#!/usr/bin/env python3
"""Drive the PyTorch port's ported paths once on one CUDA card and check
them: IVF4096,PQ32x4fs search, refined and unrefined (kernels K1, K2, K4,
K5, with the penalized mode of K1 and the masked mode of K2), the ADC scan
over its one-hot layout (K6, bf16 and int8 LUTs), the score-only floor of its
decoded store (K7), its per-probe and XLA ADC scans, exact flat search (K2
and K3), IVF4096,Flat search (K1 and K2 over hi/lo planes) and
IndexIVFPQR IVF4096,PQ8+16: all seven kernels; then Refine(SQ8) under
IDMap2 (K1), ID selectors, IVF-Flat's mutations (K1, K2), range search and
IVF-Flat by inner product (phases A-E); index files (phase G); the
scalar-quantizer family on the same 1M x 128 set (K2, K3; phase I); the
PQ and Hamming family there (BASELINE rows 1-3, K2 under
IndexBinaryFromFloat; phase J); the graph indexes and the non-flat coarse
quantizers (phase K); the additive quantizers and RaBitQ, flat and IVF
(no kernel; phase L); the rest of faiss_tpu (phase M); the multi-device
layer, four shards on the card (phase N); faiss_tpu's tools over the main
path's index (phase O: the reference format, reverse_index_factory,
autotune, bench_fw, extra, stats, datasets, contrib and the C API);
OPQ32,IVF8192,PQ32x4fs,RFlat built by index_factory over the Deep10M-like
10M x 96 set (K1, phase F); and last k-means of BASELINE row 12, 8.1M x 784
uint8 points into 256 centroids (phase H).

    python3 chip_smoke.py        # from the repository root, on a machine with a card

Phases, each of which fails the run (non-zero exit, no result line):
  1. a CUDA card is present; print its name and power limit (nvidia-smi);
  2. build K1-K7 (faiss_tpu_torch/csrc/*.cu: ivf_recon_dyn, ivf_recon,
     knn_fused, ivfpq_adc, ivfpq_v3, recon_floor), one nvcc per source, all
     started together, and print each one's ptxas register lines and
     dynamic shared memory; K3's five kernels and the tensor-core
     instances of K4, K5, K6 (bf16 and int8 LUTs) and K7 must spill no
     register, and the built libraries must route PQ32x4fs and 4-bit rows
     up to M = 37 (K4 and K5, K6 bf16) or 61 (K6 int8) to the tensor cores,
     ksub > 16 and wider rows to the lookup scan;
  3. regenerate the 1M x 128 Gaussian mixture of bench.py (seeds 42, 1, 2, 3);
  4. train and add IndexRefineFlat(IndexIVFPQFastScan(d=128, nlist=4096,
     M=32, nbits=4), store_float16=True) on the card, then stage the search
     layout (20 k-means iterations);
  5. search the 8192 queries at nprobe=1, soft probing, k_factor=8,
     pipeline_batch=2048 (K1); recall@10 against bench_gt_cache.npz must
     reach 0.95, the returned distances must be the exact squared L2 to
     the fp16 store, and K1 must have skipped PAD steps (its count of
     skipped steps, printed with its worklist splits, is above 0);
  6. on the first real 2048-query sub-batch with its real worklists, K1 and
     its plain PyTorch version must return the same slots (tie-aware) and
     keys within 1e-4 * (|q|^2 + n2), in K1's four variants: soft,
     penalized (the sub-batch's probed lists), and both over a second plane
     of the store (its values times 2^-8) as hi/lo;
  7. time K1 and the plain version with CUDA events (plain, kernel, kernel,
     plain) in each variant, and the search of all 8192 queries with a host
     clock; as a note beside K1 (not its library_ms), cuBLAS bf16 torch.mm
     of the same two products over the mean tile's real worklist columns,
     with no select;
  8. the unrefined IndexIVFPQFastScan.search of the 8192 queries at
     nprobe=1, k=10 (K4; every launch the tensor-core instance of
     csrc/adc_mma.cuh, none the lookup scan): on 64 rows the distances
     equal a float64 ADC of
     each returned slot (the same bf16 LUTs, codes, n2 and coarse term)
     within 1e-5 * (|q|^2 + max n2), and the ids agree tie-aware with a
     float64 ADC brute force over the query's probed list; recall@10;
 9. refined with strict_probe=True, the default (K2 masked): on every row
     whose probed list holds >= k * k_factor slots the ids lie in that list;
     distances exact to the fp16 store; recall@10;
 10. K4 (the unrefined search's 8192-query bucket), K5, K1 penalized,
     K2 masked and K2 unmasked (phase 12's scan; the first 2048-query
     sub-batch of their paths) against their plain versions: keys within 1e-4 * (|q|^2 + n2) + 1e-6 * |key|
     (the second term covers float32's spacing of 64 at the 1e9 mask), ids
     tie-aware; times by CUDA events, plain, kernel, kernel, plain; K4
     prints its column splits, K5 its worklist splits and PAD steps
     skipped; K5 and K1 soft over the same worklists timed in turns;
 11. phase 9 with dyn_engage_frac = 0.7 (K1 penalized): on the rows of
     phase 9's kind in sub-batches that dropped no probed chunk, the ids lie
     in the probed list and agree tie-aware with phase 9;
 12. refined at nprobe = 0 on 2048 queries (K2 unmasked over the decoded
     store);
 12a. K6 over the staged layout's data chunks (its trailing PAD chunk
     breaks K6's nchunks % G == 0): stage the one-hot in bf16 and int8
     (seconds, GiB); every 2048-query sub-batch through K6 bf16, K6 int8
     (int8 LUTs with their (a, c) from the float32 LUTs) and K4 on the
     unmasked coarse term, printing profile_v3's candidate recall (the
     top-120 slots hold the ground-truth top-10); every K6 launch of the
     path must take the tensor-core instance of its mode, its columns
     split across blocks; K4 and each K6 mode of the path against their
     plain versions on every sub-batch (keys within 1e-4 * (|q|^2 + n2) +
     1e-6 * |key|, ids tie-aware, floor all +inf; K4's columns must split);
     on the first sub-batch, K6 bf16 against K4 (the same function), K6
     int8 on 64 rows against a float64 a * acc + c + bias + n2 of its
     slots, and each mode timed in turns with its plain version, K4 too
     (with its splits); K6 int8 on 256 queries whose (a, c) vary by lane on
     every third row (the ungated path) against its plain version; K6 at
     ksub = 32 (M = 8, 256 queries over 65,536 columns of random codes),
     which must take the lookup scan of adc_scan.cuh, in both modes against
     its plain version; as notes beside K4 and K6 (not their library_ms),
     cuBLAS bf16 torch.mm and int8 torch._int_mm of the sub-batch's LUTs
     with the one-hot's M * 16 PQ rows: the same products, no bias, no
     select;
 12b. K7 over the decoded store on the 8192 queries in 2048-query
     sub-batches, every launch on the tensor cores with its columns split;
     on the first, against its plain version and the minimum over its
     lanes against K2's first key (one plane, unmasked), within
     1e-4 * (|q|^2 + max n2), with the largest difference from K2 and the
     rows where they are bitwise equal printed (the same products in the
     same order); K7 and K2 timed in turns, and K2's time printed as a
     share of K7's (the select's cost);
 12c. IndexIVFPQ.search by probe (64 queries, nprobe=16, then with
     max_codes=2000) and through the XLA ADC scan (k=200 on 1024 queries),
     none launching a kernel: on 64 rows the distances within
     1e-5 * (|q|^2 + max n2) of float64 (the exact distance to the
     reconstruction by probe; the XLA scan's own bf16 LUTs, coarse products
     and norms) and ids tie-aware with float64 over the probed lists;
     recall@10 of the XLA search; host-clock medians; the XLA scan's two
     ways to sum the LUT entries (the one-hot product it takes at
     ksub <= 16, the table gathers above) timed on its inputs;
 13-14. re-staged with recon_scan_max_bytes = 0 (no decoded store): refined
     soft (K5: every launch on the tensor cores with its worklist steps
     split, PAD steps skipped; K5 against its plain version on every
     2048-query sub-batch of the path, as in phase 10; one K5 launch at
     ksub = 32, M = 8, which must take the lookup scan and equal its plain
     version) and refined strict (K4, every launch on the tensor cores),
     then K4 on phase 14's first 2048-query sub-batch (masked, its columns
     split and merged) against its plain version as in phase 10;
     both mask unprobed lists, so their
     ids agree tie-aware on the rows of phase 11's kind where K5's sub-batch
     dropped no probed chunk; recall@10 and ivf_fast_scan_stats.
     Every search of phases 8-14 runs with all launch counts set to 0 just
     before it and read just after, must launch its path's kernel, and is
     timed by host clock, median of 5.
The IVF-PQ index is then freed, and exact flat search follows on the same
1M x 128 store. Every search below runs with all launch counts set to 0
just before it and read just after, and must launch its path's kernel:
 15. IndexFlatL2: add and stage the hi/lo screen store;
 16. k=10 through ``search`` (screen, K2): the ids must agree tie-aware with
     bench_gt_cache.npz (float64 distances, tolerance 1e-6 * (|q|^2 +
     max |y|^2)); print recall@10;
 17. k=100 (BASELINE config 1) through ``search_submit``/``search_collect``
     (screen, K2): print the certified share and the repaired rows;
 18. k=1024 (BASELINE row 9) through ``search`` (striped, K2 per stripe):
     print the striped counters;
 19. ``flat_screen = False``: k=100 on the 8192 queries and k=2000 on 1024
     queries (fused, K3 at k_lanes 128 and 2048);
 20. IndexFlatIP: k=100 on 1024 queries (screen, K2).
     After each of 17-20, 64 rows must match a float64 brute force on the
     card: distances within 1e-5 * (|q|^2 + max |y|^2) (the float32 norm
     expansion's error scales with the norms, not with the distance) and ids
     tie-aware;
 21. K2 (hi/lo and one plane) on the first 4096-query screen sub-batch
     against the full store, K2 hi/lo on the first and the last (pad-filled)
     k=1024 stripe as the striped path passes them (column slices of the
     stripe-grid store, row stride wider than the slice), against their
     plain versions: keys within 1e-4 * (|q|^2 + n2), ids tie-aware; then
     K3 against its plain version, values within 1e-4 * (|q|^2 + |y_s|^2)
     and ids tie-aware, the floor all +inf (L2) or -inf (IP), and every
     row's candidates within the buffer's bound (k_lanes - 1) * 32 +
     k_lanes, printed with their mean and max, the scratch and the peak
     device memory: L2 at k_lanes 128 (8192 q) and 2048 (1024 q), IP at
     k_lanes 256 (1024 q), k_lanes 2048 over the store's columns sorted by
     the mixture centre each vector was drawn from (an IVF-like order, the
     adversarial one for the threshold), k_lanes 128 over a store whose
     every column appears 8 times (ties), and 72 queries at d = 20 (IP,
     k_lanes 2048) and d = 200 (L2, k_lanes 384) over uniform stores of
     70,001 and 50,001 columns;
 22. time K2 (full store and one stripe) and K3 and their plain versions
     with CUDA events (plain, kernel, kernel, plain), K3's five kernels
     one by one (the norms, pass 1, the threshold select, pass 2, the final
     select), ``search`` of the 8192 queries at k=100 and k=1024, and the
     fused searches of phase 19, by host clock, median of 5, with QPS; peak
     device memory. As a note
     beside K3 (not its library_ms), cuBLAS float32 torch.mm of x @ yT at
     both shapes, TF32 off, the product alone.
The flat index is then freed, and IVF-Flat search (BASELINE config 3)
follows on the same data. Every search below runs with all launch counts
set to 0 just before it and read just after, prints the branch it took
(the kernel modes it launched, or the per-probe scan), its host-clock
median of 5, QPS and recall@10 against bench_gt_cache.npz:
 23. train (faiss_tpu's default k-means parameters), add and stage
     IndexIVFFlat(d=128, nlist=4096): hi/lo bf16 store planes, chunks of
     1024 slots;
 24. strict probing (the default) at nprobe 1, 4, 16 and 64 on the 8192
     queries; recall@10 must not fall as nprobe grows (by more than 0.002);
 25. soft probing at nprobe 1 and 16: on the rows of undropped sub-batches
     whose probed lists hold kc slots, the distances per rank must be no
     worse than strict's, within 1e-5 * (|q|^2 + max |y|^2);
 26. strict at nprobe=1 with dyn_engage_frac = 0.7 (K1 penalized);
 27. nprobe = nlist on 2048 queries (K2 unmasked): the ids must agree with
     bench_gt_cache.npz up to ties at 1e-6 * (|q|^2 + max |y|^2);
 28-29. the per-probe scan (no kernel): 64 queries at nprobe=16, and 1024
     queries at k=100.
     After each strict search of 24 and 26 and each of 28-29, the first 64
     rows (those whose probed lists hold kc slots, for 24 and 26) must equal
     a float64 exact search over the row's probed lists: distances within
     1e-5 * (|q|^2 + max |y|^2), ids up to ties at it;
 30. K1 soft and penalized over the hi plane alone and over hi/lo, and K2
     masked + hi/lo, on the first 4096-query sub-batch of their paths at
     nprobe=1 against their plain versions (keys within 1e-4 * (|q|^2 +
     n2) + 1e-6 * |key|, ids tie-aware), timed by CUDA events in turns;
     each mode must have
     launched on the path; the note of phase 7 at K1 hi/lo's shape (three
     products); peak device memory of the IVF-Flat phases.
 31. IndexIVFPQR "IVF4096,PQ8+16" (PQ8 and a refine PQ16, both 8-bit)
     trained (20 k-means iterations) and added on the card; the 8192
     queries at nprobe=16, k_factor=4 (the XLA ADC scan: ksub = 256; no
     kernel), with train and add seconds, host-clock median of 5, QPS and
     recall@10 (no limit); 64 rows of the re-rank against float64 distances
     to the refined reconstruction of their 40 candidates (within
     1e-5 * (|q|^2 + max |x|^2), ids tie-aware).
The ported remainder of the flat and IVF families, on the same data (A and
B's first part right after phase 14, B's second part and D's first after
phase 22, D's second and C after phase 30, E before 31); every number they
print stands beside the card's name and power limit:
 A. IDMap2,IVF4096,PQ32x4fs,Refine(SQ8): IndexIDMap2(IndexRefine(
     IndexIVFPQFastScan, IndexFlatSQ8(128))) from phase 4's coarse
     quantizer and PQ (faiss_tpu_torch.convert), the SQ8 store trained on
     the 200k training vectors, the 1M vectors added with seeded 64-bit ids
     (a permutation plus 2^40); the 8192 queries at nprobe=1, soft,
     k_factor=8, pipeline_batch=2048 must launch K1; every distance is the
     exact squared L2 to the SQ8 reconstruction of its id within
     1e-5 * (|q|^2 + max |y|^2); the ids equal id_map of the inner index's
     own search; the SQ8 store holds one byte a dimension; recall@10 through
     the id map beside phase 5's (no limit); host-clock median of 5;
 B. an IDSelectorRange over half the external ids on A's index, 1024
     queries (the eager path: the base by probe with the selector, then the
     re-rank on the SQ8 codes; no kernel): no id outside the selector, and
     on 64 rows the results are the best 10, on the SQ8 reconstruction, of
     the best 80 by float64 ADC among the selected entries of the probed
     list (ADC ties at that cut either side); then an IDSelectorBatch of
     100,000 ids on IndexFlatL2 over the 1M store, 1024 queries (the masked
     plain k-NN, no kernel): 64 rows exact against float64 over the
     selected rows;
 C. on phase 23's index: remove_ids of a seeded 10% of the ids, then the
     strict (K2 masked + hi/lo) and soft (K1 soft + hi/lo) searches of the
     8192 queries at nprobe=1, each launching its kernel and returning no
     removed id, the strict one exact on 64 rows against float64 over the
     probed lists without the removed rows; merge_from an index on the same
     quantizer holding the removed rows, after which the strict search's
     64 rows (those whose lists hold kc entries) agree tie-aware with phase
     24's at nprobe=1; update_vectors of 1,000 ids, after which reconstruct
     returns the new vectors;
 D. range search of 64 queries at the median 10th-neighbour distance of
     bench_gt_cache.npz, on IndexFlatL2 and on IVF-Flat at nprobe 16 (no
     kernel): each query's set equals float64's (over the probed lists for
     IVF-Flat) apart from entries within 1e-5 * (|q|^2 + max |y|^2) of the
     radius; the lims totals printed;
 E. IndexIVFFlat(128, 4096, METRIC_INNER_PRODUCT) trained by spherical
     k-means on the 200k training vectors (unit-norm centroids), the 1M
     added, 1024 queries at nprobe 16 by probe: 64 rows equal float64 over
     the probed lists, largest first.
 G. (right after B's IVF-PQ part) write_index of phase 4's index to a
     temporary directory and read_index onto the card: the class tree, the
     store ("f16"), k_factor, nprobe and bbs kept, the coarse centroids, PQ
     codebooks, codes, list numbers, ids and refine store bitwise equal;
     its search (K1 must launch) equals phase 5's on at least 99.9% of the
     rows, ids equal up to exact ties there, the other rows (candidates
     tied at K1's cut) counted; then faiss_tpu's committed
     tests/io_compat files: Flat, IVF8_Flat and IVF8_PQ4 read onto the card
     with ntotal 1200, IVF8_PQ4 at nprobe 8 reproducing golden_ivfpq.npz
     (D within rtol 1e-5, atol 1e-6, ids tie-aware within it), SQ8 read
     as an IndexScalarQuantizer of 1200 rows, PQ4x4fs read as an
     IndexPQFastScan of 1200 rows with its codes bitwise the file's, its
     search of the golden file's 10 queries equal to a float64 ADC of its
     bf16-rounded tables (within 1e-5 of each row's sum over m of its
     largest table entry, the float32 sum's error), ids tie-aware;
 I. (after phase 31) the scalar quantizers on the 1M x 128 set, each built
     by index_factory on the card (trained on the 200k training rows),
     with build seconds, host-clock median of 5, QPS and recall@10 against
     bench_gt_cache.npz (no limit): SQ8, SQ4 and SQfp16 at k=10 on the
     8192 queries (the flat screen over the decoded rows: K2 must launch),
     SQ8 with flat_screen = False at k=100 on 1024 queries (K3 must
     launch), each with 64 rows equal to a float64 search of the decoded
     rows (1e-5 * (|q|^2 + max |y|^2), ids tie-aware); IVF4096,SQ8 at
     nprobe 16 by probe (no kernel), 64 rows equal to float64 over their
     probed lists' decoded rows, then write_index/read_index onto the card
     with codes and ranges bitwise equal and the search equal on every
     row; SuperKMeans into 4096 centroids on the 200k training rows (20
     iterations) at most 1.05 x Clustering's objective, both timed;
 J. (after I) the PQ and Hamming family on the 1M x 128 set, none of it a
     kernel but IndexBinaryFromFloat's K2; every number beside the card's
     name and power limit, every search a host-clock median of 3:
     J1. BASELINE row 1: index_factory(128, "PQ64") (IndexPQ(128, 64, 8))
       trained on the 200k rows with do_polysemous_training (the k-means
       and the host annealing timed apart: the ADC does not depend on the
       codewords' labels, so one index serves rows 1-3), the 1M added, the
       8192 queries at k=10 by ADC: recall@1 and @10 against
       bench_gt_cache.npz (SIFT1M's published R@1 0.4474 printed beside
       it, no limit), and 64 rows against a float64 ADC brute force over
       every code (distances within 1e-5 of the row's sum over m of its
       largest table entry, ids tie-aware); ST_SDC on 1024 queries, 64
       rows against a float64 scan of the symmetric table;
     J2. rows 2-3: ST_polysemous at ht = 512 (the whole code) returns J1's
       results bit for bit; at ht = 54 and 30 the recall@1 (beside the
       published 0.4478 and 0.1794), the search time beside J1's, the
       share of the (query, code) pairs filtered over all queries, and 64
       rows against float64 over exactly the codes that pass;
     J3-J4. PQ32x4fs (IndexPQFastScan, the bf16 one-hot product) and
       PQ16x12 (ksub 4096, int32 codes on the card) through index_factory:
       train and add seconds, recall@1 and @10, 64 rows against float64 of
       the scan's own tables (bf16-rounded at 4 bits);
     J5. phase 4's coarse quantizer and PQ (IVF4096,PQ32x4fs) with the 1M
       vectors added, nprobe 16, polysemous_ht 40 of 128 bits, 1024
       queries by probe: the share of the probed slots filtered and 64 rows
       against float64 over the probed lists' surviving slots (1e-5 *
       (|q|^2 + max |y|^2));
     J6. IndexLSH(128, 256, rotate_data, train_thresholds) over the 1M set,
       then its codes (1M x 32 B) in IndexBinaryFlat(256) (the int8
       product and the SWAR routes, timed; equal distances),
       IndexBinaryFromFloat(IndexFlatL2(256)) (K2 must launch; counted in
       the kernels' line; IndexBinaryFlat's distances),
       IndexBinaryIVF(256, 1024) trained on the 200k rows' codes, nprobe 16,
       and IndexBinaryHash(256, 16) with nflip 1 and
       IndexBinaryMultiHash(256, 4, 16) on 1024 queries: recall@1 and @10,
       and 64 rows of each against the bits set of each byte value (from
       numpy's unpackbits) over the row's candidates (every code, the
       probed lists, the probed buckets): distances per rank equal, every
       id a candidate at its own count, ids tie-aware;
 F. the Deep10M-like set of benchs/bench_deep10m.py regenerated into
     RAM (its generator copied: seeds 7, 1, 2, 3; 10M base, 500k training
     and 8192 query rows of 96 dimensions), gt[:, 0] of .deep10m_gt.npz the
     float32 brute-force minimum on the card for 32 queries;
     index_factory(96, "OPQ32,IVF8192,PQ32x4fs,RFlat") on the card (its
     class tree printed), 20 k-means iterations, train, add and stage
     (seconds, peak device memory); at nprobe 8 soft and k_factor 12
     (benchs/bench_deep10m.py:246-248) the 8192 queries at k=10 after the
     first search sized the worklist and any sub-batch that dropped probed
     chunks widened it: every sub-batch on K1's dynamic path (no other
     kernel), ndropped 0, recall@10 >= 0.95 (printed beside faiss_tpu's
     0.9784 at this point), 64 rows' distances equal to float64
     |Aq - Ax|^2 against the float32 refine store within
     1e-5 * (|q|^2 + |y|^2) and to the unrotated |q - x|^2 within 1e-4
     relative, submit/collect equal to search as in G, host-clock median
     of 5 with QPS and the rotation's share; K1 against its plain version
     on the first real 4096-query sub-batch (d 96 of d_pad 128, qt 256, ct
     2048, kc 120; keys within lane_tol, ids tie-aware) in its four
     variants as in phase 6, each timed in turns, the soft one's entry
     ``ivf_recon_dyn[opq,d96]`` in the kernels' line bounded at d = 96;
 H. (last) BASELINE row 12: the 8.1M x 784 uint8 set of
     benchs/jobs/job_kmeans_row12.py (its generator copied, seed 42)
     generated into RAM, ``Kmeans(784, 256, niter=20, seed=1234,
     max_points_per_centroid=10**9)`` trained on the card through the
     uint8 branch: the loop must receive the set as uint8 on the card,
     peak device memory under 12 GiB (no float32 copy), the objective
     never rising by more than 1e-5 relative; the seconds to generate, to
     train end to end, to upload, the 20-iteration loop alone by CUDA
     events, the objective per iteration, the imbalance, one iteration's
     centroid sums through index_add_ and through a one-hot product (each
     timed, with its largest error against the exact float64 sums) and
     which the loop uses; Kmeans.assign of a seeded 65,536-row sample (no
     kernel) equal to the float64 argmin except on rows whose best two
     float64 distances lie within 1e-5 * (|x|^2 + max |c|^2) (the float32
     norm expansion's error), the sample's objective within 1e-4 relative
     of float64's; the published baseline (Titan X, 2015, 140.6 s) printed
     beside it.
 K. (K-a, K-b, K-d after J on the 1M x 128 set; K-c right after F on F's
     rows, generated once) the graph indexes and the coarse quantizers
     other than flat. K-a: ``index_factory(128,
     "IVF4096_HNSW32,PQ32x4fs,RFlat")`` on the card, its quantizer an HNSW
     graph over the 4096 centroids (host C++, built by g++ at first use;
     its build timed inside train), the 1M rows assigned through the graph
     at efSearch 32; the main path's point (nprobe=1 soft, k_factor=8,
     2048-query batches) must launch K1 and no other kernel and reach
     recall@10 >= 0.95 (distances exact to the store); the unrefined
     search must launch K4 and the strict one K2 masked or K1 penalized;
     64 queries by probe through the graph (no kernel) against float64
     over the probed lists. K-a's launches go into the kernels' line as
     ``k_a_launches`` of the K1, K1 penalized, K2 masked and K4 entries,
     beside their own phases' ``launches``. K-b, faiss's bench_hnsw.py configuration:
     IndexHNSWFlat(128, M=32), efConstruction 40, efSearch 16-256 over the
     first 50k rows (a 100k build took 20-28 s on the chip host), then
     HNSW32,SQ8 and HNSW32,PQ16 (their storage trained on the card's
     codecs) over 25k, NSG32 and NNDescent32 over 10k, each's recall@1 and
     @10 against float64 over its rows; NSG32 over 3k built in a process
     of its own with OMP_NUM_THREADS=1 and here with every thread: the
     graphs must be byte-identical. K-c: ``IMI2x10,PQ16`` (BASELINE row 4's
     IMI2x12,PQ16 over SIFT1B, its 2^24 cells cut to 2^20 for 10M rows)
     over the Deep10M-like set, the IMI trained on the card, the PQ with
     polysemous training; its 2^20 skewed lists held as one CSR (the padded
     layout's size printed); the 8192 queries by probe at nprobe 16,
     max_codes 10,000, with the polysemous filter at ht 47 and without (no
     kernel), 1-recall@1/10/100 against .deep10m_gt.npz; 64 rows of each
     against float64 over the lists each probed (max_codes cut, filter
     applied). K-d: IndexBinaryHNSW(256, 16) over 10k of phase J6's
     IndexLSH(128, 256) codes, 64 rows against numpy's bit counts, recall
     against IndexBinaryFlat. Every time stands beside the card's name and
     power limit. ``python3 chip_smoke.py --only K`` runs phases 1-3 and
     phase K alone.
 L. (after K-d, on the 1M x 128 set, no kernel: every search runs with the
     counts at 0 and must leave them there) the additive quantizers and
     RaBitQ, each index built by index_factory on the card. L-a:
     RQ8x8_Nfloat, LSQ8x8_Nfloat, PRQ2x4x8_Nfloat, PLSQ2x4x8_Nfloat,
     RQ8x8_Nqint8 and RQ16x4fs trained on the 200k rows, the 1M rows encoded
     (beam search; the peak device memory of the encode printed), 8192
     queries at k = 10: train and encode s, search ms, bytes a code,
     recall@1 / @10, the mean reconstruction error; 64 rows against float64
     of the same tables plus the stored norms over every code; LSQ8x8's
     error may not exceed its RQ init's (beam search over the same
     codebooks) by more than 1e-5 relative. L-b: IVF4096,RQ8x8 and
     IVF4096,RQ16x4fs (the second on the first's coarse quantizer) at
     nprobe 16 on 1024 queries, 64 rows against float64 over the probed
     lists' decoded rows. L-c: RaBitQ, RaBitQfs and RaBitQ4 flat over the
     1M rows, IVF4096,RaBitQ / RaBitQfs / RaBitQ4 and IVF4096,RaBitQ,RFlat
     (k_factor 8) on L-b's coarse quantizer at nprobe 16, 8192 queries
     (the IVF searches' peak memory printed); 64 rows of each against
     float64 of the same estimator on the same float32 inputs (the refined
     one: its distances against float64 |q - x|^2); an IDSelectorRange
     over the middle half of the ids on IVF4096,RaBitQ returns only
     selected ids, 64 rows against float64 over the selected probed slots.
     L-d: write_index / read_index of L-a's RQ8x8 and L-c's IVF4096,RaBitQ,
     each read index's 8192-query search equal to the search before the
     write (distances bit for bit). ``python3 chip_smoke.py --only L`` runs
     phases 1-3 and phase L alone.
 M. (after L, on the 1M x 128 set) the rest of faiss_tpu: M-a IndexFlat
     under the ten extra metrics (1024 q; JensenShannon, Jaccard and
     BrayCurtis on |x| normalised to sum 1, NaNEuclidean and GOWER with 1%
     NaN) and IVF4096,Flat under L1 at nprobe 16, 64 rows each against
     float64 of faiss's formulas (over the probed lists for IVF); M-b
     FlatPanorama8 against IndexFlatL2 and IVF4096,FlatPanorama4 against
     IVF4096,Flat over the same lists, every row tie-aware, the certified
     share and the repaired rows printed; M-c EDEN4, EDEN4BIASED and
     IVF4096,EDEN4 (train, encode, search, bytes a code, recall@1/@10, 64
     rows against float64 of the estimator); M-d ZnLattice8x8_r2 with the
     largest r2 of 32..8 whose codec enumerates in under 10 s,
     decode(encode) against the float64 nearest vertex on 64 rows; M-e
     train_qinco over 100k rows (K 256, M 8, L 2, h 256, 4 epochs, the loss
     falling every epoch) and IndexQINCo over the 1M rows; M-f
     IVFFlatDedup over the set with 10% of its rows duplicated (every
     duplicate in ``instances``, returned by the expanded search),
     RowwiseMinMax / FP16 over SQ8, IVFIndependentQuantizer and
     IVFSpectralHash at nprobe 16; M-g partition_fuzzy on [8192, 65536]
     against a sort-based check; M-h files of the EDEN, Panorama and
     lattice indexes, each search equal after the read. The IVF indexes
     share one k-means of 4096 centroids. Each timed search follows an
     untimed one and runs with the counts at 0 (``m_launches`` in the
     kernels' line: the flat and IVF-Flat searches behind Panorama, the
     lattice, QINCo, MinMax's decoded rows and Dedup). ``python3
     chip_smoke.py --only M`` runs phases 1-3 and phase M alone.
 N. (after M, on the 1M x 128 set, reusing phase 4's index) the
     multi-device layer, on a mesh of four shards on the one card
     (``make_mesh(devices=[dev] * 4)``): N-a ShardedFlat (8192 q, k=10)
     against the unsharded ``ops.distances.knn`` tie-aware, 64 rows
     against float64, recall@10; N-b an IVF4096,Flat on phase 4's
     centroids, ShardedIVF and an IndexShardsIVF of
     ``ivflib.shard_ivf_index_centroids`` at nprobe 1 and 16 against the
     index's search_preassigned on the same probes; N-c ShardedIVFPQ over
     phase 4's base at nprobe 1 and 16 against its search_preassigned and a
     one-shard mesh (ADC keys within lut_tol); N-d ShardedRefinedIVFPQ
     (fp16, k_factor 8, nprobe 1): 64 rows exact to the fp16 store, never
     worse than one shard at any rank, recall@10; N-e
     ShardedIVFPQBuilder(128, 4096, 32, 4) trained on the 200k rows, the 1M
     added in chunks: one ``sharded_kmeans_iter`` against the unsharded
     reduction (counts exact, sums 1e-5), 64 rows at nprobe 16 against a
     float64 ADC over their lists, recall@10 within 0.02 of phase 4's
     unrefined; N-f IndexShards of two ``clone_index`` halves of phase 4's
     index at the main operating point (K1 must launch, recall@10 >= 0.95,
     exact to the fp16 store), IndexReplicas of the index and its clone
     (equal up to K1's ties), IndexShards of four IndexFlatL2 quarters
     against N-a (the flat kernel must launch); N-g ``merge_into`` of the
     halves' bases against phase 4's base, one ``SlidingIndexWindow.step``,
     an ``OnDiskInvertedLists`` round trip of N-b's lists under the
     git-ignored ``faiss_tpu_torch/_build/``. Each part prints its time and
     peak memory; N-f's launches are ``n_launches`` in the kernels' line.
     ``python3 chip_smoke.py --only N`` runs phases 1-4 and phase N alone.
 O. (after N, on the 1M x 128 set, reusing phase 4's index with the main
     path's knobs and decoded store restored, as N does) faiss_tpu's tools
     over the port: O-a ``reverse_index_factory`` of the index and the
     index ``index_factory`` builds from the string (the same classes and
     sizes); O-b ``write_ref_index`` of the index in the reference
     library's own format under the git-ignored ``faiss_tpu_torch/_build/``
     (its bytes against the model 1M x (16 code + 8 id + 512 float32
     refine) + centroids + PQ), ``read_index`` (sniffed) onto the card, the
     8192 queries at the main operating point (K1 must launch): equal to
     phase 5's up to rows tied at K1's cut, recall@10 >= 0.95; O-c
     ``ParameterSpace.explore`` over the read index, nprobe {1, 2, 4, 8, 16}
     x k_factor_rf {4, 8, 16}, OneRecallAtRCriterion(8192, 10) against
     bench_gt_cache.npz: the optimal points, the main point >= 0.95; O-d a
     ``Benchmark`` over the 1M set (a port Dataset whose ground truth is the
     cache) of O-b's file at nprobe {1, 4, 16} and of "IVF4096,Flat"
     trained and added on the card at nprobe {1, 16}, saved and reloaded by
     ``BenchmarkIO``; ``SyntheticDataset(128, 100000, 1000000,
     8192).get_groundtruth(100)`` (K2 must launch; 64 rows equal float64);
     O-e ``extra.knn`` of the 8192 queries against the cache (ids
     tie-aware), ``knn_ground_truth`` over ``database_iterator`` against
     ``extra.knn``, ``big_batch_search`` of O-d's IVF4096,Flat at nprobe 16
     against that index's own search (tie-aware; 64 rows against float64);
     O-f ``OfflineIVF`` over the 1M set saved as four .npy files
     (IVF4096,Flat, nprobe 16, k 10: train, shard, merge by
     ``merge_ondisk``, search by ``big_batch_search``, evaluate), each
     step's seconds; O-g a ``SearchServer`` on localhost over the read
     index queried by ``ClientIndex`` (equal to the direct search, K1
     launches), ``torch_utils.search_with_torch`` with query tensors on the
     card (tensors on the card, equal to the numpy search), the C API built
     with gcc and its example run with device "cuda". Also ``MatrixStats``
     of the database. Each part prints its time and peak memory; the K1
     and K2 launches of O's searches are ``o_launches`` in the kernels'
     line. ``python3 chip_smoke.py --only O`` runs phases 1-4 and phase O
     alone.
Every K1 and K2 comparison prints the launch's splits (of the worklist or
of the columns across blocks) and K1's skipped PAD steps; phase 22 prints
the note of phase 7 at K2 hi/lo's shape (three products).
The last two lines are the card's name and power limit, then the result
line {"ok": true, "device": {...}}; the kernels' JSON line comes before. Each
kernel's entry there carries its bound, counted from this run's inputs: the
larger of the time of its operations and the time of its bytes (inputs read
once, both store planes with hi/lo, outputs written once) over 3.35 TB/s.
The operations are those of the tensor-core product that computes the same
keys: for the recon kernels over a bf16 store (K1, K2, K7) the TPU
kernels' bf16 products of the query split into hi + lo, two with one plane
and three with hi/lo (qh.yh + ql.yh + qh.yl), at 989 TFLOP/s; for the ADC
kernels (K4-K6) the contraction of the LUTs with the one-hot of the codes
(M * 16 rows in the LUTs' type, bf16 at 989 TFLOP/s or int8 at 1979 TOP/s)
alone: they add the coarse bias by one lookup and one add a key, so the
TPU's contraction of it with the 128 local-list rows is not counted. K3
scores a float32 store at float32 accuracy: the product once as 3xTF32 (three
TF32 products, the same work as the TPU's six bf16 products of HIGHEST) at
495 TFLOP/s. Rates are an
H100 SXM's dense peaks at 700 W; only the slots that hold a vector are
counted (K6's bytes count its one-hot). Phase 12a also prints the bound of
the lookup scan's design (K4's, K5's and K6's before they moved to the
tensor cores, and still theirs at ksub > 16), M + 1 shared-memory LUT
lookups per key at 32 a clock per SM, as a note.
"""

import functools
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
D, NB, NQ, NT, NLIST, M, NBITS = 128, 1_000_000, 8192, 200_000, 4096, 32, 4
NPROBE, K, K_FACTOR, BATCH, NITER = 1, 10, 8, 2048, 20
RECALL_MIN = 0.95
EXACT_ROWS = 64
CARD = ""  # the card's name and power limit (nvidia-smi), set by main()


def bench_data():
    """The Gaussian mixture of bench.py:228-244, copied."""
    rs = np.random.RandomState(42)
    ncent = 2048
    cent = rs.rand(ncent, D).astype(np.float32)
    scales = (1.0 / (np.arange(D) + 1.0)).astype(np.float32) * 0.4

    def gen(n, seed):
        r = np.random.RandomState(seed)
        a = r.randint(ncent, size=n)
        return (cent[a] + r.randn(n, D).astype(np.float32) * scales).astype(
            np.float32
        )

    return gen(NB, 1), gen(NT, 2), gen(NQ, 3)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def turns(plain, kern, reps):
    """(kernel ms, plain ms, all four) in the order plain, kernel, kernel,
    plain."""
    t = [cuda_ms(f, reps) for f in (plain, kern, kern, plain)]
    return (t[1] + t[2]) / 2, (t[0] + t[3]) / 2, t


def tc_products_ms(xq, hi, lo, ncols, reps=2):
    """A note beside K1 and K2, not their library_ms (it has no select, and
    the port never calls it): cuBLAS bf16 ``torch.mm`` of the kernels'
    products, qh.y + ql.y with one plane and qh.yh + ql.yh + qh.yl with
    two, of the queries ``xq`` against ``ncols`` store columns, in slabs of
    65,536 columns."""
    qh = xq.to(torch.bfloat16)
    ql = (xq - qh.float()).to(torch.bfloat16)
    pairs = [(qh, hi), (ql, hi)] + ([] if lo is None else [(qh, lo)])

    def run():
        for c0 in range(0, ncols, 1 << 16):
            c1 = min(ncols, c0 + (1 << 16))
            for a, b in pairs:
                torch.mm(a, b[:, c0:c1])

    return cuda_ms(run, reps)


def recon_note(fused_knn, kernel):
    """The split count of K1's, K2's, K4's or K5's last launch, and K1's or
    K5's PAD steps skipped since its counter was last reset."""
    if kernel == "K1":
        return (f"{fused_knn.ivf_recon_fused_dyn.splits} worklist splits, "
                f"{fused_knn.pad_steps_skipped(reset=True)} PAD steps skipped")
    if kernel == "K5":
        return (f"{fused_knn.ivfpq_fused_dyn.splits} worklist splits (tensor "
                f"cores), {fused_knn.pad_steps_skipped(reset=True, kernel='K5')} "
                "PAD steps skipped")
    if kernel == "K4":
        return f"{fused_knn.ivfpq_fused.splits} column splits (tensor cores)"
    return f"{fused_knn.ivf_recon_fused.splits} column splits"


def k4_on_tensor_cores(fused_knn, what, launches):
    """Every K4 launch of a path since the counts were reset took the
    tensor-core instance, none the lookup scan."""
    tc = fused_knn.ivfpq_fused.tc_launches
    check(tc == launches, f"{what}: {launches - tc} of {launches} K4 launches "
                          "took the lookup scan, not the tensor cores")
    print(f"{what}: all {launches} K4 launches on the tensor cores "
          f"({fused_knn.ivfpq_fused.splits} column splits)", flush=True)


def host_median(fn, n=5):
    times = []
    for _ in range(n):
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return float(np.median(times)), times


def reset_counts(fused_knn):
    for f in (fused_knn.ivf_recon_fused_dyn, fused_knn.ivf_recon_fused,
              fused_knn.knn_fused, fused_knn.ivfpq_fused,
              fused_knn.ivfpq_fused_dyn, fused_knn.ivfpq_fused_v3,
              fused_knn.recon_floor):
        f.launches = 0
    fused_knn.ivfpq_fused_v3.int8_launches = 0
    fused_knn.ivfpq_fused_v3.tc_launches = 0
    fused_knn.ivfpq_fused.tc_launches = 0
    fused_knn.ivfpq_fused_dyn.tc_launches = 0
    fused_knn.ivf_recon_fused_dyn.penalized_launches = 0
    fused_knn.ivf_recon_fused.masked_launches = 0
    fused_knn.ivf_recon_fused_dyn.hilo_launches = 0
    fused_knn.ivf_recon_fused.hilo_launches = 0
    fused_knn.pad_steps_skipped(reset=True)
    fused_knn.pad_steps_skipped(reset=True, kernel="K5")


# H100 SXM at 700 W, datasheet dense peaks: float32 outside the tensor
# cores, bf16, TF32 and int8 on them, an FMA counted as 2 operations; HBM
# bytes per second
PEAK_FLOPS, PEAK_BF16, PEAK_INT8, PEAK_BYTES = 67e12, 989e12, 1979e12, 3.35e12
PEAK_TF32 = 495e12


@functools.lru_cache(maxsize=None)
def lookup_rate():
    """Shared-memory 32-bit loads a second: 32 a clock per SM, at the card's
    max SM clock as nvidia-smi reports it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 32 * float(mhz) * 1e6


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def ops_s(store, keys, planes=1, int8=False, d=None):
    """Seconds of a scan's operations over ``keys`` (query, slot) pairs, as
    the tensor-core product that computes the same keys. A recon store
    (bf16 [d_pad, S], ``planes`` of it: 2 with hi/lo): the float32 query as
    bf16 hi + lo, the TPU kernels' bf16 products of d_pad, qh.y + ql.y with
    one plane and qh.yh + ql.yh + qh.yl with two (the TPU drops the ql.yl
    term, below 2^-16 |q| |y|). A code store (uint8 [M, S] of 4-bit
    codes): the PQ contraction alone, the LUTs (bf16, or int8 with
    ``int8``) against the M * 16 one-hot rows. The coarse bias is one
    lookup and one add a key in K4-K6 (the list ids are at hand), not the
    TPU's bf16 hi + lo contraction over 128 local-list rows, so it is not
    counted. ``d`` counts the products over d dimensions in place of the
    store's d_pad rows."""
    if store.dtype != torch.uint8:
        products = 3 if planes == 2 else 2
        return keys * 2 * (d or store.shape[0]) * products / PEAK_BF16
    return keys * 2 * store.shape[0] * 16 / (PEAK_INT8 if int8 else PEAK_BF16)


def lookup_s(codes, keys):
    """Seconds of the lookup scan's design over ``keys`` pairs: M + 1
    shared-memory lookups per key (the LUT entries and the bias) at
    lookup_rate(). A note beside the bound, not the bound."""
    return keys * (codes.shape[0] + 1) / lookup_rate()


def entry(name, source, replaces, launches, err, ms, plain_ms, t_ops, nbyt):
    """One kernel of the kernels' JSON line. The bound is the larger of the
    operations' time ``t_ops`` (seconds) and the bytes (each input read
    once, each output written once) over PEAK_BYTES."""
    t_ops, t_bytes = t_ops * 1e3, nbyt / PEAK_BYTES * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        # no single PyTorch call computes a top-128 of these keys
        "library_ms": None,
    }


def lane_tol(qn2, n2, rkeys, rslots):
    """Per-key tolerance of a kernel against its plain version: 1e-4 of
    |q|^2 + n2 of the slot, plus 1e-6 of |key| for the keys near 1e9 of
    masked or penalized slots (float32 spacing there is 64)."""
    n2s = np.where(rslots >= 0, n2[np.maximum(rslots, 0)], 0)
    fin = np.where(np.isfinite(rkeys), np.abs(rkeys), 0)
    return 1e-4 * (qn2[:, None] + n2s) + 1e-6 * fin


def compare_lanes(keys, slots, rkeys, rslots, tol, what, ids_agree_tie_aware):
    """Kernel against plain version: +inf and -1 at the same places, keys
    within tol [nq, 1] where finite, ids tie-aware. Returns max_abs_err."""
    kk, ks, rk, rs_ = (a.cpu().numpy() for a in (keys, slots, rkeys, rslots))
    check(((ks == -1) == ~np.isfinite(kk)).all()
          and ((rs_ == -1) == ~np.isfinite(rk)).all(),
          f"{what}: id -1 does not mark exactly the infinite keys")
    check((np.isfinite(kk) == np.isfinite(rk)).all(), f"{what}: infinite keys differ")
    fin = np.isfinite(rk)
    err = np.abs(np.where(fin, kk, 0.0) - np.where(fin, rk, 0.0))
    max_abs_err = float(err.max())
    check((err <= tol).all(), f"{what}: keys differ from the plain version by "
                              f"{max_abs_err}")
    agree = ids_agree_tie_aware(rk, rs_, kk, ks, np.where(fin, tol, 0).max(1))
    check(agree.all(), f"{what}: ids differ on {int((~agree).sum())} rows")
    return max_abs_err


def ivfpq_phases(ft, fused_knn, xb, xt, xq, gt, dev, main_only=False):
    """Phases 4-14: the IVF4096,PQ32x4fs,RFlat path and K1, then the rest of
    IVF-PQ search on the same index. Returns the entries of K1, K4, K5, K1
    penalized and K2 masked in the kernels' JSON line, K2's unmasked
    launches and max_abs_err on the IVF-PQ path, and phase 4's state (its
    index, centroids, PQ codebooks, results and recall). With
    ``main_only`` phase 4 alone (the main path's search and its checks),
    returning the state only."""
    from faiss_tpu_torch.models.ivf_pq import _dyn_inputs, _pad_dims, _probe_mask
    from faiss_tpu_torch.utils.evaluation import recall_at_k

    base = ft.IndexIVFPQFastScan(None, D, NLIST, M, NBITS, device=dev)
    base.cp.niter = NITER
    base.nprobe = NPROBE
    base.strict_probe = False
    base.pipeline_batch = BATCH
    index = ft.IndexRefineFlat(base, store_float16=True)
    index.k_factor = K_FACTOR
    torch.cuda.synchronize()
    t0 = time.time()
    index.train(xt)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    t0 = time.time()
    index.add(xb)
    torch.cuda.synchronize()
    t_add = time.time() - t0
    t0 = time.time()
    br = base._build_brute()
    index.refine_index._consolidate()
    torch.cuda.synchronize()
    t_stage = time.time() - t0
    print(f"train {t_train:.2f} s, add {t_add:.2f} s, stage {t_stage:.2f} s; "
          f"nchunks {br['nchunks']}", flush=True)

    # the main path, with the launch counts read around it
    reset_counts(fused_knn)
    t0 = time.time()
    Dm, Im = index.search(xq, K)
    t_first = time.time() - t0
    launches = fused_knn.ivf_recon_fused_dyn.launches
    skipped = fused_knn.pad_steps_skipped()
    msteps = base._dyn_bucket[NPROBE]
    check(launches > 0, "the main path launched K1 no time")
    check(skipped > 0, "the main path's K1 skipped no PAD step")
    check(Dm.shape == Im.shape == (NQ, K), f"result shape {Dm.shape}")
    check(np.isfinite(Dm).all() and (Im >= 0).all() and (Im < NB).all(),
          "non-finite distances or invalid ids")
    recall = recall_at_k(Im, gt, K)
    print(f"search (first, sizes the worklist) {t_first:.3f} s; K1 launches "
          f"{launches}, {fused_knn.ivf_recon_fused_dyn.splits} worklist splits, "
          f"{skipped} PAD steps skipped of {launches * (BATCH // 256) * msteps} "
          f"(tiles x msteps); msteps {msteps}; recall@10 {recall:.4f}", flush=True)
    check(recall >= RECALL_MIN, f"recall@10 {recall:.4f} < {RECALL_MIN}")
    xb16 = xb[Im[:256]].astype(np.float16).astype(np.float32)
    d_chk = ((xq[:256, None, :] - xb16) ** 2).sum(-1)
    check(np.allclose(Dm[:256], d_chk, rtol=1e-4, atol=1e-3),
          "distances are not the exact L2 to the fp16 store")
    state = {"cent": base.quantizer.vectors(), "pq": base.pq.centroids,
             "recall": recall, "index": index, "D": Dm, "I": Im}
    if main_only:
        return state

    # 6-7. K1 against its plain version on the first real sub-batch, in its
    # four variants (the hi/lo ones over a second plane of the store), each
    # timed with it in turns: plain, kernel, kernel, plain
    qt = 256
    xq_dev = torch.from_numpy(xq[:BATCH]).to(dev)
    perm, pcols_s, cm2, cmap, ndropped = _dyn_inputs(xq_dev, br, NPROBE, qt, msteps)
    xq_p = _pad_dims(xq_dev[perm], br)
    args = (xq_p, br["yT"], br["n2s"], cmap, qt, base.FUSED_CT)
    pen = dict(biasg=torch.where(_probe_mask(cm2, pcols_s), 0.0, 1e9),
               lid=br["lid"], cgroup=br["cgroup"])
    n2 = br["n2s"][0].cpu().numpy()
    variants = k1_variants(
        fused_knn, f"sub-batch 0 [{BATCH} q, {cmap.shape[1]} steps, ndropped "
        f"{int(ndropped)}]", args, pen, second_plane(br["yT"]),
        (xq_p.cpu().numpy() ** 2).sum(1), n2, 20, d=D)
    max_abs_err, ms, plain_ms = variants["soft"]
    real_cols = int((cmap != br["nchunks"]).sum(1).float().mean()) * base.FUSED_CT
    print(f"note: cuBLAS bf16 torch.mm of K1's two products over the mean "
          f"tile's real worklist columns ({BATCH} q x {real_cols}), no select: "
          f"{tc_products_ms(xq_p, br['yT'], None, real_cols, 20):.3f} ms", flush=True)
    t_search, times = host_median(lambda: index.search(xq, K))
    print(f"search of {NQ} queries: median {t_search * 1e3:.1f} ms over 5 "
          f"({', '.join(f'{t * 1e3:.1f}' for t in times)}) -> "
          f"{NQ / t_search:.0f} QPS; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    k1 = entry("ivf_recon_fused_dyn", "faiss_tpu_torch/csrc/ivf_recon_dyn.cu",
               "faiss_tpu/ops/pallas_knn.py:1249", launches, max_abs_err, ms,
               plain_ms, *dyn_cost(br, cmap, qt, br["yT"], (xq_p,), False))
    out, k2_ivf = strict_and_adc_phases(fused_knn, base, index, br, xb, xq,
                                        gt, dev, msteps)
    return [k1] + out, k2_ivf, state


def d64_rows(xb, xq, dev):
    """float64 squared L2 of the first EXACT_ROWS queries to every stored
    row, on the card: ([EXACT_ROWS, NB], max |y|^2)."""
    y = torch.from_numpy(xb).to(dev, torch.float64)
    q = torch.from_numpy(xq[:EXACT_ROWS]).to(dev, torch.float64)
    yn = y.square().sum(1)
    d = q.square().sum(1)[:, None] + yn[None] - 2.0 * (q @ y.T)
    return d, float(yn.max())


def range_check(what, res, xq, radius, d64, ymax, cand_of=None):
    """Phase D: each of the first EXACT_ROWS queries' result set equals
    float64's (rows ``d64``, over ``cand_of(q)`` where given, else every
    row) apart from entries within 1e-5 * (|q|^2 + max |y|^2) of the
    radius; shared entries' distances agree within it."""
    qn = (xq[:EXACT_ROWS].astype(np.float64) ** 2).sum(1)
    total = edge = 0
    for q in range(EXACT_ROWS):
        dq = d64[q]
        if cand_of is None:
            ids = torch.nonzero(dq < radius)[:, 0]
        else:
            c = torch.from_numpy(np.asarray(cand_of(q), np.int64)).to(dq.device)
            ids = c[dq[c] < radius]
        want = dict(zip(ids.cpu().tolist(), dq[ids].cpu().tolist()))
        lo, hi = int(res.lims[q]), int(res.lims[q + 1])
        got = dict(zip(res.labels[lo:hi].tolist(), res.distances[lo:hi].tolist()))
        t = 1e-5 * (qn[q] + ymax)
        check(len(got) == hi - lo, f"{what}: row {q} returns an id twice")
        for a, b in ((want, got), (got, want)):
            for i in set(a) - set(b):
                di = float(d64[q, i])
                check(abs(di - radius) <= t, f"{what}: row {q} id {i} at {di:.6g} "
                                             f"is on one side only, radius {radius:.6g}")
                edge += 1
        for i in set(got) & set(want):
            check(abs(got[i] - want[i]) <= t, f"{what}: row {q} id {i} distance "
                                              f"{got[i]} vs float64 {want[i]}")
        total += len(want)
    print(f"{what}: {EXACT_ROWS} rows equal float64's sets ({total} entries, "
          f"{edge} on one side only, within tolerance of the radius); lims total "
          f"{int(res.lims[-1])}, per row min/median/max "
          f"{np.diff(res.lims.astype(np.int64)).min()}/"
          f"{int(np.median(np.diff(res.lims.astype(np.int64))))}/"
          f"{np.diff(res.lims.astype(np.int64)).max()}", flush=True)


def refine_sq8_phases(ft, fused_knn, state, xb, xt, xq, gt, dev):
    """Phases A and B's IVF-PQ part: IDMap2,IVF4096,PQ32x4fs,Refine(SQ8)
    from phase 4's trained coarse quantizer and PQ, added with seeded
    64-bit ids; the main-path search (K1, fused re-rank on the SQ8 codes),
    then a selector through the eager path (by probe, no kernel)."""
    from faiss_tpu_torch.convert import ivfpq_from_arrays
    from faiss_tpu_torch.utils.evaluation import recall_at_k

    base = ivfpq_from_arrays(state["cent"], state["pq"],
                             np.zeros((0, M), np.uint8), [], [], device=dev)
    base.nprobe, base.strict_probe, base.pipeline_batch = NPROBE, False, BATCH
    sq8 = ft.IndexFlatSQ8(D, device=dev)
    ext = np.random.RandomState(7).permutation(NB).astype(np.int64) + (1 << 40)
    torch.cuda.synchronize()
    t0 = time.time()
    sq8.train(xt)
    refine = ft.IndexRefine(base, sq8)
    refine.k_factor = K_FACTOR
    index = ft.IndexIDMap2(refine)
    index.add_with_ids(xb, ext)
    codes = sq8._consolidate()
    torch.cuda.synchronize()
    t_add = time.time() - t0
    nbytes = codes.numel() * codes.element_size()
    check(codes.dtype == torch.uint8 and tuple(codes.shape) == (NB, D)
          and nbytes == NB * D, "A. the SQ8 store is not one byte a dimension")
    print(f"A. IDMap2,IVF4096,PQ32x4fs,Refine(SQ8): SQ8 train + add of {NB} "
          f"vectors with 64-bit ids {t_add:.2f} s; SQ8 store {nbytes / 2**20:.1f} "
          f"MiB, {nbytes / (NB * D):.0f} byte a dimension ({CARD})", flush=True)

    # the path, with the launch counts read around it
    reset_counts(fused_knn)
    t0 = time.time()
    Dm, Im = index.search(xq, K)
    torch.cuda.synchronize()
    first = time.time() - t0
    n = fused_knn.ivf_recon_fused_dyn.launches
    check(n > 0, "A. Refine(SQ8) launched K1 no time")
    check(Dm.shape == Im.shape == (NQ, K) and np.isfinite(Dm).all()
          and np.isin(Im, ext).all(), "A. invalid ids or distances")
    # the ids are id_map[...] of the inner index's own search: a pair of
    # searches with the worklist length held at the bucket the first search
    # sized (collect widens an adaptive bucket after a dropped chunk). K1's
    # select is exact up to ties: where its keys tie at the candidate cut
    # (4-bit codes of one list often do) the two searches may re-rank other
    # candidates, so the ids are held to the translation on the rows whose
    # re-ranked distances came back equal, and those rows must be nearly all
    ymax = float(sq8._norms.max())
    tol = 1e-5 * ((xq.astype(np.float64) ** 2).sum(1) + ymax)
    base.dyn_msteps = base._dyn_bucket[NPROBE]
    Di, Ii = refine.search(xq, K)
    Dm, Im = index.search(xq, K)
    base.dyn_msteps = 0
    other = rows_equal_up_to_k1_ties(
        "A. the ids against id_map of the inner index's search",
        Di, ext[Ii], Dm, Im)
    # every distance of both: the exact squared L2 to the SQ8 reconstruction
    # of its id
    errs = []
    for what, Dx, Ix in (("IDMap2", Dm, Im), ("inner", Di, ext[Ii])):
        y = index.reconstruct_batch(Ix.ravel()).reshape(NQ, K, D).astype(np.float64)
        errs.append(np.abs(Dx - ((xq[:, None, :].astype(np.float64) - y) ** 2).sum(-1)))
        check((errs[-1] <= tol[:, None]).all(), f"A. {what}: distances differ from "
              f"float64 to the SQ8 reconstruction by {errs[-1].max():.3e}")
    err = max(e.max() for e in errs)
    recall = recall_at_k(Im, ext[gt], K)
    med, times = host_median(lambda: index.search(xq, K))
    print(f"A. search of {NQ} queries, nprobe=1 soft, k_factor={K_FACTOR}: K1 x{n} "
          f"({fused_knn.ivf_recon_fused_dyn.splits} worklist splits); first call "
          f"{first:.3f} s; distances exact to the SQ8 reconstruction (max err "
          f"{err:.3e}); ids = id_map of the inner search on the "
          f"{NQ - other} of {NQ} rows whose distances came back equal "
          f"(the rest re-ranked other candidates tied at K1's cut); recall@10 "
          f"{recall:.4f} (SQ8) beside phase 5's {state['recall']:.4f} (fp16); "
          f"median {med * 1e3:.1f} ms over 5 "
          f"({', '.join(f'{t * 1e3:.1f}' for t in times)}) -> {NQ / med:.0f} QPS "
          f"({CARD})", flush=True)

    # B. a selector over half of the external ids: the eager path (the base
    # by probe with the selector, then the re-rank on the SQ8 codes)
    lo_id, hi_id = 1 << 40, (1 << 40) + NB // 2
    params = ft.SearchParametersIVF(sel=ft.IDSelectorRange(lo_id, hi_id))
    xs = xq[:1024]
    Db, Ib = no_kernel(fused_knn, "B. IDSelectorRange on Refine(SQ8), 1024 q",
                       lambda: index.search(xs, K, params=params))
    check(((Ib == -1) | ((Ib >= lo_id) & (Ib < hi_id))).all(),
          "B. an id outside the selector came back")
    # every row against float64: its results are the best K, on the SQ8
    # reconstruction, of kc candidates that are the best kc by ADC among the
    # selected entries of its probed list (float64 ADC of the PQ
    # reconstruction; candidates within the tolerance of the kc-th are
    # either side of the cut, as 4-bit codes tie)
    kc = K * K_FACTOR
    lists = base._coarse_search(torch.from_numpy(xs).to(dev), 1)[1][:EXACT_ROWS]
    lists = lists[:, 0].cpu().numpy()
    kept = (ext >= lo_id) & (ext < hi_id)
    pos_of = np.empty(NB, np.int64)
    pos_of[ext - lo_id] = np.arange(NB)
    qn = (xs.astype(np.float64) ** 2).sum(1)
    ties = 0
    for q in range(EXACT_ROWS):
        pos = np.nonzero((base._listnos_host == lists[q]) & kept)[0]
        recon = base.decode_vectors(base._codes_host[pos], base._listnos_host[pos])
        adc = ((recon.astype(np.float64) - xs[q]) ** 2).sum(1)
        t_adc = 1e-5 * (qn[q] + float((recon.astype(np.float64) ** 2).sum(1).max()))
        sure = maybe = pos
        if len(pos) > kc:
            cut = np.sort(adc)[kc - 1]
            sure, maybe = pos[adc < cut - t_adc], pos[adc <= cut + t_adc]
            ties += len(maybe) > kc
        got = Ib[q][Ib[q] >= 0]
        gp = pos_of[got - lo_id]
        t = 1e-5 * (qn[q] + ymax)
        d_got = ((sq8.reconstruct_batch(gp).astype(np.float64) - xs[q]) ** 2).sum(1)
        rest = np.setdiff1d(sure, gp)
        d_rest = ((sq8.reconstruct_batch(rest).astype(np.float64) - xs[q]) ** 2).sum(1)
        check(len(got) == min(K, len(pos)) and np.isin(gp, maybe).all()
              and (np.abs(Db[q][: len(got)] - d_got) <= t).all()
              and (len(got) < K or (d_rest >= Db[q][K - 1] - t).all()),
              f"B. row {q} differs from float64 over its selected candidates")
    med, _ = host_median(lambda: index.search(xs, K, params=params))
    print(f"B. Refine(SQ8) with IDSelectorRange over half the ids: {EXACT_ROWS} "
          f"rows agree with float64 (ADC over the selected entries of the probed "
          f"list, top {kc}, re-ranked on the SQ8 reconstruction; {ties} rows with "
          f"ADC ties at the candidate cut); median {med * 1e3:.1f} ms per 1024 q "
          f"({CARD})", flush=True)


def flat_rest_phases(ft, fused_knn, xb, xq, dev, radius):
    """Phase B's flat part (an IDSelectorBatch of 100,000 ids, the masked
    plain k-NN) and phase D's (range search) on IndexFlatL2 over the 1M
    store, against float64."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    flat = ft.IndexFlatL2(D, device=dev)
    flat.add(xb)
    flat._consolidate()
    d64, ymax = d64_rows(xb, xq, dev)
    ids = np.sort(np.random.RandomState(8).choice(NB, 100_000, replace=False))
    params = ft.SearchParameters(sel=ft.IDSelectorBatch(ids))
    xs = xq[:1024]
    Df, If = no_kernel(fused_knn, "B. IDSelectorBatch of 100000 ids on "
                       "IndexFlatL2, 1024 q", lambda: flat.search(xs, K, params=params))
    check(np.isin(If, ids).all(), "B. flat: an id outside the selector came back")
    sub = d64[:, torch.from_numpy(ids).to(dev)]
    vals, pos = torch.topk(sub, K, largest=False)
    want_d, want_i = vals.cpu().numpy(), ids[pos.cpu().numpy()]
    tol = 1e-5 * ((xs[:EXACT_ROWS].astype(np.float64) ** 2).sum(1) + ymax)
    err = np.abs(Df[:EXACT_ROWS] - want_d)
    check((err <= tol[:, None]).all()
          and ids_agree_tie_aware(want_d, want_i, Df[:EXACT_ROWS], If[:EXACT_ROWS],
                                  tol).all(),
          "B. flat: rows differ from float64 over the selected rows")
    med, _ = host_median(lambda: flat.search(xs, K, params=params))
    print(f"B. flat selector: {EXACT_ROWS} rows exact vs float64 over the selected "
          f"rows (max err {err.max():.3e}); median {med * 1e3:.1f} ms per 1024 q "
          f"({CARD})", flush=True)
    res = no_kernel(fused_knn, "D. IndexFlatL2 range_search, 64 queries",
                    lambda: flat.range_search(xq[:EXACT_ROWS], radius))
    range_check(f"D. IndexFlatL2 (radius {radius:.4f})", res, xq, radius, d64, ymax)
    med, _ = host_median(lambda: flat.range_search(xq[:EXACT_ROWS], radius))
    print(f"D. IndexFlatL2 range_search median {med * 1e3:.1f} ms per 64 q "
          f"({CARD})", flush=True)


def ivfflat_ip_phase(ft, fused_knn, xb, xt, xq, dev):
    """Phase E: IndexIVFFlat(128, 4096, METRIC_INNER_PRODUCT), trained by
    spherical k-means on the 200k training vectors; 1024 queries at
    nprobe 16 by probe; 64 rows against float64 over the probed lists,
    largest first."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    index = ft.IndexIVFFlat(None, D, NLIST, ft.METRIC_INNER_PRODUCT, device=dev)
    took = []
    for step in (lambda: index.train(xt), lambda: index.add(xb)):
        torch.cuda.synchronize()
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        took.append(time.time() - t0)
    norms = np.linalg.norm(index.quantizer.vectors(), axis=1)
    check(index.cp.spherical and np.abs(norms - 1).max() < 1e-4,
          "E. the coarse centroids are not unit-norm")
    index.nprobe = 16
    xs = xq[:1024]
    Dx, Ix = no_kernel(fused_knn, "E. IVF-Flat IP, 1024 q, nprobe=16",
                       lambda: index.search(xs, K))
    check(np.isfinite(Dx).all() and (Ix >= 0).all()
          and (np.diff(Dx, axis=1) <= 0).all(), "E. invalid or unsorted results")
    lists = index._coarse_search(torch.from_numpy(xs).to(dev), 16)[1]
    lists = lists[:EXACT_ROWS].cpu().numpy()
    ln = index._listnos_host
    order = np.argsort(ln, kind="stable")
    offs = np.concatenate([[0], np.cumsum(np.bincount(ln, minlength=NLIST))])
    ymax = float((xb.astype(np.float64) ** 2).sum(1).max())
    err = 0.0
    for q in range(EXACT_ROWS):
        ids = np.concatenate([order[offs[li] : offs[li + 1]] for li in lists[q]])
        ip = xb[ids].astype(np.float64) @ xs[q].astype(np.float64)
        o = np.argsort(-ip, kind="stable")[:K]
        t = 1e-5 * (float((xs[q].astype(np.float64) ** 2).sum()) + ymax)
        e = np.abs(Dx[q] - ip[o])
        check((e <= t).all() and ids_agree_tie_aware(
            -ip[o][None], ids[o][None], -Dx[q][None], Ix[q][None], t).all(),
            f"E. row {q} differs from float64 over its probed lists")
        err = max(err, float(e.max()))
    med, times = host_median(lambda: index.search(xs, K))
    print(f"E. IndexIVFFlat(128, {NLIST}, METRIC_INNER_PRODUCT): train "
          f"{took[0]:.2f} s (spherical, {index.cp.niter} iterations), add "
          f"{took[1]:.2f} s; {EXACT_ROWS} rows equal float64 over the probed "
          f"lists, largest first (max err {err:.3e}); median {med * 1e3:.1f} ms "
          f"per 1024 q over 5 -> {len(xs) / med:.0f} QPS ({CARD})", flush=True)


def dyn_cost(br, cmap, qt, store, per_query, lid, planes=1, d=None):
    """(operations' seconds, bytes) of a worklist scan (K1, K5) in this run:
    every query scores the vector-holding slots of its tile's non-PAD
    worklist chunks (ops_s); the store columns of the worklists' union are
    read once (``planes`` of them: 2 for hi/lo) with their n2 (and lid),
    the per-query inputs and the worklists once; three [nq, 128] outputs.
    ``d`` reckons the products and the store's bytes at d dimensions in
    place of its d_pad rows (the queries as given)."""
    nch = br["nchunks"]
    ct = store.shape[1] // (nch + 1)
    held = torch.isfinite(br["n2s"][0]).reshape(nch + 1, ct).sum(1)
    real = cmap != nch
    keys = int(held[cmap.long()][real].sum()) * qt
    union = int(torch.unique(cmap[real]).numel()) * ct
    per_col = planes * (d or store.shape[0]) * store.element_size() + 4 + 4 * lid
    nq = cmap.shape[0] * qt
    return (ops_s(store, keys, planes, d=d),
            union * per_col + nbytes(cmap, *per_query) + 3 * nq * 512)


def scan_cost(store, n2s, nq, per_query, lid, planes=1):
    """(operations' seconds, bytes) of an exhaustive scan (K2, K4): every
    query scores every vector-holding slot (ops_s); every column of the
    store (``planes`` of them: 2 for hi/lo) is read once with n2 (and
    lid)."""
    S = store.shape[1]
    per_col = planes * store.shape[0] * store.element_size() + 4 + 4 * lid
    keys = nq * int(torch.isfinite(n2s).sum())
    return (ops_s(store, keys, planes),
            S * per_col + nbytes(*per_query) + 3 * nq * 512)


def lanes_check(fused_knn, what, kern, plain, qn2, n2, recon=None):
    """A kernel against its plain version on the same inputs (keys within
    lane_tol, ids tie-aware, floor all +inf); with ``recon`` ("K1", "K2",
    "K4" or "K5") the launch's splits (and K1's or K5's skipped PAD steps)
    are printed. Returns max_abs_err."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    fused_knn.pad_steps_skipped(reset=True)
    fused_knn.pad_steps_skipped(reset=True, kernel="K5")
    kk, ks, kf = kern()
    rk, rs_, _ = plain()
    torch.cuda.synchronize()
    if recon:
        print(f"{what}: {recon_note(fused_knn, recon)}", flush=True)
    check(bool(torch.isinf(kf).all()), f"{what}: floor is not all +inf")
    tol = lane_tol(qn2, n2, rk.cpu().numpy(), rs_.cpu().numpy())
    return compare_lanes(kk, ks, rk, rs_, tol, what, ids_agree_tie_aware)


def kernel_check(fused_knn, what, kern, plain, qn2, n2, reps, recon=None):
    """lanes_check, then the kernel and its plain version timed in turns.
    Returns (max_abs_err, kernel ms, plain ms)."""
    err = lanes_check(fused_knn, what, kern, plain, qn2, n2, recon)
    ms, plain_ms, t = turns(plain, kern, reps)
    print(f"{what} vs plain: max_abs_err {err:.3e}, ids agree on all rows; "
          f"{t[1]:.2f} / {t[2]:.2f} ms, plain {t[0]:.2f} / {t[3]:.2f} ms",
          flush=True)
    return err, ms, plain_ms


def second_plane(yT):
    """A second bf16 plane of the store's shape for K1's hi/lo variants
    where the store has one: its values times 2^-8 (zero where it is)."""
    return (yT.float() * 2.0**-8).to(torch.bfloat16)


def k1_variants(fused_knn, what, args, pen, lo, qn2, n2, reps, d=None):
    """K1 in its four variants on one sub-batch's inputs ``args`` (xq_p, yT,
    n2s, cmap, qt, ct): soft, penalized (``pen``: biasg, lid, cgroup), and
    both over the second plane ``lo``; each against its plain version
    (keys within lane_tol, ids tie-aware, the floor all +inf) and timed with
    it in turns by CUDA events. ``d``: the real dims, which the kernel alone
    multiplies. Returns {variant: (max_abs_err, kernel ms, plain ms)}."""
    out = {}
    for name, kw in (("soft", {}), ("penalized", pen), ("soft + hi/lo", dict(yT_lo=lo)),
                     ("penalized + hi/lo", dict(pen, yT_lo=lo))):
        kw = dict(kw, d=d)
        out[name] = kernel_check(
            fused_knn, f"{what} K1 {name}",
            lambda: fused_knn.ivf_recon_fused_dyn(*args, **kw),
            lambda: fused_knn.ivf_recon_fused_dyn_ref(*args, **kw), qn2, n2, reps,
            recon="K1")
    return out


def counted(fused_knn, what, fn, count):
    """Run fn with every launch count set to 0 just before and read just
    after; ``count()`` (the path's kernel) must have launched."""
    reset_counts(fused_knn)
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    n = count()
    check(n > 0, f"{what} launched its kernel no time")
    print(f"{what}: {time.time() - t0:.3f} s (first call), {n} launches",
          flush=True)
    return out, n


def time_search(what, fn, n):
    """Host-clock median of 5 calls of a search of n queries."""
    med, times = host_median(fn)
    print(f"{what} search of {n} queries: median {med * 1e3:.1f} ms over 5 "
          f"({', '.join(f'{t * 1e3:.1f}' for t in times)}) -> {n / med:.0f} QPS",
          flush=True)


def refined(index, x, k=K):
    """index.search through search_submit / search_collect, with each
    sub-batch's dropped probed chunks: (D, I, [(start, real, ndropped)])."""
    handle = index.search_submit(x, k)
    drops = [(st, real, int(out[2])) for st, real, out, _ in handle[1]["pending"]]
    D, I = index.search_collect(handle)
    return D, I, drops


def undropped(drops, n):
    ok = np.zeros(n, bool)
    for st, real, nd in drops:
        ok[st : st + real] = nd == 0
    return ok


def strict_and_adc_phases(fused_knn, base, index, br, xb, xq, gt, dev, msteps):
    """Phases 8-14 on the trained 1M index: the unrefined search (K4), the
    strict refined searches (K2 masked, K1 penalized), the exhaustive one
    (K2), the four kernels against their plain versions, and without the
    decoded store the code-streaming searches (K5, K4). Returns the entries
    of K4, K5, K1 penalized and K2 masked, and K2's unmasked launches and
    max_abs_err."""
    from faiss_tpu_torch.models import ivf_pq as P
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware, recall_at_k

    ct, G = base.FUSED_CT, br["cn2g"].shape[0] // 128
    sm = br["slot_map"]
    S = len(sm)
    valid = sm >= 0
    pos_of = np.empty(int(valid.sum()), np.int64)  # input slot -> position
    pos_of[sm[valid]] = np.where(valid)[0]
    lid = br["lid"][0].cpu().numpy()
    col_of = np.minimum(np.arange(S) // ct // br["cpg"], G - 1) * 128 + lid
    col_of[~valid] = -1
    col_size = np.bincount(col_of[valid], minlength=G * 128)
    xq_all = torch.from_numpy(xq).to(dev)
    key = br["cn2g"][None] - 2.0 * (xq_all @ br["centroids_g"].T)
    probe = torch.topk(key, 1, largest=False).indices[:, 0].cpu().numpy()
    kc = K * K_FACTOR
    full = col_size[probe] >= kc  # rows whose probed list holds kc slots
    xb16 = xb.astype(np.float16).astype(np.float32)

    def slot_cols(I):
        return np.where(I >= 0, col_of[pos_of[np.maximum(I, 0)]], -1)

    def exact_fp16(D, I, what, rows=256):
        d_chk = ((xq[:rows, None, :] - xb16[I[:rows]]) ** 2).sum(-1)
        check(np.allclose(D[:rows], d_chk, rtol=1e-4, atol=1e-3),
              f"{what}: distances are not the exact L2 to the fp16 store")

    def tie_tol(D):  # exact re-ranked distances: float32 ties
        return 1e-5 * np.abs(np.where(np.isfinite(D), D, 0)).max(1)

    # 8. unrefined IndexIVFPQFastScan.search (K4), checked against a float64
    # ADC of the same bf16 LUTs, codes, n2 and coarse term on 64 rows
    (Du, Iu), k4_launches = counted(
        fused_knn, f"8. unrefined search, nprobe={NPROBE} (K4)",
        lambda: base.search(xq, K), lambda: fused_knn.ivfpq_fused.launches)
    k4_on_tensor_cores(fused_knn, "8. unrefined search", k4_launches)
    check(Du.shape == Iu.shape == (NQ, K), f"unrefined result shape {Du.shape}")
    check(((Iu >= -1) & (Iu < NB)).all() and np.isfinite(Du[Iu >= 0]).all()
          and np.isinf(Du[Iu < 0]).all(), "unrefined: invalid ids or distances")
    r = EXACT_ROWS
    qn2 = xq_all.double().square().sum(1).cpu().numpy()
    codes = br["codesT"].long()
    M = codes.shape[0]
    moff = (torch.arange(M, device=dev) * (br["cbt"].shape[1] // M))[:, None]
    n2d = br["n2s"][0].double()
    yT = br["yT"]
    cold = torch.from_numpy(np.maximum(col_of, 0)).to(dev)
    cent64 = br["centroids_g"].double()

    def adc64(q, pos):
        """float64 ADC distances of query q to packed positions, from the
        same bf16 LUTs, codes, n2 and coarse term as K4 and K5."""
        x = xq_all[q : q + 1]
        lut = P._adc_luts(x, br["cbt"]).double()[0]
        cm = -2.0 * (x.double() @ cent64.T)[0]
        p = torch.as_tensor(pos, device=dev)
        return (n2d[p] + cm[cold[p]] + lut[codes[:, p] + moff].sum(0)
                + qn2[q]).cpu().numpy()

    def recon64(q, pos):
        """float64 keys n2 - 2 q.y of query q over the bf16 decoded store,
        as K1 and K2 rank them."""
        p = torch.as_tensor(pos, device=dev)
        return (n2d[p] - 2.0 * (xq_all[q].double() @ yT[:, p].double())).cpu().numpy()

    n2max = float(br["n2s"][torch.isfinite(br["n2s"])].max())
    tol = 1e-5 * (qn2[:r] + n2max)

    def agree_at_cut(rows, Da, Ia, Db, Ib, key64, what):
        """Two strict refined results of the same probed lists on ``rows``:
        ids agree tie-aware, except that an id one result ranks clearly
        inside the other's may be a candidate whose key ties, within
        1e-5 * (|q|^2 + max n2), with the kc-th key of the probed list: at
        that cut either of the tied candidates may reach the re-rank. Prints
        and returns the rows that differed at the cut."""
        tie = tie_tol(Da)
        agree = ids_agree_tie_aware(Da[rows], Ia[rows], Db[rows], Ib[rows],
                                    tie[rows])
        cut = 0
        for q in np.where(rows)[0][~agree]:
            bad = []
            for Dx, Ix, Dy, Iy in ((Da, Ia, Db, Ib), (Db, Ib, Da, Ia)):
                only = ~np.isin(Ix[q], Iy[q]) & (Dx[q] < Dy[q][-1] - tie[q])
                bad += list(Ix[q][only])
            keys = key64(q, np.where(col_of == probe[q])[0])
            kth = np.sort(keys)[kc - 1]
            kb = key64(q, pos_of[np.asarray(bad)])
            check((np.abs(kb - kth) <= 1e-5 * (qn2[q] + n2max)).all(),
                  f"{what}: row {q} differs beyond a tie at the candidate cut "
                  f"(keys {kb} against the kc-th {kth})")
            cut += 1
        print(f"{what}: ids agree tie-aware on {int(rows.sum()) - cut} of "
              f"{int(rows.sum())} rows; {cut} differ only by candidates tied "
              f"at the kc-th key", flush=True)
    err = 0.0
    bf_d = np.full((r, K), np.inf)
    bf_i = np.full((r, K), -1)
    for q in range(r):
        got = Iu[q] >= 0
        if got.any():
            e = np.abs(Du[q, got] - adc64(q, pos_of[Iu[q, got]]))
            err = max(err, float(e.max()))
            check((e <= tol[q]).all(), f"unrefined: row {q} distances differ "
                                       f"from the float64 ADC by {e.max():.3e}")
        lst = np.where(col_of == probe[q])[0]
        d = adc64(q, lst)
        o = np.argsort(d, kind="stable")[:K]
        bf_d[q, : len(o)] = d[o]
        bf_i[q, : len(o)] = base._ids_host[sm[lst[o]]]
    agree = ids_agree_tie_aware(bf_d, bf_i, Du[:r], Iu[:r], tol)
    check(agree.all(), f"unrefined: ids differ from the float64 ADC brute force "
                       f"over the probed list on {int((~agree).sum())} rows")
    print(f"unrefined: {r} rows match a float64 ADC (max err {err:.3e}) and its "
          f"brute force over the probed list; recall@10 "
          f"{recall_at_k(Iu, gt, K):.4f}; {int((Iu < 0).sum())} empty results "
          "(probed lists shorter than k)", flush=True)
    time_search("unrefined (K4)", lambda: base.search(xq, K), NQ)

    # 9. refined, strict_probe=True (the default): 128 chunks per worklist
    # exceed dyn_engage_frac * nchunks, so the masked exhaustive scan (K2)
    base.strict_probe = True
    (Ds, Is, _), k2m_launches = counted(
        fused_knn, f"9. refined strict search, nprobe={NPROBE} (K2 masked)",
        lambda: refined(index, xq),
        lambda: fused_knn.ivf_recon_fused.masked_launches)
    check(np.isfinite(Ds).all() and (Is >= 0).all(), "strict: missing results")
    inlist = (slot_cols(Is) == probe[:, None]).all(1)
    check(inlist[full].all(), f"strict: {int((~inlist[full]).sum())} rows with "
                              f"{kc} probed slots return ids of other lists")
    exact_fp16(Ds, Is, "strict")
    print(f"strict: ids in the probed list on all {int(full.sum())} rows whose "
          f"list holds >= {kc} slots; recall@10 {recall_at_k(Is, gt, K):.4f}",
          flush=True)
    time_search("refined strict (K2 masked)", lambda: index.search(xq, K), NQ)

    # 10. kernels against their plain versions on their paths' first
    # sub-batch (keys within lane_tol, ids tie-aware), timed in turns
    n2 = br["n2s"][0].cpu().numpy()
    xq2 = xq_all[:BATCH]
    qt = 256
    out = []
    # K4: the unrefined search's one 8192-query bucket
    cm2 = P._masked_coarse_bias(xq_all, br["centroids_g"], br["cn2g"], NPROBE)
    a4 = (cm2, P._adc_luts(xq_all, br["cbt"]), br["codesT"], br["n2s"], br["lid"])
    err, ms, pms = kernel_check(
        fused_knn, f"K4 [{NQ} q x {S} slots]",
        lambda: fused_knn.ivfpq_fused(*a4, qt=qt, ct=ct),
        lambda: fused_knn.ivfpq_fused_ref(*a4, qt=qt, ct=ct),
        xq_all.square().sum(1).cpu().numpy(), n2, 3, recon="K4")
    out.append(entry("ivfpq_fused", "faiss_tpu_torch/csrc/adc_mma.cuh",
                     "faiss_tpu/ops/pallas_knn.py:1484", k4_launches, err, ms,
                     pms, *scan_cost(br["codesT"], br["n2s"], len(xq_all), a4[:2],
                                     True)))
    # K5: the first soft refined sub-batch without a decoded store
    perm, pcols_s, cm2, cmap, _ = P._dyn_inputs(xq2, br, NPROBE, qt, msteps)
    xs = xq2[perm]
    cm2_s = torch.where(P._probe_mask(cm2, pcols_s), cm2[perm], 1e9)
    a5 = (cm2_s, P._adc_luts(xs, br["cbt"]), br["codesT"], br["n2s"], br["lid"],
          cmap, br["cgroup"])
    k5 = kernel_check(
        fused_knn, f"K5 [{BATCH} q, {cmap.shape[1]} steps]",
        lambda: fused_knn.ivfpq_fused_dyn(*a5, qt=qt, ct=ct),
        lambda: fused_knn.ivfpq_fused_dyn_ref(*a5, qt=qt, ct=ct),
        xs.square().sum(1).cpu().numpy(), n2, 5, recon="K5")
    k5_cost = dyn_cost(br, cmap, qt, br["codesT"], a5[:2], True)
    # K1 penalized: the first strict sub-batch at dyn_engage_frac = 0.7
    pen = torch.where(P._probe_mask(cm2, pcols_s), 0.0, 1e9)
    a1 = (P._pad_dims(xs, br), br["yT"], br["n2s"], cmap, qt, ct)
    kw1 = dict(biasg=pen, lid=br["lid"], cgroup=br["cgroup"])
    k1p = kernel_check(
        fused_knn, f"K1 penalized [{BATCH} q, {cmap.shape[1]} steps]",
        lambda: fused_knn.ivf_recon_fused_dyn(*a1, **kw1),
        lambda: fused_knn.ivf_recon_fused_dyn_ref(*a1, **kw1),
        xs.square().sum(1).cpu().numpy(), n2, 10, recon="K1")
    k1p_cost = dyn_cost(br, cmap, qt, br["yT"], (a1[0], pen), True)
    # K5 beside K1 soft over the same worklists (K1 over the decoded store),
    # both timed in turns: K5, K1, K1, K5
    k5f = lambda: fused_knn.ivfpq_fused_dyn(*a5, qt=qt, ct=ct)  # noqa: E731
    k1f = lambda: fused_knn.ivf_recon_fused_dyn(*a1)  # noqa: E731
    tt = [cuda_ms(f, 10) for f in (k5f, k1f, k1f, k5f)]
    print(f"10. K5 {tt[0]:.3f} / {tt[3]:.3f} ms, K1 soft {tt[1]:.3f} / "
          f"{tt[2]:.3f} ms over the same {cmap.shape[1]}-step worklists of "
          f"{BATCH} q: K5/K1 = {(tt[0] + tt[3]) / (tt[1] + tt[2]):.3f}", flush=True)
    # K2 masked: the first strict sub-batch
    mask = torch.where(P._probed(xq2, br["centroids_g"], br["cn2g"], NPROBE)[1],
                       0.0, 1e9)
    a2 = (P._pad_dims(xq2, br), br["yT"], br["n2s"])
    kw2 = dict(qt=qt, ct=ct, biasg=mask, lid=br["lid"])
    err, ms, pms = kernel_check(
        fused_knn, f"K2 masked [{BATCH} q x {S} slots]",
        lambda: fused_knn.ivf_recon_fused(*a2, **kw2),
        lambda: fused_knn.ivf_recon_fused_ref(*a2, **kw2),
        xq2.square().sum(1).cpu().numpy(), n2, 3, recon="K2")
    out.append(entry("ivf_recon_fused[masked]", "faiss_tpu_torch/csrc/ivf_recon.cu",
                     "faiss_tpu/ops/pallas_knn.py:1362", k2m_launches, err, ms,
                     pms, *scan_cost(br["yT"], br["n2s"], len(xq2), (a2[0], mask),
                                     True)))
    # K2 unmasked, as phase 12 runs it: the same sub-batch with no mask
    k2_err = kernel_check(
        fused_knn, f"K2 one plane [{BATCH} q x {S} slots]",
        lambda: fused_knn.ivf_recon_fused(*a2, qt=qt, ct=ct),
        lambda: fused_knn.ivf_recon_fused_ref(*a2, qt=qt, ct=ct),
        xq2.square().sum(1).cpu().numpy(), n2, 1, recon="K2")[0]
    del a1, a2, a4, a5, kw1, kw2, pen, mask, cm2, cm2_s

    # 11. the same with dyn_engage_frac = 0.7: K1 penalized
    base.dyn_engage_frac = 0.7
    (Dp, Ip, drops), k1p_launches = counted(
        fused_knn, "11. refined strict search, dyn_engage_frac=0.7 (K1 penalized)",
        lambda: refined(index, xq),
        lambda: fused_knn.ivf_recon_fused_dyn.penalized_launches)
    rows = undropped(drops, NQ) & full
    inlist_p = (slot_cols(Ip) == probe[:, None]).all(1)
    check(inlist_p[rows].all(), f"K1 penalized: {int((~inlist_p[rows]).sum())} "
                                "rows return ids of other lists")
    print(f"K1 penalized: drops per sub-batch {[d for _, _, d in drops]}; ids "
          f"in the probed list on all {int(rows.sum())} rows of undropped "
          f"sub-batches whose list holds >= {kc} slots", flush=True)
    agree_at_cut(rows, Ds, Is, Dp, Ip, recon64, "K1 penalized vs K2 masked")
    time_search("refined strict (K1 penalized)", lambda: index.search(xq, K), NQ)
    out.insert(1, entry("ivf_recon_fused_dyn[penalized]",
                        "faiss_tpu_torch/csrc/ivf_recon_dyn.cu",
                        "faiss_tpu/ops/pallas_knn.py:1249", k1p_launches, *k1p,
                        *k1p_cost))
    base.dyn_engage_frac = 0.08

    # 12. nprobe = 0 on 2048 queries: the exhaustive scan (K2 unmasked)
    base.nprobe = 0
    nq0 = 2048
    (D0, I0, _), k2_ivf_launches = counted(
        fused_knn, f"12. refined search, nprobe=0, {nq0} queries (K2)",
        lambda: refined(index, xq[:nq0]),
        lambda: fused_knn.ivf_recon_fused.launches
        - fused_knn.ivf_recon_fused.masked_launches)
    exact_fp16(D0, I0, "nprobe=0")
    print(f"nprobe=0: recall@10 {recall_at_k(I0, gt[:nq0], K):.4f}", flush=True)
    time_search("refined nprobe=0 (K2)", lambda: index.search(xq[:nq0], K), nq0)
    base.nprobe = NPROBE

    # 12a-12c. K6 and K7 on the staged layout, then the per-probe and XLA
    # ADC scans of the same index
    out += onehot_adc_phases(fused_knn, base, br, xq, gt, dev)
    out.append(floor_phase(fused_knn, base, br, xq_all, dev))
    probe_and_xla_phases(fused_knn, base, br, xq, gt, dev)

    # 13-14. without the decoded store: soft (K5) and strict (K4)
    base.recon_scan_max_bytes = 0
    base._brute = None
    t0 = time.time()
    br = base._build_brute()
    torch.cuda.synchronize()
    check(br["yT"] is None, "the decoded store was staged above the cap")
    print(f"restaged without the decoded store in {time.time() - t0:.2f} s",
          flush=True)
    base.strict_probe = False
    P.ivf_fast_scan_stats.reset()
    (Dd, Id, drops), k5_launches = counted(
        fused_knn, "13. refined soft search, no decoded store (K5)",
        lambda: refined(index, xq), lambda: fused_knn.ivfpq_fused_dyn.launches)
    k5_tc = fused_knn.ivfpq_fused_dyn.tc_launches
    k5_splits = fused_knn.ivfpq_fused_dyn.splits
    k5_skipped = fused_knn.pad_steps_skipped(reset=True, kernel="K5")
    msteps = base._dyn_bucket[NPROBE]
    check(k5_tc == k5_launches, f"13.: {k5_launches - k5_tc} of {k5_launches} K5 "
                                "launches took the lookup scan, not the tensor cores")
    check(k5_splits > 1, f"13.: K5 at {BATCH} queries ran {k5_splits} worklist split(s)")
    check(k5_skipped > 0, "13.: K5 skipped no PAD step")
    print(f"13.: all {k5_launches} K5 launches on the tensor cores ({k5_splits} "
          f"worklist splits), {k5_skipped} PAD steps skipped of "
          f"{k5_launches * (BATCH // qt) * msteps} (tiles x msteps); msteps "
          f"{msteps}", flush=True)
    print(f"K5 path: recall@10 {recall_at_k(Id, gt, K):.4f}; "
          f"{P.ivf_fast_scan_stats}", flush=True)
    # K5 against its plain version on every sub-batch of the path, as
    # _fused_search_rerank_dyn hands them to it
    k5_err = k5[0]
    for s0 in range(0, NQ, BATCH):
        xb_ = xq_all[s0 : s0 + BATCH]
        perm, pcols_s, cm2, cmap, nd = P._dyn_inputs(xb_, br, NPROBE, qt, msteps)
        xs = xb_[perm]
        cm2_s = torch.where(P._probe_mask(cm2, pcols_s), cm2[perm], 1e9)
        a5 = (cm2_s, P._adc_luts(xs, br["cbt"]), br["codesT"], br["n2s"],
              br["lid"], cmap, br["cgroup"])
        what = f"13. K5 sub-batch {s0 // BATCH} [{BATCH} q, {msteps} steps, ndropped {int(nd)}]"
        e = lanes_check(fused_knn, what,
                        lambda: fused_knn.ivfpq_fused_dyn(*a5, qt=qt, ct=ct),
                        lambda: fused_knn.ivfpq_fused_dyn_ref(*a5, qt=qt, ct=ct),
                        xs.square().sum(1).cpu().numpy(),
                        br["n2s"][0].cpu().numpy(), recon="K5")
        print(f"{what}: max_abs_err {e:.3e}, ids agree on all rows", flush=True)
        k5_err = max(k5_err, e)
    # a note beside K5 (not its library_ms): its products, the LUTs against
    # the one-hot rows over the mean tile's real worklist columns
    real_cols = int((cmap != br["nchunks"]).sum(1).float().mean()) * ct
    oh_cols = torch.zeros(a5[1].shape[1], real_cols, dtype=a5[1].dtype, device=dev)
    print(f"note: cuBLAS bf16 torch.mm of K5's products ({BATCH} queries' "
          f"LUTs with the {a5[1].shape[1]} one-hot rows over the mean tile's "
          f"real worklist columns, {real_cols}), no bias, no select: "
          f"{onehot_products_ms(a5[1], oh_cols):.3f} ms ({CARD})", flush=True)
    del a5, oh_cols
    dyn_lookup_check(fused_knn, dev, ct, ids_agree_tie_aware)
    time_search("refined soft, no decoded store (K5)", lambda: index.search(xq, K), NQ)
    base.strict_probe = True
    P.ivf_fast_scan_stats.reset()
    (Dk, Ik, _), k4r_launches = counted(
        fused_knn, "14. refined strict search, no decoded store (K4)",
        lambda: refined(index, xq), lambda: fused_knn.ivfpq_fused.launches)
    k4_on_tensor_cores(fused_knn, "14. refined strict search, no decoded store",
                       k4r_launches)
    print(f"K4 path: recall@10 {recall_at_k(Ik, gt, K):.4f}; "
          f"{P.ivf_fast_scan_stats}", flush=True)
    time_search("refined strict, no decoded store (K4)", lambda: index.search(xq, K), NQ)
    # K4 on the first sub-batch of phase 14's path (masked, its columns split
    # across blocks and merged) against its plain version
    a4 = (P._masked_coarse_bias(xq2, br["centroids_g"], br["cn2g"], NPROBE),
          P._adc_luts(xq2, br["cbt"]), br["codesT"], br["n2s"], br["lid"])
    kernel_check(
        fused_knn, f"K4 masked [{BATCH} q x {br['codesT'].shape[1]} slots]",
        lambda: fused_knn.ivfpq_fused(*a4, qt=qt, ct=ct),
        lambda: fused_knn.ivfpq_fused_ref(*a4, qt=qt, ct=ct),
        xq2.square().sum(1).cpu().numpy(), br["n2s"][0].cpu().numpy(), 1,
        recon="K4")
    check(fused_knn.ivfpq_fused.splits > 1,
          f"K4 at {BATCH} queries ran {fused_knn.ivfpq_fused.splits} column split(s)")
    del a4
    exact_fp16(Dd, Id, "K5 path")
    exact_fp16(Dk, Ik, "K4 path")
    rows = undropped(drops, NQ) & full
    agree_at_cut(rows, Dk, Ik, Dd, Id, adc64, "K5 soft vs K4 strict")
    out.insert(1, entry("ivfpq_fused_dyn", "faiss_tpu_torch/csrc/ivfpq_adc.cu",
                        "faiss_tpu/ops/pallas_knn.py:570", k5_launches, k5_err,
                        *k5[1:], *k5_cost))
    out[0]["launches"] += k4r_launches

    # K2's entry (flat_phases) adds phase 12's unmasked launches and error
    return out, (k2_ivf_launches, k2_err)


def onehot_adc_phases(fused_knn, base, br, xq, gt, dev):
    """Phase 12a: K6 over the staged layout's data chunks (the trailing PAD
    chunk, which holds no vector, breaks K6's nchunks % G == 0), bf16 and
    int8 LUTs, on the unmasked coarse term. Returns the entries of its two
    modes in the kernels' JSON line."""
    from faiss_tpu_torch.models import ivf_pq as P
    from faiss_tpu_torch.ops import quantize_lut as Q
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    ct, nch, ksub = base.FUSED_CT, br["nchunks"], base.pq.ksub
    G = br["cn2g"].shape[0] // 128
    check(nch % G == 0 and (nch + 1) % G,
          f"expected {nch} data chunks in {G} groups, + 1 PAD chunk that breaks them")
    Sd = nch * ct
    codesT = br["codesT"][:, :Sd].contiguous()
    n2 = br["n2s"][:, :Sd].contiguous()
    lid = br["lid"][:, :Sd].contiguous()
    oh = {}
    for int8 in (False, True):
        torch.cuda.synchronize()
        t0 = time.time()
        oh[int8] = Q.expand_onehot(codesT, lid, ksub, int8)
        torch.cuda.synchronize()
        print(f"12a. ohT ({'int8' if int8 else 'bf16'}) {tuple(oh[int8].shape)} "
              f"staged in {(time.time() - t0) * 1e3:.1f} ms, "
              f"{nbytes(oh[int8]) / 2**30:.2f} GiB", flush=True)
    xq_all = torch.from_numpy(xq).to(dev)
    zero_meta = torch.zeros(BATCH, 256, device=dev)
    kw = dict(qt=256, ct=ct, ksub=ksub)

    def args(x, int8):
        """K6's inputs for the queries x: the unmasked coarse term, and the
        bf16 LUTs, or the int8 LUTs quantized from the float32 ones with
        their (a, c) meta."""
        biasg = P._masked_coarse_bias(x, br["centroids_g"], br["cn2g"], 0)
        if not int8:
            return biasg, P._adc_luts(x, br["cbt"]), zero_meta, oh[False], n2
        lf = -2.0 * (x @ br["cbt"])
        q8, meta = Q.quantize_luts_int8(lf.view(len(x), -1, ksub))
        return biasg, q8, meta, oh[True], n2

    # the path: every 2048-query sub-batch through both modes, and K4 over
    # the same codes, with profile_v3's candidate recall
    reset_counts(fused_knn)
    outs = {"K4": [], "K6 bf16": [], "K6 int8": []}
    for s0 in range(0, NQ, BATCH):
        x = xq_all[s0 : s0 + BATCH]
        for int8 in (False, True):
            outs[f"K6 {'int8' if int8 else 'bf16'}"].append(
                fused_knn.ivfpq_fused_v3(*args(x, int8), **kw))
        a = args(x, False)
        outs["K4"].append(fused_knn.ivfpq_fused(a[0], a[1], codesT, n2, lid,
                                                qt=256, ct=ct))
    torch.cuda.synchronize()
    k4_splits = fused_knn.ivfpq_fused.splits
    v3 = fused_knn.ivfpq_fused_v3
    launches = {False: v3.launches - v3.int8_launches, True: v3.int8_launches}
    check(all(launches.values()), f"K6 launches by mode (int8?) {launches}")
    check(v3.tc_launches == v3.launches,
          f"{v3.launches - v3.tc_launches} of {v3.launches} K6 launches took the "
          "lookup scan, not the tensor cores")
    k6_splits = v3.splits
    check(k6_splits > 1, f"K6 at {BATCH} queries ran {k6_splits} column split(s)")
    print(f"12a. K6: all {v3.launches} launches ({launches[False]} bf16, "
          f"{launches[True]} int8) on the tensor cores, {k6_splits} column "
          "splits", flush=True)
    sm = br["slot_map"]
    for name, parts in outs.items():
        sl = torch.cat([o[1] for o in parts])[:, :120].cpu().numpy()
        pos = np.where(sl >= 0, sm[np.maximum(sl, 0)], -1)
        ids = np.where(pos >= 0, base._ids_host[np.maximum(pos, 0)], -1)
        hit = np.mean([len(np.intersect1d(ids[i], gt[i, :K])) for i in range(NQ)])
        print(f"12a. {name}: candidate recall@10 (the top-120 slots hold the "
              f"ground-truth top-10) {hit / K:.4f} over {NQ} queries", flush=True)

    n2h = n2[0].cpu().numpy()
    # every kernel of the path against its plain version on every sub-batch
    # (at 2048 queries the columns split across blocks and the splits are
    # merged)
    check(k4_splits > 1, f"K4 at {BATCH} queries ran {k4_splits} column split(s)")
    path_err = {}
    for name, parts in outs.items():
        int8 = name == "K6 int8"
        e = 0.0
        for i, (kk, ks, kf) in enumerate(parts):
            x = xq_all[i * BATCH : (i + 1) * BATCH]
            a = args(x, int8)
            if name == "K4":
                rk, rs_, _ = fused_knn.ivfpq_fused_ref(a[0], a[1], codesT, n2, lid,
                                                       qt=256, ct=ct)
            else:
                rk, rs_, _ = fused_knn.ivfpq_fused_v3_ref(*a, **kw)
            check(bool(torch.isinf(kf).all()), f"{name} sub-batch {i}: floor is not all +inf")
            tol = lane_tol(x.square().sum(1).cpu().numpy(), n2h, rk.cpu().numpy(),
                           rs_.cpu().numpy())
            e = max(e, compare_lanes(kk, ks, rk, rs_, tol, f"{name} sub-batch {i}",
                                     ids_agree_tie_aware))
        path_err[name] = e
        splits = k4_splits if name == "K4" else k6_splits
        print(f"12a. {name} equals its plain version on all {len(parts)} "
              f"{BATCH}-query sub-batches ({splits} column splits, merged; "
              f"max_abs_err {e:.3e}, ids agree on all rows)", flush=True)
    del outs

    # the first sub-batch: each mode timed in turns with its plain version,
    # bf16 against K4, int8 against float64
    x = xq_all[:BATCH]
    qn2 = x.square().sum(1).cpu().numpy()
    res = {}
    for int8 in (False, True):
        a = args(x, int8)
        res[int8] = kernel_check(
            fused_knn, f"K6 {'int8' if int8 else 'bf16'} [{BATCH} q x {Sd} slots]",
            lambda a=a: fused_knn.ivfpq_fused_v3(*a, **kw),
            lambda a=a: fused_knn.ivfpq_fused_v3_ref(*a, **kw), qn2, n2h, 3)
        res[int8] = (max(res[int8][0], path_err[f"K6 {'int8' if int8 else 'bf16'}"]),
                     *res[int8][1:])
    a = args(x, False)
    a4 = (a[0], a[1], codesT, n2, lid)
    kb, sb, _ = fused_knn.ivfpq_fused_v3(*a, **kw)
    k4, s4, _ = fused_knn.ivfpq_fused(*a4, qt=256, ct=ct)
    torch.cuda.synchronize()
    tol = lane_tol(qn2, n2h, k4.cpu().numpy(), s4.cpu().numpy())
    e = compare_lanes(kb, sb, k4, s4, tol, "K6 bf16 vs K4", ids_agree_tie_aware)
    ms4, pms4, t = turns(lambda: fused_knn.ivfpq_fused_ref(*a4, qt=256, ct=ct),
                         lambda: fused_knn.ivfpq_fused(*a4, qt=256, ct=ct), 3)
    print(f"K6 bf16 equals K4 on the same inputs (max_abs_err {e:.3e}, ids agree "
          f"on all rows); K4 {t[1]:.2f} / {t[2]:.2f} ms, plain {t[0]:.2f} / "
          f"{t[3]:.2f} ms per {BATCH}-query sub-batch over the data chunks "
          f"({recon_note(fused_knn, 'K4')})", flush=True)
    mk = codesT.shape[0] * ksub
    print(f"note: cuBLAS bf16 torch.mm of the {BATCH} queries' LUTs with the "
          f"one-hot's {mk} PQ rows over {Sd} columns (K4's and K6's products, "
          f"no bias, no select): "
          f"{onehot_products_ms(a[1], oh[False][:mk]):.2f} ms", flush=True)
    a = args(x, True)
    print(f"note: cuBLAS int8 torch._int_mm of the {BATCH} queries' int8 LUTs "
          f"with the one-hot's {mk} PQ rows over {Sd} columns (K6 int8's "
          f"products, no bias, no select): {int_mm_note(a[1], oh[True][:mk]):.2f} ms",
          flush=True)
    k8, s8, _ = fused_knn.ivfpq_fused_v3(*a, **kw)
    r = EXACT_ROWS
    p = s8[:r].long().clamp_min(0)
    valid = (s8[:r] >= 0).cpu().numpy()
    codes = codesT.long()
    q8 = a[1][:r].long()
    acc = sum(q8.gather(1, codes[m][p] + m * ksub) for m in range(codes.shape[0]))
    lane = p % 128
    cpg = nch // G
    bias = a[0][:r].gather(1, (p // ct // cpg) * 128 + lid[0][p].long())
    key64 = (a[2][:r].gather(1, lane).double() * acc.double()
             + a[2][:r].gather(1, 128 + lane).double() + bias.double()
             + n2[0][p].double()).cpu().numpy()
    err = np.abs(np.where(valid, k8[:r].cpu().numpy() - key64, 0))
    tol = lane_tol(qn2[:r], n2h, key64, np.where(valid, p.cpu().numpy(), -1))
    check((err <= tol).all(), f"K6 int8: keys differ from float64 by {err.max():.3e}")
    print(f"K6 int8: {r} rows equal a float64 a * acc + c + bias + n2 of their "
          f"slots (max err {err.max():.3e})", flush=True)

    # (a, c) varying by lane on every third row: those rows take the ungated
    # path, reading a and c at each key's lane
    nu = 256
    biasg, q8, meta, _, _ = args(xq_all[:nu], True)
    meta = meta.clone()
    lanes = torch.arange(128, device=dev, dtype=torch.float32)
    meta[::3, :128] *= 1.0 + 0.01 * (lanes % 7)
    meta[::3, 128:] += 0.1 * (lanes % 5)
    a = (biasg, q8, meta, oh[True], n2)
    tc0 = v3.tc_launches
    kk, ks, kf = fused_knn.ivfpq_fused_v3(*a, **kw)
    rk, rs_, _ = fused_knn.ivfpq_fused_v3_ref(*a, **kw)
    torch.cuda.synchronize()
    check(v3.tc_launches == tc0 + 1, "K6 int8 with a per-lane meta left the tensor cores")
    check(bool(torch.isinf(kf).all()), "K6 int8 per-lane meta: floor is not all +inf")
    tol = lane_tol(xq_all[:nu].square().sum(1).cpu().numpy(), n2h, rk.cpu().numpy(),
                   rs_.cpu().numpy())
    e = compare_lanes(kk, ks, rk, rs_, tol, "K6 int8 per-lane meta", ids_agree_tie_aware)
    print(f"12a. K6 int8 with (a, c) varying by lane on {len(range(0, nu, 3))} of "
          f"{nu} rows (ungated) equals its plain version (max_abs_err {e:.3e}, "
          "ids agree on all rows)", flush=True)
    lookup_route_check(fused_knn, dev, ct, ids_agree_tie_aware)
    held = int(torch.isfinite(n2).sum())
    out = []
    for int8 in (False, True):
        a = args(x, int8)
        read = a[:2] + a[3:] + ((a[2],) if int8 else ())  # meta in int8 mode
        out.append(entry(
            f"ivfpq_fused_v3[{'int8' if int8 else 'bf16'}]",
            "faiss_tpu_torch/csrc/ivfpq_v3.cu", "faiss_tpu/ops/pallas_knn.py:778",
            launches[int8], *res[int8], ops_s(codesT, BATCH * held, int8=int8),
            nbytes(*read) + 3 * BATCH * 512))
    print(f"12a. the lookup scan's design (K4's, K5's and K6's before they moved "
          f"to the tensor cores), M + 1 shared-memory lookups per key at 32 a "
          f"clock per SM, takes at least "
          f"{lookup_s(codesT, BATCH * held) * 1e3:.2f} ms per {BATCH}-query "
          f"sub-batch (a note; the bounds are the tensor-core contraction's, "
          f"{out[0]['bound_ms']:.2f} ms bf16, {out[1]['bound_ms']:.2f} ms int8)",
          flush=True)
    del oh
    return out


def onehot_products_ms(luts, oh_pq, reps=3):
    """A note beside K4, not its library_ms (it has no bias and no select,
    and the port never calls it): cuBLAS bf16 ``torch.mm`` of the LUTs [nq,
    M * ksub] with the one-hot's PQ rows [M * ksub, S], in slabs of 65,536
    columns."""

    def run():
        for c0 in range(0, oh_pq.shape[1], 1 << 16):
            torch.mm(luts, oh_pq[:, c0 : c0 + (1 << 16)])

    return cuda_ms(run, reps)


def int_mm_note(q8, oh_pq, reps=3):
    """A note beside K6 int8, not its library_ms (it has no bias and no
    select, and the port never calls it): cuBLAS int8 ``torch._int_mm`` of
    the int8 LUTs [nq, M * ksub] with the one-hot's PQ rows [M * ksub, S]
    (int32 out), in contiguous slabs of 65,536 columns copied beforehand."""
    slabs = [oh_pq[:, c0 : c0 + (1 << 16)].contiguous()
             for c0 in range(0, oh_pq.shape[1], 1 << 16)]

    def run():
        for b in slabs:
            torch._int_mm(q8, b)

    return cuda_ms(run, reps)


def lookup_route_check(fused_knn, dev, ct, ids_agree_tie_aware):
    """K6 at ksub = 32 (M = 8; 256 queries over 65,536 columns of random
    codes in runs of 256 slots a list, G = 2), which the tensor cores do not
    take: both modes must take the lookup scan of adc_scan.cuh and equal
    their plain versions."""
    from faiss_tpu_torch.ops import quantize_lut as Q

    nq, Mq, ksub, S, G = 256, 8, 32, 1 << 16, 2
    g = torch.Generator(device=dev).manual_seed(7)
    codes = torch.randint(ksub, (Mq, S), generator=g, device=dev).to(torch.uint8)
    lid = ((torch.arange(S, device=dev) // 256) % 128).int()[None]
    n2 = torch.rand(1, S, generator=g, device=dev) * 2
    luts3 = torch.randn(nq, Mq, ksub, generator=g, device=dev)
    biasg = torch.randn(nq, G * 128, generator=g, device=dev)
    q8, meta = Q.quantize_luts_int8(luts3)
    mag = (luts3.abs().amax(2).sum(1) + biasg.abs().amax(1)).cpu().numpy()
    v3 = fused_knn.ivfpq_fused_v3
    for int8 in (False, True):
        luts = q8 if int8 else luts3.reshape(nq, -1).to(torch.bfloat16)
        a = (biasg, luts, meta, Q.expand_onehot(codes, lid, ksub, int8), n2)
        kw = dict(qt=256, ct=ct, ksub=ksub)
        n0, tc0 = v3.launches, v3.tc_launches
        kk, ks, kf = v3(*a, **kw)
        rk, rs_, _ = fused_knn.ivfpq_fused_v3_ref(*a, **kw)
        torch.cuda.synchronize()
        what = f"K6 {'int8' if int8 else 'bf16'} at ksub {ksub}"
        check(v3.launches == n0 + 1 and v3.tc_launches == tc0,
              f"{what} did not take the lookup scan")
        check(bool(torch.isinf(kf).all()), f"{what}: floor is not all +inf")
        tol = lane_tol(mag, n2[0].cpu().numpy(), rk.cpu().numpy(), rs_.cpu().numpy())
        e = compare_lanes(kk, ks, rk, rs_, tol, what, ids_agree_tie_aware)
        print(f"12a. {what} (M = {Mq}, {nq} q x {S} columns) took the lookup "
              f"scan and equals its plain version (max_abs_err {e:.3e})", flush=True)


def dyn_lookup_check(fused_knn, dev, ct, ids_agree_tie_aware):
    """K5 at ksub = 32 (M = 8; 256 queries in one tile over a worklist of
    24 of 64 chunks of random codes in runs of 256 slots a list, G = 2,
    then PAD steps), which the tensor cores do not take: it must take the
    lookup scan of adc_scan.cuh and equal its plain version."""
    nq, Mq, ksub, nch, G, msteps = 256, 8, 32, 64, 2, 32
    S = (nch + 1) * ct
    g = torch.Generator(device=dev).manual_seed(11)
    codes = torch.randint(ksub, (Mq, S), generator=g, device=dev).to(torch.uint8)
    lid = ((torch.arange(S, device=dev) // 256) % 128).int()[None]
    n2 = torch.rand(1, S, generator=g, device=dev) * 2
    n2[:, nch * ct :] = float("inf")  # the PAD chunk
    luts = torch.randn(nq, Mq * ksub, generator=g, device=dev).to(torch.bfloat16)
    biasg = torch.randn(nq, G * 128, generator=g, device=dev)
    cgroup = torch.clamp(torch.arange(nch + 1, device=dev) // (nch // G), max=G - 1).int()
    cmap = torch.full((1, msteps), nch, dtype=torch.int32, device=dev)
    cmap[0, :24] = torch.randperm(nch, generator=g, device=dev)[:24].sort().values.int()
    a = (biasg, luts, codes, n2, lid, cmap, cgroup)
    dyn = fused_knn.ivfpq_fused_dyn
    n0, tc0 = dyn.launches, dyn.tc_launches
    kk, ks, kf = dyn(*a, qt=nq, ct=ct)
    rk, rs_, _ = fused_knn.ivfpq_fused_dyn_ref(*a, qt=nq, ct=ct)
    torch.cuda.synchronize()
    what = f"K5 at ksub {ksub}"
    check(dyn.launches == n0 + 1 and dyn.tc_launches == tc0,
          f"{what} did not take the lookup scan")
    check(bool(torch.isinf(kf).all()), f"{what}: floor is not all +inf")
    mag = (luts.float().abs().reshape(nq, Mq, ksub).amax(2).sum(1)
           + biasg.abs().amax(1)).cpu().numpy()
    tol = lane_tol(mag, n2[0].cpu().numpy(), rk.cpu().numpy(), rs_.cpu().numpy())
    e = compare_lanes(kk, ks, rk, rs_, tol, what, ids_agree_tie_aware)
    print(f"13. {what} (M = {Mq}, {nq} q over {msteps} steps of {ct} columns) "
          f"took the lookup scan and equals its plain version (max_abs_err "
          f"{e:.3e})", flush=True)


def floor_phase(fused_knn, base, br, xq_all, dev):
    """Phase 12b: K7 over the decoded store, against its plain version and
    K2's first key, and timed beside K2 (one plane, unmasked) on the same
    sub-batch. Returns its entry in the kernels' JSON line."""
    from faiss_tpu_torch.models import ivf_pq as P

    yT, n2s = br["yT"], br["n2s"]
    kw = dict(qt=256, ct=base.FUSED_CT)
    reset_counts(fused_knn)
    outs = [fused_knn.recon_floor(P._pad_dims(xq_all[s0 : s0 + BATCH], br), yT,
                                  n2s, **kw) for s0 in range(0, NQ, BATCH)]
    torch.cuda.synchronize()
    launches = fused_knn.recon_floor.launches
    splits = fused_knn.recon_floor.splits
    check(launches > 0, "K7's path launched it no time")
    # the card's only K7 instance is the tensor-core one; each sub-batch has
    # the shape of the last
    check(splits > 1, f"K7 at {BATCH} queries ran {splits} column split(s)")
    print(f"12b. all {launches} K7 launches on the tensor cores, {splits} "
          "column splits each", flush=True)
    fl = torch.cat(outs)
    check(tuple(fl.shape) == (NQ, 128) and bool(torch.isfinite(fl).all()),
          "K7: a lane without a finite key")
    xp = P._pad_dims(xq_all[:BATCH], br)
    got = fused_knn.recon_floor(xp, yT, n2s, **kw)
    want = fused_knn.recon_floor_ref(xp, yT, n2s, **kw)
    k2 = fused_knn.ivf_recon_fused(xp, yT, n2s, **kw)[0][:, 0]
    torch.cuda.synchronize()
    n2max = float(n2s[torch.isfinite(n2s)].max())
    tol = 1e-4 * (xp.square().sum(1) + n2max)
    err = float((got - want).abs().max())
    check(bool(((got - want).abs() <= tol[:, None]).all()),
          f"K7 differs from its plain version by {err:.3e}")
    e2 = float((got.min(1).values - k2).abs().max())
    check(bool(((got.min(1).values - k2).abs() <= tol).all()),
          f"K7: the minimum over the lanes differs from K2's first key by {e2:.3e}")
    same = int((got.min(1).values == k2).sum())
    print(f"12b. min over K7's lanes vs K2 one plane's first key: largest "
          f"difference {e2!r}, bitwise equal on {same} of {BATCH} rows", flush=True)
    check(bool((got == fl[:BATCH]).all()), "K7 differs between two launches")
    ms, plain_ms, t = turns(lambda: fused_knn.recon_floor_ref(xp, yT, n2s, **kw),
                            lambda: fused_knn.recon_floor(xp, yT, n2s, **kw), 3)
    print(f"12b. K7 vs plain [{BATCH} q x {yT.shape[1]} columns]: max_abs_err "
          f"{err:.3e}; min over lanes vs K2's first key {e2:.3e}; {t[1]:.2f} / "
          f"{t[2]:.2f} ms, plain {t[0]:.2f} / {t[3]:.2f} ms", flush=True)
    k7f = lambda: fused_knn.recon_floor(xp, yT, n2s, **kw)  # noqa: E731
    k2f = lambda: fused_knn.ivf_recon_fused(xp, yT, n2s, **kw)  # noqa: E731
    tt = [cuda_ms(f, 2) for f in (k7f, k2f, k2f, k7f)]
    k7ms, k2ms = (tt[0] + tt[3]) / 2, (tt[1] + tt[2]) / 2
    print(f"12b. K7 {tt[0]:.2f} / {tt[3]:.2f} ms, K2 one plane {tt[1]:.2f} / "
          f"{tt[2]:.2f} ms on the same {BATCH} queries: K2 (the same products "
          f"and the exact select) takes K2/K7 = {k2ms / k7ms:.3f} of K7 (the "
          f"products and per-lane minima, no select)", flush=True)
    print(f"note: cuBLAS bf16 torch.mm of K7's two products (K2 one plane's) "
          f"over the same {BATCH} q x {yT.shape[1]} columns, no minima: "
          f"{tc_products_ms(xp, yT, None, yT.shape[1], 3):.3f} ms ({CARD})",
          flush=True)
    held = int(torch.isfinite(n2s).sum())
    return entry("recon_floor", "faiss_tpu_torch/csrc/recon_floor.cu",
                 "benchs/archive/exp_r3c.py:106", launches, err, ms, plain_ms,
                 ops_s(yT, BATCH * held), nbytes(yT, n2s, xp) + BATCH * 512)


def total_launches(fused_knn):
    return sum(f.launches for f in (
        fused_knn.ivf_recon_fused_dyn, fused_knn.ivf_recon_fused,
        fused_knn.knn_fused, fused_knn.ivfpq_fused, fused_knn.ivfpq_fused_dyn,
        fused_knn.ivfpq_fused_v3, fused_knn.recon_floor))


def no_kernel(fused_knn, what, fn):
    """Run fn with every count set to 0 just before and read just after: a
    path of plain torch ops must have launched no kernel."""
    reset_counts(fused_knn)
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    check(total_launches(fused_knn) == 0, f"{what} launched a kernel")
    print(f"{what}: {time.time() - t0:.3f} s (first call), no kernel", flush=True)
    return out


def probe_and_xla_phases(fused_knn, base, br, xq, gt, dev):
    """Phase 12c: the per-probe ADC scan (64 queries, nprobe 16, with and
    without max_codes) and the XLA ADC scan (k = 200 on 1024 queries) of
    the same index, each on 64 rows against float64."""
    from faiss_tpu_torch.ops import pq_ops
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware, recall_at_k

    listnos = base._listnos_host
    order = np.argsort(listnos, kind="stable")
    sizes = np.bincount(listnos, minlength=NLIST)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    xq_all = torch.from_numpy(xq).to(dev)
    x64 = xq_all.double()
    cent64 = br["centroids"].double()
    cb64 = base.pq._dev().double()
    qn2 = x64.square().sum(1).cpu().numpy()
    tol = 1e-5 * (qn2 + float(br["n2"].max()))
    nprobe = 16

    def slots_of(lists):
        return np.concatenate([order[offs[li] : offs[li + 1]] for li in lists if li >= 0])

    def agree(Dx, Ix, key64, lists, what):
        """Rows 0..EXACT_ROWS-1: distances of the returned slots within tol
        of ``key64(q, slots)``, ids up to ties with its best over the
        row's lists."""
        k, err = Dx.shape[1], 0.0
        for q in range(EXACT_ROWS):
            sl = slots_of(lists[q])
            d = key64(q, sl)
            o = np.argsort(d, kind="stable")[:k]
            want_d = np.full(k, np.inf)
            want_i = np.full(k, -1, np.int64)
            want_d[: len(o)], want_i[: len(o)] = d[o], base._ids_host[sl[o]]
            got = Ix[q] >= 0
            check((got == np.isfinite(want_d)).all(),
                  f"{what}: row {q} returns {int(got.sum())} results of {len(sl)}")
            e = np.abs(Dx[q][got] - key64(q, base._slots_of_ids(Ix[q][got])))
            check((e <= tol[q]).all(), f"{what}: row {q} distances differ from "
                                       f"float64 by {e.max():.3e}")
            check(ids_agree_tie_aware(np.where(got, want_d, 1e30)[None], want_i[None],
                                      np.where(got, Dx[q], 1e30)[None], Ix[q][None],
                                      tol[q]).all(),
                  f"{what}: row {q} ids differ from float64 beyond ties")
            err = max(err, float(e.max()) if e.size else 0.0)
        print(f"{what}: {EXACT_ROWS} rows match float64 over the probed lists "
              f"(max err {err:.3e})", flush=True)

    def recon_key64(q, sl):
        """||q - (c + y)||^2 in float64: the exact distance to the
        reconstruction, which the per-probe scan's tables decompose."""
        s = torch.from_numpy(sl).to(dev)
        rec = cent64[br["listnos"][s]] + pq_ops.pq_decode(br["codes"][s], cb64)
        return (rec - x64[q]).square().sum(1).cpu().numpy()

    base.nprobe = nprobe
    x128 = torch.zeros(128, D, device=dev)
    x128[:64] = xq_all[:64]
    lists = base._coarse_search(x128, nprobe)[1][:64].cpu().numpy()
    D1, I1 = no_kernel(fused_knn, f"12c. by probe: 64 queries, nprobe={nprobe}",
                       lambda: base.search(xq[:64], K))
    agree(D1, I1, recon_key64, lists, "by probe, 64 queries")
    time_search("12c. by probe (64 queries)", lambda: base.search(xq[:64], K), 64)
    base.max_codes = 2000
    D2, I2 = no_kernel(fused_knn, "12c. by probe, max_codes=2000",
                       lambda: base.search(xq[:64], K))
    cum = np.cumsum(sizes[lists], axis=1)
    keep = np.concatenate([np.ones((64, 1), bool), cum[:, :-1] < 2000], axis=1)
    print(f"max_codes=2000 keeps {keep.sum(1).mean():.2f} of {nprobe} lists per "
          "query", flush=True)
    agree(D2, I2, recon_key64, np.where(keep, lists, -1), "by probe, max_codes=2000")
    time_search("12c. by probe, max_codes=2000", lambda: base.search(xq[:64], K), 64)
    base.max_codes = 0

    # unrefined k = 200: the XLA ADC scan, against a float64 ADC of its own
    # bf16 LUTs, coarse products and slot norms
    nq3, k3 = 1024, 200
    x3 = xq_all[:nq3]
    luts = (-2.0 * pq_ops.pq_ip_tables(x3, base.pq._dev())).to(torch.bfloat16)
    lut64 = luts.double()
    cent = br["centroids"]
    key = cent.square().sum(-1)[None, :] - 2.0 * (x3 @ cent.T)
    lists3 = torch.topk(key, nprobe, largest=False).indices.cpu().numpy()
    n2d = br["n2"].double()
    M_ = base.pq.M

    def adc_key64(q, sl):
        s = torch.from_numpy(sl).to(dev)
        codes = br["codes"][s].long()
        ip = sum(lut64[q, m][codes[:, m]] for m in range(M_))
        coarse = x64[q] @ cent64[br["listnos"][s]].T
        return (qn2[q] + n2d[s] - 2.0 * coarse + ip).cpu().numpy()

    D3, I3 = no_kernel(fused_knn, f"12c. unrefined k={k3}, {nq3} queries, "
                       f"nprobe={nprobe} (XLA ADC)", lambda: base.search(xq[:nq3], k3))
    check(D3.shape == I3.shape == (nq3, k3), f"k={k3} result shape {D3.shape}")
    agree(D3, I3, adc_key64, lists3, f"unrefined k={k3} (XLA ADC)")
    print(f"unrefined k={k3}: recall@10 {recall_at_k(I3, gt[:nq3], K):.4f}",
          flush=True)

    # the XLA scan's two ways to sum 4-bit LUT entries, on these inputs: the
    # one-hot product it takes at ksub <= 16, and the table gathers it takes
    # above
    lb = luts.float()
    flat = lb.reshape(nq3, -1)
    ch = 1 << 16
    codes_all = br["codes"]

    def by_onehot():
        for c0 in range(0, len(codes_all), ch):
            flat @ pq_ops.codes_onehot(codes_all[c0 : c0 + ch], lb.shape[2],
                                       torch.float32).T

    def by_gathers():
        for c0 in range(0, len(codes_all), ch):
            pq_ops.adc_scores_gather(lb, codes_all[c0 : c0 + ch])

    c0s = codes_all[:ch]
    e = float((flat @ pq_ops.codes_onehot(c0s, lb.shape[2], torch.float32).T
               - pq_ops.adc_scores_gather(lb, c0s)).abs().max())
    t = [cuda_ms(f, 1) for f in (by_onehot, by_gathers, by_gathers, by_onehot)]
    print(f"12c. the XLA scan's LUT sums over {nq3} q x {len(codes_all)} codes "
          f"(M={M_}, ksub={lb.shape[2]}): one-hot product {t[0]:.2f} / {t[3]:.2f} "
          f"ms, table gathers {t[1]:.2f} / {t[2]:.2f} ms (max difference on the "
          f"first chunk {e:.3e})", flush=True)
    time_search(f"12c. unrefined k={k3} (XLA ADC)", lambda: base.search(xq[:nq3], k3),
                nq3)
    base.nprobe = NPROBE


def ivfpqr_phase(ft, fused_knn, xb, xt, xq, gt, dev):
    """Phase 31: IndexIVFPQR "IVF4096,PQ8+16" (faiss's factory name: PQ8 at
    8 bits, refine PQ16 at 8 bits) trained and added on the card; the
    search of the 8192 queries at nprobe 16 with k_factor 4 (its big batch
    takes the XLA ADC scan, ksub = 256), and 64 rows of its re-rank against
    float64 distances to the refined reconstruction."""
    from faiss_tpu_torch.ops import pq_ops
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware, recall_at_k

    torch.cuda.reset_peak_memory_stats()
    index = ft.IndexIVFPQR(None, D, NLIST, 8, 8, 16, 8, device=dev)
    index.cp.niter = NITER
    took = []
    for step in (lambda: index.train(xt), lambda: index.add(xb)):
        torch.cuda.synchronize()
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        took.append(time.time() - t0)
    index.nprobe, index.k_factor = 16, 4
    Dr, Ir = no_kernel(fused_knn, "31. IndexIVFPQR IVF4096,PQ8+16 search, nprobe=16",
                       lambda: index.search(xq, K))
    check(Dr.shape == Ir.shape == (NQ, K) and (Ir >= 0).all()
          and np.isfinite(Dr).all(), "IVFPQR: missing results")
    med, times = host_median(lambda: index.search(xq, K))
    print(f"31. IndexIVFPQR: train {took[0]:.2f} s, add {took[1]:.2f} s; search of "
          f"{NQ} queries median {med * 1e3:.1f} ms over 5 "
          f"({', '.join(f'{t * 1e3:.1f}' for t in times)}) -> {NQ / med:.0f} QPS; "
          f"recall@10 {recall_at_k(Ir, gt, K):.4f}", flush=True)
    # the candidates of the same path, re-ranked in float64
    kc = K * index.k_factor
    _, Ic = ft.IndexIVFPQ.search(index, xq, kc)
    cent64 = torch.from_numpy(index.quantizer.vectors()).to(dev).double()
    cb64, rcb64 = index.pq._dev().double(), index.refine_pq._dev().double()
    x64 = torch.from_numpy(xq[:EXACT_ROWS]).to(dev).double()
    tol = 1e-5 * (x64.square().sum(1).cpu().numpy()
                  + float((xb.astype(np.float64) ** 2).sum(1).max()))
    err = 0.0
    for q in range(EXACT_ROWS):
        ids = Ic[q][Ic[q] >= 0]
        sl = index._slots_of_ids(ids)
        rec = (cent64[torch.from_numpy(index._listnos_host[sl].astype(np.int64)).to(dev)]
               + pq_ops.pq_decode(torch.from_numpy(index._codes_host[sl]).to(dev), cb64)
               + pq_ops.pq_decode(torch.from_numpy(index._refine_codes[sl]).to(dev),
                                  rcb64))
        d = (rec - x64[q]).square().sum(1).cpu().numpy()
        o = np.argsort(d, kind="stable")[:K]
        at = {int(i): j for j, i in enumerate(ids)}
        check(all(int(i) in at for i in Ir[q]), f"IVFPQR: row {q} returns a non-candidate")
        e = np.abs(Dr[q] - d[[at[int(i)] for i in Ir[q]]])
        check((e <= tol[q]).all(), f"IVFPQR: row {q} differs from float64 by {e.max():.3e}")
        check(ids_agree_tie_aware(d[o][None], ids[o][None], Dr[q][None], Ir[q][None],
                                  tol[q]).all(),
              f"IVFPQR: row {q} re-rank differs from float64 beyond ties")
        err = max(err, float(e.max()))
    print(f"IVFPQR: {EXACT_ROWS} rows of the re-rank match float64 distances to the "
          f"refined reconstruction of their {kc} candidates (max err {err:.3e}); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)


class Exact:
    """float64 brute force on the card for the first EXACT_ROWS queries."""

    def __init__(self, xb, dev):
        self.y = torch.from_numpy(xb).to(dev, torch.float64)
        self.yn = self.y.square().sum(1)
        self.dev = dev

    def check(self, xq, Dp, Ip, k, metric_l2, what, ids_agree_tie_aware):
        q = torch.from_numpy(xq[:EXACT_ROWS]).to(self.dev, torch.float64)
        qn = q.square().sum(1)
        ip = q @ self.y.T
        if metric_l2:
            vals, ids = torch.topk(qn[:, None] + self.yn[None] - 2 * ip, k,
                                   largest=False)
        else:
            vals, ids = torch.topk(ip, k, largest=True)
        vals, ids = vals.cpu().numpy(), ids.cpu().numpy()
        tol = 1e-5 * (qn + self.yn.max()).cpu().numpy()
        Dp, Ip = Dp[:EXACT_ROWS], Ip[:EXACT_ROWS]
        err = np.abs(Dp - vals)
        check((err <= tol[:, None]).all(),
              f"{what}: distances differ from float64 by {err.max():.3e}")
        sign = 1.0 if metric_l2 else -1.0
        agree = ids_agree_tie_aware(sign * vals, ids, sign * Dp, Ip, tol)
        check(agree.all(), f"{what}: ids differ from float64 on "
                           f"{int((~agree).sum())} of {EXACT_ROWS} rows")
        return float(err.max())


def flat_search(fused_knn, what, fn, kernel, nq, k):
    """Run one flat search with the counts set to 0 just before and read
    just after; its path's kernel must have launched."""
    reset_counts(fused_knn)
    t0 = time.time()
    Dp, Ip = fn()
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = kernel.launches
    check(launches > 0, f"{what} launched its kernel no time")
    check(Dp.shape == Ip.shape == (nq, k), f"{what}: result shape {Dp.shape}")
    check(((Ip >= 0) & (Ip < NB)).all() and np.isfinite(Dp).all(),
          f"{what}: invalid ids or non-finite distances")
    print(f"{what}: {dt:.3f} s (first call), {launches} launches", flush=True)
    return Dp, Ip, launches


def k3_check(fused_knn, what, xq, yT, nb, metric_l2, k_lanes, yn, dev,
             ids_agree_tie_aware):
    """K3 against its plain version on the queries ``xq`` over the store
    ``yT`` (``yn``: the column norms in store order): the floor all +inf
    (L2) or -inf (IP), values within 1e-4 * (|q|^2 + |y_s|^2), ids
    tie-aware, and every row's candidates within the buffer's bound.
    Returns max_abs_err."""
    x = torch.from_numpy(xq).to(dev)
    kw = dict(metric_l2=metric_l2, qt=min(512, len(xq)), k_lanes=k_lanes)
    kv, ki, kf = fused_knn.knn_fused(x, yT, nb, **kw)
    counts = fused_knn.knn_fused.counts.cpu().numpy()
    scratch = fused_knn.knn_fused.scratch_bytes
    rv, ri, _ = fused_knn.knn_fused_ref(x, yT, nb, **kw)
    torch.cuda.synchronize()
    inf = float("inf") if metric_l2 else float("-inf")
    check(bool((kf == inf).all()), f"{what}: floor is not all {inf}")
    sign = 1.0 if metric_l2 else -1.0  # ascending keys for the comparison
    rin = ri.cpu().numpy()
    qn = (x.double() ** 2).sum(1).cpu().numpy()
    tol = 1e-4 * (qn[:, None] + np.where(rin >= 0, yn[np.maximum(rin, 0)], 0))
    e = compare_lanes(sign * kv, ki, sign * rv, ri, tol, what, ids_agree_tie_aware)
    lt_cap = fused_knn.knn_lt_cap(k_lanes)
    cand = counts[:, 0] + np.minimum(counts[:, 1], k_lanes)
    bound = fused_knn.knn_candidates(k_lanes)
    check((counts[:, 0] <= lt_cap).all() and (cand <= bound).all(),
          f"{what}: {int(counts[:, 0].max())} pairs below the threshold, "
          f"more than the lt region's {lt_cap}")
    print(f"{what} vs plain [{len(xq)} q x {nb} columns]: max_abs_err {e:.3e}, "
          f"ids agree on all rows, floor all {inf}; candidates per row mean "
          f"{cand.mean():.1f}, max {int(cand.max())} of the bound {bound} "
          f"(lt max {int(counts[:, 0].max())}, eq max {int(counts[:, 1].max())}); "
          f"{fused_knn.knn_fused.splits} column splits, scratch "
          f"{scratch / 2**20:.1f} MiB, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return e


def k3_phases(fused_knn, x, yT, k_lanes):
    """K3's kernels one after another on one sub-batch, by CUDA events: each
    phase's time is that of the launch through it less that of the launch
    before it (the phases read what the earlier ones wrote)."""
    nq, nb = x.shape[0], NB
    check(fused_knn.knn_sub_batch(nq, nb, k_lanes) == nq, "K3: not one sub-batch")
    scratch = fused_knn.knn_scratch(yT, nb, nq, nq, k_lanes)
    splits = fused_knn._split_count(-(-nq // fused_knn.KNN_BLOCK),
                                    -(-nb // fused_knn.KNN_TILE),
                                    torch.cuda.get_device_properties(0).multi_processor_count)
    out = (torch.empty(nq, k_lanes, device=x.device),
           torch.empty(nq, k_lanes, dtype=torch.int32, device=x.device),
           torch.empty(nq, 128, device=x.device))
    phases = ((fused_knn.KNN_PHASE_N2, "n2"), (fused_knn.KNN_PHASE_MIN, "MIN"),
              (fused_knn.KNN_PHASE_THETA, "theta"),
              (fused_knn.KNN_PHASE_APPEND, "APPEND"),
              (fused_knn.KNN_PHASE_FINAL, "final"))
    cum, prev, parts = 0, 0.0, []
    for bit, name in phases:
        cum |= bit
        ms = cuda_ms(lambda: fused_knn.knn_fused_launch(
            x, yT, nb, True, k_lanes, 512, 1024, scratch, 0, out, splits, cum), 3)
        parts.append(f"{name} {ms - prev:.3f}")
        prev = ms
    return "phases (ms): " + ", ".join(parts)


def flat_phases(ft, fused_knn, xb, xq, gt, dev, k2_ivf):
    """Phases 15-22: exact flat search and K2/K3. Returns their entries of
    the kernels' JSON line; K2's launches and max_abs_err start at
    ``k2_ivf``, those of the IVF-PQ path."""
    k2_launches, k2_err = k2_ivf
    from faiss_tpu_torch.models import flat as flat_mod
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware, recall_at_k

    torch.cuda.synchronize()
    t0 = time.time()
    flat = ft.IndexFlatL2(D, device=dev)
    flat.add(xb)
    flat._consolidate()
    yT_hi, yT_lo, n2s, ymax = flat._screen_dev()
    torch.cuda.synchronize()
    print(f"IndexFlatL2 add + stage {time.time() - t0:.2f} s "
          f"(screen store {tuple(yT_hi.shape)} x 2 bf16 planes)", flush=True)
    exact = Exact(xb, dev)

    # k=10 against the reference's ground truth (screen path)
    Dp, Ip, n = flat_search(fused_knn, "flat k=10 search",
                            lambda: flat.search(xq, 10),
                            fused_knn.ivf_recon_fused, NQ, 10)
    k2_launches += n
    y64, q64 = exact.y, torch.from_numpy(xq).to(dev, torch.float64)

    def sorted_d64(ids):
        i = torch.from_numpy(ids).to(dev)
        d = (q64[:, None, :] - y64[i]).square().sum(-1)
        d, o = torch.sort(d, 1)
        return d.cpu().numpy(), torch.gather(i, 1, o).cpu().numpy()

    d_gt, i_gt = sorted_d64(gt[:, :10])
    d_pt, i_pt = sorted_d64(Ip)
    tol = 1e-6 * (q64.square().sum(1) + exact.yn.max()).cpu().numpy()
    agree = ids_agree_tie_aware(d_gt, i_gt, d_pt, i_pt, tol)
    differ = int((np.sort(i_gt, 1) != np.sort(i_pt, 1)).any(1).sum())
    recall = recall_at_k(Ip, gt, 10)
    print(f"k=10 vs bench_gt_cache.npz: recall@10 {recall:.4f}; id sets "
          f"differ on {differ} rows, all within ties: {bool(agree.all())}",
          flush=True)
    check(agree.all(), f"k=10 ids disagree with the ground truth beyond ties "
                       f"on {int((~agree).sum())} rows")

    # k=100 (config 1) through search_submit/search_collect
    s0 = dict(flat_mod.screen_stats)
    Dp, Ip, n = flat_search(
        fused_knn, "flat k=100 search_submit/collect",
        lambda: flat.search_collect(flat.search_submit(xq, 100)),
        fused_knn.ivf_recon_fused, NQ, 100)
    k2_launches += n
    nq_s = flat_mod.screen_stats["nq"] - s0["nq"]
    flagged = flat_mod.screen_stats["flagged"] - s0["flagged"]
    check(flat_mod.screen_stats["storms"] == s0["storms"], "k=100 screen stormed")
    print(f"k=100 screen: certified {1 - flagged / nq_s:.4f} of {nq_s} rows; "
          f"{flagged} rows repaired exactly", flush=True)
    err = exact.check(xq, Dp, Ip, 100, True, "k=100", ids_agree_tie_aware)
    print(f"k=100: {EXACT_ROWS} rows exact vs float64 (max err {err:.3e})", flush=True)

    # k=1024 (BASELINE row 9): the striped path
    s0 = dict(flat_mod.striped_stats)
    P, W, nbp_lk, u = flat._striped_plan(1024)
    Dp, Ip, n = flat_search(fused_knn, "flat k=1024 search (striped)",
                            lambda: flat.search(xq, 1024),
                            fused_knn.ivf_recon_fused, NQ, 1024)
    k2_launches += n
    st = {key: flat_mod.striped_stats[key] - s0[key] for key in s0}
    check(st["storms"] == 0 and st["nq"] == NQ, f"striped path counters {st}")
    print(f"k=1024 striped: P={P} stripes of W={W}, u={u}; striped_stats "
          f"{st}", flush=True)
    err = exact.check(xq, Dp, Ip, 1024, True, "k=1024", ids_agree_tie_aware)
    print(f"k=1024: {EXACT_ROWS} rows exact vs float64 (max err {err:.3e})", flush=True)

    # the fused path: K3 at k_lanes 128 and 2048
    flat.flat_screen = False
    k3_launches = {}  # by k_lanes
    for k, nq, k_lanes in ((100, NQ, 128), (2000, 1024, 2048)):
        Dp, Ip, n = flat_search(fused_knn, f"flat k={k} fused (flat_screen=False)",
                                lambda: flat.search(xq[:nq], k),
                                fused_knn.knn_fused, nq, k)
        k3_launches[k_lanes] = n
        err = exact.check(xq, Dp, Ip, k, True, f"fused k={k}", ids_agree_tie_aware)
        print(f"fused k={k}: {EXACT_ROWS} rows exact vs float64 (max err "
              f"{err:.3e})", flush=True)
    flat.flat_screen = True

    # IndexFlatIP
    ip_index = ft.IndexFlatIP(D, device=dev)
    ip_index.add(xb)
    Dp, Ip, n = flat_search(fused_knn, "IndexFlatIP k=100 search",
                            lambda: ip_index.search(xq[:1024], 100),
                            fused_knn.ivf_recon_fused, 1024, 100)
    k2_launches += n
    err = exact.check(xq, Dp, Ip, 100, False, "IP k=100", ids_agree_tie_aware)
    print(f"IP k=100: {EXACT_ROWS} rows exact vs float64 (max err {err:.3e})",
          flush=True)
    del ip_index, exact

    # K2 and K3 against their plain versions at the main paths' shapes
    qn = torch.from_numpy(xq).to(dev).square().sum(1)
    xq4k = torch.from_numpy(xq[:4096]).to(dev)
    k2_args = (xq4k, yT_hi, n2s)
    k2_kw = dict(qt=256, ct=1024)

    def k2_check(args, lo, name):
        kk, ks, kf = fused_knn.ivf_recon_fused(*args, lo, **k2_kw)
        rk, rs_, _ = fused_knn.ivf_recon_fused_ref(*args, lo, **k2_kw)
        torch.cuda.synchronize()
        check(bool(torch.isinf(kf).all()), f"{name}: floor is not all +inf")
        rsn = rs_.cpu().numpy()
        n2 = args[2][0].cpu().numpy()
        tol = 1e-4 * (qn[:4096].cpu().numpy()[:, None]
                      + np.where(rsn >= 0, n2[np.maximum(rsn, 0)], 0))
        e = compare_lanes(kk, ks, rk, rs_, tol, name, ids_agree_tie_aware)
        print(f"{name} vs plain [4096 q x {args[1].shape[1]} columns, row stride "
              f"{args[1].stride(0)}]: max_abs_err {e:.3e}, ids agree on all rows; "
              f"{recon_note(fused_knn, 'K2')}", flush=True)
        return e

    for lo, name in ((yT_lo, "K2 hi/lo"), (None, "K2 one plane")):
        k2_err = max(k2_err, k2_check(k2_args, lo, name))
    # the striped path's shape: column slices of the stripe-grid store, with
    # row stride nbp_lk; the last stripe ends in +inf-norm pad columns
    lk_hi, lk_lo, lk_n2s, _ = flat._screen_lk_dev(nbp_lk)
    for s, what in ((0, "first"), (P - 1, "last, pad-filled")):
        sl = slice(s * W, (s + 1) * W)
        npad = min(W, max(0, (s + 1) * W - NB))
        e = k2_check((xq4k, lk_hi[:, sl], lk_n2s[:, sl]), lk_lo[:, sl],
                     f"K2 hi/lo stripe {s} ({what}, {npad} pad columns)")
        k2_err = max(k2_err, e)
    stripe_args = (xq4k, lk_hi[:, :W], lk_n2s[:, :W])
    _, _, t = turns(
        lambda: fused_knn.ivf_recon_fused_ref(*stripe_args, lk_lo[:, :W], **k2_kw),
        lambda: fused_knn.ivf_recon_fused(*stripe_args, lk_lo[:, :W], **k2_kw), 5)
    print(f"K2 hi/lo one stripe {t[1]:.2f} / {t[2]:.2f} ms, plain {t[0]:.2f} / "
          f"{t[3]:.2f} ms per 4096-query sub-batch over {W} columns", flush=True)
    del lk_hi, lk_lo, lk_n2s, stripe_args
    xbT = flat._xbT_dev()
    yn = flat._norms.cpu().numpy()
    k3_err = {128: 0.0, 2048: 0.0}
    # the two shapes of the fused path, IP at k_lanes 256, then k_lanes 2048
    # over the columns in an IVF-like order (sorted by the mixture centre
    # each vector was drawn from, bench.py:235-237) and over a store of
    # duplicated columns (ties)
    for k_lanes, nq, metric_l2 in ((128, NQ, True), (2048, 1024, True),
                                   (256, 1024, False)):
        e = k3_check(fused_knn, f"K3 {'L2' if metric_l2 else 'IP'} k_lanes={k_lanes}",
                     xq[:nq], xbT, NB, metric_l2, k_lanes, yn, dev,
                     ids_agree_tie_aware)
        if metric_l2:
            k3_err[k_lanes] = e
    centre = np.random.RandomState(1).randint(2048, size=NB)
    perm = torch.from_numpy(np.argsort(centre, kind="stable")).to(dev)
    ivf = torch.zeros_like(xbT)
    ivf[:, :NB] = xbT[:, perm]
    k3_err[2048] = max(k3_err[2048], k3_check(
        fused_knn, "K3 L2 k_lanes=2048, IVF-ordered columns", xq[:1024], ivf, NB,
        True, 2048, yn[perm.cpu().numpy()], dev, ids_agree_tie_aware))
    rep = np.random.RandomState(4).permutation(NB) % (NB // 8)  # each row 8 times
    dup = torch.zeros_like(xbT)
    dup[:, :NB] = xbT[:, torch.from_numpy(rep).to(dev)]
    del ivf, perm
    k3_err[128] = max(k3_err[128], k3_check(
        fused_knn, "K3 L2 k_lanes=128, every column 8 times", xq[:1024], dup, NB,
        True, 128, yn[rep], dev, ids_agree_tie_aware))
    del dup
    # off the main path's shapes: d below one ring stage (zero-filled dims)
    # and above the resident query segment (reloaded per tile), 72 queries
    # (a partial block), nb inside a tile, k_lanes 2048 (IP) and 384
    rs = np.random.RandomState(5)
    for d, nb, k_lanes, metric_l2 in ((20, 70_001, 2048, False), (200, 50_001, 384, True)):
        y = torch.zeros(d, -(-nb // 1024) * 1024, device=dev)
        y[:, :nb] = torch.from_numpy(rs.rand(d, nb).astype(np.float32)).to(dev)
        k3_check(fused_knn, f"K3 {'L2' if metric_l2 else 'IP'} k_lanes={k_lanes}, d={d}",
                 rs.rand(72, d).astype(np.float32), y, nb, metric_l2, k_lanes,
                 (y[:, :nb].double() ** 2).sum(0).float().cpu().numpy(), dev,
                 ids_agree_tie_aware)
    del y

    # times
    k2_ms, k2_plain, t = turns(
        lambda: fused_knn.ivf_recon_fused_ref(*k2_args, yT_lo, **k2_kw),
        lambda: fused_knn.ivf_recon_fused(*k2_args, yT_lo, **k2_kw), 3)
    print(f"K2 hi/lo {t[1]:.2f} / {t[2]:.2f} ms, plain {t[0]:.2f} / {t[3]:.2f} ms "
          f"per 4096-query sub-batch over {yT_hi.shape[1]} columns", flush=True)
    print(f"note: cuBLAS bf16 torch.mm of K2's three hi/lo products at the same "
          f"shape, no select: "
          f"{tc_products_ms(xq4k, yT_hi, yT_lo, yT_hi.shape[1]):.2f} ms", flush=True)
    k3_times = {}
    for k_lanes, nq in ((128, NQ), (2048, 1024)):
        x = torch.from_numpy(xq[:nq]).to(dev)
        kw = dict(metric_l2=True, qt=512, k_lanes=k_lanes)
        k3_times[k_lanes] = turns(
            lambda: fused_knn.knn_fused_ref(x, xbT, NB, **kw),
            lambda: fused_knn.knn_fused(x, xbT, NB, **kw), 2)
        t = k3_times[k_lanes][2]
        print(f"K3 k_lanes={k_lanes} {t[1]:.2f} / {t[2]:.2f} ms, plain "
              f"{t[0]:.2f} / {t[3]:.2f} ms per {nq}-query bucket; "
              f"{k3_phases(fused_knn, x, xbT, k_lanes)}", flush=True)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        mm = cuda_ms(lambda: torch.mm(x, xbT), 2)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        print(f"note: cuBLAS float32 torch.mm of x @ yT [{nq} x {D}] x [{D} x "
              f"{xbT.shape[1]}] (allow_tf32 False; the product alone, no select): "
              f"{mm:.2f} ms", flush=True)
    for k in (100, 1024):
        med, times = host_median(lambda: flat.search(xq, k))
        print(f"IndexFlatL2 search of {NQ} queries at k={k}: median "
              f"{med * 1e3:.1f} ms over 5 ({', '.join(f'{t * 1e3:.1f}' for t in times)})"
              f" -> {NQ / med:.0f} QPS", flush=True)
    flat.flat_screen = False  # the fused path (K3), as phase 19
    for k, nq in ((100, NQ), (2000, 1024)):
        med, times = host_median(lambda: flat.search(xq[:nq], k))
        print(f"IndexFlatL2 fused search (flat_screen=False) of {nq} queries at "
              f"k={k}: median {med * 1e3:.1f} ms over 5 "
              f"({', '.join(f'{t * 1e3:.1f}' for t in times)}) -> {nq / med:.0f} QPS",
              flush=True)
    flat.flat_screen = True
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    # K3 has one entry per k_lanes the path runs
    # K2 hi/lo: every column and query (ops_s, two planes); both planes, n2
    # and the queries read once
    S2 = yT_hi.shape[1]
    k2_cost = (ops_s(yT_hi, 4096 * S2, planes=2),
               nbytes(yT_hi, yT_lo, n2s, xq4k) + 3 * 4096 * 512)
    return [
        entry("ivf_recon_fused", "faiss_tpu_torch/csrc/ivf_recon.cu",
              "faiss_tpu/ops/pallas_knn.py:1362", k2_launches, k2_err, k2_ms,
              k2_plain, *k2_cost),
    ] + [
        entry(f"knn_fused[k_lanes={k_lanes}]", "faiss_tpu_torch/csrc/knn_fused.cu",
              "faiss_tpu/ops/pallas_knn.py:261", k3_launches[k_lanes],
              k3_err[k_lanes], k3_times[k_lanes][0], k3_times[k_lanes][1],
              3 * 2 * nq * NB * D / PEAK_TF32,
              nq * D * 4 + nbytes(xbT) + nq * (k_lanes * 8 + 128 * 4))
        for k_lanes, nq in ((128, NQ), (2048, 1024))
    ]


def ivfflat_phases(ft, fused_knn, xb, xt, xq, gt, dev, radius):
    """Phases 23-30, then D (IVF-Flat's range search) and C (mutation):
    IndexIVFFlat(d=128, nlist=4096) on the same data (BASELINE config 3).
    Returns the entries of K1 soft + hi/lo, K1 penalized + hi/lo and K2
    masked + hi/lo in the kernels' JSON line (their launches those of
    phases 24-29), and K2's unmasked hi/lo launches at nprobe = nlist."""
    from faiss_tpu_torch.models import ivf_pq as P
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware, recall_at_k

    torch.cuda.reset_peak_memory_stats()
    index = ft.IndexIVFFlat(None, D, NLIST, device=dev)
    took = []
    for step in (lambda: index.train(xt), lambda: index.add(xb), index._build_brute):
        torch.cuda.synchronize()
        t0 = time.time()
        step()
        torch.cuda.synchronize()
        took.append(time.time() - t0)
    br = index._brute
    check(br["yT_lo"] is not None, "IVF-Flat staged no lo plane")
    ct, G, qt = index.FUSED_CT, br["cn2g"].shape[0] // 128, 256
    print(f"23. IndexIVFFlat(d={D}, nlist={NLIST}): train {took[0]:.2f} s "
          f"({index.cp.niter} k-means iterations), add {took[1]:.2f} s, stage "
          f"{took[2]:.2f} s; {br['nchunks']} chunks of {ct} slots in {G} groups, "
          f"hi/lo planes {tuple(br['yT'].shape)} bf16", flush=True)

    def layout_lists():
        """Each grouped list column's list in the index's current big-batch
        layout, and the column's entry count on the card."""
        lay = index._brute
        sm = lay["slot_map"]
        valid = sm >= 0
        col_of = (np.minimum(np.arange(len(sm)) // ct // lay["cpg"], G - 1) * 128
                  + lay["lid"][0].cpu().numpy())
        lc = np.full(G * 128, -1, np.int64)
        lc[col_of[valid]] = index._listnos_host[sm[valid]]
        n = np.bincount(index._listnos_host, minlength=NLIST)
        return lc, torch.from_numpy(np.where(lc >= 0, n[np.maximum(lc, 0)], 0)).to(dev)

    # each grouped list column's list, and each list's slots (ids = slots,
    # in the add's lists: the mutations of phase C keep every vector's list)
    listnos = index._listnos_host.copy()
    sizes = np.bincount(listnos, minlength=NLIST)
    col_size = layout_lists()[1]
    order = np.argsort(listnos, kind="stable")
    offs = np.concatenate([[0], np.cumsum(sizes)])
    check((index._ids_host == np.arange(NB)).all(), "ids are not the add order")
    xq_all = torch.from_numpy(xq).to(dev)
    qn2 = (xq.astype(np.float64) ** 2).sum(1)
    ymax = float((xb.astype(np.float64) ** 2).sum(1).max())
    tol = 1e-5 * (qn2 + ymax)
    kc = min(128, max(2 * K, K + 32))

    def probed_cols(nprobe):
        """[NQ, G * 128] bool: each query's probed list columns as the big
        batches compute them, per 4096-query sub-batch, in the current
        layout."""
        lay = index._brute
        return torch.cat([
            P._probed(xq_all[s : s + 4096], lay["centroids_g"], lay["cn2g"],
                      nprobe)[1] for s in range(0, NQ, 4096)
        ])

    def exact_in_lists(Dx, Ix, lists, need, what, alive=None):
        """Rows 0..EXACT_ROWS-1 whose lists hold >= need slots: ids equal a
        float64 exact search over the row's probed lists (their ``alive``
        ids only, where given) up to ties at tol, distances within tol.
        Returns the rows checked."""
        k, n, err = Dx.shape[1], 0, 0.0
        for q in range(EXACT_ROWS):
            ls = np.asarray(lists[q])
            slots = np.concatenate(
                [order[offs[li] : offs[li + 1]] for li in ls[ls >= 0]])
            if alive is not None:
                slots = slots[alive[slots]]
            if len(slots) < need:
                continue
            d = ((xb[slots].astype(np.float64) - xq[q].astype(np.float64)) ** 2).sum(1)
            o = np.argsort(d, kind="stable")[:k]
            want_d = np.full(k, np.inf)
            want_i = np.full(k, -1, np.int64)
            want_d[: len(o)], want_i[: len(o)] = d[o], slots[o]
            fin = np.isfinite(want_d)
            check((np.isfinite(Dx[q]) == fin).all() and ((Ix[q] >= 0) == fin).all(),
                  f"{what}: row {q} returns {int((Ix[q] >= 0).sum())} results, its "
                  f"lists hold {len(slots)}")
            e = np.abs(Dx[q][fin] - want_d[fin])
            check((e <= tol[q]).all(), f"{what}: row {q} distances differ from "
                                       f"float64 by {e.max():.3e}")
            agree = ids_agree_tie_aware(
                np.where(fin, want_d, 1e30)[None], want_i[None],
                np.where(fin, Dx[q], 1e30)[None], Ix[q][None], tol[q])
            check(agree.all(), f"{what}: row {q} ids differ from the float64 "
                               "search over its probed lists beyond ties")
            n, err = n + 1, max(err, float(e.max()) if e.size else 0.0)
        print(f"{what}: {n} of {EXACT_ROWS} rows exact within the probed lists "
              f"vs float64 (max err {err:.3e})", flush=True)
        return n

    def big_lists(nprobe):
        cols = probed_cols(nprobe)[:EXACT_ROWS].cpu().numpy()
        lc = layout_lists()[0]
        return [lc[np.where(c)[0]] for c in cols]

    launches = dict(k1=0, k1p=0, k2m=0, k2=0)

    def run(what, x, k, big=True):
        """One search with every count set to 0 just before and read just
        after; the branch, launches, host-clock median of 5, QPS and
        recall@10. Returns (D, I, drops, recall)."""
        k1, k2 = fused_knn.ivf_recon_fused_dyn, fused_knn.ivf_recon_fused
        reset_counts(fused_knn)
        t0 = time.time()
        if big:
            Dx, Ix, drops = refined(index, x, k)
        else:
            (Dx, Ix), drops = index.search(x, k), []
        torch.cuda.synchronize()
        first = time.time() - t0
        n = dict(k1=k1.launches - k1.penalized_launches, k1p=k1.penalized_launches,
                 k2m=k2.masked_launches, k2=k2.launches - k2.masked_launches)
        check(k1.hilo_launches == k1.launches and k2.hilo_launches == k2.launches,
              f"{what}: a scan ran over one plane")
        names = dict(k1="K1 soft + hi/lo", k1p="K1 penalized + hi/lo",
                     k2m="K2 masked + hi/lo", k2="K2 hi/lo")
        desc = ", ".join(f"{names[key]} x{v}" for key, v in n.items() if v)
        check(big == bool(desc), f"{what}: took {desc or 'the per-probe scan'}")
        for key, v in n.items():
            launches[key] += v
        check(Dx.shape == Ix.shape == (len(x), k), f"{what}: result shape {Dx.shape}")
        check(((Ix >= -1) & (Ix < NB)).all() and np.isfinite(Dx[Ix >= 0]).all(),
              f"{what}: invalid ids or distances")
        med, times = host_median(lambda: index.search(x, k))
        rec = recall_at_k(Ix, gt[: len(x)], K)
        print(f"{what}: {desc or 'per-probe scan, no kernel'}; first call "
              f"{first:.3f} s; median {med * 1e3:.1f} ms over 5 "
              f"({', '.join(f'{t * 1e3:.1f}' for t in times)}) -> "
              f"{len(x) / med:.0f} QPS; recall@10 {rec:.4f}; dropped chunks per "
              f"sub-batch {[nd for _, _, nd in drops]}", flush=True)
        return Dx, Ix, drops, rec

    # 24. strict probing, the default: the nprobe sweep, exact within the
    # probed lists on the rows whose lists hold kc slots
    strict = {}
    for nprobe in (1, 4, 16, 64):
        index.nprobe = nprobe
        strict[nprobe] = run(f"24. strict nprobe={nprobe}", xq, K)
        Dx, Ix, drops, _ = strict[nprobe]
        check(drops[0][2] == 0, "the first sub-batch dropped probed chunks")
        exact_in_lists(Dx, Ix, big_lists(nprobe), kc, f"strict nprobe={nprobe}")
    recalls = [strict[n][3] for n in strict]
    check(all(b >= a - 0.002 for a, b in zip(recalls, recalls[1:])),
          f"recall@10 falls as nprobe grows: {recalls}")

    # 25. soft probing at nprobe 1 and 16: per rank no worse than strict
    index.strict_probe = False
    for nprobe in (1, 16):
        index.nprobe = nprobe
        Dx, Ix, drops, _ = run(f"25. soft nprobe={nprobe}", xq, K)
        full = ((probed_cols(nprobe) * col_size).sum(1) >= kc).cpu().numpy()
        rows = undropped(drops, NQ) & full
        worse = Dx[rows] > strict[nprobe][0][rows] + tol[rows, None]
        check(not worse.any(), f"soft nprobe={nprobe}: {int(worse.any(1).sum())} "
                               "rows rank worse than strict")
        print(f"soft nprobe={nprobe}: distances per rank no worse than strict on "
              f"all {int(rows.sum())} rows of undropped sub-batches whose lists "
              f"hold >= {kc} slots", flush=True)
    index.strict_probe = True

    # 26. strict at nprobe=1 with dyn_engage_frac = 0.7: K1 penalized
    index.nprobe = 1
    index.dyn_engage_frac = 0.7
    Dx, Ix, drops, _ = run("26. strict nprobe=1, dyn_engage_frac=0.7", xq, K)
    check(drops[0][2] == 0, "the first sub-batch dropped probed chunks")
    exact_in_lists(Dx, Ix, big_lists(1), kc, "strict nprobe=1, frac 0.7")
    index.dyn_engage_frac = 0.08

    # 27. nprobe = nlist on 2048 queries (K2 unmasked): the ids equal the
    # ground truth up to ties at 1e-6 (|q|^2 + max |y|^2)
    index.nprobe = NLIST
    nq0 = 2048
    Dx, Ix, _, _ = run(f"27. nprobe=nlist, {nq0} queries", xq[:nq0], K)
    y64 = torch.from_numpy(xb).to(dev, torch.float64)
    q64 = xq_all[:nq0].double()

    def sorted_d64(ids):
        i = torch.from_numpy(ids).to(dev)
        d, o = torch.sort((q64[:, None, :] - y64[i]).square().sum(-1), 1)
        return d.cpu().numpy(), torch.gather(i, 1, o).cpu().numpy()

    d_gt, i_gt = sorted_d64(gt[:nq0])
    d_pt, i_pt = sorted_d64(Ix)
    agree = ids_agree_tie_aware(d_gt, i_gt, d_pt, i_pt, 1e-6 * (qn2[:nq0] + ymax))
    differ = int((np.sort(i_gt, 1) != np.sort(i_pt, 1)).any(1).sum())
    check(agree.all(), f"nprobe=nlist: ids disagree with the ground truth beyond "
                       f"ties on {int((~agree).sum())} rows")
    print(f"nprobe=nlist: id sets differ from bench_gt_cache.npz on {differ} rows, "
          "all within ties", flush=True)
    del y64, q64

    # 28-29. the per-probe scan: 64 queries at nprobe=16, 1024 at k=100
    index.nprobe = 16
    Dx, Ix, _, _ = run("28. by probe: 64 queries, nprobe=16", xq[:64], K, big=False)
    x128 = torch.zeros(128, D, device=dev)
    x128[:64] = xq_all[:64]
    lists = index._coarse_search(x128, 16)[1][:EXACT_ROWS].cpu().numpy()
    exact_in_lists(Dx, Ix, lists, 0, "by probe, 64 queries")
    Dx, Ix, _, _ = run("29. by probe: 1024 queries, k=100, nprobe=16", xq[:1024],
                       100, big=False)
    lists = index._coarse_search(xq_all[:1024], 16)[1][:EXACT_ROWS].cpu().numpy()
    exact_in_lists(Dx, Ix, lists, 0, "by probe, k=100")
    check(launches["k1"] and launches["k1p"] and launches["k2m"] and launches["k2"],
          f"a kernel mode of the IVF-Flat path launched no time: {launches}")

    # 30. the new kernel modes against their plain versions on the first
    # 4096-query sub-batch of their paths (nprobe=1), timed in turns
    xq4 = xq_all[:4096]
    n2 = br["n2s"][0].cpu().numpy()
    msteps = index._dyn_bucket[1]
    perm, pcols_s, cm2, cmap, _ = P._dyn_inputs(xq4, br, 1, qt, msteps)
    xs = xq4[perm]
    a1 = (P._pad_dims(xs, br), br["yT"], br["n2s"], cmap, qt, ct)
    qn_s = xs.square().sum(1).cpu().numpy()
    pen = torch.where(P._probe_mask(cm2, pcols_s), 0.0, 1e9)
    variants = k1_variants(
        fused_knn, f"[4096 q, {msteps} steps]", a1,
        dict(biasg=pen, lid=br["lid"], cgroup=br["cgroup"]), br["yT_lo"], qn_s, n2,
        10, d=D)
    k1, k1p = variants["soft + hi/lo"], variants["penalized + hi/lo"]
    real_cols = int((cmap != br["nchunks"]).sum(1).float().mean()) * ct
    print(f"note: cuBLAS bf16 torch.mm of K1's three hi/lo products over the "
          f"mean tile's real worklist columns (4096 q x {real_cols}), no select: "
          f"{tc_products_ms(a1[0], br['yT'], br['yT_lo'], real_cols, 10):.3f} ms",
          flush=True)
    mask = torch.where(P._probed(xq4, br["centroids_g"], br["cn2g"], 1)[1], 0.0, 1e9)
    a2 = (P._pad_dims(xq4, br), br["yT"], br["n2s"], br["yT_lo"])
    kw2 = dict(qt=qt, ct=ct, biasg=mask, lid=br["lid"])
    k2m = kernel_check(
        fused_knn, f"K2 masked + hi/lo [4096 q x {br['yT'].shape[1]} slots]",
        lambda: fused_knn.ivf_recon_fused(*a2, **kw2),
        lambda: fused_knn.ivf_recon_fused_ref(*a2, **kw2),
        xq4.square().sum(1).cpu().numpy(), n2, 3, recon="K2")
    print(f"IVF-Flat peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    dyn = "faiss_tpu_torch/csrc/ivf_recon_dyn.cu"
    full = "faiss_tpu_torch/csrc/ivf_recon.cu"
    entries = [
        entry("ivf_recon_dyn[hilo]", dyn, "faiss_tpu/ops/pallas_knn.py:1249",
              launches["k1"], *k1,
              *dyn_cost(br, cmap, qt, br["yT"], (a1[0],), False, planes=2)),
        entry("ivf_recon_dyn[hilo,penalized]", dyn, "faiss_tpu/ops/pallas_knn.py:1249",
              launches["k1p"], *k1p,
              *dyn_cost(br, cmap, qt, br["yT"], (a1[0], pen), True, planes=2)),
        entry("ivf_recon[masked,hilo]", full, "faiss_tpu/ops/pallas_knn.py:1362",
              launches["k2m"], *k2m,
              *scan_cost(br["yT"], br["n2s"], len(xq4), (a2[0], mask), True,
                         planes=2)),
    ]
    del a1, a2, kw2, pen, mask, xs, perm, cm2, cmap, br, variants

    # D. range search at nprobe 16 on the whole index (by probe, no kernel),
    # against float64 over each row's probed lists
    index.nprobe = 16
    res = no_kernel(fused_knn, "D. IVF-Flat range_search, 64 queries, nprobe=16",
                    lambda: index.range_search(xq[:EXACT_ROWS], radius))
    lists = index._coarse_search(xq_all[:EXACT_ROWS], 16)[1].cpu().numpy()
    d64, ymax64 = d64_rows(xb, xq, dev)
    range_check("D. IVF-Flat nprobe=16", res, xq, radius, d64, ymax64,
                lambda q: np.concatenate([order[offs[li] : offs[li + 1]]
                                          for li in lists[q]]))
    del d64

    # C. remove_ids of a seeded 10% of the ids, then the strict (K2 masked +
    # hi/lo) and soft (K1 soft + hi/lo) searches at nprobe=1; merge_from an
    # index on the same quantizer holding the removed rows; update_vectors
    rs = np.random.RandomState(12)
    gone = np.sort(rs.choice(NB, NB // 10, replace=False))
    alive = np.ones(NB, bool)
    alive[gone] = False
    index.nprobe, index.strict_probe, index.dyn_engage_frac = 1, True, 0.08
    t0 = time.time()
    nrem = index.remove_ids(ft.IDSelectorBatch(gone))
    t_rm = time.time() - t0
    check(nrem == len(gone) and index.ntotal == NB - nrem and index._brute is None,
          f"C. remove_ids removed {nrem} and kept the big-batch layout")
    print(f"C. remove_ids of {nrem} ids: {t_rm:.3f} s ({CARD})", flush=True)
    for mode in ("strict", "soft"):
        index.strict_probe = mode == "strict"
        before = dict(launches)
        Dx, Ix, drops, _ = run(f"C. {mode} nprobe=1 after remove_ids", xq, K)
        key = "k2m" if mode == "strict" else "k1"
        check(launches[key] > before[key],
              f"C. {mode}: its kernel ({key}) launched no time")
        check(not np.isin(Ix, gone).any(), f"C. {mode}: a removed id came back")
        if mode == "strict":
            exact_in_lists(Dx, Ix, big_lists(1), kc, "C. strict after remove_ids",
                           alive=alive)
    index.strict_probe = True
    other = ft.IndexIVFFlat(index.quantizer, D, NLIST, device=dev)
    t0 = time.time()
    other.add_with_ids(xb[gone], gone)
    index.merge_from(other)
    t_merge = time.time() - t0
    check(index.ntotal == NB and other.ntotal == 0 and index._brute is None,
          "C. merge_from")
    Dx, Ix, _, _ = run("C. strict nprobe=1 after merge_from", xq, K)
    full = ((probed_cols(1) * layout_lists()[1]).sum(1) >= kc).cpu().numpy()
    rows = np.nonzero(full[:EXACT_ROWS])[0]
    Ds1, Is1 = strict[1][0], strict[1][1]
    agree = ids_agree_tie_aware(Ds1[rows], Is1[rows], Dx[rows], Ix[rows], tol[rows])
    check(agree.all() and (np.abs(Dx[rows] - Ds1[rows]) <= tol[rows, None]).all(),
          f"C. after merge_from: {int((~agree).sum())} of {len(rows)} rows differ "
          "from phase 24 at nprobe=1")
    print(f"C. merge_from of {len(gone)} rows (add + merge {t_merge:.3f} s, "
          f"{CARD}): {len(rows)} of {EXACT_ROWS} rows whose lists hold {kc} "
          "entries agree with phase 24 at nprobe=1, ids tie-aware", flush=True)
    upd = rs.choice(NB, 1000, replace=False)
    new = xt[rs.choice(len(xt), 1000, replace=False)]
    t0 = time.time()
    index.update_vectors(upd, new)
    back = index.reconstruct_batch(upd)
    check(np.array_equal(back, new), "C. reconstruct after update_vectors")
    moved = int((index._listnos_host[index._slots_of_ids(upd)] != listnos[upd]).sum())
    print(f"C. update_vectors of 1000 ids + reconstruct: {time.time() - t0:.3f} s "
          f"({CARD}); {moved} moved to another list; reconstruct returns the new "
          "vectors", flush=True)
    return entries, launches["k2"]


# Deep10M-like set of benchs/bench_deep10m.py:33-34 (its two-level mixture)
DEEP_D, DEEP_NB, DEEP_NT, DEEP_NQ = 96, 10_000_000, 500_000, 8192
DEEP_NCOARSE, DEEP_NSUB = 1024, 64
# the Deep10M row of benchs/bench_deep10m.py:242-248 and its operating point
DEEP_KEY = "OPQ32,IVF8192,PQ32x4fs,RFlat"
DEEP_NPROBE, DEEP_K_FACTOR, DEEP_RECALL_REF = 8, 12, 0.9784
IO_COMPAT = ROOT / "tests" / "io_compat"


def gen_deep(n, seed, coarse, subdirs, scales):
    """Rows of the two-level mixture, L2-normalized: the generator of
    benchs/bench_deep10m.py:42-60, copied, writing into RAM."""
    r = np.random.RandomState(seed)
    out = np.empty((n, DEEP_D), np.float32)
    bs = 1_000_000
    for s in range(0, n, bs):
        m = min(bs, n - s)
        ci = r.randint(DEEP_NCOARSE, size=m)
        si = r.randint(DEEP_NSUB, size=m)
        x = (
            coarse[ci]
            + 0.25 * subdirs[ci, si]
            + r.randn(m, DEEP_D).astype(np.float32) * scales[None, :] * 0.05
        )
        x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-9
        out[s : s + m] = x
    return out


def deep_data(nb=DEEP_NB, nt=DEEP_NT, nq=DEEP_NQ):
    """(xb, xt, xq) of benchs/bench_deep10m.py:67-88: the mixture's modes
    from seed 7, then the base, training and query rows from seeds 1, 2
    and 3."""
    rs = np.random.RandomState(7)
    coarse = rs.randn(DEEP_NCOARSE, DEEP_D).astype(np.float32)
    coarse /= np.linalg.norm(coarse, axis=1, keepdims=True)
    subdirs = rs.randn(DEEP_NCOARSE, DEEP_NSUB, DEEP_D).astype(np.float32) * 0.3
    scales = (1.0 / np.sqrt(np.arange(DEEP_D) + 1.0)).astype(np.float32)
    return tuple(gen_deep(n, seed, coarse, subdirs, scales)
                 for n, seed in ((nb, 1), (nt, 2), (nq, 3)))


def deep_gt():
    with np.load(ROOT / ".deep10m_gt.npz") as z:
        return z["gt"]


def class_tree(index):
    """The index's classes from the outside in, with their shapes."""
    parts = []
    while index is not None:
        name = type(index).__name__
        if hasattr(index, "chain"):
            name += "[" + ", ".join(
                f"{type(vt).__name__}({vt.d_in}->{vt.d_out}"
                + (f", M={vt.M})" if hasattr(vt, "M") else ")")
                for vt in index.chain) + "]"
            nxt = index.index
        elif hasattr(index, "base_index"):
            name += (f"(store={getattr(index, 'store', '?')}, "
                     f"k_factor={index.k_factor})")
            nxt = index.base_index
        else:
            name += f"(d={index.d}"
            if hasattr(index, "nlist"):
                name += (f", nlist={index.nlist}, quantizer="
                         f"{type(index.quantizer).__name__}")
            if hasattr(index, "pq"):
                name += f", M={index.pq.M}, nbits={index.pq.nbits}"
            if hasattr(index, "bbs"):
                name += f", bbs={index.bbs}"
            name += ")"
            nxt = None
        parts.append(name)
        index = nxt
    return " > ".join(parts)


def rows_equal_up_to_k1_ties(what, D0, I0, D1, I1):
    """Two searches of one index: K1's order among tied keys is not fixed
    across launches, so where its keys tie at the candidate cut the two may
    re-rank other candidates. Nearly every row must come back with equal
    distances, and those rows with equal ids up to exact ties. Returns the
    number of other rows."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    same = (D0 == D1).all(1)
    check(same.mean() >= 0.999 and ids_agree_tie_aware(
        D0[same], I0[same], D1[same], I1[same], 0.0).all(),
        f"{what}: {int((~same).sum())} rows differ")
    return int((~same).sum())


def io_phases(ft, fused_knn, state, xq, dev):
    """Phase G: index files on the card. write_index of phase 4's main-path
    index, read_index onto the card: arrays bitwise equal, the search equal
    to phase 5's up to rows tied at K1's cut; then the committed
    tests/io_compat files of faiss_tpu."""
    import tempfile

    index = state["index"]
    base = index.base_index
    with tempfile.TemporaryDirectory() as tmp:
        fname = str(Path(tmp) / "ivf4096_pq32x4fs_rflat.npz")
        t0 = time.time()
        ft.write_index(index, fname)
        t_write = time.time() - t0
        size = Path(fname).stat().st_size
        t0 = time.time()
        back = ft.read_index(fname, device=dev)
        t_read = time.time() - t0
    rb = back.base_index
    check(type(back) is type(index) and type(rb) is type(base)
          and back.store == index.store == "f16" and back.k_factor == index.k_factor
          and rb.nprobe == base.nprobe and rb.bbs == base.bbs,
          f"G. read_index gave {class_tree(back)}")
    pairs = (
        ("coarse centroids", base.quantizer.vectors(), rb.quantizer.vectors()),
        ("PQ codebooks", base.pq.centroids, rb.pq.centroids),
        ("codes", base._codes_host, rb._codes_host),
        ("list numbers", base._listnos_host, rb._listnos_host),
        ("ids", base._ids_host, rb._ids_host),
        ("refine store", index.refine_index.vectors(), back.refine_index.vectors()),
    )
    for what, a, b in pairs:
        check(a.dtype == b.dtype and a.shape == b.shape
              and np.array_equal(a.view(np.uint8), np.asarray(b).view(np.uint8)),
              f"G. {what} differ after the round trip")
    # phase 5's settings (the later phases changed the written index's)
    rb.nprobe, rb.strict_probe, rb.pipeline_batch = NPROBE, False, BATCH
    back.k_factor = K_FACTOR
    reset_counts(fused_knn)
    Dr, Ir = back.search(xq, K)
    torch.cuda.synchronize()
    n = fused_knn.ivf_recon_fused_dyn.launches
    check(n > 0, "G. the read index's search launched K1 no time")
    other = rows_equal_up_to_k1_ties("G. the read index's search against phase 5's",
                                     state["D"], state["I"], Dr, Ir)
    print(f"G. write_index of phase 4's index ({class_tree(index)}): "
          f"{size / 2**20:.1f} MiB in {t_write:.2f} s, read_index onto the card "
          f"{t_read:.2f} s; {len(pairs)} arrays bitwise equal; the search (K1 "
          f"x{n}) equals phase 5's on {NQ - other} of {NQ} rows, the other "
          f"{other} re-ranked candidates tied at K1's cut ({CARD})", flush=True)
    del back, rb

    # the committed files of faiss_tpu 0.1.0
    for name in ("Flat", "IVF8_Flat", "IVF8_PQ4"):
        got = ft.read_index(str(IO_COMPAT / f"v0_1_0_{name}.npz"), device=dev)
        check(got.ntotal == 1200 and got.device == dev,
              f"G. v0_1_0_{name}: ntotal {got.ntotal} on {got.device}")
    with np.load(IO_COMPAT / "golden_ivfpq.npz") as z:
        Dg, Ig, xg = z["D"], z["I"], z["xq"]
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    got.nprobe = 8
    Dp, Ip = got.search(xg, Dg.shape[1])
    # the tolerance of tests/test_io_compat.py: rtol 1e-5, atol 1e-6 (the
    # float32 ADC sums of near-zero distances), ties within it either side
    check(ids_agree_tie_aware(Dg, Ig, Dp, Ip, 1e-5 * np.abs(Dg[:, -1]) + 1e-6).all()
          and np.allclose(Dp, Dg, rtol=1e-5, atol=1e-6),
          "G. v0_1_0_IVF8_PQ4 does not reproduce golden_ivfpq.npz")
    sq8 = ft.read_index(str(IO_COMPAT / "v0_1_0_SQ8.npz"), device=dev)
    check(type(sq8).__name__ == "IndexScalarQuantizer" and sq8.ntotal == 1200
          and np.array_equal(sq8.vectors(), sq8.sq.decode(sq8._codes)),
          f"G. v0_1_0_SQ8 read as {class_tree(sq8)}, ntotal {sq8.ntotal}")
    fs = ft.read_index(str(IO_COMPAT / "v0_1_0_PQ4x4fs.npz"), device=dev)
    with np.load(IO_COMPAT / "v0_1_0_PQ4x4fs.npz") as z:
        fs_codes = z["root/codes"]
    check(type(fs).__name__ == "IndexPQFastScan" and fs.ntotal == 1200
          and fs.device == dev and np.array_equal(fs.codes_host, fs_codes),
          f"G. v0_1_0_PQ4x4fs read as {class_tree(fs)}, ntotal {fs.ntotal}")
    from faiss_tpu_torch.ops import pq_ops

    Df, If = fs.search(xg, 10)
    luts = pq_ops.pq_distance_tables(torch.from_numpy(xg).to(dev), fs.pq._dev())
    luts = luts.to(torch.bfloat16).float()  # the FastScan scan's own tables
    err = adc_rows_check("G. v0_1_0_PQ4x4fs", Df, If, adc64(luts, fs._codes),
                         lut_tol(luts))
    print(f"G. tests/io_compat: Flat, IVF8_Flat, IVF8_PQ4, SQ8 and PQ4x4fs read onto "
          f"the card (ntotal 1200 each); IVF8_PQ4 at nprobe 8 reproduces "
          f"golden_ivfpq.npz (max |D - golden| "
          f"{float(np.abs(Dp - Dg).max()):.3e}); PQ4x4fs (IndexPQFastScan) equals "
          f"a float64 ADC of its bf16 tables on all {len(xg)} queries (max err "
          f"{err:.3e})", flush=True)


def deep10m_phases(ft, fused_knn, dev, only_k=False):
    """Phase F: OPQ32,IVF8192,PQ32x4fs,RFlat built by index_factory on the
    card over the Deep10M-like 10M x 96 set, searched at the reference's
    Deep10M point (K1 on every sub-batch), K1 held against its plain
    version on the first real sub-batch. Returns K1's entry of the kernels'
    JSON line at this path's shape."""
    from faiss_tpu_torch.models.ivf_pq import _dyn_inputs, _pad_dims, _probe_mask
    from faiss_tpu_torch.utils.evaluation import recall_at_k

    t0 = time.time()
    xb, xt, xq = deep_data()
    gt = deep_gt()
    t_data = time.time() - t0
    # the ground truth's nearest neighbour is the float32 brute-force
    # minimum on the card
    xb_d = torch.from_numpy(xb).to(dev)
    nq_gt, exact = 32, 0
    for q in range(nq_gt):
        d = (xb_d - torch.from_numpy(xq[q]).to(dev)).square().sum(1)
        dmin = float(d.min())
        check(float(d[int(gt[q, 0])]) <= dmin + 1e-6 * (float((xq[q] ** 2).sum()) + 1.0),
              f"F. query {q}: gt[:, 0] is not the float32 brute-force minimum")
        exact += int(torch.argmin(d)) == int(gt[q, 0])
    del xb_d, d
    torch.cuda.empty_cache()
    print(f"F. Deep10M-like data {xb.shape[0]} x {DEEP_D} (+{len(xt)} train, "
          f"{len(xq)} queries) in RAM {t_data:.1f} s; gt[:, 0] of "
          f".deep10m_gt.npz is the float32 brute-force minimum on {nq_gt} of "
          f"{nq_gt} queries ({exact} the argmin itself)", flush=True)

    if only_k:
        imi_phase(ft, fused_knn, xb, xt, xq, gt, dev)
        return None
    torch.cuda.reset_peak_memory_stats()
    index = ft.index_factory(DEEP_D, DEEP_KEY)
    refine = index.index
    base = refine.base_index
    check(index.device == dev and base.device == dev, "F. not built on the card")
    base.cp.niter = NITER
    print(f"F. index_factory({DEEP_D}, {DEEP_KEY!r}): {class_tree(index)}",
          flush=True)
    torch.cuda.synchronize()
    t0 = time.time()
    index.train(xt)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    t0 = time.time()
    index.add(xb)
    torch.cuda.synchronize()
    t_add = time.time() - t0
    t0 = time.time()
    br = base._build_brute()
    refine.refine_index._consolidate()
    torch.cuda.synchronize()
    t_stage = time.time() - t0
    check(br["yT"] is not None, "F. no decoded store: K1 cannot run")
    print(f"F. train {t_train:.1f} s (OPQ, {NITER} k-means iterations, PQ), add "
          f"{t_add:.1f} s, stage {t_stage:.1f} s; nchunks {br['nchunks']}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({CARD})", flush=True)

    # the reference's Deep10M point, set on the inner indexes (the wrapper
    # forwards reads only)
    base.nprobe, base.strict_probe = DEEP_NPROBE, False
    refine.k_factor = DEEP_K_FACTOR
    t0 = time.time()
    index.search(xq, K)  # sizes the worklist from its first sub-batch
    t_first = time.time() - t0
    sized = base._dyn_bucket[DEEP_NPROBE]

    def run():
        handle = index.search_submit(xq, K)
        subs = [(int(out[2]), dyn) for _, _, out, dyn in handle[1]["pending"]]
        return index.search_collect(handle), subs

    # a sub-batch that drops probed chunks widens the bucket by 64 at its
    # collect; after the widening no sub-batch may drop one
    widen = 0
    while True:
        reset_counts(fused_knn)
        (Dm, Im), subs = run()
        torch.cuda.synchronize()
        if all(nd == 0 for nd, _ in subs) or widen == 3:
            break
        widen += 1
    launches = fused_knn.ivf_recon_fused_dyn.launches
    msteps = base._dyn_bucket[DEEP_NPROBE]
    check(all(nd == 0 for nd, _ in subs),
          f"F. sub-batches dropped probed chunks after {widen} widenings: {subs}")
    check(all(dyn for _, dyn in subs) and launches == len(subs)
          and total_launches(fused_knn) == launches,
          f"F. not every sub-batch took K1's dynamic path: {subs}, K1 x{launches}, "
          f"all kernels x{total_launches(fused_knn)}")
    check(msteps <= int(base.soft_engage_frac * br["nchunks"]),
          f"F. msteps {msteps} past the soft engage fraction")
    check(Dm.shape == Im.shape == (len(xq), K) and np.isfinite(Dm).all()
          and (Im >= 0).all() and (Im < len(xb)).all(),
          "F. non-finite distances or invalid ids")
    recall = recall_at_k(Im, gt, K)
    print(f"F. search of {len(xq)} queries, nprobe={DEEP_NPROBE} soft, "
          f"k_factor={DEEP_K_FACTOR}: first call {t_first:.2f} s (sized msteps "
          f"{sized}); {widen} widening searches; K1 x{launches} on "
          f"{len(subs)} sub-batches, all on the dynamic path, no other kernel; "
          f"msteps {msteps} of {br['nchunks']} chunks "
          f"({msteps / br['nchunks']:.4f}), {fused_knn.ivf_recon_fused_dyn.splits} "
          f"worklist splits; ndropped {[nd for nd, _ in subs]}; recall@10 "
          f"{recall:.4f} (faiss_tpu's at this point: {DEEP_RECALL_REF}, "
          "benchs/results/deep10m.json)", flush=True)
    check(recall >= RECALL_MIN, f"F. recall@10 {recall:.4f} < {RECALL_MIN}")

    # distances: exact to the float32 refine store, in float64 through the
    # float64 rotation, and to the unrotated vectors (OPQ is orthonormal)
    A = index.chain[0].A.astype(np.float64)
    q64 = xq[:EXACT_ROWS].astype(np.float64)
    y = refine.refine_index.reconstruct_batch(Im[:EXACT_ROWS].ravel())
    y = y.reshape(EXACT_ROWS, K, DEEP_D).astype(np.float64)
    d_rot = (((q64 @ A.T)[:, None, :] - y) ** 2).sum(-1)
    tol = 1e-5 * ((q64 ** 2).sum(1)[:, None] + (y ** 2).sum(-1))
    err_rot = np.abs(Dm[:EXACT_ROWS] - d_rot)
    check((err_rot <= tol).all(), f"F. distances differ from float64 |Aq - Ax|^2 "
                                  f"by {err_rot.max():.3e}")
    d_raw = ((q64[:, None, :] - xb[Im[:EXACT_ROWS]].astype(np.float64)) ** 2).sum(-1)
    rel = np.abs(Dm[:EXACT_ROWS] - d_raw) / np.maximum(d_raw, 1e-30)
    check((rel <= 1e-4).all(), f"F. distances differ from the unrotated "
                               f"|q - x|^2 by {rel.max():.3e} relative")
    # submit / collect against search
    Ds, Is = index.search(xq, K)
    other = rows_equal_up_to_k1_ties("F. search_submit/collect against search",
                                     Dm, Im, Ds, Is)
    t_search, times = host_median(lambda: index.search(xq, K))
    t_rot, _ = host_median(lambda: index.apply_chain(xq))
    print(f"F. {EXACT_ROWS} rows: distances = float64 |Aq - Ax|^2 to the float32 "
          f"store (max err {err_rot.max():.3e}) and = the unrotated |q - x|^2 "
          f"(max rel {rel.max():.3e}); submit/collect = search on "
          f"{len(xq) - other} of {len(xq)} rows ({other} re-ranked candidates "
          f"tied at K1's cut); search median {t_search * 1e3:.1f} ms over 5 "
          f"({', '.join(f'{t * 1e3:.1f}' for t in times)}) -> "
          f"{len(xq) / t_search:.0f} QPS; of it the OPQ rotation with its host "
          f"round trip {t_rot * 1e3:.1f} ms; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({CARD})",
          flush=True)

    # K1 against its plain version on the first real sub-batch of the path
    qt, batch = 256, base.pipeline_batch
    xr = torch.from_numpy(index.apply_chain(xq[:batch])).to(dev)
    perm, pcols_s, cm2, cmap, ndropped = _dyn_inputs(xr, br, DEEP_NPROBE, qt, msteps)
    xq_p = _pad_dims(xr[perm], br)
    args = (xq_p, br["yT"], br["n2s"], cmap, qt, base.FUSED_CT)
    pen = dict(biasg=torch.where(_probe_mask(cm2, pcols_s), 0.0, 1e9),
               lid=br["lid"], cgroup=br["cgroup"])
    n2 = br["n2s"][0].cpu().numpy()
    variants = k1_variants(
        fused_knn, f"F. [{batch} q, {msteps} steps, ndropped {int(ndropped)}]", args,
        pen, second_plane(br["yT"]), (xq_p.cpu().numpy() ** 2).sum(1), n2, 3,
        d=DEEP_D)
    err, ms, plain_ms = variants["soft"]
    t_ops, nbyt = dyn_cost(br, cmap, qt, br["yT"], (xq_p,), False, d=DEEP_D)
    d_pad = br["d_pad"]
    print(f"F. K1 at d={DEEP_D} of d_pad={d_pad}: the kernel multiplies and reads "
          f"{DEEP_D} dims, the padding's {(d_pad - DEEP_D) / d_pad:.0%} skipped; "
          f"bound at d={DEEP_D} {max(t_ops * 1e3, nbyt / PEAK_BYTES * 1e3):.3f} ms "
          f"({CARD})", flush=True)
    k1 = entry("ivf_recon_dyn[opq,d96]", "faiss_tpu_torch/csrc/ivf_recon_dyn.cu",
               "faiss_tpu/ops/pallas_knn.py:1249", launches, err, ms, plain_ms,
               t_ops, nbyt)
    # K-c on the same rows (generated once): phase F's index freed first
    del index, refine, base, br, xr, xq_p, args
    torch.cuda.empty_cache()
    t0 = time.time()
    imi_phase(ft, fused_knn, xb, xt, xq, gt, dev)
    print(f"K. K-c {time.time() - t0:.1f} s", flush=True)
    return k1


# BASELINE.md row 12: k-means of MNIST8m, 8.1M x 784 uint8 -> 256 centroids,
# 20 iterations; the stand-in set is benchs/jobs/job_kmeans_row12.py's
ROW12_N, ROW12_D, ROW12_K, ROW12_NITER = 8_100_000, 784, 256, 20
ROW12_SAMPLE, ROW12_PEAK_GIB = 65_536, 12


def row12_data(n=None):
    """The MNIST8m-shaped uint8 set of benchs/jobs/job_kmeans_row12.py:33-52,
    its generator copied, writing into RAM: 512 prototype images from seed
    42, each row a prototype plus a uniform jitter of +-24, clipped; n rows
    (ROW12_N unless given)."""
    n = ROW12_N if n is None else n
    rs = np.random.RandomState(42)
    protos = (rs.rand(512, ROW12_D) ** 2 * 255).astype(np.int16)
    x = np.empty((n, ROW12_D), np.uint8)
    bs = 500_000
    for s in range(0, n, bs):
        m = min(bs, n - s)
        pi = rs.randint(512, size=m)
        jit = rs.randint(-24, 25, size=(m, ROW12_D), dtype=np.int16)
        np.clip(protos[pi] + jit, 0, 255, out=jit)
        x[s : s + m] = jit.astype(np.uint8)
    return x


def update_ms(xd, assign, k, chunk):
    """One iteration's centroid sums over the resident uint8 set, chunk by
    chunk with each chunk decoded, two ways: the loop's own
    ``add_to_centroids`` (``index_add_``: float32 atomics, one point at a
    time) and a float32 one-hot product. Returns
    ({way: ms by CUDA events}, {way: largest error against the exact sums,
    relative to the largest sum}). The exact sums are float64 (integers
    below 2^53 add exactly); in float32 a big cluster's sums pass 2^24,
    where integers stop adding exactly."""

    from faiss_tpu_torch.ops.kmeans_ops import add_to_centroids

    def index_add(dtype=torch.float32):
        sums = torch.zeros(k, xd.shape[1], dtype=dtype, device=xd.device)
        for s in range(0, len(xd), chunk):
            add_to_centroids(sums, assign[s : s + chunk], xd[s : s + chunk].to(dtype))
        return sums

    def one_hot():
        sums = torch.zeros(k, xd.shape[1], device=xd.device)
        for s in range(0, len(xd), chunk):
            a = assign[s : s + chunk]
            oh = torch.zeros(len(a), k, device=xd.device)
            oh[torch.arange(len(a), device=xd.device), a] = 1.0
            sums += oh.T @ xd[s : s + chunk].float()
        return sums

    exact = index_add(torch.float64)
    ways = (("index_add_", index_add), ("one-hot", one_hot))
    err = {name: float((fn().double() - exact).abs().max() / exact.abs().max())
           for name, fn in ways}
    check(max(err.values()) <= 1e-2,
          f"H. the centroid sums are not the exact sums: {err}")
    ms = {name: float(np.mean([cuda_ms(fn, 1) for _ in range(2)]))
          for name, fn in ways}
    return ms, err


def kmeans_row12_phase(ft, fused_knn, dev):
    """Phase H: BASELINE row 12 on the card. The 8.1M x 784 uint8 set made
    in RAM, Kmeans(784, 256, niter=20, seed=1234) trained through the uint8
    branch (the set stays uint8 on the card), then the 20-iteration loop
    alone by CUDA events, the two centroid updates timed, and the result
    checked against float64 on a seeded sample."""
    from faiss_tpu_torch import clustering
    from faiss_tpu_torch.ops import kmeans_ops

    t0 = time.time()
    x = row12_data()
    t_gen = time.time() - t0
    print(f"H. row 12 data {x.shape[0]} x {x.shape[1]} uint8 "
          f"({x.nbytes / 1e9:.2f} GB) generated in RAM in {t_gen:.1f} s", flush=True)

    seen = []
    real_loop = clustering.kmeans_fused_loop

    def spy(xd, *args, **kw):
        seen.append((xd.dtype, xd.device.type, tuple(xd.shape)))
        return real_loop(xd, *args, **kw)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    km = ft.Kmeans(ROW12_D, ROW12_K, niter=ROW12_NITER, seed=1234,
                   max_points_per_centroid=10**9)
    clustering.kmeans_fused_loop = spy
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        obj = km.train(x)
        torch.cuda.synchronize()
        t_e2e = time.time() - t0
    finally:
        clustering.kmeans_fused_loop = real_loop
    peak = torch.cuda.max_memory_allocated()
    check(km.device == dev, f"H. Kmeans ran on {km.device}")
    check(seen == [(torch.uint8, dev.type, x.shape)],
          f"H. the loop was given {seen}, not the uint8 set on the card")
    check(peak < ROW12_PEAK_GIB * 2**30,
          f"H. peak device memory {peak / 2**30:.2f} GiB, not under "
          f"{ROW12_PEAK_GIB} GiB")
    objs = np.asarray(km.obj, np.float64)
    check(len(objs) == ROW12_NITER and np.isfinite(objs).all() and obj == objs[-1],
          f"H. objectives {objs}")
    rise = np.diff(objs) / objs[:-1]
    check((rise <= 1e-5).all(), f"H. the objective rose by {rise.max():.3e} relative")
    nsplit = sum(s.nsplit for s in km.iteration_stats)
    print(f"H. Kmeans({ROW12_D}, {ROW12_K}, niter={ROW12_NITER}, seed=1234).train "
          f"on the card: {t_e2e:.2f} s end to end (upload included); peak device "
          f"memory {peak / 2**30:.2f} GiB (the set {x.nbytes / 2**30:.2f} GiB, "
          f"uint8 on the card); {nsplit} splits; imbalance "
          f"{km.iteration_stats[-1].imbalance_factor:.4f}; objective per "
          f"iteration: {', '.join(f'{o:.8e}' for o in objs)} ({CARD})", flush=True)

    # the upload and the loop alone, from the same init
    torch.cuda.synchronize()
    t0 = time.time()
    xd = torch.from_numpy(x).to(dev)
    torch.cuda.synchronize()
    t_up = time.time() - t0
    rs = np.random.RandomState(1234)
    init = torch.from_numpy(
        x[rs.permutation(len(x))[:ROW12_K]].astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    chunk = clustering._point_chunk(ROW12_K, ROW12_D)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    c, objs2, _, _, _, _ = kmeans_ops.kmeans_fused_loop(
        xd, init, gen, niter=ROW12_NITER, chunk=chunk)
    e1.record()
    torch.cuda.synchronize()
    t_loop = e0.elapsed_time(e1) / 1e3
    # the same arithmetic, but index_add_'s float32 atomics add in no fixed
    # order: the objectives move in their last digits from run to run
    loop_rel = float(np.abs(objs2.cpu().numpy() / objs - 1).max())
    check(loop_rel <= 1e-4, f"H. the loop alone differs from Kmeans.train's "
                            f"by {loop_rel:.3e} relative")
    # one iteration's update, both ways, at the trained centroids
    cn = c.square().sum(1)
    assign = torch.cat([(cn[None] - 2.0 * (xd[s : s + chunk].float() @ c.T)).argmin(1)
                        for s in range(0, len(xd), chunk)])
    upd, err = update_ms(xd, assign, ROW12_K, chunk)
    del xd, assign
    torch.cuda.empty_cache()
    print(f"H. upload {t_up:.2f} s ({x.nbytes / 1e9 / t_up:.2f} GB/s); the "
          f"{ROW12_NITER}-iteration loop alone {t_loop:.3f} s by CUDA events "
          f"({t_loop / ROW12_NITER * 1e3:.1f} ms an iteration, chunks of {chunk} "
          f"rows; its objectives within {loop_rel:.1e} relative of the "
          f"train's); one iteration's centroid sums: index_add_ "
          f"{upd['index_add_']:.2f} ms (largest error against the exact sums "
          f"{err['index_add_']:.2e} of the largest sum), one-hot product "
          f"{upd['one-hot']:.2f} ms ({err['one-hot']:.2e}); the loop uses "
          f"index_add_ ({CARD}). BASELINE row 12 "
          "beside it: Titan X (2015), 140.6 s, published (not a number of this "
          "card)", flush=True)

    # assignments and the objective against float64 on a seeded sample
    sample = np.sort(np.random.RandomState(12).choice(len(x), ROW12_SAMPLE,
                                                      replace=False))
    xs = x[sample]
    Dk, Ik = no_kernel(fused_knn, f"H. Kmeans.assign of {ROW12_SAMPLE} rows "
                       "(256 centroids: the plain k-NN)", lambda: km.assign(xs))
    c64 = torch.from_numpy(km.centroids).to(dev, torch.float64)
    d64 = torch.cat([
        torch.cdist(torch.from_numpy(xs[s : s + 8192]).to(dev, torch.float64),
                    c64).square() for s in range(0, ROW12_SAMPLE, 8192)])
    two = torch.topk(d64, 2, largest=False).values.cpu().numpy()
    best = d64.argmin(1).cpu().numpy()
    # a near tie: the best two within 1e-5 (|x|^2 + max |c|^2), the scale of
    # the float32 norm expansion's error (the tolerance of the flat checks)
    scale = (xs.astype(np.float64) ** 2).sum(1) + float(c64.square().sum(1).max())
    near_tie = two[:, 1] - two[:, 0] <= 1e-5 * scale
    wrong = (Ik != best) & ~near_tie
    check(not wrong.any(), f"H. Kmeans.assign differs from float64 argmin on "
                           f"{int(wrong.sum())} rows that are no near tie")
    share, ref = float(Dk.astype(np.float64).sum()), float(two[:, 0].sum())
    check(abs(share - ref) <= 1e-4 * ref,
          f"H. the sample's objective {share:.9e} vs float64 {ref:.9e}")
    print(f"H. Kmeans.assign of a seeded {ROW12_SAMPLE}-row sample equals the "
          f"float64 argmin on {int((Ik == best).sum())} rows, the other "
          f"{int((Ik != best).sum())} within 1e-5 (|x|^2 + max |c|^2) of a tie "
          f"({int(near_tie.sum())} near ties); the sample's objective "
          f"{share:.9e} vs float64 {ref:.9e} (rel {abs(share - ref) / ref:.2e}); "
          f"per point {share / ROW12_SAMPLE:.6e} beside the last iteration's "
          f"{objs[-1] / len(x):.6e}", flush=True)


def exact_in_lists(index, xq, Dp, Ip, k, what):
    """EXACT_ROWS rows of a search by probe against float64 over the decoded
    rows of the row's probed lists: distances per rank within
    1e-5 * (|q|^2 + max |y|^2), ids tie-aware. Returns the largest error."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    rows = index.decode_vectors(index._codes_host, index._listnos_host)
    ymax = float((rows.astype(np.float64) ** 2).sum(1).max())
    q = torch.from_numpy(xq[:EXACT_ROWS]).to(index.device)
    probes = index._coarse_search(q, index.nprobe)[1].cpu().numpy()
    err = 0.0
    for r in range(EXACT_ROWS):
        mask = np.isin(index._listnos_host, probes[r])
        d = ((xq[r].astype(np.float64) - rows[mask].astype(np.float64)) ** 2).sum(1)
        o = np.argsort(d, kind="stable")[:k]
        tol = 1e-5 * (float((xq[r].astype(np.float64) ** 2).sum()) + ymax)
        e = np.abs(Dp[r, : len(o)] - d[o])
        check((e <= tol).all() and ids_agree_tie_aware(
            d[o][None], index._ids_host[mask][o][None], Dp[r : r + 1, : len(o)],
            Ip[r : r + 1, : len(o)], np.array([tol])).all(),
            f"{what}: row {r} differs from float64 over its probed lists")
        err = max(err, float(e.max()))
    return err


def sq_phases(ft, fused_knn, xb, xt, xq, gt, dev):
    """Phase I: the scalar-quantizer family on the 1M x 128 set, each index
    built by index_factory on the card: SQ8, SQ4 and SQfp16 at k = 10 (the
    flat screen, K2), SQ8 with flat_screen off at k = 100 (K3), IVF4096,SQ8
    at nprobe 16 (by probe, no kernel) with a write_index/read_index round
    trip, and SuperKMeans into 4096 centroids on the 200k training rows
    against Clustering. Returns the launches of K2 and of K3 (k_lanes
    128)."""
    import tempfile

    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware, recall_at_k

    k2 = k3 = 0
    for desc in ("SQ8", "SQ4", "SQfp16"):
        torch.cuda.synchronize()
        t0 = time.time()
        index = ft.index_factory(D, desc)
        index.train(xt)
        index.add(xb)
        index._screen_dev()
        torch.cuda.synchronize()
        t_build = time.time() - t0
        check(type(index).__name__ == "IndexScalarQuantizer" and index.device == dev,
              f"I. {desc}: {class_tree(index)}")
        Dp, Ip, n = flat_search(fused_knn, f"I. {desc} k={K}",
                                lambda: index.search(xq, K),
                                fused_knn.ivf_recon_fused, NQ, K)
        k2 += n
        exact = Exact(index.vectors(), dev)
        err = exact.check(xq, Dp, Ip, K, True, f"I. {desc}", ids_agree_tie_aware)
        med, _ = host_median(lambda: index.search(xq, K))
        print(f"I. {desc} ({index.sq.code_size} B codes a row): build "
              f"{t_build:.2f} s; search of {NQ} queries at k={K} (flat screen, K2 "
              f"x{n}): median {med * 1e3:.1f} ms over 5 -> {NQ / med:.0f} QPS; "
              f"recall@10 {recall_at_k(Ip, gt, K):.4f} against the float32 set; "
              f"{EXACT_ROWS} rows exact to the decoded rows (max err {err:.3e}) "
              f"({CARD})", flush=True)
        if desc == "SQ8":
            index.flat_screen = False
            nq = min(1024, NQ)
            Dp, Ip, n = flat_search(fused_knn, "I. SQ8 flat_screen=False k=100",
                                    lambda: index.search(xq[:nq], 100),
                                    fused_knn.knn_fused, nq, 100)
            k3 += n
            err = exact.check(xq, Dp, Ip, 100, True, "I. SQ8 k=100 (K3)",
                              ids_agree_tie_aware)
            med, _ = host_median(lambda: index.search(xq[:nq], 100))
            print(f"I. SQ8 with flat_screen=False: {nq} queries at k=100 (K3 x{n}): "
                  f"median {med * 1e3:.1f} ms over 5 -> {nq / med:.0f} QPS; "
                  f"{EXACT_ROWS} rows exact (max err {err:.3e}) ({CARD})", flush=True)
        del index, exact
        torch.cuda.empty_cache()

    desc = f"IVF{NLIST},SQ8"
    torch.cuda.synchronize()
    t0 = time.time()
    index = ft.index_factory(D, desc)
    index.train(xt)
    index.add(xb)
    index._build_device()
    torch.cuda.synchronize()
    t_build = time.time() - t0
    index.nprobe = 16
    Dp, Ip = no_kernel(fused_knn, f"I. {desc} nprobe 16 (by probe)",
                       lambda: index.search(xq, K))
    err = exact_in_lists(index, xq, Dp, Ip, K, f"I. {desc}")
    med, _ = host_median(lambda: index.search(xq, K))
    print(f"I. {desc}: build {t_build:.2f} s ({index.cp.niter} k-means "
          f"iterations); search of {NQ} queries at nprobe 16, k={K} by probe: "
          f"median {med * 1e3:.1f} ms over 5 -> {NQ / med:.0f} QPS; recall@10 "
          f"{recall_at_k(Ip, gt, K):.4f}; {EXACT_ROWS} rows exact over their "
          f"probed lists' decoded rows (max err {err:.3e}) ({CARD})", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        fname = str(Path(tmp) / "ivf_sq8.npz")
        ft.write_index(index, fname)
        back = ft.read_index(fname)
    check(type(back) is type(index) and back.nprobe == 16 and back.device == dev
          and np.array_equal(back._codes_host, index._codes_host)
          and np.array_equal(back.sq.trained, index.sq.trained),
          f"I. {desc} read back differs")
    Db, Ib = back.search(xq, K)
    check(np.array_equal(Db, Dp) and np.array_equal(Ib, Ip),
          f"I. the read {desc} searches differently")
    print(f"I. {desc} write_index/read_index onto the card: codes and ranges "
          "bitwise equal, the search equal on every row", flush=True)
    del index, back
    torch.cuda.empty_cache()

    skm = ft.SuperKMeans(D, NLIST, ft.SuperKMeansParameters(niter=NITER))
    clus = ft.Clustering(D, NLIST, ft.ClusteringParameters(niter=NITER))
    took = []
    for c in (skm, clus):
        torch.cuda.synchronize()
        t0 = time.time()
        c.train(xt)
        torch.cuda.synchronize()
        took.append(time.time() - t0)
    o_s, o_e = skm.iteration_stats[-1].obj, clus.iteration_stats[-1].obj
    check(o_s <= 1.05 * o_e, f"I. SuperKMeans objective {o_s:.6e} above 1.05 x "
                             f"Clustering's {o_e:.6e}")
    print(f"I. SuperKMeans({D}, {NLIST}, niter={NITER}) on the {len(xt)} training "
          f"rows: {took[0]:.2f} s, objective {o_s:.6e}, pruned share per "
          f"iteration {', '.join(f'{f:.3f}' for f in skm.pruning_fractions)}; "
          f"Clustering: {took[1]:.2f} s, objective {o_e:.6e}; ratio "
          f"{o_s / o_e:.5f} ({CARD})", flush=True)
    return k2, k3


def adc64(luts, codes, keep=None):
    """float64 ADC [r, nb] on the card: the tables ``luts`` [r, M, ksub] (as
    given) summed at the codes [nb, M]; +inf where ``keep`` [r, nb] is
    False."""
    l64 = luts.double()
    out = torch.zeros(l64.shape[0], codes.shape[0], dtype=torch.float64,
                      device=luts.device)
    for m in range(l64.shape[1]):
        out += l64[:, m, :][:, codes[:, m].long()]
    return out if keep is None else torch.where(keep, out, float("inf"))


def adc_rows_check(what, Dp, Ip, ref64, tol, ids_of=None):
    """Rows of a search against a float64 scan ``ref64`` [r, n] (+inf = not
    a candidate): per rank distances within ``tol`` [r] of its top-k, each
    returned id at its own float64 value within ``tol``, ids tie-aware; -1
    exactly where the candidates run out. ``ids_of`` maps columns to ids.
    Returns the largest difference."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    r, k = ref64.shape[0], Dp.shape[1]
    vals, cols = torch.topk(ref64, min(k, ref64.shape[1]), dim=1, largest=False)
    vals, cols = vals.cpu().numpy(), cols.cpu().numpy()
    ids = cols if ids_of is None else ids_of[cols]
    ids = np.where(np.isfinite(vals), ids, -1)
    Dp, Ip = Dp[:r, : vals.shape[1]], Ip[:r, : vals.shape[1]]
    fin = np.isfinite(vals)
    check(np.array_equal(fin, Ip >= 0) and np.array_equal(fin, np.isfinite(Dp)),
          f"{what}: -1 ids where float64 has candidates, or the reverse")
    err = np.abs(np.where(fin, Dp, 0.0) - np.where(fin, vals, 0.0))
    check((err <= tol[:, None]).all(),
          f"{what}: distances differ from float64 by {err.max():.3e}")
    own = ref64.cpu().numpy() if ids_of is None else None
    if own is not None:
        mine = own[np.arange(r)[:, None], np.maximum(Ip, 0)]
        check((np.abs(np.where(fin, mine, 0.0) - np.where(fin, Dp, 0.0))
               <= tol[:, None]).all(),
              f"{what}: a returned id's float64 distance differs")
    big = 1e30
    agree = ids_agree_tie_aware(np.where(fin, vals, big), ids,
                                np.where(fin, Dp, big), Ip, tol)
    check(agree.all(), f"{what}: ids differ from float64 on "
                       f"{int((~agree).sum())} of {r} rows")
    return float(err.max())


def lut_tol(luts):
    """1e-5 of each row's sum over m of its largest table entry: the scale of
    a float32 ADC sum's error."""
    return 1e-5 * luts.abs().amax(dim=2).sum(1).double().cpu().numpy()


def hamming_rows_check(what, Dp, Ip, qcodes, codes, cand=None, k=K):
    """EXACT_ROWS rows of a Hamming search whose ids are row numbers of
    ``codes`` [n, nbytes] (a tensor on the card), against the count of
    numpy's unpackbits (a table of the bits set in each byte value) over
    the row's candidates (``cand``: every code, or one array of row numbers
    per row): distances per rank equal, each returned id a candidate at its
    own distance, ids tie-aware."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    dev = codes.device
    table = torch.from_numpy(np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                                           axis=1).sum(1).astype(np.int32)).to(dev)
    q = torch.from_numpy(np.ascontiguousarray(qcodes[:EXACT_ROWS])).to(dev)

    def count(r, rows):
        return table[(codes[rows] ^ q[r]).long()].sum(1).cpu().numpy()

    for r in range(EXACT_ROWS):
        ci = np.arange(len(codes)) if cand is None else cand[r]
        d = count(r, torch.from_numpy(ci).to(dev))
        o = np.argpartition(d, min(k, len(d) - 1))[:k] if len(d) > k else np.arange(len(d))
        o = o[np.argsort(d[o], kind="stable")]
        n = len(o)
        got = Ip[r, :n]
        check(np.array_equal(Dp[r, :n], d[o]) and (Ip[r, n:] == -1).all(),
              f"{what}: row {r} distances differ from numpy's count")
        check(np.isin(got, ci).all() and np.array_equal(
            count(r, torch.from_numpy(got).to(dev)), Dp[r, :n]),
            f"{what}: row {r} returns a non-candidate or an id at another distance")
        check(n == 0 or ids_agree_tie_aware(d[o][None], ci[o][None],
                                            Dp[r : r + 1, :n], Ip[r : r + 1, :n], 0).all(),
              f"{what}: row {r} ids differ from numpy's beyond ties")


def timed(what, fn, n, reps=3):
    """Host-clock median of ``reps`` calls of a search of n queries, printed
    with the card."""
    med, times = host_median(fn, reps)
    print(f"{what}: median {med * 1e3:.1f} ms over {reps} "
          f"({', '.join(f'{t * 1e3:.1f}' for t in times)}) -> {n / med:.0f} QPS "
          f"({CARD})", flush=True)
    return med


def j_recalls(I, gt, nq):
    from faiss_tpu_torch.utils.evaluation import recall_at_k

    return (f"recall@1 {recall_at_k(I, gt[:nq], 1):.4f}, "
            f"recall@10 {recall_at_k(I, gt[:nq], 10):.4f}")


def pq_hamming_phases(ft, fused_knn, state, xb, xt, xq, gt, dev):
    """Phase J: the PQ and Hamming family on the 1M x 128 set. Returns the
    K2 launches of IndexBinaryFromFloat's search."""
    from faiss_tpu_torch.ops import hamming as hops
    from faiss_tpu_torch.ops import pq_ops

    def recalls(I, nq):
        return j_recalls(I, gt, nq)

    xq64 = torch.from_numpy(xq[:EXACT_ROWS]).to(dev)

    # J1 / J2: PQ64 (BASELINE rows 1-3), trained once with the polysemous
    # permutation: the ADC of row 1 does not depend on the codewords' labels
    index = ft.index_factory(D, "PQ64")
    check(type(index).__name__ == "IndexPQ" and index.pq.nbits == 8
          and index.device == dev, f"J1. PQ64 built as {class_tree(index)}")
    index.do_polysemous_training = True
    pt = ft.PolysemousTraining()
    anneal = []
    optimize = pt.optimize_pq_for_hamming

    def timed_optimize(pq):
        t = time.time()
        optimize(pq)
        anneal.append(time.time() - t)

    pt.optimize_pq_for_hamming = timed_optimize
    index.polysemous_training = pt
    torch.cuda.synchronize()
    t0 = time.time()
    index.train(xt)
    t_train = time.time() - t0
    t0 = time.time()
    index.add(xb)
    torch.cuda.synchronize()
    t_add = time.time() - t0
    D1, I1 = no_kernel(fused_knn, "J1. PQ64 ADC", lambda: index.search(xq, K))
    med1 = timed(f"J1. PQ64 ADC search of {NQ} queries at k={K}",
                 lambda: index.search(xq, K), NQ)
    codes = index._codes
    luts = pq_ops.pq_distance_tables(xq64, index.pq._dev())
    err1 = adc_rows_check("J1. PQ64", D1, I1, adc64(luts, codes), lut_tol(luts))
    print(f"J1. PQ64 (IndexPQ(128, 64, 8)): train {t_train:.2f} s (k-means "
          f"{t_train - anneal[0]:.2f} s, polysemous annealing {anneal[0]:.2f} s on "
          f"the host), add {t_add:.2f} s; {recalls(I1, NQ)} (published on the real "
          f"SIFT1M: R@1 0.4474); {EXACT_ROWS} rows equal a float64 ADC brute force "
          f"(max err {err1:.3e}) ({CARD})", flush=True)
    nq_sdc = min(1024, NQ)
    index.search_type = index.ST_SDC
    Ds, Is = no_kernel(fused_knn, "J1. PQ64 SDC",
                       lambda: index.search(xq[:nq_sdc], K))
    med = timed(f"J1. PQ64 SDC search of {nq_sdc} queries", lambda: index.search(
        xq[:nq_sdc], K), nq_sdc)
    sdc = torch.from_numpy(index.pq.compute_sdc_table()).to(dev)
    qc = pq_ops.pq_encode(xq64, index.pq._dev())
    sl = sdc[torch.arange(64, device=dev)[None, :], qc]
    err = adc_rows_check("J1. PQ64 SDC", Ds, Is, adc64(sl, codes), lut_tol(sl))
    print(f"J1. PQ64 ST_SDC: {recalls(Is, nq_sdc)}; {EXACT_ROWS} rows equal a "
          f"float64 scan of the symmetric table (max err {err:.3e}) ({CARD})",
          flush=True)

    index.search_type = index.ST_polysemous
    qbits_all = hops.code_bits(pq_ops.pq_encode(torch.from_numpy(xq).to(dev),
                                                index.pq._dev()), 8)
    for ht in (512, 54, 30):
        index.polysemous_ht = ht
        Dh, Ih = no_kernel(fused_knn, f"J2. PQ64 polysemous ht={ht}",
                           lambda: index.search(xq, K))
        if ht == 512:
            check(np.array_equal(Dh, D1) and np.array_equal(Ih, I1),
                  "J2. polysemous ht=512 (the whole code) differs from J1's ADC")
            print("J2. PQ64 polysemous at ht=512: J1's results bit for bit",
                  flush=True)
            continue
        med = timed(f"J2. PQ64 polysemous ht={ht} search of {NQ} queries",
                    lambda: index.search(xq, K), NQ)
        dropped = 0
        for c0 in range(0, len(codes), 1 << 16):
            ham = hops.hamming_product(qbits_all, hops.code_bits(codes[c0 : c0 + (1 << 16)], 8))
            dropped += int((ham >= ht).sum())
        keep = hops.hamming_product(qbits_all[:EXACT_ROWS], hops.code_bits(codes, 8)) < ht
        err = adc_rows_check(f"J2. ht={ht}", Dh, Ih, adc64(luts, codes, keep),
                             lut_tol(luts))
        print(f"J2. PQ64 polysemous (BASELINE row {2 if ht == 54 else 3}) ht={ht}: "
              f"{recalls(Ih, NQ)} (published R@1 {0.4478 if ht == 54 else 0.1794}); "
              f"{dropped / (NQ * len(codes)):.6f} of the (query, code) pairs filtered; "
              f"{int((Ih >= 0).sum())} of {NQ * K} result slots filled; "
              f"search {med * 1e3:.1f} ms against ADC's {med1 * 1e3:.1f} ms; "
              f"{EXACT_ROWS} rows equal float64 over the codes that pass (max err "
              f"{err:.3e}) ({CARD})", flush=True)
    del index, codes, qbits_all
    torch.cuda.empty_cache()

    # J3, J4: PQ32x4fs (IndexPQFastScan, the bf16 one-hot product) and PQ16x12
    for desc, cls in (("PQ32x4fs", "IndexPQFastScan"), ("PQ16x12", "IndexPQ")):
        index = ft.index_factory(D, desc)
        check(type(index).__name__ == cls, f"J. {desc} built as {class_tree(index)}")
        torch.cuda.synchronize()
        t0 = time.time()
        index.train(xt)
        t_train = time.time() - t0
        index.add(xb)
        torch.cuda.synchronize()
        t_add = time.time() - t0 - t_train
        Dp, Ip = no_kernel(fused_knn, f"J. {desc}", lambda: index.search(xq, K))
        med = timed(f"J. {desc} search of {NQ} queries at k={K}",
                    lambda: index.search(xq, K), NQ)
        luts = pq_ops.pq_distance_tables(xq64, index.pq._dev())
        if index.pq.ksub <= 16:  # the scan's own bf16-rounded tables
            luts = luts.to(torch.bfloat16).float()
        err = adc_rows_check(f"J. {desc}", Dp, Ip, adc64(luts, index._codes),
                             lut_tol(luts))
        print(f"J{3 if cls == 'IndexPQFastScan' else 4}. {desc} "
              f"({index.pq.code_size} B codes, ksub {index.pq.ksub}, codes "
              f"{str(index._codes.dtype)[6:]} on the card): train {t_train:.2f} s, "
              f"add {t_add:.2f} s; {recalls(Ip, NQ)}; {EXACT_ROWS} rows equal float64 "
              f"of {'the bf16-rounded' if index.pq.ksub <= 16 else 'the float32'} "
              f"tables (max err {err:.3e}) ({CARD})", flush=True)
        del index
        torch.cuda.empty_cache()

    # J5: the IVF-PQ polysemous filter on phase 4's IVF4096,PQ32x4fs base
    j5_phase(ft, fused_knn, state, xb, xq, dev)
    return binary_phases(ft, fused_knn, xb, xt, xq, gt, dev)


def j5_phase(ft, fused_knn, state, xb, xq, dev):
    """J5: phase 4's IVF4096,PQ32x4fs coarse quantizer and PQ with the 1M
    vectors added, searched by probe with the polysemous filter."""
    from faiss_tpu_torch.convert import ivfpq_from_arrays
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    base = ivfpq_from_arrays(state["cent"], state["pq"],
                             np.zeros((0, M), np.uint8), [], [], device=dev)
    base.add(xb)
    base.nprobe, base.polysemous_ht = 16, 40
    nq = min(1024, NQ)
    Dp, Ip = no_kernel(fused_knn, f"J5. IVF{NLIST},PQ{M}x4fs polysemous_ht=40",
                       lambda: base.search(xq[:nq], K))
    med = timed(f"J5. IVF{NLIST},PQ{M}x4fs nprobe 16, polysemous_ht 40 (of "
                f"{M * NBITS} bits), {nq} queries by probe",
                lambda: base.search(xq[:nq], K), nq)
    q = torch.from_numpy(xq[:EXACT_ROWS]).to(dev)
    probes = base._coarse_search(q, base.nprobe)[1]
    qcodes = base._query_residual_codes(q, probes).cpu().numpy()
    probes = probes.cpu().numpy()
    codes, listnos = base._codes_host, base._listnos_host
    rows = base.decode_vectors(codes, listnos).astype(np.float64)
    ymax = float((rows**2).sum(1).max())
    pop = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)
    err, kept, seen = 0.0, 0, 0
    for r in range(EXACT_ROWS):
        cand = []
        for p in range(base.nprobe):
            sl = np.nonzero(listnos == probes[r, p])[0]
            ham = pop[codes[sl] ^ qcodes[r, p].astype(np.uint8)].sum(1)
            cand.append(sl[ham < base.polysemous_ht])
            seen += len(sl)
        cand = np.concatenate(cand)
        kept += len(cand)
        x64 = xq[r].astype(np.float64)
        d = ((x64 - rows[cand]) ** 2).sum(1)
        o = np.argsort(d, kind="stable")[:K]
        tol = 1e-5 * (float((x64**2).sum()) + ymax)
        n = len(o)
        e = np.abs(Dp[r, :n] - d[o])
        check((e <= tol).all() and (Ip[r, n:] == -1).all() and (n == 0 or ids_agree_tie_aware(
            d[o][None], base._ids_host[cand][o][None], Dp[r : r + 1, :n],
            Ip[r : r + 1, :n], np.array([tol])).all()),
            f"J5: row {r} differs from float64 over its probed lists' surviving slots")
        err = max(err, float(e.max()) if n else 0.0)
    print(f"J5. IVF{NLIST},PQ{M}x4fs polysemous_ht=40 at nprobe 16: "
          f"{1 - kept / seen:.4f} of the probed slots filtered on {EXACT_ROWS} rows; "
          f"{int((Ip >= 0).sum())} of {nq * K} result slots filled; {EXACT_ROWS} rows "
          f"equal float64 over the surviving slots (max err {err:.3e}); search "
          f"{med * 1e3:.1f} ms ({CARD})", flush=True)
    del base
    torch.cuda.empty_cache()


def binary_phases(ft, fused_knn, xb, xt, xq, gt, dev):
    """J6: IndexLSH(128, 256) over the 1M set, then its codes through
    IndexBinaryFlat (both Hamming routes), IndexBinaryFromFloat over
    IndexFlatL2(256) (K2), IndexBinaryIVF, IndexBinaryHash and
    IndexBinaryMultiHash. Returns the K2 launches."""
    from faiss_tpu_torch.ops import hamming as hops
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    def recalls(I, nq):
        return j_recalls(I, gt, nq)

    lsh = ft.IndexLSH(D, 256, rotate_data=True, train_thresholds=True)
    torch.cuda.synchronize()
    t0 = time.time()
    lsh.train(xt)
    lsh.add(xb)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    Dl, Il = no_kernel(fused_knn, "J6. IndexLSH", lambda: lsh.search(xq, K))
    timed(f"J6. IndexLSH(128, 256, rotate, thresholds) search of {NQ} queries",
          lambda: lsh.search(xq, K), NQ)
    codes, qcodes = lsh.codes_host, lsh.sa_encode(xq)
    codes_dev = lsh._codes
    check(Dl.dtype == np.float32, "J6. LSH distances are not float32")
    hamming_rows_check("J6. IndexLSH", Dl.astype(np.int64), Il, qcodes, codes_dev)
    print(f"J6. IndexLSH: build {t_build:.2f} s ({NB} x {codes.shape[1]} B codes); "
          f"{recalls(Il, NQ)}; {EXACT_ROWS} rows equal numpy's count ({CARD})",
          flush=True)

    bf = ft.IndexBinaryFlat(256)
    bf.add(codes)
    Db, Ib = no_kernel(fused_knn, "J6. IndexBinaryFlat", lambda: bf.search(qcodes, K))
    t_product = timed(f"J6. IndexBinaryFlat(256) (the int8 product route), {NQ} "
                      "queries", lambda: bf.search(qcodes, K), NQ)
    hamming_rows_check("J6. IndexBinaryFlat", Db, Ib, qcodes, codes_dev)
    qdev = torch.from_numpy(qcodes).to(dev)

    def swar():
        d, i = hops.hamming_knn(qdev, bf._xb, K, "swar")
        return d.cpu().numpy(), i.cpu().numpy()

    Dw, Iw = no_kernel(fused_knn, "J6. hamming_knn by SWAR", swar)
    t_swar = timed(f"J6. hamming_knn over the same codes by the SWAR route, {NQ} "
                   "queries", swar, NQ)
    check(np.array_equal(Db, Dw) and ids_agree_tie_aware(Db, Ib, Dw, Iw, 0).all(),
          "J6. the product and SWAR routes differ beyond ties")
    print(f"J6. the int8 product route {t_product * 1e3:.1f} ms, SWAR "
          f"{t_swar * 1e3:.1f} ms ({t_swar / t_product:.1f}x), equal distances "
          f"({CARD})", flush=True)

    ff = ft.IndexBinaryFromFloat(ft.IndexFlatL2(256, device=dev))
    ff.add(codes)
    Df, If, n_k2 = flat_search(fused_knn, "J6. IndexBinaryFromFloat(IndexFlatL2(256))",
                               lambda: ff.search(qcodes, K), fused_knn.ivf_recon_fused,
                               NQ, K)
    check(np.array_equal(Df, Db) and ids_agree_tie_aware(Db, Ib, Df, If, 0).all(),
          "J6. IndexBinaryFromFloat differs from IndexBinaryFlat")
    timed(f"J6. IndexBinaryFromFloat(IndexFlatL2(256)) (K2 x{n_k2}), {NQ} queries",
          lambda: ff.search(qcodes, K), NQ)
    del ff
    torch.cuda.empty_cache()

    ivf = ft.IndexBinaryIVF(ft.IndexBinaryFlat(256), 256, 1024)
    torch.cuda.synchronize()
    t0 = time.time()
    ivf.train(lsh.sa_encode(xt))
    ivf.add(codes)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    ivf.nprobe = 16
    Di, Ii = no_kernel(fused_knn, "J6. IndexBinaryIVF", lambda: ivf.search(qcodes, K))
    timed(f"J6. IndexBinaryIVF(256, 1024) nprobe 16, {NQ} queries",
          lambda: ivf.search(qcodes, K), NQ)
    probes = ivf.quantizer.search(qcodes[:EXACT_ROWS], ivf.nprobe)[1]
    cand = [np.nonzero(np.isin(ivf._listnos, probes[r]))[0] for r in range(EXACT_ROWS)]
    hamming_rows_check("J6. IndexBinaryIVF", Di, Ii, qcodes, codes_dev, cand)
    sizes = np.bincount(ivf._listnos, minlength=1024)
    print(f"J6. IndexBinaryIVF: build {t_build:.2f} s (lists {sizes.min()}-"
          f"{sizes.max()} codes); {recalls(Ii, NQ)}; {EXACT_ROWS} rows equal numpy "
          f"over their probed lists ({CARD})", flush=True)
    del ivf

    nq = min(1024, NQ)
    for desc, index in (("IndexBinaryHash(256, 16), nflip 1", ft.IndexBinaryHash(256, 16)),
                        ("IndexBinaryMultiHash(256, 4, 16)",
                         ft.IndexBinaryMultiHash(256, 4, 16))):
        index.nflip = 1 if "nflip" in desc else 0
        t0 = time.time()
        index.add(codes)
        index._tables()
        t_build = time.time() - t0
        Dh, Ih = no_kernel(fused_knn, f"J6. {desc}", lambda: index.search(qcodes[:nq], K))
        timed(f"J6. {desc}, {nq} queries (host buckets)",
              lambda: index.search(qcodes[:nq], K), nq)
        cand = [index._candidates(qcodes[r]) for r in range(EXACT_ROWS)]
        hamming_rows_check(f"J6. {desc}", Dh, Ih, qcodes, codes_dev, cand)
        print(f"J6. {desc}: buckets {t_build:.2f} s; {recalls(Ih, nq)}; "
              f"{np.mean([len(c) for c in cand]):.0f} candidates per query on "
              f"{EXACT_ROWS} rows, which equal numpy over their buckets ({CARD})",
              flush=True)
    return n_k2


# Phase K: the graph indexes and the coarse quantizers other than flat
GRAPH_KEY = "IVF4096_HNSW32,PQ32x4fs,RFlat"
HNSW_M, HNSW_EFC, HNSW_EFS = 32, 40, (16, 32, 64, 128, 256)
# K-b's rows: the prefix of the 1M set each graph is built over, cut so
# that phase K stays near 150 s (hnsw_add is sequential: a 100k HNSW32
# build took 20-28 s on the chip host; NN-descent pulls every 2-hop pair
# of each node), and the prefix of K-b's two NSG32 builds whose graphs
# must be byte-identical (one of them on one thread)
HNSW_NB, HNSW_CODEC_NB, NSG_NB, NSG_DET_NB = 50_000, 25_000, 10_000, 3_000
BIN_NB = 10_000  # K-d's rows
# the coarse graph's efSearch while the 1M rows are assigned (faiss_tpu's
# default 16 puts ~1% of the rows in a farther list)
ASSIGN_EF = 32
# BASELINE row 4's IMI2x12,PQ16, its 2^24 cells cut to 2^20 for 10M rows
IMI_NBITS = 10
IMI_KEY = f"IMI2x{IMI_NBITS},PQ16"
IMI_NPROBE, IMI_MAX_CODES, IMI_HT = 16, 10_000, 47


def gt64_prefix(xb_d, xq, k, dev):
    """float64 exact k-NN ids of ``xq`` over the device rows ``xb_d``."""
    yn = xb_d.double().square().sum(1)
    out = []
    for q0 in range(0, len(xq), 1024):
        q = torch.from_numpy(xq[q0 : q0 + 1024]).to(dev).double()
        d2 = q.square().sum(1)[:, None] + yn[None, :] - 2.0 * (q @ xb_d.double().T)
        out.append(torch.topk(d2, k, dim=1, largest=False)[1].cpu().numpy())
    return np.concatenate(out)


def recall_1_10(I, gt):
    r1 = float((I[:, 0] == gt[:, 0]).mean())
    r10 = float(np.mean([len(set(a[:10]) & set(b[:10])) / 10 for a, b in zip(I, gt)]))
    return r1, r10


def graph_ivf_phase(ft, fused_knn, xb, xt, xq, gt, dev):
    """K-a: IVF4096_HNSW32,PQ32x4fs,RFlat by index_factory on the card, its
    coarse quantizer an HNSW graph over the 4096 centroids (host), searched
    at the main path's point (K1; the big batches take exact coarse
    distances over the graph's rows, as faiss_tpu does), unrefined (K4) and
    strict (K2 masked or K1 penalized); 64 queries by probe through the
    graph. Returns the launches of each kernel on K-a's paths, by the name
    of its entry in the kernels line."""
    from faiss_tpu_torch.utils.evaluation import recall_at_k

    index = ft.index_factory(D, GRAPH_KEY)
    base = index.base_index
    q = base.quantizer
    check(type(q).__name__ == "IndexHNSWFlat" and q.hnsw.M == HNSW_M
          and base.device == dev, f"K-a. {class_tree(index)}")
    base.cp.niter = NITER
    base.nprobe, base.strict_probe, base.pipeline_batch = NPROBE, False, BATCH
    index.k_factor = K_FACTOR
    # the graph's build over the centroids, timed inside train()
    graph_s = []
    add_graph = q.add

    def timed_add(x):
        t0 = time.time()
        add_graph(x)
        graph_s.append(time.time() - t0)

    q.add = timed_add
    torch.cuda.synchronize()
    t0 = time.time()
    index.train(xt)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    del q.add
    check(len(graph_s) == 1 and q.ntotal == NLIST, "K-a. the graph was not "
          "built over the centroids")
    t_graph = graph_s[0]
    q.hnsw.efSearch = ASSIGN_EF
    t0 = time.time()
    index.add(xb)
    torch.cuda.synchronize()
    t_add = time.time() - t0
    br = base._build_brute()
    index.refine_index._consolidate()
    torch.cuda.synchronize()
    print(f"K-a. index_factory({D}, {GRAPH_KEY!r}): {class_tree(index)}; train "
          f"{t_train:.2f} s (k-means {NITER} it., the graph, PQ); HNSW{HNSW_M} "
          f"build over {q.ntotal} centroids {t_graph * 1e3:.1f} ms; add {t_add:.2f} s ({NB} rows assigned through the "
          f"graph, efSearch {q.hnsw.efSearch}) ({CARD})", flush=True)

    reset_counts(fused_knn)
    Dm, Im = index.search(xq, K)
    torch.cuda.synchronize()
    k1 = fused_knn.ivf_recon_fused_dyn.launches
    check(k1 > 0 and total_launches(fused_knn) == k1,
          f"K-a. the main point launched K1 x{k1}, all kernels "
          f"x{total_launches(fused_knn)}")
    check(Dm.shape == Im.shape == (NQ, K) and np.isfinite(Dm).all()
          and (Im >= 0).all() and (Im < NB).all(), "K-a. invalid results")
    recall = recall_at_k(Im, gt, K)
    check(recall >= RECALL_MIN, f"K-a. recall@10 {recall:.4f} < {RECALL_MIN}")
    d_chk = ((xq[:256, None, :].astype(np.float64) - xb[Im[:256]]) ** 2).sum(-1)
    check(np.allclose(Dm[:256], d_chk, rtol=1e-4, atol=1e-4),
          "K-a. distances are not the exact L2 to the store")
    t_search, times = host_median(lambda: index.search(xq, K))
    print(f"K-a. {NQ} queries at nprobe={NPROBE} soft, k_factor={K_FACTOR}, "
          f"batches of {BATCH}: K1 x{k1}, no other kernel; recall@10 "
          f"{recall:.4f}; median {t_search * 1e3:.1f} ms per {NQ} queries "
          f"({', '.join(f'{t * 1e3:.1f}' for t in times)}) -> "
          f"{NQ / t_search:.0f} QPS ({CARD})", flush=True)

    # unrefined (K4) and strict refined (K2 masked) on the same index
    reset_counts(fused_knn)
    Du, Iu = base.search(xq, K)
    torch.cuda.synchronize()
    k4 = fused_knn.ivfpq_fused.launches
    check(k4 > 0, "K-a. the unrefined search launched K4 no time")
    base.strict_probe = True
    reset_counts(fused_knn)
    Ds, Is = index.search(xq, K)
    torch.cuda.synchronize()
    k2m = fused_knn.ivf_recon_fused.masked_launches
    k1p = fused_knn.ivf_recon_fused_dyn.penalized_launches
    check(k2m + k1p > 0, "K-a. the strict search launched neither K2 masked "
                         "nor K1 penalized")
    base.strict_probe = False
    print(f"K-a. unrefined: K4 x{k4}, recall@10 {recall_at_k(Iu, gt, K):.4f}; "
          f"strict: K2 masked x{k2m}, K1 penalized x{k1p}, recall@10 "
          f"{recall_at_k(Is, gt, K):.4f}", flush=True)

    # 64 queries by probe: the graph's coarse search, the ADC scan (the
    # first call stages the per-probe CSR)
    reset_counts(fused_knn)
    t0 = time.time()
    base.search(xq[:EXACT_ROWS], K)
    t_stage = time.time() - t0
    t_probe, _ = host_median(lambda: base.search(xq[:EXACT_ROWS], K))
    Dp, Ip = base.search(xq[:EXACT_ROWS], K)
    Dr, Ir = index.search(xq[:EXACT_ROWS], K)
    check(total_launches(fused_knn) == 0, "K-a. the search by probe launched a kernel")
    err = exact_in_lists(base, xq, Dp, Ip, K, "K-a. 64 queries by probe")
    probes = base._coarse_search(torch.from_numpy(xq[:EXACT_ROWS]).to(dev),
                                 base.nprobe)[1].cpu().numpy()
    slot_of = np.argsort(base._ids_host)
    lists = base._listnos_host[slot_of[Ir]]
    check((lists == probes[:, :1]).all(), "K-a. refined rows by probe leave the "
                                          "probed list")
    d_r = ((xq[:EXACT_ROWS, None, :].astype(np.float64) - xb[Ir]) ** 2).sum(-1)
    check(np.allclose(Dr, d_r, rtol=1e-4, atol=1e-4),
          "K-a. refined distances by probe are not exact")
    print(f"K-a. {EXACT_ROWS} queries by probe through the graph (no kernel): "
          f"median {t_probe * 1e3:.1f} ms (first call, staging the per-probe "
          f"layout, {t_stage * 1e3:.1f} ms); ADC = float64 over the probed "
          f"lists (max err {err:.3e}); refined ids in the probed list, exact "
          f"distances ({CARD})", flush=True)
    del index, base, br
    torch.cuda.empty_cache()
    return {"ivf_recon_fused_dyn": k1, "ivfpq_fused": k4,
            "ivf_recon_fused[masked]": k2m, "ivf_recon_fused_dyn[penalized]": k1p}


def hnsw_phases(ft, xb, xt, xq, dev):
    """K-b: faiss's bench_hnsw.py configuration, IndexHNSWFlat(128, M=32),
    efConstruction 40, efSearch 16-256; HNSW32,SQ8 and HNSW32,PQ16 (their
    codecs trained on the card), NSG32 and NNDescent32, each over a prefix
    of the 1M set, recall against float64 over the rows built; NSG32 built
    twice, in a process with OMP_NUM_THREADS=1 and here, byte-identical."""
    import hashlib
    import tempfile

    nq = 2048
    xq = xq[:nq]
    xb_d = torch.from_numpy(xb[:HNSW_NB]).to(dev)
    gt = gt64_prefix(xb_d, xq, K, dev)
    del xb_d
    index = ft.IndexHNSWFlat(D, HNSW_M)
    index.hnsw.efConstruction = HNSW_EFC
    t0 = time.time()
    index.add(xb[:HNSW_NB])
    t_build = time.time() - t0
    row = []
    for ef in HNSW_EFS:
        index.hnsw.efSearch = ef
        t0 = time.time()
        _, I = index.search(xq, K)
        dt = time.time() - t0
        r1, r10 = recall_1_10(I, gt)
        row.append(f"ef {ef}: R@1 {r1:.4f} R@10 {r10:.4f} "
                   f"{dt / nq * 1e3:.4f} ms/q")
    check(r10 >= 0.9, f"K-b. HNSW32 recall@10 {r10:.4f} at efSearch 256")
    print(f"K-b. IndexHNSWFlat({D}, M={HNSW_M}), efConstruction {HNSW_EFC}, "
          f"over {HNSW_NB} rows: build {t_build:.1f} s "
          f"({HNSW_NB / t_build:.0f} rows/s); {nq} queries: "
          + "; ".join(row) + f" ({CARD})", flush=True)
    del index

    xb_d = torch.from_numpy(xb[:HNSW_CODEC_NB]).to(dev)
    gt_c = gt64_prefix(xb_d, xq, K, dev)
    del xb_d
    for key in ("HNSW32,SQ8", "HNSW32,PQ16"):
        idx = ft.index_factory(D, key)
        check(idx.storage.device == dev, f"K-b. {key}: storage not on the card")
        t0 = time.time()
        idx.train(xt)
        torch.cuda.synchronize()
        t_train = time.time() - t0
        t0 = time.time()
        idx.add(xb[:HNSW_CODEC_NB])
        t_build = time.time() - t0
        idx.hnsw.efSearch = 64
        _, I = idx.search(xq, K)
        r1, r10 = recall_1_10(I, gt_c)
        check(r10 >= 0.8, f"K-b. {key} recall@10 {r10:.4f}")
        print(f"K-b. {key}: storage trained {t_train:.2f} s, build "
              f"over {HNSW_CODEC_NB} rows {t_build:.1f} s; efSearch 64: R@1 {r1:.4f} "
              f"R@10 {r10:.4f} ({CARD})", flush=True)
        del idx

    xb_d = torch.from_numpy(xb[:NSG_NB]).to(dev)
    gt_n = gt64_prefix(xb_d, xq, K, dev)
    del xb_d
    for key in ("NSG32", "NNDescent32"):
        idx = ft.index_factory(D, key)
        t0 = time.time()
        idx.add(xb[:NSG_NB])
        t_build = time.time() - t0
        row = []
        for L in (16, 64):
            idx.search_L = L
            _, I = idx.search(xq, K)
            r1, r10 = recall_1_10(I, gt_n)
            row.append(f"search_L {L}: R@1 {r1:.4f} R@10 {r10:.4f}")
        check(r10 >= 0.8, f"K-b. {key} recall@10 {r10:.4f} at search_L 64")
        print(f"K-b. {key} over {NSG_NB} rows: build {t_build:.1f} s; "
              + "; ".join(row) + f" ({CARD})", flush=True)
        del idx

    # NSG32's graph, built with one OpenMP thread in a process of its own
    # and with every thread here, byte for byte
    def digest(state):
        h = hashlib.sha256(state["graph"].tobytes())
        h.update(str(state["enterpoint"]).encode())
        return h.hexdigest()

    with tempfile.TemporaryDirectory() as tmp:
        np.save(f"{tmp}/x.npy", xb[:NSG_DET_NB])
        code = ("import hashlib, sys, numpy as np\n"
                f"sys.path.insert(0, {str(ROOT)!r})\n"
                "import faiss_tpu_torch as ft\n"
                "x = np.load(sys.argv[1])\n"
                "idx = ft.IndexNSGFlat(x.shape[1], 32, device='cpu')\n"
                "idx.add(x)\n"
                "s = idx.graph_state()\n"
                "h = hashlib.sha256(s['graph'].tobytes())\n"
                "h.update(str(s['enterpoint']).encode())\n"
                "print(h.hexdigest())\n")
        env = dict(__import__("os").environ, OMP_NUM_THREADS="1")
        t0 = time.time()
        out = subprocess.run([sys.executable, "-c", code, f"{tmp}/x.npy"],
                             env=env, capture_output=True, text=True, timeout=600)
        t_one = time.time() - t0
    check(out.returncode == 0, f"K-b. the one-thread NSG build failed: {out.stderr}")
    idx = ft.IndexNSGFlat(D, 32)
    t0 = time.time()
    idx.add(xb[:NSG_DET_NB])
    t_all = time.time() - t0
    one, here = out.stdout.strip(), digest(idx.graph_state())
    check(one == here, f"K-b. NSG32 graphs differ: one thread {one}, all {here}")
    print(f"K-b. NSG32 over {NSG_DET_NB} rows, OMP_NUM_THREADS=1 (its process, "
          f"{t_one:.1f} s) and every thread ({t_all:.1f} s): byte-identical "
          f"graphs (sha256 {here[:16]}) ({CARD})", flush=True)


def binary_hnsw_phase(ft, xb, xt, xq, dev):
    """K-d: IndexBinaryHNSW(256, 16) over the 1M set binarised as phase J6
    does (IndexLSH(128, 256) codes), on a prefix; 64 rows of distances
    against numpy's bit counts; recall@10 against an exact Hamming search
    (IndexBinaryFlat on the card)."""
    lsh = ft.IndexLSH(D, 256, rotate_data=True, train_thresholds=True)
    lsh.train(xt)
    codes, qcodes = lsh.sa_encode(xb[:BIN_NB]), lsh.sa_encode(xq[:2048])
    index = ft.IndexBinaryHNSW(256, 16)
    t0 = time.time()
    index.add(codes)
    t_build = time.time() - t0
    index.hnsw.efSearch = 64
    t0 = time.time()
    Dh, Ih = index.search(qcodes, K)
    t_search = time.time() - t0
    bits = np.unpackbits(qcodes[:EXACT_ROWS, None, :] ^ codes[Ih[:EXACT_ROWS]],
                         axis=-1).sum(-1)
    check(Dh.dtype == np.int32 and np.array_equal(Dh[:EXACT_ROWS], bits),
          "K-d. IndexBinaryHNSW distances differ from numpy's bit counts")
    flat = ft.IndexBinaryFlat(256)
    flat.add(codes)
    De, Ie = flat.search(qcodes, K)
    # recall against the exact Hamming search, ties counted by distance
    kth = De[:, K - 1]
    hit = np.mean([(Dh[r] <= kth[r]).sum() / K for r in range(len(qcodes))])
    check(hit >= 0.8, f"K-d. IndexBinaryHNSW recall@10 {hit:.4f}")
    print(f"K-d. IndexBinaryHNSW(256, 16) over {BIN_NB} LSH codes: build "
          f"{t_build:.1f} s; {len(qcodes)} queries at efSearch 64 "
          f"{t_search / len(qcodes) * 1e3:.4f} ms/q; recall@10 {hit:.4f} "
          f"(against IndexBinaryFlat, ties by distance); {EXACT_ROWS} rows = "
          f"numpy's bit counts ({CARD})", flush=True)


def graph_phases(ft, fused_knn, xb, xt, xq, gt, dev):
    """Phase K on the 1M x 128 set: K-a, K-b and K-d. Returns K-a's
    launches by kernel entry."""
    t0 = time.time()
    launches = graph_ivf_phase(ft, fused_knn, xb, xt, xq, gt, dev)
    torch.cuda.empty_cache()
    t_a = time.time() - t0
    t0 = time.time()
    hnsw_phases(ft, xb, xt, xq, dev)
    t_b = time.time() - t0
    t0 = time.time()
    binary_hnsw_phase(ft, xb, xt, xq, dev)
    print(f"K. K-a {t_a:.1f} s, K-b {t_b:.1f} s, K-d {time.time() - t0:.1f} s",
          flush=True)
    return launches


def imi_phase(ft, fused_knn, xb, xt, xq, gt, dev):
    """K-c: IMI2x10,PQ16 by index_factory over the Deep10M-like 10M x 96 set
    (BASELINE row 4's IMI2x12,PQ16 over SIFT1B, its 2^24 cells cut to 2^20
    for 10M rows): the IMI trains itself on the card, assigns on the card,
    and its 2^20 skewed lists are held as one CSR (the padded layout would
    not fit); the 8192 queries by probe at nprobe 16, max_codes 10,000,
    with the polysemous filter at ht 47 and without; 64 rows against
    float64 over the lists each probed."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    t0 = time.time()
    index = ft.index_factory(DEEP_D, IMI_KEY)
    q = index.quantizer
    check(type(q).__name__ == "MultiIndexQuantizer" and index.quantizer_trains_alone
          and index.nlist == 1 << (2 * IMI_NBITS), f"K-c. {class_tree(index)}")
    # row 4's codes are polysemous (benchs/bench_polysemous_1bn.py trains the
    # permutation), which the Hamming filter at ht 47 relies on
    index.do_polysemous_training = True
    torch.cuda.synchronize()
    index.train(xt)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    t0 = time.time()
    index.add(xb)
    torch.cuda.synchronize()
    t_add = time.time() - t0
    sizes = np.bincount(index._listnos_host, minlength=index.nlist)
    max_len = index._pad_to(int(sizes.max()))
    # what the padded layout would take: codes and a slot id per position
    padded = index.nlist * max_len * (index.pq.M + 4)
    t0 = time.time()
    dev_layout = index._build_device()
    t_stage = time.time() - t0
    check(type(dev_layout["lists"]).__name__ == "RaggedLists",
          "K-c. the lists were not held as one CSR")
    print(f"K-c. index_factory({DEEP_D}, {IMI_KEY!r}): {class_tree(index)}; "
          f"train {t_train:.1f} s (the IMI's 2 x {1 << IMI_NBITS} and the PQ16's codebooks "
          f"on the card, the polysemous permutation on the host), add {t_add:.1f} s; lists: {int((sizes > 0).sum())} of "
          f"{index.nlist} non-empty, longest {int(sizes.max())}, mean of the "
          f"non-empty {sizes[sizes > 0].mean():.1f}; the padded layout would "
          f"take {padded / 2**30:.1f} GiB at max_len {max_len}, the CSR "
          f"{(index._codes_host.nbytes + 4 * len(sizes) * 4 + 4 * index.ntotal) / 2**30:.2f} "
          f"GiB, staged in {t_stage:.1f} s ({CARD})", flush=True)
    index.nprobe, index.max_codes = IMI_NPROBE, IMI_MAX_CODES
    res = {}
    for ht in (IMI_HT, 0):
        index.polysemous_ht = ht
        reset_counts(fused_knn)
        t0 = time.time()
        Dq, Iq = index.search(xq, 100)
        torch.cuda.synchronize()
        dt = time.time() - t0
        check(total_launches(fused_knn) == 0, "K-c. the search by probe launched a kernel")
        found = float((Iq[:, 0] >= 0).mean())
        check(ht or found == 1.0, "K-c. a query found nothing without the filter")
        r = [float(np.mean([g in set(row[:n]) for g, row in zip(gt[:, 0], Iq)]))
             for n in (1, 10, 100)]
        res[ht] = (Dq, Iq)
        print(f"K-c. {len(xq)} queries, nprobe {IMI_NPROBE}, max_codes "
              f"{IMI_MAX_CODES}, ht {ht or 'off'}: {dt / len(xq) * 1e3:.4f} "
              f"ms/q; 1-R@1 {r[0]:.4f}, 1-R@10 {r[1]:.4f}, 1-R@100 {r[2]:.4f}; "
              f"{found:.4f} of the queries found a vector ({CARD})", flush=True)
        check(r[2] >= 0.3, f"K-c. 1-R@100 {r[2]:.4f} at ht {ht}")
    both = res[IMI_HT][1][:, 0] >= 0
    check((res[IMI_HT][0][both, 0] >= res[0][0][both, 0]).all(),
          "K-c. the filter found a nearer vector than the unfiltered scan")

    # 64 rows against float64 over the lists each probed (max_codes cut as
    # the search cuts them; the filter as the search filters)
    xr = torch.from_numpy(xq[:EXACT_ROWS]).to(dev)
    probes = index._coarse_search(xr, IMI_NPROBE)[1]
    cum = np.cumsum(sizes[probes.cpu().numpy()], 1)
    keep = np.concatenate([np.ones((EXACT_ROWS, 1), bool),
                           cum[:, :-1] < IMI_MAX_CODES], 1)
    qcodes = index._query_residual_codes(xr, probes).cpu().numpy()
    err, seen, kept = 0.0, 0, 0
    for ht in (IMI_HT, 0):
        Dq, Iq = res[ht]
        for r in range(EXACT_ROWS):
            pl = probes[r].cpu().numpy()[keep[r]]
            slots = np.nonzero(np.isin(index._listnos_host, pl))[0]
            ln = index._listnos_host[slots]
            codes = index._codes_host[slots]
            if ht:
                pos = np.searchsorted(pl, ln, sorter=np.argsort(pl))
                which = np.argsort(pl)[pos]
                qc = qcodes[r][keep[r]][which]
                ham = np.unpackbits((qc ^ codes).astype(np.uint8)[..., None],
                                    axis=-1).sum((-1, -2))
                seen, kept = seen + len(slots), kept + int((ham < ht).sum())
                slots, ln, codes = slots[ham < ht], ln[ham < ht], codes[ham < ht]
            if not len(slots):  # the filter left nothing
                check((Iq[r] == -1).all(), f"K-c. row {r} at ht {ht}: results "
                                           "where the filter leaves none")
                continue
            rows = index.decode_vectors(codes, ln).astype(np.float64)
            d = ((xq[r].astype(np.float64) - rows) ** 2).sum(1)
            o = np.argsort(d, kind="stable")[:K]
            tol = 1e-5 * (float((xq[r].astype(np.float64) ** 2).sum())
                          + float((rows**2).sum(1).max()))
            e = np.abs(Dq[r, : len(o)] - d[o])
            check((e <= tol).all() and ids_agree_tie_aware(
                d[o][None], index._ids_host[slots][o][None], Dq[r : r + 1, : len(o)],
                Iq[r : r + 1, : len(o)], np.array([tol])).all(),
                f"K-c. row {r} at ht {ht} differs from float64 over its probed lists")
            err = max(err, float(e.max()))
    print(f"K-c. {EXACT_ROWS} rows at ht {IMI_HT} and off = float64 over their "
          f"probed lists (max_codes cut, filter applied): max err {err:.3e}; "
          f"ht {IMI_HT} keeps {kept} of their {seen} probed slots "
          f"({kept / max(seen, 1):.4f})", flush=True)
    del index, dev_layout
    torch.cuda.empty_cache()


# -- phase L: the additive quantizers and RaBitQ ------------------------------

AQ_FLAT = ("RQ8x8_Nfloat", "LSQ8x8_Nfloat", "PRQ2x4x8_Nfloat", "PLSQ2x4x8_Nfloat",
           "RQ8x8_Nqint8", "RQ16x4fs")
AQ_IVF = ("IVF4096,RQ8x8", "IVF4096,RQ16x4fs")
RABITQ_FLAT = ("RaBitQ", "RaBitQfs", "RaBitQ4")
RABITQ_IVF = ("IVF4096,RaBitQ", "IVF4096,RaBitQfs", "IVF4096,RaBitQ4")
L_NPROBE, L_IVF_NQ = 16, 1024


def rows_vs64(what, D, I, d64, ids64, scale):
    """EXACT_ROWS rows of a search against float64 distances ``d64`` [r, n]
    (+inf where a row may not match) of candidates ``ids64`` [r, n]:
    distances per rank within 1e-5 * scale (per row), ids tie-aware.
    Returns the largest error."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    k = D.shape[1]
    v, pos = torch.topk(d64, min(k, d64.shape[1]), dim=1, largest=False)
    ref_i = torch.gather(ids64, 1, pos)
    v, ref_i = v.cpu().numpy(), ref_i.cpu().numpy()
    ref_i = np.where(np.isinf(v), -1, ref_i)
    tol = 1e-5 * scale
    r = len(v)
    Dp, Ip = D[:r, : v.shape[1]], I[:r, : v.shape[1]]
    fin = np.isfinite(v)
    err = np.zeros_like(v)
    err[fin] = np.abs(Dp[fin] - v[fin])
    check(((err <= tol[:, None]) & (np.isfinite(Dp) == fin)).all()
          and ids_agree_tie_aware(np.where(fin, v, 1e30), ref_i,
                                  np.where(fin, Dp, 1e30), Ip, tol).all(),
          f"{what}: differs from float64 (largest error {err.max():.3g})")
    return float(err.max())


def aq_rows_check(what, index, xq):
    """64 rows of a flat AQ search against float64 of the same tables plus
    the stored norms: |q|^2 + norm - 2 sum_m <q, c_m[code_m]> over every
    code. Returns the search's largest error."""
    dev = index.device
    q = torch.from_numpy(xq[:EXACT_ROWS]).to(dev).double()
    luts = torch.einsum("qd,mkd->qmk", q, index.aq._dev().double())
    codes = index._codes.long()
    ip = torch.zeros(len(q), len(codes), dtype=torch.float64, device=dev)
    for m in range(codes.shape[1]):
        ip += luts[:, m, :][:, codes[:, m]]
    qn = q.square().sum(1)
    d64 = (qn[:, None] + index._norms_dev.double()[None, :] - 2.0 * ip).clamp_min(0)
    D, I = index.search(xq[:EXACT_ROWS], K)
    ids = torch.arange(len(codes), device=dev).expand(len(q), -1)
    scale = (qn + index._norms_dev.double().max()).cpu().numpy()
    return rows_vs64(what, D, I, d64, ids, scale)


def recall_str(I, gt):
    r1, r10 = recall_1_10(I, gt[: len(I)])
    return f"recall@1 {r1:.4f}, recall@10 {r10:.4f}"


def timed_build(index, xt, xb):
    torch.cuda.synchronize()
    t0 = time.time()
    index.train(xt)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    index.add(xb)
    torch.cuda.synchronize()
    return t_train, time.time() - t0, torch.cuda.max_memory_allocated() / 2**30


def aq_flat_phase(ft, fused_knn, xb, xt, xq, gt, dev):
    """L-a: the 64-bit flat additive quantizers through index_factory on the
    card, trained on the 200k rows, the 1M rows encoded, 8192 queries at
    k = 10. Returns the RQ8x8 index for L-d."""
    errs = {}
    keep = None
    for desc in AQ_FLAT:
        index = ft.index_factory(D, desc)
        check(index.device == dev and index.aq.device == dev,
              f"L-a. {desc}: {class_tree(index)}")
        t_train, t_add, peak = timed_build(index, xt, xb)
        no_kernel(fused_knn, f"L-a. {desc} search", lambda: index.search(xq, K))
        med = timed(f"L-a. {desc}, 8192 q, k={K}", lambda: index.search(xq, K),
                    NQ, reps=2)
        _, I = index.search(xq, K)
        err = aq_rows_check(f"L-a. {desc}", index, xq)
        errs[desc] = mean_recon_err(index.aq, index._codes, xb)
        if desc == "LSQ8x8_Nfloat":  # its RQ init: beam search, same codebooks
            lsq = index.aq
            lsq._rq.codebooks = lsq.codebooks
            init = torch.cat([lsq._rq.compute_codes_dev(
                torch.from_numpy(xb[s : s + (1 << 18)]).to(dev))
                for s in range(0, len(xb), 1 << 18)])
            errs["init"] = mean_recon_err(lsq, init, xb)
        print(f"L-a. {desc} ({type(index).__name__}, search_type "
              f"{index.aq.search_type}): train {t_train:.2f} s, encode {t_add:.2f} s "
              f"for 1M rows (peak {peak:.2f} GiB), search {med * 1e3:.1f} ms, "
              f"{index.sa_code_size()} bytes a code, {recall_str(I, gt)}, "
              f"MSE {errs[desc]:.4f}, 64 rows vs float64 of the tables plus the "
              f"stored norms: largest error {err:.3g} ({CARD})", flush=True)
        if desc == "RQ8x8_Nfloat":
            keep = index
            aq_scan_split(index, xq)
        else:
            del index
        torch.cuda.empty_cache()
    init, lsq = errs["init"], errs["LSQ8x8_Nfloat"]
    check(lsq <= init * (1 + 1e-5),
          f"L-a. LSQ8x8's reconstruction error {lsq:.6f} above its RQ init's {init:.6f}")
    print(f"L-a. LSQ8x8 mean reconstruction error {lsq:.6f} vs its RQ init (beam "
          f"search over the same codebooks) {init:.6f}: {lsq / init:.4f}x; RQ8x8's "
          f"own codebooks {errs['RQ8x8_Nfloat']:.6f}", flush=True)
    return keep


def aq_scan_split(index, xq):
    """Where one chunk of the flat AQ scan goes (CUDA events): the float32
    table sums of 8192 queries over 65,536 codes, and the select over
    them."""
    from faiss_tpu_torch.ops import pq_ops

    luts = index.aq.lut_dev(torch.from_numpy(xq).to(index.device))
    cc = index._codes[: 1 << 16]
    s = pq_ops.adc_scores_gather(luts, cc)
    t_sum = cuda_ms(lambda: pq_ops.adc_scores_gather(luts, cc), 3)
    t_sel = cuda_ms(lambda: torch.topk(s, K, dim=1, largest=False), 3)
    print(f"L-a. RQ8x8, one chunk of {len(cc)} codes x {len(xq)} q: table sums "
          f"{t_sum:.2f} ms, select {t_sel:.2f} ms (the search takes "
          f"{-(-index.ntotal // len(cc))} chunks; {CARD})", flush=True)


def rabitq_scan_split(index, xq):
    """The same split for the flat 1-bit RaBitQ scan: one chunk's unpack and
    float32 product over 32,768 codes, and the select over its scores."""
    from faiss_tpu_torch.ops.ivf_ops import unpack_signs

    packed = index._device_state()[0][: 1 << 15]
    qr = torch.from_numpy(index.rabitq.rotate_queries(xq)[0]).to(index.device)
    s = qr @ unpack_signs(packed, index.d).T
    t_mm = cuda_ms(lambda: qr @ unpack_signs(packed, index.d).T, 3)
    t_sel = cuda_ms(lambda: torch.topk(s, K, dim=1, largest=False), 3)
    print(f"L-c. RaBitQ, one chunk of {len(packed)} codes x {len(xq)} q: unpack "
          f"and product {t_mm:.2f} ms, select {t_sel:.2f} ms (the search takes "
          f"{-(-index.ntotal // len(packed))} chunks; {CARD})", flush=True)


def mean_recon_err(aq, codes, xb):
    """Mean |decode(code) - x|^2 over the rows, in float64 sums."""
    tot, step = 0.0, 1 << 18
    for s in range(0, len(xb), step):
        x = torch.from_numpy(xb[s : s + step]).to(aq.device)
        tot += float((aq.decode_dev(codes[s : s + step]) - x).double().square().sum())
    return tot / len(xb)


def probed_slots(index, xq, nprobe):
    """(probes [r, nprobe], coarse distances) of EXACT_ROWS queries."""
    q = torch.from_numpy(xq[:EXACT_ROWS]).to(index.device)
    cd, pr = index._coarse_search(q, nprobe)
    return pr.cpu().numpy(), cd.cpu().numpy()


def in_lists64(index, probes, fn, sel=None):
    """float64 [r, ntotal] distances over each row's probed lists (+inf
    elsewhere and where ``sel`` [ntotal] clears a slot), with the slots' ids
    and each row's scale: fn(row, slots) gives (distances, the magnitude of
    their terms)."""
    n = index.ntotal
    out = np.full((len(probes), n), np.inf)
    scale = np.zeros(len(probes))
    for r in range(len(probes)):
        slots = np.nonzero(np.isin(index._listnos_host, probes[r]))[0]
        if sel is not None:
            slots = slots[sel[slots]]
        out[r, slots], mag = fn(r, slots)
        scale[r] = mag.max(initial=0.0)
    ids = torch.from_numpy(index._ids_host).to(index.device).expand(len(probes), -1)
    return torch.from_numpy(out).to(index.device), ids, scale


def aq_ivf_phase(ft, fused_knn, xb, xt, xq, gt, dev):
    """L-b: IVF4096,RQ8x8 and IVF4096,RQ16x4fs by index_factory, by probe
    at nprobe 16 on 1024 queries; 64 rows against float64 over the probed
    lists' decoded rows."""
    cent = None
    for desc in AQ_IVF:
        index = ft.index_factory(D, desc)
        index.cp.niter = NITER
        if cent is not None:  # the first index's coarse quantizer
            index.quantizer.add(cent)
        t_train, t_add, peak = timed_build(index, xt, xb)
        cent = index.quantizer.vectors()
        index.nprobe = L_NPROBE
        xs = xq[:L_IVF_NQ]
        Dp, Ip = no_kernel(fused_knn, f"L-b. {desc} search", lambda: index.search(xs, K))
        med = timed(f"L-b. {desc}, nprobe {L_NPROBE}, {L_IVF_NQ} q",
                    lambda: index.search(xs, K), L_IVF_NQ, reps=2)
        err = exact_in_lists(index, xs, Dp, Ip, K, f"L-b. {desc}")
        print(f"L-b. {desc}: train {t_train:.2f} s, add {t_add:.2f} s (peak "
              f"{peak:.2f} GiB), search {med * 1e3:.1f} ms, {recall_str(Ip, gt)}; "
              f"64 rows vs float64 over the probed decoded rows: largest error "
              f"{err:.3g} ({CARD})", flush=True)
        del index
        torch.cuda.empty_cache()
    return cent


def rabitq_flat64(index, xq):
    """float64 of the flat estimator on the same float32 inputs the search
    uses: 1-bit |q_r|^2 + |x_r|^2 - 2 |x_r| <q_r, o_bar> / f (q_r as the
    search rotates and quantizes it), multi-bit |q - c|^2 + f_add + f_rescale
    <P (q - c), u>, clamped at 0 as ops/distances.knn clamps; with the
    scale of its terms."""
    from faiss_tpu_torch.codecs.rabitq import quantize_query_sq
    from faiss_tpu_torch.ops.ivf_ops import unpack_signs

    dev, d = index.device, index.d
    fac = torch.from_numpy(index._factors).to(dev).double()
    if index.nb_bits > 1:
        rb = index.rabitq
        qc = torch.from_numpy(xq[:EXACT_ROWS] - rb.center).to(dev).double()
        qr = qc @ torch.from_numpy(rb.P.T.copy()).to(dev).double()
        u = torch.from_numpy(rb.u_values(index._bits)).to(dev).double()
        qn = qc.square().sum(1)
        d64 = qn[:, None] + fac[None, :, 0] + fac[None, :, 1] * (qr @ u.T)
        return d64.clamp_min(0), (qn + fac[:, 0].max()).cpu().numpy()
    qr, qn2 = index.rabitq.rotate_queries(xq[:EXACT_ROWS])
    qr = torch.from_numpy(quantize_query_sq(qr, index.qb, index.centered)).to(dev).double()
    qn = torch.from_numpy(qn2).to(dev).double()
    signs = unpack_signs(torch.from_numpy(index._bits).to(dev), d).double()
    est = fac[None, :, 0] * (qr @ signs.T) / np.sqrt(d) / fac[None, :, 1]
    d64 = qn[:, None] + fac[None, :, 0] ** 2 - 2.0 * est
    return d64, (qn + fac[:, 0].square().max() + 2.0 * est.abs().max(1)[0]).cpu().numpy()


def rabitq_ivf64(index, xq, probes, cdis, sel=None):
    """float64 of the IVF estimator over each row's probed lists on the
    search's inputs: 1-bit cd + |x_r|^2 - 2 |x_r| (<P q, o_bar> - g) / f
    with P q as the search rotates and quantizes it and cd the coarse
    distance; multi-bit |q - c|^2 + f_add + f_rescale <P (q - c), u>."""
    from faiss_tpu_torch.ops.ivf_ops import unpack_signs

    d = index.d
    q32 = torch.from_numpy(xq[:EXACT_ROWS]).to(index.device)
    codes = index._codes_host
    cents = index._centroids_host().astype(np.float64)
    P = index.rabitq.P.astype(np.float64)
    if index.nb_bits > 1:
        c, f = index.rabitq.unpack(codes)
        u = index.rabitq.u_values(c).astype(np.float64)
        f = f.astype(np.float64)
        q = xq[:EXACT_ROWS].astype(np.float64)

        def fn(r, slots):  # clamped at 0 as the norm expansion is
            qc = q[r][None, :] - cents[index._listnos_host[slots]]
            est = f[slots, 1] * ((qc @ P.T) * u[slots]).sum(1)
            dist = np.maximum((qc**2).sum(1) + f[slots, 0] + est, 0.0)
            return dist, (2.0 * ((q[r] ** 2).sum() + (cents**2).sum(1).max())
                          + f[slots, 0] + np.abs(est))
    else:
        nbytes = (d + 7) // 8
        qP = index._rotated_queries(q32).double().cpu().numpy()
        fac = np.ascontiguousarray(codes[:, nbytes:]).view(np.float32).astype(np.float64)
        signs = unpack_signs(torch.from_numpy(np.ascontiguousarray(codes[:, :nbytes])), d
                             ).double().numpy()
        cd_of = {}
        for r in range(len(probes)):
            cd_of[r] = dict(zip(probes[r], cdis[r].astype(np.float64)))

        def fn(r, slots):
            cd = np.array([cd_of[r][ln] for ln in index._listnos_host[slots]])
            ipq = (signs[slots] @ qP[r]) / np.sqrt(d)
            nr, fs, g = fac[slots, 0], fac[slots, 1], fac[slots, 2]
            est = nr * (ipq - g) / fs
            return cd + nr * nr - 2.0 * est, np.abs(cd) + nr * nr + 2.0 * np.abs(est)
    return in_lists64(index, probes, fn, sel)


def rabitq_phase(ft, fused_knn, xb, xt, xq, gt, dev, cent):
    """L-c: RaBitQ flat (1-bit, FastScan qb 8, 4-bit) over the 1M rows, the
    IVF forms at nprobe 16 and IVF4096,RaBitQ,RFlat, 8192 queries each; 64
    rows of each against float64 of the same estimator; an IDSelectorRange
    on the IVF 1-bit search. Returns IVF4096,RaBitQ for L-d."""
    for desc in RABITQ_FLAT:
        index = ft.index_factory(D, desc)
        check(index.device == dev, f"L-c. {desc}: {class_tree(index)}")
        t_train, t_add, peak = timed_build(index, xt, xb)
        no_kernel(fused_knn, f"L-c. {desc} search", lambda: index.search(xq, K))
        med = timed(f"L-c. {desc}, 8192 q, k={K}", lambda: index.search(xq, K), NQ, reps=2)
        D_, I_ = index.search(xq, K)
        d64, scale = rabitq_flat64(index, xq)
        ids = torch.arange(index.ntotal, device=dev).expand(EXACT_ROWS, -1)
        err = rows_vs64(f"L-c. {desc}", D_, I_, d64, ids, scale)
        print(f"L-c. {desc} (nb_bits {index.nb_bits}, qb {index.qb}): train "
              f"{t_train:.2f} s, encode {t_add:.2f} s (peak {peak:.2f} GiB), search "
              f"{med * 1e3:.1f} ms, {index.sa_code_size()} bytes a code, "
              f"{recall_str(I_, gt)}; 64 rows vs float64 of the estimator: largest "
              f"error {err:.3g} ({CARD})", flush=True)
        if desc == RABITQ_FLAT[0]:
            rabitq_scan_split(index, xq)
        del index, d64
        torch.cuda.empty_cache()
    keep = None
    for desc in RABITQ_IVF + (RABITQ_IVF[0] + ",RFlat",):
        index = ft.index_factory(D, desc)
        base = getattr(index, "base_index", index)
        base.quantizer.add(cent)  # L-b's coarse quantizer
        if base is not index:
            index.k_factor = K_FACTOR
        t_train, t_add, _ = timed_build(index, xt, xb)
        base.nprobe = L_NPROBE
        torch.cuda.reset_peak_memory_stats()
        no_kernel(fused_knn, f"L-c. {desc} search", lambda: index.search(xq, K))
        peak = torch.cuda.max_memory_allocated() / 2**30
        med = timed(f"L-c. {desc}, nprobe {L_NPROBE}, 8192 q", lambda: index.search(xq, K),
                    NQ, reps=2)
        D_, I_ = index.search(xq, K)
        if base is index:
            probes, cdis = probed_slots(index, xq, L_NPROBE)
            d64, ids, scale = rabitq_ivf64(index, xq, probes, cdis)
            err = rows_vs64(f"L-c. {desc}", D_, I_, d64, ids, scale)
        else:  # the re-rank's exact distances of the returned ids
            q = xq[:EXACT_ROWS].astype(np.float64)
            ok = I_[:EXACT_ROWS] >= 0
            d64 = ((q[:, None, :] - xb[np.maximum(I_[:EXACT_ROWS], 0)]) ** 2).sum(-1)
            e = np.abs(np.where(ok, D_[:EXACT_ROWS] - d64, 0.0))
            tol = 1e-5 * ((q**2).sum(1) + (xb[I_[:EXACT_ROWS]] ** 2).sum(-1).max(1))
            err = float(e.max())
            check(ok.all() and (e <= tol[:, None]).all()
                  and (np.diff(D_[:EXACT_ROWS], axis=1) >= 0).all(),
                  f"L-c. {desc}: re-ranked distances differ from float64")
        print(f"L-c. {desc} (nb_bits {base.nb_bits}, qb {base.qb}"
              f"{', k_factor %d' % index.k_factor if base is not index else ''}): train "
              f"{t_train:.2f} s, add {t_add:.2f} s, search {med * 1e3:.1f} ms (peak "
              f"{peak:.2f} GiB at 8192 q), {recall_str(I_, gt)}; 64 rows vs float64: "
              f"largest error {err:.3g} ({CARD})", flush=True)
        if desc == RABITQ_IVF[0]:
            keep = index
            lo, hi = index.ntotal // 4, 3 * index.ntotal // 4
            params = ft.SearchParametersIVF(nprobe=L_NPROBE, sel=ft.IDSelectorRange(lo, hi))
            Ds, Is = no_kernel(fused_knn, f"L-c. {desc} with IDSelectorRange",
                               lambda: index.search(xq, K, params=params))
            check(((Is == -1) | ((Is >= lo) & (Is < hi))).all(),
                  "L-c. the selector search returned an id outside the range")
            probes, cdis = probed_slots(index, xq, L_NPROBE)
            sel = (index._ids_host >= lo) & (index._ids_host < hi)
            d64, ids, scale = rabitq_ivf64(index, xq, probes, cdis, sel)
            err = rows_vs64(f"L-c. {desc} with IDSelectorRange", Ds, Is, d64, ids, scale)
            print(f"L-c. {desc} with IDSelectorRange [{lo}, {hi}): only "
                  f"selected ids; 64 rows vs float64 over the selected probed slots: "
                  f"largest error {err:.3g}", flush=True)
        else:
            del index
        torch.cuda.empty_cache()
    return keep


def aq_files_phase(ft, rq, ivf_rabitq, xq):
    """L-d: write_index / read_index of L-a's RQ8x8 and L-c's
    IVF4096,RaBitQ; each read index's search equals its search before the
    write (distances bit for bit, ids up to exact ties)."""
    import tempfile

    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    with tempfile.TemporaryDirectory() as tmp:
        for name, index in (("RQ8x8", rq), (RABITQ_IVF[0], ivf_rabitq)):
            D0, I0 = index.search(xq, K)
            path = str(Path(tmp) / "l.npz")
            t0 = time.time()
            ft.write_index(index, path)
            t_w = time.time() - t0
            t0 = time.time()
            back = ft.read_index(path)
            if hasattr(back, "nprobe"):
                back.nprobe = index.nprobe
            D1, I1 = back.search(xq, K)
            t_r = time.time() - t0
            same = (np.array_equal(D0, D1)
                    and ids_agree_tie_aware(D0, I0, D1, I1, 0.0).all())
            check(same and type(back) is type(index),
                  f"L-d. {name}: the read index searches otherwise")
            print(f"L-d. {name}: write {t_w:.2f} s, read and first search "
                  f"{t_r:.2f} s ({Path(path).stat().st_size / 2**20:.1f} MiB); "
                  f"8192 q equal to the search before the write", flush=True)


def aq_rabitq_phases(ft, fused_knn, xb, xt, xq, gt, dev):
    """Phase L: the additive quantizers and RaBitQ on the 1M x 128 set (no
    kernel)."""
    t0 = time.time()
    rq = aq_flat_phase(ft, fused_knn, xb, xt, xq, gt, dev)
    cent = aq_ivf_phase(ft, fused_knn, xb, xt, xq, gt, dev)
    ivf_rabitq = rabitq_phase(ft, fused_knn, xb, xt, xq, gt, dev, cent)
    aq_files_phase(ft, rq, ivf_rabitq, xq)
    print(f"phase L: {time.time() - t0:.1f} s ({CARD})", flush=True)


# -- phase M: the extra metrics, Panorama, EDEN, the lattice, QINCo, the
# small IVF variants, partitioning and files (no kernel of their own; the
# paths that search through the port's IndexFlat / IndexIVFFlat launch K1,
# K2 or K3, counted per entry of the kernels' line as "m_launches")

M_NQ_METRIC = 1024  # M-a's queries
M_NPROBE = 16
M_EXTRA = ("L1", "Linf", "Lp", "Canberra", "BrayCurtis", "JensenShannon",
           "Jaccard", "NaNEuclidean", "ABS_INNER_PRODUCT", "GOWER")
M_P = 3.0  # metric_arg of Lp
M_LATTICE_NSQ, M_LATTICE_SCALE = 8, 8  # d = 128: dsq 16
M_QINCO = dict(K=256, M=8, L=2, h=256, epochs=4, rows=100_000)
M_SH_NBIT = 64
M_PART = (8192, 65536, 100, 400)  # partition_fuzzy's rows, width, q_min, q_max
# IndexFlat's kernels at k = 10: the screen (K2), or K3 once a sub-batch's
# certificate fails on more than a quarter of its rows (a storm)
M_FLAT_KERNELS = ("ivf_recon_fused", "knn_fused[k_lanes=128]")


def m_counts(fused_knn):
    """Launch counts by the name of each kernel's entry in the kernels'
    line (K1-K5, K7; K6 serves no index path)."""
    return {"ivf_recon_fused_dyn": fused_knn.ivf_recon_fused_dyn.launches,
            "ivf_recon_fused": fused_knn.ivf_recon_fused.launches,
            "knn_fused[k_lanes=128]": fused_knn.knn_fused.launches,
            "ivfpq_fused": fused_knn.ivfpq_fused.launches,
            "ivfpq_fused_dyn": fused_knn.ivfpq_fused_dyn.launches,
            "recon_floor": fused_knn.recon_floor.launches}


def m_driven(fused_knn, tally, what, fn, need=(), warm=True):
    """fn() with every count at 0 just before and read just after, added to
    ``tally``; fails if a kernel of ``need`` (entry names) did not launch.
    With ``warm`` one call before (the layouts a first search stages) is
    left out of the time and of the counts. Returns (fn's result, seconds by
    the host clock, peak GiB)."""
    if warm:
        fn()
    reset_counts(fused_knn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    sec = time.time() - t0
    got = m_counts(fused_knn)
    for names in need:  # each a kernel, or a tuple of which one must launch
        names = names if isinstance(names, tuple) else (names,)
        check(sum(got[n] for n in names) > 0,
              f"{what}: {' nor '.join(names)} launched no time")
    for name, n in got.items():
        tally[name] = tally.get(name, 0) + n
    return out, sec, torch.cuda.max_memory_allocated() / 2**30


def m_metric_rows(xb, metric, rs):
    """M-a's rows for ``metric``: |x| normalised to sum 1 for the
    distribution metrics, 1% NaN for NaNEuclidean and GOWER."""
    if metric in ("JensenShannon", "Jaccard", "BrayCurtis"):
        a = np.abs(xb)
        return (a / a.sum(1, keepdims=True)).astype(np.float32)
    if metric in ("NaNEuclidean", "GOWER"):
        x = xb.copy()
        x[rs.rand(*x.shape) < 0.01] = np.nan
        return x
    return xb


def m_metric64(q, y, metric, p=M_P):
    """float64 [r, n] distances of ``metric`` between device rows, written
    out from faiss's extra_distances-inl.h formulas (the check's own
    copy), in blocks of rows."""
    out = []
    q = q.double()[:, None, :]
    for s in range(0, len(y), 8192):
        b = y[s : s + 8192].double()[None]
        diff = q - b
        if metric == "L1":
            r = diff.abs().sum(-1)
        elif metric == "Linf":
            r = diff.abs().amax(-1)
        elif metric == "Lp":
            r = diff.abs().pow(p).sum(-1)
        elif metric == "Canberra":
            den = q.abs() + b.abs()
            r = torch.where(den > 0, diff.abs() / den, 0.0).sum(-1)
        elif metric == "BrayCurtis":
            den = (q + b).abs().sum(-1)
            r = torch.where(den > 0, diff.abs().sum(-1) / den, 0.0)
        elif metric == "JensenShannon":
            m = 0.5 * (q + b)
            kl1 = torch.where(q > 0, q * torch.log(q / m), 0.0)
            kl2 = torch.where(b > 0, b * torch.log(b / m), 0.0)
            r = (0.5 * (kl1 + kl2)).sum(-1)
        elif metric == "Jaccard":
            den = torch.maximum(q, b).sum(-1)
            r = 1.0 - torch.where(den > 0, torch.minimum(q, b).sum(-1) / den, 0.0)
        elif metric == "NaNEuclidean":
            ok = ~torch.isnan(q) & ~torch.isnan(b)
            n = ok.sum(-1)
            s2 = torch.where(ok, diff, 0.0).square().sum(-1)
            r = torch.where(n > 0, q.shape[-1] * s2 / n, float("inf"))
        elif metric == "ABS_INNER_PRODUCT":
            r = (q * b).abs().sum(-1)
        else:  # GOWER
            num = (q >= 0) & (b >= 0)
            ok = ~torch.isnan(q) & ~torch.isnan(b)
            per = torch.where(num, diff.abs(), torch.where(q == b, 0.0, 1.0))
            n = ok.sum(-1)
            r = torch.where(n > 0, torch.where(ok, per, 0.0).sum(-1) / n, float("nan"))
        out.append(r)
    return torch.cat(out, 1)


def m_rows_vs64(what, D, I, d64, ids, largest=False, scale=None):
    """EXACT_ROWS rows of (D, I) against the float64 distances ``d64`` [r, n]
    of the candidates ``ids`` [n] (+inf / -inf where not allowed): per rank
    within 1e-5 of ``scale`` [r] (the L2 expansion's terms, |q|^2 + max
    |y|^2, for L2-like estimators; by default the row's largest distance:
    the extra metrics' relative bound), ids tie-aware. Returns the largest
    error over the scale."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    k = D.shape[1]
    key = -d64 if largest else d64
    v, pos = torch.topk(torch.nan_to_num(key, nan=float("inf")), k, dim=1,
                        largest=False)
    ref = (-v if largest else v).cpu().numpy()
    ref_i = ids[pos].cpu().numpy()
    fin = np.isfinite(ref)
    if scale is None:
        scale = np.abs(np.where(fin, ref, 0)).max(1) + 1e-30
    r = len(ref)
    err = np.where(fin, np.abs(D[:r] - ref), 0).max(1) / scale
    s = -1.0 if largest else 1.0
    check((err <= 1e-5).all() and (np.isfinite(D[:r]) == fin).all()
          and ids_agree_tie_aware(s * np.where(fin, ref, 1e30), ref_i,
                                  s * np.where(fin, D[:r], 1e30), I[:r],
                                  1e-5 * scale).all(),
          f"{what}: differs from float64 (largest error over the scale {err.max():.3g})")
    return float(err.max())


def m_quantizer(ft, xt, dev):
    """The 4096 L2 centroids phase M's IVF indexes share: k-means of the
    200k training rows on the card."""
    torch.cuda.synchronize()
    t0 = time.time()
    clus = ft.Clustering(D, NLIST, device=dev)
    clus.train(xt)
    torch.cuda.synchronize()
    print(f"M. k-means of {NLIST} centroids over {len(xt)} rows {time.time() - t0:.2f} s "
          f"({CARD})", flush=True)
    return np.ascontiguousarray(clus.centroids, np.float32)


def m_flat_q(ft, cent, dev, metric=None):
    q = ft.IndexFlat(D, metric if metric is not None else ft.METRIC_L2, device=dev)
    q.add(cent)
    return q


def m_probed(index, xq, nprobe):
    """The probed lists [r, nprobe] of the first EXACT_ROWS queries, by the
    index's coarse search."""
    dev = index.device
    return index._coarse_search(torch.from_numpy(xq[:EXACT_ROWS]).to(dev),
                                nprobe)[1]


def m_metrics_phase(ft, fused_knn, tally, xb, xq, cent, dev):
    """M-a: IndexFlat under the ten extra metrics (1024 queries over the 1M
    rows) and IVF4096,Flat under L1 at nprobe 16, 64 rows of each against
    float64."""
    rs = np.random.RandomState(7)
    nq = M_NQ_METRIC
    for name in M_EXTRA:
        metric = getattr(ft.MetricType, name)
        xb_m = m_metric_rows(xb, name, rs)
        xq_m = m_metric_rows(xq[:nq], name, rs)
        index = ft.IndexFlat(D, metric, M_P if name == "Lp" else 0.0, device=dev)
        index.add(xb_m)
        index._consolidate()
        (Dm, Im), sec, peak = m_driven(fused_knn, tally, f"M-a. {name}",
                                       lambda: index.search(xq_m, K), warm=False)
        y = index._consolidate()
        q = torch.from_numpy(xq_m[:EXACT_ROWS]).to(dev)
        d64 = m_metric64(q, y, name)
        largest = name == "ABS_INNER_PRODUCT"
        err = m_rows_vs64(f"M-a. {name}", Dm, Im, d64,
                          torch.arange(NB, device=dev), largest)
        check(np.isfinite(Dm).all() and (Im >= 0).all(), f"M-a. {name}: missing results")
        print(f"M-a. IndexFlat {name}: {nq} q over {NB} rows, k={K}: {sec * 1e3:.1f} ms, "
              f"peak {peak:.2f} GiB; 64 rows vs float64 over every row: largest "
              f"relative error {err:.3g} ({CARD})", flush=True)
        del index, y, d64
        torch.cuda.empty_cache()
    q = m_flat_q(ft, cent, dev, ft.METRIC_L1)
    ivf = ft.IndexIVFFlat(q, D, NLIST, ft.METRIC_L1, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    ivf.add(xb)
    torch.cuda.synchronize()
    t_add = time.time() - t0
    ivf.nprobe = M_NPROBE
    (Dm, Im), sec, peak = m_driven(fused_knn, tally, "M-a. IVF4096,Flat L1",
                                   lambda: ivf.search(xq[:nq], K))
    probes = m_probed(ivf, xq, M_NPROBE)
    lists = torch.from_numpy(ivf._listnos_host.astype(np.int64)).to(dev)
    xs = torch.from_numpy(ivf._codes_host).to(dev)
    ids = torch.from_numpy(ivf._ids_host).to(dev)
    q64 = torch.from_numpy(xq[:EXACT_ROWS]).to(dev)
    d64 = m_metric64(q64, xs, "L1")
    inl = (lists[None, :, None] == probes[:, None, :]).any(-1)
    d64 = torch.where(inl, d64, float("inf"))
    err = m_rows_vs64("M-a. IVF4096,Flat L1", Dm, Im, d64, ids)
    print(f"M-a. IVF4096,Flat under L1 (L1 assignment of {NB} rows {t_add:.2f} s): "
          f"{nq} q at nprobe {M_NPROBE}: {sec * 1e3:.1f} ms, peak {peak:.2f} GiB; 64 "
          f"rows vs float64 over the probed lists: largest relative error "
          f"{err:.3g} ({CARD})", flush=True)
    del ivf, xs, d64
    torch.cuda.empty_cache()


def m_equal_tie_aware(what, Da, Ia, Db, Ib, scale):
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    tol = 1e-5 * scale
    ok = ((np.abs(Da - Db) <= tol[:, None]).all(1)
          & ids_agree_tie_aware(Da, Ia, Db, Ib, tol))
    check(ok.all(), f"{what}: {int((~ok).sum())} rows differ")


def m_panorama_phase(ft, fused_knn, tally, xb, xq, cent, dev):
    """M-b: FlatPanorama8 against IndexFlatL2 on every row, and
    IVF4096,FlatPanorama4 against IVF4096,Flat over the same lists, both
    at nprobe 16."""
    scale = (xq.astype(np.float64) ** 2).sum(1) + float((xb.astype(np.float64) ** 2)
                                                         .sum(1).max())
    pano = ft.index_factory(D, "FlatPanorama8")
    check(type(pano).__name__ == "IndexFlatPanorama" and pano.num_levels == 8,
          f"M-b. {class_tree(pano)}")
    pano.add(xb)
    pano._pan_dev()
    (Dp, Ip), sec, peak = m_driven(fused_knn, tally, "M-b. FlatPanorama8",
                                   lambda: pano.search(xq, K))
    rep = pano.last_repaired
    flat = ft.IndexFlatL2(D, device=dev)
    flat.add(xb)
    (Df, If), sec_f, _ = m_driven(fused_knn, tally, "M-b. IndexFlatL2",
                                  lambda: flat.search(xq, K), need=(M_FLAT_KERNELS,))
    m_equal_tie_aware("M-b. FlatPanorama8 vs IndexFlatL2", Df, If, Dp, Ip, scale)
    print(f"M-b. FlatPanorama8 (d1 = {D // 8}, prune factor {pano.prune_factor}): "
          f"{NQ} q {sec * 1e3:.1f} ms (IndexFlatL2 {sec_f * 1e3:.1f} ms), peak "
          f"{peak:.2f} GiB; certified {1 - rep / NQ:.4f} of the rows, {rep} "
          f"repaired through IndexFlat; every row equal to IndexFlatL2's "
          f"({CARD})", flush=True)
    del flat
    torch.cuda.empty_cache()
    ivp = ft.IndexIVFFlatPanorama(m_flat_q(ft, cent, dev), D, NLIST, 4, device=dev)
    ivp.add(xb)
    ivf = ft.IndexIVFFlat(ivp.quantizer, D, NLIST, device=dev)
    ivf.add_encoded(ivp._codes_host, ivp._listnos_host, ivp._ids_host)
    ivp.nprobe = ivf.nprobe = M_NPROBE
    ivp._build_device()
    (Dp, Ip), sec, peak = m_driven(fused_knn, tally, "M-b. IVF4096,FlatPanorama4",
                                   lambda: ivp.search(xq, K))
    rep = ivp.last_repaired
    (Df, If), sec_f, _ = m_driven(fused_knn, tally, "M-b. IVF4096,Flat",
                                  lambda: ivf.search(xq, K))
    m_equal_tie_aware("M-b. IVF4096,FlatPanorama4 vs IVF4096,Flat", Df, If, Dp, Ip,
                      scale)
    print(f"M-b. IVF4096,FlatPanorama4 at nprobe {M_NPROBE}: {NQ} q {sec * 1e3:.1f} ms "
          f"(IVF4096,Flat strict {sec_f * 1e3:.1f} ms), peak {peak:.2f} GiB; "
          f"certified {1 - rep / NQ:.4f}, {rep} repaired through IndexIVFFlat; "
          f"every row equal to IVF4096,Flat's ({CARD})", flush=True)
    del ivp, ivf
    torch.cuda.empty_cache()
    return pano


def m_eden64(q, center, y, l2):
    """float64 of the EDEN L2 estimator |q - c|^2 + l2 - 2 <q - c, y>,
    clamped at 0 as both packages clamp the L2 expansion."""
    r = q.double() - center.double()
    return (r.square().sum(1)[:, None] + l2.double()[None]
            - 2.0 * r @ y.double().T).clamp_min(0.0)


def m_eden_phase(ft, fused_knn, tally, xb, xt, xq, gt, cent, dev):
    """M-c: EDEN4, EDEN4BIASED and IVF4096,EDEN4 at nprobe 16; 64 rows of
    each against float64 of the estimator (over the probed lists for
    IVF)."""
    keep = None
    for desc in ("EDEN4", "EDEN4BIASED"):
        index = ft.index_factory(D, desc)
        t_train, t_add, peak_add = timed_build(index, xt, xb)
        (Dm, Im), sec, peak = m_driven(fused_knn, tally, f"M-c. {desc}",
                                       lambda: index.search(xq, K))
        y, l2 = index._device_rows()
        q = torch.from_numpy(xq[:EXACT_ROWS]).to(dev)
        cen = torch.from_numpy(index.center).to(dev)
        d64 = m_eden64(q, cen, y, l2)
        scale = ((q - cen).double().square().sum(1) + l2.double().max()
                 + 2 * (q - cen).double().norm(dim=1) * y.double().norm(dim=1).max())
        err = m_rows_vs64(f"M-c. {desc}", Dm, Im, d64, torch.arange(NB, device=dev),
                          scale=scale.cpu().numpy())
        print(f"M-c. {desc}: train {t_train:.2f} s, encode {t_add:.2f} s for {NB} rows "
              f"(peak {peak_add:.2f} GiB), search {sec * 1e3:.1f} ms (peak {peak:.2f} "
              f"GiB), {index.sa_code_size()} bytes a code, {recall_str(Im, gt)}; 64 "
              f"rows vs float64 of the estimator: largest error {err:.3g} of |q - c|^2 "
              f"+ max l2 + 2 |q - c| max |y| ({CARD})", flush=True)
        if desc == "EDEN4":
            keep = index
        else:
            del index
        torch.cuda.empty_cache()
    ivf = ft.IndexIVFEDEN(m_flat_q(ft, cent, dev), D, NLIST, ft.METRIC_L2, 4, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    ivf.add(xb)
    torch.cuda.synchronize()
    t_add = time.time() - t0
    ivf.nprobe = M_NPROBE
    ivf._build_device()
    (Dm, Im), sec, peak = m_driven(fused_knn, tally, "M-c. IVF4096,EDEN4",
                                   lambda: ivf.search(xq, K))
    probes = m_probed(ivf, xq, M_NPROBE)
    c, f = ivf.eden.unpack(ivf._codes_host)
    f = torch.from_numpy(f).to(dev)
    lists = torch.from_numpy(ivf._listnos_host.astype(np.int64)).to(dev)
    cents = torch.from_numpy(cent).to(dev)[lists].double()
    y = ivf.eden.scaled(torch.from_numpy(c).to(dev), f).double()
    q = torch.from_numpy(xq[:EXACT_ROWS]).to(dev).double()
    # |q - c_l - y|^2 - |y|^2 + l2: the estimator of each row against its list
    d64 = ((q.square().sum(1)[:, None] - 2 * q @ (cents + y).T)
           + (cents.square().sum(1) + 2 * (cents * y).sum(1)
              + f[:, 0].double())[None]).clamp_min(0.0)
    inl = (lists[None, :, None] == probes[:, None, :]).any(-1)
    d64 = torch.where(inl, d64, float("inf"))
    t = cents.square().sum(1) + 2 * (cents * y).sum(1) + f[:, 0].double()
    scale = q.square().sum(1) + t.max() + 2 * q.norm(dim=1) * (cents + y).norm(dim=1).max()
    err = m_rows_vs64("M-c. IVF4096,EDEN4", Dm, Im, d64,
                      torch.from_numpy(ivf._ids_host).to(dev), scale=scale.cpu().numpy())
    print(f"M-c. IVF4096,EDEN4: encode {t_add:.2f} s for {NB} rows, {NQ} q at nprobe "
          f"{M_NPROBE}: {sec * 1e3:.1f} ms (peak {peak:.2f} GiB), "
          f"{ivf.sa_code_size()} bytes a code, {recall_str(Im, gt)}; 64 rows vs "
          f"float64 of the estimator over the probed lists: largest error "
          f"{err:.3g} of |q|^2 + max t + 2 |q| max |z| ({CARD})", flush=True)
    del ivf, y, d64
    torch.cuda.empty_cache()
    return keep


def m_atoms64(dim, r2):
    """The check's own enumeration of the Zn sphere's atoms (non-increasing
    non-negative integer vectors with sum of squares r2)."""
    out = []

    def rec(prefix, rem, top):
        if rem == 0:
            out.append(prefix + [0] * (dim - len(prefix)))
            return
        if len(prefix) == dim:
            return
        for v in range(min(top, int(rem ** 0.5)), 0, -1):
            rec(prefix + [v], rem - v * v, v)

    rec([], r2, r2)
    return np.asarray(out, np.float64)


def m_lattice_phase(ft, fused_knn, tally, xb, xt, xq, gt, dev):
    """M-d: ZnLattice8x8_r2 at d = 128 (dsq 16), r2 the largest of 32..8
    whose codec enumerates in under 10 s; decode(encode) against the
    float64 nearest sphere vertex on 64 rows."""
    from faiss_tpu_torch.codecs.lattice import ZnSphereCodec

    dsq = D // M_LATTICE_NSQ
    for r2 in range(32, 7, -1):
        t0 = time.time()
        ZnSphereCodec(dsq, r2, device=dev)
        t_enum = time.time() - t0
        if t_enum < 10:
            break
    desc = f"ZnLattice{M_LATTICE_NSQ}x{M_LATTICE_SCALE}_{r2}"
    index = ft.index_factory(D, desc)
    codec = index.zn_sphere_codec
    index.train(xt)
    torch.cuda.synchronize()
    t0 = time.time()
    index.add(xb)
    torch.cuda.synchronize()
    t_add = time.time() - t0
    (Dm, Im), sec, peak = m_driven(fused_knn, tally, f"M-d. {desc}",
                                   lambda: index.search(xq, K),
                                   need=(M_FLAT_KERNELS,))
    # decode(encode) of 64 rows against the float64 nearest vertex
    sub = xq[:EXACT_ROWS].reshape(-1, dsq).astype(np.float64)
    fields = index._encode_fields(xq[:EXACT_ROWS])
    got = codec.decode_ids(torch.from_numpy(fields[:, :, 1].ravel()).to(dev)).cpu().numpy()
    atoms = m_atoms64(dsq, r2)
    order = np.argsort(-np.abs(sub), axis=1, kind="stable")
    best = atoms[np.argmax(np.take_along_axis(np.abs(sub), order, 1) @ atoms.T, 1)]
    want = np.zeros_like(sub)
    np.put_along_axis(want, order, best, 1)
    want = np.where(sub < 0, -want, want)
    check(np.array_equal(got, want), f"M-d. {desc}: vertices differ from float64's "
          f"on {int((got != want).any(1).sum())} subvectors")
    print(f"M-d. {desc} (nv {codec.nv}, {codec.natom} atoms enumerated in "
          f"{t_enum * 1e3:.1f} ms, {index.nsq * (index.scale_nbit + index.lattice_nbit)} "
          f"bits a code): encode and decode of {NB} rows {t_add:.2f} s, search "
          f"{NQ} q {sec * 1e3:.1f} ms (peak {peak:.2f} GiB), {recall_str(Im, gt)}; "
          f"decode(encode) = the float64 nearest vertex on {len(sub)} subvectors "
          f"({CARD})", flush=True)
    return index


def m_qinco_phase(ft, fused_knn, tally, xb, xt, xq, gt, dev):
    """M-e: train_qinco over 100k rows on the card (K 256, M 8, L 2, h 256,
    4 epochs), the loss falling every epoch; IndexQINCo over the 1M rows."""
    from faiss_tpu_torch.utils.neuralnet import qinco_init, train_qinco

    p = M_QINCO
    xr = xt[: p["rows"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    init = qinco_init(D, p["K"], p["L"], p["M"], p["h"], xr, device=dev)
    model = train_qinco(xr, p["K"], p["M"], p["L"], p["h"], epochs=p["epochs"],
                        init_state=init, device=dev)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    losses = model.train_losses
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"M-e. the QINCo loss did not fall every epoch: {losses}")
    index = ft.IndexQINCo(D, p["M"], 8, p["L"], p["h"])
    index.set_net(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    index.add(xb)
    torch.cuda.synchronize()
    t_add = time.time() - t0
    peak_add = torch.cuda.max_memory_allocated() / 2**30
    rec = index.reconstruct_n(0, 100_000)
    mse = float(((rec.astype(np.float64) - xb[:100_000]) ** 2).sum(1).mean())
    # the starting level-0 codebook alone (k-means of K * 64 rows)
    cb0 = torch.from_numpy(init["codebook0.weight"]).to(dev)
    x0 = torch.from_numpy(xb[:100_000]).to(dev)
    mse0 = float(torch.cdist(x0, cb0).min(1).values.double().square().mean())
    (Dm, Im), sec, peak = m_driven(fused_knn, tally, "M-e. IndexQINCo",
                                   lambda: index.search(xq, K),
                                   need=(M_FLAT_KERNELS,))
    print(f"M-e. train_qinco over {p['rows']} rows (K {p['K']}, M {p['M']}, L {p['L']}, "
          f"h {p['h']}, {p['epochs']} epochs): {t_train:.2f} s, peak {peak_train:.2f} "
          f"GiB, losses {', '.join(f'{v:.5f}' for v in losses)}; IndexQINCo: encode "
          f"{NB} rows {t_add:.2f} s (peak {peak_add:.2f} GiB), MSE {mse:.5f} (the "
          f"starting level-0 codebook alone {mse0:.5f}), search "
          f"{NQ} q {sec * 1e3:.1f} ms (decode and IndexFlat; peak {peak:.2f} GiB), "
          f"{recall_str(Im, gt)} ({CARD})", flush=True)
    del index, model
    torch.cuda.empty_cache()


def m_small_ivf_phase(ft, fused_knn, tally, xb, xt, xq, gt, cent, dev):
    """M-f: IVFFlatDedup over the set with 10% of its rows duplicated,
    RowwiseMinMax / FP16 over SQ8, IVFIndependentQuantizer and
    IVFSpectralHash at nprobe 16."""
    rs = np.random.RandomState(11)
    src = rs.randint(0, NB, NB // 10)
    dup = np.concatenate([xb, xb[src]])
    ids = np.arange(len(dup), dtype=np.int64)
    dd = ft.IndexIVFFlatDedup(m_flat_q(ft, cent, dev), D, NLIST, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    dd.add_with_ids(dup, ids)
    torch.cuda.synchronize()
    t_add = time.time() - t0
    back = {}
    for rep, dups in dd.instances.items():
        for j in dups:
            back[j] = rep
    # every duplicate id comes back, under the id of its row in the set
    check(dd.ntotal == NB and sorted(back) == list(range(NB, len(dup)))
          and all(back[NB + i] == int(s) for i, s in enumerate(src)),
          "M-f. IVFFlatDedup: the duplicates are not all in instances")
    dd.nprobe = M_NPROBE
    dd.expand_instances = True
    qd = xb[src[:EXACT_ROWS]]
    (De, Ie), sec, _ = m_driven(fused_knn, tally, "M-f. IVFFlatDedup expanded",
                                lambda: dd.search(qd, K))
    for r, s in enumerate(src[:EXACT_ROWS]):
        want = [int(s)] + dd.instances.get(int(s), [])
        check(set(want[:K]) <= set(Ie[r]), f"M-f. IVFFlatDedup: row {r}'s duplicates "
              "are not in its expanded results")
    dd.expand_instances = False
    (Dm, Im), sec_b, _ = m_driven(fused_knn, tally, "M-f. IVFFlatDedup",
                                  lambda: dd.search(xq, K))
    print(f"M-f. IVFFlatDedup: {len(dup)} rows ({NB // 10} duplicates) added in "
          f"{t_add:.2f} s, {dd.ntotal} stored, every duplicate in instances; 64 "
          f"duplicated rows searched with expand_instances {sec * 1e3:.1f} ms, each "
          f"row's duplicates returned; {NQ} q at nprobe {M_NPROBE} {sec_b * 1e3:.1f} ms, "
          f"{recall_str(Im, gt)} ({CARD})", flush=True)
    del dd
    torch.cuda.empty_cache()
    for cls in (ft.IndexRowwiseMinMax, ft.IndexRowwiseMinMaxFP16):
        mm = cls(ft.IndexScalarQuantizer(D, ft.QuantizerType.QT_8bit, device=dev))
        mm.train(xt)
        t0 = time.time()
        codes = mm.sa_encode(xb)
        t_enc = time.time() - t0
        t0 = time.time()
        rec = mm.sa_decode(codes)
        t_dec = time.time() - t0
        flat = ft.IndexFlatL2(D, device=dev)
        flat.add(rec)
        (Dm, Im), sec, _ = m_driven(fused_knn, tally, f"M-f. {cls.__name__} decoded",
                                    lambda: flat.search(xq, K), need=(M_FLAT_KERNELS,))
        mse = float(((rec[:100_000].astype(np.float64) - xb[:100_000]) ** 2).sum(1).mean())
        print(f"M-f. {cls.__name__}(SQ8): sa_encode {t_enc:.2f} s, sa_decode {t_dec:.2f} s "
              f"for {NB} rows, {mm.sa_code_size()} bytes a code, MSE {mse:.6f}; the "
              f"decoded rows by IndexFlatL2 {sec * 1e3:.1f} ms, {recall_str(Im, gt)} "
              f"({CARD})", flush=True)
        del flat, rec, codes
    vt = ft.RandomRotationMatrix(D, D, device=dev)
    vt.init()
    iq = ft.IndexIVFIndependentQuantizer(
        m_flat_q(ft, cent, dev),
        ft.IndexIVFFlat(ft.IndexFlat(D, device=dev), D, NLIST, device=dev), vt)
    iq.train(xt)
    t0 = time.time()
    iq.add(xb)
    t_add = time.time() - t0
    iq.index_ivf.nprobe = M_NPROBE
    (Dm, Im), sec, _ = m_driven(fused_knn, tally, "M-f. IVFIndependentQuantizer",
                                lambda: iq.search(xq, K))
    print(f"M-f. IVFIndependentQuantizer (flat coarse quantizer, IVF4096,Flat over "
          f"rotated rows): add {t_add:.2f} s, {NQ} q at nprobe {M_NPROBE} "
          f"{sec * 1e3:.1f} ms, {recall_str(Im, gt)} ({CARD})", flush=True)
    del iq
    sh = ft.IndexIVFSpectralHash(m_flat_q(ft, cent, dev), D, NLIST, M_SH_NBIT, device=dev)
    sh.train(xt)
    t0 = time.time()
    sh.add(xb)
    t_add = time.time() - t0
    sh.nprobe = M_NPROBE
    (Dm, Im), sec, _ = m_driven(fused_knn, tally, "M-f. IVFSpectralHash",
                                lambda: sh.search(xq, K))
    check(np.isfinite(Dm).all() and (Dm == np.round(Dm)).all(),
          "M-f. IVFSpectralHash: distances are not bit counts")
    print(f"M-f. IVFSpectralHash ({M_SH_NBIT} bits): add {t_add:.2f} s, {NQ} q at "
          f"nprobe {M_NPROBE} {sec * 1e3:.1f} ms, {recall_str(Im, gt)} ({CARD})",
          flush=True)
    del sh
    torch.cuda.empty_cache()


def m_partition_phase(ft, dev):
    """M-g: partition_fuzzy on [8192, 65536] float32 rows with ties, held
    against a torch.sort-based check: the threshold is the q_min-th sorted
    value, q_out the count up to it clipped to [q_min, q_max], the first
    q_out values <= it and the rest >= it, each part in its original order,
    the values a permutation of the row's."""
    n, w, qmin, qmax = M_PART
    g = torch.Generator(device=dev).manual_seed(5)
    vals = torch.randint(-2000, 2000, (n, w), generator=g, device=dev).float() / 8
    pos = torch.arange(w, device=dev).expand(n, w)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: ft.partition_fuzzy(vals, pos, qmin, qmax), 3)
    vo, io, th, qo = ft.partition_fuzzy(vals, pos, qmin, qmax)
    srt = torch.sort(vals, dim=1).values
    t = srt[:, qmin - 1]
    le = (vals <= t[:, None]).sum(1)
    ok = torch.equal(th, t) and torch.equal(qo.long(), le.clamp(qmin, qmax))
    col = torch.arange(w, device=dev)[None]
    head = col < qo[:, None]
    ok = ok and bool(((vo <= t[:, None]) | ~head).all() and ((vo >= t[:, None]) | head).all())
    ok = ok and torch.equal(torch.sort(vo, 1).values, srt)
    dpos = io[:, 1:] - io[:, :-1]
    inner = (col[:, 1:] != qo[:, None])  # the step between the two parts
    ok = ok and bool(((dpos > 0) | ~inner).all())
    ok = ok and torch.equal(torch.gather(vals, 1, io), vo)
    check(ok, "M-g. partition_fuzzy disagrees with the sort-based check")
    print(f"M-g. partition_fuzzy [{n}, {w}] float32, q in [{qmin}, {qmax}]: "
          f"{ms:.2f} ms; equal to the torch.sort-based check ({CARD})", flush=True)


def m_files_phase(ft, indexes, xq):
    """M-h: write_index / read_index of EDEN4, FlatPanorama8 and the lattice
    index; each read index's search equals its search before the write."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        for index in indexes:
            name = type(index).__name__
            D0, I0 = index.search(xq, K)
            path = str(Path(tmp) / "m.npz")
            t0 = time.time()
            ft.write_index(index, path)
            back = ft.read_index(path)
            D1, I1 = back.search(xq, K)
            sec = time.time() - t0
            check(type(back) is type(index) and np.array_equal(D0, D1)
                  and np.array_equal(I0, I1), f"M-h. {name}: the read index searches "
                  "otherwise")
            print(f"M-h. {name}: write, read and search {sec:.2f} s "
                  f"({Path(path).stat().st_size / 2**20:.1f} MiB); {NQ} q equal to the "
                  f"search before the write", flush=True)
            del back


def codec_phases(ft, fused_knn, xb, xt, xq, gt, dev):
    """Phase M. Returns the launches of each kernel on phase M's paths, by
    the name of its entry in the kernels' line."""
    t_all = time.time()
    tally = {}
    times = {}
    t0 = time.time()
    cent = m_quantizer(ft, xt, dev)
    m_metrics_phase(ft, fused_knn, tally, xb, xq, cent, dev)
    times["M-a"] = time.time() - t0
    t0 = time.time()
    pano = m_panorama_phase(ft, fused_knn, tally, xb, xq, cent, dev)
    times["M-b"] = time.time() - t0
    t0 = time.time()
    eden = m_eden_phase(ft, fused_knn, tally, xb, xt, xq, gt, cent, dev)
    times["M-c"] = time.time() - t0
    t0 = time.time()
    lattice = m_lattice_phase(ft, fused_knn, tally, xb, xt, xq, gt, dev)
    times["M-d"] = time.time() - t0
    t0 = time.time()
    m_files_phase(ft, (eden, pano, lattice), xq)
    times["M-h"] = time.time() - t0
    del eden, pano, lattice
    torch.cuda.empty_cache()
    t0 = time.time()
    m_qinco_phase(ft, fused_knn, tally, xb, xt, xq, gt, dev)
    times["M-e"] = time.time() - t0
    t0 = time.time()
    m_small_ivf_phase(ft, fused_knn, tally, xb, xt, xq, gt, cent, dev)
    times["M-f"] = time.time() - t0
    t0 = time.time()
    m_partition_phase(ft, dev)
    times["M-g"] = time.time() - t0
    print(f"phase M: {time.time() - t_all:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in sorted(times.items()))
          + f"); launches {tally} ({CARD})", flush=True)
    return tally


# ---------------------------------------------------------------------------
# Phase N: the multi-device layer (parallel/sharded.py, IndexShards,
# IndexReplicas, IndexShardsIVF, ivflib, invlists) on the 1M x 128 set, with
# phase 4's index; four shards on the one card
# ---------------------------------------------------------------------------

N_SHARDS = 4
N_NQ_PROBE = 2048  # the queries of the nprobe-16 comparisons and N-e's recall
N_RECALL_GAP = 0.02  # N-e's recall@10 against phase 4's index, unrefined


def n_tol(xq, y_n2_max):
    """Per-row float32 scale of an L2 distance by the norm expansion:
    1e-5 (|q|^2 + max |y|^2)."""
    return 1e-5 * ((xq.astype(np.float64) ** 2).sum(1) + float(y_n2_max))


def n_equal(what, Da, Ia, Db, Ib, tol):
    """Two ascending results: finite at the same places, distances within
    ``tol`` [nq], ids equal up to ties at it. Returns the rows bitwise
    equal."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    fin = np.isfinite(Db)
    check((np.isfinite(Da) == fin).all(), f"{what}: infinite distances differ")
    err = np.abs(np.where(fin, Da.astype(np.float64) - Db, 0.0))
    check((err <= tol[:, None]).all(), f"{what}: distances differ by "
                                       f"{float((err / tol[:, None]).max()):.3g} x tol")
    agree = ids_agree_tie_aware(np.where(fin, Da, 0), Ia, np.where(fin, Db, 0),
                                Ib, tol)
    check(agree.all(), f"{what}: ids differ on {int((~agree).sum())} rows")
    return int(((Da == Db) & (Ia == Ib)).all(1).sum())


def n_probes(xq_d, cent_d, nprobe):
    """(coarse distances, probes) numpy of the sharded searches' own coarse
    quantization (ops.distances.knn over the centroids)."""
    from faiss_tpu_torch.ops import distances as dops

    cd, pr = dops.knn(xq_d, cent_d, nprobe)
    return cd.cpu().numpy(), pr.cpu().numpy()


def adc_tol(cb, term2, xq_d, cent):
    """1e-5 of each row's sum over m of its largest |table entry| (the
    query's -2 q.y and the largest list-side term2), plus 1e-5 (|q|^2 +
    max |c|^2) of the coarse distance's norm expansion: the scale of a
    float32 ADC sum's error, by residual in L2."""
    from faiss_tpu_torch.ops import pq_ops

    tab = (-2.0 * pq_ops.pq_ip_tables(xq_d, cb)).abs() + term2.abs().amax(0)[None]
    cn2 = float(cent.double().square().sum(1).max())
    return lut_tol(tab) + n_tol(xq_d.cpu().numpy(), cn2)


def n_part(times, peaks, name, t0):
    torch.cuda.synchronize()
    times[name] = time.time() - t0
    peaks[name] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()


def n_flat(ft, xb, xq, gt, dev, mesh):
    """N-a. ShardedFlat over the 1M rows against the port's unsharded exact
    k-NN; 64 rows against float64."""
    from faiss_tpu_torch.ops import distances as dops
    from faiss_tpu_torch.utils.evaluation import recall_at_k

    sf = ft.ShardedFlat(D, mesh)
    sf.add(xb)
    sf.search(xq[:128], K)  # the upload to the shards
    torch.cuda.synchronize()
    t0 = time.time()
    Ds, Is = sf.search(xq, K)
    torch.cuda.synchronize()
    t_search = time.time() - t0
    Du, Iu = dops.knn(torch.from_numpy(xq).to(dev), torch.from_numpy(xb).to(dev), K)
    xn2 = float((xb.astype(np.float64) ** 2).sum(1).max())
    tol = n_tol(xq, xn2)
    same = n_equal("N-a. ShardedFlat against the unsharded k-NN", Ds, Is,
                   Du.cpu().numpy(), Iu.cpu().numpy(), tol)
    r = slice(0, EXACT_ROWS)
    d64 = ((xq[r, None, :].astype(np.float64) - xb[Is[r]].astype(np.float64)) ** 2).sum(-1)
    err = np.abs(Ds[r] - d64)
    check((err <= tol[r, None]).all(), f"N-a. ShardedFlat's distances differ "
                                       f"from float64 by {float(err.max()):.3e}")
    recall = recall_at_k(Is, gt, K)
    print(f"N-a. ShardedFlat over {N_SHARDS} shards of {NB // N_SHARDS} rows: "
          f"{NQ} q k={K} in {t_search * 1e3:.1f} ms ({NQ / t_search:.0f} QPS); "
          f"equals the unsharded ops.distances.knn tie-aware ({same} rows "
          f"bitwise); {EXACT_ROWS} rows vs float64 max err {float(err.max()):.3e}; "
          f"recall@10 {recall:.4f} ({CARD})", flush=True)
    del sf
    return Ds, Is


def n_ivf(ft, state, xb, xq, dev, mesh):
    """N-b. IVF4096,Flat over phase 4's coarse centroids; ShardedIVF and an
    IndexShardsIVF of ivflib.shard_ivf_index_centroids, each against the
    unsharded index's search_preassigned on the same probes."""
    q = ft.IndexFlatL2(D, device=dev)
    q.add(state["cent"])
    ivf = ft.IndexIVFFlat(q, D, NLIST, device=dev)
    t0 = time.time()
    ivf.add(xb)
    ivf._build_device()
    torch.cuda.synchronize()
    t_build = time.time() - t0
    sivf = ft.ShardedIVF(ivf, mesh)
    hsh = ft.IndexShardsIVF(ivf.quantizer, D, NLIST)
    for shard in ft.shard_ivf_index_centroids(ivf, N_SHARDS):
        hsh.add_shard(shard)
    check(hsh.ntotal == NB, f"N-b. the IndexShardsIVF shards hold {hsh.ntotal} rows")
    cent_d = torch.from_numpy(state["cent"]).to(dev)
    xn2 = float((xb.astype(np.float64) ** 2).sum(1).max())
    notes = []
    for nprobe in (1, 16):
        nq = NQ if nprobe == 1 else N_NQ_PROBE
        x = xq[:nq]
        cd, pr = n_probes(torch.from_numpy(x).to(dev), cent_d, nprobe)
        Dr, Ir = ivf.search_preassigned(x, K, pr, cd)
        torch.cuda.synchronize()
        t0 = time.time()
        Ds, Is = sivf.search(x, K, nprobe=nprobe)
        torch.cuda.synchronize()
        t_s = time.time() - t0
        tol = n_tol(x, xn2)
        a = n_equal(f"N-b. ShardedIVF nprobe {nprobe}", Ds, Is, Dr, Ir, tol)
        hsh.nprobe = nprobe
        Dh, Ih = hsh.search(x, K)
        cdq, prq = ivf.quantizer.search(x, nprobe)
        Dq, Iq = ivf.search_preassigned(x, K, prq, cdq)
        b = n_equal(f"N-b. IndexShardsIVF nprobe {nprobe}", Dh, Ih, Dq, Iq, tol)
        notes.append(f"nprobe {nprobe} ({nq} q): ShardedIVF {t_s * 1e3:.1f} ms, "
                     f"{a} rows bitwise; IndexShardsIVF {b} rows bitwise")
    print(f"N-b. IVF{NLIST},Flat on phase 4's centroids built in {t_build:.2f} s; "
          f"ShardedIVF and IndexShardsIVF ({N_SHARDS} shards) equal its "
          f"search_preassigned on the same probes tie-aware: "
          + "; ".join(notes) + f" ({CARD})", flush=True)
    del sivf, hsh
    return ivf


def n_ivfpq(ft, base, xq, dev, mesh):
    """N-c. ShardedIVFPQ over phase 4's base, unrefined, at nprobe 1 and 16,
    against the base's search_preassigned on the same probes and a one-shard
    mesh."""
    sp4 = ft.ShardedIVFPQ(base, mesh)
    sp1 = ft.ShardedIVFPQ(base, ft.make_mesh(devices=[dev]))
    cent_d = base._centroids_dev()
    notes = []
    for nprobe in (1, 16):
        nq = NQ if nprobe == 1 else N_NQ_PROBE
        x = xq[:nq]
        xd = torch.from_numpy(x).to(dev)
        cd, pr = n_probes(xd, cent_d, nprobe)
        Dr, Ir = base.search_preassigned(x, K, pr, cd)
        torch.cuda.synchronize()
        t0 = time.time()
        D4, I4 = sp4.search(x, K, nprobe=nprobe)
        torch.cuda.synchronize()
        t4 = time.time() - t0
        D1, I1 = sp1.search(x, K, nprobe=nprobe)
        tol = adc_tol(base.pq._dev(), base._maybe_term2(), xd, cent_d)
        a = n_equal(f"N-c. ShardedIVFPQ nprobe {nprobe}", D4, I4, Dr, Ir, tol)
        b = n_equal(f"N-c. ShardedIVFPQ 4 vs 1 shard nprobe {nprobe}", D4, I4,
                    D1, I1, tol)
        notes.append(f"nprobe {nprobe} ({nq} q): {t4 * 1e3:.1f} ms, {a} rows "
                     f"bitwise to search_preassigned, {b} to one shard, max "
                     f"|D - ref| {float(np.abs(D4 - Dr).max()):.3e}")
    print(f"N-c. ShardedIVFPQ over phase 4's base ({N_SHARDS} CSR shards of "
          f"{base.nlist // N_SHARDS} lists): " + "; ".join(notes) + f" ({CARD})",
          flush=True)


def n_refined(ft, state, xb, xq, gt, dev, mesh):
    """N-d. ShardedRefinedIVFPQ (fp16 store, k_factor 8, nprobe 1) on 4
    shards and on one."""
    from faiss_tpu_torch.utils.evaluation import recall_at_k

    base = state["index"].base_index
    r4 = ft.ShardedRefinedIVFPQ(base, mesh, xb, store_float16=True, k_factor=K_FACTOR)
    r1 = ft.ShardedRefinedIVFPQ(base, ft.make_mesh(devices=[dev]), xb,
                                store_float16=True, k_factor=K_FACTOR)
    torch.cuda.synchronize()
    t0 = time.time()
    D4, I4 = r4.search(xq, K, nprobe=NPROBE)
    torch.cuda.synchronize()
    t4 = time.time() - t0
    D1, I1 = r1.search(xq, K, nprobe=NPROBE)
    check(np.isfinite(D4).all() and (I4 >= 0).all(), "N-d. missing results")
    r = slice(0, EXACT_ROWS)
    x16 = xb[I4[r]].astype(np.float16).astype(np.float64)
    d64 = ((xq[r, None, :].astype(np.float64) - x16) ** 2).sum(-1)
    err = float(np.abs(D4[r] - d64).max())
    check(np.allclose(D4[r], d64, rtol=1e-5, atol=1e-5),
          f"N-d. distances are not exact to the fp16 store ({err:.3e})")
    # the union of the shards' top-kc holds the one-shard top-kc
    tol = 1e-6 * (1.0 + np.abs(D1))
    worse = D4 > D1 + tol
    check(not worse.any(), f"N-d. 4 shards worse than one at {int(worse.sum())} "
                           "(row, rank) places")
    recall4, recall1 = recall_at_k(I4, gt, K), recall_at_k(I1, gt, K)
    print(f"N-d. ShardedRefinedIVFPQ (fp16 store, k_factor {K_FACTOR}, nprobe "
          f"{NPROBE}, kc {min(K * K_FACTOR, 8 * r4.max_len)}): {NQ} q in "
          f"{t4 * 1e3:.1f} ms; {EXACT_ROWS} rows exact to the fp16 store (max "
          f"err {err:.3e}); never worse than one shard ({int((D4 < D1 - tol).sum())} "
          f"places better); recall@10 {recall4:.4f} (one shard {recall1:.4f}; "
          f"the main path {state['recall']:.4f}) ({CARD})", flush=True)


def n_builder(ft, state, xb, xt, xq, gt, dev, mesh):
    """N-e. ShardedIVFPQBuilder(128, 4096, 32, 4): trained on the training
    rows, the 1M rows added in chunks, finalized; checked by one k-means
    iteration against the unsharded reduction, 64 rows against float64 and
    its recall against phase 4's index."""
    from faiss_tpu_torch.ops.kmeans_ops import kmeans_assign_update
    from faiss_tpu_torch.parallel.sharded import _shard_pad
    from faiss_tpu_torch.utils.evaluation import recall_at_k

    b = ft.ShardedIVFPQBuilder(D, NLIST, M, NBITS, mesh)
    torch.cuda.synchronize()
    t0 = time.time()
    b.train(xt, niter=NITER)
    torch.cuda.synchronize()
    t_train = time.time() - t0
    t0 = time.time()
    for c0 in range(0, NB, NB // 4):
        b.add(xb[c0 : c0 + NB // 4])
    out = b.finalize()
    torch.cuda.synchronize()
    t_add = time.time() - t0

    # one data-parallel iteration against the unsharded reduction
    xp, _ = _shard_pad(xt, N_SHARDS)
    cent = torch.from_numpy(b.centroids).to(dev)
    ss, sc, so = ft.sharded_kmeans_iter(mesh, xp, b.centroids)
    us, uc, uo, _ = kmeans_assign_update(torch.from_numpy(xp).to(dev), cent)
    ndiff = int((sc != uc).sum())
    check(ndiff == 0, f"N-e. sharded k-means counts differ on {ndiff} centroids")
    serr = float((ss - us).abs().max() / us.abs().max())
    check(serr <= 1e-5, f"N-e. sharded k-means sums differ by {serr:.3e} relative")
    oerr = abs(float(so) - float(uo)) / abs(float(uo))
    check(oerr <= 1e-5, f"N-e. sharded k-means objective differs by {oerr:.3e}")

    # 64 rows at nprobe 16 against a float64 ADC over the probed lists
    x = xq[:EXACT_ROWS]
    cd, pr = n_probes(torch.from_numpy(x).to(dev), cent, 16)
    Dp, Ip = out.search(x, K, nprobe=16)
    c64 = b.centroids.astype(np.float64)
    cb = b.pq.centroids.astype(np.float64)
    lps = out.lists_per_shard
    tol = adc_tol(out.pq_codebooks[0], torch.cat(out.term2), torch.from_numpy(x).to(dev),
                  cent)
    for q in range(EXACT_ROWS):
        ds, ids = [], []
        for ln in pr[q]:
            s, l = divmod(int(ln), lps)
            lists = out.lists[s]
            o, n = int(lists.offsets[l]), int(lists.lengths[l])
            codes = lists.codes[o : o + n].long().cpu().numpy()
            rec = c64[ln] + np.concatenate([cb[m, codes[:, m]] for m in range(M)], 1)
            ds.append(((x[q].astype(np.float64) - rec) ** 2).sum(1))
            ids.append(out._ids_host[lists.slot_ids[o : o + n].cpu().numpy()])
        ds, ids = np.concatenate(ds), np.concatenate(ids)
        order = np.argsort(ds, kind="stable")[:K]
        n_equal(f"N-e. builder row {q} against float64", Dp[q : q + 1], Ip[q : q + 1],
                ds[order][None], ids[order][None], tol[q : q + 1])

    # recall against phase 4's index, unrefined, at nprobe 16
    base = state["index"].base_index
    x = xq[:N_NQ_PROBE]
    base.nprobe = 16
    _, Ib = base.search(x, K)
    base.nprobe = NPROBE
    _, Is = out.search(x, K, nprobe=16)
    rb, rs_ = recall_at_k(Ib, gt[:N_NQ_PROBE], K), recall_at_k(Is, gt[:N_NQ_PROBE], K)
    check(abs(rs_ - rb) <= N_RECALL_GAP, f"N-e. the builder's recall@10 {rs_:.4f} "
                                         f"against phase 4's index {rb:.4f}")
    print(f"N-e. ShardedIVFPQBuilder({D}, {NLIST}, {M}, {NBITS}) on {N_SHARDS} "
          f"shards: train ({NT} rows, {NITER} data-parallel iterations, PQ) "
          f"{t_train:.2f} s, add of {NB} rows in 4 chunks + finalize "
          f"{t_add:.2f} s; one iteration equals the unsharded reduction (counts "
          f"exact, sums {serr:.2e}, objective {oerr:.2e} relative); "
          f"{EXACT_ROWS} rows at nprobe 16 equal a float64 ADC over their "
          f"lists; recall@10 at nprobe 16 {rs_:.4f} against phase 4's "
          f"{rb:.4f} ({N_NQ_PROBE} q) ({CARD})", flush=True)


def n_main_knobs(index):
    """The main path's search settings: phases 5-14 change them on phase
    4's index (phase 14 re-stages it without the decoded store)."""
    base = index.base_index
    base.nprobe = NPROBE
    base.strict_probe = False
    base.pipeline_batch = BATCH
    if base.recon_scan_max_bytes != type(base).recon_scan_max_bytes:
        base.recon_scan_max_bytes = type(base).recon_scan_max_bytes
        base._drop_caches()
    index.k_factor = K_FACTOR


def n_compositions(ft, fused_knn, tally, state, xb, xq, gt, dev, flat_res):
    """N-f. IndexShards over two cloned, reset and refilled halves of phase
    4's index at the main operating point (K1), IndexReplicas of phase 4's
    index and its clone, IndexShards of four IndexFlatL2 quarters. Returns
    the halves."""
    from faiss_tpu_torch.utils.evaluation import recall_at_k

    index = state["index"]
    n_main_knobs(index)
    t0 = time.time()
    half_a = ft.clone_index(index)
    t_clone = time.time() - t0
    half_a.reset()
    half_b = ft.clone_index(half_a)
    half_a.add(xb[: NB // 2])
    half_b.add(xb[NB // 2 :])
    shards = ft.IndexShards(D, successive_ids=True)
    for h in (half_a, half_b):
        n_main_knobs(h)
        shards.add_shard(h)
    check(shards.ntotal == NB, f"N-f. IndexShards holds {shards.ntotal} rows")
    (Ds, Is), t_sh, peak = m_driven(fused_knn, tally, "N-f. IndexShards",
                                    lambda: shards.search(xq, K),
                                    need=("ivf_recon_fused_dyn",))
    k1_shards = fused_knn.ivf_recon_fused_dyn.launches
    recall = recall_at_k(Is, gt, K)
    check(recall >= RECALL_MIN, f"N-f. IndexShards recall@10 {recall:.4f}")
    x16 = xb[Is[:256]].astype(np.float16).astype(np.float32)
    check(np.allclose(Ds[:256], ((xq[:256, None, :] - x16) ** 2).sum(-1),
                      rtol=1e-4, atol=1e-3),
          "N-f. IndexShards distances are not the exact L2 to the fp16 store")

    replica = ft.clone_index(index)
    n_main_knobs(replica)
    reps = ft.IndexReplicas(D)
    reps.add_replica(index)
    reps.add_replica(replica)
    D0, I0 = index.search(xq, K)
    (Dr, Ir), t_rep, _ = m_driven(fused_knn, tally, "N-f. IndexReplicas",
                                  lambda: reps.search(xq, K),
                                  need=("ivf_recon_fused_dyn",))
    k1_reps = fused_knn.ivf_recon_fused_dyn.launches
    other = rows_equal_up_to_k1_ties("N-f. IndexReplicas against phase 4's index",
                                     D0, I0, Dr, Ir)
    del reps, replica

    quarters = ft.IndexShards(D, successive_ids=True)
    for q in range(4):
        f = ft.IndexFlatL2(D, device=dev)
        f.add(xb[q * NB // 4 : (q + 1) * NB // 4])
        quarters.add_shard(f)
    (Dq, Iq), t_q, _ = m_driven(fused_knn, tally, "N-f. IndexShards of IndexFlatL2",
                                lambda: quarters.search(xq, K),
                                need=(M_FLAT_KERNELS,))
    flat_n = {n: c for n, c in m_counts(fused_knn).items() if c}
    xn2 = float((xb.astype(np.float64) ** 2).sum(1).max())
    same = n_equal("N-f. IndexShards of IndexFlatL2 against N-a", Dq, Iq,
                   *flat_res, n_tol(xq, xn2))
    del quarters
    print(f"N-f. clone_index of phase 4's index {t_clone:.2f} s; IndexShards of "
          f"two IVF{NLIST},PQ{M}x{NBITS}fs,RFlat halves ({NB // 2} rows each; nprobe {NPROBE} "
          f"soft, k_factor {K_FACTOR}): {NQ} q in {t_sh * 1e3:.1f} ms "
          f"({NQ / t_sh:.0f} QPS), K1 x{k1_shards}, recall@10 {recall:.4f}, peak "
          f"{peak:.2f} GiB; IndexReplicas (index + clone): {t_rep * 1e3:.1f} ms, "
          f"K1 x{k1_reps}, equal to the index on {NQ - other} of {NQ} rows (the "
          f"rest tied at K1's cut); IndexShards of four IndexFlatL2 quarters: "
          f"{t_q * 1e3:.1f} ms, kernels {flat_n}, equal to N-a tie-aware ({same} "
          f"rows bitwise) ({CARD})", flush=True)
    return half_a, half_b


def n_tools(ft, state, half_a, half_b, ivf, xb, xq, dev):
    """N-g. ivflib.merge_into of the N-f halves' bases against phase 4's
    base, one SlidingIndexWindow.step, an OnDiskInvertedLists round trip of
    N-b's lists."""
    base = state["index"].base_index
    a, b_ = half_a.base_index, half_b.base_index
    t0 = time.time()
    ft.merge_into(a, b_, shift_ids=True)
    t_merge = time.time() - t0
    check(a.ntotal == NB and b_.ntotal == 0
          and np.array_equal(a._ids_host, base._ids_host),
          f"N-g. merge_into left {a.ntotal} + {b_.ntotal} entries")
    ncodes = int((a._codes_host != base._codes_host).any(1).sum())
    x = xq[:N_NQ_PROBE]
    xd = torch.from_numpy(x).to(dev)
    cd, pr = n_probes(xd, base._centroids_dev(), 16)
    Dm, Im = a.search_preassigned(x, K, pr, cd)
    Db, Ib = base.search_preassigned(x, K, pr, cd)
    same = n_equal("N-g. merge_into against phase 4's base", Dm, Im, Db, Ib,
                   adc_tol(base.pq._dev(), base._maybe_term2(), xd,
                           base._centroids_dev()))

    # the window: drop the merged entries, append a sub-index of a tenth
    n_sub = NB // 10
    sub = ft.IndexIVFPQFastScan(base.quantizer, D, NLIST, M, NBITS, device=dev)
    sub.pq.set_centroids(base.pq.centroids)
    sub.is_trained = True
    sub.add(xb[:n_sub])
    win = ft.SlidingIndexWindow(a)
    t0 = time.time()
    win.step(sub, remove_oldest=True)
    t_step = time.time() - t0
    check(win.n_slice == 1 and a.ntotal == n_sub and a._device is None,
          f"N-g. the window holds {a.ntotal} entries in {win.n_slice} slices")
    x = xq[:256]
    cd, pr = n_probes(torch.from_numpy(x).to(dev), base._centroids_dev(), 4)
    Dw, Iw = a.search_preassigned(x, K, pr, cd)
    Dsub, Isub = sub.search_preassigned(x, K, pr, cd)
    check(np.array_equal(Dw, Dsub) and np.array_equal(Iw, Isub),
          "N-g. the window's search differs from its sub-index's")

    # the IVF-Flat lists through a file and back
    path = ROOT / "faiss_tpu_torch" / "_build" / "phase_n.ivfdata"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    il = ft.ArrayInvertedLists.from_index(ivf)
    od = ft.OnDiskInvertedLists(NLIST, il.code_size, str(path))
    od.merge_from_multiple([il])
    back = ft.shard_ivf_index_centroids(ivf, 1)[0]
    ft.replace_invlists(back, od)
    t_disk = time.time() - t0
    size = path.stat().st_size
    x = xq[:N_NQ_PROBE]
    cd, pr = n_probes(torch.from_numpy(x).to(dev),
                      torch.from_numpy(state["cent"]).to(dev), 16)
    Do, Io = back.search_preassigned(x, K, pr, cd)
    Di, Ii = ivf.search_preassigned(x, K, pr, cd)
    od.close()
    path.unlink()
    check(np.array_equal(Do, Di) and np.array_equal(Io, Ii),
          "N-g. the IVF-Flat read back from OnDiskInvertedLists searches otherwise")
    print(f"N-g. merge_into of the two halves' bases {t_merge:.2f} s: equal to "
          f"phase 4's base at nprobe 16 ({N_NQ_PROBE} q; {same} rows bitwise, "
          f"{ncodes} of {NB} codes differ from phase 4's encode); "
          f"SlidingIndexWindow.step (drop {NB}, append {n_sub}) {t_step:.3f} s, its "
          f"search equal to the sub-index's; OnDiskInvertedLists of the "
          f"IVF{NLIST},Flat lists ({size / 2**20:.0f} MiB file, from_index + "
          f"merge_from_multiple + replace_invlists {t_disk:.2f} s) searches "
          f"bit for bit as before ({CARD})", flush=True)


def sharded_phases(ft, fused_knn, state, xb, xt, xq, gt, dev):
    """Phase N. Returns the launches of each kernel on N-f's user-facing
    searches (IndexShards, IndexReplicas), by the name of its entry in the
    kernels' line."""
    t_all = time.time()
    times, peaks, tally = {}, {}, {}
    mesh = ft.make_mesh(devices=[dev] * N_SHARDS)
    check(mesh.size == N_SHARDS, f"N. mesh {mesh}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    flat_res = n_flat(ft, xb, xq, gt, dev, mesh)
    n_part(times, peaks, "N-a", t0)
    t0 = time.time()
    ivf = n_ivf(ft, state, xb, xq, dev, mesh)
    n_part(times, peaks, "N-b", t0)
    t0 = time.time()
    n_ivfpq(ft, state["index"].base_index, xq, dev, mesh)
    n_part(times, peaks, "N-c", t0)
    t0 = time.time()
    n_refined(ft, state, xb, xq, gt, dev, mesh)
    n_part(times, peaks, "N-d", t0)
    t0 = time.time()
    n_builder(ft, state, xb, xt, xq, gt, dev, mesh)
    n_part(times, peaks, "N-e", t0)
    torch.cuda.empty_cache()
    t0 = time.time()
    half_a, half_b = n_compositions(ft, fused_knn, tally, state, xb, xq, gt, dev,
                                    flat_res)
    n_part(times, peaks, "N-f", t0)
    t0 = time.time()
    n_tools(ft, state, half_a, half_b, ivf, xb, xq, dev)
    n_part(times, peaks, "N-g", t0)
    del half_a, half_b, ivf
    torch.cuda.empty_cache()
    print(f"phase N: {time.time() - t_all:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s / {peaks[k]:.2f} GiB peak"
                      for k, v in sorted(times.items()))
          + f"); launches {tally} ({CARD})", flush=True)
    return tally


# ---------------------------------------------------------------------------
# Phase O: faiss_tpu's tools over the port (the reference format,
# reverse_index_factory, autotune, bench_fw, extra, stats, datasets, contrib,
# the C API) on the 1M x 128 set, with phase 4's index
# ---------------------------------------------------------------------------

O_DIR = ROOT / "faiss_tpu_torch" / "_build" / "phase_o"
O_NPROBES, O_KFACTORS = [1, 2, 4, 8, 16], [4, 8, 16]
O_SYN = (128, 100_000, 1_000_000, NQ)  # SyntheticDataset(d, nt, nb, nq)


def o_gt64(what, xb, xq, I, dev):
    """The first EXACT_ROWS rows of an exact k-NN ``I`` against a float64
    brute force on the card: ids tie-aware within 1e-6 (|q|^2 + max |y|^2)."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    d64, ymax = d64_rows(xb, xq, dev)
    k = I.shape[1]
    vals, ids = torch.topk(d64, k, largest=False)
    got = torch.gather(d64, 1, torch.from_numpy(I[:EXACT_ROWS]).to(dev))
    got, order = torch.sort(got, 1)
    mine = np.take_along_axis(I[:EXACT_ROWS], order.cpu().numpy(), 1)
    q2 = (xq[:EXACT_ROWS].astype(np.float64) ** 2).sum(1)
    tol = 1e-6 * (q2 + ymax)
    agree = ids_agree_tie_aware(vals.cpu().numpy(), ids.cpu().numpy(),
                                got.cpu().numpy(), mine, tol)
    check(agree.all(), f"{what}: {int((~agree).sum())} of {EXACT_ROWS} rows "
                       "differ from float64 beyond ties")
    del d64


def o_sorted64(xb, xq, I, dev):
    """float64 squared L2 of each row's ids, sorted ascending, with the ids
    in that order (the tie-aware comparison of two id tables)."""
    q = torch.from_numpy(xq).to(dev, torch.float64)
    out_d, out_i = [], []
    for s in range(0, len(xq), 1024):
        i = torch.from_numpy(I[s : s + 1024]).to(dev)
        y = torch.from_numpy(xb).to(dev)[i].double()
        d, o = torch.sort((q[s : s + 1024, None, :] - y).square().sum(-1), 1)
        out_d.append(d.cpu().numpy())
        out_i.append(torch.gather(i, 1, o).cpu().numpy())
    return np.concatenate(out_d), np.concatenate(out_i)


def o_ids_equal(what, xb, xq, Ia, Ib, dev):
    """Two exact id tables equal up to ties within 1e-5 (|q|^2 + max |y|^2)
    of their float64 distances. Returns the rows whose id sets differ."""
    from faiss_tpu_torch.utils.evaluation import ids_agree_tie_aware

    da, ia = o_sorted64(xb, xq, Ia, dev)
    db, ib = o_sorted64(xb, xq, Ib, dev)
    tol = n_tol(xq, float((xb.astype(np.float64) ** 2).sum(1).max()))
    agree = ids_agree_tie_aware(da, ia, db, ib, tol)
    check(agree.all(), f"{what}: ids differ beyond ties on {int((~agree).sum())} rows")
    return int((np.sort(Ia, 1) != np.sort(Ib, 1)).any(1).sum())


def o_dataset(ft_datasets, xb, xt, xq, gt, dev):
    """The 1M x 128 set as a port Dataset whose ground truth is
    bench_gt_cache.npz."""
    class Cached(ft_datasets.Dataset):
        def __init__(self):
            self.d, self.nt, self.nb, self.nq = D, len(xt), len(xb), len(xq)
            self.device = dev

        def get_train(self, maxtrain=None):
            return xt if maxtrain is None else xt[:maxtrain]

        def get_database(self):
            return xb

        def get_queries(self):
            return xq

        def get_groundtruth(self, k=100):
            check(k <= gt.shape[1], f"the cache holds {gt.shape[1]} neighbours")
            return gt[:, :k]

    return Cached()


def o_ref_format(ft, fused_knn, tally, state, xq, gt, dev):
    """O-a and O-b: reverse_index_factory, then the index through the
    reference library's own format and back onto the card. Returns the
    read index and its file."""
    from faiss_tpu_torch.utils.evaluation import recall_at_k

    index = state["index"]
    base = index.base_index
    s = ft.reverse_index_factory(index)
    rebuilt = ft.index_factory(D, s, device=dev)
    rb = rebuilt.base_index
    check(s == f"IVF{NLIST},PQ{M}x{NBITS}fs,RFlat" and type(rebuilt) is type(index)
          and type(rb) is type(base) and type(rb.quantizer) is type(base.quantizer)
          and (rb.nlist, rb.pq.M, rb.pq.nbits, rb.bbs, rebuilt.refine_index.d)
          == (base.nlist, base.pq.M, base.pq.nbits, base.bbs, D),
          f"O-a. reverse_index_factory gave {s!r}, which builds {class_tree(rebuilt)}")
    print(f"O-a. reverse_index_factory of phase 4's index: {s!r}; index_factory "
          f"builds {class_tree(rebuilt)} (nlist {rb.nlist}, PQ{rb.pq.M}x{rb.pq.nbits}, "
          f"bbs {rb.bbs})", flush=True)
    del rebuilt, rb

    O_DIR.mkdir(parents=True, exist_ok=True)
    path = O_DIR / "ivf4096_pq32x4fs_rflat.faissindex"
    t0 = time.time()
    ft.write_ref_index(index, str(path))
    t_write = time.time() - t0
    size = path.stat().st_size
    model = NB * (M * NBITS // 8 + 8 + 4 * D) + NLIST * D * 4 + M * (1 << NBITS) * (D // M) * 4
    check(model <= size <= 1.01 * model, f"O-b. the file holds {size} B, the model {model} B")
    torch.cuda.synchronize()
    t0 = time.time()
    back = ft.read_index(str(path), device=dev)
    torch.cuda.synchronize()
    t_read = time.time() - t0
    check(type(back) is type(index) and back.store == "f32"
          and back.base_index.ntotal == NB and back.device == dev,
          f"O-b. read_index gave {class_tree(back)} ({back.store})")
    n_main_knobs(back)
    (Dr, Ir), t_s, peak = m_driven(fused_knn, tally, "O-b. the read index's search",
                                   lambda: back.search(xq, K),
                                   need=("ivf_recon_fused_dyn",))
    k1 = fused_knn.ivf_recon_fused_dyn.launches
    recall = recall_at_k(Ir, gt, K)
    check(recall >= RECALL_MIN, f"O-b. recall@10 {recall:.4f}")
    other = rows_equal_up_to_k1_ties("O-b. the read index's search against phase 5's",
                                     state["D"], state["I"], Dr, Ir)
    print(f"O-b. write_ref_index {size} B ({size / 2**20:.1f} MiB; model "
          f"{model} B: 1M x (16 code + 8 id + 512 float32 refine) + centroids + PQ; "
          f"the rest the FastScan blocks' padding and the records) in "
          f"{t_write:.2f} s; read_index (sniffed) onto the card {t_read:.2f} s, "
          f"{class_tree(back)} with an f32 store; {NQ} q at nprobe {NPROBE} soft, "
          f"k_factor {K_FACTOR}: {t_s * 1e3:.1f} ms, K1 x{k1}, recall@10 "
          f"{recall:.4f} (phase 5 {state['recall']:.4f}), equal to phase 5's on "
          f"{NQ - other} of {NQ} rows (the rest tied at K1's cut), peak "
          f"{peak:.2f} GiB ({CARD})", flush=True)
    return back, path


def o_autotune(ft, back, xq, gt):
    """O-c. ParameterSpace.explore over the read index."""
    ps = ft.ParameterSpace()
    ps.parameter_ranges = [ft.ParameterRange("nprobe", O_NPROBES),
                           ft.ParameterRange("k_factor_rf", O_KFACTORS)]
    crit = ft.OneRecallAtRCriterion(NQ, K)
    crit.set_groundtruth(None, gt)
    t0 = time.time()
    ops = ps.explore(back, xq, crit)
    t_all = time.time() - t0
    perf = {o.key: o.perf for o in ops.all_pts}
    main_key = f"nprobe={NPROBE},k_factor_rf={K_FACTOR}"
    check(perf[main_key] >= RECALL_MIN, f"O-c. {main_key}: 1-recall@10 {perf[main_key]:.4f}")
    n_main_knobs(back)
    print(f"O-c. ParameterSpace.explore of {len(ops.all_pts)} points in {t_all:.1f} s "
          f"({NQ} q each, 1-recall@10 against bench_gt_cache.npz); {main_key}: "
          f"{perf[main_key]:.4f}; optimal: "
          + "; ".join(f"{o.key} {o.perf:.4f} {o.t * 1e3:.1f} ms" for o in ops.optimal_pts)
          + f" ({CARD})", flush=True)


def o_bench(ft, fused_knn, tally, path, xb, xt, xq, gt, dev):
    """O-d. Benchmark over the 1M set: O-b's file and IVF4096,Flat (trained,
    added, saved and reloaded by BenchmarkIO); then SyntheticDataset's
    ground truth through IndexFlat (K2). Returns the reloaded IVF4096,Flat."""
    from faiss_tpu_torch import bench_fw
    from faiss_tpu_torch.utils import datasets as ftds

    ds = bench_fw.DatasetDescriptor(dataset=o_dataset(ftds, xb, xt, xq, gt, dev),
                                    name="bench1M")
    io = bench_fw.BenchmarkIO(str(O_DIR / "bench_io"))
    descs = [bench_fw.IndexDescriptor(path=str(path), search_params={"nprobe": [1, 4, 16]}),
             bench_fw.IndexDescriptor(f"IVF{NLIST},Flat",
                                      search_params={"nprobe": [1, 16]})]
    counts0 = m_counts(fused_knn)
    t0 = time.time()
    out = bench_fw.Benchmark(ds, descs, k=K, io=io, device=dev).run()
    torch.cuda.synchronize()
    t_bench = time.time() - t0
    for name, n in m_counts(fused_knn).items():
        tally[name] = tally.get(name, 0) + n - counts0[name]
    check(Path(io.index_path("bench1M", descs[1])).exists(), "O-d. BenchmarkIO saved nothing")
    ivf = io.load_index("bench1M", descs[1], dev)
    check(type(ivf).__name__ == "IndexIVFFlat" and ivf.ntotal == NB,
          f"O-d. BenchmarkIO reloaded {class_tree(ivf)}")
    rows = "; ".join(
        f"{e['factory'].split('/')[-1]} (train {e['train_s']:.1f} s, add {e['add_s']:.1f} s): "
        + ", ".join(f"{p['params']} recall {p['recall']:.4f} {p['time_s'] * 1e3:.1f} ms"
                    for p in e["points"])
        for e in out["indexes"])
    print(f"O-d. Benchmark over the 1M set in {t_bench:.1f} s: {rows}; "
          f"IVF{NLIST},Flat saved and reloaded by BenchmarkIO ({CARD})", flush=True)

    t0 = time.time()
    syn = ftds.SyntheticDataset(*O_SYN, device=dev)
    t_gen = time.time() - t0
    sxb, sxq = syn.get_database(), syn.get_queries()
    gt100, t_gt, peak = m_driven(fused_knn, tally, "O-d. get_groundtruth(100)",
                                   lambda: syn.get_groundtruth(100),
                                   need=("ivf_recon_fused",), warm=False)
    k2 = fused_knn.ivf_recon_fused.launches
    check(gt100.shape == (O_SYN[3], 100), f"O-d. ground truth of shape {gt100.shape}")
    o_gt64("O-d. SyntheticDataset.get_groundtruth(100)", sxb, sxq, gt100, dev)
    print(f"O-d. SyntheticDataset{O_SYN} drawn in {t_gen:.1f} s; "
          f"get_groundtruth(100) through IndexFlat on the card {t_gt:.2f} s, K2 x{k2}, "
          f"{EXACT_ROWS} rows equal float64 (tie-aware), peak {peak:.2f} GiB ({CARD})",
          flush=True)
    return ivf


def o_exact(ft, fused_knn, tally, ivf, xb, xq, gt, dev):
    """O-e. extra.knn against the cache, knn_ground_truth over the
    dataset's blocks against extra.knn, big_batch_search of O-d's IVF4096,Flat
    against its own search."""
    from faiss_tpu_torch.contrib.big_batch_search import big_batch_search
    from faiss_tpu_torch.contrib.exhaustive_search import knn_ground_truth

    torch.cuda.synchronize()
    t0 = time.time()
    Dk, Ik = ft.knn(xq, xb, K, device=dev)
    t_knn = time.time() - t0
    differ = o_ids_equal("O-e. extra.knn against bench_gt_cache.npz", xb, xq, gt, Ik, dev)
    bs = 1 << 17
    t0 = time.time()
    Dg, Ig = knn_ground_truth(xq, (xb[s : s + bs] for s in range(0, NB, bs)), K,
                              device=dev)
    t_gt = time.time() - t0
    n_equal("O-e. knn_ground_truth against extra.knn", Dg, Ig, Dk, Ik,
            n_tol(xq, float((xb.astype(np.float64) ** 2).sum(1).max())))

    ivf.nprobe = 16
    (Ds, Is), t_own, _ = m_driven(fused_knn, tally, "O-e. the IVF4096,Flat's own search",
                                  lambda: ivf.search(xq, K),
                                  need=(("ivf_recon_fused_dyn", "ivf_recon_fused"),))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    Db, Ib = big_batch_search(ivf, xq, K)
    torch.cuda.synchronize()
    t_bbs = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_equal("O-e. big_batch_search against the index's own search", Db, Ib, Ds, Is,
            n_tol(xq, float((xb.astype(np.float64) ** 2).sum(1).max())))
    d64, ymax = d64_rows(xb, xq, dev)
    got = torch.gather(d64, 1, torch.from_numpy(Ib[:EXACT_ROWS]).to(dev)).cpu().numpy()
    err = float(np.abs(Db[:EXACT_ROWS] - got).max())
    check((np.abs(Db[:EXACT_ROWS] - got)
           <= 1e-5 * ((xq[:EXACT_ROWS].astype(np.float64) ** 2).sum(1) + ymax)[:, None]).all(),
          f"O-e. big_batch_search distances differ from float64 by {err:.3e}")
    del d64
    print(f"O-e. extra.knn ({NQ} q x {NB}) {t_knn:.2f} s, equal to bench_gt_cache.npz "
          f"up to ties ({differ} rows' id sets differ, all within ties); "
          f"knn_ground_truth over {-(-NB // bs)} blocks of {bs} {t_gt:.2f} s, equal to "
          f"extra.knn; big_batch_search of IVF{NLIST},Flat at nprobe 16 {t_bbs:.2f} s "
          f"(peak {peak:.2f} GiB), equal to its own search ({t_own * 1e3:.1f} ms) "
          f"tie-aware, {EXACT_ROWS} rows within 1e-5 of float64 (max err {err:.3e}) "
          f"({CARD})", flush=True)


def o_offline(xb, xt, xq, dev):
    """O-f. OfflineIVF over the 1M set as four .npy files."""
    from faiss_tpu_torch.contrib.offline_ivf import OfflineIVF

    root = O_DIR / "offline"
    root.mkdir(parents=True, exist_ok=True)
    files = []
    for s in range(4):
        np.save(root / f"xb_{s}.npy", xb[s * NB // 4 : (s + 1) * NB // 4])
        files.append(f"xb_{s}.npy")
    np.save(root / "xq.npy", xq)
    cfg = {"d": D, "output": str(root / "out"), "index": f"IVF{NLIST},Flat",
           "nprobe": 16, "k": K, "training_sample": len(xt),
           "datasets": {"db": {"root": str(root), "files": files},
                        "queries": {"root": str(root), "files": ["xq.npy"]}}}
    oivf = OfflineIVF(cfg, device=dev)
    times = {}
    for step, fn in (("train", oivf.train_index), ("shard", oivf.index_shard),
                     ("merge", oivf.merge_index), ("search", oivf.search),
                     ("evaluate", lambda: oivf.evaluate(sample=1000))):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        times[step] = time.time() - t0
    recall = out
    I = np.load(root / "out" / "I.npy")
    check(I.shape == (NQ, K) and (I >= 0).all() and (I < NB).all(),
          "O-f. OfflineIVF's results")
    check(recall >= 0.9, f"O-f. OfflineIVF evaluate: {recall:.4f}")
    size = sum(f.stat().st_size for f in (root / "out").iterdir())
    shutil.rmtree(root)
    print(f"O-f. OfflineIVF (IVF{NLIST},Flat, nprobe 16, k {K}) over four .npy "
          f"files: " + ", ".join(f"{k} {v:.2f} s" for k, v in times.items())
          + f"; intersection@10 against extra.knn on 1000 q {recall:.4f}; "
          f"{size / 2**20:.0f} MiB of outputs ({CARD})", flush=True)


def o_unpatch(ft, torch_utils):
    """Undo torch_utils's patches of the Index tree (its import installs
    them for the whole process; the later phases pass numpy)."""
    def walk(c):
        for name in torch_utils._PATCHED_METHODS:
            fn = c.__dict__.get(name)
            if getattr(fn, "_torch_wrapped", False):
                setattr(c, name, fn.__wrapped__)
        for sub in c.__subclasses__():
            walk(sub)

    walk(ft.Index)


def o_serving(ft, fused_knn, tally, back, xq, dev):
    """O-g. SearchServer / ClientIndex over the read index, search_with_torch
    with query tensors on the card, the C API's example on the card."""
    from faiss_tpu_torch import c_api
    from faiss_tpu_torch.contrib.client_server import ClientIndex, SearchServer

    n_main_knobs(back)
    D0, I0 = back.search(xq, K)
    server = SearchServer(back).start()
    try:
        client = ClientIndex([("127.0.0.1", server.port)])
        check(client.ntotal == NB, f"O-g. the client sees {client.ntotal} rows")
        (Dc, Ic), t_c, _ = m_driven(fused_knn, tally, "O-g. ClientIndex.search",
                                    lambda: client.search(xq, K),
                                    need=("ivf_recon_fused_dyn",), warm=False)
        k1 = fused_knn.ivf_recon_fused_dyn.launches
        client.close()
    finally:
        server.stop()
    other = rows_equal_up_to_k1_ties("O-g. the served search against the direct one",
                                     D0, I0, Dc, Ic)

    from faiss_tpu_torch.contrib import torch_utils

    try:
        xq_t = torch.from_numpy(xq).to(dev)
        Dt, It = torch_utils.search_with_torch(back, xq_t, K)
        Dp, Ip = back.search(xq_t, K)  # the patched method
    finally:
        o_unpatch(ft, torch_utils)
    check(Dt.device == It.device == Dp.device == xq_t.device and It.dtype == torch.int64,
          f"O-g. search_with_torch gave {Dt.device} for queries on {xq_t.device}")
    other_t = rows_equal_up_to_k1_ties("O-g. search_with_torch against the numpy search",
                                       D0, I0, Dt.cpu().numpy(), It.cpu().numpy())
    rows_equal_up_to_k1_ties("O-g. the patched search against the numpy search",
                             D0, I0, Dp.cpu().numpy(), Ip.cpu().numpy())

    t0 = time.time()
    paths = c_api.build()
    t_build = time.time() - t0
    t0 = time.time()
    out = c_api.run_example("cuda")
    t_run = time.time() - t0
    check("device cuda" in out and "C API EXAMPLE: OK" in out, f"O-g. C API: {out}")
    print(f"O-g. SearchServer on localhost over the read index, ClientIndex: "
          f"{NQ} q in {t_c * 1e3:.1f} ms, K1 x{k1}, equal to the direct search on "
          f"{NQ - other} of {NQ} rows (the rest tied at K1's cut); "
          f"search_with_torch with query tensors on {dev}: tensors on {Dt.device}, "
          f"equal on {NQ - other_t} rows; C API built by gcc in {t_build:.2f} s "
          f"({Path(paths['lib']).name}), its example on device cuda in {t_run:.2f} s: "
          f"{out.strip().splitlines()[-1]} ({CARD})", flush=True)


def tools_phases(ft, fused_knn, state, xb, xt, xq, gt, dev):
    """Phase O. Returns the launches of each kernel on O's searches, by the
    name of its entry in the kernels' line."""
    t_all = time.time()
    times, peaks, tally = {}, {}, {}
    index = state["index"]
    n_main_knobs(index)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    stats = ft.MatrixStats(xb)
    n_part(times, peaks, "stats", t0)
    print(f"O. MatrixStats of the database in {times['stats']:.2f} s: "
          + stats.comments.replace("\n", "; "), flush=True)
    t0 = time.time()
    back, path = o_ref_format(ft, fused_knn, tally, state, xq, gt, dev)
    n_part(times, peaks, "O-a/b", t0)
    t0 = time.time()
    o_autotune(ft, back, xq, gt)
    n_part(times, peaks, "O-c", t0)
    t0 = time.time()
    ivf = o_bench(ft, fused_knn, tally, path, xb, xt, xq, gt, dev)
    n_part(times, peaks, "O-d", t0)
    t0 = time.time()
    o_exact(ft, fused_knn, tally, ivf, xb, xq, gt, dev)
    n_part(times, peaks, "O-e", t0)
    del ivf
    torch.cuda.empty_cache()
    t0 = time.time()
    o_offline(xb, xt, xq, dev)
    n_part(times, peaks, "O-f", t0)
    t0 = time.time()
    o_serving(ft, fused_knn, tally, back, xq, dev)
    n_part(times, peaks, "O-g", t0)
    del back
    shutil.rmtree(O_DIR)
    torch.cuda.empty_cache()
    print(f"phase O: {time.time() - t_all:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s / {peaks[k]:.2f} GiB peak"
                      for k, v in times.items())
          + f"); launches {tally} ({CARD})", flush=True)
    return tally


def main():
    # ``--only K`` runs phases 1-3 and phase K alone (the graph indexes and
    # the IMI), ``--only L`` phases 1-3 and phase L (the additive quantizers
    # and RaBitQ), ``--only M`` phases 1-3 and phase M (the extra metrics and
    # the codecs of faiss_tpu's remainder), ``--only N`` phases 1-4 and
    # phase N (the multi-device layer), ``--only O`` phases 1-4 and phase O
    # (faiss_tpu's tools), with no kernels' line
    only = sys.argv[2] if sys.argv[1:2] == ["--only"] and len(sys.argv) == 3 else None
    if sys.argv[1:] and only not in ("K", "L", "M", "N", "O"):
        print("usage: chip_smoke.py [--only K|L|M|N|O]", file=sys.stderr)
        return 2
    only_k = only == "K"
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import faiss_tpu_torch as ft
    from faiss_tpu_torch.ops import fused_knn

    global CARD
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    CARD = card
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, card: {card}; shared-memory lookups "
          f"{lookup_rate():.4g}/s at the max SM clock", flush=True)

    t0 = time.time()
    built = fused_knn.build_all()
    print(f"build of {len(built)} kernels {time.time() - t0:.2f} s", flush=True)
    smem = {
        "ivf_recon_dyn": lambda lib: (f"{lib.ivf_recon_dyn_smem_bytes(1)} (hi/lo), "
                                      f"{lib.ivf_recon_dyn_smem_bytes(0)} (one plane)"),
        "ivf_recon": lambda lib: (f"{lib.ivf_recon_smem_bytes(1)} (hi/lo), "
                                  f"{lib.ivf_recon_smem_bytes(0)} (one plane)"),
        "ivfpq_adc": lambda lib: (f"{lib.ivfpq_adc_smem_bytes(M, 1 << NBITS, 1)} "
                                  f"(K4 and K5, tensor cores), "
                                  f"{lib.ivfpq_adc_smem_bytes(M, 1 << NBITS, 0)} "
                                  "(lookup scan)"),
        "ivfpq_v3": lambda lib: ", ".join(
            f"{lib.ivfpq_v3_smem_bytes(M, 1 << NBITS, i, tc)} ({m}, {how})"
            for i, m in ((0, "bf16"), (1, "int8"))
            for tc, how in ((1, "tensor cores"), (0, "lookup scan"))
        ),
        "recon_floor": lambda lib: f"{lib.recon_floor_smem_bytes(D)}",
        "knn_fused": lambda lib: f"{lib.knn_fused_smem_bytes(D, 128)} (product passes)",
    }
    for name, (lib, report) in built.items():
        print(f"{name}: ptxas " + "; ".join(
            # each instance's template arguments (Lb1E = true), then its
            # stack, spills and registers
            m.group(1) if m else line.split(":", 1)[-1].strip()
            for line in report.splitlines()
            for m in [re.search(r"entry function '\w*?(I(?:L[bi]\d+E)+E)", line)]
            if m or "registers" in line or "spill" in line
        ) + f"; dynamic smem {smem[name](lib)} B/block", flush=True)
    # K3's five kernels (the norms, the two product passes, the two selects)
    report = built["knn_fused"][1]
    k3_regs = re.findall(r"Used (\d+) registers", report)
    check(len(k3_regs) >= 5 and report.count(" 0 bytes spill stores, 0 bytes spill loads")
          == report.count("spill stores"), f"K3's kernels spill: {report}")
    print(f"K3: {len(k3_regs)} kernels, registers {', '.join(k3_regs)}, no spill",
          flush=True)
    # the tensor-core instances (K4's, K5's, K6's two modes, K7's) spill
    # nothing
    tc_regs = {}
    for name, what, pattern in (
            ("ivfpq_adc", "K4", r"adc_mma_kernelILi0E"),
            ("ivfpq_adc", "K5", r"adc_dyn_kernel"),
            ("ivfpq_v3", "K6 bf16", r"adc_mma_kernelILi1E"),
            ("ivfpq_v3", "K6 int8", r"adc_mma_kernelILi2E"),
            ("recon_floor", "K7", r"recon_floor_kernel")):
        lines = built[name][1].splitlines()
        at = next(i for i, line in enumerate(lines) if "entry function" in line
                  and re.search(pattern, line))
        tc = "\n".join(lines[at + 1 : at + 4])
        regs = re.search(r"Used (\d+) registers", tc)
        check(regs is not None and " 0 bytes spill stores, 0 bytes spill loads" in tc,
              f"{what}'s tensor-core kernel spills: {tc}")
        tc_regs[what] = regs.group(1)
    # the wrappers' routes, as the built libraries answer them: the tensor
    # cores for PQ32x4fs and 4-bit rows up to M = 37 (K4, K6 bf16) or 61
    # (K6 int8), the lookup scan for ksub > 16 and for LUT rows beyond a
    # block's shared memory
    routes = {(M, 1 << NBITS): True, (37, 16): True, (38, 16): False,
              (2, 17): False, (M, 256): False}
    got = {s: fused_knn.adc_on_tensor_cores(*s) for s in routes}
    check(got == routes, f"K4's route by (M, ksub) {got}, expected {routes}")
    v3_routes = {(M, 1 << NBITS, False): True, (M, 1 << NBITS, True): True,
                 (37, 16, False): True, (38, 16, False): False,
                 (38, 16, True): True, (61, 16, True): True, (62, 16, True): False,
                 (8, 32, False): False, (8, 32, True): False}
    v3_got = {s: fused_knn.v3_on_tensor_cores(*s) for s in v3_routes}
    check(v3_got == v3_routes,
          f"K6's route by (M, ksub, int8) {v3_got}, expected {v3_routes}")
    print(f"tensor-core instances, no spill: registers {tc_regs}; route by "
          f"(M, ksub), True for the tensor cores: K4 {got}, K6 (M, ksub, int8) "
          f"{v3_got}", flush=True)

    t0 = time.time()
    xb, xt, xq = bench_data()
    with np.load(ROOT / "bench_gt_cache.npz") as z:
        gt = z["gt"]
    print(f"data {time.time() - t0:.2f} s", flush=True)

    dev = torch.device("cuda")
    # phase D's radius: the median 10th-neighbour distance of the first
    # EXACT_ROWS queries, from the ground truth
    radius = float(np.median(((xq[:EXACT_ROWS].astype(np.float64)
                               - xb[gt[:EXACT_ROWS, 9]]) ** 2).sum(1)))
    if only:
        if only_k:
            graph_phases(ft, fused_knn, xb, xt, xq, gt, dev)
            del xb, xt, xq
            deep10m_phases(ft, fused_knn, dev, only_k=True)
        elif only == "M":
            codec_phases(ft, fused_knn, xb, xt, xq, gt, dev)
        elif only in ("N", "O"):
            state = ivfpq_phases(ft, fused_knn, xb, xt, xq, gt, dev, main_only=True)
            (sharded_phases if only == "N" else tools_phases)(
                ft, fused_knn, state, xb, xt, xq, gt, dev)
        else:
            aq_rabitq_phases(ft, fused_knn, xb, xt, xq, gt, dev)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    kernels, k2_ivf, state = ivfpq_phases(ft, fused_knn, xb, xt, xq, gt, dev)
    torch.cuda.empty_cache()
    refine_sq8_phases(ft, fused_knn, state, xb, xt, xq, gt, dev)
    io_phases(ft, fused_knn, state, xq, dev)
    # phase N reuses the index: its list-built layouts go until then
    state["index"].base_index._drop_caches()
    torch.cuda.empty_cache()
    kernels += flat_phases(ft, fused_knn, xb, xq, gt, dev, k2_ivf)
    torch.cuda.empty_cache()
    flat_rest_phases(ft, fused_knn, xb, xq, dev, radius)
    torch.cuda.empty_cache()
    ivfflat, k2_hilo = ivfflat_phases(ft, fused_knn, xb, xt, xq, gt, dev, radius)
    next(e for e in kernels if e["name"] == "ivf_recon_fused")["launches"] += k2_hilo
    kernels += ivfflat
    torch.cuda.empty_cache()
    ivfflat_ip_phase(ft, fused_knn, xb, xt, xq, dev)
    torch.cuda.empty_cache()
    ivfpqr_phase(ft, fused_knn, xb, xt, xq, gt, dev)
    torch.cuda.empty_cache()
    k2_sq, k3_sq = sq_phases(ft, fused_knn, xb, xt, xq, gt, dev)
    next(e for e in kernels if e["name"] == "ivf_recon_fused")["launches"] += k2_sq
    torch.cuda.empty_cache()
    k2_j = pq_hamming_phases(ft, fused_knn, state, xb, xt, xq, gt, dev)
    next(e for e in kernels if e["name"] == "ivf_recon_fused")["launches"] += k2_j
    next(e for e in kernels if e["name"] == "knn_fused[k_lanes=128]")["launches"] += k3_sq
    torch.cuda.empty_cache()
    # K-a's launches in a field of their own: "launches" stays the count
    # of the path that each entry's phase drove
    for name, n in graph_phases(ft, fused_knn, xb, xt, xq, gt, dev).items():
        next(e for e in kernels if e["name"] == name)["k_a_launches"] = n
    torch.cuda.empty_cache()
    aq_rabitq_phases(ft, fused_knn, xb, xt, xq, gt, dev)
    torch.cuda.empty_cache()
    # phase M's launches in a field of their own, as K-a's
    for name, n in codec_phases(ft, fused_knn, xb, xt, xq, gt, dev).items():
        next(e for e in kernels if e["name"] == name)["m_launches"] = n
    torch.cuda.empty_cache()
    # phase N's launches (IndexShards, IndexReplicas) in a field of their own
    for name, n in sharded_phases(ft, fused_knn, state, xb, xt, xq, gt, dev).items():
        next(e for e in kernels if e["name"] == name)["n_launches"] = n
    torch.cuda.empty_cache()
    # phase O's launches (the read index, the benchmark, the served and the
    # ground-truth searches) in a field of their own
    for name, n in tools_phases(ft, fused_knn, state, xb, xt, xq, gt, dev).items():
        next(e for e in kernels if e["name"] == name)["o_launches"] = n
    del xb, xt, xq, state
    torch.cuda.empty_cache()
    kernels.append(deep10m_phases(ft, fused_knn, dev))
    torch.cuda.empty_cache()
    kmeans_row12_phase(ft, fused_knn, dev)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
