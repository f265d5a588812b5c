#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (dfm_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--phases headline,session,...]

``--phases`` takes a comma list of phase groups (all by default, the
acceptance run), which run in this order: dense (phases 37-39), tvl
(24-26), tgen (83-87), sv (31-33), vgen (88-92), headline (2-5), session
(6-8), batched (9-13), fleet (14-18), lowrank (19-23), mf (27-30), pit
(34-36), wide (40-43), bwide (44-49), kbig (50-57), bgen (58-65), sgen
(66-72), qgen (73-82), lgen (93-100), dgen (101-104), assoc (105-109).
The setup, the build and the final lines always run.

Phases, each of which raises (and the script exits non-zero) on failure:

1. setup: the card's name and power limit (nvidia-smi), then the build of
   every CUDA kernel from ``dfm_tpu_torch/csrc`` (one nvcc per source and
   dtype, one a core, niced), started in the
   background with the first groups' sources first (``BUILD_FIRST``): the
   groups run beside it, a kernel's first launch waiting for its own
   library, and after the last group the script waits for every library
   (a failed compile raises) and prints each source's build lines and the
   build's seconds.
2. kernels: every kernel of the three fit paths at the headline shape
   (T = 500, N = 10,000, k = 10), in f64 and f32, against its plain-torch
   version on the same inputs on the card, within a stated relative
   tolerance (in f32 widened by the plain twin's own distance from the
   f64 pipeline, see TOL); timed with CUDA events beside the plain version, a one-call
   library yardstick where one exists, and the least time the card could
   take (bytes over memory rate or operations over peak rate, whichever is
   larger); each kernel also with a cold L2 (flushed before every call),
   K4 and K5a beside their measured latency floor (``csrc/step_chain.cu``:
   one step's dependent chain, once a step).  The steady-state kernels run
   at the tau that ``auto_tau`` picks at the unmasked fit's init and at
   tau = 192; the square-root kernels in every mode, K6/K7 one function at
   a time.  Then the same comparisons, untimed, at k = 1, 3, 10 and 16 on
   a small panel with a fully missing step and a step observing fewer than
   k series (the square-root kernels up to k = 10), K3 with a ridge.
3. fit: ``dfm_tpu_torch.fit`` on a simulated 10,000 x 500, k = 10, AR(1)
   panel with a ragged edge and scattered missing values (filter="auto"
   must resolve to "info"), the same panel fully observed with
   filter="auto" (must resolve to the steady-state engine "ss") and with
   filter="info", and the masked panel with filter="pit_qr" and "pit": 20
   EM iterations with tol = 0 (10 for the unmasked "info" run), the
   reporting smooth and a 12-step forecast.  Logliks must be finite and
   non-decreasing within the f32 noise floor, factors and forecasts
   finite, and every kernel of the path launched (launch counts are reset
   just before each fit), the engine's own kernels every iteration; the
   pit fit's launches exactly (``pit_fit_launches``: 4 K14-el and 2
   K14-scan, K2, K1-wide and K3 an iteration, the info pair once), one
   read a chunk, its EM it/s beside the masked info and pit_qr rates.
4. reference: the same fit at a small size, masked and not (k = 3), and
   through "ss" (150 x 80), "pit_qr" and "pit" (120 x 80, masked), on the
   card in f64 against the CPU in f64 (the plain versions), within 1e-9
   (1e-10 for ss, pit_qr and pit).
5. contract: from one init, 3 EM iterations in f32 and in f64; the f32
   params re-evaluated in f64 must be within 1e-5 relative of the f64
   trajectory's loglik at iteration 3: info masked and unmasked, ss
   unmasked (at the fit's tau), pit_qr and pit masked.
6. ring kernel: K13 (``ring_append``) against its plain twin at
   T_cap = 1,000, N = 10,000, r_max = 8, f32 and f64, bit for bit
   (tolerance 0), for (n_evict, n_new) in (0, 0), (0, 2), (0, 8), (2, 2),
   (8, 8), an append past capacity, and n_evict = 0 twice (the live rows
   must come back bit-identical); timed warm and cold beside the plain
   twin, ``torch.roll`` + ``index_copy_`` and its bound, and at the ring
   session's own shape (T_cap = 480, e = 2).
7. sessions, full width: the masked headline panel's first 480 rows
   fitted with ``fit(fused=True)`` (20 iterations, tol = 0; info, pit_qr
   and pit), then four sessions, each with 4 updates of 2 rows (rows
   480-487, ragged mask) and a re-forecast (no rows), 5 warm EM
   iterations a query: info at
   capacity 1,000, pit_qr at capacity 1,000, an info ring at capacity
   480 (every update evicts 2) and pit at capacity 1,000.  Each query's device work runs
   under ``torch.cuda.set_sync_debug_mode("error")`` and is followed by
   one counted read; K13 must launch exactly once a query, K4 (info), K8
   (pit_qr) or K14-scan (pit) every query.  Synchronized query walls (p50, p99: the
   session's own ``wall_s``, upload to read, and the whole ``update``
   call, host checks and the host mirror included), the
   info query's kernel times at its shapes; after each session's last
   query, every kernel of its path against its plain twin on the
   session's own buffers and params (f32 and f64, the TOL rule; K13 bit
   for bit); then a cold
   ``fit(fused=True, max_iters=5, tol=0, init=...)`` of the live 488 rows
   from the info session's entry params of its last query, and its
   device part alone (``run_fused`` on the panel already on the card).
8. session reference: at 120 x 80, k = 3, a ``standardize=False`` model,
   info and pit ring sessions with 3 updates (the first evicts), on the
   card in f64
   against the same session on the CPU in f64, and against the card's
   cold fused fit of the trailing window from the same start params,
   within 1e-10 relative (nowcast, factors, factor_cov, forecasts,
   logliks).

9. batched kernels: K4b-fwd, K4b-bwd (``csrc/info_scan.cu``), K1b
   (``csrc/quad_local.cu``) and K6b (``csrc/bsolve_rows.cu``, the
   loadings' and A's row solves) against their plain twins at the
   headline shape, f64 and f32 (the TOL rule), timed as in phase 2 (K6b's
   library column: ``cholesky`` + ``cholesky_solve``): 8 restarts, a
   B = 4 Hetero bucket (t_act 500/400/300/250, n_act 10,000/8,000/
   10,000/6,000) and the B = 10 k-grid (k = 1..10 padded to 10); then
   error checks at k = 1 and 16 on 120 x 400 panels.
10. fit_many: ``DFMBatchSpec.restarts(model, Y, 8)`` on the unmasked
   headline panel, 20 iterations, tol = 0, f32: aggregate EM
   iterations/s, beside 8 looped lone ``fit(filter="info")`` runs and one
   lone ``fit`` (auto -> ss) from the same inits and budget; exactly 1
   K4b-fwd, 1 K4b-bwd, 1 K1b and 2 K6b launches an iteration (+1 K4b
   pair for the final smooth), no other kernel, and n_chunks + 1 reads.
11. k-grid: ``select_n_factors_em`` over k = 1..10 (20 iterations): wall,
   its EM part, k_best, the lane logliks.
12. rolling windows: ``oos_evaluate(engine="batched")``, 12 windows of
   400 rows, horizon 1, 10 iterations: wall and the mean rel_rmse.
13. batched reference and contract: ``fit_many`` (3 panels) and a Hetero
   ``run_batched_em`` at 120 x 80, k = 3, card f64 against CPU f64 within
   1e-10; the 1e-5 loglik contract per lane of the 8 restarts in f32.

14. fleet: 8 tenants (six 480 x 10,000 at k = 10, two 400 x 6,000 at
   k = 8; masked panels, 10-iteration fused info fits) in one bucket of
   B = 8 at capacity 1,000, f32, ``max_update_rows`` 2, 5 iterations,
   tol = 0: 2 drains (the first: every tenant 2 rows; the second: 3
   tenants), each
   tick's device part under ``set_sync_debug_mode("error")``, exactly 1
   read and 1 K13b, 6 K2b-m, 6 K4b-fwd, 6 K1b-m, 6 K4b-bwd, 5 K3b-m and
   5 K6b launches a tick and no other kernel, the frozen lanes of an odd
   tick bit-identical; tick wall p50/p99 and queries/s beside the same
   rounds on 8 lone sessions (two lanes, one of each shape, held to
   their lone answers within 5e-3); then every kernel of the tick
   against its plain twin on the bucket's own buffers and params (f64
   and f32, the TOL rule, K13b bit for bit), timed warm and cold.
15. ring fleet: the six 10,000-series tenants with ``ring=True`` at
   capacity 480 (every update evicts 2), 5 drains, lane 0 against a
   lone ring session, the kernels on the bucket's buffers.
16. pit_qr fleet: two tenants with ``filter="pit_qr"``, 3 drains, beside
   lone pit_qr sessions: in f64 each lane equals its lone session within
   1e-9; in f32 the fleet lane and the lone session are each measured
   against that f64 answer, the lane within PIT_F32_TOL of it.
17. fleet k-sweep: small fleets at k = 1, 3 and 16, one drain each, and
   every kernel of the tick against its plain twin.
18. fleet reference: the JAX trio fixture's shapes (10 x 40, 12 x 44,
   12 x 44, k = 2, capacity 56), card f64 against CPU f64 within 1e-12.

19. lowrank kernels: K9-basis (``csrc/lowrank_scan.cu``'s Jacobi
   eigensolve, compared on its projector V V' beside
   ``torch.linalg.eigh``), K9-fwd and K9-bwd against their plain twins on
   the headline masked panel simulated at k = 16 and its unmasked twin,
   rank 8, f64 and f32 (the TOL rule), timed warm and cold with their
   bounds; whether ``torch.linalg.eigh`` on the card synchronizes (it
   raises under ``set_sync_debug_mode("error")``); then error checks at
   (k, r) = (1, 1), (3, 3), (16, 16), (17, 8), (50, 8), (100, 8), (100,
   32) on 120 x 400 panels (statistics from the plain twin above k = 16).
20. lowrank fits: ``fit(filter="lowrank", rank=8)`` masked (20
   iterations) and unmasked (10), tol = 0, EM it/s, exactly 1 K9-basis,
   1 K9-fwd, 1 K9-bwd and 1 K1 an iteration (+1 K2 and 1 K3 masked) and
   the exact info pair once for the reporting smooth; logliks finite,
   each drop past the f32 noise floor one the f64 trajectory from the
   same init makes too (EM at r < k is not monotone); then
   ``fit(fused=True)`` on the first 480 rows.
21. lowrank reference and contract: the lowrank fits (masked, unmasked,
   fused) at 120 x 80, k = 3, rank 2, card f64 against CPU f64 within
   1e-9; f32 params after 2 updates re-evaluated by the f64 lowrank
   filter within 1e-5 of the f64 trajectory (k = 16, rank 8).
22. lowrank session on the fused fit, capacity 1,000, 4 queries of 2
   rows: 1 read, 1 K13 and 6 each of K9-basis, K9-fwd, K9-bwd a query
   under ``set_sync_debug_mode("error")``, p50/p99, the query's kernel
   times, the session's kernels against their plain twins on its buffers.
23. lowrank fleet: 4 tenants of 480 x 10,000 at k = 16 in one bucket at
   capacity 1,000, 2 drains, f64 then f32: 1 read a tick and exactly 1
   K13b, 6 each of K2b-m, K9-basis, K9-fwd, K1b-m and K9-bwd, 5 K3b-m and
   5 K6b; lanes 0 and 1 against lone lowrank sessions (f64, 1e-9, up to
   a lane's first divergence); the tick's kernels on the bucket's
   buffers.

24. TVL kernels: K2-tv (``csrc/obs_stats.cu``), K1-tv
   (``csrc/quad_local.cu``), K11-fwd and K11-bwd (``csrc/tv_loadings.cu``,
   ``csrc/tv_smoother.cu``)
   against their plain twins at S4's full width (T = 300, N = 5,000, k =
   4; ``simulate_tv_loadings`` at walk scale 0.05), unmasked and masked
   (the headline ragged edge and 5% scattered missing), f64 and f32 (the
   TOL rule), timed warm and cold beside the plain twin, a
   ``torch.einsum`` yardstick (K2-tv: C_t; K1-tv: the loadings' fit) and
   the bound; then error checks at k = 1, 8, 9 and 16 on 120 x 400
   panels with a fully missing step and a never-observed series.
25. TVL fits: ``fit(TVLSpec(n_factors=4, n_rounds=20, tol=0.0), Y)`` at
   5,000 x 300, unmasked and masked, f32 in chunks of 8, and a 12-step
   forecast: finite outputs, exactly one read a chunk plus the result's,
   exactly 1 K2-tv, K4-fwd, K1-tv, K4-bwd, K11-fwd and K11-bwd a round
   (+1 K2-tv and K4 pair for the reporting pass), rounds/s and the wall;
   two rounds under ``set_sync_debug_mode("error")``.
26. TVL reference and contract: card f64 against CPU f64 on a 60 x 80,
   k = 3 fit (masked and not) within 1e-9; from one init, 2 rounds in f32
   and f64 at S4, the f32 state re-evaluated by ``tvl_loglik_eval`` in f64
   within 1e-5 of the f64 state's conditional loglik.

27. MF kernels: K12, the wide kernels (K2-wide ``csrc/obs_stats.cu``,
   K4-wide forward and backward ``csrc/info_scan.cu``, K1-wide
   ``csrc/quad_local.cu``, the lone entry points' kernels for 16 < k <=
   32) against their plain twins at S3's full width (the augmented
   loadings of the fit's PCA init, m = 25, T = 300, N = 2,000:
   ``simulate_mixed_freq(1600, 400, 300, 5)`` with 10% ragged missing,
   bench/run.py:54-60), f64 and f32 (the TOL rule), timed warm and cold
   beside the plain twin, the ``einsum`` yardstick (K2-wide: C_t; K1-wide:
   the loadings' fit), the bound and, for the K4-wide pair, the latency
   floor at m = 25; then error checks at k = 17, 20, 25 and 32 on 120 x
   400 panels with a fully missing step and a never-observed series.
28. MF fits: ``fit(MixedFreqSpec(1600, 400, 5), Y, mask=W)`` at S3, f32,
   10 iterations, tol = 0, chunks of 8, ``time_scan="seq"``,
   ``"lowrank"`` (rank 5) and ``"pit"``, and a 12-step forecast: finite
   outputs, exactly one read a chunk plus the result's (3), exactly each
   path kernel's launches an E-step (``MF_ROUTES``) for every iteration
   and the reporting smooth and no other kernel, EM it/s (pit beside
   seq) and the wall; the ``seq`` and ``pit`` iterations' breakdowns
   (kernels at the dtypes the path runs them in: the augmented scans in
   f64) and two iterations under ``set_sync_debug_mode("error")``.
29. MF reference: ``fit(MixedFreqSpec(24, 8, 5))`` at 60 steps (m = 25,
   a fully missing step, a never-observed monthly series), ``seq``,
   ``lowrank`` (rank 4) and ``pit``, card f64 against CPU f64 within 1e-9
   (1e-10 for ``pit``).
30. MF contract: from the PCA init, 2 EM iterations in f32 and f64 at S3
   (``seq``, ``lowrank`` and ``pit``); the f32 params by
   ``mf_loglik_eval(precise=True)`` within 1e-5 of the f64 params'.

31. SV kernels: K10-fwd (``csrc/sv_rbpf.cu``'s RBPF scan, the residual
   form, the fit's; the expanded form on the first 100 steps) and K10-ffbs
   (its backward sampler) against their plain twins at S5's full width
   (``simulate_sv(10000, 1000, 5)`` standardized
   as phase 32's fit saw it, the fit's params, sigma_h and h_0 center, M =
   256, S = 64), on the same draws (made on the host in f64, cast):
   f64 every output through all T steps (ll_rel and the particle history
   within 1e-10, the weight-derived outputs within SV_WEIGHT_TOL's 1e-8;
   the resampling decisions and the gathered particles the same at every
   step), f32 every output before the first step at which the two
   resample differently (a decision flip must sit within the f32
   tolerance of ESS of the threshold; an index flip is reported); K10-ffbs exactly (its outputs
   are copies of h rows), in f32 up to argmax near-ties; each bit for bit
   across two runs; timed warm and cold beside the plain twin, the
   residual stage's two ``torch.matmul`` products (T x one step's) and the
   bound, K10-fwd beside K4's latency floor at k = 5; then the same checks
   at (k, M) = (1, 64), (2, 64), (8, 64), (9, 64), (16, 64), (5, 1), (5,
   512), (5, 1,024) on 60 x 300 panels, and k = 129 must raise
   NotImplementedError naming the ROADMAP row before any launch (k = 17
   and M = 1,025 run on the generic kernels, phases 88-92).
32. SV fit (run before 31, which takes its params): ``fit(SVSpec(
   n_factors=5, n_particles=256), Y, max_iters=1)`` at S5, f32 (the
   pre-fit ``auto`` -> ``ss``, one particle-EM iteration and the final
   E-step) and ``forecast(res, 12)``: finite outputs, sigma_h >= 1e-4,
   exactly one K10-fwd and one K10-ffbs and no other kernel an E-step,
   one read an E-step plus the result's; the fit wall; the filter pass at
   the estimated params (``store_paths=False``): host seconds a pass,
   best of 3 after a warm pass, and passes/s; the K10-fwd pass split by
   ``torch.profiler`` into its residual and step stages and the launch
   gaps; one E-step and its M-step under
   ``set_sync_debug_mode("error")``.
33. SV reference and contract: ``sv_fit`` of ``simulate_sv(40, 120, 2)``,
   M = 64, 2 iterations, card f64 against CPU f64 on the same draws
   within 1e-9; at S5, sigma_h = 0 and h0_scale = 0, the RBPF loglik
   against the exact Kalman loglik (the port's f64 ``loglik_eval``)
   within 1e-9 in f64 and 1e-5 in f32; the matched-draws f32 against f64
   loglik at the fitted sigma_h with both resample counts (not gated).

34. K14 kernels: K14-el (``csrc/pit_elements.cu``: the filter elements,
   the filter assembly, the smoother elements, P_lag) and K14-scan
   (``csrc/pit_scan.cu``: the prefix and the suffix) against their plain
   twins at the masked headline panel, S3's statistics (m = 25) and
   bench/longt.py's largest point (T = 4,000, N = 24, k = 2), f64 and
   f32 (the TOL rule), timed warm and cold beside the plain twin, the
   bound, K4's latency floor at the same (T, k) (the scans), the combines
   in sequence and a one-call yardstick where there is one.
35. K14 sweep: every mode at k = 1, 2, 3, 10, 16, 17, 25, 32 (T = 97)
   and T = 1, 2, 3, 7, 97 (k = 3) on panels with a fully missing step 0
   and a step observing fewer than k series; at k = 33 both entry points
   must route to their generic kernels (phase 67 holds those).
36. long-T: 16-iteration ``info``, ``pit``, ``pit_qr``, ``dense`` and
   ``auto`` (which must resolve to ``dense``) fits at T = 4,000, N = 24,
   k = 2 (f32): their walls.

37. K15 (``csrc/dense_filter.cu``, the dense small-N filter) against its
   plain twin at (T, N, k) = (500, 31, 10) masked (the widest panel
   ``auto`` routes dense), (4,000, 24, 2) (bench/longt.py's largest
   point) and (1,000, 31, 10) masked (a session's capacity), f64 and f32
   (the TOL rule), timed warm and cold beside the plain twin, the bound
   and K4's latency floor at the same (T, k); then error checks at k =
   1, 3, 16, 17, 25, 32 with N in {k, 31, 32} on 40-step panels with
   step 0 fully missing and a step observing fewer than k series; N = 33
   and k = 33 must route to K15-gen (phases 101-104 run it).
38. dense fit: ``fit`` (auto -> dense) on the masked headline panel's
   first 31 series, 20 iterations, tol = 0, f32, the reporting smooth and
   a 12-step forecast: exactly 21 K15, 20 K3 and 21 K4-backward launches
   and no other kernel, one read a chunk; EM it/s, the wall; then
   ``fit(fused=True)`` on its first 480 rows and a dense session on it at
   capacity 1,000 (4 queries of 2 rows, one read and no sync a query,
   p50 and p99); the iteration's breakdown (K15, K4-backward and K3
   against the whole ``em_step``).
39. dense reference: ``fit(auto)`` at 40 x 20, k = 3, masked, and a dense
   ring session (120 x 20), card f64 against CPU f64 within 1e-10.
40. wide kernels: K3-wide (``csrc/mstep_rows.cu``), K5a-wide
   (``csrc/ss_cov_path.cu``) and K5b-wide (``csrc/affine_scan.cu``), the
   kernels the lone wrappers take at 16 < k <= 32, against their plain
   twins on the headline panel simulated at k = 25 (K3 masked, K5 on the
   fully observed twin at the tau ``fit`` picks and at 192), f64 and f32
   (the TOL rule), timed warm and cold beside the plain twin, with the
   bound and K4's latency floor at k = 25; then error checks through
   the wrappers at k = 1, 3, 16, 17, 25, 32 on 120 x 400 panels; at k =
   33 all three must route to their generic kernels (phases 51 and 67
   hold those and the raise at 129).
41. generic-k fits at k = 25 on the headline panel, 20 iterations, tol =
   0, f32: masked ``auto`` (-> info), masked ``pit``, masked ``lowrank``
   (rank 8) and unmasked ``auto`` (-> ss): the wide kernels every
   iteration and no k <= 16 kernel of a wide entry point, one read a
   chunk, EM it/s and the wall; then a masked info session at k = 25
   (capacity 1,000, 3 queries of 2 rows, one read a query).
42. generic-k reference: ``fit`` at 120 x 80, k = 20, masked (auto ->
   info) and unmasked (``filter="ss"``), card f64 against CPU f64 within
   1e-10.
43. contract: the loglik contract of phase 5 for the dense fit (k = 10,
   N = 31) and the k = 25 masked info and unmasked ss fits.
44. batched wide kernels: K4b-wide (both passes, ``csrc/info_scan.cu``),
   K1b-wide (``csrc/quad_local.cu``) and K6b-wide (``csrc/bsolve_rows.cu``,
   the loadings' and A's rows), the batched wrappers' kernels at 16 < k
   <= 32, against their plain twins on the 8-restart ``fit_many`` inputs
   of the unmasked k = 25 panel (B = 8, T = 500, N = 10,000), and the lone
   K4-wide pair alone at (T, k) = (500, 25) on the masked panel, f64 and
   f32 (the TOL rule), timed warm and cold beside the plain twin, the
   bound, K4's latency floor at k = 25 and, for K6b, ``cholesky`` +
   ``cholesky_solve``.
45. batched k-sweep: the batched kernels through their wrappers at k =
   17, 25 and 32 on phase 9's 120 x 400 shapes (the Hetero bucket's
   scan with NaN and inf at its pad steps), the fleet path at k = 17 and
   32 (phase 17's tenants, every kernel of the tick against its twin), and
   at k = 33 all seven wrappers must route to their generic kernels (phase
   59 holds those and the raise at 129).
46. batched paths at k = 25 (f32): ``fit_many`` of 4 restarts of the
   unmasked k = 25 panel (20 iterations, tol = 0) beside 4 looped lone
   info fits; ``select_n_factors_em`` over k = 8, 16, 25, 32 (B = 4
   lanes padded to 32); ``oos_evaluate(engine="batched")``, 6
   windows of 400 rows, 10 iterations: each with n_chunks + 1 reads and
   exactly the wide twins' launches of phases 10-12 (no k <= 16 batched
   kernel).
47. k = 25 fleets: phase 14 on four masked 480 x 10,000 tenants at k =
   25 and two 400 x 6,000 at k = 12 in one info bucket at (1,000, 10,000,
   25), 3 drains (odd drains: tenants 1, 3 and 5), 1 read and exactly
   phase 14's launches (the wide twins) a tick under the sync check, lane
   0 (k = 25) and lane 4 (k = 12, padded across 16) held to their lone
   sessions within 5e-3 (lone sessions of those two only), then the
   tick's kernels on the bucket's buffers (f64 and f32, timed); phase 23 on two 480 x 10,000 tenants at k = 25
   in a lowrank bucket (rank 8, 2 drains, f64 then f32).
48. batched reference at k = 20: ``fit_many`` of 3 panels and a Hetero
   ``run_batched_em`` at 120 x 80, and a 3-tick fleet of a 100 x 40 tenant
   at k = 20 and a 90 x 30 tenant at k = 12, card f64 against CPU f64
   within 1e-12.
49. contract: phase 13's loglik contract for the 8 f32 restarts at k = 25.

50. generic kernels: K2-gen (``csrc/obs_stats.cu``), the K4-gen pair
   (``csrc/info_scan.cu`` on ``csrc/cta_linalg.cuh``), K1-gen
   (``csrc/quad_local.cu``: ``quad_local`` and ``loglik_terms_local``)
   and K3-gen (``csrc/mstep_rows.cu``), the lone kernels past k = 32,
   against their plain twins on the headline panel simulated at k = 50
   and 100 (T = 500, N = 10,000), masked and (K4 forward, K1) unmasked,
   f64 and f32 (the TOL rule), timed warm and cold beside the plain twin, the
   bound, K2-gen's ``einsum`` (C_t) and the K4-gen pair's latency floor.
51. k-sweep: the same at k = 33, 64, 100, 127, 128 on 120 x
   400 panels with a fully missing step, a step observing fewer than k
   series and a never-observed series (K3 with a ridge); k = 129 must
   raise NotImplementedError in every lone entry point before any launch.
52. fits at k > 32: masked ``auto`` (-> info), unmasked ``info`` and
   masked ``lowrank`` (rank 8) at k = 50; unmasked ``info`` and
   ``lowrank`` and masked ``info`` at k = 100; 10 iterations, tol = 0,
   f32: exact launches (the generic kernels, no k <= 32 kernel of
   K1-K4), one read a chunk, logliks within the noise floor (lowrank:
   drops the f64 trajectory makes too), EM it/s and each info fit's
   iteration split into its kernels.
53. kscale's own shape (N = 120, T = 200, k = 50 and 100, 12 iterations):
   the warm fit wall (one run) of exact ``info`` over ``lowrank`` and
   each f32 fit's final-loglik error against the f64 info fit (printed).
54. ``fit(fused=True)`` on the masked k = 50 panel's first 480 rows and an
   info session on it (capacity 1,000, 3 queries of 2 rows, one read a
   query under the sync check).
55. mixed frequency past 32: ``MixedFreqSpec(1600, 400, 7)`` (m = 35)
   ``seq`` at S3's shape, 5 iterations, f32 (exact launches of K2-gen,
   K4-gen and K1-gen an E-step, n_chunks + 1 reads); card f64 against CPU
   f64 on a 24 + 8 series x 60 panel within 1e-9.
56. reference: ``fit`` at 100 x 60, k = 40, masked, ``info`` and
   ``lowrank`` (rank 4), card f64 against CPU f64 within 1e-12.
57. contract: phase 5's loglik contract for the masked info fits at k =
   50 and 100.

58. batched generic kernels: the K4b-gen pair (``csrc/info_scan.cu``),
   K1b-gen and K1b-m-gen (``csrc/quad_local.cu``), K6b-gen
   (``csrc/bsolve_rows.cu``: a factor kernel and a tile solve), K2b-m-gen
   (``csrc/obs_stats.cu``) and K3b-m-gen (``csrc/mstep_rows.cu``), the
   batched wrappers' kernels at 32 < k <= 128, against their plain twins
   at the fit_many shape (B = 4, T = 500, N = 10,000, k = 50: the K4b-gen
   pair, K1b-gen and K6b-gen on the restarts, K4b-gen forward again with
   a ragged t_mask), the tick shape (B = 2, T_cap = 1,000: every kernel
   of an info tick) and k = 100 (B = 2, T = 500: the K4b-gen pair and
   K3b-m-gen), f64 and f32 (the TOL rule), timed warm and cold beside the
   plain twin, the bound, K4's latency floor for the pair and K6b-gen's
   ``cholesky`` + ``cholesky_solve``.
59. batched k-sweep: the same kernels through their wrappers at k = 33,
   50, 64, 100, 128 on 80 x 120 panels (3 restarts, a Hetero bucket with
   NaN and inf at its scan's pad steps, a masked bucket with a fully
   masked step and a never-observed series), f64 and f32; k = 129 must
   raise NotImplementedError in all seven wrappers before any launch.
60. fit_many at k = 50: 4 restarts of the unmasked panel simulated at k =
   50, 10 iterations, tol = 0, f32: aggregate EM it/s beside 2 looped
   lone ``fit(filter="info")`` runs from the same inits, n_chunks + 1
   reads, exactly the generic twins' launches an iteration (no k <= 32
   batched kernel).
61. k-grid: ``select_n_factors_em(ks=(10, 33, 50))``, 3 lanes padded to
   50, 10 iterations; the same launch and read gates.
62. rolling windows: ``oos_evaluate(engine="batched")`` at k = 50, 6
   windows of 400 rows, the seed fit through the default backend
   (``auto`` -> ``ss``: K5a-gen and K5b-gen).
63. fleets past 32: bench/fleet.py's wide-k leg at its own definition
   (``120,200,50x2``, rank 8: the info and lowrank fleet walls and their
   ratio, printed); then phase 14 on two masked 480 x 10,000 tenants at k
   = 50 and one 400 x 6,000 at k = 40 in one info bucket at (1,000,
   10,000, 50), 2 drains, one read and exact launches a tick under the
   sync check, lane 0 held to a lone k = 50 session, the k = 40 tenant's
   padded factors exactly 0 (phase 58 holds the tick's kernels).
64. batched reference at k = 40: ``fit_many`` of 3 panels and a Hetero
   ``run_batched_em`` at 120 x 80, and 3-tick fleets of a 100 x 60 tenant
   at k = 40 and a 90 x 50 tenant at k = 34, info and lowrank (rank 4),
   card f64 against CPU f64 within 1e-12 (the lowrank fleet's
   diffusion-index forecast within ``DI_REF_TOL``, 1e-7).
65. contract: phase 13's loglik contract for the 4 f32 restarts at k =
   50.

66. ss and pit generic kernels: K5a-gen (``csrc/ss_cov_path.cu``: three
   kernels a call, counted as three launches), K5b-gen
   (``csrc/affine_scan.cu``), K14-el-gen (``csrc/pit_elements.cu``, all
   four modes) and K14-scan-gen (``csrc/pit_scan.cu``, prefix and suffix),
   on ``csrc/cta_linalg.cuh`` (LU with partial pivoting by
   ``cta_getrf`` / ``cta_getrs``), against their plain twins on the
   headline panel simulated at k = 50 and 100 (T = 500, N = 10,000; K5a at
   tau = 8, the k = 50 fit's own tau and 192, K5b forward and reverse
   with h = tau on the fully observed panel, K14 on the masked one), f64
   and f32 (the TOL rule), timed warm and cold beside the plain twin, the
   bound, the latency floor and K14-el's one-call yardsticks.
67. ss and pit k-sweep: the same at k = 33, 50, 100, 128 on 97 x 300
   panels (step 0 fully missing, a step observing fewer than k series, a
   never-observed series; K14 also with a static C; K5a at tau = 8 and
   24); k = 129 must raise NotImplementedError naming the ROADMAP row in
   every entry point of the four kernels before any launch.
68. fits past 32: ``fit(Y)`` with the default ``TorchBackend()`` on the
   fully observed panel at k = 50 and 100 (``auto`` -> ``ss``, tau =
   auto_tau(init)) and ``filter="pit"`` on the masked panel at k = 50 and
   100; 10 iterations, tol = 0, f32, a 12-step forecast: exact launches
   (the generic kernels only), one read a chunk, logliks within the noise
   floor, EM it/s beside kbig's info fit at the same k, tau and the freeze
   delta, and each iteration split into its kernels.
69. ``fit(fused=True, filter="pit")`` on the masked k = 50 panel's first
   480 rows and a pit session on it (capacity 1,000, 3 queries of 2 rows,
   one read a query under the sync check, no kernel of a k <= 32 tier).
70. mixed frequency past 32, pit: phase 55 with ``time_scan="pit"``
   (four K14-el-gen, two K14-scan-gen, K2-gen and K1-gen an E-step, in
   f64), its wall beside the ``seq`` fit's; its card f64 fit against the
   CPU's within 1e-9.
71. reference: ``fit`` at 120 x 80, k = 40, ``filter="ss"`` (fully
   observed) and ``"pit"`` (masked), card f64 against CPU f64 within
   1e-12.
72. contract: phase 5's loglik contract at k = 50 for ``ss`` (fully
   observed) and ``pit`` (masked).

73. square-root kernels past 10: qr_elements_gen
   (``csrc/pit_elements.cu``: the filter and smoother elements, both
   assemblies and the six K6/K7 unit ops) and qr_scan_gen
   (``csrc/pit_scan.cu``: the prefix and suffix,
   four kernels a call counted as one launch), the JAX package's generic
   branches (a Gram matrix's jittered Cholesky, triangular solves) on
   ``csrc/cta_linalg.cuh``, against their plain twins on the masked
   headline panel at k = 25, 50 and 100, f64 and f32 (the TOL rule; f32
   timed warm and cold beside the plain twin, the bound and the unit
   ops' one-call yardsticks), and on S3's augmented state (m = 25) in
   f64, timed.
74. square-root k-sweep: every mode at k = 10 (the one-thread kernels
   still launched) and k = 11, 16, 25, 32, 33, 64, 128 on 97 x 300 panels
   (per-step and static C; in f64 also a step observing fewer than k
   series); k = 129 must raise NotImplementedError naming the ROADMAP row
   in every entry point before any launch.
75. ``fit(filter="pit_qr")`` on the masked panel at k = 25 and 50, 10
   iterations, tol = 0, f32: exact launches (4 qr_elements_gen and 2
   qr_scan_gen an iteration), one read a chunk; the stop rule's
   iterations reported (the f32 Gram branch); EM it/s from the E-step and
   M-step beside info and pit at the same k.
76. mixed frequency past 10, pit_qr: ``MixedFreqSpec(1600, 400, 5,
   time_scan="pit_qr")`` at S3 in f64 (m = 25: four qr_elements_gen and
   two qr_scan_gen an E-step), phase 28's checks, EM it/s beside ``seq``
   and ``pit``.
77. its card f64 fit at 60 x 32 against the CPU's within 1e-10.
78. its loglik: f64 2-update error against ``mf_loglik_eval`` on the card
   within 2x the CPU twins' (the 1e-5 limit printed beside); the f32
   E-step finite on the card iff on the CPU.
79. ``fit(fused=True, filter="pit_qr")`` on the masked k = 25 panel's
   first 480 rows and a pit_qr session on it (capacity 1,000, 3 queries
   of 2 rows, one read a query under the sync check).
80. a pit_qr fleet bucket past 10 (k = 12 and 14 tenants), 2 drains,
   lanes held to lone sessions in f64 within 1e-9.
81. reference: ``fit(filter="pit_qr")`` at 120 x 80, k = 40, masked,
   card f64 against CPU f64 within 1e-12.
82. the square-root loglik past 10 at k = 25 and 50 (init and fitted
   params), kernel path and plain twins on the card in f32 and f64,
   against the exact f64 loglik: the kernel path within 2x the twins'.

83. TVL kernels past 16: K2-tv and K1-tv's wide kernels (k = 25) and
   generic ones (k = 50), K11-fwd and K11-bwd's generic kernels
   (``csrc/tv_loadings_gen.cu``: a block a series) against their
   plain twins on S4's panel at k = 25 (5,000 series) and k = 50 (1,000
   series: the plain twins' (T, N, k, k) copies), masked and unmasked
   (K11-bwd, which has no mask, once), f64 and f32 (the masked f32 ones
   timed); then timed alone, masked, at k = 50 on S4's 5,000 series.
84. TVL k-sweep past 16: k = 17, 24, 32, 33, 64, 100 and 128 on 120 x
   400 panels (a fully missing step, a never-observed series): masked and
   unmasked (K11-bwd once), f64 and f32, and K11-bwd-gen again on a
   workspace of 150 series at k = 100 (f64) and 128 (both dtypes), each
   block looping over two or three series; k = 100 and 128 timed in f32
   (masked); at k = 129 every TVL entry point must raise
   NotImplementedError naming the ROADMAP row before any launch.
85. ``fit(TVLSpec(n_factors=k, tol=0))`` at S4 (5,000 x 300), f32,
   chunks of 8, unmasked and masked, 12-step forecast: k = 25 (20
   rounds) and k = 50 (10 rounds); phase 25's checks with the launch
   gates under the routed kernel names, and the round breakdown.
86. TVL reference past 16: card f64 against CPU f64, 6 rounds, at 60 x
   80 with k = 20 and 60 x 90 with k = 40, masked (a fully missing step,
   a never-observed series) and not, within 1e-9.
87. TVL contract at S4 and k = 25: the f32 state after 2 rounds
   re-evaluated in f64 against the f64 state's loglik, < 1e-5 relative.

88. SV fits past 16 and past 1,024 particles: phase 32 at k = 25 and 50
   (S5's panel simulated at that k, M = 256) and on S5 at M = 2,048: one
   K10-fwd-gen and one K10-ffbs-gen (``csrc/sv_gen.cu``) and no other
   kernel an E-step, one read an E-step + 1, the fit wall; at k = 25 the
   pass breakdown by the generic kernel's five stages.
89. SV kernels past 16: K10-fwd-gen (residual form) and K10-ffbs-gen
   against their twins on those three panels at each fit's params, f64
   and f32 on the first 250 steps (phase 31's rules, bit for bit on a
   rerun); K10-fwd-gen timed in f32 on that window (warm and cold, beside
   the twin's time there, the yardstick and the bound) and over all 1,000
   steps, K10-ffbs-gen over all 1,000 beside its twin; the expanded form
   at k = 25 on the first 100 steps.
90. SV sweep: the generic kernels at k = 1, 16, 17, 24, 32, 33, 64, 100,
   128 (M = 64) and (k, M) = (5, 1,025), (17, 1,025), (5, 4,096), (50, 1)
   on 60 x 300 panels, f64 and f32, both forms and FFBS; k = 129 must
   raise NotImplementedError naming the ROADMAP row before any launch.
91. SV reference: ``sv_fit`` card f64 against CPU f64 on the same draws
   within 1e-9 at 60 x 80, k = 20 and 60 x 90, k = 40 (M = 64) and 120 x
   40, k = 3 with M = 1,100.
92. SV contract at k = 25 on S5's panel: phase 33's sigma_h = 0 limit
   (1e-9 in f64, 1e-5 in f32), also against the Kalman filter of Q +
   1e-6 I (the reference's jitter on P_p makes that one exact).

93. rank-r kernels past k = 100 and r = 32: K9-basis-gen (on its
   projector), K9-fwd-gen and K9-bwd-gen (``csrc/gen_filters.cu``) at the
   full width (T = 500, N = 10,000, k = 128) at r = 8, 64 and 128 on the
   masked panel, f64 and f32 against their plain twins (the TOL rule),
   timed beside the twins, the bound, ``torch.linalg.eigh`` and K4's
   latency floor.
94. K9 sweep: (k, r) = (101, 8), (110, 33), (128, 32), (128, 128), (40,
   40) on 120 x 400 panels with a fully missing step, masked and
   unmasked, f64 and f32, each through the generic kernels; k = 129 (r =
   8 and r = 129) must raise NotImplementedError naming the ROADMAP row in
   every entry point before any launch, r > k ValueError.
95. lowrank fits at k = 128 (``kbig_fit_phase``): masked and unmasked at
   rank 8, masked at rank 64, 10 iterations, tol = 0, f32: exactly the
   generic K9 trio, K1-gen (+ K2-gen, K3-gen masked) an iteration and the
   K4-gen pair once, one read a chunk.
96. rank = k exactness: the lowrank loglik at rank = k against the info
   loglik at the same params, f64 on the card, k = 110 and 128 (120 x
   400 masked), within 1e-9 (the JAX package's own gap on the same
   inputs, ``tools/port/lowrank_exact.py``, beside it).
97. a lowrank fused fit at k = 128 (rank 64) on the first 480 rows and a
   session on it at capacity 1,000, 3 queries of 2 rows (2 EM iterations
   a query): one read a query under the sync check, no k <= 32 kernel.
98. a lowrank fleet of a 300-series tenant at k = 110 (160 rows) and a
   250-series tenant at k = 104 (150 rows), rank 40, 3 ticks, card f64
   against CPU f64 (1e-12, the DI forecast DI_REF_TOL) on the ticks before
   a lane's first divergence.
99. the mixed-frequency lowrank route at m = 105 (k = 21, rank 5, 100
   monthly + 20 quarterly series x 180 months), 4 iterations, card f64
   against CPU f64 within 1e-9.
100. the loglik contract of the lowrank engine at k = 128, rank 64
   (masked headline panel at k = 128): < 1e-5, or the JAX package's own
   figure at the same inputs where it misses that (1.50e-5,
   ``tools/port/lowrank_contract.py``).
101. K15-gen (``csrc/gen_filters.cu``) at (T, N, k) = (500, 128, 10) on
   the masked headline panel's first 128 series, f64 and f32 against its
   plain twin, timed beside it, the bound and K4's latency floor.
102. K15-gen sweep at (N, k) = (33, 10), (64, 33), (100, 64), (128, 128),
   (40, 100) on 40-step panels with a fully missing step, f64 and f32; the
   long-T point (N = 24) stays on K15; N = 129 and k = 129 must raise
   before any launch.
103. dense fits (``filter="dense"``) on the masked headline panel's first
   64 and 128 series at k = 10, 20 iterations, tol = 0, f32: exactly 21
   K15-gen, 20 K3 and 21 K4-backward launches, one read a chunk; a dense
   fused fit at N = 128 on the first 480 rows and a session on it at
   capacity 1,000 (3 queries, one read a query under the sync check).
104. dense reference: ``fit(filter="dense")`` at 120 x 40, k = 3 and 100 x
   64, k = 36, masked, card f64 against CPU f64 within 1e-12.
105. the log-depth associative scans (``scan_impl="associative"``):
   K14-assoc (``pit_assoc`` to k = 32, ``pit_assoc_gen`` to 128) and
   K8-assoc (``qr_assoc`` to 10, ``qr_assoc_gen`` to 128), prefix and
   suffix, on the elements of the masked headline panel simulated at k =
   10, 25, 50 and 100, f64 and f32 against their plain twins
   (``ops.scan.associative_scan`` with the torch combines), timed warm and
   cold beside the twin, the bound and K4's step chain over the levels;
   and against the blocked kernel of the tier on the same elements, output
   by output (f64 within 1e-10 relative, or twice the reference's own gap
   between its two scans on that output; the square-root prefix's Z Z',
   0 but for jitter, within T x 1e-10 absolute; both timed).  The bound
   counts the T - 1 combines an inclusive scan needs.
106. the associative sweep: k = 1, 2, 10, 11, 16, 17, 32, 33, 64, 128 at
   T = 1, 2, 3, 64, 65, 257 (a 150-series masked panel), f64, kernel
   against twin; nothing launches at T = 1.
107. the six public functions (``pit_from_stats``, ``pit_filter``,
   ``pit_smoother`` and the ``pit_qr`` three) with
   ``scan_impl="associative"`` at full width on the masked headline panel
   at k = 10 and 100, f64 and f32, at the true params: finite outputs of
   the expected shapes, three launches of the tier's kernel a run, the f64
   loglik within 1e-12 of the JAX package's own, the f32 loglik within
   1e-5 of the exact f64 one or, where the JAX package's own f32 run
   misses that, within 1e-4 x |exact| of its loglik (``ASSOC_LL_JAX``),
   and both scans' filter and smoother walls.
108. the long-T point (T = 4,000, N = 24, k = 2): both engines' filter and
   smoother with either scan, timed side by side.
109. k = 129 raises in both associative scans before any launch; card f64
   against CPU f64 on a 40 x 30 panel at k = 3 within 1e-12.

Output: one JSON line per kernel and dtype, one per fit, contract check,
ring case, session, batched, fleet, TVL, MF, SV, K14, dense, wide, kbig,
bgen, sgen, qgen, tgen, vgen, lgen, dgen and assoc phase, the seconds of
each phase (``step_s``), of each phase group as it ends (with the libraries still
building as it began) and of the script, the build lines, then the
{"kernels": [...]}
summary, the card line and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import inspect
import json
import subprocess
import sys
import time

import numpy as np
import torch

import dfm_tpu_torch as dt
from dfm_tpu_torch import kernels
from dfm_tpu_torch.backends import cpu_ref
from dfm_tpu_torch.estim import batched as tb
from dfm_tpu_torch.estim import em as tem
from dfm_tpu_torch.estim import fused as tfu
from dfm_tpu_torch.estim.em import (EMConfig, em_fit_scan, moments,
                                    mstep_rows, mstep_rows_plain,
                                    noise_floor_for)
from dfm_tpu_torch.estim.fused import FusedOptions, run_fused
from dfm_tpu_torch.estim.init import pca_init_device
from dfm_tpu_torch.models import mixed_freq as mf
from dfm_tpu_torch.models import sv
from dfm_tpu_torch.models import tv_loadings as tv
from dfm_tpu_torch.ops import linalg as la
from dfm_tpu_torch.ops import scan as sc
from dfm_tpu_torch.ops.precision import highest_precision
from dfm_tpu_torch.serve import batched as sb
from dfm_tpu_torch.serve.batched import (ring_evict_append,
                                         ring_evict_append_plain)
from dfm_tpu_torch.ssm import info_filter as inf
from dfm_tpu_torch.ssm import lowrank_filter as lr
from dfm_tpu_torch.ssm import parallel_filter as pf
from dfm_tpu_torch.ssm import steady as ss
from dfm_tpu_torch.ssm.kalman import (kalman_filter, kalman_filter_plain,
                                      rts_smoother, rts_smoother_plain)
from dfm_tpu_torch.ssm.params import FilterResult, SSMParams
from dfm_tpu_torch.utils import data, dgp

T, N, K = 500, 10_000, 10
# H100 SXM, NVIDIA data sheet: HBM rate; FP32 outside the tensor cores
# (TF32 on them is a lower precision than f32), FP64 on the tensor cores
# (the same IEEE f64 type).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
L2_FLUSH_BYTES = 256 * 2**20                   # > 5x the H100's 50 MB L2
COLD_REPS = 2                # cold-L2 calls a timed kernel record
# Relative tolerance of each kernel against its plain version, as
# max|kernel - plain| / max|plain| over each output.  f64: 1e-10 for the
# one-pass reductions, 1e-9 where a solve or a 500-step recursion
# compounds rounding.  f32: the reductions sum 10,000 terms in another
# order (~sqrt(N) eps relative), the solves and recursions amplify by the
# condition of the k x k systems.  nvcc contracts a * b + c into one fma
# where the plain versions round twice, and the scans associate in
# another order (K5b by chunks, K8 by the same blocks as its twin but
# with fma), so the recursions (K4, K5, K8) take 1e-4 in f32 and 1e-9 in
# f64; the per-step square-root algebra (qr_elements, K6/K7) takes 1e-4
# and 1e-10: each step's chain of factorizations and solves amplifies
# rounding by the condition of its k x k systems.
# In f32 each output may differ from its plain twin by the tolerance times
# the twin's largest entry PLUS four times the twin's own distance from
# the f64 pipeline on the same panel (F32_NOISE_MULT): where a function
# cancels, the f32 twin is itself that far from the exact answer, and the
# kernel, which rounds differently, may be as far on the other side (at
# N = 10,000, M = A - P_f C A in K5a and A_t = F - Q W (HH')^{-1} W' F in
# the element build subtract nearly equal terms: P_f C is close to I).
# The f64 tolerances stand alone.
# The batched kernels take their lone twins' tolerances (K4b as K4, K1b and
# K1b-m as K1, K2b-m as K2, K3b-m as K3); K6b, one k x k factorization and
# two triangular solves a row of a well-conditioned moment matrix, 1e-4 /
# 1e-10 as K6.  K13 and K13b move values only: bit for bit.  K9-fwd and
# K9-bwd are recursions (1e-4 / 1e-9, as K4); K9-basis is compared on its
# projector V V', an eigensolve with a gap (1e-4 / 1e-10).  K2-tv and K1-tv
# are one-pass reductions (as K2 and K1); K11-fwd and K11-bwd are T-step
# recursions a series (as K4), K11-bwd with a k x k factorization a step.
# The wide kernels (K12) take their k <= 16 twins' tolerances: K2-wide and
# K1-wide one-pass reductions, the K4-wide pair recursions.  K10-fwd's
# ll_rel and particle history take 1e-10 / 1e-4, its weight-derived
# outputs SV_WEIGHT_TOL (below); K10-ffbs copies h rows: exact (0) but
# for f32 argmax near-ties (``ffbs_compare``).  K14-el, a step's LU
# solves, Cholesky factorizations and products, takes 1e-4 / 1e-10 as
# qr_elements; K14-scan, ~2 sqrt(T) dependent combines with general
# solves, 1e-4 / 1e-9 as the other scans.  K15, a T-step recursion with
# an N x N factorization a step, takes 1e-4 / 1e-9 as K4; the wide K3,
# K5a and K5b, and the batched wide twins (K4b, K1b, K6b, K2b-m, K1b-m,
# K3b-m at 16 < k <= 32), their k <= 16 kernels' tolerances.  The generic
# kernels past 32 (K2-gen, the K4-gen pair, K1-gen, K3-gen) take their
# lone twins' f32 tolerances and 1e-10 in f64 (measured <= 1e-12 at k =
# 33..128 on 120 x 400 panels and at the headline shape); so do their
# batched twins (K4b-gen, K1b-gen, K6b-gen, K2b-m-gen, K1b-m-gen,
# K3b-m-gen), which run the same bodies lane by lane, and K5a-gen, K5b-gen,
# K14-el-gen and K14-scan-gen (measured <= 1.2e-14 in f64 at k = 33..128).
# K5a-gen's freeze diagnostic delta (output 4), a relative change of
# matrices whose entries each carry ~eps rounding, is at rounding level
# once the path has converged (1e-19..1e-16 in f64 on the 97 x 300 sweep
# panels), where any two orders of additions differ by O(1) relatively:
# it takes DELTA_FLOOR_EPS x the dtype's eps on top of the rule.  The
# square-root engine's generic kernels past k = 10 (qr_elements_gen,
# qr_scan_gen: the JAX package's Gram-and-Cholesky branches) take the k <=
# 10 kernels' tolerances.  K2-tv and K1-tv past 16 (wide and generic) take
# the one-pass reductions' 1e-5 / 1e-10, K11's generic kernels (every 16 <
# k <= 128) the recursions' 1e-4 in f32 and the generic kernels' 1e-10 in
# f64.  The rank-r trio's and the dense filter's generic kernels
# (K9-basis-gen, K9-fwd-gen, K9-bwd-gen, K15-gen) take their first
# kernels' f32 tolerances and the generic kernels' 1e-10 in f64.
TOL = {torch.float32: {"quad_local": 1e-5, "obs_stats": 1e-5,
                       "mstep_rows": 1e-4, "info_scan": 1e-4,
                       "rts_smoother": 1e-4, "ss_cov_path": 1e-4,
                       "affine_scan": 1e-4, "qr_elements": 1e-4,
                       "qr_scan": 1e-4, "batched_info_scan": 1e-4,
                       "batched_rts": 1e-4, "batched_quad": 1e-5,
                       "batched_solve_rows": 1e-4, "batched_obs_stats": 1e-5,
                       "batched_quad_masked": 1e-5,
                       "batched_mstep_rows": 1e-4, "lowrank_basis": 1e-4,
                       "lowrank_scan": 1e-4, "lowrank_smoother": 1e-4,
                       "tvl_obs_stats": 1e-5, "tvl_quad": 1e-5,
                       "loading_filter": 1e-4, "loading_smoother": 1e-4,
                       "obs_stats_wide": 1e-5, "quad_local_wide": 1e-5,
                       "info_scan_wide": 1e-4, "rts_smoother_wide": 1e-4,
                       "sv_rbpf": 1e-4, "sv_ffbs": 0.0,
                       "pit_elements": 1e-4, "pit_scan": 1e-4,
                       "dense_filter": 1e-4, "mstep_rows_wide": 1e-4,
                       "ss_cov_path_wide": 1e-4, "affine_scan_wide": 1e-4,
                       "batched_info_scan_wide": 1e-4,
                       "batched_rts_wide": 1e-4, "batched_quad_wide": 1e-5,
                       "batched_quad_masked_wide": 1e-5,
                       "batched_solve_rows_wide": 1e-4,
                       "batched_obs_stats_wide": 1e-5,
                       "batched_mstep_rows_wide": 1e-4,
                       "obs_stats_gen": 1e-5, "quad_local_gen": 1e-5,
                       "info_scan_gen": 1e-4, "rts_smoother_gen": 1e-4,
                       "mstep_rows_gen": 1e-4,
                       "batched_info_scan_gen": 1e-4,
                       "batched_rts_gen": 1e-4, "batched_quad_gen": 1e-5,
                       "batched_quad_masked_gen": 1e-5,
                       "batched_solve_rows_gen": 1e-4,
                       "batched_obs_stats_gen": 1e-5,
                       "batched_mstep_rows_gen": 1e-4,
                       "ss_cov_path_gen": 1e-4, "affine_scan_gen": 1e-4,
                       "pit_elements_gen": 1e-4, "pit_scan_gen": 1e-4,
                       "qr_elements_gen": 1e-4, "qr_scan_gen": 1e-4,
                       "tvl_obs_stats_wide": 1e-5, "tvl_obs_stats_gen": 1e-5,
                       "tvl_quad_wide": 1e-5, "tvl_quad_gen": 1e-5,
                       "loading_filter_gen": 1e-4,
                       "loading_smoother_gen": 1e-4,
                       "lowrank_basis_gen": 1e-4, "lowrank_scan_gen": 1e-4,
                       "lowrank_smoother_gen": 1e-4,
                       "dense_filter_gen": 1e-4, "pit_assoc": 1e-4,
                       "pit_assoc_gen": 1e-4, "qr_assoc": 1e-4,
                       "qr_assoc_gen": 1e-4},
       torch.float64: {"quad_local": 1e-10, "obs_stats": 1e-10,
                       "mstep_rows": 1e-9, "info_scan": 1e-9,
                       "rts_smoother": 1e-9, "ss_cov_path": 1e-9,
                       "affine_scan": 1e-9, "qr_elements": 1e-10,
                       "qr_scan": 1e-9, "batched_info_scan": 1e-9,
                       "batched_rts": 1e-9, "batched_quad": 1e-10,
                       "batched_solve_rows": 1e-10, "batched_obs_stats": 1e-10,
                       "batched_quad_masked": 1e-10,
                       "batched_mstep_rows": 1e-9, "lowrank_basis": 1e-10,
                       "lowrank_scan": 1e-9, "lowrank_smoother": 1e-9,
                       "tvl_obs_stats": 1e-10, "tvl_quad": 1e-10,
                       "loading_filter": 1e-9, "loading_smoother": 1e-9,
                       "obs_stats_wide": 1e-10, "quad_local_wide": 1e-10,
                       "info_scan_wide": 1e-9, "rts_smoother_wide": 1e-9,
                       "sv_rbpf": 1e-10, "sv_ffbs": 0.0,
                       "pit_elements": 1e-10, "pit_scan": 1e-9,
                       "dense_filter": 1e-9, "mstep_rows_wide": 1e-9,
                       "ss_cov_path_wide": 1e-9, "affine_scan_wide": 1e-9,
                       "batched_info_scan_wide": 1e-9,
                       "batched_rts_wide": 1e-9, "batched_quad_wide": 1e-10,
                       "batched_quad_masked_wide": 1e-10,
                       "batched_solve_rows_wide": 1e-10,
                       "batched_obs_stats_wide": 1e-10,
                       "batched_mstep_rows_wide": 1e-9,
                       "obs_stats_gen": 1e-10, "quad_local_gen": 1e-10,
                       "info_scan_gen": 1e-10, "rts_smoother_gen": 1e-10,
                       "mstep_rows_gen": 1e-10,
                       "batched_info_scan_gen": 1e-10,
                       "batched_rts_gen": 1e-10, "batched_quad_gen": 1e-10,
                       "batched_quad_masked_gen": 1e-10,
                       "batched_solve_rows_gen": 1e-10,
                       "batched_obs_stats_gen": 1e-10,
                       "batched_mstep_rows_gen": 1e-10,
                       "ss_cov_path_gen": 1e-10, "affine_scan_gen": 1e-10,
                       "pit_elements_gen": 1e-10, "pit_scan_gen": 1e-10,
                       "qr_elements_gen": 1e-10, "qr_scan_gen": 1e-9,
                       "tvl_obs_stats_wide": 1e-10,
                       "tvl_obs_stats_gen": 1e-10, "tvl_quad_wide": 1e-10,
                       "tvl_quad_gen": 1e-10, "loading_filter_gen": 1e-10,
                       "loading_smoother_gen": 1e-10,
                       "lowrank_basis_gen": 1e-10,
                       "lowrank_scan_gen": 1e-10,
                       "lowrank_smoother_gen": 1e-10,
                       "dense_filter_gen": 1e-10, "pit_assoc": 1e-9,
                       "pit_assoc_gen": 1e-10, "qr_assoc": 1e-9,
                       "qr_assoc_gen": 1e-9}}
# The TPU routine each kernel replaces.
REPLACES = {"quad_local": "dfm_tpu/ssm/info_filter.py:159",
            "obs_stats": "dfm_tpu/ssm/info_filter.py:69",
            "mstep_rows": "dfm_tpu/estim/em.py:163",
            "info_scan": "dfm_tpu/ssm/info_filter.py:104",
            "rts_smoother": "dfm_tpu/ssm/kalman.py:84",
            "ss_cov_path": "dfm_tpu/ssm/steady.py:124",
            "affine_scan": "dfm_tpu/ops/scan.py:39",
            "qr_elements": "dfm_tpu/ssm/parallel_filter.py:293",
            "qr_scan": "dfm_tpu/ops/scan.py:73",
            "ring_append": "dfm_tpu/serve/batched.py:72",
            "batched_info_scan": "dfm_tpu/estim/batched.py:358",
            "batched_rts": "dfm_tpu/estim/batched.py:444",
            "batched_quad": "dfm_tpu/estim/batched.py:409",
            "batched_solve_rows": "dfm_tpu/estim/batched.py:106",
            "batched_ring_append": "dfm_tpu/serve/batched.py:97",
            "batched_obs_stats": "dfm_tpu/estim/batched.py:593",
            "batched_quad_masked": "dfm_tpu/estim/batched.py:650",
            "batched_mstep_rows": "dfm_tpu/estim/batched.py:682",
            "lowrank_basis": "dfm_tpu/ssm/lowrank_filter.py:96",
            "lowrank_scan": "dfm_tpu/ssm/lowrank_filter.py:107",
            "lowrank_smoother": "dfm_tpu/ssm/lowrank_filter.py:207",
            "tvl_obs_stats": "dfm_tpu/models/tv_loadings.py:81",
            "tvl_quad": "dfm_tpu/models/tv_loadings.py:111",
            "loading_filter": "dfm_tpu/models/tv_loadings.py:148",
            "loading_smoother": "dfm_tpu/models/tv_loadings.py:179",
            "obs_stats_wide": "dfm_tpu/models/mixed_freq.py:154",
            "info_scan_wide": "dfm_tpu/models/mixed_freq.py:183",
            "quad_local_wide": "dfm_tpu/models/mixed_freq.py:185",
            "rts_smoother_wide": "dfm_tpu/models/mixed_freq.py:202",
            "sv_rbpf": "dfm_tpu/models/sv.py:103",
            "sv_ffbs": "dfm_tpu/models/sv.py:297",
            "pit_elements": "dfm_tpu/ssm/parallel_filter.py:70",
            "pit_scan": "dfm_tpu/ssm/parallel_filter.py:109",
            "dense_filter": "dfm_tpu/ssm/kalman.py:43",
            "mstep_rows_wide": "dfm_tpu/estim/em.py:163",
            "ss_cov_path_wide": "dfm_tpu/ssm/steady.py:124",
            "affine_scan_wide": "dfm_tpu/ops/scan.py:39",
            "batched_info_scan_wide": "dfm_tpu/estim/batched.py:358",
            "batched_rts_wide": "dfm_tpu/estim/batched.py:444",
            "batched_quad_wide": "dfm_tpu/estim/batched.py:409",
            "batched_quad_masked_wide": "dfm_tpu/estim/batched.py:650",
            "batched_solve_rows_wide": "dfm_tpu/estim/batched.py:106",
            "batched_obs_stats_wide": "dfm_tpu/estim/batched.py:593",
            "batched_mstep_rows_wide": "dfm_tpu/estim/batched.py:682",
            "obs_stats_gen": "dfm_tpu/ssm/info_filter.py:69",
            "info_scan_gen": "dfm_tpu/ssm/info_filter.py:104",
            "rts_smoother_gen": "dfm_tpu/ssm/kalman.py:84",
            "quad_local_gen": "dfm_tpu/ssm/info_filter.py:159",
            "mstep_rows_gen": "dfm_tpu/estim/em.py:163",
            "batched_info_scan_gen": "dfm_tpu/estim/batched.py:358",
            "batched_rts_gen": "dfm_tpu/estim/batched.py:444",
            "batched_quad_gen": "dfm_tpu/estim/batched.py:409",
            "batched_quad_masked_gen": "dfm_tpu/estim/batched.py:650",
            "batched_solve_rows_gen": "dfm_tpu/estim/batched.py:106",
            "batched_obs_stats_gen": "dfm_tpu/estim/batched.py:593",
            "batched_mstep_rows_gen": "dfm_tpu/estim/batched.py:682",
            "ss_cov_path_gen": "dfm_tpu/ssm/steady.py:124",
            "affine_scan_gen": "dfm_tpu/ops/scan.py:39",
            "pit_elements_gen": "dfm_tpu/ssm/parallel_filter.py:70",
            "pit_scan_gen": "dfm_tpu/ssm/parallel_filter.py:109",
            "qr_elements_gen": "dfm_tpu/ssm/parallel_filter.py:293",
            "qr_scan_gen": "dfm_tpu/ops/scan.py:73",
            "tvl_obs_stats_wide": "dfm_tpu/models/tv_loadings.py:81",
            "tvl_obs_stats_gen": "dfm_tpu/models/tv_loadings.py:81",
            "tvl_quad_wide": "dfm_tpu/models/tv_loadings.py:111",
            "tvl_quad_gen": "dfm_tpu/models/tv_loadings.py:111",
            "loading_filter_gen": "dfm_tpu/models/tv_loadings.py:148",
            "loading_smoother_gen": "dfm_tpu/models/tv_loadings.py:179",
            "sv_rbpf_gen": "dfm_tpu/models/sv.py:103",
            "sv_ffbs_gen": "dfm_tpu/models/sv.py:297",
            "lowrank_basis_gen": "dfm_tpu/ssm/lowrank_filter.py:96",
            "lowrank_scan_gen": "dfm_tpu/ssm/lowrank_filter.py:107",
            "lowrank_smoother_gen": "dfm_tpu/ssm/lowrank_filter.py:207",
            "dense_filter_gen": "dfm_tpu/ssm/kalman.py:43",
            "pit_assoc": "dfm_tpu/ssm/parallel_filter.py:161",
            "pit_assoc_gen": "dfm_tpu/ssm/parallel_filter.py:161",
            "qr_assoc": "dfm_tpu/ssm/parallel_filter.py:457",
            "qr_assoc_gen": "dfm_tpu/ssm/parallel_filter.py:457"}
# The variant of each kernel whose f32 record goes into the summary line.
SUMMARY_VARIANT = {"quad_local": "masked", "obs_stats": "masked",
                   "mstep_rows": "masked", "info_scan": "masked",
                   "rts_smoother": "masked", "ss_cov_path": "tau_fit",
                   "affine_scan": "forward tau_fit",
                   "qr_elements": "filter masked",
                   "qr_scan": "filter masked",
                   "batched_info_scan": "restarts", "batched_rts": "restarts",
                   "batched_quad": "restarts",
                   "batched_solve_rows": "restarts Lam rows"}
TAU_MAX = 192
F32_NOISE_MULT = 4.0
DELTA_FLOOR_EPS = 16.0
# Constants of the latency probe's chain: fma x h + c, pivot b - (a/d)^2,
# division by e (csrc/step_chain.cu).
CHAIN_CONSTS = [0.5, 1.0, 1.0, 3.0, 2.0]


def emit(obj) -> None:
    """Print one record.  While the background build runs, a dict record
    carries ``libraries_building`` (the libraries still queued or
    compiling): its host-clock numbers were taken beside nvcc."""
    n = kernels.build_pending()
    if n and isinstance(obj, dict) and "libraries_building" not in obj:
        obj = {**obj, "libraries_building": n}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warm: bool = True) -> float:
    """Milliseconds of one call from CUDA events, after a warm-up (skipped
    when ``warm`` is False: the caller has just run ``fn``): one timed
    call, and unless it took 0.1 s or more (the slow plain twins), the
    mean over a run of back-to-back calls (~0.025 s of work, 3..50
    calls)."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    one = start.elapsed_time(end)
    if one >= 100.0:
        return one
    reps = max(3, min(50, int(25.0 / max(one, 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def plain_ms(c: dict) -> float:
    """The plain twin's milliseconds for case ``c``: the comparison's own
    call when it took 20 ms or more (a slow twin is timed by one call, so
    a second would add little), else ``cuda_ms`` after it."""
    if "plain_events" in c:
        one = c["plain_events"][0].elapsed_time(c["plain_events"][1])
        if one >= 20.0:
            return one
    return cuda_ms(c["plain"], warm=False)


def cuda_ms_cold(fn, reps: int = COLD_REPS, warm: bool = True) -> float:
    """Mean milliseconds of one call with a cold L2: a buffer five times
    the L2 is overwritten before each call, and CUDA events time the call
    alone (after a warm-up unless ``warm`` is False)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    if warm:
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def latency_ms(name: str, dtype, k: int = K, T_: int = T) -> float:
    """Measured latency floor of a K4 pass at (T_, k): the probe runs one
    step's dependent chain T_ times in one thread (csrc/step_chain.cu)."""
    consts = torch.tensor(CHAIN_CONSTS, dtype=dtype, device="cuda")
    out = torch.empty(1, dtype=dtype, device="cuda")
    backward = int(name == "rts_smoother")
    ms = cuda_ms(lambda: kernels.probe("step_chain", dtype, consts, out, T_,
                                       k, backward))
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"latency probe for {name}: non-finite chain")
    return ms


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k4_flops(T_: int, k: int, per_k3: float) -> float:
    """Operations of a K4 pass: ``per_k3`` k^3 + 4 k^2 a step."""
    return T_ * (per_k3 * k ** 3 + 4 * k * k)


def panel(seed: int, T_: int = T, N_: int = N, K_: int = K):
    """Simulated panel (the headline shape by default): (Y with NaN at
    missing, mask, the fully observed Y, true params).  The groups ask for
    the same panels again and again: each is simulated once (``_panel``
    keeps the last few) and handed out as copies, which a phase may
    edit."""
    Ynan, W, Y, p = _panel(seed, T_, N_, K_)
    return (Ynan.copy(), W.copy(), Y.copy(),
            dataclasses.replace(p, **{f.name: np.array(getattr(p, f.name))
                                      for f in dataclasses.fields(p)}))


@functools.lru_cache(maxsize=12)
def _panel(seed: int, T_: int, N_: int, K_: int):
    rng = np.random.default_rng(seed)
    p = dgp.dfm_params(N_, K_, rng)
    Y, _ = dgp.simulate(p, T_, rng)
    W = np.ones((T_, N_))
    ragged = rng.random(N_) < 0.30            # ragged edge: last 12 rows
    W[T_ - 12:, ragged] = 0.0
    W[rng.random((T_, N_)) < 0.05] = 0.0      # 5% scattered
    return np.where(W > 0, Y, np.nan), W, Y, p


def n_combines(T_: int) -> int:
    """Combines of one blocked scan of length T_ (ops.scan.blocked_scan):
    phase 1, phase 2 (B - 2), phase 3 and the remainder."""
    S = sc.default_block_size(T_)
    B = T_ // S
    return (T_ - B) + max(B - 2, 0) + (B - 1) * S + (T_ - B * S)


def case(name, variant, run, plain, ins, flops, library=None, floor=None,
         gram=(), ref=None, abs_floor=None):
    """One kernel comparison: ``ins`` are the tensors the function reads
    (its bytes bound counts each once, and each output once); the outputs
    at ``gram`` are square-root factors compared through X X' (see
    compare); ``ref``, when given, is ``plain_call(plain)`` already made on
    the same inputs (the comparison takes its output instead of a second
    call, ``plain_ms`` its events); ``abs_floor``: {output: absolute
    allowance} added to an output's bound (see TOL)."""
    c = {"name": name, "variant": variant, "run": run, "plain": plain,
         "ins": ins, "flops": float(flops), "library": library,
         "floor": floor, "gram": gram, "ref": None,
         "abs_floor": abs_floor or {}}
    if ref is not None:
        c["ref"], c["plain_events"] = ref
    return c


def plain_call(fn) -> tuple:
    """(``fn()``, the CUDA events around the call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    return out, (start, end)


def ss_inputs(stats, pt, tau: int):
    """The plain steady-state pass at ``tau`` up to the two mean scans:
    (path, forward scan inputs, reverse scan inputs)."""
    path = ss.ss_cov_path_plain(stats.C, pt.A, pt.Q, pt.P0, tau)
    Pf, M, J = path[1], path[2], path[5]
    T_, k = stats.b.shape
    b = stats.b
    x0 = pt.mu0 + Pf[0] @ (b[0] - stats.C @ pt.mu0)
    d = torch.einsum("tkl,tl->tk", ss._freeze(Pf, T_, tau), b).contiguous()
    fwd = (d, M, M[-1].contiguous(), x0)
    x_filt = sc.affine_scan_plain(*fwd)
    x_pred = torch.cat([pt.mu0[None], x_filt[:-1] @ pt.A.T], dim=0)
    Jfull = torch.cat([J[:-1], J[-1].expand(T_ - tau, k, k)], dim=0)
    c = x_filt[:-1] - torch.einsum("tkl,tl->tk", Jfull, x_pred[1:])
    c = torch.cat([c, torch.zeros_like(c[:1])], dim=0).contiguous()
    rev = (c, J[:-1].contiguous(), J[-1].contiguous(),
           x_filt[-1].contiguous())
    return path, fwd, rev


def qr_mgs_flops(T_: int) -> dict:
    """Operations, in units of k^3, of the one-thread square-root kernels
    (k <= 10: modified Gram-Schmidt trias, guarded substitution) on T_
    steps, by case."""
    return {"elements": 21.3 * T_, "prefix": 34.0 * n_combines(T_),
            "assemble": 15.0 * T_, "smoother": 15.0 * T_,
            "suffix": 8.0 * n_combines(T_), "smoother assemble": 4.0 * T_,
            "tria": 4.0}


def qr_gen_flops(T_: int) -> dict:
    """Operations, in units of k^3, of the generic square-root kernels
    past k = 10 on T_ steps, by case, counted from their code
    (csrc/pit_elements.cu, csrc/pit_scan.cu): a k x k product 2, a
    Cholesky 1/3, a triangular solve of k rows 1, a chol_solve 2, a tria
    of [X1 | X2] two products and a Cholesky (13/3; of [X | I] one
    product, 7/3).  Element build: 6 products, 3 Cholesky, 3 solves a
    step (16), the t = 0 posterior 31/3.  Filter combine: 6 products, the
    trias of Theta and Lam (7/3 each) and of U and Z, a k-row chol_solve
    and 2 solves (88/3).  Filter assembly: 5 products, a tria and a
    Cholesky a step (44/3; t = 0 26/3).  Smoother elements: 4 products, a
    chol_solve, a tria and 2 Cholesky (15; the last step 1/3).  Smoother
    combine: 2 products and a tria (25/3).  Smoother assembly: 2 products
    (the first step 1)."""
    return {"elements": 16.0 * (T_ - 1) + 31.0 / 3,
            "prefix": 88.0 / 3 * n_combines(T_),
            "assemble": 44.0 / 3 * (T_ - 1) + 26.0 / 3,
            "smoother": 15.0 * (T_ - 1) + 1.0 / 3,
            "suffix": 25.0 / 3 * n_combines(T_),
            "smoother assemble": 4.0 * T_ - 2.0, "tria": 13.0 / 3}


def qr_cases(stats, pt, label: str, unit: bool = True) -> list:
    """The square-root engine's kernels in every mode, on the elements and
    moments the plain engine makes from ``stats``, each case named by the
    kernel its wrapper routes to at this k (``la.check_qr_k``: past k = 10
    the generic kernels, whose unit ops are the JAX package's generic
    branches).  The operation counts are each kernel's own: past 10 those
    of the generic branches (``qr_gen_flops``), not MGS's."""
    A, Q, mu0, P0 = pt.A, pt.Q, pt.mu0, pt.P0
    T_, k = stats.b.shape
    k3 = k ** 3
    fl = (qr_gen_flops if k > la.QR_UNROLL_K_MAX else qr_mgs_flops)(T_)
    # Each plain pass runs once: its output is the next pass's input and
    # the comparison's reference (``plain_call``; the K8 twin takes
    # seconds at T = 1,000).
    el_ref = plain_call(
        lambda: pf.qr_filter_elements_plain(stats, A, Q, mu0, P0))
    el = tuple(x.contiguous() for x in el_ref[0])
    pref_ref = plain_call(lambda: pf.qr_scan_plain(el))
    pref = tuple(x.contiguous() for x in pref_ref[0])
    asm_ref = plain_call(lambda: pf.qr_filter_assemble_plain(
        pref[1], pref[2], stats.C, A, Q, mu0, P0))
    asm = asm_ref[0]
    kf = FilterResult(asm[0].contiguous(), asm[1].contiguous(), pref[1],
                      asm[2].contiguous(), torch.zeros((), dtype=A.dtype))
    sel_ref = plain_call(lambda: pf.qr_smoother_elements_plain(kf, A, Q))
    (E, g, D), J = sel_ref[0]
    sel = (E.contiguous(), g.contiguous(), D.contiguous())
    J = J.contiguous()
    suf_ref = plain_call(lambda: pf.qr_scan_plain(sel, True))
    suf = tuple(x.contiguous() for x in suf_ref[0])
    cases = [
        case("qr_elements", f"filter {label}",
             lambda: pf.qr_filter_elements(stats, A, Q, mu0, P0),
             lambda: pf.qr_filter_elements_plain(stats, A, Q, mu0, P0),
             (stats.b, stats.C, A, Q, mu0, P0), fl["elements"] * k3, gram=(4,),
             ref=el_ref),
        case("qr_scan", f"filter {label}", lambda: pf.qr_scan(el),
             lambda: pf.qr_scan_plain(el), el, fl["prefix"] * k3,
             ref=pref_ref),
        case("qr_elements", f"assemble filter {label}",
             lambda: pf.qr_filter_assemble(pref[1], pref[2], stats.C, A, Q,
                                           mu0, P0),
             lambda: pf.qr_filter_assemble_plain(pref[1], pref[2], stats.C,
                                                 A, Q, mu0, P0),
             (pref[1], pref[2], stats.C, A, Q, mu0, P0), fl["assemble"] * k3,
             ref=asm_ref),
        case("qr_elements", f"smoother {label}",
             lambda: pf.qr_smoother_elements(kf, A, Q),
             lambda: pf.qr_smoother_elements_plain(kf, A, Q),
             (kf.x_pred, kf.P_pred, kf.x_filt, kf.P_filt, A, Q),
             fl["smoother"] * k3, ref=sel_ref),
        case("qr_scan", f"smoother {label}", lambda: pf.qr_scan(sel, True),
             lambda: pf.qr_scan_plain(sel, True), sel, fl["suffix"] * k3,
             ref=suf_ref),
        case("qr_elements", f"assemble smoother {label}",
             lambda: pf.qr_smoother_assemble(suf[2], J),
             lambda: pf.qr_smoother_assemble_plain(suf[2], J),
             (suf[2], J), fl["smoother assemble"] * k3),
    ]
    for c in cases:
        c["name"] = la.check_qr_k(c["name"], k)
    if not unit:
        return cases
    # K6/K7 one function at a time, on matrices of the path: the
    # predicted covariances (PD), their factors, the observation
    # precisions C_t (rank-deficient where a step observes < k series),
    # the [A U_f | Lq] blocks of the predicted factors.
    Pp = kf.P_pred
    L = torch.linalg.cholesky(Pp).contiguous()    # LAPACK gives column-major
    Bm = (A @ kf.P_filt).contiguous()
    C_t = (stats.C if stats.C.ndim == 3
           else stats.C.expand(T_, k, k)).contiguous()
    blk = torch.cat([A @ pref[2], la.psd_factor(Q).expand(T_, k, k)],
                    dim=-1).contiguous()
    jit_eye = la.default_jitter(A.dtype) * torch.eye(k, dtype=A.dtype,
                                                     device=A.device)
    unit_ops = (
        ("chol", Pp, None, k3 / 3, lambda: torch.linalg.cholesky(Pp)),
        ("chol_solve", L, Bm, 2.0 * k3,
         lambda: torch.cholesky_solve(Bm, L)),
        ("tria", blk, None, fl["tria"] * k3,
         (lambda: torch.linalg.qr(blk.transpose(-1, -2)))
         if k <= la.QR_UNROLL_K_MAX else
         (lambda: torch.linalg.cholesky_ex(torch.baddbmm(
             jit_eye, blk, blk.transpose(-1, -2))))),
        ("tri_solve", L, Bm, 1.0 * k3,
         lambda: torch.linalg.solve_triangular(L, Bm, upper=False)),
        ("tri_solve_trans", L, Bm, 1.0 * k3,
         lambda: torch.linalg.solve_triangular(L.transpose(-1, -2), Bm,
                                               upper=True)),
        ("psd_factor", C_t, None, k3 / 3,
         None if k <= la.QR_UNROLL_K_MAX else
         lambda: torch.linalg.cholesky_ex(C_t + jit_eye)),
    )
    for op, X, B, fl, lib in unit_ops:
        cases.append(case(
            la.check_qr_k("qr_elements", k), op,
            lambda op=op, X=X, B=B: la.small_linalg(op, X, B),
            lambda op=op, X=X, B=B: la.SMALL_LINALG_OPS[op][1](X, B),
            (X,) if B is None else (X, B), T_ * fl, library=lib,
            gram=(0,) if op == "psd_factor" else ()))
    return cases


def masked_cases(Yt, mt, pt, label: str = "masked",
                 lam_ridge=None) -> tuple:
    """K1-K4 on a masked panel already on the card, on inputs the plain
    pipeline makes from it (K3 with ``lam_ridge`` when given), each case
    named by the kernel its wrapper routes to at this k: (cases, the plain
    observation stats).  Call under ``highest_precision()``."""
    dtype = Yt.dtype
    T_, N_ = Yt.shape
    k = pt.A.shape[0]
    TN, k2, k3 = T_ * N_, k * k, k ** 3
    stats = inf.obs_stats_plain(Yt, pt.Lam, pt.R, mt)
    scan = inf.info_scan_plain(stats, pt.A, pt.Q, pt.mu0, pt.P0)
    kf = FilterResult(*scan[:4], torch.zeros((), dtype=dtype))
    sm = rts_smoother_plain(kf, pt)
    EffT, _ = moments(sm)
    scan_in = (stats.b, stats.C, pt.A, pt.Q, pt.mu0, pt.P0)
    cases = [
        case(kernels.route("obs_stats", k), label,
             lambda: inf.obs_stats(Yt, pt.Lam, pt.R, mt),
             lambda: inf.obs_stats_plain(Yt, pt.Lam, pt.R, mt),
             (Yt, pt.Lam, pt.R, mt), TN * (2 * k + k * (k + 1) + 6),
             library=lambda: torch.einsum("nk,tn,n,nl->tkl", pt.Lam, mt,
                                          1.0 / pt.R, pt.Lam)),
        case(kernels.route("info_scan", k), label,
             lambda: inf.info_scan(stats, pt.A, pt.Q, pt.mu0, pt.P0),
             lambda: inf.info_scan_plain(stats, pt.A, pt.Q, pt.mu0, pt.P0),
             scan_in, T_ * (12.67 * k3 + 4 * k2),
             floor=lambda: latency_ms("info_scan", dtype, k, T_)),
        case(kernels.route("quad_local", k), label,
             lambda: inf.quad_local(Yt, pt.Lam, pt.R, scan[0], mt),
             lambda: inf.quad_local_plain(Yt, pt.Lam, pt.R, scan[0], mt),
             (Yt, pt.Lam, pt.R, scan[0], mt), TN * (2 * k + 5)),
        case(kernels.route("rts_smoother", k), label,
             lambda: rts_smoother(kf, pt),
             lambda: rts_smoother_plain(kf, pt),
             (kf.x_pred, kf.P_pred, kf.x_filt, kf.P_filt, pt.A),
             T_ * (10.33 * k3 + 4 * k2),
             floor=lambda: latency_ms("rts_smoother", dtype, k, T_)),
        case(kernels.route("mstep_rows", k), label,
             lambda: mstep_rows(Yt, mt, sm.x_sm, EffT, sm.P_sm, None, 1e-6,
                                lam_ridge=lam_ridge),
             lambda: mstep_rows_plain(Yt, mt, sm.x_sm, EffT, sm.P_sm, 1e-6,
                                      lam_ridge),
             (Yt, mt, sm.x_sm, EffT, sm.P_sm),
             TN * (4 * k + 2 * k * (k + 1) + 5) + N_ * (k3 // 3 + 6 * k2)),
    ]
    return cases, stats


def kernel_cases(Ynan, W, Yfull, p, dtype, taus=(), lam_ridge=None,
                 qr=True, unit=True) -> list:
    """Every kernel of the fit paths on inputs the plain pipeline makes
    from this panel on the card: K1-K4 (K3 with ``lam_ridge`` when given),
    K5a/K5b at each (label, tau) of ``taus``, and the square-root kernels
    when ``qr``.  Call under ``highest_precision()``."""
    dev = torch.device("cuda")
    Yt = torch.as_tensor(Ynan, dtype=dtype, device=dev).contiguous()
    Yf = torch.as_tensor(Yfull, dtype=dtype, device=dev).contiguous()
    mt = torch.as_tensor(W, dtype=dtype, device=dev).contiguous()
    pt = SSMParams.from_numpy(p, dtype=dtype, device=dev)
    T_, N_ = Yt.shape
    k = pt.A.shape[0]
    TN, k2, k3 = T_ * N_, k * k, k ** 3
    cases, stats = masked_cases(Yt, mt, pt, lam_ridge=lam_ridge)
    ustats = inf.obs_stats_plain(Yf, pt.Lam, pt.R)
    uscan = inf.info_scan_plain(ustats, pt.A, pt.Q, pt.mu0, pt.P0)
    uscan_in = (ustats.b, ustats.C, pt.A, pt.Q, pt.mu0, pt.P0)
    cases += [
        case("info_scan", "unmasked",
             lambda: inf.info_scan(ustats, pt.A, pt.Q, pt.mu0, pt.P0),
             lambda: inf.info_scan_plain(ustats, pt.A, pt.Q, pt.mu0, pt.P0),
             uscan_in, T_ * (12.67 * k3 + 4 * k2),
             floor=lambda: latency_ms("info_scan", dtype, k, T_)),
        case("quad_local", "unmasked",
             lambda: inf.quad_local(Yf, pt.Lam, pt.R, uscan[0]),
             lambda: inf.quad_local_plain(Yf, pt.Lam, pt.R, uscan[0]),
             (Yf, pt.Lam, pt.R, uscan[0]), TN * (2 * k + 5)),
    ]
    for label, tau in taus:
        path, fwd, rev = ss_inputs(ustats, pt, tau)
        C = ustats.C
        cases += [
            case("ss_cov_path", label,
                 lambda tau=tau: ss.ss_cov_path(C, pt.A, pt.Q, pt.P0, tau),
                 lambda tau=tau: ss.ss_cov_path_plain(C, pt.A, pt.Q, pt.P0,
                                                      tau),
                 (C, pt.A, pt.Q, pt.P0), tau * 27.0 * k3,
                 floor=lambda tau=tau: (
                     latency_ms("info_scan", dtype, k, tau)
                     + latency_ms("rts_smoother", dtype, k, 2 * tau + 1))),
            case("affine_scan", f"forward {label}",
                 lambda fwd=fwd: sc.affine_scan(*fwd),
                 lambda fwd=fwd: sc.affine_scan_plain(*fwd), fwd,
                 2.0 * T_ * k2),
            case("affine_scan", f"reverse {label}",
                 lambda rev=rev: sc.affine_scan(*rev, reverse=True),
                 lambda rev=rev: sc.affine_scan_plain(*rev, reverse=True),
                 rev, 2.0 * T_ * k2),
        ]
    if qr:
        cases += qr_cases(stats, pt, "masked", unit)
    return cases


def as_tuple(x) -> tuple:
    """The tensors of a (nested) result, flattened."""
    if isinstance(x, (tuple, list)):
        return tuple(t for v in x for t in as_tuple(v))
    return (x,)


def compare(c: dict, dtype, ref64=None) -> tuple:
    """(max abs error, max over outputs of max|err| / max|plain|, tol, the
    plain outputs, the plain f32 twin's largest distance from ``ref64``
    relative to max|plain|) of the kernel against its plain version; an
    output with an ``abs_floor`` is left out of the first two and its
    abs error kept in ``c["floored_abs_err"]``.
    ``ref64``: the f64 pipeline's plain outputs for this case (f32 only,
    see TOL).  Raises on a non-finite kernel output or past the
    tolerance."""
    got = as_tuple(c["run"]())
    if c["ref"] is not None:
        ref = as_tuple(c["ref"])
    else:
        out, c["plain_events"] = plain_call(c["plain"])
        ref = as_tuple(out)
    torch.cuda.synchronize()
    tol = TOL[dtype][c["name"]]
    abs_err = rel_err = plain_err = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{c['name']} ({c['variant']}): non-finite "
                                 "kernel output")
        g, r = g.double(), r.double()
        r64 = ref64[i].double() if ref64 is not None else None
        if i in c["gram"]:
            # A guarded factor of a rank-deficient matrix (psd_factor of
            # C_t at a step observing < k series) has a last pivot of
            # rounding noise, which the kernel (fma) and its twin may
            # keep or zero: factors differing by sqrt(noise) in a null
            # direction, with the same X X', which is all the element
            # algebra uses (J = Z Z').
            g, r = (x @ x.transpose(-1, -2) for x in (g, r))
            r64 = r64 @ r64.transpose(-1, -2) if r64 is not None else None
        e = float((g - r).abs().max())
        scale = max(float(r.abs().max()), 1e-300)
        noise = float((r - r64).abs().max()) if r64 is not None else 0.0
        flo = c["abs_floor"].get(i, 0.0)
        if not e <= tol * scale + F32_NOISE_MULT * noise + flo:
            raise AssertionError(
                f"{c['name']} ({dtype}, {c['variant']}), output {i}: "
                f"max|kernel - plain| {e:.3e} > {tol:.0e} x max|plain| "
                f"{scale:.3e} + {F32_NOISE_MULT} x max|plain - plain_f64| "
                f"{noise:.3e} + {flo:.1e}")
        if flo:
            # Reported apart: a rounding-level output's relative error
            # says nothing of the kernel (see TOL).
            c.setdefault("floored_abs_err", {})[i] = e
            continue
        abs_err = max(abs_err, e)
        if e / scale > rel_err or i == 0:
            c["worst_output"] = i        # the output at max_rel_err
        rel_err = max(rel_err, e / scale)
        plain_err = max(plain_err, noise / scale)
    return abs_err, rel_err, tol, ref, plain_err


def nbytes_of(tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def fit_tau(seed: int, k: int = K, offset: int = 1) -> int:
    """The tau that ``fit`` picks for the unmasked headline panel (its
    init, then ``auto_tau``; the panel simulated at k factors from seed +
    ``offset``): a fit with no EM iteration reports it."""
    _, _, Yfull, _ = panel(seed + offset, K_=k)
    model = dt.DynamicFactorModel(n_factors=k, dynamics="ar1")
    res = dt.fit(model, Yfull, backend=dt.TorchBackend(), max_iters=0)
    if res.filter != "ss":
        raise AssertionError(f"unmasked headline fit resolved to "
                             f"{res.filter!r}, expected 'ss'")
    return res.tau


def kernel_record(c: dict, dtype, refs: dict, timed=None) -> dict:
    """One case compared (``compare``, the f64 plain outputs kept in
    ``refs`` as the f32 yardstick) and, when ``timed`` (default: f32, the
    dtype of every path but the mixed-frequency augmented scans, whose
    phases pass it), timed: warm and cold L2, the plain twin, the library
    call, the latency floor; the bound always.  An untimed record has
    None for each time."""
    name = c["name"]
    key = (name, c["variant"])
    n0 = kernels.LAUNCHES[name]
    abs_err, rel_err, tol, ref, plain_err = compare(c, dtype, refs.get(key))
    if dtype == torch.float64:
        refs[key] = ref
    bound_ms, bound_by = bound(nbytes_of(c["ins"]) + nbytes_of(ref),
                               c["flops"], dtype)
    if timed is None:
        timed = dtype == torch.float32
    return {"name": name, "variant": c["variant"],
            "dtype": str(dtype).replace("torch.", ""),
            "max_rel_err": rel_err, "max_abs_err": abs_err, "tol": tol,
            "plain_f32_err": plain_err,
            "kernel_ms": cuda_ms(c["run"], warm=False) if timed else None,
            "kernel_ms_cold_l2": cuda_ms_cold(
                c["run"], c.get("cold_reps", COLD_REPS), False)
            if timed else None,
            "plain_ms": plain_ms(c) if timed else None,
            "library_ms": cuda_ms(c["library"]) if timed and c["library"]
            else None,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "latency_ms": c["floor"]() if timed and c["floor"] else None,
            "launches": kernels.LAUNCHES[name] - n0,
            **({"floored_abs_err": c["floored_abs_err"]}
               if "floored_abs_err" in c else {})}


def kernel_phase(seed: int, tau_fit: int) -> dict:
    """Every kernel vs its plain version at the headline shape, f32 and
    f64, timed.  Returns the f32 summary records by kernel name."""
    pan = panel(seed)
    taus = [("tau_fit", tau_fit), (f"tau={TAU_MAX}", TAU_MAX)]
    summary = {}
    refs = {}               # f64 plain outputs, the f32 yardstick
    for dtype in (torch.float64, torch.float32):
        with highest_precision():
            for c in kernel_cases(*pan, dtype, taus=taus):
                rec = kernel_record(c, dtype, refs)
                name = c["name"]
                if name in ("ss_cov_path", "affine_scan"):
                    rec["tau"] = dict(taus)[c["variant"].split()[-1]]
                emit(rec)
                if (dtype == torch.float32
                        and c["variant"] == SUMMARY_VARIANT[name]):
                    summary[name] = rec
        torch.cuda.empty_cache()
    return summary


def k_sweep(seed: int) -> None:
    """Every kernel at other factor counts (k = 1 and 16, the ends of the
    kernels' compile-time dispatch, 3, and 10, the square-root kernels'
    end) on a 120 x 400 panel with a fully missing step and a step that
    observes fewer than k series, f32 and f64, K3 with a loading ridge,
    the steady-state kernels at tau = 24, the square-root kernels up to
    k = 10: error checks only."""
    for k in (1, 3, 10, 16):
        _, W, Yfull, p = panel(seed + 2, T_=120, N_=400, K_=k)
        W[7] = 0.0
        W[11] = 0.0
        W[11, :k - 1] = 1.0
        Ynan = np.where(W > 0, Yfull, np.nan)
        refs = {}
        for dtype in (torch.float64, torch.float32):
            worst = {}
            with highest_precision():
                for c in kernel_cases(Ynan, W, Yfull, p, dtype,
                                      taus=[("tau=24", 24)], lam_ridge=0.5,
                                      qr=k <= la.QR_UNROLL_K_MAX):
                    key = (c["name"], c["variant"])
                    _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                    refs[key] = ref
                    worst[c["name"]] = max(worst.get(c["name"], 0.0), rel)
            emit({"k_sweep": k, "dtype": str(dtype).replace("torch.", ""),
                  "max_rel_err": worst})


# Per fit: (label, masked, filter asked, engine it must resolve to, EM
# iterations, kernels that must launch, kernels that must launch every
# iteration).
FITS = (
    ("masked", True, "auto", "info", 20,
     ("quad_local", "obs_stats", "mstep_rows", "info_scan", "rts_smoother"),
     ("quad_local", "obs_stats", "mstep_rows", "info_scan",
      "rts_smoother")),
    ("unmasked ss", False, "auto", "ss", 20,
     ("ss_cov_path", "affine_scan", "quad_local", "info_scan",
      "rts_smoother"),
     ("ss_cov_path", "affine_scan")),
    ("masked pit_qr", True, "pit_qr", "pit_qr", 20,
     ("qr_elements", "qr_scan", "obs_stats", "quad_local", "mstep_rows",
      "info_scan", "rts_smoother"),
     ("qr_elements", "qr_scan", "obs_stats", "quad_local", "mstep_rows")),
    ("unmasked info", False, "info", "info", 10,
     ("quad_local", "info_scan", "rts_smoother"),
     ("quad_local", "info_scan", "rts_smoother")),
    ("masked pit", True, "pit", "pit", 20,
     ("pit_elements", "pit_scan", "obs_stats", "quad_local_wide",
      "mstep_rows", "info_scan", "rts_smoother"),
     ("pit_elements", "pit_scan", "obs_stats", "quad_local_wide",
      "mstep_rows")),
)
# The masked pit fit's launches, exactly: a K14 E-step is four
# pit_elements (elements, assembly, smoother elements, P_lag) and two
# pit_scan (prefix, suffix); K2, K1-wide (``loglik_terms_local``) and K3
# once an iteration; the info pair once for the reporting smooth.
PIT_PER_ITER = {"pit_elements": 4, "pit_scan": 2}


def pit_fit_launches(iters: int) -> dict:
    return {"pit_elements": 4 * iters, "pit_scan": 2 * iters,
            "obs_stats": iters + 1, "quad_local_wide": iters,
            "mstep_rows": iters, "quad_local": 1, "info_scan": 1,
            "rts_smoother": 1}


# EM it/s of each headline fit by label (fit_phase fills it).
RATES: dict = {}
# The fit whose launch counts the summary line reports for each kernel:
# the path that kernel serves.
OWN_FIT = {"quad_local": "masked", "obs_stats": "masked",
           "mstep_rows": "masked", "info_scan": "masked",
           "rts_smoother": "masked", "ss_cov_path": "unmasked ss",
           "affine_scan": "unmasked ss", "qr_elements": "masked pit_qr",
           "qr_scan": "masked pit_qr", "ring_append": "info",
           "batched_info_scan": "fit_many", "batched_rts": "fit_many",
           "batched_quad": "fit_many", "batched_solve_rows": "fit_many",
           "batched_ring_append": "fleet", "batched_obs_stats": "fleet",
           "batched_quad_masked": "fleet", "batched_mstep_rows": "fleet",
           "lowrank_basis": "lowrank masked",
           "lowrank_scan": "lowrank masked",
           "lowrank_smoother": "lowrank masked",
           "tvl_obs_stats": "tvl unmasked", "tvl_quad": "tvl unmasked",
           "loading_filter": "tvl unmasked",
           "loading_smoother": "tvl unmasked",
           "obs_stats_wide": "mf seq", "info_scan_wide": "mf seq",
           "quad_local_wide": "mf seq", "rts_smoother_wide": "mf seq",
           "sv_rbpf": "sv fit", "sv_ffbs": "sv fit",
           "pit_elements": "masked pit", "pit_scan": "masked pit",
           "dense_filter": "dense", "mstep_rows_wide": "k25 masked auto",
           "ss_cov_path_wide": "k25 unmasked auto",
           "affine_scan_wide": "k25 unmasked auto",
           "batched_info_scan_wide": "fit_many k25",
           "batched_rts_wide": "fit_many k25",
           "batched_quad_wide": "fit_many k25",
           "batched_solve_rows_wide": "fit_many k25",
           "batched_obs_stats_wide": "fleet k25",
           "batched_quad_masked_wide": "fleet k25",
           "batched_mstep_rows_wide": "fleet k25",
           "obs_stats_gen": "k100 masked info",
           "info_scan_gen": "k100 masked info",
           "rts_smoother_gen": "k100 masked info",
           "quad_local_gen": "k100 masked info",
           "mstep_rows_gen": "k100 masked info",
           "batched_info_scan_gen": "fit_many k50",
           "batched_rts_gen": "fit_many k50",
           "batched_quad_gen": "fit_many k50",
           "batched_solve_rows_gen": "fit_many k50",
           "batched_obs_stats_gen": "fleet k50",
           "batched_quad_masked_gen": "fleet k50",
           "batched_mstep_rows_gen": "fleet k50",
           "ss_cov_path_gen": "k100 unmasked auto",
           "affine_scan_gen": "k100 unmasked auto",
           "pit_elements_gen": "k100 masked pit",
           "pit_scan_gen": "k100 masked pit",
           "qr_elements_gen": "k50 masked pit_qr",
           "qr_scan_gen": "k50 masked pit_qr",
           "tvl_obs_stats_wide": "tvl k25 masked",
           "tvl_quad_wide": "tvl k25 masked",
           "loading_filter_gen": "tvl k25 masked",
           "loading_smoother_gen": "tvl k25 masked",
           "tvl_obs_stats_gen": "tvl k50 masked",
           "tvl_quad_gen": "tvl k50 masked",
           "sv_rbpf_gen": "sv k25 fit", "sv_ffbs_gen": "sv k25 fit",
           "lowrank_basis_gen": "k128 masked lowrank r8",
           "lowrank_scan_gen": "k128 masked lowrank r8",
           "lowrank_smoother_gen": "k128 masked lowrank r8",
           "dense_filter_gen": "dense N128",
           "pit_assoc": "assoc pit k10", "qr_assoc": "assoc pit_qr k10",
           "pit_assoc_gen": "assoc pit k100",
           "qr_assoc_gen": "assoc pit_qr k100"}


def fit_phase(seed: int) -> dict:
    """The headline fits; returns each fit's launch counts by label."""
    Ynan, _, Yfull, _ = panel(seed + 1)
    model = dt.DynamicFactorModel(n_factors=K, dynamics="ar1")
    counts = {}
    for label, masked, flt, engine, iters, need, every in FITS:
        Y = Ynan if masked else Yfull
        backend = dt.TorchBackend(filter=flt)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with ReadWatch() as rw:
            t0 = time.perf_counter()
            res = dt.fit(model, Y, backend=backend, max_iters=iters,
                         tol=0.0)
            y_fore, f_fore = dt.forecast(res, 12)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        lls = res.logliks
        floor = noise_floor_for(torch.float32, T * N)
        chunk = backend.fused_chunk
        steady = [h["secs"] for h in res.history[chunk:]]
        rec = {"fit": label, "filter": res.filter,
               "n_iters": res.n_iters, "tau": res.tau,
               "max_freeze_delta": res.ss_delta,
               "loglik_first": float(lls[0]), "loglik_last": float(lls[-1]),
               "max_drop": float(max(0.0, -np.diff(lls).min())),
               "noise_floor": floor, "wall_s": wall,
               "em_iters_per_sec": (len(steady) / sum(steady)
                                    if steady and sum(steady) > 0 else None),
               "chunk_reads": len(rw.stamps), "launches": launches}
        emit(rec)
        RATES[label] = rec["em_iters_per_sec"]
        if res.filter != engine:
            raise AssertionError(f"{label}: filter={flt!r} resolved to "
                                 f"{res.filter!r}, expected {engine!r}")
        if engine == "ss" and not 2 * res.tau + 4 < T:
            raise AssertionError(f"{label}: tau = {res.tau} sends the ss "
                                 "engine to its exact fallback")
        if res.n_iters != iters:
            raise AssertionError(f"{label}: fit stopped after {res.n_iters} "
                                 "iterations")
        if not np.isfinite(lls).all():
            raise AssertionError(f"{label}: non-finite loglik")
        if np.diff(lls).min() < -floor:
            raise AssertionError(f"{label}: loglik dropped by "
                                 f"{-np.diff(lls).min()} > noise floor "
                                 f"{floor}")
        for name, arr in (("factors", res.factors), ("y_fore", y_fore),
                          ("f_fore", f_fore)):
            if not np.isfinite(arr).all():
                raise AssertionError(f"{label}: non-finite {name}")
        if res.factors.shape != (T, K) or y_fore.shape != (12, N):
            raise AssertionError(f"{label}: unexpected output shapes")
        missing = [n for n in need if launches[n] == 0]
        short = [n for n in every if launches[n] < iters]
        if missing or short:
            raise AssertionError(f"{label}: kernels not launched on the fit "
                                 f"path: {missing}; launched fewer times "
                                 f"than iterations: {short}")
        if engine == "pit":
            n_chunks = -(-iters // chunk)
            want = pit_fit_launches(iters)
            bad = {n: v for n, v in launches.items()
                   if v != want.get(n, 0)}
            # reads: one a chunk, and the reporting smooth's host copy.
            emit({"pit_fit": label, "em_iters_per_sec": RATES[label],
                  "info_em_iters_per_sec": RATES["masked"],
                  "pit_qr_em_iters_per_sec": RATES["masked pit_qr"],
                  "reads": len(rw.stamps) + 1, "n_chunks": n_chunks,
                  "launches_per_iter": {n: launches[n] / iters
                                        for n in PIT_PER_ITER},
                  "wall_s": wall})
            if bad or len(rw.stamps) != n_chunks:
                raise AssertionError(f"{label}: launches off {want}: {bad}; "
                                     f"chunk reads {len(rw.stamps)}, "
                                     f"expected {n_chunks}")
        counts[label] = launches
    return counts


def reference_phase(seed: int) -> None:
    """The whole fit on small panels, on the card in f64 against the same
    fit on the CPU in f64, where every kernel's plain version runs:
    logliks, params, factors and forecasts.  The info fits at 120 x 80,
    k = 3, masked and not, within 1e-9 relative (each kernel pass agrees
    to ~1e-15 in f64; 10 EM iterations carry each pass's rounding into the
    next params); the ss fit (150 x 80, unmasked) and the pit_qr fit
    (120 x 80, masked) within 1e-10, and the pit fit (120 x 80, masked)
    within 1e-10."""
    Ynan, _, Yfull, _ = panel(seed + 3, T_=120, N_=80, K_=3)
    _, _, Ylong, _ = panel(seed + 4, T_=150, N_=80, K_=3)
    for label, Y, flt, tol in (("masked", Ynan, "info", 1e-9),
                               ("unmasked", Yfull, "info", 1e-9),
                               ("unmasked ss", Ylong, "ss", 1e-10),
                               ("masked pit_qr", Ynan, "pit_qr", 1e-10),
                               ("masked pit", Ynan, "pit", 1e-10)):
        reference_fit(label, Y, 3, flt, tol)


# The kernels a reference fit on the card must launch, by engine.
REFERENCE_OWN = {"ss": ("ss_cov_path", "affine_scan"),
                 "pit_qr": ("qr_elements", "qr_scan"),
                 "pit": ("pit_elements", "pit_scan"),
                 "dense": ("dense_filter",)}


def reference_fit(label: str, Y, k: int, flt: str, tol: float,
                  engine=None, extra=None, own=None, iters: int = 10) -> None:
    """One ``iters``-iteration fit (10 by default) of ``Y`` at k factors
    with ``filter=flt`` on
    the card in f64 against the same fit on the CPU in f64 (the plain
    twins): logliks, params, factors and forecasts within ``tol``
    relative.  The card fit must resolve to ``engine`` (default ``flt``)
    and launch that engine's own kernels (``own``, default
    ``REFERENCE_OWN``; each entry point's kernel at k: ``kernels.route``).
    ``extra``: more backend options (a rank)."""
    engine = engine or flt
    model = dt.DynamicFactorModel(n_factors=k, dynamics="ar1")
    res = {}
    for dev in ("cuda", "cpu"):
        b = dt.TorchBackend(device=dev, dtype=torch.float64, filter=flt,
                            **(extra or {}))
        kernels.reset_launches()
        r = dt.fit(model, Y, backend=b, max_iters=iters, tol=0.0)
        res[dev] = (r, dt.forecast(r, 12)[0], dict(kernels.LAUNCHES))
    (rg, yg, lg), (rc, yc, _) = res["cuda"], res["cpu"]
    own = tuple(routed(dict.fromkeys(
        own or REFERENCE_OWN.get(engine, ()), 1), k))
    if rg.filter != engine or any(lg[n] == 0 for n in own):
        raise AssertionError(f"reference {label}: the card fit ran "
                             f"{rg.filter!r}, not {engine!r}, or did not "
                             f"launch {own} (launches {lg})")
    errs = {}
    for name, g, c in (("logliks", rg.logliks, rc.logliks),
                       ("Lam", rg.params.Lam, rc.params.Lam),
                       ("R", rg.params.R, rc.params.R),
                       ("A", rg.params.A, rc.params.A),
                       ("factors", rg.factors, rc.factors),
                       ("y_fore", yg, yc)):
        errs[name] = float(np.abs(g - c).max() / np.abs(c).max())
    emit({"reference": label, "filter": rg.filter, "tau": rg.tau,
          "shape": [Y.shape[0], Y.shape[1], k], "max_rel_err": errs,
          "tol": tol})
    bad = {n: e for n, e in errs.items() if not e <= tol}
    if bad:
        raise AssertionError(f"card fit disagrees with the CPU fit "
                             f"({label}): {bad}")


def contract_phase(seed: int) -> None:
    """BASELINE.json:5 loglik contract at iteration 3 (bench.py's
    definition): f32 params after 2 updates, evaluated with the exact f64
    filter, against the f64 trajectory's loglik of the same engine (same
    tau) at its 2-update params."""
    Ynan, W, Yfull, _ = panel(seed + 1)
    for engine, masked in (("info", True), ("info", False), ("ss", False),
                           ("pit_qr", True), ("pit", True)):
        loglik_contract(f"{'masked' if masked else 'unmasked'} {engine}",
                        Ynan if masked else Yfull, W if masked else None, K,
                        engine)


def loglik_contract(label: str, Y, Wm, k: int, engine: str) -> None:
    """The contract of ``contract_phase`` for one engine on the panel
    ``Y`` (mask ``Wm`` or None) at k factors, from its device PCA init; ss
    at ``auto_tau`` of that init."""
    dev = torch.device("cuda")
    masked = Wm is not None
    Z, _ = data.standardize(Y, mask=Wm)
    Z = np.where(np.isfinite(Z), Z, 0.0)
    with highest_precision():
        p0 = pca_init_device(
            torch.as_tensor(Z, dtype=torch.float64, device=dev), k)
        cfg = EMConfig(filter=engine)
        if engine == "ss":
            cfg = EMConfig(filter="ss", tau=ss.auto_tau(p0))
        lls = {}
        for dtype in (torch.float32, torch.float64):
            Yt = torch.as_tensor(Z, dtype=dtype, device=dev)
            mt = (torch.as_tensor(Wm, dtype=dtype, device=dev)
                  if masked else None)
            pt = SSMParams.from_numpy(p0, dtype=dtype, device=dev)
            ps, ll, _ = em_fit_scan(Yt, pt, 3, mask=mt, cfg=cfg)
            lls[dtype] = (ps, ll.cpu().numpy())
        ref = float(lls[torch.float64][1][2])
        p2 = lls[torch.float32][0][1].to_numpy()
        precise = inf.loglik_eval(
            torch.as_tensor(Z, dtype=torch.float64, device=dev), p2,
            mask=Wm, precise=True)
    rel = abs(precise - ref) / abs(ref)
    fast = abs(float(lls[torch.float32][1][2]) - ref) / abs(ref)
    emit({"contract": label, "k": k, "N": Y.shape[1],
          "tau": cfg.tau if engine == "ss" else None, "iter": 3,
          "loglik_f64": ref, "rel_err_precise": rel, "rel_err_fast": fast,
          "limit": 1e-5})
    if not rel < 1e-5:
        raise AssertionError(f"loglik contract broken ({label}): "
                             f"{rel:.3e}")


RING_CASES = ((0, 0), (0, 2), (0, 8), (2, 2), (8, 8))
RING_T_CAP, RING_R_MAX = 1000, 8
SESSION_T0, SESSION_UPDATES, SESSION_ROWS = 480, 3, 2


def ring_buffers(T_cap: int, t_cur: int, dtype, seed: int):
    """A session's (Ybuf, Wbuf) on the card: ``t_cur`` live rows with a
    ragged mask, every row past them exactly zero (the invariant K13
    assumes)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    Y = torch.zeros((T_cap, N), dtype=dtype, device="cuda")
    W = torch.zeros_like(Y)
    W[:t_cur] = (torch.rand((t_cur, N), generator=g, device="cuda")
                 < 0.95).to(dtype)
    Y[:t_cur] = torch.randn((t_cur, N), generator=g, dtype=dtype,
                            device="cuda") * W[:t_cur]
    return Y, W


def ring_rows(n_new: int, dtype, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.zeros((RING_R_MAX, N), dtype=dtype, device="cuda")
    rmask = torch.zeros_like(rows)
    rmask[:n_new] = 1.0
    rows[:n_new] = torch.randn((n_new, N), generator=g, dtype=dtype,
                               device="cuda")
    return rows, rmask


def ring_bytes(T_cap, N_, r_max, n_evict, t_cur, itemsize) -> int:
    """Bytes K13 must move on this call's data, both buffers: the shifted
    live rows read and written, the appended rows read and written, the
    vacated rows past the append written."""
    t_keep = t_cur - n_evict
    moved = t_keep if n_evict else 0
    n_in = max(0, min(r_max, T_cap - t_keep))
    zeroed = max(0, t_cur - t_keep - r_max)
    return 2 * N_ * itemsize * (2 * moved + 2 * n_in + zeroed)


def ring_phase(seed: int) -> dict:
    """K13 against its plain twin, bit for bit, and timed.  Returns the
    f32 record of the ring session's shape (T_cap = 480, e = 2)."""
    summary = None
    t_part = RING_T_CAP * 3 // 5           # a session below capacity
    cases = [(f"e={e} n={n}", RING_T_CAP, RING_T_CAP if e else t_part, e, n)
             for e, n in RING_CASES]
    cases.append(("past capacity", RING_T_CAP, RING_T_CAP - 4, 0, 8))
    cases.append(("ring session", SESSION_T0, SESSION_T0, 2, 2))
    for dtype in (torch.float64, torch.float32):
        for i, (label, T_cap, t_cur, e, n) in enumerate(cases):
            Y0, W0 = ring_buffers(T_cap, t_cur, dtype, seed + i)
            rows, rmask = ring_rows(n, dtype, seed + 100 + i)
            Yk, Wk, Yp, Wp = Y0.clone(), W0.clone(), Y0.clone(), W0.clone()
            n0 = kernels.LAUNCHES["ring_append"]
            ring_evict_append(Yk, Wk, rows, rmask, e, t_cur)
            launches = kernels.LAUNCHES["ring_append"] - n0
            ring_evict_append_plain(Yp, Wp, rows, rmask, e, t_cur)
            torch.cuda.synchronize()
            err = max(float((Yk - Yp).abs().max()),
                      float((Wk - Wp).abs().max()))
            exact = torch.equal(Yk, Yp) and torch.equal(Wk, Wp)
            if not exact or launches != 1:
                raise AssertionError(f"ring_append ({dtype}, {label}): "
                                     f"bit_exact={exact} (max abs err "
                                     f"{err}), launches {launches}")
            if e == 0 and not torch.equal(Yk[:t_cur], Y0[:t_cur]):
                raise AssertionError(f"ring_append ({dtype}, {label}): "
                                     "n_evict = 0 changed a live row")
            t_keep = t_cur - e
            n_in = max(0, min(RING_R_MAX, T_cap - t_keep))
            idx = torch.arange(t_keep, t_keep + n_in, device="cuda")
            run = lambda: ring_evict_append(Yk, Wk, rows, rmask, e, t_cur)
            plain = lambda: ring_evict_append_plain(Yp, Wp, rows, rmask, e,
                                                    t_cur)
            library = lambda: [torch.roll(b, -e, dims=0).index_copy_(
                0, idx, s[:n_in]) for b, s in ((Yp, rows), (Wp, rmask))]
            kernel_ms = cuda_ms(run)
            cold_ms = cuda_ms_cold(run)
            bound_ms, bound_by = bound(
                ring_bytes(T_cap, N, RING_R_MAX, e, t_cur,
                           Y0.element_size()), 0.0, dtype)
            rec = {"name": "ring_append", "variant": label,
                   "dtype": str(dtype).replace("torch.", ""),
                   "T_cap": T_cap, "t_cur": t_cur, "n_evict": e, "n_new": n,
                   "bit_exact": exact, "max_abs_err": err,
                   "max_rel_err": err, "tol": 0.0, "latency_ms": None,
                   "kernel_ms": kernel_ms, "kernel_ms_cold_l2": cold_ms,
                   "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "launches": launches}
            emit(rec)
            if dtype == torch.float32 and label == "ring session":
                summary = rec
        # n_evict = 0 twice: two appends leave the live rows bit-identical.
        Y0, W0 = ring_buffers(RING_T_CAP, t_part, dtype, seed + 50)
        Yk, Wk = Y0.clone(), W0.clone()
        for j, t_cur in enumerate((t_part, t_part + 2)):
            rows, rmask = ring_rows(2, dtype, seed + 60 + j)
            ring_evict_append(Yk, Wk, rows, rmask, 0, t_cur)
        torch.cuda.synchronize()
        same = (torch.equal(Yk[:t_part], Y0[:t_part])
                and torch.equal(Wk[:t_part], W0[:t_part]))
        emit({"ring_append": "n_evict=0 twice", "dtype": str(dtype),
              "live_rows_bit_identical": same})
        if not same:
            raise AssertionError("ring_append: two n_evict = 0 appends "
                                 "changed a live row")
    return summary


# Per session: (label, engine, ring, capacity, the kernel of its engine
# that must launch on every query).
SESSIONS = (("info", "info", False, 1000, "info_scan"),
            ("pit_qr", "pit_qr", False, 1000, "qr_scan"),
            ("ring", "info", True, SESSION_T0, "info_scan"),
            ("pit", "pit", False, 1000, "pit_scan"))


def pct(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def query_breakdown(sess, walls) -> dict:
    """Kernel times of one info query at the session's shapes (the live
    buffers, params and capacity; CUDA events, warm L2): K2, K4 forward,
    K1 and K4 backward run once per E-step (5 EM iterations + the
    reporting smooth), K3 once per M-step, K13 once.  "rest" is the p50
    query wall less those kernels: the torch glue, the upload and the
    read."""
    Yb, Wb = sess._Ybuf, sess._Wbuf
    pt = sess._p
    with highest_precision():
        stats = inf.obs_stats(Yb, pt.Lam, pt.R, Wb)
        scan = inf.info_scan(stats, pt.A, pt.Q, pt.mu0, pt.P0)
        kf = FilterResult(*scan[:4], torch.zeros((), dtype=Yb.dtype))
        sm = rts_smoother(kf, pt)
        EffT, _ = moments(sm)
        ms = {"obs_stats": cuda_ms(lambda: inf.obs_stats(Yb, pt.Lam, pt.R,
                                                         Wb)),
              "info_scan": cuda_ms(lambda: inf.info_scan(
                  stats, pt.A, pt.Q, pt.mu0, pt.P0)),
              "quad_local": cuda_ms(lambda: inf.quad_local(
                  Yb, pt.Lam, pt.R, scan[0], Wb)),
              "rts_smoother": cuda_ms(lambda: rts_smoother(kf, pt)),
              "mstep_rows": cuda_ms(lambda: mstep_rows(
                  Yb, Wb, sm.x_sm, EffT, sm.P_sm, None, 1e-6))}
        rows = torch.zeros((8, Yb.shape[1]), dtype=Yb.dtype, device="cuda")
        Yc, Wc = Yb.clone(), Wb.clone()
        ms["ring_append"] = cuda_ms(lambda: ring_evict_append(
            Yc, Wc, rows, rows, 0, sess.t))
    per_query = {n: ms[n] * (5 if n == "mstep_rows" else
                             1 if n == "ring_append" else 6) for n in ms}
    p50 = pct(walls, 50) * 1e3
    return {"query_breakdown": "info", "T_cap": Yb.shape[0],
            "kernel_ms": ms, "per_query_ms": per_query,
            "rest_ms": p50 - sum(per_query.values()), "p50_ms": p50}


def session_kernel_check(sess, label: str, seed: int) -> None:
    """Every kernel of the session's path against its plain twin on the
    session's own buffers and params after its last query: T_cap rows,
    those past the live length zero-masked pad (K8 splits T_cap into its
    own blocks), in f32 (the session's dtype) and in f64 (the same values
    cast), with the kernel phase's TOL rule; K13 bit for bit on copies of
    the buffers at the session's next (n_evict, t_cur).  Raises on a
    mismatch."""
    worst, refs = {}, {}
    variant = f"session {label}"
    for dtype in (torch.float64, torch.float32):
        Yb = sess._Ybuf.to(dtype).contiguous()
        Wb = sess._Wbuf.to(dtype).contiguous()
        pt = sess._p.to(dtype=dtype)
        with highest_precision():
            cases, stats = masked_cases(Yb, Wb, pt, label=variant)
            if sess.filter == "pit_qr":
                cases += qr_cases(stats, pt, variant, unit=False)
            if sess.filter == "pit":
                cases += pit_cases(stats, pt, variant)
            if sess.filter == "lowrank":
                cases += lowrank_cases(Yb, Wb, pt, lr.resolve_rank(
                    pt.A.shape[0], sess.rank), variant)
            for c in cases:
                key = (c["name"], c["variant"])
                _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                refs[key] = ref
                name = f"{c['name']} {str(dtype)[6:]}"
                worst[name] = max(worst.get(name, 0.0), rel)
        e = SESSION_ROWS if sess.ring else 0
        rows, rmask = ring_rows(SESSION_ROWS, dtype, seed)
        Yk, Wk, Yp, Wp = Yb.clone(), Wb.clone(), Yb.clone(), Wb.clone()
        ring_evict_append(Yk, Wk, rows, rmask, e, sess.t)
        ring_evict_append_plain(Yp, Wp, rows, rmask, e, sess.t)
        if not (torch.equal(Yk, Yp) and torch.equal(Wk, Wp)):
            raise AssertionError(f"ring_append ({dtype}, {variant}): not "
                                 "bit-exact against its plain twin")
        worst[f"ring_append {str(dtype)[6:]}"] = 0.0
    emit({"session_kernels": label, "T_cap": sess.capacity, "t": sess.t,
          "filter": sess.filter, "max_rel_err": worst})


def drive_session(sess, label: str, Ynan, engine: str, own: str,
                  on_query=None, queries: int = SESSION_UPDATES) -> tuple:
    """``queries`` (four) updates of SESSION_ROWS rows of ``Ynan`` from
    SESSION_T0, then
    a pure re-forecast (no rows; still one K13 launch and one read), each
    query's device work under ``set_sync_debug_mode("error")`` and followed
    by one counted read; launch counts are reset before the first query.
    Emits the session's record and raises unless every query launched K13
    once and ``own`` at least once, read the host once, and the session
    serves ``engine``.  ``on_query(q)`` runs before query q.  Returns (the
    record, the updates' walls)."""
    sess.check_sync = True
    reads = []
    read = sess._read
    sess._read = lambda out: reads.append(1) or read(out)
    walls, calls, per_query = [], [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    for q in range(queries + 1):
        lo = SESSION_T0 + q * SESSION_ROWS
        if on_query is not None:
            on_query(q)
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        u = sess.update(Ynan[lo:lo + SESSION_ROWS] if q < queries else None)
        torch.cuda.synchronize()
        call = time.perf_counter() - c0
        if q < queries:
            walls.append(u.wall_s)
            calls.append(call)
        per_query.append({n: kernels.LAUNCHES[n] - before[n]
                          for n in kernels.LAUNCHES})
        if not (np.isfinite(u.nowcast).all()
                and np.isfinite(u.factors).all()
                and np.isfinite(u.forecasts["di"]).all()
                and u.nowcast.shape == (Ynan.shape[1],)):
            raise AssertionError(f"session {label}: non-finite output")
    rec = {"session": label, "filter": sess.filter, "ring": sess.ring,
           "capacity": sess.capacity, "t": sess.t,
           "n_evicted": sess.n_evicted, "queries": queries,
           "p50_ms": pct(walls, 50) * 1e3, "p99_ms": pct(walls, 99) * 1e3,
           "walls_ms": [w * 1e3 for w in walls],
           "call_p50_ms": pct(calls, 50) * 1e3,
           "call_p99_ms": pct(calls, 99) * 1e3,
           "calls_ms": [c * 1e3 for c in calls],
           "reads_per_query": len(reads) / len(per_query),
           "reforecast_launches": {n: per_query[-1][n] for n in
                                   ("ring_append", own)},
           "sync_checked": True,
           "launches_per_query": {n: v for n, v in per_query[-2].items()
                                  if v},
           "n_iters_last": u.n_iters}
    emit(rec)
    bad = [q for q, c in enumerate(per_query)
           if c["ring_append"] != 1 or c[own] < 1]
    if bad or len(reads) != len(per_query) or sess.filter != engine:
        raise AssertionError(f"session {label}: queries {bad} missed one "
                             f"ring_append launch or {own}; reads "
                             f"{len(reads)}, engine {sess.filter}")
    return rec, walls


def session_phase(seed: int) -> dict:
    """The full-width sessions; returns each session's launch counts over
    its queries by label."""
    Ynan, _, _, _ = panel(seed + 1)
    model = dt.DynamicFactorModel(n_factors=K, dynamics="ar1")
    T_end = SESSION_T0 + SESSION_UPDATES * SESSION_ROWS
    fits = {}
    for engine in ("info", "pit_qr", "pit"):
        backend = dt.TorchBackend(filter="auto" if engine == "info"
                                  else engine)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = dt.fit(model, Ynan[:SESSION_T0], backend=backend, fused=True,
                     max_iters=20, tol=0.0)
        wall = time.perf_counter() - t0
        emit({"fused_fit": engine, "filter": res.filter,
              "n_iters": res.n_iters, "host_reads": res.host_reads,
              "converged": res.converged, "wall_s": wall,
              "loglik_last": float(res.logliks[-1]),
              "launches": dict(kernels.LAUNCHES)})
        if (res.filter != engine or res.n_iters != 20
                or not np.isfinite(res.logliks).all()
                or not np.isfinite(res.nowcast).all()
                or res.forecasts["y"].shape != (1, N)):
            raise AssertionError(f"fused fit ({engine}) failed: filter "
                                 f"{res.filter}, {res.n_iters} iterations")
        fits[engine] = (res, backend)
    counts = {}
    entry = None
    for label, engine, ring, cap, own in SESSIONS:
        res, backend = fits[engine]
        sess = dt.open_session(res, Ynan[:SESSION_T0], backend=backend,
                               capacity=cap, max_update_rows=8, max_iters=5,
                               tol=0.0, ring=ring)

        def keep_entry(q, sess=sess, label=label):
            nonlocal entry
            if label == "info" and q == SESSION_UPDATES - 1:
                entry = sess.params()
        rec, walls = drive_session(sess, label, Ynan, engine, own,
                                   keep_entry)
        counts[label] = dict(kernels.LAUNCHES)
        if ring and sess.n_evicted != SESSION_UPDATES * SESSION_ROWS:
            raise AssertionError(f"ring session evicted {sess.n_evicted}")
        if label == "info":
            info_p50 = rec["p50_ms"]
            emit(query_breakdown(sess, walls))
        session_kernel_check(sess, label, seed + 70)
        sess.close()
    # The cold refit the session replaces: the live 488 rows from the
    # params the info session's last query started from.
    cold = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = dt.fit(model, Ynan[:T_end], backend=fits["info"][1], fused=True,
                   max_iters=5, tol=0.0, init=entry)
        cold.append(time.perf_counter() - t0)
    # Its device part alone: the fused fit on the panel already on the
    # card (standardized as the fit does, zero-filled, with its mask).
    W = data.build_mask(Ynan[:T_end])
    Z, _ = data.standardize(Ynan[:T_end], mask=W)
    Zt = torch.as_tensor(np.where(W > 0, np.nan_to_num(Z), 0.0),
                         dtype=torch.float32, device="cuda")
    Wt = torch.as_tensor(W, dtype=torch.float32, device="cuda")
    p0 = SSMParams.from_numpy(entry, dtype=torch.float32, device="cuda")
    floor = noise_floor_for(torch.float32, Zt.numel())
    device = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_fused(Zt, Wt, p0, EMConfig(filter="info"), 5, 0.0, floor,
                  FusedOptions())
        device.append(time.perf_counter() - t0)
    emit({"cold_refit": "info", "T": T_end, "n_iters": r.n_iters,
          "host_reads": r.host_reads, "walls_ms": [w * 1e3 for w in cold],
          "median_ms": pct(cold, 50) * 1e3,
          "device_part_ms": [w * 1e3 for w in device],
          "device_part_median_ms": pct(device, 50) * 1e3,
          "info_session_p50_over_cold": info_p50 / (pct(cold, 50) * 1e3)})
    return counts


def session_reference_phase(seed: int) -> None:
    """A ring session at 120 x 80, k = 3 (standardize=False), 3 updates
    (the first one evicting), info and pit, on the card in f64 against the
    CPU in f64 and against the card's cold fused fit of the trailing
    window, within 1e-10 relative."""
    for engine in ("info", "pit"):
        _session_reference(seed, engine)


def _session_reference(seed: int, engine: str, N_: int = 80) -> None:
    Ynan, _, _, _ = panel(seed + 5, T_=130, N_=N_, K_=3)
    model = dt.DynamicFactorModel(n_factors=3, dynamics="ar1",
                                  standardize=False)
    ups = ((120, 123), (123, 124), (124, 128))
    out = {}
    for dev in ("cuda", "cpu"):
        b = dt.TorchBackend(device=dev, dtype=torch.float64, filter=engine)
        res = dt.fit(model, Ynan[:120], backend=b, fused=True, max_iters=10,
                     tol=0.0)
        sess = dt.open_session(res, Ynan[:120], backend=b, capacity=120,
                               max_update_rows=4, max_iters=5, tol=0.0,
                               ring=True)
        sess.check_sync = dev == "cuda"
        us, entries = [], []
        for lo, hi in ups:
            entries.append(sess.params())
            us.append(sess.update(Ynan[lo:hi]))
        out[dev] = (res, us, entries, b)
    errs = {}
    fields = ("nowcast", "factors", "factor_cov", "logliks")

    def worst(name, got, want):
        e = float(np.abs(got - want).max() / np.abs(want).max())
        errs[name] = max(errs.get(name, 0.0), e)

    for ug, uc in zip(out["cuda"][1], out["cpu"][1]):
        for f in fields:
            worst(f"card-cpu {f}", getattr(ug, f), getattr(uc, f))
        for key in ("y", "f", "di"):
            worst(f"card-cpu forecast {key}", ug.forecasts[key],
                  uc.forecasts[key])
    # Each ring update against a cold fused fit of its trailing window.
    _, us, entries, b = out["cuda"]
    for (lo, hi), u, p in zip(ups, us, entries):
        ref = dt.fit(model, Ynan[hi - 120:hi], backend=b, fused=True,
                     max_iters=5, tol=0.0, init=p)
        for f in ("nowcast", "factors", "factor_cov", "logliks"):
            worst(f"session-cold {f}", getattr(u, f), getattr(ref, f))
        worst("session-cold forecast y", u.forecasts["y"], ref.forecasts["y"])
    emit({"session_reference": f"ring {engine}", "shape": [120, N_, 3],
          "max_rel_err": errs, "tol": 1e-10})
    bad = {n: e for n, e in errs.items() if not e <= 1e-10}
    if bad:
        raise AssertionError(f"session reference disagrees: {bad}")


B_RESTARTS = 8
FIT_MANY_ITERS = 20
BATCHED = ("batched_info_scan", "batched_rts", "batched_quad",
           "batched_solve_rows")
# oos_evaluate's rolling windows: 12 windows of 4T/5 rows, horizon 1, 10
# iterations at its default tol.
ROLL_WINDOWS, ROLL_TRAIN, ROLL_ITERS = 12, 4 * T // 5, 10


class BatchedWatch:
    """For the duration: stamps every blocking read of the batched engine
    (``estim.batched.read_packed``: one a chunk, then the final packed
    one) and the start of its EM (``run_batched_em``).  At that start it
    keeps the launch counts so far (``before_em``: a caller's lone fits)
    and sets every count to 0, so that afterwards ``kernels.LAUNCHES``
    holds the batched EM's and the final smooth's launches alone; it keeps
    the EM's return (``em_out``) and the iterations its chunks ran
    (``em_iters``)."""

    def __enter__(self):
        self.reads, self.em_start = [], None
        self.before_em, self.em_out, self.em_iters = None, None, None
        self._saved = (tb.read_packed, tb.run_batched_em)
        read, run = self._saved

        def stamped_read(named):
            out = read(named)
            self.reads.append(time.perf_counter())
            return out

        def stamped_run(*args, **kw):
            a = inspect.signature(run).bind(*args, **kw)
            a.apply_defaults()
            torch.cuda.synchronize()
            self.before_em = dict(kernels.LAUNCHES)
            kernels.reset_launches()
            self.em_start = time.perf_counter()
            self.em_out = run(*args, **kw)
            chunk = max(1, int(a.arguments["fused_chunk"]))
            self.em_iters = min(self.em_out[4][0].n_chunks * chunk,
                                a.arguments["max_iters"])
            return self.em_out

        tb.run_batched_em = stamped_run
        tb.read_packed = stamped_read
        return self

    def __exit__(self, *exc):
        tb.read_packed, tb.run_batched_em = self._saved


def routed(counts: dict, k: int, rank: int = 0) -> dict:
    """``counts`` (calls) keyed by the kernel each entry point launches at
    k (``kernels.route``: its wide twin at 16 < k <= 32, its generic one
    past 32; the square-root engine's by ``la.check_qr_k``: its generic
    ones past 10; the rank-r trio's by ``kernels.route_lowrank`` at
    ``rank``, 0 the auto rank), in device kernels
    (``kernels.DEVICE_LAUNCHES`` a call)."""
    out = {}
    for n, c in counts.items():
        if n in ("qr_elements", "qr_scan"):
            name = la.check_qr_k(n, k)
        elif n in LOWRANK:
            name = kernels.route_lowrank(n, k, lr.resolve_rank(k, rank))
        elif n in kernels.WIDE or n in kernels.GEN:
            name = kernels.route(n, k)
        else:
            name = n
        out[name] = (None if c is None
                     else c * kernels.DEVICE_LAUNCHES.get(name, 1))
    return out


def check_batched_launches(label: str, launches: dict, iters: int,
                           k: int = K) -> dict:
    """Per batched EM iteration (A estimated): one K4b pair, one K1b and
    two K6b (their wide twins at 16 < k <= 32); the final smooth one more
    K4b pair; no other kernel.  Returns the launches per iteration, the
    smooth's included."""
    want = routed({"batched_info_scan": iters + 1, "batched_rts": iters + 1,
                   "batched_quad": iters, "batched_solve_rows": 2 * iters},
                  k)
    wrong = {n: launches[n] for n in launches
             if launches[n] != want.get(n, 0)}
    if wrong:
        raise AssertionError(f"{label} launches {wrong} in {iters} "
                             f"iterations, expected {want} and no other "
                             "kernel")
    return {n: launches[n] / iters for n in want}


def solve_inputs(Yt, sm, pt, hetero=None) -> list:
    """The (S, V) pairs ``batched_m_step`` hands K6b on these smoother
    moments, recorded from a plain M-step: the loadings' (S_ff, S_yf),
    then A's (S_lag, S_cross)."""
    calls = []
    real = tb._bsolve_rows

    def record(S, V):
        calls.append((S.contiguous(), V.contiguous()))
        return tb._bsolve_rows_plain(S, V)

    tb._bsolve_rows = record
    try:
        tb.batched_m_step(Yt, *sm, pt, EMConfig(filter="info"),
                          torch.einsum("btn,btn->bn", Yt, Yt), hetero=hetero)
    finally:
        tb._bsolve_rows = real
    return calls


def batched_cases(Yt, pt, label: str, hetero=None, junk: bool = False
                  ) -> list:
    """K4b-fwd, K1b, K4b-bwd and K6b (the loadings' and A's solves; their
    wide twins at 16 < k <= 32, each case named by the kernel its wrapper
    routes to) on the inputs the plain batched pipeline makes from the
    stacked panel ``Yt`` and params ``pt`` (with the Hetero freeze and
    masked sums when given).  With ``junk`` the scan's b holds NaN and
    inf at every lane's pad steps (the freeze must select, never
    multiply).  Call under ``highest_precision()``."""
    dtype = Yt.dtype
    B_, T_, N_ = Yt.shape
    k = pt.A.shape[-1]
    k2, k3 = k * k, k ** 3
    tm = None if hetero is None else hetero.t_mask
    b, C, _ = tb._batched_obs_stats(Yt, pt.Lam, pt.R)
    scan_ref = plain_call(lambda: tb._batched_info_scan_plain(
        b, C, pt.A, pt.Q, pt.mu0, pt.P0, tm))
    scan = scan_ref[0]
    flt = scan[:4]
    sm_ref = plain_call(lambda: tb._batched_rts_plain(*flt, pt.A))
    sm = sm_ref[0]
    bs = b
    if junk and tm is not None:
        pad = (tm <= 0)[..., None].expand_as(b)
        bs = torch.where(pad, torch.full_like(b, float("nan")), b)
        bs[:, -1, 0] = torch.where(pad[:, -1, 0], float("inf"), bs[:, -1, 0])
    scan_in = (bs, C, pt.A, pt.Q, pt.mu0, pt.P0) + (() if tm is None
                                                    else (tm,))
    cases = [
        case(kernels.route("batched_info_scan", k), label,
             lambda: tb._batched_info_scan(bs, C, pt.A, pt.Q, pt.mu0, pt.P0,
                                           tm),
             lambda: tb._batched_info_scan_plain(bs, C, pt.A, pt.Q, pt.mu0,
                                                 pt.P0, tm),
             scan_in, B_ * T_ * (12.67 * k3 + 4 * k2),
             floor=lambda: latency_ms("info_scan", dtype, k, T_),
             ref=scan_ref if bs is b else None),
        case(kernels.route("batched_quad", k), label,
             lambda: tb._batched_quad(Yt, pt.Lam, pt.R, scan[0], b, C),
             lambda: tb._batched_quad_plain(Yt, pt.Lam, pt.R, scan[0], b, C),
             (Yt, pt.Lam, pt.R, scan[0], b, C),
             B_ * T_ * (N_ * (2 * k + 5) + 2 * k2)),
        case(kernels.route("batched_rts", k), label,
             lambda: tb._batched_rts(*flt, pt.A),
             lambda: tb._batched_rts_plain(*flt, pt.A), (*flt, pt.A),
             B_ * T_ * (10.33 * k3 + 4 * k2),
             floor=lambda: latency_ms("rts_smoother", dtype, k, T_),
             ref=sm_ref),
    ]
    for which, (S, V) in zip(("Lam rows", "A rows"),
                             solve_inputs(Yt, sm, pt, hetero)):
        cases.append(case(
            kernels.route("batched_solve_rows", k), f"{label} {which}",
            lambda S=S, V=V: tb._bsolve_rows(S, V),
            lambda S=S, V=V: tb._bsolve_rows_plain(S, V), (S, V),
            B_ * (k3 / 3 + 2 * V.shape[1] * k2),
            library=lambda S=S, V=V: torch.cholesky_solve(
                V.transpose(-1, -2), torch.linalg.cholesky(S))))
    return cases


def hetero_lanes(Z, p, t_act, n_act):
    """Lanes of one standardized panel ``Z`` cut to (t_act, n_act) and
    padded back to its shape (zero pad steps and series), with ``p`` cut
    and padded to match (inert pad series)."""
    T_, N_ = Z.shape
    Ys = [tb.pad_panel_to_n(tb.pad_panel_to_t(Z[:t, :n], T_), N_)
          for t, n in zip(t_act, n_act)]
    ps = [tb.pad_params_to_n(tb.slice_params_to_n(p, n), N_) for n in n_act]
    return np.stack(Ys), ps


def rolling_origins(T_: int = T, windows: int = ROLL_WINDOWS) -> np.ndarray:
    """The forecast origins ``oos_evaluate`` picks for the rolling
    phase's call (``windows`` windows of ROLL_TRAIN rows, horizon 1)."""
    return np.unique(np.linspace(ROLL_TRAIN, T_ - 1, windows,
                                 dtype=int))


def batched_inputs(seed: int, T_: int = T, N_: int = N, K_: int = K,
                   B_: int = B_RESTARTS, rolling: bool = False) -> list:
    """(label, stacked standardized panel, per-lane NumPy params,
    (t_act, n_act) or None) of each batched case on the unmasked panel:
    the restarts' inits, a Hetero bucket (ragged T and N, restart 0's
    init cut to each lane), at K_ > 1 the k-grid (restart 0's init cut to
    k = 1..K_ and padded back with inert factors) and, with ``rolling``,
    the rolling phase's windows (each standardized on its own) with the
    first window's 10-iteration lone fit as every lane's init, as
    ``oos_evaluate(engine="batched")`` makes them."""
    _, _, Yfull, _ = panel(seed + 1, T_, N_, K_)
    spec = dt.DFMBatchSpec.restarts(dt.DynamicFactorModel(n_factors=K_),
                                    Yfull, B_)
    Z = data.standardize(Yfull)[0]
    p0 = spec.inits[0]
    # At the headline shape: t_act (500, 400, 300, 250), n_act (10,000,
    # 8,000, 10,000, 6,000).
    t_act = [int(T_ * f) for f in (1.0, 0.8, 0.6, 0.5)]
    n_act = [int(N_ * f) for f in (1.0, 0.8, 1.0, 0.6)]
    Yh, ph = hetero_lanes(Z, p0, t_act, n_act)
    out = [("restarts", np.broadcast_to(Z, (B_,) + Z.shape), spec.inits,
            None),
           ("hetero", Yh, ph, (t_act, n_act))]
    if K_ > 1:
        ks = range(1, K_ + 1)
        out.append(("k-grid", np.broadcast_to(Z, (K_,) + Z.shape),
                    [tb.pad_params_to_k(tb.slice_params_to_k(p0, k), K_)
                     for k in ks], None))
    if rolling:
        model = dt.DynamicFactorModel(n_factors=K_)
        origins = rolling_origins(T_)
        spec = dt.DFMBatchSpec.rolling_windows(model, Yfull, origins,
                                               train_len=ROLL_TRAIN)
        first = dt.fit(model, spec.Y[0], backend=dt.TorchBackend(),
                       max_iters=ROLL_ITERS)
        out.append(("rolling", np.stack([data.standardize(y)[0]
                                         for y in spec.Y]),
                    [first.params] * len(origins), None))
    return out


def batched_kernel_phase(seed: int) -> dict:
    """K4b-fwd, K4b-bwd, K1b and K6b against their plain twins at full
    width (T = 500, N = 10,000, k = 10: B = 8 restarts, the B = 4 Hetero
    bucket, the B = 10 k-grid; T = 400: the B = 12 rolling windows), f64
    then f32 (the TOL rule), each timed
    as the kernel phase times K1-K4; K6b's library column is
    ``cholesky`` + ``cholesky_solve``.  Returns the f32 summary records
    by kernel name."""
    summary, refs = {}, {}
    inputs = batched_inputs(seed, rolling=True)
    for dtype in (torch.float64, torch.float32):
        for label, Zb, ps, het in inputs:
            Yt = torch.tensor(np.ascontiguousarray(Zb), dtype=dtype,
                              device="cuda")
            pt = tb.stack_params(ps, dtype=dtype, device="cuda")
            hetero = None if het is None else tb.make_hetero(
                *het, T, N, dtype=dtype, tol=0.0, iter_cap=FIT_MANY_ITERS,
                device="cuda")
            with highest_precision():
                for c in batched_cases(Yt, pt, label, hetero):
                    name, key = c["name"], (c["name"], c["variant"])
                    n0 = kernels.LAUNCHES[name]
                    abs_err, rel_err, tol, ref, plain_err = compare(
                        c, dtype, refs.get(key))
                    if dtype == torch.float64:
                        refs[key] = ref
                    bound_ms, bound_by = bound(
                        nbytes_of(c["ins"]) + nbytes_of(ref), c["flops"],
                        dtype)
                    rec = {"name": name, "variant": c["variant"],
                           "dtype": str(dtype).replace("torch.", ""),
                           "B": Yt.shape[0], "max_rel_err": rel_err,
                           "max_abs_err": abs_err, "tol": tol,
                           "plain_f32_err": plain_err,
                           "kernel_ms": cuda_ms(c["run"], warm=False),
                           "kernel_ms_cold_l2": cuda_ms_cold(
                               c["run"], c.get("cold_reps", COLD_REPS),
                               False),
                           "plain_ms": plain_ms(c),
                           "library_ms": (cuda_ms(c["library"])
                                          if c["library"] else None),
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "latency_ms": (c["floor"]() if c["floor"]
                                          else None),
                           "launches": kernels.LAUNCHES[name] - n0}
                    emit(rec)
                    if (dtype == torch.float32
                            and c["variant"] == SUMMARY_VARIANT[name]):
                        summary[name] = rec
            del Yt, pt, hetero
            torch.cuda.empty_cache()
    return summary


def batched_k_sweep(seed: int, ks=(1, 16), junk: bool = False) -> None:
    """The batched kernels at each k of ``ks`` (by default the ends of
    their k dispatch, 1 and 16) on 120 x 400 panels (B = 3 restarts, a
    B = 4 Hetero bucket, with ``junk`` NaN and inf in its scan's pad
    steps, and the B = k k-grid), f64 and f32: error checks only."""
    for k in ks:
        refs = {}
        inputs = batched_inputs(seed + 2, T_=120, N_=400, K_=k, B_=3)
        for dtype in (torch.float64, torch.float32):
            worst = {}
            for label, Zb, ps, het in inputs:
                Yt = torch.tensor(np.ascontiguousarray(Zb), dtype=dtype,
                                  device="cuda")
                pt = tb.stack_params(ps, dtype=dtype, device="cuda")
                hetero = None if het is None else tb.make_hetero(
                    *het, 120, 400, dtype=dtype, tol=0.0, iter_cap=5,
                    device="cuda")
                with highest_precision():
                    for c in batched_cases(Yt, pt, label, hetero, junk):
                        key = (c["name"], c["variant"])
                        _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                        refs[key] = ref
                        worst[c["name"]] = max(worst.get(c["name"], 0.0),
                                               rel)
            emit({"batched_k_sweep": k,
                  "dtype": str(dtype).replace("torch.", ""),
                  "max_rel_err": worst})


def em_rate(history, chunk: int):
    """(iterations after the first chunk, the host wall of those chunks)
    of a lone fit's history."""
    steady = [h["secs"] for h in history[chunk:]]
    return len(steady), sum(steady)


def fit_many_phase(seed: int, k: int = K, offset: int = 1,
                   label: str = "fit_many", lone_ss: bool = True,
                   B_: int = B_RESTARTS, iters: int = FIT_MANY_ITERS,
                   n_lone: int = B_RESTARTS) -> dict:
    """``fit_many`` on ``B_`` (8) restarts of the unmasked headline panel
    (k = 10, from ``panel(seed + offset)``; ``iters`` (20) iterations,
    tol = 0, f32): aggregate EM iterations/s (B x the iterations after the
    first chunk over the host wall of those chunks, each chunk ending in
    its one read), reads, launches per iteration; then ``n_lone`` (8)
    looped lone ``fit(filter="info")`` runs from the first inits and
    (``lone_ss``) one lone ``fit`` (auto -> ss) from restart 0's, same
    budget.  Returns the fit_many's launch counts under ``label``."""
    _, _, Yfull, _ = panel(seed + offset, K_=k)
    model = dt.DynamicFactorModel(n_factors=k)
    spec = dt.DFMBatchSpec.restarts(model, Yfull, B_)
    chunk = 8
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with BatchedWatch() as w:
        res = dt.fit_many(spec, backend=dt.TorchBackend(), max_iters=iters,
                          tol=0.0, fused_chunk=chunk)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_chunks = -(-iters // chunk)
    chunk_reads = w.reads[:n_chunks]
    steady_s = chunk_reads[-1] - chunk_reads[0]
    agg = B_ * (iters - chunk) / steady_s
    floor = noise_floor_for(torch.float32, T * N)
    lls = np.stack(res.logliks)
    # The lone comparisons, same inits and budget.
    lone = {}
    runs = [("looped info", "info", spec.inits[:n_lone])]
    if lone_ss:
        runs.append(("lone ss", "auto", spec.inits[:1]))
    for name, flt, inits in runs:
        n_it = secs = 0.0
        t1 = time.perf_counter()
        for p0 in inits:
            r = dt.fit(model, Yfull, backend=dt.TorchBackend(filter=flt),
                       max_iters=iters, tol=0.0, init=p0)
            n, s_ = em_rate(r.history, chunk)
            n_it += n
            secs += s_
        torch.cuda.synchronize()
        lone[name] = {"filter": r.filter, "fits": len(inits),
                      "wall_s": time.perf_counter() - t1,
                      "em_iters_per_sec": n_it / secs}
    per_iter = {n: launches[n] / iters for n in launches if launches[n]}
    rec = {"fit_many": label, "B": B_, "k": k, "n_iters":
           res.n_iters.tolist(), "wall_s": wall,
           "em_wall_s": w.reads[-1] - w.em_start,
           "init_s": w.em_start - t0,
           "aggregate_em_iters_per_sec": agg,
           "steady_chunks_s": steady_s, "reads": len(w.reads),
           "host_reads": res.host_reads, "n_chunks": n_chunks,
           "launches": launches, "launches_per_iter": per_iter,
           "loglik_last": lls[:, -1].tolist(), "best": res.best(),
           "max_drop": float(max(0.0, -np.diff(lls, axis=1).min())),
           "noise_floor": floor, "lone": lone,
           "aggregate_over_looped_info": agg / lone["looped info"][
               "em_iters_per_sec"]}
    if lone_ss:
        rec["aggregate_over_lone_ss"] = (agg / lone["lone ss"]
                                         ["em_iters_per_sec"])
    emit(rec)
    check_batched_launches(label, launches, iters, k)
    if len(w.reads) != n_chunks + 1 or res.host_reads != n_chunks + 1:
        raise AssertionError(f"fit_many read {len(w.reads)} times "
                             f"(host_reads {res.host_reads}), expected "
                             f"{n_chunks + 1}")
    if (res.n_iters != iters).any() or not np.isfinite(lls).all():
        raise AssertionError(f"fit_many: n_iters {res.n_iters}, finite "
                             f"{np.isfinite(lls).all()}")
    if np.diff(lls, axis=1).min() < -floor:
        raise AssertionError(f"fit_many: a loglik dropped by "
                             f"{-np.diff(lls, axis=1).min()} > {floor}")
    for f, P in zip(res.factors, res.factor_cov):
        if (f.shape != (T, k) or P.shape != (T, k, k)
                or not (np.isfinite(f).all() and np.isfinite(P).all())):
            raise AssertionError("fit_many: bad factors")
    if lone_ss and lone["lone ss"]["filter"] != "ss":
        raise AssertionError("the lone auto fit did not resolve to ss")
    return {label: launches}


def kgrid_phase(seed: int, ks=range(1, K + 1), k: int = K,
                offset: int = 1, iters: int = FIT_MANY_ITERS) -> None:
    """``select_n_factors_em`` over ``ks`` (k = 1..10) on the unmasked
    headline panel (simulated at k factors from ``seed + offset``; 20
    iterations, tol = 0, f32): the wall, the EM part (from the batched
    EM's start, after the host PCA inits, to its last read), k_best, the
    lane logliks, the reads and the launches per iteration (counted from
    the EM's start), at max(ks) the wide twins past 16."""
    _, _, Yfull, _ = panel(seed + offset, K_=k)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with BatchedWatch() as w:
        sel = dt.select_n_factors_em(Yfull, ks=ks,
                                     max_iters=iters, tol=0.0,
                                     backend=dt.TorchBackend())
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_chunks = -(-iters // 8)
    emit({"k_grid": list(map(int, sel.ks)), "wall_s": wall,
          "init_s": w.em_start - t0, "em_wall_s": w.reads[-1] - w.em_start,
          "k_best": sel.k_best, "logliks": sel.logliks.tolist(),
          "ic": sel.ic.tolist(), "n_iters": sel.fit.n_iters.tolist(),
          "reads": len(w.reads), "em_iters": w.em_iters,
          "launches_before_em": w.before_em, "launches": launches})
    if (not np.isfinite(sel.logliks).all()
            or (sel.fit.n_iters != iters).any()
            or len(w.reads) != n_chunks + 1 or w.em_iters != iters
            or any(w.before_em.values())):
        raise AssertionError(f"k-grid: logliks {sel.logliks}, n_iters "
                             f"{sel.fit.n_iters}, reads {len(w.reads)}, "
                             f"EM iterations {w.em_iters}, launches before "
                             f"the EM {w.before_em}")
    check_batched_launches("k-grid", launches, iters, max(ks))


def rolling_phase(seed: int, k: int = K, offset: int = 1,
                  windows: int = ROLL_WINDOWS) -> None:
    """``oos_evaluate(engine="batched")``: 12 rolling windows of 400 rows
    (4T/5) of the unmasked headline panel, horizon 1, 10 iterations at the
    default tol (the first window's lone fit seeds every window): the
    wall, the batched EM part, each window's trace length, converged flag
    and stop rule (``rel``: |relative change| < tol; ``drop``: the
    loglik fell, the plateau stop, which at f32 may be rounding), the mean
    relative RMSE against the last-value forecast, the lone fit's launches
    and the batched EM's launches per iteration (counted from its
    start); the panel simulated at k factors from ``seed + offset``, the
    model at k; ``windows`` windows (12), the lone seed fit through the
    default ``TorchBackend()``, which must resolve to ``ss`` (the panel is
    fully observed, N >= 512) and launch K5a at its tier of k."""
    _, _, Yfull, _ = panel(seed + offset, K_=k)
    model = dt.DynamicFactorModel(n_factors=k)
    tol = inspect.signature(dt.fit_many).parameters["tol"].default
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with BatchedWatch() as w:
        oos = dt.oos_evaluate(model, Yfull, engine="batched",
                              n_windows=windows, min_train=ROLL_TRAIN,
                              horizon=1, max_iters=ROLL_ITERS,
                              backend=dt.TorchBackend())
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rel = oos.rel_rmse
    lls, conv = w.em_out[1], w.em_out[2]
    stops = []
    for tr, c in zip(lls, conv):
        last = (tr[-1] - tr[-2]) / max(abs(tr[-2]), 1e-12)
        stops.append(None if not c else "rel" if abs(last) < tol else "drop")
    n_chunks = -(-w.em_iters // 8)
    emit({"rolling_windows": len(oos.origins), "k": k, "train": ROLL_TRAIN,
          "wall_s": wall, "em_wall_s": w.reads[-1] - w.em_start,
          "reads": len(w.reads), "tol": tol, "em_iters": w.em_iters,
          "n_iters": [len(t) for t in lls], "converged": conv.tolist(),
          "stop": stops,
          "last_rel_change": [float((t[-1] - t[-2]) / abs(t[-2]))
                              for t in lls],
          "mean_rel_rmse": float(rel.mean()),
          "origins": oos.origins.tolist(),
          "launches_lone_fit": {n: c for n, c in w.before_em.items() if c},
          "launches": launches})
    if (len(oos.origins) != windows or rel.shape != (N,)
            or not np.isfinite(rel).all()
            or not np.array_equal(oos.origins, rolling_origins(T, windows))
            or len(w.reads) != n_chunks + 1
            or any(w.before_em[n] for n in routed(dict.fromkeys(BATCHED),
                                                  k))
            or not any(w.before_em.values())
            or not w.before_em[kernels.route("ss_cov_path", k)]):
        raise AssertionError(f"rolling windows: origins {oos.origins}, "
                             f"finite {np.isfinite(rel).all()}, reads "
                             f"{len(w.reads)} for {w.em_iters} EM "
                             f"iterations, lone fit launches {w.before_em}")
    check_batched_launches("rolling windows", launches, w.em_iters, k)


def batched_reference_phase(seed: int, k: int = 3,
                            tol: float = 1e-10, iters: int = 10) -> None:
    """At 120 x 80, k = 3: ``fit_many`` of three panels (``iters``
    iterations, 10 by default, tol = 0) and ``run_batched_em`` on a Hetero
    bucket (lane 1 ragged in T, lane 2 in N; ``iters`` iterations, chunks
    of 4), on the card in f64 against the CPU in f64, within ``tol``
    relative."""
    Ys = [panel(seed + 3 + i, T_=120, N_=80, K_=k)[2] for i in range(3)]
    Yb = np.stack(Ys)
    model = dt.DynamicFactorModel(n_factors=k)
    Z = np.stack([data.standardize(y)[0] for y in Ys])
    Yh, ph = [], []
    for i, (t, n) in enumerate(((120, 80), (90, 80), (120, 60))):
        y, p = hetero_lanes(Z[i], cpu_ref.pca_init(Z[i][:t, :n], k), [t],
                            [n])
        Yh.append(y[0])
        ph += p
    out = {}
    for dev in ("cuda", "cpu"):
        b = dt.TorchBackend(device=dev, dtype=torch.float64)
        kernels.reset_launches()
        r = dt.fit_many(dt.DFMBatchSpec(Y=Yb, model=model), backend=b,
                        max_iters=iters, tol=0.0)
        het = tb.make_hetero((120, 90, 120), (80, 80, 60), 120, 80,
                             dtype=torch.float64, tol=0.0, iter_cap=iters,
                             device=dev)
        with highest_precision():
            h = tb.run_batched_em(
                torch.tensor(np.stack(Yh), dtype=torch.float64, device=dev),
                tb.stack_params(ph, device=dev), EMConfig(filter="info"),
                iters, 0.0, fused_chunk=4, hetero=het)
        out[dev] = (r, h, dict(kernels.LAUNCHES))
    (rg, hg, lg), (rc, hc, _) = out["cuda"], out["cpu"]
    if any(lg[n] == 0 for n in routed(dict.fromkeys(BATCHED), k)):
        raise AssertionError(f"batched reference: the card run did not "
                             f"launch every batched kernel ({lg})")
    errs = {}

    def worst(name, got, want):
        e = float(np.abs(got - want).max() / np.abs(want).max())
        errs[name] = max(errs.get(name, 0.0), e)

    for i in range(3):
        worst("fit_many logliks", rg.logliks[i], rc.logliks[i])
        for f in ("Lam", "R", "A", "Q"):
            worst(f"fit_many {f}", getattr(rg.params[i], f),
                  getattr(rc.params[i], f))
        worst("fit_many factors", rg.factors[i], rc.factors[i])
        worst("fit_many factor_cov", rg.factor_cov[i], rc.factor_cov[i])
        worst("hetero logliks", hg[1][i], hc[1][i])
    for f in ("Lam", "A", "Q", "R"):
        worst(f"hetero {f}", getattr(hg[0], f).cpu().numpy(),
              getattr(hc[0], f).numpy())
    emit({"batched_reference": "fit_many + hetero", "shape": [3, 120, 80, k],
          "max_rel_err": errs, "tol": tol,
          "hetero_n_iters": [len(t) for t in hg[1]]})
    bad = {n: e for n, e in errs.items() if not e <= tol}
    if bad or [len(t) for t in hg[1]] != [len(t) for t in hc[1]]:
        raise AssertionError(f"batched card run disagrees with the CPU: "
                             f"{bad}")


def batched_contract_phase(seed: int, k: int = K, offset: int = 1,
                           B_: int = B_RESTARTS) -> None:
    """The 1e-5 loglik contract for each lane of an f32 batched fit of the
    ``B_`` (8) restarts at the headline shape (simulated at k factors from
    ``seed + offset``), as contract_phase evaluates it: the f32 params
    after 2 updates, evaluated with the exact f64 filter, against the f64
    batched trajectory's loglik at iteration 3."""
    _, _, Yfull, _ = panel(seed + offset, K_=k)
    spec = dt.DFMBatchSpec.restarts(dt.DynamicFactorModel(n_factors=k),
                                    Yfull, B_)
    Z = data.standardize(Yfull)[0]
    Zb = np.ascontiguousarray(np.broadcast_to(Z, (B_, T, N)))
    cfg = EMConfig(filter="info")
    runs = {}
    with highest_precision():
        for dtype, iters in ((torch.float32, 2), (torch.float32, 3),
                             (torch.float64, 3)):
            Yt = torch.tensor(Zb, dtype=dtype, device="cuda")
            p0 = tb.stack_params(spec.inits, dtype=dtype, device="cuda")
            p, lls = tb.run_batched_em(Yt, p0, cfg, iters, 0.0)[:2]
            runs[(dtype, iters)] = (tb.unstack_params(p), lls)
            del Yt, p0, p
            torch.cuda.empty_cache()
        Z64 = torch.tensor(Z, dtype=torch.float64, device="cuda")
        rels, fasts = [], []
        for b in range(B_):
            ref = float(runs[(torch.float64, 3)][1][b][2])
            precise = inf.loglik_eval(Z64, runs[(torch.float32, 2)][0][b],
                                      precise=True)
            rels.append(abs(precise - ref) / abs(ref))
            fasts.append(abs(float(runs[(torch.float32, 3)][1][b][2]) - ref)
                         / abs(ref))
    emit({"contract": "fit_many restarts", "B": B_, "k": k,
          "iter": 3, "rel_err_precise": rels, "rel_err_fast": fasts,
          "limit": 1e-5})
    if not max(rels) < 1e-5:
        raise AssertionError(f"loglik contract broken (fit_many): {rels}")


# The fleet: 8 tenants in one bucket at (T_cap, N_max, k_max) = (1000,
# 10,000, 10): six of 480 x 10,000 at k = 10, two of 400 x 6,000 at k = 8
# (the T, N and k padding seams).  Each tenant has FLEET_HELD held-out
# rows; an even drain gives every tenant 2 of them, an odd drain only the
# FLEET_ODD tenants.
FLEET_SHAPES = ((480, N, K),) * 6 + ((400, 6000, 8),) * 2
FLEET_CAP, FLEET_ROWS, FLEET_ITERS, FLEET_DRAINS = 1000, 2, 5, 2
# Rows held out a tenant: ten drains' worth, enough for every phase that
# drains the tenants (the ring fleet takes five), and part of each panel's
# simulated length.
FLEET_HELD = 10 * FLEET_ROWS
FLEET_ODD = (1, 3, 6)
FLEET_LONE = (0, 6)          # lanes held against their lone sessions
FLEET_F32_TOL = 5e-3         # the JAX f32 fleet test (tests/test_fleet.py)
RING_FLEET_DRAINS, PIT_FLEET_DRAINS = 5, 3
# An f32 pit_qr fleet lane's limit from the f64 answer (relative, each
# field, worst drain and lane): its f32 lone session itself stands up to
# 6.0e-3 from that answer and the lane up to 5.0e-3 (root PERF.md), two
# f32 roundings of one cancelling element build.
PIT_F32_TOL = 1e-2
# The kernels this slice added (the fleet's), in the summary line.
FLEET_NEW = ("batched_ring_append", "batched_obs_stats",
             "batched_quad_masked", "batched_mstep_rows")
# Kernels of an info tick, with their launches a tick (5 EM iterations +
# the reporting smooth; K3b-m and K6b once a M-step; K13b once).
FLEET_LAUNCHES = {"batched_ring_append": 1, "batched_obs_stats": 6,
                  "batched_info_scan": 6, "batched_quad_masked": 6,
                  "batched_rts": 6, "batched_mstep_rows": 5,
                  "batched_solve_rows": 5}


def fleet_tenants(seed: int, shapes=FLEET_SHAPES,
                  held: int = FLEET_HELD) -> list:
    """(fused info fit, fitted panel, held-out rows) of each fleet tenant
    of ``shapes`` (T0, N, k): its own masked panel (ragged edge, 5%
    missing) from ``seed + i``, the first T0 rows fitted with
    ``fit(fused=True)``, 10 iterations, ``held`` rows held out."""
    out = []
    backend = dt.TorchBackend(filter="info")
    for i, (T0, N_, K_) in enumerate(shapes):
        Ynan, _, _, _ = panel(seed + i, T0 + held, N_, K_)
        res = dt.fit(dt.DynamicFactorModel(n_factors=K_, dynamics="ar1"),
                     Ynan[:T0], backend=backend, fused=True, max_iters=10,
                     tol=0.0)
        if res.filter != "info" or not np.isfinite(res.logliks).all():
            raise AssertionError(f"fleet tenant {i}: fit failed")
        out.append((res, Ynan[:T0], Ynan[T0:]))
    return out


def fleet_cases(Yb, Wb, pt, t_new, label: str) -> list:
    """K2b-m, K4b-fwd over a per-step C, K1b-m, K4b-bwd, K3b-m and K6b (A's
    rows; their wide twins at 16 < k <= 32, each case named by the kernel
    its wrapper routes to) on the inputs the plain masked batched
    pipeline makes from a bucket's buffers ``Yb``/``Wb`` (B, T_cap, N) and
    stacked params ``pt`` at live lengths ``t_new``.  Call under
    ``highest_precision()``."""
    dtype = Yb.dtype
    B_, T_, N_ = Yb.shape
    k = pt.A.shape[-1]
    k2, k3, BTN = k * k, k ** 3, B_ * T_ * N_
    stats_ref = plain_call(lambda: tb._batched_obs_stats_masked_plain(
        Yb, Wb, pt.Lam, pt.R))
    b, C = stats_ref[0][:2]
    scan_ref = plain_call(lambda: tb._batched_info_scan_plain(
        b, C, pt.A, pt.Q, pt.mu0, pt.P0))
    scan = scan_ref[0]
    flt = scan[:4]
    sm_ref = plain_call(lambda: tb._batched_rts_plain(*flt, pt.A))
    x_sm, P_sm, P_lag = sm_ref[0]
    EffT = P_sm + tb._outer(x_sm)
    calls = []
    real = tb._bsolve_rows

    def record(S, V):
        calls.append((S.contiguous(), V.contiguous()))
        return tb._bsolve_rows_plain(S, V)

    tb._bsolve_rows = record
    try:
        tb.batched_m_step_masked(Yb, Wb, x_sm, P_sm, P_lag, pt,
                                 EMConfig(filter="info"), t_new)
    finally:
        tb._bsolve_rows = real
    (S, V), = calls
    return [
        case(kernels.route("batched_obs_stats", k), label,
             lambda: tb._batched_obs_stats_masked(Yb, Wb, pt.Lam, pt.R),
             lambda: tb._batched_obs_stats_masked_plain(Yb, Wb, pt.Lam,
                                                        pt.R),
             (Yb, Wb, pt.Lam, pt.R), BTN * (2 * k + k * (k + 1) + 6),
             ref=stats_ref),
        case(kernels.route("batched_info_scan", k), label,
             lambda: tb._batched_info_scan(b, C, pt.A, pt.Q, pt.mu0, pt.P0),
             lambda: tb._batched_info_scan_plain(b, C, pt.A, pt.Q, pt.mu0,
                                                 pt.P0),
             (b, C, pt.A, pt.Q, pt.mu0, pt.P0),
             B_ * T_ * (12.67 * k3 + 4 * k2),
             floor=lambda: latency_ms("info_scan", dtype, k, T_),
             ref=scan_ref),
        case(kernels.route("batched_quad_masked", k), label,
             lambda: tb._batched_quad_masked(Yb, Wb, pt.Lam, pt.R, scan[0],
                                             b, C),
             lambda: tb._batched_quad_masked_plain(Yb, Wb, pt.Lam, pt.R,
                                                   scan[0], b, C),
             (Yb, Wb, pt.Lam, pt.R, scan[0], b, C),
             BTN * (2 * k + 6) + B_ * T_ * 2 * k2),
        case(kernels.route("batched_rts", k), label,
             lambda: tb._batched_rts(*flt, pt.A),
             lambda: tb._batched_rts_plain(*flt, pt.A), (*flt, pt.A),
             B_ * T_ * (10.33 * k3 + 4 * k2),
             floor=lambda: latency_ms("rts_smoother", dtype, k, T_),
             ref=sm_ref),
        case(kernels.route("batched_mstep_rows", k), label,
             lambda: tb._batched_mstep_rows(Yb, Wb, x_sm, EffT, P_sm, 1e-6),
             lambda: tb._batched_mstep_rows_plain(Yb, Wb, x_sm, EffT, P_sm,
                                                  1e-6),
             (Yb, Wb, x_sm, EffT, P_sm),
             BTN * (4 * k + 2 * k * (k + 1) + 5)
             + B_ * N_ * (k3 // 3 + 6 * k2)),
        case(kernels.route("batched_solve_rows", k), f"{label} A rows",
             lambda: tb._bsolve_rows(S, V),
             lambda: tb._bsolve_rows_plain(S, V), (S, V),
             B_ * (k3 / 3 + 2 * V.shape[1] * k2),
             library=lambda: torch.cholesky_solve(
                 V.transpose(-1, -2), torch.linalg.cholesky(S))),
    ]


def fleet_ring_case(Yb, n_evict, t_cur, r_max: int, seed: int):
    """K13b's inputs at a bucket's next tick: each lane's ``r_max`` padded
    rows (the first 2 random with a full mask) and the (B,) int32 counts
    on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B_, _, N_ = Yb.shape
    rows = torch.zeros((B_, r_max, N_), dtype=Yb.dtype, device="cuda")
    rmask = torch.zeros_like(rows)
    rmask[:, :FLEET_ROWS] = 1.0
    rows[:, :FLEET_ROWS] = torch.randn((B_, FLEET_ROWS, N_), generator=g,
                                       dtype=Yb.dtype, device="cuda")
    counts = [torch.tensor(np.asarray(c), dtype=torch.int32, device="cuda")
              for c in (n_evict, t_cur)]
    return rows, rmask, counts


def fleet_ring_check(Yb, Wb, n_evict, t_cur, r_max: int, seed: int,
                     label: str, timed: bool = False):
    """K13b against its plain twin on copies of a bucket's buffers, bit for
    bit; with ``timed`` its record (warm / cold, plain, bound)."""
    rows, rmask, (ev, tc) = fleet_ring_case(Yb, n_evict, t_cur, r_max, seed)
    Yk, Wk, Yp, Wp = Yb.clone(), Wb.clone(), Yb.clone(), Wb.clone()
    n0 = kernels.LAUNCHES["batched_ring_append"]
    sb.batched_ring_evict_append(Yk, Wk, rows, rmask, ev, tc)
    launches = kernels.LAUNCHES["batched_ring_append"] - n0
    sb.batched_ring_evict_append_plain(Yp, Wp, rows, rmask, ev, tc)
    torch.cuda.synchronize()
    exact = torch.equal(Yk, Yp) and torch.equal(Wk, Wp)
    if not exact or launches != 1:
        err = max(float((Yk - Yp).abs().max()), float((Wk - Wp).abs().max()))
        raise AssertionError(f"batched_ring_append ({Yb.dtype}, {label}): "
                             f"bit_exact={exact} (max abs err {err}), "
                             f"launches {launches}")
    if not timed:
        return None
    B_, T_cap, N_ = Yb.shape
    run = lambda: sb.batched_ring_evict_append(Yk, Wk, rows, rmask, ev, tc)
    plain = lambda: sb.batched_ring_evict_append_plain(Yp, Wp, rows, rmask,
                                                       ev, tc)
    nbytes = sum(ring_bytes(T_cap, N_, r_max, int(e), int(t), Yb.itemsize)
                 for e, t in zip(n_evict, t_cur))
    bound_ms, bound_by = bound(nbytes, 0.0, Yb.dtype)
    return {"name": "batched_ring_append", "variant": label,
            "dtype": str(Yb.dtype).replace("torch.", ""), "B": B_,
            "T_cap": T_cap, "n_evict": [int(e) for e in n_evict],
            "bit_exact": exact, "max_abs_err": 0.0, "max_rel_err": 0.0,
            "tol": 0.0, "latency_ms": None, "kernel_ms": cuda_ms(run),
            "kernel_ms_cold_l2": cuda_ms_cold(run),
            "plain_ms": cuda_ms(plain), "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by, "launches": launches}


def fleet_kernel_check(bucket, label: str, seed: int,
                       timed: bool = False) -> dict:
    """Every kernel of the info tick against its plain twin on a bucket's
    own buffers and params, f64 then f32 (the TOL rule), K13b bit for bit
    at the bucket's next (n_evict, t_cur); with ``timed``, the f32 records
    (warm / cold L2, plain, bound, floor), returned by kernel name."""
    slots = [bucket.lane_of[ln] for ln in range(bucket.B)]
    t_cur = np.array([s.t for s in slots])
    n_evict = np.array([max(0, s.t + FLEET_ROWS - s.capacity)
                        for s in slots])
    t_new = torch.tensor(t_cur, dtype=torch.int32, device="cuda")
    refs, worst, recs = {}, {}, {}
    for dtype in (torch.float64, torch.float32):
        Yb = bucket.Ybuf.to(dtype).contiguous()
        Wb = bucket.Wbuf.to(dtype).contiguous()
        pt = SSMParams(*(x.to(dtype).contiguous() for x in bucket.p))
        with highest_precision():
            for c in fleet_cases(Yb, Wb, pt, t_new, label):
                key = (c["name"], c["variant"])
                abs_err, rel, tol, ref, plain_err = compare(c, dtype,
                                                            refs.get(key))
                refs[key] = ref
                worst[f"{c['name']} {str(dtype)[6:]}"] = rel
                if timed and dtype == torch.float32:
                    bound_ms, bound_by = bound(
                        nbytes_of(c["ins"]) + nbytes_of(ref), c["flops"],
                        dtype)
                    recs[c["name"]] = {
                        "name": c["name"], "variant": c["variant"],
                        "dtype": "float32", "B": bucket.B,
                        "max_rel_err": rel, "max_abs_err": abs_err,
                        "tol": tol, "plain_f32_err": plain_err,
                        "kernel_ms": cuda_ms(c["run"], warm=False),
                        "kernel_ms_cold_l2": cuda_ms_cold(
                            c["run"], c.get("cold_reps", COLD_REPS),
                            False),
                        "plain_ms": plain_ms(c),
                        "library_ms": (cuda_ms(c["library"])
                                       if c["library"] else None),
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "latency_ms": c["floor"]() if c["floor"] else None}
        rec = fleet_ring_check(Yb, Wb, n_evict, t_cur, bucket.r_max, seed,
                               label, timed=timed and dtype == torch.float32)
        worst[f"batched_ring_append {str(dtype)[6:]}"] = 0.0
        if rec is not None:
            recs["batched_ring_append"] = rec
        del Yb, Wb, pt
        torch.cuda.empty_cache()
    emit({"fleet_kernels": label, "B": bucket.B, "dims": bucket.dims,
          "max_rel_err": worst})
    for rec in recs.values():
        emit(rec)
    return recs


def lane_state(bucket, lane: int) -> list:
    """Copies of one lane's panel, mask and params on the card."""
    return [x[lane].clone() for x in (bucket.Ybuf, bucket.Wbuf, *bucket.p)]


def drain_timed(fleet) -> tuple:
    """One synchronized ``drain``: (its outputs, host wall s, the launch
    counts of its ticks, the blocking reads it made)."""
    reads = []
    read = fleet._read
    fleet._read = lambda out: reads.append(1) or read(out)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fleet.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fleet._read = read
    return out, wall, dict(kernels.LAUNCHES), len(reads)


def check_fleet_out(label: str, out: dict, N_of: dict) -> None:
    for name, ups in out.items():
        for u in ups:
            if not (np.isfinite(u.nowcast).all()
                    and np.isfinite(u.factors).all()
                    and np.isfinite(u.forecasts["di"]).all()
                    and u.nowcast.shape == (N_of[name],)):
                raise AssertionError(f"fleet {label}: non-finite output "
                                     f"for {name}")


def lone_close(label: str, u, ref) -> float:
    """The JAX f32 test's agreement of a fleet lane with its lone session
    (n_iters equal; nowcast and factors within 5e-3 relative + 5e-3
    absolute); returns the largest |fleet - lone|."""
    err = 0.0
    if u.n_iters != ref.n_iters or u.t != ref.t:
        raise AssertionError(f"{label}: n_iters / t {u.n_iters}/{u.t} vs "
                             f"lone {ref.n_iters}/{ref.t}")
    for f in ("nowcast", "factors"):
        a, b = getattr(u, f), getattr(ref, f)
        if not np.all(np.abs(a - b) <= FLEET_F32_TOL
                      + FLEET_F32_TOL * np.abs(b)):
            raise AssertionError(f"{label}: {f} off its lone session by "
                                 f"{float(np.abs(a - b).max()):.3e}")
        err = max(err, float(np.abs(a - b).max()))
    return err


def fleet_phase(seed: int, tenants: list, k: int = K,
                drains: int = FLEET_DRAINS, odd=FLEET_ODD, held=FLEET_LONE,
                label: str = "info", lone_all: bool = True, inert=(),
                kernel_check: bool = True) -> tuple:
    """The full-width info fleet (``drains`` drains; at odd drains only
    the ``odd`` tenants; one bucket at (FLEET_CAP, N, k), the wide twins
    at 16 < k <= 32, the generic ones past 32), the same rounds on lone
    sessions of every tenant (only of the ``held`` ones unless
    ``lone_all``; lanes ``held`` held to theirs within FLEET_F32_TOL),
    the padded factors of each (lane, k) of ``inert`` exactly 0 in the
    bucket's params after the last tick (loadings, A's rows and columns,
    mu0), then (with ``kernel_check``) every kernel of the tick on the
    bucket's buffers, timed.  Returns (launches by kernel over the ticks,
    the f32 kernel records; none without ``kernel_check``)."""
    backend = dt.TorchBackend(filter="info")
    names = [f"t{i}" for i in range(len(tenants))]
    N_of = {n: t[1].shape[1] for n, t in zip(names, tenants)}
    fleet = dt.open_fleet([t[0] for t in tenants], [t[1] for t in tenants],
                          capacity=FLEET_CAP, max_update_rows=FLEET_ROWS,
                          max_iters=FLEET_ITERS, tol=0.0, max_classes=1,
                          backend=backend)
    fleet.check_sync = True
    (bucket,) = fleet._buckets
    if bucket.dims != (FLEET_CAP, N, k) or bucket.B != len(tenants):
        raise AssertionError(f"fleet bucket {bucket}, expected one of "
                             f"{(FLEET_CAP, N, k)}")
    want = routed(FLEET_LAUNCHES, k)
    used = [0] * len(tenants)
    rounds, walls, ticks, per_tick, n_reads = [], [], [], [], []
    frozen_ok = None
    for d in range(drains):
        active = range(len(tenants)) if d % 2 == 0 else odd
        batch = {}
        for i in active:
            rows = tenants[i][2][used[i]:used[i] + FLEET_ROWS]
            used[i] += FLEET_ROWS
            fleet.submit(names[i], rows)
            batch[i] = rows
        rounds.append(batch)
        frozen = [ln for ln in range(bucket.B) if ln not in batch]
        before = ({ln: lane_state(bucket, ln) for ln in frozen}
                  if d == 1 else None)
        out, wall, launches, reads = drain_timed(fleet)
        check_fleet_out(label, out, N_of)
        if before is not None:
            frozen_ok = all(torch.equal(a, b) for ln in frozen
                            for a, b in zip(before[ln],
                                            lane_state(bucket, ln)))
            if not frozen_ok:
                raise AssertionError("fleet: a frozen lane changed across "
                                     "an odd tick")
        walls.append(wall)
        ticks.append(out[names[next(iter(batch))]][0].wall_s)
        per_tick.append(launches)
        n_reads.append(reads)
        if d == 0:
            results = out
        else:
            for n, ups in out.items():
                results.setdefault(n, []).extend(ups)
    bad = [d for d, c in enumerate(per_tick)
           if any(c[n] != want.get(n, 0) for n in c)]
    if bad or set(n_reads) != {1}:
        raise AssertionError(f"fleet ticks {bad}: launches "
                             f"{[per_tick[d] for d in bad]}, expected "
                             f"{want} and no other kernel; reads "
                             f"{n_reads}")
    n_q = sum(len(r) for r in rounds)
    p = bucket.p
    live = {(ln, kt): bool((p.Lam[ln, :, kt:] == 0).all()
                           and (p.A[ln, kt:, :] == 0).all()
                           and (p.A[ln, :, kt:] == 0).all()
                           and (p.mu0[ln, kt:] == 0).all())
            for ln, kt in inert}
    if not all(live.values()):
        raise AssertionError(f"fleet {label}: padded factors not inert "
                             f"{live}")
    # The same rounds on lone sessions.
    lone = {i: dt.open_session(t[0], t[1], backend=backend,
                               capacity=FLEET_CAP, max_update_rows=FLEET_ROWS,
                               max_iters=FLEET_ITERS, tol=0.0)
            for i, t in enumerate(tenants) if lone_all or i in held}
    q_walls, got, lone_err = [], [0] * len(tenants), {}
    for batch in rounds:
        for i, rows in batch.items():
            if i not in lone:
                continue
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u = lone[i].update(rows)
            torch.cuda.synchronize()
            q_walls.append(time.perf_counter() - t0)
            if i in held:
                e = lone_close(f"fleet lane {i}", results[names[i]][got[i]],
                               u)
                lone_err[names[i]] = max(lone_err.get(names[i], 0.0), e)
            got[i] += 1
    for s in lone.values():
        s.close()
    emit({"fleet": label, "B": bucket.B, "dims": bucket.dims,
          "filter": bucket.cfg.filter, "drains": drains,
          "queries": n_q, "tick_p50_ms": pct(walls, 50) * 1e3,
          "tick_p99_ms": pct(walls, 99) * 1e3,
          "ticks_ms": [w * 1e3 for w in walls],
          "wall_s_p50_ms": pct(ticks, 50) * 1e3,
          "queries_per_s": n_q / sum(walls),
          "reads_per_tick": sum(n_reads) / len(n_reads),
          "sync_checked": True,
          "launches_per_tick": {n: per_tick[0][n] for n in want},
          "frozen_lanes_bit_identical": frozen_ok,
          "padded_factors_inert": {f"lane {ln} k {kt}": v
                                   for (ln, kt), v in live.items()},
          "pad_waste_frac": fleet.pad_waste_frac,
          "lone": {"sessions": len(lone), "queries": len(q_walls),
                   "query_p50_ms": pct(q_walls, 50) * 1e3,
                   "query_p99_ms": pct(q_walls, 99) * 1e3,
                   "queries_per_s": len(q_walls) / sum(q_walls)},
          "fleet_over_lone_qps": (n_q / sum(walls))
          / (len(q_walls) / sum(q_walls)),
          "lane_vs_lone_max_abs": lone_err, "lone_tol": FLEET_F32_TOL})
    recs = (fleet_kernel_check(bucket, "fleet" if k == K else f"fleet k{k}",
                               seed + 300, timed=True)
            if kernel_check else {})
    fleet.close()
    return {n: sum(c[n] for c in per_tick) for n in want}, recs


def ring_fleet_phase(seed: int, tenants: list) -> None:
    """The six 10,000-series tenants as a ring fleet at capacity 480:
    every update evicts 2 rows (K13b's shift); 5 drains, lane 0 held
    against a lone ring session, every kernel of the tick on the bucket's
    buffers (K13b bit for bit at its next ring tick), timed."""
    backend = dt.TorchBackend(filter="info")
    big = tenants[:6]
    fleet = dt.open_fleet([t[0] for t in big], [t[1] for t in big],
                          capacity=SESSION_T0, max_update_rows=FLEET_ROWS,
                          max_iters=FLEET_ITERS, tol=0.0, max_classes=1,
                          ring=True, backend=backend)
    fleet.check_sync = True
    lone = dt.open_session(big[0][0], big[0][1], backend=backend,
                           capacity=SESSION_T0, max_update_rows=FLEET_ROWS,
                           max_iters=FLEET_ITERS, tol=0.0, ring=True)
    walls, err = [], 0.0
    for d in range(RING_FLEET_DRAINS):
        lo = d * FLEET_ROWS
        for i, t in enumerate(big):
            fleet.submit(f"t{i}", t[2][lo:lo + FLEET_ROWS])
        out, wall, launches, reads = drain_timed(fleet)
        check_fleet_out("ring", out, {f"t{i}": N for i in range(6)})
        if launches["batched_ring_append"] != 1 or reads != 1:
            raise AssertionError(f"ring fleet drain {d}: launches "
                                 f"{launches}, reads {reads}")
        walls.append(wall)
        err = max(err, lone_close("ring fleet lane 0", out["t0"][0],
                                  lone.update(big[0][2][lo:lo + FLEET_ROWS])))
    (bucket,) = fleet._buckets
    evicted = [s.n_evicted for s in bucket.slots]
    if evicted != [RING_FLEET_DRAINS * FLEET_ROWS] * 6:
        raise AssertionError(f"ring fleet evicted {evicted}")
    fleet_kernel_check(bucket, "ring fleet", seed + 400, timed=True)
    emit({"fleet": "ring", "B": bucket.B, "dims": bucket.dims,
          "drains": RING_FLEET_DRAINS, "n_evicted": evicted,
          "tick_p50_ms": pct(walls, 50) * 1e3,
          "ticks_ms": [w * 1e3 for w in walls],
          "lane0_vs_lone_max_abs": err, "sync_checked": True})
    lone.close()
    fleet.close()


def rel_err(a, b) -> float:
    """max|a - b| / max|b| (0 where both are 0) of two arrays, numbers or
    tensors."""
    if not isinstance(a, torch.Tensor):
        a, b = np.asarray(a), np.asarray(b)
    return float(abs(a - b).max()) / max(float(abs(b).max()), 1e-300)


def pit_fleet_phase(seed: int, tenants: list) -> None:
    """Two 10,000-series tenants with ``filter="pit_qr"``, 3 drains, beside
    lone pit_qr sessions on the same queries: first in f64, where every
    lane must equal its lone session within 1e-9 relative (the path
    check); then in f32 (timed), where the fleet lane and the lone session
    are each measured against that f64 answer, and the fleet lane must
    stand within PIT_F32_TOL of it (the f32 element build cancels at N =
    10,000 on both paths, root PERF.md)."""
    two = tenants[:2]
    kw = dict(capacity=FLEET_CAP, max_update_rows=FLEET_ROWS,
              max_iters=FLEET_ITERS, tol=0.0, filter="pit_qr")
    rec = {"fleet": "pit_qr", "B": 2, "drains": PIT_FLEET_DRAINS,
           "sync_checked": True}
    fields = lambda u: {"nowcast": u.nowcast, "factors": u.factors,  # noqa: E731
                        "forecast y": u.forecasts["y"]}
    ref64 = {}
    for dtype in (torch.float64, torch.float32):
        backend = dt.TorchBackend(dtype=dtype, filter="info")
        fleet = dt.open_fleet([t[0] for t in two], [t[1] for t in two],
                              max_classes=1, backend=backend, **kw)
        fleet.check_sync = True
        lone = [dt.open_session(t[0], t[1], backend=backend, **kw)
                for t in two]
        walls, errs = [], {}
        for d in range(PIT_FLEET_DRAINS):
            lo = d * FLEET_ROWS
            for i, t in enumerate(two):
                fleet.submit(f"t{i}", t[2][lo:lo + FLEET_ROWS])
            out, wall, launches, reads = drain_timed(fleet)
            check_fleet_out("pit_qr", out, {"t0": N, "t1": N})
            if (launches["batched_ring_append"] != 1 or reads != 1
                    or launches["qr_scan"] < 1 or launches["info_scan"]
                    or launches["batched_info_scan"]):
                raise AssertionError(f"pit_qr fleet drain {d}: launches "
                                     f"{launches}, reads {reads}")
            walls.append(wall)
            for i, t in enumerate(two):
                u = out[f"t{i}"][0]
                ref = lone[i].update(t[2][lo:lo + FLEET_ROWS])
                if (u.n_iters, u.t) != (ref.n_iters, ref.t):
                    raise AssertionError(f"pit_qr fleet lane {i}: n_iters "
                                         "or t differ from its lone session")
                fu, fr = fields(u), fields(ref)
                if dtype == torch.float64:
                    ref64[d, i] = fr
                    pairs = {"fleet_vs_lone": fu}
                    base = fr
                else:
                    pairs = {"fleet_vs_f64": fu, "lone_vs_f64": fr}
                    base = ref64[d, i]
                for key, got in pairs.items():
                    e = errs.setdefault(key, {})
                    for f in got:
                        e[f] = max(e.get(f, 0.0), rel_err(got[f], base[f]))
        name = str(dtype).replace("torch.", "")
        rec[name] = {"tick_p50_ms": pct(walls, 50) * 1e3,
                     "ticks_ms": [w * 1e3 for w in walls],
                     "max_rel_err": errs}
        for s in lone:
            s.close()
        fleet.close()
    rec["float64"]["tol"] = 1e-9
    rec["float32"]["tol"] = PIT_F32_TOL
    emit(rec)
    bad = {f: e for f, e in rec["float64"]["max_rel_err"]["fleet_vs_lone"]
           .items() if not e <= 1e-9}
    if bad:
        raise AssertionError(f"pit_qr fleet (f64) off its lone sessions: "
                             f"{bad}")
    e32 = rec["float32"]["max_rel_err"]
    bad = {f: e for f, e in e32["fleet_vs_f64"].items()
           if not e <= PIT_F32_TOL}
    if bad:
        raise AssertionError(f"pit_qr fleet (f32) off the f64 answer: "
                             f"{bad}")


def fleet_k_sweep(seed: int, ks=(1, 3, 16)) -> None:
    """The fleet path at other factor counts (by default k = 1, 3 and 16,
    the ends of the kernels' compile-time dispatch) on small tenants (50 x
    100 and 60 x 120, fitted on the CPU in f64): one sync-checked drain of
    a card f32 fleet, then every kernel of the tick against its plain twin
    on the bucket's buffers (f64 and f32, the TOL rule; K13b bit for
    bit)."""
    cpu = dt.TorchBackend(device="cpu", dtype=torch.float64, filter="info")
    for k in ks:
        tens = []
        for i, (T0, N_) in enumerate(((50, 100), (60, 120))):
            Ynan, _, _, _ = panel(seed + 700 + i, T0 + 4, N_, k)
            res = dt.fit(dt.DynamicFactorModel(n_factors=k), Ynan[:T0],
                         backend=cpu, fused=True, max_iters=4, tol=0.0)
            tens.append((res, Ynan[:T0], Ynan[T0:]))
        fl = dt.open_fleet([t[0] for t in tens], [t[1] for t in tens],
                           capacity=64, max_update_rows=FLEET_ROWS,
                           max_iters=3, tol=0.0, max_classes=1,
                           backend=dt.TorchBackend(filter="info"))
        fl.check_sync = True
        for i, t in enumerate(tens):
            fl.submit(f"t{i}", t[2][:FLEET_ROWS])
        out, _, launches, reads = drain_timed(fl)
        check_fleet_out(f"k = {k}", out, {"t0": 100, "t1": 120})
        if launches["batched_ring_append"] != 1 or reads != 1:
            raise AssertionError(f"fleet k = {k}: launches {launches}, "
                                 f"reads {reads}")
        fleet_kernel_check(fl._buckets[0], f"fleet k = {k}", seed + k)
        fl.close()


# The lowrank fleets' diffusion-index forecast, card f64 against CPU f64:
# a limit from readings.  At rank 4 < k the regression's factor block is
# nearly collinear (condition ~1e10 at k = 40), so factors that agree to
# ~4e-14 give forecasts ~1e-8 apart (7.1e-9, 9.3e-9 and 1.2e-8 in three
# runs on an H100); a ridge of 1e-7 instead of 1e-8 moves them by 0.48.
# Every other output of a reference fleet is held to 1e-12.
DI_REF_TOL = 1e-7

# The JAX trio fixture's tenants (T0, N, k) and ticks (rows per tenant).
FLEET_REF_SHAPES = ((40, 10, 2), (44, 12, 2), (44, 12, 2))
FLEET_REF_TICKS = ((1, 3, 2), (2, 0, 1), (3, 2, 3))


def fleet_reference_phase(seed: int, shapes=FLEET_REF_SHAPES,
                          ticks=FLEET_REF_TICKS, capacity: int = 56,
                          flt: str = "info", rank: int = 0,
                          to_divergence: bool = False) -> None:
    """A fleet in f64 on the card against the CPU, within 1e-12 relative:
    by default at the JAX trio fixture's shapes (10 x 40 and two 12 x 44,
    k = 2, capacity 56), three ragged ticks (one tenant sits out the
    second); the tenants' fused fits are info fits, the fleet's engine
    ``flt`` (``rank`` for lowrank).  A lowrank fleet's diffusion-index
    forecast is held to ``DI_REF_TOL`` instead.  With ``to_divergence``
    the values are held on the ticks before a lane's first divergence (at
    least one; that tick's flags must agree too)."""
    cpu = dt.TorchBackend(device="cpu", dtype=torch.float64, filter="info")
    tens = []
    for i, (T0, N_, k) in enumerate(shapes):
        Ynan, _, _, _ = panel(seed + 500 + i, T0 + 10, N_, k)
        res = dt.fit(dt.DynamicFactorModel(n_factors=k), Ynan[:T0],
                     backend=cpu, fused=True, max_iters=8, tol=0.0)
        tens.append((res, Ynan[:T0], Ynan[T0:]))
    outs = {}
    for dev in ("cuda", "cpu"):
        b = dt.TorchBackend(device=dev, dtype=torch.float64, filter="info")
        kernels.reset_launches()
        fl = dt.open_fleet([t[0] for t in tens], [t[1] for t in tens],
                           capacity=capacity, max_update_rows=3,
                           max_iters=4, tol=0.0, max_classes=1, backend=b,
                           filter=flt, rank=rank)
        fl.check_sync = dev == "cuda"
        used, got = [0] * len(tens), []
        for tick in ticks:
            for i, n in enumerate(tick):
                if n:
                    fl.submit(f"t{i}", tens[i][2][used[i]:used[i] + n])
                    used[i] += n
            got.append(fl.drain())
        outs[dev] = got
        if dev == "cuda":
            k_max = max(sh[2] for sh in shapes)
            idle = [n for n in routed(FLEET_LAUNCHES if flt == "info"
                                      else LR_FLEET_LAUNCHES, k_max, rank)
                    if not kernels.LAUNCHES[n]]
            if idle:
                raise AssertionError(f"fleet reference: the card run did "
                                     f"not launch {idle}")
        fl.close()
    errs, held = {}, 0
    for og, oc in zip(outs["cuda"], outs["cpu"]):
        for name in oc:
            ug, uc = og[name][0], oc[name][0]
            if (ug.n_iters, ug.t, ug.diverged) != (uc.n_iters, uc.t,
                                                   uc.diverged):
                raise AssertionError(f"fleet reference {name}: n_iters/t")
        # EM at r < k is not monotone: from a lane's first divergence the
        # two runs' rolled-back states part ways (as a lane and its lone
        # session do, ``lowrank_fleet_phase``).
        if to_divergence and any(u[0].diverged for u in oc.values()):
            break
        held += 1
        for name in oc:
            ug, uc = og[name][0], oc[name][0]
            for f in ("nowcast", "factors", "factor_cov", "logliks",
                      "nowcast_sd"):
                e = rel_err(getattr(ug, f), getattr(uc, f))
                errs[f] = max(errs.get(f, 0.0), e)
            for key in ("y", "f", "di"):
                e = rel_err(ug.forecasts[key], uc.forecasts[key])
                errs[f"forecast {key}"] = max(errs.get(f"forecast {key}",
                                                  0.0), e)
    tol = {n: 1e-12 for n in errs}
    if flt != "info":
        tol["forecast di"] = DI_REF_TOL
    emit({"fleet_reference": flt, "shapes": shapes, "capacity": capacity,
          "ticks_held": held, "max_rel_err": errs, "tol": tol})
    bad = {n: e for n, e in errs.items() if not e <= tol[n]}
    if bad or not held:
        raise AssertionError(f"fleet reference disagrees: {bad} (ticks "
                             f"held {held})")

# ---------------------------------------------------------------------------
# The rank-r engine (K9): the headline panel simulated at k = 16 (the widest
# k the rest of its path takes), rank 8 (the engine's default cap).
# ---------------------------------------------------------------------------

LR_K, LR_RANK = 16, 8
LOWRANK = ("lowrank_basis", "lowrank_scan", "lowrank_smoother")
LR_SWEEP = ((1, 1), (3, 3), (16, 16), (17, 8), (50, 8), (100, 8), (100, 32))
LR_FLEET_TENANTS, LR_FLEET_DRAINS = 2, 2
LR_LONE = (0, 1)             # lanes held against their lone sessions
# Kernels of a lowrank tick and their launches a tick (5 EM iterations +
# the reporting smooth; K3b-m and K6b once a M-step; K13b once).
LR_FLEET_LAUNCHES = {"batched_ring_append": 1, "batched_obs_stats": 6,
                     "lowrank_basis": 6, "lowrank_scan": 6,
                     "batched_quad_masked": 6, "lowrank_smoother": 6,
                     "batched_mstep_rows": 5, "batched_solve_rows": 5}


def lowrank_flops(k: int, r: int, T_: int) -> tuple:
    """Operations of (K9-basis, K9-fwd, K9-bwd) on one lane: a symmetric
    eigendecomposition with vectors ~9 k^3; a forward step 4 k^3 (the
    predict) + 6 k^2 r (C V, P J, the downdate) + 8 k r^2 (the r x r
    products and the k solves with S) + r^3 (two factorizations); a
    backward step 10 k^2 r + 8 k r^2 + 5 r^3."""
    return (9.0 * k ** 3,
            T_ * (4.0 * k ** 3 + 6.0 * k * k * r + 8.0 * k * r * r
                  + r ** 3),
            T_ * (10.0 * k * k * r + 8.0 * k * r * r + 5.0 * r ** 3))


def lowrank_cases(Y, W, p, r: int, label: str) -> list:
    """K9-basis (compared on its projector V V'), K9-fwd and K9-bwd on the
    inputs the plain pipeline makes from a panel on the card: ``Y`` (T, N)
    with params ``p``, or a bucket's (B, T, N) with stacked params; masked
    when ``W`` is given (the statistics from the plain K2b-m twin, which
    takes any k), else the static C.  Call under ``highest_precision()``."""
    if Y.ndim == 2:
        Y = Y[None]
        W = None if W is None else W[None]
        p = SSMParams(*(x[None] for x in p))
    B_, T_ = Y.shape[0], Y.shape[1]
    k = p.A.shape[-1]
    G = p.Lam / p.R[..., None]
    C = torch.matmul(G.transpose(-1, -2), p.Lam).contiguous()
    if W is None:
        b, Ct = torch.matmul(torch.nan_to_num(Y), G), C
    else:
        b, Ct, _, _ = tb._batched_obs_stats_masked_plain(Y, W, p.Lam, p.R)
    V = lr.lowrank_basis_plain(C, r)
    fwd_in = (b, Ct, V, p.A, p.Q, p.mu0, p.P0)
    fwd = lr.lowrank_scan_plain(*fwd_in)
    bwd_in = (*fwd[:4], p.A, V)
    fb, ff, fs = (B_ * f for f in lowrank_flops(k, r, T_))
    return [
        case("lowrank_basis", label, lambda: lr.lowrank_basis(C, r),
             lambda: lr.lowrank_basis_plain(C, r), (C,), fb,
             library=lambda: torch.linalg.eigh(C), gram=(0,)),
        case("lowrank_scan", label, lambda: lr.lowrank_scan(*fwd_in),
             lambda: lr.lowrank_scan_plain(*fwd_in), fwd_in, ff),
        case("lowrank_smoother", label,
             lambda: lr.lowrank_smoother_scan(*bwd_in),
             lambda: lr.lowrank_smoother_scan_plain(*bwd_in), bwd_in, fs),
    ]


def eigh_syncs(C) -> bool:
    """Whether ``torch.linalg.eigh`` on the card synchronizes with the host
    (raises under ``set_sync_debug_mode("error")``)."""
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.linalg.eigh(C)
        return False
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize()


def lowrank_kernel_phase(seed: int) -> dict:
    """K9 at the full width (T = 500, N = 10,000, k = 16, r = 8), masked
    and unmasked, f64 then f32, each kernel against its plain twin (the
    TOL rule) and timed (``kernel_record``; K9-basis beside
    ``torch.linalg.eigh``).  Returns the f32 masked records by name."""
    Ynan, W, Yfull, p = panel(seed + 800, K_=LR_K)
    summary, refs = {}, {}
    for dtype in (torch.float64, torch.float32):
        Yt, mt, Yf = (torch.as_tensor(a, dtype=dtype, device="cuda")
                      .contiguous() for a in (Ynan, W, Yfull))
        pt = SSMParams.from_numpy(p, dtype=dtype, device="cuda")
        with highest_precision():
            for c in (lowrank_cases(Yt, mt, pt, LR_RANK, "masked")
                      + lowrank_cases(Yf, None, pt, LR_RANK, "unmasked")):
                if c["name"] != "lowrank_basis":    # K4's chain at (T, k)
                    c["floor"] = functools.partial(
                        latency_ms, "info_scan" if c["name"] ==
                        "lowrank_scan" else "rts_smoother", dtype, LR_K)
                rec = kernel_record(c, dtype, refs)
                rec.update({"k": LR_K, "r": LR_RANK})
                emit(rec)
                if dtype == torch.float32 and c["variant"] == "masked":
                    summary[c["name"]] = rec
        del Yt, mt, Yf
        torch.cuda.empty_cache()
    C = torch.matmul((pt.Lam / pt.R[:, None]).T, pt.Lam)
    emit({"eigh_syncs_on_card": eigh_syncs(C), "k": LR_K})
    return summary


def lowrank_k_sweep(seed: int) -> None:
    """K9 at other (k, r), the kernels' range to its ends (k = 100, r =
    32), on 120 x 400 panels with a fully missing step and a step
    observing 2r series (fewer than k where 2r < k), masked and unmasked,
    f64 and f32: error checks only."""
    for k, r in LR_SWEEP:
        _, W, Yfull, p = panel(seed + 810 + k, T_=120, N_=400, K_=k)
        W[7] = 0.0
        W[11] = 0.0
        W[11, :2 * r] = 1.0
        Ynan = np.where(W > 0, Yfull, np.nan)
        refs, worst = {}, {}
        for dtype in (torch.float64, torch.float32):
            Yt, mt, Yf = (torch.as_tensor(a, dtype=dtype, device="cuda")
                          .contiguous() for a in (Ynan, W, Yfull))
            pt = SSMParams.from_numpy(p, dtype=dtype, device="cuda")
            with highest_precision():
                for c in (lowrank_cases(Yt, mt, pt, r, "masked")
                          + lowrank_cases(Yf, None, pt, r, "unmasked")):
                    key = (c["name"], c["variant"])
                    _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                    refs[key] = ref
                    name = f"{c['name']} {c['variant']} {str(dtype)[6:]}"
                    worst[name] = rel
        emit({"lowrank_k_sweep": [k, r], "max_rel_err": worst})


def lowrank_f64_lls(Y, W, n: int, k: int = LR_K,
                    rank: int = LR_RANK) -> np.ndarray:
    """The f64 lowrank EM trajectory on the card (``em_fit_scan``, no stop
    rule) from the init ``fit`` computes, for ``n`` iterations: the
    yardstick of an f32 loglik drop."""
    Z, _ = data.standardize(Y, mask=W)
    Zt = torch.as_tensor(np.where(np.isfinite(Z), Z, 0.0),
                         dtype=torch.float64, device="cuda")
    mt = (torch.as_tensor(W, dtype=torch.float64, device="cuda")
          if W is not None else None)
    with highest_precision():
        p0 = SSMParams.from_numpy(pca_init_device(Zt, k),
                                  dtype=torch.float64, device="cuda")
        _, lls, _ = em_fit_scan(Zt, p0, n, mask=mt,
                                cfg=EMConfig(filter="lowrank", rank=rank))
    return lls.cpu().numpy()


def lowrank_fit_phase(seed: int) -> tuple:
    """``fit(filter="lowrank", rank=8)`` at 10,000 x 500, k = 16: masked
    (20 iterations) and unmasked (10), tol = 0, then ``fit(fused=True)``
    on the masked panel's first 480 rows (20 iterations).  EM at r < k is
    EM on an approximate likelihood, so a loglik drop past the f32 noise
    floor passes only where the f64 trajectory from ``fit``'s init drops
    too (and the chunked driver's divergence rule may stop the fit there).
    Launches: per iteration 1 K9-basis, 1 K9-fwd, 1 K9-bwd, 1 K1, + 1 K2
    and 1 K3 masked; the reporting smooth is the exact info pair (1 K2
    masked, 1 K4 pair, 1 K1).  Returns (launch counts by fit, the fused
    fit)."""
    Ynan, W, Yfull, _ = panel(seed + 801, K_=LR_K)
    model = dt.DynamicFactorModel(n_factors=LR_K, dynamics="ar1")
    backend = dt.TorchBackend(filter="lowrank", rank=LR_RANK)
    floor = noise_floor_for(torch.float32, T * N)
    counts = {}
    for label, masked, iters in (("lowrank masked", True, 20),
                                 ("lowrank unmasked", False, 10)):
        Y = Ynan if masked else Yfull
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = dt.fit(model, Y, backend=backend, max_iters=iters, tol=0.0)
        y_fore, f_fore = dt.forecast(res, 12)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        lls = res.logliks
        n = len(lls)
        chunk = backend.fused_chunk
        ran = min(iters, -(-n // chunk) * chunk)    # whole chunks run
        ll64 = lowrank_f64_lls(Y, W if masked else None, n)
        drops = [i for i in range(1, n) if lls[i] < lls[i - 1] - floor]
        unexplained = [i for i in drops if not ll64[i] < ll64[i - 1]]
        steady = [h["secs"] for h in res.history[chunk:]]
        per_iter = {nm: launches[nm] / ran for nm in
                    (*LOWRANK, "quad_local", "obs_stats", "mstep_rows")}
        emit({"fit": label, "filter": res.filter, "rank": LR_RANK, "k": LR_K,
              "n_iters": res.n_iters, "iterations_run": ran,
              "converged": res.converged,
              "loglik_first": float(lls[0]), "loglik_last": float(lls[-1]),
              "drops_past_floor": drops,
              "f64_drops": [i for i in range(1, n) if ll64[i] < ll64[i - 1]],
              "max_drop": float(max(0.0, -np.diff(lls).min())),
              "noise_floor": floor, "wall_s": wall,
              "em_iters_per_sec": (len(steady) / sum(steady)
                                   if steady and sum(steady) > 0 else None),
              "launches_per_iter": per_iter, "launches": launches})
        want = {"lowrank_basis": ran, "lowrank_scan": ran,
                "lowrank_smoother": ran, "quad_local": ran + 1,
                "obs_stats": ran + 1 if masked else 0,
                "mstep_rows": ran if masked else 0, "info_scan": 1,
                "rts_smoother": 1}
        bad = {nm: launches[nm] for nm in launches
               if launches[nm] != want.get(nm, 0)}
        if res.filter != "lowrank" or bad:
            raise AssertionError(f"{label}: filter {res.filter}, launches "
                                 f"off the path's {want}: {bad}")
        if not np.isfinite(lls).all() or unexplained:
            raise AssertionError(f"{label}: non-finite loglik or drops past "
                                 f"the noise floor at {unexplained} that "
                                 "the f64 trajectory does not make")
        if n != iters and not (drops and drops[-1] == n - 1):
            raise AssertionError(f"{label}: stopped after {n} iterations")
        for name, arr in (("factors", res.factors), ("y_fore", y_fore),
                          ("f_fore", f_fore)):
            if not np.isfinite(arr).all():
                raise AssertionError(f"{label}: non-finite {name}")
        counts[label] = launches
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    fused = dt.fit(model, Ynan[:SESSION_T0], backend=backend, fused=True,
                   max_iters=20, tol=0.0)
    wall = time.perf_counter() - t0
    emit({"fused_fit": "lowrank", "filter": fused.filter,
          "n_iters": fused.n_iters, "host_reads": fused.host_reads,
          "converged": fused.converged, "diverged": fused.nowcast is None,
          "wall_s": wall, "loglik_last": float(fused.logliks[-1]),
          "launches": dict(kernels.LAUNCHES)})
    if (fused.filter != "lowrank" or not np.isfinite(fused.logliks).all()
            or any(kernels.LAUNCHES[nm] < 1 for nm in LOWRANK)):
        raise AssertionError("lowrank fused fit failed")
    return counts, fused


def lowrank_reference_phase(seed: int) -> None:
    """The lowrank fits at 120 x 80, k = 3, rank 2 (masked, unmasked,
    and the masked fused fit), on the card in f64 against the CPU in f64,
    within 1e-9 relative."""
    Ynan, _, Yfull, _ = panel(seed + 3, T_=120, N_=80, K_=3)
    model = dt.DynamicFactorModel(n_factors=3, dynamics="ar1")
    errs = {}
    for label, Y, fused in (("masked", Ynan, False),
                            ("unmasked", Yfull, False),
                            ("masked fused", Ynan, True)):
        res = {}
        for dev in ("cuda", "cpu"):
            b = dt.TorchBackend(device=dev, dtype=torch.float64,
                                filter="lowrank", rank=2)
            kernels.reset_launches()
            r = dt.fit(model, Y, backend=b, max_iters=10, tol=0.0,
                       fused=fused)
            res[dev] = (r, dt.forecast(r, 12)[0], dict(kernels.LAUNCHES))
        (rg, yg, lg), (rc, yc, _) = res["cuda"], res["cpu"]
        if any(lg[nm] == 0 for nm in LOWRANK) or rg.n_iters != rc.n_iters:
            raise AssertionError(f"lowrank reference {label}: launches {lg}, "
                                 f"n_iters {rg.n_iters} / {rc.n_iters}")
        for name, g, c in (("logliks", rg.logliks, rc.logliks),
                           ("Lam", rg.params.Lam, rc.params.Lam),
                           ("R", rg.params.R, rc.params.R),
                           ("A", rg.params.A, rc.params.A),
                           ("factors", rg.factors, rc.factors),
                           ("y_fore", yg, yc)):
            errs[f"{label} {name}"] = rel_err(g, c)
    emit({"reference": "lowrank", "shape": [120, 80, 3], "rank": 2,
          "max_rel_err": errs, "tol": 1e-9})
    bad = {n: e for n, e in errs.items() if not e <= 1e-9}
    if bad:
        raise AssertionError(f"lowrank card fit disagrees with the CPU "
                             f"fit: {bad}")


def lowrank_contract_phase(seed: int, k: int = LR_K, rank: int = LR_RANK,
                           seed_off: int = 801, maskings=(True, False),
                           limit: float = 1e-5) -> None:
    """The loglik contract of the rank-r engine at iteration 3: f32 params
    after 2 updates, evaluated by the f64 lowrank filter on the card, against
    the f64 lowrank trajectory's loglik at its 2-update params (masked and
    unmasked, k = 16, r = 8; the headline panel simulated at k from seed +
    ``seed_off``), within ``limit`` (1e-5; where the JAX package's own run
    misses it at the same inputs, its figure: ROADMAP Queue 3)."""
    Ynan, W, Yfull, _ = panel(seed + seed_off, K_=k)
    dev = torch.device("cuda")
    cfg = EMConfig(filter="lowrank", rank=rank)
    for masked in maskings:
        Wm = W if masked else None
        Z, _ = data.standardize(Ynan if masked else Yfull, mask=Wm)
        Z = np.where(np.isfinite(Z), Z, 0.0)
        with highest_precision():
            p0 = pca_init_device(
                torch.as_tensor(Z, dtype=torch.float64, device=dev), k)
            lls = {}
            for dtype in (torch.float32, torch.float64):
                Yt = torch.as_tensor(Z, dtype=dtype, device=dev)
                mt = (torch.as_tensor(Wm, dtype=dtype, device=dev)
                      if masked else None)
                pt = SSMParams.from_numpy(p0, dtype=dtype, device=dev)
                ps, ll, _ = em_fit_scan(Yt, pt, 3, mask=mt, cfg=cfg)
                lls[dtype] = (ps, ll.cpu().numpy())
            ref = float(lls[torch.float64][1][2])
            p2 = lls[torch.float32][0][1].to(dtype=torch.float64)
            Z64 = torch.as_tensor(Z, dtype=torch.float64, device=dev)
            m64 = (torch.as_tensor(Wm, dtype=torch.float64, device=dev)
                   if masked else None)
            precise = float(lr.lowrank_filter(Z64, p2, mask=m64,
                                              rank=rank).loglik)
        rel = abs(precise - ref) / abs(ref)
        fast = abs(float(lls[torch.float32][1][2]) - ref) / abs(ref)
        emit({"contract": f"{'masked' if masked else 'unmasked'} lowrank",
              "k": k, "rank": rank, "iter": 3, "loglik_f64": ref,
              "rel_err_precise": rel, "rel_err_fast": fast, "limit": limit})
        if not rel < limit:
            raise AssertionError(f"lowrank loglik contract broken: {rel:.3e}")


def lowrank_session_phase(seed: int, fused) -> None:
    """A lowrank session on the fused lowrank fit, capacity 1,000, 4
    queries of 2 rows (rows 480-487) and a re-forecast, 5 iterations a
    query, each query's device work under ``set_sync_debug_mode("error")``:
    exactly 1 read and 1 K13 a query, and 6 launches each of K9-basis,
    K9-fwd and K9-bwd (5 EM iterations + the reporting smooth through the
    lowrank pair); p50/p99; the query's kernel times; then every kernel of
    its path against its plain twin on the session's own buffers."""
    Ynan, _, _, _ = panel(seed + 801, K_=LR_K)
    backend = dt.TorchBackend(filter="lowrank", rank=LR_RANK)
    sess = dt.open_session(fused, Ynan[:SESSION_T0], backend=backend,
                           capacity=1000, max_update_rows=8, max_iters=5,
                           tol=0.0)
    sess.check_sync = True
    reads = []
    read = sess._read
    sess._read = lambda out: reads.append(1) or read(out)
    walls, calls, per_query = [], [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    for q in range(SESSION_UPDATES + 1):
        lo = SESSION_T0 + q * SESSION_ROWS
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        u = sess.update(Ynan[lo:lo + SESSION_ROWS]
                        if q < SESSION_UPDATES else None)
        torch.cuda.synchronize()
        if q < SESSION_UPDATES:
            walls.append(u.wall_s)
            calls.append(time.perf_counter() - c0)
        per_query.append({n: kernels.LAUNCHES[n] - before[n]
                          for n in kernels.LAUNCHES})
        if not (np.isfinite(u.nowcast).all() and np.isfinite(u.factors).all()
                and u.nowcast.shape == (N,)):
            raise AssertionError("lowrank session: non-finite output")
    want = {"ring_append": 1, **{n: 6 for n in LOWRANK}}
    bad = [q for q, c in enumerate(per_query)
           if any(c[n] != v for n, v in want.items())]
    # The query's kernels at its shapes (warm L2): K2, the K9 trio and K1
    # once an E-step (6), K3 once a M-step (5), K13 once.
    Yb, Wb, pt = sess._Ybuf, sess._Wbuf, sess._p
    with highest_precision():
        stats = inf.obs_stats(Yb, pt.Lam, pt.R, Wb)
        V = lr.policy_basis(pt.Lam, pt.R, LR_RANK)
        fwd = lr.lowrank_from_stats(stats, pt, LR_RANK, V=V)
        kf = FilterResult(*fwd[:4], torch.zeros((), dtype=Yb.dtype))
        sm = lr.lowrank_smoother(kf, pt, LR_RANK, V=V)
        EffT, _ = moments(sm)
        ms = {"obs_stats": cuda_ms(lambda: inf.obs_stats(Yb, pt.Lam, pt.R,
                                                         Wb)),
              "lowrank_basis": cuda_ms(lambda: lr.policy_basis(
                  pt.Lam, pt.R, LR_RANK)),
              "lowrank_scan": cuda_ms(lambda: lr.lowrank_from_stats(
                  stats, pt, LR_RANK, V=V)),
              "quad_local": cuda_ms(lambda: inf.quad_local(
                  Yb, pt.Lam, pt.R, fwd[0], Wb)),
              "lowrank_smoother": cuda_ms(lambda: lr.lowrank_smoother(
                  kf, pt, LR_RANK, V=V)),
              "mstep_rows": cuda_ms(lambda: mstep_rows(
                  Yb, Wb, sm.x_sm, EffT, sm.P_sm, None, 1e-6))}
    per_q = {n: v * (5 if n == "mstep_rows" else 6) for n, v in ms.items()}
    p50 = pct(walls, 50) * 1e3
    emit({"session": "lowrank", "filter": sess.filter, "rank": sess.rank,
          "key": sess.key, "capacity": sess.capacity, "t": sess.t,
          "queries": SESSION_UPDATES, "p50_ms": p50,
          "p99_ms": pct(walls, 99) * 1e3,
          "walls_ms": [w * 1e3 for w in walls],
          "call_p50_ms": pct(calls, 50) * 1e3,
          "reads_per_query": len(reads) / len(per_query),
          "sync_checked": True,
          "launches_per_query": {n: per_query[-2][n] for n in
                                 ("ring_append", *LOWRANK, "obs_stats",
                                  "quad_local", "mstep_rows")},
          "query_breakdown": {"kernel_ms": ms, "per_query_ms": per_q,
                              "rest_ms": p50 - sum(per_q.values())}})
    if bad or len(reads) != len(per_query) or sess.filter != "lowrank":
        raise AssertionError(f"lowrank session: queries {bad} off {want}; "
                             f"reads {len(reads)}, engine {sess.filter}")
    session_kernel_check(sess, "lowrank", seed + 71)
    sess.close()


def lowrank_fleet_phase(seed: int, k: int = LR_K,
                        n_tenants: int = LR_FLEET_TENANTS,
                        drains: int = LR_FLEET_DRAINS) -> None:
    """4 tenants of 480 x 10,000 at k = 16 (``n_tenants`` at k; fused
    lowrank fits, 10 iterations: the fleet inherits their engine, rank
    auto = 8) in one bucket at capacity 1,000, 2 drains (``drains``) of 2
    rows, 5 iterations, tol = 0,
    beside lone lowrank sessions of lanes LR_LONE on the same queries,
    first in f64, then in f32 (timed).  Each tick's device part runs under
    ``set_sync_debug_mode("error")`` with 1 read and exactly
    LR_FLEET_LAUNCHES.  EM at r < k is not monotone, and a fleet lane and
    a lone session handle a divergence differently (in the JAX package
    too: the lane rolls back the offending update, the session keeps its
    chunk's last-good params), so a lane tracks its lone session up to
    its first divergence: in f64 each held lane equals its lone session
    within 1e-9 relative on every query up to and including the first one
    that diverges on either side (the path check; at least one query).
    In f32 the lane is measured against the f64 lane and the lone session
    against the f64 lone session, and reported.  Then every kernel of the
    tick against its plain twin on the f32 bucket's own buffers (the wide
    twins of K2b-m, K1b-m, K3b-m and K6b at 16 < k <= 32)."""
    model = dt.DynamicFactorModel(n_factors=k, dynamics="ar1")
    held = drains * FLEET_ROWS
    fit_b = dt.TorchBackend(filter="lowrank", rank=LR_RANK)
    tens = []
    for i in range(n_tenants):
        Ynan, _, _, _ = panel(seed + 820 + i, SESSION_T0 + held, N, k)
        res = dt.fit(model, Ynan[:SESSION_T0], backend=fit_b, fused=True,
                     max_iters=10, tol=0.0)
        if res.filter != "lowrank" or not np.isfinite(res.logliks).all():
            raise AssertionError(f"lowrank fleet tenant {i}: fit failed")
        tens.append((res, Ynan[:SESSION_T0], Ynan[SESSION_T0:]))
    kw = dict(capacity=FLEET_CAP, max_update_rows=FLEET_ROWS,
              max_iters=FLEET_ITERS, tol=0.0)
    N_of = {f"t{i}": N for i in range(n_tenants)}
    expect = routed(LR_FLEET_LAUNCHES, k)
    rec = {"fleet": "lowrank", "k": k, "B": n_tenants, "drains": drains,
           "queries": drains * n_tenants, "held_lanes": LR_LONE,
           "sync_checked": True}
    ref64, bad = {}, []
    for dtype in (torch.float64, torch.float32):
        backend = dt.TorchBackend(dtype=dtype, filter="lowrank",
                                  rank=LR_RANK)
        fleet = dt.open_fleet([t[0] for t in tens], [t[1] for t in tens],
                              max_classes=1, backend=backend, **kw)
        fleet.check_sync = True
        (bucket,) = fleet._buckets
        if (bucket.dims != (FLEET_CAP, N, k) or bucket.B != len(tens)
                or bucket.cfg.filter != "lowrank"):
            raise AssertionError(f"lowrank fleet bucket {bucket}")
        lone = {i: dt.open_session(tens[i][0], tens[i][1], backend=backend,
                                   **kw) for i in LR_LONE}
        walls, per_tick, n_reads, errs, same_iters = [], [], [], {}, []
        tracked = {i: 0 for i in LR_LONE}       # queries held, f64
        diverged = {i: False for i in LR_LONE}
        for d in range(drains):
            lo = d * FLEET_ROWS
            for i, t in enumerate(tens):
                fleet.submit(f"t{i}", t[2][lo:lo + FLEET_ROWS])
            out, wall, launches, reads = drain_timed(fleet)
            check_fleet_out("lowrank", out, N_of)
            walls.append(wall)
            per_tick.append(launches)
            n_reads.append(reads)
            for i in LR_LONE:
                u = out[f"t{i}"][0]
                ref = lone[i].update(tens[i][2][lo:lo + FLEET_ROWS])
                same_iters.append(u.n_iters == ref.n_iters)
                got = {"nowcast": u.nowcast, "factors": u.factors,
                       "forecast y": u.forecasts["y"],
                       "logliks": u.logliks}
                want = {"nowcast": ref.nowcast, "factors": ref.factors,
                        "forecast y": ref.forecasts["y"],
                        "logliks": ref.logliks}
                if dtype == torch.float64:
                    ref64[d, i] = (got, want)
                    if diverged[i]:
                        continue
                    tracked[i] += 1
                    diverged[i] = u.diverged or ref.diverged
                    if diverged[i]:     # only the iterations both ran
                        got = {"logliks": u.logliks}
                        if u.n_iters != ref.n_iters:
                            got["logliks"] = np.full(1, np.inf)
                    checks = [("fleet_vs_lone", got, want)]
                else:
                    lane64, lone64 = ref64[d, i]
                    checks = [("fleet_vs_f64", got, lane64),
                              ("lone_vs_f64", want, lone64)]
                for key, vals, base in checks:
                    e = errs.setdefault(key, {})
                    for f, v in vals.items():
                        if v.shape == base[f].shape:
                            e[f] = max(e.get(f, 0.0), rel_err(v, base[f]))
        bad += [(str(dtype), d) for d, c in enumerate(per_tick)
                if any(c[n] != expect.get(n, 0) for n in c)
                or n_reads[d] != 1]
        rec[str(dtype).replace("torch.", "")] = {
            "tick_p50_ms": pct(walls, 50) * 1e3,
            "tick_p99_ms": pct(walls, 99) * 1e3,
            "ticks_ms": [w * 1e3 for w in walls],
            "queries_per_s": rec["queries"] / sum(walls),
            "reads_per_tick": sum(n_reads) / len(n_reads),
            "launches_per_tick": {n: per_tick[0][n] for n in expect},
            "lane_n_iters_as_lone": sum(same_iters) / len(same_iters),
            "max_rel_err": errs}
        if dtype == torch.float64:
            rec["float64"]["queries_held"] = tracked
        for sess in lone.values():
            sess.close()
        if dtype == torch.float64:
            fleet.close()
    rec["dims"] = bucket.dims
    rec["rank"] = lr.resolve_rank(k, bucket.cfg.rank)
    rec["float64"]["tol"] = 1e-9
    emit(rec)
    e64 = rec["float64"]
    held_errs = e64["max_rel_err"].get("fleet_vs_lone", {})
    if bad or min(e64["queries_held"].values()) < 1 or any(
            not v <= 1e-9 for v in held_errs.values()) or not held_errs:
        raise AssertionError(f"lowrank fleet: ticks {bad} off "
                             f"{expect} or 1 read; f64 lanes "
                             f"against lone sessions {e64}")
    fleet_kernel_check(bucket, "lowrank fleet", seed + 830)
    slots = [bucket.lane_of[ln] for ln in range(bucket.B)]
    refs, worst = {}, {}
    for dtype in (torch.float64, torch.float32):
        Yb = bucket.Ybuf.to(dtype).contiguous()
        Wb = bucket.Wbuf.to(dtype).contiguous()
        pt = SSMParams(*(x.to(dtype).contiguous() for x in bucket.p))
        with highest_precision():
            for c in lowrank_cases(Yb, Wb, pt, LR_RANK, "lowrank fleet"):
                key = (c["name"], c["variant"])
                _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                refs[key] = ref
                worst[f"{c['name']} {str(dtype)[6:]}"] = rel
        del Yb, Wb, pt
        torch.cuda.empty_cache()
    emit({"fleet_kernels": "lowrank fleet K9", "B": bucket.B,
          "t": [s.t for s in slots], "max_rel_err": worst})
    fleet.close()

# ---------------------------------------------------------------------------
# The time-varying-loadings family (S4, K11, K2-tv, K1-tv): BASELINE.json's
# S4 at its full width, 5,000 series x 300 steps, k = 4 (bench/configs.py:
# 41-43), the random-walk DGP at walk scale 0.05 (bench/run.py:62-64).
# ---------------------------------------------------------------------------

TVL_T, TVL_N, TVL_K = 300, 5000, 4
TVL_ROUNDS, TVL_CHUNK = 20, 8
TVL_NEW = ("tvl_obs_stats", "tvl_quad", "loading_filter", "loading_smoother")
TVL_SWEEP = (1, 8, 9, 16)


def tvl_panel(seed: int, T_: int = TVL_T, N_: int = TVL_N, K_: int = TVL_K):
    """S4's random-walk-loadings panel: (Y, mask with the headline panel's
    ragged edge (last 12 rows of 30% of series) and 5% scattered missing,
    true F (T, k), true loading paths (T, N, k), A, R)."""
    rng = np.random.default_rng(seed)
    Y, F, Lams, A, R = dgp.simulate_tv_loadings(N_, T_, K_, rng,
                                                walk_scale=0.05)
    W = np.ones((T_, N_))
    W[T_ - 12:, rng.random(N_) < 0.30] = 0.0
    W[rng.random((T_, N_)) < 0.05] = 0.0
    return Y, W, F, Lams, A, R


@functools.lru_cache(maxsize=2)
def tvl_s4_panel(seed: int, k: int):
    """``tvl_panel`` at S4's full width and k factors, kept for the phases
    that reuse it (the fit, its round breakdown, the contract and, past
    16, the kernel phase): simulating 5,000 series x 300 steps takes ~3 s
    on the host at k = 50.  Read-only."""
    return tvl_panel(seed, K_=k)


def k11_bwd_flops(k: int) -> float:
    """Operations of one K11-bwd step of one series, counted from its code
    (csrc/tv_loadings.cu): the Cholesky k^3 / 3, two triangular solves 2
    k^3, two full k x k products 4 k^3; the solves' divisions, lam_s, P_n -
    P_pred with tr(P_n J') and the sym 10.5 k^2."""
    return 19.0 / 3.0 * k ** 3 + 10.5 * k * k


def few_slots(n: int, fn):
    """``fn()`` with ``loading_smoother_gen``'s global workspace held to n
    series where its rule gives it one, so each block of the persistent
    grid loops over several series (the rule's min(N, 8 x SMs) slots give
    the sweep's 400 series a block each)."""
    orig = tv._smoother_work
    tv._smoother_work = lambda k, N, dt_, dev: orig(k, min(N, n), dt_, dev)
    try:
        return fn()
    finally:
        tv._smoother_work = orig


def tvl_cases(Y, W, F, Lams, pt, label: str, smoother: bool = True,
              slots: int = 0) -> list:
    """K2-tv, K1-tv, K11-fwd and K11-bwd on card tensors: ``Y`` (T, N)
    zero-filled at missing, ``W`` the mask or None, the true factor path
    ``F`` and loading paths ``Lams`` (T, N, k), params ``pt``; K1-tv at the
    plain scan's x_pred, K11-bwd (left out unless ``smoother``) on the
    plain forward pass's output, and, with ``slots`` where the rule gives
    K11-bwd-gen a global workspace, again on a workspace of ``slots``
    series (``few_slots``; variant "``label`` slots=n", the same twin
    output).  Each case is named by the kernel its wrapper launches at k
    (``kernels.route``).  Library yardsticks: the one ``torch.einsum`` of
    C_t (K2-tv) and of the loadings' fit (K1-tv).  Call under
    ``highest_precision()``."""
    T_, N_, k = Lams.shape
    stats = tv.obs_stats_tv_plain(Y, Lams, pt.R, W)
    xp = inf.info_scan_plain(stats, pt.A, pt.Q, pt.mu0, pt.P0)[0]
    ms = () if W is None else (W,)
    wr = (1.0 / pt.R).expand(T_, N_) if W is None else W / pt.R
    tn = T_ * N_
    out = [
        case(kernels.route("tvl_obs_stats", k), label,
             lambda: tv.obs_stats_tv(Y, Lams, pt.R, W),
             lambda: tv.obs_stats_tv_plain(Y, Lams, pt.R, W),
             (Y, Lams, pt.R, *ms), tn * (2 * k + k * (k + 1) + 4),
             library=lambda: torch.einsum("tnk,tn,tnl->tkl", Lams, wr,
                                          Lams)),
        case(kernels.route("tvl_quad", k), label,
             lambda: tv.quad_local_tv(Y, Lams, pt.R, xp, W),
             lambda: tv.quad_local_tv_plain(Y, Lams, pt.R, xp, W),
             (Y, Lams, pt.R, xp, *ms), tn * (4 * k + 5),
             library=lambda: torch.einsum("tnk,tk->tn", Lams, xp)),
        case(kernels.route("loading_filter", k), label,
             lambda: tv.loading_filter(Y, F, pt.Lam0, pt.tau2, pt.R, W),
             lambda: tv.loading_filter_plain(Y, F, pt.Lam0, pt.tau2, pt.R,
                                             W),
             (Y, F, pt.Lam0, pt.tau2, pt.R, *ms), tn * (5 * k * k + 8 * k)),
    ]
    if smoother:
        lam_f, P_f = tv.loading_filter_plain(Y, F, pt.Lam0, pt.tau2, pt.R, W)
        name = kernels.route("loading_smoother", k)
        run = lambda: tv.loading_smoother(lam_f, P_f, pt.tau2)
        plain = lambda: tv.loading_smoother_plain(lam_f, P_f, pt.tau2)
        ins, flops = (lam_f, P_f, pt.tau2), (T_ - 1) * N_ * k11_bwd_flops(k)
        few = slots and name != "loading_smoother" and kernels.query(
            "loading_smoother_gen_slots", Y.dtype, k, N_, 1)
        ref = plain_call(plain) if few else None
        out.append(case(name, label, run, plain, ins, flops, ref=ref))
        if few:
            out.append(case(name, f"{label} slots={slots}",
                            lambda: few_slots(slots, run), plain, ins, flops,
                            ref=ref))
    return out


def tvl_inputs(pan, dtype):
    """Card tensors of a ``tvl_panel``: (Y zero-filled, mask, F, Lams,
    params at the truth with tau2 = 1e-3, Q = I)."""
    Y, W, F, Lams, A, R = pan
    N_, k = Lams.shape[1], Lams.shape[2]
    on = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda").contiguous()
    pt = tv.TVLParams(Lam0=Lams[0], tau2=np.full((N_,), 1e-3), A=A,
                      Q=np.eye(k), R=R, mu0=np.zeros(k),
                      P0=np.eye(k)).to("cuda", dtype)
    return on(np.where(W > 0, Y, 0.0)), on(W), on(Y), on(F), on(Lams), pt


def tvl_kernel_phase(seed: int) -> dict:
    """The four TVL kernels at S4's full width, unmasked and masked, f64
    then f32, each against its plain twin (the TOL rule) and timed
    (``kernel_record``).  Returns the f32 unmasked records by name."""
    pan = tvl_panel(seed + 900)
    summary, refs = {}, {}
    for dtype in (torch.float64, torch.float32):
        Yz, Wt, Yf, Ft, Lt, pt = tvl_inputs(pan, dtype)
        with highest_precision():
            for c in (tvl_cases(Yf, None, Ft, Lt, pt, "unmasked")
                      + tvl_cases(Yz, Wt, Ft, Lt, pt, "masked")):
                rec = kernel_record(c, dtype, refs)
                rec.update({"T": TVL_T, "N": TVL_N, "k": TVL_K})
                emit(rec)
                if dtype == torch.float32 and c["variant"] == "unmasked":
                    summary[c["name"]] = rec
        del Yz, Wt, Yf, Ft, Lt, pt
        torch.cuda.empty_cache()
    return summary


def tvl_k_sweep(seed: int) -> None:
    """The four TVL kernels at k = 1, 8, 9 and 16 (the kernels' dispatch
    ends, and both sides of the JAX package's UNROLL_K_MAX = 8; S4's k =
    4 is the kernel phase's)
    on 120 x 400 panels with a fully missing step and a never-observed
    series, masked and unmasked (K11-bwd, which has no mask, once), f64
    and f32: error checks only."""
    for k in TVL_SWEEP:
        pan = tvl_panel(seed + 910 + k, T_=120, N_=400, K_=k)
        pan[1][7] = 0.0
        pan[1][:, 5] = 0.0
        refs, worst = {}, {}
        for dtype in (torch.float64, torch.float32):
            Yz, Wt, Yf, Ft, Lt, pt = tvl_inputs(pan, dtype)
            with highest_precision():
                for c in (tvl_cases(Yf, None, Ft, Lt, pt, "unmasked", False)
                          + tvl_cases(Yz, Wt, Ft, Lt, pt, "masked")):
                    key = (c["name"], c["variant"])
                    _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                    refs[key] = ref
                    worst[f"{c['name']} {c['variant']} {str(dtype)[6:]}"] = rel
        emit({"tvl_k_sweep": k, "max_rel_err": worst})


class ReadWatch:
    """Counts and stamps the blocking reads of a TVL fit: one a chunk of
    ``run_chunked`` (``estim.em.read_host``), then the packed result read
    (``estim.fused.read_packed``)."""

    def __enter__(self):
        self.stamps = []
        self._saved = (tem.read_host, tfu.read_packed)

        def stamp(fn):
            def stamped(x):
                out = fn(x)
                self.stamps.append(time.perf_counter())
                return out
            return stamped
        tem.read_host, tfu.read_packed = map(stamp, self._saved)
        return self

    def __exit__(self, *exc):
        tem.read_host, tfu.read_packed = self._saved


def tvl_fit_phase(seed: int, k: int = TVL_K, rounds: int = TVL_ROUNDS,
                  tag: str = "tvl") -> dict:
    """``fit(TVLSpec(n_factors=k, n_rounds=rounds, tol=0.0), Y)`` at 5,000
    x 300 on ``TorchBackend()`` (f32, chunks of 8), unmasked and masked,
    with a 12-step forecast: finite logliks, loadings, factors and
    forecasts; exactly one read a chunk plus the result's; exactly one
    launch of each of K2-tv, K4-fwd, K1-tv, K4-bwd, K11-fwd and K11-bwd a
    round run (+1 K2-tv and one K4 pair for the reporting pass), each under
    the name of the kernel its wrapper launches at k (``routed``), and no
    other kernel.  Rounds/s: the rounds after the first chunk over the wall
    between the first chunk's read and the last one's.  Then
    ``tvl_round_breakdown`` of the unmasked fit.  The panel is S4's at k
    factors (seed + 901 at k = 4, seed + 1700 + k past it).  Returns each
    fit's launch counts by label (``tag`` unmasked, ``tag`` masked)."""
    Y, W, _, _, _, _ = tvl_s4_panel(
        seed + (901 if k == TVL_K else 1700 + k), k)
    spec = dt.TVLSpec(n_factors=k, n_rounds=rounds, tol=0.0)
    backend = dt.TorchBackend(fused_chunk=TVL_CHUNK)
    counts = {}
    for label, Yx in ((f"{tag} unmasked", Y),
                      (f"{tag} masked", np.where(W > 0, Y, np.nan))):
        torch.cuda.synchronize()
        kernels.reset_launches()
        with ReadWatch() as rw:
            t0 = time.perf_counter()
            res = dt.fit(spec, Yx, backend=backend)
            y_fore, f_fore = dt.forecast(res, 12)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        n = len(res.logliks)
        n_chunks = -(-n // TVL_CHUNK)
        ran = min(rounds, n_chunks * TVL_CHUNK)         # whole chunks run
        chunk_reads = rw.stamps[:n_chunks]
        steady = ran - TVL_CHUNK
        want = routed({"tvl_obs_stats": ran + 1, "info_scan": ran + 1,
                       "rts_smoother": ran + 1, "tvl_quad": ran,
                       "loading_filter": ran, "loading_smoother": ran}, k)
        per_round = {nm: launches[nm] / ran for nm in want}
        lls = res.logliks
        emit({"fit": label, "spec": dataclasses.asdict(spec),
              "shape": [TVL_T, TVL_N, k], "n_rounds": n,
              "rounds_run": ran, "converged": res.converged,
              "loglik_first": float(lls[0]), "loglik_last": float(lls[-1]),
              "max_drop": float(max(0.0, -np.diff(lls).min())),
              "noise_floor": noise_floor_for(torch.float32, TVL_T * TVL_N),
              "wall_s": wall,
              "rounds_per_sec": (steady / (chunk_reads[-1] - chunk_reads[0])
                                 if steady > 0 else None),
              "reads": len(rw.stamps), "launches_per_round": per_round,
              "launches": {nm: v for nm, v in launches.items() if v}})
        bad = {nm: launches[nm] for nm in launches
               if launches[nm] != want.get(nm, 0)}
        if bad or len(rw.stamps) != n_chunks + 1:
            raise AssertionError(f"{label}: launches off the path's {want}: "
                                 f"{bad}; reads {len(rw.stamps)}, expected "
                                 f"{n_chunks + 1}")
        for name, arr in (("logliks", lls), ("loadings", res.loadings),
                          ("factors", res.factors), ("y_fore", y_fore),
                          ("f_fore", f_fore)):
            if not np.isfinite(arr).all():
                raise AssertionError(f"{label}: non-finite {name}")
        if (res.loadings.shape != (TVL_T, TVL_N, k)
                or y_fore.shape != (12, TVL_N)):
            raise AssertionError(f"{label}: unexpected output shapes")
        counts[label] = launches
        if label == f"{tag} unmasked":
            fitted = res
        del res
    tvl_round_breakdown(Y, fitted, spec)
    return counts


def tvl_round_breakdown(Y, res, spec) -> None:
    """Where an unmasked S4 round goes (f32, warm L2, at the fitted state
    ``res`` of panel ``Y``): each path kernel's time and the whole
    ``tvl_round_core`` on the device (CUDA events, from its first launch
    to its last); the rest is the round less the kernels (torch glue and
    launch gaps), not a measured breakdown.  Beside it the K4 pair's bytes
    bound, latency floor and (at k <= 16) plain twins at S4 (``k4_pair``).  Then two rounds from that
    state under ``set_sync_debug_mode("error")``: no host read inside a
    round (the panel is uploaded before the guard)."""
    Yt = torch.as_tensor(Y, dtype=torch.float32, device="cuda").contiguous()
    k = spec.n_factors
    route = lambda nm: kernels.route(nm, k)
    with highest_precision():
        Lt = torch.as_tensor(res.loadings, dtype=torch.float32,
                             device="cuda").contiguous()
        pt = tv.TVLParams(*res.params).to("cuda", torch.float32)
        stats = tv.obs_stats_tv(Yt, Lt, pt.R)
        fwd = inf.info_scan(stats, pt.A, pt.Q, pt.mu0, pt.P0)
        kf = FilterResult(*fwd[:4], None)
        dummy = SSMParams(Lt[0], pt.A, pt.Q, pt.R, pt.mu0, pt.P0)
        F = rts_smoother(kf, dummy).x_sm
        lam_f, P_f = tv.loading_filter(Yt, F, pt.Lam0, pt.tau2, pt.R)
        ms = {route("tvl_obs_stats"): cuda_ms(
                  lambda: tv.obs_stats_tv(Yt, Lt, pt.R)),
              route("info_scan"): cuda_ms(lambda: inf.info_scan(
                  stats, pt.A, pt.Q, pt.mu0, pt.P0)),
              route("tvl_quad"): cuda_ms(lambda: tv.quad_local_tv(
                  Yt, Lt, pt.R, fwd[0])),
              route("rts_smoother"): cuda_ms(
                  lambda: rts_smoother(kf, dummy)),
              route("loading_filter"): cuda_ms(lambda: tv.loading_filter(
                  Yt, F, pt.Lam0, pt.tau2, pt.R)),
              route("loading_smoother"): cuda_ms(
                  lambda: tv.loading_smoother(lam_f, P_f, pt.tau2))}
        del lam_f, P_f
        # The K4 pair over the per-step C: its plain twins and bytes bound
        # (each input read once, each output written once).
        fwd_in = (stats.b, stats.C, pt.A, pt.Q, pt.mu0, pt.P0)
        k4 = {"fwd_bound_ms": bound(nbytes_of(fwd_in) + nbytes_of(fwd),
                                    k4_flops(TVL_T, k, 12.67),
                                    torch.float32)[0],
              "bwd_bound_ms": bound(
                  nbytes_of((*fwd[:4], pt.A)) + nbytes_of(fwd[:1])
                  + 2 * nbytes_of(fwd[1:2]),
                  k4_flops(TVL_T, k, 9.0), torch.float32)[0],
              "fwd_floor_ms": latency_ms("info_scan", torch.float32, k,
                                         TVL_T),
              "bwd_floor_ms": latency_ms("rts_smoother", torch.float32, k,
                                         TVL_T)}
        if k <= kernels.KMAX:
            k4["fwd_plain_ms"] = cuda_ms(lambda: inf.info_scan_plain(
                stats, pt.A, pt.Q, pt.mu0, pt.P0))
            k4["bwd_plain_ms"] = cuda_ms(lambda: rts_smoother_plain(kf,
                                                                    dummy))
        round_ms = cuda_ms(lambda: tv.tvl_round_core(Yt, None, Lt, pt, spec))
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tv.tvl_round_scan(Yt, None, Lt, pt, spec, False, 2)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize()
    emit({"tvl_round_breakdown": "unmasked", "shape": [TVL_T, TVL_N, k],
          "round_ms": round_ms, "kernel_ms": ms,
          "rest_ms": round_ms - sum(ms.values()), "rounds_sync_checked": 2,
          "k4_pair": k4})


def tvl_reference_phase(seed: int, N_: int = 80, k: int = 3,
                        variants=("unmasked", "masked"),
                        rounds: int = 6) -> None:
    """``fit(TVLSpec(n_factors=k, n_rounds=rounds, tol=0))`` at 60 x ``N_``,
    unmasked and masked (a fully missing step and a never-observed series;
    ``variants`` picks), on the card in f64 against the CPU in f64 within
    1e-9 relative (logliks, loadings, factors, params, forecast); the card
    fit must launch every kernel of the path at k (``kernels.route``).
    Each fit's wall is printed."""
    pan = tvl_panel(seed + 902 + (k if k > 3 else 0), T_=60, N_=N_, K_=k)
    Y, W = pan[0], pan[1]
    W[7] = 0.0
    W[:, 5] = 0.0
    spec = dt.TVLSpec(n_factors=k, n_rounds=rounds, tol=0.0)
    errs, walls = {}, {}
    panels = {"unmasked": Y, "masked": np.where(W > 0, Y, np.nan)}
    for label in variants:
        Yx = panels[label]
        res = {}
        for dev in ("cuda", "cpu"):
            kernels.reset_launches()
            t0 = time.perf_counter()
            r = dt.fit(spec, Yx, backend=dt.TorchBackend(
                device=dev, dtype=torch.float64, fused_chunk=4))
            walls[f"{label} {dev}"] = time.perf_counter() - t0
            res[dev] = (r, dt.forecast(r, 12)[0], dict(kernels.LAUNCHES))
        (rg, yg, lg), (rc, yc, _) = res["cuda"], res["cpu"]
        if any(lg[kernels.route(nm, k)] == 0 for nm in TVL_NEW) or len(
                rg.logliks) != len(rc.logliks):
            raise AssertionError(f"tvl reference {label}: launches {lg}, "
                                 f"rounds {len(rg.logliks)} / "
                                 f"{len(rc.logliks)}")
        for name, g, c in (("logliks", rg.logliks, rc.logliks),
                           ("loadings", rg.loadings, rc.loadings),
                           ("factors", rg.factors, rc.factors),
                           ("tau2", rg.params.tau2, rc.params.tau2),
                           ("R", rg.params.R, rc.params.R),
                           ("A", rg.params.A, rc.params.A),
                           ("y_fore", yg, yc)):
            errs[f"{label} {name}"] = rel_err(g, c)
    emit({"reference": "tvl", "shape": [60, N_, k], "rounds": rounds,
          "max_rel_err": errs, "tol": 1e-9, "wall_s": walls})
    bad = {n: e for n, e in errs.items() if not e <= 1e-9}
    if bad:
        raise AssertionError(f"tvl card fit disagrees with the CPU fit: {bad}")


def tvl_contract_phase(seed: int, k: int = TVL_K) -> None:
    """The loglik contract of the TVL family (BASELINE.json:5) at S4's full
    width (k factors; the fit phase's panel), unmasked and masked: from one
    init (the fit's PCA warm start, tau2 = 1e-4), 2 rounds in f32 and in
    f64 on the card; the f32 state (loading paths and params, cast to f64)
    re-evaluated by ``tvl_loglik_eval`` in f64 against the f64 state's
    conditional loglik after its 2 rounds, within 1e-5 relative."""
    Y, W, _, _, _, _ = tvl_s4_panel(
        seed + (901 if k == TVL_K else 1700 + k), k)
    spec = dt.TVLSpec(n_factors=k, n_rounds=2, tol=0.0)
    for masked in (False, True):
        Wm = W if masked else None
        Yz = np.where(W > 0, Y, 0.0) if masked else Y
        p0 = cpu_ref.pca_init(Yz, k, mask=Wm)
        init = tv.TVLParams(Lam0=p0.Lam, tau2=np.full((TVL_N,), 1e-4),
                            A=p0.A, Q=p0.Q, R=p0.R, mu0=p0.mu0, P0=p0.P0)
        state = {}
        with highest_precision():
            for dtype in (torch.float32, torch.float64):
                Yt = torch.as_tensor(Yz, dtype=dtype, device="cuda")
                mt = (torch.as_tensor(Wm, dtype=dtype, device="cuda")
                      if masked else None)
                pt = init.to("cuda", dtype)
                L0 = pt.Lam0.expand(TVL_T, TVL_N, k).contiguous()
                state[dtype] = tv.tvl_round_scan(Yt, mt, L0, pt, spec,
                                                 masked, 2)[0]
                del Yt, mt, pt, L0
            L64, p64 = state[torch.float64]
            ref = tv.tvl_loglik_eval(Yz, L64, p64, mask=Wm)
            L32, p32 = state[torch.float32]
            precise = tv.tvl_loglik_eval(Yz, L32.double(), p32.to(
                dtype=torch.float64), mask=Wm)
            fast = tv.tvl_loglik_eval(Yz, L32, p32, mask=Wm, precise=False)
        rel = abs(precise - ref) / abs(ref)
        emit({"contract": f"{'masked' if masked else 'unmasked'} tvl",
              "shape": [TVL_T, TVL_N, k], "rounds": 2,
              "loglik_f64": ref, "rel_err_precise": rel,
              "rel_err_fast": abs(fast - ref) / abs(ref), "limit": 1e-5})
        if not rel < 1e-5:
            raise AssertionError(f"tvl loglik contract broken: {rel:.3e}")


# ---------------------------------------------------------------------------
# Mixed-frequency family (config S3): BASELINE.json:9, bench/configs.py:37-40
# (2,000 series, 400 quarterly, T = 300, k = 5, 10% ragged missing), the
# panel of bench/run.py:54-60.
# ---------------------------------------------------------------------------

MF_NM, MF_NQ, MF_T, MF_K = 1600, 400, 300, 5
MF_ITERS, MF_CHUNK = 10, 8
# The lowrank route at r = k: above k, a step with no quarterly observation
# has a rank-k C_t and the rank-r scan goes to NaN at S3 in both packages.
MF_RANK = 5
MF_NEW = ("obs_stats_wide", "info_scan_wide", "quad_local_wide",
          "rts_smoother_wide")
MF_SWEEP = (17, 20, 25, 32)
# The dtype each wide kernel runs in on the f32 S3 path (the augmented
# scans in f64): the summary line reports that record.
MF_PATH_DTYPE = {"obs_stats_wide": torch.float32,
                 "quad_local_wide": torch.float32,
                 "info_scan_wide": torch.float64,
                 "rts_smoother_wide": torch.float64}
# Per route: the kernels it launches and how many times an E-step (each
# iteration and the reporting smooth run one).
MF_ROUTES = {"seq": dict.fromkeys(MF_NEW, 1),
             "lowrank": dict.fromkeys(
                 ("obs_stats_wide", "lowrank_basis", "lowrank_scan",
                  "quad_local_wide", "lowrank_smoother"), 1),
             "pit": {"obs_stats_wide": 1, "pit_elements": 4, "pit_scan": 2,
                     "quad_local_wide": 1},
             "pit_qr": {"obs_stats_wide": 1, "qr_elements_gen": 4,
                        "qr_scan_gen": 2, "quad_local_wide": 1}}
# Per fit: (label, time_scan); the qgen group runs ``pit_qr`` (m = 25, past
# the square-root engine's k <= 10 kernels) beside them.
MF_FITS = (("mf seq", "seq"), ("mf lowrank", "lowrank"), ("mf pit", "pit"))
MF_BASE_ROUTES = ("seq", "lowrank", "pit")
# EM it/s of each S3 fit by time_scan (mf_fit_phase fills it).
MF_RATES: dict = {}


def mf_spec(ts: str = "seq", nm: int = MF_NM, nq: int = MF_NQ,
            k: int = MF_K, rank: int = MF_RANK):
    return dt.MixedFreqSpec(n_monthly=nm, n_quarterly=nq, n_factors=k,
                            time_scan=ts, rank=rank)


def mf_panel(seed: int, nm: int = MF_NM, nq: int = MF_NQ, T_: int = MF_T,
             k: int = MF_K):
    """S3's panel (bench/run.py:54-60): (Y with NaN at missing, mask)."""
    rng = np.random.default_rng(seed)
    Y, mask, _, _ = dgp.simulate_mixed_freq(nm, nq, T_, k, rng)
    mask = mask * dgp.random_mask(T_, nm + nq, rng, 0.1)
    return np.where(mask > 0, Y, np.nan), mask


def mf_inputs(pan, spec):
    """As ``mf_fit`` makes them on the host: (the standardized panel
    zero-filled at missing, the mask, the PCA init)."""
    Y, W = pan
    Wm = data.build_mask(Y, W)
    Ys, _ = data.standardize(Y, mask=Wm)
    return np.nan_to_num(Ys * (Wm > 0)), Wm, mf.mf_pca_init(Ys, Wm, spec)


def wide_cases(Yt, Wt, p: SSMParams, label: str) -> list:
    """K2-wide, K4-wide forward, K1-wide (``loglik_terms_local``) and
    K4-wide backward on card tensors at p's width (17..32), on inputs the
    plain pipeline makes; K4-wide beside its latency floor.  Library
    yardsticks: ``einsum`` of C_t (K2-wide) and of the loadings' fit
    (K1-wide).  Call under ``highest_precision()``."""
    T_, N_ = Yt.shape
    m = p.A.shape[0]
    dtype = Yt.dtype
    stats = inf.obs_stats_plain(Yt, p.Lam, p.R, Wt)
    scan = inf.info_scan_plain(stats, p.A, p.Q, p.mu0, p.P0)
    kf = FilterResult(*scan[:4], None)
    scan_in = (stats.b, stats.C, p.A, p.Q, p.mu0, p.P0)
    wr = (Wt / p.R).contiguous()
    return [
        case("obs_stats_wide", label,
             lambda: inf.obs_stats(Yt, p.Lam, p.R, Wt),
             lambda: inf.obs_stats_plain(Yt, p.Lam, p.R, Wt),
             (Yt, p.Lam, p.R, Wt), 2 * T_ * N_ * (m + m * (m + 1) // 2),
             library=lambda: torch.einsum("tn,ni,nj->tij", wr, p.Lam,
                                          p.Lam)),
        case("info_scan_wide", label,
             lambda: inf.info_scan(stats, p.A, p.Q, p.mu0, p.P0),
             lambda: inf.info_scan_plain(stats, p.A, p.Q, p.mu0, p.P0),
             scan_in, k4_flops(T_, m, 12.67),
             floor=lambda: latency_ms("info_scan", dtype, m, T_)),
        case("quad_local_wide", label,
             lambda: inf.loglik_terms_local(Yt, p.Lam, p.R, scan[0], Wt),
             lambda: inf.loglik_terms_local_plain(Yt, p.Lam, p.R, scan[0],
                                                  Wt),
             (Yt, p.Lam, p.R, scan[0], Wt), T_ * N_ * (4 * m + 5),
             library=lambda: torch.einsum("nk,tk->tn", p.Lam, scan[0])),
        case("rts_smoother_wide", label,
             lambda: rts_smoother(kf, p),
             lambda: rts_smoother_plain(kf, p),
             (*scan[:4], p.A), k4_flops(T_, m, 9.0),
             floor=lambda: latency_ms("rts_smoother", dtype, m, T_)),
    ]


def mf_kernel_phase(seed: int) -> dict:
    """The four wide kernels at S3's full width (the augmented loadings of
    the fit's PCA init, m = 25, T = 300, N = 2,000), f64 then f32, each
    against its plain twin (the TOL rule) and timed (``kernel_record``).
    Returns, by name, the record in the dtype the f32 path runs it in
    (``MF_PATH_DTYPE``)."""
    spec = mf_spec()
    Yz, W, init = mf_inputs(mf_panel(seed + 1000), spec)
    summary, refs = {}, {}
    for dtype in (torch.float64, torch.float32):
        with highest_precision():
            Yt = torch.as_tensor(Yz, dtype=dtype, device="cuda").contiguous()
            Wt = torch.as_tensor(W, dtype=dtype, device="cuda").contiguous()
            aug = mf.augment(mf.MFParams(*init).to("cuda", dtype), spec)
            for c in wide_cases(Yt, Wt, aug, "S3"):
                rec = kernel_record(c, dtype, refs,
                                    dtype == MF_PATH_DTYPE[c["name"]])
                rec.update({"T": MF_T, "N": MF_NM + MF_NQ,
                            "m": spec.state_dim})
                emit(rec)
                if dtype == MF_PATH_DTYPE[c["name"]]:
                    summary[c["name"]] = rec
        torch.cuda.empty_cache()
    return summary


def mf_k_sweep(seed: int) -> None:
    """The four wide kernels at k = 17, 20, 25 and 32 (the wide range's
    ends and S3's m) on 120 x 400 panels with a fully missing step and a
    never-observed series, f64 and f32: error checks only."""
    for k in MF_SWEEP:
        _, W, Yfull, p = panel(seed + 1010 + k, T_=120, N_=400, K_=k)
        W[7] = 0.0
        W[:, 5] = 0.0
        refs, worst = {}, {}
        for dtype in (torch.float64, torch.float32):
            with highest_precision():
                Wt = torch.as_tensor(W, dtype=dtype, device="cuda")
                Yt = (torch.as_tensor(Yfull, dtype=dtype, device="cuda")
                      * Wt).contiguous()
                pt = SSMParams.from_numpy(p, dtype=dtype, device="cuda")
                for c in wide_cases(Yt, Wt.contiguous(), pt, f"k={k}"):
                    key = (c["name"], c["variant"])
                    _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                    refs[key] = ref
                    worst[f"{c['name']} {str(dtype)[6:]}"] = rel
        emit({"mf_k_sweep": k, "max_rel_err": worst})


def mf_fit_phase(seed: int, fits=MF_FITS, dtype=None) -> dict:
    """``fit(MixedFreqSpec(1600, 400, 5), Y, mask=W)`` at S3 on
    ``TorchBackend()`` (f32, chunks of 8, 10 iterations, tol = 0) with
    ``time_scan="seq"``, ``"lowrank"`` (rank 5) and ``"pit"``, and a
    12-step forecast: finite outputs of S3's shapes, exactly one read a
    chunk plus the result's, exactly the route's launches an E-step
    (``MF_ROUTES``) for each iteration run and the reporting smooth, and no
    other kernel.  EM it/s: the iterations after the first chunk over the
    wall between the first and the last chunk reads.  Then
    ``mf_iteration_breakdown`` of ``seq`` and ``pit``.  ``fits``: the
    (label, time_scan) pairs (default ``MF_FITS``); a route other than
    those is reported beside the ``seq`` and ``pit`` rates when they ran;
    ``dtype``: the backend's (default f32).  Returns each fit's launch
    counts by label."""
    Y, W = mf_panel(seed + 1001)
    backend = dt.TorchBackend(dtype=dtype, fused_chunk=MF_CHUNK)
    counts, fitted, rates = {}, {}, MF_RATES
    for label, ts in fits:
        need = MF_ROUTES[ts]
        spec = mf_spec(ts)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with ReadWatch() as rw:
            t0 = time.perf_counter()
            res = dt.fit(spec, Y, mask=W, backend=backend,
                         max_iters=MF_ITERS, tol=0.0)
            y_fore, f_fore = dt.forecast(res, 12)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        lls = res.logliks
        n = len(lls)
        n_chunks = -(-n // MF_CHUNK)
        ran = min(MF_ITERS, n_chunks * MF_CHUNK)        # whole chunks run
        chunk_reads = rw.stamps[:n_chunks]
        steady = ran - MF_CHUNK
        rates[ts] = (steady / (chunk_reads[-1] - chunk_reads[0])
                     if steady > 0 else None)
        emit({"fit": label, "spec": dataclasses.asdict(spec),
              "dtype": str(backend.dtype)[6:],
              "shape": [MF_T, MF_NM + MF_NQ, MF_K], "n_iters": n,
              "iters_run": ran, "converged": res.converged,
              "loglik_first": float(lls[0]), "loglik_last": float(lls[-1]),
              "max_drop": float(max(0.0, -np.diff(lls).min())),
              "noise_floor": noise_floor_for(torch.float32,
                                             MF_T * (MF_NM + MF_NQ)),
              "wall_s": wall,
              "em_iters_per_sec": rates[ts],
              **({"beside": {b: rates.get(b) for b in ("seq", "pit")}}
                 if ts not in MF_BASE_ROUTES else {}),
              "reads": len(rw.stamps),
              "launches_per_iter": {nm: launches[nm] / ran for nm in need},
              "launches": {nm: v for nm, v in launches.items() if v}})
        want = {nm: per * (ran + 1) for nm, per in need.items()}
        bad = {nm: launches[nm] for nm in launches
               if launches[nm] != want.get(nm, 0)}
        if bad or len(rw.stamps) != n_chunks + 1:
            raise AssertionError(f"{label}: launches off the path's {want}: "
                                 f"{bad}; reads {len(rw.stamps)}, expected "
                                 f"{n_chunks + 1}")
        for name, arr in (("logliks", lls), ("nowcast", res.nowcast),
                          ("factors", res.factors), ("state_T", res.state_T),
                          ("y_fore", y_fore), ("f_fore", f_fore)):
            if not np.isfinite(arr).all():
                raise AssertionError(f"{label}: non-finite {name}")
        if (res.nowcast.shape != (MF_T, MF_NM + MF_NQ)
                or res.state_T.shape != (5 * MF_K,)
                or y_fore.shape != (12, MF_NM + MF_NQ)):
            raise AssertionError(f"{label}: unexpected output shapes")
        counts[label] = launches
        fitted[ts] = res
    if "pit" in fitted and "seq" in fitted:
        emit({"mf_pit_vs_seq": {"pit_em_iters_per_sec": rates["pit"],
                                "seq_em_iters_per_sec": rates["seq"]}})
    for ts in ("seq", "pit"):
        if ts in fitted:
            mf_iteration_breakdown(Y, W, fitted[ts])
    return counts


def mf_iteration_breakdown(Y, W, res) -> None:
    """Where an S3 ``seq`` or ``pit`` iteration goes (f32, warm L2, at the
    fitted params): each path kernel (each K14 mode) at the dtype the path
    runs it in, times its launches an iteration, and the whole
    ``mf_em_core`` on the device (CUDA events); the rest is the iteration
    less the kernels (the widening and narrowing casts, the loglik
    assembly, the M-step's einsums and solves, launch gaps).  Then two
    iterations under ``set_sync_debug_mode("error")``: no host read inside
    an iteration (the panel and params are uploaded before the guard)."""
    spec = res.spec
    Yz, Wm, _ = mf_inputs((Y, W), spec)
    f32, f64 = torch.float32, torch.float64
    with highest_precision():
        Yt = torch.as_tensor(Yz, dtype=f32, device="cuda").contiguous()
        Wt = torch.as_tensor(Wm, dtype=f32, device="cuda").contiguous()
        pt = mf.MFParams(*res.params).to("cuda", f32)
        aug = mf.augment(pt, spec)
        stats = inf.obs_stats(Yt, aug.Lam, aug.R, Wt)
        s64 = inf.ObsStats(*(x.to(f64) for x in stats))
        a64 = aug.to(dtype=f64)
        if spec.time_scan == "pit":
            fwd = pf.pit_from_stats(s64, a64)
        else:
            fwd = inf.info_scan(s64, a64.A, a64.Q, a64.mu0, a64.P0)
        kf = FilterResult(*fwd[:4], None)
        xp = fwd[0].to(f32)
        ms = {"obs_stats_wide": cuda_ms(lambda: inf.obs_stats(
                  Yt, aug.Lam, aug.R, Wt)),
              "quad_local_wide": cuda_ms(lambda: inf.loglik_terms_local(
                  Yt, aug.Lam, aug.R, xp, Wt))}
        if spec.time_scan == "pit":
            for c in pit_cases(s64, a64, "S3 breakdown"):
                ms[c["variant"].replace(" S3 breakdown", "")] = \
                    cuda_ms(c["run"])
        else:
            ms["info_scan_wide"] = cuda_ms(lambda: inf.info_scan(
                s64, a64.A, a64.Q, a64.mu0, a64.P0))
            ms["rts_smoother_wide"] = cuda_ms(lambda: rts_smoother(kf, a64))
        iter_ms = cuda_ms(lambda: mf.mf_em_core(Yt, Wt, pt, spec))
        mf.mf_em_scan(Yt, Wt, pt, spec, 1)
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            mf.mf_em_scan(Yt, Wt, pt, spec, 2)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize()
    emit({"mf_iteration_breakdown": spec.time_scan,
          "shape": [MF_T, MF_NM + MF_NQ, MF_K], "m": spec.state_dim,
          "iter_ms": iter_ms, "kernel_ms": ms,
          "rest_ms": iter_ms - sum(ms.values()),
          "iters_sync_checked": 2})


def mf_small(seed: int):
    """A 60-step panel of 24 monthly + 8 quarterly series at k = 5 (m =
    25, the wide kernels) with a fully missing step and a never-observed
    monthly series: (Y with NaN, mask)."""
    Y, W = mf_panel(seed, nm=24, nq=8, T_=60)
    W[17] = 0.0
    W[:, 2] = 0.0
    return np.where(W > 0, Y, np.nan), W


def mf_reference_phase(seed: int, routes=MF_BASE_ROUTES) -> None:
    """``fit(MixedFreqSpec(24, 8, 5))`` at 60 steps (``mf_small``), 6
    iterations, tol = 0, chunks of 3, each of ``routes`` (default ``seq``,
    ``lowrank`` at rank 4 and ``pit``; the qgen group's ``pit_qr``), on
    the card in f64 against the CPU in f64 within 1e-9 relative (1e-10
    for ``pit`` and ``pit_qr``; logliks, params, nowcast, factors,
    state_T, forecast)."""
    Y, W = mf_small(seed + 1002)
    errs = {}
    for ts in routes:
        need = MF_ROUTES[ts]
        spec = mf_spec(ts, nm=24, nq=8, rank=4)
        res = {}
        for dev in ("cuda", "cpu"):
            kernels.reset_launches()
            r = dt.fit(spec, Y, mask=W, max_iters=6, tol=0.0,
                       backend=dt.TorchBackend(device=dev,
                                               dtype=torch.float64,
                                               fused_chunk=3))
            res[dev] = (r, dt.forecast(r, 12)[0], dict(kernels.LAUNCHES))
        (rg, yg, lg), (rc, yc, _) = res["cuda"], res["cpu"]
        if any(lg[nm] == 0 for nm in need) or len(rg.logliks) != len(
                rc.logliks):
            raise AssertionError(f"mf reference {ts}: launches {lg}, "
                                 f"iterations {len(rg.logliks)} / "
                                 f"{len(rc.logliks)}")
        pairs = [("logliks", rg.logliks, rc.logliks),
                 ("nowcast", rg.nowcast, rc.nowcast),
                 ("factors", rg.factors, rc.factors),
                 ("state_T", rg.state_T, rc.state_T), ("y_fore", yg, yc)]
        pairs += [(f, getattr(rg.params, f), getattr(rc.params, f))
                  for f in mf.MFParams._fields if f != "mu0"]   # mu0 = 0
        for name, g, c in pairs:
            errs[f"{ts} {name}"] = rel_err(g, c)
    tol = {"seq": 1e-9, "lowrank": 1e-9, "pit": 1e-10, "pit_qr": 1e-10}
    emit({"reference": "mf", "routes": list(routes), "shape": [60, 32, 5],
          "m": 25, "iters": 6,
          "max_rel_err": errs, "tol": tol})
    bad = {n: e for n, e in errs.items() if not e <= tol[n.split()[0]]}
    if bad:
        raise AssertionError(f"mf card fit disagrees with the CPU fit: {bad}")


def mf_contract_phase(seed: int, routes=MF_BASE_ROUTES) -> None:
    """The loglik contract of S3 (BASELINE.json:5, bench/run.py:173-176):
    from one init (the fit's PCA warm start), 2 EM iterations in f32 and in
    f64 on the card (``mf_em_scan``), each of ``routes`` (default ``seq``,
    ``lowrank`` and ``pit``; the qgen group's ``pit_qr``); the f32 params
    re-evaluated by ``mf_loglik_eval(precise=True)`` (the augmented
    info-form filter in f64) against the f64 params' after their 2
    iterations, within 1e-5 relative."""
    pan = mf_panel(seed + 1001)
    for ts in routes:
        spec = mf_spec(ts)
        Yz, W, init = mf_inputs(pan, spec)
        params = {}
        with highest_precision():
            for dtype in (torch.float32, torch.float64):
                Yt = torch.as_tensor(Yz, dtype=dtype, device="cuda")
                Wt = torch.as_tensor(W, dtype=dtype, device="cuda")
                p0 = mf.MFParams(*init).to("cuda", dtype)
                params[dtype] = mf.mf_em_scan(Yt.contiguous(),
                                              Wt.contiguous(), p0, spec,
                                              2)[0]
        p32, p64 = params[torch.float32], params[torch.float64]
        ref = mf.mf_loglik_eval(Yz, W, p64, spec, device="cuda")
        precise = mf.mf_loglik_eval(Yz, W, p32, spec, device="cuda")
        fast = mf.mf_loglik_eval(Yz.astype(np.float32), W, p32, spec,
                                 precise=False, device="cuda")
        # (the seq route's fast figure is the f32 in-loop loglik)
        rel = abs(precise - ref) / abs(ref)
        # The fast figure is the route's own E-step loglik: the rank-r
        # route's is an approximate likelihood, not comparable.
        emit({"contract": f"mf {ts}", "shape": [MF_T, MF_NM + MF_NQ, MF_K],
              "iters": 2, "loglik_f64": ref, "rel_err_precise": rel,
              "rel_err_fast": (abs(fast - ref) / abs(ref)
                               if ts != "lowrank" else None),
              "limit": 1e-5})
        if not rel < 1e-5:
            raise AssertionError(f"mf loglik contract broken: {rel:.3e}")


# ---------------------------------------------------------------------------
# The stochastic-volatility family (config S5, K10): BASELINE.json:11,
# 10,000 series x 1,000 steps, k = 5 (bench/configs.py:45-46), the panel
# of bench/run.py:66-67 (``simulate_sv``), M = 256 particles
# (bench/run.py:76) and the default S = 64 FFBS draws.
# ---------------------------------------------------------------------------

SV_T, SV_N, SV_K, SV_M = 1000, 10_000, 5, 256
# Steps of S5 the expanded form is held on at full width (N, k, M): its
# plain twin, a Python loop a step, takes ~8 s over all 1,000.
SV_EXPANDED_T = 100
SV_NEW = ("sv_rbpf", "sv_ffbs")
# (k, M): both sides of UNROLL_K_MAX = 8 and the dispatch ends; one
# particle, and the step block past 256 threads up to its 1,024.
SV_SWEEP = ((1, 64), (2, 64), (8, 64), (9, 64), (16, 64), (5, 1), (5, 512),
            (5, 1024))
SV_OUTS = ("ll_rel", "f_mean", "h_mean", "ess", "n_resamples", "h_hist",
           "logw_hist")
# An index flip in f32: a gathered h row that moved by more than this
# (distinct particles' h paths differ by ~sigma_h; the kernel's fma moves
# a row by ulps).
SV_ROW_FLIP = 1e-4
# f32 Gumbel-max near-tie: the two particles' backward scores within this
# relative distance (f32 rounding of ~|score| terms).
SV_TIE = 1e-5
# K10-fwd's weight-derived outputs (ESS, the log-weights, the weighted
# means), max|err| / max|plain|.  Each step's log-weight increment is a
# difference of N-term sums of magnitude ~N (10,000 at S5), which the
# kernel and its twin add in other orders: ~sqrt(N) N eps apart (1e-10 in
# f64; in f32 the twin's own N-term f32 sums, ~N log2(N) eps32 ~ 1e-2).
# The log-weights carry it from step to step until a resampling, and ESS
# doubles the weights' relative error.  ll_rel and the gathered particles
# take TOL's 1e-10 / 1e-4, n_resamples exactly.
SV_WEIGHT_TOL = {torch.float64: 1e-8, torch.float32: 5e-2}
SV_WEIGHTED = ("f_mean", "h_mean", "ess", "logw_hist")


@functools.lru_cache(maxsize=None)
def sv_panel(seed: int, T_: int = SV_T, N_: int = SV_N, K_: int = SV_K):
    """``simulate_sv`` (walk scale 0.05): (Y, the DGP's params), made once
    a seed and shape (callers only read them)."""
    Y, _, _, p = dgp.simulate_sv(N_, T_, K_, np.random.default_rng(seed))
    return Y, p


def sv_draws64(T_: int, spec, seed: int):
    """One E-step's draws in f64 from a seeded host generator; each run
    casts them to its device and dtype, so every comparison is on the same
    numbers."""
    g = torch.Generator().manual_seed(seed)
    return sv.estep_draws(T_, spec, True, torch.float64, "cpu", g)


def sv_args(Yz, p, sigma_h, h_center, draws, dtype):
    """Card tensors of one RBPF pass in ``dtype``: (the scan's leading
    arguments, ``SVDraws``, ``FFBSDraws``).  B = Y R^{-1} Lam is read only
    by the expanded form."""
    on = lambda a: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                   else a).to("cuda", dtype).contiguous()
    Yt = on(Yz)
    pt = SSMParams(*(on(getattr(p, f)) for f in SSMParams._fields))
    G0 = pt.Lam / pt.R[:, None]
    args = (Yt, pt.Lam, pt.R, (pt.Lam.T @ G0).contiguous(),
            (Yt @ G0).contiguous(), pt.A, pt.mu0, pt.P0, on(h_center),
            on(sigma_h))
    return (args, sv.SVDraws(*map(on, draws[0])),
            sv.FFBSDraws(*map(on, draws[1])))


def cuda_ms_once(fn) -> tuple:
    """(milliseconds on CUDA events, result) of one call of ``fn``: the
    plain twin's S5 pass takes seconds, so its comparison call is its
    timing (a Python loop of ~60 launches a step, warm after the
    kernel's runs)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def sv_run(fn, args, fd, spec, residual: bool, store: bool = True):
    return fn(*args, spec.h0_scale, fd, spec.ess_frac, residual, store)


def sv_split(kern, plain, thr: float, dtype):
    """(t*, kind, n_rows): the first step at which the kernel and its twin
    resample differently, their decisions (ESS < thr) or, both resampling,
    the particles they gather (an h row moved past SV_ROW_FLIP; n_rows
    such rows); (None, None, 0) if they never do."""
    dk, dp = kern[3] < thr, plain[3] < thr
    rows = (kern[5] - plain[5]).abs().amax(-1) > SV_ROW_FLIP      # (T, M)
    bad = (dk != dp) | (dk & dp & rows.any(-1))
    if not bool(bad.any()):
        return None, None, 0
    t = int(bad.nonzero()[0, 0])
    kind = "decision" if bool(dk[t] != dp[t]) else "indices"
    return t, kind, int(rows[t].sum())


def sv_compare(kern, plain, dtype, thr: float, label: str) -> dict:
    """K10-fwd against its twin: in f64 every output through all T steps
    (TOL, SV_WEIGHT_TOL), the same resampling decisions at every step and
    the same gathered particles; in f32 every output before the first step
    t* at which the two resample differently (``sv_split``), and ll_rel
    and ESS (computed before the gather) at t* too.  At a decision flip
    the ESS margin |ESS - ess_frac M| must lie within the f32 tolerance of
    ESS (SV_WEIGHT_TOL x ess_frac M); an index flip is reported with its
    row count.  Returns the record's error fields."""
    t_star, kind, n_rows = sv_split(kern, plain, thr, dtype)
    if dtype == torch.float64 and t_star is not None:
        raise AssertionError(f"sv_rbpf f64 {label}: resampled differently "
                             f"from its twin at step {t_star} ({kind})")
    T_ = kern[0].shape[0]
    win = T_ if t_star is None else t_star
    errs, abs_err = {}, 0.0
    for name, g, r in zip(SV_OUTS, kern, plain):
        if g is None:
            continue
        if not bool(torch.isfinite(g.double()).all()):
            raise AssertionError(f"sv_rbpf {label}: non-finite {name}")
        if name == "n_resamples":
            if t_star is None and int(g) != int(r):
                raise AssertionError(f"sv_rbpf {label}: n_resamples "
                                     f"{int(g)} != {int(r)}")
            continue
        n = win + 1 if (name in ("ll_rel", "ess") and t_star is not None) \
            else win
        g, r = g[:n].double(), r[:n].double()
        if n == 0:
            continue
        e = float((g - r).abs().max())
        scale = max(float(r.abs().max()), 1e-300)
        errs[name] = e / scale
        abs_err = max(abs_err, e)
        tol = (SV_WEIGHT_TOL[dtype] if name in SV_WEIGHTED
               else TOL[dtype]["sv_rbpf"])
        if not e <= tol * scale:
            raise AssertionError(f"sv_rbpf ({dtype}, {label}) {name} over "
                                 f"{n} steps: {e:.3e} > {tol:.0e} x "
                                 f"{scale:.3e}")
    out = {"max_rel_err": max(errs.values()), "max_abs_err": abs_err,
           "rel_err": errs, "tol": TOL[dtype]["sv_rbpf"],
           "weight_tol": SV_WEIGHT_TOL[dtype], "first_split": t_star,
           "split_kind": kind, "n_resamples": [int(kern[4]),
                                               int(plain[4])]}
    if kind == "decision":
        ek, ep = float(kern[3][t_star]), float(plain[3][t_star])
        margin = min(abs(ek - thr), abs(ep - thr))
        allowed = SV_WEIGHT_TOL[dtype] * thr
        out.update({"split_ess": [ek, ep], "ess_margin": margin,
                    "ess_margin_allowed": allowed})
        if not margin <= allowed:
            raise AssertionError(f"sv_rbpf ({dtype}, {label}): decision "
                                 f"flip at step {t_star} with ESS margin "
                                 f"{margin:.3e} > {allowed:.3e}")
    elif kind == "indices":
        out["split_rows"] = n_rows
    return out


def ffbs_compare(Hk, Hp, h_hist, logw, sigma, bd, dtype, label: str) -> dict:
    """K10-ffbs against its twin on the same filter history: the outputs
    are copies of h rows, so they agree exactly unless an argmax flips.
    In f64 none may; in f32 each draw's first flip (backward) must be a
    near-tie: the two chosen particles' scores, recomputed in f64, within
    SV_TIE of each other."""
    diff = (Hk != Hp).any(-1)                                   # (T, S)
    if not bool(diff.any()):
        return {"max_rel_err": 0.0, "max_abs_err": 0.0, "flips": 0}
    if dtype == torch.float64:
        raise AssertionError(f"sv_ffbs f64 {label}: paths differ at "
                             f"{int(diff.sum())} (step, draw) cells")
    T_ = Hk.shape[0]
    s2 = torch.clamp(sigma.double() ** 2, min=1e-20)
    gaps = []
    for s in diff.any(0).nonzero()[:, 0].tolist():
        t = int(diff[:, s].nonzero()[-1, 0])                 # first, backward
        if t == T_ - 1:
            v = logw[t].double() + bd.g_last[s].double()
        else:
            d2 = ((Hp[t + 1, s].double()[None] - h_hist[t].double()) ** 2
                  / s2).sum(-1)
            v = logw[t].double() - 0.5 * d2 + bd.g[t, s].double()
        ik = int((h_hist[t] == Hk[t, s]).all(-1).nonzero()[0, 0])
        ip = int((h_hist[t] == Hp[t, s]).all(-1).nonzero()[0, 0])
        gaps.append(float((v[ik] - v[ip]).abs()
                          / max(float(v[ik].abs()), 1.0)))
    e = float((Hk - Hp).abs().max())
    out = {"max_rel_err": e / float(Hp.abs().max()), "max_abs_err": e,
           "flips": len(gaps), "max_tie_gap": max(gaps)}
    if not max(gaps) <= SV_TIE:
        raise AssertionError(f"sv_ffbs f32 {label}: a flipped argmax with "
                             f"score gap {max(gaps):.3e} > {SV_TIE}")
    return out


def k10_flops(name: str, T_: int, N_: int, M_: int, k: int,
              residual: bool) -> float:
    """Operations of a K10-fwd pass.  ``sv_rbpf`` (csrc/sv_rbpf.cu):
    15 k^3 + 8 k^2 a particle and step.  K10-fwd-gen (csrc/sv_gen.cu), what
    the step needs, each symmetric result counted over one triangle: the
    prediction 23/3 k^3 + 10 k^2 (A P 2 k^3 and the lower half of (A P) A'
    k^3, two Cholesky factors 2/3 k^3, C Lp over Lp's triangle k^3 and the
    lower half of Lp' (C Lp) k^3 / 3, the two triangular solves of G^{-1}
    Lp' 2 k^3, the lower half of Lp Xs 2/3 k^3), the update 2 k^2 + 5 k
    (expanded 4 k^2 + 9 k), the weighted means 4 k.  Both: the residual
    stage's (4 k + 3) N."""
    if name == "sv_rbpf":
        per = 15 * k ** 3 + 8 * k * k
    else:
        per = (23 / 3 * k ** 3 + 10 * k * k + 4 * k
               + (2 * k * k + 5 * k if residual else 4 * k * k + 9 * k))
    return T_ * M_ * (per + ((4 * k + 3) * N_ if residual else 0))


# The wrapper that launches each K10 kernel at any (k, M) it takes: the
# routing entries for K10's own kernels (k <= 16, M <= 1,024), the generic
# entries, which launch the generic kernels at every (k, M), for theirs.
SV_ENTRY = {"sv_rbpf": sv.rbpf_scan, "sv_ffbs": sv.ffbs,
            "sv_rbpf_gen": sv.rbpf_scan_gen, "sv_ffbs_gen": sv.ffbs_gen}


def sv_rbpf_timing(name, args, fd, spec, residual: bool, kern, dtype) -> dict:
    """K10-fwd (kernel ``name``) on these inputs, warm and cold L2, beside T
    x the residual's two ``matmul``s a step (the yardstick), the bound and
    K4's latency floor at (T, k)."""
    run = lambda: sv_run(SV_ENTRY[name], args, fd, spec, residual, False)
    T_, N_ = args[0].shape
    M_, k = fd.h0.shape
    ins = (args[0] if residual else args[4], *args[1:4], *args[5:], *fd)
    bms, bby = bound(nbytes_of(ins) + nbytes_of(kern[:5]),
                     k10_flops(name, T_, N_, M_, k, residual), dtype)
    xp = fd.h0 @ args[5].T                                   # (M, k)
    lib = (lambda: ((args[0][0][None] - xp @ args[1].T) / args[2][None])
           @ args[1])
    return {"kernel_ms": cuda_ms(run),
            "kernel_ms_cold_l2": cuda_ms_cold(run, reps=3),
            "library_ms": (T_ * cuda_ms(lib) if residual else None),
            "bound_ms": bms, "bound_by": bby,
            "latency_ms": latency_ms("info_scan", dtype, k, T_)}


def sv_ffbs_timing(name, hist, sigma, bd, dtype) -> dict:
    """K10-ffbs (kernel ``name``) on a filter history, warm and cold L2,
    beside its plain twin and its bound (the history, weights and Gumbels
    read once)."""
    run = lambda: SV_ENTRY[name](hist[5], hist[6], sigma, bd)
    T_, M_, k = hist[5].shape
    S_ = bd.g_last.shape[0]
    bms, bby = bound(nbytes_of((hist[5], hist[6], sigma, *bd, run())),
                     (T_ - 1) * S_ * M_ * (3 * k + 3), dtype)
    return {"kernel_ms": cuda_ms(run),
            "kernel_ms_cold_l2": cuda_ms_cold(run, reps=3),
            "plain_ms": cuda_ms(lambda: sv.ffbs_plain(hist[5], hist[6],
                                                      sigma, bd)),
            "library_ms": None, "latency_ms": None, "bound_ms": bms,
            "bound_by": bby}


def sv_kernel_cases(Yz, p, sigma_h, h_center, spec, draws, dtype,
                    label: str, timed: bool,
                    forms=("residual", "expanded"),
                    generic: bool = False) -> list:
    """K10-fwd (in each of ``forms``: residual, expanded) and, after the
    residual form, K10-ffbs on one panel in ``dtype``, under the kernel
    names ``kernels.route_sv`` gives (the generic kernels, through their
    own entries, if ``generic``): each against its twin, the kernel run
    twice (bit for bit), the twin's comparison call timed
    (``plain_ms``), and, when ``timed``, the kernels timed warm and cold
    beside the yardstick and the bound.  Returns one record each."""
    args, fd, bd = sv_args(Yz, p, sigma_h, h_center, draws, dtype)
    T_, N_ = args[0].shape
    M_, k = fd.h0.shape
    S_ = bd.g_last.shape[0]
    thr = spec.ess_frac * M_
    fwd, bwd = (kernels.GEN[n] if generic else kernels.route_sv(n, k, M_)
                for n in ("sv_rbpf", "sv_ffbs"))
    recs = []
    with highest_precision():
        for form in forms:
            residual = form == "residual"
            kern = sv_run(SV_ENTRY[fwd], args, fd, spec, residual)
            again = sv_run(SV_ENTRY[fwd], args, fd, spec, residual)
            plain_ms, plain = cuda_ms_once(lambda: sv_run(
                sv.rbpf_scan_plain, args, fd, spec, residual))
            same = all(torch.equal(a, b) for a, b in zip(kern, again)
                       if a is not None)
            if not same:
                raise AssertionError(f"{fwd} {label} {form}: two runs "
                                     "on the same draws differ")
            rec = {"name": fwd, "variant": f"{label} {form}",
                   "dtype": str(dtype)[6:], "T": T_, "N": N_, "k": k,
                   "M": M_, "bitwise_rerun": same, "plain_ms": plain_ms,
                   **sv_compare(kern, plain, dtype, thr, f"{label} {form}")}
            if timed:
                rec.update(sv_rbpf_timing(fwd, args, fd, spec, residual,
                                          kern, dtype))
            recs.append(rec)
            if residual:
                hist = kern
        if "residual" not in forms:
            return recs
        Hk = SV_ENTRY[bwd](hist[5], hist[6], args[9], bd)
        Hp = sv.ffbs_plain(hist[5], hist[6], args[9], bd)
        torch.cuda.synchronize()
        if not torch.equal(Hk, SV_ENTRY[bwd](hist[5], hist[6], args[9], bd)):
            raise AssertionError(f"{bwd} {label}: two runs differ")
        rec = {"name": bwd, "variant": label,
               "dtype": str(dtype)[6:], "T": T_, "M": M_, "S": S_, "k": k,
               **ffbs_compare(Hk, Hp, hist[5], hist[6], args[9], bd, dtype,
                              label)}
        if timed:
            rec.update(sv_ffbs_timing(bwd, hist, args[9], bd, dtype))
        recs.append(rec)
    return recs


def sv_kernel_phase(seed: int, fit) -> dict:
    """Phase 31: K10-fwd and K10-ffbs against their plain twins at S5's
    full width, on the same draws: the panel standardized as the fit saw
    it, the fit's params, sigma_h and h_0 center; f64 then f32
    (``sv_compare``, ``ffbs_compare``): the residual form (the fit's) and
    FFBS on the first VGEN_WINDOW steps (the twins' Python loop takes
    ~6 s a pass over all 1,000: ``vgen_kernel_phase``'s cut), the kernels
    timed in f32, the path's dtype, on the window and over all SV_T steps
    (``vgen_time``); the expanded form (``quad_form="expanded"``) on the
    first SV_EXPANDED_T steps, untimed; then the generic kernels timed on
    the same f32 inputs over all the steps (``sv_gen_beside``).  Returns
    the f32 residual and FFBS records by name."""
    Y, _ = sv_panel(seed + 1101)
    Yz = fit.standardizer.transform(Y)
    spec = dt.SVSpec(n_factors=SV_K, n_particles=SV_M)
    draws = sv_draws64(SV_T, spec, seed + 1103)
    draws_e = sv_draws64(SV_EXPANDED_T, spec, seed + 1104)
    W_ = VGEN_WINDOW
    fd, bd = draws
    win = (sv.SVDraws(fd.h0, fd.xi[:W_], fd.u[:W_]),
           sv.FFBSDraws(bd.g_last, bd.g[:W_ - 1]))
    summary = {}
    for dtype in (torch.float64, torch.float32):
        recs = sv_kernel_cases(Yz[:W_], fit.params, fit.sigma_h,
                               fit.h_center, spec, win, dtype,
                               f"S5 T={W_}", timed=False,
                               forms=("residual",))
        recs += sv_kernel_cases(Yz[:SV_EXPANDED_T], fit.params, fit.sigma_h,
                                fit.h_center, spec, draws_e, dtype,
                                f"S5 T={SV_EXPANDED_T}", timed=False,
                                forms=("expanded",))
        if dtype == torch.float32:
            recs = vgen_time(recs, Yz, fit, spec, draws, W_)
        for rec in recs:
            rec.setdefault("plain_T", rec["T"])
            emit(rec)
            if dtype == torch.float32 and rec["variant"] in (
                    f"S5 T={W_} residual", f"S5 T={W_}"):
                summary[rec["name"]] = rec
        torch.cuda.empty_cache()
    emit(sv_gen_beside(Yz, fit, spec, draws))
    return summary


def sv_gen_beside(Yz, fit, spec, draws) -> dict:
    """The generic kernels at S5's own (k, M) in f32, through their own
    entries, on the inputs and draws ``sv_kernel_phase`` times K10's own
    kernels on: K10-fwd-gen (residual form) and K10-ffbs-gen timed as
    there, each beside the routed kernel's time on the same inputs in this
    call (``route_sv``'s choice below k = 17 and M = 1,025)."""
    args, fd, bd = sv_args(Yz, fit.params, fit.sigma_h, fit.h_center, draws,
                           torch.float32)
    T_, N_ = args[0].shape
    M_, k = fd.h0.shape
    with highest_precision():
        hist = sv_run(sv.rbpf_scan_gen, args, fd, spec, True)
        fwd = sv_rbpf_timing("sv_rbpf_gen", args, fd, spec, True, hist,
                             torch.float32)
        bwd = sv_ffbs_timing("sv_ffbs_gen", hist, args[9], bd,
                             torch.float32)
        own = sv_run(sv.rbpf_scan, args, fd, spec, True)
        own_fwd = cuda_ms(lambda: sv_run(sv.rbpf_scan, args, fd, spec, True,
                                         False))
        own_bwd = cuda_ms(lambda: sv.ffbs(own[5], own[6], args[9], bd))
    del hist, own
    return {"sv_gen_beside": "S5", "dtype": "float32", "T": T_, "N": N_,
            "k": k, "M": M_, "sv_rbpf_gen": fwd, "sv_ffbs_gen": bwd,
            "sv_rbpf_ms": own_fwd, "sv_ffbs_ms": own_bwd,
            "gen_over_own": [fwd["kernel_ms"] / own_fwd,
                             bwd["kernel_ms"] / own_bwd]}


def sv_k_sweep(seed: int) -> None:
    """K10 at (k, M) in SV_SWEEP on 60 x 300 panels (the DGP's params,
    sigma_h 0.1), f64 and f32, both forms and FFBS (S = 16): error checks
    only; then ``sv_k129_raises``."""
    for i, (k, M_) in enumerate(SV_SWEEP):
        Y, p = sv_panel(seed + 1120 + i, T_=60, N_=300, K_=k)
        spec = dt.SVSpec(n_factors=k, n_particles=M_, n_smooth_draws=16)
        draws = sv_draws64(60, spec, seed + 1140 + i)
        worst = {}
        for dtype in (torch.float64, torch.float32):
            for rec in sv_kernel_cases(Y, p, np.full(k, 0.1), np.zeros(k),
                                       spec, draws, dtype, f"k{k} M{M_}",
                                       timed=False):
                worst[f"{rec['variant']} {rec['dtype']}"] = {
                    x: rec.get(x) for x in ("max_rel_err", "first_split",
                                            "split_kind", "flips")
                    if rec.get(x) is not None}
        emit({"sv_k_sweep": [k, M_], "checks": worst})
    sv_k129_raises(seed)


def sv_k129_raises(seed: int) -> None:
    """K10-fwd and K10-ffbs at k = 129 (M = 64 and 2,048), through the
    routing entries and the generic ones, must raise NotImplementedError
    naming the ROADMAP row before any launch."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    k = kernels.GEN_KMAX + 1
    for M_ in (64, 2048):
        spec = dt.SVSpec(n_factors=k, n_particles=M_, n_smooth_draws=4)
        Y, p = sv_panel(seed + 1160, T_=10, N_=40, K_=k)
        args, fd, bd = sv_args(Y, p, np.full(k, 0.1), np.zeros(k),
                               sv_draws64(10, spec, 1), torch.float32)
        hist = torch.zeros((10, M_, k), dtype=torch.float32, device="cuda")
        logw = torch.zeros((10, M_), dtype=torch.float32, device="cuda")
        for name, call in (
                ("sv_rbpf", lambda: sv_run(sv.rbpf_scan, args, fd, spec,
                                           True)),
                ("sv_ffbs", lambda: sv.ffbs(hist, logw, args[9], bd)),
                ("sv_rbpf_gen", lambda: sv_run(sv.rbpf_scan_gen, args, fd,
                                               spec, True)),
                ("sv_ffbs_gen", lambda: sv.ffbs_gen(hist, logw, args[9],
                                                    bd))):
            try:
                call()
            except NotImplementedError as e:
                if kernels.GENERIC_K not in str(e):
                    raise
                emit({"sv_range": [name, k, M_], "raises": str(e)[:120]})
            else:
                raise AssertionError(f"{name} at k = {k}, M = {M_} did "
                                     "not raise")
    if sum(kernels.LAUNCHES.values()):
        raise AssertionError(f"k = 129: launches {kernels.LAUNCHES}")


class SVWatch:
    """Stamps an SV fit's E-steps (``models.sv.e_step_device``, with the
    launches each made) and its blocking reads (``estim.fused.read_packed``,
    which each pass's read and the result's go through), in order."""

    def __enter__(self):
        self.events = []
        self._saved = (sv.e_step_device, tfu.read_packed)
        e_step, read = self._saved

        def watched_e_step(*a, **kw):
            n0 = dict(kernels.LAUNCHES)
            out = e_step(*a, **kw)
            self.events.append(("E", {nm: v - n0[nm] for nm, v in
                                      kernels.LAUNCHES.items() if v != n0[nm]}))
            return out

        def watched_read(x):
            out = read(x)
            self.events.append(("R", time.perf_counter()))
            return out
        sv.e_step_device, tfu.read_packed = watched_e_step, watched_read
        return self

    def __exit__(self, *exc):
        sv.e_step_device, tfu.read_packed = self._saved


def device_ms_by_kernel(fn) -> dict:
    """Device milliseconds and launches of each kernel that ``fn`` runs,
    from ``torch.profiler`` (CUPTI); empty if the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.count:
            out[ev.key] = (us / 1e3, ev.count)
    return out


def sv_fit_phase(seed: int, k: int = SV_K, M_: int = SV_M,
                 label: str = "sv fit", breakdown: bool = True):
    """Phase 32: ``fit(SVSpec(n_factors=k, n_particles=M_), Y,
    max_iters=1)`` on S5's panel simulated at k (f32; S5 itself at k = 5):
    the pre-fit (``auto`` -> ``ss``, the api's 20 EM iterations), one
    particle-EM iteration and the final E-step, then ``forecast(res,
    12)``: finite outputs of S5's shapes, sigma_h >= 1e-4; exactly one
    K10-fwd and one K10-ffbs (the kernels ``kernels.route_sv`` gives) and
    no other kernel an E-step, and one read an E-step plus the result's;
    the fit wall; then, if ``breakdown``, ``sv_pass_breakdown``.  Returns
    ({label: the launch counts}, the fit)."""
    Y, _ = sv_panel(seed + 1101, K_=k)
    spec = dt.SVSpec(n_factors=k, n_particles=M_)
    want = {kernels.route_sv(n, k, M_): 1 for n in ("sv_rbpf", "sv_ffbs")}
    torch.cuda.synchronize()
    kernels.reset_launches()
    with SVWatch() as w:
        t0 = time.perf_counter()
        res = dt.fit(spec, Y, max_iters=1)
        y_fore, f_fore = dt.forecast(res, 12)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    kinds = [e[0] for e in w.events]
    first = kinds.index("E")
    e_launches = [e[1] for e in w.events if e[0] == "E"]
    emit({"fit": label, "spec": dataclasses.asdict(spec),
          "shape": [SV_T, SV_N, k], "wall_s": wall,
          "logliks": [float(x) for x in res.logliks],
          "sigma_h": res.sigma_h.tolist(), "h_center": res.h_center.tolist(),
          "n_resamples": int(res.result.n_resamples),
          "events_from_first_e_step": "".join(kinds[first:]),
          "launches_per_e_step": e_launches,
          "launches": {nm: v for nm, v in launches.items() if v}})
    if (kinds[first:] != ["E", "R", "E", "R", "R"]
            or any(e != want for e in e_launches)):
        raise AssertionError(f"{label}: events {kinds[first:]}, E-step "
                             f"launches {e_launches}, expected {want}")
    for name, arr in (("logliks", res.logliks), ("sigma_h", res.sigma_h),
                      ("h_center", res.h_center),
                      ("h_smooth", res.h_smooth),
                      ("vol_paths", res.vol_paths), ("y_fore", y_fore),
                      ("f_fore", f_fore)):
        if not np.isfinite(arr).all():
            raise AssertionError(f"{label}: non-finite {name}")
    if not (res.sigma_h >= sv.SIGMA_FLOOR).all():
        raise AssertionError(f"{label}: sigma_h {res.sigma_h} under the "
                             "floor")
    if res.h_smooth.shape != (SV_T, k) or y_fore.shape != (12, SV_N):
        raise AssertionError(f"{label}: unexpected output shapes")
    if breakdown:
        sv_pass_breakdown(Y, res, spec)
    return {label: launches}, res


# Device kernels of a K10-fwd pass by its C call's name, and how many a
# pass launches (T steps; the history off, as the timed pass runs):
# csrc/sv_rbpf.cu an init grid, then a residual grid and a step kernel a
# step; csrc/sv_gen.cu an init prediction, then a residual grid, the
# update, the scalar stage, the means and (for t + 1 < T) the prediction a
# step.
SV_STAGES = {"sv_rbpf": ("sv_residual_kernel", "sv_step_kernel",
                         "sv_init_kernel"),
             "sv_rbpf_gen": ("svg_residual_kernel", "svg_update_kernel",
                             "svg_scalar_kernel", "svg_means_kernel",
                             "svg_predict_kernel")}


def sv_pass_launches(name: str, T_: int, residual: bool = True) -> int:
    if name == "sv_rbpf":
        return (2 if residual else 1) * T_ + 1
    return (5 if residual else 4) * T_


def sv_pass_breakdown(Y, res, spec) -> None:
    """The filter pass at the estimated params (f32, ``store_paths=False``,
    bench/run.py:111-135): host seconds a pass, best of 3 after a warm
    pass (``sv_filter``, the read included), and passes/s; the K10-fwd
    pass alone on CUDA events, split by ``torch.profiler`` into the
    routed kernel's stages (``SV_STAGES``), the rest being the launch gaps
    (``sv_pass_launches`` a pass); the E-step (K10-fwd with the history,
    K10-ffbs, the f64 increments) on CUDA events.  Then one E-step and its
    M-step under ``set_sync_debug_mode("error")`` (the panel, params and
    generator made before the guard, the draws inside)."""
    f32 = torch.float32
    with highest_precision():
        Yt = torch.as_tensor(res.standardizer.transform(Y), dtype=f32,
                             device="cuda").contiguous()
        pt = SSMParams.from_numpy(res.params, dtype=f32, device="cuda")
        sig = torch.as_tensor(res.sigma_h, dtype=f32, device="cuda")
        hc = torch.as_tensor(res.h_center, dtype=f32, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)

        def one_pass():
            t0 = time.perf_counter()
            r = sv.sv_filter(Yt, pt, spec, generator=gen, sigma_h=sig,
                             h_center=hc, store_paths=False)
            float(r.loglik)
            return time.perf_counter() - t0
        one_pass()
        pass_s = min(one_pass() for _ in range(3))
        T_, N_ = Yt.shape
        k, M_ = spec.n_factors, spec.n_particles
        name = kernels.route_sv("sv_rbpf", k, M_)
        draws = sv.estep_draws(T_, spec, True, f32, "cuda", gen)
        G0 = pt.Lam / pt.R[:, None]
        C = (pt.Lam.T @ G0).contiguous()
        run = lambda: sv.rbpf_scan(Yt, pt.Lam, pt.R, C, None, pt.A, pt.mu0,
                                   pt.P0, hc, sig, spec.h0_scale, draws[0],
                                   spec.ess_frac, True, False)
        pass_ms = cuda_ms(run)
        by_kernel = device_ms_by_kernel(run)
        stage = {}
        for key, (ms, n) in by_kernel.items():
            for nm in SV_STAGES[name]:
                if nm in key:
                    stage[nm] = (stage.get(nm, (0.0, 0))[0] + ms,
                                 stage.get(nm, (0.0, 0))[1] + n)
        e_ms = cuda_ms(lambda: sv.e_step_device(Yt, pt, spec, sig, hc, draws,
                                                smooth=True))
        torch.cuda.synchronize()
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            dr = sv.estep_draws(T_, spec, True, f32, "cuda", gen)
            _, H = sv.e_step_device(Yt, pt, spec, sig, hc, dr, smooth=True)
            sv.m_step(H, sig, None, 3.0)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.synchronize()
    measured = sum(ms for ms, _ in stage.values())
    emit({"sv_pass_breakdown": "residual f32", "kernel": name,
          "shape": [T_, N_, k], "M": M_, "pass_s": pass_s,
          "passes_per_sec": 1.0 / pass_s, "kernel_pass_ms": pass_ms,
          "stage_ms": {nm: ms for nm, (ms, _) in stage.items()} or
          "not measured (no device time from the profiler)",
          "stage_launches": {nm: n for nm, (_, n) in stage.items()},
          "launches_under_pass": sv_pass_launches(name, T_),
          "gaps_ms": pass_ms - measured if stage else None,
          "e_step_ms": e_ms, "e_steps_sync_checked": 1})


def sv_reference_phase(seed: int, T_: int = 120, N_: int = 40, k: int = 2,
                       M_: int = 64, sv_iters: int = 2) -> None:
    """Phase 33a: ``sv_fit`` of ``simulate_sv(N_, T_, k)`` (40 x 120, k =
    2 by default), M_ particles, ``sv_iters`` particle-EM iterations (2
    by default) and the final E-step, on the card in f64 against the CPU in f64 on the same draws
    (made on the host), within 1e-9 relative (logliks, sigma_h, h_center,
    h_smooth, the forecast); the card's kernels the routed ones, one
    K10-fwd and one K10-ffbs an E-step."""
    Y, _ = sv_panel(seed + 1102, T_=T_, N_=N_, K_=k)
    spec = dt.SVSpec(n_factors=k, n_particles=M_)
    draws = [sv_draws64(T_, spec, seed + 1110 + i)
             for i in range(sv_iters + 1)]
    res = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launches()
        dr = [(sv.SVDraws(*(x.to(dev) for x in a)),
               sv.FFBSDraws(*(x.to(dev) for x in b))) for a, b in draws]
        r = sv.sv_fit(Y, spec, sv_iters=sv_iters, draws=dr,
                      backend=dt.TorchBackend(device=dev,
                                              dtype=torch.float64))
        res[dev] = (r, dt.forecast(r, 12)[0], dict(kernels.LAUNCHES))
    (rg, yg, lg), (rc, yc, _) = res["cuda"], res["cpu"]
    for n in ("sv_rbpf", "sv_ffbs"):
        if lg[kernels.route_sv(n, k, M_)] != sv_iters + 1:
            raise AssertionError(f"sv reference k = {k}, M = {M_}: "
                                 f"launches {lg}")
    errs = {name: rel_err(g, c) for name, g, c in (
        ("logliks", rg.logliks, rc.logliks), ("sigma_h", rg.sigma_h,
                                              rc.sigma_h),
        ("h_center", rg.h_center, rc.h_center),
        ("h_smooth", rg.h_smooth, rc.h_smooth), ("y_fore", yg, yc))}
    emit({"reference": "sv", "shape": [T_, N_, k], "M": M_,
          "sv_iters": sv_iters,
          "kernels": [kernels.route_sv(n, k, M_)
                      for n in ("sv_rbpf", "sv_ffbs")],
          "max_rel_err": errs, "tol": 1e-9})
    bad = {n: e for n, e in errs.items() if not e <= 1e-9}
    if bad:
        raise AssertionError(f"sv card fit disagrees with the CPU fit: {bad}")


def sv_contract_phase(seed: int, fit, k: int = SV_K,
                      jitter_oracle: bool = False) -> None:
    """Phase 33b-c at S5's full width (the panel simulated at k, k = 5
    being S5's own), the panel as the fit saw it.  (b) sigma_h = 0,
    h0_scale = 0: every particle carries h = log diag Q, so the RBPF loglik
    (M = 256) is the exact Kalman loglik with Q = diag(diag Q)
    (tests/test_sv.py:20-32), here the port's f64 ``loglik_eval`` on the
    card: within 1e-9 in f64 and 1e-5 in f32, gated.  The RBPF predicts
    its step 0 from (mu0, P0) where the info filter takes them as the
    step-0 prediction, so the oracle's are (A mu0, A P0 A' + Q) (equal
    only for a stationary P0, as ``dgp.dfm_params`` draws it in that
    test).  With ``jitter_oracle`` (k = 25) the pass is also held, within
    the same limits, to the oracle the reference's arithmetic makes exact:
    its Lp = chol(sym(P_p) + 1e-6 I) makes the sigma_h = 0 RBPF the Kalman
    filter of Q + 1e-6 I (the JAX package's as the port's,
    tests/test_torch_sv_gen.py), whose gap to the filter of Q (reported)
    grows with k and the conditioning.  (c) f32 against f64 on the same draws at
    the fitted sigma_h and h_0 center (bench/run.py:193-214), with both
    runs' resample counts: a Monte-Carlo estimate, one flipped decision
    changes the path, so not gated."""
    Y, _ = sv_panel(seed + 1101, K_=k)
    Yz = fit.standardizer.transform(Y)
    p = fit.params
    Qd = np.diag(np.diag(p.Q))
    p_diag = cpu_ref.SSMParams(p.Lam, p.A, Qd, p.R, p.mu0, p.P0)

    def kalman(Q):
        return inf.loglik_eval(Yz, cpu_ref.SSMParams(
            p.Lam, p.A, Q, p.R, p.A @ p.mu0, p.A @ p.P0 @ p.A.T + Q),
            precise=True, device="cuda")
    ll_kf = kalman(Qd)
    ll_jit = kalman(Qd + 1e-6 * np.eye(k)) if jitter_oracle else None
    spec0 = dt.SVSpec(n_factors=k, n_particles=SV_M, sigma_h=0.0,
                      h0_scale=0.0)
    spec = dt.SVSpec(n_factors=k, n_particles=SV_M)
    fd = sv_draws64(SV_T, spec, seed + 1104)[0]
    lims = {torch.float64: 1e-9, torch.float32: 1e-5}
    out = {}
    for dtype in (torch.float64, torch.float32):
        Yt = torch.as_tensor(Yz, dtype=dtype, device="cuda").contiguous()
        d = sv.SVDraws(*(x.to("cuda", dtype) for x in fd))
        r0 = sv.sv_filter(Yt, SSMParams.from_numpy(p_diag, dtype=dtype,
                                                   device="cuda"),
                          spec0, draws=d, store_paths=False)
        rel = abs(float(r0.loglik) - ll_kf) / abs(ll_kf)
        r = sv.sv_filter(Yt, SSMParams.from_numpy(p, dtype=dtype,
                                                  device="cuda"),
                         spec, draws=d, sigma_h=fit.sigma_h,
                         h_center=fit.h_center, store_paths=False)
        out[dtype] = (rel, float(r.loglik), int(r.n_resamples))
        rec = {"contract": f"sv linear-Gaussian limit {str(dtype)[6:]}",
               "shape": [SV_T, SV_N, k], "M": SV_M,
               "loglik_kalman_f64": ll_kf, "loglik_rbpf": float(r0.loglik),
               "rel_err": rel, "limit": lims[dtype]}
        checks = [("Q", rel)]
        if jitter_oracle:
            rel_jit = abs(float(r0.loglik) - ll_jit) / abs(ll_jit)
            rec.update({"loglik_kalman_jitter_f64": ll_jit,
                        "rel_err_jitter_oracle": rel_jit,
                        "oracles_gap": abs(ll_jit - ll_kf) / abs(ll_kf)})
            checks.append(("Q + 1e-6 I", rel_jit))
        emit(rec)
        for oracle, e in checks:
            if not e <= lims[dtype]:
                raise AssertionError(
                    f"sv linear-Gaussian limit ({dtype}, k = {k}, oracle "
                    f"{oracle}): {e:.3e} > {lims[dtype]}")
    (_, l64, n64), (_, l32, n32) = out[torch.float64], out[torch.float32]
    emit({"contract": "sv matched draws f32 vs f64 (not gated)",
          "shape": [SV_T, SV_N, k], "M": SV_M, "loglik_f64": l64,
          "loglik_f32": l32, "rel_err": abs(l32 - l64) / abs(l64),
          "n_resamples_f64": n64, "n_resamples_f32": n32})


# ---------------------------------------------------------------------------
# The covariance-form parallel-in-time engine (pit, K14): its two kernels at
# the headline shape, S3's augmented statistics and bench/longt.py's
# largest point (N = 24, k = 2, T = 4,000: bench/longt.py:37-38).  Its fit,
# session, MF route, references and contracts run in the phases above.
# ---------------------------------------------------------------------------

PIT_NEW = ("pit_elements", "pit_scan")
PIT_K_SWEEP = (1, 2, 3, 10, 16, 17, 25, 32)
PIT_T_SWEEP = (1, 2, 3, 7, 97)
LONGT_T, LONGT_N, LONGT_K, LONGT_ITERS = 4000, 24, 2, 16
# The one-call yardsticks of ``pit_cases`` by mode.
PIT_LIBRARY = {"filter elements": "torch.linalg.solve(I + Q C_t, [F | Q])",
               "P_lag": "torch.matmul(P_sm[1:], J')"}


def pit_chain(T_: int) -> list:
    """The combines in sequence of one K14-scan pass: phase 1 (S - 1),
    phase 2 (B - 2), phase 3 (one, every element in parallel) and the
    tail (T - T0)."""
    S = sc.default_block_size(T_)
    B = T_ // S
    return [S - 1, max(B - 2, 0), int(B > 1), T_ - B * S]


def pit_cases(stats, pt, label: str) -> list:
    """Every K14 mode on the elements and moments the plain engine makes
    from ``stats``: the filter elements, the prefix, the assembly, the
    smoother elements, the suffix and P_lag.  Library yardsticks: for the
    element build one batched ``torch.linalg.solve`` of its systems (I + Q
    C_t against [F | Q]: half the build), for P_lag one ``matmul`` (all
    but its zero row); the scans sit beside K4's latency floor at the same
    (T, k)."""
    stats = inf.ObsStats(*(x.contiguous() for x in stats))
    A, Q, mu0, P0 = pt.A, pt.Q, pt.mu0, pt.P0
    dtype = A.dtype
    T_, k = stats.b.shape
    k3 = k ** 3
    el = tuple(x.contiguous() for x in
               pf.pit_filter_elements_plain(stats, A, Q, mu0, P0))
    pref = tuple(x.contiguous() for x in pf.pit_scan_plain(el))
    asm = pf.pit_filter_assemble_plain(pref[1], pref[2], stats.C, A, Q, mu0,
                                       P0)
    kf = FilterResult(asm[0].contiguous(), asm[1].contiguous(), pref[1],
                      pref[2], None)
    (E, g, L), J = pf.pit_smoother_elements_plain(kf, A)
    sel = (E.contiguous(), g.contiguous(), L.contiguous())
    J = J.contiguous()
    suf = tuple(x.contiguous() for x in pf.pit_scan_plain(sel, True))
    C_t = stats.C if stats.C.ndim == 3 else stats.C.expand(T_, k, k)
    M = (torch.eye(k, dtype=dtype, device=A.device)
         + torch.einsum("kl,tlm->tkm", Q, C_t)).contiguous()
    rhs = torch.cat([A, Q], dim=-1).expand(T_, k, 2 * k).contiguous()
    n_comb = n_combines(T_)
    return [
        case("pit_elements", f"filter elements {label}",
             lambda: pf.pit_filter_elements(stats, A, Q, mu0, P0),
             lambda: pf.pit_filter_elements_plain(stats, A, Q, mu0, P0),
             (stats.b, stats.C, A, Q, mu0, P0), T_ * 15.3 * k3,
             library=lambda: torch.linalg.solve(M, rhs)),
        case("pit_scan", f"prefix {label}", lambda: pf.pit_scan(el),
             lambda: pf.pit_scan_plain(el), el, n_comb * 17.0 * k3,
             floor=lambda: latency_ms("info_scan", dtype, k, T_)),
        case("pit_elements", f"assemble {label}",
             lambda: pf.pit_filter_assemble(pref[1], pref[2], stats.C, A, Q,
                                            mu0, P0),
             lambda: pf.pit_filter_assemble_plain(pref[1], pref[2], stats.C,
                                                  A, Q, mu0, P0),
             (pref[1], pref[2], stats.C, A, Q, mu0, P0), T_ * 8.7 * k3),
        case("pit_elements", f"smoother elements {label}",
             lambda: pf.pit_smoother_elements(kf, A)[0],
             lambda: pf.pit_smoother_elements_plain(kf, A)[0],
             (kf.x_pred, kf.P_pred, kf.x_filt, kf.P_filt, A),
             T_ * 8.3 * k3),
        case("pit_scan", f"suffix {label}", lambda: pf.pit_scan(sel, True),
             lambda: pf.pit_scan_plain(sel, True), sel, n_comb * 6.0 * k3,
             floor=lambda: latency_ms("rts_smoother", dtype, k, T_)),
        case("pit_elements", f"P_lag {label}",
             lambda: pf.pit_smoother_assemble(suf[2], J),
             lambda: pf.pit_smoother_assemble_plain(suf[2], J),
             (suf[2], J), T_ * 2.0 * k3,
             library=lambda: torch.matmul(suf[2][1:], J.transpose(-1, -2))),
    ]


def pit_shapes(seed: int, dtype) -> list:
    """(label, stats, params) on the card in ``dtype``: the masked
    headline panel (a per-step C), S3's statistics (the augmented
    loadings of the fit's PCA init, m = 25, T = 300) and the long-T point
    (unmasked: one static C)."""
    dev = torch.device("cuda")
    Ynan, W, _, p = panel(seed)
    Yt = torch.as_tensor(np.where(W > 0, Ynan, 0.0), dtype=dtype,
                         device=dev)
    pt = SSMParams.from_numpy(p, dtype=dtype, device=dev)
    out = [("masked", inf.obs_stats_plain(
        Yt, pt.Lam, pt.R, torch.as_tensor(W, dtype=dtype, device=dev)), pt)]
    spec = mf_spec()
    Yz, Wm, init = mf_inputs(mf_panel(seed + 1000), spec)
    aug = mf.augment(mf.MFParams(*init).to("cuda", dtype), spec)
    out.append(("S3", inf.obs_stats_plain(
        torch.as_tensor(Yz, dtype=dtype, device=dev), aug.Lam, aug.R,
        torch.as_tensor(Wm, dtype=dtype, device=dev)), aug))
    _, _, Yl, pl = panel(seed + 1100, T_=LONGT_T, N_=LONGT_N, K_=LONGT_K)
    ptl = SSMParams.from_numpy(pl, dtype=dtype, device=dev)
    out.append(("long-T", inf.obs_stats_plain(
        torch.as_tensor(Yl, dtype=dtype, device=dev), ptl.Lam, ptl.R), ptl))
    return [(lb, inf.ObsStats(*(x.contiguous() for x in st)), q)
            for lb, st, q in out]


def pit_kernel_phase(seed: int) -> dict:
    """Every K14 mode against its plain twin at the three shapes of
    ``pit_shapes``, f64 then f32 (the TOL rule), timed warm and cold
    (``kernel_record``) beside the plain twin, the bound, the library
    yardstick (the element build), K4's latency floor (the scans) and
    the combines in sequence.  Returns the f32 headline records of the
    element build and the prefix by kernel name."""
    summary, refs = {}, {}
    for dtype in (torch.float64, torch.float32):
        with highest_precision():
            for label, stats, pt in pit_shapes(seed, dtype):
                T_, k = stats.b.shape
                for c in pit_cases(stats, pt, label):
                    # S3's augmented scans run in f64 on the MF path.
                    rec = kernel_record(c, dtype, refs, (
                        dtype == torch.float64) == (label == "S3"))
                    rec.update({"T": T_, "k": k})
                    if c["name"] == "pit_scan":
                        rec["combines_in_sequence"] = pit_chain(T_)
                    rec["library_call"] = PIT_LIBRARY.get(
                        c["variant"][:-len(label) - 1])
                    emit(rec)
                    if (dtype == torch.float32 and c["variant"] in
                            ("filter elements masked", "prefix masked")):
                        summary[c["name"]] = rec
        torch.cuda.empty_cache()
    return summary


def pit_k_sweep(seed: int) -> None:
    """Every K14 mode at k = 1, 2, 3, 10, 16, 17, 25 and 32 (T = 97) and
    at T = 1, 2, 3, 7 and 97 (k = 3), on small panels whose step 0 is
    fully missing and whose step 7 observes fewer than k series, f64 and
    f32: error checks only.  Then k = 33 must route both entry points to
    their generic kernels (the sgen group holds those, and the raise, now
    at 129)."""
    shapes = [(97, k) for k in PIT_K_SWEEP] + [(t, 3) for t in PIT_T_SWEEP]
    for T_, k in shapes:
        _, W, Yfull, p = panel(seed + 1200 + k + T_, T_=T_, N_=300, K_=k)
        W[0] = 0.0
        if T_ > 7:
            W[7] = 0.0
            W[7, :k - 1] = 1.0
        refs, worst = {}, {}
        for dtype in (torch.float64, torch.float32):
            with highest_precision():
                Wt = torch.as_tensor(W, dtype=dtype, device="cuda")
                Yt = torch.as_tensor(Yfull, dtype=dtype, device="cuda") * Wt
                pt = SSMParams.from_numpy(p, dtype=dtype, device="cuda")
                stats = inf.ObsStats(*(x.contiguous() for x in
                                       inf.obs_stats_plain(Yt, pt.Lam, pt.R,
                                                           Wt)))
                for c in pit_cases(stats, pt, f"T={T_} k={k}"):
                    key = (c["name"], c["variant"])
                    _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                    refs[key] = ref
                    mode = c["variant"].split(" T=")[0]
                    worst[f"{mode} {str(dtype)[6:]}"] = rel
        emit({"pit_sweep": {"T": T_, "k": k}, "max_rel_err": worst})
    got = {n: kernels.route(n, kernels.WIDE_KMAX + 1) for n in PIT_NEW}
    emit({"pit_k33": got})
    if any(got[n] != kernels.GEN[n] for n in got):
        raise AssertionError(f"K14 at k = 33 routes {got}, expected the "
                             "generic kernels")


def pit_longt_phase(seed: int) -> None:
    """bench/longt.py's largest point (N = 24, k = 2, T = 4,000,
    standardize=False, f32): the walls of 16-iteration ``info``, ``pit``,
    ``pit_qr``, ``dense`` and ``auto`` fits (tol = 0), each the second of
    two runs (the first warms the caches); finite logliks, the engine
    asked for (``auto`` resolves to ``dense`` at N = 24), K14 launched on
    the pit fit and K15 on the dense ones."""
    _, _, Y, _ = panel(seed + 1100, T_=LONGT_T, N_=LONGT_N, K_=LONGT_K)
    model = dt.DynamicFactorModel(n_factors=LONGT_K, standardize=False)
    walls = {}
    own = {"pit": PIT_NEW, "dense": ("dense_filter",),
           "auto": ("dense_filter",)}
    for engine in ("info", "pit", "pit_qr", "dense", "auto"):
        backend = dt.TorchBackend(filter=engine)
        for _ in range(2):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = dt.fit(model, Y, backend=backend, max_iters=LONGT_ITERS,
                         tol=0.0)
            torch.cuda.synchronize()
            walls[engine] = time.perf_counter() - t0
        resolved = "dense" if engine == "auto" else engine
        if (res.filter != resolved or not np.isfinite(res.logliks).all()
                or res.n_iters != LONGT_ITERS):
            raise AssertionError(f"long-T {engine} fit failed: "
                                 f"{res.filter}, {res.n_iters} iterations")
        if any(kernels.LAUNCHES[n] < LONGT_ITERS
               for n in own.get(engine, ())):
            raise AssertionError(f"long-T {engine}: launches "
                                 f"{kernels.LAUNCHES}")
    emit({"longt": {"T": LONGT_T, "N": LONGT_N, "k": LONGT_K,
                    "iters": LONGT_ITERS}, "fit_wall_s": walls})


# ------------------------------------------------- K15 and generic k --

DENSE_N = 31                 # the widest panel auto routes to dense
DENSE_ITERS = 20
# K15's timed shapes: (label, T, N, k, masked): the masked headline panel's
# first 31 series, bench/longt.py's largest point, a session's capacity.
DENSE_SHAPES = (("masked", T, DENSE_N, K, True),
                ("long-T", LONGT_T, LONGT_N, LONGT_K, False),
                ("session capacity", 1000, DENSE_N, K, True))
WIDE_SWEEP = (1, 3, 16, 17, 25, 32)
WIDE_K = 25                  # BENCH_kscale.json's exact fits
WIDE_SEED = 1302             # the k = 25 panel: seed + WIDE_SEED
WIDE_ITERS = 20
# The generic-k fits at WIDE_K: (label, masked, filter asked, engine it
# resolves to, extra backend options, kernels launched every iteration).
WIDE_FITS = (
    ("k25 masked auto", True, "auto", "info", {},
     ("obs_stats_wide", "info_scan_wide", "quad_local_wide",
      "rts_smoother_wide", "mstep_rows_wide")),
    ("k25 masked pit", True, "pit", "pit", {},
     ("pit_elements", "pit_scan", "obs_stats_wide", "quad_local_wide",
      "mstep_rows_wide")),
    ("k25 masked lowrank", True, "lowrank", "lowrank", {"rank": 8},
     ("lowrank_basis", "lowrank_scan", "lowrank_smoother", "obs_stats_wide",
      "mstep_rows_wide")),
    ("k25 unmasked auto", False, "auto", "ss", {},
     ("ss_cov_path_wide", "affine_scan_wide")),
)


def dense_flops(T_: int, N_: int, k: int) -> float:
    """Operations of a K15 pass: per step the N x N Cholesky (N^3 / 3),
    two triangular solves against k + 1 right-hand sides, S = (H P) H',
    the gain products, the Joseph update and the prediction (the whole
    N x N algebra: masked rows are rows of the identity, still computed)."""
    return T_ * (N_ ** 3 / 3 + 2 * N_ * N_ * (k + 1) + 2 * N_ * N_ * k
                 + 7 * N_ * k * k + 8 * k ** 3)


def dense_case(Yt, mt, pt, label: str) -> dict:
    T_, N_ = Yt.shape
    k = pt.A.shape[0]
    ins = (Yt, *pt) if mt is None else (Yt, mt, *pt)
    return case("dense_filter", label,
                lambda: kalman_filter(Yt, pt, mt),
                lambda: kalman_filter_plain(Yt, pt, mt), ins,
                dense_flops(T_, N_, k),
                floor=lambda: latency_ms("info_scan", Yt.dtype, k, T_))


def dense_inputs(Ynan, W, p, dtype, masked: bool = True):
    dev = torch.device("cuda")
    Yt = torch.as_tensor(Ynan, dtype=dtype, device=dev).contiguous()
    mt = (torch.as_tensor(W, dtype=dtype, device=dev).contiguous()
          if masked else None)
    return Yt, mt, SSMParams.from_numpy(p, dtype=dtype, device=dev)


def dense_kernel_phase(seed: int) -> dict:
    """K15 against its plain twin at ``DENSE_SHAPES``, f64 then f32 (the
    TOL rule), timed warm and cold beside the plain twin, the bound and
    K4's latency floor at the same (T, k).  Returns the f32 masked
    record."""
    summary, refs = {}, {}
    pans = {label: panel(seed + 1200 + i, T_=T_, N_=N_, K_=k)
            for i, (label, T_, N_, k, _) in enumerate(DENSE_SHAPES)}
    for dtype in (torch.float64, torch.float32):
        with highest_precision():
            for label, T_, N_, k, masked in DENSE_SHAPES:
                Ynan, W, Yfull, p = pans[label]
                Yt, mt, pt = dense_inputs(Ynan if masked else Yfull, W, p,
                                          dtype, masked)
                rec = kernel_record(dense_case(Yt, mt, pt, label), dtype,
                                    refs)
                rec["shape"] = [T_, N_, k]
                emit(rec)
                if dtype == torch.float32 and label == "masked":
                    summary["dense_filter"] = rec
    return summary


def dense_k_sweep(seed: int) -> None:
    """K15 at k in WIDE_SWEEP with N in {k, 31, 32} on 40-step panels with
    step 0 fully missing and a step observing fewer than k series, f64 and
    f32 (error checks only); N = 33 and k = 33 must route to K15-gen (the
    dgen group runs it)."""
    worst = {}
    for k in WIDE_SWEEP:
        for N_ in sorted({k, 31, 32}):
            _, W, Yfull, p = panel(seed + 1210 + k, T_=40, N_=N_, K_=k)
            W[0] = 0.0
            W[5] = 0.0
            W[5, :k - 1] = 1.0
            Ynan = np.where(W > 0, Yfull, np.nan)
            refs = {}
            for dtype in (torch.float64, torch.float32):
                with highest_precision():
                    c = dense_case(*dense_inputs(Ynan, W, p, dtype), "sweep")
                    _, rel, _, ref, _ = compare(c, dtype, refs.get("k15"))
                refs["k15"] = ref
                key = f"k={k} {str(dtype)[6:]}"
                worst[key] = max(worst.get(key, 0.0), rel)
    past = {f"{N_},{k}": kernels.route_dense("dense_filter", N_, k)
            for N_, k in ((33, 3), (3, 33))}
    emit({"dense_k_sweep": list(WIDE_SWEEP), "max_rel_err": worst,
          "routes_past_32": past})
    if set(past.values()) != {"dense_filter_gen"}:
        raise AssertionError(f"K15 past N, k = 32 routes {past}")


def dense_fit_launches(iters: int) -> dict:
    """A masked dense fit's launches, exactly: K15, K3 and K4-backward an
    iteration, and K15 + K4-backward once more for the reporting smooth."""
    return {"dense_filter": iters + 1, "mstep_rows": iters,
            "rts_smoother": iters + 1}


def dense_fit_phase(seed: int) -> dict:
    """``fit`` (auto -> dense) on the first 31 series of the masked
    headline panel (20 iterations, tol = 0, f32), the reporting smooth and
    a 12-step forecast; ``fit(fused=True)`` on its first 480 rows; a dense
    session on that at capacity 1,000 (4 queries of 2 rows, one read a
    query under the sync check).  Returns the launch counts by label."""
    Ynan, _, _, _ = panel(seed + 1)
    Yd = Ynan[:, :DENSE_N]
    model = dt.DynamicFactorModel(n_factors=K, dynamics="ar1")
    backend = dt.TorchBackend()
    torch.cuda.synchronize()
    kernels.reset_launches()
    with ReadWatch() as rw:
        t0 = time.perf_counter()
        res = dt.fit(model, Yd, backend=backend, max_iters=DENSE_ITERS,
                     tol=0.0)
        y_fore, _ = dt.forecast(res, 12)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    lls = res.logliks
    chunk = backend.fused_chunk
    steady = [h["secs"] for h in res.history[chunk:]]
    n_chunks = -(-DENSE_ITERS // chunk)
    floor = noise_floor_for(torch.float32, Yd.size)
    want = dense_fit_launches(DENSE_ITERS)
    bad = {n: v for n, v in launches.items() if v != want.get(n, 0)}
    rec = {"fit": "dense", "filter": res.filter, "shape": [T, DENSE_N, K],
           "n_iters": res.n_iters, "loglik_first": float(lls[0]),
           "loglik_last": float(lls[-1]),
           "max_drop": float(max(0.0, -np.diff(lls).min())),
           "noise_floor": floor, "wall_s": wall,
           "em_iters_per_sec": (len(steady) / sum(steady)
                                if steady and sum(steady) > 0 else None),
           "reads": len(rw.stamps) + 1, "n_chunks": n_chunks,
           "launches": {n: v for n, v in launches.items() if v}}
    emit(rec)
    if (res.filter != "dense" or res.n_iters != DENSE_ITERS
            or not np.isfinite(lls).all() or np.diff(lls).min() < -floor
            or not np.isfinite(res.factors).all()
            or not np.isfinite(y_fore).all()
            or y_fore.shape != (12, DENSE_N)):
        raise AssertionError(f"dense fit failed: {res.filter}, "
                             f"{res.n_iters} iterations, logliks {lls}")
    if bad or len(rw.stamps) != n_chunks:
        raise AssertionError(f"dense fit: launches off {want}: {bad}; "
                             f"chunk reads {len(rw.stamps)}, expected "
                             f"{n_chunks}")
    counts = {"dense": launches}
    dense_iteration_breakdown(Yd, res)
    kernels.reset_launches()
    t0 = time.perf_counter()
    fused = dt.fit(model, Yd[:SESSION_T0], backend=backend, fused=True,
                   max_iters=DENSE_ITERS, tol=0.0)
    emit({"fused_fit": "dense", "filter": fused.filter,
          "n_iters": fused.n_iters, "host_reads": fused.host_reads,
          "wall_s": time.perf_counter() - t0,
          "loglik_last": float(fused.logliks[-1]),
          "launches": {n: v for n, v in kernels.LAUNCHES.items() if v}})
    if (fused.filter != "dense" or fused.n_iters != DENSE_ITERS
            or not np.isfinite(fused.logliks).all()
            or kernels.LAUNCHES["dense_filter"] < DENSE_ITERS):
        raise AssertionError(f"dense fused fit failed: {fused.filter}, "
                             f"{fused.n_iters} iterations")
    sess = dt.open_session(fused, Yd[:SESSION_T0], backend=backend,
                           capacity=1000, max_update_rows=8, max_iters=5,
                           tol=0.0)
    drive_session(sess, "dense", Yd, "dense", "dense_filter")
    counts["dense session"] = dict(kernels.LAUNCHES)
    sess.close()
    return counts


def dense_iteration_breakdown(Y, res) -> None:
    """Where a dense EM iteration goes (f32, warm L2, at the fitted params
    on the standardized panel): K15, K4-backward and K3 (CUDA events)
    against the whole ``em_step`` on the device; the rest is the
    iteration less the three (the moments, the k x k M-step, launch
    gaps)."""
    W = data.build_mask(Y)
    Z, _ = data.standardize(Y, mask=W)
    f32 = torch.float32
    with highest_precision():
        Zt = torch.as_tensor(np.where(W > 0, np.nan_to_num(Z), 0.0),
                             dtype=f32, device="cuda").contiguous()
        Wt = torch.as_tensor(W, dtype=f32, device="cuda").contiguous()
        pt = SSMParams.from_numpy(res.params, dtype=f32, device="cuda")
        kf = kalman_filter(Zt, pt, Wt)
        sm = rts_smoother(kf, pt)
        EffT, _ = moments(sm)
        ms = {"dense_filter": cuda_ms(lambda: kalman_filter(Zt, pt, Wt)),
              "rts_smoother": cuda_ms(lambda: rts_smoother(kf, pt)),
              "mstep_rows": cuda_ms(lambda: mstep_rows(
                  Zt, Wt, sm.x_sm, EffT, sm.P_sm, None, 1e-6))}
        cfg = EMConfig(filter="dense")
        iter_ms = cuda_ms(lambda: tem.em_step(Zt, pt, Wt, cfg))
    emit({"dense_iteration_breakdown": list(Y.shape) + [res.params.A.shape[0]],
          "iter_ms": iter_ms, "kernel_ms": ms,
          "rest_ms": iter_ms - sum(ms.values())})


def dense_reference_phase(seed: int) -> None:
    """Dense ``fit(auto)`` at 40 x 20, k = 3, masked, and a dense ring
    session (120 x 20), card f64 against CPU f64 within 1e-10."""
    Ynan, _, _, _ = panel(seed + 1220, T_=40, N_=20, K_=3)
    reference_fit("dense masked", Ynan, 3, "auto", 1e-10, engine="dense")
    _session_reference(seed, "dense", N_=20)


def wide_k_cases(Ynan, W, Yfull, p, dtype, taus) -> list:
    """K3-wide on the masked panel's plain smoother moments, K5a-wide and
    K5b-wide on the unmasked panel's plain ss pass at each (label, tau) of
    ``taus``: cases named by the kernel each wrapper routes to."""
    dev = torch.device("cuda")
    Yt = torch.as_tensor(Ynan, dtype=dtype, device=dev).contiguous()
    Yf = torch.as_tensor(Yfull, dtype=dtype, device=dev).contiguous()
    mt = torch.as_tensor(W, dtype=dtype, device=dev).contiguous()
    pt = SSMParams.from_numpy(p, dtype=dtype, device=dev)
    T_, N_ = Yt.shape
    k = pt.A.shape[0]
    TN, k2, k3 = T_ * N_, k * k, k ** 3
    stats = inf.obs_stats_plain(Yt, pt.Lam, pt.R, mt)
    scan = inf.info_scan_plain(stats, pt.A, pt.Q, pt.mu0, pt.P0)
    kf = FilterResult(*scan[:4], torch.zeros((), dtype=dtype))
    sm = rts_smoother_plain(kf, pt)
    EffT, _ = moments(sm)
    cases = [case(kernels.route("mstep_rows", k), "masked",
                  lambda: mstep_rows(Yt, mt, sm.x_sm, EffT, sm.P_sm, None,
                                     1e-6),
                  lambda: mstep_rows_plain(Yt, mt, sm.x_sm, EffT, sm.P_sm,
                                           1e-6),
                  (Yt, mt, sm.x_sm, EffT, sm.P_sm),
                  TN * (4 * k + 2 * k * (k + 1) + 5) + N_ * (k3 // 3
                                                             + 6 * k2),
                  floor=lambda: latency_ms("info_scan", dtype, k, T_))]
    return cases + ss_cases(inf.obs_stats_plain(Yf, pt.Lam, pt.R), pt, taus)


def ss_cases(ustats, pt, taus, delta_floor: bool = False) -> list:
    """K5a at each (label, tau) of ``taus`` and K5b forward and reverse
    with h = tau on the plain ss pass of the unmasked statistics
    ``ustats``, named by the kernel each wrapper routes to at this k, K4's
    latency chain beside them; with ``delta_floor``, K5a's freeze delta
    takes its rounding floor (see TOL)."""
    T_, k = ustats.b.shape
    dtype = pt.A.dtype
    C = ustats.C
    floor = {4: DELTA_FLOOR_EPS * torch.finfo(dtype).eps} if delta_floor \
        else None
    cases = []
    for label, tau in taus:
        path, fwd, rev = ss_inputs(ustats, pt, tau)
        cases += [
            case(kernels.route("ss_cov_path", k), label,
                 lambda tau=tau: ss.ss_cov_path(C, pt.A, pt.Q, pt.P0, tau),
                 lambda tau=tau: ss.ss_cov_path_plain(C, pt.A, pt.Q, pt.P0,
                                                      tau),
                 (C, pt.A, pt.Q, pt.P0), tau * 27.0 * k ** 3,
                 floor=lambda tau=tau: (
                     latency_ms("info_scan", dtype, k, tau)
                     + latency_ms("rts_smoother", dtype, k, 2 * tau + 1)),
                 abs_floor=floor),
            case(kernels.route("affine_scan", k), f"forward {label}",
                 lambda fwd=fwd: sc.affine_scan(*fwd),
                 lambda fwd=fwd: sc.affine_scan_plain(*fwd), fwd,
                 2.0 * T_ * k * k, floor=lambda: latency_ms(
                     "info_scan", dtype, k, T_)),
            case(kernels.route("affine_scan", k), f"reverse {label}",
                 lambda rev=rev: sc.affine_scan(*rev, reverse=True),
                 lambda rev=rev: sc.affine_scan_plain(*rev, reverse=True),
                 rev, 2.0 * T_ * k * k, floor=lambda: latency_ms(
                     "info_scan", dtype, k, T_)),
        ]
    return cases


def wide_kernel_phase(seed: int, tau_fit: int) -> dict:
    """K3-wide, K5a-wide and K5b-wide at the headline panel simulated at
    k = 25 (K5 at the fit's tau and at 192), f64 then f32 (the TOL rule),
    timed warm and cold beside the plain twin, with the bound and K4's
    latency floor at k = 25 (K5a: tau forward and 2 tau + 1 backward
    steps; K3 and K5b: T forward steps, a yardstick, not their own
    chain).  Returns the f32 records of the summary line."""
    pan = panel(seed + WIDE_SEED, K_=WIDE_K)
    taus = [("tau_fit", tau_fit), (f"tau={TAU_MAX}", TAU_MAX)]
    want = {"mstep_rows_wide": "masked", "ss_cov_path_wide": "tau_fit",
            "affine_scan_wide": "forward tau_fit"}
    summary, refs = {}, {}
    for dtype in (torch.float64, torch.float32):
        with highest_precision():
            for c in wide_k_cases(*pan, dtype, taus):
                rec = kernel_record(c, dtype, refs)
                rec["k"] = WIDE_K
                if c["name"] != "mstep_rows_wide":
                    rec["tau"] = dict(taus)[c["variant"].split()[-1]]
                emit(rec)
                if (dtype == torch.float32
                        and c["variant"] == want[c["name"]]):
                    summary[c["name"]] = rec
        torch.cuda.empty_cache()
    return summary


def wide_k_sweep(seed: int) -> None:
    """K3, K5a and K5b through their wrappers (today's kernel for k <= 16,
    the wide one past it) at k in WIDE_SWEEP on 120 x 400 panels with a
    fully missing step and a step observing fewer than k series, tau =
    24, f64 and f32 (error checks only); at k = 33 all three route to
    their generic kernels (the kbig and sgen groups hold those, and the
    raise, at 129)."""
    for k in WIDE_SWEEP:
        _, W, Yfull, p = panel(seed + 1310 + k, T_=120, N_=400, K_=k)
        W[7] = 0.0
        W[11] = 0.0
        W[11, :k - 1] = 1.0
        Ynan = np.where(W > 0, Yfull, np.nan)
        refs, worst = {}, {}
        for dtype in (torch.float64, torch.float32):
            with highest_precision():
                for c in wide_k_cases(Ynan, W, Yfull, p, dtype,
                                    [("tau=24", 24)]):
                    key = (c["name"], c["variant"])
                    _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                    refs[key] = ref
                    name = f"{c['name']} {str(dtype)[6:]}"
                    if rel >= worst.get(name, (0.0,))[0]:
                        worst[name] = (rel, c["worst_output"])
        emit({"wide_k_sweep": k,
              "max_rel_err": {n: v[0] for n, v in worst.items()},
              "worst_output": {n: v[1] for n, v in worst.items()}})
    got = {n: kernels.route(n, WIDE_SWEEP[-1] + 1)
           for n in ("mstep_rows", "ss_cov_path", "affine_scan")}
    emit({"wide_k33": got})
    if any(got[n] != kernels.GEN[n] for n in got):
        raise AssertionError(f"k = 33 routes {got}, expected the generic "
                             "kernels")


def wide_fit_phase(seed: int) -> dict:
    """The generic-k fits (``WIDE_FITS``) on the headline panel simulated
    at k = 25, 20 iterations, tol = 0, f32, with a 12-step forecast: the
    engine asked for, every listed kernel launched every iteration and no
    k <= 16 kernel of a ``kernels.WIDE`` entry point, one read a chunk;
    EM it/s and the wall.  Then a masked info session at k = 25 (fused fit
    of the first 480 rows, capacity 1,000, 3 queries of 2 rows, one read
    a query under the sync check).  Returns the launch counts by label."""
    Ynan, _, Yfull, _ = panel(seed + WIDE_SEED, K_=WIDE_K)
    model = dt.DynamicFactorModel(n_factors=WIDE_K, dynamics="ar1")
    counts = {}
    iters = WIDE_ITERS
    for label, masked, flt, engine, extra, every in WIDE_FITS:
        backend = dt.TorchBackend(filter=flt, **extra)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with ReadWatch() as rw:
            t0 = time.perf_counter()
            res = dt.fit(model, Ynan if masked else Yfull, backend=backend,
                         max_iters=iters, tol=0.0)
            y_fore, _ = dt.forecast(res, 12)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        chunk = backend.fused_chunk
        steady = [h["secs"] for h in res.history[chunk:]]
        n_chunks = -(-iters // chunk)
        narrow = [n for n in kernels.WIDE if launches[n]]
        short = [n for n in every if launches[n] < iters]
        rec = {"fit": label, "filter": res.filter, "k": WIDE_K,
               "tau": res.tau, "n_iters": res.n_iters,
               "loglik_first": float(res.logliks[0]),
               "loglik_last": float(res.logliks[-1]), "wall_s": wall,
               "em_iters_per_sec": (len(steady) / sum(steady)
                                    if steady and sum(steady) > 0 else None),
               "reads": len(rw.stamps) + 1, "n_chunks": n_chunks,
               "launches": {n: v for n, v in launches.items() if v}}
        emit(rec)
        RATES[label] = rec["em_iters_per_sec"]
        if (res.filter != engine or res.n_iters != iters
                or not np.isfinite(res.logliks).all()
                or not np.isfinite(res.factors).all()
                or not np.isfinite(y_fore).all()):
            raise AssertionError(f"{label}: {res.filter}, {res.n_iters} "
                                 "iterations or non-finite outputs")
        if narrow or short or len(rw.stamps) != n_chunks:
            raise AssertionError(f"{label}: k <= 16 kernels launched "
                                 f"{narrow}; fewer launches than "
                                 f"iterations {short}; chunk reads "
                                 f"{len(rw.stamps)} of {n_chunks}")
        counts[label] = launches
    backend = dt.TorchBackend()
    fused = dt.fit(model, Ynan[:SESSION_T0], backend=backend, fused=True,
                   max_iters=iters, tol=0.0)
    if fused.filter != "info" or not np.isfinite(fused.logliks).all():
        raise AssertionError(f"k = 25 fused fit failed: {fused.filter}")
    sess = dt.open_session(fused, Ynan[:SESSION_T0], backend=backend,
                           capacity=1000, max_update_rows=8, max_iters=5,
                           tol=0.0)
    drive_session(sess, "info k25", Ynan, "info", "info_scan_wide",
                  queries=KBIG_SESSION_QUERIES)
    counts["info k25 session"] = dict(kernels.LAUNCHES)
    sess.close()
    return counts


def wide_reference_phase(seed: int) -> None:
    """``fit`` at 120 x 80, k = 20, masked (auto -> info) and unmasked
    (filter="ss"), card f64 against CPU f64 within 1e-10."""
    Ynan, _, Yfull, _ = panel(seed + 1320, T_=120, N_=80, K_=20)
    reference_fit("k20 masked", Ynan, 20, "auto", 1e-10, engine="info")
    reference_fit("k20 unmasked ss", Yfull, 20, "ss", 1e-10)


def wide_contract_phase(seed: int) -> None:
    """The loglik contract (``loglik_contract``) of the dense fit (the
    masked panel's first 31 series, k = 10) and of the k = 25 masked info
    and unmasked ss fits."""
    Ynan, W, _, _ = panel(seed + 1)
    loglik_contract("dense masked", Ynan[:, :DENSE_N], W[:, :DENSE_N], K,
                    "dense")
    Ynan, W, Yfull, _ = panel(seed + WIDE_SEED, K_=WIDE_K)
    loglik_contract("k25 masked info", Ynan, W, WIDE_K, "info")
    loglik_contract("k25 unmasked ss", Yfull, None, WIDE_K, "ss")

# ------------------------------------------- the batched twins at wide k --

# The k-grid of the bwide group: B = 4 lanes padded to k_max = 32, so the
# wide twins run at the end of their range.
BWIDE_KS = (8, 16, 25, 32)
BWIDE_SWEEP = (17, 25, 32)
# fit_many's restarts (and looped lone fits) and the rolling windows at
# k = 25.
BWIDE_RESTARTS, BWIDE_WINDOWS = 4, 6
# The k = 25 fleet: four masked 480 x 10,000 tenants at k = 25 and two
# 400 x 6,000 at k = 12, one bucket at (1,000, 10,000, 25) padded in T, N
# and k (across 16); at odd drains tenants 1, 3 and 5; lanes 0 (k = 25) and
# 4 (k = 12) held to their lone sessions.  The lowrank bucket: two tenants
# at k = 25.
BWIDE_FLEET_SHAPES = ((SESSION_T0, N, WIDE_K),) * 2 + ((400, 6000, 12),)
BWIDE_DRAINS, BWIDE_ODD, BWIDE_HELD = 3, (1, 2), (0, 2)
BWIDE_LR_TENANTS, BWIDE_LR_DRAINS = 2, 2
BWIDE_FLEET_NEW = ("batched_obs_stats_wide", "batched_quad_masked_wide",
                   "batched_mstep_rows_wide")
# The k = 20 fleet reference: a k = 20 and a k = 12 tenant (one bucket
# padding the second across 16), three ragged ticks.
BWIDE_REF_SHAPES = ((100, 40, 20), (90, 30, 12))
BWIDE_REF_TICKS = ((1, 3), (2, 0), (3, 2))


def bwide_kernel_phase(seed: int) -> dict:
    """K4b-wide (both passes), K1b-wide and K6b-wide (the loadings' and
    A's rows) against their plain twins on the 8-restart ``fit_many``
    inputs of the unmasked k = 25 panel (B = 8, T = 500, N = 10,000), and
    the lone K4-wide pair alone at (T, k) = (500, 25) on the masked panel,
    f64 then f32 (the TOL rule), timed warm and cold beside the plain twin,
    the bound, K4's latency floor at k = 25 and K6b's library call.
    Returns the f32 restart records by kernel name."""
    Ynan, W, Yfull, p = panel(seed + WIDE_SEED, K_=WIDE_K)
    spec = dt.DFMBatchSpec.restarts(dt.DynamicFactorModel(n_factors=WIDE_K),
                                    Yfull, B_RESTARTS)
    Zb = np.ascontiguousarray(np.broadcast_to(
        data.standardize(Yfull)[0], (B_RESTARTS, T, N)))
    summary, refs = {}, {}
    for dtype in (torch.float64, torch.float32):
        Yt = torch.tensor(Zb, dtype=dtype, device="cuda")
        pt = tb.stack_params(spec.inits, dtype=dtype, device="cuda")
        lone = [torch.as_tensor(x, dtype=dtype, device="cuda").contiguous()
                for x in (Ynan, W)]
        with highest_precision():
            pair = [c for c in masked_cases(
                        *lone, SSMParams.from_numpy(p, dtype=dtype,
                                                    device="cuda"),
                        "lone k25 masked")[0]
                    if c["name"] in ("info_scan_wide", "rts_smoother_wide")]
            cases = batched_cases(Yt, pt, "restarts k25") + pair
            for c in cases:
                rec = kernel_record(c, dtype, refs)
                rec["k"] = WIDE_K
                rec["B"] = B_RESTARTS if c["name"].startswith("batched") else 1
                emit(rec)
                if (dtype == torch.float32 and c["variant"] in
                        ("restarts k25", "restarts k25 Lam rows")):
                    summary[c["name"]] = rec
        del Yt, pt, lone, cases, pair
        torch.cuda.empty_cache()
    return summary


def batched_wrapper_calls(k: int) -> dict:
    """Each of the seven batched wrappers called at k on card tensors of
    zeros (B = 2, T = 4, N = 8)."""

    def z(*shape):
        return torch.zeros(shape, device="cuda")

    return {
        "batched_info_scan": lambda: tb._batched_info_scan(
            z(2, 4, k), z(2, k, k), z(2, k, k), z(2, k, k), z(2, k),
            z(2, k, k)),
        "batched_rts": lambda: tb._batched_rts(
            z(2, 4, k), z(2, 4, k, k), z(2, 4, k), z(2, 4, k, k),
            z(2, k, k)),
        "batched_quad": lambda: tb._batched_quad(
            z(2, 4, 8), z(2, 8, k), z(2, 8), z(2, 4, k), z(2, 4, k),
            z(2, k, k)),
        "batched_quad_masked": lambda: tb._batched_quad_masked(
            z(2, 4, 8), z(2, 4, 8), z(2, 8, k), z(2, 8), z(2, 4, k),
            z(2, 4, k), z(2, 4, k, k)),
        "batched_solve_rows": lambda: tb._bsolve_rows(z(2, k, k),
                                                      z(2, 8, k)),
        "batched_obs_stats": lambda: tb._batched_obs_stats_masked(
            z(2, 4, 8), z(2, 4, 8), z(2, 8, k), z(2, 8)),
        "batched_mstep_rows": lambda: tb._batched_mstep_rows(
            z(2, 4, 8), z(2, 4, 8), z(2, 4, k), z(2, 4, k, k),
            z(2, 4, k, k), 1e-6),
    }


def bwide_k_sweep(seed: int) -> None:
    """The batched twins through their wrappers at k in BWIDE_SWEEP
    (``batched_k_sweep``'s 120 x 400 shapes, the Hetero bucket's scan
    with NaN and inf at its pad steps), the fleet path at k = 17 and 32
    (``fleet_k_sweep``); the wide tier ends at 32: at k = 33 all seven
    wrappers route to their generic kernels (the bgen group holds those,
    and the raise, now at 129)."""
    batched_k_sweep(seed + 1370, BWIDE_SWEEP, junk=True)
    fleet_k_sweep(seed + 1380, (17, 32))
    k = kernels.WIDE_KMAX + 1
    got = {name: kernels.route(name, k) for name in batched_wrapper_calls(k)}
    emit({"bwide_k33": got})
    if any(got[n] != kernels.GEN[n] for n in got):
        raise AssertionError(f"k = 33 routes {got}, expected the generic "
                             "kernels")


# ---------------------------------------- the lone paths past k = 32 --

# The generic kernels past 32 (K2-gen, the K4-gen pair, K1-gen, K3-gen) at
# BENCH_kscale.json's widest exact points, k = 50 and 100, on the headline
# panel simulated at each k (seed + KBIG_SEED + k).
KBIG_KS = (50, 100)
KBIG_SEED = 1500
KBIG_ITERS = 10
KBIG_SWEEP = (33, 64, 100, 127, 128)
KBIG_NEW = ("obs_stats_gen", "info_scan_gen", "rts_smoother_gen",
            "quad_local_gen", "mstep_rows_gen")
# The fits: (label, k, masked, filter asked, engine it resolves to, extra
# backend options).  k = 100 unmasked info and lowrank are kscale's pair at
# full N.
KBIG_FITS = (
    ("k50 masked auto", 50, True, "auto", "info", {}),
    ("k50 unmasked info", 50, False, "info", "info", {}),
    ("k50 masked lowrank", 50, True, "lowrank", "lowrank", {"rank": 8}),
    ("k100 unmasked info", 100, False, "info", "info", {}),
    ("k100 unmasked lowrank", 100, False, "lowrank", "lowrank", {"rank": 8}),
    ("k100 masked info", 100, True, "info", "info", {}),
)
# bench/kscale.py's own shape and budget (its defaults: N = 120, T = 200,
# 12 iterations, the DGP seed 3000 + k, rank auto = min(k, 8); one timed
# run after the warm one, not its best of 3, for the script's time).
KSCALE_N, KSCALE_T, KSCALE_ITERS, KSCALE_REPS = 120, 200, 12, 1
KBIG_MF_K, KBIG_MF_ITERS = 7, 5       # m = 35
KBIG_SESSION_QUERIES = 3
# The m = 35 mixed-frequency fits' walls by route, for the pit one's line.
MF_WALLS: dict = {}


def kbig_cases(Ynan, W, Yfull, p, dtype, lam_ridge=None) -> list:
    """K2-gen, the K4-gen pair, K1-gen (``quad_local``, and
    ``loglik_terms_local`` with U) and K3-gen on the masked panel, and
    K4-gen forward (static C_t) and K1-gen on its fully observed twin (the
    backward pass takes no mask or C_t: its masked case covers it), on
    inputs the plain pipeline makes on the card: cases named by the kernel
    each wrapper routes to at this k (K3 with ``lam_ridge`` when given).  The K4-gen
    cases time a cold L2 over 2 calls (a pass is ~0.1-0.35 s).  Call under
    ``highest_precision()``."""
    dev = torch.device("cuda")
    Yt = torch.as_tensor(Ynan, dtype=dtype, device=dev).contiguous()
    Yf = torch.as_tensor(Yfull, dtype=dtype, device=dev).contiguous()
    mt = torch.as_tensor(W, dtype=dtype, device=dev).contiguous()
    pt = SSMParams.from_numpy(p, dtype=dtype, device=dev)
    T_, N_ = Yt.shape
    k = pt.A.shape[0]
    TN, k2, k3 = T_ * N_, k * k, k ** 3
    cases, stats = masked_cases(Yt, mt, pt, lam_ridge=lam_ridge)
    xp = inf.info_scan_plain(stats, pt.A, pt.Q, pt.mu0, pt.P0)[0]
    ustats = inf.obs_stats_plain(Yf, pt.Lam, pt.R)
    uscan = inf.info_scan_plain(ustats, pt.A, pt.Q, pt.mu0, pt.P0)
    fwd, bwd, quad = (kernels.route(n, k) for n in
                      ("info_scan", "rts_smoother", "quad_local"))
    cases += [
        case(fwd, "unmasked",
             lambda: inf.info_scan(ustats, pt.A, pt.Q, pt.mu0, pt.P0),
             lambda: inf.info_scan_plain(ustats, pt.A, pt.Q, pt.mu0, pt.P0),
             (ustats.b, ustats.C, pt.A, pt.Q, pt.mu0, pt.P0),
             T_ * (12.67 * k3 + 4 * k2),
             floor=lambda: latency_ms("info_scan", dtype, k, T_)),
        case(quad, "unmasked",
             lambda: inf.quad_local(Yf, pt.Lam, pt.R, uscan[0]),
             lambda: inf.quad_local_plain(Yf, pt.Lam, pt.R, uscan[0]),
             (Yf, pt.Lam, pt.R, uscan[0]), TN * (2 * k + 5)),
        case(quad, "masked U",
             lambda: inf.loglik_terms_local(Yt, pt.Lam, pt.R, xp, mt),
             lambda: inf.loglik_terms_local_plain(Yt, pt.Lam, pt.R, xp, mt),
             (Yt, pt.Lam, pt.R, xp, mt), TN * (4 * k + 6)),
    ]
    for c in cases:
        if c["name"] in (fwd, bwd):
            c["cold_reps"] = 2
    return cases


def kbig_kernel_phase(seed: int) -> dict:
    """The generic kernels against their plain twins at (T, N, k) = (500,
    10,000, 50) and (500, 10,000, 100), f64 then f32 (the TOL rule),
    masked and not, timed warm and cold beside the plain twin, the bound,
    K2-gen's ``einsum`` (C_t) and, for the K4-gen pair, the latency floor
    at the same (T, k).  Returns the f32 masked records at k = 100 for the
    summary line."""
    summary = {}
    for k in KBIG_KS:
        pan = panel(seed + KBIG_SEED + k, K_=k)
        refs = {}
        for dtype in (torch.float64, torch.float32):
            with highest_precision():
                for c in kbig_cases(*pan, dtype):
                    rec = kernel_record(c, dtype, refs)
                    rec["k"] = k
                    emit(rec)
                    if (dtype == torch.float32 and k == KBIG_KS[-1]
                            and c["variant"] == "masked"):
                        summary[c["name"]] = rec
            torch.cuda.empty_cache()
        del pan, refs
    return summary


def kbig_raise_calls(k: int) -> dict:
    """Each lone entry point of the generic kernels called at k on card
    tensors of zeros (T = 4, N = 8)."""
    def z(*shape):
        return torch.zeros(shape, device="cuda")
    st = inf.ObsStats(z(4, k), z(4, k, k), z(4), z(4))
    kf = FilterResult(z(4, k), z(4, k, k), z(4, k), z(4, k, k), z())
    pk = SSMParams(z(8, k), z(k, k), z(k, k), z(8), z(k), z(k, k))
    return {
        "obs_stats": lambda: inf.obs_stats(z(4, 8), z(8, k), z(8), z(4, 8)),
        "info_scan": lambda: inf.info_scan(st, z(k, k), z(k, k), z(k),
                                           z(k, k)),
        "rts_smoother": lambda: rts_smoother(kf, pk),
        "quad_local": lambda: inf.quad_local(z(4, 8), z(8, k), z(8),
                                             z(4, k)),
        "loglik_terms_local": lambda: inf.loglik_terms_local(
            z(4, 8), z(8, k), z(8), z(4, k)),
        "mstep_rows": lambda: mstep_rows(z(4, 8), z(4, 8), z(4, k),
                                         z(4, k, k), z(4, k, k), None, 1e-6),
    }


def kbig_k_sweep(seed: int) -> None:
    """The generic kernels through their wrappers at k in KBIG_SWEEP on
    120 x 400 panels with a fully missing step, a step observing fewer
    than k series and a never-observed series, K3 with a loading ridge,
    f64 and f32 (error checks only); then k = 129 must raise
    NotImplementedError in every lone entry point before any launch."""
    for k in KBIG_SWEEP:
        _, W, Yfull, p = panel(seed + KBIG_SEED + 200 + k, T_=120, N_=400,
                               K_=k)
        W[7] = 0.0
        W[11] = 0.0
        W[11, :k - 1] = 1.0
        W[:, 3] = 0.0
        Ynan = np.where(W > 0, Yfull, np.nan)
        refs, worst = {}, {}
        for dtype in (torch.float64, torch.float32):
            with highest_precision():
                for c in kbig_cases(Ynan, W, Yfull, p, dtype, lam_ridge=0.5):
                    key = (c["name"], c["variant"])
                    _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                    refs[key] = ref
                    name = f"{c['name']} {str(dtype)[6:]}"
                    worst[name] = max(worst.get(name, 0.0), rel)
        emit({"kbig_k_sweep": k, "max_rel_err": worst})
    torch.cuda.synchronize()
    kernels.reset_launches()
    raised = []
    for name, fn in kbig_raise_calls(kernels.GEN_KMAX + 1).items():
        try:
            fn()
        except NotImplementedError:
            raised.append(name)
    launched = sum(kernels.LAUNCHES.values())
    emit({"kbig_k129_raised": raised, "launches": launched})
    if len(raised) != 6 or launched:
        raise AssertionError(f"k = 129: only {raised} raised, {launched} "
                             "launches")


def kbig_fit_launches(k: int, masked: bool, engine: str, ran: int,
                      rank: int = 0) -> dict:
    """A kbig fit's launches, exactly, for ``ran`` iterations: info runs
    the K4 pair and K1 every iteration and once more for the reporting
    smooth, masked also K2 (as K1) and K3 (every iteration); lowrank runs
    the K9 trio and K1 every iteration, masked K2 and K3, and the exact
    info pair (K2 masked, the K4 pair, K1) for the reporting smooth."""
    if engine == "info":
        want = {"info_scan": ran + 1, "rts_smoother": ran + 1,
                "quad_local": ran + 1}
    else:
        want = {"lowrank_basis": ran, "lowrank_scan": ran,
                "lowrank_smoother": ran, "quad_local": ran + 1,
                "info_scan": 1, "rts_smoother": 1}
    if masked:
        want.update(obs_stats=ran + 1, mstep_rows=ran)
    return routed(want, k, rank)


def kbig_fit_phase(seed: int, fits=KBIG_FITS, seed_off: int = KBIG_SEED,
                   iters: int = KBIG_ITERS) -> dict:
    """``fits`` (``KBIG_FITS``) on the headline panel simulated at each k
    (seed + ``seed_off`` + k: k = 50 and 100), ``iters`` (10) iterations,
    tol = 0, f32, with a 12-step forecast: the engine asked
    for, finite outputs, exactly ``kbig_fit_launches`` (the generic
    kernels, no k <= 32 kernel of K1-K4), one read a chunk (and the
    result's), logliks non-decreasing within the f32 noise floor (lowrank:
    a drop past it only where the f64 trajectory from ``fit``'s init
    drops too, as phase 20); EM it/s and the wall; each masked info
    fit's iteration split into its kernels.  Returns the launch counts by
    label."""
    counts, pans = {}, {}
    floor = noise_floor_for(torch.float32, T * N)
    for label, k, masked, flt, engine, extra in fits:
        if k not in pans:
            pans = {k: panel(seed + seed_off + k, K_=k)}
        Ynan, W, Yfull, _ = pans[k]
        Y = Ynan if masked else Yfull
        model = dt.DynamicFactorModel(n_factors=k, dynamics="ar1")
        backend = dt.TorchBackend(filter=flt, **extra)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with ReadWatch() as rw:
            t0 = time.perf_counter()
            res = dt.fit(model, Y, backend=backend, max_iters=iters,
                         tol=0.0)
            y_fore, f_fore = dt.forecast(res, 12)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        lls = res.logliks
        n = len(lls)
        chunk = backend.fused_chunk
        n_chunks = -(-n // chunk)
        ran = min(iters, n_chunks * chunk)     # whole chunks run
        drops = [i for i in range(1, n) if lls[i] < lls[i - 1] - floor]
        unexplained, f64_drops = drops, None
        if engine == "lowrank" and drops:
            ll64 = lowrank_f64_lls(Y, W if masked else None, n, k,
                                   extra["rank"])
            f64_drops = [i for i in range(1, n) if ll64[i] < ll64[i - 1]]
            unexplained = [i for i in drops if i not in f64_drops]
        want = kbig_fit_launches(k, masked, engine, ran,
                                 extra.get("rank", 0))
        bad = {nm: v for nm, v in launches.items() if v != want.get(nm, 0)}
        steady = [h["secs"] for h in res.history[chunk:]]
        rec = {"fit": label, "filter": res.filter, "k": k, **extra,
               "n_iters": n, "iterations_run": ran,
               "loglik_first": float(lls[0]), "loglik_last": float(lls[-1]),
               "max_drop": float(max(0.0, -np.diff(lls).min())),
               "noise_floor": floor, "drops_past_floor": drops,
               "f64_drops": f64_drops, "wall_s": wall,
               "em_iters_per_sec": (len(steady) / sum(steady)
                                    if steady and sum(steady) > 0 else None),
               "reads": len(rw.stamps) + 1, "n_chunks": n_chunks,
               "launches": {nm: v for nm, v in launches.items() if v}}
        emit(rec)
        RATES[label] = rec["em_iters_per_sec"]
        stopped = n != iters and not (engine == "lowrank" and drops
                                           and drops[-1] == n - 1)
        if (res.filter != engine or stopped or not np.isfinite(lls).all()
                or unexplained):
            raise AssertionError(f"{label}: {res.filter}, {n} iterations, "
                                 f"drops past the noise floor {drops} "
                                 f"(unexplained {unexplained})")
        for name, arr in (("factors", res.factors), ("y_fore", y_fore),
                          ("f_fore", f_fore)):
            if not np.isfinite(arr).all():
                raise AssertionError(f"{label}: non-finite {name}")
        if bad or len(rw.stamps) != n_chunks:
            raise AssertionError(f"{label}: launches off {want}: {bad}; "
                                 f"chunk reads {len(rw.stamps)} of "
                                 f"{n_chunks}")
        counts[label] = launches
        if engine == "info" and masked:
            kbig_iteration_breakdown(label, Y, res, masked)
    return counts


def kbig_iteration_breakdown(label: str, Y, res, masked: bool) -> None:
    """Where an info EM iteration at k > 32 goes (f32, warm L2, at the
    fitted params on the standardized panel): each generic kernel (CUDA
    events) against the whole ``em_step``; the rest is the iteration less
    the kernels (the moments, the k x k M-step, launch gaps)."""
    W = data.build_mask(Y)
    Z, _ = data.standardize(Y, mask=W)
    f32 = torch.float32
    with highest_precision():
        Zt = torch.as_tensor(np.where(W > 0, np.nan_to_num(Z), 0.0),
                             dtype=f32, device="cuda").contiguous()
        Wt = (torch.as_tensor(W, dtype=f32, device="cuda").contiguous()
              if masked else None)
        pt = SSMParams.from_numpy(res.params, dtype=f32, device="cuda")
        stats = inf.obs_stats(Zt, pt.Lam, pt.R, Wt)
        scan = inf.info_scan(stats, pt.A, pt.Q, pt.mu0, pt.P0)
        kf = FilterResult(*scan[:4], torch.zeros((), dtype=f32))
        sm = rts_smoother(kf, pt)
        EffT, _ = moments(sm)
        k = pt.A.shape[0]
        ms = {kernels.route("info_scan", k): cuda_ms(
                  lambda: inf.info_scan(stats, pt.A, pt.Q, pt.mu0, pt.P0)),
              kernels.route("rts_smoother", k): cuda_ms(
                  lambda: rts_smoother(kf, pt)),
              kernels.route("quad_local", k): cuda_ms(
                  lambda: inf.quad_local(Zt, pt.Lam, pt.R, scan[0], Wt))}
        if masked:
            ms[kernels.route("obs_stats", k)] = cuda_ms(
                lambda: inf.obs_stats(Zt, pt.Lam, pt.R, Wt))
            ms[kernels.route("mstep_rows", k)] = cuda_ms(
                lambda: mstep_rows(Zt, Wt, sm.x_sm, EffT, sm.P_sm, None,
                                   1e-6))
        iter_ms = cuda_ms(lambda: tem.em_step(Zt, pt, Wt,
                                              EMConfig(filter="info")))
    emit({"kbig_iteration_breakdown": label, "shape": [*Y.shape, k],
          "iter_ms": iter_ms, "kernel_ms": ms,
          "rest_ms": iter_ms - sum(ms.values())})


def kscale_phase(seed: int) -> None:
    """``bench/kscale.py``'s own shape on the card: N = 120, T = 200, k =
    50 and 100, 12 iterations, the panel standardized and its PCA init
    (``cpu_ref.pca_init``) given to every fit (``standardize=False``): the
    warm chunked-fit wall (one run after the warm one, the fit's own
    reads the barrier) of
    the exact ``info`` fit over the ``lowrank`` fit (rank auto = min(k, 8))
    -- kscale's ``kscale_speedup_k50`` / ``_k100`` -- and each f32 fit's
    final-loglik error against the f64 ``info`` fit.  Printed, not
    gated."""
    for k in KBIG_KS:
        rng = np.random.default_rng(3000 + k)
        p_true = dgp.dfm_params(KSCALE_N, k, rng)
        Y_raw, _ = dgp.simulate(p_true, KSCALE_T, rng)
        Y = (Y_raw - Y_raw.mean(0)) / Y_raw.std(0)
        p0 = cpu_ref.pca_init(Y, k)
        model = dt.DynamicFactorModel(n_factors=k, standardize=False)
        kw = dict(max_iters=KSCALE_ITERS, tol=0.0, init=p0)
        ref = dt.fit(model, Y, backend=dt.TorchBackend(
            dtype=torch.float64, filter="info"), **kw)
        ll_ref = float(ref.logliks[-1])
        walls, errs, launched = {}, {}, {}
        for name in ("info", "lowrank"):
            b = dt.TorchBackend(filter=name)
            kernels.reset_launches()
            r = dt.fit(model, Y, backend=b, **kw)
            launched[name] = {nm: v for nm, v in kernels.LAUNCHES.items()
                              if v}
            errs[name] = abs(float(r.logliks[-1]) - ll_ref) / abs(ll_ref)
            best = float("inf")
            for _ in range(KSCALE_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dt.fit(model, Y, backend=b, **kw)
                best = min(best, time.perf_counter() - t0)
            walls[name] = best
        emit({"kscale": k, "shape_N_T": [KSCALE_N, KSCALE_T],
              "em_iters": KSCALE_ITERS, "rank": min(k, 8),
              "wall_s": walls,
              f"kscale_speedup_k{k}": walls["info"] / walls["lowrank"],
              f"kscale_exact_iters_per_sec_k{k}":
                  KSCALE_ITERS / walls["info"],
              "f32_final_loglik_rel_err_vs_f64_info": errs,
              "launches": launched})


def narrow_launched(launches: dict) -> list:
    """The kernels of a k <= 32 tier (an entry point of ``kernels.WIDE``
    or ``kernels.GEN`` itself, or a wide kernel) launched in
    ``launches``."""
    return [nm for nm, v in launches.items() if v and (
        nm in kernels.WIDE or nm in kernels.WIDE.values()
        or nm in kernels.GEN)]


def kbig_session_phase(seed: int) -> dict:
    """``fit(fused=True)`` on the masked k = 50 panel's first 480 rows (10
    iterations, tol = 0, f32), then an info session on it at capacity
    1,000 with 3 queries of 2 rows and a re-forecast: one read a query
    under the sync check, K13 and K4-gen forward every query.  Returns
    the launch counts by label."""
    k = KBIG_KS[0]
    Ynan = panel(seed + KBIG_SEED + k, K_=k)[0]
    model = dt.DynamicFactorModel(n_factors=k, dynamics="ar1")
    backend = dt.TorchBackend()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    fused = dt.fit(model, Ynan[:SESSION_T0], backend=backend, fused=True,
                   max_iters=KBIG_ITERS, tol=0.0)
    wall = time.perf_counter() - t0
    launches = {nm: v for nm, v in kernels.LAUNCHES.items() if v}
    emit({"fused_fit": f"k{k} info", "filter": fused.filter,
          "n_iters": fused.n_iters, "host_reads": fused.host_reads,
          "wall_s": wall, "loglik_last": float(fused.logliks[-1]),
          "launches": launches})
    narrow = narrow_launched(launches)
    if (fused.filter != "info" or not np.isfinite(fused.logliks).all()
            or narrow or launches.get("info_scan_gen", 0) < KBIG_ITERS):
        raise AssertionError(f"k = {k} fused fit failed: {fused.filter}, "
                             f"launches {launches}")
    sess = dt.open_session(fused, Ynan[:SESSION_T0], backend=backend,
                           capacity=1000, max_update_rows=8, max_iters=5,
                           tol=0.0)
    drive_session(sess, f"info k{k}", Ynan, "info", "info_scan_gen",
                  queries=KBIG_SESSION_QUERIES)
    counts = {f"info k{k} session": dict(kernels.LAUNCHES)}
    sess.close()
    return counts


def kbig_mf_phase(seed: int, ts: str = "seq") -> dict:
    """A mixed-frequency route past 32: ``fit(MixedFreqSpec(1600, 400, 7,
    time_scan=ts), Y, mask=W)`` on an S3-shaped panel at k = 7 (m = 35),
    f32, chunks of 8, 5 iterations, tol = 0, and a 12-step forecast:
    finite outputs, one read a chunk plus the result's, exactly the
    route's launches an E-step (``MF_ROUTES`` at m = 35: ``seq`` one
    K2-gen, K4-gen forward, K1-gen and K4-gen backward; ``pit`` one
    K2-gen, four K14-el-gen, two K14-scan-gen and one K1-gen; the
    augmented scans in f64) for each iteration and the reporting smooth,
    and no other kernel; the wall beside the ``seq`` fit's when ``ts`` is
    another route.  Then ``fit(MixedFreqSpec(24, 8, 7, time_scan=ts))`` at
    60 steps (a fully missing step, a never-observed monthly series), card
    f64 against CPU f64 within 1e-9.  Returns the fit's launch counts."""
    k, m = KBIG_MF_K, 5 * KBIG_MF_K
    Y, W = mf_panel(seed + 1501, k=k)
    backend = dt.TorchBackend(fused_chunk=MF_CHUNK)
    spec = mf_spec(ts, k=k)
    per = routed({nm.removesuffix("_wide"): c
                  for nm, c in MF_ROUTES[ts].items()}, m)
    need = list(per)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with ReadWatch() as rw:
        t0 = time.perf_counter()
        res = dt.fit(spec, Y, mask=W, backend=backend,
                     max_iters=KBIG_MF_ITERS, tol=0.0)
        y_fore, f_fore = dt.forecast(res, 12)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    lls = res.logliks
    n_chunks = -(-len(lls) // MF_CHUNK)
    ran = min(KBIG_MF_ITERS, n_chunks * MF_CHUNK)
    want = {nm: c * (ran + 1) for nm, c in per.items()}
    bad = {nm: v for nm, v in launches.items() if v != want.get(nm, 0)}
    MF_WALLS[ts] = wall
    emit({"fit": f"mf {ts} m{m}", "spec": dataclasses.asdict(spec),
          "shape": [MF_T, MF_NM + MF_NQ, k], "m": m, "n_iters": len(lls),
          "loglik_first": float(lls[0]), "loglik_last": float(lls[-1]),
          "max_drop": float(max(0.0, -np.diff(lls).min())),
          "noise_floor": noise_floor_for(torch.float32,
                                         MF_T * (MF_NM + MF_NQ)),
          "wall_s": wall, "seq_wall_s": MF_WALLS.get("seq"),
          "reads": len(rw.stamps),
          "launches": {nm: v for nm, v in launches.items() if v}})
    if bad or len(rw.stamps) != n_chunks + 1:
        raise AssertionError(f"mf {ts} m = {m}: launches off {want}: {bad}; "
                             f"reads {len(rw.stamps)} of {n_chunks + 1}")
    for name, arr in (("logliks", lls), ("nowcast", res.nowcast),
                      ("factors", res.factors), ("state_T", res.state_T),
                      ("y_fore", y_fore), ("f_fore", f_fore)):
        if not np.isfinite(arr).all():
            raise AssertionError(f"mf {ts} m = {m}: non-finite {name}")
    if res.state_T.shape != (m,) or y_fore.shape != (12, MF_NM + MF_NQ):
        raise AssertionError(f"mf {ts} m = {m}: unexpected output shapes")
    Ys, Ws = mf_panel(seed + 1502, nm=24, nq=8, T_=60, k=k)
    Ws[17] = 0.0
    Ws[:, 2] = 0.0
    Ys = np.where(Ws > 0, Ys, np.nan)
    spec = mf_spec(ts, nm=24, nq=8, k=k)
    out = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launches()
        r = dt.fit(spec, Ys, mask=Ws, max_iters=6, tol=0.0,
                   backend=dt.TorchBackend(device=dev, dtype=torch.float64,
                                           fused_chunk=3))
        out[dev] = (r, dt.forecast(r, 12)[0], dict(kernels.LAUNCHES))
    (rg, yg, lg), (rc, yc, _) = out["cuda"], out["cpu"]
    pairs = [("logliks", rg.logliks, rc.logliks),
             ("nowcast", rg.nowcast, rc.nowcast),
             ("factors", rg.factors, rc.factors),
             ("state_T", rg.state_T, rc.state_T), ("y_fore", yg, yc)]
    pairs += [(f, getattr(rg.params, f), getattr(rc.params, f))
              for f in mf.MFParams._fields if f != "mu0"]   # mu0 = 0
    errs = {name: rel_err(g, c) for name, g, c in pairs}
    emit({"reference": f"mf {ts} m{m}", "shape": [60, 32, k], "iters": 6,
          "max_rel_err": errs, "tol": 1e-9})
    if any(lg[nm] == 0 for nm in need) or any(e > 1e-9 for e in
                                              errs.values()):
        raise AssertionError(f"mf {ts} m = {m} card fit disagrees with the "
                             f"CPU fit or skipped its kernels: {errs}, {lg}")
    return {f"mf {ts} m{m}": launches}


def kbig_reference_phase(seed: int) -> None:
    """``fit`` at 100 x 60, k = 40, masked (scattered missing values, a
    ragged edge, one series observed at its first step alone: ``fit``
    refuses an all-missing column), ``filter="info"`` and ``"lowrank"``
    (rank 4), card f64 against CPU f64 within 1e-12."""
    k = 40
    _, W, Yfull, _ = panel(seed + KBIG_SEED + k, T_=100, N_=60, K_=k)
    W[:, 5] = 0.0
    W[0, 5] = 1.0
    Ynan = np.where(W > 0, Yfull, np.nan)
    own = ("obs_stats", "info_scan", "rts_smoother", "quad_local",
           "mstep_rows")
    reference_fit("k40 masked info", Ynan, k, "info", 1e-12, own=own)
    reference_fit("k40 masked lowrank", Ynan, k, "lowrank", 1e-12,
                  extra={"rank": 4},
                  own=("lowrank_scan", "obs_stats", "quad_local",
                       "mstep_rows"))


def kbig_contract_phase(seed: int) -> None:
    """The loglik contract (``loglik_contract``) of the masked info fits
    at k = 50 and 100 on the headline panel simulated at each k."""
    for k in KBIG_KS:
        Ynan, W, _, _ = panel(seed + KBIG_SEED + k, K_=k)
        loglik_contract(f"k{k} masked info", Ynan, W, k, "info")


# ------------------------------------- the batched twins past k = 32 --

# The generic batched twins (K4b-gen pair, K1b-gen, K6b-gen, K2b-m-gen,
# K1b-m-gen, K3b-m-gen) at k = 50, the JAX fleet's wide-k scenario, on the
# headline panel simulated at k = 50 (seed + BGEN_SEED).
BGEN_K = 50
BGEN_SEED = 1600
BGEN_B, BGEN_ITERS, BGEN_LONE = 4, 10, 2     # fit_many restarts
BGEN_TICK = (2, 1000)        # (B, T_cap) of the kernels' tick shape
BGEN_K100 = (2, T)           # (B, T_cap) of the k = 100 case
BGEN_SWEEP = (33, 64, 100, 128)
BGEN_SWEEP_SHAPE = (80, 120)  # (T, N) of the sweep's panels
BGEN_KGRID = (10, 33, 50)
BGEN_WINDOWS = 6
# The full-width info fleet: two masked 480 x 10,000 tenants at k = 50 and
# one 400 x 6,000 at k = 40 in one bucket at (1,000, 10,000, 50), padded
# in T, N and k past 32; 2 drains (the second: tenants 0 and 2), tenant 0
# held to its lone session.
BGEN_FLEET_SHAPES = ((SESSION_T0, N, BGEN_K),) * 2 + ((400, 6000, 40),)
BGEN_DRAINS, BGEN_ODD, BGEN_HELD = 2, (0, 2), (0,)
# The k = 40 reference fleet: a 100 x 60 tenant at k = 40 and a 90 x 50
# tenant at k = 34, three ragged ticks, info and lowrank (rank 4).
BGEN_REF_K = 40
BGEN_REF_SHAPES = ((100, 60, 40), (90, 50, 34))
BGEN_NEW = tuple(kernels.GEN[n] for n in (
    "batched_info_scan", "batched_rts", "batched_quad",
    "batched_solve_rows", "batched_obs_stats", "batched_quad_masked",
    "batched_mstep_rows"))
# bench/fleet.py's wide-k leg at its own definition (lines 186-239): the
# mix "120,200,50x2" (N, T, k), DGP seeds 4000 + i, lowrank fits of
# max(4, 30 // 6) iterations at rank 8, capacities T + n_w + r_max, one
# warm tick, then 3 rounds of 2 rows at 5 iterations, tol = 0.
WIDEK_MIX = ((120, 200, BGEN_K),) * 2
WIDEK_RANK, WIDEK_ROUNDS, WIDEK_ROWS, WIDEK_ITERS = 8, 3, 2, 5
WIDEK_FIT_ITERS = max(4, 30 // 6)


def tick_buffers(seed: int, B_: int, T_cap: int, k: int) -> tuple:
    """A fleet bucket's state (NumPy): lane i holds the first 480 - 20 i
    rows of the masked headline panel simulated at k from seed + i (NaN
    zeroed, the mask zero past them and at missing cells) in a T_cap
    buffer, with that panel's true params.  Returns (Yb, Wb, per-lane
    params, t_new)."""
    Yb = np.zeros((B_, T_cap, N))
    Wb = np.zeros((B_, T_cap, N))
    ps, t_new = [], []
    for i in range(B_):
        t = SESSION_T0 - 20 * i
        Ynan, W, _, p = panel(seed + i, T_=t, K_=k)
        Yb[i, :t] = np.nan_to_num(Ynan)
        Wb[i, :t] = W
        ps.append(p)
        t_new.append(t)
    return Yb, Wb, ps, t_new


def bgen_kernel_phase(seed: int) -> dict:
    """The generic batched twins against their plain twins, f64 then f32
    (the TOL rule), timed warm and cold beside the plain twin, the bound,
    K4's latency floor at the same (T, k) for the K4b-gen pair and, for
    K6b-gen, ``cholesky`` + ``cholesky_solve``: at the fit_many shape (B,
    T, N, k) = (4, 500, 10,000, 50) the K4b-gen pair, K1b-gen and K6b-gen
    (loadings and A) on the 4 restarts' inputs of the unmasked panel, and
    K4b-gen forward again with a ragged t_mask (t_act 500/400/300/250, NaN
    and inf in b at the pad steps); at the tick shape (2, 1,000, 10,000,
    50) every kernel of an info tick (K2b-m-gen, K4b-gen over a per-step
    C, K1b-m-gen, K4b-gen backward, K3b-m-gen, K6b-gen on A's rows) on
    ``tick_buffers``; at k = 100 (B = 2, T = 500) the K4b-gen pair and
    K3b-m-gen.  The K4b-gen pair and K3b-m-gen (over 50 ms a call) take
    one cold-L2 call, the rest three.  Returns the f32 summary records by
    kernel name."""
    _, _, Yfull, _ = panel(seed + BGEN_SEED, K_=BGEN_K)
    spec = dt.DFMBatchSpec.restarts(dt.DynamicFactorModel(n_factors=BGEN_K),
                                    Yfull, BGEN_B)
    Zb = np.ascontiguousarray(np.broadcast_to(
        data.standardize(Yfull)[0], (BGEN_B, T, N)))
    t_act = [int(T * f) for f in (1.0, 0.8, 0.6, 0.5)]
    scan_gen = kernels.GEN["batched_info_scan"]
    slow = (scan_gen, kernels.GEN["batched_rts"],
            kernels.GEN["batched_mstep_rows"])
    ticks = [((BGEN_TICK, BGEN_K, "tick k50",
               (kernels.GEN["batched_obs_stats"], scan_gen,
                kernels.GEN["batched_quad_masked"],
                kernels.GEN["batched_mstep_rows"])),
              tick_buffers(seed + BGEN_SEED + 10 + BGEN_K, *BGEN_TICK,
                           BGEN_K)),
             ((BGEN_K100, 100, "tick k100", slow),
              tick_buffers(seed + BGEN_SEED + 110, *BGEN_K100, 100))]
    summary, refs = {}, {}
    for dtype in (torch.float64, torch.float32):
        cases = []
        Yt = torch.tensor(Zb, dtype=dtype, device="cuda")
        pt = tb.stack_params(spec.inits, dtype=dtype, device="cuda")
        het = tb.make_hetero(t_act, [N] * BGEN_B, T, N, dtype=dtype, tol=0.0,
                             iter_cap=BGEN_ITERS, device="cuda")
        with highest_precision():
            cases += [(c, BGEN_B, T, BGEN_K)
                      for c in batched_cases(Yt, pt, "restarts k50")]
            cases += [(c, BGEN_B, T, BGEN_K)
                      for c in batched_cases(Yt, pt, "restarts k50 ragged",
                                             het, junk=True)
                      if c["name"] == scan_gen]
            for ((B_, T_cap), k, label, keep), (Yn, Wn, ps, tn) in ticks:
                Yb, Wb = (torch.tensor(x, dtype=dtype, device="cuda")
                          for x in (Yn, Wn))
                pb = tb.stack_params(ps, dtype=dtype, device="cuda")
                t_new = torch.tensor(tn, dtype=torch.int32, device="cuda")
                cases += [(c, B_, T_cap, k)
                          for c in fleet_cases(Yb, Wb, pb, t_new, label)
                          if c["name"] in keep]
            for c, B_, T_, k in cases:
                if c["name"] in slow:
                    c["cold_reps"] = 1
                rec = kernel_record(c, dtype, refs)
                rec.update(B=B_, T=T_, k=k)
                emit(rec)
                if dtype == torch.float32 and c["variant"] in (
                        "restarts k50", "restarts k50 Lam rows",
                        "tick k50") and c["name"] not in summary:
                    summary[c["name"]] = rec
        del Yt, pt, het, cases
        torch.cuda.empty_cache()
    return summary


def bgen_sweep_inputs(seed: int, k: int) -> list:
    """(label, stacked panel or buffers, per-lane NumPy params, Hetero
    (t_act, n_act) or the masked bucket's (mask, t_new)) of the k-sweep
    on a BGEN_SWEEP_SHAPE panel simulated at k: three restarts (the true
    params, the loadings scaled 0.9, R scaled 1.2), a Hetero bucket (lane
    1 ragged in T, lane 2 in N) and a masked bucket (live lengths 80, 64,
    50; lane 0's step 7 fully masked; series 3 never observed)."""
    T_, N_ = BGEN_SWEEP_SHAPE
    Ynan, W, Yfull, p = panel(seed, T_=T_, N_=N_, K_=k)
    Z = data.standardize(Yfull)[0]
    ps = [p, dataclasses.replace(p, Lam=0.9 * p.Lam),
          dataclasses.replace(p, R=1.2 * p.R)]
    t_act, n_act = (T_, 60, T_), (N_, N_, 100)
    Yh, ph = hetero_lanes(Z, p, t_act, n_act)
    t_new = (T_, 64, 50)
    Wb = np.zeros((3, T_, N_))
    for i, t in enumerate(t_new):
        Wb[i, :t] = W[:t]
    Wb[0, 7] = 0.0
    Wb[:, :, 3] = 0.0
    Yb = np.where(Wb > 0, np.nan_to_num(Ynan)[None], 0.0)
    return [("restarts", np.broadcast_to(Z, (3, T_, N_)), ps, None),
            ("hetero", Yh, ph, (t_act, n_act)),
            ("masked", Yb, ps, (Wb, t_new))]


def bgen_k_sweep(seed: int) -> None:
    """The generic batched twins through their wrappers at k in BGEN_SWEEP
    on ``bgen_sweep_inputs`` (the Hetero bucket's scan with NaN and inf at
    its pad steps; the masked bucket through every kernel of an info
    tick), f64 and f32 (error checks only); then k = 129 must raise
    NotImplementedError in all seven wrappers before any launch."""
    T_, N_ = BGEN_SWEEP_SHAPE
    for k in BGEN_SWEEP:
        refs, worst = {}, {}
        inputs = bgen_sweep_inputs(seed + BGEN_SEED + 200 + k, k)
        for dtype in (torch.float64, torch.float32):
            for label, Yn, ps, extra in inputs:
                Yt = torch.tensor(np.ascontiguousarray(Yn), dtype=dtype,
                                  device="cuda")
                pt = tb.stack_params(ps, dtype=dtype, device="cuda")
                with highest_precision():
                    if label == "masked":
                        Wt = torch.tensor(extra[0], dtype=dtype,
                                          device="cuda")
                        tn = torch.tensor(extra[1], dtype=torch.int32,
                                          device="cuda")
                        cases = fleet_cases(Yt, Wt, pt, tn, label)
                    else:
                        het = None if extra is None else tb.make_hetero(
                            *extra, T_, N_, dtype=dtype, tol=0.0,
                            iter_cap=5, device="cuda")
                        cases = batched_cases(Yt, pt, label, het, junk=True)
                    for c in cases:
                        key = (c["name"], c["variant"])
                        _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                        refs[key] = ref
                        name = f"{c['name']} {str(dtype)[6:]}"
                        worst[name] = max(worst.get(name, 0.0), rel)
        missing = [n for n in BGEN_NEW
                   if not any(w.startswith(n + " ") for w in worst)]
        emit({"bgen_k_sweep": k, "shape": BGEN_SWEEP_SHAPE,
              "max_rel_err": worst})
        if missing:
            raise AssertionError(f"bgen k = {k}: {missing} not compared")
    torch.cuda.synchronize()
    kernels.reset_launches()
    raised = []
    calls = batched_wrapper_calls(kernels.GEN_KMAX + 1)
    for name, fn in calls.items():
        try:
            fn()
        except NotImplementedError:
            raised.append(name)
    launched = sum(kernels.LAUNCHES.values())
    emit({"bgen_k129_raised": raised, "launches": launched})
    if len(raised) != len(calls) or launched:
        raise AssertionError(f"k = 129: only {raised} raised, {launched} "
                             "launches")


def widek_leg_phase(seed: int) -> None:
    """bench/fleet.py's wide-k leg at its own definition (WIDEK_*): the
    same tenants, schedule and container through an info fleet and a
    lowrank (rank 8) fleet, one warm tick, then the timed rounds: each
    engine's wall, their ratio, and the launches of the timed rounds.
    Printed, not gated (beyond finite outputs)."""
    r_max, rounds = WIDEK_ROWS, WIDEK_ROUNDS
    n_w = (rounds + 1) * r_max
    blr = dt.TorchBackend(filter="lowrank", rank=WIDEK_RANK)
    ress, Ys, streams = [], [], []
    for i, (N_, T_, k) in enumerate(WIDEK_MIX):
        rng = np.random.default_rng(4000 + i)
        p_true = dgp.dfm_params(N_, k, rng)
        Y_all, _ = dgp.simulate(p_true, T_ + n_w, rng)
        ress.append(dt.fit(dt.DynamicFactorModel(n_factors=k), Y_all[:T_],
                           max_iters=WIDEK_FIT_ITERS, backend=blr))
        Ys.append(Y_all[:T_])
        streams.append(Y_all[T_:])
    caps = [y.shape[0] + n_w + r_max for y in Ys]
    N_of = {f"t{i}": y.shape[1] for i, y in enumerate(Ys)}
    rec = {"widek_leg": "120,200,50x2", "rank": WIDEK_RANK,
           "rounds": rounds, "rows": r_max, "iters": WIDEK_ITERS,
           "capacity": caps}
    for eng, rk in (("info", 0), ("lowrank", WIDEK_RANK)):
        fl = dt.open_fleet(ress, Ys, capacity=caps, max_update_rows=r_max,
                           max_iters=WIDEK_ITERS, tol=0.0, backend=blr,
                           max_classes=1, filter=eng, rank=rk)
        cur = [0] * len(Ys)
        for i, t in enumerate(fl.tenants):            # the warm tick
            fl.submit(t, streams[i][:r_max])
            cur[i] = r_max
        fl.drain()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        for _ in range(rounds):
            for i, t in enumerate(fl.tenants):
                fl.submit(t, streams[i][cur[i]:cur[i] + r_max])
                cur[i] += r_max
            check_fleet_out(f"wide-k {eng}", fl.drain(), N_of)
        torch.cuda.synchronize()
        rec[f"{eng}_wall_s"] = time.perf_counter() - t0
        rec[f"{eng}_launches"] = {n: c for n, c in kernels.LAUNCHES.items()
                                  if c}
        rec[f"{eng}_dims"] = fl._buckets[0].dims
        fl.close()
    rec["lowrank_over_info_speedup"] = (rec["info_wall_s"]
                                        / rec["lowrank_wall_s"])
    emit(rec)


def bgen_fleet_phase(seed: int) -> dict:
    """The wide-k leg, then the full-width info fleet (BGEN_FLEET_SHAPES:
    ``fleet_phase`` with the sync check, one read and exact launches a
    tick, lane 0 held to its lone k = 50 session, the k = 40 tenant's
    padded factors exactly 0; the kernel phase holds every kernel of the
    tick against its twin at the tick shape, so the bucket's buffers are
    not compared again).  Returns the fleet's launch counts under "fleet
    k50"."""
    widek_leg_phase(seed)
    tenants = fleet_tenants(seed + BGEN_SEED + 40, BGEN_FLEET_SHAPES,
                            BGEN_DRAINS * FLEET_ROWS)
    counts, _ = fleet_phase(seed + BGEN_SEED + 50, tenants, BGEN_K,
                            BGEN_DRAINS, BGEN_ODD, BGEN_HELD, "info k50",
                            lone_all=False, kernel_check=False,
                            inert=((2, BGEN_FLEET_SHAPES[2][2]),))
    return {"fleet k50": counts}


def bgen_reference_phase(seed: int) -> None:
    """Card f64 against CPU f64 within 1e-12 at k = 40: ``fit_many`` of 3
    panels and a Hetero ``run_batched_em`` (120 x 80, 5 iterations), and
    fleets of BGEN_REF_SHAPES over 2 ticks, info and lowrank (rank 4): the
    CPU's f64 twins take most of the phase."""
    batched_reference_phase(seed + BGEN_SEED + 60, k=BGEN_REF_K, tol=1e-12,
                            iters=5)
    for flt, rank in (("info", 0), ("lowrank", 4)):
        fleet_reference_phase(seed + BGEN_SEED + 70, BGEN_REF_SHAPES,
                              BWIDE_REF_TICKS[:2], capacity=120, flt=flt,
                              rank=rank)


# ---------------------------------- the ss and pit engines past k = 32 --

# K5a-gen, K5b-gen, K14-el-gen and K14-scan-gen on kbig's panels: the
# headline panel simulated at k = 50 and 100 (seed + KBIG_SEED + k).
SGEN_SWEEP = (33, 50, 100, 128)
SGEN_SWEEP_SHAPE = (97, 300)      # (T, N): S = 9, B = 10, a tail of 7
SGEN_SWEEP_TAUS = (8, 24)
# The fits: (label, k, masked, filter asked, engine it resolves to); the
# kbig fit each sits beside (info at the same k, masked or not alike).
SGEN_FITS = (
    ("k50 unmasked auto", 50, False, "auto", "ss"),
    ("k100 unmasked auto", 100, False, "auto", "ss"),
    ("k50 masked pit", 50, True, "pit", "pit"),
    ("k100 masked pit", 100, True, "pit", "pit"),
)
SGEN_BESIDE = {"k50 unmasked auto": "k50 unmasked info",
               "k100 unmasked auto": "k100 unmasked info",
               "k50 masked pit": "k50 masked auto",
               "k100 masked pit": "k100 masked info"}
# The f32 records of the summary line, at k = 100: K5a at the fit's tau,
# K5b forward, the filter element build and the prefix.
SGEN_SUMMARY = ("tau_fit", "forward tau_fit", "filter elements masked",
                "prefix masked")
SGEN_REF_K = 40


def sgen_cases(stats, ustats, pt, taus, label: str,
               static=None) -> list:
    """``ss_cases`` on the unmasked statistics ``ustats`` (K5a's delta with
    its rounding floor) and every K14 mode (``pit_cases``) on ``stats``
    (variants ``label``) and, when given, on ``static`` (one
    time-invariant C, variants "static"), named by the kernel each wrapper
    routes to at this k.  Call under ``highest_precision()``."""
    k = ustats.b.shape[1]
    cases = ss_cases(ustats, pt, taus, delta_floor=True)
    pit = pit_cases(stats, pt, label)
    if static is not None:
        pit += pit_cases(static, pt, "static")
    for c in pit:
        c["name"] = kernels.route(c["name"], k)
    return cases + pit


def sgen_stats(Ynan, W, Yfull, p, dtype) -> tuple:
    """(masked statistics, unmasked statistics, params) of a panel on the
    card in ``dtype``, from the plain K2 twin."""
    dev = torch.device("cuda")
    Wt = torch.as_tensor(W, dtype=dtype, device=dev)
    Yt = torch.as_tensor(np.where(W > 0, Ynan, 0.0), dtype=dtype, device=dev)
    Yf = torch.as_tensor(Yfull, dtype=dtype, device=dev)
    pt = SSMParams.from_numpy(p, dtype=dtype, device=dev)
    stats, ustats = (inf.ObsStats(*(x.contiguous() for x in st)) for st in (
        inf.obs_stats_plain(Yt, pt.Lam, pt.R, Wt),
        inf.obs_stats_plain(Yf, pt.Lam, pt.R)))
    return stats, ustats, pt


def sgen_kernel_phase(seed: int, tau_fit: int) -> dict:
    """The four generic kernels against their plain twins at (T, N, k) =
    (500, 10,000, 50) and (500, 10,000, 100), f64 then f32 (the TOL rule),
    timed warm and cold beside the plain twin, the bound, the latency floor
    (K4's chain at the same (T, k); K5a: tau forward and 2 tau + 1
    backward steps) and K14-el's one-call yardsticks: K5a-gen at tau = 8,
    the k = 50 fit's own tau and 192, K5b-gen forward and reverse with h =
    tau on the unmasked panel, every K14 mode on the masked one (T = 500:
    S = 22, B = 22, a tail of 16).  Calls over ~50 ms (K5a-gen at 192,
    the prefix at k = 100) take one cold-L2 call.  Returns the f32 records
    at k = 100 of ``SGEN_SUMMARY``."""
    summary = {}
    taus = {8: "tau=8", tau_fit: "tau_fit", TAU_MAX: f"tau={TAU_MAX}"}
    taus = [(lb, t) for t, lb in sorted(taus.items())]
    for k in KBIG_KS:
        pan = panel(seed + KBIG_SEED + k, K_=k)
        refs = {}
        for dtype in (torch.float64, torch.float32):
            with highest_precision():
                stats, ustats, pt = sgen_stats(*pan, dtype)
                for c in sgen_cases(stats, ustats, pt, taus, "masked"):
                    if c["variant"] in (f"tau={TAU_MAX}", "prefix masked"):
                        c["cold_reps"] = 1
                    rec = kernel_record(c, dtype, refs)
                    rec["k"] = k
                    tau = dict(taus).get(c["variant"].split()[-1])
                    if tau is not None:
                        rec["tau"] = tau
                    if c["name"] == kernels.GEN["pit_scan"]:
                        rec["combines_in_sequence"] = pit_chain(T)
                    rec["library_call"] = PIT_LIBRARY.get(
                        c["variant"].removesuffix(" masked"))
                    emit(rec)
                    if (dtype == torch.float32 and k == KBIG_KS[-1]
                            and c["variant"] in SGEN_SUMMARY):
                        summary[c["name"]] = rec
                del stats, ustats, pt
            torch.cuda.empty_cache()
        del pan, refs
    return summary


def sgen_raise_calls(k: int) -> dict:
    """Every entry point of the four kernels called at k on card tensors
    of zeros (T = 5)."""
    z = dict(dtype=torch.float32, device="cuda")
    mats, vecs = torch.zeros((5, k, k), **z), torch.zeros((5, k), **z)
    eye, v0 = torch.eye(k, **z), torch.zeros(k, **z)
    st = inf.ObsStats(vecs, mats, torch.zeros(5, **z), torch.zeros(5, **z))
    kf = FilterResult(vecs, mats, vecs, mats, None)
    return {"ss_cov_path": lambda: ss.ss_cov_path(eye, eye, eye, eye, 4),
            "affine_scan": lambda: sc.affine_scan(vecs, mats, eye, v0),
            "filter elements": lambda: pf.pit_filter_elements(
                st, eye, eye, v0, eye),
            "prefix": lambda: pf.pit_scan((mats, vecs, mats, vecs, mats)),
            "assemble": lambda: pf.pit_filter_assemble(
                vecs, mats, mats, eye, eye, v0, eye),
            "smoother elements": lambda: pf.pit_smoother_elements(kf, eye),
            "suffix": lambda: pf.pit_scan((mats, vecs, mats), True),
            "P_lag": lambda: pf.pit_smoother_assemble(mats, mats[:4])}


def sgen_k_sweep(seed: int) -> None:
    """The four generic kernels through their wrappers at k in SGEN_SWEEP
    on SGEN_SWEEP_SHAPE panels, f64 and f32 (error checks only): K5a-gen
    at tau = 8 and 24, K5b-gen forward and reverse with h = tau on the
    fully observed panel, every K14 mode with a per-step C on the masked
    panel (step 0 fully missing, step 7 observing fewer than k series,
    series 3 never observed) and with the static C of the fully observed
    one.  Then k = 129 must raise NotImplementedError naming the ROADMAP
    row in every entry point before any launch."""
    T_, N_ = SGEN_SWEEP_SHAPE
    taus = [(f"tau={t}", t) for t in SGEN_SWEEP_TAUS]
    for k in SGEN_SWEEP:
        _, W, Yfull, p = panel(seed + KBIG_SEED + 300 + k, T_=T_, N_=N_,
                               K_=k)
        W[0] = 0.0
        W[7] = 0.0
        W[7, :k - 1] = 1.0
        W[:, 3] = 0.0
        Ynan = np.where(W > 0, Yfull, np.nan)
        refs, worst = {}, {}
        for dtype in (torch.float64, torch.float32):
            with highest_precision():
                stats, ustats, pt = sgen_stats(Ynan, W, Yfull, p, dtype)
                for c in sgen_cases(stats, ustats, pt, taus, "masked",
                                    static=ustats):
                    key = (c["name"], c["variant"])
                    _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                    refs[key] = ref
                    name = f"{c['variant']} {str(dtype)[6:]}"
                    worst[name] = max(worst.get(name, 0.0), rel)
        emit({"sgen_k_sweep": k, "shape": SGEN_SWEEP_SHAPE,
              "max_rel_err": worst})
    torch.cuda.synchronize()
    kernels.reset_launches()
    raised = {}
    for name, fn in sgen_raise_calls(kernels.GEN_KMAX + 1).items():
        try:
            fn()
        except NotImplementedError as e:
            raised[name] = kernels.GENERIC_K in str(e)
    launched = sum(kernels.LAUNCHES.values())
    emit({"sgen_k129_raised": raised, "launches": launched})
    if len(raised) != 8 or not all(raised.values()) or launched:
        raise AssertionError(f"k = 129: only {raised} raised, {launched} "
                             "launches")


def sgen_fit_launches(k: int, engine: str, ran: int) -> dict:
    """An sgen fit's launches, exactly, for ``ran`` iterations: ss runs
    K5a (three device kernels a call past 32) and K5b twice an iteration,
    the f32 quadratic by the expanded form (no kernel), and the K4 pair
    and K1 once for the reporting smooth; masked pit runs four K14-el
    modes and two K14-scan passes, K2, K1 (``loglik_terms_local``) and K3
    an iteration, K2 and K1 once more and the K4 pair once for the
    reporting smooth."""
    if engine == "ss":
        want = {"ss_cov_path": ran, "affine_scan": 2 * ran,
                "info_scan": 1, "rts_smoother": 1, "quad_local": 1}
    else:
        want = {"pit_elements": 4 * ran, "pit_scan": 2 * ran,
                "obs_stats": ran + 1, "quad_local": ran + 1,
                "mstep_rows": ran, "info_scan": 1, "rts_smoother": 1}
    return routed(want, k)


def sgen_fit_phase(seed: int) -> dict:
    """``SGEN_FITS`` on the headline panel simulated at k = 50 and 100 (the
    unmasked ones through the default ``TorchBackend()``, which must
    resolve to ``ss`` at tau = auto_tau(init)), 10 iterations, tol = 0,
    f32, with a 12-step forecast: finite outputs, exactly
    ``sgen_fit_launches`` (the generic kernels, no kernel of a k <= 32
    tier), one read a chunk (and the result's), logliks non-decreasing
    within the f32 noise floor; EM it/s beside kbig's info fit at the same
    k (when the kbig group ran), the wall, tau and the largest freeze
    delta; each iteration split into its kernels.  Returns the launch
    counts by label."""
    counts, pans = {}, {}
    floor = noise_floor_for(torch.float32, T * N)
    for label, k, masked, flt, engine in SGEN_FITS:
        if k not in pans:
            pans = {k: panel(seed + KBIG_SEED + k, K_=k)}
        Ynan, W, Yfull, _ = pans[k]
        Y = Ynan if masked else Yfull
        model = dt.DynamicFactorModel(n_factors=k, dynamics="ar1")
        backend = dt.TorchBackend(filter=flt)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with ReadWatch() as rw:
            t0 = time.perf_counter()
            res = dt.fit(model, Y, backend=backend, max_iters=KBIG_ITERS,
                         tol=0.0)
            y_fore, f_fore = dt.forecast(res, 12)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        lls = res.logliks
        n = len(lls)
        chunk = backend.fused_chunk
        n_chunks = -(-n // chunk)
        ran = min(KBIG_ITERS, n_chunks * chunk)
        drops = [i for i in range(1, n) if lls[i] < lls[i - 1] - floor]
        want = sgen_fit_launches(k, engine, ran)
        bad = {nm: v for nm, v in launches.items() if v != want.get(nm, 0)}
        steady = [h["secs"] for h in res.history[chunk:]]
        rec = {"fit": label, "filter": res.filter, "k": k, "tau": res.tau,
               "ss_delta": res.ss_delta, "n_iters": n,
               "iterations_run": ran, "loglik_first": float(lls[0]),
               "loglik_last": float(lls[-1]),
               "max_drop": float(max(0.0, -np.diff(lls).min())),
               "noise_floor": floor, "drops_past_floor": drops,
               "wall_s": wall,
               "em_iters_per_sec": (len(steady) / sum(steady)
                                    if steady and sum(steady) > 0 else None),
               "beside": {SGEN_BESIDE[label]:
                          RATES.get(SGEN_BESIDE[label])},
               "reads": len(rw.stamps) + 1, "n_chunks": n_chunks,
               "launches": {nm: v for nm, v in launches.items() if v}}
        emit(rec)
        RATES[label] = rec["em_iters_per_sec"]
        if (res.filter != engine or n != KBIG_ITERS
                or not np.isfinite(lls).all() or drops
                or (engine == "ss" and not 2 * res.tau + 4 < T)):
            raise AssertionError(f"{label}: {res.filter}, {n} iterations, "
                                 f"tau {res.tau}, drops past the noise "
                                 f"floor {drops}")
        for name, arr in (("factors", res.factors), ("y_fore", y_fore),
                          ("f_fore", f_fore)):
            if not np.isfinite(arr).all():
                raise AssertionError(f"{label}: non-finite {name}")
        if bad or len(rw.stamps) != n_chunks:
            raise AssertionError(f"{label}: launches off {want}: {bad}; "
                                 f"chunk reads {len(rw.stamps)} of "
                                 f"{n_chunks}")
        counts[label] = launches
        sgen_iteration_breakdown(label, Y, res, masked)
    return counts


def sgen_iteration_breakdown(label: str, Y, res, masked: bool) -> None:
    """Where an ss or pit EM iteration at k > 32 goes (f32, warm L2, at the
    fitted params on the standardized panel): each generic kernel (CUDA
    events; K14-el by mode, K14-scan by pass) against the whole
    ``em_step``; the rest is the iteration less the kernels (the
    statistics' GEMM and the expanded quadratic of ss, the moments, the
    k x k M-step, launch gaps)."""
    W = data.build_mask(Y)
    Z, _ = data.standardize(Y, mask=W)
    f32 = torch.float32
    engine = res.filter
    with highest_precision():
        Zt = torch.as_tensor(np.where(W > 0, np.nan_to_num(Z), 0.0),
                             dtype=f32, device="cuda").contiguous()
        Wt = (torch.as_tensor(W, dtype=f32, device="cuda").contiguous()
              if masked else None)
        pt = SSMParams.from_numpy(res.params, dtype=f32, device="cuda")
        k = pt.A.shape[0]
        stats = inf.obs_stats(Zt, pt.Lam, pt.R, Wt)
        ms = {}
        if engine == "ss":
            cfg = EMConfig(filter="ss", tau=res.tau)
            _, fwd, rev = ss_inputs(stats, pt, res.tau)
            ms["ss_cov_path_gen"] = cuda_ms(lambda: ss.ss_cov_path(
                stats.C, pt.A, pt.Q, pt.P0, res.tau))
            ms["affine_scan_gen forward"] = cuda_ms(
                lambda: sc.affine_scan(*fwd))
            ms["affine_scan_gen reverse"] = cuda_ms(
                lambda: sc.affine_scan(*rev, reverse=True))
        else:
            cfg = EMConfig(filter="pit")
            el = pf.pit_filter_elements(stats, pt.A, pt.Q, pt.mu0, pt.P0)
            kf = pf.pit_filter(Zt, pt, Wt)
            (E, g, L), J = pf.pit_smoother_elements(kf, pt.A)
            sm = pf.pit_smoother(kf, pt)
            EffT, _ = moments(sm)
            ms[kernels.route("obs_stats", k)] = cuda_ms(
                lambda: inf.obs_stats(Zt, pt.Lam, pt.R, Wt))
            ms["pit_elements_gen filter elements"] = cuda_ms(
                lambda: pf.pit_filter_elements(stats, pt.A, pt.Q, pt.mu0,
                                               pt.P0))
            ms["pit_scan_gen prefix"] = cuda_ms(lambda: pf.pit_scan(el))
            ms["pit_elements_gen assemble"] = cuda_ms(
                lambda: pf.pit_filter_assemble(kf.x_filt, kf.P_filt, stats.C,
                                               pt.A, pt.Q, pt.mu0, pt.P0))
            ms["pit_elements_gen smoother elements"] = cuda_ms(
                lambda: pf.pit_smoother_elements(kf, pt.A))
            ms["pit_scan_gen suffix"] = cuda_ms(
                lambda: pf.pit_scan((E, g, L), True))
            ms["pit_elements_gen P_lag"] = cuda_ms(
                lambda: pf.pit_smoother_assemble(sm.P_sm, J))
            ms[kernels.route("quad_local", k)] = cuda_ms(
                lambda: inf.loglik_terms_local(Zt, pt.Lam, pt.R, kf.x_pred,
                                               Wt))
            ms[kernels.route("mstep_rows", k)] = cuda_ms(
                lambda: mstep_rows(Zt, Wt, sm.x_sm, EffT, sm.P_sm, None,
                                   1e-6))
        iter_ms = cuda_ms(lambda: tem.em_step(Zt, pt, Wt, cfg))
    beside = SGEN_BESIDE[label]
    emit({"sgen_iteration_breakdown": label, "shape": [*Y.shape, k],
          "tau": res.tau, "iter_ms": iter_ms, "kernel_ms": ms,
          "rest_ms": iter_ms - sum(ms.values()),
          "beside": beside,
          "beside_iter_ms": (1e3 / RATES[beside] if RATES.get(beside)
                             else None)})


def sgen_session_phase(seed: int) -> dict:
    """``fit(fused=True)`` with ``filter="pit"`` on the masked k = 50
    panel's first 480 rows (10 iterations, tol = 0, f32), then a pit
    session on it at capacity 1,000 with 3 queries of 2 rows and a
    re-forecast: one read a query under the sync check, K13 and
    K14-scan-gen every query, no kernel of a k <= 32 tier.  Returns the
    launch counts by label."""
    k = KBIG_KS[0]
    Ynan = panel(seed + KBIG_SEED + k, K_=k)[0]
    model = dt.DynamicFactorModel(n_factors=k, dynamics="ar1")
    backend = dt.TorchBackend(filter="pit")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    fused = dt.fit(model, Ynan[:SESSION_T0], backend=backend, fused=True,
                   max_iters=KBIG_ITERS, tol=0.0)
    wall = time.perf_counter() - t0
    launches = {nm: v for nm, v in kernels.LAUNCHES.items() if v}
    emit({"fused_fit": f"k{k} pit", "filter": fused.filter,
          "n_iters": fused.n_iters, "host_reads": fused.host_reads,
          "wall_s": wall, "loglik_last": float(fused.logliks[-1]),
          "launches": launches})
    narrow = narrow_launched(launches)
    if (fused.filter != "pit" or not np.isfinite(fused.logliks).all()
            or narrow
            or launches.get("pit_scan_gen", 0) < 2 * KBIG_ITERS):
        raise AssertionError(f"k = {k} pit fused fit failed: "
                             f"{fused.filter}, launches {launches}")
    sess = dt.open_session(fused, Ynan[:SESSION_T0], backend=backend,
                           capacity=1000, max_update_rows=8, max_iters=5,
                           tol=0.0)
    drive_session(sess, f"pit k{k}", Ynan, "pit", "pit_scan_gen",
                  queries=KBIG_SESSION_QUERIES)
    counts = {f"pit k{k} session": dict(kernels.LAUNCHES)}
    narrow = narrow_launched(kernels.LAUNCHES)
    sess.close()
    if narrow:
        raise AssertionError(f"pit k{k} session launched {narrow}")
    return counts


def sgen_reference_phase(seed: int) -> None:
    """``fit`` at 120 x 80, k = 40, card f64 against CPU f64 within 1e-12:
    fully observed with ``filter="ss"`` (tau = auto_tau(init), 12 here)
    and masked (scattered missing values, a ragged edge, one series
    observed at its first step alone) with ``filter="pit"``."""
    k = SGEN_REF_K
    _, W, Yfull, _ = panel(seed + KBIG_SEED + k + 100, T_=120, N_=80, K_=k)
    W[:, 5] = 0.0
    W[0, 5] = 1.0
    Ynan = np.where(W > 0, Yfull, np.nan)
    reference_fit("k40 unmasked ss", Yfull, k, "ss", 1e-12)
    reference_fit("k40 masked pit", Ynan, k, "pit", 1e-12)


def sgen_contract_phase(seed: int) -> None:
    """The loglik contract (``loglik_contract``) at k = 50 on the headline
    panel simulated there: ss on the fully observed panel, pit on the
    masked one."""
    k = KBIG_KS[0]
    Ynan, W, Yfull, _ = panel(seed + KBIG_SEED + k, K_=k)
    loglik_contract(f"k{k} unmasked ss", Yfull, None, k, "ss")
    loglik_contract(f"k{k} masked pit", Ynan, W, k, "pit")


# ---------------------------------------------------------------------------
# The square-root engine past k = 10 (qgen): qr_elements_gen and qr_scan_gen
# (K8-gen), the JAX package's generic branches of tria, tri_solve,
# psd_factor and the element builds' Cholesky factorizations and solves.
# ---------------------------------------------------------------------------

QGEN_KS = (25, 50, 100)
QGEN_SWEEP = (11, 16, 25, 32, 33, 64, 128)
QGEN_SWEEP_SHAPE = (97, 300)      # (T, N): S = 9, B = 10, a tail of 7
QGEN_FIT_KS = (25, 50)
QGEN_ITERS = 10
# The fits each pit_qr fit sits beside (info and pit at the same k on the
# same panel: the wide group's at k = 25, kbig's and sgen's at k = 50, when
# those groups ran).
QGEN_BESIDE = {25: ("k25 masked auto", "k25 masked pit"),
               50: ("k50 masked auto", "k50 masked pit")}
# Past k = 10 the reference forms tria from the Gram matrix with the
# dtype's jitter (1e-6 in f32, 1e-10 in f64) on posterior factors whose Gram
# is O(1/N): the square-root loglik is far from the exact one at N =
# 10,000 in either package.  The kernel path is held to the plain twins on
# the card: its loglik error from the exact f64 one at most QR_ERR_MULT
# times the twins' (plus QR_ERR_FLOOR), and the gap between the two paths,
# |kernel - twin| / |exact|, at most QR_GAP_F64 in f64 and, in f32, at
# most QR_GAP_F32 (the other engines' loglik limit) or QR_GAP_F32_SHARE of
# the twins' own error, whichever is larger.
QR_ERR_MULT, QR_ERR_FLOOR = 2.0, 1e-12
QR_GAP_F64, QR_GAP_F32, QR_GAP_F32_SHARE = 1e-6, 1e-5, 1e-3
# The fitted params of the qgen fits by k (qgen_fit_phase fills it).
QGEN_FITTED: dict = {}


def qgen_panel(seed: int, k: int):
    """The headline panel simulated at k factors: the wide group's panel
    at k = 25, kbig's and sgen's elsewhere (the fits beside)."""
    if k == WIDE_K:
        return panel(seed + WIDE_SEED, K_=k)
    return panel(seed + KBIG_SEED + k, K_=k)


def qgen_kernel_phase(seed: int) -> dict:
    """Every mode of qr_elements_gen (the filter and smoother elements,
    both assemblies, the six K6/K7 unit ops on matrices of the path) and
    both passes of qr_scan_gen against their plain twins on the masked
    headline panel at k = 25, 50 and 100, f64 then f32 (the TOL rule; f32
    timed warm and cold L2 beside the plain twin, the bound and the unit
    ops' one-call yardsticks), then on S3's augmented state (m = 25, the
    fit's PCA init) in f64, the mixed-frequency path's dtype, timed.
    Calls over ~50 ms (the k = 100 prefix) take one cold-L2 call.  Returns
    the f32 records at k = 50 (the widest fit's, whose launches the
    summary line reports) of the filter element build and the prefix.
    (S3's augmented C_t has rank 10 of 25: the
    reference's f32 psd_factor, a Cholesky with a 1e-6 jitter, fails on it
    with NaN, which is why that route's scans run in f64.)"""
    summary = {}
    for k in QGEN_KS:
        pan = qgen_panel(seed, k)
        refs = {}
        for dtype in (torch.float64, torch.float32):
            with highest_precision():
                stats, _, pt = sgen_stats(*pan, dtype)
                for c in qr_cases(stats, pt, "masked"):
                    if k == QGEN_KS[-1] and c["name"] == "qr_scan_gen":
                        c["cold_reps"] = 1
                    rec = kernel_record(c, dtype, refs)
                    rec["k"] = k
                    if c["name"] == "qr_scan_gen":
                        rec["combines_in_sequence"] = pit_chain(T)
                    emit(rec)
                    if (dtype == torch.float32 and k == QGEN_FIT_KS[-1]
                            and c["variant"] == "filter masked"):
                        summary[c["name"]] = rec
                del stats, pt
            torch.cuda.empty_cache()
        del pan, refs
    spec = mf_spec("pit_qr")
    Yz, Wm, init = mf_inputs(mf_panel(seed + 1000), spec)
    f64 = torch.float64
    with highest_precision():
        aug = mf.augment(mf.MFParams(*init).to("cuda", f64), spec)
        stats = inf.ObsStats(*(x.contiguous() for x in inf.obs_stats_plain(
            torch.as_tensor(Yz, dtype=f64, device="cuda"), aug.Lam, aug.R,
            torch.as_tensor(Wm, dtype=f64, device="cuda"))))
        for c in qr_cases(stats, aug, "S3", unit=False):
            rec = kernel_record(c, f64, {}, True)
            rec.update({"T": MF_T, "m": spec.state_dim})
            emit(rec)
    return summary


def qgen_raise_calls(k: int) -> dict:
    """Every entry point of the square-root engine's kernels called at k
    on card tensors of zeros (T = 5)."""
    z = dict(dtype=torch.float32, device="cuda")
    mats, vecs = torch.zeros((5, k, k), **z), torch.zeros((5, k), **z)
    eye, v0 = torch.eye(k, **z), torch.zeros(k, **z)
    st = inf.ObsStats(vecs, mats, torch.zeros(5, **z), torch.zeros(5, **z))
    kf = FilterResult(vecs, mats, vecs, mats, None)
    return {"filter elements": lambda: pf.qr_filter_elements(
                st, eye, eye, v0, eye),
            "prefix": lambda: pf.qr_scan((mats, vecs, mats, vecs, mats)),
            "assemble": lambda: pf.qr_filter_assemble(
                vecs, mats, mats, eye, eye, v0, eye),
            "smoother elements": lambda: pf.qr_smoother_elements(
                kf, eye, eye),
            "suffix": lambda: pf.qr_scan((mats, vecs, mats), True),
            "smoother assemble": lambda: pf.qr_smoother_assemble(
                mats, mats[:4]),
            "unit": lambda: la.small_linalg("chol", mats)}


def qgen_k_sweep(seed: int) -> None:
    """Every mode of the square-root kernels through their wrappers at k =
    10 (the one-thread kernels, which must still be the ones launched) and
    at k in QGEN_SWEEP (the generic ones, on both sides of 32) on
    QGEN_SWEEP_SHAPE panels, f64 and f32 (error checks only): a per-step C
    on the masked panel (step 0 fully missing, series 3 never observed)
    and the static C of the fully observed one (the unit ops on the
    masked panel's matrices); in f64 also with step 7 observing fewer
    than k series (in f32 the reference's psd_factor of
    that rank-deficient C_t, a Cholesky with a 1e-6 jitter, is NaN in the
    plain twin itself past k ~ 32).  Then k = 129 must raise
    NotImplementedError naming the ROADMAP row in every entry point before
    any launch."""
    T_, N_ = QGEN_SWEEP_SHAPE
    for k in (la.QR_UNROLL_K_MAX,) + QGEN_SWEEP:
        _, W, Yfull, p = panel(seed + KBIG_SEED + 400 + k, T_=T_, N_=N_,
                               K_=k)
        W[0] = 0.0
        W[:, 3] = 0.0
        Wd = W.copy()
        Wd[7] = 0.0
        Wd[7, :k - 1] = 1.0
        Wd[7, 3] = 0.0
        refs, worst = {}, {}
        kernels.reset_launches()
        for dtype, Wm, label in ((torch.float64, Wd, "rank-deficient"),
                                 (torch.float64, W, "masked"),
                                 (torch.float32, W, "masked")):
            Ynan = np.where(Wm > 0, Yfull, np.nan)
            with highest_precision():
                stats, ustats, pt = sgen_stats(Ynan, Wm, Yfull, p, dtype)
                cases = qr_cases(stats, pt, label, unit=label == "masked")
                if label == "masked":
                    cases += qr_cases(ustats, pt, "static", unit=False)
                for c in cases:
                    key = (c["name"], c["variant"])
                    _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                    refs[key] = ref
                    name = f"{c['name']} {c['variant']} {str(dtype)[6:]}"
                    worst[name] = max(worst.get(name, 0.0), rel)
        launched = {n: v for n, v in kernels.LAUNCHES.items() if v}
        emit({"qgen_k_sweep": k, "shape": QGEN_SWEEP_SHAPE,
              "max_rel_err": worst, "launches": launched})
        want = {la.check_qr_k("qr_elements", k), la.check_qr_k("qr_scan", k)}
        if set(launched) != want:
            raise AssertionError(f"qgen k = {k}: launched {launched}, "
                                 f"expected only {want}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    raised = {}
    for name, fn in qgen_raise_calls(kernels.GEN_KMAX + 1).items():
        try:
            fn()
        except NotImplementedError as e:
            raised[name] = kernels.GENERIC_K in str(e)
    launched = sum(kernels.LAUNCHES.values())
    emit({"qgen_k129_raised": raised, "launches": launched})
    if len(raised) != 7 or not all(raised.values()) or launched:
        raise AssertionError(f"k = 129: only {raised} raised, {launched} "
                             "launches")


def qgen_fit_launches(k: int, ran: int) -> dict:
    """A masked pit_qr fit's launches, exactly, for ``ran`` iterations:
    four qr_elements and two qr_scan, K2, K1 (``quad_local``) and K3 an
    iteration; K2 and K1 once more and the K4 pair once for the reporting
    smooth (the info pair)."""
    return routed({"qr_elements": 4 * ran, "qr_scan": 2 * ran,
                   "obs_stats": ran + 1, "quad_local": ran + 1,
                   "mstep_rows": ran, "info_scan": 1, "rts_smoother": 1}, k)


def qgen_fit_phase(seed: int) -> dict:
    """``fit(filter="pit_qr")`` on the masked headline panel simulated at
    k = 25 and 50, 10 iterations, tol = 0, f32, with a 12-step forecast:
    finite outputs, exactly ``qgen_fit_launches`` for the iterations the
    device ran (whole chunks), one read a chunk (and the result's).  The
    f32 square-root loglik past 10 carries the reference's Gram-branch
    jitter (``QR_ERR_MULT``), so the stop rule may end the fit early as
    diverged: the fit's iterations, stop and drops are reported, not
    gated.  EM it/s from ``em_fit_scan`` at the fitted params (two timed
    runs of a chunk after a warm one; ``RATES`` holds it) beside info and
    pit at the same k.  Returns the launch counts by label."""
    counts = {}
    floor = noise_floor_for(torch.float32, T * N)
    for k in QGEN_FIT_KS:
        Ynan, W, _, _ = qgen_panel(seed, k)
        label = f"k{k} masked pit_qr"
        model = dt.DynamicFactorModel(n_factors=k, dynamics="ar1")
        backend = dt.TorchBackend(filter="pit_qr")
        torch.cuda.synchronize()
        kernels.reset_launches()
        with ReadWatch() as rw:
            t0 = time.perf_counter()
            res = dt.fit(model, Ynan, backend=backend, max_iters=QGEN_ITERS,
                         tol=0.0)
            y_fore, f_fore = dt.forecast(res, 12)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        lls = res.logliks
        n = len(lls)
        chunk = backend.fused_chunk
        n_chunks = -(-n // chunk)
        ran = min(QGEN_ITERS, n_chunks * chunk)
        drops = [i for i in range(1, n) if lls[i] < lls[i - 1] - floor]
        want = qgen_fit_launches(k, ran)
        bad = {nm: v for nm, v in launches.items() if v != want.get(nm, 0)}
        rate = qgen_em_rate(Ynan, W, res.params, chunk)
        rec = {"fit": label, "filter": res.filter, "k": k, "n_iters": n,
               "iterations_run": ran, "converged": res.converged,
               "loglik_first": float(lls[0]), "loglik_last": float(lls[-1]),
               "logliks": [float(x) for x in lls],
               "noise_floor": floor, "drops_past_floor": drops,
               "wall_s": wall, "em_iters_per_sec": rate,
               "beside": {b: RATES.get(b) for b in QGEN_BESIDE.get(k, ())},
               "launches_per_iter": {
                   nm: launches[nm] / ran for nm in
                   ("qr_elements_gen", "qr_scan_gen")},
               "reads": len(rw.stamps) + 1, "n_chunks": n_chunks,
               "launches": {nm: v for nm, v in launches.items() if v}}
        emit(rec)
        RATES[label] = rate
        QGEN_FITTED[k] = res.params
        if res.filter != "pit_qr" or not np.isfinite(lls).all():
            raise AssertionError(f"{label}: {res.filter}, non-finite "
                                 "logliks")
        for name, arr in (("factors", res.factors), ("y_fore", y_fore),
                          ("f_fore", f_fore)):
            if not np.isfinite(arr).all():
                raise AssertionError(f"{label}: non-finite {name}")
        if bad or len(rw.stamps) != n_chunks:
            raise AssertionError(f"{label}: launches off {want}: {bad}; "
                                 f"chunk reads {len(rw.stamps)} of "
                                 f"{n_chunks}")
        counts[label] = launches
    return counts


def qgen_em_rate(Ynan, W, p0, chunk: int) -> float:
    """EM iterations a second of the f32 pit_qr E-step and M-step
    (``em_fit_scan``, ``chunk`` iterations a run, no stop rule) from the
    params ``p0`` on the standardized panel: the mean of two timed runs
    after a warm one, each ending in a synchronize."""
    Z, _ = data.standardize(Ynan, mask=W)
    cfg = EMConfig(filter="pit_qr")
    with highest_precision():
        Zt = torch.as_tensor(np.where(W > 0, np.nan_to_num(Z), 0.0),
                             dtype=torch.float32, device="cuda").contiguous()
        Wt = torch.as_tensor(W, dtype=torch.float32,
                             device="cuda").contiguous()
        pt = SSMParams.from_numpy(p0, dtype=torch.float32, device="cuda")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            em_fit_scan(Zt, pt, chunk, mask=Wt, cfg=cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    return 2 * chunk / sum(walls[1:])


def qr_loglik_plain(Yt, pt, mt) -> float:
    """``pit_qr_filter``'s loglik with every kernel's plain twin, on the
    tensors' device and in their dtype."""
    st = inf.ObsStats(*inf.obs_stats_plain(Yt, pt.Lam, pt.R, mt))
    el = pf.qr_filter_elements_plain(st, pt.A, pt.Q, pt.mu0, pt.P0)
    pref = pf.qr_scan_plain(el)
    x_pred, _, P_f, logdetG = pf.qr_filter_assemble_plain(
        pref[1], pref[2], st.C, pt.A, pt.Q, pt.mu0, pt.P0)
    quad = inf.quad_local_plain(Yt, pt.Lam, pt.R, x_pred, mt)
    return float(inf.loglik_from_terms(st, logdetG, P_f, quad,
                                       inf.u_from_stats(st, x_pred)))


def qr_gap_limit(dtype, twin_err: float) -> float:
    """The largest |kernel - twin| / |exact| loglik gap allowed between
    the square-root kernel path and its plain twins in ``dtype``, given
    the twins' own relative error ``twin_err``."""
    if dtype == torch.float64:
        return QR_GAP_F64
    return max(QR_GAP_F32, QR_GAP_F32_SHARE * twin_err)


def qgen_contract_phase(seed: int) -> None:
    """The square-root loglik past 10 on the masked headline panel at k =
    25 and 50, at the device PCA init and at the qgen fit's params: the
    kernel path (``pit_qr_filter``) and the plain twins on the card, each
    in f32 and f64, against the exact f64 loglik (the info filter,
    ``loglik_eval(precise=True)``).  Printed on one line a point; the
    kernel path's error at most QR_ERR_MULT times the twins' (+
    QR_ERR_FLOOR) in each dtype, as the reference's Gram branch puts both
    far from 1e-5 at N = 10,000 (the f64 figures are the reference's own;
    the 1e-5 contract of the augmented S3 route is ``mf_contract_phase``'s),
    and the gap between the paths within ``qr_gap_limit``."""
    dev = torch.device("cuda")
    for k in QGEN_FIT_KS:
        Ynan, W, _, _ = qgen_panel(seed, k)
        Z, _ = data.standardize(Ynan, mask=W)
        Z = np.where(W > 0, np.nan_to_num(Z), 0.0)
        with highest_precision():
            Z64 = torch.as_tensor(Z, dtype=torch.float64, device=dev)
            points = {"init": pca_init_device(Z64, k)}
            if k in QGEN_FITTED:
                points["fitted"] = QGEN_FITTED[k]
            for where, p in points.items():
                exact = inf.loglik_eval(Z64, p, mask=W, precise=True)
                errs = {}
                for dtype in (torch.float32, torch.float64):
                    Yt = torch.as_tensor(Z, dtype=dtype, device=dev)
                    mt = torch.as_tensor(W, dtype=dtype, device=dev)
                    pt = SSMParams.from_numpy(p, dtype=dtype, device=dev)
                    kern = float(pf.pit_qr_filter(Yt, pt, mt).loglik)
                    twin = qr_loglik_plain(Yt, pt, mt)
                    e = {"kernel": abs(kern - exact) / abs(exact),
                         "twin": abs(twin - exact) / abs(exact),
                         "gap": abs(kern - twin) / abs(exact)}
                    e["gap_limit"] = qr_gap_limit(dtype, e["twin"])
                    errs[str(dtype)[6:]] = e
                emit({"qr_contract": f"k{k} masked pit_qr {where}", "k": k,
                      "N": N, "loglik_exact_f64": exact, "rel_err": errs,
                      "mult": QR_ERR_MULT})
                bad = {d: e for d, e in errs.items() if not (
                    e["kernel"] <= QR_ERR_MULT * e["twin"] + QR_ERR_FLOOR
                    and e["gap"] <= e["gap_limit"])}
                if bad:
                    raise AssertionError(f"pit_qr k = {k} ({where}): the "
                                         f"kernel path's loglik error past "
                                         f"{QR_ERR_MULT} x the twins' or "
                                         f"its gap from them past the "
                                         f"limit: {bad}")


def qgen_mf_contract_phase(seed: int) -> None:
    """The S3 ``pit_qr`` route's loglik (m = 25: the generic kernels on
    the augmented state).  f64: 2 EM iterations from the fit's PCA init
    (``mf_em_scan``) on the card (the kernels) and on the CPU (the plain
    twins); each trajectory's loglik at its 2-update params against
    ``mf_loglik_eval(precise=True)`` (the augmented info-form filter) of the
    same params: the card's error at most QR_ERR_MULT times the CPU's (+
    QR_ERR_FLOOR) and the card's loglik within QR_GAP_F64 (relative to
    the exact one) of the CPU's, the 1e-5 limit printed beside (the
    reference's jitter
    puts the route ~1.5e-4 from it at S3).  f32: the route's E-step from
    the same init on the card and on the CPU: the reference's psd_factor
    of the rank-10 augmented C_t (widened from f32 statistics) fails, so
    the loglik must be non-finite on both, or finite on both."""
    pan = mf_panel(seed + 1001)
    spec = mf_spec("pit_qr")
    Yz, W, init = mf_inputs(pan, spec)
    errs, lls32, own64 = {}, {}, {}
    for dev in ("cuda", "cpu"):
        with highest_precision():
            for dtype in (torch.float64, torch.float32):
                Yt = torch.as_tensor(Yz, dtype=dtype, device=dev)
                Wt = torch.as_tensor(W, dtype=dtype, device=dev)
                p0 = mf.MFParams(*init).to(dev, dtype)
                if dtype == torch.float32:
                    lls32[dev] = float(mf.mf_em_core(
                        Yt.contiguous(), Wt.contiguous(), p0, spec)[1])
                    continue
                p2 = mf.mf_em_scan(Yt.contiguous(), Wt.contiguous(), p0,
                                   spec, 2)[0]
                own = float(mf.mf_em_core(Yt.contiguous(), Wt.contiguous(),
                                          p2, spec)[1])
                exact = mf.mf_loglik_eval(Yz, W, p2, spec, device=dev)
                errs[dev] = abs(own - exact) / abs(exact)
                own64[dev], exact64 = own, exact
    gap = abs(own64["cuda"] - own64["cpu"]) / abs(exact64)
    emit({"qr_contract": "mf pit_qr S3", "m": spec.state_dim,
          "shape": [MF_T, MF_NM + MF_NQ, MF_K], "iters": 2,
          "f64_rel_err": {"card": errs["cuda"], "cpu_twins": errs["cpu"],
                          "gap": gap, "gap_limit": QR_GAP_F64},
          "limit_1e-5_met": errs["cuda"] < 1e-5, "mult": QR_ERR_MULT,
          "f32_loglik": lls32})
    if not (errs["cuda"] <= QR_ERR_MULT * errs["cpu"] + QR_ERR_FLOOR
            and gap <= QR_GAP_F64):
        raise AssertionError(f"mf pit_qr (f64): the card's loglik error "
                             f"past {QR_ERR_MULT} x the twins' or its gap "
                             f"from them past {QR_GAP_F64}: {errs}, {gap}")
    if np.isfinite(lls32["cuda"]) != np.isfinite(lls32["cpu"]):
        raise AssertionError(f"mf pit_qr (f32): finite on one path only: "
                             f"{lls32}")


def qgen_session_phase(seed: int) -> dict:
    """``fit(fused=True)`` with ``filter="pit_qr"`` on the masked k = 25
    panel's first 480 rows (10 iterations, tol = 0, f32), then a pit_qr
    session on it at capacity 1,000 with 3 queries of 2 rows and a
    re-forecast: one read a query under the sync check, K13 and
    qr_scan_gen every query, no k <= 10 square-root kernel.  Returns the
    launch counts by label."""
    k = WIDE_K
    Ynan = qgen_panel(seed, k)[0]
    model = dt.DynamicFactorModel(n_factors=k, dynamics="ar1")
    backend = dt.TorchBackend(filter="pit_qr")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    fused = dt.fit(model, Ynan[:SESSION_T0], backend=backend, fused=True,
                   max_iters=QGEN_ITERS, tol=0.0)
    wall = time.perf_counter() - t0
    launches = {nm: v for nm, v in kernels.LAUNCHES.items() if v}
    emit({"fused_fit": f"k{k} pit_qr", "filter": fused.filter,
          "n_iters": fused.n_iters, "converged": fused.converged,
          "host_reads": fused.host_reads, "wall_s": wall,
          "loglik_last": float(fused.logliks[-1]), "launches": launches})
    if (fused.filter != "pit_qr" or not np.isfinite(fused.logliks).all()
            or launches.get("qr_scan") or launches.get("qr_elements")
            or launches.get("qr_scan_gen", 0) < 2 * fused.n_iters):
        raise AssertionError(f"k = {k} pit_qr fused fit failed: "
                             f"{fused.filter}, launches {launches}")
    sess = dt.open_session(fused, Ynan[:SESSION_T0], backend=backend,
                           capacity=1000, max_update_rows=8, max_iters=5,
                           tol=0.0)
    drive_session(sess, f"pit_qr k{k}", Ynan, "pit_qr", "qr_scan_gen",
                  queries=KBIG_SESSION_QUERIES)
    counts = {f"pit_qr k{k} session": dict(kernels.LAUNCHES)}
    sess.close()
    if counts[f"pit_qr k{k} session"].get("qr_scan"):
        raise AssertionError(f"pit_qr k{k} session launched the k <= 10 "
                             "scan kernel")
    return counts


# A small pit_qr fleet past 10: two tenants (T0, N, k), each lane the lone
# square-root engine at the bucket's k.
QGEN_FLEET_SHAPES = ((100, 300, 12), (90, 250, 14))
QGEN_FLEET_DRAINS, QGEN_FLEET_CAP = 2, 120


def qgen_fleet_phase(seed: int) -> dict:
    """A pit_qr fleet bucket of two tenants past k = 10
    (``QGEN_FLEET_SHAPES``: k = 12 and 14, padded to 14), 2 drains of
    FLEET_ROWS rows, beside lone pit_qr sessions on the same queries: in
    f64 every lane equals its lone session within 1e-9 relative; in f32
    (the card's default) finite outputs.  Each drain one K13b, one read,
    qr_scan_gen and no k <= 10 square-root kernel nor K4b.  Returns the f32
    drains' launch counts."""
    held = QGEN_FLEET_DRAINS * FLEET_ROWS
    tenants = fleet_tenants(seed + 1700, QGEN_FLEET_SHAPES, held)
    kw = dict(capacity=QGEN_FLEET_CAP, max_update_rows=FLEET_ROWS,
              max_iters=FLEET_ITERS, tol=0.0, filter="pit_qr")
    rec = {"fleet": "pit_qr k14", "B": 2, "drains": QGEN_FLEET_DRAINS,
           "sync_checked": True}
    fields = lambda u: {"nowcast": u.nowcast, "factors": u.factors,  # noqa: E731
                        "forecast y": u.forecasts["y"]}
    last = {}
    for dtype in (torch.float64, torch.float32):
        backend = dt.TorchBackend(dtype=dtype, filter="info")
        fleet = dt.open_fleet([t[0] for t in tenants],
                              [t[1] for t in tenants], max_classes=1,
                              backend=backend, **kw)
        fleet.check_sync = True
        lone = [dt.open_session(t[0], t[1], backend=backend, **kw)
                for t in tenants]
        walls, errs = [], {}
        for d in range(QGEN_FLEET_DRAINS):
            lo = d * FLEET_ROWS
            for i, t in enumerate(tenants):
                fleet.submit(f"t{i}", t[2][lo:lo + FLEET_ROWS])
            out, wall, launches, reads = drain_timed(fleet)
            check_fleet_out("pit_qr k14", out,
                            {f"t{i}": s[1] for i, s in
                             enumerate(QGEN_FLEET_SHAPES)})
            if (launches["batched_ring_append"] != 1 or reads != 1
                    or launches["qr_scan_gen"] < 1 or launches["qr_scan"]
                    or launches["info_scan"]
                    or launches["batched_info_scan"]):
                raise AssertionError(f"pit_qr fleet drain {d}: launches "
                                     f"{launches}, reads {reads}")
            last = launches
            walls.append(wall)
            for i, t in enumerate(tenants):
                u = out[f"t{i}"][0]
                ref = lone[i].update(t[2][lo:lo + FLEET_ROWS])
                fu, fr = fields(u), fields(ref)
                e = errs.setdefault("fleet_vs_lone", {})
                for f in fu:
                    if not np.isfinite(fu[f]).all():
                        raise AssertionError(f"pit_qr fleet lane {i} "
                                             f"({dtype}): non-finite {f}")
                    e[f] = max(e.get(f, 0.0), rel_err(fu[f], fr[f]))
        rec[str(dtype)[6:]] = {"tick_p50_ms": pct(walls, 50) * 1e3,
                               "ticks_ms": [w * 1e3 for w in walls],
                               "max_rel_err": errs}
        for s_ in lone:
            s_.close()
        fleet.close()
    rec["float64"]["tol"] = 1e-9
    emit(rec)
    bad = {f: e for f, e in rec["float64"]["max_rel_err"]["fleet_vs_lone"]
           .items() if not e <= 1e-9}
    if bad:
        raise AssertionError(f"pit_qr fleet (f64) off its lone sessions: "
                             f"{bad}")
    return {"fleet pit_qr k14": last}


def qgen_reference_phase(seed: int) -> None:
    """``fit(filter="pit_qr")`` at 120 x 80, k = 40, masked (scattered
    missing values, a ragged edge, one series observed at its first step
    alone), 5 iterations (the CPU's f64 twins take most of the phase),
    card f64 against CPU f64 within 1e-12."""
    k = SGEN_REF_K
    _, W, Yfull, _ = panel(seed + KBIG_SEED + k + 100, T_=120, N_=80, K_=k)
    W[:, 5] = 0.0
    W[0, 5] = 1.0
    reference_fit("k40 masked pit_qr", np.where(W > 0, Yfull, np.nan), k,
                  "pit_qr", 1e-12, iters=5)


# ---------------------------------------------------------------------------
# The time-varying-loadings family past k = 16 (tgen): K2-tv and K1-tv's
# wide and generic kernels, K11-fwd and K11-bwd's generic ones, on S4's
# panel (5,000 series x 300 steps) at k = 25 and 50.
# ---------------------------------------------------------------------------

TGEN_KS = (25, 50)
# Series of the kernel-vs-twin comparison a k: at k = 50 each (T, N, k, k)
# array is 15 GB in f32 at 5,000 series, and the plain twins hold copies of
# their own, so the pair is held there on 1,000 series (the kernels are
# also timed alone on all 5,000).
TGEN_TWIN_N = {25: TVL_N, 50: 1000}
TGEN_SWEEP = (17, 24, 32, 33, 64, 100, 128)
TGEN_SWEEP_SHAPE = (120, 400)
TGEN_SWEEP_TIMED = (100, 128)
# K11-bwd-gen's workspace held to TGEN_SLOTS series at these k (where its
# rule gives one: f32 past 119, f64 past 83), so each block loops over
# two or three of the sweep's 400 series.
TGEN_SLOTS_KS, TGEN_SLOTS = (100, 128), 150
TGEN_FITS = ((25, 12), (50, 10))
TGEN_REF = ((80, 20, 3), (90, 40, 2))    # (N, k, rounds) at T = 60


def tgen_tvl_cases(pan, dtype) -> list:
    """``tvl_cases`` of a ``tvl_panel`` in ``dtype``: unmasked (the
    kernels' mask-free branches; K11-bwd, which has no mask and whose plain
    twin takes seconds at S4, left out) and masked."""
    Yz, Wt, Yf, Ft, Lt, pt = tvl_inputs(pan, dtype)
    return (tvl_cases(Yf, None, Ft, Lt, pt, "unmasked", False)
            + tvl_cases(Yz, Wt, Ft, Lt, pt, "masked"))


def tgen_time_alone(c: dict, dtype) -> dict:
    """A case's kernel timed with no twin (warm and cold L2) beside its
    bound from the inputs and one call's outputs."""
    out = as_tuple(c["run"]())
    torch.cuda.synchronize()
    for x in out:
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{c['name']} ({c['variant']}): non-finite "
                                 "kernel output")
    bound_ms, bound_by = bound(nbytes_of(c["ins"]) + nbytes_of(out),
                               c["flops"], dtype)
    del out
    return {"name": c["name"], "variant": c["variant"],
            "dtype": str(dtype).replace("torch.", ""),
            "kernel_ms": cuda_ms(c["run"], warm=False),
            "kernel_ms_cold_l2": cuda_ms_cold(c["run"], 1, False),
            "bound_ms": bound_ms, "bound_by": bound_by}


def tgen_kernel_phase(seed: int) -> dict:
    """The four TVL kernels past 16 against their plain twins on S4's
    panel at k = 25 and 50 (``TGEN_TWIN_N`` series), unmasked and masked
    (``tgen_tvl_cases``), f64 then f32 (the TOL rule; the masked f32
    records timed warm and cold beside the twin, the library yardstick and
    the bound); at k = 50 then each kernel timed alone on all 5,000
    series, masked.  Returns the masked f32 records of the wide kernels
    and of K11's at k = 25, of the generic K2-tv and K1-tv at k = 50."""
    summary = {}
    for k in TGEN_KS:
        N_ = TGEN_TWIN_N[k]
        pan = (tvl_s4_panel(seed + 1700 + k, k) if N_ == TVL_N
               else tvl_panel(seed + 1700 + k, N_=N_, K_=k))
        refs = {}
        for dtype in (torch.float64, torch.float32):
            with highest_precision():
                for c in tgen_tvl_cases(pan, dtype):
                    timed = (dtype == torch.float32
                             and c["variant"] == "masked")
                    rec = kernel_record(c, dtype, refs, timed)
                    rec.update({"T": TVL_T, "N": N_, "k": k})
                    emit(rec)
                    if timed and c["name"] not in summary:
                        summary[c["name"]] = rec
            torch.cuda.empty_cache()
        del pan, refs
        torch.cuda.empty_cache()
        if N_ == TVL_N:
            continue
        pan = tvl_s4_panel(seed + 1700 + k, k)
        Yz, Wt, Yf, Ft, Lt, pt = tvl_inputs(pan, torch.float32)
        del pan
        with highest_precision():
            cs = tvl_cases(Yz, Wt, Ft, Lt, pt, "masked", smoother=False)
            for c in cs:
                rec = tgen_time_alone(c, torch.float32)
                rec.update({"T": TVL_T, "N": TVL_N, "k": k})
                emit(rec)
            del cs
            torch.cuda.empty_cache()
            # K11-bwd on the kernel's own forward pass.
            lam_f, P_f = tv.loading_filter(Yz, Ft, pt.Lam0, pt.tau2, pt.R,
                                           Wt)
            c = case(kernels.route("loading_smoother", k), "masked",
                     lambda: tv.loading_smoother(lam_f, P_f, pt.tau2), None,
                     (lam_f, P_f, pt.tau2),
                     (TVL_T - 1) * TVL_N * k11_bwd_flops(k))
            rec = tgen_time_alone(c, torch.float32)
            rec.update({"T": TVL_T, "N": TVL_N, "k": k})
            emit(rec)
            del lam_f, P_f, c
        del Yz, Wt, Yf, Ft, Lt, pt
        torch.cuda.empty_cache()
    return summary


def tgen_raise_calls(k: int) -> dict:
    """Every TVL entry point called at k on card tensors of zeros (T = 4,
    N = 6)."""
    z = dict(dtype=torch.float32, device="cuda")
    T_, N_ = 4, 6
    Y, L = torch.zeros((T_, N_), **z), torch.zeros((T_, N_, k), **z)
    F, v = torch.zeros((T_, k), **z), torch.ones(N_, **z)
    P = torch.zeros((T_, N_, k, k), **z)
    pt = tv.TVLParams(L[0], v, torch.eye(k, **z), torch.eye(k, **z), v,
                      torch.zeros(k, **z), torch.eye(k, **z))
    spec = dt.TVLSpec(n_factors=k)
    return {"obs_stats_tv": lambda: tv.obs_stats_tv(Y, L, v),
            "quad_local_tv": lambda: tv.quad_local_tv(Y, L, v, F),
            "loading_filter": lambda: tv.loading_filter(Y, F, L[0], v, v),
            "loading_smoother": lambda: tv.loading_smoother(L, P, v),
            "factor_pass_tv": lambda: tv.factor_pass_tv(Y, L, pt),
            "loading_pass": lambda: tv.loading_pass(Y, F, pt),
            "tvl_round_core": lambda: tv.tvl_round_core(Y, None, L, pt,
                                                        spec),
            "tvl_round_scan": lambda: tv.tvl_round_scan(Y, None, L, pt,
                                                        spec, False, 1),
            "tvl_loglik_eval": lambda: tv.tvl_loglik_eval(Y, L, pt)}


def tgen_k_sweep(seed: int) -> None:
    """The four TVL kernels through their wrappers at k in TGEN_SWEEP on
    TGEN_SWEEP_SHAPE panels with a fully missing step and a never-observed
    series: masked and unmasked (K11-bwd, which has no mask, once), f64
    and f32, and at k in TGEN_SLOTS_KS K11-bwd-gen on a workspace of
    TGEN_SLOTS series (``tvl_cases``' ``slots``); only the routed kernels
    may launch.  At k in TGEN_SWEEP_TIMED the f32 masked records are timed
    (``kernel_record``).
    Then k = 129 must raise NotImplementedError naming the ROADMAP row in
    every TVL entry point before any launch."""
    T_, N_ = TGEN_SWEEP_SHAPE
    for k in TGEN_SWEEP:
        t0 = time.perf_counter()
        pan = tvl_panel(seed + 1800 + k, T_=T_, N_=N_, K_=k)
        pan[1][7] = 0.0
        pan[1][:, 5] = 0.0
        refs, worst, recs = {}, {}, []
        kernels.reset_launches()
        for dtype in (torch.float64, torch.float32):
            Yz, Wt, Yf, Ft, Lt, pt = tvl_inputs(pan, dtype)
            with highest_precision():
                cases = (tvl_cases(Yz, Wt, Ft, Lt, pt, "masked", slots=(
                    TGEN_SLOTS if k in TGEN_SLOTS_KS else 0))
                         + tvl_cases(Yf, None, Ft, Lt, pt, "unmasked",
                                     smoother=False))
                for c in cases:
                    if (dtype == torch.float32 and k in TGEN_SWEEP_TIMED
                            and c["variant"] == "masked"):
                        rec = kernel_record(c, dtype, refs)
                        rec.update({"T": T_, "N": N_, "k": k})
                        recs.append(rec)
                        rel = rec["max_rel_err"]
                    else:
                        key = (c["name"], c["variant"])
                        _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                        refs[key] = ref
                    worst[f"{c['name']} {c['variant']} {str(dtype)[6:]}"] = rel
                del cases
            del Yz, Wt, Yf, Ft, Lt, pt
            torch.cuda.empty_cache()
        launched = {n: v for n, v in kernels.LAUNCHES.items() if v}
        for rec in recs:
            emit(rec)
        emit({"tgen_k_sweep": k, "shape": TGEN_SWEEP_SHAPE,
              "max_rel_err": worst, "launches": launched,
              "s": time.perf_counter() - t0})
        want = {kernels.route(n, k) for n in TVL_NEW}
        if set(launched) != want:
            raise AssertionError(f"tgen k = {k}: launched {launched}, "
                                 f"expected only {want}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    raised = {}
    calls = tgen_raise_calls(kernels.GEN_KMAX + 1)
    for name, fn in calls.items():
        try:
            fn()
        except NotImplementedError as e:
            raised[name] = kernels.GENERIC_K in str(e)
    launched = sum(kernels.LAUNCHES.values())
    emit({"tgen_k129_raised": raised, "launches": launched})
    if len(raised) != len(calls) or not all(raised.values()) or launched:
        raise AssertionError(f"k = 129: only {raised} raised, {launched} "
                             "launches")


def tgen_fit_phase(seed: int) -> dict:
    """``tvl_fit_phase`` at k = 25 (20 rounds) and k = 50 (10 rounds) on
    S4's panel: returns each fit's launch counts by label."""
    counts = {}
    for k, rounds in TGEN_FITS:
        counts.update(tvl_fit_phase(seed, k, rounds, f"tvl k{k}"))
        torch.cuda.empty_cache()
    return counts


def tgen_reference_phase(seed: int) -> None:
    """``tvl_reference_phase`` at 60 x 80, k = 20 (3 rounds) and 60 x 90,
    k = 40 (2 rounds: the CPU's f64 twins take ~3 s a round there),
    masked."""
    for N_, k, rounds in TGEN_REF:
        tvl_reference_phase(seed, N_, k, ("masked",), rounds)


# ---------------------------------------------------------------------------
# The stochastic-volatility family past k = 16 and past 1,024 particles
# (vgen): K10-fwd-gen and K10-ffbs-gen (csrc/sv_gen.cu) on S5's panel
# (10,000 series x 1,000 steps) simulated at k = 25 and 50 with M = 256,
# and on S5 itself (k = 5) at M = 2,048.
# ---------------------------------------------------------------------------

VGEN_FITS = ((25, SV_M, "sv k25 fit"), (50, SV_M, "sv k50 fit"),
             (SV_K, 2048, "sv M2048 fit"))
# Leading steps of a full-width pass the plain twins are held on (the twin
# is a Python loop of ~60 launches a step); the kernels are timed over all
# SV_T steps.
VGEN_WINDOW = 125
# (k, M) of the sweep on 60 x 300 panels: the generic kernels at every
# width (below 17 and 1,025 through their own entries, ``SV_ENTRY``), then
# past 1,024 particles, and one particle.
VGEN_SWEEP = ((1, 64), (16, 64), (17, 64), (24, 64), (32, 64), (33, 64),
              (64, 64), (100, 64), (128, 64), (5, 1025), (17, 1025),
              (5, 4096), (50, 1))
# (T, N, k, M) of the card-vs-CPU references.
VGEN_REF = ((60, 80, 20, 64), (60, 90, 40, 64), (60, 40, 3, 1100))


def vgen_fit_phase(seed: int) -> tuple:
    """Phase 88: ``sv_fit_phase`` for VGEN_FITS (k = 25 with the pass
    breakdown by the generic kernel's stages).  Returns (the launch counts
    by label, the fits by (k, M))."""
    counts, fits = {}, {}
    for k, M_, label in VGEN_FITS:
        c, fits[(k, M_)] = sv_fit_phase(seed, k, M_, label,
                                        breakdown=k == 25)
        counts.update(c)
        torch.cuda.empty_cache()
    return counts, fits


def vgen_kernel_phase(seed: int, fits: dict) -> dict:
    """Phase 89: K10-fwd-gen (residual form) and K10-ffbs-gen against their
    twins on each VGEN_FITS panel (as each fit saw it, at its params,
    sigma_h and h_0 center, the same draws): f64 and f32 on the first
    VGEN_WINDOW steps (``sv_compare``, ``ffbs_compare``, bit for bit on a
    rerun; the twin's comparison call is its time on the window), K10-fwd
    timed in f32 on the window (beside the twin, the yardstick and the
    bound) and over all SV_T steps, K10-ffbs over all SV_T steps beside its
    twin (``vgen_time``); at k = 25 the expanded form on the first
    SV_EXPANDED_T steps, f64 and f32, untimed.  Returns the k = 25 f32
    records by kernel name."""
    summary = {}
    for k, M_, label in VGEN_FITS:
        fit = fits[(k, M_)]
        Y, _ = sv_panel(seed + 1101, K_=k)
        Yz = fit.standardizer.transform(Y)
        spec = dt.SVSpec(n_factors=k, n_particles=M_)
        fd, bd = sv_draws64(SV_T, spec, seed + 1903 + k)
        W_ = VGEN_WINDOW
        win = (sv.SVDraws(fd.h0, fd.xi[:W_], fd.u[:W_]),
               sv.FFBSDraws(bd.g_last, bd.g[:W_ - 1]))
        tag = f"S5 k{k} M{M_}"
        for dtype in (torch.float64, torch.float32):
            recs = sv_kernel_cases(Yz[:W_], fit.params, fit.sigma_h,
                                   fit.h_center, spec, win, dtype,
                                   f"{tag} T={W_}", timed=False,
                                   forms=("residual",))
            if k == 25:
                E_ = SV_EXPANDED_T
                recs += sv_kernel_cases(
                    Yz[:E_], fit.params, fit.sigma_h, fit.h_center, spec,
                    (sv.SVDraws(fd.h0, fd.xi[:E_], fd.u[:E_]),
                     sv.FFBSDraws(bd.g_last, bd.g[:E_ - 1])), dtype,
                    f"{tag} T={SV_EXPANDED_T}", timed=False,
                    forms=("expanded",))
            if dtype == torch.float32:
                recs = vgen_time(recs, Yz, fit, spec, (fd, bd), W_)
            for rec in recs:
                rec.setdefault("plain_T", rec["T"])
                emit(rec)
                if (k == 25 and dtype == torch.float32
                        and rec["variant"] in (f"{tag} T={W_} residual",
                                               f"{tag} T={W_}")):
                    summary[rec["name"]] = rec
            torch.cuda.empty_cache()
    return summary


def vgen_time(recs: list, Yz, fit, spec, draws, window: int) -> list:
    """The f32 records of ``vgen_kernel_phase`` with the kernels timed
    (``sv_rbpf_timing``, ``sv_ffbs_timing``): K10-fwd on the twin's window
    (the record's numbers, beside the twin's time there) and over all the
    panel's steps (``full_T``); K10-ffbs (and its twin) over all the
    steps."""
    args, fd, bd = sv_args(Yz, fit.params, fit.sigma_h, fit.h_center, draws,
                           torch.float32)
    M_, k = fd.h0.shape
    fwd, bwd = (kernels.route_sv(n, k, M_) for n in ("sv_rbpf", "sv_ffbs"))
    wargs = (args[0][:window], *args[1:4], args[4][:window], *args[5:])
    wfd = sv.SVDraws(fd.h0, fd.xi[:window], fd.u[:window])
    with highest_precision():
        kern = sv_run(sv.rbpf_scan, wargs, wfd, spec, True, False)
        t_win = sv_rbpf_timing(fwd, wargs, wfd, spec, True, kern,
                               torch.float32)
        hist = sv_run(sv.rbpf_scan, args, fd, spec, True)
        t_full = sv_rbpf_timing(fwd, args, fd, spec, True, hist,
                                torch.float32)
        t_bwd = sv_ffbs_timing(bwd, hist, args[9], bd, torch.float32)
    del hist, kern
    out = []
    for rec in recs:
        if rec["name"] == fwd and rec["variant"].endswith("residual"):
            rec = {**rec, **t_win, "full_T": {"T": SV_T, **t_full}}
        elif rec["name"] != fwd:
            rec = {**rec, **t_bwd, "T_timed": SV_T, "plain_T": SV_T}
        out.append(rec)
    return out


def vgen_k_sweep(seed: int) -> None:
    """Phase 90: the generic kernels at (k, M) in VGEN_SWEEP on 60 x 300
    panels (the DGP's params, sigma_h 0.1), f64 and f32, both forms and
    FFBS (S = 16), through their own entries (``sv.rbpf_scan_gen``,
    ``sv.ffbs_gen``, so below k = 17 and M = 1,025 too): only the generic
    kernels may launch; then ``sv_k129_raises``."""
    for i, (k, M_) in enumerate(VGEN_SWEEP):
        t0 = time.perf_counter()
        Y, p = sv_panel(seed + 1920 + i, T_=60, N_=300, K_=k)
        spec = dt.SVSpec(n_factors=k, n_particles=M_, n_smooth_draws=16)
        draws = sv_draws64(60, spec, seed + 1940 + i)
        worst = {}
        kernels.reset_launches()
        for dtype in (torch.float64, torch.float32):
            for rec in sv_kernel_cases(Y, p, np.full(k, 0.1), np.zeros(k),
                                       spec, draws, dtype, f"k{k} M{M_}",
                                       timed=False, generic=True):
                worst[f"{rec['variant']} {rec['dtype']}"] = {
                    x: rec.get(x) for x in ("max_rel_err", "first_split",
                                            "split_kind", "flips")
                    if rec.get(x) is not None}
        launched = {n: v for n, v in kernels.LAUNCHES.items() if v}
        emit({"vgen_k_sweep": [k, M_], "checks": worst,
              "launches": launched, "s": time.perf_counter() - t0})
        if set(launched) != {"sv_rbpf_gen", "sv_ffbs_gen"}:
            raise AssertionError(f"vgen (k, M) = ({k}, {M_}): launched "
                                 f"{launched}")
    sv_k129_raises(seed)


def vgen_reference_phase(seed: int) -> None:
    """Phase 91: ``sv_reference_phase`` at VGEN_REF: card f64 against CPU
    f64 within 1e-9 at k = 20 and 40 (M = 64) and at k = 3 with M =
    1,100, one particle-EM iteration and the final E-step (the CPU's f64
    twins take most of the phase)."""
    for T_, N_, k, M_ in VGEN_REF:
        sv_reference_phase(seed, T_, N_, k, M_, sv_iters=1)


# ---------------------------------------------------------------------------
# The rank-r engine past k = 100 and r = 32, and the dense engine past N =
# 32 (K9-basis-gen, K9-fwd-gen, K9-bwd-gen, K15-gen: csrc/gen_filters.cu),
# to the generic tier's end, 128.
# ---------------------------------------------------------------------------

LGEN_K = 128                  # the tier's end
LGEN_SEED = 1900              # the k = 128 panel: seed + LGEN_SEED + k
LGEN_ITERS = 10
LGEN_FITS = (
    ("k128 masked lowrank r8", LGEN_K, True, "lowrank", "lowrank",
     {"rank": 8}),
    ("k128 unmasked lowrank r8", LGEN_K, False, "lowrank", "lowrank",
     {"rank": 8}),
    ("k128 masked lowrank r64", LGEN_K, True, "lowrank", "lowrank",
     {"rank": 64}),
)
LGEN_RANKS = (8, 64, 128)     # the kernels at k = 128, timed
# (k, r) of the sweep on LGEN_SWEEP_SHAPE panels: past k = 100, past r =
# 32, the tier's ends, and r = k below 100.
LGEN_SWEEP = ((101, 8), (110, 33), (128, 32), (128, 128), (40, 40))
LGEN_SWEEP_SHAPE = (120, 400)
LGEN_EXACT_KS = (110, 128)    # rank = k against info, f64
# The JAX package's own |loglik(lowrank, r = k) - loglik(info)| /
# |loglik(info)| on the same inputs (``tools/port/lowrank_exact.py``, a
# CPU run at x64).
LGEN_EXACT_JAX = {110: 6.805855679799775e-12, 128: 7.155515087890136e-12}
# The JAX package's own figure of the contract at k = 128, rank 64 on the
# same inputs (``tools/port/lowrank_contract.py``, a CPU run at x64): it
# misses 1e-5, so the port is held to it (ROADMAP Queue 3 "Watch").
LGEN_CONTRACT_JAX = 1.4960750186123512e-05
LGEN_SESSION_ITERS, LGEN_SESSION_QUERIES, LGEN_SESSION_RANK = 8, 3, 64
# EM iterations a query of that session (5 elsewhere): a rank-64 query at
# capacity 1,000 takes ~1.4 s an iteration on the card.
LGEN_QUERY_ITERS = 2
# (T0, N, k): a 300-series tenant at k = 110 and a 250-series one at k =
# 104, with 160 / 150 rows: at T0 near k the tenants' fits leave R at its
# 1e-6 floor (110 factors span nearly all of a 120-row panel) and
# Lam'R^{-1}Lam at |.|_F ~ 2e9, where a blocked and an unblocked Cholesky
# of the r x r S_t differ by ~1e-6 relative (``fit`` takes k <= min(T, N)
# anyway); at 160 rows R is ~1e-3 and |.|_F ~ 1e6.
LGEN_FLEET_SHAPES = ((160, 300, 110), (150, 250, 104))
LGEN_FLEET_CAP = 180
LGEN_FLEET_RANK = 40
LGEN_FLEET_TICKS = ((1, 3), (2, 0), (3, 2))
# The MF lowrank route at m = 5k > 100: 100 monthly and 20 quarterly
# series x 60 quarters (120 >= 4k series), k = 21, rank 5.
LGEN_MF = (100, 20, 180, 21, 5)
LGEN_NEW = ("lowrank_basis_gen", "lowrank_scan_gen", "lowrank_smoother_gen")

DGEN_NS = (64, 128)           # the masked headline panel's first N series
DGEN_ITERS = 20
DGEN_SESSION_QUERIES = 3
DGEN_SWEEP = ((33, 10), (64, 33), (100, 64), (128, 128), (40, 100))
DGEN_REF = ((120, 40, 3), (100, 64, 36))       # (T, N, k)


def lgen_cases(Y, W, p, r: int, label: str) -> list:
    """``lowrank_cases`` under the generic kernels' names (each wrapper
    routes there at these (k, r))."""
    cases = lowrank_cases(Y, W, p, r, label)
    k = p.A.shape[-1]
    for c in cases:
        c["name"] = kernels.route_lowrank(c["name"], k, r)
    return cases


def lgen_kernel_phase(seed: int) -> dict:
    """K9-basis-gen (on its projector), K9-fwd-gen and K9-bwd-gen at the
    full width (T = 500, N = 10,000, k = 128) at r = 8, 64 and 128, on the
    masked panel the fits run, f64 then f32, each against its plain twin
    (the TOL rule) and timed (f32) beside the twin, the bound,
    ``torch.linalg.eigh`` (K9-basis-gen) and K4's latency floor at (T,
    k).  Returns the f32 records at r = 8 by name."""
    Ynan, W, _, p = panel(seed + LGEN_SEED + LGEN_K, K_=LGEN_K)
    summary, refs = {}, {}
    for dtype in (torch.float64, torch.float32):
        Yt, mt = (torch.as_tensor(a, dtype=dtype, device="cuda")
                  .contiguous() for a in (Ynan, W))
        pt = SSMParams.from_numpy(p, dtype=dtype, device="cuda")
        with highest_precision():
            for r in LGEN_RANKS:
                for c in lgen_cases(Yt, mt, pt, r, f"masked r{r}"):
                    if c["name"] != "lowrank_basis_gen":
                        c["floor"] = functools.partial(
                            latency_ms, "info_scan"
                            if c["name"] == "lowrank_scan_gen"
                            else "rts_smoother", dtype, LGEN_K)
                    rec = kernel_record(c, dtype, refs)
                    rec.update({"k": LGEN_K, "r": r})
                    emit(rec)
                    if dtype == torch.float32 and r == LGEN_RANKS[0]:
                        summary[c["name"]] = rec
        del Yt, mt
        torch.cuda.empty_cache()
    return summary


def lgen_raise_calls(k: int, r: int) -> dict:
    """The three K9 entry points called at (k, r) on card tensors of zeros
    (B = 1, T = 4)."""
    def z(*shape):
        return torch.zeros(shape, device="cuda")
    return {
        "lowrank_basis": lambda: lr.lowrank_basis(z(1, k, k), r),
        "lowrank_scan": lambda: lr.lowrank_scan(
            z(1, 4, k), z(1, k, k), z(1, k, r), z(1, k, k), z(1, k, k),
            z(1, k), z(1, k, k)),
        "lowrank_smoother": lambda: lr.lowrank_smoother_scan(
            z(1, 4, k), z(1, 4, k, k), z(1, 4, k), z(1, 4, k, k),
            z(1, k, k), z(1, k, r)),
    }


def lgen_k_sweep(seed: int) -> None:
    """The K9 trio through its wrappers at (k, r) in LGEN_SWEEP on 120 x
    400 panels with a fully missing step and a step observing 2r series
    (fewer than k where 2r < k), masked and unmasked, f64 and f32 (error
    checks; each case must route to the generic kernels); then k = 129
    (r = 8 and r = 129) must raise NotImplementedError naming the ROADMAP
    row in every entry point before any launch, and r > k ValueError."""
    T_, N_ = LGEN_SWEEP_SHAPE
    for k, r in LGEN_SWEEP:
        _, W, Yfull, p = panel(seed + LGEN_SEED + 10 + k + r, T_=T_, N_=N_,
                               K_=k)
        W[7] = 0.0
        W[11] = 0.0
        W[11, :2 * r] = 1.0
        Ynan = np.where(W > 0, Yfull, np.nan)
        refs, worst = {}, {}
        for dtype in (torch.float64, torch.float32):
            Yt, mt, Yf = (torch.as_tensor(a, dtype=dtype, device="cuda")
                          .contiguous() for a in (Ynan, W, Yfull))
            pt = SSMParams.from_numpy(p, dtype=dtype, device="cuda")
            with highest_precision():
                for c in (lgen_cases(Yt, mt, pt, r, "masked")
                          + lgen_cases(Yf, None, pt, r, "unmasked")):
                    n0 = kernels.LAUNCHES[c["name"]]
                    key = (c["name"], c["variant"])
                    _, rel, _, ref, _ = compare(c, dtype, refs.get(key))
                    if kernels.LAUNCHES[c["name"]] == n0:
                        raise AssertionError(f"{c['name']} at (k, r) = "
                                             f"({k}, {r}) did not launch")
                    refs[key] = ref
                    worst[f"{c['name']} {c['variant']} "
                          f"{str(dtype)[6:]}"] = rel
        emit({"lgen_k_sweep": [k, r], "max_rel_err": worst})
    torch.cuda.synchronize()
    kernels.reset_launches()
    raised, value_errors = [], []
    for k, r in ((kernels.GEN_KMAX + 1, 8),
                 (kernels.GEN_KMAX + 1, kernels.GEN_KMAX + 1)):
        for name, fn in lgen_raise_calls(k, r).items():
            try:
                fn()
            except NotImplementedError as e:
                if kernels.GENERIC_K in str(e):
                    raised.append(f"{name} ({k}, {r})")
    for name, fn in lgen_raise_calls(40, 41).items():
        try:
            fn()
        except ValueError:
            value_errors.append(name)
    launched = sum(kernels.LAUNCHES.values())
    emit({"lgen_k129_raised": raised, "r_above_k_value_error": value_errors,
          "launches": launched})
    if len(raised) != 6 or len(value_errors) != 3 or launched:
        raise AssertionError(f"K9 past 128: raised {raised}, r > k "
                             f"{value_errors}, {launched} launches")


def lgen_exact_phase(seed: int) -> None:
    """Lowrank at rank = k is the exact filter: on the card in f64, the
    loglik of ``lowrank_filter(rank=k)`` against ``info_filter`` at the
    same params, at k = 110 and 128 on 120 x 400 masked panels, within
    1e-9 relative or the JAX package's own figure at the same inputs
    (``LGEN_EXACT_JAX``), whichever is larger."""
    T_, N_ = LGEN_SWEEP_SHAPE
    rec = {}
    for k in LGEN_EXACT_KS:
        Ynan, W, _, p = panel(seed + LGEN_SEED + 20 + k, T_=T_, N_=N_, K_=k)
        dev = torch.device("cuda")
        Yt = torch.as_tensor(np.nan_to_num(Ynan), dtype=torch.float64,
                             device=dev)
        mt = torch.as_tensor(W, dtype=torch.float64, device=dev)
        pt = SSMParams.from_numpy(p, dtype=torch.float64, device=dev)
        kernels.reset_launches()
        with highest_precision():
            ll_lr = float(lr.lowrank_filter(Yt, pt, mask=mt, rank=k).loglik)
            ll_info = float(inf.info_filter(Yt, pt, mask=mt).loglik)
        gap = abs(ll_lr - ll_info) / abs(ll_info)
        jax_gap = LGEN_EXACT_JAX.get(k)
        limit = max(1e-9, jax_gap or 0.0)
        rec[k] = {"loglik_lowrank": ll_lr, "loglik_info": ll_info,
                  "rel_gap": gap, "jax_rel_gap": jax_gap, "limit": limit,
                  "lowrank_scan_gen": kernels.LAUNCHES["lowrank_scan_gen"]}
        if not gap <= limit or not kernels.LAUNCHES["lowrank_scan_gen"]:
            raise AssertionError(f"lowrank at rank = k = {k}: loglik gap "
                                 f"{gap:.3e} to info (limit {limit:.1e})")
    emit({"lgen_exact": rec, "shape": [T_, N_]})


def lgen_session_phase(seed: int) -> dict:
    """A lowrank fused fit at k = 128, rank 64, on the masked panel's first
    480 rows (LGEN_SESSION_ITERS iterations, tol = 0, f32), then a session
    on it at capacity 1,000 with 3 queries of 2 rows and a re-forecast:
    one read a query under ``set_sync_debug_mode("error")``, K13 and
    K9-fwd-gen every query, no k <= 32 kernel.  Rank 64: at rank 8 (and
    32) the 480-row fused fit stops as diverged (EM at r < k is not
    monotone) and a session opened on it gives a non-finite DI forecast
    (CPU f32 at N = 1,500).  Returns the launch counts."""
    Ynan = panel(seed + LGEN_SEED + LGEN_K, K_=LGEN_K)[0]
    model = dt.DynamicFactorModel(n_factors=LGEN_K, dynamics="ar1")
    backend = dt.TorchBackend(filter="lowrank", rank=LGEN_SESSION_RANK)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    fused = dt.fit(model, Ynan[:SESSION_T0], backend=backend, fused=True,
                   max_iters=LGEN_SESSION_ITERS, tol=0.0)
    wall = time.perf_counter() - t0
    launches = {nm: v for nm, v in kernels.LAUNCHES.items() if v}
    emit({"fused_fit": f"k{LGEN_K} lowrank", "filter": fused.filter,
          "n_iters": fused.n_iters, "host_reads": fused.host_reads,
          "diverged": fused.nowcast is None, "wall_s": wall,
          "loglik_last": float(fused.logliks[-1]), "launches": launches})
    narrow = narrow_launched(launches) + [n for n in LOWRANK
                                          if n in launches]
    if (fused.filter != "lowrank" or not np.isfinite(fused.logliks).all()
            or narrow or any(launches.get(n, 0) < 1 for n in LGEN_NEW)):
        raise AssertionError(f"k = {LGEN_K} lowrank fused fit failed: "
                             f"{fused.filter}, launches {launches}")
    sess = dt.open_session(fused, Ynan[:SESSION_T0], backend=backend,
                           capacity=1000, max_update_rows=8,
                           max_iters=LGEN_QUERY_ITERS, tol=0.0)
    drive_session(sess, f"lowrank k{LGEN_K}", Ynan, "lowrank",
                  "lowrank_scan_gen", queries=LGEN_SESSION_QUERIES)
    counts = {f"lowrank k{LGEN_K} session": dict(kernels.LAUNCHES)}
    narrow = narrow_launched(counts[f"lowrank k{LGEN_K} session"])
    sess.close()
    if narrow:
        raise AssertionError(f"lowrank k = {LGEN_K} session ran {narrow}")
    return counts


def lgen_fleet_phase(seed: int) -> None:
    """A lowrank fleet of a 300-series tenant at k = 110 (160 rows) and a
    250-series tenant at k = 104 (150 rows), rank 40, 3 ticks (EM at r < k
    is not monotone: the values are held on the ticks before a lane's
    first divergence): card f64 against CPU f64 within
    1e-12 (the DI forecast DI_REF_TOL), the card run through the generic
    K9 kernels (``fleet_reference_phase``)."""
    fleet_reference_phase(seed + LGEN_SEED + 30, LGEN_FLEET_SHAPES,
                          LGEN_FLEET_TICKS, capacity=LGEN_FLEET_CAP,
                          flt="lowrank", rank=LGEN_FLEET_RANK,
                          to_divergence=True)


def lgen_mf_phase(seed: int) -> None:
    """The mixed-frequency lowrank route at m = 105: ``fit(MixedFreqSpec(
    100, 20, 21, time_scan="lowrank", rank=5))`` on a 180-month panel (a
    fully missing step, a never-observed monthly series), 4 iterations,
    tol = 0, chunks of 2, card f64 against CPU f64 within 1e-9 (logliks,
    params, nowcast, factors, state_T, forecast); the card fit must launch
    the generic K9 trio and no k <= 100 kernel of it."""
    nm, nq, T_, k, rank = LGEN_MF
    Y, W = mf_panel(seed + LGEN_SEED + 40, nm=nm, nq=nq, T_=T_, k=k)
    W[17] = 0.0
    W[:, 2] = 0.0
    Y = np.where(W > 0, Y, np.nan)
    spec = mf_spec("lowrank", nm=nm, nq=nq, k=k, rank=rank)
    res = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launches()
        r = dt.fit(spec, Y, mask=W, max_iters=4, tol=0.0,
                   backend=dt.TorchBackend(device=dev, dtype=torch.float64,
                                           fused_chunk=2))
        res[dev] = (r, dt.forecast(r, 12)[0], dict(kernels.LAUNCHES))
    (rg, yg, lg), (rc, yc, _) = res["cuda"], res["cpu"]
    pairs = [("logliks", rg.logliks, rc.logliks),
             ("nowcast", rg.nowcast, rc.nowcast),
             ("factors", rg.factors, rc.factors),
             ("state_T", rg.state_T, rc.state_T), ("y_fore", yg, yc)]
    pairs += [(f, getattr(rg.params, f), getattr(rc.params, f))
              for f in mf.MFParams._fields if f != "mu0"]
    errs = {name: rel_err(g, c) for name, g, c in pairs}
    emit({"reference": "mf lowrank", "shape": [T_, nm + nq, k], "m": 5 * k,
          "rank": rank, "max_rel_err": errs, "tol": 1e-9,
          "launches": {n: v for n, v in lg.items() if v}})
    if (any(lg[n] == 0 for n in LGEN_NEW) or any(lg[n] for n in LOWRANK)
            or len(rg.logliks) != len(rc.logliks)):
        raise AssertionError(f"mf lowrank at m = {5 * k}: launches {lg}")
    bad = {n: e for n, e in errs.items() if not e <= 1e-9}
    if bad:
        raise AssertionError(f"mf lowrank card fit disagrees: {bad}")


def dgen_case(Yt, mt, pt, label: str) -> dict:
    """``dense_case`` under K15-gen's name, its floor K4's chain."""
    c = dense_case(Yt, mt, pt, label)
    c["name"] = kernels.route_dense("dense_filter", Yt.shape[1],
                                    pt.A.shape[0])
    return c


def dgen_kernel_phase(seed: int) -> dict:
    """K15-gen against its plain twin at (T, N, k) = (500, 128, 10) on the
    masked headline panel's first 128 series, f64 then f32 (the TOL rule),
    timed warm and cold beside the plain twin, the bound and K4's latency
    floor at (T, k).  Returns the f32 record."""
    Ynan, W, _, p = panel(seed + 1)
    N_ = DGEN_NS[-1]
    p = dataclasses.replace(p, Lam=p.Lam[:N_], R=p.R[:N_])
    summary, refs = {}, {}
    for dtype in (torch.float64, torch.float32):
        with highest_precision():
            Yt, mt, pt = dense_inputs(np.ascontiguousarray(Ynan[:, :N_]),
                                      np.ascontiguousarray(W[:, :N_]), p,
                                      dtype)
            rec = kernel_record(dgen_case(Yt, mt, pt, "masked"), dtype,
                                refs)
        rec["shape"] = [T, N_, K]
        emit(rec)
        if dtype == torch.float32:
            summary[rec["name"]] = rec
    return summary


def dgen_k_sweep(seed: int) -> None:
    """K15-gen at (N, k) in DGEN_SWEEP on 40-step panels with step 0 fully
    missing and a step observing fewer than k series, f64 and f32 (error
    checks; each case must launch K15-gen); the long-T point's (24, 2)
    must stay on K15's own kernel; then N = 129 and k = 129 must raise
    NotImplementedError naming the ROADMAP row before any launch."""
    worst = {}
    for N_, k in DGEN_SWEEP:
        _, W, Yfull, p = panel(seed + 1900 + N_ + k, T_=40, N_=N_, K_=k)
        W[0] = 0.0
        W[5] = 0.0
        W[5, :min(k, N_) - 1] = 1.0
        Ynan = np.where(W > 0, Yfull, np.nan)
        refs = {}
        for dtype in (torch.float64, torch.float32):
            with highest_precision():
                c = dgen_case(*dense_inputs(Ynan, W, p, dtype), "sweep")
                n0 = kernels.LAUNCHES["dense_filter_gen"]
                _, rel, _, ref, _ = compare(c, dtype, refs.get("k15"))
                if kernels.LAUNCHES["dense_filter_gen"] == n0:
                    raise AssertionError(f"K15-gen at ({N_}, {k}) did not "
                                         "launch")
            refs["k15"] = ref
            worst[f"N={N_} k={k} {str(dtype)[6:]}"] = rel
    longt = kernels.route_dense("dense_filter", LONGT_N, LONGT_K)
    torch.cuda.synchronize()
    kernels.reset_launches()
    raised = []
    for N_, k in ((kernels.GEN_KMAX + 1, 3), (3, kernels.GEN_KMAX + 1)):
        Yt = torch.zeros((5, N_), device="cuda")
        pt = SSMParams(*(torch.zeros(s, device="cuda") for s in
                         ((N_, k), (k, k), (k, k), (N_,), (k,), (k, k))))
        try:
            kalman_filter(Yt, pt)
        except NotImplementedError as e:
            if kernels.GENERIC_K in str(e):
                raised.append([N_, k])
    launched = sum(kernels.LAUNCHES.values())
    emit({"dgen_k_sweep": [list(x) for x in DGEN_SWEEP],
          "max_rel_err": worst, "raised": raised, "launches": launched,
          "long_t_route": longt})
    if len(raised) != 2 or launched or longt != "dense_filter":
        raise AssertionError(f"K15 past 128: only {raised} raised, "
                             f"{launched} launches; long-T route {longt}")


def dgen_fit_phase(seed: int) -> dict:
    """``fit(filter="dense")`` on the masked headline panel's first 64 and
    128 series at k = 10 (20 iterations, tol = 0, f32), the reporting
    smooth and a 12-step forecast: exactly ``dense_fit_launches`` under
    K15-gen's name, one read a chunk (+ the result's); then at N = 128
    ``fit(fused=True)`` on the first 480 rows and a dense session on it at
    capacity 1,000 (3 queries of 2 rows and a re-forecast, one read a
    query under the sync check, K15-gen every query).  Returns the launch
    counts by label."""
    Ynan, _, _, _ = panel(seed + 1)
    model = dt.DynamicFactorModel(n_factors=K, dynamics="ar1")
    backend = dt.TorchBackend(filter="dense")
    counts = {}
    for N_ in DGEN_NS:
        Yd = Ynan[:, :N_]
        torch.cuda.synchronize()
        kernels.reset_launches()
        with ReadWatch() as rw:
            t0 = time.perf_counter()
            res = dt.fit(model, Yd, backend=backend, max_iters=DGEN_ITERS,
                         tol=0.0)
            y_fore, _ = dt.forecast(res, 12)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        lls = res.logliks
        chunk = backend.fused_chunk
        steady = [h["secs"] for h in res.history[chunk:]]
        n_chunks = -(-DGEN_ITERS // chunk)
        floor = noise_floor_for(torch.float32, Yd.size)
        want = {("dense_filter_gen" if n == "dense_filter" else n): v
                for n, v in dense_fit_launches(DGEN_ITERS).items()}
        bad = {n: v for n, v in launches.items() if v != want.get(n, 0)}
        label = f"dense N{N_}"
        emit({"fit": label, "filter": res.filter, "shape": [T, N_, K],
              "n_iters": res.n_iters, "loglik_first": float(lls[0]),
              "loglik_last": float(lls[-1]),
              "max_drop": float(max(0.0, -np.diff(lls).min())),
              "noise_floor": floor, "wall_s": wall,
              "em_iters_per_sec": (len(steady) / sum(steady)
                                   if steady and sum(steady) > 0 else None),
              "reads": len(rw.stamps) + 1, "n_chunks": n_chunks,
              "launches": {n: v for n, v in launches.items() if v}})
        if (res.filter != "dense" or res.n_iters != DGEN_ITERS
                or not np.isfinite(lls).all() or np.diff(lls).min() < -floor
                or not np.isfinite(res.factors).all()
                or not np.isfinite(y_fore).all()
                or y_fore.shape != (12, N_)):
            raise AssertionError(f"{label} fit failed: {res.filter}, "
                                 f"{res.n_iters} iterations, logliks {lls}")
        if bad or len(rw.stamps) != n_chunks:
            raise AssertionError(f"{label} fit: launches off {want}: {bad}; "
                                 f"chunk reads {len(rw.stamps)} of "
                                 f"{n_chunks}")
        counts[label] = launches
    kernels.reset_launches()
    t0 = time.perf_counter()
    fused = dt.fit(model, Yd[:SESSION_T0], backend=backend, fused=True,
                   max_iters=DGEN_ITERS, tol=0.0)
    emit({"fused_fit": f"dense N{N_}", "filter": fused.filter,
          "n_iters": fused.n_iters, "host_reads": fused.host_reads,
          "wall_s": time.perf_counter() - t0,
          "loglik_last": float(fused.logliks[-1]),
          "launches": {n: v for n, v in kernels.LAUNCHES.items() if v}})
    if (fused.filter != "dense" or fused.n_iters != DGEN_ITERS
            or not np.isfinite(fused.logliks).all()
            or kernels.LAUNCHES["dense_filter_gen"] < DGEN_ITERS
            or kernels.LAUNCHES["dense_filter"]):
        raise AssertionError(f"dense N{N_} fused fit failed: "
                             f"{fused.filter}, {fused.n_iters} iterations")
    sess = dt.open_session(fused, Yd[:SESSION_T0], backend=backend,
                           capacity=1000, max_update_rows=8, max_iters=5,
                           tol=0.0)
    drive_session(sess, f"dense N{N_}", Yd, "dense", "dense_filter_gen",
                  queries=DGEN_SESSION_QUERIES)
    counts[f"dense N{N_} session"] = dict(kernels.LAUNCHES)
    sess.close()
    return counts


def dgen_reference_phase(seed: int) -> None:
    """``fit(filter="dense")`` at 120 x 40, k = 3 and 100 x 64, k = 36,
    masked, card f64 against CPU f64 within 1e-12, the card fit through
    K15-gen."""
    for T_, N_, k in DGEN_REF:
        Ynan, _, _, _ = panel(seed + 1950 + N_ + k, T_=T_, N_=N_, K_=k)
        reference_fit(f"dense {T_} x {N_} k{k}", Ynan, k, "dense", 1e-12,
                      own=("dense_filter_gen",))


# ------------------------------------------------ the associative scans --

# The four kernels, each by the k of the record the summary line keeps:
# its tier's full width.
ASSOC_NEW = {"pit_assoc": 10, "pit_assoc_gen": 100, "qr_assoc": 10,
             "qr_assoc_gen": 100}
# Every tier's full-width shape: k = 10 (the warp and one-thread kernels),
# 25 (the warp kernel at LD 33; K8-assoc's generic one), 50 and 100 (the
# generic kernels), on the masked headline panel simulated at k.
ASSOC_KS = (K, WIDE_K, 50, 100)
ASSOC_SWEEP_KS = (1, 2, 10, 11, 16, 17, 32, 33, 64, 128)
ASSOC_SWEEP_TS = (1, 2, 3, 64, 65, 257)
ASSOC_SWEEP_N = 150
ASSOC_PUBLIC_KS = (K, 100)
# f64 associative kernel against the blocked kernel of its tier, relative.
ASSOC_BLOCKED_TOL = 1e-10
# Card f64 against CPU f64 on a small panel, relative.
ASSOC_REF_TOL = 1e-12
# The JAX package's own loglik with scan_impl="associative" at
# assoc_public_phase's inputs (the default seed, the panel's true params),
# f32 and f64, and its |loglik - exact f64| / |exact f64|, by (k,
# engine): tools/port/assoc_loglik.py, a CPU run at x64.
ASSOC_LL_JAX = {
    (K, "pit"): {"loglik_f32": -6603445.950585705,
                 "loglik_f64": -6603446.446391153,
                 "f32": 7.508279178555282e-08, "f64": 3.8361746756326244e-14},
    (K, "pit_qr"): {"loglik_f32": -6603445.884635946,
                    "loglik_f64": -6603446.446390903,
                    "f32": 8.50699643902658e-08,
                    "f64": 4.231075009888924e-16},
    (100, "pit"): {"loglik_f32": -6805588.48956384,
                   "loglik_f64": -6805589.948544168,
                   "f32": 2.143793292390716e-07,
                   "f64": 3.7017034281865716e-13},
    (100, "pit_qr"): {"loglik_f32": -1388727.3292463394,
                      "loglik_f64": -6805048.250476308,
                      "f32": 0.795943137957654,
                      "f64": 7.959604816575791e-05}}
# The f32 loglik against the exact f64 one, relative.
ASSOC_LL_LIMIT = 1e-5
# Where the JAX package's own f32 loglik misses ASSOC_LL_LIMIT (ROADMAP
# Queue 3 "Watch"), the card's f32 loglik within this x |exact| of it:
# both run the same algorithm on the same inputs and part only by f32
# rounding (2.2e-5 apart at k = 100, on figures 0.796 from the exact
# one).
ASSOC_LL_JAX_MARGIN = 1e-4


def assoc_panel(seed: int, k: int):
    """The masked headline panel at k factors: the headline panel itself
    at k = 10, the wide group's at 25, kbig's at 50 and 100."""
    return panel(seed) if k == K else qgen_panel(seed, k)


def assoc_levels(T_: int) -> list:
    """Elements of each level of the associative scan's tree, level 0
    (T_) included."""
    return [T_] + pf._assoc_levels(T_)


def assoc_combines(T_: int) -> int:
    """Combines the tree of one associative scan of length T_ runs: the
    up-sweep's pair products and the down-sweep's even slots past 0.  The
    inclusive scan itself needs T_ - 1 (its bound counts those)."""
    n = assoc_levels(T_)
    return sum(n[1:]) + sum((m - 1) // 2 for m in n[:-1])


def assoc_flops(engine: str) -> tuple:
    """Operations a (filter, smoother) combine needs, in units of k^3,
    each symmetric result counted over one triangle (a k x k product 2,
    one with a symmetric result 1, an LU 2/3, an LU or Cholesky solve of
    k columns 2, a triangular solve 1, a Cholesky 1/3).  ``pit`` filter:
    D = I + C_i J_j, its LU, A_j D^-1, A, C (a product and one with a
    symmetric result), J (J_j A_i, its solve by D', a symmetric product):
    44/3; smoother: E, E_e L_l, the symmetric (E_e L_l) E_e': 5.
    ``pit_qr`` filter, with each tria the Cholesky of its Gram matrix:
    K8-gen's 6 products, a chol_solve and 2 triangular solves, the trias
    of [X | I] (Theta, Lam: a symmetric product and a Cholesky) and of
    [X1 | X2] (U, Z: two symmetric products and a Cholesky): 70/3;
    smoother: E, E_e D_l and the tria of [E_e D_l | D_e]: 19/3.  The
    same at every tier (the one-thread kernels' Gram-Schmidt trias do
    more)."""
    if engine == "pit":
        return 44.0 / 3, 5.0
    return 70.0 / 3, 19.0 / 3


def assoc_elements(stats, pt, engine: str, ref: bool = True) -> tuple:
    """(filter elements, smoother elements, the plain associative prefix
    and suffix as ``plain_call`` pairs, or None without ``ref``): the
    elements built from ``stats`` by the card's kernels (the element
    builds' Python loops are the twins' cost, and the checks here are the
    scans'), the smoother's from the filter the associative prefix
    gives."""
    A, Q, mu0, P0 = pt.A, pt.Q, pt.mu0, pt.P0
    impl = "associative"
    if engine == "pit":
        el = pf.pit_filter_elements(stats, A, Q, mu0, P0)
        pref = pf.pit_scan(el, scan_impl=impl)
        x_pred, P_pred, _ = pf.pit_filter_assemble(
            pref[1], pref[2], stats.C, A, Q, mu0, P0)
        sel = pf.pit_smoother_elements(
            FilterResult(x_pred, P_pred, pref[1], pref[2], None), A)[0]
    else:
        el = pf.qr_filter_elements(stats, A, Q, mu0, P0)
        pref = pf.qr_scan(el, scan_impl=impl)
        x_pred, P_pred, P_f, _ = pf.qr_filter_assemble(
            pref[1], pref[2], stats.C, A, Q, mu0, P0)
        sel = pf.qr_smoother_elements(
            FilterResult(x_pred, P_pred, pref[1], P_f, None), A, Q)[0]
    el, sel = (tuple(x.contiguous() for x in e) for e in (el, sel))
    if not ref:
        return el, sel, None, None
    plain = assoc_scan_fns(engine)[1]
    return (el, sel, plain_call(lambda: plain(el, False, impl)),
            plain_call(lambda: plain(sel, True, impl)))


def assoc_scan_fns(engine: str):
    """(the engine's scan wrapper, its plain twin, its kernel route)."""
    if engine == "pit":
        return pf.pit_scan, pf.pit_scan_plain, \
            lambda k: kernels.route("pit_assoc", k)
    return pf.qr_scan, pf.qr_scan_plain, \
        lambda k: la.check_qr_k("qr_assoc", k)


def assoc_cases(stats, pt, engine: str, label: str) -> list:
    """The engine's associative prefix and suffix kernels against their
    plain twins on the elements of ``stats``, each named by the kernel its
    wrapper routes to at this k; the blocked kernel of the tier is run on
    the same elements by ``assoc_kernel_phase``."""
    T_, k = stats.b.shape
    scan, plain, route = assoc_scan_fns(engine)
    el, sel, pref, suf = assoc_elements(stats, pt, engine)
    f_fl, s_fl = assoc_flops(engine)
    chain = 2 * (len(assoc_levels(T_)) - 1)
    dtype = pt.A.dtype
    floor = lambda: latency_ms("info_scan", dtype, k, max(chain, 1))  # noqa: E731
    out = []
    for side, elems, ref, fl in (("prefix", el, pref, f_fl),
                                 ("suffix", sel, suf, s_fl)):
        smooth = side == "suffix"
        c = case(route(k), f"{side} {label}",
                 lambda e=elems, s=smooth: scan(e, s, "associative"),
                 lambda e=elems, s=smooth: plain(e, s, "associative"),
                 elems, (T_ - 1) * fl * k ** 3, floor=floor, ref=ref)
        c["blocked"] = lambda e=elems, s=smooth: scan(e, s)
        c["side"] = side
        out.append(c)
    return out


def gram_outputs(x, gram=()) -> tuple:
    """The tensors of a result in f64, those at ``gram`` (square-root
    factors) as X X' (see ``compare``)."""
    out = tuple(z.double() for z in as_tuple(x))
    return tuple(z @ z.transpose(-1, -2) if i in gram else z
                 for i, z in enumerate(out))


def rel_gaps(a, b, gram=()) -> list:
    """``rel_err`` of each output of ``a`` against ``b``, through
    ``gram_outputs``."""
    return [rel_err(x, y) for x, y in zip(gram_outputs(a, gram),
                                          gram_outputs(b, gram))]


def assoc_gram(engine: str, side: str) -> tuple:
    """The square-root factors among a scan's outputs: the filter's U and
    Z, the smoother's D (the square-root engine only)."""
    if engine != "pit_qr":
        return ()
    return (2,) if side == "suffix" else (2, 4)


def assoc_abs_floor(engine: str, side: str, T_: int) -> dict:
    """{output: absolute allowance} of the f64 check against the blocked
    kernel.  The square-root prefix's Z Z' is 0 in exact arithmetic (the
    t = 0 element has A = 0 and Z = 0); past k = 10 each tria on its chain
    adds the f64 jitter (1e-10) to it, and no chain of either scan is
    longer than T_ combines, so the two scans' Z Z' stand within T_ x the
    jitter of each other (0 at k <= 10, where the trias have no
    jitter)."""
    if engine != "pit_qr" or side != "prefix":
        return {}
    return {4: T_ * la.default_jitter(torch.float64)}


def assoc_kernel_phase(seed: int) -> dict:
    """K14-assoc and K8-assoc (prefix and suffix) against their plain
    twins on the elements of the masked headline panel simulated at k =
    10, 25, 50 and 100 (every tier), f64 then f32 (the TOL rule), timed
    warm and cold (``kernel_record``) beside the plain twin, the bound and
    K4's step chain over the levels in sequence; and against the blocked
    kernel of the tier on the same elements (f64, ``assoc_vs_blocked``;
    both timed in f32).  Returns the f32 records of the prefix at k = 10
    (pit_assoc, qr_assoc) and 100 (the generic ones)."""
    summary = {}
    for k in ASSOC_KS:
        pan = assoc_panel(seed, k)
        refs = {}
        for dtype in (torch.float64, torch.float32):
            with highest_precision():
                stats, _, pt = sgen_stats(*pan, dtype)
                for engine in ("pit", "pit_qr"):
                    for c in assoc_cases(stats, pt, engine, "masked"):
                        if k == ASSOC_KS[-1]:
                            c["cold_reps"] = 1
                        rec = kernel_record(c, dtype, refs)
                        gram = assoc_gram(engine, c["side"])
                        got = gram_outputs(c["run"](), gram)
                        blk = gram_outputs(c["blocked"](), gram)
                        floor = assoc_abs_floor(engine, c["side"], T)
                        gaps = [rel_err(x, y) for x, y in zip(got, blk)]
                        abs_gaps = {i: float(abs(got[i] - blk[i]).max())
                                    for i in floor}
                        rec.update({"engine": engine, "k": k, "T": T,
                                    "levels": len(assoc_levels(T)) - 1,
                                    "combines": assoc_combines(T),
                                    "combines_needed": T - 1,
                                    "vs_blocked_rel": max(
                                        g for i, g in enumerate(gaps)
                                        if i not in floor),
                                    "vs_blocked_rel_by_output": gaps,
                                    "vs_blocked_abs_floored": abs_gaps,
                                    "abs_floor": floor})
                        if dtype == torch.float64:
                            assoc_vs_blocked(c, engine, k, gaps, abs_gaps,
                                             floor, gram, rec)
                        else:
                            rec["blocked_ms"] = cuda_ms(c["blocked"])
                            rec["blocked_name"] = kernels.route(
                                "pit_scan", k) if engine == "pit" else \
                                la.check_qr_k("qr_scan", k)
                        emit(rec)
                        if (dtype == torch.float32 and c["side"] == "prefix"
                                and k == ASSOC_NEW[c["name"]]):
                            summary[c["name"]] = rec
                        del got, blk
                del stats, pt
            torch.cuda.empty_cache()
        del pan, refs
    return summary


def assoc_vs_blocked(c, engine, k, gaps, abs_gaps, floor, gram,
                     rec) -> None:
    """Holds the f64 associative kernel to the blocked one output by
    output: an output with an absolute floor within it, every other one
    within ASSOC_BLOCKED_TOL relative or, where it passes that, within
    twice the gap between the reference's own two scans (the plain twins)
    on that same output (the square-root engine's jittered Gram past k =
    10, ROADMAP Queue 3 "Watch")."""
    over = [i for i, g in enumerate(gaps)
            if i not in floor and g > ASSOC_BLOCKED_TOL]
    twins = [0.0] * len(gaps)
    if over:
        twins = rel_gaps(c["ref"], assoc_scan_fns(engine)[1](
            c["ins"], c["side"] == "suffix"), gram)
        rec["twins_vs_blocked_rel_by_output"] = twins
    bad = [f"output {i}: {gaps[i]:.3e} relative (the twins' "
           f"{twins[i]:.3e})" for i in over if gaps[i] > 2.0 * twins[i]]
    bad += [f"output {i}: {abs_gaps[i]:.3e} absolute (floor "
            f"{floor[i]:.1e})" for i in floor if abs_gaps[i] > floor[i]]
    if bad:
        raise AssertionError(f"{c['name']} ({c['variant']}, k = {k}) "
                             f"against the blocked kernel: {bad}")


def assoc_k_sweep(seed: int) -> None:
    """Both engines' associative prefix and suffix kernels against their
    plain twins at every k of ASSOC_SWEEP_KS (each tier's ends) and T of
    ASSOC_SWEEP_TS (odd and even lengths, one and two elements), f64: the
    elements of a masked 257-step panel (step 0 fully missing), their
    first T.  At T = 1 nothing is launched (an element is its own
    scan)."""
    f64 = torch.float64
    for k in ASSOC_SWEEP_KS:
        Tmax = max(ASSOC_SWEEP_TS)
        _, W, Yfull, p = panel(seed + 2000 + k, T_=Tmax, N_=ASSOC_SWEEP_N,
                               K_=k)
        W[0] = 0.0
        worst = {}
        with highest_precision():
            stats, _, pt = sgen_stats(np.where(W > 0, Yfull, np.nan), W,
                                      Yfull, p, f64)
            for engine in ("pit", "pit_qr"):
                scan, plain, route = assoc_scan_fns(engine)
                el, sel = assoc_elements(stats, pt, engine, ref=False)[:2]
                for T_ in ASSOC_SWEEP_TS:
                    for side, elems in (("prefix", el), ("suffix", sel)):
                        e = tuple(x[:T_].contiguous() for x in elems)
                        smooth = side == "suffix"
                        n0 = kernels.LAUNCHES[route(k)]
                        c = case(route(k), f"{side} T={T_} k={k}",
                                 lambda: scan(e, smooth, "associative"),
                                 lambda: plain(e, smooth, "associative"),
                                 e, 0.0)
                        rel = compare(c, f64)[1]
                        ran = kernels.LAUNCHES[route(k)] - n0
                        if ran != int(T_ > 1):
                            raise AssertionError(
                                f"{route(k)} at T = {T_}: {ran} launches")
                        worst[f"{engine} {side} T={T_}"] = rel
            del stats, pt
        emit({"assoc_sweep": {"k": k, "N": ASSOC_SWEEP_N},
              "max_rel_err": worst})


def assoc_public_phase(seed: int) -> dict:
    """The six public functions with scan_impl="associative" (the main
    path of the kernels: ``*_from_stats``, ``*_filter``, ``*_smoother``)
    at full width on the masked headline panel at k = 10 and 100, at its
    true params, in f32 and f64: finite outputs of the expected shapes,
    the launches of each engine's run (from_stats, filter, smoother) with
    the counts set to 0 before it; the f64 loglik within ASSOC_REF_TOL of
    the JAX package's own (ASSOC_LL_JAX, at the default seed), the f32
    loglik within ASSOC_LL_LIMIT of the exact f64 one (``info_filter``)
    or, where the JAX package's own f32 loglik misses that, within
    ASSOC_LL_JAX_MARGIN x |exact| of that loglik; the walls of the filter
    and smoother with either scan.  Returns the launch counts by run."""
    counts = {}
    fns = {"pit": (pf.pit_from_stats, pf.pit_filter, pf.pit_smoother),
           "pit_qr": (pf.pit_qr_from_stats, pf.pit_qr_filter,
                      pf.pit_qr_smoother)}
    dev = torch.device("cuda")
    for k in ASSOC_PUBLIC_KS:
        Ynan, W, _, p = assoc_panel(seed, k)
        ins = {}
        for dtype in (torch.float64, torch.float32):
            ins[dtype] = (torch.as_tensor(np.where(W > 0, Ynan, 0.0),
                                          dtype=dtype, device=dev),
                          torch.as_tensor(W, dtype=dtype, device=dev),
                          SSMParams.from_numpy(p, dtype=dtype, device=dev))
        with highest_precision():
            Y64, W64, p64 = ins[torch.float64]
            exact = float(inf.info_filter(Y64, p64, mask=W64).loglik)
            for engine, (f_stats, f_filter, f_smoother) in fns.items():
                rec = {"assoc_public": engine, "k": k, "T": T, "N": N,
                       "loglik_exact_f64": exact}
                for dtype in (torch.float64, torch.float32):
                    Yt, Wt, pt = ins[dtype]
                    stats = inf.obs_stats(Yt, pt.Lam, pt.R, mask=Wt)
                    torch.cuda.synchronize()
                    kernels.reset_launches()
                    fs = f_stats(stats, pt, "associative")
                    kf = f_filter(Yt, pt, mask=Wt, scan_impl="associative")
                    sm = f_smoother(kf, pt, scan_impl="associative")
                    torch.cuda.synchronize()
                    run = {nm: v for nm, v in kernels.LAUNCHES.items() if v}
                    name = (kernels.route("pit_assoc", k) if engine == "pit"
                            else la.check_qr_k("qr_assoc", k))
                    shapes = ([(T, k), (T, k, k), (T, k), (T, k, k), (T,)]
                              + [(T, k), (T, k, k), (T, k), (T, k, k)]
                              + [(T, k), (T, k, k), (T, k, k)])
                    outs = list(fs) + list(kf[:4]) + list(sm)
                    bad = [i for i, (x, s) in enumerate(zip(outs, shapes))
                           if tuple(x.shape) != s
                           or not bool(torch.isfinite(x).all())]
                    ll = float(kf.loglik)
                    tag = str(dtype)[6:]
                    rec[f"loglik_{tag}"] = ll
                    rec[f"rel_err_{tag}"] = abs(ll - exact) / abs(exact)
                    rec[f"launches_{tag}"] = run
                    if bad or not np.isfinite(ll) or run.get(name) != 3:
                        raise AssertionError(
                            f"assoc {engine} k = {k} ({tag}): outputs {bad} "
                            f"wrong or non-finite, launches {run}")
                    if dtype == torch.float32:
                        counts[f"assoc {engine} k{k}"] = run
                        for impl in ("blocked", "associative"):
                            rec[f"filter_ms_{impl}"] = cuda_ms(
                                lambda: f_filter(Yt, pt, mask=Wt,
                                                 scan_impl=impl))
                            rec[f"smoother_ms_{impl}"] = cuda_ms(
                                lambda: f_smoother(kf, pt, scan_impl=impl))
                    del fs, kf, sm, stats
                jax = ASSOC_LL_JAX[(k, engine)]
                vs_jax = {tag: abs(rec[f"loglik_float{tag[1:]}"]
                                   - jax[f"loglik_{tag}"]) / abs(exact)
                          for tag in ("f32", "f64")}
                f32_vs = "exact" if jax["f32"] <= ASSOC_LL_LIMIT else "jax"
                limit = ASSOC_LL_LIMIT if f32_vs == "exact" \
                    else ASSOC_LL_JAX_MARGIN
                got = rec["rel_err_float32"] if f32_vs == "exact" \
                    else vs_jax["f32"]
                rec.update({"jax_rel_err_f32": jax["f32"],
                            "vs_jax_rel": vs_jax, "f32_held_to": f32_vs,
                            "limit_f32": limit})
                emit(rec)
                if not (got <= limit and vs_jax["f64"] <= ASSOC_REF_TOL):
                    raise AssertionError(
                        f"assoc {engine} k = {k}: f32 loglik {got:.3e} "
                        f"from the {f32_vs} one (limit {limit:.1e}), f64 "
                        f"{vs_jax['f64']:.3e} from JAX's")
        del ins
        torch.cuda.empty_cache()
    return counts


def assoc_longt_phase(seed: int) -> None:
    """bench/longt.py's largest point (T = 4,000, N = 24, k = 2, fully
    observed, f32): each engine's filter and smoother with either scan,
    timed (CUDA events) at the panel's true params, the two scans' logliks
    and moments side by side."""
    _, _, Yl, pl = panel(seed + 1100, T_=LONGT_T, N_=LONGT_N, K_=LONGT_K)
    dev = torch.device("cuda")
    Yt = torch.as_tensor(Yl, dtype=torch.float32, device=dev)
    pt = SSMParams.from_numpy(pl, dtype=torch.float32, device=dev)
    for engine, f_filter, f_smoother in (
            ("pit", pf.pit_filter, pf.pit_smoother),
            ("pit_qr", pf.pit_qr_filter, pf.pit_qr_smoother)):
        rec = {"assoc_longt": engine, "T": LONGT_T, "N": LONGT_N,
               "k": LONGT_K}
        res = {}
        for impl in ("blocked", "associative"):
            kf = f_filter(Yt, pt, scan_impl=impl)
            sm = f_smoother(kf, pt, scan_impl=impl)
            res[impl] = (kf, sm)
            rec[f"filter_ms_{impl}"] = cuda_ms(
                lambda: f_filter(Yt, pt, scan_impl=impl))
            rec[f"smoother_ms_{impl}"] = cuda_ms(
                lambda: f_smoother(kf, pt, scan_impl=impl))
        (kb, sb), (ka, sa) = res["blocked"], res["associative"]
        rec["loglik"] = {i: float(r[0].loglik) for i, r in res.items()}
        rec["vs_blocked_rel"] = max(rel_gaps((*ka[:4], *sa),
                                             (*kb[:4], *sb)))
        emit(rec)
        if not all(np.isfinite(v) for v in rec["loglik"].values()):
            raise AssertionError(f"long-T {engine}: non-finite loglik")


def assoc_raise_phase(seed: int) -> None:
    """k = 129: both associative scans raise naming the ROADMAP row before
    any launch (card tensors of zeros, T = 5); then one small case, card
    f64 against CPU f64 (the plain twins): both engines' filter and
    smoother with scan_impl="associative" within ASSOC_REF_TOL."""
    k = kernels.GEN_KMAX + 1
    z = dict(dtype=torch.float32, device="cuda")
    mats, vecs = torch.zeros((5, k, k), **z), torch.zeros((5, k), **z)
    before = dict(kernels.LAUNCHES)
    for scan in (pf.pit_scan, pf.qr_scan):
        for elems, smooth in (((mats, vecs, mats, vecs, mats), False),
                              ((mats, vecs, mats), True)):
            try:
                scan(elems, smooth, "associative")
            except NotImplementedError as e:
                if kernels.GENERIC_K not in str(e):
                    raise
            else:
                raise AssertionError(f"{scan.__name__} at k = {k} ran")
    if kernels.LAUNCHES != before:
        raise AssertionError("a launch at k = 129")
    del mats, vecs
    Ynan, W, _, p = panel(seed + 2300, T_=40, N_=30, K_=3)
    worst = {}
    for engine, f_filter, f_smoother in (
            ("pit", pf.pit_filter, pf.pit_smoother),
            ("pit_qr", pf.pit_qr_filter, pf.pit_qr_smoother)):
        out = {}
        for dev in ("cuda", "cpu"):
            Yt = torch.as_tensor(np.where(W > 0, Ynan, 0.0),
                                 dtype=torch.float64, device=dev)
            Wt = torch.as_tensor(W, dtype=torch.float64, device=dev)
            pt = SSMParams.from_numpy(p, dtype=torch.float64, device=dev)
            kf = f_filter(Yt, pt, mask=Wt, scan_impl="associative")
            sm = f_smoother(kf, pt, scan_impl="associative")
            out[dev] = tuple(x.cpu() for x in (*kf[:4], kf.loglik, *sm))
        worst[engine] = max(rel_gaps(out["cuda"], out["cpu"]))
    emit({"assoc_k129": "raised before any launch",
          "assoc_reference": worst})
    if max(worst.values()) > ASSOC_REF_TOL:
        raise AssertionError(f"assoc card vs CPU f64: {worst}")


def ptxas_summary(source: str) -> dict:
    """Build seconds and, over the k = 10 instantiations of ``source``
    (every function for a source without a k template), the largest
    register count and stack frame and the summed spills, from nvcc's
    ``-Xptxas -v`` log."""
    rec = {"ptxas": source, "built_s": None, "functions": 0, "max_regs": 0,
           "max_stack_frame": 0, "spill_stores": 0, "spill_loads": 0}
    log = kernels.build_log(source).splitlines()
    templ = any("Li10E" in line for line in log)
    name = None
    for line in log:
        if line.startswith("# built in"):
            words = line.split()
            rec["built_s"] = max(rec["built_s"] or 0.0, float(words[3]))
            if "(nvcc" in words:
                rec["nvcc_s"] = max(rec.get("nvcc_s", 0.0),
                                    float(words[words.index("(nvcc") + 1]))
        elif "Compiling entry function" in line or "Function properties" in line:
            name = line.split()[-1] if "properties" in line else \
                line.split("'")[1]
        elif name and (not templ or "Li10E" in name):
            words = line.replace(",", "").split()
            if "stack" in words and "frame" in words:
                rec["functions"] += 1
                rec["max_stack_frame"] = max(rec["max_stack_frame"],
                                             int(words[0]))
                rec["spill_stores"] += int(words[words.index("spill") - 2])
                rec["spill_loads"] += int(words[-4])
            elif "registers" in words:
                rec["max_regs"] = max(rec["max_regs"],
                                      int(words[words.index("registers") - 1]))
    return rec


# The build's queue (one niced nvcc fewer than the host's cores).  The
# first wave: the dense group's sources (it runs first: dense_filter.cu
# and the latency probe build in seconds) beside sv_rbpf.cu and
# tv_smoother.cu, two of the longest compiles, which the sv group (by
# ~150 s) and tvl (by ~30 s) need; then the rest of tvl's k <= 16 sources,
# sv's pre-fit (affine_scan.cu, ss_cov_path.cu), tgen's k > 16 sources and
# vgen's, then the longest compiles the later groups need (nvcc seconds a
# dtype beside the groups on the card's host, ``step_s`` records: pit_scan
# 169, qr_scan 135, pit_elements 89), then the rest.  The groups run
# beside the build; a kernel's first launch waits for its own library only
# (and moves it to the front of the queue).
BUILD_FIRST = ("dense_filter.cu", "step_chain.cu", "sv_rbpf.cu",
               "tv_smoother.cu", "mstep_rows.cu", "info_scan.cu",
               "ring_append.cu", "tv_loadings.cu", "obs_stats.cu",
               "quad_local.cu", "affine_scan.cu", "ss_cov_path.cu",
               "tv_loadings_gen.cu", "info_scan_gen.cu", "sv_gen.cu",
               "pit_scan.cu", "qr_scan.cu", "pit_elements.cu",
               "qr_elements.cu", "gen_filters.cu", "bsolve_rows.cu",
               "lowrank_scan.cu", "pit_assoc.cu")

# Phase groups of ``--phases``, in run order: the groups whose few sources
# build first (dense's build in seconds, so it runs while tvl's K11-bwd
# compiles), then the rest.
PHASES = ("dense", "tvl", "tgen", "sv", "vgen", "headline", "session",
          "batched", "fleet", "lowrank", "mf", "pit", "wide", "bwide",
          "kbig", "bgen", "sgen", "qgen", "lgen", "dgen", "assoc")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phase groups to run, of "
                         f"{', '.join(PHASES)} (default: all)")
    args = ap.parse_args()
    want = [g for g in args.phases.split(",") if g]
    unknown = sorted(set(want) - set(PHASES))
    if unknown or not want:
        ap.error(f"unknown phase groups {unknown}; pick from {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    seed = args.seed
    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    kernels.build_start(BUILD_FIRST)
    emit({"build_started": list(BUILD_FIRST), "torch": torch.__version__,
          "cuda": torch.version.cuda, "phases": want})
    summary, launches, group_s = {}, {}, {}
    for group in PHASES:
        if group not in want:
            continue
        t0 = time.perf_counter()
        emit({"group": group, "libraries_building": kernels.build_pending()})

        def timed(fn, *a, **kw):
            """``fn(*a, **kw)``, its seconds printed under the group."""
            t1, n0 = time.perf_counter(), kernels.build_pending()
            out = fn(*a, **kw)
            emit({"step_s": {"group": group, "step": fn.__name__,
                             "s": time.perf_counter() - t1,
                             "libraries_building_at_start": n0}})
            return out

        if group == "headline":
            tau_fit = timed(fit_tau, seed)
            emit({"tau_fit": tau_fit})
            summary.update(timed(kernel_phase, seed, tau_fit))
            timed(k_sweep, seed)
            launches.update(timed(fit_phase, seed))
            timed(reference_phase, seed)
            timed(contract_phase, seed)
        elif group == "session":
            summary["ring_append"] = timed(ring_phase, seed)
            launches.update(timed(session_phase, seed))
            timed(session_reference_phase, seed)
        elif group == "batched":
            summary.update(timed(batched_kernel_phase, seed))
            timed(batched_k_sweep, seed)
            launches.update(timed(fit_many_phase, seed))
            timed(kgrid_phase, seed)
            timed(rolling_phase, seed)
            timed(batched_reference_phase, seed)
            timed(batched_contract_phase, seed)
        elif group == "fleet":
            tenants = timed(fleet_tenants, seed + 600)
            launches["fleet"], recs = timed(fleet_phase, seed, tenants)
            summary.update({n: recs[n] for n in FLEET_NEW})
            timed(ring_fleet_phase, seed, tenants)
            timed(pit_fleet_phase, seed, tenants)
            del tenants
            timed(fleet_k_sweep, seed)
            timed(fleet_reference_phase, seed)
        elif group == "lowrank":
            summary.update(timed(lowrank_kernel_phase, seed))
            timed(lowrank_k_sweep, seed)
            lr_counts, lr_fused = timed(lowrank_fit_phase, seed)
            launches.update(lr_counts)
            timed(lowrank_reference_phase, seed)
            timed(lowrank_contract_phase, seed)
            timed(lowrank_session_phase, seed, lr_fused)
            timed(lowrank_fleet_phase, seed)
        elif group == "tvl":
            summary.update(timed(tvl_kernel_phase, seed))
            timed(tvl_k_sweep, seed)
            launches.update(timed(tvl_fit_phase, seed))
            timed(tvl_reference_phase, seed)
            timed(tvl_contract_phase, seed)
        elif group == "mf":
            summary.update(timed(mf_kernel_phase, seed))
            timed(mf_k_sweep, seed)
            launches.update(timed(mf_fit_phase, seed))
            timed(mf_reference_phase, seed)
            timed(mf_contract_phase, seed)
        elif group == "sv":
            sv_counts, sv_fit = timed(sv_fit_phase, seed)
            launches.update(sv_counts)
            summary.update(timed(sv_kernel_phase, seed, sv_fit))
            timed(sv_k_sweep, seed)
            timed(sv_reference_phase, seed)
            timed(sv_contract_phase, seed, sv_fit)
        elif group == "pit":
            summary.update(timed(pit_kernel_phase, seed))
            timed(pit_k_sweep, seed)
            timed(pit_longt_phase, seed)
        elif group == "dense":
            summary.update(timed(dense_kernel_phase, seed))
            timed(dense_k_sweep, seed)
            launches.update(timed(dense_fit_phase, seed))
            timed(dense_reference_phase, seed)
        elif group == "wide":
            tau_wide = timed(fit_tau, seed, WIDE_K, WIDE_SEED)
            emit({"tau_fit": tau_wide, "k": WIDE_K})
            summary.update(timed(wide_kernel_phase, seed, tau_wide))
            timed(wide_k_sweep, seed)
            launches.update(timed(wide_fit_phase, seed))
            timed(wide_reference_phase, seed)
            timed(wide_contract_phase, seed)
        elif group == "bwide":
            summary.update(timed(bwide_kernel_phase, seed))
            timed(bwide_k_sweep, seed)
            launches.update(timed(
                fit_many_phase, seed, WIDE_K, WIDE_SEED, "fit_many k25",
                lone_ss=False, B_=BWIDE_RESTARTS, n_lone=BWIDE_RESTARTS))
            timed(kgrid_phase, seed, BWIDE_KS, WIDE_K, WIDE_SEED)
            timed(rolling_phase, seed, WIDE_K, WIDE_SEED, BWIDE_WINDOWS)
            tenants = timed(fleet_tenants, seed + 1340, BWIDE_FLEET_SHAPES,
                            BWIDE_DRAINS * FLEET_ROWS)
            launches["fleet k25"], recs = timed(
                fleet_phase, seed + 1040, tenants, WIDE_K, BWIDE_DRAINS,
                BWIDE_ODD, BWIDE_HELD, "info k25", lone_all=False)
            del tenants
            summary.update({n: recs[n] for n in BWIDE_FLEET_NEW})
            timed(lowrank_fleet_phase, seed + 540, WIDE_K,
                  BWIDE_LR_TENANTS, BWIDE_LR_DRAINS)
            timed(batched_reference_phase, seed + 1390, k=20, tol=1e-12)
            timed(fleet_reference_phase, seed + 1400, BWIDE_REF_SHAPES,
                  BWIDE_REF_TICKS, capacity=120)
            timed(batched_contract_phase, seed, WIDE_K, WIDE_SEED)
        elif group == "kbig":
            summary.update(timed(kbig_kernel_phase, seed))
            timed(kbig_k_sweep, seed)
            launches.update(timed(kbig_fit_phase, seed))
            timed(kscale_phase, seed)
            launches.update(timed(kbig_session_phase, seed))
            launches.update(timed(kbig_mf_phase, seed))
            timed(kbig_reference_phase, seed)
            timed(kbig_contract_phase, seed)
        elif group == "bgen":
            summary.update(timed(bgen_kernel_phase, seed))
            timed(bgen_k_sweep, seed)
            launches.update(timed(
                fit_many_phase, seed, BGEN_K, BGEN_SEED, "fit_many k50",
                lone_ss=False, B_=BGEN_B, iters=BGEN_ITERS,
                n_lone=BGEN_LONE))
            timed(kgrid_phase, seed, BGEN_KGRID, BGEN_K, BGEN_SEED,
                  BGEN_ITERS)
            timed(rolling_phase, seed, BGEN_K, BGEN_SEED, BGEN_WINDOWS)
            launches.update(timed(bgen_fleet_phase, seed))
            timed(bgen_reference_phase, seed)
            timed(batched_contract_phase, seed, BGEN_K, BGEN_SEED, BGEN_B)
        elif group == "sgen":
            k = KBIG_KS[0]
            tau_sgen = timed(fit_tau, seed, k, KBIG_SEED + k)
            emit({"tau_fit": tau_sgen, "k": k})
            summary.update(timed(sgen_kernel_phase, seed, tau_sgen))
            timed(sgen_k_sweep, seed)
            launches.update(timed(sgen_fit_phase, seed))
            launches.update(timed(sgen_session_phase, seed))
            launches.update(timed(kbig_mf_phase, seed, "pit"))
            timed(sgen_reference_phase, seed)
            timed(sgen_contract_phase, seed)
        elif group == "qgen":
            summary.update(timed(qgen_kernel_phase, seed))
            timed(qgen_k_sweep, seed)
            launches.update(timed(qgen_fit_phase, seed))
            launches.update(timed(mf_fit_phase, seed,
                                  (("mf pit_qr", "pit_qr"),),
                                  torch.float64))
            timed(mf_reference_phase, seed, ("pit_qr",))
            timed(qgen_mf_contract_phase, seed)
            launches.update(timed(qgen_session_phase, seed))
            launches.update(timed(qgen_fleet_phase, seed))
            timed(qgen_reference_phase, seed)
            timed(qgen_contract_phase, seed)
        elif group == "tgen":
            summary.update(timed(tgen_kernel_phase, seed))
            timed(tgen_k_sweep, seed)
            launches.update(timed(tgen_fit_phase, seed))
            timed(tgen_reference_phase, seed)
            timed(tvl_contract_phase, seed, TGEN_KS[0])
        elif group == "lgen":
            summary.update(timed(lgen_kernel_phase, seed))
            timed(lgen_k_sweep, seed)
            launches.update(timed(kbig_fit_phase, seed, LGEN_FITS,
                                  LGEN_SEED, LGEN_ITERS))
            timed(lgen_exact_phase, seed)
            launches.update(timed(lgen_session_phase, seed))
            timed(lgen_fleet_phase, seed)
            timed(lgen_mf_phase, seed)
            timed(lowrank_contract_phase, seed, LGEN_K, 64,
                  LGEN_SEED + LGEN_K, (True,), max(1e-5, LGEN_CONTRACT_JAX))
        elif group == "dgen":
            summary.update(timed(dgen_kernel_phase, seed))
            timed(dgen_k_sweep, seed)
            launches.update(timed(dgen_fit_phase, seed))
            timed(dgen_reference_phase, seed)
        elif group == "assoc":
            summary.update(timed(assoc_kernel_phase, seed))
            timed(assoc_k_sweep, seed)
            launches.update(timed(assoc_public_phase, seed))
            timed(assoc_longt_phase, seed)
            timed(assoc_raise_phase, seed)
        elif group == "vgen":
            vg_counts, vg_fits = timed(vgen_fit_phase, seed)
            launches.update(vg_counts)
            summary.update(timed(vgen_kernel_phase, seed, vg_fits))
            timed(vgen_k_sweep, seed)
            timed(vgen_reference_phase, seed)
            timed(sv_contract_phase, seed, vg_fits[(25, SV_M)], 25, True)
            del vg_fits
        group_s[group] = time.perf_counter() - t0
        emit({"group_s": {group: group_s[group]},
              "script_s": time.perf_counter() - t_start})
    wait_s = kernels.build()           # every library; a failed compile raises
    recs = [ptxas_summary(source)
            for source in sorted({src for src, _ in kernels.KERNELS.values()})]
    for rec in recs:
        emit(rec)
    emit({"build_s": max(r["built_s"] or 0.0 for r in recs),
          "build_wait_after_groups_s": wait_s})
    emit({"phase_s": group_s, "script_s": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"dfm_tpu_torch/csrc/{kernels.KERNELS[name][0]}",
         "replaces": REPLACES[name], "variant": rec["variant"],
         "launches": launches.get(OWN_FIT[name], {}).get(name),
         "launches_fit": OWN_FIT[name],
         "max_abs_err": rec["max_abs_err"], "max_rel_err": rec["max_rel_err"],
         "ms": rec["kernel_ms"], "ms_cold_l2": rec["kernel_ms_cold_l2"],
         "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
         "bound_by": rec["bound_by"], "latency_ms": rec["latency_ms"],
         "library_ms": rec["library_ms"]}
        for name, rec in summary.items()]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
