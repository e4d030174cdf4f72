#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Runs ``mosaic_tpu_torch`` (never the JAX package) on the card:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compiles ``mosaic_tpu_torch/kernels/csrc/pip.cu`` and ``zonal.cu``,
   one nvcc each, started together;
3. index: tessellates the 256 ``synthetic_zones(16, 16, verts=256)`` zones
   at H3 resolution 9 and builds the join index on the card;
4. pip_heavy_tiled: the wrapper's kernels (a counting sort of the points
   by heavy row, then the row-staged probe) on the real heavy tables and
   the compacted heavy points of a 4M-point batch, with and without the
   epsilon band, and on the banded launch of the crop tile (phase 8) with
   the most heavy points; each equal bit for bit to its plain torch
   version, its device time summed over every device op the wrapper
   launches, timed against the bound of the work these inputs need;
5. pip_zone: the brute-force zone kernel (the bench's zone lane) at 500k
   points, equal bit for bit to its plain version on a 16,384-point
   subset, timed on all 500k against its bound;
6. main path: ``pip_join(probe="adaptive")`` on the 4M batch must launch
   the heavy kernel and equal ``probe="scatter"`` bit for bit; prints
   points/s and the agreement with the f64 host oracle on 100k points
   (at least ``MIN_ORACLE_AGREEMENT``: f32 rounding near boundaries is
   expected, a wrong path is not); then where the time of one warm join
   goes (stage times, the profiler's device time by op, and the host
   microseconds of a ``guarded_call``, a span and an event, each beside a
   bare call); the warm joins are timed bare, the events checked on the
   gated calls around them;
6b. the exact join: ``pip_join(probe="adaptive", recheck=True)`` on the
   4M batch must launch ``pip_heavy_tiled`` (banded), come back not
   degraded and equal the recheck's f64 oracle (``recheck_oracle``:
   ``host_join``, save at H3's cell-edge gap) exactly on its first
   ``N_EXACT`` points (agreement 1.0); prints its best warm points/s beside the
   ``recheck=False`` figure, the cell band, ties and host-oracle rows,
   and its stage times (margin cells, banded probe, narrow re-join, host
   ties) on the host clock with a sync around each, and its device idle
   share under the profiler;
6c. drift: the port's calibration sweep on the card
   (``mosaic_tpu_torch/tools/calibrate_margins.py``): CUDA's f32 cell
   drift at H3 res 5, 7 and 9 over ``N_DRIFT`` global points for seeds 3
   and 11 (and the sweep's BNG lane), and the edge drift over
   ``synthetic_zones(12, 12)`` with ``N_DRIFT`` uniform and as many
   near-edge points; both must
   keep 2x headroom under ``CELL_MARGIN_K`` and ``EDGE_BAND_K``; the cell
   maximum is printed beside the reference golden's;
6d. faults: on ``N_FAULT`` points of the exact join, injected transient
   errors give bit-identical ids and ``transient_retry`` events,
   exhaustion raises ``RetryExhausted`` (a join on the card is never
   answered from the CPU) and records no degradation, and a
   planned stall under a short ``MOSAIC_WATCHDOG_PIP_JOIN_DEVICE``
   deadline raises ``StalledDeviceError`` and is retried. Every gated
   join of phases 6 and 6b must record no retry or degradation;
7. zonal_tiled: the kernel on the segments the zones probe gives on one
   256x256 tile (the raster path's launch) and one 2048x2048 tile of the
   raster below, equal to its plain version (count, min and max exactly;
   the sum exactly on integer-valued data, to ``ZONAL_SUM_RTOL`` of the
   segment's sum of |v| on float data; two calls equal bit for bit),
   timed against its bound and the four-call torch composite; then the
   fold lane's ``zonal_seq_fold`` against the CPU lane, bit for bit in
   f64, on the 256x256 tile's integer values (the exact branch) and on
   float values (the sequential branch): the wrapper's time, the
   kernel's own, the longest run, the longest sequential-branch run and
   the measured latency of one dependent ``__dadd_rn`` that bounds it;
8. raster path: ``synthetic_raster(2400, 2400)`` (5.76M pixels of about
   24 x 28 m) over the same zones and index, default (256, 256) tiles:
   ``ZonalEngine.zones`` in the tiled lane (must launch ``zonal_tiled``
   once per tile with live pixels, and ``pip_heavy_tiled``), in the fold
   lane, and ``ZonalEngine.grid``, each with the wall time of its one
   warm call and pixels/s, and its device idle share on the 512x512
   middle of the crop (the profiler traces 4 tiles; the whole raster's
   ~10**6 device ops take it minutes, and it spends seconds on every
   thousand);
   then where one warm tiled zones call spends its time, stage by stage,
   on the host clock. Gates: fold zones and grid on the 1024x1024 crop
   equal the f64 host oracles bit for bit (agreement 1.0), and the tiled
   lane equals the fold lane bit for bit on the values-mod-113 twin of the
   whole raster (every zone total under 2**24);
8b. the durable stream (``sql/stream.py StreamJoin``, the reference's
   stream bench): a ring of ``STREAM_RING`` batches of 4M points (slot 0
   the main path's batch) staged on the card, caps sized from every
   slot's exact counts, ``STREAM_BATCHES`` batches (100M points) with the
   adaptive probe, which launches ``pip_heavy_tiled`` once a batch.
   Gates, each bit for bit: no overflow; ``run`` equals ``run_batched``;
   slot 0's row equals phase 6's adaptive and scatter joins; both durable
   executors (synchronous, and pipelined with a window of 4) equal
   ``run`` with snapshots at 8, 16, 24 and 25; a fatal fault at
   ``stream.scan_step`` after 2 segments, then ``resume``, equals ``run``
   from cursor 16 for both executors; rows poisoned at ``stream.admit``
   are quarantined exactly and the admitted ring's ``run`` equals its
   ``run_batched``; exhausted retries raise ``RetryExhausted`` with no
   degradation. Prints the sustained and single-batch rates, both
   durable rates, snapshot and fingerprint seconds, the host
   synchronisations the loop makes a batch, ``hbm_peak`` and the device
   idle share over 3 profiled batches;
8c. the durable raster scan (``sql/raster_stream.py RasterStream``): the
   tiled lane over the whole raster must equal phase 8's tiled zones bit
   for bit and launch ``zonal_tiled`` and ``pip_heavy_tiled``; on the
   crop (fold lane) the plain, durable, killed-and-resumed and retried
   scans must equal the fold zones bit for bit; prints tiles/s and
   pixels/s;
8g. expressions (``mosaic_tpu_torch/expr``): ``synthetic_raster(2400,
   2400, bands=3)`` over phase 3's zones; the tree ``ndvi(nir=2,
   red=1).mask_where(band(3) < t)``, ``t`` the 80th percentile of band
   3's valid values, run as one fused program a tile (probe through
   ``pip_heavy_tiled``, fold in f64 through ``zonal_seq_fold``) by zones,
   by grid cell and through ``.join()``, after ``warmup_expr`` and
   ``expr.freeze()``. Gates, bit for bit: the fused zones fold equals the
   staged pipeline (``map_pixels`` into a one-band raster, then the fold
   lane's ``ZonalEngine.zones``) on the whole raster; on the 1024 crop the
   fused zones and grid folds equal ``host_expr_zonal_oracle``, the join's
   zone plane equals the rows the fold lane's zones fold by, and one
   tile's fold equals the CPU lane. Prints pixels/s fused and staged,
   the program's torch ops and the device ops a tile, the idle share on
   the crop's 512x512 middle, and the kernels' launches;
8h. the durable expression scan: ``RasterStream.scan(expr=...)`` over the
   whole raster equals ``map_zonal`` bit for bit; on the crop a killed
   scan resumed equals the uninterrupted one, and a resume with another
   tree refuses; no cold compile and no nvcc build after the warmups of
   8g. Prints tiles/s beside ``map_zonal``'s;
8i. the overlay join (``sql/overlay.py``) on the reference overlay
   bench's squares, 55 x 55 a side (the bench's default is 110 x 110) on
   the custom grid ``GridConf(-180, 180, -90, 90, 2, 10, 10)`` at
   resolution 4 (6,050 geometries), ``overlap_fraction()``, ``prepare_overlay`` once and
   ``warmup_overlay``. Gates: the device lane equals the f64 host lane
   bit for bit on pairs, value, valid, area and sure; no overflow; no
   nvcc build and no cold compile in the warm runs; the fold at the
   overlay's shapes equals the CPU lane. Prints pairs/s of both lanes
   and the host-overridden pairs;
8l. tuning profiles (``mosaic_tpu_torch/tune``) on phase 3's index,
   points and the 1024 crop, for two point workloads: the uniform 4M
   points, and the ones along the zone boundaries (each of them in a
   heavy cell, and as many in light cells). ``profile_points`` against
   the card index (a capped 4,096-point host sample) equals the same
   call on a CPU copy of the index; ``recommend`` (the port's priors,
   ``tune/priors/``) picks the probe by the dense share, the boundary
   workload ``probe="adaptive"``; ``pip_join(profile=)`` on up to 1M of
   each workload's points equals, bit for bit, ``pip_join`` with the
   same knobs passed explicitly, and the boundary workload's launches
   ``pip_heavy_tiled``;
   ``ZonalEngine(profile=TuningProfile(zonal_lane="tiled", raster_tile=
   (128, 128)))`` on the crop's 64 tiles launches ``zonal_tiled`` and
   ``pip_heavy_tiled`` at 128x128 and its zones equal the fold lane on
   the values-mod-113 twin; ``zonal_tiled`` at 128x128 equals its plain
   version, and one 128x128 tile's zone rows equal the CPU index's;
   ``profile_polygons`` of phase 3's zones merged with the boundary
   workload's recommendation round-trips through a ``ProfileStore`` bound to the
   card index's fingerprint (which equals the CPU copy's), and another
   index's fingerprint raises ``ProfileFingerprintMismatch``;
   ``profile_raster`` of the crop. Prints each profile, the
   recommendation and its rationale, and each step's seconds; the store
   goes to the serving process for 8e;
8n. multi-device (``mosaic_tpu_torch/parallel``, ``mesh=``): a logical
   mesh of ``MESH_SHARDS`` shards on the card (``devices=[card] * 4``;
   the real cards where there are more than one) reusing phase 3's
   index, the 4M batch, the crop and 8i's overlay squares. Gates, each
   bit for bit: ``pip_join(mesh=, probe="adaptive")`` in
   ``MESH_BATCH``-point chunks equals phase 6's adaptive and scatter
   joins and launches ``pip_heavy_tiled`` once a shard a chunk, and
   ``recheck=True`` raises ``ValueError``; ``dist_pip_join`` on a
   ``(dp, cell)`` mesh with ``cell_axis=2`` equals phase 6 and its zone
   counts equal the ``bincount`` of phase 6's match, with the hash table
   sharded and replicated, and exhausted retries raise
   ``RetryExhausted`` with no degradation; ``StreamJoin(mesh=)`` over 3
   batches equals the single-device ``run``; ``ServeEngine(mesh=)``
   after ``warmup()`` answers ``MESH_REQUESTS`` requests of 1-1,024 rows
   as ``pip_join`` does, with no cold compile, no nvcc build, one graph
   per (rung, shard), and none left after ``close()``;
   ``ZonalEngine(mesh=)`` ``.zones`` in both lanes and ``.grid`` on the
   crop equal the single-device calls; ``overlay_measures(mesh=)``
   equals 8i's device lane. The serving process's 8j holds a meshed
   ``KNNFrontend``'s 64-row ring dispatch against the single-device one.
   Prints the meshed and single-device points/s of the join (a logical
   mesh runs its shards one after another on one card: no scaling
   figure), the sharded index's bytes a shard and after the gather, the
   phase's launches and seconds, with the card's name and power limit;
8o. the function surface (``mosaic_tpu_torch/functions``, ``context.py``,
   ``sql/frame.py``), every call through ``MosaicContext.build("H3")
   .functions``: phase 3's 256 zones and 8i's 6,050 squares go to WKT,
   WKB, hex and GeoJSON and back (gate: bit for bit); ``st_area``,
   ``st_length``, ``st_perimeter``, ``st_centroid``, ``st_x/ymin/max`` on
   the card for zones and squares as two columns, held to the f64 oracle
   (1e-9; the centroid to the oracle on the recentred column, and to the
   raw oracle and the native engine within the function matrix's
   2e-5 / 1e-7), the native engine to the oracle (1e-11 / 1e-12), the
   card to ``device="cpu"`` (1e-12 relative, the largest gap printed),
   ``st_numpoints`` to the device vertex count; ``st_contains``,
   ``st_intersects`` and ``st_distance`` on ``FN_PAIRS`` row pairs (zone
   ``i % 256`` against square ``i % 6050``, the squares mapped into the
   zones' bbox), the first ``FN_PAIRS_CPU`` equal to the CPU bit for bit
   and the first ``FN_ORACLE`` (``FN_ORACLE_DIST`` for the distance) in
   ≥ 0.9999 agreement with the oracle; ``grid_longlatascellid`` of the 4M
   points equal to ``H3.point_to_cell`` on the card (its agreement with
   the CPU on ``FN_CELL_CPU`` points and each differing point's margin
   printed); ``MosaicFrame.set_index_resolution`` (``grid_tessellate``)
   of the first ``FN_TESS_ZONES`` zones equal to phase 3's chips of them
   (a sixteenth: the whole set takes ~20 s again), the phase 3 cells'
   ``grid_format_cellid`` / ``grid_parse_cellid`` round trip; a frame
   carrying phase 3's chips joins: ``point_in_polygon_join`` of the 4M
   points under ``MOSAIC_TUNE_PROBE=adaptive`` equal to phase 6's join,
   and under the context's ``exact_recheck`` on the first ``N_EXACT``
   equal to phase 6b's oracle, each launching ``pip_heavy_tiled``;
   ``intersects_join`` of 8i's two frames equal to the overlay's;
   ``rst_rastertogrid{avg,min,max,count}`` of the whole raster, each
   launching ``zonal_seq_fold``, equal on the crop to a numpy f64 host
   fold of the same cells bit for bit, ``rst_rastertogridmedian`` on the
   crop; ``st_intersection_area`` of 8i's squares equal to
   ``overlay_measures`` bit for bit with one ``zonal_seq_fold`` launch.
   Prints geometries/s, pairs/s, points/s beside phase 6's, pixels/s and
   the phase's launches;
8p. files in and out (``core/crs*.py``, ``raster/core.py`` IO,
   ``readers``), under ``FILES_DIR`` (removed): ``from_wgs84`` and
   ``to_wgs84`` on the torch lane in f64 on the card, the 4M points mapped
   into each of ``FILES_CRS_SRIDS``' areas of use, held to the numpy lane
   on the first ``FILES_CRS_CHECK`` within ``FILES_CRS_BANDS`` with the
   same non-finite rows and no host sync (points/s printed); the raster
   in UTM 18N at ``FILES_UTM_PIXEL`` m and in EPSG:4326 through
   ``write_geotiff`` and ``read_raster`` (pixels, geotransform, SRID and
   nodata bit for bit); the tiled deflate predictor-2 file of
   ``tests/modis_fixture.py`` decoded to its field; ``read("raster_to_grid")``
   of the UTM file at ``RES``, ``retileSize`` ``FILES_GRID_TILE``, avg,
   and of its ``CROP`` middle avg and max, each launching
   ``zonal_seq_fold``, on the card equal to ``device="cpu"`` and to a
   numpy f64 host fold of the
   same cells merged tile by tile as the reader merges; the tiled zones of
   the read-back EPSG:4326 raster equal to phase 4's bit for bit; phase
   3's zones through every ``readers.write`` format and ``readers.read``
   back (bit for bit; a shapefile stores each ring reversed); the zones
   in UTM 18N as a shapefile with a ``.prj`` read back as SRID 32618 and
   returned to EPSG:4326 within 2e-7 degrees; the first
   ``FILES_TESS_ZONES`` read-back zones tessellated equal to phase 3's
   chips and their 4M ``pip_join`` equal to the in-memory zones' join;
8q. the last modules (``utils``, ``viz.py``, ``tools/chaos_sweep.py``):
   ``utils.benchmark`` of the warm 4M adaptive ``pip_join`` on phase 3's
   index, each trial bracketed by CUDA events (gate: the median is at
   least the trials' median event time); ``utils.device_trace`` around
   one join under ``utils.annotate`` (gate: the Chrome trace names
   ``pip_heavy_kernel`` and the annotation); ``viz.plot_cells`` of
   ``VIZ_CELLS`` of phase 3's cells (gate: the page's FeatureCollection
   holds one polygon a cell); the chaos sweep on the card, in this
   process, over the 25 registered fault sites (gates: every site holds
   its contract, none degrades, the environment is unchanged), then
   ``pip_join.device`` at full width (phase 3's index, the 4M batch,
   clean and with one injected fault, bit for bit) and ``raster.zonal``
   (tiled lane) on the crop, a typed error and then the clean answer;
   the sweep and the two sites together launch ``pip_heavy_tiled``,
   ``zonal_tiled`` and ``zonal_seq_fold`` (``launches_chaos``);
8r. the last gaps on the card (``models/core.py``, the retry knobs), on
   phase 3's index and the 4M batch: a ``BinaryTransformer`` whose
   ``right`` is the ``ChipIndex`` runs ``MODELS_ITERATIONS`` steps, step
   i the adaptive ``pip_join`` of the i-th 1M slice, folding
   ``torch.bincount(ids + 1, minlength=257)`` into a state of CUDA
   tensors, each step checkpointed by a ``CheckpointManager`` under
   ``MODELS_DIR`` (removed). Gates: the final counts equal those of one
   4M join bit for bit; ``load()`` holds one part an iteration with
   ``iteration`` 1-4, each equal to that iteration's state; the index is
   threaded unchanged; an ``IterativeTransformer`` over the same steps
   stops where the reference's rule says (the first step whose matched
   total reaches the second step's plus one). Then one transient fault at
   ``pip_join.device`` on the 4M join: under ``MOSAIC_RETRY_ATTEMPTS=1``
   it raises ``RetryExhausted`` after one attempt with no degradation;
   under ``=2`` it answers the clean join's bits with one
   ``transient_retry``; the environment is as before. The phase's
   launches by kernel are ``launches_models``;
8s. the program store (``dispatch/programs.py``), after 8n: a
   ``ServeEngine`` over phase 3's index with 8d's ladder and
   ``program_store`` under ``RELAUNCH_DIR`` warms up and exports two
   entries a rung and the ``pip`` library (gate: exactly those exports,
   no nvcc build). A relaunch process (``--relaunch-child``) then runs
   from a copy of ``mosaic_tpu_torch/`` without ``kernels/.build/``, with
   no nvcc on its ``PATH`` and ``CUDA_HOME`` an empty directory, beside
   this process's phases 8o-8r. Its gates: the package and build directory are
   the copy's, nvcc is not found, warming an engine from the store loads
   every entry the parent exported and exports none, the ``pip`` library
   is bound from the store, no nvcc build; 200 requests of 8d's mix (1-
   1,024 rows) each equal ``pip_join`` in that process bit for bit,
   launching ``pip_heavy_tiled`` (``launches_relaunch``), and the kernel
   equals ``pip_heavy_plain`` on the inputs of one top-rung dispatch.
   Its line gives the seconds from its start to the store bound, its
   warmup, graph captures and first answer, beside phase 2's nvcc build
   seconds. Meanwhile this process runs three refusals on copies of the
   store: a flipped byte in the ``pip`` payload
   (``program_store_corrupt_skipped``, the entry exported again, then a
   clean load), a sidecar naming another card
   (``program_store_mismatch``, exported again), and a core on 8n's
   4-shard mesh (``program_store_refused``); every answer equals
   ``pip_join``;
8d-8f, 8j and 8k run in a process of their own (``--serve-child``; its
   lines' ``t_s`` count from its own start, the parent passes them
   through), started right after phase 3: it loads phase 3's index from
   disk and the kernel libraries built in phase 2 (it must start no nvcc
   build) and, while this process runs phases 4-8i, builds on the host
   and the card what its phases need (8k's epochal index and its rebuild,
   8j's KNN index; the ``serve_prep`` line gives their seconds); its
   phases start when this process sends ``go``. The ``serve_process``
   line gives a 1,024-row dispatch's host ms in this process, which the
   profiler has traced (every later eager op runs slower), beside the
   child's;
8d. serving (``serve/engine.py ServeEngine``, the reference serve
   bench's settings): ``probe="adaptive"``, ladder 64-16,384, a 2 ms
   window, a queue of 64, 2 s deadlines; ``warmup()`` (seconds per rung,
   nvcc builds before and after), then a closed loop of 8 clients over
   2,000 requests of 1-1,024 rows (seed 7, ~1M points). Gates, bit for
   bit: every answer equals ``pip_join(probe="scatter")`` of the same
   points, and so does a second engine with the default probe; the
   signatures equal the rungs, no cold compile, no nvcc build after
   warmup, no shed or degradation, ``pip_heavy_tiled`` launched, and no
   host sync in a warm dispatch's cells and probe on any rung. Prints
   requests/s, points/s, p50 and p99 latency, occupancy, batches, and a
   1,024-row dispatch's host ms alone and beside a thread holding the
   GIL (a 2,250 Hz ticker of 80 µs, and a thread that never leaves
   Python); after 8k, the ``serve_profile`` line gives the device idle
   share over a profiled window of 50 requests;
8e. serve resilience on that engine: a transient fault at
   ``serve.dispatch`` is retried to the same bits; exhausted retries
   fail the request with ``RetryExhausted`` and nothing degrades; a
   request with 100 NaN rows is parked (-1) and its batchmates' bits are
   untouched; ``hot_swap`` to the index of ``synthetic_zones(16, 16,
   verts=256, seed=12)`` over the middle quarter of the bbox (epoch 0 of
   8k's ``EpochalIndex``), in the middle of a stream of requests: every
   answer equals one of the two indexes' ``pip_join``, every request
   submitted after the swap returned equals the new index's, and the
   swap makes no cold compile and no nvcc build; then
   ``hot_swap(profile=)`` with 8l's stored profile (loaded against phase
   3's fingerprint; ``resolution=`` passed, as the new index's is not
   the profile's) builds the profile's ladder: every answer, a request
   on the top rung's included, equals ``pip_join``, no nvcc build and no
   cold compile follow the swap's warmup, and the replaced core's graphs
   are freed. Prints each rung's capture seconds and the
   ``memory_reserved`` after it;
8f. the router (``serve/router.py ServeRouter``): 3 tenants over the
   index, ``SERVE_TENANT_r16.json``'s open-loop traffic (the aggressor at
   15x a victim's 150 requests/s, a quota of 64 each); the victims shed
   nothing and every answer is exact; with ``max_resident=2`` a third
   tenant evicts one, and a submit revives it with no nvcc build and no
   cold compile. Prints each tenant's shed rate, p50 and p99;
8j. KNN (``mosaic_tpu_torch/knn``, ``models/knn.py``), in the serving
   process after 8f: 10,000 squares over the NYC bbox (uniform corners,
   sides of 0.5-1.5 H3 res-9 cell widths, the reference's
   ``tests/test_knn_serve.py`` candidates), ``build_knn_index`` at H3
   res 9, k = 5, both lanes warmed. Gates, each bit for bit: both lanes
   equal ``brute_force_knn`` on 32 queries; the Voronoi lane equals the
   ring lane on 64 rows; the card equals the CPU frontend on them;
   ``SpatialKNN`` (exact) on the card equals the CPU on 200 landmarks; a
   transient fault at ``knn.distance`` retries to the same bits;
   exhausted retries raise ``RetryExhausted`` and record no degradation;
   the warmups' signatures equal the rungs; no nvcc build and no cold
   compile; in a mixed closed loop of 300 requests (8 clients, half pip
   of 1-1,024 rows, half KNN of 1-8 rows, ring lane) every pip answer
   equals ``pip_join`` and every KNN answer the engine-less ring lane,
   pip and KNN requests share batches, nothing is shed or degraded and
   ``pip_heavy_tiled`` is launched. The loop's deadline is
   ``max(SERVE_DEADLINE_S, 10 x)`` one warm top-rung mixed dispatch
   measured before it; the line prints ``max_latency_over_deadline``
   (a finding, not a gate), latency per kind, each lane's queries/s, the
   stage split of a 64-row dispatch, ``knn_s`` (the phase after its
   index, which ``serve_prep`` built) and the index's build seconds; the
   ``knn_profile`` line, after every other phase of the process, gives
   that dispatch's device ops and idle share;
8k. epochs under load (``index/epoch.py EpochalIndex``, ``ServeRouter.
   advance_epoch``): 8e's zone set as an epochal index with a delta log,
   4 epochs, each upserting 8 live zones with grown or moved versions,
   inserting 4 and removing 4, each published into a router tenant's
   engine through ``advance_epoch`` while 8 closed-loop clients submit
   pip requests of 1-1,024 rows; the second goes through
   ``advance_epoch(reprofile=True)`` (the engine keeps the index's
   resolution whatever the analyzer picks, a gate); the last publish is
   killed at its torn boundary (index swapped, epoch counter not
   bumped). Gates: every
   answer equals ``pip_join`` of an epoch live while it was in flight,
   bit for bit; every request submitted after a publish returned equals
   that epoch's (or a later one's); no nvcc build and no cold compile
   after each publish; no shed or degradation; the final index equals
   ``build_chip_index(tessellate(column))`` on the card
   (``chip_index_equal``); ``EpochalIndex.replay`` of the log on the card
   equals the live index at the applied epoch, so the torn publish
   replays to a clean epoch; ``memory_allocated`` beyond the indexes
   still held grows by at most one rung's pool (the device memory the
   top rung's captured graph reserves) from epoch to epoch, and each
   replaced core is gone or holds no graph (a swap frees its graphs). Prints each epoch's apply and
   publish seconds (tessellate, append; materialize, build, swap), its
   ``memory_allocated``, the replay's seconds, ``pip_heavy_tiled``
   launches, the loop's GC pauses and its slowest request;
8m. observability (``mosaic_tpu_torch/obs``: importing it installs the
   ops plane, on in both processes): in the serving process an
   ``OpsServer(0)`` on loopback around 8d's loop, ``/metrics`` and ``/``
   scraped before it, every ``OBS_SCRAPE_S`` during it and after it.
   Gates (line ``observability_serve``): the four observers are
   installed; the Prometheus text parses; the deltas of
   ``serve.requests_completed`` and of ``serve.request_seconds``'s count
   equal the requests the loop completed; no ``obs.compile_count{kind=
   "serve_cold"}``; ``/health`` healthy in every scope; the port refuses
   once the server stopped; 8e's exhausted retries leave a flight-recorder
   dump (``MOSAIC_RECORDER_DIR``, the process's run directory) whose
   trigger is the failing ``serve.dispatch`` span's ``retry_exhausted``
   and whose file the port's ``read_trail`` reads back equal; the
   timeline of 8d's trail sums to its wall within 1e-6; its Chrome trace
   re-reads with every ``dur >= 0`` and a queue_wait track. In this
   process, after the serving process returned, over 8b's synchronous
   durable run's trail and 8d's (line ``observability``): the stream
   trail's timeline sums to its wall, ``fleet_report`` stitches the two
   into 2 incarnations in wall-clock order, ``doctor``'s cold_compiles
   check is green, and ``perf_gate`` with a 10x slowdown of the committed
   card golden's largest required stage is red. Findings, not gates:
   ``perf_gate``'s verdict against the golden
   (``mosaic_tpu_torch/tools/goldens/perf_gate.json``), the doctor's other
   checks, ``trace_report``'s top stages, ``stall_report``'s classes, and
   the host µs of a ``telemetry.record`` with and without the observers
   beside 8d's events a request and requests/s. The ``stream`` (8b) and
   ``serve_profile`` (8d) lines give the timeline's class shares of their
   profiled windows beside the profiler's idle share.
   ``python3 chip_smoke.py --keep-trails DIR`` copies the two trails to
   ``DIR``, the input of ``perf_gate --update``;
9. a ``kernels`` line with each kernel's launches (their sum over the
   paths above, and each path's own count), times and bound, and each
   raster kernel's device time per launch in the crop profile.

A kernel's ``ms`` is its device time per launch from the profiler over
repeated calls at the phase's shapes; ``wrapper_ms`` is CUDA events
around the wrapper call, which a short kernel leaves to the host's
dispatch.

The build phase reports each kernel's FFMA/DFMA count in the SASS
(``cuobjdump -sass``): the kernels build with ``-fmad=false``, so only
IEEE division's own sequence holds any.

Every phase prints one JSON line; a line whose gates hold a false one
names them (``failed_gates``); any failed check prints ``{"phase":
"failed", "in": <phase>, "why": ..., "t_s": ...}`` on stdout and exits
non-zero, and so does a serving process killed at its time limit (with
the phase of its last line). The last line is ``{"ok": true, "device":
{...}}``. Exits non-zero without a result when no CUDA card is available
or the package is missing.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import types
import warnings
import weakref

HERE = os.path.dirname(os.path.abspath(__file__))

N_POINTS = 4_000_000       # the bench's batch
N_ZONE = 500_000           # the bench's zone-kernel lane
N_ZONE_CHECK = 16_384      # subset held against the plain version
N_ORACLE = 100_000         # subset held against the f64 host oracle
N_EXACT = 1_000_000        # subset of the exact join held against its f64 oracle
N_DRIFT = 1_000_000        # global points a drift-sweep configuration
N_FAULT = 200_000          # points of each fault-pass join
WATCHDOG_S = 2.0           # the fault pass's watchdog deadline
RASTER = (2400, 2400)      # width, height: the Landsat 30 m class over NYC
CROP = 1024                # side of the crop held against the f64 oracles
NODATA = 32767
RES = 9
SEED = 11
ZONES = (16, 16)
DEVICE = "cuda"
STREAM_RING = 8            # ring slots of N_POINTS: the stream bench's --ring 8
STREAM_BATCHES = 25        # 25 x 4M = 100M points, the stream bench's long run
STREAM_HEADROOM = 1.05     # cap headroom over the largest slot's exact counts
STREAM_POISON = 1000       # rows poisoned in each of 3 admitted batches
STREAM_EVERY1_REPS = 1     # runs of each executor snapshotting every batch
RASTER_WARM_REPS = 1       # warm whole-raster calls of each raster path
PROFILE_CROP = 512         # side of the crop's middle that the profiler traces
RUNS_DIR = ".chip_smoke_runs"  # run directories of the durable phases (removed)
CHILD_TIMEOUT_S = 600       # the serving process after go (8d-8f, 8j, 8k)
SERVE_DIR = ".chip_smoke_serve"  # the serving process's index, result and epoch log (removed)
RELAUNCH_DIR = ".chip_smoke_relaunch"  # 8s's store and the package copy it relaunches (removed)
RELAUNCH_REQUESTS = 200     # 8s's requests, 8d's mix of 1-1,024 rows
RELAUNCH_SEED = 29
RELAUNCH_TIMEOUT_S = 300    # the relaunch process, from its start
REFUSAL_LADDER = (64, 1024)  # the refusal cores' ladder: 5 of 8d's rungs
# serving (8d-8f): the reference serve bench's settings
# (tools/serve_bench.py defaults) and SERVE_TENANT_r16.json's traffic
SERVE_LADDER = (64, 16384)  # --min-bucket, --max-bucket
SERVE_MAX_BATCH = 16384     # --max-batch
SERVE_WINDOW_S = 0.002      # --window-ms 2
SERVE_QUEUE = 64            # --queue-cap, the per-tenant quota
SERVE_DEADLINE_S = 2.0      # --deadline-ms 2000
SERVE_CLIENTS = 8           # --concurrency, closed loop
SERVE_REQUESTS = 2000       # of 1-1,024 rows each (--rows-min/max), ~1M points
SERVE_ROWS = (1, 1024)
SERVE_SEED = 7
SERVE_PROFILED = 50         # requests in the profiled window
SERVE_POISON = 100          # NaN rows of the parked request
SWAP_SEED = 12              # zones of the index swapped in under load
SWAP_BOX = 0.25             # share of the bbox they cover, in its middle
TENANTS = 3                 # tenant_0 the aggressor
TENANT_RATE = 150.0         # requests/s of each victim, open loop
TENANT_MULT = 15.0          # the aggressor's multiple of rate and requests
TENANT_REQUESTS = 100       # per victim
EXPR_KEEP = 0.8             # share of band 3's valid pixels the expr mask keeps
OVERLAY_N = 55              # squares per side per table (tools/overlay_bench.py: 110)
OVERLAY_RES = 4
OVERLAY_REPS = 3
# KNN (8j): the reference's test_knn_serve.py square candidates over NYC
KNN_CANDIDATES = 10_000     # squares, uniform corners and sides
KNN_SIDE = (0.5, 1.5)       # side range in H3 res-9 cell widths
KNN_RES = 9
KNN_K = 5
KNN_SEED = 19
KNN_ORACLE = 32             # queries held against brute_force_knn
KNN_ROWS = 64               # rows of the lane and CPU comparisons
KNN_LANDMARKS = 200         # SpatialKNN landmarks, card against CPU
KNN_MODEL_BOX = 0.25        # SpatialKNN's candidates: this share of the bbox
KNN_REQUESTS = 300          # mixed closed loop: half pip, half KNN
KNN_REQ_ROWS = (1, 8)       # rows of a KNN request
KNN_DEADLINE_X = 10.0       # loop deadline over one warm top-rung mixed dispatch
KNN_HEADROOM = 0.25         # most a request's latency may take of its deadline
# epochs under load (8k): deltas over 8e's swapped zone set
EPOCHS = 4
EPOCH_UPSERTS = 8           # live ids grown or moved an epoch
EPOCH_INSERTS = 4           # new ids an epoch
EPOCH_REMOVES = 4           # live ids removed an epoch
EPOCH_SEED = 13
EPOCH_POOL = 400            # requests of 1-1,024 rows the clients cycle through
EPOCH_REPROFILED = 2        # the epoch published through advance_epoch(reprofile=True)

# tuning profiles (8l) and the profiled swap (8e)
TUNE_JOIN_POINTS = 1_000_000  # points of the profiled join and its explicit twin
TUNE_TILE = (128, 128)      # the tile recommend gives a sparse raster
TUNE_TOP_ROWS = 50_000      # rows of 8e's request on the profile's top rung
PROFILE_STORE = "profile"   # 8l's store under the serving process's directory
OBS_DIR = ".chip_smoke_obs"  # 8m's two trails: the durable stream's and 8d's (removed)
OBS_SCRAPE_S = 0.2          # the ops server's scrape period during 8d's loop
OBS_PROBE_N = 10_000        # telemetry.record calls a round of the cost probe
OBS_PROBE_ROUNDS = 5        # interleaved rounds, with and without the observers
MESH_SHARDS = 4             # 8n's shards
MESH_BATCH = 65_536         # 8n's pip_join chunk: the dispatch ladder's top rung
MESH_STREAM = 1 << 20       # points of each of 8n's 3 stream batches
MESH_REQUESTS = 200         # 8n's served requests, 1-1,024 rows each
MESH_LADDER = (64, 1024)    # 8n's serving ladder
MESH_SEED = 23
FN_PAIRS = 16_384           # 8o's row pairs of the pair predicates
FN_PAIRS_CPU = 1_024        # the first pairs, held against the CPU bit for bit
FN_ORACLE = 2_048           # the first pairs held against the f64 oracle ...
FN_ORACLE_DIST = 128        # ... and of st_distance (a Python loop a vertex)
FN_CELL_CPU = 100_000       # points whose card cells are compared with the CPU's
FN_TESS_ZONES = 16          # zones 8o tessellates again, held to phase 3's chips of them
FILES_DIR = ".chip_smoke_files"  # 8p's vector files and GeoTIFFs (removed)
FILES_TESS_ZONES = 16       # read-back zones 8p tessellates and joins
FILES_CRS_SRIDS = (32618, 27700, 3857, 3067, 5880)  # 8p's device CRS lane
FILES_CRS_CHECK = 65_536    # points of each code held against the numpy lane
FILES_UTM_PIXEL = 30.0      # metres, the UTM 18N GeoTIFF's pixel
FILES_GRID_TILE = 512       # raster_to_grid's retileSize
UTILS_DIR = ".chip_smoke_utils"  # 8q's trace and map page (removed)
MODELS_DIR = ".chip_smoke_models"  # 8r's checkpoints (removed)
MODELS_ITERATIONS = 4       # 8r's transformer steps, one 1M slice of the 4M batch each
BENCH_TRIALS = 5            # 8q's utils.benchmark trials of the warm 4M join
VIZ_CELLS = 2_000           # phase 3's cells 8q draws with viz.plot_cells
#: 8p's torch-lane bands against the numpy lane (the reference's device
#: bands: tests/test_crs_affine.py, tests/test_crs_proj.py), forward in
#: projected units, inverse in degrees
FILES_CRS_BANDS = {27700: (1e-5, 1e-6), 3067: (1e-6, 1e-6), 5880: (1e-6, 1e-5),
                   32618: (1e-6, 1e-6), 3857: (1e-6, 1e-6)}
#: WKT1 of EPSG:32618 as GDAL writes it: the shapefile writer emits a .prj
#: only for 4326, 27700 and 3857
UTM18N_PRJ = (
    'PROJCS["WGS 84 / UTM zone 18N",GEOGCS["WGS 84",DATUM["WGS_1984",'
    'SPHEROID["WGS 84",6378137,298.257223563]],PRIMEM["Greenwich",0],'
    'UNIT["degree",0.0174532925199433]],PROJECTION["Transverse_Mercator"],'
    'PARAMETER["latitude_of_origin",0],PARAMETER["central_meridian",-75],'
    'PARAMETER["scale_factor",0.9996],PARAMETER["false_easting",500000],'
    'PARAMETER["false_northing",0],UNIT["metre",1],AUTHORITY["EPSG","32618"]]'
)
#: where ``--keep-trails DIR`` copies 8m's trails (the card golden's input)
KEEP_TRAILS = None

#: H100 SXM rates: HBM3 bytes/s (NVIDIA data sheet); single f32 and f64
#: operations per second outside the tensor cores. The data sheet's 67 and
#: 34 TFLOP/s count a fused multiply-add as two operations; the kernels
#: build with -fmad=false and the counts below are of single operations,
#: so the rate is one per lane and clock: 132 SMs x 128 f32 lanes (64 f64
#: lanes) x 1.98 GHz
PEAK_F32 = 132 * 128 * 1.98e9
PEAK_F64 = 132 * 64 * 1.98e9
PEAK_BYTES = 3.35e12
#: f32 operations of the heavy kernel, counted on the work its inputs need:
#: the straddle test of a (point, real edge) pair (2 compares, 1
#: inequality); the crossing of a straddling pair (3 subtractions, 1
#: multiply, 1 divide, 1 add, 1 compare); the band's distance of a real
#: edge up to the first one within the band (4 subtractions for the edge
#: and offset vectors, 3 for the squared length, 3 for the dot product, 2
#: compares deciding the clamp, 4 for the residual, 3 for its squared
#: length, 1 compare), plus its one divide where the clamp is not decided
OPS_STRADDLE = 3
OPS_CROSS = 7
OPS_BAND = 20
#: f32 operations per (point, zone slot, edge) test of the zone kernel, the
#: count bench.py uses for the same lane
OPS_ZONE = 8
#: floor on the recheck=False join's agreement with the f64 host oracle.
#: Exact agreement is not expected there (f32 cells and edges differ from
#: f64 near cell and zone boundaries; phase 6b's recheck join must agree
#: exactly); a path that is wrong, and not merely rounded, falls far below
MIN_ORACLE_AGREEMENT = 0.99
#: events a timed or gated join must not record: only the fault pass
#: injects faults
FAULT_EVENTS = ("transient_retry", "degraded", "retry_exhausted", "watchdog_stall",
                "capacity_overflow")
#: zonal_tiled sums in chunk order, its plain version in another order, both
#: in f64 rounded once to f32: on float data the two sums may differ at a
#: rounding tie, by one f32 ulp, far inside this share of the segment's sum
#: of |v|
ZONAL_SUM_RTOL = 1e-6


START = time.perf_counter()
#: the phase of the last line printed, named by a failure
LAST_PHASE = "start"


def emit(obj) -> None:
    """Print one JSON line; a phase line carries the script's elapsed
    seconds as ``t_s``, and a line whose ``gates`` hold a false one names
    them in ``failed_gates``."""
    global LAST_PHASE
    if "phase" in obj:
        LAST_PHASE = obj["phase"]
        bad = [k for k, v in obj.get("gates", {}).items() if not v]
        obj = {**obj, **({"failed_gates": bad} if bad else {}),
               "t_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def fail(msg: str, where: str | None = None) -> int:
    """Report a failure on stdout (a ``failed`` line naming the phase it
    came in) and stderr; returns the exit code 1."""
    where = where or LAST_PHASE
    print(json.dumps({"phase": "failed", "in": where, "why": msg,
                      "t_s": time.perf_counter() - START}), flush=True)
    print(f"chip_smoke: FAILED in {where}: {msg}", file=sys.stderr, flush=True)
    return 1


def result_rows(r) -> dict:
    """{key: (count, sum, min, max)} with the f64 bit patterns kept."""
    return {
        int(k): (int(c), float(s).hex(), float(mn).hex(), float(mx).hex())
        for k, c, s, mn, mx in zip(r.keys, r.count, r.sum, r.min, r.max)
    }


def same_bits(a, b) -> bool:
    """Tensors of two results equal bit for bit (-0.0 is not +0.0, NaN
    payloads count)."""
    import torch

    def view(t):
        t = t.detach().cpu().contiguous()
        return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)

    return all(x.dtype == y.dtype and torch.equal(view(x), view(y)) for x, y in zip(a, b))


def agreement(got, want) -> float:
    """Share of the rows of either result that the other matches bit for
    bit (keys, counts, and the f64 bits of sum, min and max)."""
    a, b = result_rows(got), result_rows(want)
    keys = set(a) | set(b)
    return sum(a.get(k) == b.get(k) for k in keys) / len(keys) if keys else 1.0


def square_grid(n: int, x0: float, y0: float, size: float, pitch: float):
    """n x n CCW squares of ``size`` on a ``pitch`` lattice, row by row (the
    overlay bench's tables, built as CSR arrays instead of WKT; the same
    f64 corners)."""
    import numpy as np

    from mosaic_tpu_torch.core.types import GeometryType, PackedGeometry

    j, i = np.divmod(np.arange(n * n), n)
    x = x0 + i * pitch
    y = y0 + j * pitch
    xy = np.stack([np.stack([x, y], -1), np.stack([x + size, y], -1),
                   np.stack([x + size, y + size], -1), np.stack([x, y + size], -1)],
                  axis=1).reshape(-1, 2)
    k = np.arange(n * n + 1, dtype=np.int64)
    return PackedGeometry(
        xy=xy, ring_offsets=4 * k, part_offsets=k, geom_offsets=k,
        geom_type=np.full(n * n, int(GeometryType.POLYGON), np.uint8),
        srid=np.full(n * n, 4326, np.int32),
    )


def middle(raster, side: int):
    """The ``side`` x ``side`` middle of ``raster``, georeferenced."""
    from mosaic_tpu_torch.raster import Raster

    r0 = (raster.height - side) // 2
    c0 = (raster.width - side) // 2
    wx, wy = raster.raster_to_world(c0, r0)
    gt = raster.gt
    return Raster(data=raster.data[:, r0:r0 + side, c0:c0 + side].copy(),
                  gt=(float(wx), gt[1], gt[2], float(wy), gt[4], gt[5]),
                  srid=raster.srid, nodata=raster.nodata)


def profile_device(fn):
    """(device busy ms, [(ms, op, calls)] by device op, wall ms) of one
    call of ``fn`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels and copies): the host-side
        # aten ops carry the same device time again
        if "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        if ev.key.startswith("Activity Buffer"):  # profiler bookkeeping
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows, wall_ms


def sass_fma_counts(build) -> dict:
    """{library: {kernel: {"FFMA": n, "DFMA": n}}} from ``cuobjdump -sass``
    of each built library: multiply-adds the compiler fused on its own
    (none with -fmad=false; IEEE division's own sequence uses FFMA), or
    "not measured" without cuobjdump."""
    out = {}
    for name in build.SOURCES:
        try:
            tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
            sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                                  capture_output=True, text=True, timeout=120).stdout
        except (OSError, RuntimeError) as exc:
            return {"not measured": str(exc)[:200]}
        counts, fn = {}, None
        for ln in sass.splitlines():
            if "Function :" in ln:
                fn = ln.split("Function :", 1)[1].strip()
                counts[fn] = {"FFMA": 0, "DFMA": 0}
            elif fn is not None:
                for op in ("FFMA", "DFMA"):
                    if f" {op} " in ln or f" {op}." in ln:
                        counts[fn][op] += 1
        out[name] = counts
    return out


#: device-op name fragments of each hand-written kernel, for the profiles:
#: every device kernel its wrapper launches, the one counted as the launch
#: first (pip_heavy_tiled's memset of its row counts is a memset, not a
#: named kernel: phase 4 counts it, the crop profiles cannot tell it apart)
KERNEL_OPS = {
    "pip_heavy_tiled": ("pip_heavy_kernel", "pip_heavy_hist_kernel",
                        "pip_heavy_scan_kernel", "pip_heavy_scatter_kernel"),
    "pip_zone": ("pip_zone_kernel",),
    "zonal_tiled": ("zonal_tiled_partial_kernel", "zonal_tiled_merge_kernel"),
    "zonal_seq_fold": ("zonal_seq_fold_kernel",),
}


def kernel_times(rows) -> dict:
    """{kernel: {"ms", "launches", "ms_per_launch"}} from a profile's device
    ops; a kernel of several device kernels counts the first one's calls as
    its launches."""
    out = {}
    for name, frags in KERNEL_OPS.items():
        ms, calls = 0.0, 0
        for dev_ms, key, c in rows:
            if any(f in key for f in frags):
                ms += dev_ms
                if frags[0] in key:
                    calls += c
        if calls:
            out[name] = {"ms": ms, "launches": calls, "ms_per_launch": ms / calls}
    return out


def idle_share(busy_ms, rows, warm_ms) -> dict:
    """Device busy time and idle share against an unprofiled warm call."""
    if not rows:
        return {"device_busy_ms": "not measured", "device_idle_share": "not measured"}
    return {"device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / warm_ms)}


def timeline_shares(events) -> dict | None:
    """The timeline's class shares of a window's trail (``obs/timeline.py``:
    the host's view, beside the profiler's device idle share of the same
    window), with the window it picked."""
    from mosaic_tpu_torch.obs import timeline

    attr = timeline.attribute(events)
    if attr is None:
        return None
    return {"window": attr["window"]["source"], "wall_s": attr["wall_s"],
            **{c: v["share"] for c, v in attr["classes"].items()}}


def count_syncs(fn) -> tuple:
    """(count, first message) of the host synchronisations ``fn()`` makes
    (torch's sync debug mode, one warning each; a lower bound: the mode
    is a prototype)."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    msgs = [str(x.message) for x in w if "synchroniz" in str(x.message).lower()
            and "prototype" not in str(x.message)]
    return len(msgs), msgs[:1]


def dispatch_ms(core, pts, reps=20) -> float:
    """Host ms of one warm ``core.execute_padded(pts)``."""
    core.execute_padded(pts)
    t0 = time.perf_counter()
    for _ in range(reps):
        core.execute_padded(pts)
    return (time.perf_counter() - t0) / reps * 1e3


def dispatch_contention(core, pts) -> dict:
    """Host ms of one ``core.execute_padded(pts)``: alone, beside a
    thread that wakes 2,250 times a second and holds the GIL 80 µs each
    time (the router's aggressor submitting), and beside a thread that
    never leaves Python. A dispatch releases and retakes the GIL at each
    of its eager ops, so it waits at each for the other thread."""
    stop = threading.Event()

    def ticker():
        nxt = time.perf_counter()
        while not stop.is_set():
            nxt += 1 / 2250
            lag = nxt - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            t = time.perf_counter()
            while time.perf_counter() - t < 80e-6:
                pass

    def busy():
        while not stop.is_set():
            pass

    out = {}
    for name, target, reps in (("alone", None, 20), ("ticker_2250hz_80us", ticker, 20),
                               ("busy_python_thread", busy, 2)):
        stop.clear()
        th = threading.Thread(target=target, daemon=True) if target else None  # lint: thread-context-adoption-ok (a GIL-contention thread: it runs no mosaic code)
        if th:
            th.start()
        out[name] = dispatch_ms(core, pts, reps)
        stop.set()
        if th:
            th.join()
    return out


def expr_overlay_phases(ix, H3, dev, n_zones, counted, cuda_ms, runs_dir, fold_eng):
    """Phases 8g-8i over phase 3's index ``ix``: returns the launch counts
    and fold checks the kernels line reads, or a non-zero exit code."""
    import numpy as np
    import torch

    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.datasets import NYC_BBOX, synthetic_raster
    from mosaic_tpu_torch.kernels import zonal as Z
    from mosaic_tpu_torch.raster import Raster, ZonalEngine, plan_tiles
    from mosaic_tpu_torch.runtime import faults
    from mosaic_tpu_torch.sql import RasterStream

    def counted_run(call):
        for fn in counted.values():
            fn.launches = 0
        out_ = call()
        return out_, {k: fn.launches for k, fn in counted.items()}

    # 8g. expressions (mosaic_tpu_torch/expr): a three-band raster of the
    # same size over the same zones; NDVI masked where band 3 is high, one
    # fused program a tile into the f64 fold (zonal_seq_fold), by zones,
    # by grid cell and through .join()
    from mosaic_tpu_torch import expr as E
    from mosaic_tpu_torch.dispatch import backend_compiles
    from mosaic_tpu_torch.expr import compile as EC
    from mosaic_tpu_torch.expr import eval as EV

    raster3 = synthetic_raster(*RASTER, NYC_BBOX, bands=3, nodata=NODATA, seed=SEED)
    crop3 = middle(raster3, CROP)
    n_tiles = plan_tiles(raster3).ntiles
    real_pixels = raster3.height * raster3.width
    b3 = raster3.data[2]
    thr = float(np.quantile(b3[b3 != NODATA], EXPR_KEEP))
    value = E.ndvi(nir=2, red=1).mask_where(E.band(3) < thr)
    tree, gtree = value.zonal(by="zones"), value.zonal(by="grid")
    eng_x = ZonalEngine(H3, RES, chip_index=ix, device=dev)
    nv_w = backend_compiles()
    t0 = time.perf_counter()
    eng_x.warmup_expr(tree, raster3)
    eng_x.warmup_expr(gtree, raster3)
    warmup_x_s = time.perf_counter() - t0
    # the staged pipeline: the value per pixel, then the fold lane's zones
    t0 = time.perf_counter()
    px, pvalid = E.map_pixels(value, raster3, index_system=H3, resolution=RES,
                              device=dev)
    pixels_s = time.perf_counter() - t0
    staged_r = Raster(data=np.where(pvalid, px, np.nan)[None], gt=raster3.gt,
                      srid=raster3.srid, nodata=float("nan"))
    t0 = time.perf_counter()
    staged = ZonalEngine(H3, RES, chip_index=ix, lane="fold", device=dev).zones(staged_r)
    staged_s = pixels_s + time.perf_counter() - t0
    del px, pvalid, staged_r
    EC.freeze()
    nv0, cold0 = backend_compiles(), EC.cold_compiles()
    t0 = time.perf_counter()
    # warmup_expr ran every tile shape, so this first call is warm
    fused, x_launches = counted_run(lambda: eng_x.map(tree, raster3))
    fused_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fgrid, xg_launches = counted_run(lambda: eng_x.map(gtree, raster3))
    grid_x_s = time.perf_counter() - t0
    staged_agree = agreement(fused, staged)
    # the 1024 crop: fused against the f64 host oracles; the join's zone
    # rows against the rows the fold lane's zones fold by
    fused_crop = eng_x.map(tree, crop3)
    t0 = time.perf_counter()
    crop_oracle_agree = agreement(fused_crop, E.host_expr_zonal_oracle(
        crop3, tree, index_system=H3, resolution=RES, chip_index=ix))
    grid_oracle_agree = agreement(eng_x.map(gtree, crop3), E.host_expr_zonal_oracle(
        crop3, gtree, index_system=H3, resolution=RES))
    x_oracle_s = time.perf_counter() - t0
    jz, _jv, jvalid = eng_x.map(value.join(), crop3)
    cplan3 = plan_tiles(crop3)
    th3, tw3 = cplan3.shape
    rows_plane = np.full((CROP, CROP), -1, np.int32)
    for t in range(cplan3.ntiles):
        ro, co = (int(v) for v in cplan3.origins[t])
        g_t = fold_eng._tile_zone_rows(cplan3, t).reshape(th3, tw3)
        rows_plane[ro:ro + th3, co:co + tw3] = np.where(g_t >= 0, g_t, -1)
    rows_plane[~jvalid] = -1
    jcount = np.bincount(jz[jz >= 0], minlength=n_zones)
    join_ok = (np.array_equal(jz, rows_plane)
               and np.array_equal(jcount[fused_crop.keys], fused_crop.count)
               and int(jcount.sum()) == int(fused_crop.count.sum()))
    # one crop tile's fold held against the CPU lane, at the fused
    # program's shapes: (P,) f64 values and validity, S = the zones
    vals3, mask3 = EV.stack_bands(crop3, cplan3, E.bands_of(value))
    t_chk = cplan3.ntiles // 2
    g_chk = fold_eng._tile_zone_rows(cplan3, t_chk)
    seg_chk = torch.from_numpy(np.where(g_chk >= 0, g_chk, -1).astype(np.int32)).to(dev)
    v_chk, m_chk = EC.pixel_program(value, th3, tw3, H3, RES)(
        np.asarray(cplan3.gt, np.float64), cplan3.origins[t_chk],
        torch.from_numpy(vals3[t_chk]).to(dev), torch.from_numpy(mask3[t_chk]).to(dev),
        seg_chk)
    segm_chk = torch.where(m_chk, seg_chk, -1)
    x_fold = Z.zonal_fold(v_chk, segm_chk, n_zones, acc_dtype=torch.float64)
    x_fold_cpu = Z.zonal_seq_fold_plain(v_chk.cpu(), segm_chk.cpu(), n_zones,
                                        acc_dtype=torch.float64)
    x_fold_equal = same_bits(x_fold, x_fold_cpu)
    x_fold_err = float((x_fold[1].cpu() - x_fold_cpu[1]).abs().max())
    x_fold_ms = cuda_ms(lambda: Z.zonal_fold(v_chk, segm_chk, n_zones,
                                             acc_dtype=torch.float64))
    prog_x = EC.zonal_program(E.terminal_of(tree)[0], th3, tw3, n_zones, "float64",
                              H3, RES)
    prog_ops = EC.program_ops(prog_x, np.asarray(cplan3.gt, np.float64),
                              cplan3.origins[t_chk],
                              torch.from_numpy(vals3[t_chk]).to(dev),
                              torch.from_numpy(mask3[t_chk]).to(dev), seg_chk)
    pcrop3 = middle(raster3, PROFILE_CROP)
    t0 = time.perf_counter()
    eng_x.map(tree, pcrop3)
    crop_x_s = time.perf_counter() - t0
    busy_x, rows_x, prof_x_ms = profile_device(lambda: eng_x.map(tree, pcrop3))
    expr_kernels = kernel_times(rows_x)
    x_ok = {
        "fused_equal_to_staged": staged_agree == 1.0,
        "fused_crop_equal_to_oracle": crop_oracle_agree == 1.0,
        "grid_crop_equal_to_oracle": grid_oracle_agree == 1.0,
        "join_rows_equal_to_fold_zones_rows": join_ok,
        "tile_fold_equal_to_cpu_lane": x_fold_equal,
        "launched_pip_heavy_tiled": x_launches["pip_heavy_tiled"] > 0,
        "launched_zonal_seq_fold": x_launches["zonal_fold"] > 0
        and xg_launches["zonal_fold"] > 0,
    }
    emit({
        "phase": "expr", "pixels": real_pixels, "tiles": n_tiles, "bands": 3,
        "tree": repr(E.structure_key(tree)), "band3_threshold": thr,
        "kept_share_of_band3_valid": EXPR_KEEP,
        "keys": int(fused.keys.size), "pixels_folded": int(fused.pixels),
        "warmup_s": warmup_x_s, "nvcc_builds_in_warmup": backend_compiles() - nv_w,
        "fused_s": fused_s, "fused_pixels_per_s": real_pixels / fused_s,
        "staged_s": staged_s, "staged_map_pixels_s": pixels_s,
        "staged_pixels_per_s": real_pixels / staged_s,
        "grid_s": grid_x_s, "grid_pixels_per_s": real_pixels / grid_x_s,
        "grid_keys": int(fgrid.keys.size),
        "launches_zones": x_launches, "launches_grid": xg_launches,
        "program_torch_ops_per_tile": prog_ops,
        "device_ops_per_tile": sum(c for _, _, c in rows_x) / plan_tiles(pcrop3).ntiles,
        "profiled_on": f"{PROFILE_CROP}x{PROFILE_CROP} crop, "
                       f"{plan_tiles(pcrop3).ntiles} tiles",
        "crop_warm_s": crop_x_s, "profiled_wall_ms": prof_x_ms,
        **idle_share(busy_x, rows_x, crop_x_s * 1e3),
        "crop_kernels": expr_kernels,
        "top_device_ops": [{"op": k[:80], "ms": ms, "calls": c} for ms, k, c in rows_x[:6]],
        "tile_fold_ms": x_fold_ms, "tile_fold_max_abs_err": x_fold_err,
        "oracle_s": x_oracle_s, "gates": x_ok,
    })
    bad_gates = [k for k, v in x_ok.items() if not v]
    if bad_gates:
        return fail(f"expr gates failed: {bad_gates}")

    # 8h. the durable expression scan over the whole three-band raster,
    # then durability on the crop
    rs_x = RasterStream(ix, H3, RES)
    xscan, xs_launches = counted_run(lambda: rs_x.scan(raster3, expr=tree))
    xscan_agree = agreement(xscan.stats, fused)
    xcrop_clean = rs_x.scan(crop3, expr=tree)
    os.makedirs(runs_dir, exist_ok=True)
    dkx = os.path.join(runs_dir, "expr_kill")
    with faults.inject(fail_first=99, skip_first=8, sites=("raster.zonal",),
                       exc_factory=lambda site: RuntimeError("simulated device loss")):
        try:
            rs_x.scan(crop3, expr=tree, run_dir=dkx, snapshot_every=4)
            x_killed = False
        except RuntimeError:
            x_killed = True
    xcrop_resumed = rs_x.resume(dkx, crop3, expr=tree)
    try:
        rs_x.resume(dkx, crop3, expr=E.ndvi(nir=3, red=1).zonal())
        other_refused = False
    except ValueError:
        other_refused = True
    shutil.rmtree(runs_dir, ignore_errors=True)
    nv1, cold1 = backend_compiles(), EC.cold_compiles()
    xs_ok = {
        "scan_equal_to_map_zonal": xscan_agree == 1.0,
        "crop_equal_to_map_zonal": agreement(xcrop_clean.stats, fused_crop) == 1.0,
        "resume_equal": x_killed and xcrop_resumed.metrics["resumed_from"] == 8
        and agreement(xcrop_resumed.stats, xcrop_clean.stats) == 1.0,
        "other_tree_refused": other_refused,
        "no_cold_compile_after_warmup": cold1 == cold0,
        "no_nvcc_build_after_warmup": nv1 == nv0,
        "launched_pip_heavy_tiled": xs_launches["pip_heavy_tiled"] > 0,
        "launched_zonal_seq_fold": xs_launches["zonal_fold"] > 0,
    }
    emit({
        "phase": "expr_scan", "pixels": real_pixels, "tiles": xscan.ntiles,
        "wall_s": xscan.wall_s, "tiles_per_s": xscan.ntiles / xscan.wall_s,
        "pixels_per_s": real_pixels / xscan.wall_s,
        "map_zonal_tiles_per_s": n_tiles / fused_s,
        "launches": xs_launches, "pipeline": xscan.metrics["pipeline"],
        "crop_wall_s": xcrop_clean.wall_s, "crop_resume_wall_s": xcrop_resumed.wall_s,
        "cold_compiles_after_warmup": cold1 - cold0,
        "nvcc_builds_after_warmup": nv1 - nv0, "gates": xs_ok,
    })
    bad_gates = [k for k, v in xs_ok.items() if not v]
    if bad_gates:
        return fail(f"expr_scan gates failed: {bad_gates}")
    del raster3, vals3, mask3

    # 8i. the overlay join (sql/overlay.py): the reference overlay bench's
    # two square-grid tables on the custom grid, overlap_fraction() over
    # every pair of geometries sharing a cell; device lane against the
    # f64 host lane
    from mosaic_tpu_torch.core.index import CustomIndexSystem, GridConf
    from mosaic_tpu_torch.sql import overlay as OV

    ogrid = CustomIndexSystem(GridConf(-180, 180, -90, 90, 2, 10.0, 10.0))
    cw, _ = ogrid.cell_size(OVERLAY_RES)
    left = square_grid(OVERLAY_N, -80.0, -82.0, 2.2 * cw, 2.4 * cw)
    right = square_grid(OVERLAY_N, -80.0 + 0.73 * cw, -82.0 + 0.49 * cw,
                        2.2 * cw, 2.4 * cw)
    t0 = time.perf_counter()
    lt = tessellate(left, ogrid, OVERLAY_RES)
    rt = tessellate(right, ogrid, OVERLAY_RES)
    tess_o_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = OV.prepare_overlay(lt, rt, left, right, ogrid, OVERLAY_RES, device=dev)
    prep_s = time.perf_counter() - t0
    ovalue = E.overlap_fraction()
    t0 = time.perf_counter()
    OV.warmup_overlay(left, right, ogrid, OVERLAY_RES, ovalue, prep=prep)
    warm_o_s = time.perf_counter() - t0
    EC.freeze()
    nv0, cold0 = backend_compiles(), EC.cold_compiles()

    def measure():
        out = OV.overlay_measures(left, right, ogrid, OVERLAY_RES, ovalue, prep=prep)
        torch.cuda.synchronize()
        return out

    odev, o_launches = counted_run(measure)
    o_s = []
    for _ in range(OVERLAY_REPS):
        t0 = time.perf_counter()
        measure()
        o_s.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ohost = OV.overlay_measures(left, right, ogrid, OVERLAY_RES, ovalue, prep=prep,
                                lane="host")
    ohost_s = time.perf_counter() - t0
    nv1, cold1 = backend_compiles(), EC.cold_compiles()
    o_agree = {f: float(np.asarray(getattr(odev, f)).dtype == np.asarray(getattr(ohost, f)).dtype
                        and np.asarray(getattr(odev, f)).tobytes()
                        == np.asarray(getattr(ohost, f)).tobytes())
               for f in ("pairs", "value", "valid", "area", "sure")}
    # the fold at the overlay's shapes, held against the CPU lane: the
    # program's own fold inputs, recorded on one call
    seen = {}
    real_fold = EC.zonal_fold_masked

    def recording_fold(values, valid, seg, num_segments, *, acc_dtype=None):
        seen.update(v=values.clone(), m=valid.clone(), s=seg.clone(), k=num_segments)
        return real_fold(values, valid, seg, num_segments, acc_dtype=acc_dtype)

    EC.zonal_fold_masked = recording_fold
    try:
        measure()
    finally:
        EC.zonal_fold_masked = real_fold
    segm_o = torch.where(seen["m"], seen["s"], -1)
    o_fold = Z.zonal_fold(seen["v"], segm_o, seen["k"], acc_dtype=torch.float64)
    o_fold_cpu = Z.zonal_seq_fold_plain(seen["v"].cpu(), segm_o.cpu(), seen["k"],
                                        acc_dtype=torch.float64)
    o_fold_equal = same_bits(o_fold, o_fold_cpu)
    o_fold_ms = cuda_ms(lambda: Z.zonal_fold(seen["v"], segm_o, seen["k"],
                                             acc_dtype=torch.float64))
    busy_o, rows_o, prof_o_ms = profile_device(measure)
    pairs_n = int(odev.pairs.shape[0])
    o_ok = {
        **{f"agreement_{f}": v == 1.0 for f, v in o_agree.items()},
        "device_lane": odev.lane == "device" and not odev.degraded,
        "no_overflow": odev.overflow == 0,
        "no_nvcc_build_after_warmup": nv1 == nv0,
        "no_cold_compile_after_warmup": cold1 == cold0,
        "fold_equal_to_cpu_lane": o_fold_equal,
        "launched_zonal_seq_fold": o_launches["zonal_fold"] > 0,
    }
    emit({
        "phase": "overlay", "n_per_side": OVERLAY_N, "res": OVERLAY_RES,
        "geoms": len(left) + len(right), "chips": len(lt) + len(rt),
        "pairs": pairs_n, "candidates_bucket": int(seen["v"].numel()),
        "pair_segments_bucket": int(seen["k"]), "vpad": prep.vpad,
        "tessellate_s": tess_o_s, "prepare_s": prep_s, "warmup_s": warm_o_s,
        "device_s": o_s, "device_pairs_per_s": pairs_n / min(o_s),
        "host_s": ohost_s, "host_pairs_per_s": pairs_n / ohost_s,
        "host_overridden": odev.host_overridden, "overflow": odev.overflow,
        "agreement": o_agree, "launches": o_launches,
        "fold_ms": o_fold_ms, "profiled_wall_ms": prof_o_ms,
        **idle_share(busy_o, rows_o, min(o_s) * 1e3),
        "device_ops": sum(c for _, _, c in rows_o),
        "overlay_kernels": kernel_times(rows_o),
        "top_device_ops": [{"op": k[:80], "ms": ms, "calls": c} for ms, k, c in rows_o[:6]],
        "gates": o_ok,
    })
    bad_gates = [k for k, v in o_ok.items() if not v]
    if bad_gates:
        return fail(f"overlay gates failed: {bad_gates}")
    return {
        "x_launches": x_launches, "xg_launches": xg_launches,
        "xs_launches": xs_launches, "o_launches": o_launches,
        "x_fold_equal": x_fold_equal, "x_fold_ms": x_fold_ms, "x_fold_err": x_fold_err,
        "o_fold_equal": o_fold_equal, "o_fold_ms": o_fold_ms,
        "o_segments": int(seen["k"]),
        "overlay": {"left": left, "right": right, "grid": ogrid, "value": ovalue,
                    "prep": prep, "single": odev, "left_chips": lt, "right_chips": rt},
    }


def tune_phase(ix, H3, dev, zones, raw, crop, counted, timers, store_dir):
    """Phase 8l, tuning profiles on phase 3's index ``ix``, its points
    ``raw`` and the 1024 crop. ``timers`` holds main's ``cuda_ms``,
    ``device_ms`` and ``bound``; the merged profile is saved under
    ``store_dir`` for 8e. Returns the launches and the 128x128
    ``zonal_tiled`` measurement the kernels line reads, or a non-zero
    exit code."""
    import dataclasses

    import numpy as np
    import torch

    from mosaic_tpu_torch import tune as T
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.kernels import zonal as Z
    from mosaic_tpu_torch.raster import Raster, ZonalEngine, plan_tiles, stack_tiles
    from mosaic_tpu_torch.raster.zonal import host_tile_centers
    from mosaic_tpu_torch.sql import join as J
    from mosaic_tpu_torch.tune.recommend import ADAPTIVE_DENSE_SHARE

    secs = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    def counted_run(fn):
        for f in counted.values():
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: f.launches for k, f in counted.items()}

    ix_cpu = step("cpu_copy", lambda: J.ChipIndex.from_arrays(ix.to_arrays(), device="cpu"))

    def in_heavy(cells):
        u = torch.searchsorted(ix.cells, cells).clamp(max=ix.num_cells - 1)
        return (ix.cells[u] == cells) & (ix.cell_heavy[u] >= 0)

    # two point workloads: the uniform 4M points, and the ones along the
    # zone boundaries (each of them in a heavy cell, and as many in light
    # cells), whose dense share routes the probe to the adaptive lane
    hv = in_heavy(H3.point_to_cell(torch.from_numpy(raw).to(dev), RES)).cpu().numpy()
    n_hv = int(hv.sum())
    workloads = {"uniform": raw, "border": np.concatenate([raw[hv], raw[~hv][:n_hv]])}
    priors = T.load_priors()
    profs, recs, j_launches, joins_equal, cpu_equal = {}, {}, {}, {}, {}
    for name, wpts in workloads.items():
        # the profile against the card index and against its CPU copy
        profs[name] = step(f"profile_points_{name}", lambda: T.profile_points(wpts, ix, H3, RES))
        cpu_equal[name] = profs[name].as_dict() == step(
            f"profile_points_{name}_cpu", lambda: T.profile_points(wpts, ix_cpu, H3, RES)
        ).as_dict()
        rec = recs[name] = step(f"recommend_{name}", lambda: T.recommend(profs[name], priors))
        # the profile's join against the same knobs passed explicitly
        pts = wpts[:TUNE_JOIN_POINTS]
        joined, j_launches[name] = counted_run(lambda: step(
            f"pip_join_profile_{name}", lambda: J.pip_join(
                pts, None, H3, RES, chip_index=ix, profile=rec)))
        explicit = step(f"pip_join_explicit_{name}", lambda: J.pip_join(
            pts, None, H3, RES, chip_index=ix, probe=rec.probe, writeback=rec.writeback,
            lookup=rec.lookup, batch_size=rec.batch_size))
        joins_equal[name] = bool(np.array_equal(joined, explicit))

    def dense(p):
        return p.class_shares["heavy"] + p.class_shares["convex"]
    # zones through a profile's lane and tile on the crop's 64 tiles
    zprof = T.TuningProfile(zonal_lane="tiled", raster_tile=TUNE_TILE)
    zeng = ZonalEngine(H3, RES, chip_index=ix, profile=zprof)
    feng = ZonalEngine(H3, RES, chip_index=ix, lane="fold")
    ntiles = plan_tiles(crop, TUNE_TILE).ntiles
    _, z_launches = counted_run(lambda: step("zones_profile_crop", lambda: zeng.zones(crop)))
    twin = Raster(
        data=np.where(crop.data == NODATA, NODATA, crop.data % 113).astype(np.int16),
        gt=crop.gt, srid=crop.srid, nodata=crop.nodata,
    )
    twin_tiled = step("zones_profile_twin", lambda: zeng.zones(twin))
    twin_fold = step("zones_fold_twin", lambda: feng.zones(twin, tile=TUNE_TILE))
    # the kernels at 128x128: one crop tile's zone rows (the probe, its
    # pip_heavy_tiled launch) against the CPU index's plain versions, and
    # zonal_tiled on that tile's segments against zonal_tiled_plain
    plan = plan_tiles(crop, TUNE_TILE)
    vals, mask = stack_tiles(crop, plan, 1, dtype=np.float32)
    best, best_n = 0, -1
    for t in range(plan.ntiles):  # the tile with the most valid heavy-cell pixels
        c = H3.point_to_cell(torch.from_numpy(host_tile_centers(plan, t)).to(dev), RES)
        n = int((in_heavy(c).cpu().numpy() & mask[t].reshape(-1)).sum())
        if n > best_n:
            best, best_n = t, n
    maskf = mask[best].reshape(-1)
    one = dataclasses.replace(plan, origins=plan.origins[[best]])
    ceng = ZonalEngine(H3, RES, chip_index=ix_cpu, lane="tiled", device="cpu")
    rows_card = zeng._tile_zone_rows(one, 0, maskf)
    rows_cpu = ceng._tile_zone_rows(one, 0, maskf)
    n_seg = zeng.num_zones
    seg = np.where(maskf & (rows_card >= 0), rows_card, -1).astype(np.int32)
    s_d = torch.from_numpy(seg).to(dev)
    live = s_d >= 0
    rng = np.random.default_rng(SEED)
    k_ok, k_err = True, 0.0
    for kind, v in (("integer", vals[best].reshape(-1) % 113),
                    ("float", rng.uniform(0, 32000, seg.size).astype(np.float32))):
        v_d = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        got, want = Z.zonal_tiled(v_d, s_d, n_seg), Z.zonal_tiled_plain(v_d, s_d, n_seg)
        torch.cuda.synchronize()
        exact3 = all(torch.equal(got[i], want[i]) for i in (0, 2, 3))
        abs_sum = torch.zeros(n_seg, dtype=torch.float64, device=dev)
        abs_sum.index_add_(0, s_d[live].long(), v_d[live].abs().double())
        sum_err = (got[1].double() - want[1].double()).abs()
        k_ok = k_ok and exact3 and (torch.equal(got[1], want[1]) if kind == "integer"
                                    else bool((sum_err <= ZONAL_SUM_RTOL * abs_sum).all()))
        k_err = max(k_err, float(sum_err.max()))
    cuda_ms, device_ms, bound = timers["cuda_ms"], timers["device_ms"], timers["bound"]
    b_ms, b_by = bound(seg.size * (4 + 4) + 4 * n_seg * 4, 4 * seg.size)
    k128 = {
        "pixels": int(seg.size), "live_pixels": int(live.sum()), "heavy_pixels": best_n,
        "match": k_ok, "max_abs_err": k_err,
        "ms": device_ms(lambda: Z.zonal_tiled(v_d, s_d, n_seg), "zonal_tiled"),
        "wrapper_ms": cuda_ms(lambda: Z.zonal_tiled(v_d, s_d, n_seg)),
        "plain_ms": cuda_ms(lambda: Z.zonal_tiled_plain(v_d, s_d, n_seg), reps=5),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    # the polygons' profile, merged, through a store bound to the index
    pprof = step("profile_polygons", lambda: T.profile_polygons(zones, H3))
    prec = T.recommend(pprof, priors)
    merged = T.TuningProfile.merged(prec, recs["border"])
    fp = T.index_fingerprint(ix)
    store = T.ProfileStore(store_dir)
    step("store_save", lambda: store.save(merged, fingerprint=fp))
    loaded, payload = step("store_load", lambda: store.load_latest(expect_fingerprint=fp))
    other = J.build_chip_index(
        tessellate(zones.take(range(4)), H3, RES, keep_core_geoms=False), device=dev)
    try:
        store.load_latest(expect_fingerprint=T.index_fingerprint(other))
        refused = False
    except T.ProfileFingerprintMismatch:
        refused = True
    rprof = step("profile_raster", lambda: T.profile_raster(crop))
    gates = {
        "points_profiles_equal_cpu_copy": all(cpu_equal.values()),
        "probe_follows_the_dense_share": all(
            recs[n].probe == ("adaptive" if dense(profs[n]) > ADAPTIVE_DENSE_SHARE
                              else "scatter") for n in workloads),
        "border_workload_recommends_adaptive": recs["border"].probe == "adaptive",
        "profile_joins_equal_explicit": all(joins_equal.values()),
        "border_profile_join_launched_pip_heavy_tiled":
            j_launches["border"]["pip_heavy_tiled"] > 0,
        "profile_zones_lane_and_tile": zeng.lane == "tiled" and ntiles == 64,
        "profile_zones_launched_zonal_tiled": z_launches["zonal_tiled"] > 0,
        "profile_zones_launched_pip_heavy_tiled": z_launches["pip_heavy_tiled"] > 0,
        "tiled_equals_fold_on_twin": agreement(twin_tiled, twin_fold) == 1.0
        and float(twin_fold.sum.max()) < 2 ** 24,
        "zonal_tiled_128_equals_plain": k_ok,
        "tile_128_zone_rows_equal_cpu": bool(np.array_equal(rows_card, rows_cpu))
        and best_n > 0,
        "store_round_trip": loaded.as_dict() == merged.as_dict()
        and payload["fingerprint"] == fp,
        "fingerprint_equals_cpu_copy": T.index_fingerprint(ix_cpu) == fp,
        "other_index_refused": refused,
    }
    emit({
        "phase": "tuning", "points": {n: int(w.shape[0]) for n, w in workloads.items()},
        "join_points": TUNE_JOIN_POINTS,
        "points_profiles": {n: p.as_dict() for n, p in profs.items()},
        "probes": {n: r.probe for n, r in recs.items()},
        "recommendation": {
            k: v for k, v in merged.as_dict().items() if k not in ("rationale", "source")},
        "rationale": merged.rationale,
        "uniform_rationale": recs["uniform"].rationale, "priors": sorted(priors["artifacts"]),
        "polygons_profile": pprof.as_dict(), "raster_profile": rprof.as_dict(),
        "crop_tiles": ntiles, "tile": list(TUNE_TILE),
        "launches_join": j_launches, "launches_zones": z_launches,
        "zonal_tiled_128": k128, "seconds": secs, "gates": gates,
    })
    bad = [k for k, v in gates.items() if not v]
    if bad:
        return fail(f"tuning gates failed: {bad}")
    return {"join": j_launches["border"], "zones": z_launches, "k128": k128}


class GcPauses:
    """Garbage-collection pauses while active (``gc.callbacks``): their
    count and seconds by generation, and each pause's (start, seconds) on
    the perf_counter clock."""

    def __init__(self):
        self.pauses, self._t0 = [], None

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((self._t0, time.perf_counter() - self._t0,
                                info.get("generation")))
            self._t0 = None

    def __enter__(self):
        import gc

        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        by_gen = {}
        for _, sec, gen in self.pauses:
            c, t = by_gen.get(gen, (0, 0.0))
            by_gen[gen] = (c + 1, t + sec)
        return {"count_and_s_by_generation": {str(g): v for g, v in by_gen.items()},
                "max_s": max((p[1] for p in self.pauses), default=0.0)}


def repeat_rows(col, rows):
    """The one-ring column ``col`` gathered by ``rows`` (a vectorized
    ``col.take`` for polygons of one shell each, the smoke's zones and
    squares)."""
    import numpy as np

    from mosaic_tpu_torch.core.types import PackedGeometry

    n = len(col)
    if not (np.array_equal(col.geom_offsets, np.arange(n + 1))
            and np.array_equal(col.part_offsets, np.arange(n + 1))):
        raise ValueError("repeat_rows takes one ring a geometry")
    rows = np.asarray(rows, dtype=np.int64)
    lens = np.diff(col.ring_offsets)[rows]
    ro = np.concatenate([[0], np.cumsum(lens)])
    src = np.repeat(col.ring_offsets[:-1][rows] - ro[:-1], lens) + np.arange(ro[-1])
    k = np.arange(rows.size + 1, dtype=np.int64)
    return PackedGeometry(xy=col.xy[src], ring_offsets=ro, part_offsets=k,
                          geom_offsets=k, geom_type=col.geom_type[rows],
                          srid=col.srid[rows])


def same_column(a, b) -> bool:
    """Two PackedGeometry columns equal bit for bit: xy, offsets, types,
    SRIDs and the z lane."""
    import numpy as np

    fields = ("xy", "ring_offsets", "part_offsets", "geom_offsets", "geom_type", "srid")
    same = all(np.asarray(getattr(a, f)).dtype == np.asarray(getattr(b, f)).dtype
               and np.asarray(getattr(a, f)).tobytes() == np.asarray(getattr(b, f)).tobytes()
               for f in fields)
    return (same and (a.z is None) == (b.z is None)
            and np.array_equal(a.geom_has_z, b.geom_has_z))


def max_rel_gap(a, b, scale: float = 1e-300) -> float:
    """Largest |a - b| / max(|b|, scale) over the rows (NaN where both are
    NaN counts as no gap). A coordinate's ``scale`` is its column's
    largest coordinate magnitude: near 0 a relative gap of a coordinate
    says nothing."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    gap = np.where(both_nan, 0.0, np.abs(a - b) / np.maximum(np.abs(b), scale))
    return float(np.max(gap)) if gap.size else 0.0


def host_cell_fold(values, valid, cells):
    """{cell: (count, sum, min, max)} of the valid pixels, numpy f64, each
    sum sequential in pixel order (``np.add.at``): the host fold the
    ``rst_rastertogrid*`` projections are held to."""
    import numpy as np

    uniq, inv = np.unique(cells, return_inverse=True)
    v, m = values.astype(np.float64), valid
    k = uniq.size
    cnt = np.bincount(inv[m], minlength=k)
    s = np.zeros(k)
    np.add.at(s, inv[m], v[m])
    mn = np.full(k, np.inf)
    np.minimum.at(mn, inv[m], v[m])
    mx = np.full(k, -np.inf)
    np.maximum.at(mx, inv[m], v[m])
    return uniq, cnt, s, mn, mx


def functions_phase(ix, table, H3, dev, zones, raw, joined, host_exact, main_pps,
                    raster, crop, ov, counted, card):
    """Phase 8o, the function surface through ``MosaicContext.build("H3")``
    and its ``.functions``: codecs, device measures, pair predicates, grid,
    MosaicFrame, raster to grid and the overlay frontend, on phase 3's
    zones, the 4M batch, the raster and 8i's squares. Returns (failure
    message or None, the phase's launches by kernel)."""
    import numpy as np
    import torch

    from mosaic_tpu_torch import context as TC
    from mosaic_tpu_torch.core.geometry import measures as TM
    from mosaic_tpu_torch.core.geometry.device import pack_to_device
    from mosaic_tpu_torch.core.types import PackedGeometry, concat_packed
    from mosaic_tpu_torch.sql import overlay as OV
    from mosaic_tpu_torch.sql.frame import MosaicFrame

    t_phase = time.perf_counter()
    launches = {k: 0 for k in counted}
    secs = {}

    def run(name, call):
        """``call()`` timed (synced) with its launches added to the
        phase's; the counts are set to 0 just before it."""
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out_ = call()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counted.items()}
        for k, v in got.items():
            launches[k] += v
        return out_, got

    ctx = TC.MosaicContext.build("H3")
    F = ctx.functions
    left, right, ogrid = ov["left"], ov["right"], ov["grid"]
    squares = concat_packed([left, right])
    geoms = concat_packed([zones, squares])
    gates = {"register_names": len(ctx.register()) == 131,
             "index_system_h3": ctx.index_system.name == "H3"}

    # codecs: every format and back, bit for bit
    codec_s = {}
    readers = {"wkt": F.st_geomfromwkt, "wkb": F.st_geomfromwkb,
               "hex": F.st_geomfromwkb, "geojson": F.st_geomfromgeojson}
    for fmt, read in readers.items():
        t0 = time.perf_counter()
        back = read(F.convert_to(geoms, fmt))
        codec_s[fmt] = time.perf_counter() - t0
        gates[f"codec_{fmt}_round_trip"] = same_column(back, geoms)

    # device measures on the card, zones and squares as two columns (each
    # recentred on its own bbox)
    meas = {"st_area": F.st_area, "st_length": F.st_length,
            "st_perimeter": F.st_perimeter, "st_xmin": F.st_xmin,
            "st_ymin": F.st_ymin, "st_xmax": F.st_xmax, "st_ymax": F.st_ymax}
    m_gap = {"card_cpu": 0.0, "card_oracle": 0.0, "card_native": 0.0,
             "native_oracle": 0.0}
    m_ok = True
    card_s = 0.0
    card_cpu = {}
    coord = ("st_xmin", "st_ymin", "st_xmax", "st_ymax", "st_centroid")
    for part in (zones, squares):
        scale = float(np.abs(part.xy).max())
        for name, fn in meas.items():
            sc = scale if name in coord else 1e-300
            fn(part)  # warm
            t0 = time.perf_counter()
            got = fn(part)
            card_s += time.perf_counter() - t0
            cpu = fn(part, device="cpu")
            orc = fn(part, backend="oracle")
            nat = fn(part, backend="native")
            m_ok &= bool(np.allclose(got, orc, rtol=1e-9, atol=1e-9)
                         and np.allclose(got, nat, rtol=2e-5, atol=1e-7)
                         and np.allclose(nat, orc, rtol=1e-11, atol=1e-12))
            gap = max_rel_gap(got, cpu, sc)
            card_cpu[name] = max(card_cpu.get(name, 0.0), gap)
            m_gap["card_cpu"] = max(m_gap["card_cpu"], gap)
            m_gap["card_oracle"] = max(m_gap["card_oracle"], max_rel_gap(got, orc, sc))
            m_gap["card_native"] = max(m_gap["card_native"], max_rel_gap(got, nat, sc))
            m_gap["native_oracle"] = max(m_gap["native_oracle"], max_rel_gap(nat, orc, sc))
        t0 = time.perf_counter()
        c = F.st_centroid(part)
        card_s += time.perf_counter() - t0
        c_cpu = F.st_centroid(part, device="cpu")
        c_orc = F.st_centroid(part, backend="oracle")
        c_nat = F.st_centroid(part, backend="native")
        # the oracle's shoelace on raw NYC coordinates loses ~1e-9 of the
        # centroid to cancellation; on the column moved to its bbox middle
        # (the device's frame) it holds the 1e-9 band
        bb = part.bounds()
        mid = (bb[:, :2].min(0) + bb[:, 2:].max(0)) / 2.0
        c_rc = F.st_centroid(F.st_translate(part, -mid[0], -mid[1]), backend="oracle").xy + mid
        m_ok &= bool(np.allclose(c.xy, c_rc, rtol=1e-9, atol=1e-9)
                     and np.allclose(c.xy, c_orc.xy, rtol=2e-5, atol=1e-7)
                     and np.allclose(c.xy, c_nat.xy, rtol=2e-5, atol=1e-7))
        gap = max_rel_gap(c.xy, c_cpu.xy, scale)
        card_cpu["st_centroid"] = max(card_cpu.get("st_centroid", 0.0), gap)
        m_gap["card_cpu"] = max(m_gap["card_cpu"], gap)
        m_gap["centroid_card_oracle"] = max(
            m_gap.get("centroid_card_oracle", 0.0), max_rel_gap(c.xy, c_orc.xy, scale))
        m_gap["centroid_card_recentred_oracle"] = max(
            m_gap.get("centroid_card_recentred_oracle", 0.0),
            max_rel_gap(c.xy, c_rc, scale))
        counts = TM.num_points(pack_to_device(part, dtype=torch.float64, device=dev))
        m_ok &= bool(np.array_equal(F.st_numpoints(part), counts.cpu().numpy()))
    gates["measures_within_bands"] = m_ok
    gates["measures_card_equal_cpu_1e-12"] = m_gap["card_cpu"] <= 1e-12
    measures_per_s = len(geoms) * (len(meas) + 1) / card_s

    # predicates on FN_PAIRS row pairs: zone i % 256 against square
    # i % 6,050, the squares mapped into the zones' bbox
    zb, sb = zones.bounds(), squares.bounds()
    z0, z1 = zb[:, :2].min(0), zb[:, 2:].max(0)
    s0, s1 = sb[:, :2].min(0), sb[:, 2:].max(0)
    moved = F.st_scale(F.st_translate(squares, -s0[0], -s0[1]),
                       (z1[0] - z0[0]) / (s1[0] - s0[0]), (z1[1] - z0[1]) / (s1[1] - s0[1]))
    moved = F.st_translate(moved, z0[0], z0[1])
    i = np.arange(FN_PAIRS)
    pa, pb = repeat_rows(zones, i % len(zones)), repeat_rows(moved, i % len(moved))
    pred = {}
    p_ok = {}
    for name in ("st_contains", "st_intersects", "st_distance"):
        fn = getattr(F, name)
        fn(pa.slice(0, 64), pb.slice(0, 64))  # warm
        got, _ = run(name, lambda: fn(pa, pb))
        sub = slice(0, FN_PAIRS_CPU)
        cpu = fn(repeat_rows(zones, i[sub] % len(zones)),
                 repeat_rows(moved, i[sub] % len(moved)), device="cpu")
        n_orc = FN_ORACLE_DIST if name == "st_distance" else FN_ORACLE
        orc = fn(repeat_rows(zones, i[:n_orc] % len(zones)),
                 repeat_rows(moved, i[:n_orc] % len(moved)), backend="oracle")
        if name == "st_distance":
            orc_agree = float(np.isclose(got[:n_orc], orc, rtol=1e-9, atol=1e-12).mean())
            gap = max_rel_gap(got[sub], cpu)
        else:
            orc_agree = float((got[:n_orc] == orc).mean())
            gap = None
        p_ok[f"{name}_card_equal_cpu"] = got[sub].tobytes() == cpu.tobytes()
        p_ok[f"{name}_oracle_agreement"] = orc_agree >= 0.9999
        pred[name] = {"s": secs[name], "pairs_per_s": FN_PAIRS / secs[name],
                      "true_or_positive": int((got > 0).sum()),
                      "oracle_agreement": orc_agree, "oracle_pairs": n_orc,
                      "card_cpu_max_gap": gap}
    gates.update(p_ok)

    # grid: the 4M points' cells on the card, the zones' chips, the ids
    F.grid_longlatascellid(raw[:1024, 0], raw[:1024, 1], RES)  # warm
    cells, _ = run("grid_longlatascellid", lambda: F.grid_longlatascellid(
        raw[:, 0], raw[:, 1], RES))
    want_cells = H3.point_to_cell(torch.from_numpy(raw).to(dev), RES)
    gates["longlat_equal_point_to_cell"] = bool(
        cells.device.type == "cuda" and torch.equal(cells, want_cells))
    sub = raw[:FN_CELL_CPU]
    cpu_cells = F.grid_longlatascellid(sub[:, 0], sub[:, 1], RES, device="cpu")
    differ = (cells[:FN_CELL_CPU].cpu() != cpu_cells).numpy()
    margins = []
    if differ.any():
        _, rel = H3.point_to_cell_margin(torch.from_numpy(sub[differ]), RES)
        margins = rel[:, 0].numpy().tolist()[:20]
    sub, _ = run("set_index_resolution", lambda: MosaicFrame.from_geometry(
        zones.slice(0, FN_TESS_ZONES)).set_index_resolution(RES))
    rows = np.nonzero(table.geom_id < FN_TESS_ZONES)[0]
    gates["tessellate_equal_phase3"] = bool(
        sub.chips_index == "H3" and sub.resolution == RES
        and np.array_equal(sub.chips.cell_id, table.cell_id[rows])
        and np.array_equal(sub.chips.is_core, table.is_core[rows])
        and np.array_equal(sub.chips.geom_id, table.geom_id[rows])
        and same_column(sub.chips.chips, table.chips.take(rows)))
    # the joins' frame carries phase 3's chips, as set_index_resolution
    # would attach them
    frame = MosaicFrame(geometry=zones, columns={"zone_id": np.arange(len(zones))},
                        resolution=RES, chips=table, chips_index=ctx.index_system.name)
    uniq = np.unique(table.cell_id)
    gates["format_parse_round_trip"] = bool(np.array_equal(
        F.grid_parse_cellid(F.grid_format_cellid(uniq)), uniq))

    # MosaicFrame: the 4M batch under probe="adaptive", then the exact
    # join under the context's exact_recheck on the first N_EXACT points
    points = MosaicFrame.from_geometry(PackedGeometry.from_points(raw))
    exact_pts = MosaicFrame.from_geometry(PackedGeometry.from_points(raw[:N_EXACT]))
    old_probe = os.environ.get("MOSAIC_TUNE_PROBE")
    os.environ["MOSAIC_TUNE_PROBE"] = "adaptive"
    try:
        fj, fj_l = run("frame_join_cold", lambda: frame.point_in_polygon_join(points))
        fj_warm, fjw_l = run("frame_join", lambda: frame.point_in_polygon_join(points))
        TC.MosaicContext.build("H3", exact_recheck=True)
        fe, fe_l = run("frame_exact_join", lambda: frame.point_in_polygon_join(exact_pts))
    finally:
        TC.MosaicContext.build("H3")
        if old_probe is None:
            os.environ.pop("MOSAIC_TUNE_PROBE")
        else:
            os.environ["MOSAIC_TUNE_PROBE"] = old_probe
    gates["frame_join_equal_pip_join"] = bool(
        np.array_equal(fj["polygon_row"], joined)
        and np.array_equal(fj_warm["polygon_row"], joined))
    ok = joined >= 0
    gates["frame_join_columns"] = bool(np.array_equal(
        fj["polygon_zone_id"][ok], joined[ok].astype(np.float64))
        and np.isnan(fj["polygon_zone_id"][~ok]).all())
    gates["frame_join_launched_pip_heavy_tiled"] = (
        fj_l["pip_heavy_tiled"] > 0 and fjw_l["pip_heavy_tiled"] > 0)
    gates["frame_exact_equal_oracle"] = bool(np.array_equal(fe["polygon_row"], host_exact))
    gates["frame_exact_launched_pip_heavy_tiled"] = fe_l["pip_heavy_tiled"] > 0
    lc, rc = ov["left_chips"], ov["right_chips"]
    fl = MosaicFrame(geometry=left, resolution=OVERLAY_RES, chips=lc, chips_index=ogrid.name)
    fr = MosaicFrame(geometry=right, resolution=OVERLAY_RES, chips=rc, chips_index=ogrid.name)
    pairs, _ = run("frame_intersects_join", lambda: fl.intersects_join(fr, index=ogrid))
    want_pairs = OV.intersects_join(left, right, ogrid, OVERLAY_RES,
                                    left_chips=lc, right_chips=rc)
    gates["frame_intersects_equal_overlay"] = bool(
        pairs.dtype == want_pairs.dtype and np.array_equal(pairs, want_pairs))

    # raster to grid: the whole raster on the card, held against a numpy f64
    # host fold on the crop (same cells)
    grid_s = {}
    r_ok = True
    for comb in ("avg", "min", "max", "count"):
        fn = getattr(F, f"rst_rastertogrid{comb}")
        res_, got_l = run(f"rst_rastertogrid{comb}", lambda: fn([raster], RES))
        grid_s[comb] = secs[f"rst_rastertogrid{comb}"]
        r_ok &= got_l["zonal_fold"] > 0 and len(res_[0][0]) > 0
    gates["rastertogrid_launched_zonal_seq_fold"] = r_ok
    x, y = crop.pixel_centers()
    crop_cells = H3.point_to_cell(torch.from_numpy(
        np.stack([x, y], -1).reshape(-1, 2)).to(dev), RES).cpu().numpy()
    band = crop.bands[0]
    uniq_c, cnt, s_, mn, mx = host_cell_fold(band.values.ravel(), band.mask.ravel(),
                                             crop_cells)
    keep = cnt > 0
    host = {
        "count": {int(c): float(v) for c, v, k in zip(uniq_c, cnt.astype(np.float64), keep) if k},
        "avg": {int(c): float(v) for c, v, k in zip(uniq_c, s_ / np.maximum(cnt, 1.0), keep) if k},
        "min": {int(c): float(v) for c, v, k in zip(uniq_c, mn, keep) if k},
        "max": {int(c): float(v) for c, v, k in zip(uniq_c, mx, keep) if k},
    }
    crop_equal = {}
    for comb in ("avg", "min", "max", "count"):
        got = getattr(F, f"rst_rastertogrid{comb}")([crop], RES)[0][0]
        crop_equal[comb] = {k: v.hex() for k, v in got.items()} == {
            k: v.hex() for k, v in host[comb].items()}
        gates[f"rastertogrid{comb}_crop_equal_host_fold"] = crop_equal[comb]
    med, _ = run("rst_rastertogridmedian_crop", lambda: F.rst_rastertogridmedian([crop], RES))
    gates["median_crop_cells"] = sorted(med[0][0]) == sorted(host["count"])

    # the overlay frontend through the surface: 8i's squares, the default
    # tree (the exact intersection area)
    prep = ov["prep"]
    area, a_l = run("st_intersection_area", lambda: F.st_intersection_area(
        left, right, ogrid, OVERLAY_RES, prep=prep))
    want_area = OV.overlay_measures(left, right, ogrid, OVERLAY_RES, prep=prep)
    gates["intersection_area_equal_overlay_measures"] = all(
        np.asarray(getattr(area, f)).dtype == np.asarray(getattr(want_area, f)).dtype
        and np.asarray(getattr(area, f)).tobytes() == np.asarray(getattr(want_area, f)).tobytes()
        for f in ("pairs", "value", "valid", "area", "sure"))
    gates["intersection_area_one_zonal_seq_fold"] = a_l["zonal_fold"] == 1
    TC.MosaicContext.reset()

    real_pixels = raster.height * raster.width
    emit({
        "phase": "functions", "geometries": len(geoms), "zones": len(zones),
        "squares": len(squares), "pairs": FN_PAIRS, "pairs_cpu": FN_PAIRS_CPU,
        "codec_s": codec_s, "measures_per_s": measures_per_s,
        "measure_max_rel_gap": m_gap, "measure_card_cpu_gap": card_cpu,
        "predicates": pred,
        "longlat_points": int(raw.shape[0]),
        "longlat_points_per_s": raw.shape[0] / secs["grid_longlatascellid"],
        "longlat_cpu_points": FN_CELL_CPU,
        "longlat_cpu_agreement": float(1.0 - differ.mean()),
        "longlat_cpu_differ_margins": margins,
        "tessellated_zones": FN_TESS_ZONES, "tessellated_chips": len(sub.chips),
        "chips": len(table), "cells": int(uniq.size),
        "heavy_cells": ix.num_heavy_cells,
        "frame_join_points_per_s": raw.shape[0] / secs["frame_join"],
        "main_path_points_per_s": main_pps,
        "frame_exact_points_per_s": N_EXACT / secs["frame_exact_join"],
        "intersects_pairs": int(pairs.shape[0]),
        "rastertogrid_s": grid_s,
        "rastertogrid_pixels_per_s": {k: real_pixels / v for k, v in grid_s.items()},
        "crop_cells": len(host["count"]), "seconds": secs,
        "launches": launches, "phase_s": time.perf_counter() - t_phase,
        "nvidia_smi": card, "gates": gates,
    })
    bad = [k for k, v in gates.items() if not v]
    return (f"functions gates failed: {bad}" if bad else None), launches


def files_phase(ix, table, H3, dev, zones, raw, raster, zones_want, zone_eng,
                counted, card):
    """Phase 8p, files in and out: the device CRS lane on the 4M batch,
    GeoTIFF written and read back (a UTM 18N copy of the raster and the
    EPSG:4326 raster itself), the MODIS-like tiled deflate file,
    ``read("raster_to_grid")`` of the UTM file on the card, the zones of
    the read-back raster, the zones through every vector writer and
    reader, a UTM shapefile with its ``.prj``, and a join from read-back
    zones. Returns (failure message or None, the phase's launches by
    kernel)."""
    import importlib.util

    import numpy as np
    import torch

    from mosaic_tpu_torch import readers
    from mosaic_tpu_torch.core import crs
    from mosaic_tpu_torch.core.tessellate import ChipTable, tessellate
    from mosaic_tpu_torch.datasets import NYC_BBOX
    from mosaic_tpu_torch.functions import geometry as FG
    from mosaic_tpu_torch.raster import Raster, read_raster, write_geotiff
    from mosaic_tpu_torch.readers.vector import VectorTable
    from mosaic_tpu_torch.sql import join as J

    spec = importlib.util.spec_from_file_location(
        "modis_fixture", os.path.join(HERE, "tests", "modis_fixture.py"))
    modis = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(modis)

    t_phase = time.perf_counter()
    launches = {k: 0 for k in counted}
    secs = {}
    gates = {}
    d = os.path.join(HERE, FILES_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)

    def run(name, call):
        """``call()`` timed (synced) with its launches added to the
        phase's; the counts are set to 0 just before it."""
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out_ = call()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        got = {k: fn.launches for k, fn in counted.items()}
        for k, v in got.items():
            launches[k] += v
        return out_, got

    # the device CRS lane: the 4M batch mapped into each code's area of
    # use, forward and inverse in f64 on the card, against the numpy lane
    # on the first FILES_CRS_CHECK points
    bx0, by0, bx1, by1 = NYC_BBOX
    unit = (raw - [bx0, by0]) / [bx1 - bx0, by1 - by0]
    lane = {}
    sub = slice(0, FILES_CRS_CHECK)
    for srid in FILES_CRS_SRIDS:
        gx0, gy0, gx1, gy1 = crs.crs_bounds(srid, reprojected=False)
        ll = np.stack([gx0 + unit[:, 0] * (gx1 - gx0), gy0 + unit[:, 1] * (gy1 - gy0)], -1)
        ll_t = torch.from_numpy(ll).to(dev)
        crs.to_wgs84(crs.from_wgs84(ll_t, srid, crs.TORCH), srid, crs.TORCH)  # warm
        en_t, _ = run(f"crs_fwd_{srid}", lambda: crs.from_wgs84(ll_t, srid, crs.TORCH))
        back_t, _ = run(f"crs_inv_{srid}", lambda: crs.to_wgs84(en_t, srid, crs.TORCH))
        syncs, first = count_syncs(lambda: crs.to_wgs84(
            crs.from_wgs84(ll_t, srid, crs.TORCH), srid, crs.TORCH))
        en_np = crs.from_wgs84(ll[sub], srid, np)
        inv_t = crs.to_wgs84(torch.from_numpy(en_np).to(dev), srid, crs.TORCH)
        inv_np = crs.to_wgs84(en_np, srid, np)
        gaps = []
        for got, want in ((en_t[sub].cpu().numpy(), en_np), (inv_t.cpu().numpy(), inv_np)):
            fin = np.isfinite(want)
            gaps.append((int((np.isfinite(got) != fin).sum()),
                         float(np.abs(np.where(fin, got - want, 0.0)).max())))
        fb, ib = FILES_CRS_BANDS[srid]
        ok = (gaps[0][0] == 0 and gaps[1][0] == 0 and gaps[0][1] <= fb and gaps[1][1] <= ib
              and en_t.dtype == torch.float64 and en_t.device.type == dev.type)
        gates[f"crs_{srid}_within_band"] = ok
        lane[srid] = {
            "fwd_points_per_s": raw.shape[0] / secs[f"crs_fwd_{srid}"],
            "inv_points_per_s": raw.shape[0] / secs[f"crs_inv_{srid}"],
            "fwd_max_gap": gaps[0][1], "inv_max_gap": gaps[1][1],
            "finite_mismatch": gaps[0][0] + gaps[1][0], "bands": [fb, ib],
            "host_syncs": syncs, "first_sync": first,
        }
    gates["crs_lane_no_host_sync"] = sum(v["host_syncs"] for v in lane.values()) == 0

    # GeoTIFF: the raster in UTM 18N at FILES_UTM_PIXEL metres from the
    # UTM envelope's upper left of NYC_BBOX, and the EPSG:4326 raster
    def same_raster(a, b):
        return (a.data.dtype == b.data.dtype and a.data.shape == b.data.shape
                and a.data.tobytes() == b.data.tobytes() and a.gt == b.gt
                and a.srid == b.srid and np.float64(a.nodata).tobytes()
                == np.float64(b.nodata).tobytes())

    corners = np.array([[bx0, by0], [bx0, by1], [bx1, by0], [bx1, by1]])
    en = crs.from_wgs84(corners, 32618)
    utm = Raster(data=raster.data, gt=(float(en[:, 0].min()), FILES_UTM_PIXEL, 0.0,
                                       float(en[:, 1].max()), 0.0, -FILES_UTM_PIXEL),
                 srid=32618, nodata=raster.nodata)
    tif = {"utm": os.path.join(d, "utm.tif"), "wgs84": os.path.join(d, "wgs84.tif")}
    io_s = {}
    back = {}
    for key, r in (("utm", utm), ("wgs84", raster)):
        t0 = time.perf_counter()
        write_geotiff(tif[key], r)
        t1 = time.perf_counter()
        back[key] = read_raster(tif[key])
        io_s[key] = {"write_s": t1 - t0, "read_s": time.perf_counter() - t1,
                     "mb": os.path.getsize(tif[key]) / 1e6}
        gates[f"geotiff_{key}_round_trip"] = same_raster(back[key], r)
    mpath = modis.write_modis_like(os.path.join(d, "modis.tif"))
    t0 = time.perf_counter()
    m = read_raster(mpath)
    io_s["modis_read_s"] = time.perf_counter() - t0
    mwant = modis.modis_like_field()
    m_valid = float(m.bands[0].mask.mean())
    gates["modis_decode"] = bool(
        m.data.dtype == mwant.dtype and m.data.tobytes() == mwant.tobytes()
        and m.nodata == 32767.0 and abs(m.gt[1] - modis.MODIS_PIXEL) < 1e-3
        and 0.05 < m_valid < 0.2 and m.metadata().get("PRODUCT") == "SYNTHETIC_MCD43A4")

    # raster_to_grid of the UTM file on the card, then on its middle crop
    # on the card and the CPU, and against the f64 host fold of the crop
    def to_grid(path, comb, **kw):
        return (readers.read("raster_to_grid").option("resolution", RES)
                .option("combiner", comb).option("retileSize", FILES_GRID_TILE)
                .load(path, index=H3, **kw))

    # (the whole raster's avg only: max runs on the crop, as its host CRS
    # transform of 25 tiles took 6.5 s)
    grid = {}
    grid["avg"], gl = run("raster_to_grid_avg", lambda: to_grid(tif["utm"], "avg"))
    gates["raster_to_grid_avg_launched_zonal_seq_fold"] = gl["zonal_fold"] > 0
    ucrop = middle(back["utm"], CROP)
    cpath = os.path.join(d, "utm_crop.tif")
    write_geotiff(cpath, ucrop)
    merged = {"avg": {}, "max": {}}
    for t in ucrop.retile(FILES_GRID_TILE, FILES_GRID_TILE):
        x, y = t.pixel_centers()
        ll = crs.transform_points(np.stack([x, y], -1).reshape(-1, 2), 32618, 4326)
        cells = H3.point_to_cell(torch.from_numpy(ll).to(dev), RES).cpu().numpy()
        band = t.bands[0]
        uniq, cnt, s_, _, mx = host_cell_fold(band.values.ravel(), band.mask.ravel(), cells)
        cntf = cnt.astype(np.float64)
        avg = s_ / np.maximum(cntf, 1.0)
        for i in np.nonzero(cnt > 0)[0]:
            c = int(uniq[i])
            merged["avg"].setdefault(c, []).append((float(avg[i]) * cntf[i], cntf[i]))
            merged["max"].setdefault(c, []).append(float(mx[i]))
    host = {"avg": {c: float(sum(v[0] for v in vs) / sum(v[1] for v in vs))
                    for c, vs in merged["avg"].items()},
            "max": {c: float(np.asarray(vs, np.float64).max())
                    for c, vs in merged["max"].items()}}
    hexed = lambda m_: {k: v.hex() for k, v in m_.items()}  # noqa: E731
    for comb in ("avg", "max"):
        card_crop, cl = run(f"raster_to_grid_{comb}_crop", lambda: to_grid(cpath, comb))
        gates[f"raster_to_grid_{comb}_crop_launched_zonal_seq_fold"] = cl["zonal_fold"] > 0
        cpu_crop, _ = run(f"raster_to_grid_{comb}_crop_cpu",
                          lambda: to_grid(cpath, comb, device="cpu"))
        gates[f"raster_to_grid_{comb}_crop_equal_cpu_lane"] = (
            hexed(card_crop[1]) == hexed(cpu_crop[1]))
        gates[f"raster_to_grid_{comb}_crop_equal_host_fold"] = (
            hexed(card_crop[1]) == hexed(host[comb]))
    gates["raster_to_grid_cells"] = len(grid["avg"][1]) > len(host["avg"]) > 0

    # the zones of the read-back EPSG:4326 raster, against phase 4's call
    zr, zl = run("zones_tiled_read_back", lambda: zone_eng.zones(back["wgs84"]))
    gates["zones_read_back_equal_phase4"] = result_rows(zr) == result_rows(zones_want)
    gates["zones_read_back_launched"] = zl["zonal_tiled"] > 0 and zl["pip_heavy_tiled"] > 0

    # the zones through every writer and back
    fields = ("ring_offsets", "part_offsets", "geom_offsets", "geom_type", "srid")
    vt = VectorTable(geometry=zones, columns={"zone_id": np.arange(len(zones), dtype=np.int64)})
    names = {"geojson": "z.geojson", "geojsonseq": "z.geojsonl", "shapefile": "z.shp",
             "flatgeobuf": "z.fgb", "geopackage": "z.gpkg", "kml": "z.kml"}
    vec_s = {}
    read_back = {}
    for fmt, name in names.items():
        p = os.path.join(d, name)
        t0 = time.perf_counter()
        readers.write(fmt).save(p, vt)
        t1 = time.perf_counter()
        read_back[fmt] = rb = readers.read(fmt).load(p)
        vec_s[fmt] = {"write_s": t1 - t0, "read_s": time.perf_counter() - t1}
        g = rb.geometry
        ids_ok = np.array_equal(np.asarray(rb.columns["zone_id"], np.float64),
                                np.arange(len(zones), dtype=np.float64))
        if fmt == "shapefile":  # shells are stored clockwise: each ring reversed
            ro = zones.ring_offsets
            ok = all(np.asarray(getattr(g, f)).tobytes() == np.asarray(getattr(zones, f)).tobytes()
                     for f in fields) and g.xy.shape == zones.xy.shape and all(
                np.array_equal(g.xy[ro[i]:ro[i + 1]], zones.xy[ro[i]:ro[i + 1]][::-1])
                for i in range(ro.size - 1))
        else:
            ok = same_column(g, zones)
        gates[f"{fmt}_round_trip"] = bool(ok and ids_ok)

    # UTM 18N zones as a shapefile with a .prj: the SRID comes back through
    # crs_wkt; back to EPSG:4326 within the round-trip band of
    # tests/test_crs_affine.py (2e-7 degrees)
    zu, _ = run("st_transform_32618", lambda: FG.st_transform(zones, 32618))
    up = os.path.join(d, "z_utm.shp")
    readers.write("shapefile").save(up, VectorTable(geometry=zu, columns=vt.columns),
                                    srid=32618)
    with open(os.path.join(d, "z_utm.prj"), "w") as f:
        f.write(UTM18N_PRJ)
    ru = readers.read("shapefile").load(up)
    gates["utm_prj_srid"] = set(ru.geometry.srid.tolist()) == {32618}
    wgs, _ = run("st_transform_4326", lambda: FG.st_transform(ru.geometry, 4326))
    utm_gap = float(np.abs(wgs.xy - read_back["shapefile"].geometry.xy).max())
    gates["utm_round_trip_within_2e-7"] = utm_gap <= 2e-7

    # a join from read-back zones: FILES_TESS_ZONES of the FlatGeobuf's,
    # tessellated, against the same zones' chips of phase 3
    rz = read_back["flatgeobuf"].geometry.slice(0, FILES_TESS_ZONES)
    t64, _ = run("tessellate_read_back", lambda: tessellate(rz, H3, RES, keep_core_geoms=False))
    rows = np.nonzero(table.geom_id < FILES_TESS_ZONES)[0]
    mem = ChipTable(geom_id=table.geom_id[rows], cell_id=table.cell_id[rows],
                    is_core=table.is_core[rows], chips=table.chips.take(rows),
                    has_geom=table.has_geom[rows])
    gates["tessellate_read_back_equal_phase3"] = bool(
        np.array_equal(t64.cell_id, mem.cell_id) and np.array_equal(t64.is_core, mem.is_core)
        and np.array_equal(t64.geom_id, mem.geom_id) and same_column(t64.chips, mem.chips))
    ix_read = J.build_chip_index(t64, device=dev)
    ix_mem = J.build_chip_index(mem, device=dev)
    J.pip_join(raw[:1024], None, H3, RES, chip_index=ix_read, probe="adaptive")  # warm
    joined, jl = run("join_read_back", lambda: J.pip_join(
        raw, None, H3, RES, chip_index=ix_read, probe="adaptive"))
    want = J.pip_join(raw, None, H3, RES, chip_index=ix_mem, probe="adaptive")
    gates["join_read_back_equal_in_memory"] = bool(
        joined.dtype == want.dtype and np.array_equal(joined, want))
    gates["join_read_back_launched_pip_heavy_tiled"] = jl["pip_heavy_tiled"] > 0
    shutil.rmtree(d, ignore_errors=True)

    real_pixels = raster.height * raster.width
    emit({
        "phase": "files", "points": int(raw.shape[0]), "crs_check_points": FILES_CRS_CHECK,
        "crs_lane": lane, "geotiff": io_s, "modis_valid_share": m_valid,
        "raster_to_grid_cells": {k: len(v[1]) for k, v in grid.items()},
        "raster_to_grid_pixels_per_s": {
            k: real_pixels / secs[f"raster_to_grid_{k}"] for k in grid},
        "crop_cells": len(host["avg"]), "zones_read_back_pixels_per_s":
            real_pixels / secs["zones_tiled_read_back"],
        "vector_s": vec_s, "utm_round_trip_max_gap": utm_gap,
        "join_read_back_points_per_s": raw.shape[0] / secs["join_read_back"],
        "tessellated_zones": FILES_TESS_ZONES, "heavy_cells_read_back": ix_read.num_heavy_cells,
        "seconds": secs, "launches": launches,
        "phase_s": time.perf_counter() - t_phase, "nvidia_smi": card, "gates": gates,
    })
    bad = [k for k, v in gates.items() if not v]
    return (f"files gates failed: {bad}" if bad else None), launches


def utilities_phase(ix, table, H3, dev, raw, crop, counted, card):
    """Phase 8q, the last modules on the card: ``utils.benchmark`` of the
    warm 4M adaptive ``pip_join`` (each trial's CUDA-event time beside
    it), ``utils.device_trace`` around one such join (its Chrome trace
    must name the heavy kernel), ``viz.plot_cells`` of ``VIZ_CELLS`` of
    phase 3's cells, and the chaos sweep
    (``mosaic_tpu_torch/tools/chaos_sweep.py``) over every registered
    fault site on the card, in this process, then ``pip_join.device`` at
    full width (phase 3's index, the 4M batch, clean and with one injected
    fault, bit for bit) and ``raster.zonal`` (tiled lane) on the crop.
    Returns (failure message or None, the benchmark's and trace's
    launches, the sweep's and full-width sites' launches, by kernel)."""
    import contextlib

    import numpy as np
    import torch

    from mosaic_tpu_torch import utils as U
    from mosaic_tpu_torch import viz
    from mosaic_tpu_torch.raster.zonal import zonal_zones
    from mosaic_tpu_torch.sql import join as J
    from mosaic_tpu_torch.tools import chaos_sweep as CS

    t_phase = time.perf_counter()
    gates = {}
    secs = {}
    d = os.path.join(HERE, UTILS_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)

    def zero():
        for fn in counted.values():
            fn.launches = 0

    def read():
        return {k: fn.launches for k, fn in counted.items()}

    def join():
        return J.pip_join(raw, None, H3, RES, chip_index=ix, probe="adaptive")

    # utils.benchmark: every trial's join bracketed by CUDA events, so each
    # trial's host seconds stand beside its device-timeline seconds
    ev_ms = []

    def timed_join():
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out_ = join()
        e.record()
        ev_ms.append((s, e))
        return out_

    join()  # warm
    zero()
    t0 = time.perf_counter()
    bench = U.benchmark(timed_join, trials=BENCH_TRIALS, warmup=1)
    secs["benchmark"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    trial_ms = sorted(s.elapsed_time(e) for s, e in ev_ms[1:])
    event_median_ms = trial_ms[len(trial_ms) // 2]
    gates["benchmark_median_at_least_cuda_event_time"] = (
        bench["median_s"] * 1e3 >= event_median_ms)

    # utils.device_trace around one join, with an annotated region
    t0 = time.perf_counter()
    with U.device_trace(os.path.join(d, "trace"), device=dev) as prof:
        with U.annotate("chip_smoke.8q.join"):
            traced = join()
    secs["device_trace"] = time.perf_counter() - t0
    util_launches = read()
    with open(prof.trace_path) as f:
        trace_text = f.read()
    trace_kernels = sorted(k for k in KERNEL_OPS["pip_heavy_tiled"] if k in trace_text)
    gates["trace_names_pip_heavy_kernel"] = "pip_heavy_kernel" in trace_text
    gates["trace_names_the_annotation"] = "chip_smoke.8q.join" in trace_text
    gates["traced_join_equal"] = bool(np.array_equal(traced, join()))
    gates["benchmark_and_trace_launched_pip_heavy_tiled"] = (
        util_launches["pip_heavy_tiled"] >= BENCH_TRIALS + 2)

    # viz.plot_cells of VIZ_CELLS of phase 3's cells, the fallback page
    cells = np.unique(table.cell_id)[:VIZ_CELLS]
    t0 = time.perf_counter()
    page = viz.plot_cells(cells, index=H3, path=os.path.join(d, "cells.html"))
    secs["plot_cells"] = time.perf_counter() - t0
    with open(page) as f:
        html = f.read()
    head = "const fc = "
    fc = json.loads(html[html.index(head) + len(head):].split(";\n", 1)[0])
    gates["plot_cells_feature_count"] = len(fc["features"]) == cells.size == VIZ_CELLS
    gates["plot_cells_polygons"] = all(
        ft["geometry"]["type"] == "Polygon" for ft in fc["features"])

    # the chaos sweep over every registered site on the card, then the two
    # sites at full width; counts set to 0 just before, read just after
    env_before = dict(os.environ)
    zero()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        sweep, rc = CS.run_sweep(device=str(dev))
    secs["chaos_sweep"] = time.perf_counter() - t0
    out = sweep["detail"].get("outcomes", {})
    gates["chaos_sweep_clean"] = rc == 0 and not sweep["detail"].get("failures")
    gates["chaos_every_registered_site"] = (
        sweep["value"] == sweep["detail"].get("registered") == len(out) == 25)
    gates["chaos_no_degraded_on_card"] = all(
        r["outcome"] != "degraded" for r in out.values())
    gates["chaos_environment_unchanged"] = dict(os.environ) == env_before

    t0 = time.perf_counter()
    wide = {}
    clean_join = join()
    r = CS.one_shot("pip_join.device", join, CS.arr_same, clean=clean_join)
    gates["full_width_pip_join_bit_equal"] = (
        r["outcome"] == "identical" and CS.arr_same(join(), clean_join))
    wide["pip_join.device"] = r

    def zones():
        return zonal_zones(crop, ix, H3, RES, lane="tiled", device=dev)

    clean_zones = zones()
    r = CS.one_shot("raster.zonal", zones, CS.zonal_same, clean=clean_zones)
    gates["full_width_raster_zonal_typed_then_serves"] = (
        r["outcome"] in ("typed", "identical")
        and CS.zonal_same(zones(), clean_zones))
    wide["raster.zonal"] = r
    secs["full_width_sites"] = time.perf_counter() - t0
    chaos_launches = read()
    for k in ("pip_heavy_tiled", "zonal_tiled", "zonal_fold"):
        gates[f"chaos_launched_{k}"] = chaos_launches[k] > 0
    shutil.rmtree(d, ignore_errors=True)

    emit({
        "phase": "utilities", "benchmark": bench, "benchmark_trials_cuda_event_ms": trial_ms,
        "benchmark_event_median_ms": event_median_ms,
        "trace_mb": len(trace_text) / 1e6, "trace_kernels": trace_kernels,
        "viz_cells": int(cells.size), "viz_page_mb": len(html) / 1e6,
        "chaos": {"value": sweep["value"], "registered": sweep["detail"].get("registered"),
                  "outcomes": out, "failures": sweep["detail"].get("failures"),
                  "error": sweep["detail"].get("error")},
        "full_width_sites": wide, "seconds": secs,
        "launches_utils": util_launches, "launches_chaos": chaos_launches,
        "phase_s": time.perf_counter() - t_phase, "nvidia_smi": card, "gates": gates,
    })
    bad = [k for k, v in gates.items() if not v]
    return (f"utilities gates failed: {bad}" if bad else None), util_launches, chaos_launches


def models_phase(ix, H3, dev, raw, n_zones, counted, card):
    """Phase 8r, the last gaps on the card: the iteration skeletons of
    ``models/core.py`` over the adaptive join of phase 3's index, with
    a ``CheckpointManager`` recording a state of CUDA tensors, then the
    ``MOSAIC_RETRY_ATTEMPTS`` knob on the 4M join with one transient fault
    at ``pip_join.device``. Returns (failure message or None, the phase's
    launches by kernel)."""
    import glob

    import numpy as np
    import torch

    from mosaic_tpu_torch.models import (
        BinaryTransformer,
        CheckpointManager,
        IterativeTransformer,
    )
    from mosaic_tpu_torch.runtime import faults, telemetry
    from mosaic_tpu_torch.runtime.errors import DegradedResult, RetryExhausted
    from mosaic_tpu_torch.sql import join as J

    t_phase = time.perf_counter()
    gates = {}
    secs = {}
    d = os.path.join(HERE, MODELS_DIR)
    shutil.rmtree(d, ignore_errors=True)
    step_n = N_POINTS // MODELS_ITERATIONS
    n_bins = n_zones + 1
    for fn in counted.values():
        fn.launches = 0

    def join(pts, index=ix):
        return J.pip_join(pts, None, H3, RES, chip_index=index, probe="adaptive")

    def bincount(ids):
        return torch.bincount(torch.as_tensor(ids, device=dev).long() + 1, minlength=n_bins)

    rights = []

    def join_step(left, right, i):
        rights.append(right)
        ids = join(raw[(i - 1) * step_n:i * step_n], right)
        c = left["counts"] + bincount(ids)
        return {"counts": c, "matched": c[1:].sum()}

    start = {"counts": torch.zeros(n_bins, dtype=torch.int64, device=dev),
             "matched": torch.zeros((), dtype=torch.int64, device=dev)}
    states = []

    def recorded(left, right, i):
        states.append(join_step(left, right, i))
        return states[-1]

    ck = CheckpointManager(d, overwrite=True)
    bt = BinaryTransformer(recorded, should_stop=lambda prev, cur: False,
                           max_iterations=MODELS_ITERATIONS, right=ix, checkpoint=ck)
    t0 = time.perf_counter()
    final = bt.transform(start)
    torch.cuda.synchronize()
    secs["binary_transformer"] = time.perf_counter() - t0
    transformer_launches = {k: fn.launches for k, fn in counted.items()}
    t0 = time.perf_counter()
    clean = join(raw)
    secs["join_4m"] = time.perf_counter() - t0
    want = bincount(clean)
    gates["transformer_counts_equal_one_4m_join"] = bool(torch.equal(final["counts"], want))
    gates["transformer_iterations_run"] = bt.iterations_run == MODELS_ITERATIONS
    gates["transformer_right_threaded_unchanged"] = (
        len(rights) == MODELS_ITERATIONS and all(r is ix for r in rights))
    gates["transformer_state_on_card"] = all(
        v.device.type == "cuda" for v in final.values())
    gates["transformer_launched_pip_heavy_tiled"] = (
        transformer_launches["pip_heavy_tiled"] >= MODELS_ITERATIONS)

    t0 = time.perf_counter()
    loaded = ck.load()
    parts = sorted(glob.glob(os.path.join(d, "part-*.npz")))
    gates["checkpoint_one_part_an_iteration"] = len(parts) == MODELS_ITERATIONS
    gates["checkpoint_iterations"] = (
        loaded.get("iteration", np.zeros(0)).tolist() == list(range(1, MODELS_ITERATIONS + 1)))
    same_parts = len(parts) == len(states)
    for part, st in zip(parts, states):
        with np.load(part) as z:
            same_parts &= (
                sorted(z.files) == ["counts", "iteration", "matched"]
                and np.array_equal(z["counts"], st["counts"].cpu().numpy())
                and np.array_equal(z["matched"], np.atleast_1d(st["matched"].cpu().numpy())))
    gates["checkpoint_parts_equal_each_state"] = bool(same_parts)
    secs["checkpoint_check"] = time.perf_counter() - t0

    # the reference's stopping rule: the first step whose state meets
    # should_stop(prev, state); the threshold is the matched total after
    # the second step plus one
    matched = [int(st["matched"]) for st in states]
    threshold = matched[1] + 1
    stop_at = next((i + 1 for i, m in enumerate(matched) if m >= threshold),
                   MODELS_ITERATIONS)
    it = IterativeTransformer(lambda s, i: join_step(s, ix, i),
                              should_stop=lambda prev, cur: int(cur["matched"]) >= threshold,
                              max_iterations=MODELS_ITERATIONS)
    t0 = time.perf_counter()
    stopped = it.iterate(start)
    secs["iterative_transformer"] = time.perf_counter() - t0
    gates["iterative_stops_where_the_rule_says"] = (
        it.iterations_run == stop_at < MODELS_ITERATIONS
        and torch.equal(stopped["counts"], states[stop_at - 1]["counts"]))
    ck.delete()
    gates["checkpoint_deleted"] = not os.path.exists(d)

    # MOSAIC_RETRY_ATTEMPTS at full width, one transient fault each
    env_before = dict(os.environ)
    prev = os.environ.get("MOSAIC_RETRY_ATTEMPTS")
    knob = {}
    t0 = time.perf_counter()
    for attempts in ("1", "2"):
        os.environ["MOSAIC_RETRY_ATTEMPTS"] = attempts
        try:
            with telemetry.capture() as ev, faults.transient_errors(
                    1, sites=("pip_join.device",)) as plan:
                try:
                    out, err = join(raw), None
                except RetryExhausted as e:
                    out, err = None, e
        finally:
            if prev is None:
                del os.environ["MOSAIC_RETRY_ATTEMPTS"]
            else:
                os.environ["MOSAIC_RETRY_ATTEMPTS"] = prev
        names = [e["event"] for e in ev]
        knob[attempts] = {
            "trips": plan.trips, "error": type(err).__name__ if err else None,
            "attempts": getattr(err, "attempts", None),
            "events": {n: names.count(n) for n in sorted(set(names)) if n in FAULT_EVENTS},
        }
        if attempts == "1":
            gates["knob_1_raises_after_one_attempt"] = (
                err is not None and err.attempts == 1 and len(plan.trips) == 1)
            gates["knob_1_no_degradation"] = "degraded" not in names
        else:
            gates["knob_2_answers_the_clean_bits"] = (
                err is None and not isinstance(out, DegradedResult)
                and out.dtype == clean.dtype and np.array_equal(out, clean))
            gates["knob_2_one_transient_retry"] = names.count("transient_retry") == 1
    secs["retry_knobs"] = time.perf_counter() - t0
    gates["environment_unchanged"] = dict(os.environ) == env_before
    launches = {k: fn.launches for k, fn in counted.items()}
    shutil.rmtree(d, ignore_errors=True)

    emit({
        "phase": "models", "iterations": MODELS_ITERATIONS, "slice_points": step_n,
        "matched_by_iteration": matched, "stop_threshold": threshold,
        "stopped_at": it.iterations_run, "expected_stop": stop_at,
        "retry_knob": knob, "seconds": secs,
        "launches_transformer": transformer_launches, "launches_models": launches,
        "phase_s": time.perf_counter() - t_phase, "nvidia_smi": card, "gates": gates,
    })
    bad = [k for k, v in gates.items() if not v]
    return (f"models gates failed: {bad}" if bad else None), launches


def mesh_devices(dev):
    """8n's devices: the real cards where there are more than one (up to
    ``MESH_SHARDS``), else ``MESH_SHARDS`` times the one card — a
    logical mesh, whose shards run one after another."""
    import torch

    n = torch.cuda.device_count()
    if n > 1:
        return [torch.device("cuda", i) for i in range(min(n, MESH_SHARDS))]
    return [dev] * MESH_SHARDS


def np_same(a, b) -> bool:
    """Two arrays of one shape and dtype with the same bytes."""
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def mesh_phase(ix, H3, dev, n_zones, raw, cells, joined, scattered, crop,
               engines, ov, counted, card):
    """Phase 8n, multi-device. Returns (failure message or None, the
    launches of the meshed calls by kernel)."""
    import numpy as np
    import torch

    from mosaic_tpu_torch.dispatch import BucketLadder, backend_compiles, data_mesh
    from mosaic_tpu_torch.parallel import dist_join as DJ
    from mosaic_tpu_torch.raster import ZonalEngine
    from mosaic_tpu_torch.runtime import RetryExhausted, faults, telemetry
    from mosaic_tpu_torch.serve import ServeEngine
    from mosaic_tpu_torch.sql import join as J
    from mosaic_tpu_torch.sql import overlay as OV
    from mosaic_tpu_torch.sql.stream import StreamJoin, ring_from_host

    t_phase = time.perf_counter()
    devices = mesh_devices(dev)
    mesh = data_mesh(devices=devices)
    shards = mesh.size
    launches = {k: 0 for k in counted}

    def meshed(call):
        """A meshed call, its launches added to the phase's."""
        for fn in counted.values():
            fn.launches = 0
        out_ = call()
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in counted.items()}
        for k, v in got.items():
            launches[k] += v
        return out_, got

    def timed(call):
        t0 = time.perf_counter()
        out_ = call()
        torch.cuda.synchronize()
        return out_, time.perf_counter() - t0

    # pip_join(mesh=): the dispatch core's sharded lane, a chunk at a time
    jkw = dict(chip_index=ix, probe="adaptive", batch_size=MESH_BATCH)
    chunks = -(-raw.shape[0] // MESH_BATCH)
    t0 = time.perf_counter()
    mj, jl = meshed(lambda: J.pip_join(raw, None, H3, RES, mesh=mesh, **jkw))
    join_cold_s = time.perf_counter() - t0
    (_, mesh_s) = timed(lambda: J.pip_join(raw, None, H3, RES, mesh=mesh, **jkw))
    (_, single_s) = timed(lambda: J.pip_join(raw, None, H3, RES, **jkw))
    try:
        J.pip_join(raw[:1000], None, H3, RES, chip_index=ix, mesh=mesh, recheck=True)
        rejects_recheck = False
    except ValueError:
        rejects_recheck = True

    # dist_pip_join on a (dp, cell) mesh: the index sharded over cell
    dmesh = DJ.make_mesh(devices=devices, cell_axis=2 if shards % 2 == 0 else 1)
    pc = cells.cpu().numpy()
    T = int(ix.table_cell.shape[0])
    with telemetry.capture() as dev_ev:
        (dj, dl), djl = meshed(lambda: DJ.dist_pip_join(
            raw, pc, ix, dmesh, n_zones, table_size=T, probe="adaptive"))
    layout = [e for e in dev_ev if e["event"] == "dist_join_layout"][-1]
    (dj_rep, dl_rep), _ = meshed(lambda: DJ.dist_pip_join(
        raw, pc, ix, dmesh, n_zones, table_size=None, probe="adaptive"))
    counts_want = np.bincount(joined[joined >= 0], minlength=n_zones)[:n_zones]
    with telemetry.capture() as ex_ev, faults.transient_errors(
            50, sites=("dist_join.step",)):
        try:
            DJ.dist_pip_join(raw, pc, ix, dmesh, n_zones, table_size=T, probe="adaptive")
            dist_exhausted = False
        except RetryExhausted:
            dist_exhausted = True
    ex_kinds = [e["event"] for e in ex_ev]

    # StreamJoin(mesh=): 3 batches of a ring cut from the 4M batch
    ring = ring_from_host(
        [raw[i * MESH_STREAM:(i + 1) * MESH_STREAM] for i in range(3)], device=dev)
    s_one = StreamJoin(ix, H3, RES, probe="adaptive").run(ring, 3, collect=True)
    s_mesh, sl = meshed(lambda: StreamJoin(ix, H3, RES, probe="adaptive", mesh=mesh).run(
        ring, 3, collect=True))
    stream_equal = (
        (s_mesh.checksum, s_mesh.matches, s_mesh.overflow)
        == (s_one.checksum, s_one.matches, s_one.overflow)
        and np_same(s_mesh.outs, s_one.outs)
    )
    del ring

    # ServeEngine(mesh=): warm, serve, close
    rng = np.random.default_rng(MESH_SEED)
    sizes = rng.integers(1, 1025, MESH_REQUESTS)
    bbox = (float(raw[:, 0].min()), float(raw[:, 1].min()),
            float(raw[:, 0].max()), float(raw[:, 1].max()))
    reqs = [rng.uniform(bbox[:2], bbox[2:], (int(n), 2)) for n in sizes]
    want = np.split(J.pip_join(np.concatenate(reqs), None, H3, RES, chip_index=ix,
                               probe="adaptive"), np.cumsum(sizes)[:-1])
    b0 = backend_compiles()
    ladder = BucketLadder(*MESH_LADDER)
    eng = ServeEngine(ix, H3, RES, probe="adaptive", ladder=ladder, bounds=bbox,
                      max_wait_s=0.0, mesh=mesh, default_deadline_s=30.0)
    try:
        (warm_info, warm_s) = timed(eng.warmup)
        graphs = sorted(eng.core._graphs)
        got, srv_l = meshed(lambda: [eng.join(r, deadline_s=30.0) for r in reqs])
        (_, serve_s) = timed(lambda: [eng.join(r, deadline_s=30.0) for r in reqs])
        m = eng.metrics()
    finally:
        core = eng.core
        eng.close()
    serve_nvcc = backend_compiles() - b0

    # ZonalEngine(mesh=): both zones lanes and the grid on the crop
    zonal_equal, zonal_l = {}, {}
    stats_ = ("keys", "count", "sum", "min", "max")
    for name in ("zones_tiled", "zones_fold", "grid"):
        one = engines[name]
        if name == "grid":
            want_z = one.grid(crop)
            got_z, zonal_l[name] = meshed(lambda: ZonalEngine(H3, RES, mesh=mesh).grid(crop))
        else:
            want_z = one.zones(crop)
            got_z, zonal_l[name] = meshed(lambda: ZonalEngine(
                H3, RES, chip_index=ix, lane=one.lane, mesh=mesh).zones(crop))
        zonal_equal[name] = all(np_same(getattr(got_z, a), getattr(want_z, a))
                                for a in stats_)

    # overlay_measures(mesh=) on 8i's squares against 8i's device lane
    om, ol = meshed(lambda: OV.overlay_measures(
        ov["left"], ov["right"], ov["grid"], OVERLAY_RES, ov["value"],
        prep=ov["prep"], mesh=mesh))
    overlay_equal = om.lane == "device" and not om.degraded and all(
        np_same(getattr(om, f), getattr(ov["single"], f))
        for f in ("pairs", "value", "valid", "area", "sure"))

    gates = {
        "join_equal_adaptive": np_same(mj, joined),
        "join_equal_scatter": np_same(mj, scattered),
        "join_heavy_once_a_shard": jl["pip_heavy_tiled"] == chunks * shards,
        "join_rejects_recheck": rejects_recheck,
        "dist_join_equal": np_same(dj, joined),
        "dist_join_counts_equal_bincount": np_same(dl, counts_want.astype(np.int64)),
        "dist_join_heavy_once_a_shard": djl["pip_heavy_tiled"] == shards,
        "dist_join_table_sharded": bool(layout["table_sharded"]),
        "dist_join_replicated_table_equal": np_same(dj_rep, joined)
        and np_same(dl_rep, dl),
        "dist_join_exhaustion_raises_no_degradation": dist_exhausted
        and "degraded" not in ex_kinds and "retry_exhausted" in ex_kinds,
        "stream_equal": stream_equal,
        "stream_launched_pip_heavy_tiled": sl["pip_heavy_tiled"] > 0,
        "serve_equal_pip_join": all(np_same(g, w) for g, w in zip(got, want)),
        "serve_no_cold_compile": m["cold_compiles"] == 0,
        "serve_no_nvcc_build": serve_nvcc == 0,
        "serve_one_graph_per_rung_and_shard": graphs == [
            (b, i) for b in ladder.buckets for i in range(shards)],
        "serve_close_frees_every_graph": core._graphs == {},
        "serve_nothing_shed_or_degraded": m["shed"] == 0 and m["degraded"] == 0,
        "zonal_equal": all(zonal_equal.values()),
        "zonal_launched_kernels": zonal_l["zones_tiled"]["zonal_tiled"] > 0
        and zonal_l["zones_fold"]["zonal_fold"] > 0
        and zonal_l["zones_tiled"]["pip_heavy_tiled"] > 0,
        "overlay_equal": overlay_equal,
        "overlay_launched_zonal_seq_fold": ol["zonal_fold"] > 0,
    }
    emit({
        "phase": "multi_device", "card": card, "shards": shards,
        "devices": [str(d) for d in mesh.device_list],
        "logical": len(mesh.distinct) < shards,
        "join": {"points": int(raw.shape[0]), "batch_size": MESH_BATCH,
                 "chunks": chunks, "cold_s": join_cold_s, "mesh_s": mesh_s,
                 "single_s": single_s,
                 "mesh_points_per_s": raw.shape[0] / mesh_s,
                 "single_points_per_s": raw.shape[0] / single_s,
                 "pip_heavy_tiled_launches": jl["pip_heavy_tiled"]},
        "dist_join": {"mesh": dmesh.shape, "table_sharded": layout["table_sharded"],
                      "index_bytes": DJ.index_nbytes(ix),
                      "shard_bytes": layout["shard_bytes"],
                      "gathered_bytes": layout["gathered_bytes"],
                      "pip_heavy_tiled_launches": djl["pip_heavy_tiled"]},
        "stream": {"batches": 3, "batch": MESH_STREAM, "launches": sl},
        "serve": {"requests": MESH_REQUESTS, "ladder": list(MESH_LADDER),
                  "warmup_s": warm_s, "signatures": warm_info["signatures"],
                  "graphs": len(graphs), "loop_s": serve_s,
                  "requests_per_s": MESH_REQUESTS / serve_s, "launches": srv_l},
        "zonal": {"crop": [CROP, CROP], "equal": zonal_equal, "launches": zonal_l},
        "overlay": {"pairs": int(om.pairs.shape[0]), "launches": ol},
        "launches": launches, "phase_s": time.perf_counter() - t_phase,
        "gates": gates,
    })
    bad = [g for g, v in gates.items() if not v]
    if bad:
        return f"multi_device gates failed: {bad}", launches
    return None, launches


def latency_outlier(lat, t_start, t0, rows, events, gcp) -> dict:
    """Where the slowest request of a closed loop came from: its index,
    submit time (s after the loop began), rows and latency; the dispatches
    that ran while it was in flight (bucket, seconds, and whether it was
    that bucket's first dispatch since warmup); and the GC pauses that
    overlapped it."""
    i = max(range(len(lat)), key=lambda j: lat[j] if lat[j] is not None else -1.0)
    a, b = t_start[i], t_start[i] + lat[i]
    off = time.monotonic() - time.perf_counter()  # events stamp ts_mono
    first, during = set(), []
    for e in events:
        if e.get("event") != "serve_stage" or e.get("stage") != "dispatch":
            continue
        bucket = e.get("bucket")
        is_first = bucket not in first
        first.add(bucket)
        end = e["ts_mono"] - off
        if a <= end <= b:
            during.append({"kind": e.get("kind", "pip"), "bucket": bucket,
                           "rows": e.get("rows"), "seconds": e.get("seconds"),
                           "first_at_bucket": is_first})
    gc_in = [{"at_s": p0 - t0, "seconds": sec, "generation": gen}
             for p0, sec, gen in gcp.pauses if p0 < b and p0 + sec > a]
    return {"request": i, "submitted_at_s": a - t0, "rows": rows[i],
            "latency_s": lat[i], "dispatches_in_flight": during[:8],
            "gc_pauses_in_flight": gc_in}


def plane_installed() -> dict:
    """Which of the ops plane's observers the port's telemetry spine holds
    (importing ``mosaic_tpu_torch.obs`` installs all four)."""
    from mosaic_tpu_torch.obs import health, metrics, recorder, slo
    from mosaic_tpu_torch.runtime import telemetry

    on = telemetry._OBSERVERS
    return {"bridge": metrics._on_event in on,
            "recorder": recorder.RECORDER.observer in on,
            "slo_monitor": slo.MONITOR.observer in on,
            "health_monitor": health.MONITOR.observer in on}


def parse_prometheus(text: str) -> dict:
    """{(name, sorted label pairs): value} of a Prometheus text exposition;
    raises ValueError on a line that is neither a comment nor a sample."""
    import re

    sample = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$")
    label = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = sample.match(ln)
        if m is None:
            raise ValueError(f"not a sample line: {ln!r}")
        out[(m.group(1), tuple(sorted(label.findall(m.group(2) or ""))))] = float(m.group(3))
    return out


class OpsScraper:
    """8m's ops server around 8d's loop: ``OpsServer(0)`` on loopback,
    ``/metrics`` and ``/`` scraped once before the loop, every
    ``OBS_SCRAPE_S`` during it (a thread that sleeps between scrapes) and
    once after it; :meth:`finish` reads ``/health``, stops the server and
    tries its port again."""

    def __init__(self):
        from mosaic_tpu_torch.obs import OpsServer

        self.srv = OpsServer(0).start()
        self.port = self.srv.port
        self.scrapes, self.errors = [], []  # (perf_counter, label, metrics)
        self._stop, self._thread = threading.Event(), None
        self.scrape("before")

    def _get(self, path):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=5)
        try:
            conn.request("GET", path)
            r = conn.getresponse()
            return r.status, r.read().decode()
        finally:
            conn.close()

    def scrape(self, label):
        try:
            st, text = self._get("/metrics")
            st_root, root = self._get("/")
            if (st, st_root) != (200, 200) or "incarnation" not in json.loads(root):
                raise ValueError(f"status {st}, {st_root}")
            self.scrapes.append((time.perf_counter(), label, parse_prometheus(text)))
        except (OSError, ValueError) as e:
            self.errors.append(f"{label}: {e!r}"[:200])

    def during(self):
        def loop():
            while not self._stop.wait(OBS_SCRAPE_S):
                self.scrape("during")

        self._thread = threading.Thread(target=loop, daemon=True)  # lint: thread-context-adoption-ok (scrapes the ops server over HTTP: it runs no mosaic code)
        self._thread.start()

    def finish(self) -> None:
        """The scrape after the loop; keeps the ``/health`` document and
        whether the port refuses connections once the server stopped."""
        self._stop.set()
        self._thread.join()
        self.scrape("after")
        self.health = json.loads(self._get("/health")[1])
        self.srv.stop()
        try:
            self._get("/metrics")
            self.refused = False
        except OSError:
            self.refused = True

    def delta(self, name, **labels) -> float:
        key = (name, tuple(sorted(labels.items())))
        return self.scrapes[-1][2].get(key, 0.0) - self.scrapes[0][2].get(key, 0.0)


def serve_obs_gates(scr, t_loop, completed, events, ev2, run_dir) -> dict:
    """Phase 8m in the serving process: the ops server's scrapes around
    8d's loop (``t_loop``, its perf_counter window; ``completed`` requests),
    the flight recorder's dump of 8e's exhausted retries (``ev2``, their
    events) and the timeline of 8d's trail (``events``)."""
    from mosaic_tpu_torch.obs import RECORDER, export, timeline

    health, refused = scr.health, scr.refused
    during = [s for s in scr.scrapes if s[1] == "during" and t_loop[0] <= s[0] <= t_loop[1]]
    after = scr.scrapes[-1][2] if scr.scrapes and scr.scrapes[-1][1] == "after" else {}
    cold = after.get(("obs_compile_count", (("kind", "serve_cold"),)), 0.0)
    states = {k: v.get("state") for k, v in health.get("scopes", {}).items()}
    # the dump 8e's exhausted retries left: its trigger is the failing
    # serve.dispatch span's retry_exhausted
    dump = RECORDER.last_dump or []
    trig = next((e for e in reversed(dump) if e.get("event") == "retry_exhausted"), {})
    failed = [(e["trace_id"], e["span_id"]) for e in ev2 if e.get("event") == "span"
              and e.get("name") == "serve.dispatch" and e.get("error") == "RetryExhausted"]
    path = RECORDER.last_dump_path
    rows = export.read_trail(path) if path and os.path.exists(path) else []
    first_diff = next((i for i, (a, b) in enumerate(zip(rows[1:], dump)) if a != b), None)
    attr = timeline.attribute(events)
    trace_path = os.path.join(run_dir, "serve_trace.json")
    export.write_chrome_trace(events, trace_path)
    with open(trace_path) as fh:
        doc = json.load(fh)
    os.remove(trace_path)
    tracks = {e["args"]["name"] for e in doc["traceEvents"] if e.get("ph") == "M"}
    gates = {
        "plane_installed": all(plane_installed().values()),
        "ops_scrapes_parse": not scr.errors and len(during) >= 2 and bool(after),
        "ops_requests_completed_delta": scr.delta("serve_requests_completed") == completed,
        "ops_request_seconds_count_delta": scr.delta("serve_request_seconds_count") == completed,
        "ops_no_serve_cold_compile": cold == 0,
        "ops_health_all_healthy": bool(states) and all(v == "healthy" for v in states.values()),
        "ops_refused_after_stop": refused,
        "recorder_dumped_retry_exhausted": trig.get("label") == "serve.dispatch"
        and (trig.get("trace_id"), trig.get("span_id")) in failed,
        "recorder_file_reads_back_equal": bool(rows) and rows[0].get("event") == "incarnation"
        and rows[1:] == dump,
        "timeline_serve_sums_to_wall": attr is not None
        and abs(attr["sum_s"] - attr["wall_s"]) <= 1e-6 * attr["wall_s"],
        "chrome_trace_valid": all(e.get("dur", 0) >= 0 for e in doc["traceEvents"])
        and {"mosaic:queue_wait"} <= tracks,
    }
    return {
        "scrapes": {"before": 1, "during_loop": len(during), "after": int(bool(after)),
                    "errors": scr.errors[:3]},
        "requests_completed": completed,
        "requests_completed_delta": scr.delta("serve_requests_completed"),
        "request_seconds_count_delta": scr.delta("serve_request_seconds_count"),
        "serve_cold_compiles": cold, "health": states,
        "recorder": {"auto_dumps": RECORDER.auto_dumps, "dump_events": len(dump),
                     "trigger_seq": trig.get("seq"), "file": os.path.basename(path or ""),
                     "file_rows": len(rows), "first_difference": first_diff},
        "timeline_serve": None if attr is None else {
            "wall_s": attr["wall_s"], "sum_s": attr["sum_s"],
            "shares": {c: v["share"] for c, v in attr["classes"].items()}},
        "chrome_trace": {"events": len(doc["traceEvents"]), "class_tracks": sorted(tracks)},
        "gates": gates,
    }


def record_cost_us() -> dict:
    """Host µs per ``telemetry.record`` with the ops plane's observers on the
    spine and with them removed: interleaved rounds of ``OBS_PROBE_N``
    calls, the best round of each, for an event no observer folds and for
    ``serve_request`` (counted, observed into a histogram, and read by the
    SLO and health monitors)."""
    from mosaic_tpu_torch.runtime import telemetry

    installed = list(telemetry._OBSERVERS)

    def once(event):
        t0 = time.perf_counter()
        for _ in range(OBS_PROBE_N):
            telemetry.record(event, seconds=0.001)
        return (time.perf_counter() - t0) / OBS_PROBE_N * 1e6

    out = {}
    for event in ("obs_cost_probe", "serve_request"):
        bare = on = float("inf")
        try:
            for _ in range(OBS_PROBE_ROUNDS):
                for fn in installed:
                    telemetry.remove_observer(fn)
                bare = min(bare, once(event))
                for fn in installed:
                    telemetry.add_observer(fn)
                on = min(on, once(event))
        finally:
            for fn in installed:
                telemetry.add_observer(fn)
        out[event] = {"installed_us": on, "removed_us": bare, "ratio": on / bare}
    return out


def obs_phase(obs_dir: str, serve_obs: dict):
    """Phase 8m in the main process, after the serving process returned:
    the tools over the durable stream's trail (this process) and 8d's
    (the serving process). Returns the failure's exit code, or None."""
    import contextlib
    import io

    from mosaic_tpu_torch.obs import export, timeline
    from mosaic_tpu_torch.tools import doctor, fleet_report, perf_gate, stall_report
    from mosaic_tpu_torch.tools import trace_report

    t0 = time.perf_counter()
    paths = {k: os.path.join(obs_dir, f"{k}.jsonl") for k in ("stream", "serve")}
    if KEEP_TRAILS:
        os.makedirs(KEEP_TRAILS, exist_ok=True)
        for p in paths.values():
            shutil.copy(p, KEEP_TRAILS)
    trails = {k: export.read_trail(p) for k, p in paths.items()}
    attr = timeline.attribute(trails["stream"])

    def tool(mod, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            rc = mod.main(argv)
        lines = out.getvalue().strip().splitlines()
        return rc, json.loads(lines[-1]) if lines else None

    merged, fleet = fleet_report.stitch(list(paths.values()))
    walls = [e["ts_wall"] for e in merged if "ts_wall" in e]
    diag = doctor.diagnose(list(paths.values()))
    checks = {c["check"]: c for c in diag["checks"]}
    pool_args = ["--trail", paths["stream"], "--trail", paths["serve"]]
    verdict, red, top = None, (None, None), None
    if os.path.exists(perf_gate.DEFAULT_GOLDEN):
        rc, line = tool(perf_gate, pool_args)
        verdict = {"exit": rc, "pass": (line or {}).get("pass"),
                   "not_ok": {k: v for k, v in (line or {}).get("stages", {}).items()
                              if not v["ok"]}}
        with open(perf_gate.DEFAULT_GOLDEN) as fh:
            golden = json.load(fh)["stages"]
        fresh = perf_gate.merge_pools(perf_gate.stage_odds(t) for t in trails.values())
        required = [k for k, g in golden.items() if g.get("require") and k in fresh]
        top = max(required, key=lambda k: golden[k]["odds"], default=None)
        if top is not None:
            red = tool(perf_gate, pool_args + ["--inject-slowdown", f"{top}:10"])
    stages = {k: dict(sorted(trace_report.stage_breakdown(t).items(),
                             key=lambda kv: -kv[1]["total_s"])[:6])
              for k, t in trails.items()}
    stalls = {}
    for k, t in trails.items():
        rep = stall_report.build_report(t)
        stalls[k] = None if rep is None else {
            "window": rep["window"]["source"], "wall_s": rep["wall_s"],
            "shares": {c: v["share"] for c, v in rep["classes"].items()},
            "top_stall": rep["top_stall"], "sum_ok": rep["sum_ok"]}
    tools_s = time.perf_counter() - t0
    cost = record_cost_us()
    gates = {
        "plane_installed": all(plane_installed().values()),
        "timeline_stream_sums_to_wall": attr is not None
        and abs(attr["sum_s"] - attr["wall_s"]) <= 1e-6 * attr["wall_s"],
        "fleet_two_incarnations_monotone": len(fleet["incarnations"]) == 2
        and walls == sorted(walls),
        "doctor_cold_compiles_green": checks["cold_compiles"]["status"] == "green",
        "perf_gate_red_on_10x": red[0] == 1 and (red[1] or {}).get("pass") is False,
    }
    emit({
        "phase": "observability", "trails": {k: len(t) for k, t in trails.items()},
        "timeline_stream": None if attr is None else {
            "window": attr["window"]["source"], "wall_s": attr["wall_s"],
            "sum_s": attr["sum_s"],
            "shares": {c: v["share"] for c, v in attr["classes"].items()}},
        "fleet": {"incarnations": len(fleet["incarnations"]), "chain": fleet["chain"]},
        "doctor": {k: {"status": c["status"], "findings": len(c["findings"])}
                   for k, c in checks.items()},
        "perf_gate_verdict": verdict, "perf_gate_injected": {
            "stage": top, "exit": red[0], "pass": (red[1] or {}).get("pass")},
        "trace_report_top_stages": stages, "stall_report": stalls,
        "record_cost_us": cost,
        "events_per_served_request": serve_obs.get("events_per_request"),
        "serve_requests_per_s": serve_obs.get("requests_per_s"),
        "tools_s": tools_s, "phase_s": time.perf_counter() - t0, "gates": gates,
    })
    shutil.rmtree(obs_dir, ignore_errors=True)
    bad = [k for k, v in gates.items() if not v]
    if bad:
        return fail(f"observability gates failed: {bad}")
    return None


def serve_phases(ix, H3, dev, ix2, ix2_s, profile_root):
    """Phases 8d-8f, serving over phase 3's index; 8e swaps in ``ix2``,
    epoch 0 of phase 8k's epochal index, which the serving process built
    and published in ``ix2_s`` seconds before its phases, then swaps
    again to the tuning profile 8l stored under ``profile_root``. Returns
    (failure message or None, {"serve": launches, "serve_tuned":
    launches, "router": launches} of ``pip_heavy_tiled``, each counted
    from 0 just before its run, and the function that runs the profiled
    window, to be called last)."""
    import numpy as np
    import torch

    from mosaic_tpu_torch import tune as T
    from mosaic_tpu_torch.datasets import NYC_BBOX
    from mosaic_tpu_torch.dispatch import BucketLadder, backend_compiles
    from mosaic_tpu_torch.kernels import pip as K
    from mosaic_tpu_torch.runtime import (
        DegradedResult, Overloaded, RetryExhausted, faults, telemetry,
    )
    from mosaic_tpu_torch.serve import ServeEngine, ServeRouter
    from mosaic_tpu_torch.sql import join as J

    bbox = NYC_BBOX
    ekw = dict(
        ladder=BucketLadder(*SERVE_LADDER), max_batch_rows=SERVE_MAX_BATCH,
        max_wait_s=SERVE_WINDOW_S, queue_capacity=SERVE_QUEUE,
        default_deadline_s=SERVE_DEADLINE_S, bounds=bbox,
    )

    def make_requests(seed, count):
        rng = np.random.default_rng(seed)
        sizes = rng.integers(SERVE_ROWS[0], SERVE_ROWS[1] + 1, count)
        return [rng.uniform(bbox[:2], bbox[2:], (int(n), 2)) for n in sizes]

    def joined(reqs, index):
        """`pip_join(probe="scatter")` of the concatenation, split per
        request (the join is pointwise)."""
        out = J.pip_join(np.concatenate(reqs), None, H3, RES, chip_index=index,
                         probe="scatter", recheck=False)
        return np.split(out, np.cumsum([len(r) for r in reqs])[:-1])

    def exact(answers, want) -> bool:
        return all(a is not None and not isinstance(a, DegradedResult)
                   and np.array_equal(a, w) for a, w in zip(answers, want))

    def first_mismatch(answers, want):
        """(request, rows that differ, got, want) of the first request
        that differs from ``want``, or None."""
        for i, (a, w) in enumerate(zip(answers, want)):
            if a is None or not np.array_equal(a, w):
                d = None if a is None else np.nonzero(np.asarray(a) != w)[0][:3]
                return (i, None if d is None else d.tolist(),
                        None if a is None else np.asarray(a)[d].tolist(), w[d].tolist()
                        if d is not None else None, type(a).__name__)
        return None

    def closed_loop(eng, reqs, timing=None):
        """(answers, errors, wall s): SERVE_CLIENTS clients, each submitting
        its next request when its last one is answered. ``timing``, a dict,
        gets each request's client-side latency and submit instant."""
        answers, errors = [None] * len(reqs), []
        lat, t_start = [None] * len(reqs), [None] * len(reqs)
        cursor, lock = iter(range(len(reqs))), threading.Lock()
        sinks = telemetry.current_sinks()

        def client():
            telemetry.adopt_sinks(sinks)
            while True:
                with lock:
                    i = next(cursor, None)
                if i is None:
                    return
                t_start[i] = time.perf_counter()
                try:
                    answers[i] = eng.submit(reqs[i]).result()
                except Exception as e:  # lint: broad-except-ok (every failure is listed and gated)
                    errors.append((i, repr(e)[:200]))
                lat[i] = time.perf_counter() - t_start[i]

        threads = [threading.Thread(target=client, daemon=True)  # lint: thread-context-adoption-ok (a load client: the engine's batcher adopts each request's context)
                   for _ in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if timing is not None:
            timing.update(lat=lat, t_start=t_start, t0=t0)
        return answers, errors, time.perf_counter() - t0

    reqs = make_requests(SERVE_SEED, SERVE_REQUESTS)
    n_pts = int(sum(len(r) for r in reqs))
    want = joined(reqs, ix)
    # 8d. serve: warm the ladder, then the closed loop
    eng = ServeEngine(ix, H3, RES, probe="adaptive", **ekw)
    b_before = backend_compiles()
    t0 = time.perf_counter()
    warm = eng.warmup()
    warm_wall = time.perf_counter() - t0
    b_warm = backend_compiles()
    rng = np.random.default_rng(SERVE_SEED + 1)
    syncs = {}
    for b in eng.ladder.buckets:
        staged = eng.core.stage(rng.uniform(bbox[:2], bbox[2:], (b, 2)))
        syncs[b] = count_syncs(lambda: eng.core.probe_staged(*staged))[0]
    # 8m: the ops server, scraped before, during and after the loop
    scr = OpsScraper()
    K.pip_heavy_tiled.launches = 0
    timing = {}
    with telemetry.capture() as events, GcPauses() as gcp:
        scr.during()
        answers, errors, wall = closed_loop(eng, reqs, timing)
    t_loop = (timing["t0"], timing["t0"] + wall)
    scr.finish()
    serve_launches = K.pip_heavy_tiled.launches
    outlier = latency_outlier(timing["lat"], timing["t_start"], timing["t0"],
                              [len(r) for r in reqs], events, gcp)
    m = eng.metrics()
    lat = telemetry.summarize(events, "serve_request")
    with ServeEngine(ix, H3, RES, **ekw) as eng_s:  # the default probe
        eng_s.warmup()
        answers_s, errors_s, wall_s = closed_loop(eng_s, reqs)
        m_s = eng_s.metrics()
    contention = dispatch_contention(
        eng.core, rng.uniform(bbox[:2], bbox[2:], (1024, 2)))
    b_after = backend_compiles()
    serve_ok = {
        "equal_to_pip_join": not errors and exact(answers, want),
        "scatter_engine_equal": not errors_s and exact(answers_s, want),
        "signatures_equal_rungs": warm["signatures"] == len(eng.ladder.buckets)
        == m["compile_signatures"],
        "no_cold_compiles": m["cold_compiles"] == 0 and m_s["cold_compiles"] == 0,
        "no_nvcc_build_after_warmup": b_after == b_warm,
        "no_shed_or_degraded": m["shed"] == 0 and m["degraded"] == 0
        and m_s["shed"] == 0 and m_s["degraded"] == 0,
        "launched_pip_heavy_tiled": serve_launches > 0,
        "probe_free_of_host_syncs": not any(syncs.values()),
    }
    emit({
        "phase": "serve", "requests": SERVE_REQUESTS, "points": n_pts,
        "clients": SERVE_CLIENTS, "ladder": list(SERVE_LADDER),
        "window_s": SERVE_WINDOW_S, "deadline_s": SERVE_DEADLINE_S,
        "probe": "adaptive", "wall_s": wall,
        "requests_per_s": SERVE_REQUESTS / wall, "points_per_s": n_pts / wall,
        "latency_s": lat, "occupancy_mean": m["occupancy_mean"],
        "batches": m["batches"], "pip_heavy_tiled_launches": serve_launches,
        "warmup_s": warm_wall, "warmup_rung_s": warm["rung_seconds"],
        "backend_compiles": {"before_warmup": b_before, "after_warmup": b_warm,
                             "after_serving": b_after},
        "host_syncs_per_rung": syncs,
        "dispatch_ms_1024_rows": contention,
        "latency_max_request": outlier, "gc_during_loop": gcp.summary(),
        "scatter_engine": {"wall_s": wall_s, "requests_per_s": SERVE_REQUESTS / wall_s,
                           "batches": m_s["batches"]},
        "errors": errors[:3] + errors_s[:3],
        "first_mismatch": first_mismatch(answers, want),
        "first_mismatch_scatter": first_mismatch(answers_s, want), "gates": serve_ok,
    })
    bad = [k for k, v in serve_ok.items() if not v]
    if bad:
        eng.close()
        return f"serve gates failed: {bad}", None, None

    # 8e. resilience and a hot swap under load, on the same engine
    with telemetry.capture() as ev1:
        with faults.transient_errors(1, sites=("serve.dispatch",)):
            got = eng.join(reqs[1])
    retried = [e["event"] for e in ev1].count("transient_retry")
    with telemetry.capture() as ev2:
        with faults.transient_errors(50, sites=("serve.dispatch",)):
            fut = eng.submit(reqs[2])
            try:
                fut.result()
                exhausted = False
            except RetryExhausted:
                exhausted = True
    kinds2 = [e["event"] for e in ev2]
    poison = np.random.default_rng(SERVE_SEED + 2).uniform(bbox[:2], bbox[2:], (1000, 2))
    bad_rows = np.zeros(len(poison), bool)
    bad_rows[::len(poison) // SERVE_POISON] = True
    poison[bad_rows] = np.nan
    q0 = eng.metrics()["quarantined"]
    fa, fp, fb = (eng.submit(x) for x in (reqs[3], poison, reqs[4]))
    out_a, out_p, out_b = fa.result(), fp.result(), fb.result()
    want_p = J.pip_join(poison[~bad_rows], None, H3, RES, chip_index=ix,
                        probe="scatter", recheck=False)
    parked = eng.metrics()["quarantined"] - q0
    want2 = joined(reqs, ix2)
    subs, stop, swapped = [], threading.Event(), threading.Event()

    def streamer():
        i = 0
        while not stop.is_set():
            after = swapped.is_set()
            try:
                subs.append((i % len(reqs), eng.submit(reqs[i % len(reqs)]), after))
            except Overloaded:
                subs.append((i % len(reqs), None, after))
            i += 1
            time.sleep(0.001)

    th = threading.Thread(target=streamer, daemon=True)  # lint: thread-context-adoption-ok (a load client: the engine's batcher adopts each request's context)
    th.start()
    time.sleep(0.3)
    t0 = time.perf_counter()
    swap = eng.hot_swap(ix2)
    swap_s = time.perf_counter() - t0
    swapped.set()
    time.sleep(0.3)
    stop.set()
    th.join()
    torn, stale, shed_swap, n_after = 0, 0, 0, 0
    for i, f, after in subs:
        if f is None:
            shed_swap += 1
            continue
        try:
            a = f.result()
        except Overloaded:
            shed_swap += 1
            continue
        old_ok, new_ok = np.array_equal(a, want[i]), np.array_equal(a, want2[i])
        torn += not (old_ok or new_ok)
        if after:
            n_after += 1
            stale += not new_ok
    m2 = eng.metrics()
    res_ok = {
        "retry_equal": np.array_equal(got, want[1]) and retried == 1
        and not isinstance(got, DegradedResult),
        "exhaustion_raised": exhausted and "degraded" not in kinds2
        and "retry_exhausted" in kinds2,
        "parked_exact": parked == SERVE_POISON and bool((out_p[bad_rows] == -1).all())
        and np.array_equal(out_p[~bad_rows], want_p)
        and np.array_equal(out_a, want[3]) and np.array_equal(out_b, want[4]),
        "swap_observable": any(not np.array_equal(a, b) for a, b in zip(want, want2)),
        "swap_untorn": torn == 0 and len(subs) > shed_swap,
        "after_swap_new_index": stale == 0 and n_after > 0,
        "no_cold_compiles_after_swap": m2["cold_compiles"] == 0
        and swap["backend_compiles"] == 0,
        "never_degraded": m2["degraded"] == 0,
    }
    emit({
        "phase": "serve_resilience", "retry_events": retried, "exhausted": exhausted,
        "parked_rows": parked, "swap_index_build_s": ix2_s, "hot_swap_s": swap_s,
        "swap_warmup": swap, "swap_requests": len(subs), "swap_after": n_after,
        "swap_shed": shed_swap, "torn": torn, "stale_after_swap": stale,
        "gates": res_ok,
    })
    bad = [k for k, v in res_ok.items() if not v]
    if bad:
        eng.close()
        return f"serve_resilience gates failed: {bad}", None, None

    # 8m in this process: the ops server's scrapes of 8d's loop, the
    # flight recorder's dump of 8e's exhausted retries, the timeline and
    # the Chrome trace of 8d's trail, which goes to the main process's tools
    completed = sum(a is not None for a in answers)
    obs_line = serve_obs_gates(scr, t_loop, completed, events, ev2,
                               os.path.dirname(profile_root))
    OBS_SERVE.update(events_per_request=len(events) / SERVE_REQUESTS,
                     requests_per_s=SERVE_REQUESTS / wall)
    emit({"phase": "observability_serve", "events": len(events), **OBS_SERVE, **obs_line})
    from mosaic_tpu_torch.obs import write_jsonl

    os.makedirs(os.path.join(HERE, OBS_DIR), exist_ok=True)
    write_jsonl(events, os.path.join(HERE, OBS_DIR, "serve.jsonl"))
    bad = [k for k, v in obs_line["gates"].items() if not v]
    if bad:
        eng.close()
        return f"observability_serve gates failed: {bad}", None, None

    # 8e (cont.). hot_swap to 8l's stored profile: its ladder, its probe,
    # at the new index's resolution; each rung's capture and the memory
    # the allocator holds after it
    tuned, _ = T.ProfileStore(profile_root).load_latest(
        expect_fingerprint=T.index_fingerprint(ix))
    rungs = []

    def on_rung(e):
        if e.get("event") == "dispatch_stage" and e.get("stage") == "warmup":
            rungs.append({"bucket": e["bucket"], "capture_s": e["seconds"],
                          "memory_reserved": torch.cuda.memory_reserved()})

    replaced = eng.core
    mem0 = torch.cuda.memory_reserved()
    b0 = backend_compiles()
    telemetry.add_observer(on_rung)
    try:
        t0 = time.perf_counter()
        tswap = eng.hot_swap(ix2, profile=tuned, resolution=RES)
        tswap_s = time.perf_counter() - t0
    finally:
        telemetry.remove_observer(on_rung)
    treqs_e = reqs[:SERVE_REQUESTS // 4]
    big = np.random.default_rng(SERVE_SEED + 3).uniform(
        bbox[:2], bbox[2:], (TUNE_TOP_ROWS, 2))
    K.pip_heavy_tiled.launches = 0
    answers_t, errors_t, wall_t = closed_loop(eng, treqs_e)
    big_got = eng.submit(big).result()
    tuned_launches = K.pip_heavy_tiled.launches
    big_want = J.pip_join(big, None, H3, RES, chip_index=ix2, probe="scatter",
                          recheck=False)
    m3 = eng.metrics()
    tuned_ladder = BucketLadder(tuned.bucket_min or 64, tuned.bucket_max or 65536)
    eng.close()
    tuned_ok = {
        "equal_to_pip_join": not errors_t and exact(answers_t, want2)
        and bool(np.array_equal(big_got, big_want)),
        "profile_ladder_and_probe": eng.ladder.buckets == tuned_ladder.buckets
        and eng.probe == tuned.probe and eng.resolution == RES,
        "top_rung_served": eng.ladder.max_bucket >= TUNE_TOP_ROWS,
        "no_nvcc_build_or_cold_compile": tswap["backend_compiles"] == 0
        and backend_compiles() == b0 and m3["cold_compiles"] == 0,
        "replaced_core_graphs_freed": not replaced._graphs,
        "never_degraded": m3["degraded"] == 0,
        "launched_pip_heavy_tiled": tuned.probe != "adaptive" or tuned_launches > 0,
    }
    emit({
        "phase": "serve_tuned", "profile": {
            k: v for k, v in tuned.as_dict().items() if k not in ("rationale", "source")},
        "ladder": list(eng.ladder.buckets), "hot_swap_s": tswap_s,
        "swap_warmup": tswap, "rungs": rungs, "memory_reserved_before": mem0,
        "requests": len(treqs_e), "wall_s": wall_t,
        "requests_per_s": len(treqs_e) / wall_t, "top_rung_request_rows": TUNE_TOP_ROWS,
        "pip_heavy_tiled_launches": tuned_launches, "errors": errors_t[:3],
        "first_mismatch": first_mismatch(answers_t, want2), "gates": tuned_ok,
    })
    bad = [k for k, v in tuned_ok.items() if not v]
    if bad:
        return f"serve_tuned gates failed: {bad}", None, None

    # 8f. the router: an aggressor at 15x a victim's rate, open loop
    rkw = dict(ekw, probe="adaptive")
    router = ServeRouter(H3, max_resident=TENANTS, engine_defaults=rkw)
    t0 = time.perf_counter()
    for t in range(TENANTS):
        router.add_tenant(f"tenant_{t}", ix, RES)
    tenants_warm_s = time.perf_counter() - t0
    treqs = {t: make_requests(SERVE_SEED + t, int(TENANT_REQUESTS * (TENANT_MULT if t == 0 else 1)))
             for t in range(TENANTS)}
    twant = {t: joined(treqs[t], ix) for t in range(TENANTS)}
    stats = {t: {"shed_submit": 0, "shed_deadline": 0, "other": 0, "lat": [],
                 "answers": [None] * len(treqs[t])} for t in range(TENANTS)}
    lock, futures = threading.Lock(), []

    sinks = telemetry.current_sinks()

    def tenant_load(t):
        # requests carry their submitter's sinks to the batcher threads
        telemetry.adopt_sinks(sinks)
        r = np.random.default_rng(1000 + t)
        rate = TENANT_RATE * (TENANT_MULT if t == 0 else 1.0)
        next_t = time.perf_counter()
        for i, pts in enumerate(treqs[t]):
            next_t += float(r.exponential(1.0 / rate))
            lag = next_t - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
            t1 = time.perf_counter()
            try:
                f = router.submit(f"tenant_{t}", pts)
            except Overloaded:
                with lock:
                    stats[t]["shed_submit"] += 1
                continue

            def done(f, t=t, i=i, t1=t1):
                dt = time.perf_counter() - t1
                exc = f.exception()
                with lock:
                    if exc is None:
                        stats[t]["lat"].append(dt)
                        stats[t]["answers"][i] = f.result()
                    elif isinstance(exc, Overloaded) and exc.reason == "deadline":
                        stats[t]["shed_deadline"] += 1
                    else:
                        stats[t]["other"] += 1

            f.add_done_callback(done)
            with lock:
                futures.append(f)

    threads = [threading.Thread(target=tenant_load, args=(t,), daemon=True)  # lint: thread-context-adoption-ok (a load client: the router's batchers adopt each request's context)
               for t in range(TENANTS)]
    import concurrent.futures as cf

    K.pip_heavy_tiled.launches = 0
    with telemetry.capture() as rev:
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        cf.wait(futures)
        router_wall = time.perf_counter() - t0
    router_stages = {
        stage: telemetry.summarize([e for e in rev if e["event"] == "serve_stage"
                                    and e.get("stage") == stage])
        for stage in ("queue_wait", "batch", "dispatch")
    }
    router_launches = K.pip_heavy_tiled.launches
    rm = router.metrics()
    router.close()
    per = {}
    for t in range(TENANTS):
        s, total = stats[t], len(treqs[t])
        lat_t = np.asarray(s["lat"])
        per[f"tenant_{t}"] = {
            "requests": total, "completed": int(lat_t.size),
            "shed_submit": s["shed_submit"], "shed_deadline": s["shed_deadline"],
            "other_errors": s["other"],
            "shed_rate": (s["shed_submit"] + s["shed_deadline"]) / total,
            "p50_s": float(np.percentile(lat_t, 50)) if lat_t.size else None,
            "p99_s": float(np.percentile(lat_t, 99)) if lat_t.size else None,
            "exact": exact([a for a in s["answers"] if a is not None],
                           [w for a, w in zip(s["answers"], twant[t]) if a is not None]),
            "cold_compiles": rm["tenants"][f"tenant_{t}"]["cold_compiles"],
        }
    # residency: max_resident 2, the third tenant evicts one, a submit
    # to the evicted one revives it
    router2 = ServeRouter(H3, max_resident=2, engine_defaults=rkw)
    for name in ("a", "b", "c"):
        router2.add_tenant(name, ix, RES)
    m3 = router2.metrics()
    evicted = [n for n, v in m3["tenants"].items() if not v["resident"]]
    b0 = backend_compiles()
    with telemetry.capture() as ev3:
        revived = [router2.join(evicted[0], x) for x in reqs[:20]] if evicted else []
    revive_builds = backend_compiles() - b0
    revive_warm = [e for e in ev3 if e["event"] == "serve_warmup"]
    m4 = router2.metrics()
    router2.close()
    victims = [per[f"tenant_{t}"] for t in range(1, TENANTS)]
    router_ok = {
        "victims_never_shed": all(v["shed_rate"] == 0 and v["other_errors"] == 0
                                  and v["completed"] == v["requests"] for v in victims),
        "answers_exact": all(v["exact"] for v in per.values()),
        "no_cold_compiles": all(v["cold_compiles"] == 0 for v in per.values()),
        "third_tenant_evicts_one": m3["evictions"] == 1 and m3["resident"] == 2
        and len(evicted) == 1,
        "revival_exact": bool(revived) and exact(revived, want[:20]),
        "revival_builds_nothing": revive_builds == 0 and len(revive_warm) == 1
        and revive_warm[0]["backend_compiles"] == 0,
        "no_cold_compiles_after_revival": bool(evicted)
        and m4["tenants"][evicted[0]]["cold_compiles"] == 0
        and m4["tenants"][evicted[0]]["revivals"] == 2,
    }
    emit({
        "phase": "router", "tenants": TENANTS, "aggressor": "tenant_0",
        "aggressor_mult": TENANT_MULT, "rate_per_victim": TENANT_RATE,
        "quota": SERVE_QUEUE, "add_tenants_s": tenants_warm_s, "wall_s": router_wall,
        "per_tenant": per, "stage_s": router_stages,
        "pip_heavy_tiled_launches": router_launches,
        "evicted": evicted, "revival_warmup": revive_warm[0] if revive_warm else None,
        "revival_nvcc_builds": revive_builds, "gates": router_ok,
    })
    bad = [k for k, v in router_ok.items() if not v]
    if bad:
        return f"router gates failed: {bad}", None, None
    if router_launches <= 0:
        return "the router's engines never launched pip_heavy_tiled", None, None

    def profile_window():
        """The profiled window, run after every other phase of the
        process: a process the profiler has traced runs every later eager
        op slower (the serve_process line)."""
        sub = reqs[:SERVE_PROFILED]
        with ServeEngine(ix, H3, RES, probe="adaptive", **ekw) as eng_p:
            eng_p.warmup()
            sub_wall = closed_loop(eng_p, sub)[2]
            b0 = eng_p.metrics()["batches"]
            with telemetry.capture() as pev:
                busy, rows, prof_ms = profile_device(lambda: closed_loop(eng_p, sub))
            prof_batches = eng_p.metrics()["batches"] - b0
        emit({
            "phase": "serve_profile", "requests": SERVE_PROFILED, "probe": "adaptive",
            "warm_wall_ms": sub_wall * 1e3, "profiled_wall_ms": prof_ms,
            "batches": prof_batches,
            "device_ops_per_batch": sum(c for _, _, c in rows) / max(prof_batches, 1),
            **idle_share(busy, rows, sub_wall * 1e3),
            "timeline_shares": timeline_shares(pev),
            "kernels_profiled": kernel_times(rows),
            "top_device_ops": [{"op": k[:80], "ms": ms_, "calls": c}
                               for ms_, k, c in rows[:6]],
        })

    return None, {"serve": serve_launches, "serve_tuned": tuned_launches,
                  "router": router_launches}, profile_window


def knn_candidates(H3, bbox, n, seed):
    """``n`` CCW squares over ``bbox``: uniform lower-left corners and
    sides uniform in ``KNN_SIDE`` H3 res-``KNN_RES`` cell widths (the
    reference's ``tests/test_knn_serve.py square_wkts``, as CSR arrays)."""
    import numpy as np

    from mosaic_tpu_torch.core.types import GeometryType, PackedGeometry

    rng = np.random.default_rng(seed)
    w = float(np.sqrt(H3.cell_area_approx(KNN_RES)))
    cx = rng.uniform(bbox[0], bbox[2], n)
    cy = rng.uniform(bbox[1], bbox[3], n)
    s = rng.uniform(*KNN_SIDE, n) * w
    xy = np.stack([np.stack([cx, cy], -1), np.stack([cx + s, cy], -1),
                   np.stack([cx + s, cy + s], -1), np.stack([cx, cy + s], -1)],
                  axis=1).reshape(-1, 2)
    k = np.arange(n + 1, dtype=np.int64)
    return PackedGeometry(
        xy=xy, ring_offsets=4 * k, part_offsets=k, geom_offsets=k,
        geom_type=np.full(n, int(GeometryType.POLYGON), np.uint8),
        srid=np.full(n, 4326, np.int32),
    )


def point_column(pts):
    """A POINT PackedGeometry column of (n, 2) coordinates."""
    import numpy as np

    from mosaic_tpu_torch.core.types import GeometryType, PackedGeometry

    k = np.arange(len(pts) + 1, dtype=np.int64)
    return PackedGeometry(
        xy=pts, ring_offsets=k, part_offsets=k, geom_offsets=k,
        geom_type=np.full(len(pts), int(GeometryType.POINT), np.uint8),
        srid=np.full(len(pts), 4326, np.int32),
    )


def knn_phase(ix, H3, dev, kx, build_s):
    """Phase 8j, KNN on the card (``mosaic_tpu_torch/knn``, the batch
    model and KNN serving) over ``kx``, the candidates' index that the
    serving process built before its phases (``build_s`` seconds).
    Returns (failure message or None, ``pip_heavy_tiled`` launches of the
    mixed loop, the function that runs the profiled 64-row dispatch, to be
    called last)."""
    import numpy as np
    import torch

    from mosaic_tpu_torch.datasets import NYC_BBOX, random_points
    from mosaic_tpu_torch.dispatch import BucketLadder, backend_compiles
    from mosaic_tpu_torch.kernels import pip as K
    from mosaic_tpu_torch.knn import KNNFrontend, brute_force_knn
    from mosaic_tpu_torch.models import SpatialKNN
    from mosaic_tpu_torch.runtime import DegradedResult, RetryExhausted, faults, telemetry
    from mosaic_tpu_torch.serve import ServeEngine
    from mosaic_tpu_torch.sql import join as J

    t_phase = time.perf_counter()
    bbox, k = NYC_BBOX, KNN_K
    b0 = backend_compiles()
    cand = kx.candidates
    fe = {lane: KNNFrontend(kx, lane=lane) for lane in ("ring", "voronoi")}
    t0 = time.perf_counter()
    warm = {lane: f.warmup() for lane, f in fe.items()}
    warm_s = time.perf_counter() - t0
    rungs = len(fe["ring"].row_ladder.buckets) + len(fe["ring"].pair_ladder.buckets)

    def same(a, b) -> bool:
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a.view(np.int64), b.view(np.int64))

    def wire(ids, dist):
        return np.concatenate([dist, ids.astype(np.float64)], axis=1)

    # both lanes against the brute-force f64 oracle
    q_o = random_points(KNN_ORACLE, bbox, seed=KNN_SEED + 1)
    t0 = time.perf_counter()
    want_o = wire(*brute_force_knn(q_o, kx, k))
    oracle_s = time.perf_counter() - t0
    lanes_oracle = all(same(f.dispatch(q_o, k)[0], want_o) for f in fe.values())
    # the lanes on 64 rows: Voronoi = ring, each lane's rate
    q64 = random_points(KNN_ROWS, bbox, seed=KNN_SEED + 2)
    lane_s, outs = {}, {}
    for lane, f in fe.items():
        it0, t0 = f.stats["iterations"], time.perf_counter()
        outs[lane] = f.dispatch(q64, k)[0]
        lane_s[lane] = {"seconds": time.perf_counter() - t0,
                        "iterations": f.stats["iterations"] - it0}
    lane_s["voronoi"]["fallback_rows"] = fe["voronoi"].stats["voronoi_fallback"]
    # where one 64-row ring dispatch spends its time, on the host clock
    with telemetry.capture() as ev:
        t0 = time.perf_counter()
        fe["ring"].dispatch(q64, k)
        dispatch64_s = time.perf_counter() - t0
    stages = {}
    for e in ev:
        if e["event"] == "knn_stage" and "seconds" in e:
            stages[e["stage"]] = stages.get(e["stage"], 0.0) + e["seconds"]
    # the card against the CPU frontend on the same index
    kx_cpu = kx.to("cpu")
    t0 = time.perf_counter()
    out_cpu = KNNFrontend(kx_cpu, lane="ring").dispatch(q64, k)[0]
    cpu_s = time.perf_counter() - t0
    # 8n in this process: a meshed frontend's ring dispatch (every pair
    # batch sharded over the mesh) against the single-device one
    from mosaic_tpu_torch.dispatch import data_mesh

    kmesh = data_mesh(devices=mesh_devices(dev))
    t0 = time.perf_counter()
    out_mesh = KNNFrontend(kx, lane="ring", mesh=kmesh).dispatch(q64, k)[0]
    mesh_s = time.perf_counter() - t0
    # transient faults retry to the same bits; exhaustion raises on the card
    q8 = q64[:8]
    with telemetry.capture() as ev1, faults.transient_errors(1, sites=("knn.distance",)):
        retried = fe["ring"].dispatch(q8, k)[0]
    retries = [e["event"] for e in ev1].count("transient_retry")
    with telemetry.capture() as ev2, faults.transient_errors(50, sites=("knn.distance",)):
        try:
            fe["ring"].dispatch(q8, k)
            exhausted = False
        except RetryExhausted:
            exhausted = True
    kinds2 = [e["event"] for e in ev2]
    # the batch model: card against CPU on 200 landmarks (candidates and
    # landmarks in the middle KNN_MODEL_BOX share of the bbox)
    cxy = cand.bounds()
    half = np.sqrt(KNN_MODEL_BOX) / 2
    mid = np.array([(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2])
    span = np.array([bbox[2] - bbox[0], bbox[3] - bbox[1]])
    lo, hi = mid - half * span, mid + half * span
    inside = np.nonzero(((cxy[:, :2] >= lo) & (cxy[:, 2:] <= hi)).all(axis=1))[0]
    sub = cand.take(inside)
    land = point_column(random_points(KNN_LANDMARKS, (*(lo + 0.1 * half * span),
                                                      *(hi - 0.1 * half * span)),
                                      seed=KNN_SEED + 3))
    model = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        m = SpatialKNN(H3, KNN_RES, k_neighbours=k, max_iterations=64,
                       early_stop_iterations=100, approximate=False, device=d)
        t0 = time.perf_counter()
        model[name] = (m.transform(land, sub), time.perf_counter() - t0)
    rc, rp = model["card"][0], model["cpu"][0]
    model_equal = (not rc.metrics["degraded"] and all(
        np.array_equal(getattr(rc, f), getattr(rp, f))
        for f in ("landmark_id", "candidate_id", "rank")) and same(rc.distance, rp.distance))

    # the mixed closed loop: half pip requests of 1-1,024 rows, half KNN
    # requests of 1-8 rows, on one engine over phase 3's index
    rng = np.random.default_rng(KNN_SEED + 4)
    kinds = rng.permutation(np.arange(KNN_REQUESTS) % 2)  # 0 pip, 1 knn
    reqs = []
    for kind in kinds:
        lo_r, hi_r = (KNN_REQ_ROWS if kind else SERVE_ROWS)
        n = int(rng.integers(lo_r, hi_r + 1))
        reqs.append(("knn" if kind else "pip", rng.uniform(bbox[:2], bbox[2:], (n, 2))))
    pip_idx = [i for i, (kd, _) in enumerate(reqs) if kd == "pip"]
    knn_idx = [i for i, (kd, _) in enumerate(reqs) if kd == "knn"]
    want = [None] * len(reqs)
    pj = J.pip_join(np.concatenate([reqs[i][1] for i in pip_idx]), None, H3, RES,
                    chip_index=ix, probe="scatter", recheck=False)
    for i, part in zip(pip_idx, np.split(pj, np.cumsum([len(reqs[i][1]) for i in pip_idx])[:-1])):
        want[i] = part
    t0 = time.perf_counter()
    kr = fe["ring"].dispatch(np.concatenate([reqs[i][1] for i in knn_idx]), k)[0]
    want_knn_s = time.perf_counter() - t0
    for i, part in zip(knn_idx, np.split(kr, np.cumsum([len(reqs[i][1]) for i in knn_idx])[:-1])):
        want[i] = part
    ekw = dict(
        ladder=BucketLadder(*SERVE_LADDER), max_batch_rows=SERVE_MAX_BATCH,
        max_wait_s=SERVE_WINDOW_S, queue_capacity=SERVE_QUEUE,
        default_deadline_s=SERVE_DEADLINE_S, bounds=bbox,
    )
    eng = ServeEngine(ix, H3, RES, probe="adaptive", knn=fe["ring"], **ekw)
    eng.warmup()
    b_warm = backend_compiles()
    # one warm top-rung mixed dispatch: pip rows filling the top rung
    # beside the most KNN rows a batch of the loop can hold (every client
    # holding a KNN request of the most rows)
    knn_rows = SERVE_CLIENTS * KNN_REQ_ROWS[1]
    top = [types.SimpleNamespace(kind="pip", n=SERVE_MAX_BATCH - knn_rows, k=0),
           types.SimpleNamespace(kind="knn", n=knn_rows, k=k)]
    top_pts = rng.uniform(bbox[:2], bbox[2:], (SERVE_MAX_BATCH, 2))
    top_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        eng._dispatch(top_pts, None, top)
        top_s.append(time.perf_counter() - t0)
    deadline = max(SERVE_DEADLINE_S, KNN_DEADLINE_X * top_s[-1])
    answers, errors = [None] * len(reqs), []
    lat, t_start = [None] * len(reqs), [None] * len(reqs)
    cursor, lock = iter(range(len(reqs))), threading.Lock()
    sinks = telemetry.current_sinks()

    def client():
        telemetry.adopt_sinks(sinks)
        while True:
            with lock:
                i = next(cursor, None)
            if i is None:
                return
            kind, pts = reqs[i]
            t1 = t_start[i] = time.perf_counter()
            try:
                if kind == "knn":
                    answers[i] = eng.submit_knn(pts, k, deadline_s=deadline).result()
                else:
                    answers[i] = eng.submit(pts, deadline_s=deadline).result()
            except Exception as e:  # lint: broad-except-ok (every failure is listed and gated)
                errors.append((i, repr(e)[:200]))
            lat[i] = time.perf_counter() - t1

    mixed_batches, plain_mixed = [0], eng._dispatch_mixed

    def counted_mixed(*a):
        mixed_batches[0] += any(r.kind == "pip" for r in a[-1])
        return plain_mixed(*a)

    eng._dispatch_mixed = counted_mixed
    K.pip_heavy_tiled.launches = 0
    threads = [threading.Thread(target=client, daemon=True) for _ in range(SERVE_CLIENTS)]  # lint: thread-context-adoption-ok (a load client: the engine's batcher adopts each request's context)
    with telemetry.capture() as loop_events, GcPauses() as gcp:
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        loop_s = time.perf_counter() - t0
    loop_launches = K.pip_heavy_tiled.launches
    m = eng.metrics()
    eng.close()
    b_after = backend_compiles()

    def exact(i) -> bool:
        a = answers[i]
        if a is None:
            return False
        if reqs[i][0] == "pip":
            return not isinstance(a, DegradedResult) and np.array_equal(a, want[i])
        return not a.degraded and same(wire(a.ids, a.distance), want[i])

    bad_answers = [i for i in range(len(reqs)) if not exact(i)]

    def lat_summary(idx):
        v = np.asarray([lat[i] for i in idx if lat[i] is not None])
        return {"p50_s": float(np.percentile(v, 50)), "p99_s": float(np.percentile(v, 99)),
                "max_s": float(v.max())} if v.size else None

    max_lat = max((x for x in lat if x is not None), default=float("inf"))
    outlier = latency_outlier(lat, t_start, t0, [len(r[1]) for r in reqs], loop_events, gcp)
    outlier["kind"] = reqs[outlier["request"]][0]
    gates = {
        "lanes_equal_oracle": lanes_oracle,
        "voronoi_equal_ring": same(outs["voronoi"], outs["ring"]),
        "card_equal_cpu": same(outs["ring"], out_cpu),
        "mesh_ring_equal_single": same(out_mesh, outs["ring"]),
        "spatial_knn_equal_cpu": model_equal,
        "transient_retried_same_bits": retries >= 1 and same(retried, outs["ring"][:8]),
        "exhaustion_raises_no_degradation": exhausted and "degraded" not in kinds2
        and "retry_exhausted" in kinds2,
        "warmup_signatures_equal_rungs": all(w["signatures"] == rungs for w in warm.values()),
        "no_nvcc_build_or_cold_compile": backend_compiles() == b0 == b_warm == b_after
        and m["cold_compiles"] == 0 and all(f.cold_compiles == 0 for f in fe.values()),
        "mixed_loop_exact": not errors and not bad_answers,
        "nothing_shed_or_degraded": m["shed"] == 0 and m["degraded"] == 0 and not errors,
        "launched_pip_heavy_tiled": loop_launches > 0,
        "pip_and_knn_co_batched": mixed_batches[0] > 0,
    }
    knn_s = time.perf_counter() - t_phase

    def profile_64():
        """Device ops and idle share of one warm 64-row ring dispatch."""
        busy, rows, prof_ms = profile_device(lambda: fe["ring"].dispatch(q64, k))
        emit({"phase": "knn_profile", "rows": KNN_ROWS, "lane": "ring",
              "warm_ms": dispatch64_s * 1e3, "profiled_wall_ms": prof_ms,
              "device_ops": sum(c for _, _, c in rows),
              **idle_share(busy, rows, dispatch64_s * 1e3),
              "top_device_ops": [{"op": key[:80], "ms": ms_, "calls": c}
                                 for ms_, key, c in rows[:5]]})

    emit({
        "phase": "knn", "candidates": KNN_CANDIDATES, "resolution": KNN_RES, "k": k,
        "index": {"build_s": build_s, "chips": int(kx.cells.size),
                  "voronoi_sites": kx.voronoi.num_sites, "voronoi_method": kx.voronoi.method,
                  "cell_width_deg": kx.cell_width},
        "warmup_s": warm_s, "rungs": rungs, "oracle_queries": KNN_ORACLE, "oracle_s": oracle_s,
        "lanes_64_rows": {lane: {**v, "queries_per_s": KNN_ROWS / v["seconds"]}
                          for lane, v in lane_s.items()},
        "dispatch_64_rows_s": dispatch64_s, "stage_s_64_rows": stages,
        "cpu_frontend_s": cpu_s, "transient_retries": retries,
        "mesh_ring": {"shards": kmesh.size,
                      "devices": [str(d) for d in kmesh.device_list],
                      "dispatch_64_rows_s": mesh_s},
        "spatial_knn": {"landmarks": KNN_LANDMARKS, "candidates": len(sub),
                        "iterations": rc.metrics["iterations"],
                        "card_s": model["card"][1], "cpu_s": model["cpu"][1]},
        "mixed": {"requests": len(reqs), "pip": len(pip_idx), "knn": len(knn_idx),
                  "knn_rows": int(sum(len(reqs[i][1]) for i in knn_idx)),
                  "lane": "ring", "clients": SERVE_CLIENTS,
                  "top_rung_mixed_dispatch_s": top_s, "deadline_s": deadline,
                  "max_latency_over_deadline": max_lat / deadline,
                  "headroom_limit": KNN_HEADROOM, "co_batched_batches": mixed_batches[0],
                  "wall_s": loop_s, "requests_per_s": len(reqs) / loop_s,
                  "latency": {"pip": lat_summary(pip_idx), "knn": lat_summary(knn_idx)},
                  "latency_max_request": outlier, "gc_during_loop": gcp.summary(),
                  "batches": m["batches"], "pair_occupancy": m["knn_pair_occupancy"],
                  "ring_reference_s": want_knn_s,
                  "pip_heavy_tiled_launches": loop_launches,
                  "errors": errors[:3], "bad_answers": bad_answers[:5]},
        "nvcc_builds": backend_compiles() - b0, "knn_s": knn_s, "gates": gates,
    })
    bad = [g for g, v in gates.items() if not v]
    if bad:
        return f"knn gates failed: {bad}", None, None
    return None, loop_launches, profile_64


def swap_box():
    """The middle ``SWAP_BOX`` share of the NYC bbox: 8e's and 8k's zones."""
    import numpy as np

    from mosaic_tpu_torch.datasets import NYC_BBOX

    mid = np.add(NYC_BBOX[:2], NYC_BBOX[2:]) / 2
    half = np.subtract(NYC_BBOX[2:], NYC_BBOX[:2]) * np.sqrt(SWAP_BOX) / 2
    return tuple(float(v) for v in (*(mid - half), *(mid + half)))


def epoch_edits(base, box):
    """Phase 8k's ``EPOCHS`` deltas over ``base`` (stable ids 0..n-1), from
    ``EPOCH_SEED``: each upserts ``EPOCH_UPSERTS`` live ids with a grown
    (scaled 1.15-1.35 about its vertex mean) or moved (a third of a zone
    cell) version of its current ring, inserts ``EPOCH_INSERTS`` zones of
    another ``synthetic_zones`` lattice over ``box`` under new ids, and
    removes ``EPOCH_REMOVES`` other live ids. Returns [(upsert column,
    ids, removed ids)]."""
    import numpy as np

    from mosaic_tpu_torch.core.types import GeometryBuilder, GeometryType
    from mosaic_tpu_torch.datasets import synthetic_zones

    rng = np.random.default_rng(EPOCH_SEED)
    fresh = synthetic_zones(*ZONES, bbox=box, verts=256, seed=EPOCH_SEED)
    step = np.subtract(box[2:], box[:2]) / np.asarray(ZONES) / 3
    rings = {g: base.geom_xy(g) for g in range(len(base))}
    next_id, out = 10_000, []
    for _ in range(EPOCHS):
        live = np.asarray(sorted(rings))
        pick = rng.choice(live, EPOCH_UPSERTS + EPOCH_REMOVES, replace=False)
        ups, gone = pick[:EPOCH_UPSERTS], pick[EPOCH_UPSERTS:]
        b, ids = GeometryBuilder(), []
        for g in ups:
            xy = rings[int(g)]
            if rng.random() < 0.5:
                c = xy.mean(axis=0)
                xy = c + (xy - c) * rng.uniform(1.15, 1.35)
            else:
                xy = xy + step * rng.choice([-1.0, 1.0], 2)
            rings[int(g)] = xy
            b.add_geometry(GeometryType.POLYGON, [[xy]], srid=int(base.srid[0]))
            ids.append(int(g))
        for f in rng.choice(len(fresh), EPOCH_INSERTS, replace=False):
            rings[next_id] = fresh.geom_xy(int(f))
            b.add_geometry(GeometryType.POLYGON, [[rings[next_id]]],
                           srid=int(base.srid[0]))
            ids.append(next_id)
            next_id += 1
        for g in gone:
            del rings[int(g)]
        out.append((b.build(), np.asarray(ids, np.int64), gone.astype(np.int64)))
    return out


def final_column(base, edits):
    """The column ``EpochalIndex`` holds after ``edits``, in its column
    order (an upsert keeps its id's place, a new id goes last, a removal
    closes up): the input of the from-scratch rebuild phase 8k holds the
    last epoch to."""
    from mosaic_tpu_torch.core.types import GeometryBuilder

    order = list(range(len(base)))
    src = {g: (base, g) for g in order}
    for col, ids, gone in edits:
        for g in gone:
            order.remove(int(g))
            del src[int(g)]
        for i, g in enumerate(ids):
            if int(g) not in src:
                order.append(int(g))
            src[int(g)] = (col, i)
    b = GeometryBuilder()
    for g in order:
        b.append_from(*src[g])
    return b.build()


def index_bytes(index) -> int:
    """Bytes of a chip index's tensors on the device."""
    from mosaic_tpu_torch.sql import join as J

    ts = [getattr(index, n) for n in J.ChipIndex.field_names()]
    ts += [getattr(index.border, n) for n in J.ChipIndex._BORDER]
    return sum(t.numel() * t.element_size() for t in ts)


def epoch_phase(prep, H3, dev, ekw):
    """Phase 8k, epochs under load: ``EPOCHS`` deltas (``prep.edits``)
    applied to ``prep.ep`` (epoch 0 published) and each published through
    ``ServeRouter.advance_epoch`` while closed-loop clients submit pip
    requests; the last publish is killed at its torn boundary.
    ``prep.rebuilt`` is the card's ``build_chip_index(tessellate(column))``
    of the final column. Returns (failure message or None,
    ``pip_heavy_tiled`` launches of the loop)."""
    import numpy as np
    import torch

    from mosaic_tpu_torch.dispatch import BucketLadder, DispatchCore, backend_compiles
    from mosaic_tpu_torch.index import EpochalIndex, chip_index_equal
    from mosaic_tpu_torch.kernels import pip as K
    from mosaic_tpu_torch.runtime import faults, telemetry
    from mosaic_tpu_torch.serve import ServeRouter
    from mosaic_tpu_torch.sql import join as J

    t_phase = time.perf_counter()
    ep, edits = prep.ep, prep.edits
    box = swap_box()
    rng = np.random.default_rng(EPOCH_SEED + 1)
    sizes = rng.integers(SERVE_ROWS[0], SERVE_ROWS[1] + 1, EPOCH_POOL)
    pool = [rng.uniform(box[:2], box[2:], (int(n), 2)) for n in sizes]
    cat, cuts = np.concatenate(pool), np.cumsum(sizes)[:-1]

    def answers(index):
        return np.split(J.pip_join(cat, None, H3, RES, chip_index=index,
                                   probe="scatter", recheck=False), cuts)

    # one rung's pool: the device memory the top rung's captured graph
    # holds (its private pool and its static tensors)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m0 = torch.cuda.memory_reserved()
    top = DispatchCore(ep.index, H3, RES, probe="adaptive",
                       ladder=BucketLadder(SERVE_LADDER[1], SERVE_LADDER[1]))
    top.warmup()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rung_pool = torch.cuda.memory_reserved() - m0
    top.release_graphs()
    del top
    want = [answers(ep.index)]
    router = ServeRouter(H3, max_resident=1, engine_defaults=dict(ekw, probe="adaptive"))
    router.add_tenant("epochs", ep.index, RES)
    b0 = backend_compiles()
    subs, stop = [], threading.Event()
    # the clients pause while memory is read, so no batch's own tensors
    # are counted: {"paused": bool, "inflight": requests in flight}
    cv, state = threading.Condition(), {"paused": False, "inflight": 0}
    sinks = telemetry.current_sinks()

    def client(c):
        telemetry.adopt_sinks(sinks)
        i = c
        while not stop.is_set():
            with cv:
                while state["paused"]:
                    cv.wait()
                state["inflight"] += 1
            t0 = time.perf_counter()
            try:
                a, err = router.submit("epochs", pool[i % EPOCH_POOL]).result(), None
            except Exception as e:  # lint: broad-except-ok (every failure is listed and gated)
                a, err = None, repr(e)[:200]
            with cv:
                subs.append((i % EPOCH_POOL, t0, time.perf_counter(), a, err))
                state["inflight"] -= 1
                cv.notify_all()
            i += SERVE_CLIENTS

    def quiet_memory():
        """(``memory_allocated``, ``memory_reserved`` less the allocator's
        free cache) with no request in flight."""
        with cv:
            state["paused"] = True
            while state["inflight"]:
                cv.wait()
        torch.cuda.synchronize()
        mem = torch.cuda.memory_allocated()
        torch.cuda.empty_cache()
        res = torch.cuda.memory_reserved()
        with cv:
            state["paused"] = False
            cv.notify_all()
        return mem, res

    threads = [threading.Thread(target=client, args=(c,), daemon=True)  # lint: thread-context-adoption-ok (a load client: the router's batchers adopt each request's context)
               for c in range(SERVE_CLIENTS)]
    K.pip_heavy_tiled.launches = 0
    epochs, pub = [], [(0.0, 0.0)]
    torn_raised = False

    def held_index_bytes():
        """Bytes of the distinct indexes still referenced: the epochal
        index's and the router's record (which keeps the last epoch it
        advanced to when a publish dies)."""
        held = {id(x): x for x in (ep.index, router._tenants["epochs"].index)}
        return sum(index_bytes(x) for x in held.values())

    with telemetry.capture() as events, GcPauses() as gcp:
        t_loop = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(0.2)
        for e, (col, ids, gone) in enumerate(edits, start=1):
            st_a = ep.apply(upsert=col, ids=ids, remove=gone)
            replaced = weakref.ref(router._tenants["epochs"].engine.core)
            t0 = time.perf_counter()
            if e == EPOCH_REPROFILED:
                st_p = router.advance_epoch("epochs", ep, reprofile=True)
            elif e < EPOCHS:
                st_p = router.advance_epoch("epochs", ep)
            else:  # a kill between the index swap and the epoch bump
                st_p = None
                with faults.transient_errors(
                    1, sites=("epoch.publish",), skip_first=1,
                    exc_factory=lambda site: RuntimeError("simulated kill"),
                ):
                    try:
                        router.advance_epoch("epochs", ep)
                    except RuntimeError:
                        torn_raised = True
            t1 = time.perf_counter()
            pub.append((t0, t1))
            want.append(answers(ep.index))
            mem, res = quiet_memory()
            old = replaced()
            m = router.metrics()["tenants"]["epochs"]
            epochs.append({
                "epoch": e, "reprofiled": bool(st_p and st_p.get("reprofiled")),
                "engine_resolution": router._tenants["epochs"].engine.resolution,
                "apply_s": st_a["seconds"], "chip_rows": st_a["chip_rows"],
                "publish_wall_s": t1 - t0,
                "publish_s": st_p["seconds"] if st_p else "killed at the torn boundary",
                "chips": st_p["chips"] if st_p else None,
                "memory_allocated": mem, "memory_reserved_in_use": res,
                "replaced_core_graphs": None if old is None else len(old._graphs),
                "held_index_bytes": held_index_bytes(),
                "nvcc_builds": backend_compiles() - b0,
                "cold_compiles": m["cold_compiles"],
            })
        time.sleep(0.2)
        stop.set()
        for th in threads:
            th.join()
        loop_s = time.perf_counter() - t_loop
    launches = K.pip_heavy_tiled.launches
    m = router.metrics()["tenants"]["epochs"]
    router.close()
    # the reprofiled publish: the analyzer's resolution for the column
    # against the one the swap served
    picked = [ev["optimal_resolution"] for ev in events
              if ev.get("event") == "tune_profile" and ev.get("kind") == "polygons"]
    swaps = [ev for ev in events if ev.get("event") == "tune_resolve"
             and ev.get("entry") == "serve_engine.hot_swap" and ev.get("profiled")]
    # every answer is one of the epochs live while it was in flight; one
    # submitted after a publish returned is that epoch's or a later one's
    torn, stale, n_after, errors = 0, 0, 0, []
    for i, t0, t1, a, err in subs:
        if a is None:
            errors.append(err)
            continue
        live = [e for e in range(EPOCHS + 1)
                if (e == 0 or pub[e][0] <= t1) and (e == EPOCHS or pub[e + 1][1] >= t0)]
        ok = [e for e in live if np.array_equal(a, want[e][i])]
        torn += not ok
        done = [e for e in range(1, EPOCHS + 1) if pub[e][1] <= t0]
        if done:
            n_after += 1
            stale += not any(e >= done[-1] for e in ok)
    lat = [t1 - t0 for _, t0, t1, _, _ in subs]
    outlier = latency_outlier(lat, [t0 for _, t0, _, _, _ in subs], t_loop,
                              [len(pool[i]) for i, *_ in subs], events, gcp)
    # the last epoch against a rebuild, and the log replayed on the card
    final, col = final_column(prep.base, edits), ep.column()
    col_equal = all(
        np.asarray(getattr(col, f)).tobytes() == np.asarray(getattr(final, f)).tobytes()
        for f in ("xy", "ring_offsets", "part_offsets", "geom_offsets", "geom_type"))
    t0 = time.perf_counter()
    r = EpochalIndex.replay(prep.log_dir, H3, device=dev)
    replay_s = time.perf_counter() - t0
    growth = [b["memory_allocated"] - a["memory_allocated"]
              - (b["held_index_bytes"] - a["held_index_bytes"])
              for a, b in zip(epochs, epochs[1:])]
    gates = {
        "untorn": torn == 0 and not errors and len(subs) > 0,
        "new_epoch_after_publish": stale == 0 and n_after > 0,
        "epochs_observable": all(any(not np.array_equal(x, y) for x, y in zip(a, b))
                                 for a, b in zip(want, want[1:])),
        "no_compiles_after_publishes": all(x["nvcc_builds"] == 0 and x["cold_compiles"] == 0
                                           for x in epochs) and m["cold_compiles"] == 0,
        "no_shed_or_degraded": m["shed"] == 0 and m["degraded"] == 0,
        "equals_a_rebuild": col_equal and chip_index_equal(ep.index, prep.rebuilt),
        "replay_equals_live": r.applied_epoch == r.epoch == EPOCHS
        and chip_index_equal(r.index, ep.index)
        and r.epoch_token() == ep.index.epoch_token,
        "torn_publish_replays_clean": torn_raised and ep.epoch == EPOCHS - 1
        and ep.applied_epoch == EPOCHS and m["epoch"] == EPOCHS - 1
        and m["epoch_advances"] == EPOCHS - 1,
        "memory_flat": all(g <= rung_pool for g in growth),
        "replaced_cores_hold_no_graphs": all(not x["replaced_core_graphs"] for x in epochs),
        "launched_pip_heavy_tiled": launches > 0,
        "reprofiled_at_index_resolution": len(picked) == len(swaps) == 1
        and swaps[0]["resolution"] == RES and swaps[0]["resolution_source"] == "explicit"
        and all(x["engine_resolution"] == RES for x in epochs)
        and [x["epoch"] for x in epochs if x["reprofiled"]] == [EPOCH_REPROFILED],
    }
    emit({
        "phase": "epochs", "epochs": EPOCHS, "zones": len(prep.base),
        "reprofiled_epoch": EPOCH_REPROFILED, "analyzer_resolution": picked,
        "reprofiled_swap": [{k: v for k, v in ev.items() if k.startswith(("resolution", "probe"))}
                            for ev in swaps],
        "upserts": EPOCH_UPSERTS, "inserts": EPOCH_INSERTS, "removes": EPOCH_REMOVES,
        "requests": len(subs), "requests_after_a_publish": n_after, "pool": EPOCH_POOL,
        "clients": SERVE_CLIENTS, "loop_s": loop_s, "per_epoch": epochs,
        "rung_pool_bytes": rung_pool, "memory_growth_less_index_bytes": growth,
        "replay_s": replay_s, "pip_heavy_tiled_launches": launches,
        "latency_max_request": outlier, "gc_during_loop": gcp.summary(),
        "torn": torn, "stale": stale, "errors": errors[:3],
        "epoch_s": time.perf_counter() - t_phase, "gates": gates,
    })
    bad = [g for g, v in gates.items() if not v]
    return (f"epochs gates failed: {bad}" if bad else None), launches


def serve_prep(ix_path, dev, runs_dir):
    """What the serving process builds before its phases, while the main
    process runs its own (host work, beside them on other cores): phase
    3's index from disk; 8k's epochal index over the swap box, published
    at epoch 0 (8e swaps it in), its deltas and the card's rebuild of
    their final column; 8j's KNN index. Returns them with their seconds."""
    import numpy as np
    import torch

    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.datasets import NYC_BBOX, synthetic_zones
    from mosaic_tpu_torch.index import EpochalIndex
    from mosaic_tpu_torch.knn import build_knn_index
    from mosaic_tpu_torch.sql import join as J

    H3 = H3IndexSystem()
    with np.load(ix_path) as z:
        ix = J.ChipIndex.from_arrays(dict(z), device=dev)
    box = swap_box()
    zones2 = synthetic_zones(*ZONES, bbox=box, verts=256, seed=SWAP_SEED)
    log_dir = os.path.join(runs_dir, "epoch_log")
    t0 = time.perf_counter()
    ep = EpochalIndex(zones2, H3, RES, keep_core_geoms=False, device=dev,
                      log_dir=log_dir)
    publish0 = ep.publish()
    torch.cuda.synchronize()
    ep_s = time.perf_counter() - t0
    edits = epoch_edits(zones2, box)
    t0 = time.perf_counter()
    rebuilt = J.build_chip_index(
        tessellate(final_column(zones2, edits), H3, RES, keep_core_geoms=False), device=dev)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    cand = knn_candidates(H3, NYC_BBOX, KNN_CANDIDATES, KNN_SEED)
    t0 = time.perf_counter()
    kx = build_knn_index(cand, H3, KNN_RES, device=dev)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    return types.SimpleNamespace(
        H3=H3, ix=ix, ep=ep, base=zones2, edits=edits, rebuilt=rebuilt, kx=kx,
        log_dir=log_dir,
        seconds={"epoch0_index_s": ep_s, "epoch0_publish_s": publish0["seconds"],
                 "rebuild_s": rebuild_s, "knn_index_s": knn_s})


def serve_child(index_path: str, result_path: str) -> int:
    """The serving process (``chip_smoke.py --serve-child INDEX RESULT``):
    builds what its phases need (:func:`serve_prep`), waits for ``go`` on
    its standard input (the main process's phases are done), then runs
    8d-8f, 8j and 8k over phase 3's index from ``INDEX`` (npz) and writes
    the outcome to ``RESULT`` (JSON: error and the phase it came in,
    launches, the nvcc builds this process started). The profiled windows
    of 8d and 8j run after all of them."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mosaic_tpu_torch.dispatch import BucketLadder, backend_compiles
    from mosaic_tpu_torch.datasets import NYC_BBOX

    dev = torch.device(DEVICE)
    # 8m: the flight recorder dumps into this process's run directory
    os.environ["MOSAIC_RECORDER_DIR"] = os.path.dirname(result_path)
    t0 = time.perf_counter()
    prep = serve_prep(index_path, dev, os.path.dirname(result_path))
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if sys.stdin.readline().strip() != "go":
        return 2  # the main process failed before the serving phases
    emit({"phase": "serve_prep", "prep_s": prep_s,
          "waited_for_main_s": time.perf_counter() - t0, **prep.seconds})
    H3, ix = prep.H3, prep.ix
    err, launches, serve_profile = serve_phases(
        ix, H3, dev, prep.ep.index, prep.seconds["epoch0_index_s"],
        os.path.join(os.path.dirname(result_path), PROFILE_STORE))
    if not err:
        err, knn_launches, knn_profile = knn_phase(
            ix, H3, dev, prep.kx, prep.seconds["knn_index_s"])
        if not err:
            launches["knn_serve"] = knn_launches
            ekw = dict(
                ladder=BucketLadder(*SERVE_LADDER), max_batch_rows=SERVE_MAX_BATCH,
                max_wait_s=SERVE_WINDOW_S, queue_capacity=SERVE_QUEUE,
                default_deadline_s=SERVE_DEADLINE_S, bounds=NYC_BBOX,
            )
            err, launches["epochs"] = epoch_phase(prep, H3, dev, ekw)
            if not err:
                serve_profile()
                knn_profile()
    with open(result_path, "w") as fh:
        json.dump({"error": err, "in": LAST_PHASE, "launches": launches,
                   "nvcc_builds": backend_compiles(), "obs": OBS_SERVE}, fh)
    return 1 if err else 0


class ServeProcess:
    """The serving process, started as soon as phase 3's index exists so
    that its set-up overlaps the main process's phases; its lines pass
    through to stdout as they come."""

    def __init__(self, ix, serve_dir: str):
        import numpy as np

        shutil.rmtree(serve_dir, ignore_errors=True)
        os.makedirs(serve_dir)
        self.dir = serve_dir
        index_path = os.path.join(serve_dir, "serve_index.npz")
        self.result_path = os.path.join(serve_dir, "serve_result.json")
        np.savez(index_path, **ix.to_arrays())
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--serve-child", index_path,
             self.result_path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, bufsize=1)
        self.last = "none"
        self.pump = threading.Thread(target=self._pump, daemon=True)  # lint: thread-context-adoption-ok (pumps the serving process's stdout: it runs no mosaic code)
        self.pump.start()

    def _pump(self):
        for line in self.proc.stdout:
            print(line, end="", flush=True)
            try:
                self.last = json.loads(line).get("phase", self.last)
            except (ValueError, AttributeError):
                pass

    def finish(self, timeout_s: float) -> tuple:
        """Send ``go`` and wait: (exit code or None if killed at
        ``timeout_s``, the phase of its last line, its result or None)."""
        try:
            self.proc.stdin.write("go\n")
            self.proc.stdin.close()
        except OSError:
            pass  # it has already exited: its code says why
        try:
            rc = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            rc = None
        self.stop()
        try:
            with open(self.result_path) as fh:
                result = json.load(fh)
        except (OSError, ValueError) as exc:
            result = {"error": f"no result from the serving process: {exc!r}",
                      "in": self.last}
        shutil.rmtree(self.dir, ignore_errors=True)
        return rc, self.last, result

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.pump.join(timeout=10)


#: the serving process, stopped however main() ends
SERVING = []
#: 8d's events per served request and requests/s, for 8m's line
OBS_SERVE = {}


def serve_process(serving, ix, H3):
    """Let the serving process run 8d-8f, 8j and 8k; print the
    ``serve_process`` line. Returns the child's result (its ``launches``),
    or the exit code of a failure."""
    from mosaic_tpu_torch.datasets import NYC_BBOX, random_points
    from mosaic_tpu_torch.dispatch import BucketLadder, DispatchCore

    core1024 = DispatchCore(ix, H3, RES, probe="adaptive", ladder=BucketLadder(64, 1024))
    core1024.warmup()
    parent_ms = dispatch_ms(core1024, random_points(1024, NYC_BBOX, seed=SERVE_SEED))
    core1024.release_graphs()
    t0 = time.perf_counter()
    child_rc, child_last, served = serving.finish(CHILD_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    if child_rc is None:
        return fail(f"the serving process passed its {CHILD_TIMEOUT_S:.0f} s limit "
                    f"and was killed", where=child_last)
    emit({"phase": "serve_process", "child_rc": child_rc, "child_s_after_go": child_s,
          "parent_dispatch_ms_1024_rows": parent_ms,
          "child_nvcc_builds": served.get("nvcc_builds")})
    if child_rc or served.get("error"):
        return fail(served.get("error") or f"the serving process exited {child_rc}",
                    where=served.get("in", child_last))
    if served.get("nvcc_builds") != 0:
        return fail(f"the serving process built kernels: {served.get('nvcc_builds')} nvcc jobs")
    return served


# ------------------------------------------------------------------- 8s


def serve_requests(seed: int, count: int) -> list:
    """``count`` requests of 8d's mix: 1-1,024 rows each, uniform over
    the bbox."""
    import numpy as np

    from mosaic_tpu_torch.datasets import NYC_BBOX as bbox

    rng = np.random.default_rng(seed)
    sizes = rng.integers(SERVE_ROWS[0], SERVE_ROWS[1] + 1, count)
    return [rng.uniform(bbox[:2], bbox[2:], (int(n), 2)) for n in sizes]


def store_engine(ix, H3, store):
    """8d's engine over ``ix`` (adaptive probe, 8d's ladder, window,
    queue and deadline) with the program store ``store`` bound."""
    from mosaic_tpu_torch.datasets import NYC_BBOX
    from mosaic_tpu_torch.dispatch import BucketLadder
    from mosaic_tpu_torch.serve import ServeEngine

    return ServeEngine(
        ix, H3, RES, probe="adaptive", program_store=store,
        ladder=BucketLadder(*SERVE_LADDER), max_batch_rows=SERVE_MAX_BATCH,
        max_wait_s=SERVE_WINDOW_S, queue_capacity=SERVE_QUEUE,
        default_deadline_s=SERVE_DEADLINE_S, bounds=NYC_BBOX,
    )


def no_nvcc_env(run_dir: str) -> dict:
    """The environment of a process that cannot build a kernel: no
    directory that holds nvcc on ``PATH``, ``CUDA_HOME`` an empty
    directory, no ``PYTHONPATH``."""
    empty = os.path.join(run_dir, "no_cuda")
    os.makedirs(empty, exist_ok=True)
    path = os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc"))
    )
    env = dict(os.environ, PATH=path, CUDA_HOME=empty)
    env.pop("PYTHONPATH", None)
    return env


def relaunch_child(index_path: str, store: str, result_path: str, spawned_at: str) -> int:
    """The relaunch process of 8s (``chip_smoke.py --relaunch-child INDEX
    STORE RESULT SPAWNED_AT``), run from a copy of the package without its
    build directory and with no nvcc: loads phase 3's index, warms 8d's
    engine from the program store, serves ``RELAUNCH_REQUESTS`` requests
    and holds each against ``pip_join``, and the kernel against its plain
    version on one top-rung dispatch. Writes its gates, counts and
    seconds (from ``SPAWNED_AT``, the parent's clock at the start) to
    ``RESULT`` (JSON)."""
    t_spawn = float(spawned_at)
    entered_s = time.time() - t_spawn
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    out = {"error": None, "in": "import"}
    try:
        import mosaic_tpu_torch
        from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
        from mosaic_tpu_torch.kernels import _build
        from mosaic_tpu_torch.kernels import pip as K
        from mosaic_tpu_torch.runtime.errors import DegradedResult, KernelCompileError
        from mosaic_tpu_torch.sql import join as J

        gates = {
            "package_is_the_copy": os.path.dirname(os.path.abspath(mosaic_tpu_torch.__file__))
            == os.path.join(HERE, "mosaic_tpu_torch"),
            "no_build_dir_at_start": not _build.BUILD_DIR.exists(),
        }
        try:
            _build.nvcc_path()
            gates["nvcc_not_found"] = False
        except KernelCompileError:
            gates["nvcc_not_found"] = True
        imported_s = time.time() - t_spawn
        out["in"] = "index"
        dev = torch.device(DEVICE)
        H3 = H3IndexSystem()
        with np.load(index_path) as z:
            ix = J.ChipIndex.from_arrays(dict(z), device=dev)
        torch.cuda.synchronize()
        index_s = time.time() - t_spawn
        out["in"] = "store"
        eng = store_engine(ix, H3, store)
        eng.core.load_kernels()
        bound_s = time.time() - t_spawn
        out["in"] = "warmup"
        t0 = time.perf_counter()
        warm = eng.warmup()
        warmup_s = time.perf_counter() - t0
        out["in"] = "serve"
        reqs = serve_requests(RELAUNCH_SEED, RELAUNCH_REQUESTS)
        K.pip_heavy_tiled.launches = 0
        answers, errors, first_s = [], [], None
        t0 = time.perf_counter()
        for r in reqs:
            try:
                answers.append(eng.submit(r).result(timeout=30))
            except Exception as e:  # lint: broad-except-ok (every failure is listed and gated)
                answers.append(None)
                errors.append(repr(e)[:200])
            if first_s is None:
                first_s = time.time() - t_spawn
        serve_s = time.perf_counter() - t0
        launches = K.pip_heavy_tiled.launches
        m = eng.metrics()
        out["in"] = "check"
        want = J.pip_join(np.concatenate(reqs), None, H3, RES, chip_index=ix,
                          probe="scatter", recheck=False)
        want = np.split(want, np.cumsum([len(r) for r in reqs])[:-1])
        equal = not errors and all(
            a is not None and not isinstance(a, DegradedResult) and np.array_equal(a, w)
            for a, w in zip(answers, want))
        # the kernel on the top rung: one dispatch run eagerly, its inputs
        # captured at the wrapper, held against the plain version
        padded, _ = eng.ladder.pad(np.concatenate(reqs)[:eng.ladder.max_bucket])
        captured, real = [], K.pip_heavy_tiled

        def capture(*a, **kw):
            captured.append((a, kw))
            return real(*a, **kw)

        capture.launches = 0
        K.pip_heavy_tiled = capture
        try:
            eng.core.probe_staged(*eng.core.stage(padded))
        finally:
            K.pip_heavy_tiled = real
        a, kw = captured[0]
        kb, kn = real(*a, **kw)
        pb, pn = K.pip_heavy_plain(*a, **kw)
        torch.cuda.synchronize()
        kernel_equal = torch.equal(kb, pb) and (kn is None) == (pn is None) and (
            kn is None or torch.equal(kn, pn))
        max_err = int((kb.long() - pb.long()).abs().max()) if kb.numel() else 0
        eng.close()
        rungs = len(eng.ladder.buckets)
        gates.update({
            "loaded_every_entry_exported_none": warm.get("aot") == {
                "loaded": 2 * rungs + 1, "exported": 0, "fallback": 0},
            "library_bound_from_store": _build.ORIGINS.get("pip") == "store",
            "no_nvcc_build": _build.nvcc_builds() == 0 and warm["backend_compiles"] == 0,
            "equal_to_pip_join": equal,
            "no_cold_compile_shed_or_degraded": m["cold_compiles"] == 0 and m["shed"] == 0
            and m["degraded"] == 0,
            "launched_pip_heavy_tiled": launches > 0,
            "kernel_equals_plain": kernel_equal,
        })
        out.update({
            "in": "done", "gates": gates, "aot": warm.get("aot"), "launches": launches,
            "max_abs_err": max_err, "kernel_rows": int(a[0].shape[0]),
            "requests": len(reqs), "points": int(sum(len(r) for r in reqs)),
            "errors": errors[:3], "batches": m["batches"],
            "nvcc_builds": _build.nvcc_builds(), "origin": _build.ORIGINS.get("pip"),
            "seconds": {
                "start_to_main": entered_s, "start_to_imported": imported_s,
                "start_to_index": index_s, "start_to_store_bound": bound_s,
                "warmup": warmup_s, "graph_capture": eng.core.capture_seconds,
                "start_to_first_answer": first_s, "serve_loop": serve_s,
            },
        })
    except Exception as e:  # lint: broad-except-ok (every failure goes to the result, which the parent gates)
        out["error"] = repr(e)[:500]
    with open(result_path, "w") as fh:
        json.dump(out, fh)
    return 1 if out["error"] or not all(out.get("gates", {}).values()) else 0


class RelaunchProcess:
    """8s: export 8d's ladder to a program store in this process, then
    start the relaunch process from a copy of the package without its
    build directory and without nvcc; it runs beside this process's
    phases until :meth:`finish`."""

    def __init__(self, ix, H3, run_dir: str):
        from mosaic_tpu_torch.dispatch import BucketLadder, ProgramStore, backend_compiles

        shutil.rmtree(run_dir, ignore_errors=True)
        os.makedirs(run_dir)
        self.dir = run_dir
        self.store = os.path.join(run_dir, "programs")
        self.proc = None
        b0 = backend_compiles()
        t0 = time.perf_counter()
        with store_engine(ix, H3, self.store) as eng:
            warm = eng.warmup()
            capture_s = eng.core.capture_seconds
        export_s = time.perf_counter() - t0
        rungs = len(BucketLadder(*SERVE_LADDER).buckets)
        self.exported = 2 * rungs + 1
        keys = ProgramStore(self.store).keys()
        gates = {
            "exported_two_a_rung_and_the_library": warm.get("aot") == {
                "loaded": 0, "exported": self.exported, "fallback": 0},
            "entries_on_disk": len(keys) == self.exported,
            "no_nvcc_build": backend_compiles() == b0,
        }
        emit({"phase": "store_export", "rungs": rungs, "aot": warm.get("aot"),
              "entries": len(keys), "warmup_s": export_s, "graph_capture_s": capture_s,
              "store_bytes": sum(os.path.getsize(os.path.join(self.store, n))
                                 for n in os.listdir(self.store)),
              "gates": gates})
        self.failed = [g for g, v in gates.items() if not v]

    def start(self, index_path: str) -> None:
        """Start the relaunch process from a copy of the package made
        without its build directory, in an environment without nvcc."""
        app = os.path.join(self.dir, "app")
        shutil.copytree(os.path.join(HERE, "mosaic_tpu_torch"),
                        os.path.join(app, "mosaic_tpu_torch"),
                        ignore=shutil.ignore_patterns(".build", "__pycache__"))
        shutil.copy2(os.path.abspath(__file__), app)
        self.result_path = os.path.join(self.dir, "relaunch_result.json")
        self.out_path = os.path.join(self.dir, "relaunch.out")
        self.t_start = time.time()
        with open(self.out_path, "w") as fh:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.join(app, "chip_smoke.py"), "--relaunch-child",
                 index_path, self.store, self.result_path, repr(self.t_start)],
                env=no_nvcc_env(self.dir), cwd=app, stdout=fh, stderr=subprocess.STDOUT)

    def finish(self, build_s: float, card: str) -> tuple:
        """Wait for the relaunch process and print the ``relaunch`` line:
        (failure message or None, its ``pip_heavy_tiled`` launches)."""
        left = RELAUNCH_TIMEOUT_S - (time.time() - self.t_start)
        try:
            rc = self.proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            rc = None
        self.stop()
        try:
            with open(self.result_path) as fh:
                res = json.load(fh)
        except (OSError, ValueError) as exc:
            res = {"error": f"no result from the relaunch process: {exc!r}", "in": "start"}
        with open(self.out_path) as fh:
            tail = fh.read()[-1500:]
        gates = dict(res.get("gates") or {})
        gates["loaded_what_the_parent_exported"] = (res.get("aot") or {}).get(
            "loaded") == self.exported
        emit({"phase": "relaunch", "card": card, "rc": rc, "in": res.get("in"),
              "error": res.get("error"), "seconds": res.get("seconds"),
              "nvcc_build_s_phase_2": build_s, "aot": res.get("aot"),
              "exported_by_parent": self.exported, "nvcc_builds": res.get("nvcc_builds"),
              "library_origin": res.get("origin"), "requests": res.get("requests"),
              "points": res.get("points"), "batches": res.get("batches"),
              "pip_heavy_tiled_launches": res.get("launches"),
              "kernel_rows": res.get("kernel_rows"), "max_abs_err": res.get("max_abs_err"),
              "errors": res.get("errors"), "gates": gates,
              "output_tail": tail if rc or res.get("error") else None})
        if rc is None:
            return f"the relaunch process passed its {RELAUNCH_TIMEOUT_S} s limit", 0
        if rc or res.get("error"):
            return f"the relaunch process failed in {res.get('in')}: {res.get('error')}", 0
        bad = [g for g, v in gates.items() if not v]
        return (f"relaunch gates failed: {bad}" if bad else None), res.get("launches", 0)

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
        if self.proc is not None:
            self.proc.wait()


#: the relaunch process of 8s, stopped however main() ends
RELAUNCHING = []


def store_refusals(ix, H3, dev, store: str, run_dir: str) -> str | None:
    """8s in this process: three refusals on copies of the exported
    store, each core's answers held against ``pip_join``. Prints the
    ``store_refusals`` line; returns a failure message or None."""
    import numpy as np

    from mosaic_tpu_torch.datasets import NYC_BBOX, random_points
    from mosaic_tpu_torch.dispatch import (
        BucketLadder, DispatchCore, ProgramStore, data_mesh, programs,
    )
    from mosaic_tpu_torch.runtime import telemetry
    from mosaic_tpu_torch.sql import join as J

    t_all = time.perf_counter()
    lad = BucketLadder(*REFUSAL_LADDER)
    rungs = len(lad.buckets)
    pts = random_points(1024, NYC_BBOX, seed=RELAUNCH_SEED)
    want = J.pip_join(pts, None, H3, RES, chip_index=ix, probe="scatter", recheck=False)
    lib = programs.library_key("pip")

    def run(root, **kw):
        """(warmup report or None, the store's refusal and fallback events,
        answers equal, core)"""
        with telemetry.capture() as events:
            core = DispatchCore(ix, H3, RES, probe="adaptive", ladder=lad,
                                program_store=root, **kw)
            w = core.warmup() if "mesh" not in kw else None
            got = core.execute(pts)
        core.release_graphs()
        names = [e["event"] for e in events
                 if str(e.get("event", "")).startswith("program_store")
                 and e["event"] not in ("program_store_loaded", "program_store_saved")]
        return w, names, np.array_equal(got, want), core

    corrupt = os.path.join(run_dir, "corrupt")
    shutil.copytree(store, corrupt)
    payload = os.path.join(corrupt, f"prog-{lib}.bin")
    with open(payload, "rb") as fh:
        blob = bytearray(fh.read())
    blob[len(blob) // 2] ^= 0xFF
    with open(payload, "wb") as fh:
        fh.write(bytes(blob))
    w1, ev1, eq1, _ = run(corrupt)
    w1b, ev1b, eq1b, _ = run(corrupt)

    mismatch = os.path.join(run_dir, "mismatch")
    shutil.copytree(store, mismatch)
    sidecar = os.path.join(mismatch, f"prog-{lib}.json")
    with open(sidecar) as fh:
        doc = json.load(fh)
    doc["env"]["device_kind"] = "another card"
    with open(sidecar, "w") as fh:
        json.dump(doc, fh)
    w2, ev2, eq2, _ = run(mismatch)

    keys_before = ProgramStore(corrupt).keys()
    _, ev3, eq3, meshed = run(corrupt, mesh=data_mesh(devices=mesh_devices(dev)))
    gates = {
        "corrupt_skipped_and_exported_again": "program_store_corrupt_skipped" in ev1
        and w1["aot"] == {"loaded": 2 * rungs, "exported": 1, "fallback": 0},
        "healed_store_loads_clean": w1b["aot"] == {
            "loaded": 2 * rungs + 1, "exported": 0, "fallback": 0}
        and "program_store_corrupt_skipped" not in ev1b,
        "mismatch_refused_and_exported_again": "program_store_mismatch" in ev2
        and w2["aot"] == {"loaded": 2 * rungs, "exported": 1, "fallback": 0},
        "mesh_refused": ev3 == ["program_store_refused"] and meshed._programs is None
        and ProgramStore(corrupt).keys() == keys_before,
        "answers_equal_pip_join": eq1 and eq1b and eq2 and eq3,
        "no_nvcc_build": w1["backend_compiles"] == 0 and w2["backend_compiles"] == 0,
    }
    emit({"phase": "store_refusals", "ladder": list(REFUSAL_LADDER),
          "corrupt": {"aot": w1["aot"], "events": ev1}, "healed": {"aot": w1b["aot"]},
          "mismatch": {"aot": w2["aot"], "events": ev2}, "mesh": {"events": ev3},
          "seconds": time.perf_counter() - t_all, "gates": gates})
    bad = [g for g, v in gates.items() if not v]
    return f"store refusal gates failed: {bad}" if bad else None


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "mosaic_tpu_torch")):
        print("chip_smoke: mosaic_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import dataclasses

    import numpy as np

    from mosaic_tpu_torch.core.geometry.device import pack_to_device
    from mosaic_tpu_torch.core.index.h3 import H3IndexSystem
    from mosaic_tpu_torch.core.tessellate import tessellate
    from mosaic_tpu_torch.datasets import (
        NYC_BBOX, random_points, synthetic_raster, synthetic_zones,
    )
    from mosaic_tpu_torch.kernels import _build
    from mosaic_tpu_torch.kernels import pip as K
    from mosaic_tpu_torch.kernels import zonal as Z
    from mosaic_tpu_torch.raster import Raster, ZonalEngine, plan_tiles, stack_tiles
    from mosaic_tpu_torch.raster import zonal as RZ
    from mosaic_tpu_torch.dispatch import guarded_call
    from mosaic_tpu_torch.obs import trace
    from mosaic_tpu_torch.runtime import (
        DegradedResult, RetryExhausted, StalledDeviceError, faults, telemetry,
    )
    from mosaic_tpu_torch.sql import join as J
    from mosaic_tpu_torch.tools import calibrate_margins as CM

    dev = torch.device(DEVICE)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi gave no output"
    print(card, flush=True)
    emit({
        "phase": "device", "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "nvidia_smi": card,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })

    # 2. build
    t0 = time.perf_counter()
    _build.load_all()
    build_s = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "Compiling entry" in ln]
        for name, log in _build.BUILD_LOGS.items()
    }
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas,
          "sass_fma_by_kernel": sass_fma_counts(_build)})

    # 3. index
    H3 = H3IndexSystem()
    zones = synthetic_zones(*ZONES, verts=256)
    t0 = time.perf_counter()
    table = tessellate(zones, H3, RES, keep_core_geoms=False)
    t1 = time.perf_counter()
    ix = J.build_chip_index(table, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    table_bytes = sum(
        getattr(ix, n).numel() * getattr(ix, n).element_size()
        for n in J.ChipIndex.field_names()
    )
    emit({
        "phase": "index", "zones": len(zones), "res": RES,
        "cells": ix.num_cells, "heavy": ix.num_heavy_cells,
        "convex": ix.num_convex_cells,
        "cell_edges": list(ix.cell_edges.shape),
        "heavy_edges": list(ix.heavy_edges.shape),
        "heavy_slot_geom": list(ix.heavy_slot_geom.shape),
        "table_mb": table_bytes / 1e6,
        "tessellate_s": t1 - t0, "build_s": t2 - t1,
    })
    if ix.num_heavy_cells == 0:
        return fail("the index has no heavy cells: the heavy lane is not exercised")
    # the serving process builds its indexes now, beside the phases below
    SERVING.append(ServeProcess(ix, os.path.join(HERE, SERVE_DIR)))

    raw = random_points(N_POINTS, NYC_BBOX, seed=SEED)
    shift = ix.host.shift
    pts_f32 = torch.from_numpy(raw).to(dev).to(torch.float32)
    shifted = torch.from_numpy((raw - shift).astype(np.float32)).to(dev)

    def cuda_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    def host_us(fn, reps=20_000):
        """Host microseconds a call of ``fn``, the best of three rounds."""
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, time.perf_counter() - t0)
        return best / reps * 1e6

    def device_ms(fn, kernel, reps=20):
        """Device time per launch of ``kernel`` over ``reps`` calls of
        ``fn``, from the profiler: the kernel's own time, without the host
        dispatch that CUDA events around a short call also catch."""
        fn()
        torch.cuda.synchronize()

        def many():
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()

        k = kernel_times(profile_device(many)[1]).get(kernel)
        return k["ms_per_launch"] if k else "not measured"

    def bound(n_bytes, n_ops, peak_ops=PEAK_F32, chain_s=0.0):
        """(ms, "bytes" or "operations"): the larger of the bytes over the
        memory rate and the operations over the peak rate, or a dependent
        chain of operations (``chain_s``) where that is longer."""
        t_b, t_o = n_bytes / PEAK_BYTES, max(n_ops / peak_ops, chain_s)
        return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")

    # the raster of phase 8 and the crop held against the oracles there; the
    # profiler traces each raster path on the crop (16 tiles), as tracing
    # the whole raster's ~10**6 device ops takes minutes
    raster = synthetic_raster(*RASTER, NYC_BBOX, nodata=NODATA, seed=SEED)
    probe_eng = ZonalEngine(H3, RES, chip_index=ix, lane="tiled")
    crop = middle(raster, CROP)
    pcrop = middle(raster, PROFILE_CROP)

    def wrapper_device_ms(fn, reps=20):
        """(device ms per call, {device op: ms per call}) of ``fn`` alone
        under the profiler: every device op it launches, memsets included."""
        fn()
        torch.cuda.synchronize()

        def many():
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()

        rows_ = profile_device(many)[1]
        if not rows_:
            return "not measured", {}
        by_op = {}
        for ms, key, _ in rows_:
            name = next((f for frags in KERNEL_OPS.values() for f in frags if f in key),
                        key[:40])
            by_op[name] = by_op.get(name, 0.0) + ms / reps
        return sum(by_op.values()), by_op

    def heavy_work(px, py, rows_, edges, ebits, sgeom, e2):
        """(bytes, f32 operations, counts) that one pip_heavy_tiled call
        needs on these inputs, counted from the plain version's
        intermediates: each point's row, coordinates and outputs; of the
        table rows its points touch, every slot bit (a pad edge is known
        by its bits alone), the real edges and the slot geoms; the
        straddle test of every real edge of a point's row, the crossing
        of each straddling one, and with the band its distance for the
        real edges up to the first one within the band, dividing where
        the clamp is not decided."""
        live = rows_ >= 0
        r = rows_[live].long()
        qx, qy = px[live][:, None], py[live][:, None]
        ed = edges[r]
        real = ebits[r] != 0
        ax, ay, bx, by = ed.unbind(-1)
        n_real = int(real.sum())
        n_cross = int((((ay > qy) != (by > qy)) & real).sum())
        ops = OPS_STRADDLE * n_real + OPS_CROSS * n_cross
        counts = {"real_edge_tests": n_real, "straddling": n_cross}
        if e2 is not None:
            ex, ey, dx, dy = bx - ax, by - ay, qx - ax, qy - ay
            dd = ex * ex + ey * ey
            dot = dx * ex + dy * ey
            t = torch.clamp(dot / torch.where(dd == 0, torch.ones_like(dd), dd), 0.0, 1.0)
            rx, ry = dx - t * ex, dy - t * ey
            near = ((rx * rx + ry * ry <= e2) & real).int()
            need = real & ((torch.cumsum(near, dim=1) - near) == 0)
            decided = (dot <= 0) | ((dd > 0) & (dd < float("inf")) & (dot >= dd))
            n_band, n_div = int(need.sum()), int((need & ~decided).sum())
            ops += OPS_BAND * n_band + n_div
            counts.update({"band_edges": n_band, "band_divides": n_div})
        rows_hit = torch.unique(r)
        touched = int(rows_hit.numel())
        row_edges = int((ebits[rows_hit] != 0).sum())
        n_bytes = (rows_.numel() * (4 + 4 + (1 if e2 is not None else 0))
                   + int(live.sum()) * 8 + row_edges * 16
                   + touched * (edges.shape[1] * 4 + sgeom.shape[1] * 4))
        counts.update({"points": rows_.numel(), "live_points": int(live.sum()),
                       "rows_touched": touched, "real_edges_of_touched_rows": row_edges})
        return n_bytes, ops, counts

    def heavy_case(args, e2):
        """pip_heavy_tiled against its plain version on ``args``: equality,
        device time (all of the wrapper's device ops), event-timed wrapper
        and plain times, and the bound of the work these inputs need."""
        kb, kn = K.pip_heavy_tiled(*args, eps2=e2)
        pb, pn = K.pip_heavy_plain(*args, eps2=e2)
        torch.cuda.synchronize()
        ok = torch.equal(kb, pb) and (e2 is None or torch.equal(kn, pn))
        err = int((kb.long() - pb.long()).abs().max()) if kb.numel() else 0
        ms, by_op = wrapper_device_ms(lambda: K.pip_heavy_tiled(*args, eps2=e2))
        n_bytes, ops, counts = heavy_work(*args, e2)
        b_ms, b_by = bound(n_bytes, ops)
        return {
            **counts, "equal": ok, "max_abs_err": err, "ms": ms, "ms_by_op": by_op,
            "wrapper_ms": cuda_ms(lambda: K.pip_heavy_tiled(*args, eps2=e2)),
            "plain_ms": cuda_ms(lambda: K.pip_heavy_plain(*args, eps2=e2), reps=3),
            "bytes": n_bytes, "ops": ops, "bound_ms": b_ms, "bound_by": b_by,
        }

    # 4. pip_heavy_tiled on the compacted heavy points of the 4M batch,
    # compacted exactly as pip_join_points(probe="adaptive") compacts them,
    # without and with the band; then one tile-sized banded launch as the
    # zones probe makes it
    cells = H3.point_to_cell(pts_f32, RES)
    u = J._probe_slot(cells, ix)
    found = u >= 0
    cvrow = torch.where(found, ix.cell_convex[torch.clamp(u, min=0)], -1)
    src1, valid1, _, _ = J._compact(found & (cvrow < 0), N_POINTS)
    us = torch.clamp(u[src1], min=0).long()
    hs = torch.where(valid1, ix.cell_heavy[us], -1)
    nh = int((hs >= 0).sum())
    src2, valid2, _, _ = J._compact(hs >= 0, N_POINTS)
    rows = torch.clamp(hs[src2[:nh]], min=0)  # int32, as the join passes them
    pq = shifted[src1][src2[:nh]]
    hpx, hpy = pq[:, 0].contiguous(), pq[:, 1].contiguous()
    # the band as the exact join passes it: a number rounded to f32 on the host
    eps2 = float(np.float32(
        (J.EDGE_BAND_K * float(np.finfo(np.float32).eps) * ix.host.coord_scale) ** 2))
    heavy_args = (hpx, hpy, rows, ix.heavy_edges, ix.heavy_ebits, ix.heavy_slot_geom)
    # the launches the zones probe makes on the crop's 16 tiles, captured at
    # the wrapper; the tile with the most heavy points is timed
    captured = []
    real_heavy = K.pip_heavy_tiled

    def capture(*a, **kw):
        captured.append((a, kw["eps2"]))
        return real_heavy(*a, **kw)

    capture.launches = 0
    cplan = plan_tiles(crop)
    K.pip_heavy_tiled = capture
    try:
        for t in range(cplan.ntiles):
            probe_eng._zones_probe(np.asarray(cplan.gt, np.float64), cplan.origins[t],
                                   *cplan.shape)
    finally:
        K.pip_heavy_tiled = real_heavy
    tile_args, tile_eps2 = max(captured, key=lambda c: int((c[0][2] >= 0).sum()))
    heavy = {
        "join": heavy_case(heavy_args, None),
        "join_banded": heavy_case(heavy_args, eps2),
        "tile_banded": heavy_case(tile_args, tile_eps2),
    }
    H, E2 = ix.heavy_ebits.shape
    M2 = ix.heavy_slot_geom.shape[1]
    heavy_ok = all(c["equal"] for c in heavy.values())
    heavy_err = max(c["max_abs_err"] for c in heavy.values())
    emit({
        "phase": "pip_heavy_tiled", "rows": H, "E2": E2, "M2": M2,
        "tile_launches_captured": len(captured), "equal": heavy_ok, **heavy,
    })
    if not heavy_ok:
        return fail("pip_heavy_tiled differs from pip_heavy_plain")

    # 5. pip_zone: the bench's brute-force lane, every point x every zone
    zdev = pack_to_device(zones, dtype=torch.float32, recenter=True, device=dev)
    planes, n_real = K.edge_planes(zdev)
    zshift = zdev.shift.cpu().numpy()
    zpts = torch.from_numpy((raw[:N_ZONE] - zshift).astype(np.float32)).to(dev)
    sub = zpts[:N_ZONE_CHECK]
    kz = K.pip_zone(sub, planes, n_real)
    pz = K.pip_zone_plain(sub, planes, n_real)
    torch.cuda.synchronize()
    zone_ok = torch.equal(kz, pz)
    zone_err = int((kz.long() - pz.long()).abs().max())
    E, G = planes.shape[1], planes.shape[2]
    zone_ms = cuda_ms(lambda: K.pip_zone(zpts, planes, n_real), reps=5)
    zone_dev_ms = device_ms(lambda: K.pip_zone(zpts, planes, n_real), "pip_zone", reps=5)
    zone_plain_ms = cuda_ms(lambda: K.pip_zone_plain(zpts, planes, n_real), reps=1)
    zone_bytes = N_ZONE * (8 + 4) + planes.numel() * 4
    zone_bound, zone_by = bound(zone_bytes, OPS_ZONE * N_ZONE * G * E)
    emit({
        "phase": "pip_zone", "points": N_ZONE, "zone_slots": G, "edges": E,
        "equal_on_subset": zone_ok, "subset": N_ZONE_CHECK,
        "ms": zone_dev_ms, "wrapper_ms": zone_ms, "plain_ms": zone_plain_ms,
        "bound_ms": zone_bound, "bound_by": zone_by,
    })
    if not zone_ok:
        return fail("pip_zone differs from pip_zone_plain")

    # every gated join of phases 6 and 6b keeps its events, and none may be
    # a retry, a stall, an escalation or a degradation (the fault pass of 6d
    # injects its own); the warm timings call pip_join bare, as a user does
    gated_events = []

    def gated(*a, **kw):
        with telemetry.capture() as ev:
            r = J.pip_join(*a, **kw)
        gated_events.extend(ev)
        if getattr(r, "degraded", False):
            gated_events.append({"event": "degraded", "reason": r.reason})
        return r

    # 6. the main paths, each with the counts set to 0 just before it
    K.pip_heavy_tiled.launches = 0
    K.pip_zone.launches = 0
    t0 = time.perf_counter()
    out = gated(raw, None, H3, RES, chip_index=ix, probe="adaptive")
    cold_s = time.perf_counter() - t0
    heavy_launches = K.pip_heavy_tiled.launches
    zone_lane_launches_in_join = K.pip_zone.launches
    K.pip_heavy_tiled.launches = 0
    K.pip_zone.launches = 0
    lane = K.pip_zone(zpts, planes, n_real)
    torch.cuda.synchronize()
    zone_launches = K.pip_zone.launches
    base = gated(raw, None, H3, RES, chip_index=ix, probe="scatter")
    same = bool(np.array_equal(out, base))
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        J.pip_join(raw, None, H3, RES, chip_index=ix, probe="adaptive")
        warm.append(time.perf_counter() - t0)
    warm_scatter = []
    for _ in range(3):
        t0 = time.perf_counter()
        J.pip_join(raw, None, H3, RES, chip_index=ix, probe="scatter")
        warm_scatter.append(time.perf_counter() - t0)
    oracle = J.host_join(raw[:N_ORACLE], ix.host, H3, RES)
    agree = float((oracle == out[:N_ORACLE]).mean())
    lane_match = float((lane.cpu().numpy() >= 0).mean())
    valid = (
        out.shape == (N_POINTS,) and out.dtype == np.int32
        and int(out.min()) >= -1 and int(out.max()) < len(zones)
    )
    emit({
        "phase": "main_path", "points": N_POINTS, "probe": "adaptive",
        "pip_heavy_tiled_launches": heavy_launches,
        "pip_zone_launches_in_join": zone_lane_launches_in_join,
        "pip_zone_lane_launches": zone_launches,
        "equal_to_scatter": same, "valid_output": valid,
        "match_rate": float((out >= 0).mean()),
        "zone_lane_match_rate": lane_match,
        "cold_s": cold_s, "warm_s": warm, "warm_scatter_s": warm_scatter,
        "points_per_s": N_POINTS / min(warm),
        "scatter_points_per_s": N_POINTS / min(warm_scatter),
        "host_oracle_agreement": agree, "oracle_points": N_ORACLE,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    main_pps = N_POINTS / min(warm)
    if heavy_launches <= 0:
        return fail("pip_join(probe='adaptive') never launched pip_heavy_tiled")
    if zone_launches <= 0:
        return fail("the zone lane never launched pip_zone")
    if not same:
        return fail("pip_join adaptive differs from scatter")
    if not valid:
        return fail("pip_join output is not valid polygon ids of the right shape")
    if agree < MIN_ORACLE_AGREEMENT:
        return fail(f"pip_join agrees with the f64 host oracle on {agree:.5f} "
                    f"of {N_ORACLE} points (floor {MIN_ORACLE_AGREEMENT})")

    # where the time of one warm adaptive pip_join goes: its stages one at
    # a time (CUDA events), then the whole call under the profiler
    nf, nhc, ncv = J._probe_counts(cells, ix).tolist()
    caps = {
        "found_cap": min(J._next_pow2(nf + 1), N_POINTS),
        "heavy_cap": min(J._next_pow2(nhc + 1), N_POINTS),
        "convex_cap": min(J._next_pow2(ncv + 1), N_POINTS),
    }
    stages = {
        "h2d_points": lambda: torch.from_numpy(raw).to(dev).to(torch.float32),
        "h3_cells_f32": lambda: H3.point_to_cell(pts_f32, RES),
        "probe_counts": lambda: J._probe_counts(cells, ix).tolist(),
        "probe_adaptive": lambda: J.pip_join_points(
            shifted, cells, ix, probe="adaptive", **caps),
        "probe_scatter": lambda: J.pip_join_points(
            shifted, cells, ix, probe="scatter", **caps),
        "d2h_result": lambda: out_dev.cpu().numpy(),
    }
    out_dev = torch.from_numpy(out).to(dev)
    stage_ms = {k: cuda_ms(fn, reps=5) for k, fn in stages.items()}
    busy_ms, rows_, prof_wall_ms = profile_device(
        lambda: gated(raw, None, H3, RES, chip_index=ix, probe="adaptive"))
    # the host cost of the runtime a join passes through (two guarded
    # calls, one span and one event a chunk), each against a bare call
    def noop():
        return None

    def spanned():
        with trace.span("join.pip", n=1):
            return None

    runtime_us = {
        "bare_call": host_us(noop),
        "guarded_call": host_us(lambda: guarded_call("pip_join.device", noop)),
        "span": host_us(spanned),
        "record": host_us(lambda: telemetry.record("probe_route", n=1)),
    }
    # the profiler adds host time to the call it traces: the idle share is
    # taken against the best unprofiled warm call, and the traced call's
    # own wall time is printed beside it
    warm_ms = min(warm) * 1e3
    emit({
        "phase": "breakdown", "points": N_POINTS, "stage_ms": stage_ms,
        "warm_wall_ms": warm_ms, "profiled_wall_ms": prof_wall_ms,
        "runtime_host_us": runtime_us,
        **idle_share(busy_ms, rows_, warm_ms),
        "top_device_ops": [
            {"op": k[:80], "ms": ms, "calls": c} for ms, k, c in rows_[:10]
        ],
    })

    # 6b. the exact join, with the counts set to 0 just before it
    K.pip_heavy_tiled.launches = 0
    K.pip_zone.launches = 0
    t0 = time.perf_counter()
    exact = gated(raw, None, H3, RES, chip_index=ix, probe="adaptive", recheck=True)
    exact_cold_s = time.perf_counter() - t0
    recheck_launches = K.pip_heavy_tiled.launches
    recheck_zone_launches = K.pip_zone.launches
    narrow = [e for e in gated_events if e["event"] == "recheck_narrow"]
    warm_exact = []
    for _ in range(3):
        t0 = time.perf_counter()
        J.pip_join(raw, None, H3, RES, chip_index=ix, probe="adaptive", recheck=True)
        warm_exact.append(time.perf_counter() - t0)
    # the recheck's oracle on the first N_EXACT points, in chunks
    t0 = time.perf_counter()
    want = np.concatenate([
        J.recheck_oracle(raw[i:min(i + 250_000, N_EXACT)], ix.host, H3, RES)
        for i in range(0, N_EXACT, 250_000)
    ])
    exact_oracle_s = time.perf_counter() - t0
    host_exact = want
    exact_agree = float((want == exact[:N_EXACT]).mean())
    # stage times of one more warm exact join, a sync around each stage:
    # margin cells, the banded probe (and its copy back), the narrow
    # re-join (runner-up cells and the band's scatter probe) and the host
    # oracle's tie rows; the rest is counts, staging and host numpy
    stage_s = {"margin_cells": 0.0, "banded_probe": 0.0, "narrow_rejoin": 0.0,
               "host_ties": 0.0}
    host_rows = []
    real = {"margin": H3.point_to_cell_margin, "alt": H3.point_to_cell_alt,
            "probe": J.pip_join_points, "host": J.recheck_oracle}

    def synced(stage, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            stage_s[stage(a, k) if callable(stage) else stage] += time.perf_counter() - t0
            return r
        return run

    def host_ties(chunk, *a, **k):
        host_rows.append(len(chunk))
        return real["host"](chunk, *a, **k)

    H3.point_to_cell_margin = synced("margin_cells", real["margin"])
    H3.point_to_cell_alt = synced("narrow_rejoin", real["alt"])
    J.pip_join_points = synced(
        lambda a, k: "banded_probe" if k.get("edge_eps2") is not None else "narrow_rejoin",
        real["probe"])
    J.recheck_oracle = synced("host_ties", host_ties)
    try:
        t0 = time.perf_counter()
        staged = gated(raw, None, H3, RES, chip_index=ix, probe="adaptive", recheck=True)
        staged_s = time.perf_counter() - t0
    finally:
        del H3.point_to_cell_margin, H3.point_to_cell_alt
        J.pip_join_points, J.recheck_oracle = real["probe"], real["host"]
    busy_x, rows_x, prof_x_ms = profile_device(
        lambda: gated(raw, None, H3, RES, chip_index=ix, probe="adaptive", recheck=True))
    bad_events = [e for e in gated_events if e["event"] in FAULT_EVENTS]
    nar = narrow[0] if narrow else {}
    emit({
        "phase": "exact_join", "points": N_POINTS, "probe": "adaptive", "recheck": True,
        "pip_heavy_tiled_launches": recheck_launches,
        "pip_zone_launches": recheck_zone_launches,
        "degraded": bool(getattr(exact, "degraded", False)),
        "oracle_agreement": exact_agree, "exact_points": N_EXACT,
        "oracle_s": exact_oracle_s, "equal_to_staged_call": bool(np.array_equal(exact, staged)),
        "cold_s": exact_cold_s, "warm_s": warm_exact,
        "points_per_s": N_POINTS / min(warm_exact),
        "recheck_false_points_per_s": N_POINTS / min(warm),
        "cell_band": nar.get("band"), "band_cap": nar.get("cap"),
        "narrow_caps": nar.get("caps"), "ties": nar.get("ties"),
        "host_oracle_rows": sum(host_rows),
        "staged_wall_s": staged_s, "stage_s": {
            **stage_s, "rest": staged_s - sum(stage_s.values())},
        "profiled_wall_ms": prof_x_ms, **idle_share(busy_x, rows_x, min(warm_exact) * 1e3),
        "top_device_ops": [{"op": k[:80], "ms": ms, "calls": c} for ms, k, c in rows_x[:6]],
        "changed_vs_recheck_false": int((exact != out).sum()),
        "unexpected_events": bad_events[:5],
    })
    if recheck_launches <= 0:
        return fail("pip_join(recheck=True) never launched pip_heavy_tiled")
    if getattr(exact, "degraded", False) or isinstance(exact, DegradedResult):
        return fail("the exact join came back degraded")
    if exact_agree != 1.0:
        return fail(f"the exact join agrees with its f64 oracle on {exact_agree} "
                    f"of {N_EXACT} points (must be 1.0)")
    if len(narrow) != 1 or nar.get("mode") != "alt_rejoin":
        return fail(f"the exact join recorded {narrow[:2]} as its narrow re-join")
    if bad_events:
        return fail(f"a timed or gated join recorded {bad_events[:3]}")

    # 6c. the port's calibration sweep on the card (CUDA's trigonometry)
    t0 = time.perf_counter()
    sweep = CM.run_sweep(N_DRIFT, seeds=(3, 11), device=dev, resolutions=(5, 7, 9))
    cell_sweep = sweep["cell_margin"]["sweep"]
    edge_sweep = sweep["edge_band"]["sweep"]
    cell_max = sweep["cell_margin"]["max_observed_k"]
    edge_max = sweep["edge_band"]["max_observed_k"]
    golden = os.path.join(HERE, "tests", "goldens", "recheck_margins.json")
    ref_golden = None
    if os.path.exists(golden):
        with open(golden) as fh:
            g = json.load(fh)
        ref_golden = {"cell_max_k": g["cell_margin"]["max_observed_k"],
                      "edge_max_k": g["edge_band"]["max_observed_k"]}
    emit({
        "phase": "drift", "device": str(dev), "seconds": time.perf_counter() - t0,
        "CELL_MARGIN_K": J.CELL_MARGIN_K, "EDGE_BAND_K": J.EDGE_BAND_K,
        "cell_max_observed_k": cell_max, "edge_max_observed_k": edge_max,
        "cell_headroom": J.CELL_MARGIN_K / max(cell_max, 1e-9),
        "edge_headroom": J.EDGE_BAND_K / max(edge_max, 1e-9),
        "reference_golden_xla_cpu": ref_golden,
        "cell_sweep": cell_sweep, "edge_sweep": edge_sweep,
    })
    if not all(any(r["n_disagreements"] for r in sw) for sw in (cell_sweep, edge_sweep)):
        return fail("a drift sweep found no f32 disagreement: no signal")
    if 2 * cell_max > J.CELL_MARGIN_K:
        return fail(f"CUDA cell drift {cell_max} eps leaves < 2x headroom under "
                    f"CELL_MARGIN_K={J.CELL_MARGIN_K}")
    if 2 * edge_max > J.EDGE_BAND_K:
        return fail(f"CUDA edge drift {edge_max} eps*scale leaves < 2x headroom "
                    f"under EDGE_BAND_K={J.EDGE_BAND_K}")

    # 6d. the fault pass on the first N_FAULT points of the exact join
    fpts = raw[:N_FAULT]
    fclean = exact[:N_FAULT]

    def fjoin():
        return J.pip_join(fpts, None, H3, RES, chip_index=ix, probe="adaptive",
                          recheck=True)

    with telemetry.capture() as ev_t:
        with faults.transient_errors(2, sites=("pip_join.device",)):
            f_transient = fjoin()
    # past the retry budget a join on the card raises: its work never
    # moves to the CPU
    f_exhaust = None
    with telemetry.capture() as ev_x:
        with faults.transient_errors(50, sites=("pip_join.device",)):
            try:
                f_exhaust = fjoin()
            except RetryExhausted as e:
                exhausted = e
    f_host = J.recheck_oracle(fpts, ix.host, H3, RES)
    site = "pip_join.device"
    os.environ["MOSAIC_WATCHDOG_PIP_JOIN_DEVICE"] = str(WATCHDOG_S)
    try:
        with telemetry.capture() as ev_s:
            with faults.stalls(2 * WATCHDOG_S, sites=(site,)):
                f_stall = fjoin()
    finally:
        del os.environ["MOSAIC_WATCHDOG_PIP_JOIN_DEVICE"]
        for th in threading.enumerate():  # the abandoned attempt ends here
            if th.name == f"mosaic-watchdog:{site}":
                th.join(timeout=60)
        torch.cuda.synchronize()

    def kinds(ev):
        return [e["event"] for e in ev if e["event"] != "span"]

    stall_retry = [e for e in ev_s if e["event"] == "transient_retry"]
    checks = {
        "transient_bit_identical": bool(np.array_equal(f_transient, fclean))
        and not getattr(f_transient, "degraded", False),
        "transient_retries": kinds(ev_t).count("transient_retry"),
        "exhausted_raised": f_exhaust is None,
        "exhausted_attempts": exhausted.attempts if f_exhaust is None else 0,
        "exhausted_degraded": "degraded" in kinds(ev_x),
        "stall_bit_identical": bool(np.array_equal(f_stall, fclean))
        and not getattr(f_stall, "degraded", False),
        "stall_events": [k for k in kinds(ev_s) if k != "probe_route"],
        "stall_retried_as": stall_retry[0]["error"][:80] if stall_retry else None,
        "clean_equals_oracle": bool(np.array_equal(fclean, f_host)),
    }
    emit({"phase": "faults", "points": N_FAULT, "watchdog_s": WATCHDOG_S,
          "exhausted_events": sorted(set(kinds(ev_x))), **checks})
    if not (checks["transient_bit_identical"] and checks["transient_retries"] == 2):
        return fail(f"injected transient errors: {checks}")
    if not (checks["exhausted_raised"] and checks["exhausted_attempts"] >= 3
            and not checks["exhausted_degraded"]):
        return fail(f"retry exhaustion on the card did not raise RetryExhausted: {checks}")
    if not (checks["stall_bit_identical"] and "watchdog_stall" in checks["stall_events"]
            and stall_retry and StalledDeviceError.__name__ in stall_retry[0]["error"]):
        return fail(f"the planned stall was not raised and retried: {checks}")

    # 7. zonal_tiled on the segments the zones probe gives on the raster of
    # phase 8, at the two launch sizes: a default 256x256 tile, a 2048x2048
    # tile; both tiles centred on the raster
    n_seg = probe_eng.num_zones
    rng = np.random.default_rng(SEED)
    tiled, segs, tile_vals = {}, {}, {}
    for side in (256, 2048):
        plan = plan_tiles(raster, (side, side))
        ny, nx = -(-raster.height // side), -(-raster.width // side)
        one = dataclasses.replace(plan, origins=plan.origins[[(ny // 2) * nx + nx // 2]])
        vals, mask = stack_tiles(raster, one, 1, dtype=np.float32)
        tile_vals[side] = vals.reshape(-1)
        maskf = mask.reshape(-1)
        geom = probe_eng._tile_zone_rows(one, 0, maskf)
        seg_np = segs[side] = np.where(maskf & (geom >= 0), geom, -1).astype(np.int32)
        s_d = torch.from_numpy(seg_np).to(dev)
        live = s_d >= 0
        data = {
            "integer": torch.from_numpy(vals.reshape(-1) % 113).to(dev),
            "float": torch.from_numpy(
                rng.uniform(0, 32000, seg_np.size).astype(np.float32)).to(dev),
        }
        res = {"pixels": int(seg_np.size), "live_pixels": int(live.sum()), "S": n_seg}
        err = 0.0
        for kind, v_d in data.items():
            got = Z.zonal_tiled(v_d, s_d, n_seg)
            again = Z.zonal_tiled(v_d, s_d, n_seg)
            want = Z.zonal_tiled_plain(v_d, s_d, n_seg)
            torch.cuda.synchronize()
            exact3 = all(torch.equal(got[i], want[i]) for i in (0, 2, 3))
            exact3 = exact3 and same_bits(got, again)
            abs_sum = torch.zeros(n_seg, dtype=torch.float64, device=dev)
            abs_sum.index_add_(0, s_d[live].long(), v_d[live].abs().double())
            sum_err = (got[1].double() - want[1].double()).abs()
            if kind == "integer":
                ok = exact3 and torch.equal(got[1], want[1])
                res["integer_max_zone_total"] = float(want[1].max())
            else:
                ok = exact3 and bool((sum_err <= ZONAL_SUM_RTOL * abs_sum).all())
                res["float_max_rel_sum_err"] = float(
                    (sum_err / abs_sum.clamp(min=1.0)).max())
            res[f"equal_{kind}"] = ok
            err = max(err, float(sum_err.max()),
                      *(float((got[i].double() - want[i].double()).abs().max())
                        for i in (0, 2, 3)))
        v_d = data["float"]
        segc = torch.where(live, s_d, n_seg).long()
        ones = torch.ones_like(v_d)

        def composite():
            # four torch calls computing the same function (not used by the port)
            c = torch.zeros(n_seg + 1, device=dev).scatter_reduce_(0, segc, ones, "sum")
            t_ = torch.zeros(n_seg + 1, device=dev).index_add_(0, segc, v_d)
            lo = torch.full((n_seg + 1,), 1e30, device=dev).scatter_reduce_(
                0, segc, v_d, "amin")
            hi = torch.full((n_seg + 1,), -1e30, device=dev).scatter_reduce_(
                0, segc, v_d, "amax")
            return c, t_, lo, hi

        n_bytes = seg_np.size * (4 + 4) + 4 * n_seg * 4
        b_ms, b_by = bound(n_bytes, 4 * seg_np.size)
        res.update({
            "match": res["equal_integer"] and res["equal_float"], "max_abs_err": err,
            "ms": device_ms(lambda: Z.zonal_tiled(v_d, s_d, n_seg), "zonal_tiled"),
            "wrapper_ms": cuda_ms(lambda: Z.zonal_tiled(v_d, s_d, n_seg)),
            "plain_ms": cuda_ms(lambda: Z.zonal_tiled_plain(v_d, s_d, n_seg), reps=5),
            "composite_ms": cuda_ms(composite),
            "composite": "index_add_ + 3 scatter_reduce_ (count, min, max)",
            "bound_ms": b_ms, "bound_by": b_by,
        })
        tiled[side] = res
        emit({"phase": "zonal_tiled", "tile": [side, side], **res})
        if not res["match"]:
            return fail(f"zonal_tiled differs from zonal_tiled_plain on the {side} tile")
        if res["integer_max_zone_total"] >= 2 ** 24:
            return fail("the integer check's zone totals are not f32-exact")

    # the fold lane's zonal_seq_fold against the CPU lane, f64 bit for bit,
    # on the 256 tile's segments: the raster's integer values (the exact
    # branch) and float values (the sequential branch)
    small = tiled[256]
    seg_np = segs[256]
    dadd_cycles, dadd_ns = Z.dadd_latency(dev)
    fs = torch.from_numpy(seg_np)
    fs_d = fs.to(dev)
    live_n = int((seg_np >= 0).sum())
    fold = {}
    for kind, fv in (
        ("integer", torch.from_numpy(tile_vals[256].astype(np.float64))),
        ("float", torch.from_numpy(rng.uniform(0, 32000, seg_np.size))),
    ):
        fv_d = fv.to(dev)
        got = Z.zonal_fold(fv_d, fs_d, n_seg, acc_dtype=torch.float64)
        again = Z.zonal_fold(fv_d, fs_d, n_seg, acc_dtype=torch.float64)
        t0 = time.perf_counter()
        want = Z.zonal_fold(fv, fs, n_seg, acc_dtype=torch.float64)
        plain_cpu_ms = (time.perf_counter() - t0) * 1e3
        ok = same_bits(got, want) and same_bits(got, again)
        live_seg = want[0] > 0  # empty segments hold +-inf on both lanes
        err = max(float((g.cpu().double() - w.double())[live_seg].abs().max())
                  for g, w in zip(got, want)) if bool(live_seg.any()) else 0.0
        segc = torch.where(fs_d >= 0, fs_d, n_seg)
        counts = torch.bincount(segc, minlength=n_seg + 1)[:n_seg]
        exact = Z.exact_sum_ok(fv_d, fs_d, n_seg)
        seq_run = int(torch.where(exact, 0, counts).max())
        # 8-byte value and 4-byte id in a pixel; count and three f64 out
        n_bytes = seg_np.size * (8 + 4) + n_seg * (4 + 3 * 8)
        # per live pixel: one f64 add, two f64 compares
        b_ms, b_by = bound(n_bytes, 3 * live_n, PEAK_F64, seq_run * dadd_ns * 1e-9)
        fold[kind] = {
            "equal_to_cpu_lane": ok, "max_abs_err": err, "longest_run": int(counts.max()),
            "longest_sequential_run": seq_run,
            "exact_segments": int(exact.sum()),
            "ms": device_ms(lambda: Z.zonal_fold(
                fv_d, fs_d, n_seg, acc_dtype=torch.float64), "zonal_seq_fold"),
            "wrapper_ms": cuda_ms(lambda: Z.zonal_fold(
                fv_d, fs_d, n_seg, acc_dtype=torch.float64)),
            "plain_ms": cuda_ms(lambda: Z.zonal_seq_fold_plain(
                fv_d, fs_d, n_seg, acc_dtype=torch.float64), reps=5),
            "plain_cpu_ms": plain_cpu_ms, "bound_ms": b_ms, "bound_by": b_by,
        }
    fold_ok = all(f["equal_to_cpu_lane"] for f in fold.values())
    emit({
        "phase": "zonal_fold_seq", "pixels": int(seg_np.size), "live_pixels": live_n,
        "S": n_seg, "dtype": "float64", "dadd_latency_cycles": dadd_cycles,
        "dadd_latency_ns": dadd_ns, **fold,
    })
    if not fold_ok:
        return fail("the CUDA fold lane differs from the sequential CPU lane")

    # 8. the raster path, each path with the counts set to 0 just before it
    counted = {
        "zonal_tiled": Z.zonal_tiled, "zonal_fold": Z.zonal_fold,
        "pip_heavy_tiled": K.pip_heavy_tiled, "pip_zone": K.pip_zone,
    }
    engines = {
        "zones_tiled": ZonalEngine(H3, RES, chip_index=ix, lane="tiled"),
        "zones_fold": ZonalEngine(H3, RES, chip_index=ix, lane="fold"),
        "grid": ZonalEngine(H3, RES),
    }
    calls = {
        "zones_tiled": lambda r: engines["zones_tiled"].zones(r),
        "zones_fold": lambda r: engines["zones_fold"].zones(r),
        "grid": lambda r: engines["grid"].grid(r),
    }
    n_tiles = plan_tiles(raster).ntiles
    real_pixels = raster.height * raster.width
    pcrop_tiles = plan_tiles(pcrop).ntiles
    launches = {}
    results = {}
    crop_kernels = {}
    warm_by_path = {}
    for name, call in calls.items():
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        results[name] = call(raster)
        cold_s = time.perf_counter() - t0
        launches[name] = {k: fn.launches for k, fn in counted.items()}
        warm_s = []
        for _ in range(RASTER_WARM_REPS):
            t0 = time.perf_counter()
            call(raster)
            warm_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        call(pcrop)
        crop_warm_s = time.perf_counter() - t0
        busy, rows_r, prof_ms = profile_device(lambda: call(pcrop))
        crop_kernels[name] = kernel_times(rows_r)
        out_r = results[name]
        warm_by_path[name] = warm_s
        emit({
            "phase": f"raster_{name}", "pixels": real_pixels, "tiles": n_tiles,
            "tile": list(plan_tiles(raster).shape), "launches": launches[name],
            "keys": int(out_r.keys.size), "pixels_folded": int(out_r.pixels),
            "cold_s": cold_s, "warm_s": warm_s,
            "pixels_per_s": real_pixels / min(warm_s),
            "profiled_on": f"{PROFILE_CROP}x{PROFILE_CROP} crop, {pcrop_tiles} tiles",
            "crop_warm_s": crop_warm_s, "profiled_wall_ms": prof_ms,
            **idle_share(busy, rows_r, crop_warm_s * 1e3),
            "device_ops_per_tile": sum(c for _, _, c in rows_r) / pcrop_tiles,
            "crop_kernels": crop_kernels[name],
            "top_device_ops": [
                {"op": k[:80], "ms": ms, "calls": c} for ms, k, c in rows_r[:6]
            ],
        })
    zl = launches["zones_tiled"]
    if zl["zonal_tiled"] <= 0 or zl["pip_heavy_tiled"] <= 0:
        return fail(f"the tiled zones path launched {zl}: it must launch "
                    "zonal_tiled and pip_heavy_tiled")
    if zl["zonal_tiled"] != launches["zones_fold"]["zonal_fold"]:
        return fail("zonal_tiled did not launch once per tile with live pixels "
                    f"({zl['zonal_tiled']} against the fold lane's "
                    f"{launches['zones_fold']['zonal_fold']})")
    if launches["grid"]["zonal_fold"] <= 0:
        return fail("the grid path never launched the fold")
    for name, r in results.items():
        ok = (r.keys.size > 0 and np.isfinite(r.sum).all() and (r.count > 0).all()
              and r.pixels == int(r.count.sum()) and r.pixels <= real_pixels)
        if name != "grid":
            ok = ok and int(r.keys.min()) >= 0 and int(r.keys.max()) < len(zones)
        if not ok:
            return fail(f"raster {name} result is not well formed")

    # where the time of one warm tiled zones call goes, on the host clock:
    # each tile's probe (pixel centers, f64 H3 cells, pip_join_points), the
    # rest of its zone rows (copy back, epsilon-band host re-join), its fold
    # (copies in, zonal_tiled), and the rest (staging, per-tile merge)
    eng = engines["zones_tiled"]
    stage_s = {"probe": 0.0, "rows": 0.0, "fold": 0.0}

    def timed(stage, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            stage_s[stage] += time.perf_counter() - t0
            return out
        return run

    eng._zones_probe = timed("probe", eng._zones_probe)
    eng._tile_zone_rows = timed("rows", eng._tile_zone_rows)
    eng._zones_fold = timed("fold", eng._zones_fold)
    t0 = time.perf_counter()
    eng.zones(raster)
    total_s = time.perf_counter() - t0
    del eng._zones_probe, eng._tile_zone_rows, eng._zones_fold
    emit({
        "phase": "raster_breakdown", "call": "zones_tiled", "tiles": n_tiles,
        "wall_s": total_s,
        "stage_s": {
            "probe": stage_s["probe"],
            "rows_copy_back_and_band_rejoin": stage_s["rows"] - stage_s["probe"],
            "fold": stage_s["fold"],
            "staging_and_merge": total_s - stage_s["rows"] - stage_s["fold"],
        },
        "ms_per_tile": total_s * 1e3 / n_tiles,
    })

    # gates: the fold lane and the grid against the f64 host oracles on the
    # crop; the tiled lane against the fold lane on the mod-113 twin
    t0 = time.perf_counter()
    zones_agree = agreement(engines["zones_fold"].zones(crop),
                            RZ.host_zonal_zones_oracle(crop, ix, H3, RES))
    grid_agree = agreement(engines["grid"].grid(crop),
                           RZ.host_zonal_grid_oracle(crop, RES, H3))
    oracle_s = time.perf_counter() - t0
    # f64 H3 cells of the crop's pixel centers: the card's against numpy's
    cplan = plan_tiles(crop)
    mismatch, first = 0, None
    for t in range(cplan.ntiles):
        d = engines["grid"]._assign(cplan.gt, cplan.origins[t], *cplan.shape).cpu().numpy()
        pts = RZ.host_tile_centers(cplan, t)
        h = H3.point_to_cell(pts, RES)
        bad = np.nonzero(d != h)[0]
        mismatch += bad.size
        if bad.size and first is None:
            first = {"tile": t, "pixel": int(bad[0]), "xy": pts[bad[0]].tolist(),
                     "card": int(d[bad[0]]), "host": int(h[bad[0]])}
    twin = Raster(
        data=np.where(raster.data == NODATA, NODATA, raster.data % 113).astype(np.int16),
        gt=raster.gt, srid=raster.srid, nodata=raster.nodata,
    )
    twin_fold = engines["zones_fold"].zones(twin)
    twin_agree = agreement(engines["zones_tiled"].zones(twin), twin_fold)
    emit({
        "phase": "raster_gates", "crop": [CROP, CROP],
        "fold_zones_vs_oracle": zones_agree, "grid_vs_oracle": grid_agree,
        "oracle_s": oracle_s, "crop_cells_card_vs_host_mismatch": mismatch,
        "first_cell_mismatch": first,
        "tiled_vs_fold_on_twin": twin_agree,
        "twin_max_zone_total": float(twin_fold.sum.max()),
    })
    if zones_agree != 1.0 or grid_agree != 1.0:
        return fail(f"fold zones / grid agree with the f64 oracles on "
                    f"{zones_agree} / {grid_agree} of the crop's rows")
    if twin_fold.sum.max() >= 2 ** 24:
        return fail("the twin's zone totals are not f32-exact")
    if twin_agree != 1.0:
        return fail(f"tiled zones agree with fold zones on {twin_agree} of the twin")

    # 8b. the durable stream at full width (the reference's stream bench:
    # a ring of 8 batches of 4M points, 25 batches, snapshots every 8)
    from mosaic_tpu_torch.obs import write_jsonl
    from mosaic_tpu_torch.runtime import checkpoint as CK
    from mosaic_tpu_torch.sql import RasterStream
    from mosaic_tpu_torch.sql import stream as S

    runs_dir = os.path.join(HERE, RUNS_DIR)
    shutil.rmtree(runs_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    slots = [raw] + [random_points(N_POINTS, NYC_BBOX, seed=SEED + i)
                     for i in range(1, STREAM_RING)]
    t0 = time.perf_counter()
    ring = S.ring_from_host(slots, device=dev)
    ring_s = time.perf_counter() - t0
    # the caps from the exact counts of every slot, with headroom
    slot_counts = [J._probe_counts(H3.point_to_cell(ring[i].to(torch.float32), RES), ix)
                   .tolist() for i in range(STREAM_RING)]
    top = [max(c[j] for c in slot_counts) for j in range(3)]
    stream_caps = {
        name: min(J._next_pow2(int(top[j] * STREAM_HEADROOM) + 1), N_POINTS)
        for j, name in enumerate(("found_cap", "heavy_cap", "convex_cap"))
    }
    sj = S.StreamJoin(ix, H3, RES, probe="adaptive", **stream_caps)
    sj.compile(ring, 1)

    (s1, first_sync), (s3, _) = (count_syncs(lambda nb=nb: sj._loop(ring, ix, nb, False))
                                 for nb in (1, 3))
    K.pip_heavy_tiled.launches = 0
    K.pip_zone.launches = 0
    stream_run = sj.run(ring, STREAM_BATCHES)
    stream_launches = K.pip_heavy_tiled.launches
    stream_zone_launches = K.pip_zone.launches
    stream_walls = [stream_run.wall_s]
    batched = sj.run_batched(ring, STREAM_BATCHES)
    one_cycle = sj.run(ring, STREAM_RING, collect=True)
    t0 = time.perf_counter()
    sj.step_stats(ring[0]).cpu()
    step_s = [time.perf_counter() - t0]

    def stats3(r):
        return (r.checksum, r.matches, r.overflow)

    want3 = stats3(stream_run)
    t0 = time.perf_counter()
    CK.fingerprint(ring)
    fingerprint_s = time.perf_counter() - t0
    durable = {}
    for name, kw in (("sync", {}), ("pipelined", {"pipeline": True, "window": 4})):
        d = os.path.join(runs_dir, name)
        with telemetry.capture() as ev:
            r = sj.run_durable(ring, STREAM_BATCHES, run_dir=d, snapshot_every=8, **kw)
        if name == "sync":  # 8m's stream trail
            os.makedirs(os.path.join(HERE, OBS_DIR), exist_ok=True)
            write_jsonl(ev, os.path.join(HERE, OBS_DIR, "stream.jsonl"))
        snaps = [e["seconds"] for e in ev if e["event"] == "snapshot_saved"]
        # a fatal device loss after 2 segments, then resume
        dk = os.path.join(runs_dir, f"{name}_kill")
        killed = False
        with faults.inject(fail_first=99, skip_first=2, sites=("stream.scan_step",),
                           exc_factory=lambda site: RuntimeError("simulated device loss")):
            try:
                sj.run_durable(ring, STREAM_BATCHES, run_dir=dk, snapshot_every=8, **kw)
            except RuntimeError:
                killed = True
        t0 = time.perf_counter()
        resumed = sj.resume(dk, ring, **kw)
        resume_s = time.perf_counter() - t0
        durable[name] = {
            "equal_to_run": stats3(r) == want3, "degraded": r.metrics["degraded"],
            "snapshots": r.metrics["snapshots"], "snapshot_steps": CK.list_snapshots(d),
            "wall_s": r.wall_s, "points_per_s": r.points_per_sec,
            "snapshot_s": snaps, "pipeline": r.metrics.get("pipeline"),
            "killed": killed, "resumed_from": resumed.metrics["resumed_from"],
            "resume_equal_to_run": stats3(resumed) == want3, "resume_s": resume_s,
        }
    # snapshots every batch: where the pipelined executor's writer thread
    # has the most to overlap (each executor STREAM_EVERY1_REPS times)
    every1 = {"sync": [], "pipelined": [], "equal_to_run": True}
    for rep_i in range(STREAM_EVERY1_REPS):
        for name, kw in (("sync", {}), ("pipelined", {"pipeline": True, "window": 4})):
            d = os.path.join(runs_dir, f"every1_{name}_{rep_i}")
            r = sj.run_durable(ring, STREAM_BATCHES, run_dir=d, snapshot_every=1, **kw)
            every1[name].append(r.wall_s)
            every1["equal_to_run"] &= stats3(r) == want3 and r.metrics["snapshots"] == STREAM_BATCHES
            shutil.rmtree(d, ignore_errors=True)
    # admission: rows poisoned at the stream.admit site are quarantined,
    # exactly those; the admitted ring's loop equals its per-batch path
    with faults.corrupt_batches(rows=STREAM_POISON, n=3, sites=("stream.admit",)):
        t0 = time.perf_counter()
        ring_q, rep = sj.admit(slots, bounds=(NYC_BBOX[0], NYC_BBOX[1],
                                              NYC_BBOX[2], NYC_BBOX[3]))
        admit_s = time.perf_counter() - t0
    expect_rows = [(b, r_) for b in range(3) for r_ in range(STREAM_POISON)]
    q_run, q_batched = sj.run(ring_q, STREAM_RING), sj.run_batched(ring_q, STREAM_RING)
    admit = {
        "quarantined": rep.n_quarantined, "exact_rows": sorted(rep.rows) == expect_rows,
        "run_equal_to_batched": stats3(q_run) == stats3(q_batched), "admit_s": admit_s,
    }
    del ring_q
    # past the retry budget a segment on the card raises, and nothing
    # degrades to the CPU
    with telemetry.capture() as ev_x:
        with faults.transient_errors(50, sites=("stream.scan_step",)):
            try:
                sj.run_durable(ring, 2, run_dir=os.path.join(runs_dir, "exhaust"),
                               snapshot_every=1)
                stream_exhausted = False
            except RetryExhausted:
                stream_exhausted = True
    stream_exhaust_degraded = "degraded" in [e["event"] for e in ev_x]
    peak, peak_src = S.hbm_peak(dev, fallback_arrays=[ring])
    # device busy time and idle share over 3 batches under the profiler
    warm3 = sj.run(ring, 3).wall_s
    with telemetry.capture() as sev:
        busy_s, rows_s, prof_s_ms = profile_device(lambda: sj.run(ring, 3))
    stream_kernels = kernel_times(rows_s)
    stream_ok = {
        "overflow_zero": stream_run.overflow == 0,
        "run_equal_to_batched": want3 == stats3(batched),
        "slot0_equal_to_pip_join": bool(np.array_equal(one_cycle.outs[0], out)),
        "slot0_equal_to_scatter": bool(np.array_equal(one_cycle.outs[0], base)),
        "cycle_equal_to_batched": bool(np.array_equal(one_cycle.outs, batched.outs[:STREAM_RING])),
        "durable_equal": all(v["equal_to_run"] and not v["degraded"]
                             and v["snapshot_steps"] == [8, 16, 24, 25]
                             for v in durable.values()),
        "resume_equal": all(v["killed"] and v["resumed_from"] == 16
                            and v["resume_equal_to_run"] for v in durable.values()),
        "quarantine_exact": admit["quarantined"] == 3 * STREAM_POISON and admit["exact_rows"]
        and admit["run_equal_to_batched"],
        "exhaustion_raised": stream_exhausted and not stream_exhaust_degraded,
        "durable_every_batch_equal": every1["equal_to_run"],
        # a lower bound: torch's sync debug mode is a prototype
        "loop_free_of_host_syncs": s3 - s1 == 0,
    }
    emit({
        "phase": "stream", "ring": [STREAM_RING, N_POINTS], "batches": STREAM_BATCHES,
        "points": STREAM_BATCHES * N_POINTS, "caps": stream_caps,
        "slot_counts": slot_counts, "ring_build_s": ring_s,
        "ring_mb": ring.numel() * ring.element_size() / 1e6,
        "pip_heavy_tiled_launches": stream_launches,
        "pip_zone_launches": stream_zone_launches,
        "checksum": stream_run.checksum, "matches": stream_run.matches,
        "overflow": stream_run.overflow,
        "run_wall_s": stream_walls,
        "points_per_s": STREAM_BATCHES * N_POINTS / min(stream_walls),
        "batched_wall_s": batched.wall_s,
        "step_stats_s": step_s, "single_batch_points_per_s": N_POINTS / min(step_s),
        "host_syncs": {"loop_1_batch": s1, "loop_3_batches": s3,
                       "per_batch": (s3 - s1) / 2, "first": first_sync},
        "fingerprint_s": fingerprint_s, "durable": durable,
        "durable_snapshot_every_batch_wall_s": every1, "admit": admit,
        "hbm_peak_bytes": peak, "hbm_peak_source": peak_src,
        "profiled_batches": 3, "warm_wall_ms_3": warm3 * 1e3,
        "profiled_wall_ms": prof_s_ms, **idle_share(busy_s, rows_s, warm3 * 1e3),
        "timeline_shares": timeline_shares(sev),
        "kernels_3_batches": stream_kernels,
        "top_device_ops": [{"op": k[:80], "ms": ms, "calls": c} for ms, k, c in rows_s[:6]],
        "gates": stream_ok,
    })
    del ring, one_cycle, batched
    shutil.rmtree(runs_dir, ignore_errors=True)
    if stream_launches <= 0:
        return fail("the stream never launched pip_heavy_tiled")
    bad_gates = [k for k, v in stream_ok.items() if not v]
    if bad_gates:
        return fail(f"stream gates failed: {bad_gates}")

    # 8c. the durable raster scan: both lanes on the whole raster against
    # phase 8's zones of the same lane, then durability on the crop; the
    # counts are zeroed just before each run they are read from
    def counted_run(call):
        for fn in counted.values():
            fn.launches = 0
        out_ = call()
        return out_, {k: fn.launches for k, fn in counted.items()}

    rs_tiled = RasterStream(ix, H3, RES, lane="tiled")
    scan, rs_launches = counted_run(lambda: rs_tiled.scan(raster))
    scan_agree = agreement(scan.stats, results["zones_tiled"])
    # a warm scan, and one with no watchdog deadline (every guarded call
    # inline on this thread instead of a worker thread each)
    scan_warm_s = rs_tiled.scan(raster).wall_s
    scan_inline_s = rs_tiled.scan(raster, watchdog_default_s=None).wall_s
    rs_fold = RasterStream(ix, H3, RES)
    fold_scan, rs_fold_launches = counted_run(lambda: rs_fold.scan(raster))
    fold_scan_agree = agreement(fold_scan.stats, results["zones_fold"])
    crop_clean, crop_launches = counted_run(lambda: rs_fold.scan(crop))
    crop_fold_launches = crop_launches["zonal_fold"]
    crop_agree = agreement(crop_clean.stats, engines["zones_fold"].zones(crop))
    d = os.path.join(runs_dir, "raster")
    crop_durable = rs_fold.scan(crop, run_dir=d, snapshot_every=4)
    dk = os.path.join(runs_dir, "raster_kill")
    with faults.inject(fail_first=99, skip_first=8, sites=("raster.zonal",),
                       exc_factory=lambda site: RuntimeError("simulated device loss")):
        try:
            rs_fold.scan(crop, run_dir=dk, snapshot_every=4)
            raster_killed = False
        except RuntimeError:
            raster_killed = True
    crop_resumed = rs_fold.resume(dk, crop)
    with telemetry.capture() as ev_r:
        with faults.transient_errors(2, sites=("raster.zonal",)):
            crop_retried = rs_fold.scan(crop)
    shutil.rmtree(runs_dir, ignore_errors=True)
    rs_ok = {
        "scan_equal_to_zones_tiled": scan_agree == 1.0,
        "fold_scan_equal_to_zones_fold": fold_scan_agree == 1.0,
        "crop_equal_to_zones_fold": crop_agree == 1.0,
        "durable_equal": agreement(crop_durable.stats, crop_clean.stats) == 1.0
        and crop_durable.metrics["snapshots"] == 4,
        "resume_equal": raster_killed and crop_resumed.metrics["resumed_from"] == 8
        and agreement(crop_resumed.stats, crop_clean.stats) == 1.0,
        "retry_equal": agreement(crop_retried.stats, crop_clean.stats) == 1.0
        and [e["event"] for e in ev_r].count("transient_retry") == 2
        and not crop_retried.metrics["degraded"],
    }
    emit({
        "phase": "raster_stream", "pixels": real_pixels, "tiles": scan.ntiles,
        "lane": "tiled", "wall_s": scan.wall_s, "warm_wall_s": scan_warm_s,
        "inline_watchdog_wall_s": scan_inline_s,
        "tiles_per_s": scan.ntiles / min(scan.wall_s, scan_warm_s),
        "pixels_per_s": real_pixels / min(scan.wall_s, scan_warm_s),
        "zones_tiled_warm_s": warm_by_path["zones_tiled"], "launches": rs_launches,
        "pipeline": scan.metrics["pipeline"],
        "fold_wall_s": fold_scan.wall_s, "fold_launches": rs_fold_launches,
        "fold_tiles_per_s": fold_scan.ntiles / fold_scan.wall_s,
        "fold_pixels_per_s": real_pixels / fold_scan.wall_s,
        "zones_fold_warm_s": warm_by_path["zones_fold"],
        "crop": [CROP, CROP], "crop_tiles": crop_clean.ntiles,
        "crop_launches": crop_launches,
        "crop_wall_s": crop_clean.wall_s, "crop_durable_wall_s": crop_durable.wall_s,
        "crop_resume_wall_s": crop_resumed.wall_s, "gates": rs_ok,
    })
    if rs_launches["zonal_tiled"] <= 0 or rs_launches["pip_heavy_tiled"] <= 0:
        return fail(f"the durable raster scan launched {rs_launches}")
    if rs_fold_launches["zonal_fold"] <= 0 or rs_fold_launches["pip_heavy_tiled"] <= 0:
        return fail(f"the fold-lane raster scan launched {rs_fold_launches}")
    bad_gates = [k for k, v in rs_ok.items() if not v]
    if bad_gates:
        return fail(f"raster_stream gates failed: {bad_gates}")

    x_out = expr_overlay_phases(ix, H3, dev, len(zones), counted, cuda_ms, runs_dir,
                                engines["zones_fold"])
    if isinstance(x_out, int):
        return x_out
    x_launches, xg_launches = x_out["x_launches"], x_out["xg_launches"]
    xs_launches, o_launches = x_out["xs_launches"], x_out["o_launches"]
    x_fold_equal, x_fold_ms, x_fold_err = (
        x_out["x_fold_equal"], x_out["x_fold_ms"], x_out["x_fold_err"])
    o_fold_equal, o_fold_ms, o_segments = (
        x_out["o_fold_equal"], x_out["o_fold_ms"], x_out["o_segments"])

    # 8l. tuning profiles; the store goes to the serving process for 8e
    t_out = tune_phase(ix, H3, dev, zones, raw, crop, counted,
                       {"cuda_ms": cuda_ms, "device_ms": device_ms, "bound": bound},
                       os.path.join(SERVING[0].dir, PROFILE_STORE))
    if isinstance(t_out, int):
        return t_out
    tj, tz, k128 = t_out["join"], t_out["zones"], t_out["k128"]

    # 8n. multi-device: the mesh lanes on a logical mesh of the card
    why, mesh_launches = mesh_phase(ix, H3, dev, len(zones), raw, cells, out, base,
                                    crop, engines, x_out["overlay"], counted, card)
    if why:
        return fail(why)

    # 8s. the program store: export 8d's ladder, start the relaunch process
    # (it runs beside 8o-8r), then the three refusals in this process
    t8s = time.perf_counter()
    relaunch = RelaunchProcess(ix, H3, os.path.join(HERE, RELAUNCH_DIR))
    RELAUNCHING.append(relaunch)
    if relaunch.failed:
        return fail(f"store export gates failed: {relaunch.failed}")
    relaunch.start(os.path.join(SERVING[0].dir, "serve_index.npz"))
    why = store_refusals(ix, H3, dev, relaunch.store, relaunch.dir)
    if why:
        return fail(why)
    store_main_s = time.perf_counter() - t8s

    # 8o. the function surface through MosaicContext.build("H3").functions
    why, fn_launches = functions_phase(ix, table, H3, dev, zones, raw, out, host_exact,
                                       main_pps, raster, crop, x_out["overlay"],
                                       counted, card)
    if why:
        return fail(why)

    # 8p. files in and out: the CRS lane, GeoTIFF, the readers and writers
    why, files_launches = files_phase(ix, table, H3, dev, zones, raw, raster,
                                      results["zones_tiled"], engines["zones_tiled"],
                                      counted, card)
    if why:
        return fail(why)

    # 8q. the last modules: utils, viz and the chaos sweep on the card
    why, util_launches, chaos_launches = utilities_phase(ix, table, H3, dev, raw, crop,
                                                         counted, card)
    if why:
        return fail(why)

    # 8r. the last gaps: the iteration skeletons and the retry knobs
    why, models_launches = models_phase(ix, H3, dev, raw, len(zones), counted, card)
    if why:
        return fail(why)

    # 8s (cont.): the relaunch process's result
    t0 = time.perf_counter()
    why, relaunch_launches = relaunch.finish(build_s, card)
    store_main_s += time.perf_counter() - t0
    emit({"phase": "store_cost", "main_process_s": store_main_s})
    if why:
        return fail(why)

    # 8d-8f, 8j, 8k. serving, KNN and epochs in a process of its own, as a
    # server runs: the profiler the phases above attached to this process
    # slows every later eager op. The child, started after phase 3, loaded
    # the index from disk and the kernel libraries nvcc built here and
    # built its own indexes meanwhile; it runs its phases now.
    served = serve_process(SERVING[0], ix, H3)
    if isinstance(served, int):
        return served
    serve_launches = served["launches"]

    # 8m. observability: the tools over both processes' trails
    code = obs_phase(os.path.join(HERE, OBS_DIR), served.get("obs") or {})
    if code is not None:
        return code

    # 9. the kernels line; "crop_ms_per_launch" is a kernel's device time
    # per launch in the profiled crop call of the raster path named
    def crop_ms(path, name):
        k = crop_kernels[path].get(name)
        return k["ms_per_launch"] if k else None

    src = "mosaic_tpu_torch/kernels/csrc/pip.cu"
    zsrc = "mosaic_tpu_torch/kernels/csrc/zonal.cu"
    fi, ff = fold["integer"], fold["float"]
    hj, hb, ht = heavy["join"], heavy["join_banded"], heavy["tile_banded"]
    kernels = {"kernels": [
        {"name": "pip_heavy_tiled", "route": "cuda", "source": src,
         "replaces": "mosaic_tpu/kernels/pip.py:492",
         "launches": heavy_launches + recheck_launches + stream_launches
         + rs_launches["pip_heavy_tiled"] + rs_fold_launches["pip_heavy_tiled"]
         + serve_launches["serve"] + serve_launches["router"]
         + serve_launches["knn_serve"] + serve_launches["epochs"]
         + x_launches["pip_heavy_tiled"] + xs_launches["pip_heavy_tiled"]
         + tj["pip_heavy_tiled"] + tz["pip_heavy_tiled"] + serve_launches["serve_tuned"]
         + mesh_launches["pip_heavy_tiled"] + fn_launches["pip_heavy_tiled"]
         + files_launches["pip_heavy_tiled"] + util_launches["pip_heavy_tiled"]
         + chaos_launches["pip_heavy_tiled"] + models_launches["pip_heavy_tiled"]
         + relaunch_launches,
         "launches_relaunch": relaunch_launches,
         "launches_models": models_launches["pip_heavy_tiled"],
         "launches_chaos": chaos_launches["pip_heavy_tiled"],
         "launches_utils": util_launches["pip_heavy_tiled"],
         "launches_files": files_launches["pip_heavy_tiled"],
         "launches_mesh": mesh_launches["pip_heavy_tiled"],
         "launches_functions": fn_launches["pip_heavy_tiled"],
         "launches_tune_join": tj["pip_heavy_tiled"],
         "launches_tune_zones_128": tz["pip_heavy_tiled"],
         "launches_serve_tuned": serve_launches["serve_tuned"],
         "launches_knn_serve": serve_launches["knn_serve"],
         "launches_epochs": serve_launches["epochs"],
         "launches_expr": x_launches["pip_heavy_tiled"],
         "launches_expr_scan": xs_launches["pip_heavy_tiled"],
         "launches_join": heavy_launches, "launches_exact_join": recheck_launches,
         "launches_serve": serve_launches["serve"],
         "launches_router": serve_launches["router"],
         "launches_stream": stream_launches,
         "launches_raster_stream": rs_launches["pip_heavy_tiled"],
         "launches_raster_stream_fold": rs_fold_launches["pip_heavy_tiled"],
         "launches_raster_zones_tiled": zl["pip_heavy_tiled"],
         "stream_ms_per_launch": stream_kernels.get("pip_heavy_tiled", {}).get(
             "ms_per_launch", "not measured"),
         "crop_ms_per_launch_zones_tiled": crop_ms("zones_tiled", "pip_heavy_tiled"),
         "match": heavy_ok, "max_abs_err": heavy_err,
         "ms": hj["ms"], "wrapper_ms": hj["wrapper_ms"], "plain_ms": hj["plain_ms"],
         "bound_ms": hj["bound_ms"], "bound_by": hj["bound_by"], "library_ms": None,
         "banded_ms": hb["ms"], "banded_bound_ms": hb["bound_ms"],
         "tile_ms": ht["ms"], "tile_bound_ms": ht["bound_ms"],
         "tile_bound_by": ht["bound_by"], "tile_points": ht["points"]},
        {"name": "pip_zone", "route": "cuda", "source": src,
         "replaces": "mosaic_tpu/kernels/pip.py:245", "launches": zone_launches,
         "launches_chaos": chaos_launches["pip_zone"],
         "match": zone_ok, "max_abs_err": zone_err,
         "ms": zone_dev_ms, "wrapper_ms": zone_ms, "plain_ms": zone_plain_ms,
         "bound_ms": zone_bound, "bound_by": zone_by, "library_ms": None},
        {"name": "zonal_tiled", "route": "cuda", "source": zsrc,
         "replaces": "mosaic_tpu/kernels/zonal.py:196",
         "launches": zl["zonal_tiled"] + rs_launches["zonal_tiled"] + tz["zonal_tiled"]
         + mesh_launches["zonal_tiled"] + files_launches["zonal_tiled"]
         + chaos_launches["zonal_tiled"],
         "launches_chaos": chaos_launches["zonal_tiled"],
         "launches_files": files_launches["zonal_tiled"],
         "launches_mesh": mesh_launches["zonal_tiled"],
         "launches_raster_zones_tiled": zl["zonal_tiled"],
         "launches_tune_zones_128": tz["zonal_tiled"],
         "match_128": k128["match"], "max_abs_err_128": k128["max_abs_err"],
         "ms_128": k128["ms"], "wrapper_ms_128": k128["wrapper_ms"],
         "plain_ms_128": k128["plain_ms"], "bound_ms_128": k128["bound_ms"],
         "bound_by_128": k128["bound_by"],
         "launches_raster_stream": rs_launches["zonal_tiled"],
         "crop_ms_per_launch_zones_tiled": crop_ms("zones_tiled", "zonal_tiled"),
         "match": small["match"] and tiled[2048]["match"] and k128["match"],
         "max_abs_err": max(small["max_abs_err"], tiled[2048]["max_abs_err"],
                            k128["max_abs_err"]),
         "ms": small["ms"], "wrapper_ms": small["wrapper_ms"], "plain_ms": small["plain_ms"],
         "bound_ms": small["bound_ms"], "bound_by": small["bound_by"],
         "library_ms": small["composite_ms"], "library": small["composite"],
         "pixels": small["pixels"], "ms_2048": tiled[2048]["ms"],
         "wrapper_ms_2048": tiled[2048]["wrapper_ms"],
         "bound_ms_2048": tiled[2048]["bound_ms"]},
        # a jnp segment reduce in the reference, not a Pallas kernel
        {"name": "zonal_seq_fold", "route": "cuda", "source": zsrc,
         "replaces": "mosaic_tpu/kernels/zonal.py:52",
         "launches": launches["zones_fold"]["zonal_fold"]
         + rs_fold_launches["zonal_fold"] + x_launches["zonal_fold"]
         + xg_launches["zonal_fold"] + xs_launches["zonal_fold"]
         + o_launches["zonal_fold"] + mesh_launches["zonal_fold"]
         + fn_launches["zonal_fold"] + files_launches["zonal_fold"]
         + chaos_launches["zonal_fold"],
         "launches_chaos": chaos_launches["zonal_fold"],
         "launches_files": files_launches["zonal_fold"],
         "launches_mesh": mesh_launches["zonal_fold"],
         "launches_functions": fn_launches["zonal_fold"],
         "launches_expr": x_launches["zonal_fold"],
         "launches_expr_grid": xg_launches["zonal_fold"],
         "launches_expr_scan": xs_launches["zonal_fold"],
         "launches_overlay": o_launches["zonal_fold"],
         "expr_tile_equal_to_cpu_lane": x_fold_equal, "expr_tile_ms": x_fold_ms,
         "overlay_equal_to_cpu_lane": o_fold_equal, "overlay_ms": o_fold_ms,
         "overlay_segments": o_segments,
         "launches_zones_fold": launches["zones_fold"]["zonal_fold"],
         "launches_grid": launches["grid"]["zonal_fold"],
         "launches_raster_stream": rs_fold_launches["zonal_fold"],
         "launches_raster_stream_crop": crop_fold_launches,
         "crop_ms_per_launch_zones_fold": crop_ms("zones_fold", "zonal_seq_fold"),
         "crop_ms_per_launch_grid": crop_ms("grid", "zonal_seq_fold"),
         "match": fold_ok and x_fold_equal and o_fold_equal,
         "max_abs_err": max(fi["max_abs_err"], ff["max_abs_err"], x_fold_err),
         "ms": fi["ms"], "wrapper_ms": fi["wrapper_ms"], "plain_ms": fi["plain_ms"],
         "bound_ms": fi["bound_ms"], "bound_by": fi["bound_by"], "library_ms": None,
         "data": "integer raster values (exact branch), 256x256 tile",
         "float_ms": ff["ms"], "float_wrapper_ms": ff["wrapper_ms"],
         "float_bound_ms": ff["bound_ms"], "float_bound_by": ff["bound_by"],
         "float_longest_sequential_run": ff["longest_sequential_run"],
         "dadd_latency_ns": dadd_ns},
    ]}
    print(card, flush=True)
    emit(kernels)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--serve-child"]:
        sys.exit(serve_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--relaunch-child"]:
        sys.exit(relaunch_child(*sys.argv[2:6]))
    if sys.argv[1:2] == ["--keep-trails"]:
        KEEP_TRAILS = os.path.abspath(sys.argv[2])
    try:
        code = main()
    finally:
        for p in SERVING + RELAUNCHING:
            p.stop()
            shutil.rmtree(p.dir, ignore_errors=True)
        shutil.rmtree(os.path.join(HERE, OBS_DIR), ignore_errors=True)
        shutil.rmtree(os.path.join(HERE, FILES_DIR), ignore_errors=True)
        shutil.rmtree(os.path.join(HERE, UTILS_DIR), ignore_errors=True)
        shutil.rmtree(os.path.join(HERE, MODELS_DIR), ignore_errors=True)
    sys.exit(code)
