#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole check (needs one card)

Phases (any failure exits non-zero, and no result line is printed):

1. device: requires ``torch.cuda.is_available()``; prints the card's name
   and ``nvidia-smi --query-gpu=name,power.limit``.
2. build: builds every kernel from the sources in this checkout, one nvcc
   per ``csrc`` source and per generated K4 unit (one for each flow set and
   neighbourhood this check runs, and the bf16 programs of phase 6g's flow
   sets: ``k4_steppers``), all started together,
   and prints each library's build seconds, whether it was cached, and
   ptxas's registers and spills (one line per instance of K4's paired
   bf16 walk, ``field_kernel16``).
3. each kernel against its plain version on the card, over dtypes, depths,
   neighborhoods and small and odd shapes, the main paths' own shapes
   included:
   - K1 (``dense_step_plain``): bit for bit, f32 nsteps 1, 2, 4, 8 and
     bf16 1, 2, 4, 8, 16, three neighbourhoods, on grids with no
     closed-form cell, grids whose edge tiles straddle d = nsteps beside
     interior tiles (ragged and not), a grid of unaligned rows, and the
     main path's 16384² (Moore, nsteps 1 and the deepest).
   - K3 (``composed_dense_step_plain``), each form asked for by name
     where the JAX package admits it (mxu: a 128-aligned block width): the
     vpu form (the binomial order in ``_rn`` intrinsics) bit for bit; the
     mxu form (tensor cores, 3×TF32 or two bf16 tap terms, another
     summation order) within ``1e-6·k·max|v|`` at f32 and one bf16 ulp of
     the value scale at bf16.
   - K6 (``fused_compute_plain``) and K7 (``fused_scatter_plain``): bit for
     bit at every k (K6 computes in the storage dtype with every operation
     rounded, in the plain version's order: the exact path's steps, and the
     tap table's products summed in row-major order from 0). K7 also alone
     (its persistent lane walk): counts 0, 1, some and K, rings 1 and 8,
     2-, 4- and 8-byte elements, 128- and 13-column tiles, on a state of
     NaN, by its bits.
   - K4 (``field_step_plain``; one generated unit per flow set and
     neighbourhood): bit for bit, f32 and bf16, nsteps 1, 4, 8 (and 16 at
     bf16), over config 4's flows, ``Coupled`` alone (the modulator must
     come back as the same tensor), an affine user flow, a row-reading flow
     (``cell_coords``), a 3-channel chain and one flow with every
     whitelisted operation, on grids holding -0.0 cells (corners, an edge,
     inside), and config 4 at the main path's 8192² (nsteps 1 and the
     deepest). The every-operation flow uses ``exp``, where CUDA's ``expf``
     and torch's may differ by an ulp: it is held to
     ``8·eps·nsteps·max|v|`` (plus one bf16 ulp of the scale at bf16).
   - K5 (``pipeline_step_plain``): bit for bit, f32 and bf16, nsteps 1, 4,
     8, Moore, von Neumann and a custom neighborhood, B 1, 3 and 8, on
     16×128 (auto block) and 48×384 with block (16, 128) (closed-form
     tiles inside), and the ensemble path's 8 × 4096² (Moore, nsteps 1
     and 8).
3c-halo. K6 and K7 at k=1 on ghost-padded shards, against their plain
   versions on every shard of a 3×3 block mesh (corner, edge and interior
   origins) and of 4 row stripes, each shard in a ring-1 padded buffer
   whose ring ``parallel.halo.refresh_rings`` fills from its neighbours, as
   the sharded runner does (held bit for bit against
   ``pad_with_halo_1d/2d``; random bands across the seams, so the rings
   are nonzero and ``ghost_flags`` wakes edge tiles), at the shard's global
   origin: f32, f64 and bf16, Moore, von Neumann and a custom
   neighbourhood, bit for bit. The shards' one step put together must
   equal one serial fused step on the whole grid bit for bit (and, at
   f32/f64, the plain dense step).
4. the K1 main path at full width: ``Model(Diffusion(0.1)).execute`` of a
   16384² grid through ``SerialExecutor("pallas")``, 64 steps, f32
   substeps=8, bf16 substeps=16 and f32 substeps=1 (the default, and the
   active runners' dense fallback); conservation checked, the launch
   counters set to 0 just before and read just after each run; the 512²
   chained checks against the plain version, bit for bit; K1's time per
   call against its bound (7 flops a cell-step on closed-form cells, k + 3
   on the exact path) and against ``conv2d`` 3x3 chained nsteps times, the
   same work (one step's time beside it; TF32 off; the port never calls
   it).
5. the active paths at full width, f32: the sparse state of
   ``bench.py::_active_workload`` (a zero 16384² grid with a centred square
   of side ``round(16384 * sqrt(frac))`` holding ``U(0.5, 2.0)`` values from
   a numpy seed) at activity 0.01, 0.05 and 0.15, through
   ``SerialExecutor("active")``, ``("active_fused", substeps=1)`` and
   ``("active_fused", substeps=8)`` (k=8), 20 steps after a warm-up, each
   run with the counters set to 0 just before and read just after:
   conservation, K6 and K7 launches == ``flags_fused``, K1 launches ==
   ``fallback_steps``; per row the cell-updates/s (host clock, median of
   three runs), mean active fraction, fallback steps, the time of one pass
   against K6 + K7 kernel time, and the peak device memory; K7 alone at
   each activity against its bound (its live tiles read and written once)
   and against ``index_copy_`` of the live tiles' cells (its library call;
   the port never calls it). Then the gates: one step at 0.01, ``active`` ==
   ``active_fused`` k=1 == the plain dense step, bitwise; a dense nonzero
   16384² state falls back every step and equals
   ``SerialExecutor("pallas", substeps=1)`` bitwise (K1 serves the
   fallback); a 1024² f64 state at 0.02, 12 steps, ``active`` ==
   ``active_fused`` == ``xla`` bitwise.
6. the composed path at full width: ``SerialExecutor("composed")`` at
   16384², f32 substeps=8 (k=8) and bf16 substeps=16 (k=16), 64 steps,
   once with ``"auto"`` (JAX's rule: the mxu form) and once with
   ``composed_variant="vpu"``, each run counted (the form's launches ==
   steps / k, and no other form's), conservation checked; on 512², each
   form against the K1 path under the derived tolerance below; K3's time
   per call and form against the function's bound (bytes, or the vpu
   form's operations), the form's own bound (vpu: its f32 operations; mxu:
   its tensor-core flops over the TF32 or bf16 peak), the plain version
   and one ``conv2d`` with the same table (TF32 off; the port never calls
   it).
6b. the field path at full width (BASELINE config 4): ``Model([Diffusion(0.1,
   "a"), Coupled(0.05, "a", "b"), Diffusion(0.2, "b")]).execute`` of an 8192²
   two-channel space of ``U(0.5, 2.0)`` from a numpy seed through
   ``SerialExecutor("pallas")``: f32 at substeps 1 and 8, bf16 at 1 and 16,
   64 steps each, the counters set to 0 just before and read just after
   each run (K4 launches == steps / substeps); conservation checked;
   ``SerialExecutor("auto")`` reports ``pallas``; on 512², 64 steps against
   the plain version chained call by call, bit for bit; cell-updates/s
   (CUDA events, median), K4 ms per call (f32 nsteps 1 and 8, bf16 1 and
   16) against its bound (computed from the lowered program), the plain
   version's and the ``impl="xla"`` step's times, and the peak device
   memory.
6c. ensemble serving at full width (``bench.py``'s serving row uncut): B = 8
   lanes of 4096², 8 steps, lane i = ``np.roll(base, 7·i, axis=0)`` of a
   ``U(0.5, 2.0)`` base from a numpy seed. Gates first, on lanes 0 and 7
   against per-scenario serial runs: ``impl="xla"`` with per-lane rates
   ``0.1·(1 + 0.05·i/7)`` bit for bit against ``SerialExecutor("xla")`` at
   f32; ``impl="pipeline"`` (rate 0.1) bit for bit against
   ``pipeline_step_plain`` chained call by call, at f32 and bf16; against
   ``SerialExecutor("pallas", substeps)`` (K1, which takes the closed form
   on cells where K5's 4096² edge tiles take the exact path) within phase
   4's drift bound; and within ``1e-6·steps`` of ``SerialExecutor("xla")``
   at f32. Then the rows, each
   through ``EnsembleService(buckets=buckets_for(8), retry="solo")``:
   pipeline f32 and bf16 at substeps 1 and 8, xla f32 and bf16; each row's
   first dispatch builds the runner, the next is the counted one (counters
   set to 0 just before, read just after: K5 launches == steps/substeps;
   the peak device memory above what the spaces held), then 5 warm
   dispatches timed with CUDA events (median): scenarios/s, cell-updates/s,
   occupancy, runner builds and cache hits. The sequential baselines: 8
   runs of ``SerialExecutor("xla")`` and 8 of ``SerialExecutor("pallas",
   substeps=8)`` (K1). One more pipeline substeps=8 dispatch and one f32
   K1 baseline run under ``torch.profiler``, device activity only: busy
   time against the call's CUDA-event time (the idle share) and device time
   by kind of work. A third baseline runs the 8 K1 scenarios through
   ``Model.execute``, which takes the totals, conservation check and report
   that a served scenario carries. K5 per call against its bound, its plain version and
   one ``conv2d`` 3×3 box over ``[B, 1, H, W]`` times nsteps (TF32 off; the
   port never calls it). A B = 3 dispatch into the 4-bucket (occupancy
   0.75), and a padded batch whose pad lane stays zero.
6c-serve. always-on serving at full width (``serving_phase``): (a) 16
   scenarios of 4096² (6c's lanes ``np.roll(base, 7·i)``, rate 0.1, 8
   steps) through ``AsyncEnsembleService(impl="pipeline", substeps=8,
   buckets=buckets_for(8), retry="solo")`` and the synchronous service,
   f32 and with ``compute_dtype=bfloat16``: bit for bit per ticket, the
   counts set to 0 just before the async run and read just after (K5
   launches == steps/substeps a dispatch, nothing else); (b) a pipeline
   flight, then an 8 × 4096² xla flight behind it on the stream: finishing
   the first returns while the second's event is pending; (c) ``run_soak``
   of 64 × 4096² at 90% of the synchronous service's measured rate, sync
   and async in turns on fresh services (``SOAK_ROUNDS`` rounds, medians),
   then one profiled round each: sustained scenarios/s, p50/p99 queue
   latency, occupancy, the device idle share (``soak_profile``); (d)
   ``bench.py::bench_service``'s row uncut (512², B = 8, 8 steps, xla,
   windows 2, donated, ``max_queue`` 256, 2000 scenarios, its chaos plan
   armed on the serving seams): async == sync bit for bit first, then every
   ticket served, quarantined, expired or shed, and ``donated_windows ==
   windows`` on every batch dispatch; (e) the CLI's ``--serve
   --serve-scenarios=16 --ensemble-impl=pipeline --substeps=8`` at 4096²
   with a complete ledger.
6d. the halo kernels K2, K3-halo and K4-halo against their plain versions
   (``halo_step_plain``, ``composed_halo_step_plain``,
   ``field_halo_step_plain``) on every shard of a 3×3 block mesh (corner,
   edge and interior origins) and of 4 row stripes, the rings exchanged
   from the neighbouring shards: f32 nsteps 1, 4, 8 and bf16 1, 4, 8, 16,
   three neighbourhoods (K4: its flow sets, on grids holding -0.0 cells).
   K2 and K4-halo are held bit
   for bit (K4-halo's ``every_op``, with exp, to K4's tolerance); K3-halo
   per form as K3 (vpu bit for bit, mxu to its tolerance), also on a 2×3
   mesh of 300 × 768 (shard rows at 150: origins that are not multiples
   of the mxu tiles) and of 300 × 390 (vpu alone: the JAX package refuses
   mxu at a width of 130). The shards put together must equal the dense
   kernel (K3: of the same form) on the whole grid bit for bit.
   K2 also on every 1024 × 1280 shard of a 2×2 mesh of 2048 × 2560, whose
   windows inside the shard take the cp.async path (f32 nsteps 1, 4, 8 and
   bf16 2, 8, 16, three neighbourhoods: every window height), bit for bit
   and put together against K1.
   Then the main paths' own shards: 8192² of the 16384² grid (K2 f32
   nsteps 8, K3-halo k 8 in each form) and 4096² of config 4's 8192²
   (K4-halo nsteps 8).
6e. the sharded main path at full width, every mesh position on the one
   card: ``Model(Diffusion(0.1)).execute`` of bench.py's 16384² grid through
   ``ShardMapExecutor(make_mesh_2d(2, 2), "pallas", halo_depth=8)`` and
   through 4 row stripes (``make_mesh(4)``, the reference's), 64 steps;
   ``"composed"`` at depth 8 on 2×2 in each form (``composed_variant``
   ``"vpu"`` and ``"mxu"``); config 4 at 8192² through the
   ``field`` plan on 2×2, depth 8; an f32 ``xla`` 2×2 run at 4096², 16
   steps; ``ModelRectangular.reference_scenario`` at f64. Each run with the
   counts set to 0 just before and read just after (one halo launch per
   shard per chunk); conservation checked on every f32 run. Gates, bit for
   bit: K2 against ``SerialExecutor("pallas", substeps=8)``, K3-halo
   against ``SerialExecutor("composed", substeps=8)`` of the same form
   (and only that form's kernel launched), K4-halo against
   serial K4, xla against serial xla, the reference scenario against the
   oracle, which must run the point subsystem (``impl == "point"``).
   Then point-flow models the point subsystem refuses (65 frozen flows,
   past ``MAX_FLOWS``, and Diffusion + Exponencial), 60×90 f64, 20 steps,
   serially (the full-grid ``point_flow_step``) and on 2×3 (the xla step's
   point scatter on the owning shard): ``impl == "xla"`` and bit for bit a
   NumPy oracle with the same rounding points.
   Rows: run ms (CUDA events, median of 3) and cell-updates/s, the
   kernel ms per call against its bound, the plain version's ms and (K2,
   K3-halo) one ``conv2d`` on the padded shard, launches per chunk, the
   exchange ms per chunk (the same run under ``halo_mode="zero"``, the JAX
   package's diagnostic), the assembly ms of the global tensors, serial K1
   beside it, and a ``torch.profiler`` view of one 2×2 run.
6f. the shard-local active path at full width, every shard on the one
   card: ``Model(Diffusion(0.1)).execute`` of ``bench.py::_active_workload``
   (16384², f32, activity 0.01, 0.05, 0.15, 20 steps) through
   ``ShardMapExecutor(mesh, "active" | "active_fused")`` on 2×2 blocks and
   on 4 row stripes, each run after a warm-up with the counts set to 0 just
   before and read just after (K6 launches == K7 launches ==
   ``flags_fused``, ``flags_fused + fallback_steps == steps · shards``; the
   plain ``"active"`` launches no kernel). Gates, bit for bit: each run
   against ``SerialExecutor`` with the same impl and against sharded
   ``xla``; an everywhere-nonzero 16384² state on 2×2 falls back on every
   (shard, step) and equals sharded ``xla``; a 1024² f64 state at 0.02, 12
   steps: sharded ``"active"`` == ``"active_fused"`` == serial ``xla`` on
   both meshes. Rows: run ms (CUDA events, median of 3), effective
   cell-updates/s, the serial runs of the same grid, mean active fraction,
   fallback steps, host reads a step, and K6 + K7 ms of one pass on shard
   (1, 1) of 2×2 (stripe 1) at the run's starting state against their
   plain versions (bit for bit) and their bound (each live tile's ring-1
   window read and its tile written, K7 each tile read and written; K7
   alone also against ``index_copy_``), the
   runner's host split (``backend_report["host_s"]``: ring refresh, flags,
   the count read, the passes); a ``torch.profiler`` idle share of the 2×2
   ``"active_fused"`` run at 0.01. Then the spread: the 2×2 rows at 0.01
   and 0.05 (both impls) and serial ``"active_fused"`` in turn,
   ``SPREAD_ROUNDS`` rounds, each with its host split and a probe of the
   host's time to enqueue one small op.
6g. bf16 interior math (``compute_dtype=bfloat16``; the TPU kernels' knob):
   each variant against its plain version (``compute_dtype=bfloat16``):
   K1 (f32 nsteps 1, 2, 8 and bf16 1, 4, 16, three neighbourhoods, on
   512 × 1024 at block (64, 128) and 336 × 1000 at (48, 200), where the
   bf16 rectangle's edges cut the kernel's tiles, and 16384² at JAX's
   blocks), K2 (the 2×2 shards of 2048 × 2560 and the 4 stripes of
   96 × 768, whose every tile is near, f32 nsteps 1 and 8, bf16 16), K1
   and K2 over windows of ±0, bf16 subnormals and ±inf (K1 on 225 × 999 at
   block (45, 333), whose bf16 rectangle starts at an odd row and column;
   K2 on the 2×2 shards of 1024 × 2048; f32 nsteps 8 and bf16 16; bit for
   bit, NaN compared by position), K3
   and K3-halo in each form (f32 k 1, 8 and bf16 4, 16), K4 and K4-halo
   on the paired walk (config 4, the 3-channel chain, ``Coupled`` alone,
   the affine flow and the every-operation flow, Moore, config 4 and the
   affine flow also over six offsets; f32 nsteps 1 and 8, bf16 1 and 16;
   on 512 × 1024 at block (64, 128) and on 225 × 640 at (45, 128), whose
   bf16 rectangle has an odd number of rows from an odd row; uniform
   values and values holding ±0, bf16 subnormals and ±inf, every flow
   set bit for bit, NaN compared by position; a call is two kernels, the
   f32 walk off the bf16 rectangle and the paired walk in it, counted as
   one launch)
   and K5 (2 × 1024² at block (128, 256), closed tiles inside; 8 × 4096²,
   none: the f32 result): bit for bit, K3 mxu to its tolerance; K3 mxu
   also over windows of ±0 and bf16 subnormals (and, outside the bf16
   rectangle, bit for bit the f32-compute kernel over the grid rounded to
   bf16) and of ±inf (held by position; the non-finite cells of each
   version recorded, ``inf_positions``). At one
   step K1/K2 are their f32 results. Then the main paths at full width,
   each run with the counts set to 0 just before and read just after:
   K1 16384² f32 substeps 8 and bf16 16, the composed path at k 8 and 16
   in both forms and at substeps 2 ``"auto"`` (k = 2: the vpu form,
   checked), config 4 at 8192² (f32 substeps 1 and 8, bf16 1 and
   16), the 2×2
   sharded K2, K3-halo (each form, bit for bit its serial composed run)
   and K4-halo (config 4 at 8192²) at depth 8 (every one of these rows
   made whole in a process apart from this one, the rows of a kernel
   family in one process, ``TRACED_GROUPS``, ``fresh_row`` /
   ``traced_rows``: its counted run is traced,
   and every K1/K2 and K3 vpu launch must have run the near launch's f32
   walk and the paired launch's walk once each and no other kernel of its
   family, ``two_launch_walk``; every K3 mxu launch the
   persistent walk once and no other K3 kernel, ``k3_mxu16``; every K4
   launch the f32 walk and the paired walk once each, ``k4_walk``; a
   counted run whose trace dropped one of its kernels is made again, at
   most ``TRACE_RETRIES`` times; the kernels line's ``launches``, ``walk``
   and ``kernels_per_launch`` come from that one counted run), the
   ensemble 8 × 4096² (no closed tile: the near launch alone) and 4 × 8192²
   (blocks (512, 2048): closed tiles in every lane: the near launch and the
   paired launch), each dispatch whole in a process apart, both in one
   (``_traced_k5_row``: every lane bit for bit its plain version, the
   counted dispatch traced, ``k5_walk``, and the near and paired launches'
   device ms from that trace; the source's plan held to the wrapper's
   mirrors, ``plan_of``); each run's mass change
   held below ``MASS_BF16`` of the total (the composed substeps 2 row
   instead bit for bit its plain version's calls: JAX's bf16 coefficients
   at k = 2 move more mass in 32 calls than that, 3.4% at 16384²). Each
   variant's kernel held
   against its plain version on the same inputs at the main path's shape
   (bit for bit, K3 mxu to its tolerance), its ms beside the f32-compute
   kernel's of this run, its plain version's, and the function's bound
   (bytes, or the operations of its cheapest form: bf16 cells at the
   paired bf16 rate ``BF16X2_OPS``, the rest at the f32 rate; K3 mxu's
   banded MMAs on the layout that runs are its form's bound,
   ``form_bound_ms``, ``mxu16_tensor_ms``; K4's paired form
   counts its instructions on the f32 halves at the f32 rate; K1/K2's
   and K3 vpu's paired form its walk's instructions over the windows of
   the tiling that runs, ``k1_paired_bound_ms``, ``k3_paired_bound_ms``).
6h. checkpoints, supervision and migration at full width
   (``checkpoint_phase``; files under ``chiprun_out/ckpt_6h``, deleted at
   the end; the peak bytes on disk printed), each run with the counts set
   to 0 just before and read just after: (a) ``run_checkpointed`` of
   phase 4's 16384² grid (rate 0.1, ``SerialExecutor("pallas",
   substeps=8)``, 64 steps, every 16, the full layout) cut after step 32
   and resumed from ``latest()`` by a fresh manager: bit for bit the
   uninterrupted run, K1 × 8; per save the device-to-host copy, CRC and
   write seconds and the file's bytes, the restore's seconds. (b)
   ``supervised_run`` of the same with ``exc`` on chunk 1, ``nan`` on
   chunk 2 and a ``torn`` step-48 checkpoint, run to 48, then restarted
   to 64 by a fresh manager (which falls back past 48 to 32): bit for bit
   the uninterrupted run, events ``exception, nonfinite``, one
   ``check_health`` transfer per checked chunk (6), K1 × 12. (c) the delta
   layout: ``bench.py::_active_workload``'s grid (16384² at 0.01, 128²
   tiles) through ``"active_fused"`` k=8 (K6 + K7), 64 steps, every 8,
   ``keyframe_every`` 8, beside the same run in the full layout; the chain
   cut at 56 with that delta record torn and resumed (it falls back to
   48): every committed step restores bit for bit the full layout's, every
   delta record's tiles come from ``last_dirty_tiles``; the keyframe's and
   each record's bytes and seconds. (d) ``ShardMapExecutor`` on 2×2 (one
   card), ``"pallas"`` depth 8 (K2), a ``halo`` fault on chunk 1: detected
   as conservation drift, rolled back, bit for bit the unperturbed sharded
   run, K2 × 40. (e) ``migrate_scenario`` of (c)'s grid serial K1 ↔ the 2×2
   K2 executor, 64 steps, handoff at 16, 8 in flight: bit for bit the
   serial run, ``0 < delta_bytes < keyframe_bytes``. (f)
   ``EnsembleService.migrate`` of a queued 4096² ticket between two
   pipeline services: bit for bit the ticket served in place, K5 × 1. (g)
   the CLI: ``--steps=64 --checkpoint-dir --checkpoint-every=16
   --chaos=exc:1`` at 16384², and the same with
   ``--checkpoint-layout=delta --impl=active_fused --substeps=8
   --blob=0.01``: each recovers one failure, its event ledger printed.
6i. the Flow IR at full width (``ir_phase``), each run with the counts
   set to 0 just before and read just after: (a) ``ir.library.diffusion``
   (rate 0.1, f32, 64 steps) on phase 4's 16384² grid through
   ``SerialExecutor("pallas", substeps=8)`` (K1), ``("composed",
   substeps=8)`` (K3, ``"auto"``: the mxu form),
   ``("active_fused", substeps=8)`` (K6/K7) and ``ShardMapExecutor`` on 2×2
   ``"pallas"`` depth 8 (K2), and 8 × 4096² through the ensemble's
   ``"pipeline"`` (K5, 8 steps, lane i rolled 7·i rows): each bit for bit
   ``Model([Diffusion(0.1)])`` on the same spaces, with the same launch
   counts, the run ms of each beside the flow model's (in turns); (b)
   ``gray_scott``, ``sir`` and ``predator_prey`` at 8192², f32,
   64 steps, through ``xla``, ``composed`` (substeps 4: k = 1 with the
   warning) and ``active``: bit for bit with each other, the budget
   reconciliation checked (``check_conservation=True``), no kernel
   launched, ``sir``'s active run skipping tiles and ``gray_scott``'s
   falling back every step; ms a step, cell-updates/s, the bound from
   bytes (``ir_bytes_bound_ms``) and the ``xla`` and ``active`` steps'
   device idle share and time by kind (``profile_dispatch`` of 4 steps, in
   a process apart, ``ir_profiles``); (c) ``gray_scott`` as 8 × 4096²
   through the ensemble's ``xla`` with per-lane F and k (``with_rates``),
   16 steps, each lane bit for bit its serial run; (d) ``gray_scott`` at
   8192² on 2×2 ``ShardMapExecutor("xla")``, 16 steps, bit for bit the
   serial run; (e) the CLI's ``--model=gray_scott`` at 8192², 16 steps,
   ``conserved``. ``ir_phase_main`` runs this phase alone.
6j. observability (``observability_phase``, in a process of its own,
   ``observability_main``; it prints its seconds): (a) phase 4's K1 run
   (16384², f32, substeps 8, 64 steps) under a ``Tracer``: bit for bit the
   run under ``Tracer(enabled=False)``, with as many implicit host syncs
   (``torch.cuda.set_sync_debug_mode("warn")``), spans ``model.execute`` ⊃
   ``executor.run``, ``model.report`` as JAX nests them, and
   ``tracing_overhead_frac`` (JAX's bench's: traced wall over untraced wall
   less one, the median of three rounds in turns, four runs an arm a
   round, after a round not kept) at most 0.02; ``chip_peaks()`` read
   from the card within 2% of 3.35 TB/s and 67 TFLOP/s, and
   ``stencil_roofline`` of K1's call, its bytes a call the bound's; (b) the same run under ``device_trace`` in a
   process apart (``device_trace_count``): the K1 kernels in the written
   Chrome trace equal the launches counted; (c) K2 on 2×2, depth 8: one
   ``shardmap.build`` span for the one build, bit for bit the serial K1
   run; (d) 16 × 4096² through ``AsyncEnsembleService`` (``pipeline``,
   K5) under ``run_soak(snapshot_path=, status_port=0)``, each submit in a
   span: every dispatch span parents under its submit context, every
   snapshot written validates, a ``GET /metrics`` scrape after the last
   result parses and its ``dispatches`` equals ``stats()``'s, the ledger is
   complete; (e) a supervised K1 run (every 16) with an ``exc`` fault at
   chunk 1: one ``supervise.failure`` instant, five ``supervise.chunk``
   spans, bit for bit the uninterrupted run; (g) the CLI: ``run --trace``
   at 16384² (the trace holds ``model.execute``), ``info --json``
   (``chip_peaks``, ``native_library``), ``--serve --status`` (its snapshot
   validates); (h) the native engine (``native.NativeExecutor``): the
   reference scenario (50 steps, f64) against the port's plain path on the
   card within 1e-10 and the oracle within 1e-12, and 1024²
   ``Diffusion(0.1)`` f32, 64 steps, against K1 within
   ``2·eps32·steps·max|v|``. Outside that process: (f) the build cache, a
   fresh process (``compile_cache_probe``, started before phase 2, so its
   nvcc runs beside the build) runs the CLI's K1 run with
   ``--compile-cache`` on an empty directory and builds ``fused_stencil``
   alone, and a second fresh process on that directory builds nothing
   (``build_info[...]["cached"]``), each printing its build seconds. 6k
   (g) runs in this long process just before (f)'s probes are read.
   6k. the degradation ladder and the fleet's formats
   (``ladder_formats_phase``; alone: ``ladder_phase_main``): (a)
   ``EnsembleScheduler(impl="pipeline", substeps=8, degrade_after=1,
   retry="solo")`` on 6c's 8 lanes of 4096² f32: a clean dispatch (K5
   launched, ``degraded_from`` None), then ``batch_exc``: one "degraded to
   'xla'" warning, every lane recovered on ``xla``, stamped ``impl: "xla"``,
   ``degraded_from: "pipeline"``, bit for bit a fresh ``xla`` scheduler, K5
   not launched after the rung; the async service's mid-fall gate on the
   card (shed while gated, reopened by the first clean completion); (b)
   ``impl="active_fused"`` at 4096², 0.05 activity: a clean dispatch
   launches K6 and K7, then ``active`` and ``xla`` after a fault each, each
   rung bit for bit that engine's own dispatch; (c) the TJ1 journal of 2
   K5-served lanes (submit and served records, the submit under a traced
   span) under ``protocolcheck.armed()`` (no violation), replayed and
   rebuilt on the card bit for bit K5's result, then torn at its last
   record (the verified prefix survives) and fenced (an epoch-0 handle
   refused after epoch 1 is declared); the write and replay seconds and the
   file bytes printed; (d) a served lane in one TW1 frame across a
   ``socketpair`` and a ``127.0.0.1`` TCP pair after the HMAC handshake,
   bit for bit, its bytes and seconds printed; (e) ``lockdep.armed()``
   around an ``AsyncEnsembleService(impl="pipeline")`` built inside the
   block, under ``run_soak`` of 16 × 4096²: no violation, K5 launched, the
   edges printed; (f) ``obs.timeline`` of (c)'s first ticket over the
   journal and the traced spans: complete, gap-free; (g) in this long
   process, after the earlier phases' profiles, ``Tracer.device_trace`` of
   phase 4's K1 run: every K1 launch's kernel in the written Chrome file
   (and, a finding, a profile without ``acc_events`` counted in its own
   file and in ``prof.events()``). Every phase that runs a
   scheduler or service on ``pipeline``, ``active`` or ``active_fused``
   without injecting a fault ends with ``ladder_guard``: ``degraded_from``
   None, ``impl_faults`` 0 and its kernel's counter advanced (the
   ``--serve`` CLI rows through ``cli_row_guard``).
7. the CLI (K1, active_fused, K4, ensemble pipeline, ``--mesh=2x2`` with
   K2 and with ``--impl=active_fused --blob=0.05``, whose row must show
   K6 + K7 launches == 2 · ``flags_fused``), the reference scenario through
   the CLI's scenario flags with ``--output`` (its merged file and dump
   byte for byte the oracle's values written out), and the 100×100
   ``Exponencial`` reference run at f64 against the port's own
   ``oracle.reference_run_np``, through the point subsystem
   (``impl == "point"``).
8. the kernels line (K5's near and paired launches each a row of their
   own at the ensemble's shapes; K7 with ``index_copy_`` as its library
   call), the card line, and the last line
   ``{"ok": true, "device": {...}}``. ``chip_smoke.json`` in the output
   directory keeps every row, every kernel case and the build record.
"""

from __future__ import annotations

import atexit
import contextlib
import io
import json
import math
import random
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

N = 16384          # main-path grid side (bench.py's headline grid)
N4 = 8192          # the field path's grid side (BASELINE config 4)
N5 = 4096          # the ensemble path's grid side (bench.py's serving row)
B5 = 8             # the ensemble path's lanes
STEPS5 = 8
SERVE_GATE = 16    # phase 6c-serve's gate: 16 scenarios of N5²
SERVE_SOAK = 64    # and its open-loop soak
SOAK_ROUNDS = 3    # the soak's unprofiled rounds a mode, in turns
#: bench.py::bench_service's row uncut: grid side, lanes, scenarios
SERVE_BENCH = (512, 8, 2000)
STEPS = 64
CKPT_STEPS = 64    # phase 6h's runs
CKPT_EVERY = 16    # its dense-layout cadence (a chunk, a save)
DELTA_EVERY = 8    # its delta-layout cadence and keyframe_every
ACTIVE_STEPS = 20
FRACS = (0.01, 0.05, 0.15)
SPREAD_ROUNDS = 3  # phase 6f's repeated 2x2 rows at 0.01 and 0.05
SEED = 1234
#: H100 SXM data-sheet peaks (NVIDIA): HBM bytes/s and f32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: and the dense tensor-core peaks (TF32, bf16)
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
#: paired bf16 arithmetic outside the tensor cores (add.rn.bf16x2,
#: mul.rn.bf16x2: two operations an instruction) at the issue rate of f32's
#: data-sheet 67 TFLOP/s: twice the f32 operation rate
BF16X2_OPS = 2 * F32_FLOPS
CUSTOM_OFFSETS = ((-1, 0), (1, 1), (0, -1))
#: phase 6g's traced main-path rows, ``(kind, dtype, substeps, steps)``, in
#: the groups that share a process (``traced_rows``): one process a kernel
#: family. A process took 8.7-9.7 s to set up and 10-13 s for its first
#: trace, the runs themselves ~0.1 s (one H100 80GB HBM3 at 700 W, PERF.md
#: §4), so the rows share processes rather than cut their steps
TRACED_GROUPS = (
    (("K1", "float32", 8, STEPS), ("K1", "bfloat16", 16, STEPS),
     ("K2", "float32", 8, STEPS)),
    (("K3", "float32", 8, STEPS), ("K3 vpu", "float32", 8, STEPS),
     ("K3", "bfloat16", 16, STEPS), ("K3 vpu", "bfloat16", 16, STEPS),
     ("K3 auto", "float32", 2, STEPS)),
    (("K3-halo vpu", "float32", 8, STEPS), ("K3-halo", "float32", 8, STEPS)),
    (("K4", "float32", 1, STEPS), ("K4", "float32", 8, STEPS),
     ("K4", "bfloat16", 1, STEPS), ("K4", "bfloat16", 16, STEPS),
     ("K4-halo", "float32", 8, STEPS)),
    ((f"K5 {B5}x{N5}", "float32", 8, STEPS5),
     (f"K5 4x{N4}", "float32", 8, STEPS5)),
)
#: how many times phase 6g makes again a counted main-path run whose trace
#: dropped one of its kernels (``two_launch_short``, ``k3_short``,
#: ``k4_short``)
TRACE_RETRIES = 3
#: the share of the total mass a main-path run with bf16 interior math may
#: move (JAX's semantics: constants rounded to bf16, every operation
#: rounded). H100 80GB HBM3 at 700.00 W, this script: at most 4.69e-3
#: (K3 vpu bf16 k=16, 64 steps of 16384²); a third of this limit
MASS_BF16 = 2.0 ** -6
#: the mxu bf16-interior kernel before its persistent walk (a block a tile,
#: windows staged element by element), ms a call on an H100 80GB HBM3 at
#: 700.00 W, as PERF.md §6 records them (PR 11's run L): printed beside this
#: run's figures, and in no JSON, since no run of this script measures them
MXU16_BEFORE_MS = {"K3 mxu float32 k=8": 3.427,
                   "K3 mxu bfloat16 k=16": 4.507,
                   "K3-halo mxu float32 k=8 shard (8192, 8192)": 1.072}
#: K5's bf16-interior call before its two launches (one kernel with both
#: branches), ms a call on an H100 80GB HBM3 at 700.00 W through this
#: script's phase 6g, as PERF.md §6 records them: printed beside this run's
#: figures, and in no JSON
K5_BF16_BEFORE_MS = {"K5 float32 ns=8 8x4096^2": 2.1482,
                     "K5 float32 ns=8 4x8192^2": 3.0266}
#: the vpu bf16-interior kernel before its two launches (one kernel with
#: both walks), ms a call on an H100 80GB HBM3 at 700.00 W, as PERF.md §6
#: records them (PR 14's run 13 of this script): printed beside this run's
#: figures, and in no JSON
VPU16_BEFORE_MS = {"K3 vpu float32 k=8": 1.9519,
                   "K3 vpu bfloat16 k=16": 4.5371,
                   "K3-halo vpu float32 k=8 shard (8192, 8192)": 0.7098}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def timed_ms(torch, fn, reps: int, warmup: int = 1) -> list[float]:
    """Per-call device times of ``fn`` from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def profile_dispatch(torch, fn, wall_ms: float) -> dict:
    """Where one call of ``fn`` spends its device time, from a
    ``torch.profiler`` trace of the device alone: the busy time (the union
    of kernel, copy and memset intervals), the device time and operation
    count by kind of work, and the idle share against ``wall_ms``, the
    call's unprofiled CUDA-event time (the profiler's own host cost
    stretches the traced call, so only device durations are taken from
    it). A profiler that sees no device activity gives ``{"error": ...}``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type.name == "CUDA"
                   and e.time_range.end > e.time_range.start)
    if not spans:
        return {"error": "the profiler recorded no device activity"}
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3
    kinds: dict[str, list] = {}
    for s, e, name in spans:
        low = name.lower()
        kind = ("K5" if "pipeline_" in low else
                "K6" if "fused_compute" in low else
                "K7" if "fused_scatter" in low else
                "K2" if "fused_stencil_halo" in low else
                "K3-halo" if "composed" in low and "halo" in low else
                "K3" if "composed" in low else
                # one generated kernel per flow set serves K4 and K4-halo
                "K4" if "mm_field" in low else
                "K1" if "fused_stencil" in low else
                "reduction" if "reduce" in low else
                "copy" if "memcpy" in low or "copy" in low else
                "memset" if "memset" in low else "elementwise/other")
        k = kinds.setdefault(kind, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "device_by_kind": {k: {"ops": n, "ms": ms}
                               for k, (n, ms) in kinds.items()}}


def traced_kernels(torch, fn, with_ms: bool = False) -> tuple:
    """What ``fn()`` returns, and the device kernels it launched, by name
    with their counts, from a ``torch.profiler`` trace (``with_ms``: and
    each name's device ms, summed). The work is queued
    behind a spin of the device (``torch.cuda._sleep``), and the trace is
    held open past its end, behind a second spin: the profiler keeps only
    the kernels whose device times fall in its host window, and its device
    and host clocks do not line up, so a short window's first or last
    kernels can go missing otherwise. Only counts, names and device
    durations are taken from it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        torch.cuda._sleep(100_000_000)  # ~50 ms of the device
        got = fn()
        torch.cuda._sleep(100_000_000)
        torch.cuda.synchronize()
        time.sleep(0.05)
    names: dict[str, int] = {}
    ms: dict[str, float] = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            names[e.name] = names.get(e.name, 0) + 1
            ms[e.name] = ms.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
    return (got, names, ms) if with_ms else (got, names)


def k4_walk(names: dict, launched: int, what: str) -> dict:
    """Which K4 walks a counted main-path run of the bf16 interior math
    ran, from its trace (``traced_kernels``): every launch the f32 walk off
    the rectangle (``field_kernel_near``) and the paired walk in it
    (``field_kernel16`` with the bf16 program), and no other K4 kernel.
    Fails otherwise, and when the trace holds no K4 kernel. Returns the
    walk, the kernels a launch (the K4 kernels over the launches counted)
    and the counts."""
    k4 = {n: c for n, c in names.items() if "mm_field::" in n}
    paired = sum(c for n, c in k4.items()
                 if "field_kernel16" in n and "ProgramBf16" in n)
    near = sum(c for n, c in k4.items() if "field_kernel_near" in n)
    check(bool(k4), f"{what}: the trace shows no K4 kernel "
                    f"({len(names)} kernel names traced)")
    check(launched > 0 and paired == launched and near == launched
          and sum(k4.values()) == paired + near,
          f"{what}: {launched} launches ran the K4 kernels {k4}, not the "
          "f32 walk and the paired walk once each")
    return {"walk": "paired", "kernels_per_launch": sum(k4.values())
            / launched, "k4_kernels": k4}


def k4_short(names: dict, launched: int) -> bool:
    """A K4 bf16-interior trace that shows fewer near or paired walks than
    the launches counted, and no other K4 kernel (kernels the profiler
    dropped)."""
    k4 = {n: c for n, c in names.items() if "mm_field::" in n}
    paired = sum(c for n, c in k4.items()
                 if "field_kernel16" in n and "ProgramBf16" in n)
    near = sum(c for n, c in k4.items() if "field_kernel_near" in n)
    return min(paired, near) < launched and sum(k4.values()) == paired + near


def k3_short(names: dict, launched: int) -> int:
    """The walks a K3 mxu bf16-interior trace shows when they are fewer
    than the launches counted and the trace holds no other K3 kernel (a
    kernel the profiler dropped); else 0."""
    k3 = {n: c for n, c in names.items() if "composed_" in n}
    walk = sum(c for n, c in k3.items() if "composed_mxu16" in n)
    return walk if walk < launched and sum(k3.values()) == walk else 0


def k3_mxu16(names: dict, launched: int, what: str) -> dict:
    """Which K3 kernels a counted main-path run of the mxu form's bf16
    interior math ran, from its trace (``traced_kernels``): the persistent
    walk (``composed_mxu16_kernel`` / ``composed_mxu16_halo_kernel``) once
    a launch, and no other K3 kernel. Fails otherwise. Returns the instance
    and the counts."""
    k3 = {n: c for n, c in names.items() if "composed_" in n}
    walk = sum(c for n, c in k3.items() if "composed_mxu16" in n)
    check(launched > 0 and walk == launched and sum(k3.values()) == walk,
          f"{what}: {launched} launches ran the K3 kernels {k3} ({walk} of "
          "the persistent bf16-interior walk), not the walk once each")
    halo = any("composed_mxu16_halo_kernel" in n for n in k3)
    return {"instance": ("composed_mxu16_halo_kernel" if halo
                         else "composed_mxu16_kernel"), "k3_kernels": k3}


#: the kernels of each two-launch bf16-interior walk, by their names in a
#: trace: the family's, the near launch's, the paired launch's
TWO_LAUNCHES = {"K1/K2": ("fused_stencil", "_near_kernel", "_bf16_kernel"),
                "K3": ("composed_", "_near_kernel", "composed_vpu16_")}


def _two_launches(names: dict, family: str) -> tuple:
    """A trace's kernels of ``family`` (``TWO_LAUNCHES``) by name, and its
    near and paired launches."""
    fam, near_key, paired_key = TWO_LAUNCHES[family]
    ks = {n: c for n, c in names.items() if fam in n}
    return (ks, sum(c for n, c in ks.items() if near_key in n),
            sum(c for n, c in ks.items() if paired_key in n))


def two_launch_walk(names: dict, launched: int, what: str,
                    family: str) -> dict:
    """Which kernels a counted main-path run of a two-launch bf16-interior
    walk ran, from its trace (``traced_kernels``): every launch the near
    launch's f32 walk over the bands (K1/K2: ``fused_stencil_near_kernel``
    / ``_halo_near_kernel``; K3 vpu: ``composed_vpu_near_kernel`` /
    ``_halo_near_kernel``) and the paired launch's walk over the rectangle
    (``fused_stencil_bf16_kernel`` / ``_halo_bf16_kernel``;
    ``composed_vpu16_kernel`` / ``_halo_kernel``) once each, and no other
    kernel of the family. Fails otherwise. Returns the walk, the kernels a
    launch and the counts."""
    ks, near, paired = _two_launches(names, family)
    check(launched > 0 and paired == launched and near == launched
          and sum(ks.values()) == paired + near,
          f"{what}: {launched} launches ran the {family} kernels {ks}, not "
          "the near walk and the paired walk once each")
    return {"walk": "row pairs", "kernels_per_launch": sum(ks.values())
            / launched, "kernels": ks}


def two_launch_short(names: dict, launched: int, family: str) -> bool:
    """A two-launch trace that shows fewer paired or near kernels than the
    launches counted, and no other kernel of the family (a kernel the
    profiler dropped)."""
    ks, near, paired = _two_launches(names, family)
    return min(paired, near) < launched and sum(ks.values()) == paired + near


def traced_rows(spec: str) -> None:
    """Phase 6g's traced main-path rows of one group (``TRACED_GROUPS``),
    whole, one after the other in a process of its own (``fresh_row``
    starts it): ``spec`` is the group as JSON, a list of ``[kind, dtype,
    substeps, steps]``. Prints one JSON line a row (``"spec"``, ``"row"``,
    ``"attempts"``)."""
    import torch

    for kind, dname, sub, steps in json.loads(spec):
        fn = _traced_k5_row if kind.startswith("K5") else _traced_row
        got = fn(kind, dname, str(sub), str(steps))
        print(json.dumps({"spec": [kind, dname, sub, steps], **got}),
              flush=True)
        torch.cuda.empty_cache()


def _traced_row(kind: str, dname: str, sub: str, steps: str) -> dict:
    """One bf16-interior main-path row of phase 6g, whole (``traced_rows``
    runs it): the entry point of ``kind`` (K1, K2
    on the 2x2 mesh, K3 ``"auto"`` (mxu at k 8 and 16, vpu at k 2), K3
    vpu, K3-halo mxu and vpu on 2x2, K4 and K4-halo on 2x2 with config 4)
    on a grid made from ``SEED``; one uncounted run; then the counted run,
    traced (every count to 0 just before, read just after; a trace that
    dropped one of its kernels, ``two_launch_short`` / ``k3_short`` /
    ``k4_short``, and its counted run are made again, at
    most ``TRACE_RETRIES`` times); that run's result checked (finite, its
    mass change, the form the composed executor resolved; K3-halo: bit for
    bit the serial composed run); then the run's ms (CUDA events, median of
    3). Returns the row (with ``process_marks``: seconds from its start to
    the end of its set-up, first run, traced runs, checks and timing) and
    the attempts' counts and kernel names."""
    t0 = time.perf_counter()
    marks = {}
    import torch

    import mpi_model_tpu_torch as mt
    from mpi_model_tpu_torch.ops import composed_stencil as cs
    from mpi_model_tpu_torch.ops import field_stencil as k4
    from mpi_model_tpu_torch.ops import fused_stencil as fs
    from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d

    sub, steps = int(sub), int(steps)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    BF = torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if kind.startswith("K4"):
        vals = {c: (0.5 + 1.5 * torch.rand((N4, N4), generator=gen,
                                           device=dev)).to(
                                               getattr(torch, dname))
                for c in ("a", "b")}
        space = mt.CellularSpace.create(N4, N4, {"a": 1.0, "b": 1.0},
                                        dtype=dname).with_values(vals)
        model = mt.Model(config4_flows(mt))
    else:
        x = (1.0 + 0.1 * torch.rand((N, N), generator=gen, device=dev)).to(
            getattr(torch, dname))
        space = mt.CellularSpace.create(N, N, 1.0, dtype=dname).with_values(
            {"value": x})
        model = mt.Model(mt.Diffusion(0.1))
    mesh = make_mesh_2d(2, 2, devices=[dev] * 4)
    ex, counter, short = {
        "K1": (mt.SerialExecutor("pallas", substeps=sub, compute_dtype=BF),
               fs.launches, lambda n, c: two_launch_short(n, c, "K1/K2")),
        "K2": (ShardMapExecutor(mesh, "pallas", halo_depth=sub,
                                compute_dtype=BF),
               fs.halo_launches,
               lambda n, c: two_launch_short(n, c, "K1/K2")),
        "K3": (mt.SerialExecutor("composed", substeps=sub,
                                 composed_variant="auto", compute_dtype=BF),
               lambda: cs.launches("mxu"), k3_short),
        "K3 auto": (mt.SerialExecutor("composed", substeps=sub,
                                      composed_variant="auto",
                                      compute_dtype=BF),
                    lambda: cs.launches("vpu"),
                    lambda n, c: two_launch_short(n, c, "K3")),
        "K3 vpu": (mt.SerialExecutor("composed", substeps=sub,
                                     composed_variant="vpu",
                                     compute_dtype=BF),
                   lambda: cs.launches("vpu"),
                    lambda n, c: two_launch_short(n, c, "K3")),
        "K3-halo": (ShardMapExecutor(mesh, "composed", halo_depth=sub,
                                     composed_variant="mxu",
                                     compute_dtype=BF),
                    lambda: cs.halo_launches("mxu"), k3_short),
        "K3-halo vpu": (ShardMapExecutor(mesh, "composed", halo_depth=sub,
                                         composed_variant="vpu",
                                         compute_dtype=BF),
                        lambda: cs.halo_launches("vpu"),
                        lambda n, c: two_launch_short(n, c, "K3")),
        "K4": (mt.SerialExecutor("pallas", substeps=sub, compute_dtype=BF),
               k4.launches, k4_short),
        "K4-halo": (ShardMapExecutor(mesh, "pallas", halo_depth=sub,
                                     compute_dtype=BF),
                    k4.halo_launches, k4_short),
    }[kind]

    def run():
        return model.execute(space, ex, steps=steps, check_conservation=False)

    marks["setup_s"] = time.perf_counter() - t0
    run()
    marks["first_run_s"] = time.perf_counter() - t0
    attempts = []
    for _ in range(1 + TRACE_RETRIES):
        fs.reset_launches()
        cs.reset_launches()
        k4.reset_launches()
        (res, rep), names = traced_kernels(torch, run)
        attempts.append({"launches": counter(), "kernels": names})
        if not short(names, attempts[-1]["launches"]):
            break
    marks["traced_s"] = time.perf_counter() - t0
    total = sum(abs(float(t)) for t in rep.initial_total.values())
    row = {"impl": rep.impl, "steps": steps,
           "launches": attempts[-1]["launches"],
           "conservation_error": float(rep.conservation_error()),
           "mass_allowed": MASS_BF16 * total,
           "finite": all(bool(torch.isfinite(v).all())
                         for v in res.values.values())}
    if kind.startswith("K3"):
        row["form"] = (rep.backend_report or {}).get("form")
    if kind == "K3 auto":
        # the run bit for bit the plain version's calls (JAX's semantics at
        # k = 2, 32 calls of the bf16 coefficients, move the mass by more
        # than MASS_BF16: this run is held to the reference, the mass the
        # reference moves recorded beside its own)
        v = space.values["value"]
        for _ in range(steps // sub):
            v = cs.composed_dense_step_plain(v, 0.1, sub, variant="vpu",
                                             compute_dtype=BF)
        row["bitwise_plain"] = torch.equal(res.values["value"], v)
        row["plain_conservation_error"] = abs(
            float(v.double().sum())
            - float(space.values["value"].double().sum()))
        del v
    if kind.startswith("K3-halo"):
        # chunk for chunk (depth ``sub``) the serial composed run
        serial, _ = model.execute(
            space, mt.SerialExecutor("composed", substeps=sub,
                                     composed_variant=(
                                         "vpu" if kind.endswith("vpu")
                                         else "mxu"),
                                     compute_dtype=BF),
            steps=steps, check_conservation=False)
        row["bitwise_serial"] = torch.equal(res.values["value"],
                                            serial.values["value"])
        del serial
    del res
    marks["checks_s"] = time.perf_counter() - t0
    run_ms = statistics.median(timed_ms(
        torch, lambda: ex.run_model(model, space, steps), reps=3))
    marks["timed_s"] = time.perf_counter() - t0
    cells = sum(t.numel() for t in space.values.values()
                if t.is_floating_point())
    row.update(run_ms_median=run_ms,
               cell_updates_per_s=cells * steps / (run_ms / 1e3),
               process_marks=marks)
    return {"row": row, "attempts": attempts}


def k5_kernels(names: dict) -> tuple:
    """A trace's K5 kernels by name, and its near launches
    (``pipeline_near_kernel``) and paired launches
    (``pipeline_bf16_kernel``)."""
    ks = {n: c for n, c in names.items() if "pipeline_" in n}
    return (ks, sum(c for n, c in ks.items() if "pipeline_near_kernel" in n),
            sum(c for n, c in ks.items() if "pipeline_bf16_kernel" in n))


def k5_walk(names: dict, launched: int, closed: bool, what: str) -> dict:
    """Which K5 kernels a counted bf16-interior dispatch ran, from its
    trace: every launch the near launch once and, where the lanes have
    closed tiles, the paired launch once; no other K5 kernel (none with
    both branches, ``pipeline_stencil_kernel``). Fails otherwise."""
    ks, near, paired = k5_kernels(names)
    check(launched > 0 and near == launched
          and paired == (launched if closed else 0)
          and sum(ks.values()) == near + paired,
          f"{what}: {launched} launches ran the K5 kernels {ks}, not the "
          "near launch" + (" and the paired launch" if closed else "")
          + " once each")
    return {"kernels_per_launch": sum(ks.values()) / launched,
            "kernels": ks}


def _traced_k5_row(kind: str, dname: str, sub: str, steps: str) -> dict:
    """Phase 6g's K5 row (``kind`` ``"K5 BxS"``: B lanes of S²), whole
    (``traced_rows`` runs it): ``EnsembleService(impl="pipeline", substeps,
    compute_dtype=bfloat16)`` over lanes ``np.roll``-ed from one
    ``U(0.5, 2.0)`` base made from ``SEED`` (storage ``dname``); one
    uncounted dispatch; then the counted dispatch, traced (the count to 0
    just before, read just after; a trace that dropped one of its kernels
    and its dispatch made again, at most ``TRACE_RETRIES`` times), each
    lane held bit for bit to ``pipeline_step_plain(..., compute_dtype)``
    chained call by call; the near and paired launches' device ms from
    that trace; then the dispatch ms (CUDA events, median of 5). Returns
    the row and the attempts."""
    import torch

    import mpi_model_tpu_torch as mt
    from mpi_model_tpu_torch.ops import pipeline_stencil as k5

    B, side = (int(x) for x in kind.split()[1].split("x"))
    sub, steps = int(sub), int(steps)
    BF = torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = 0.5 + 1.5 * torch.rand((side, side), generator=gen, device=dev)
    tdt = getattr(torch, dname)
    spaces = [mt.CellularSpace.create(side, side, 1.0, dtype=dname)
              .with_values({"value": torch.roll(base, 7 * i, 0).to(tdt)})
              for i in range(B)]
    del base
    svc = mt.EnsembleService(mt.Model(mt.Diffusion(0.1)), steps=steps,
                             impl="pipeline", substeps=sub,
                             buckets=mt.buckets_for(B), compute_dtype=BF,
                             check_conservation=False)

    def dispatch():
        ts = [svc.submit(s) for s in spaces]
        svc.flush()
        return [svc.result(t)[0].values["value"] for t in ts]

    dispatch()
    blk = k5.pipeline_block((side, side), sub)
    closed = bool(k5.interior_mask((side, side), blk, sub).any())
    attempts = []
    for _ in range(1 + TRACE_RETRIES):
        k5.reset_launches()
        outs, names, ms = traced_kernels(torch, dispatch, with_ms=True)
        launched = k5.launches()
        attempts.append({"launches": launched, "kernels": names})
        _, near, paired = k5_kernels(names)
        if min(near, paired if closed else near) >= launched:
            break
    want = torch.stack([s.values["value"] for s in spaces])
    for _ in range(steps // sub):
        want = k5.pipeline_step_plain(want, 0.1, nsteps=sub,
                                      compute_dtype=BF)
    same = all(torch.equal(o, w) for o, w in zip(outs, want))
    del want, outs

    def mean_ms(key):
        got = [(ms[n], c) for n, c in names.items() if key in n]
        return (sum(m for m, _ in got) / sum(c for _, c in got)
                if got else None)

    ladder_guard(svc.stats(), launched, f"6g the traced {kind} row")
    disp = statistics.median(timed_ms(torch, dispatch, reps=5))
    row = {"launches": launched, "bit_for_bit": same, "closed": closed,
           "closed_cells_per_lane": int(k5.interior_mask(
               (side, side), blk, sub).sum()),
           "near_ms": mean_ms("pipeline_near_kernel"),
           "paired_ms": mean_ms("pipeline_bf16_kernel"),
           "dispatch_ms_median": disp, "scenarios_per_s": B / (disp / 1e3)}
    return {"row": row, "attempts": attempts}


#: the paired walk's instructions a pair and step, as the kernel runs them
#: (fused_stencil.cu::paired_step): pass 1 two prmt and two adds (the band),
#: a quarter of a 16-byte store; pass 2 two selects, two adds, two
#: multiplies and an add, a quarter of a 16-byte load; and its two shuffles
PAIRED_ALU = 2 + 2 + 0.25 + 2 + 2 + 2 + 1 + 0.25
PAIRED_SHFL = 2
#: lane-instructions a second: 132 SMs x 128 lanes at the clock of the data
#: sheet's f32 rate (67 TFLOP/s counts an FMA as two); shuffles 32 lanes a
#: clock an SM
ISSUE_PER_S = F32_FLOPS / 2
SHFL_PER_S = ISSUE_PER_S / 4


def k1_paired_bound_ms(fs, shape, dtype, nsteps: int, origin=(0, 0),
                       global_shape=None) -> tuple[float, str]:
    """Least time of one K1 (K2) bf16-interior call in the form that runs:
    the paired launch's windows (``fs.region_tiles`` over the rectangle at
    ``fs.paired_rows``' rows, every window pair a step) at the paired
    walk's instructions (``PAIRED_ALU`` at the issue rate, ``PAIRED_SHFL``
    at the shuffle rate, whichever is larger), plus the near launch's f32
    operations at the f32 rate; against the bytes (each cell read and
    written once); whichever is larger. The split and the tilings counted
    are held to the source's own (``fs.kernel_plan``): the bound counts the
    layout that runs."""
    import torch

    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS

    h, w = shape
    rect = fs.kernel_rect(shape, dtype, None, nsteps, torch.bfloat16, origin,
                          global_shape)
    local = (rect[0] - origin[0], rect[1] - origin[0], rect[2] - origin[1],
             rect[3] - origin[1])
    inner, bands = fs.bf16_regions(shape, local)
    rows = fs.window_rows(nsteps, MOORE_OFFSETS)
    rows16 = fs.paired_rows(nsteps, MOORE_OFFSETS)
    mine = (rows, [(*inner, len(fs.region_tiles(inner, rows16, nsteps))),
                   *((*b, len(fs.region_tiles(b, rows, nsteps)))
                     for b in bands)])
    source = fs.kernel_plan(shape, rect, nsteps, MOORE_OFFSETS, origin,
                            global_shape)
    check(source == mine, f"K1/K2 bf16 interior {shape} at {origin}, "
                          f"nsteps={nsteps}: the source launches {source}, "
                          f"fused_stencil.py's mirrors say {mine}")
    pairs = source[1][0][4] * rows16 // 2 * 256
    paired_s = pairs * nsteps * max(PAIRED_ALU / ISSUE_PER_S,
                                    PAIRED_SHFL / SHFL_PER_S)
    cells = h * w
    inner16 = (inner[1] - inner[0]) * (inner[3] - inner[2])
    closed = closed_cells(shape, nsteps, origin, global_shape)
    near_flops = nsteps * (7 * (closed - inner16) + 11 * (cells - closed))
    itemsize = 2 if dtype == torch.bfloat16 else 4
    return larger(2 * cells * itemsize / HBM_BYTES_PER_S * 1e3,
                  (paired_s + near_flops / F32_FLOPS) * 1e3)


#: K3 vpu's paired walk a pair and step (mm::paired_step with the
#: accumulator in its finish): K1's walk less its finish's two multiplies
#: and add; on the accumulator's pairs a multiply and an add
VPU16_ALU = PAIRED_ALU - 3
VPU16_ACC = 2


def k3_paired_bound_ms(cs, fs, shape, dtype, k: int, origin=(0, 0),
                       global_shape=None) -> tuple[float, str]:
    """Least time of one K3 (K3-halo) vpu bf16-interior call in the form
    that runs: the paired launch's windows (the rectangle's tiles at
    ``cs.paired_rows``, every window pair a step) at the paired walk's
    instructions (``VPU16_ALU`` a pair, ``VPU16_ACC`` on the accumulator's
    pairs, at the issue rate; ``PAIRED_SHFL`` at the shuffle rate;
    whichever is larger), plus the near launch's f32 operations (the vpu
    form's, ``cs.vpu_ops``, off the rectangle) at the f32 rate; against the
    bytes (each cell read and written once); whichever is larger. The split
    and the tilings counted are held to the source's own
    (``cs.kernel_plan``): the bound counts the layout that runs."""
    import torch

    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS

    h, w = shape
    rect = fs.kernel_rect(shape, dtype, None, k, torch.bfloat16, origin,
                          global_shape)
    mine = cs.plan_of(shape, rect, k, MOORE_OFFSETS, origin)
    source = cs.kernel_plan(shape, rect, k, dtype, MOORE_OFFSETS, origin,
                            global_shape)
    check(source == mine, f"K3 vpu bf16 interior {shape} at {origin}, k={k}: "
                          f"the source launches {source}, "
                          f"composed_stencil.py's mirrors say {mine}")
    _, (rows16, off16), regions = source
    p = rows16 // 2
    per_pair = max((VPU16_ALU + VPU16_ACC * (p - off16) / p) / ISSUE_PER_S,
                   PAIRED_SHFL / SHFL_PER_S)
    paired_s = regions[0][4] * p * 256 * k * per_pair
    inner = regions[0]
    inner16 = (inner[1] - inner[0]) * (inner[3] - inner[2])
    near_ops = (cs.vpu_ops(shape, k, origin=origin, global_shape=global_shape)
                - inner16 * (4 * k + 2 * k + 1))
    itemsize = 2 if dtype == torch.bfloat16 else 4
    return larger(2 * h * w * itemsize / HBM_BYTES_PER_S * 1e3,
                  (paired_s + near_ops / F32_FLOPS) * 1e3)


def k7_library(torch, act, padded, upd, ids, n: int, plan, ring: int):
    """K7's function as one PyTorch call, for its ``library_ms``: the live
    lanes' tiles copied into the padded state by ``index_copy_`` over its
    flat cells, their flat indices built beforehand (not timed). The port
    never calls it. Returns the call."""
    rows, cols = act.window_index(ids, plan, n, 0, ring)
    idx = (rows[:, :, None] * padded.shape[1] + cols[:, None, :]).reshape(-1)
    src = upd[:n].reshape(-1)
    flat = padded.view(-1)
    return lambda: flat.index_copy_(0, idx, src)


def print_profile(what: str, prof: dict) -> None:
    if "error" in prof:
        print(f"{what} profile: not measured ({prof['error']})", flush=True)
        return
    kinds = ", ".join(f"{k} {v['ms']:.3f} ({v['ops']} ops)" for k, v in
                      sorted(prof["device_by_kind"].items()))
    print(f"{what} profile: device busy {prof['device_busy_ms']:.3f} of "
          f"{prof['wall_ms']:.3f} ms (idle share {prof['idle_share']:.3f}); "
          f"{kinds}", flush=True)


def closed_cells(shape, nsteps: int, origin=(0, 0), global_shape=None) -> int:
    """Cells of the ``[h, w]`` region at global ``origin`` that K1/K2 compute
    in closed form: distance to the global grid's edge above ``nsteps``."""
    (h, w), (r0, c0) = shape, origin
    gh, gw = global_shape if global_shape is not None else shape
    rows = max(0, min(r0 + h, gh - 1 - nsteps) - max(r0, nsteps + 1))
    cols = max(0, min(c0 + w, gw - 1 - nsteps) - max(c0, nsteps + 1))
    return rows * cols


def bound_ms(shape, itemsize: int, nsteps: int, k: int, origin=(0, 0),
             global_shape=None) -> tuple[float, str]:
    """Least time for one K1 (K2) call: the grid (shard) read once and
    written once over HBM bandwidth, or the f32 flops of the form each cell
    takes over the f32 peak, whichever is larger: 7 a cell-step in closed
    form (two band adds, two nine adds, two multiplies and an add), k + 3
    on the exact path (share: multiply and divide; gather: k - 1 adds;
    keep-multiply and add)."""
    cells = shape[0] * shape[1]
    inner = closed_cells(shape, nsteps, origin, global_shape)
    bytes_ms = 2 * cells * itemsize / HBM_BYTES_PER_S * 1e3
    flops = nsteps * (7 * inner + (k + 3) * (cells - inner))
    return larger(bytes_ms, flops / F32_FLOPS * 1e3)


def ptxas_summary(text: str) -> list[tuple[str, str, str]]:
    """ptxas's report of one library, one ``(function, registers, spill)``
    row per kernel and per non-inlined function, names demangled enough to
    read (the template arguments kept)."""
    rows, fn, spill = [], None, ""
    for line in text.splitlines():
        m = (re.search(r"Compiling entry function '(\w+)'", line)
             or re.search(r"Function properties for (\w+)", line))
        if m:
            if fn is not None and fn != m.group(1) and spill:
                rows.append((fn, "the caller's", spill))  # not inlined
                spill = ""
            fn = m.group(1)
        elif "spill stores" in line:
            spill = line.split("bytes stack frame,")[-1].strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            rows.append((fn, m.group(1), spill))
            fn, spill = None, ""
    if fn is not None and spill:
        rows.append((fn, "the caller's", spill))
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            r[0] for r in rows), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(names) == len(rows):
            rows = [(re.sub(r"^void |\(.*\)$", "", n.replace(
                "(anonymous namespace)::", "")), r, sp)
                for n, (_, r, sp) in zip(names, rows)]
    return rows


def larger(bytes_ms: float, ops_ms: float) -> tuple[float, str]:
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def bf16_ulp(scale: float) -> float:
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def k3_agrees(got, want, form: str, k: int) -> tuple[bool, float, str]:
    """K3's gate against its plain version: the vpu form bit for bit; the
    mxu form (tensor cores, another summation order) within
    ``1e-6·k·max|v|`` at f32 and one bf16 ulp of the value scale at bf16.
    Returns (ok, max abs error, the tolerance as text)."""
    g32, w32 = got.float(), want.float()
    err = float((g32 - w32).abs().max())
    if form == "vpu":
        return bool(got.equal(want)), err, "bit for bit"
    scale = float(w32.abs().max())
    tol = (1e-6 * k * scale if got.dtype == w32.dtype
           else bf16_ulp(scale))
    return err <= tol, err, f"atol={tol:.3g}"


def k3_bounds(cs, torch, shape, k: int, dtype, origin=(0, 0),
              global_shape=None) -> tuple[float, str, dict]:
    """Least time for one K3 (K3-halo) call: the function's bound, the
    larger of the bytes (the grid or shard read once and written once over
    HBM bandwidth) and the operations of its cheapest exact form (the vpu
    form's f32 operations over the f32 peak); and each form's own bound,
    the bytes against that form's operations: vpu's over the f32 peak,
    mxu's tensor-core flops (``cs.mxu_tensor_flops``) over the TF32 or bf16
    peak. Returns (ms, by, {form: (ms, by)})."""
    cells = shape[0] * shape[1]
    itemsize = 4 if dtype == torch.float32 else 2
    bytes_ms = 2 * cells * itemsize / HBM_BYTES_PER_S * 1e3
    vpu_ms = cs.vpu_ops(shape, k, origin=origin,
                        global_shape=global_shape) / F32_FLOPS * 1e3
    peak = TF32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    mxu_ms = cs.mxu_tensor_flops(shape, k, dtype, origin,
                                 global_shape) / peak * 1e3
    b_ms, b_by = larger(bytes_ms, vpu_ms)
    return b_ms, b_by, {"vpu": larger(bytes_ms, vpu_ms),
                        "mxu": larger(bytes_ms, mxu_ms)}


def workload(np, h: int, w: int, frac: float, seed: int):
    """``bench.py::_active_workload``: zeros with a centred square of side
    ``round(h * sqrt(frac))`` of ``U(0.5, 2.0)`` f32 values."""
    side = max(1, int(round(h * math.sqrt(frac))))
    v = np.zeros((h, w), np.float32)
    r0, c0 = (h - side) // 2, (w - side) // 2
    v[r0:r0 + side, c0:c0 + side] = np.random.default_rng(seed).uniform(
        0.5, 2.0, (side, side)).astype(np.float32)
    return v


#: a six-offset neighbourhood (hexagonal; its count is no power of two)
SIX_OFFSETS = ((-1, -1), (-1, 0), (0, -1), (0, 1), (1, 0), (1, 1))
#: phase 6g's K4 bf16-interior flow sets, each with its neighbourhoods
K4_BF16_SETS = {"config4": ("moore", "six"), "chain3": ("moore",),
                "coupled_alone": ("moore",), "affine": ("moore", "six"),
                "every_op": ("moore",)}


def field_flow_sets(mt, torch) -> dict:
    """K4's flow sets: config 4's, ``Coupled`` alone, an affine user flow
    (outflow(0) != 0), a row-reading flow, a 3-channel chain and one flow
    with every whitelisted operation (beside a Diffusion on its
    modulator)."""
    from mpi_model_tpu_torch.ops.flow import Flow, cell_coords

    class Affine(Flow):
        footprint = "pointwise"
        attr = "a"

        def outflow(self, values, origin=(0, 0)):
            return 0.05 * (3.0 - values["a"])

    class RowRate(Flow):
        footprint = "pointwise"
        attr = "a"

        def outflow(self, values, origin=(0, 0)):
            v = values["a"]
            rows, _ = cell_coords(v, origin)
            return 0.002 * rows.to(v.dtype) * v

    class EveryOp(Flow):
        footprint = "pointwise"
        attr = "a"

        def outflow(self, values, origin=(0, 0)):
            a, b = values["a"], values["b"]
            r, c = cell_coords(a, origin)
            x = (torch.minimum(a, b) * 0.3
                 + torch.maximum(a, 2.0 - b) / (b + 1.5))
            y = (-a).abs() * torch.exp(-b) + a ** 2 * 0.01 - b ** 3 * 0.001
            z = ((c + 1).to(a.dtype) * 1e-4 * a
                 - (r - 2).to(a.dtype) * 1e-5 * torch.clamp(b, 0.7, 1.8))
            return (x + y + z).clamp(min=0.0) * 0.05

    return {
        "config4": config4_flows(mt),
        "coupled_alone": [mt.Coupled(0.05, "a", "b")],
        "affine": [Affine()],
        "row_rate": [RowRate()],
        "chain3": [mt.Diffusion(0.1, "a"), mt.Diffusion(0.1, "b"),
                   mt.Diffusion(0.1, "c"), mt.Coupled(0.05, "a", "b"),
                   mt.Coupled(0.05, "b", "c")],
        "every_op": [EveryOp(), mt.Diffusion(0.1, "b")],
    }


def config4_flows(mt) -> list:
    """BASELINE config 4's flow set (``benchmarks/ladder.py``)."""
    return [mt.Diffusion(0.1, "a"), mt.Coupled(0.05, "a", "b"),
            mt.Diffusion(0.2, "b")]


def k4_steppers(mt, torch, k4, neighborhoods) -> list:
    """A stepper planned for every flow set and neighbourhood this check
    runs on K4 (phases 3d, 6b, 6d, 6e and the CLI's coupled chain), so that
    phase 2 builds their units together."""
    import argparse

    from mpi_model_tpu_torch.cli import build_flows

    sets = field_flow_sets(mt, torch)
    out = [k4.PallasFieldStep((8, 8), flows, offsets=offs,
                              names=("a", "b", "c"))
           for flows in sets.values()
           for offs in neighborhoods.values()]
    # phase 6g's bf16 interior math: the same flows lowered at bf16 too
    hoods = {**neighborhoods, "six": SIX_OFFSETS}
    out += [k4.PallasFieldStep((8, 8), sets[name], offsets=hoods[hood],
                               names=("a", "b", "c"),
                               compute_dtype=torch.bfloat16)
            for name, names in K4_BF16_SETS.items() for hood in names]
    chain, _ = build_flows(argparse.Namespace(flow="coupled", channels=2,
                                              rate=0.1, init=1.0))
    out.append(k4.PallasFieldStep((8, 8), chain, names=("c0", "c1")))
    return out


def field_bound_ms(prog, shape, itemsize: int, nsteps: int,
                   k: int) -> tuple[float, str]:
    """Least time for one K4 call, from the lowered program: every loaded
    channel read once and every written channel written once over HBM
    bandwidth, or the flops per cell-step (the program's, which include the
    adds that sum flows of one channel, and per written channel a divide, k
    inflow adds and two more) over the f32 peak, whichever is larger."""
    cells = shape[0] * shape[1]
    n_out = len(prog.outputs)
    bytes_ms = ((len(prog.channels) + n_out) * cells * itemsize
                / HBM_BYTES_PER_S * 1e3)
    flops = prog.flops() + n_out * (k + 3)
    ops_ms = cells * nsteps * flops / F32_FLOPS * 1e3
    return larger(bytes_ms, ops_ms)


def k5_bound_ms(batch: int, shape, itemsize: int, nsteps: int, k: int,
                interior_cells: int) -> tuple[float, str]:
    """Least time for one K5 call: the batch read once and written once over
    HBM bandwidth, or its flops over the f32 peak: 7 a cell-step on
    closed-form (interior) tiles, k + 3 on the exact path (share: multiply
    and divide; k - 1 gather adds; keep-multiply and add), whichever is
    larger. Which tiles are interior is fixed by the grid and the block."""
    cells = batch * shape[0] * shape[1]
    inner = batch * interior_cells
    bytes_ms = 2 * cells * itemsize / HBM_BYTES_PER_S * 1e3
    flops = nsteps * (7 * inner + (k + 3) * (cells - inner))
    return larger(bytes_ms, flops / F32_FLOPS * 1e3)


def halo_kernel_cases(np, torch, mt, dev, gen, record,
                      neighborhoods) -> dict:
    """Phase 6d: each halo kernel against its plain version on every shard
    of small meshes and on the main paths' own shards; the shards put
    together against the dense kernel. Returns the main shapes' errors."""
    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS
    from mpi_model_tpu_torch.ops import composed_stencil as cs
    from mpi_model_tpu_torch.ops import field_stencil as k4
    from mpi_model_tpu_torch.ops import fused_stencil as fs
    from mpi_model_tpu_torch.parallel import (assemble, exchange_ring,
                                              make_mesh, make_mesh_2d)
    from mpi_model_tpu_torch.parallel.mesh import shard_tensor

    meshes = {"3x3": ((96, 1152), make_mesh_2d(3, 3, devices=[dev] * 9)),
              "stripes4": ((128, 640), make_mesh(4, devices=[dev] * 4))}
    n = {"K2": 0, "K3-halo": 0, "K4-halo": 0}
    worst = {"K3-halo mxu": 0.0, "K4-halo every_op": 0.0}

    def shards_of(x, mesh):
        lines, columns = mesh.grid_shape
        h, w = x.shape[0] // lines, x.shape[1] // columns
        return shard_tensor(x, mesh, h, w), h, w

    def positions(mesh):
        lines, columns = mesh.grid_shape
        return [(i, j) for i in range(lines) for j in range(columns)]

    def k3_halo_case(x, g, mesh, shape, h, w, k, offs, form, what):
        """K3-halo's ``form`` on every shard against its plain version
        (``k3_agrees``) and the shards put together against K3 of that form
        on the whole grid, bit for bit. Skipped where the JAX package
        refuses the form (mxu at a width that is not 128-aligned)."""
        bw = fs.resolve_block((h, w), x.dtype)[1]
        if form == "mxu" and bw % fs.LANE:
            return
        parts = [[None] * mesh.grid_shape[1]
                 for _ in range(mesh.grid_shape[0])]
        ok, err = True, 0.0
        for i, j in positions(mesh):
            ring = exchange_ring(g, i, j, k)
            org = (i * h, j * w)
            got = cs.composed_halo_step(g[i][j], ring, org, shape, 0.13, k,
                                        offs, variant=form)
            want = cs.composed_halo_step_plain(g[i][j], ring, org, shape,
                                               0.13, k, offs, form)
            agree, e, _ = k3_agrees(got, want, form, k)
            ok, err = ok and agree, max(err, e)
            parts[i][j] = got
        torch.cuda.synchronize()
        mos = bool(torch.equal(assemble(parts, dev), cs.composed_dense_step(
            x, 0.13, k, offs, variant=form)))
        ok = ok and mos
        n["K3-halo"] += 1
        if form == "mxu":
            worst["K3-halo mxu"] = max(worst["K3-halo mxu"], err)
        record(f"K3-halo {form} {what}: max_abs_err={err:.3e} "
               f"mosaic==K3 {mos} {'ok' if ok else 'FAIL'}", ok)
        check(ok, f"K3-halo {form} disagrees: {what} err={err} "
                  f"mosaic={mos}")

    for dtype, nsteps_set in ((torch.float32, (1, 4, 8)),
                              (torch.bfloat16, (1, 4, 8, 16))):
        dname = str(dtype).removeprefix("torch.")
        for mname, (shape, mesh) in meshes.items():
            x = (0.5 + 1.5 * torch.rand(shape, generator=gen,
                                        device=dev)).to(dtype)
            g, h, w = shards_of(x, mesh)
            for ns in nsteps_set:
                for hood, offs in neighborhoods.items():
                    k2 = [[None] * mesh.grid_shape[1]
                          for _ in range(mesh.grid_shape[0])]
                    ok2 = True
                    for i, j in positions(mesh):
                        ring = exchange_ring(g, i, j, ns)
                        org = (i * h, j * w)
                        got = fs.pallas_halo_step(g[i][j], ring, org, shape,
                                                  0.13, offs, nsteps=ns)
                        want = fs.halo_step_plain(g[i][j], ring, org, shape,
                                                  0.13, offs, ns)
                        ok2 = ok2 and bool(torch.equal(got, want))
                        k2[i][j] = got
                    torch.cuda.synchronize()
                    mos2 = bool(torch.equal(assemble(k2, dev),
                                            fs.pallas_dense_step(
                                                x, 0.13, offs, nsteps=ns)))
                    ok = ok2 and mos2
                    n["K2"] += 1
                    record(f"K2 {dname} {mname} {shape} ns={ns} {hood}: "
                           f"bitwise={ok2} mosaic==K1 {mos2} "
                           f"{'ok' if ok else 'FAIL'}", ok)
                    check(ok, f"K2 disagrees: {dname} {mname} ns={ns} "
                              f"{hood} bitwise={ok2} mosaic={mos2}")
                    for form in cs.FORMS:
                        k3_halo_case(x, g, mesh, shape, h, w, ns, offs,
                                     form, f"{dname} {mname} {shape} k={ns} "
                                           f"{hood}")
            del x, g
            # K4-halo over its flow sets (Moore; config 4 also VN, custom)
            names = ("a", "b", "c")
            xs = {nm: (0.5 + 1.5 * torch.rand(shape, generator=gen,
                                              device=dev)).to(dtype)
                  for nm in names}
            for t in xs.values():  # -0.0 on a corner, a seam and inside
                t[0, 0] = t[shape[0] // 2, shape[1] // 2] = -0.0
                t[shape[0] // 3, shape[1] - 1] = -0.0
            gs = {nm: shards_of(t, mesh)[0] for nm, t in xs.items()}
            for ns in nsteps_set:
                for fname, flows in field_flow_sets(mt, torch).items():
                    for hood, offs in neighborhoods.items():
                        if hood != "moore" and fname != "config4":
                            continue
                        step = k4.PallasFieldStep((h, w), flows, offsets=offs,
                                                  nsteps=ns)
                        written = sorted({f.attr for f in flows})
                        res = {nm: [[None] * mesh.grid_shape[1]
                                    for _ in range(mesh.grid_shape[0])]
                               for nm in written}
                        ok, err = True, 0.0
                        for i, j in positions(mesh):
                            vals = {nm: gs[nm][i][j] for nm in names}
                            rings = {nm: exchange_ring(gs[nm], i, j, ns)
                                     for nm in names}
                            got = step.halo(vals, rings, (i * h, j * w),
                                            shape)
                            want = k4.field_halo_step_plain(
                                vals, rings, (i * h, j * w), shape, flows,
                                offs, ns)
                            ok = ok and all(got[nm] is vals[nm]
                                            for nm in names
                                            if nm not in written)
                            for nm in written:
                                e = float((got[nm].float()
                                           - want[nm].float()).abs().max())
                                err = max(err, e)
                                if fname == "every_op" and nm == "a":
                                    scale = float(want[nm].float().abs()
                                                  .max())
                                    tol = 8 * 2.0 ** -23 * ns * scale
                                    if dtype == torch.bfloat16:
                                        tol += bf16_ulp(scale)
                                    ok = ok and e <= tol
                                    worst["K4-halo every_op"] = max(
                                        worst["K4-halo every_op"], e)
                                else:
                                    ok = ok and bool(torch.equal(got[nm],
                                                                 want[nm]))
                                res[nm][i][j] = got[nm]
                        dense = k4.PallasFieldStep(shape, flows, offsets=offs,
                                                   nsteps=ns)(xs)
                        mos = all(torch.equal(assemble(res[nm], dev),
                                              dense[nm]) for nm in written)
                        ok = ok and mos
                        n["K4-halo"] += 1
                        record(f"K4-halo {dname} {mname} {shape} ns={ns} "
                               f"{hood} {fname}: max_abs_err={err:.3e} "
                               f"mosaic==K4 {mos} {'ok' if ok else 'FAIL'}",
                               ok)
                        check(ok, f"K4-halo disagrees: {dname} {mname} "
                                  f"ns={ns} {hood} {fname} err={err}")
            del xs, gs
            torch.cuda.empty_cache()

    # K2 on shards large enough for windows inside the shard (the cp.async
    # path, which the small meshes above never take): every shard of a 2x2
    # mesh of 2048 x 2560, each window height and neighbourhood of both
    # dtypes, bit for bit, and the mosaic against K1
    mesh = make_mesh_2d(2, 2, devices=[dev] * 4)
    shape = (2048, 2560)
    for dtype, nsteps_set in ((torch.float32, (1, 4, 8)),
                              (torch.bfloat16, (2, 8, 16))):
        dname = str(dtype).removeprefix("torch.")
        x = (0.5 + 1.5 * torch.rand(shape, generator=gen,
                                    device=dev)).to(dtype)
        g, h, w = shards_of(x, mesh)
        for ns in nsteps_set:
            for hood, offs in neighborhoods.items():
                k2 = [[None, None], [None, None]]
                ok2 = True
                for i, j in positions(mesh):
                    ring = exchange_ring(g, i, j, ns)
                    org = (i * h, j * w)
                    k2[i][j] = fs.pallas_halo_step(g[i][j], ring, org, shape,
                                                   0.13, offs, nsteps=ns)
                    want = fs.halo_step_plain(g[i][j], ring, org, shape,
                                              0.13, offs, ns)
                    ok2 = ok2 and bool(torch.equal(k2[i][j], want))
                torch.cuda.synchronize()
                mos2 = bool(torch.equal(assemble(k2, dev),
                                        fs.pallas_dense_step(
                                            x, 0.13, offs, nsteps=ns)))
                ok = ok2 and mos2
                n["K2"] += 1
                record(f"K2 {dname} 2x2 {shape} ns={ns} {hood}: "
                       f"bitwise={ok2} mosaic==K1 {mos2} "
                       f"{'ok' if ok else 'FAIL'}", ok)
                check(ok, f"K2 disagrees: {dname} 2x2 {shape} ns={ns} "
                          f"{hood} bitwise={ok2} mosaic={mos2}")
        del x, g, k2, want
    torch.cuda.empty_cache()

    # K3-halo on shards whose origins are not multiples of the kernels'
    # tiles: rows at 150 and columns at 256 of a 2x3 mesh of 300 x 768 (both
    # forms), and rows at 150, columns at 130 of 300 x 390 (vpu; the JAX
    # package refuses mxu at a width of 130)
    mesh23 = make_mesh_2d(2, 3, devices=[dev] * 6)
    for shape in ((300, 768), (300, 390)):
        for dtype, ks in ((torch.float32, (4, 8)),
                          (torch.bfloat16, (8, 16))):
            dname = str(dtype).removeprefix("torch.")
            x = (0.5 + 1.5 * torch.rand(shape, generator=gen,
                                        device=dev)).to(dtype)
            g, h, w = shards_of(x, mesh23)
            for k in ks:
                for hood, offs in neighborhoods.items():
                    for form in cs.FORMS:
                        k3_halo_case(x, g, mesh23, shape, h, w, k, offs,
                                     form,
                                     f"{dname} 2x3 unaligned {shape} k={k} "
                                     f"{hood}")
            del x, g

    # the main paths' own shards: shard (1, 1) of 16384² on 2x2 (K2, K3-halo
    # in each form) and of config 4's 8192² (K4-halo), rings from the
    # neighbours
    main = {}
    x = 1.0 + 0.1 * torch.rand((N, N), generator=gen, device=dev)
    g = shard_tensor(x, mesh, N // 2, N // 2)
    del x
    ring = exchange_ring(g, 1, 1, 8)
    got = fs.pallas_halo_step(g[1][1], ring, (N // 2, N // 2), (N, N), 0.1,
                              nsteps=8)
    want = fs.halo_step_plain(g[1][1], ring, (N // 2, N // 2), (N, N), 0.1,
                              MOORE_OFFSETS, 8)
    main["K2"] = float((got - want).abs().max())
    check(bool(torch.equal(got, want)),
          f"K2 disagrees at the main path's shard: err={main['K2']}")
    del got, want
    for form in cs.FORMS:
        got = cs.composed_halo_step(g[1][1], ring, (N // 2, N // 2), (N, N),
                                    0.1, 8, variant=form)
        want = cs.composed_halo_step_plain(g[1][1], ring, (N // 2, N // 2),
                                           (N, N), 0.1, 8, variant=form)
        ok, main[f"K3-halo {form}"], _ = k3_agrees(got, want, form, 8)
        check(ok, f"K3-halo {form} disagrees at the main path's shard: "
                  f"{main[f'K3-halo {form}']}")
        del got, want
    del g, ring
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    xs = {nm: torch.from_numpy(rng.uniform(0.5, 2.0, (N4, N4)).astype(
        np.float32)).to(dev) for nm in ("a", "b")}
    gs = {nm: shard_tensor(t, mesh, N4 // 2, N4 // 2) for nm, t in xs.items()}
    del xs
    vals = {nm: gs[nm][1][1] for nm in gs}
    rings = {nm: exchange_ring(gs[nm], 1, 1, 8) for nm in gs}
    flows = config4_flows(mt)
    got = k4.pallas_field_halo_step(vals, rings, (N4 // 2, N4 // 2),
                                    (N4, N4), flows, nsteps=8)
    want = k4.field_halo_step_plain(vals, rings, (N4 // 2, N4 // 2),
                                    (N4, N4), flows, nsteps=8)
    main["K4-halo"] = max(float((got[nm] - want[nm]).abs().max())
                          for nm in vals)
    check(all(torch.equal(got[nm], want[nm]) for nm in vals),
          f"K4-halo disagrees at the main path's shard: {main['K4-halo']}")
    del got, want, gs, vals, rings
    torch.cuda.empty_cache()
    for name, count in n.items():
        at = ", ".join(f"{key} {e:.3e}" for key, e in main.items()
                       if key.startswith(name))
        print(f"{name}: {count} mesh cases agree with the plain version "
              f"(every shard; the shards together equal the dense kernel "
              f"bit for bit), at the main path's shard max_abs_err: {at}",
              flush=True)
    print(f"K3-halo mxu largest error against its plain version "
          f"{worst['K3-halo mxu']:.3e} (K3's tolerance; K2, K3-halo vpu and "
          f"K4-halo are bit for bit but every_op, "
          f"{worst['K4-halo every_op']:.3e})", flush=True)
    return main


def sharded_active_kernel_cases(np, torch, mt, dev, record,
                                neighborhoods) -> None:
    """Phase 3c-halo: K6 and K7 at k=1 against their plain versions on every
    shard of a 3x3 block mesh and of 4 row stripes, each shard in a ring-1
    padded buffer whose ring ``refresh_rings`` filled from its neighbours
    (mass on the seams), as the sharded runner does, at the shard's global
    origin; the rings against ``pad_with_halo_1d/2d``; the shards' one
    step put together against one serial fused step on the whole grid
    (and, f32/f64, the plain dense step)."""
    from mpi_model_tpu_torch.ops import active as act
    from mpi_model_tpu_torch.ops import fused_active as fa
    from mpi_model_tpu_torch.parallel import (assemble, make_mesh,
                                              make_mesh_2d)
    from mpi_model_tpu_torch.parallel.halo import (pad_with_halo_1d,
                                                   pad_with_halo_2d,
                                                   refresh_rings)
    from mpi_model_tpu_torch.parallel.mesh import shard_tensor

    meshes = {"3x3": ((96, 1152), make_mesh_2d(3, 3, devices=[dev] * 9)),
              "stripes4": ((128, 640), make_mesh(4, devices=[dev] * 4))}
    tile = (16, 32)
    rate = 0.13
    ncases = 0

    def seam_state(shape, lines, columns):
        """Zeros with random bands across the shard seams (the horizontal
        ones on the left half, the vertical ones on the bottom half) and
        one blob inside a shard: nonzero rings, and tiles left idle."""
        H, W = shape
        h, w = H // lines, W // columns
        rng = np.random.default_rng(SEED)
        v = np.zeros(shape)
        band = rng.uniform(0.5, 2.0, shape) * (rng.random(shape) < 0.4)
        for i in range(1, lines):
            v[i * h - 3:i * h + 3, :W // 2] = band[i * h - 3:i * h + 3,
                                                   :W // 2]
        for j in range(1, columns):
            v[H // 2:, j * w - 3:j * w + 3] = band[H // 2:, j * w - 3:
                                                    j * w + 3]
        v[5:9, 40:50] = band[5:9, 40:50] + 0.5
        v[0, 0] = v[H - 1, W - 1] = 1.25  # the grid's corners
        return v

    def flagged(padded, values, plan):
        tmap = act.tile_nonzero_map(values, plan)
        flags = act.ghost_flags(padded, plan, tmap)
        ids, count = act.compact_tile_ids(flags, plan)
        selfnz = tmap.reshape(-1)[ids.long()].to(torch.int32)
        return ids, count, selfnz

    for mname, (shape, mesh) in meshes.items():
        lines, columns = mesh.grid_shape
        h, w = shape[0] // lines, shape[1] // columns
        v_np = seam_state(shape, lines, columns)
        plan = act.plan_for((h, w), tile=tile, max_active_frac=1.0)
        wplan = act.plan_for(shape, tile=tile, max_active_frac=1.0)
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            x = torch.from_numpy(v_np).to(dev, dtype)
            g = shard_tensor(x, mesh, h, w)
            bufs = [[torch.nn.functional.pad(t, (1, 1, 1, 1)) for t in row]
                    for row in g]
            refresh_rings(bufs)
            rings_ok = all(torch.equal(
                bufs[i][j], pad_with_halo_1d(g, i) if columns == 1
                else pad_with_halo_2d(g, i, j))
                for i in range(lines) for j in range(columns))
            check(rings_ok, f"refresh_rings disagrees with pad_with_halo on "
                            f"{mname} {dtype}")
            for hood, offs in neighborhoods.items():
                ok6 = ok7 = True
                err = 0.0
                live = 0
                res = [[None] * columns for _ in range(lines)]
                for i in range(lines):
                    for j in range(columns):
                        p = bufs[i][j]
                        ids, count, selfnz = flagged(p, g[i][j], plan)
                        cnt1 = count.reshape(1).to(torch.int32)
                        org = (i * h, j * w)
                        upd, anyf = fa.fused_compute(
                            p, ids, cnt1, selfnz, rate=rate, plan=plan,
                            origin=org, global_shape=shape, offsets=offs,
                            dtype=dtype, k=1, ring=1)
                        want_u, want_f = fa.fused_compute_plain(
                            p, ids, count, selfnz, rate, plan, org, shape,
                            offs, dtype, 1, 1)
                        n = min(max(int(count), 1), plan.capacity)
                        live += int(count)
                        err = max(err, float((upd[:n].double()
                                              - want_u[:n].double())
                                             .abs().max()))
                        ok6 = ok6 and bool(torch.equal(upd[:n], want_u[:n])
                                           and torch.equal(anyf, want_f))
                        pk = fa.fused_scatter(p.clone(), upd, ids, cnt1,
                                              plan=plan, ring=1)
                        pp = fa.fused_scatter_plain(p.clone(), upd, ids,
                                                    count, plan, 1)
                        ok7 = ok7 and bool(torch.equal(pk, pp))
                        res[i][j] = pk[1:-1, 1:-1]
                # one serial fused step on the whole zero-padded grid
                P = torch.nn.functional.pad(x, (1, 1, 1, 1)).contiguous()
                ids, count, selfnz = flagged(P, x, wplan)
                fa.fused_active_pass(P, ids, count, selfnz, rate, wplan,
                                     (0, 0), shape, offs, dtype, k=1, ring=1)
                torch.cuda.synchronize()
                mosaic = bool(torch.equal(assemble(res, dev), P[1:-1, 1:-1]))
                dense = None
                if dtype != torch.bfloat16:
                    dense = bool(torch.equal(
                        P[1:-1, 1:-1], act.dense_transport_step(
                            shape, rate, offs, (0, 0), shape, dtype)(x)))
                ok = ok6 and ok7 and mosaic and dense is not False
                ncases += 1
                record(f"K6/K7 sharded {dname} {mname} {shape} k=1 {hood}: "
                       f"live tiles {live}, max_abs_err={err:.3e} K6 "
                       f"bitwise={ok6} K7 bitwise={ok7} mosaic==serial "
                       f"{mosaic} ==dense {dense} {'ok' if ok else 'FAIL'}",
                       ok)
                check(ok, f"K6/K7 on shards disagree: {dname} {mname} "
                          f"{hood} K6={ok6} K7={ok7} mosaic={mosaic} "
                          f"dense={dense} err={err}")
            del x, g, bufs
    print(f"K6/K7 sharded: {ncases} mesh cases (3x3 blocks and 4 stripes, "
          f"k=1, f32/f64/bf16, three neighbourhoods) bit for bit their "
          f"plain versions on every shard, rings from refresh_rings bit for "
          f"bit pad_with_halo's; the shards together equal one serial fused "
          f"step bit for bit", flush=True)


def per_call_ms(torch, fn, calls: int = 4, reps: int = 5) -> float:
    """Median device ms of one call of ``fn``, from CUDA events around
    ``calls`` back-to-back calls (so the host's work on a call overlaps the
    device's on the one before)."""
    def batch():
        for _ in range(calls):
            fn()
    return statistics.median(timed_ms(torch, batch, reps=reps)) / calls


def sharded_main_path(np, torch, mt, dev, gen, reset_counts,
                      kernel_launches, oracle) -> dict:
    """Phase 6e: the sharded main path at full width on the one card (see
    the module docstring). Returns its rows and the halo kernels' per-call
    times."""
    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS
    from mpi_model_tpu_torch.ops import composed_stencil as cs
    from mpi_model_tpu_torch.ops import field_stencil as k4
    from mpi_model_tpu_torch.ops import fused_stencil as fs
    from mpi_model_tpu_torch.parallel import (ShardMapExecutor,
                                              exchange_ring, make_mesh,
                                              make_mesh_2d)
    from mpi_model_tpu_torch.parallel.mesh import shard_tensor

    out = {"runs": [], "calls": {}, "serial_run_ms": {}}
    depth = 8

    def mesh_of(name):
        return (make_mesh_2d(2, 2, devices=[dev] * 4) if name == "2x2"
                else make_mesh(4, devices=[dev] * 4))

    def serial_of(what, model, space, serial, steps):
        """The serial run a sharded run is held to: its values and its run
        ms (CUDA events, median of 3)."""
        want = dict(model.execute(space, serial, steps=steps)[0].values)
        ms = statistics.median(timed_ms(
            torch, lambda: serial.run_model(model, space, steps), reps=3))
        out["serial_run_ms"][what] = ms
        print(f"serial {what}: run {ms:.3f} ms", flush=True)
        return want, ms

    def sharded_run(what, model, space, mesh_name, impl, steps, counter,
                    want, cells, serial_ms, **ex_kw):
        """One counted run, the bitwise gate against ``want``, then the
        timed runs, the same run without exchange, and the row. ``ex_kw``
        goes to both executors (K3-halo's ``composed_variant``)."""
        mesh = mesh_of(mesh_name)
        ex = ShardMapExecutor(mesh, impl, halo_depth=depth if impl != "xla"
                              else 1, **ex_kw)
        reset_counts()
        res, rep = model.execute(space, ex, steps=steps)  # raises on drift
        ran = kernel_launches()
        k3_forms = {f: cs.halo_launches(f) for f in cs.FORMS}
        chunks = -(-steps // ex.halo_depth)
        want_launch = chunks * mesh.size if counter else 0
        check((ran[counter] if counter else 0) == want_launch
              and sum(ran.values()) == want_launch,
              f"{what}: launches {ran}, expected {want_launch} of {counter}")
        same = all(torch.equal(res.values[k], want[k]) for k in want)
        check(same, f"{what} is not bitwise its serial run")
        for v in res.values.values():
            check(bool(torch.isfinite(v).all()), f"{what}: not finite")
        assembly_ms = ex.last_assembly_s * 1e3
        del res
        run_ms = timed_ms(torch, lambda: ex.run_model(model, space, steps),
                          reps=3)
        med = statistics.median(run_ms)
        zero = ShardMapExecutor(mesh, impl, halo_mode="zero",
                                halo_depth=ex.halo_depth, **ex_kw)
        zero_ms = statistics.median(timed_ms(
            torch, lambda: zero.run_model(model, space, steps), reps=3))
        prof = profile_dispatch(torch, lambda: ex.run_model(model, space,
                                                           steps), med)
        row = {"what": what, "mesh": mesh_name, "impl": rep.impl,
               "steps": steps, "halo_depth": ex.halo_depth,
               "chunks": chunks, "shards": mesh.size,
               "launches": ran[counter] if counter else 0,
               "launches_per_chunk": (ran[counter] // chunks if counter
                                      else 0),
               "bitwise_serial": same,
               "conservation_error": rep.conservation_error(),
               "run_ms_median": med, "run_ms_all": run_ms,
               "cell_updates_per_s": cells * steps / (med / 1e3),
               "zero_halo_run_ms": zero_ms,
               "exchange_ms_per_chunk": (med - zero_ms) / chunks,
               "assembly_ms": assembly_ms, "serial_run_ms": serial_ms,
               "vs_serial": med / serial_ms, "profile": prof,
               "k3_halo_launches_by_form": k3_forms}
        kname = {"fused_stencil_halo": "K2",
                 "composed_stencil_halo": "K3-halo",
                 "field_stencil_halo": "K4"}.get(counter)
        if kname and "device_by_kind" in prof:
            k = prof["device_by_kind"].get(kname, {"ms": 0.0})["ms"]
            row.update(kernel_ms_run=k, kernel_ms_per_chunk=k / chunks,
                       kernel_ms_per_launch=k / max(row["launches"], 1))
        out["runs"].append(row)
        print(f"sharded {what} {mesh_name}: impl={rep.impl}, launches "
              f"{row['launches']} ({row['launches_per_chunk']} a chunk), "
              f"bitwise serial, conserved (|d|="
              f"{row['conservation_error']:.3e}), run {med:.3f} ms "
              f"({row['vs_serial']:.3f}x the serial run), "
              f"{row['cell_updates_per_s']:.4e} cell-updates/s, exchange "
              f"{row['exchange_ms_per_chunk']:.4f} ms a chunk (zero-halo "
              f"run {zero_ms:.3f} ms), assembly {assembly_ms:.3f} ms",
              flush=True)
        print_profile(f"sharded {what} {mesh_name} run", prof)
        return ex, row

    # -- K2 on 2x2 and on 4 row stripes, 16384², against serial K1 --------
    x = 1.0 + 0.1 * torch.rand((N, N), generator=gen, device=dev)
    space = mt.CellularSpace.create(N, N, 1.0).with_values({"value": x})
    model = mt.Model(mt.Diffusion(0.1))
    want, serial_ms = serial_of(f"K1 {N}x{N} substeps={depth}", model,
                                space, mt.SerialExecutor("pallas",
                                                         substeps=depth),
                                STEPS)
    for mesh_name in ("2x2", "stripes4"):
        sharded_run(f"K2 {N}x{N}", model, space, mesh_name, "pallas", STEPS,
                    "fused_stencil_halo", want, N * N, serial_ms)
    del want
    # K2 per call on shard (1, 1) of 2x2, its plain version, conv2d 3x3 on
    # the padded shard
    h = N // 2
    g = shard_tensor(x, mesh_of("2x2"), h, h)
    ring = exchange_ring(g, 1, 1, depth)
    y = torch.empty_like(g[1][1])
    k_ms = per_call_ms(torch, lambda: fs.pallas_halo_step(
        g[1][1], ring, (h, h), (N, N), 0.1, nsteps=depth, out=y))
    # K1 on a whole grid of the shard's size, beside it
    xs = g[1][1].clone()
    k1_ms = per_call_ms(torch, lambda: fs.pallas_dense_step(
        xs, 0.1, nsteps=depth, out=y))
    del xs
    p_ms = statistics.median(timed_ms(torch, lambda: fs.halo_step_plain(
        g[1][1], ring, (h, h), (N, N), 0.1, MOORE_OFFSETS, depth), reps=3))
    padded = fs.pad_from_ring(g[1][1], ring).view(1, 1, h + 2 * depth,
                                                   h + 2 * depth)
    w3 = torch.ones((1, 1, 3, 3), device=dev)
    # yardstick: the same work, `depth` 3x3 box sums on the padded shard
    # (one conv2d a step, each on the last one's output; the one-step time
    # kept beside it)
    l1_ms = statistics.median(timed_ms(
        torch, lambda: torch.nn.functional.conv2d(padded, w3, padding=1),
        reps=10))

    def conv_steps():
        t = padded
        for _ in range(depth):
            t = torch.nn.functional.conv2d(t, w3, padding=1)
        return t

    l_ms = statistics.median(timed_ms(torch, conv_steps, reps=5))
    b_ms, b_by = bound_ms((h, h), 4, depth, 8, (h, h), (N, N))
    out["calls"]["K2"] = {"shape": [h, h], "nsteps": depth, "ms": k_ms,
                          "plain_ms": p_ms, "library_ms": l_ms,
                          "library_one_step_ms": l1_ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "bound_ms_four_shards": 4 * b_ms,
                          "k1_same_shape_ms": k1_ms}
    print(f"K2 float32 shard {h}x{h} ns={depth}: kernel {k_ms:.4f} ms/call "
          f"(4 calls a chunk: {4 * k_ms:.4f} ms; K1 on a {h}x{h} grid "
          f"{k1_ms:.4f} ms), plain {p_ms:.3f} ms, "
          f"conv2d 3x3 x {depth} on the padded shard {l_ms:.4f} ms (one "
          f"step {l1_ms:.4f}), bound {b_ms:.4f} ms ({b_by}; 4 shards "
          f"{4 * b_ms:.4f} ms)", flush=True)
    # -- K3-halo on 2x2 against serial composed, per form -----------------
    out["calls"]["K3-halo"] = {}
    taps = torch.from_numpy(np.array(cs.composed_taps(
        0.1, MOORE_OFFSETS, depth))).to(dev, torch.float32).view(
        1, 1, 2 * depth + 1, 2 * depth + 1)
    l_ms = statistics.median(timed_ms(
        torch, lambda: torch.nn.functional.conv2d(padded, taps), reps=5))
    b_ms, b_by, forms = k3_bounds(cs, torch, (h, h), depth, torch.float32,
                                  (h, h), (N, N))
    xs = g[1][1].clone()
    for form in cs.FORMS:
        want, serial_ms = serial_of(
            f"K3 {form} {N}x{N} substeps={depth}", model, space,
            mt.SerialExecutor("composed", substeps=depth,
                              composed_variant=form), STEPS)
        _, row = sharded_run(f"K3-halo {form} {N}x{N}", model, space, "2x2",
                             "composed", STEPS, "composed_stencil_halo",
                             want, N * N, serial_ms, composed_variant=form)
        check(row["k3_halo_launches_by_form"][form] == row["launches"] > 0,
              f"K3-halo {form}: the sharded run launched "
              f"{row['k3_halo_launches_by_form']}")
        del want
        k_ms = per_call_ms(torch, lambda: cs.composed_halo_step(
            g[1][1], ring, (h, h), (N, N), 0.1, depth, out=y, variant=form))
        k3_ms = per_call_ms(torch, lambda: cs.composed_dense_step(
            xs, 0.1, depth, out=y, variant=form))
        p_ms = statistics.median(timed_ms(
            torch, lambda: cs.composed_halo_step_plain(
                g[1][1], ring, (h, h), (N, N), 0.1, depth, variant=form),
            reps=1, warmup=0))
        out["calls"]["K3-halo"][form] = {
            "shape": [h, h], "k": depth, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
            "form_bound_ms": forms[form][0], "form_bound_by": forms[form][1],
            "k3_same_shape_ms": k3_ms}
        print(f"K3-halo {form} float32 shard {h}x{h} k={depth}: kernel "
              f"{k_ms:.4f} ms/call (K3 on a {h}x{h} grid {k3_ms:.4f} ms), "
              f"plain {p_ms:.3f} ms, conv2d {2 * depth + 1}x"
              f"{2 * depth + 1} on the padded shard {l_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), the form's bound "
              f"{forms[form][0]:.4f} ms ({forms[form][1]})", flush=True)
    del xs
    del g, ring, y, padded, x, space
    torch.cuda.empty_cache()
    # -- K4-halo: config 4 at 8192² through the field plan on 2x2 ---------
    rng = np.random.default_rng(SEED)
    base = {nm: torch.from_numpy(rng.uniform(0.5, 2.0, (N4, N4)).astype(
        np.float32)).to(dev) for nm in ("a", "b")}
    space = mt.CellularSpace.create(N4, N4, {"a": 1.0, "b": 1.0}).with_values(
        base)
    model4 = mt.Model(config4_flows(mt))
    want, serial_ms = serial_of(f"K4 config 4 {N4}x{N4} substeps={depth}",
                                model4, space, mt.SerialExecutor(
                                    "pallas", substeps=depth), STEPS)
    sharded_run(f"K4-halo config 4 {N4}x{N4}", model4, space, "2x2",
                "pallas", STEPS, "field_stencil_halo", want, N4 * N4,
                serial_ms)
    del want
    h4 = N4 // 2
    gs = {nm: shard_tensor(t, mesh_of("2x2"), h4, h4) for nm, t in
          base.items()}
    vals = {nm: gs[nm][1][1] for nm in gs}
    rings = {nm: exchange_ring(gs[nm], 1, 1, depth) for nm in gs}
    step = k4.PallasFieldStep((h4, h4), model4.flows, nsteps=depth,
                              names=("a", "b"))
    ys = {nm: torch.empty_like(t) for nm, t in vals.items()}
    k_ms = per_call_ms(torch, lambda: step.halo(
        vals, rings, (h4, h4), (N4, N4), out=ys))
    xs = {nm: t.clone() for nm, t in vals.items()}
    k4_ms = per_call_ms(torch, lambda: step(xs, out=ys))
    del xs
    p_ms = statistics.median(timed_ms(torch, lambda: k4.field_halo_step_plain(
        vals, rings, (h4, h4), (N4, N4), model4.flows, nsteps=depth),
        reps=3))
    b_ms, b_by = field_bound_ms(step.program, (h4, h4), 4, depth, 8)
    out["calls"]["K4-halo"] = {"shape": [h4, h4], "nsteps": depth,
                               "ms": k_ms, "plain_ms": p_ms,
                               "library_ms": None, "bound_ms": b_ms,
                               "bound_by": b_by, "rows": step.rows,
                               "k4_same_shape_ms": k4_ms}
    print(f"K4-halo float32 shard {h4}x{h4} ns={depth}: kernel {k_ms:.4f} "
          f"ms/call (K4 on a {h4}x{h4} grid {k4_ms:.4f} ms), plain "
          f"{p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"window rows {step.rows}", flush=True)
    del gs, vals, rings, ys, base, space
    torch.cuda.empty_cache()
    # -- xla 2x2 at 4096², f32, against serial xla --------------------------
    x = 1.0 + 0.1 * torch.rand((N5, N5), generator=gen, device=dev)
    space = mt.CellularSpace.create(N5, N5, 1.0).with_values({"value": x})
    xsteps = 16
    want, serial_ms = serial_of(f"xla {N5}x{N5}", model, space,
                                mt.SerialExecutor("xla"), xsteps)
    sharded_run(f"xla {N5}x{N5}", model, space, "2x2", "xla", xsteps, None,
                want, N5 * N5, serial_ms)
    del want, x, space
    # -- the reference scenario at f64, against the oracle -----------------
    rspace, rmodel = mt.ModelRectangular.reference_scenario(device=dev)
    res, rep = rmodel.execute(rspace)
    got = res.values["value"].cpu().numpy()
    ref = oracle.reference_run_np(20, 60, src=(18, 19), steps=50)
    ok = (bool((got == ref).all()) and rep.comm_size == 6
          and rep.impl == "point")
    out["reference_scenario"] = {"comm_size": rep.comm_size,
                                 "impl": rep.impl,
                                 "bitwise_oracle": ok,
                                 "conservation_error":
                                     rep.conservation_error(),
                                 "devices": len(rmodel._default_executor
                                                .mesh.distinct_devices())}
    print(f"ModelRectangular reference scenario 20x60 on 2x3, f64, 50 "
          f"steps: impl={rep.impl} comm_size={rep.comm_size}, bitwise the "
          f"oracle: {ok}, |d|={rep.conservation_error():.3e}", flush=True)
    check(ok, "the rectangular reference scenario disagrees with the oracle "
              f"or did not run the point subsystem (impl={rep.impl!r})")
    return out


def point_flows_off_the_subsystem(np, torch, mt, dev, oracle) -> dict:
    """Phase 6e-point: point-flow models that the point subsystem refuses
    still run the full-grid steps on the card: 65 frozen flows (past
    ``MAX_FLOWS``) and Diffusion + Exponencial, f64, serially (the
    full-grid ``point_flow_step``) and on a 2x3 mesh (the xla pad-gather
    step, the point scattered on the owning shard), each reporting
    ``"xla"`` and bit for bit a NumPy oracle of the same rounding points:
    one ``point_flow_step_np`` after another (the serial step), or the
    amount added into the outflow before one ``transport_np`` (the sharded
    step). The 65 sources sit 3 apart (no cell neighbours two), some on the
    seams and one in a grid corner."""
    from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d

    H, W, steps, rate = 60, 90, 20, 0.1
    rng = np.random.default_rng(SEED)
    lattice = [(x, y) for x in range(0, H, 3) for y in range(0, W, 3)]
    must = [(0, 0), (30, 30), (30, 60), (27, 87)]
    rest = [q for q in lattice if q not in must]
    picks = [rest[k] for k in rng.choice(len(rest), 65 - len(must),
                                         replace=False)]
    sources = [(x, y, float(a)) for (x, y), a in zip(
        must + picks, rng.uniform(0.5, 2.0, 65))]
    base = rng.uniform(0.5, 2.0, (H, W))

    def flow(x, y, a):
        return mt.Exponencial(mt.Cell(x, y, mt.Attribute(99, a)), rate)

    def serial_oracle(v, diffusion):
        for _ in range(steps):
            if diffusion:
                v = oracle.dense_flow_step_np(v, rate)
            for x, y, a in sources_of[diffusion]:
                v = oracle.point_flow_step_np(v, x, y, rate * a)
        return v

    def sharded_oracle(v, diffusion):
        for _ in range(steps):
            o = rate * v if diffusion else np.zeros_like(v)
            for x, y, a in sources_of[diffusion]:
                o[x, y] += rate * a
            v = oracle.transport_np(v, o)
        return v

    sources_of = {False: sources, True: [(19, 33, 2.2)]}
    models = {
        "65 frozen flows": (mt.Model([flow(*q) for q in sources]), False),
        "Diffusion + Exponencial": (mt.Model(
            [mt.Diffusion(rate)] + [flow(*q) for q in sources_of[True]]),
            True),
    }
    out = {}
    space = mt.CellularSpace.create(H, W, 0.0, dtype="float64", device=dev)
    space = space.with_values({"value": torch.from_numpy(base).to(dev)})
    for name, (model, diffusion) in models.items():
        res = {}
        for where, ex in (("serial", mt.SerialExecutor("xla")),
                          ("2x3", ShardMapExecutor(
                              make_mesh_2d(2, 3, devices=[dev] * 6),
                              "xla"))):
            r, rep = model.execute(space, ex, steps=steps)
            got = r.values["value"].cpu().numpy()
            want = (serial_oracle if where == "serial"
                    else sharded_oracle)(base, diffusion)
            ok = rep.impl == "xla" and bool((got == want).all())
            res[where] = {"impl": rep.impl, "bitwise_oracle": ok,
                          "max_abs_err": float(abs(got - want).max())}
            print(f"point flows off the subsystem: {name} {where} {H}x{W} "
                  f"f64 {steps} steps: impl={rep.impl}, bitwise the oracle: "
                  f"{ok}", flush=True)
            check(ok, f"{name} on {where}: impl={rep.impl!r}, max_abs_err="
                      f"{res[where]['max_abs_err']}")
        out[name] = res
    return out


def sharded_active_path(np, torch, mt, dev, reset_counts,
                        kernel_launches) -> dict:
    """Phase 6f: the shard-local active path at full width on the one card
    (see the module docstring). Returns its rows, the K6/K7 per-pass times
    on one shard and the gates."""
    from mpi_model_tpu_torch.ops import active as act
    from mpi_model_tpu_torch.ops import fused_active as fa
    from mpi_model_tpu_torch.parallel import (ShardMapExecutor, make_mesh,
                                              make_mesh_2d)
    from mpi_model_tpu_torch.parallel.halo import (pad_with_halo_1d,
                                                   pad_with_halo_2d,
                                                   refresh_rings)
    from mpi_model_tpu_torch.parallel.mesh import shard_tensor
    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS

    out = {"runs": [], "k67": {}, "serial": {}, "gates": {}, "spread": []}
    model = mt.Model(mt.Diffusion(0.1))
    steps = ACTIVE_STEPS

    def mesh_of(name):
        return (make_mesh_2d(2, 2, devices=[dev] * 4) if name == "2x2"
                else make_mesh(4, devices=[dev] * 4))

    def run_ms(ex, space, n):
        """(median, all) of three runs' CUDA-event ms."""
        ms = timed_ms(torch, lambda: ex.run_model(model, space, n), reps=3)
        return statistics.median(ms), ms

    def k67_on_shard(space, mesh_name, frac):
        """K6 + K7 of one pass on shard (1, 1) of 2x2 (stripe 1 of 4) at the
        run's starting state, in its ring-1 padded buffer with the ring
        refreshed from its neighbours as the runner does (held against
        ``pad_with_halo``): against the plain versions, then timed."""
        mesh = mesh_of(mesh_name)
        lines, columns = mesh.grid_shape
        h, w = N // lines, N // columns
        i, j = 1, (1 if columns > 1 else 0)
        g = shard_tensor(space.values["value"], mesh, h, w)
        bufs = [[torch.nn.functional.pad(t, (1, 1, 1, 1)) for t in row]
                for row in g]
        refresh_rings(bufs)
        p = bufs[i][j]
        check(torch.equal(p, pad_with_halo_2d(g, i, j) if columns > 1
                          else pad_with_halo_1d(g, i)),
              f"refresh_rings disagrees with pad_with_halo on {mesh_name}")
        plan = act.plan_for((h, w))
        tmap = act.tile_nonzero_map(g[i][j], plan)
        flags = act.ghost_flags(p, plan, tmap)
        ids, count = act.compact_tile_ids(flags, plan)
        cnt1 = count.reshape(1).to(torch.int32)
        # as the runner: K6 reads selfnz only with taps (k=1 has none)
        selfnz = torch.zeros(plan.capacity, dtype=torch.int32, device=dev)
        del g, bufs
        org = (i * h, j * w)
        kw = dict(rate=0.1, plan=plan, origin=org, global_shape=(N, N),
                  offsets=MOORE_OFFSETS, dtype=torch.float32, k=1, ring=1)
        upd = torch.empty((plan.capacity,) + plan.tile, dtype=torch.float32,
                          device=dev)
        anyf = torch.empty(plan.capacity, dtype=torch.int32, device=dev)
        upd, anyf = fa.fused_compute(p, ids, cnt1, selfnz, upd=upd,
                                     anyf=anyf, **kw)
        want_u, want_f = fa.fused_compute_plain(
            p, ids, count, selfnz, 0.1, plan, org, (N, N), MOORE_OFFSETS,
            torch.float32, 1, 1)
        n = min(max(int(count), 1), plan.capacity)
        err6 = float((upd[:n] - want_u[:n]).abs().max())
        bit6 = bool(torch.equal(upd[:n], want_u[:n])
                    and torch.equal(anyf, want_f))
        pk = fa.fused_scatter(p.clone(), upd, ids, cnt1, plan=plan, ring=1)
        pp = fa.fused_scatter_plain(p.clone(), upd, ids, count, plan, 1)
        bit7 = bool(torch.equal(pk, pp))
        del pk, pp, want_u, want_f
        check(bit6 and bit7, f"K6/K7 disagree on the {mesh_name} shard at "
                             f"frac={frac}: K6 {bit6} K7 {bit7} err={err6}")
        # four launches back to back a timing, so the host's enqueue of
        # one overlaps the device's run of the one before
        k6 = per_call_ms(torch, lambda: fa.fused_compute(
            p, ids, cnt1, selfnz, upd=upd, anyf=anyf, **kw))
        k7 = per_call_ms(torch, lambda: fa.fused_scatter(
            p, upd, ids, cnt1, plan=plan, ring=1))
        p6 = statistics.median(timed_ms(torch, lambda: fa.fused_compute_plain(
            p, ids, count, selfnz, 0.1, plan, org, (N, N), MOORE_OFFSETS,
            torch.float32, 1, 1), reps=3))
        p7 = statistics.median(timed_ms(torch, lambda: fa.fused_scatter_plain(
            p, upd, ids, count, plan, 1), reps=3))
        # the least time: each live tile's ring-1 window read once and its
        # tile written once (K6), each tile read and written once (K7)
        th, tw = plan.tile
        b6 = (int(count) * ((th + 2) * (tw + 2) + th * tw) * 4
              / HBM_BYTES_PER_S * 1e3)
        b7 = 2 * int(count) * th * tw * 4 / HBM_BYTES_PER_S * 1e3
        lib7 = per_call_ms(torch, k7_library(torch, act, p, upd, ids, n,
                                             plan, 1))
        print(f"K7 alone on the {mesh_name} shard {org} frac={frac}: "
              f"{k7:.4f} ms (back to back), bound {b7:.4f} ms (bytes: "
              f"{int(count)} live tiles read and written), index_copy_ "
              f"{lib7:.4f} ms", flush=True)
        return {"shard": [h, w], "origin": list(org), "tile": [th, tw],
                "active_tiles": int(count), "k6_ms": k6, "k7_ms": k7,
                "k6_plain_ms": p6, "k7_plain_ms": p7, "k6_bound_ms": b6,
                "k7_bound_ms": b7, "k7_library_ms": lib7,
                "k6_max_abs_err": err6,
                "k6_bitwise": bit6, "k7_bitwise": bit7}

    for frac in FRACS:
        v_np = workload(np, N, N, frac, SEED)
        space = mt.CellularSpace.create(N, N, 0.0, dtype="float32", device=dev)
        space = space.with_values({"value": torch.from_numpy(v_np).to(dev)})
        del v_np
        serial = {}
        for impl in ("active", "active_fused"):
            sx = mt.SerialExecutor(impl)
            res, _ = model.execute(space, sx, steps=steps)
            ms, _ = run_ms(sx, space, steps)
            serial[impl] = res.values["value"]
            out["serial"][f"{impl} {frac}"] = ms
            print(f"serial {impl} {N}x{N} frac={frac}: run {ms:.3f} ms "
                  f"({N * N * steps / (ms / 1e3):.4e} effective "
                  f"cell-updates/s)", flush=True)
        for mesh_name in ("2x2", "stripes4"):
            mesh = mesh_of(mesh_name)
            want_x = ShardMapExecutor(mesh, "xla").run_model(
                model, space, steps)["value"]
            for impl in ("active", "active_fused"):
                ex = ShardMapExecutor(mesh, impl)
                ex.run_model(model, space, 2)  # warm-up (and first build)
                torch.cuda.synchronize()
                reset_counts()
                res, rep = model.execute(space, ex, steps=steps)
                ran = kernel_launches()
                br = rep.backend_report
                got = res.values["value"]
                check(rep.impl == impl and br["impl"] == impl,
                      f"sharded {impl} ran {rep.impl!r}")
                check(bool(torch.isfinite(got).all()),
                      f"sharded {impl}: not finite")
                same_s = bool(torch.equal(got, serial[impl]))
                same_x = bool(torch.equal(got, want_x))
                check(same_s and same_x,
                      f"sharded {impl} {mesh_name} frac={frac}: bitwise "
                      f"serial {same_s}, bitwise sharded xla {same_x}")
                shards = br["shards"]
                if impl == "active_fused":
                    ff = br["flags_fused"]
                    check(ran["fused_compute"] == ff
                          and ran["fused_scatter"] == ff
                          and sum(ran.values()) == 2 * ff,
                          f"K6/K7 launches {ran} != flags_fused {ff}")
                    check(ff + br["fallback_steps"] == steps * shards,
                          "flags_fused + fallback_steps != steps x shards")
                    check(ff > 0, "no fused pass ran")
                else:
                    check(sum(ran.values()) == 0,
                          f"sharded active launched kernels: {ran}")
                del res, got
                med, all_ms = run_ms(ex, space, steps)
                row = {"frac": frac, "mesh": mesh_name, "impl": impl,
                       "steps": steps, "shards": shards,
                       "run_ms_median": med, "run_ms_all": all_ms,
                       "cell_updates_per_s": N * N * steps / (med / 1e3),
                       "serial_active_fused_run_ms":
                           out["serial"][f"active_fused {frac}"],
                       "serial_same_impl_run_ms":
                           out["serial"][f"{impl} {frac}"],
                       "mean_active_fraction": br["mean_active_fraction"],
                       "fallback_steps": br["fallback_steps"],
                       "flags_fused": br.get("flags_fused"),
                       "host_syncs_per_step": br["host_syncs"] / steps,
                       "host_split_ms": {k: t * 1e3 for k, t in
                                         br["host_s"].items()},
                       "launches": ran,
                       "conservation_error": rep.conservation_error(),
                       "bitwise_serial": same_s, "bitwise_sharded_xla":
                           same_x, "backend_report": br}
                if impl == "active_fused":
                    kt = k67_on_shard(space, mesh_name, frac)
                    out["k67"][f"{mesh_name} {frac}"] = kt
                    row.update(k6_ms=kt["k6_ms"], k7_ms=kt["k7_ms"],
                               k67_bound_ms=kt["k6_bound_ms"]
                               + kt["k7_bound_ms"],
                               pass_ms=med / steps / shards)
                    if mesh_name == "2x2" and frac == FRACS[0]:
                        row["profile"] = profile_dispatch(
                            torch, lambda: ex.run_model(model, space, steps),
                            med)
                out["runs"].append(row)
                extra = (f", K6+K7 a pass on one shard {row['k6_ms']:.4f}+"
                         f"{row['k7_ms']:.4f} ms (bound "
                         f"{row['k67_bound_ms']:.4f}; run ms a shard-pass "
                         f"{row['pass_ms']:.4f})" if "k6_ms" in row else "")
                print(f"sharded {impl} {mesh_name} {N}x{N} frac={frac}: "
                      f"run {med:.3f} ms ({med / row['serial_active_fused_run_ms']:.3f}x "
                      f"serial active_fused), "
                      f"{row['cell_updates_per_s']:.4e} effective "
                      f"cell-updates/s, mean active "
                      f"{row['mean_active_fraction']:.4f}, fallback "
                      f"{row['fallback_steps']}, flags_fused "
                      f"{row['flags_fused']}, host syncs a step "
                      f"{row['host_syncs_per_step']:.1f}, bitwise serial "
                      f"and sharded xla{extra}", flush=True)
                if "profile" in row:
                    print_profile(f"sharded {impl} {mesh_name} frac={frac} "
                                  "run", row["profile"])
            del want_x
            torch.cuda.empty_cache()
        del serial, space
        torch.cuda.empty_cache()

    # the spread: the 2x2 rows at 0.01 and 0.05 and their serial column in
    # turn, SPREAD_ROUNDS rounds in this one call; each timed run's host
    # split (backend_report["host_s"]) beside its CUDA-event time, and a
    # probe of the host's cost to enqueue one small op, each round
    spaces = {}
    for frac in FRACS[:2]:
        v_np = workload(np, N, N, frac, SEED)
        spaces[frac] = mt.CellularSpace.create(
            N, N, 0.0, dtype="float32", device=dev).with_values(
            {"value": torch.from_numpy(v_np).to(dev)})
        del v_np
    mesh = mesh_of("2x2")
    exs = {impl: ShardMapExecutor(mesh, impl)
           for impl in ("active", "active_fused")}
    sx = mt.SerialExecutor("active_fused")
    probe = torch.zeros(1, device=dev)
    for rnd in range(SPREAD_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            probe.add_(1.0)
        enqueue_us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        for frac, space in spaces.items():
            serial_ms = statistics.median(timed_ms(
                torch, lambda: sx.run_model(model, space, steps), reps=3))
            for impl, ex in exs.items():
                runs = []

                def one():
                    ex.run_model(model, space, steps)
                    runs.append(dict(ex.last_backend_report["host_s"]))

                ms = timed_ms(torch, one, reps=3)
                runs = runs[1:]  # the warm-up's split goes
                med = statistics.median(ms)
                split = {k: statistics.median(r[k] * 1e3 for r in runs)
                         for k in runs[0]}
                row = {"round": rnd, "frac": frac, "mesh": "2x2",
                       "impl": impl, "run_ms_all": ms, "run_ms_median": med,
                       "serial_active_fused_run_ms": serial_ms,
                       "x_serial": med / serial_ms,
                       "host_split_ms_median": split,
                       "host_enqueue_us_per_op": enqueue_us}
                out["spread"].append(row)
                print(f"spread round {rnd} sharded {impl} 2x2 frac={frac}: "
                      f"run {med:.3f} ms ({med / serial_ms:.3f}x serial "
                      f"active_fused {serial_ms:.3f} ms); host ms refresh "
                      f"{split['refresh']:.3f}, flags {split['flags']:.3f}, "
                      f"count read {split['count_read']:.3f}, passes "
                      f"{split['passes']:.3f}; host enqueue "
                      f"{enqueue_us:.2f} us/op", flush=True)
    del spaces, exs, sx, probe
    torch.cuda.empty_cache()

    # gate: an everywhere-nonzero state falls back on every (shard, step)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = 1.0 + 0.1 * torch.rand((N, N), generator=gen, device=dev)
    space = mt.CellularSpace.create(N, N, 0.0, dtype="float32", device=dev).with_values(
        {"value": x})
    mesh = mesh_of("2x2")
    want_x = ShardMapExecutor(mesh, "xla").run_model(model, space, 3)["value"]
    for impl in ("active", "active_fused"):
        reset_counts()
        ex = ShardMapExecutor(mesh, impl)
        got = ex.run_model(model, space, 3)["value"]
        br = ex.last_backend_report
        ran = kernel_launches()
        ok = (br["fallback_steps"] == 3 * br["shards"]
              and sum(ran.values()) == 0 and bool(torch.equal(got, want_x)))
        out["gates"][f"dense fallback {impl}"] = ok
        print(f"sharded fallback gate {N}x{N} 2x2 {impl}: fallback_steps="
              f"{br['fallback_steps']}/{3 * br['shards']}, launches "
              f"{sum(ran.values())}, bitwise sharded xla: {ok}", flush=True)
        check(ok, f"sharded {impl} fallback gate failed")
        del got
    del x, space, want_x
    torch.cuda.empty_cache()
    # gate: f64, 1024², activity 0.02, 12 steps
    v64 = workload(np, 1024, 1024, 0.02, SEED).astype(np.float64)
    space = mt.CellularSpace.create(1024, 1024, 0.0, dtype="float64",
                                    device=dev)
    space = space.with_values({"value": torch.from_numpy(v64).to(dev)})
    want = model.execute(space, mt.SerialExecutor("xla"),
                         steps=12)[0].values["value"]
    for mesh_name in ("2x2", "stripes4"):
        mesh = mesh_of(mesh_name)
        got = {impl: ShardMapExecutor(mesh, impl).run_model(
            model, space, 12)["value"] for impl in ("active", "active_fused")}
        ok = (torch.equal(got["active"], want)
              and torch.equal(got["active_fused"], want))
        out["gates"][f"f64 {mesh_name}"] = ok
        print(f"sharded f64 gate 1024x1024 {mesh_name} frac=0.02, 12 steps: "
              f"active == active_fused == serial xla bitwise: {ok}",
              flush=True)
        check(ok, f"sharded f64 gate failed on {mesh_name}")
    return out


def with_specials(vals: dict, seed: int) -> dict:
    """Cells of each channel set to +0, -0, bf16 subnormals and +-inf, in
    place; returns ``vals``."""
    rng = random.Random(seed)
    specials = (0.0, -0.0, 2.0 ** -130, -(2.0 ** -128), 2.0 ** -133,
                float("inf"), float("-inf"))
    for t in vals.values():
        flat = t.view(-1)
        for i, x in enumerate(rng.sample(range(flat.numel()),
                                         4 * len(specials))):
            flat[x] = specials[i % len(specials)]
    return vals


def k4_bits_agree(got, want) -> tuple[bool, float, str]:
    """K4's paired walk against its plain version: NaN where the plain
    version has NaN, every other cell bit for bit (exp too: the kernel's
    ``expf`` and torch's on the card agree). Returns (agrees, the largest
    difference on cells finite in both, how)."""
    import torch

    bits = torch.int16 if want.dtype == torch.bfloat16 else torch.int32
    nan = want.isnan()
    g, w = got[~nan], want[~nan]
    fin = w.isfinite() & g.isfinite()
    err = float((g[fin].float() - w[fin].float()).abs().max()) if bool(
        fin.any()) else 0.0
    ok = got.isnan().equal(nan) and g.view(bits).equal(w.view(bits))
    return ok, err, "bit for bit, NaN by position"


def rect_cells(fs, shape, block, n, origin=(0, 0), global_shape=None) -> int:
    """Cells the bf16 interior math takes (``fs.bf16_rect``'s rectangle)."""
    r0, r1, c0, c1 = fs.bf16_rect(shape, block, n, origin, global_shape)
    return (r1 - r0) * (c1 - c0)


def bf16_form_bound_ms(cells: int, inner16: int, ops16: float,
                       ops32: float, in_bytes: int,
                       out_bytes: int) -> tuple[float, str]:
    """Least time for one call of a bf16-interior variant: the bytes it must
    move (each input read once, each output written once) over HBM
    bandwidth, or its operations: ``ops16`` a cell on its ``inner16`` bf16
    cells at the paired bf16 rate (``BF16X2_OPS``), ``ops32`` a cell on the
    rest at the f32 rate, whichever is larger."""
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = (inner16 * ops16 / BF16X2_OPS
              + (cells - inner16) * ops32 / F32_FLOPS) * 1e3
    return larger(bytes_ms, ops_ms)


def mxu16_tensor_ms(cs, fs, shape, k: int, dtype, block, origin=(0, 0),
                    global_shape=None) -> float:
    """Least tensor-core time of one K3 (K3-halo) mxu call with bf16
    interior math, on the layout that runs (``cs.mxu_mma_flops`` with the
    call's rectangle): its bf16 MMAs over the bf16 peak, its TF32 MMAs over
    the TF32 peak."""
    import torch

    rect = fs.kernel_rect(shape, dtype, block, k, torch.bfloat16, origin,
                          global_shape)
    by = cs.mxu_mma_flops(shape, k, dtype, origin, global_shape, rect)
    return (by.get("bf16", 0.0) / BF16_FLOPS
            + by.get("tf32", 0.0) / TF32_FLOPS) * 1e3


def k4_paired_bound_ms(plan, k: int, cells: int, inner16: int, nsteps: int,
                       nbytes: int) -> tuple[float, str]:
    """Least time for one K4 call over ``k`` offsets in the paired walk's
    own form: its bf16
    cells' instructions on pairs at the paired rate (``BF16X2_OPS``: the
    program's paired instructions, per written channel the inflow adds,
    the subtract and add, and the share's multiply where the count is a
    power of two), its instructions on f32 halves at the f32 rate (the
    rest of the program, a share's division otherwise), the other cells'
    operations at the f32 rate, against the bytes; whichever is larger."""
    from mpi_model_tpu_torch.ops import field_codegen as cg
    from mpi_model_tpu_torch.ops.field_lower import OP_ACC

    prog16 = plan.program16
    pair = halves = 0
    for (op, _, first, _, _), on_pair in zip(prog16.code,
                                             cg.pair_plan(prog16)):
        if op == OP_ACC and first:
            continue
        pair, halves = (pair + 1, halves) if on_pair else (pair, halves + 1)
    n_out = len(prog16.outputs)
    pow2 = k & (k - 1) == 0
    pair += n_out * (k + 2 + pow2)
    halves += n_out * (not pow2)
    per32 = plan.program.flops() + n_out * (k + 3)
    ops_ms = nsteps * (inner16 * (pair / BF16X2_OPS + halves / F32_FLOPS)
                       + (cells - inner16) * per32 / F32_FLOPS) * 1e3
    return larger(nbytes / HBM_BYTES_PER_S * 1e3, ops_ms)


def soak_profile(torch, fn) -> tuple:
    """``fn()``'s result and its device busy time (the union of kernel,
    copy and memset intervals) in ms, from a ``torch.profiler`` trace of
    the device (the pump thread's work included: the trace is of the
    device, not of one host thread); None when the profiler recorded no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA"
                   and e.time_range.end > e.time_range.start)
    if not spans:
        return got, None
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return got, (busy + cur_e - cur_s) / 1e3


def serving_phase(np, torch, mt, dev, reset_counts, kernel_launches) -> dict:
    """Phase 6c-serve: the always-on serving path at full width (see the
    module docstring): (a) the bit-for-bit gate of the async service against
    the synchronous one with K5, counted; (b) a flight finishing while the
    next runs; (c) an open-loop soak against the synchronous schedule, with
    each one's device idle share; (d) ``bench.py::bench_service``'s row
    uncut with its chaos plan armed; (e) the CLI's ``--serve``."""
    import collections

    from mpi_model_tpu_torch.ensemble import (AsyncEnsembleService,
                                              EnsembleService, buckets_for,
                                              run_soak)
    from mpi_model_tpu_torch.ensemble.batch import (complete_ensemble,
                                                    launch_ensemble)
    from mpi_model_tpu_torch.resilience.inject import (Fault, FaultPlan,
                                                       armed)

    t_phase = time.perf_counter()
    out = {}
    base = np.random.default_rng(SEED).uniform(0.5, 2.0, (N5, N5)).astype(
        np.float32)
    spaces = [mt.CellularSpace({"value": torch.from_numpy(
        np.roll(base, 7 * i, axis=0)).to(dev)}, N5, N5)
        for i in range(SERVE_GATE)]
    del base
    model01 = mt.Model(mt.Diffusion(0.1))
    kw = dict(steps=STEPS5, impl="pipeline", substeps=8,
              buckets=buckets_for(B5), retry="solo")

    # (a) the gate: async == sync per ticket, f32 and the bf16 knob, counted
    gates = []
    for cdt in (None, torch.bfloat16):
        sync = EnsembleService(model01, compute_dtype=cdt, **kw)
        ts = [sync.submit(s) for s in spaces]
        sync.flush()
        want = [sync.result(t) for t in ts]
        with AsyncEnsembleService(model01, compute_dtype=cdt, **kw) as svc:
            # the first dispatch builds the runner; the next is counted
            svc.result(svc.submit(spaces[0]), timeout=600)
            torch.cuda.synchronize()
            reset_counts()
            ta = [svc.submit(s) for s in spaces]
            got = [svc.result(t, timeout=600) for t in ta]
            torch.cuda.synchronize()
            ran = kernel_launches()
            st = svc.stats()
        dispatches = st["dispatches"] - 1
        ok = all(torch.equal(g[0].values["value"], w[0].values["value"])
                 and g[1].final_total == w[1].final_total
                 for g, w in zip(got, want))
        for sp, _ in got:
            v = sp.values["value"]
            check(tuple(v.shape) == (N5, N5) and bool(torch.isfinite(v).all()),
                  "served output has the wrong shape or is not finite")
        name = "float32" if cdt is None else "bfloat16 compute"
        want_k5 = dispatches * (STEPS5 // 8)
        gates.append({"compute": name, "scenarios": SERVE_GATE,
                      "bitwise": ok, "dispatches": dispatches,
                      "launches": ran, "k5_expected": want_k5})
        print(f"serving gate {name}: {SERVE_GATE} x {N5}^2 async == sync "
              f"bit for bit: {ok}; {dispatches} dispatches, K5 launches "
              f"{ran['pipeline_stencil']} (expected {want_k5})", flush=True)
        check(ok, f"async-served scenarios differ from sync ({name})")
        check(ran["pipeline_stencil"] == want_k5
              and sum(ran.values()) == want_k5,
              f"serving gate {name}: launches {ran}, expected {want_k5} "
              "of K5 and nothing else")
        ladder_guard(st, ran["pipeline_stencil"],
                     f"6c-serve gate {name}, the async service")
        ladder_guard(sync.stats(), None, f"6c-serve gate {name}, sync")
        del want, got, sync, svc
    out["gates"] = gates
    torch.cuda.empty_cache()

    # (b) the overlap: a pipeline flight finishes while an 8 x 4096^2 xla
    # flight queued behind it on the same stream still runs
    k5x = mt.EnsembleExecutor("pipeline", substeps=8)
    xla = mt.EnsembleExecutor("xla")
    lanes = spaces[:B5]
    for ex in (k5x, xla):  # build both runners first
        complete_ensemble(launch_ensemble(model01, lanes, executor=ex,
                                          steps=STEPS5))
    torch.cuda.synchronize()
    f1 = launch_ensemble(model01, lanes, executor=k5x, steps=STEPS5)
    f2 = launch_ensemble(model01, lanes, executor=xla, steps=STEPS5)
    t0 = time.perf_counter()
    complete_ensemble(f1)
    first_ms = (time.perf_counter() - t0) * 1e3
    pending = f2.done is not None and not f2.done.query()
    t0 = time.perf_counter()
    complete_ensemble(f2)
    second_ms = (time.perf_counter() - t0) * 1e3
    out["overlap"] = {"second_pending_after_first": pending,
                      "first_complete_ms": first_ms,
                      "second_complete_ms": second_ms}
    print(f"serving overlap: the pipeline flight finished in {first_ms:.3f} "
          f"ms while the xla flight behind it was still running: {pending} "
          f"(it finished {second_ms:.3f} ms later)", flush=True)
    check(pending, "finishing a flight waited for the flight behind it")
    del f1, f2
    torch.cuda.empty_cache()

    # (c) the open-loop soak: 64 scenarios at 90% of the sync rate
    scen = [(spaces[i % SERVE_GATE], None, None) for i in range(SERVE_SOAK)]
    sync = EnsembleService(model01, **kw)
    sync.result(sync.submit(spaces[0]))  # the runner's build
    st0 = sync.stats()
    for t in [sync.submit(s) for s in spaces[:B5]]:
        sync.result(t)
    st1 = sync.stats()
    # the sync service's busy seconds a scenario, over one warm dispatch
    per = (st1["busy_s"] - st0["busy_s"]) / (st1["scenarios"]
                                             - st0["scenarios"])
    rate = 0.9 / per

    # in turns, each soak on a fresh service (its counters and latency
    # reservoir its own): SOAK_ROUNDS unprofiled rounds, then one profiled
    def soak(mode, profiled=False):
        svc = (EnsembleService(model01, **kw) if mode == "sync"
               else AsyncEnsembleService(model01, **kw))
        k5_0 = kernel_launches()["pipeline_stencil"]
        try:
            if profiled:
                rep, busy = soak_profile(
                    torch, lambda: run_soak(svc, scen, arrival_rate_hz=rate))
                rep["device_busy_ms"] = busy
                rep["idle_share"] = (None if busy is None
                                     else 1.0 - busy / (rep["wall_s"] * 1e3))
            else:
                rep = run_soak(svc, scen, arrival_rate_hz=rate)
        finally:
            if mode == "async":
                svc.stop()
        check(rep["ledger_complete"] and rep["served"] == SERVE_SOAK,
              f"{mode} soak ledger incomplete: {rep}")
        ladder_guard(svc.stats(), kernel_launches()["pipeline_stencil"]
                     - k5_0, f"6c-serve the {mode} soak")
        return rep

    soaks = {"sync": [], "async": []}
    for _ in range(SOAK_ROUNDS):
        for mode in ("sync", "async"):
            soaks[mode].append(soak(mode))
    for mode in ("sync", "async"):
        reps = soaks[mode]
        prof = soak(mode, profiled=True)
        med = {k: statistics.median(r[k] for r in reps) for k in (
            "sustained_scenarios_per_s", "latency_p50_s", "latency_p99_s",
            "occupancy", "dispatches")}
        soaks[mode] = {"rounds": reps, "median": med, "profiled": prof}
        idle = ("not measured (no device activity in the trace)"
                if prof["idle_share"] is None
                else f"{prof['idle_share']:.3f}")
        each = ", ".join(f"{r['sustained_scenarios_per_s']:.1f}"
                         for r in reps)
        print(f"serving soak {mode}: {SERVE_SOAK} x {N5}^2 at {rate:.2f} Hz "
              f"offered, {SOAK_ROUNDS} rounds (median; all): "
              f"{med['sustained_scenarios_per_s']:.2f} scenarios/s "
              f"sustained ({each}), "
              f"queue latency p50 {med['latency_p50_s'] * 1e3:.3f} ms, p99 "
              f"{med['latency_p99_s'] * 1e3:.3f} ms, occupancy "
              f"{med['occupancy']:.3f}, {med['dispatches']} dispatches; "
              f"profiled round: {prof['sustained_scenarios_per_s']:.2f} "
              f"scenarios/s, device idle share {idle} (wall "
              f"{prof['wall_s'] * 1e3:.1f} ms)", flush=True)
    out["soak"] = {"scenarios": SERVE_SOAK, "offered_hz": rate,
                   "sync_s_per_scenario": per, **soaks}
    del sync, scen
    torch.cuda.empty_cache()

    # (d) bench.py::bench_service's row, uncut: 512^2, B = 8, 8 steps,
    # xla, windows 2, donated, max_queue 256, 2000 scenarios, chaos armed
    g, B, n = SERVE_BENCH
    base = np.random.default_rng(17).uniform(0.5, 2.0, (g, g)).astype(
        np.float32)
    pool = [mt.CellularSpace({"value": torch.from_numpy(
        np.roll(base, 11 * i, axis=0)).to(dev)}, g, g) for i in range(B)]
    models = [mt.Model(mt.Diffusion(0.1 * (1.0 + 0.05 * i / (B - 1))),
                       1.0, 1.0) for i in range(B)]
    bkw = dict(steps=STEPS5, impl="xla", buckets=buckets_for(B),
               retry="solo")
    sync = EnsembleService(models[0], **bkw)
    ts = [sync.submit(pool[i], model=models[i]) for i in range(B)]
    sync.flush()
    want = [sync.result(t)[0] for t in ts]
    with AsyncEnsembleService(models[0], windows=2, max_queue=256,
                              **bkw) as gsvc:
        ta = [gsvc.submit(pool[i], model=models[i]) for i in range(B)]
        got = [gsvc.result(t, timeout=600)[0] for t in ta]
    ok = all(torch.equal(a.values["value"], b.values["value"])
             for a, b in zip(got, want))
    print(f"bench_service gate: {B} async lanes (windows 2, donated) == "
          f"sync at {g}^2 bit for bit: {ok}", flush=True)
    check(ok, "bench_service gate: async lanes differ from sync")
    gst = sync.stats()
    rate = 0.9 / max(gst["busy_s"] / gst["scenarios"], 1e-6)
    scen = [(pool[i % B], models[i % B], STEPS5) for i in range(n)]
    sync_rep = run_soak(EnsembleService(models[0], **bkw), scen,
                        arrival_rate_hz=rate)
    plan = FaultPlan((
        Fault("lane_nan", ticket=max(1, n // 3), once=True),
        Fault("batch_exc", at=max(2, n // (2 * B))),
        Fault("thread_exc", at=3),
        Fault("slow_compile", at=5, seconds=0.01),
        Fault("fetch_nan", at=max(3, n // (2 * B)) + 4, lane=0, once=True),
        Fault("queue_full", at=max(4, n // 2)),
    ), seed=23)
    asvc = AsyncEnsembleService(models[0], windows=2, max_queue=256, **bkw)
    # every dispatch of the soak kept, for the donation audit
    asvc.scheduler.dispatch_log = collections.deque(maxlen=100_000)
    with armed(plan) as st, asvc:
        rep = run_soak(asvc, scen, arrival_rate_hz=rate)
    fired = [f["kind"] for f in st.fired]
    # every batch dispatch's entry (solo retries and failed dispatches log
    # none, as in the JAX package)
    logged = [d for d in asvc.scheduler.dispatch_log if "windows" in d]
    donation_ok = bool(logged) and all(
        d["donated_windows"] == d["windows"] == 2 for d in logged)
    out["bench_service"] = {
        "grid": g, "B": B, "steps": STEPS5, "windows": 2,
        "max_queue": 256, "offered": n, "offered_hz": rate,
        "chaos_fired": fired, "donation_ok": donation_ok,
        "donated_dispatches": len(logged), "async": rep, "sync": sync_rep,
        "sync_occupancy": sync_rep["occupancy"]}
    print(f"bench_service {g}^2 B={B} xla windows=2 donated, {n} scenarios "
          f"at {rate:.1f} Hz, chaos {sorted(set(fired))}: served "
          f"{rep['served']} failed {rep['failed']} expired {rep['expired']} "
          f"shed {rep['shed']} (ledger complete {rep['ledger_complete']}); "
          f"{rep['sustained_scenarios_per_s']:.1f} scenarios/s sustained "
          f"(sync {sync_rep['sustained_scenarios_per_s']:.1f}), p50 "
          f"{rep['latency_p50_s'] * 1e3:.3f} ms p99 "
          f"{rep['latency_p99_s'] * 1e3:.3f} ms (sync "
          f"{sync_rep['latency_p99_s'] * 1e3:.3f}), occupancy "
          f"{rep['occupancy']:.3f} (sync {sync_rep['occupancy']:.3f}); "
          f"recovered {rep['recovered_failures']}, quarantined "
          f"{rep['quarantined']}, loop faults {rep['loop_faults']}; "
          f"donated_windows == windows on all {len(logged)} dispatches: "
          f"{donation_ok}", flush=True)
    check(rep["ledger_complete"] and sync_rep["ledger_complete"],
          "bench_service soak dropped tickets")
    check(donation_ok, "a dispatch of the soak did not donate its windows")
    check({"thread_exc", "queue_full", "batch_exc"} <= set(fired),
          f"the chaos plan did not fire: {fired}")
    del pool, sync, asvc, gsvc, want, got
    torch.cuda.empty_cache()

    # (e) the CLI's --serve
    from mpi_model_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["run", "--flow=diffusion", f"--dimx={N5}",
                       f"--dimy={N5}", "--serve", "--serve-scenarios=16",
                       "--ensemble-impl=pipeline", "--substeps=8",
                       "--json"])
    print(buf.getvalue(), end="", flush=True)
    row = json.loads(buf.getvalue().strip().splitlines()[-1])
    out["cli"] = row
    check(rc == 0 and row["ledger_complete"] and row["served"] == 16,
          f"the --serve CLI run failed: {row}")
    cli_row_guard(row, "6c-serve (e) the --serve CLI row")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"serving phase: {out['seconds']:.1f} s", flush=True)
    return out


def bf16_interior_phase(np, torch, mt, dev, gen, record, reset_counts,
                        neighborhoods, f32_ms) -> dict:
    """Phase 6g: the bf16 interior math (``compute_dtype=bfloat16``) of K1,
    K2, K3 (both forms), K3-halo, K4, K4-halo and K5: each variant against
    its plain version (see the module docstring), then the main paths at
    full width through their entry points, each run counted, and each
    variant's kernel ms beside the f32-compute kernel's of this run
    (``f32_ms``) and the bound of its form. Returns the cases' worst
    errors, the rows and the per-call times."""
    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS
    from mpi_model_tpu_torch.ops import composed_stencil as cs
    from mpi_model_tpu_torch.ops import field_stencil as k4
    from mpi_model_tpu_torch.ops import fused_stencil as fs
    from mpi_model_tpu_torch.ops import pipeline_stencil as k5
    from mpi_model_tpu_torch.parallel import (ShardMapExecutor, assemble,
                                              exchange_ring, make_mesh_2d)
    from mpi_model_tpu_torch.parallel.mesh import shard_tensor

    BF = torch.bfloat16
    out = {"err": {}, "rows": {}, "calls": {}}
    t_phase = time.perf_counter()

    def rand(shape, dtype):
        return (0.5 + 1.5 * torch.rand(shape, generator=gen,
                                       device=dev)).to(dtype)

    def case(name, got, want, form="vpu", k=1):
        if form == "mxu":
            ok, err, how = k3_agrees(got, want, form, k)
        elif form == "bits":
            # K4's paired walk: bit for bit, NaN compared by position
            ok, err, how = k4_bits_agree(got, want)
        else:
            err = float((got.float() - want.float()).abs().max())
            ok, how = bool(torch.equal(got, want)), "bit for bit"
        record(f"{name}: max_abs_err={err:.3e} {how} "
               f"{'ok' if ok else 'FAIL'}", ok)
        check(ok, f"{name} is not its plain version ({how}): err={err}")
        key = name.split(" ")[0] + (f" {form}" if name.startswith("K3")
                                    else "")
        out["err"][key] = max(out["err"].get(key, 0.0), err)
        return err

    def shards(full, mesh_shape):
        lines, columns = mesh_shape
        mesh = make_mesh_2d(lines, columns, devices=[dev] * (lines * columns))
        h, w = full.shape[0] // lines, full.shape[1] // columns
        return shard_tensor(full, mesh, h, w), (h, w)

    # -- the variants against their plain versions ----------------------------
    n_cases = len(out["err"])
    for dtype, depths in ((torch.float32, (1, 2, 8)), (BF, (1, 4, 16))):
        dname = str(dtype).removeprefix("torch.")
        for shape, block in (((512, 1024), (64, 128)),
                             ((336, 1000), (48, 200)), ((N, N), None)):
            x = rand(shape, dtype)
            for ns in depths:
                if ns > fs.ghost_depth(shape, dtype, block):
                    continue
                for hood, offs in neighborhoods.items():
                    if shape == (N, N) and not (
                            hood == "moore" and ns in (1, max(depths))):
                        continue
                    got = fs.pallas_dense_step(x, 0.13, offs, block, ns,
                                               compute_dtype=BF)
                    want = fs.dense_step_plain(x, 0.13, offs, ns, BF, block)
                    case(f"K1 bf16-interior {dname} {shape} ns={ns} "
                               f"{hood} ({rect_cells(fs, shape, fs.resolve_block(shape, dtype, block), ns)} bf16 "
                               "cells)", got, want)
                    if ns == 1:
                        check(torch.equal(got, fs.pallas_dense_step(
                            x, 0.13, offs, block, 1)),
                            "K1 at one step is not the f32 result")
                    del got, want
            del x
    # K2: the 2x2 shards of 2048 x 2560 (tiles off the edge in every shard)
    # and the 4 row stripes of 96 x 768 (every tile near)
    for dtype, ns in ((torch.float32, 8), (BF, 16), (torch.float32, 1)):
        dname = str(dtype).removeprefix("torch.")
        for gshape, mshape in (((2048, 2560), (2, 2)), ((96, 768), (4, 1))):
            g, (h, w) = shards(rand(gshape, dtype), mshape)
            for i in range(mshape[0]):
                for j in range(mshape[1]):
                    ring = exchange_ring(g, i, j, ns)
                    org = (i * h, j * w)
                    nb = rect_cells(fs, (h, w), fs.resolve_block(
                        (h, w), dtype), ns, org, gshape)
                    case(f"K2 bf16-interior {dname} {gshape} shard {org} "
                         f"ns={ns} ({nb} bf16 cells)",
                         fs.pallas_halo_step(g[i][j], ring, org, gshape,
                                             0.13, nsteps=ns,
                                             compute_dtype=BF),
                         fs.halo_step_plain(g[i][j], ring, org, gshape,
                                            0.13, MOORE_OFFSETS, ns, BF))
            del g
    # K1 and K2 over windows of +-0 and bf16 subnormals, and of +-inf (NaN
    # compared by position): K1 on the odd rectangle (rows [45, 180),
    # columns [333, 666) at block (45, 333)), K2 on the 2x2 shards of
    # 1024 x 2048
    for dtype, ns in ((torch.float32, 8), (BF, 16)):
        dname = str(dtype).removeprefix("torch.")
        shape, block = (225, 999), (45, 333)
        x = rand(shape, dtype)
        xs = with_specials({"v": x.clone()}, 17)["v"]
        for vname, v in (("+-0 and subnormals",
                          torch.where(torch.isinf(xs), x, xs)),
                         ("+-inf", xs)):
            for hood in ("moore", "custom"):
                offs = neighborhoods[hood]
                case(f"K1 bf16-interior {dname} {shape} ns={ns} {hood} "
                     f"{vname}",
                     fs.pallas_dense_step(v, 0.13, offs, block, ns,
                                          compute_dtype=BF),
                     fs.dense_step_plain(v, 0.13, offs, ns, BF, block),
                     "bits")
        full = with_specials({"v": rand((1024, 2048), dtype)}, 19)["v"]
        g, (h, w) = shards(full, (2, 2))
        for i in range(2):
            for j in range(2):
                ring = exchange_ring(g, i, j, ns)
                org = (i * h, j * w)
                case(f"K2 bf16-interior {dname} (1024, 2048) shard {org} "
                     f"ns={ns} +-0, subnormals and +-inf",
                     fs.pallas_halo_step(g[i][j], ring, org, (1024, 2048),
                                         0.13, nsteps=ns, compute_dtype=BF),
                     fs.halo_step_plain(g[i][j], ring, org, (1024, 2048),
                                        0.13, MOORE_OFFSETS, ns, BF), "bits")
        del x, xs, full, g
    # K3 and K3-halo, each form
    for dtype, ks in ((torch.float32, (1, 8)), (BF, (4, 16))):
        dname = str(dtype).removeprefix("torch.")
        x = rand((512, 1024), dtype)
        for k in ks:
            for form in cs.FORMS:
                for hood in ("moore", "custom"):
                    offs = neighborhoods[hood]
                    case(f"K3 bf16-interior {dname} (512, 1024) k={k} "
                         f"{form} {hood}",
                         cs.composed_dense_step(x, 0.13, k, offs, (64, 256),
                                                form, BF),
                         cs.composed_dense_step_plain(x, 0.13, k, offs, form,
                                                      BF, (64, 256)),
                         form, k)
        k = ks[-1]
        g, (h, w) = shards(rand((1024, 2048), dtype), (2, 2))
        for form in cs.FORMS:
            for i in range(2):
                for j in range(2):
                    ring = exchange_ring(g, i, j, k)
                    case(f"K3-halo bf16-interior {dname} shard "
                         f"{(i * h, j * w)} k={k} {form}",
                         cs.composed_halo_step(g[i][j], ring, (i * h, j * w),
                                               (1024, 2048), 0.13, k,
                                               variant=form,
                                               compute_dtype=BF),
                         cs.composed_halo_step_plain(
                             g[i][j], ring, (i * h, j * w), (1024, 2048),
                             0.13, k, variant=form, compute_dtype=BF),
                         form, k)
        del x, g
    # K3 mxu bf16-interior over +-0 and bf16 subnormals (and +-inf): the
    # kernel against its plain version, and its cells outside the bf16
    # rectangle bit for bit the f32-compute kernel over the grid rounded to
    # bf16 (the f32 pass without the window's zero low term); with +-inf,
    # where the plain version is not finite the kernel is not either, its
    # finite cells are held to the tolerance, and the non-finite cells each
    # version gives are recorded by position
    out["inf_positions"] = {}
    for dtype, k in ((torch.float32, 8), (BF, 16)):
        dname = str(dtype).removeprefix("torch.")
        shape, block = (336, 1024), (48, 256)
        x = rand(shape, dtype)
        xs = with_specials({"v": x.clone()}, 11)["v"]
        r0, r1, c0, c1 = fs.kernel_rect(shape, dtype, block, k, BF)
        rows = torch.arange(shape[0], device=dev)[:, None]
        cols = torch.arange(shape[1], device=dev)[None, :]
        outside = ~((rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1))
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        for vname, v in (("+-0 and subnormals",
                          torch.where(torch.isinf(xs), x, xs)),
                         ("+-inf", xs)):
            got = cs.composed_dense_step(v, 0.13, k, block=block,
                                         variant="mxu", compute_dtype=BF)
            want = cs.composed_dense_step_plain(v, 0.13, k, variant="mxu",
                                                compute_dtype=BF,
                                                block=block)
            f32k = cs.composed_dense_step(v.to(BF).to(dtype), 0.13, k,
                                          block=block, variant="mxu")
            what = f"K3 bf16-interior {dname} {shape} k={k} mxu {vname}"
            if vname == "+-inf":
                fin = torch.isfinite(want)
                both = fin & torch.isfinite(got)
                case(what + " (finite cells)", got[both], want[both], "mxu",
                     k)
                check(not bool(torch.isfinite(got[~fin]).any()),
                      f"{what}: a cell the plain version leaves non-finite "
                      "is finite")
                nf = {n: int((~torch.isfinite(t)).sum()) for n, t in (
                    ("plain", want), ("kernel", got),
                    ("f32_compute_kernel_over_bf16", f32k))}
                nf["outside_rect_differ_from_f32_compute"] = int(
                    (torch.isfinite(got) != torch.isfinite(f32k))[
                        outside].sum())
                out["inf_positions"][f"{dname} k={k}"] = nf
                record(f"{what}: non-finite cells {nf}", True)
            else:
                case(what, got, want, "mxu", k)
                same = torch.equal(got[outside].view(bits),
                                   f32k[outside].view(bits))
                record(f"{what}: outside the rectangle bit for bit the "
                       f"f32-compute kernel over bf16 values: {same}", same)
                check(same, f"{what}: the f32 pass is not the f32-compute "
                            "kernel over the grid rounded to bf16")
        del x, xs, got, want, f32k
    # K4 and K4-halo on the paired walk: each flow set of K4_BF16_SETS and
    # its neighbourhoods, uniform values and values holding +-0, bf16
    # subnormals and +-inf, on a grid whose bf16 rectangle cuts the tiles
    # and one whose rectangle has an odd number of rows from an odd row
    flow_sets = field_flow_sets(mt, torch)
    hoods = {**neighborhoods, "six": SIX_OFFSETS}
    for dtype, depths in ((torch.float32, (1, 8)), (BF, (1, 16))):
        dname = str(dtype).removeprefix("torch.")
        for shape, block in (((512, 1024), (64, 128)),
                             ((225, 640), (45, 128))):
            uniform = {n: rand(shape, dtype) for n in ("a", "b", "c")}
            special = with_specials({n: t.clone() for n, t in
                                     uniform.items()}, 5)
            for fname, names in K4_BF16_SETS.items():
                fl = flow_sets[fname]
                for hood in names:
                    for ns in depths:
                        ns = min(ns, fs.ghost_depth(shape, dtype, block))
                        step = k4.PallasFieldStep(
                            shape, fl, offsets=hoods[hood], block=block,
                            nsteps=ns, compute_dtype=BF)
                        for vname, vals in (("uniform", uniform),
                                            ("special", special)):
                            got = step(vals)
                            want = k4.field_step_plain(
                                vals, fl, hoods[hood], nsteps=ns,
                                compute_dtype=BF, block=block)
                            for n in sorted({f.attr for f in fl}):
                                case(f"K4 bf16-interior {dname} {shape} "
                                     f"ns={ns} {fname} {hood} {vname} "
                                     f"channel {n}", got[n], want[n],
                                     "bits")
        ns = depths[-1]
        g = {}
        for n in ("a", "b", "c"):
            full = rand((1024, 2048), dtype)
            if n != "c":
                with_specials({n: full}, 9)
            g[n], (h, w) = shards(full, (2, 2))
        for fname, hood in (("config4", "moore"), ("config4", "six"),
                            ("affine", "moore"), ("every_op", "moore")):
            fl = flow_sets[fname]
            st = k4.PallasFieldStep((h, w), fl, offsets=hoods[hood],
                                    nsteps=ns, compute_dtype=BF)
            for i in range(2):
                for j in range(2):
                    v = {n: g[n][i][j] for n in g}
                    rings = {n: exchange_ring(g[n], i, j, ns) for n in g}
                    got = st.halo(v, rings, (i * h, j * w), (1024, 2048))
                    want = k4.field_halo_step_plain(
                        v, rings, (i * h, j * w), (1024, 2048), fl,
                        hoods[hood], nsteps=ns, compute_dtype=BF)
                    for n in sorted({f.attr for f in fl}):
                        case(f"K4-halo bf16-interior {dname} shard "
                             f"{(i * h, j * w)} ns={ns} {fname} {hood} "
                             f"channel {n}", got[n], want[n], "bits")
        del uniform, special, g
    # K5: a grid with closed tiles, and the ensemble's 4096² (none)
    for dtype in (torch.float32, BF):
        dname = str(dtype).removeprefix("torch.")
        x = rand((2, 1024, 1024), dtype)
        for ns in (1, 4, 8):
            for hood, offs in neighborhoods.items():
                case(f"K5 bf16-interior {dname} 2x(1024, 1024) block "
                     f"(128, 256) ns={ns} {hood}",
                     k5.pipeline_dense_step(x, 0.13, offs, (128, 256), ns,
                                            compute_dtype=BF),
                     k5.pipeline_step_plain(x, 0.13, offs, ns, (128, 256),
                                            BF))
        x = rand((B5, N5, N5), dtype)
        for ns in (1, 8):
            got = k5.pipeline_dense_step(x, 0.1, nsteps=ns, compute_dtype=BF)
            case(f"K5 bf16-interior {dname} {B5}x{N5}^2 ns={ns} (no closed "
                 "tile: the f32 result)", got,
                 k5.pipeline_dense_step(x, 0.1, nsteps=ns))
        del x
    print(f"bf16 interior math: every case its plain version (worst errors "
          f"{ {k: f'{v:.3e}' for k, v in out['err'].items()} }), "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # -- the main paths at full width ---------------------------------------------
    traced: dict = {}

    def run_fresh(what, kind, dname, sub, steps):
        """The row ``(kind, dname, sub, steps)`` of ``TRACED_GROUPS``: at the
        first row of a group, every row of the group in a process of its
        own (``traced_rows``); its row and its trace attempts (each attempt
        before the last, one whose trace dropped kernels, printed)."""
        key = (kind, dname, int(sub), int(steps))
        if key not in traced:
            group = next(g for g in TRACED_GROUPS if key in g)
            here = Path(__file__).resolve().parent
            t_proc = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", "import sys; sys.path.insert(0, "
                 "sys.argv[1]); import chip_smoke; "
                 "chip_smoke.traced_rows(sys.argv[2])", str(here),
                 json.dumps(group)], cwd=here, capture_output=True,
                text=True, timeout=1200)
            check(proc.returncode == 0, f"{what}: its group's traced runs "
                                        f"failed:\n{proc.stderr[-3000:]}")
            wall = time.perf_counter() - t_proc
            for line in proc.stdout.strip().splitlines():
                if line.startswith('{"spec"'):
                    got = json.loads(line)
                    got["row"].update(group_process_s=wall,
                                      group_rows=len(group))
                    traced[tuple(got["spec"])] = got
            print(f"bf16-interior traced rows {[g[0] for g in group]}: one "
                  f"process, {wall:.1f} s", flush=True)
        got = traced.pop(key)
        for i, a in enumerate(got["attempts"][:-1]):
            print(f"bf16-interior {what}: trace {i + 1} dropped kernels "
                  f"({a['launches']} launches, {a['kernels']}); its run "
                  "made and traced again", flush=True)
        return got["row"], got["attempts"]

    def fresh_row(what, kind, dname, sub, steps, want_launches):
        """One main-path row whose counted run is traced: the whole row
        (the counted run, traced, its checks and its run ms) in a process
        apart from this one, shared with its kernel family's other rows
        (``run_fresh``, ``TRACED_GROUPS``), since in this process, after
        its earlier profiles, the profiler dropped kernels of these runs
        (one near kernel of 8 K1 launches in four traces in a row; two or
        three K3 mxu walks of 8; three K4 launches of 64) while a fresh
        process traced them whole (a row whose trace still drops a kernel
        is made again, ``TRACE_RETRIES``). The launches, the checks and the kernels the
        trace shows (K1/K2's and K3 vpu's two launches,
        ``two_launch_walk``; the K3 mxu bf16-interior walk, ``k3_mxu16``;
        K4's two walks, ``k4_walk``) all come from that
        one counted run."""
        row, attempts = run_fresh(what, kind, dname, sub, steps)
        launched = row["launches"]
        check(launched == want_launches,
              f"{what}: {launched} launches, expected {want_launches}")
        check(row.pop("finite"), f"{what}: not finite")
        if "bitwise_plain" in row:
            check(row["bitwise_plain"],
                  f"{what}: the run is not its plain version's bit for bit")
        else:
            check(row["conservation_error"] <= row["mass_allowed"],
                  f"{what}: mass moved by {row['conservation_error']} "
                  f"(allowed {row['mass_allowed']})")
        if kind in ("K3 vpu", "K3 auto", "K3-halo vpu"):
            check(row.get("form") == "vpu",
                  f"{what}: the composed executor resolved "
                  f"{row.get('form')!r}, not the vpu form")
            key, walk = "k3_vpu_walk", lambda n, c, w: two_launch_walk(
                n, c, w, "K3")
        else:
            key, walk = {"K1": ("k1_walk", lambda n, c, w: two_launch_walk(
                             n, c, w, "K1/K2")),
                         "K2": ("k1_walk", lambda n, c, w: two_launch_walk(
                             n, c, w, "K1/K2")),
                         "K3": ("k3_walk", k3_mxu16),
                         "K4": ("k4_walk", k4_walk)}[kind[:2]]
        row[key] = walk(attempts[-1]["kernels"], launched, what)
        row[key]["trace_attempts"] = len(attempts)
        row = {"what": what, **row, "run_in": "its family's process"}
        out["rows"][what] = row
        print(f"bf16-interior {what}: impl={row['impl']}, launches "
              f"{launched}, |d|={row['conservation_error']:.3e}, run "
              f"{row['run_ms_median']:.3f} ms, "
              f"{row['cell_updates_per_s']:.4e} cell-updates/s; traced, "
              f"{len(attempts)} attempt(s): {row[key]}", flush=True)
        return row

    def timed(what, kernel, got, plain, bound, f32_key, f32_kernel=None,
              library=None, form="vpu", k=1, form_bound=None):
        """The variant's kernel ms (CUDA events, median of 10), its plain
        version's (one call), the function's bound, beside the f32-compute
        kernel's ms of this run (phases 4-6e, or timed here with
        ``f32_kernel``); and the kernel's result on the plain version's
        inputs (``got()``, a tensor or a dict of channels) held against the
        plain result, as the cases above hold it (``form``, ``k``): every
        variant at the main path's shapes. ``form_bound``: the bound of the
        kernel's own form where it does more operations than the
        function needs (K3 mxu's banded MMAs)."""
        k_ms = statistics.median(timed_ms(torch, kernel, reps=10))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        want = plain()
        b.record()
        torch.cuda.synchronize()
        p_ms = a.elapsed_time(b)
        res = got()
        pairs = (((f" channel {n}", res[n], want[n]) for n in res)
                 if isinstance(res, dict) else (("", res, want),))
        err = max(case(f"{what} at the main path's shape{c}", g, w, form, k)
                  for c, g, w in pairs)
        del want, res
        b_ms, b_by = bound
        ref = f32_ms.get(f32_key)
        if ref is None:
            ref = {"ms": statistics.median(timed_ms(torch, f32_kernel,
                                                    reps=10)),
                   "library_ms": statistics.median(timed_ms(
                       torch, library, reps=3))}
        out["calls"][what] = {"ms": k_ms, "plain_ms": p_ms,
                              "bound_ms": b_ms, "bound_by": b_by,
                              "f32_compute_ms": ref.get("ms"),
                              "library_ms": ref.get("library_ms"),
                              "max_abs_err": err}
        if form_bound is not None:
            out["calls"][what].update(form_bound_ms=form_bound[0],
                                      form_bound_by=form_bound[1])
        print(f"bf16-interior {what}: kernel {k_ms:.4f} ms/call (f32 "
              f"compute {ref.get('ms', float('nan')):.4f} ms), plain "
              f"{p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})"
              + (f", its form's {form_bound[0]:.4f} ms ({form_bound[1]})"
                 if form_bound else "") + f", max_abs_err {err:.3e}"
              + (f" [before the persistent walk: {MXU16_BEFORE_MS[what]} "
                 "ms, PERF.md]"
                 if what in MXU16_BEFORE_MS else "")
              + (f" [before the two launches: {VPU16_BEFORE_MS[what]} "
                 "ms, PERF.md]"
                 if what in VPU16_BEFORE_MS else ""), flush=True)

    model = mt.Model(mt.Diffusion(0.1))
    for dname, sub in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        x = (1.0 + 0.1 * torch.rand((N, N), generator=gen,
                                    device=dev)).to(tdt)
        space = mt.CellularSpace.create(N, N, 1.0, dtype=dname).with_values(
            {"value": x})
        fresh_row(f"K1 {dname} ns={sub}", "K1", dname, sub, STEPS,
                  STEPS // sub)
        y = torch.empty_like(x)
        bufs = [x.clone(), y]

        def k1_call():
            fs.pallas_dense_step(bufs[0], 0.1, nsteps=sub, out=bufs[1],
                                 compute_dtype=BF)
            bufs.reverse()

        blk = fs.resolve_block((N, N), tdt)
        inner16 = rect_cells(fs, (N, N), blk, sub)
        closed = closed_cells((N, N), sub)
        cells = N * N
        # 7 a cell-step in closed form (bf16 on the rectangle), k + 3 exact
        ops32 = sub * (7 * (closed - inner16) + 11 * (cells - closed)) / max(
            cells - inner16, 1)
        timed(f"K1 {dname} ns={sub}", k1_call,
              lambda: fs.pallas_dense_step(x, 0.1, nsteps=sub,
                                           compute_dtype=BF),
              lambda: fs.dense_step_plain(x, 0.1, MOORE_OFFSETS, sub, BF),
              bf16_form_bound_ms(cells, inner16, 7 * sub, ops32,
                                 cells * x.element_size(),
                                 cells * x.element_size()),
              f"K1 {dname} ns={sub}",
              form_bound=k1_paired_bound_ms(fs, (N, N), tdt, sub))
        out["calls"][f"K1 {dname} ns={sub}"].update(
            bf16_cells=inner16, rows=fs.window_rows(sub, MOORE_OFFSETS),
            rows16=fs.paired_rows(sub, MOORE_OFFSETS))
        for variant in ("auto", "vpu"):
            ex = mt.SerialExecutor("composed", substeps=sub,
                                   composed_variant=variant,
                                   compute_dtype=BF)
            form = "mxu" if variant == "auto" else "vpu"
            fresh_row(f"K3 {form} {dname} k={sub}",
                      "K3" if form == "mxu" else "K3 vpu", dname, sub,
                      STEPS, STEPS // sub)
            inner16 = rect_cells(fs, (N, N), blk, sub)
            nvpu = sub * 4 + 2 * sub + 1
            # the function's bound: its cheapest form's operations (vpu,
            # bf16 cells at the paired rate), as k3_bounds takes it
            bound = bf16_form_bound_ms(
                cells, inner16, nvpu, cs.vpu_ops((N, N), sub) / cells,
                cells * x.element_size(), cells * x.element_size())
            if form == "mxu":
                # the banded MMAs of the layout that runs
                form_bound = larger(2 * cells * x.element_size()
                                    / HBM_BYTES_PER_S * 1e3,
                                    mxu16_tensor_ms(cs, fs, (N, N), sub, tdt,
                                                    blk))
            else:
                # the paired walk's instructions over the tiling that runs
                form_bound = k3_paired_bound_ms(cs, fs, (N, N), tdt, sub)
            timed(f"K3 {form} {dname} k={sub}",
                  lambda: cs.composed_dense_step(x, 0.1, sub, out=y,
                                                 variant=form,
                                                 compute_dtype=BF),
                  lambda: cs.composed_dense_step(x, 0.1, sub, variant=form,
                                                 compute_dtype=BF),
                  lambda: cs.composed_dense_step_plain(
                      x, 0.1, sub, variant=form, compute_dtype=BF),
                  bound, f"K3 {form} {dname} k={sub}", form=form, k=sub,
                  form_bound=form_bound)
            if form == "vpu":
                out["calls"][f"K3 vpu {dname} k={sub}"].update(
                    bf16_cells=inner16, rows=cs.window_rows(sub,
                                                            MOORE_OFFSETS),
                    rows16=cs.paired_rows(sub, MOORE_OFFSETS))
        del x, y, bufs, space
        torch.cuda.empty_cache()

    # the composed path at substeps 2, "auto": k = 2, where JAX's rule
    # resolves to the vpu form (5 taps)
    x = (1.0 + 0.1 * torch.rand((N, N), generator=gen, device=dev))
    y = torch.empty_like(x)
    fresh_row("K3 auto float32 k=2", "K3 auto", "float32", 2, STEPS,
              STEPS // 2)
    blk = fs.resolve_block((N, N), torch.float32)
    check(cs.resolve_form("auto", 2, blk[1]) == "vpu",
          "composed substeps=2 \"auto\" does not resolve to vpu")
    inner16 = rect_cells(fs, (N, N), blk, 2)
    timed("K3 auto float32 k=2",
          lambda: cs.composed_dense_step(x, 0.1, 2, out=y, compute_dtype=BF),
          lambda: cs.composed_dense_step(x, 0.1, 2, compute_dtype=BF),
          lambda: cs.composed_dense_step_plain(x, 0.1, 2, variant="vpu",
                                               compute_dtype=BF),
          bf16_form_bound_ms(N * N, inner16, 2 * 4 + 2 * 2 + 1,
                             cs.vpu_ops((N, N), 2) / (N * N), N * N * 4,
                             N * N * 4),
          "K3 auto float32 k=2", form="vpu", k=2,
          f32_kernel=lambda: cs.composed_dense_step(x, 0.1, 2, out=y),
          library=lambda: torch.nn.functional.conv2d(
              x.view(1, 1, N, N), torch.ones((1, 1, 5, 5), device=dev),
              padding=2),
          form_bound=k3_paired_bound_ms(cs, fs, (N, N), torch.float32, 2))
    out["calls"]["K3 auto float32 k=2"].update(
        bf16_cells=inner16, rows=cs.window_rows(2, MOORE_OFFSETS),
        rows16=cs.paired_rows(2, MOORE_OFFSETS))
    del x, y
    torch.cuda.empty_cache()

    # config 4 at 8192² through the field plan
    model4 = mt.Model(config4_flows(mt))
    for dname, sub in (("float32", 1), ("float32", 8), ("bfloat16", 1),
                       ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        vals = {n: (0.5 + 1.5 * torch.rand((N4, N4), generator=gen,
                                           device=dev)).to(tdt)
                for n in ("a", "b")}
        fresh_row(f"K4 config4 {dname} ns={sub}", "K4", dname, sub, STEPS,
                  STEPS // sub)
        step = k4.PallasFieldStep((N4, N4), model4.flows, dtype=tdt,
                                  nsteps=sub, names=("a", "b"),
                                  compute_dtype=BF)
        bufs = [{n: t.clone() for n, t in vals.items()},
                {n: torch.empty_like(t) for n, t in vals.items()}]

        def k4_call():
            step(bufs[0], out=bufs[1])
            bufs.reverse()

        prog = step.program
        cells = N4 * N4
        per = prog.flops() + len(prog.outputs) * 11
        inner16 = rect_cells(fs, (N4, N4), fs.resolve_block((N4, N4), tdt),
                             sub)
        nbytes = ((len(prog.channels) + len(prog.outputs)) * cells
                  * vals["a"].element_size())
        timed(f"K4 config4 {dname} ns={sub}", k4_call,
              lambda: step(vals),
              lambda: k4.field_step_plain(vals, model4.flows, nsteps=sub,
                                          compute_dtype=BF),
              bf16_form_bound_ms(cells, inner16, per * sub, per * sub,
                                 nbytes, 0),
              f"K4 {dname} ns={sub}",
              form_bound=k4_paired_bound_ms(step.planned, 8, cells, inner16,
                                            sub, nbytes))
        out["calls"][f"K4 config4 {dname} ns={sub}"].update(
            rows=step.rows, rows16=step.planned.rows16, bf16_cells=inner16)
        del vals, bufs, step
        torch.cuda.empty_cache()

    # the 2x2 sharded K2, 16384², depth 8, f32
    x = 1.0 + 0.1 * torch.rand((N, N), generator=gen, device=dev)
    space = mt.CellularSpace.create(N, N, 1.0).with_values({"value": x})
    mesh = make_mesh_2d(2, 2, devices=[dev] * 4)
    fresh_row("K2 2x2 float32 depth=8", "K2", "float32", 8, STEPS,
              STEPS // 8 * 4)
    g, (h, w) = shards(x, (2, 2))
    ring = exchange_ring(g, 1, 1, 8)
    y = torch.empty_like(g[1][1])
    inner16 = rect_cells(fs, (h, w), fs.resolve_block((h, w), torch.float32),
                         8, (h, w), (N, N))
    closed = closed_cells((h, w), 8, (h, w), (N, N))
    ops32 = 8 * (7 * (closed - inner16) + 11 * (h * w - closed)) / max(
        h * w - inner16, 1)
    timed("K2 float32 ns=8 shard (8192, 8192)",
          lambda: fs.pallas_halo_step(g[1][1], ring, (h, w), (N, N), 0.1,
                                      nsteps=8, out=y, compute_dtype=BF),
          lambda: fs.pallas_halo_step(g[1][1], ring, (h, w), (N, N), 0.1,
                                      nsteps=8, compute_dtype=BF),
          lambda: fs.halo_step_plain(g[1][1], ring, (h, w), (N, N), 0.1,
                                     MOORE_OFFSETS, 8, BF),
          bf16_form_bound_ms(h * w, inner16, 56, ops32, h * w * 4,
                             h * w * 4),
          "K2 float32 ns=8",
          form_bound=k1_paired_bound_ms(fs, (h, w), torch.float32, 8,
                                        (h, w), (N, N)))
    out["calls"]["K2 float32 ns=8 shard (8192, 8192)"].update(
        bf16_cells=inner16, rows=fs.window_rows(8, MOORE_OFFSETS),
        rows16=fs.paired_rows(8, MOORE_OFFSETS))
    # K3-halo on 2x2 in each form, depth 8, and its shard (1, 1) a call
    # the function's bound: its cheapest form's operations (vpu)
    bound = bf16_form_bound_ms(
        h * w, inner16, 8 * 4 + 17, cs.vpu_ops(
            (h, w), 8, origin=(h, w), global_shape=(N, N)) / (h * w),
        h * w * 4, h * w * 4)
    for form in cs.FORMS:
        what = f"K3-halo {form} 2x2 float32 depth=8"
        # its run and the serial composed run (chunk for chunk, 64 steps at
        # depth 8) compared in its process
        same = fresh_row(what, "K3-halo" if form == "mxu" else
                         "K3-halo vpu", "float32", 8, STEPS,
                         STEPS // 8 * 4)["bitwise_serial"]
        record(f"{what}: bit for bit the serial composed run: {same}", same)
        check(same, f"{what} is not its serial run bit for bit")
        if form == "mxu":
            form_bound = larger(2 * h * w * 4 / HBM_BYTES_PER_S * 1e3,
                                mxu16_tensor_ms(
                                    cs, fs, (h, w), 8, torch.float32,
                                    fs.resolve_block((h, w), torch.float32),
                                    (h, w), (N, N)))
        else:
            form_bound = k3_paired_bound_ms(cs, fs, (h, w), torch.float32, 8,
                                            (h, w), (N, N))
        timed(f"K3-halo {form} float32 k=8 shard (8192, 8192)",
              lambda: cs.composed_halo_step(g[1][1], ring, (h, w), (N, N),
                                            0.1, 8, out=y, variant=form,
                                            compute_dtype=BF),
              lambda: cs.composed_halo_step(g[1][1], ring, (h, w), (N, N),
                                            0.1, 8, variant=form,
                                            compute_dtype=BF),
              lambda: cs.composed_halo_step_plain(
                  g[1][1], ring, (h, w), (N, N), 0.1, 8, variant=form,
                  compute_dtype=BF),
              bound, f"K3-halo {form} float32", form=form, k=8,
              form_bound=form_bound)
        if form == "vpu":
            out["calls"][f"K3-halo vpu float32 k=8 shard (8192, 8192)"].update(
                bf16_cells=inner16, rows=cs.window_rows(8, MOORE_OFFSETS),
                rows16=cs.paired_rows(8, MOORE_OFFSETS))
    del x, space, g, ring, y
    torch.cuda.empty_cache()

    # K4-halo: config 4 at 8192² on 2x2, depth 8, and its shard (1, 1)
    vals = {n: 0.5 + 1.5 * torch.rand((N4, N4), generator=gen, device=dev)
            for n in ("a", "b")}
    fresh_row("K4-halo config4 2x2 float32 depth=8", "K4-halo", "float32", 8,
              STEPS, STEPS // 8 * 4)
    gs, (h4, _) = {}, (N4 // 2, N4 // 2)
    for n in vals:
        gs[n], _ = shards(vals[n], (2, 2))
    st = k4.PallasFieldStep((h4, h4), model4.flows, nsteps=8,
                            names=("a", "b"), compute_dtype=BF)
    sv = {n: gs[n][1][1] for n in gs}
    rings = {n: exchange_ring(gs[n], 1, 1, 8) for n in gs}
    so = {n: torch.empty_like(t) for n, t in sv.items()}
    prog = st.program
    per = prog.flops() + len(prog.outputs) * 11
    inner16 = rect_cells(fs, (h4, h4), fs.resolve_block((h4, h4),
                                                        torch.float32), 8,
                         (h4, h4), (N4, N4))
    nbytes = (len(prog.channels) + len(prog.outputs)) * h4 * h4 * 4
    timed("K4-halo config4 float32 ns=8 shard (4096, 4096)",
          lambda: st.halo(sv, rings, (h4, h4), (N4, N4), out=so),
          lambda: st.halo(sv, rings, (h4, h4), (N4, N4)),
          lambda: k4.field_halo_step_plain(sv, rings, (h4, h4), (N4, N4),
                                           model4.flows, nsteps=8,
                                           compute_dtype=BF),
          bf16_form_bound_ms(h4 * h4, inner16, per * 8, per * 8, nbytes, 0),
          "K4-halo",
          form_bound=k4_paired_bound_ms(st.planned, 8, h4 * h4, inner16, 8,
                                        nbytes))
    out["calls"]["K4-halo config4 float32 ns=8 shard (4096, 4096)"].update(
        bf16_cells=inner16, rows=st.rows, rows16=st.planned.rows16)
    del vals, gs, sv, rings, so, st
    torch.cuda.empty_cache()

    # the ensemble: 8 x 4096² (no closed tile: the near launch alone) and
    # 4 x 8192² (blocks (512, 2048): closed tiles in every lane, the near
    # and the paired launch), each dispatch whole in one process apart
    # (_traced_k5_row: the counted dispatch traced, bit for bit its plain
    # version, the near and paired launches' device ms from its trace)
    for B, side in ((B5, N5), (4, N4)):
        what = f"K5 ensemble {B}x{side}^2 float32 substeps=8"
        row, attempts = run_fresh(what, f"K5 {B}x{side}", "float32", 8,
                                  STEPS5)
        launched = row["launches"]
        check(launched == STEPS5 // 8, f"{what}: {launched} K5 launches")
        check(row["bit_for_bit"],
              f"{what} is not its plain version bit for bit")
        row["k5_walk"] = k5_walk(attempts[-1]["kernels"], launched,
                                 row["closed"], what)
        row["k5_walk"]["trace_attempts"] = len(attempts)
        row = {"what": what, **row, "run_in": "its family's process"}
        out["rows"][what] = row
        inner = row["closed_cells_per_lane"]
        print(f"bf16-interior {what}: K5 launches {launched}, its plain "
              f"version bit for bit, {inner} closed cells a lane, "
              f"dispatch {row['dispatch_ms_median']:.3f} ms "
              f"({row['scenarios_per_s']:.2f} scenarios/s); traced, "
              f"{len(attempts)} attempt(s): {row['k5_walk']}; near launch "
              f"{row['near_ms']:.4f} ms, paired launch "
              + (f"{row['paired_ms']:.4f} ms" if row["paired_ms"]
                 else "none (no closed tile)"), flush=True)
        base = 0.5 + 1.5 * torch.rand((side, side), generator=gen,
                                      device=dev)
        xb = torch.stack([torch.roll(base, 7 * i, 0) for i in range(B)])
        del base
        yb = torch.empty_like(xb)
        cells = xb.numel()
        w3 = torch.ones((1, 1, 3, 3), device=dev)
        x4 = xb.view(B, 1, side, side)

        def conv_steps():
            t = x4
            for _ in range(8):
                t = torch.nn.functional.conv2d(t, w3, padding=1)
            return t

        call = f"K5 float32 ns=8 {B}x{side}^2"
        timed(call,
              lambda: k5.pipeline_dense_step(xb, 0.1, nsteps=8, out=yb,
                                             compute_dtype=BF),
              lambda: k5.pipeline_dense_step(xb, 0.1, nsteps=8,
                                             compute_dtype=BF),
              lambda: k5.pipeline_step_plain(xb, 0.1, nsteps=8,
                                             compute_dtype=BF),
              bf16_form_bound_ms(cells, B * inner, 56, 88, cells * 4,
                                 cells * 4),
              f"K5 float32 {B}x{side}",
              lambda: k5.pipeline_dense_step(xb, 0.1, nsteps=8, out=yb),
              conv_steps)
        # each launch's own bound: the near tiles' cells on the exact path
        # (11 f32 operations a cell-step), the rectangle's on the paired
        # form (7 a cell-step at the paired bf16 rate); each its cells read
        # and written once
        near_cells = cells - B * inner
        c = out["calls"][call]
        c.update(bf16_cells=B * inner, near_ms=row["near_ms"],
                 paired_ms=row["paired_ms"],
                 near_bound=larger(2 * near_cells * 4 / HBM_BYTES_PER_S
                                   * 1e3, 88 * near_cells / F32_FLOPS
                                   * 1e3),
                 paired_bound=larger(2 * B * inner * 4 / HBM_BYTES_PER_S
                                     * 1e3, 56 * B * inner / BF16X2_OPS
                                     * 1e3),
                 plan=k5.kernel_plan((side, side),
                                     k5.pipeline_block((side, side), 8), 8,
                                     compute_dtype=BF))
        check(c["plan"] == k5.plan_of((side, side), k5.pipeline_block(
            (side, side), 8), 8, compute_dtype=BF),
              f"{call}: the source's plan {c['plan']} is not the mirrors'")
        print(f"bf16-interior {call}: near launch {row['near_ms']:.4f} ms "
              f"(bound {c['near_bound'][0]:.4f}, {c['near_bound'][1]}), "
              "paired launch "
              + (f"{row['paired_ms']:.4f} ms (bound "
                 f"{c['paired_bound'][0]:.4f}, {c['paired_bound'][1]})"
                 if row["paired_ms"] else "none")
              + f", the call {c['ms']:.4f} ms [one kernel with both "
              f"branches: {K5_BF16_BEFORE_MS[call]} ms, PERF.md]", flush=True)
        del xb, yb, x4
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def disk_bytes(root: Path) -> int:
    """Bytes of every file under ``root``."""
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())


def checkpoint_phase(np, torch, mt, dev, root: Path, reset_counts,
                     kernel_launches, side: int = N, side5: int = N5,
                     cli_args=()) -> dict:
    """Phase 6h: checkpoints, supervision and migration at full width (see
    the module docstring). Writes under ``root`` and deletes it at the end;
    ``side``/``side5``/``cli_args`` exist for a rehearsal on the CPU."""
    import warnings

    from mpi_model_tpu_torch.cli import main as cli_main
    from mpi_model_tpu_torch.io import (CheckpointManager, migrate_scenario,
                                        run_checkpointed)
    from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d
    from mpi_model_tpu_torch.resilience import inject, supervised_run
    from mpi_model_tpu_torch.resilience import supervisor as sup
    from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan

    t_phase = time.perf_counter()
    out = {"side": side, "side5": side5, "steps": CKPT_STEPS,
           "every": CKPT_EVERY, "delta_every": DELTA_EVERY}
    saves, restores, peak = [], [], [0]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    class Recorded(CheckpointManager):
        """A manager that logs each save's and restore's figures and the
        phase's bytes on disk."""

        def save(self, space, step, extra=None, *, dirty_tiles=None):
            path = super().save(space, step, extra, dirty_tiles=dirty_tiles)
            saves.append({"dir": Path(self.directory).name,
                          **self.last_save})
            peak[0] = max(peak[0], disk_bytes(root))
            return path

        def restore(self, step, *, device=None):
            sync()
            t0 = time.perf_counter()
            ok = False
            try:
                ck = super().restore(step, device=device)
                sync()
                ok = True
                return ck
            finally:
                restores.append({"dir": Path(self.directory).name,
                                 "step": step, "ok": ok,
                                 "s": time.perf_counter() - t0})

    def counted(fn):
        """``fn()`` with the counts set to 0 just before and read just
        after: (its result, the nonzero counts)."""
        reset_counts()
        res = fn()
        sync()
        return res, {k: v for k, v in kernel_launches().items() if v}

    def print_saves(first: int, what: str) -> None:
        for s in saves[first:]:
            kind = s.get("kind", "full")
            crc = (f"crc {s['crc_s']:.3f} s, " if "crc_s" in s
                   else "(CRC in the copy) ")
            dirty = (f", {s['dirty_tiles']} dirty tiles from "
                     f"{s['dirty_from']}" if s.get("dirty_tiles") is not None
                     else "")
            print(f"  {what} save step {s['step']} {kind}: copy "
                  f"{s['copy_s']:.3f} s, {crc}write {s['write_s']:.3f} s, "
                  f"{s['bytes']} bytes{dirty}", flush=True)

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        # -- (a) the checkpointed main path, cut after step 32 and resumed
        gen = torch.Generator(device=dev).manual_seed(SEED)
        space = mt.CellularSpace({"value": 1.0 + 0.1 * torch.rand(
            (side, side), generator=gen, device=dev)}, side, side)
        model = mt.Model(mt.Diffusion(0.1))

        def serial():
            return mt.SerialExecutor("pallas", substeps=8)

        want = model.execute(space, serial(), steps=CKPT_STEPS)[0]
        want = want.values["value"]
        first = len(saves)

        def cut_and_resume():
            run_checkpointed(model, space, Recorded(str(root / "a"),
                                                    device=dev),
                             steps=32, every=CKPT_EVERY, executor=serial())
            return run_checkpointed(model, space, Recorded(
                str(root / "a"), device=dev), steps=CKPT_STEPS,
                every=CKPT_EVERY, executor=serial())

        (got, step, _), counts = counted(cut_and_resume)
        ok = step == CKPT_STEPS and torch.equal(got.values["value"], want)
        out["a"] = {"bit_for_bit": ok, "launches": counts,
                    "saves": saves[first:],
                    "restores": [r for r in restores if r["dir"] == "a"]}
        print(f"6h (a) checkpointed main path {side}^2, every "
              f"{CKPT_EVERY}, cut at 32 and resumed by a fresh manager: bit "
              f"for bit the uninterrupted run {ok}; launches {counts}",
              flush=True)
        print_saves(first, "(a)")
        for r in out["a"]["restores"]:
            print(f"  (a) restore step {r['step']}: {r['s']:.3f} s",
                  flush=True)
        check(ok, "6h (a): the resumed checkpointed run is not the "
                  "uninterrupted run bit for bit")
        check(counts == {"fused_stencil": CKPT_STEPS // 8},
              f"6h (a): launches {counts}, expected K1 x "
              f"{CKPT_STEPS // 8}")
        shutil.rmtree(root / "a")

        # -- (b) the supervised main path: exc, nan, a torn checkpoint, a
        # restart
        plan = FaultPlan((Fault("exc", at=1), Fault("nan", at=2),
                          Fault("torn", at=48, tear="truncate", offset=64)),
                         seed=SEED)
        events = []
        first = len(saves)
        syncs = sup.health_syncs()

        def supervised():
            with inject.armed(plan) as st:
                r1 = supervised_run(model, space, Recorded(
                    str(root / "b"), device=dev), steps=48,
                    every=CKPT_EVERY, executor=serial(),
                    on_event=events.append)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                r2 = supervised_run(model, space, Recorded(
                    str(root / "b"), device=dev), steps=CKPT_STEPS,
                    every=CKPT_EVERY, executor=serial(),
                    on_event=events.append)
            return r1, r2, [f["kind"] for f in st.fired], [
                str(w.message) for w in caught
                if issubclass(w.category, RuntimeWarning)]

        (r1, r2, fired, fell), counts = counted(supervised)
        syncs = sup.health_syncs() - syncs
        # chunks health-checked: 0-16, 16-32 poisoned, 16-32, 32-48, then
        # the restart's 32-48 and 48-64 (48 is torn: it falls back to 32)
        ok = (r1.step == 48 and r2.step == CKPT_STEPS
              and torch.equal(r2.space.values["value"], want))
        kinds = [e.kind for e in events]
        out["b"] = {"bit_for_bit": ok, "fired": fired, "events": [
            {"kind": e.kind, "step": e.step,
             "rolled_back_to": e.rolled_back_to,
             "classification": e.classification,
             "wall_time_s": e.wall_time_s} for e in events],
            "fallback_warnings": fell, "health_syncs": syncs,
            "chunks_checked": 6, "launches": counts,
            "saves": saves[first:],
            "restores": [r for r in restores if r["dir"] == "b"]}
        print(f"6h (b) supervised main path: fired {fired}, events "
              f"{kinds}, resume fell back past the torn step 48: "
              f"{bool(fell)}, {syncs} health-check transfers for 6 checked "
              f"chunks, launches {counts}; bit for bit the uninterrupted "
              f"run {ok}", flush=True)
        print_saves(first, "(b)")
        for r in out["b"]["restores"]:
            print(f"  (b) restore step {r['step']}: {r['s']:.3f} s "
                  f"{'ok' if r['ok'] else 'failed verification'}",
                  flush=True)
        check(fired == ["exc", "nan", "torn"], f"6h (b): fired {fired}")
        check(kinds == ["exception", "nonfinite"], f"6h (b): events {kinds}")
        check(any("failed verification" in m for m in fell),
              "6h (b): the restart did not fall back past the torn step")
        check(syncs == 6, f"6h (b): {syncs} health-check transfers for 6 "
                          "checked chunks")
        check(counts == {"fused_stencil": 2 * 6},
              f"6h (b): launches {counts}, expected K1 x 12")
        check(ok, "6h (b): the supervised run is not the uninterrupted run "
                  "bit for bit")
        shutil.rmtree(root / "b")
        del space, want, got, r1, r2

        # -- (c) the delta layout: active_fused k=8 (K6 + K7), against the
        # full layout step by step; the newest record torn, then resumed
        sparse = mt.CellularSpace({"value": torch.from_numpy(workload(
            np, side, side, 0.01, SEED)).to(dev)}, side, side)

        def active():
            return mt.SerialExecutor("active_fused", substeps=8)

        full = Recorded(str(root / "c_full"), keep=100, device=dev)
        first_full = len(saves)
        _, counts_full = counted(lambda: run_checkpointed(
            model, sparse, full, steps=CKPT_STEPS, every=DELTA_EVERY,
            executor=active()))
        delta_kw = dict(keep=100, layout="delta",
                        keyframe_every=DELTA_EVERY, device=dev)
        torn = FaultPlan((Fault("torn", at=56, channel="delta",
                                tear="truncate", offset=64),), seed=SEED)
        first = len(saves)

        def delta_run():
            with inject.armed(torn) as st:
                run_checkpointed(model, sparse, Recorded(
                    str(root / "c_delta"), **delta_kw), steps=56,
                    every=DELTA_EVERY, executor=active())
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                res = run_checkpointed(model, sparse, Recorded(
                    str(root / "c_delta"), **delta_kw), steps=CKPT_STEPS,
                    every=DELTA_EVERY, executor=active())
            return res, [f["kind"] for f in st.fired], [
                str(w.message) for w in caught
                if issubclass(w.category, RuntimeWarning)]

        (res_c, fired, fell), counts = counted(delta_run)
        chain_saves = saves[first:]
        delta = Recorded(str(root / "c_delta"), **delta_kw)
        steps_ok = delta.steps() == full.steps() == list(
            range(0, CKPT_STEPS + 1, DELTA_EVERY))
        same = {s: torch.equal(delta.restore(s).space.values["value"],
                               full.restore(s).space.values["value"])
                for s in full.steps()}
        kinds = [s["kind"] for s in chain_saves]
        sources = {s["dirty_from"] for s in chain_saves
                   if s["kind"] == "delta"}
        kf = [s for s in chain_saves if s["kind"] == "keyframe"]
        dd = [s for s in chain_saves if s["kind"] == "delta"]
        after_torn = [r["step"] for r in restores
                      if r["dir"] == "c_delta"][:2]
        out["c"] = {"steps_ok": steps_ok, "bit_for_bit": same,
                    "kinds": kinds, "dirty_from": sorted(sources),
                    "fired": fired, "fallback_warnings": fell,
                    "resume_restores": after_torn,
                    "launches_full_run": counts_full,
                    "launches_delta_runs": counts,
                    "full_saves": saves[first_full:first],
                    "chain_saves": chain_saves,
                    "restores": [r for r in restores
                                 if r["dir"].startswith("c_")],
                    "delta_over_keyframe": (
                        max(s["bytes"] for s in dd) / kf[0]["bytes"]
                        if dd and kf else None)}
        print(f"6h (c) delta layout {side}^2 at 0.01, active_fused k=8, "
              f"every {DELTA_EVERY}: records {kinds}; dirty tiles from "
              f"{sorted(sources)}; torn delta at 56 fired {fired}, the "
              f"resume tried {after_torn} (fell back: {bool(fell)}); every "
              f"committed step bit for bit the full layout's: "
              f"{all(same.values())}; launches full run {counts_full}, "
              f"delta runs {counts}", flush=True)
        print_saves(first, "(c) chain")
        for r in out["c"]["restores"]:
            print(f"  (c) restore {r['dir']} step {r['step']}: "
                  f"{r['s']:.3f} s {'ok' if r['ok'] else 'failed'}",
                  flush=True)
        print(f"  (c) full layout: {len(saves[first_full:first])} saves of "
              f"{saves[first_full]['bytes']} bytes, "
              f"{statistics.median(s['copy_s'] + s['crc_s'] + s['write_s'] for s in saves[first_full:first]):.3f} s "
              f"median each", flush=True)
        check(steps_ok, f"6h (c): chain steps {delta.steps()}, full "
                        f"{full.steps()}")
        check(all(same.values()), f"6h (c): steps not bit for bit: {same}")
        check(sources == {"executor"} and dd,
              f"6h (c): delta tiles came from {sources}")
        check(fired == ["torn"] and any("failed verification" in m
                                        for m in fell)
              and after_torn == [56, 48],
              f"6h (c): torn-delta fired {fired}, resume {after_torn}")
        check(torch.equal(res_c[0].values["value"],
                          full.restore(CKPT_STEPS).space.values["value"]),
              "6h (c): the resumed delta run's result differs")
        shutil.rmtree(root / "c_full")
        shutil.rmtree(root / "c_delta")

        # -- (d) sharded supervision: K2 at depth 8 on 2x2, a halo fault
        mesh = make_mesh_2d(2, 2, devices=[dev] * 4)

        def sharded():
            return ShardMapExecutor(mesh, "pallas", halo_depth=8)

        want_d = model.execute(sparse, sharded(), steps=CKPT_STEPS)[0]
        halo = FaultPlan((Fault("halo", at=1),), seed=SEED)

        def halo_run():
            with inject.armed(halo) as st:
                res = supervised_run(model, sparse, steps=CKPT_STEPS,
                                     every=CKPT_EVERY, executor=sharded())
            return res, [f["kind"] for f in st.fired]

        (res_d, fired), counts = counted(halo_run)
        ok = torch.equal(res_d.space.values["value"],
                         want_d.values["value"])
        kinds = [e.kind for e in res_d.events]
        chunks = CKPT_STEPS // CKPT_EVERY + 1
        out["d"] = {"bit_for_bit": ok, "fired": fired, "events": [
            {"kind": e.kind, "detail": e.detail, "step": e.step,
             "rolled_back_to": e.rolled_back_to} for e in res_d.events],
            "launches": counts}
        print(f"6h (d) sharded supervision 2x2 K2 depth 8: fired {fired}, "
              f"events {kinds} ({res_d.events[0].detail if kinds else ''}); "
              f"bit for bit the unperturbed sharded run {ok}; launches "
              f"{counts}", flush=True)
        check(fired == ["halo"] and kinds == ["conservation"],
              f"6h (d): fired {fired}, events {kinds}")
        check(ok, "6h (d): the recovered sharded run differs")
        check(counts == {"fused_stencil_halo": 4 * (CKPT_EVERY // 8)
                         * chunks},
              f"6h (d): launches {counts}")
        del want_d, res_d

        # -- (e) live migration serial <-> sharded
        want_e = model.execute(sparse, serial(), steps=CKPT_STEPS)[0]
        out["e"] = {}
        for name, src, tgt, want_counts in (
                ("serial->sharded", serial(), sharded(),
                 {"fused_stencil": 3, "fused_stencil_halo": 4 * 5}),
                ("sharded->serial", sharded(), serial(),
                 {"fused_stencil_halo": 4 * 3, "fused_stencil": 5})):
            t0 = time.perf_counter()
            res, counts = counted(lambda: migrate_scenario(
                model, sparse, source=src, target=tgt, steps=CKPT_STEPS,
                handoff_at=16, transfer_steps=8))
            wall = time.perf_counter() - t0
            ok = torch.equal(res.space.values["value"],
                             want_e.values["value"])
            out["e"][name] = {"bit_for_bit": ok,
                              "keyframe_bytes": res.keyframe_bytes,
                              "delta_bytes": res.delta_bytes,
                              "dirty_tiles": res.dirty_tiles,
                              "ntiles": res.ntiles, "wall_s": wall,
                              "launches": counts}
            print(f"6h (e) migrate {name} at step 16 + 8 in flight: bit for "
                  f"bit the serial run {ok}; keyframe {res.keyframe_bytes} "
                  f"bytes, delta {res.delta_bytes} bytes ({res.dirty_tiles} "
                  f"of {res.ntiles} tiles), {wall:.3f} s; launches {counts}",
                  flush=True)
            check(ok, f"6h (e): {name} differs from the serial run")
            check(0 < res.delta_bytes < res.keyframe_bytes,
                  f"6h (e): {name} delta {res.delta_bytes} keyframe "
                  f"{res.keyframe_bytes}")
            check(counts == want_counts, f"6h (e): {name} launches {counts}")
            del res
        del want_e, sparse

        # -- (f) ensemble migration between two pipeline services (K5)
        base = np.random.default_rng(SEED).uniform(
            0.5, 2.0, (side5, side5)).astype(np.float32)
        sp5 = mt.CellularSpace({"value": torch.from_numpy(base).to(dev)},
                               side5, side5)
        kw = dict(steps=STEPS5, impl="pipeline", substeps=8, max_batch=8)
        svc_a, svc_b, here = (mt.EnsembleService(model, **kw)
                              for _ in range(3))
        ticket = svc_a.submit(sp5)
        moved_to = svc_a.migrate(ticket, svc_b)
        (moved, _), counts = counted(lambda: svc_b.result(moved_to))
        in_place = here.result(here.submit(sp5))[0]
        ok = torch.equal(moved.values["value"], in_place.values["value"])
        out["f"] = {"bit_for_bit": ok, "launches": counts,
                    "migrated_out": svc_a.stats()["migrated_out"],
                    "migrated_in": svc_b.stats()["migrated_in"]}
        print(f"6h (f) ensemble migration {side5}^2 pipeline: bit for bit "
              f"the ticket served in place {ok}; launches {counts}",
              flush=True)
        check(ok and counts == {"pipeline_stencil": 1}
              and out["f"]["migrated_out"] == out["f"]["migrated_in"] == 1,
              f"6h (f): {out['f']}")
        for name_, svc_, k5_ in (("source", svc_a, None),
                                 ("target", svc_b,
                                  counts.get("pipeline_stencil", 0)),
                                 ("in place", here, None)):
            ladder_guard(svc_.stats(), k5_,
                         f"6h (f) the {name_} pipeline service")
        del sp5, moved, in_place

        # -- (g) the CLI
        def cli_row(argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(["run", *cli_args, *argv])
            text = buf.getvalue().strip().splitlines()[-1]
            print(text, flush=True)
            return rc, json.loads(text)

        common = ["--flow=diffusion", f"--dimx={side}", f"--dimy={side}",
                  f"--steps={CKPT_STEPS}", f"--checkpoint-every={CKPT_EVERY}",
                  "--chaos=exc:1", "--json"]
        out["g"] = {}
        for name, extra in (
                ("full", [f"--checkpoint-dir={root / 'g_full'}"]),
                ("delta", [f"--checkpoint-dir={root / 'g_delta'}",
                           "--checkpoint-layout=delta",
                           "--impl=active_fused", "--substeps=8",
                           "--blob=0.01"])):
            rc, row = cli_row(common + extra)
            peak[0] = max(peak[0], disk_bytes(root))
            out["g"][name] = row
            check(rc == 0 and row["conserved"]
                  and row["recovered_failures"] == 1
                  and row["injected_faults"] == 1
                  and [e["kind"] for e in row["events"]] == ["exception"]
                  and row["checkpoint_steps"][-1] == CKPT_STEPS,
                  f"6h (g): the {name} CLI run did not recover: {row}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["peak_disk_bytes"] = peak[0]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"6h: {out['seconds']:.1f} s, peak {peak[0]} bytes on disk "
          f"(cuts: none; {CKPT_STEPS} steps as phase 4)", flush=True)
    return out


IR_MODELS = ("gray_scott", "sir", "predator_prey")
IR_SHARDED_STEPS = 16  # phase 6i (d)'s and (e)'s runs
IR_ENSEMBLE_STEPS = 16  # phase 6i (c)'s dispatch


def ir_bytes_bound_ms(model, space) -> float:
    """The least time of one step of a nonlinear IR model from bytes: every
    channel a term reads or writes (budgets included) read once and every
    written channel written once, over the card's memory rate."""
    from mpi_model_tpu_torch.ir import lower

    terms = model.ir_terms
    n = (len(lower.involved_channels(terms))
         + len(lower.written_channels(terms)))
    item = space.values[lower.written_channels(terms)[0]].element_size()
    return n * space.dim_x * space.dim_y * item / HBM_BYTES_PER_S * 1e3


def ir_profiles(side: str) -> None:
    """Phase 6i's profiles, in a process apart from the script's (in the
    script's long process the profiler dropped kernels of these steps, 245
    of 276 on one H100 80GB HBM3 at 700 W, as PERF.md §7 records):
    per nonlinear library model at ``side``², the device activity of 4
    ``xla`` steps and of 4 ``active`` steps (``profile_dispatch`` against
    their CUDA-event time, median of 3). Prints one JSON line."""
    import torch

    import mpi_model_tpu_torch as mt
    from mpi_model_tpu_torch.ir import library

    out = {}
    for name in IR_MODELS:
        model, space = library.MODELS[name](int(side), dtype="float32",
                                            device=torch.device("cuda"))
        for impl in ("xla", "active"):
            ex = mt.SerialExecutor(impl)
            wall = statistics.median(timed_ms(
                torch, lambda: ex.run_model(model, space, 4), reps=3))
            out[f"{name} {impl}"] = profile_dispatch(
                torch, lambda: ex.run_model(model, space, 4), wall)
        del space
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def ir_phase(np, torch, mt, dev, reset_counts, kernel_launches, side=N,
             side_nl=N4, side5=N5, lanes=B5, steps=STEPS,
             cli_args=()) -> dict:
    """Phase 6i: the Flow IR on the card (see the module docstring). (a)
    ``ir.library.diffusion`` at ``side``² through K1, K3, K6/K7 and K2, and
    the ensemble's K5 over ``lanes`` × ``side5``², each bit for bit and
    launch for launch the flow-built ``Model([Diffusion(0.1)])``; (b) the
    three nonlinear library models at ``side_nl``² through ``xla``,
    ``composed`` (substeps 4: k = 1, warned) and ``active``, bit for bit
    with each other, conservation checked; (c) ``gray_scott`` as an
    ensemble with per-lane F and k, each lane bit for bit its serial run;
    (d) ``gray_scott`` on 2×2 against serial; (e) the CLI's ``--model``.
    ``check`` fails the run on any disagreement."""
    import warnings

    from mpi_model_tpu_torch.cli import main as cli_main
    from mpi_model_tpu_torch.ensemble import EnsembleExecutor
    from mpi_model_tpu_torch.ir import library
    from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    out = {"linear": {}, "nonlinear": {}}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def same(a, b) -> bool:
        return all(torch.equal(a.values[k], b.values[k]) for k in b.values)

    def counted(fn):
        """``fn()`` with every count set to 0 just before and read just
        after: (its result, the nonzero counts)."""
        reset_counts()
        res = fn()
        sync()
        return res, {k: v for k, v in kernel_launches().items() if v}

    def run_ms(fn, reps=3) -> float:
        if on_card:
            return statistics.median(timed_ms(torch, fn, reps=reps))
        t = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            t.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(t)

    # -- (a) the linear model through the kernels, against the flow model ----
    ir_m, space = library.diffusion(side, rate=0.1, dtype="float32",
                                    device=dev)
    flow_m = mt.Model(mt.Diffusion(0.1), ir_m.time, ir_m.time_step)
    mesh = make_mesh_2d(2, 2, devices=[dev] * 4)
    for what, make, kernels in (
            ("K1 pallas substeps=8",
             lambda: mt.SerialExecutor("pallas", substeps=8),
             ("fused_stencil",)),
            ("K3 composed substeps=8",
             lambda: mt.SerialExecutor("composed", substeps=8),
             ("composed_stencil",)),
            ("K6/K7 active_fused k=8",
             lambda: mt.SerialExecutor("active_fused", substeps=8),
             ("fused_compute", "fused_scatter")),
            ("K2 2x2 pallas depth=8",
             lambda: ShardMapExecutor(mesh, "pallas", halo_depth=8),
             ("fused_stencil_halo",))):
        runs = {}
        for label, m in (("ir", ir_m), ("flow", flow_m)):
            ex = make()
            (res, rep), launched = counted(
                lambda: m.execute(space, ex, steps=steps))
            runs[label] = (res, rep, launched, ex)
        (a, ra, la, ex_ir), (b, rb, lb, ex_flow) = runs["ir"], runs["flow"]
        bitwise = same(a, b)
        # the IR model and the flow model in turns: ir, flow, flow, ir
        t = [run_ms(lambda: ex.run_model(m, space, steps))
             for m, ex in ((ir_m, ex_ir), (flow_m, ex_flow),
                           (flow_m, ex_flow), (ir_m, ex_ir))]
        ms, flow_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        row = {"impl": ra.impl, "launches": la, "flow_launches": lb,
               "bit_for_bit_flow_model": bitwise, "run_ms": ms,
               "flow_run_ms": flow_ms, "turns_ms": t,
               "cell_updates_per_s": side * side * steps / (ms / 1e3),
               "backend_report": ra.backend_report}
        out["linear"][what] = row
        print(f"6i (a) diffusion IR {side}^2 {what}: impl={ra.impl}, "
              f"launches {la} (flow model {lb}), bit for bit the flow model "
              f"{bitwise}, run {ms:.3f} ms (flow model {flow_ms:.3f}; "
              f"{row['cell_updates_per_s']:.4e} cell-updates/s)",
              flush=True)
        check(bitwise, f"6i (a) {what}: the IR run is not the flow model's "
                       "bit for bit")
        check(la == lb, f"6i (a) {what}: launches {la} != the flow model's "
                        f"{lb}")
        check(all(la.get(k, 0) > 0 for k in kernels),
              f"6i (a) {what}: {kernels} not launched ({la})")
        del a, b, runs
    del space

    ir5, s5 = library.diffusion(side5, rate=0.1, dtype="float32", device=dev)
    flow5 = mt.Model(mt.Diffusion(0.1), ir5.time, ir5.time_step)
    spaces = [s5.with_values({"value": torch.roll(s5.values["value"], 7 * i,
                                                  0).contiguous()})
              for i in range(lanes)]
    got = {}
    for label, m in (("ir", ir5), ("flow", flow5)):
        res, launched = counted(lambda: m.execute_many(
            spaces, executor=EnsembleExecutor("pipeline", substeps=8),
            steps=8))
        got[label] = (res, launched)
    lanes_ok = all(same(a, b) for (a, _), (b, _) in zip(got["ir"][0],
                                                        got["flow"][0]))
    out["linear"]["K5 pipeline"] = {"lanes": lanes, "side": side5,
                                    "launches": got["ir"][1],
                                    "flow_launches": got["flow"][1],
                                    "bit_for_bit_flow_dispatch": lanes_ok}
    print(f"6i (a) diffusion IR ensemble {lanes}x{side5}^2 pipeline "
          f"substeps=8: launches {got['ir'][1]} (flow dispatch "
          f"{got['flow'][1]}), every lane bit for bit the flow dispatch "
          f"{lanes_ok}", flush=True)
    check(lanes_ok, "6i (a) the IR ensemble is not the flow dispatch's bit "
                    "for bit")
    check(got["ir"][1] == got["flow"][1]
          and got["ir"][1].get("pipeline_stencil", 0) > 0,
          f"6i (a) K5 launches {got['ir'][1]} against {got['flow'][1]}")
    del spaces, got

    # -- (b) the nonlinear models through xla, composed and active -----------
    profiles = {}
    if on_card:
        here = Path(__file__).resolve().parent
        proc = subprocess.run(
            [sys.executable, "-c", "import sys; sys.path.insert(0, "
             "sys.argv[1]); import chip_smoke; "
             "chip_smoke.ir_profiles(sys.argv[2])", str(here),
             str(side_nl)], cwd=here, capture_output=True, text=True,
            timeout=600)
        check(proc.returncode == 0, "6i (b) the profiles' process failed:"
                                    f"\n{proc.stderr[-3000:]}")
        profiles = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in IR_MODELS:
        model, space = library.MODELS[name](side_nl, dtype="float32",
                                            device=dev)
        runs, row = {}, {"steps": steps, "side": side_nl}
        for impl, kw in (("xla", {}), ("composed", {"substeps": 4}),
                         ("active", {})):
            ex = mt.SerialExecutor(impl, **kw)
            with warnings.catch_warnings(record=True) as warned:
                warnings.simplefilter("always")
                (res, rep), launched = counted(
                    lambda: model.execute(space, ex, steps=steps,
                                          check_conservation=True))
            ms = run_ms(lambda: ex.run_model(model, space, steps), reps=2)
            runs[impl] = res
            r = {"impl": rep.impl, "launches": launched,
                 "run_ms": ms, "ms_per_step": ms / steps,
                 "cell_updates_per_s": side_nl * side_nl * steps
                 / (ms / 1e3),
                 "budget_error": model.report_conservation_error(rep),
                 "budget_threshold": model.conservation_threshold(space)}
            if impl == "composed":
                r["k1_warning"] = any("forces k=1" in str(w.message)
                                      for w in warned)
                check(r["k1_warning"], f"6i (b) {name} composed: no k=1 "
                                       "warning")
            if impl == "active":
                br = rep.backend_report or {}
                r.update(fallback_steps=br.get("fallback_steps"),
                         mean_active_fraction=br.get("mean_active_fraction"),
                         host_syncs=br.get("host_syncs"))
            check(not launched, f"6i (b) {name} {impl}: a kernel was "
                                f"launched ({launched}); the nonlinear "
                                "terms run plain torch ops")
            row[impl] = r
        bitwise = {impl: same(runs[impl], runs["xla"])
                   for impl in ("composed", "active")}
        row["bit_for_bit_xla"] = bitwise
        row["bytes_bound_ms_per_step"] = ir_bytes_bound_ms(model, space)
        act_row = row["active"]
        if name == "sir":
            check(act_row["fallback_steps"] is not None
                  and act_row["fallback_steps"] < steps
                  and act_row["mean_active_fraction"] < 1.0,
                  f"6i (b) sir active skipped no tile: {act_row}")
        if name == "gray_scott":
            check(act_row["fallback_steps"] == steps,
                  f"6i (b) gray_scott active did not fall back to dense "
                  f"every step: {act_row}")
        for impl in ("xla", "active"):
            if f"{name} {impl}" in profiles:
                row[f"{impl}_profile_4_steps"] = profiles[f"{name} {impl}"]
        out["nonlinear"][name] = row
        prof = row.get("xla_profile_4_steps", {})
        print(f"6i (b) {name} {side_nl}^2 f32 {steps} steps: "
              + ", ".join(f"{impl} {row[impl]['ms_per_step']:.3f} ms/step "
                          f"({row[impl]['cell_updates_per_s']:.4e} "
                          "cell-updates/s)"
                          for impl in ("xla", "composed", "active"))
              + f"; bytes bound {row['bytes_bound_ms_per_step']:.4f} "
              f"ms/step; xla idle share {prof.get('idle_share')}, active "
              f"{row.get('active_profile_4_steps', {}).get('idle_share')}; "
              "composed "
              f"and active bit for bit xla {bitwise}; budgets reconciled "
              f"(|d| {row['xla']['budget_error']:.3e} <= "
              f"{row['xla']['budget_threshold']:.3e}); active: fallback "
              f"steps {act_row['fallback_steps']}, mean active fraction "
              f"{act_row['mean_active_fraction']}", flush=True)
        check(all(bitwise.values()), f"6i (b) {name}: impls disagree "
                                     f"{bitwise}")
        del runs, space

    # -- (c) gray_scott as an ensemble, per-lane F and k ----------------------
    gs, g5 = library.gray_scott(side5, dtype="float32", device=dev)
    Du, Dv, react, F0, kill0 = gs.term_rates()
    k0 = kill0 - F0
    models, spaces = [], []
    for i in range(lanes):
        Fi = F0 * (1 + 0.05 * i / max(lanes - 1, 1))
        ki = k0 * (1 - 0.05 * i / max(lanes - 1, 1))
        models.append(gs.with_rates([Du, Dv, react, Fi, Fi + ki]))
        spaces.append(g5.with_values({
            **g5.values,
            **{c: torch.roll(g5.values[c], 7 * i, 0).contiguous()
               for c in ("u", "v")}}))
    res, launched = counted(lambda: gs.execute_many(
        spaces, models=models, executor=EnsembleExecutor("xla"),
        steps=IR_ENSEMBLE_STEPS))
    lane_ok = []
    for m, sp, (got_sp, _) in zip(models, spaces, res):
        want, _ = m.execute(sp, mt.SerialExecutor("xla"),
                            steps=IR_ENSEMBLE_STEPS)
        lane_ok.append(same(got_sp, want))
    out["ensemble"] = {"lanes": lanes, "side": side5,
                       "steps": IR_ENSEMBLE_STEPS,
                       "bit_for_bit_serial": lane_ok, "launches": launched}
    print(f"6i (c) gray_scott ensemble {lanes}x{side5}^2 xla, per-lane F/k, "
          f"{IR_ENSEMBLE_STEPS} steps: each lane bit for bit its serial run "
          f"{lane_ok}", flush=True)
    check(all(lane_ok), f"6i (c) ensemble lanes disagree: {lane_ok}")
    del res, spaces

    # -- (d) gray_scott on 2x2 against serial ---------------------------------
    model, space = library.gray_scott(side_nl, dtype="float32", device=dev)
    want, _ = model.execute(space, mt.SerialExecutor("xla"),
                            steps=IR_SHARDED_STEPS)
    ex = ShardMapExecutor(mesh, "xla")
    (got_sp, rep), launched = counted(
        lambda: model.execute(space, ex, steps=IR_SHARDED_STEPS))
    ok = same(got_sp, want)
    ms = run_ms(lambda: ex.run_model(model, space, IR_SHARDED_STEPS),
                reps=2)
    out["sharded"] = {"mesh": "2x2", "steps": IR_SHARDED_STEPS,
                      "bit_for_bit_serial": ok, "comm_size": rep.comm_size,
                      "run_ms": ms}
    print(f"6i (d) gray_scott {side_nl}^2 on 2x2 ShardMapExecutor(xla), "
          f"{IR_SHARDED_STEPS} steps: bit for bit serial {ok}, run "
          f"{ms:.3f} ms", flush=True)
    check(ok and rep.comm_size == 4, "6i (d) the sharded run is not the "
                                     "serial run bit for bit")
    del want, got_sp, space

    # -- (e) the CLI ----------------------------------------------------------
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["run", "--model=gray_scott", f"--dimx={side_nl}",
                       f"--dimy={side_nl}", f"--steps={IR_SHARDED_STEPS}",
                       "--json", *cli_args])
    print(buf.getvalue(), end="", flush=True)
    row = json.loads(buf.getvalue().strip().splitlines()[-1])
    out["cli"] = row
    check(rc == 0 and row["conserved"] is True,
          f"6i (e) the --model CLI run is not conserved: {row}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"6i: {out['seconds']:.1f} s", flush=True)
    return out


def ir_phase_main() -> None:
    """Phase 6i alone on the card (``python3 -c "import chip_smoke;
    chip_smoke.ir_phase_main()"``): builds the sources and runs
    ``ir_phase``; the rows go to ``chiprun_out/chip_smoke_6i.json``."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import mpi_model_tpu_torch as mt
    from mpi_model_tpu_torch.models.model import kernel_launches
    from mpi_model_tpu_torch.ops import _build
    from mpi_model_tpu_torch.ops import composed_stencil as cs
    from mpi_model_tpu_torch.ops import field_stencil as k4
    from mpi_model_tpu_torch.ops import fused_active as fa
    from mpi_model_tpu_torch.ops import fused_stencil as fs
    from mpi_model_tpu_torch.ops import pipeline_stencil as k5

    def reset_counts():
        for mod in (fs, cs, k4, k5, fa):
            mod.reset_launches()

    _build.build_all()
    dev = torch.device("cuda")
    out = ir_phase(np, torch, mt, dev, reset_counts, kernel_launches)
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_6i.json").write_text(json.dumps(out, indent=1))


#: phase 6j's ensemble soak: 16 scenarios of N5² through the always-on
#: service, a snapshot every OBS_SNAPSHOT_S seconds of it
OBS_SCENARIOS = 16
OBS_SNAPSHOT_S = 0.02
#: phase 6j (h)'s native run: 1024² f32, 64 steps (the native engine runs
#: on the host, so the grid is cut; the reference scenario is 100²)
NATIVE_SIDE = 1024
#: phase 6j (f)'s probe runs: the CLI's K1 run at this side
CACHE_PROBE_SIDE = 1024


def compile_cache_probe(cache_dir: str, *cli_args: str) -> None:
    """Phase 6j (f)'s fresh process: the CLI's K1 run with
    ``--compile-cache=<cache_dir>`` (``--impl=pallas --substeps=8``, 64 steps
    of ``CACHE_PROBE_SIDE``², ``cli_args`` added), then one JSON line: its
    row, every library the process built or loaded (``_build.build_info``:
    seconds, cached) and its seconds."""
    t0 = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mpi_model_tpu_torch.cli import main as cli_main
    from mpi_model_tpu_torch.ops import _build

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["run", "--flow=diffusion",
                       f"--dimx={CACHE_PROBE_SIDE}",
                       f"--dimy={CACHE_PROBE_SIDE}", "--impl=pallas",
                       "--substeps=8", f"--steps={STEPS}",
                       f"--compile-cache={cache_dir}", "--json", *cli_args])
    print(json.dumps({
        "rc": rc, "row": json.loads(buf.getvalue().strip().splitlines()[-1]),
        "build_dir": str(_build.BUILD_DIR),
        "build": {k: {"seconds": v["seconds"], "cached": v["cached"],
                      "library": v["library"]}
                  for k, v in _build.build_info.items()},
        "seconds": time.perf_counter() - t0}), flush=True)


def k1_space(torch, mt, dev, side: int):
    """Phase 4's grid: ``U(0.5, 2.0)`` f32 from ``SEED``, made on the
    device."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return mt.CellularSpace({"value": 0.5 + 1.5 * torch.rand(
        (side, side), generator=gen, device=dev)}, side, side)


def device_trace_count(logdir: str, side: str) -> None:
    """Phase 6j (b), in a process apart from the script's: (a)'s K1 run
    (64 steps of ``side``², substeps 8) under ``Tracer.device_trace``, the
    work between two spins of the device so the window holds all of it;
    prints one JSON line: the K1 launches counted and the K1 kernels in the
    Chrome trace written to ``logdir``."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import mpi_model_tpu_torch as mt
    from mpi_model_tpu_torch.ops import fused_stencil as fs
    from mpi_model_tpu_torch.utils import Tracer, set_tracer

    dev = torch.device("cuda")
    space = k1_space(torch, mt, dev, int(side))
    model = mt.Model(mt.Diffusion(0.1))
    ex = mt.SerialExecutor("pallas", substeps=8)
    model.execute(space, ex, steps=STEPS)  # build and warm
    torch.cuda.synchronize()
    tr = Tracer()
    set_tracer(tr)
    t0 = time.perf_counter()
    before = fs.launches()
    with tr.device_trace(logdir):
        time.sleep(0.05)
        torch.cuda._sleep(100_000_000)
        model.execute(space, ex, steps=STEPS)
        torch.cuda._sleep(100_000_000)
        torch.cuda.synchronize()
        time.sleep(0.05)
    launched = fs.launches() - before
    with open(Path(logdir) / "device_trace.pt.trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    k1 = {}
    for e in events:
        if e.get("cat") == "kernel" and "fused_stencil" in e.get("name", ""):
            k1[e["name"]] = k1.get(e["name"], 0) + 1
    print(json.dumps({"launches": launched, "trace_kernels": k1,
                      "spans": [s.name for s in tr.spans],
                      "trace_s": time.perf_counter() - t0}), flush=True)


def observability_phase(np, torch, mt, dev, side=N, side5=N5,
                        scenarios=OBS_SCENARIOS, steps=STEPS,
                        native_side=NATIVE_SIDE, cli_args=()) -> dict:
    """Phase 6j (a)-(e), (g), (h): the tracer, the roofline, the status
    plane and the native engine on the card (see the module docstring).
    ``check`` fails the run on any disagreement."""
    import statistics as stats_
    import urllib.request
    import warnings

    from mpi_model_tpu_torch import native, obs, oracle
    from mpi_model_tpu_torch.cli import main as cli_main
    from mpi_model_tpu_torch.ensemble import (AsyncEnsembleService,
                                              buckets_for, run_soak)
    from mpi_model_tpu_torch.models.model import kernel_launches
    from mpi_model_tpu_torch.ops import fused_stencil as fs
    from mpi_model_tpu_torch.parallel import ShardMapExecutor, make_mesh_2d
    from mpi_model_tpu_torch.resilience import inject, supervised_run
    from mpi_model_tpu_torch.utils import (Tracer, chip_peaks, set_tracer,
                                           stencil_roofline)

    on_card = dev.type == "cuda"
    here = Path(__file__).resolve().parent
    out_dir = here / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    out = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def traced(tracer, fn):
        """``fn()`` with ``tracer`` as the process tracer, and the implicit
        host syncs it made (torch's sync debug mode; on the card)."""
        prev = set_tracer(tracer)
        sync()
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                res = fn()
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
            set_tracer(prev)
        return res, sum("synchroniz" in str(x.message) for x in w)

    def same(a, b) -> bool:
        return all(torch.equal(a.values[k], b.values[k]) for k in b.values)

    # -- (a) K1 traced against untraced ----------------------------------------
    space = k1_space(torch, mt, dev, side)
    model = mt.Model(mt.Diffusion(0.1))
    ex = mt.SerialExecutor("pallas", substeps=8)
    model.execute(space, ex, steps=steps)  # build and warm
    tr = Tracer()
    before = fs.launches()
    (got, rep), syncs_on = traced(tr, lambda: model.execute(
        space, ex, steps=steps))
    launched = fs.launches() - before
    (want, _), syncs_off = traced(Tracer(enabled=False),
                                  lambda: model.execute(space, ex,
                                                        steps=steps))
    bitwise = same(got, want)
    names = [s.name for s in tr.spans]
    exs = tr.spans[-1]
    nested = (names == ["executor.run", "model.report", "model.execute"]
              and all(s.parent_id == exs.span_id and s.depth == 1
                      for s in tr.spans[:2])
              and exs.meta == {"steps": steps, "executor": "SerialExecutor"})
    # the overhead as JAX's bench defines it: traced wall over untraced
    # wall, less one, the median of rounds in turns (4 runs an arm a round;
    # a first round, not kept, settles the card's clocks)
    ratios = []
    for r in range(-1, 3):
        walls = {}
        for mode in (("on", "off") if r % 2 == 0 else ("off", "on")):
            prev = set_tracer(Tracer(enabled=mode == "on"))
            try:
                sync()
                t0 = time.perf_counter()
                for _ in range(4):
                    model.execute(space, ex, steps=steps)
                walls[mode] = time.perf_counter() - t0
            finally:
                set_tracer(prev)
        if r >= 0:
            ratios.append(walls["on"] / walls["off"] - 1.0)
    overhead = stats_.median(ratios)
    peaks = chip_peaks(dev)
    if on_card:
        call_ms = stats_.median(timed_ms(torch, lambda: fs.pallas_dense_step(
            space.values["value"], 0.1, model.offsets, nsteps=8), reps=5))
    else:
        t0 = time.perf_counter()
        fs.pallas_dense_step(space.values["value"], 0.1, model.offsets,
                             nsteps=8)
        call_ms = (time.perf_counter() - t0) * 1e3
    roof = stencil_roofline(side, 4, call_ms / 8 / 1e3, substeps=8,
                            device=dev)
    bytes_call = 2.0 * side * side * 4  # bound_ms's bytes for K1 at ns=8
    out["a"] = {
        "impl": rep.impl, "launches": launched, "bit_for_bit": bitwise,
        "host_syncs_traced": syncs_on, "host_syncs_untraced": syncs_off,
        "spans": names, "nested": nested, "overhead_rounds": ratios,
        "tracing_overhead_frac": overhead, "chip_peaks": peaks,
        "k1_call_ms": call_ms, "roofline": roof,
        "bound_ms_from_peaks": (bytes_call / (peaks["hbm_gbps"] * 1e9) * 1e3
                                if peaks else None),
        "bound_ms_data_sheet": bytes_call / HBM_BYTES_PER_S * 1e3}
    print(f"6j (a) K1 {side}^2 f32 substeps=8, {steps} steps traced: "
          f"impl={rep.impl}, {launched} launches, bit for bit the untraced "
          f"run {bitwise}, implicit host syncs {syncs_on} traced / "
          f"{syncs_off} untraced, spans {names} nested as JAX's {nested}; "
          f"tracing_overhead_frac {overhead:.5f} (rounds {ratios})",
          flush=True)
    print(f"6j (a) chip_peaks: {peaks}", flush=True)
    print(f"6j (a) roofline of K1's call ({call_ms:.4f} ms at ns=8): "
          f"{roof}; bytes a call {roof['bytes_per_step'] * 8:.0f} (the "
          f"bound's {bytes_call:.0f}), bound {out['a']['bound_ms_from_peaks']}"
          f" ms from the card's peaks, {out['a']['bound_ms_data_sheet']:.4f}"
          " ms from the data sheet's", flush=True)
    check(rep.impl == "pallas" and launched == steps // 8,
          f"6j (a) the run took {rep.impl} with {launched} launches")
    check(bitwise, "6j (a) the traced run is not the untraced run")
    check(syncs_on == syncs_off, f"6j (a) the traced run synced the host "
                                 f"{syncs_on} times, untraced {syncs_off}")
    check(nested, f"6j (a) spans {names} do not nest as JAX's")
    check(roof["bytes_per_step"] * 8 == bytes_call,
          "6j (a) the roofline's bytes a call are not the bound's")
    if on_card:
        check(peaks is not None, "6j (a) chip_peaks is None on the card")
        check(abs(peaks["hbm_gbps"] / 3350 - 1) < 0.02
              and abs(peaks["vpu_gops"] / 67_000 - 1) < 0.02,
              f"6j (a) chip_peaks {peaks} are not within 2% of 3.35 TB/s "
              "and 67 TFLOP/s")
        check(overhead <= 0.02, f"6j (a) tracing overhead {overhead:.4f} "
                                "exceeds 2% of the untraced wall")
    del got, want

    # -- (b) device_trace, in a process apart ----------------------------------
    if on_card:
        logdir = out_dir / "device_trace_6j"
        shutil.rmtree(logdir, ignore_errors=True)
        proc = subprocess.run(
            [sys.executable, "-c", "import sys; sys.path.insert(0, "
             "sys.argv[1]); import chip_smoke; "
             "chip_smoke.device_trace_count(sys.argv[2], sys.argv[3])",
             str(here), str(logdir), str(side)], cwd=here,
            capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, "6j (b) the device_trace process "
                                    f"failed:\n{proc.stderr[-3000:]}")
        b = json.loads(proc.stdout.strip().splitlines()[-1])
        shutil.rmtree(logdir, ignore_errors=True)
        out["b"] = b
        n = sum(b["trace_kernels"].values())
        print(f"6j (b) device_trace of (a)'s run in its own process: "
              f"{b['launches']} K1 launches, {n} K1 kernels in the written "
              f"trace {b['trace_kernels']}, spans {b['spans']} "
              f"({b['trace_s']:.1f} s)", flush=True)
        check(b["launches"] == steps // 8 and n == b["launches"]
              and b["spans"] == ["executor.run", "model.report",
                                 "model.execute", "device_trace"],
              f"6j (b) the trace's K1 kernels {b} are not the launches")

    # -- (c) K2 on 2x2, depth 8 --------------------------------------------------
    mesh = make_mesh_2d(2, 2, devices=None if on_card else [dev] * 4)
    tr = Tracer()
    k2 = ShardMapExecutor(mesh, "pallas", halo_depth=8)
    before = fs.halo_launches()
    (got, rep), _ = traced(tr, lambda: model.execute(space, k2,
                                                     steps=steps))
    (again, _), _ = traced(tr, lambda: model.execute(space, k2,
                                                     steps=steps))
    halo = fs.halo_launches() - before
    (serial, _), _ = traced(Tracer(enabled=False), lambda: model.execute(
        space, mt.SerialExecutor("pallas", substeps=8), steps=steps))
    builds = [s for s in tr.spans if s.name == "shardmap.build"]
    firsts = [s for s in tr.spans if s.name == "shardmap.compile+first_run"]
    ok = same(got, serial) and same(again, serial)
    out["c"] = {"bit_for_bit_serial": ok, "halo_launches": halo,
                "builds": [s.meta for s in builds],
                "compile_first_runs": [s.meta for s in firsts],
                "build_ms": [s.duration_s * 1e3 for s in builds]}
    print(f"6j (c) K2 {side}^2 on 2x2 depth 8, two runs: bit for bit the "
          f"serial K1 run {ok}; {halo} K2 launches; shardmap.build spans "
          f"{out['c']['builds']} ({out['c']['build_ms']} ms), "
          f"compile+first_run {out['c']['compile_first_runs']}", flush=True)
    check(ok, "6j (c) the K2 run is not the serial run bit for bit")
    check(len(builds) == 1 and builds[0].meta == {"impl": "pallas-deep",
                                                   "depth": 8}
          and len(firsts) == 1, "6j (c) not one shardmap.build span a build")
    if on_card:
        check(halo == 2 * 4 * steps // 8, f"6j (c) K2 launches {halo}")
    del got, again, serial, space
    torch.cuda.empty_cache() if on_card else None

    # -- (d) the serving stack under the status plane --------------------------
    base = np.random.default_rng(SEED).uniform(0.5, 2.0, (side5, side5))
    spaces = [mt.CellularSpace({"value": torch.from_numpy(
        np.roll(base, 7 * i, axis=0).astype(np.float32)).to(dev)},
        side5, side5) for i in range(scenarios)]
    del base
    tr = Tracer()
    rec = obs.FlightRecorder(dump_dir=str(out_dir / "flight_6j"))
    prev_tr, prev_rec = set_tracer(tr), obs.set_recorder(rec)
    snap = out_dir / "snapshot_6j.json"
    servers, scrapes, snapshots = [], [], []
    real_serve, real_write = obs.serve_status, obs.write_snapshot

    def capture(port, fn, host="127.0.0.1"):
        servers.append(real_serve(port, fn, host=host))
        return servers[-1]

    def write(path, service=None, **kw):
        doc = real_write(path, service, **kw)
        obs.validate_snapshot(doc)
        snapshots.append(doc["stats"]["dispatches"])
        return doc

    # the loopback only: no proxy from the environment is consulted
    loopback = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    obs.serve_status, obs.write_snapshot = capture, write
    try:
        with AsyncEnsembleService(mt.Model(mt.Diffusion(0.1)), steps=8,
                                  impl="pipeline", substeps=8,
                                  buckets=buckets_for(B5),
                                  max_queue=64) as svc:
            svc.result(svc.submit(spaces[0]), timeout=600)  # the build
            base_stats = svc.stats()
            tr.clear()
            submits = []

            class Client:
                """The service, a span around each submit and a scrape of
                the live endpoint after each result."""

                def submit(self, space, **kw):
                    with tr.span("client.submit") as m:
                        t = svc.submit(space, **kw)
                        m["ticket"] = t
                        submits.append(tr.current())
                    return t

                def result(self, t, **kw):
                    res = svc.result(t, **kw)
                    port = servers[0].server_address[1]
                    with loopback.open(f"http://127.0.0.1:{port}/metrics",
                                       timeout=30) as r:
                        scrapes.append(r.read().decode())
                    return res

                def stats(self):
                    return svc.stats()

            ran0 = kernel_launches()
            soak = run_soak(Client(), [(s, None, None) for s in spaces],
                            arrival_rate_hz=1e9, snapshot_path=str(snap),
                            snapshot_interval_s=OBS_SNAPSHOT_S,
                            status_port=0)
            sync()
            k5 = kernel_launches()["pipeline_stencil"] - \
                ran0["pipeline_stencil"]
            final = svc.stats()
    finally:
        obs.serve_status, obs.write_snapshot = real_serve, real_write
        set_tracer(prev_tr)
        obs.set_recorder(prev_rec)
    ctx = {c.span_id: c for c in submits}
    disp = [s for s in tr.spans if s.name in ("ensemble.assemble",
                                              "ensemble.launch",
                                              "ensemble.fetch")]
    parented = bool(disp) and all(
        s.parent_id in ctx and ctx[s.parent_id].trace_id == s.trace_id
        for s in disp)
    last = {}
    for line in scrapes[-1].splitlines():
        if line and not line.startswith("#"):
            k, v = line.rsplit(" ", 1)
            last[k] = float(v)
    with open(snap) as fh:
        doc = json.load(fh)
    obs.validate_snapshot(doc)
    snap.unlink()
    out["d"] = {"soak": soak, "dispatch_spans": len(disp),
                "parented_under_submit": parented,
                "snapshots_written": len(snapshots),
                "snapshot_dispatches": snapshots,
                "scrapes": len(scrapes),
                "scrape_dispatches": last.get("mpi_model_tpu_dispatches"),
                "final_dispatches": final["dispatches"],
                "soak_dispatches": final["dispatches"]
                - base_stats["dispatches"], "k5_launches": k5,
                "stages": doc["tracer"]["stages"]}
    print(f"6j (d) {scenarios} x {side5}^2 pipeline substeps=8 through "
          f"AsyncEnsembleService under run_soak(snapshot_path=, "
          f"status_port=0): served {soak['served']}/{soak['offered']}, "
          f"ledger complete {soak['ledger_complete']}, "
          f"{out['d']['soak_dispatches']} dispatches, K5 launches {k5}; "
          f"{len(disp)} dispatch spans, each under its submit context "
          f"{parented}; {len(snapshots)} snapshots written, each valid; "
          f"/metrics scraped {len(scrapes)} times, the last dispatches "
          f"{out['d']['scrape_dispatches']} (final stats "
          f"{final['dispatches']})", flush=True)
    check(soak["ledger_complete"] and soak["served"] == scenarios,
          f"6j (d) the soak's ledger is not complete: {soak}")
    check(parented, "6j (d) a dispatch span is not under a submit context")
    check(len(snapshots) >= 1 and doc["stats"]["dispatches"]
          == final["dispatches"], "6j (d) the snapshots do not hold")
    check(last.get("mpi_model_tpu_dispatches") == final["dispatches"],
          f"6j (d) /metrics said {last.get('mpi_model_tpu_dispatches')} "
          f"dispatches, stats() {final['dispatches']}")
    if on_card:
        check(k5 > 0, "6j (d) K5 was not launched")
    ladder_guard(final, k5, "6j (d) the soak's pipeline service")
    del spaces

    # -- (e) a supervised K1 run with exc:1 -------------------------------------
    space = k1_space(torch, mt, dev, side)
    tr = Tracer()
    prev = set_tracer(tr)
    try:
        with inject.armed(inject.FaultPlan((inject.Fault("exc", at=1),))):
            hurt = supervised_run(model, space, steps=steps, every=16,
                                  executor=mt.SerialExecutor(
                                      "pallas", substeps=8))
    finally:
        set_tracer(prev)
    clean = supervised_run(model, space, steps=steps, every=16,
                           executor=mt.SerialExecutor("pallas", substeps=8))
    whole, _ = model.execute(space, ex, steps=steps)
    fails = [s for s in tr.spans if s.name == "supervise.failure"]
    chunks = [s for s in tr.spans if s.name == "supervise.chunk"]
    ok = same(hurt.space, clean.space) and same(hurt.space, whole)
    out["e"] = {"recovered_failures": hurt.recovered_failures,
                "failure_instants": [s.meta for s in fails],
                "chunk_spans": len(chunks), "bit_for_bit": ok}
    print(f"6j (e) supervised K1 {side}^2 every 16 with exc:1: "
          f"{hurt.recovered_failures} recovered, supervise.failure "
          f"{[s.meta['kind'] for s in fails]}, {len(chunks)} "
          f"supervise.chunk spans, bit for bit the uninterrupted run {ok}",
          flush=True)
    check(hurt.recovered_failures == 1 and len(fails) == 1
          and len(chunks) == steps // 16 + 1,
          f"6j (e) spans {len(chunks)} chunks, {len(fails)} failures")
    check(ok, "6j (e) the recovered run is not the uninterrupted run")
    del hurt, clean, whole, space

    # -- (g) the CLI: --trace, info, --serve --status -------------------------
    trace = out_dir / "trace_6j.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["run", "--flow=diffusion", f"--dimx={side}",
                       f"--dimy={side}", "--impl=pallas", "--substeps=8",
                       f"--steps={steps}", f"--trace={trace}", "--json",
                       *cli_args])
        rc_info = cli_main(["info", "--json"])
    lines = buf.getvalue().strip().splitlines()
    row, info = json.loads(lines[-2]), json.loads(lines[-1])
    with open(trace) as fh:
        tnames = {e["name"] for e in json.load(fh)["traceEvents"]}
    trace.unlink()
    status = out_dir / "status_6j.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_serve = cli_main(["run", "--flow=diffusion", f"--dimx={side5}",
                             f"--dimy={side5}", "--serve",
                             f"--serve-scenarios={scenarios}",
                             "--ensemble-impl=pipeline", "--substeps=8",
                             "--steps=8", f"--status={status}",
                             "--status-interval-s=0.5", "--json",
                             *cli_args])
    serve_row = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(status) as fh:
        obs.validate_snapshot(json.load(fh))
    out["g"] = {"run": row, "info": info, "serve": serve_row,
                "trace_names": sorted(tnames)}
    print(f"6j (g) CLI run --trace at {side}^2: rc {rc}, trace holds "
          f"model.execute {'model.execute' in tnames}; info: device_kind "
          f"{info['device_kind']!r}, chip_peaks {info['chip_peaks']}, "
          f"native_library {info['native_library']}; --serve --status: rc "
          f"{rc_serve}, ledger complete {serve_row['ledger_complete']}, "
          "the snapshot validates", flush=True)
    check(rc == 0 and rc_info == 0 and rc_serve == 0
          and "model.execute" in tnames and row["trace"] == str(trace),
          "6j (g) the CLI's --trace run failed")
    check((info["chip_peaks"] is not None) == on_card
          and Path(info["native_library"]).is_file(),
          f"6j (g) info: {info}")
    check(serve_row["ledger_complete"]
          and serve_row["telemetry_snapshot"] == str(status),
          f"6j (g) the --serve --status run: {serve_row}")
    cli_row_guard(serve_row, "6j (g) the --serve --status row")
    status.unlink()

    # -- (h) the native engine ----------------------------------------------------
    ref = mt.CellularSpace.create(100, 100, 1.0, dtype="float64", device=dev)
    ref_model = mt.Model(mt.Exponencial(mt.Cell(19, 3, mt.Attribute(99, 2.2)),
                                        0.1), 10.0, 0.2)
    nat, nrep = ref_model.execute(ref, native.NativeExecutor(), steps=50)
    plain, _ = ref_model.execute(ref, mt.SerialExecutor("xla"), steps=50)
    ref_err = float((nat.values["value"] - plain.values["value"]).abs().max())
    oracle_err = float(abs(nat.values["value"].cpu().numpy()
                           - oracle.reference_run_np(steps=50)).max())
    v = np.random.default_rng(SEED).uniform(0.5, 2.0, (native_side,
                                                       native_side))
    sp = mt.CellularSpace({"value": torch.from_numpy(v.astype(
        np.float32)).to(dev)}, native_side, native_side)
    t0 = time.perf_counter()
    nat32, _ = model.execute(sp, native.NativeExecutor(), steps=steps)
    native_s = time.perf_counter() - t0
    k1, _ = model.execute(sp, mt.SerialExecutor("pallas", substeps=8),
                          steps=steps)
    err32 = float((nat32.values["value"] - k1.values["value"]).abs().max())
    tol32 = 2 * float(np.finfo(np.float32).eps) * steps * float(v.max())
    out["h"] = {"reference_max_abs_err": ref_err,
                "reference_oracle_err": oracle_err,
                "native_report": nrep.backend_report,
                "f32_max_abs_err": err32, "f32_tolerance": tol32,
                "native_f32_s": native_s, "library": native.build_native()}
    print(f"6j (h) native: the reference scenario (50 steps, f64) against "
          f"the port's plain path on the card max|d| {ref_err:.3e} (oracle "
          f"{oracle_err:.3e}); {native_side}^2 Diffusion(0.1) f32 {steps} "
          f"steps against K1 max|d| {err32:.3e} <= {tol32:.3e} (native "
          f"{native_s:.2f} s on the host)", flush=True)
    check(ref_err <= 1e-10 and oracle_err <= 1e-12,
          f"6j (h) the native reference run is off by {ref_err}")
    check(err32 <= tol32, f"6j (h) native f32 against K1: {err32} > {tol32}")
    return out


def observability_main() -> None:
    """Phase 6j in a process of its own (``main`` starts it): loads the
    libraries the script built, runs ``observability_phase`` on the card
    and prints one JSON line, the rows and the phase's seconds."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import mpi_model_tpu_torch as mt
    from mpi_model_tpu_torch.ops import _build

    _build.build_all()
    out = observability_phase(np, torch, mt, torch.device("cuda"))
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out, default=repr), flush=True)


#: phase 6k's activity for the K6/K7 rung (bench.py's middle fraction)
LADDER_FRAC = 0.05
#: phase 6k (d)'s wire secret (a loopback pair in one process)
WIRE_SECRET = "chip-smoke-6k"


def ladder_guard(stats: dict, launched, what: str) -> None:
    """The degradation ladder never stands in for a kernel unnoticed: a
    scheduler or service on ``pipeline``, ``active`` or ``active_fused``
    that injected no fault ends with ``degraded_from`` None, ``impl_faults``
    0 and (``launched``, when given) its kernel's counter advanced."""
    check(stats["degraded_from"] is None and stats["impl_faults"] == 0
          and (launched is None or launched > 0),
          f"{what}: the ladder engaged or the kernel did not run "
          f"(degraded_from={stats['degraded_from']!r}, impl_faults="
          f"{stats['impl_faults']}, kernel launches {launched})")


def cli_row_guard(row: dict, what: str) -> None:
    """``ladder_guard`` for a ``--serve`` or ``--ensemble`` CLI row, which
    carries no ladder keys (the JAX package's rows): under ``retry="solo"``
    every impl-level fault makes a solo retry (under ``retry="none"`` the
    run fails), so no solo retry and no quarantine means ``impl_faults`` 0
    and no rung; and the row's kernel launches advanced."""
    check(row["solo_retries"] == 0 and row["quarantined"] == 0
          and row["kernel_launches"] > 0,
          f"{what}: a solo retry, a quarantine or no kernel launch: {row}")


def _k1_file_kernels(path) -> int:
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel"
               and "fused_stencil" in e.get("name", ""))


def device_trace_in_long_process(torch, mt, fs, dev, logdir: Path,
                                 side=N, steps=STEPS) -> dict:
    """Phase 6k (g), in the script's long process: phase 4's K1 run (64
    steps of ``side``², substeps 8) under ``Tracer.device_trace``, its K1
    kernels counted in the written Chrome file (the gate: every launch);
    and, a finding beside it, the same run under a ``torch.profiler``
    profile without ``acc_events`` exported to a file and counted there."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_model_tpu_torch.utils import Tracer

    logdir.mkdir(parents=True, exist_ok=True)
    space = k1_space(torch, mt, dev, side)
    model = mt.Model(mt.Diffusion(0.1))
    ex = mt.SerialExecutor("pallas", substeps=8)
    model.execute(space, ex, steps=steps)
    out = {}
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    before = fs.launches()
    with profile(activities=acts) as prof:
        model.execute(space, ex, steps=steps)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    raw = logdir / "raw_profile.pt.trace.json"
    prof.export_chrome_trace(str(raw))
    out["profile_without_acc_events"] = {
        "launches": fs.launches() - before,
        "file_kernels": _k1_file_kernels(raw),
        "events_kernels": sum(1 for e in prof.events()
                              if e.device_type.name == "CUDA"
                              and "fused_stencil" in e.name)}
    tr = Tracer()
    before = fs.launches()
    t0 = time.perf_counter()
    with tr.device_trace(str(logdir)):
        model.execute(space, ex, steps=steps)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    out["device_trace"] = {
        "launches": fs.launches() - before,
        "file_kernels": _k1_file_kernels(logdir / "device_trace.pt.trace.json"),
        "seconds": time.perf_counter() - t0}
    shutil.rmtree(logdir, ignore_errors=True)
    del space
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    d, r = out["device_trace"], out["profile_without_acc_events"]
    print(f"6k (g) Tracer.device_trace in this long process: "
          f"{d['file_kernels']} K1 kernels in the written file for "
          f"{d['launches']} launches; a profile without acc_events: "
          f"{r['file_kernels']} in its file, {r['events_kernels']} in "
          f"prof.events(), for {r['launches']} launches", flush=True)
    check(d["launches"] == steps // 8 and d["file_kernels"] == d["launches"],
          f"6k (g) device_trace lost K1 kernels: {out}")
    return out


def ladder_formats_phase(np, torch, mt, dev, reset_counts, kernel_launches,
                         side5=N5, lanes=B5, steps=STEPS5,
                         scenarios=SERVE_GATE, out_dir=None) -> dict:
    """Phase 6k: the degradation ladder and the fleet's formats on the card
    (see the module docstring): (a) the ladder from K5 and the async
    service's health gate; (b) the ladder from K6/K7; (c) the TJ1 journal
    of K5-served lanes under the protocol witness, replayed onto the card,
    torn and fenced; (d) a served lane over the TW1 wire, on a socketpair
    and on TCP after the handshake; (e) lockdep over a K5 soak; (f) a
    ticket's timeline. ``check`` fails the run on any disagreement."""
    import socket
    import threading
    import warnings

    from mpi_model_tpu_torch import obs
    from mpi_model_tpu_torch.ensemble import (AsyncEnsembleService,
                                              EnsembleScheduler,
                                              ServiceOverloaded, buckets_for,
                                              run_soak)
    from mpi_model_tpu_torch.ensemble import journal as jn
    from mpi_model_tpu_torch.ensemble import lifecycle, wire
    from mpi_model_tpu_torch.resilience import (inject, lockdep,
                                                protocolcheck)
    from mpi_model_tpu_torch.resilience.inject import Fault, FaultPlan
    from mpi_model_tpu_torch.utils import Tracer, set_tracer

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    out_dir = (Path(__file__).resolve().parent / "chiprun_out"
               if out_dir is None else Path(out_dir))
    out = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def k5n():
        return kernel_launches()["pipeline_stencil"]

    base = np.random.default_rng(SEED).uniform(
        0.5, 2.0, (side5, side5)).astype(np.float32)
    spaces = [mt.CellularSpace({"value": torch.from_numpy(
        np.roll(base, 7 * i, axis=0)).to(dev)}, side5, side5)
        for i in range(lanes)]
    del base
    model01 = mt.Model(mt.Diffusion(0.1))
    k5_calls = steps // 8 + steps % 8  # K5 launches a dispatch at substeps 8

    def serve(sched, spaces_, steps_=steps):
        ts = [sched.submit(s, model01, steps_) for s in spaces_]
        sched.pump(force=True)
        return [sched.poll(t) for t in ts]

    def rung_warnings(w) -> list:
        return [str(x.message) for x in w
                if issubclass(x.category, RuntimeWarning)
                and "degraded to" in str(x.message)]

    def equal_lanes(got, want) -> bool:
        return all(torch.equal(g[0].values["value"], v[0].values["value"])
                   for g, v in zip(got, want))

    # -- (a) the ladder from K5 ------------------------------------------------
    sched = EnsembleScheduler(impl="pipeline", substeps=8, degrade_after=1,
                              retry="solo", buckets=buckets_for(lanes))
    reset_counts()
    t0 = time.perf_counter()
    clean = serve(sched, spaces)
    sync()
    clean_s = time.perf_counter() - t0
    ran = kernel_launches()
    ladder_guard(sched.stats(), ran["pipeline_stencil"],
                 "6k (a) the clean K5 dispatch")
    check(ran["pipeline_stencil"] == k5_calls and all(
        r[1].backend_report.get("kernel") == "K5 pipeline_stencil"
        for r in clean), f"6k (a) the clean dispatch: launches {ran}")
    del clean
    k5_0 = k5n()
    with inject.armed(FaultPlan((Fault("batch_exc", at=0),))) as fst:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            fell = serve(sched, spaces)
            sync()
            rung_s = time.perf_counter() - t0
    rungs = rung_warnings(w)
    st = sched.stats()
    k5_after = k5n() - k5_0
    want = serve(EnsembleScheduler(impl="xla", buckets=buckets_for(lanes)),
                 spaces)
    bitwise = equal_lanes(fell, want)
    stamped = all((r[1].backend_report or {}).get("impl") == "xla"
                  and r[1].backend_report.get("degraded_from") == "pipeline"
                  for r in fell)
    finite = all(tuple(r[0].values["value"].shape) == (side5, side5)
                 and bool(torch.isfinite(r[0].values["value"]).all())
                 for r in fell)
    out["a"] = {"lanes": lanes, "side": side5, "clean_dispatch_s": clean_s,
                "rung_dispatch_s": rung_s, "warnings": rungs,
                "fired": [f["kind"] for f in fst.fired],
                "k5_launches_after_rung": k5_after,
                "bitwise_fresh_xla": bitwise, "stamped": stamped,
                "stats": {k: st[k] for k in (
                    "impl", "degraded_from", "intake_gated", "impl_faults",
                    "recovered_failures", "solo_retries", "quarantined")}}
    print(f"6k (a) {lanes} x {side5}^2 pipeline (K5, substeps 8): clean "
          f"dispatch {clean_s:.3f} s, K5 launched {ran['pipeline_stencil']}; "
          f"batch_exc with degrade_after=1: {rungs}; the {lanes} solo "
          f"retries on xla in {rung_s:.3f} s, every report stamped impl xla "
          f"degraded_from pipeline {stamped}, bit for bit a fresh xla "
          f"scheduler {bitwise}, K5 launches after the rung {k5_after}; "
          f"stats {out['a']['stats']}", flush=True)
    check(len(rungs) == 1 and "'pipeline' degraded to 'xla'" in rungs[0]
          and out["a"]["fired"] == ["batch_exc"],
          f"6k (a) the rung was not announced once: {rungs}")
    check(stamped and bitwise and finite and k5_after == 0,
          "6k (a) the degraded lanes are not the xla dispatch's, or K5 "
          "ran after the rung")
    check(st["impl"] == "xla" and st["degraded_from"] == "pipeline"
          and st["impl_faults"] == 1 and st["recovered_failures"] == lanes
          and not st["intake_gated"], f"6k (a) stats: {out['a']['stats']}")
    del fell, want, sched

    # the async service's mid-fall gate: shed while gated, reopened by the
    # first clean completion
    svc = AsyncEnsembleService(model01, steps=steps, impl="pipeline",
                               substeps=8, retry="none", degrade_after=1,
                               max_wait_s=1e9, max_batch=2, start=False)
    gate = []

    def shed(space) -> bool:
        try:
            svc.submit(space)
        except ServiceOverloaded as e:
            return "health-gated" in str(e)
        return False

    with inject.armed(FaultPlan((Fault("batch_exc", at=0),))):
        a = svc.submit(spaces[0])
        b = svc.submit(spaces[1])
        c = svc.submit(spaces[2], steps=3)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            svc.pump_once()
        gate.append(("rung", rung_warnings(w)))
        gate.append(("gated", svc.scheduler.intake_gated))
        gate.append(("shed while gated", shed(spaces[3])))
        svc.pump_once(force=True)
        gate.append(("shed with C in flight", shed(spaces[3])))
        svc.pump_once()
        gate.append(("gated after C", svc.scheduler.intake_gated))
        t = svc.submit(spaces[3])
    svc.stop()
    failed = []
    for bad in (a, b):
        try:
            svc.poll(bad)
            failed.append(None)
        except inject.InjectedFault:
            failed.append("InjectedFault")
    got_c, got_t = svc.poll(c), svc.poll(t)
    fresh = EnsembleScheduler(impl="xla")
    gate_ok = (gate[1][1] and gate[2][1] and gate[3][1] and not gate[4][1]
               and failed == ["InjectedFault"] * 2
               and equal_lanes([got_c], serve(fresh, [spaces[2]], 3))
               and equal_lanes([got_t], serve(fresh, [spaces[3]]))
               and got_c[1].backend_report.get("degraded_from")
               == "pipeline")
    out["a"]["gate"] = {"sequence": gate, "failed": failed,
                        "shed": svc.stats()["shed"], "ok": gate_ok}
    print(f"6k (a) async service mid-fall on the card: {gate}; A/B "
          f"{failed}; C and the reopened ticket bit for bit fresh xla, "
          f"stamped: {gate_ok}; shed {svc.stats()['shed']}", flush=True)
    check(gate_ok and svc.stats()["shed"] == 2,
          f"6k (a) the health gate: {out['a']['gate']}")
    del svc, got_c, got_t, fresh
    if on_card:
        torch.cuda.empty_cache()

    # -- (b) the ladder from K6/K7 ---------------------------------------------
    act = [mt.CellularSpace({"value": torch.from_numpy(
        workload(np, side5, side5, LADDER_FRAC, SEED + i)).to(dev)},
        side5, side5) for i in range(2)]
    sched = EnsembleScheduler(impl="active_fused", degrade_after=1,
                              retry="solo", max_batch=2)
    reset_counts()
    serve(sched, act)
    ran = kernel_launches()
    k67 = (ran["fused_compute"], ran["fused_scatter"])
    ladder_guard(sched.stats(), min(k67), "6k (b) the clean K6/K7 dispatch")
    rows = []
    for rung in ("active", "xla"):
        before = kernel_launches()
        with inject.armed(FaultPlan((Fault("batch_exc", at=0),))):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                got = serve(sched, act)
                sync()
                secs = time.perf_counter() - t0
        after = kernel_launches()
        want = serve(EnsembleScheduler(impl=rung, max_batch=2), act)
        row = {"rung": rung, "warnings": rung_warnings(w), "seconds": secs,
               "bitwise_own_dispatch": equal_lanes(got, want),
               "stamped": all(
                   (r[1].backend_report.get("impl"),
                    r[1].backend_report.get("degraded_from"))
                   == (rung, "active_fused") for r in got),
               "k6_k7_after_rung": (
                   after["fused_compute"] - before["fused_compute"],
                   after["fused_scatter"] - before["fused_scatter"]),
               "impl": sched.stats()["impl"]}
        rows.append(row)
        check(len(row["warnings"]) == 1
              and f"degraded to '{rung}'" in row["warnings"][0]
              and row["bitwise_own_dispatch"] and row["stamped"]
              and row["k6_k7_after_rung"] == (0, 0) and row["impl"] == rung,
              f"6k (b) the rung to {rung}: {row}")
        del got, want
    st = sched.stats()
    out["b"] = {"side": side5, "frac": LADDER_FRAC, "lanes": 2,
                "k6_k7_clean": k67, "rungs": rows,
                "impl_faults": st["impl_faults"],
                "degraded_from": st["degraded_from"]}
    print(f"6k (b) 2 x {side5}^2 at {LADDER_FRAC} active_fused: the clean "
          f"dispatch launched K6/K7 {k67}; " + "; ".join(
              f"rung to {r['rung']} in {r['seconds']:.3f} s, bit for bit "
              f"its own dispatch {r['bitwise_own_dispatch']}, stamped "
              f"{r['stamped']}, K6/K7 after it {r['k6_k7_after_rung']}"
              for r in rows), flush=True)
    check(st["impl_faults"] == 2 and st["degraded_from"] == "active_fused",
          f"6k (b) stats: {out['b']}")
    del act, sched
    if on_card:
        torch.cuda.empty_cache()

    # -- (c) the journal of K5-served lanes, (f) a ticket's timeline ----------
    jdir = out_dir / "journal_6k"
    shutil.rmtree(jdir, ignore_errors=True)
    path = jn.journal_path(str(jdir))
    tracer = Tracer()
    prev = set_tracer(tracer)
    sched = EnsembleScheduler(impl="pipeline", substeps=8,
                              buckets=buckets_for(lanes))
    write_s = 0.0
    try:
        with protocolcheck.armed() as pw:
            j = jn.TicketJournal(path)
            tickets, ctxs = [], []
            for s in spaces[:2]:
                with tracer.span("client.submit"):
                    ctx = tracer.current()
                    ctxs.append(ctx)
                    t = sched.submit(s, model01, steps)
                    meta, arrays = jn.space_payload(s)
                    t0 = time.perf_counter()
                    j.append(lifecycle.SUBMIT, dict(
                        meta, ticket=t, steps=steps,
                        model=jn.model_meta(model01),
                        trace=ctx.to_meta()), arrays)
                    write_s += time.perf_counter() - t0
                tickets.append(t)
            k5_0 = k5n()
            sched.pump(force=True)
            served = [sched.poll(t) for t in tickets]
            k5_c = k5n() - k5_0
            for t, (sp, rep) in zip(tickets, served):
                meta, arrays = jn.space_payload(sp)
                t0 = time.perf_counter()
                j.append(lifecycle.SERVED, dict(
                    meta, ticket=t, steps=steps,
                    initial_total=rep.initial_total,
                    final_total=rep.final_total,
                    wall_time_s=rep.wall_time_s), arrays)
                write_s += time.perf_counter() - t0
    finally:
        set_tracer(prev)
    ladder_guard(sched.stats(), k5_c, "6k (c) the journaled K5 dispatch")
    nbytes = Path(path).stat().st_size
    t0 = time.perf_counter()
    state = jn.replay(path)
    rebuilt = [jn.space_from_record(state.terminal[t], device=dev)
               for t in tickets]
    sync()
    replay_s = time.perf_counter() - t0
    rebuilt_ok = all(
        r.values["value"].device.type == dev.type
        and torch.equal(r.values["value"], sp.values["value"])
        for r, (sp, _) in zip(rebuilt, served))
    out["c"] = {"lanes": 2, "side": side5, "records": j.count,
                "file_bytes": nbytes, "write_s": write_s,
                "replay_s": replay_s, "protocol_records": pw.records,
                "violations": pw.violations, "rebuilt_bitwise": rebuilt_ok,
                "k5_launches": k5_c}
    print(f"6k (c) the journal of 2 K5-served {side5}^2 lanes under the "
          f"protocol witness: {j.count} records, {nbytes} bytes, written in "
          f"{write_s:.3f} s; {pw.records} appends witnessed, violations "
          f"{pw.violations}; replayed and rebuilt on {dev.type} in "
          f"{replay_s:.3f} s, bit for bit K5's result {rebuilt_ok}",
          flush=True)
    check(pw.records == 4 and not pw.violations and rebuilt_ok
          and state.unresolved() == [] and not state.duplicate_terminals
          and not state.torn, f"6k (c) the journal: {out['c']}")
    del rebuilt, state

    tl = obs.timeline(tickets[0], journal_dir=str(jdir),
                      spans=tracer.spans)
    kinds = [e.kind for e in tl.events]
    out["f"] = {"ticket": tickets[0], "complete": tl.complete,
                "gaps": len(tl.gaps), "events": kinds,
                "trace_id": tl.trace_id}
    print(f"6k (f) obs.timeline of ticket {tickets[0]}: complete "
          f"{tl.complete}, {len(tl.gaps)} gaps, events {kinds}", flush=True)
    check(tl.complete and not tl.gaps and tl.trace_id == ctxs[0].trace_id
          and lifecycle.SUBMIT in kinds
          and lifecycle.SERVED in kinds and "ensemble.launch" in kinds
          and "ensemble.fetch" in kinds, f"6k (f) the timeline: {out['f']}")

    # the torn tail and the fence
    n_before = j.count
    with inject.armed(FaultPlan((Fault("journal_torn", at=n_before,
                                       offset=30, tear="truncate"),))) as tst:
        j.append(lifecycle.SUBMIT, {"ticket": 99, "steps": steps})
    j.close()
    recs, torn = jn.read_records(path)
    j2 = jn.TicketJournal(path)  # reopening truncates the torn tail
    count2 = j2.count
    jn.declare_epoch(j2, supervisor="chip-smoke")
    zombie = jn.TicketJournal(path, epoch=0)
    size = Path(path).stat().st_size
    try:
        zombie.append(lifecycle.SUBMIT, {"ticket": 100})
        fenced = False
    except jn.StaleEpochError:
        fenced = True
    zombie.close()
    j2.close()
    audit = jn.audit_journal(path)
    out["c"].update(torn={"fired": [f["kind"] for f in tst.fired],
                          "torn": torn, "verified": len(recs),
                          "count_after_reopen": count2},
                    fence={"refused": fenced,
                           "unchanged": Path(path).stat().st_size == size,
                           "audit_ok": audit["ok"],
                           "epochs": [e["epoch"] for e in audit["epochs"]]})
    print(f"6k (c) journal_torn at record {n_before}: torn {torn}, the "
          f"verified prefix {len(recs)} records, {count2} after reopening; "
          f"an epoch-0 handle after epoch 1 was declared refused {fenced}, "
          f"the file unchanged {out['c']['fence']['unchanged']}, audit ok "
          f"{audit['ok']}", flush=True)
    check(out["c"]["torn"]["fired"] == ["journal_torn"] and torn
          and len(recs) == n_before == count2 and fenced
          and out["c"]["fence"]["unchanged"] and audit["ok"],
          f"6k (c) the torn tail or the fence: {out['c']}")
    shutil.rmtree(jdir, ignore_errors=True)

    # -- (d) a served lane over the wire ---------------------------------------
    lane = served[0][0].values["value"]
    got = {}

    def receive(conn, key):
        got[key] = conn.recv(deadline_s=300)

    a_sock, b_sock = socket.socketpair()
    tx, rx = wire.FrameConn(a_sock), wire.FrameConn(b_sock)
    th = threading.Thread(target=receive, args=(rx, "pair"))
    th.start()
    t0 = time.perf_counter()
    tx.send("ok", {"ticket": tickets[0]}, {"value": lane})
    th.join(timeout=300)
    back = got["pair"][2]["value"].to(dev)
    sync()
    pair_s = time.perf_counter() - t0
    pair_ok = torch.equal(back, lane)
    pair_bytes = tx.bytes_out
    tx.close(), rx.close()
    srv = wire.tcp_listener()
    host, port = srv.getsockname()[:2]
    acc = {}

    def accept():
        sock, _ = srv.accept()
        wire.serve_handshake(sock, WIRE_SECRET)
        acc["conn"] = wire.FrameConn(sock)
        receive(acc["conn"], "tcp")

    th = threading.Thread(target=accept)
    th.start()
    t0 = time.perf_counter()
    cs_ = wire.tcp_dial(f"{host}:{port}")
    wire.client_handshake(cs_, WIRE_SECRET)
    hs_s = time.perf_counter() - t0
    cconn = wire.FrameConn(cs_)
    t0 = time.perf_counter()
    cconn.send("ok", {"ticket": tickets[0]}, {"value": lane})
    th.join(timeout=300)
    back = got["tcp"][2]["value"].to(dev)
    sync()
    tcp_s = time.perf_counter() - t0
    tcp_ok = torch.equal(back, lane)
    out["d"] = {"frame_bytes": pair_bytes,
                "socketpair": {"seconds": pair_s, "bitwise": pair_ok},
                "tcp": {"host": host, "handshake_s": hs_s,
                        "seconds": tcp_s, "bitwise": tcp_ok,
                        "bytes_in": acc["conn"].bytes_in}}
    cconn.close(), acc["conn"].close(), srv.close()
    print(f"6k (d) a served {side5}^2 f32 lane in one TW1 frame of "
          f"{pair_bytes} bytes: socketpair {pair_s:.3f} s bit for bit "
          f"{pair_ok}; TCP {host} after a {hs_s * 1e3:.2f} ms handshake "
          f"{tcp_s:.3f} s bit for bit {tcp_ok} (card to host to card)",
          flush=True)
    check(pair_ok and tcp_ok and out["d"]["tcp"]["bytes_in"] == pair_bytes,
          f"6k (d) the wire: {out['d']}")
    del lane, back, served, sched

    # -- (e) lockdep over a K5 soak --------------------------------------------
    soak = [(spaces[i % lanes], None, None) for i in range(scenarios)]
    k5_0 = k5n()
    t0 = time.perf_counter()
    with lockdep.armed() as lw:
        with AsyncEnsembleService(model01, steps=steps, impl="pipeline",
                                  substeps=8, buckets=buckets_for(lanes),
                                  max_queue=64) as svc:
            rep = run_soak(svc, soak, arrival_rate_hz=1e9)
            st = svc.stats()
    soak_s = time.perf_counter() - t0
    k5_e = k5n() - k5_0
    edges = sorted(lw.edges)
    out["e"] = {"scenarios": scenarios, "side": side5, "edges": edges,
                "violations": lw.violations, "k5_launches": k5_e,
                "served": rep["served"], "seconds": soak_s}
    print(f"6k (e) lockdep armed over run_soak of {scenarios} x {side5}^2 "
          f"through AsyncEnsembleService(pipeline): served {rep['served']}, "
          f"K5 launches {k5_e}, edges {edges}, violations {lw.violations} "
          f"({soak_s:.2f} s)", flush=True)
    ladder_guard(st, k5_e, "6k (e) the witnessed K5 soak")
    check(rep["ledger_complete"] and rep["served"] == scenarios and edges
          and not lw.violations, f"6k (e) lockdep: {out['e']}")
    del spaces, soak, svc
    if on_card:
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"6k: {out['seconds']:.1f} s", flush=True)
    return out


def ladder_phase_main() -> None:
    """Phase 6k alone on the card (``python3 -c "import chip_smoke;
    chip_smoke.ladder_phase_main()"``): builds the sources, runs
    ``ladder_formats_phase``, then (g), whose own profile without
    ``acc_events`` comes before its ``device_trace``; the rows go to
    ``chiprun_out/chip_smoke_6k.json``."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import mpi_model_tpu_torch as mt
    from mpi_model_tpu_torch.models.model import kernel_launches
    from mpi_model_tpu_torch.ops import _build
    from mpi_model_tpu_torch.ops import composed_stencil as cs
    from mpi_model_tpu_torch.ops import field_stencil as k4
    from mpi_model_tpu_torch.ops import fused_active as fa
    from mpi_model_tpu_torch.ops import fused_stencil as fs
    from mpi_model_tpu_torch.ops import pipeline_stencil as k5

    def reset_counts():
        for mod in (fs, cs, k4, k5, fa):
            mod.reset_launches()

    _build.build_all()
    dev = torch.device("cuda")
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out = ladder_formats_phase(np, torch, mt, dev, reset_counts,
                               kernel_launches)
    out["g"] = device_trace_in_long_process(torch, mt, fs, dev,
                                            out_dir / "device_trace_6k")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_6k.json").write_text(
        json.dumps(out, indent=1, default=repr))


def main() -> int:
    import numpy as np
    import torch

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import mpi_model_tpu_torch as mt
        from mpi_model_tpu_torch import oracle
        from mpi_model_tpu_torch.core.cell import (MOORE_OFFSETS,
                                                   VON_NEUMANN_OFFSETS)
        from mpi_model_tpu_torch.models.model import kernel_launches
        from mpi_model_tpu_torch.ops import _build
        from mpi_model_tpu_torch.ops import active as act
        from mpi_model_tpu_torch.ops import composed_stencil as cs
        from mpi_model_tpu_torch.ops import field_stencil as k4
        from mpi_model_tpu_torch.ops import fused_active as fa
        from mpi_model_tpu_torch.ops import fused_stencil as fs
        from mpi_model_tpu_torch.ops import pipeline_stencil as k5
    except ImportError as e:
        fail(f"the port's package is not importable here: {e}")
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"{kind}, power limit not readable"
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {card_line}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    neighborhoods = {"moore": MOORE_OFFSETS, "von_neumann": VON_NEUMANN_OFFSETS,
                     "custom": CUSTOM_OFFSETS}
    # phase 6j (f)'s cold process starts now, so its nvcc runs beside the
    # build below; it is read in phase 6j
    here = Path(__file__).resolve().parent
    cache_dir = here / "chiprun_out" / "compile_cache_6j"
    shutil.rmtree(cache_dir, ignore_errors=True)
    (here / "chiprun_out").mkdir(exist_ok=True)
    cold_log = here / "chiprun_out" / "compile_cache_cold.out"
    with open(cold_log, "w") as fh:
        cold = subprocess.Popen(
            [sys.executable, "-c", "import sys; sys.path.insert(0, "
             "sys.argv[1]); import chip_smoke; "
             "chip_smoke.compile_cache_probe(sys.argv[2])", str(here),
             str(cache_dir)], cwd=here, stdout=fh, stderr=subprocess.STDOUT)
    atexit.register(lambda: cold.poll() is None and cold.kill())

    def reset_counts():
        fs.reset_launches()
        cs.reset_launches()
        k4.reset_launches()
        k5.reset_launches()
        fa.reset_launches()

    cases = []  # every kernel-vs-plain case, kept in chip_smoke.json

    def record(line: str, ok: bool) -> None:
        """Keep a case's line; print it only when it fails."""
        cases.append({"case": line, "ok": ok})
        if not ok:
            print(line, flush=True)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    units = {}  # K4's generated units, one per flow set and neighbourhood
    paired = {}  # the units with the paired bf16 walk, by library name
    for step in k4_steppers(mt, torch, k4, neighborhoods):
        units.setdefault(step.planned.unit.text, step.planned.label)
        if step.planned.program16 is not None:
            paired[_build.unit_name(step.planned.unit.text)] = \
                step.planned.label
    _build.build_all(units=tuple(units.items()))
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s (one nvcc per source and per K4 unit, "
          f"{len(units)} units, in parallel)", flush=True)
    for name, info in _build.build_info.items():
        print(f"  {name}: {info['seconds']:.2f} s cached={info['cached']}")
        if name in ("fused_active", "pipeline_stencil"):
            # K6's and K5's instances, one line each (registers, spills)
            for entry, regs, spill in ptxas_summary(info["ptxas"]):
                print(f"    {entry}: {regs} registers, {spill}")
            continue
        if name in paired:
            # K4's paired bf16 walk, one line an instance (registers, spills)
            print(f"    paired bf16 walk of {paired[name]}:")
            for entry, regs, spill in ptxas_summary(info["ptxas"]):
                if "field_kernel16" in entry:
                    print(f"      {entry}: {regs} registers, {spill}")
            continue
        for line in info["ptxas"].splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line) and not (
                    name.startswith(_build.UNIT_STEM)
                    and "Compiling entry" in line):
                print(f"    {line.strip()}")

    # -- 3. K1 against its plain version --------------------------------------
    # Grids with no closed-form cell (every cell within ns of the edge), grids
    # whose edge tiles straddle d = ns beside interior tiles (ragged and not),
    # a grid whose rows are not 16-byte aligned (its windows staged element
    # by element), and the main path's shape; every case bit for bit.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(13, 17), (13, 160), (24, 256), (400, 1664), (999, 2001),
              (2048, 2048), "unaligned", (N, N)]
    worst = 0.0
    main_err = {}
    ncases = 0
    nclosed = 0
    for dtype, nsteps_set in ((torch.float32, (1, 2, 4, 8)),
                              (torch.bfloat16, (1, 2, 4, 8, 16))):
        for shape in shapes:
            if shape == "unaligned":
                shape = (1000, 1000)
                flat = torch.rand(1000 * 1000 + 1, generator=gen, device=dev)
                x = (0.5 + 1.5 * flat).to(dtype)[1:].view(shape)
                check(x.data_ptr() % 16 != 0, "the unaligned case is aligned")
            else:
                x = (0.5 + 1.5 * torch.rand(shape, generator=gen,
                                            device=dev)).to(dtype)
            depth = fs.ghost_depth(shape, dtype)
            for ns in nsteps_set:
                if ns > depth:
                    continue
                for hood, offs in neighborhoods.items():
                    if shape == (N, N) and not (
                            hood == "moore" and ns in (1, max(nsteps_set))):
                        continue  # the main path's own cases only
                    got = fs.pallas_dense_step(x, 0.13, offs, nsteps=ns)
                    want = fs.dense_step_plain(x, 0.13, offs, ns)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    ok = torch.equal(got, want)
                    inner = closed_cells(shape, ns)
                    ncases += 1
                    nclosed += inner > 0
                    dname = str(dtype).removeprefix("torch.")
                    record(f"K1 {dname} {shape} ns={ns} {hood} ({inner} "
                           f"closed-form cells): max_abs_err={err:.3e} "
                           f"bit for bit {'ok' if ok else 'FAIL'}", ok)
                    check(ok, f"K1 is not its plain version bit for bit: "
                              f"{dname} {shape} ns={ns} {hood} err={err}")
                    worst = max(worst, err)
                    if shape == (N, N):
                        main_err[(dname, ns)] = err
                    del got, want
            del x
    print(f"K1: {ncases} cases bit for bit the plain version ({nclosed} with "
          f"closed-form cells; largest error {worst:.3e})", flush=True)

    # -- 3b. K3 against its plain version, per form --------------------------
    # Each form asked for by name where the JAX package admits it (mxu: a
    # 128-aligned block width): vpu bit for bit, mxu (tensor cores) within
    # 1e-6·k·max|v| at f32 and one bf16 ulp of the value scale at bf16.
    k3_err = {}
    ncases = 0
    k3_shapes = [(13, 17), (77, 131), (400, 1664), (2048, 2048), (N, N)]
    for dtype, ks in ((torch.float32, (1, 4, 8)),
                      (torch.bfloat16, (1, 4, 8, 16))):
        dname = str(dtype).removeprefix("torch.")
        for shape in k3_shapes:
            x = (0.5 + 1.5 * torch.rand(shape, generator=gen, device=dev)).to(
                dtype)
            bw = fs.resolve_block(shape, dtype)[1]
            for k in ks:
                if k > cs.max_k(shape, dtype):
                    continue
                for hood, offs in neighborhoods.items():
                    if shape == (N, N) and not (hood == "moore"
                                                and k == max(ks)):
                        continue  # the main path's own case only
                    for form in cs.FORMS:
                        if form == "mxu" and bw % fs.LANE:
                            continue  # refused, as the JAX package does
                        before = cs.launches(form)
                        got = cs.composed_dense_step(x, 0.13, k, offs,
                                                     variant=form)
                        want = cs.composed_dense_step_plain(x, 0.13, k, offs,
                                                            form)
                        torch.cuda.synchronize()
                        ok, err, tol_s = k3_agrees(got, want, form, k)
                        ok = ok and cs.launches(form) == before + 1
                        ncases += 1
                        record(f"K3 {form} {dname} {shape} k={k} {hood}: "
                               f"max_abs_err={err:.3e} {tol_s} "
                               f"{'ok' if ok else 'FAIL'}", ok)
                        check(ok and math.isfinite(err),
                              f"K3 {form} disagrees with its plain version: "
                              f"{dname} {shape} k={k} {hood} err={err}")
                        if shape == (N, N):
                            k3_err[(form, dname)] = err
                        del got, want
            del x
            torch.cuda.empty_cache()
    print(f"K3: {ncases} cases agree with the plain version (at the main "
          f"path's shape: " + ", ".join(
              f"{f} {d} {e:.3e}" for (f, d), e in sorted(k3_err.items()))
          + ")", flush=True)

    # -- 3c. K6 and K7 against their plain versions ---------------------------
    def active_case(v, dtype, tile, k, plan_kw=None):
        """A state (numpy or on the card) padded to ring k, its plan and
        its compacted active set."""
        x = (v if isinstance(v, torch.Tensor)
             else torch.from_numpy(v)).to(dev, dtype)
        plan = act.plan_for(tuple(x.shape), tile=tile, **(plan_kw or {}))
        tmap = act.tile_nonzero_map(x, plan)
        flags = act.dilate_tile_map(tmap)
        ids, count = act.compact_tile_ids(flags, plan)
        selfnz = tmap.reshape(-1)[ids.long()].to(torch.int32)
        padded = torch.nn.functional.pad(x, (k, k, k, k)).contiguous()
        del x
        return padded, plan, ids, count, selfnz

    def k67_compare(padded, plan, ids, count, selfnz, dtype, k, offs, shape):
        """K6 and K7 against their plain versions on one state; returns
        (K6 max_abs_err, K6 bitwise, K7 bitwise)."""
        taps = fa._fused_taps(0.13, offs, k)
        cnt1 = count.reshape(1).to(torch.int32)
        upd, anyf = fa.fused_compute(
            padded, ids, cnt1, selfnz, rate=0.13, plan=plan, origin=(0, 0),
            global_shape=shape, offsets=offs, dtype=dtype, k=k, ring=k,
            taps=taps)
        want_u, want_f = fa.fused_compute_plain(
            padded, ids, count, selfnz, 0.13, plan, (0, 0), shape, offs,
            dtype, k, k, taps)
        n = min(max(int(count), 1), plan.capacity)
        g, w = upd[:n].double(), want_u[:n].double()
        err = float((g - w).abs().max()) if n else 0.0
        bitwise = bool(torch.equal(upd[:n], want_u[:n])
                       and torch.equal(anyf, want_f))
        p_k = fa.fused_scatter(padded.clone(), upd, ids, cnt1, plan=plan,
                               ring=k)
        p_p = fa.fused_scatter_plain(padded.clone(), upd, ids, count, plan, k)
        k7_bitwise = bool(torch.equal(p_k, p_p))
        del upd, anyf, want_u, want_f, g, w, p_k, p_p
        return err, bitwise, k7_bitwise

    k6_err = {}
    ncases = 0
    small = [((200, 264), (40, 24)), ((256, 320), (64, 64)),
             ((96, 96), (16, 16))]
    for dtype, ks in ((torch.float32, (1, 4, 8)), (torch.float64, (1, 4, 8)),
                      (torch.bfloat16, (1, 4, 8, 16))):
        dname = str(dtype).removeprefix("torch.")
        for shape, tile in small:
            v_np = workload(np, shape[0], shape[1], 0.04, SEED)
            v_np[0:5, 0:7] = np.random.default_rng(SEED).uniform(
                0.5, 2.0, (5, 7))  # mass on the corner: near-edge tiles
            for k in ks:
                if k > min(tile):
                    continue
                for hood, offs in neighborhoods.items():
                    case = active_case(v_np, dtype, tile, k,
                                       {"max_active_frac": 1.0})
                    err, bitwise, k7_bit = k67_compare(
                        *case, dtype, k, offs, shape)
                    ok = k7_bit and bitwise
                    ncases += 1
                    record(f"K6/K7 {dname} {shape} tile={tile} k={k} {hood}: "
                           f"max_abs_err={err:.3e} bitwise={bitwise} "
                           f"K7 bitwise={k7_bit} {'ok' if ok else 'FAIL'}",
                           ok)
                    check(ok, f"K6/K7 disagree with their plain versions: "
                              f"{dname} {shape} k={k} {hood} err={err}")
                    del case
    # the main paths' own states: 16384² f32 at activity 0.05, 128² tiles
    v_main = workload(np, N, N, 0.05, SEED)
    for k in (1, 8):
        case = active_case(v_main, torch.float32, None, k)
        err, bitwise, k7_bit = k67_compare(
            *case, torch.float32, k, MOORE_OFFSETS, (N, N))
        ok = k7_bit and bitwise
        k6_err[k] = err
        line = (f"K6/K7 float32 {(N, N)} tile=(128, 128) k={k} moore: "
                f"max_abs_err={err:.3e} bitwise={bitwise} K7 bitwise="
                f"{k7_bit} {'ok' if ok else 'FAIL'}")
        record(line, ok)
        if ok:
            print(line, flush=True)
        check(ok, f"K6/K7 disagree at the main path's shape, k={k}")
        del case
        torch.cuda.empty_cache()
    del v_main
    # K7 alone: counts 0 (one lane: clip(count, 1, K)), 1, some and K,
    # rings 1 and 8 (destination columns off every 16-byte boundary), 2-,
    # 4- and 8-byte elements, tiles whose rows are whole 16-byte chunks
    # (128 columns) and tiles whose rows are not (13), on a state of NaN:
    # bit for bit, by the bits (the untouched cells keep theirs)
    n_k7 = 0
    for dtype, bits in ((torch.bfloat16, torch.int16),
                        (torch.float32, torch.int32),
                        (torch.float64, torch.int64)):
        dname = str(dtype).removeprefix("torch.")
        for tile, grid in (((128, 128), (8, 16)), ((16, 13), (6, 5))):
            (th, tw), (gi, gj) = tile, grid
            plan = act.plan_for((gi * th, gj * tw), tile=tile,
                                max_active_frac=1.0)
            K = plan.capacity
            rng = np.random.default_rng(SEED + K)
            upd = torch.from_numpy(rng.uniform(-2.0, 2.0, (K, th, tw))).to(
                dev, dtype)
            ids = torch.from_numpy(rng.permutation(K).astype(np.int32)).to(
                dev)
            for ring in (1, 8):
                state = torch.full((gi * th + 2 * ring, gj * tw + 2 * ring),
                                   float("nan"), dtype=dtype, device=dev)
                for n in (0, 1, K // 3, K):
                    cnt1 = torch.tensor([n], dtype=torch.int32, device=dev)
                    got = fa.fused_scatter(state.clone(), upd, ids, cnt1,
                                           plan=plan, ring=ring)
                    want = fa.fused_scatter_plain(state.clone(), upd, ids, n,
                                                  plan, ring)
                    ok = bool(torch.equal(got.view(bits), want.view(bits)))
                    n_k7 += 1
                    record(f"K7 {dname} tile={tile} ring={ring} count={n}: "
                           f"bit for bit {ok}", ok)
                    check(ok, f"K7 disagrees with its plain version: "
                              f"{dname} tile={tile} ring={ring} count={n}")
    print(f"K7: {n_k7} cases (counts 0, 1, some, K; rings 1, 8; 2-, 4-, "
          "8-byte elements; 128- and 13-column tiles; a NaN state) bit for "
          "bit", flush=True)
    n_big = sum(c["case"].startswith("K6/K7") and " k=1 " not in c["case"]
                for c in cases)
    print(f"K6/K7: {ncases + 2} cases bit for bit the plain versions "
          f"({n_big} of them at k > 1, the tap table's and the exact "
          f"path's)", flush=True)

    # -- 3c-halo. K6 and K7 on ghost-padded shards -----------------------------
    sharded_active_kernel_cases(np, torch, mt, dev, record, neighborhoods)

    # -- 3d. K4 against its plain version -------------------------------------
    flow_sets = field_flow_sets(mt, torch)
    k4_err = {}
    ncases = n_bit = 0
    k4_shapes = [(5, 7), (37, 300), (77, 131), (N4, N4)]
    for dtype, nsteps_set in ((torch.float32, (1, 4, 8)),
                              (torch.bfloat16, (1, 4, 8, 16))):
        dname = str(dtype).removeprefix("torch.")
        for shape in k4_shapes:
            vals = {n: (0.5 + 1.5 * torch.rand(shape, generator=gen,
                                               device=dev)).to(dtype)
                    for n in ("a", "b", "c")}
            sh, sw = shape
            for n in vals:  # cells holding -0.0: corners, edges, inside
                for r, c in ((0, 0), (sh - 1, sw - 1), (sh // 2, 0),
                             (sh // 2, sw // 2), (sh // 3, (2 * sw) // 3)):
                    vals[n][r, c] = -0.0
            depth = fs.ghost_depth(shape, dtype)
            for ns in nsteps_set:
                if ns > depth:
                    continue
                for hood, offs in neighborhoods.items():
                    for fname, flows in flow_sets.items():
                        if shape == (N4, N4) and not (
                                hood == "moore" and fname == "config4"
                                and ns in (1, max(nsteps_set))):
                            continue  # the main path's own cases only
                        step = k4.PallasFieldStep(shape, flows, offsets=offs,
                                                  nsteps=ns)
                        got = step(vals)
                        want = k4.field_step_plain(vals, flows, offs, ns)
                        torch.cuda.synchronize()
                        written = {f.attr for f in flows}
                        ok = step.launches == 1 and all(
                            got[n] is vals[n] for n in vals
                            if n not in written)
                        err, exact = 0.0, True
                        for n in sorted(written):
                            g32, w32 = got[n].float(), want[n].float()
                            e = float((g32 - w32).abs().max())
                            err = max(err, e)
                            exact = exact and bool(torch.equal(got[n],
                                                               want[n]))
                            if fname == "every_op" and n == "a":
                                scale = float(w32.abs().max())
                                tol = 8 * 2.0 ** -23 * ns * scale
                                if dtype == torch.bfloat16:
                                    tol += bf16_ulp(scale)
                                ok = ok and e <= tol
                            else:
                                ok = ok and bool(torch.equal(got[n],
                                                             want[n]))
                        ncases += 1
                        n_bit += exact
                        record(f"K4 {dname} {shape} ns={ns} {hood} {fname}: "
                               f"max_abs_err={err:.3e} bitwise={exact} "
                               f"{'ok' if ok else 'FAIL'}", ok)
                        check(ok and math.isfinite(err),
                              f"K4 disagrees with its plain version: {dname} "
                              f"{shape} ns={ns} {hood} {fname} err={err}")
                        if shape == (N4, N4):
                            k4_err[(dname, ns)] = err
                        del got, want
            del vals
            torch.cuda.empty_cache()
    print(f"K4: {ncases} cases agree with the plain version, {n_bit} of them "
          f"bit for bit (every_op, with exp, is held to a tolerance; -0.0 "
          f"cells in every grid); at the main path's shape "
          + ", ".join(f"{d} ns={ns} {e:.3e}" for (d, ns), e in
                      sorted(k4_err.items())), flush=True)

    # -- 3e. K5 against its plain version -------------------------------------
    k5_err = {}
    ncases = 0
    k5_shapes = [((16, 128), None), ((48, 384), (16, 128))]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for B in (1, 3, 8):
            for shape, block in k5_shapes:
                x = (0.5 + 1.5 * torch.rand((B,) + shape, generator=gen,
                                            device=dev)).to(dtype)
                for ns in (1, 4, 8):
                    for hood, offs in neighborhoods.items():
                        got = k5.pipeline_dense_step(x, 0.13, offs,
                                                     block=block, nsteps=ns)
                        want = k5.pipeline_step_plain(x, 0.13, offs, ns,
                                                      block)
                        torch.cuda.synchronize()
                        ok = bool(torch.equal(got, want))
                        err = float((got.float() - want.float()).abs().max())
                        ncases += 1
                        record(f"K5 {dname} B={B} {shape} block={block} "
                               f"ns={ns} {hood}: max_abs_err={err:.3e} "
                               f"bitwise={ok} {'ok' if ok else 'FAIL'}", ok)
                        check(ok, f"K5 disagrees with its plain version: "
                                  f"{dname} B={B} {shape} ns={ns} {hood} "
                                  f"err={err}")
        # the ensemble path's own batch: 8 lanes of 4096², Moore
        x = (0.5 + 1.5 * torch.rand((B5, N5, N5), generator=gen,
                                    device=dev)).to(dtype)
        for ns in (1, 8):
            got = k5.pipeline_dense_step(x, 0.13, MOORE_OFFSETS, nsteps=ns)
            want = k5.pipeline_step_plain(x, 0.13, MOORE_OFFSETS, ns)
            torch.cuda.synchronize()
            ok = bool(torch.equal(got, want))
            err = float((got.float() - want.float()).abs().max())
            ncases += 1
            line = (f"K5 {dname} B={B5} {(N5, N5)} ns={ns} moore: "
                    f"max_abs_err={err:.3e} bitwise={ok} "
                    f"{'ok' if ok else 'FAIL'}")
            record(line, ok)
            check(ok, f"K5 disagrees with its plain version at the ensemble "
                      f"path's shape: {dname} ns={ns} err={err}")
            if ns == 8:
                k5_err[dname] = err
            del got, want
        del x
        torch.cuda.empty_cache()
    print(f"K5: {ncases} cases equal the plain version bit for bit",
          flush=True)

    # -- 4. K1 main path at full width ----------------------------------------
    results = {}
    # f32 substeps=8, bf16 substeps=16, and f32 substeps=1 (the default,
    # and the depth of the active runners' dense fallback)
    k1_runs = (("float32", 8), ("bfloat16", 16), ("float32", 1))
    for dname, sub in k1_runs:
        tdt = getattr(torch, dname)
        noise = torch.rand((N, N), generator=gen, device=dev)
        space = mt.CellularSpace.create(N, N, 1.0, dtype=dname)
        space = space.with_values({"value": (1.0 + 0.1 * noise).to(tdt)})
        del noise
        model = mt.Model(mt.Diffusion(0.1))
        ex = mt.SerialExecutor(step_impl="pallas", substeps=sub)
        reset_counts()
        out, rep = model.execute(space, ex, steps=STEPS)  # raises on drift
        launched = fs.launches()
        v = out.values["value"]
        check(rep.impl == "pallas", f"main path ran impl {rep.impl!r}")
        check(launched == STEPS // sub,
              f"{dname}: K1 launched {launched} times, expected "
              f"{STEPS // sub}")
        check(rep.backend_report["launches"] == launched,
              "the report's launch count disagrees with the counter")
        check(tuple(v.shape) == (N, N) and v.dtype == tdt,
              "main-path output has the wrong shape or dtype")
        check(bool(torch.isfinite(v).all()), "main-path output not finite")
        run_ms = timed_ms(torch, lambda: ex.run_model(model, space, STEPS),
                          reps=5)
        med = statistics.median(run_ms)
        row = {"dtype": dname, "substeps": sub, "steps": STEPS,
               "launches": launched,
               "conservation_error": rep.conservation_error(),
               "run_ms_median": med, "run_ms_all": run_ms,
               "step_ms": med / STEPS,
               "cell_updates_per_s": N * N * STEPS / (med / 1e3)}
        results[(dname, sub)] = row
        print(f"main path {dname} {N}x{N} substeps={sub}: conserved "
              f"(|d|={row['conservation_error']:.3e}), impl=pallas, "
              f"launches={launched}, {row['step_ms']:.4f} ms/step, "
              f"{row['cell_updates_per_s']:.4e} cell-updates/s", flush=True)
        del out, v, space
        torch.cuda.empty_cache()

    # the main path's answer against the plain-op path on a small grid
    small_space = mt.CellularSpace.create(512, 512, 1.0, dtype="float32")
    small_space = small_space.with_values({"value": 1.0 + 0.1 * torch.rand(
        (512, 512), generator=gen, device=dev)})
    model = mt.Model(mt.Diffusion(0.1))
    a, _ = model.execute(small_space, mt.SerialExecutor("pallas", substeps=8),
                         steps=STEPS)
    b, _ = model.execute(small_space, mt.SerialExecutor("xla"), steps=STEPS)
    d = float((a.values["value"] - b.values["value"]).abs().max())
    print(f"main path 512x512 f32 pallas vs xla, {STEPS} steps: "
          f"max_abs_err={d:.3e} (atol 1e-4)", flush=True)
    check(d <= 1e-4, "the kernel path disagrees with the plain-op path")

    # the main path's answer at each dtype against the plain version of K1
    # chained call by call: bit for bit, as K1 is its plain version's.
    # (Where two paths round differently, phases 6 and 6c bound how far
    # they drift: a call differs by at most `t`, and a difference carried
    # in grows by at most the gain G of one call: the call is a
    # nonnegative linear map, so G is the largest entry of the map applied
    # to ones, above 1 next to the corners. After `calls` calls the two
    # differ by at most t * (1 + G + ... + G^(calls-1)).)
    def gain(fn, sub):
        return float(fn(torch.ones((512, 512), device=dev), sub).max())

    for dname, sub in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        x = (1.0 + 0.1 * torch.rand((512, 512), generator=gen,
                                    device=dev)).to(tdt)
        small_space = mt.CellularSpace.create(512, 512, 1.0, dtype=dname)
        small_space = small_space.with_values({"value": x})
        a, _ = model.execute(small_space,
                             mt.SerialExecutor("pallas", substeps=sub),
                             steps=STEPS)
        want = x
        for _ in range(STEPS // sub):
            want = fs.dense_step_plain(want, 0.1, MOORE_OFFSETS, sub)
        d = float((a.values["value"].float() - want.float()).abs().max())
        same = torch.equal(a.values["value"], want)
        print(f"main path 512x512 {dname} substeps={sub} vs chained plain "
              f"K1, {STEPS} steps: max_abs_err={d:.3e}, bit for bit: {same}",
              flush=True)
        check(same, f"{dname}: the kernel path is not the plain version's "
                    "chained calls bit for bit")

    # kernel, plain and library times at the main path's shape
    timings = {}
    for dname, ns in k1_runs:
        tdt = getattr(torch, dname)
        x = (1.0 + 0.1 * torch.rand((N, N), generator=gen, device=dev)).to(tdt)
        y = torch.empty_like(x)
        bufs = [x, y]

        def kernel_call():
            fs.pallas_dense_step(bufs[0], 0.1, nsteps=ns, out=bufs[1])
            bufs.reverse()

        k_ms = statistics.median(timed_ms(torch, kernel_call, reps=20))
        p_ms = statistics.median(timed_ms(
            torch, lambda: fs.dense_step_plain(x, 0.1, MOORE_OFFSETS, ns),
            reps=3))
        # yardstick: the same work, ns 3x3 box sums (one conv2d a step, each
        # on the last one's output), with the one-step time beside it
        w = torch.ones((1, 1, 3, 3), device=dev, dtype=tdt)
        x4 = x.view(1, 1, N, N)
        l1_ms = statistics.median(timed_ms(
            torch, lambda: torch.nn.functional.conv2d(x4, w, padding=1),
            reps=10))

        def conv_steps():
            t = x4
            for _ in range(ns):
                t = torch.nn.functional.conv2d(t, w, padding=1)
            return t

        l_ms = statistics.median(timed_ms(torch, conv_steps, reps=3))
        b_ms, b_by = bound_ms((N, N), x.element_size(), ns, 8)
        timings[(dname, ns)] = {"nsteps": ns, "ms": k_ms, "plain_ms": p_ms,
                                "library_ms": l_ms,
                                "library_one_step_ms": l1_ms,
                                "bound_ms": b_ms, "bound_by": b_by}
        print(f"K1 {dname} {N}x{N} ns={ns}: kernel {k_ms:.4f} ms/call, "
              f"plain {p_ms:.3f} ms, conv2d 3x3 x {ns} {l_ms:.4f} ms (one "
              f"step {l1_ms:.4f}), bound {b_ms:.4f} ms ({b_by}), "
              f"{k_ms / ns:.4f} ms per step", flush=True)
        del x, y, bufs, x4
        torch.cuda.empty_cache()

    # -- 5. the active paths at full width ------------------------------------
    # the runners read the dilated count on the host once per pass: the
    # round trip of one such read on an idle card
    probe = torch.ones(4, dtype=torch.int32, device=dev)
    sync_us = []
    for _ in range(200):
        t0 = time.perf_counter()
        int(probe.sum())
        sync_us.append((time.perf_counter() - t0) * 1e6)
    sync_us = statistics.median(sync_us)
    print(f"host read of a device count: {sync_us:.1f} us (median of 200)",
          flush=True)
    model = mt.Model(mt.Diffusion(0.1))
    configs = (("active", 1), ("active_fused", 1), ("active_fused", 8))
    active_rows = []
    k67_time = {}   # (frac, k) -> K6/K7 ms on the run's starting state
    for frac in FRACS:
        v_np = workload(np, N, N, frac, SEED)
        space = mt.CellularSpace.create(N, N, 0.0, dtype="float32")
        space = space.with_values({"value": torch.from_numpy(v_np).to(dev)})
        del v_np
        for impl, sub in configs:
            ex = mt.SerialExecutor(impl, substeps=sub)
            model.execute(space, ex, steps=2)  # warm-up (and first build)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            out, rep = model.execute(space, ex, steps=ACTIVE_STEPS)
            ran = kernel_launches()
            peak = torch.cuda.max_memory_allocated()
            br = rep.backend_report
            check(rep.impl == impl, f"active row ran impl {rep.impl!r}")
            check(bool(torch.isfinite(out.values["value"]).all()),
                  "active path output not finite")
            passes = br.get("passes", ACTIVE_STEPS)
            check(ran["fused_stencil"] == br["fallback_steps"],
                  f"{impl}: K1 fallback launches {ran['fused_stencil']} != "
                  f"fallback_steps {br['fallback_steps']}")
            if impl == "active_fused":
                check(ran["fused_compute"] == br["flags_fused"]
                      and ran["fused_scatter"] == br["flags_fused"],
                      f"K6/K7 launches {ran} != flags_fused "
                      f"{br['flags_fused']}")
                check(br["flags_fused"] + br["fallback_steps"] == passes,
                      "flags_fused + fallback_steps != passes")
                check(br["flags_fused"] > 0, "no fused pass ran")
            # host clock around the run and a synchronize; the median of
            # this run and two more (their launches are not counted)
            walls = [rep.wall_time_s * 1e3] + [
                model.execute(space, ex, steps=ACTIVE_STEPS)[1].wall_time_s
                * 1e3 for _ in range(2)]
            run_ms = statistics.median(walls)
            row = {"frac": frac, "impl": impl, "substeps": sub,
                   "steps": ACTIVE_STEPS, "passes": passes,
                   "run_ms": run_ms, "run_ms_all": walls,
                   "cell_updates_per_s": N * N * ACTIVE_STEPS
                   / (run_ms / 1e3),
                   "mean_active_fraction": br["mean_active_fraction"],
                   "fallback_steps": br["fallback_steps"],
                   "flags_fused": br.get("flags_fused"),
                   "launches": ran,
                   "conservation_error": rep.conservation_error(),
                   "peak_mem_bytes": peak,
                   "pass_ms": run_ms / passes}
            if impl == "active_fused":
                k = br["composed_k"]
                # K6 + K7 on the run's starting state, one pass at depth k
                case_p, plan, ids, count, selfnz = active_case(
                    space.values["value"], torch.float32, None, k)
                taps = fa._fused_taps(0.1, MOORE_OFFSETS, k)
                cnt1 = count.reshape(1).to(torch.int32)
                upd = torch.empty((plan.capacity,) + plan.tile,
                                  dtype=torch.float32, device=dev)
                anyf = torch.empty(plan.capacity, dtype=torch.int32,
                                   device=dev)
                kw = dict(rate=0.1, plan=plan, origin=(0, 0),
                          global_shape=(N, N), offsets=MOORE_OFFSETS,
                          dtype=torch.float32, k=k, ring=k, taps=taps,
                          upd=upd, anyf=anyf)
                k6 = statistics.median(timed_ms(torch, lambda: fa.fused_compute(
                    case_p, ids, cnt1, selfnz, **kw), reps=10))
                k7 = statistics.median(timed_ms(torch, lambda: fa.fused_scatter(
                    case_p, upd, ids, cnt1, plan=plan, ring=k), reps=10))
                # the device's time alone: four calls back to back, the
                # wrapper's host time overlapped (the single-call times
                # above hold it, as run F's did)
                k6_b2b = per_call_ms(torch, lambda: fa.fused_compute(
                    case_p, ids, cnt1, selfnz, **kw))
                k7_b2b = per_call_ms(torch, lambda: fa.fused_scatter(
                    case_p, upd, ids, cnt1, plan=plan, ring=k))
                n = int(count)
                t = ids[:n].long()
                th, tw = plan.tile
                tr0, tc0 = t // plan.grid[1] * th, t % plan.grid[1] * tw
                near = ((tr0 <= k) | (tr0 + th >= N - k) | (tc0 <= k)
                        | (tc0 + tw >= N - k))
                n_taps = (int(((selfnz[:n] != 0) & ~near).sum())
                          if taps is not None else 0)
                plain6 = plain7 = None
                if frac == 0.05:
                    plain6 = statistics.median(timed_ms(
                        torch, lambda: fa.fused_compute_plain(
                            case_p, ids, count, selfnz, 0.1, plan, (0, 0),
                            (N, N), MOORE_OFFSETS, torch.float32, k, k,
                            taps), reps=1))
                    plain7 = statistics.median(timed_ms(
                        torch, lambda: fa.fused_scatter_plain(
                            case_p, upd, ids, count, plan, k), reps=3))
                live = min(max(n, 1), plan.capacity)
                k7_bound = 2 * live * th * tw * 4 / HBM_BYTES_PER_S * 1e3
                k7_lib = statistics.median(timed_ms(torch, k7_library(
                    torch, act, case_p, upd, ids, live, plan, k), reps=10))
                k67_time[(frac, k)] = {"k6_ms": k6, "k7_ms": k7, "count": n,
                                       "k6_ms_back_to_back": k6_b2b,
                                       "k7_ms_back_to_back": k7_b2b,
                                       "k7_bound_ms": k7_bound,
                                       "k7_library_ms": k7_lib,
                                       "tap_lanes": n_taps,
                                       "k6_plain_ms": plain6,
                                       "k7_plain_ms": plain7}
                print(f"K7 alone serial frac={frac} ring {k}: {k7:.4f} ms "
                      f"(back to back {k7_b2b:.4f}), bound {k7_bound:.4f} "
                      f"ms (bytes: {live} live tiles read and written), "
                      f"index_copy_ {k7_lib:.4f} ms", flush=True)
                # the run's kernel time: each pass charged with K6 + K7 at
                # its own depth (n // k passes at depth k, then n % k at
                # depth 1), both timed on the run's starting state
                one = k67_time[(frac, 1)]
                q, r = divmod(ACTIVE_STEPS, k)
                kernel_ms = q * (k6 + k7) + r * (one["k6_ms"] + one["k7_ms"])
                row.update(k6_ms=k6, k7_ms=k7, k6_ms_back_to_back=k6_b2b,
                           kernel_ms_run=kernel_ms,
                           kernel_ms_per_pass=kernel_ms / passes,
                           host_share=1.0 - kernel_ms / run_ms)
                del case_p, upd, anyf
            active_rows.append(row)
            extra = (f", pass {row['pass_ms']:.3f} ms vs K6+K7 "
                     f"{row['kernel_ms_per_pass']:.3f} ms (host share "
                     f"{row['host_share']:.3f}; K6 {row['k6_ms']:.4f} ms, "
                     f"back to back {row['k6_ms_back_to_back']:.4f})"
                     if "k6_ms" in row else "")
            print(f"active {impl} substeps={sub} frac={frac}: "
                  f"{row['cell_updates_per_s']:.4e} cell-updates/s, "
                  f"mean active {row['mean_active_fraction']:.4f}, "
                  f"fallback {row['fallback_steps']}, passes {passes}, "
                  f"launches {ran}{extra}, peak "
                  f"{peak / 2 ** 30:.2f} GiB, conserved "
                  f"(|d|={row['conservation_error']:.3e})", flush=True)
            del out
            torch.cuda.empty_cache()
        if frac == FRACS[0]:
            # gate: one step, active == active_fused k=1 == plain dense
            one = {impl: model.execute(space, mt.SerialExecutor(impl),
                                       steps=1)[0].values["value"]
                   for impl in ("active", "active_fused", "xla")}
            ok = (torch.equal(one["active"], one["xla"])
                  and torch.equal(one["active_fused"], one["xla"]))
            print(f"one-step gate {N}x{N} f32 frac={frac}: active == "
                  f"active_fused == xla bitwise: {ok}", flush=True)
            check(ok, "one-step bitwise gate failed")
            del one
        del space
        torch.cuda.empty_cache()

    # gate: a dense nonzero state falls back every step, K1 serving it
    x = 1.0 + 0.1 * torch.rand((N, N), generator=gen, device=dev)
    space = mt.CellularSpace.create(N, N, 0.0, dtype="float32").with_values(
        {"value": x})
    reset_counts()
    fb_out, fb_rep = model.execute(space, mt.SerialExecutor("active"),
                                   steps=3)
    fb_k1 = fs.launches()
    pl_out, _ = model.execute(space, mt.SerialExecutor("pallas"), steps=3)
    ok = (fb_rep.backend_report["fallback_steps"] == 3 and fb_k1 == 3
          and torch.equal(fb_out.values["value"], pl_out.values["value"]))
    print(f"fallback gate {N}x{N} f32 dense: fallback_steps="
          f"{fb_rep.backend_report['fallback_steps']}/3, K1 launches "
          f"{fb_k1}, equal to pallas substeps=1 bitwise: {ok}", flush=True)
    check(ok, "fallback gate failed")
    del x, space, fb_out, pl_out
    torch.cuda.empty_cache()

    # gate: f64, 1024², activity 0.02, 12 steps, three ways bitwise
    v64 = workload(np, 1024, 1024, 0.02, SEED).astype(np.float64)
    space = mt.CellularSpace.create(1024, 1024, 0.0, dtype="float64")
    space = space.with_values({"value": torch.from_numpy(v64).to(dev)})
    three = {impl: model.execute(space, mt.SerialExecutor(impl),
                                 steps=12)[0].values["value"]
             for impl in ("active", "active_fused", "xla")}
    ok = (torch.equal(three["active"], three["xla"])
          and torch.equal(three["active_fused"], three["xla"]))
    print(f"f64 gate 1024x1024 frac=0.02, 12 steps: active == active_fused "
          f"== xla bitwise: {ok}", flush=True)
    check(ok, "f64 three-way bitwise gate failed")
    del three, space

    # -- 6. the composed path at full width, per form -------------------------
    # "auto" resolves to mxu at f32 k=8 and bf16 k=16 (JAX's rule); the vpu
    # form runs through the same entry point with composed_variant="vpu".
    # Each run with the counts set to 0 just before and read just after.
    composed = {}
    for dname, sub in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        noise = torch.rand((N, N), generator=gen, device=dev)
        space = mt.CellularSpace.create(N, N, 1.0, dtype=dname)
        space = space.with_values({"value": (1.0 + 0.1 * noise).to(tdt)})
        del noise
        for variant in ("auto", "vpu"):
            ex = mt.SerialExecutor("composed", substeps=sub,
                                   composed_variant=variant)
            reset_counts()
            out, rep = model.execute(space, ex, steps=STEPS)
            br = rep.backend_report
            form = br["form"]
            launched = cs.launches(form)
            check(rep.impl == "composed" and br["composed_k"] == sub,
                  f"composed path ran {rep.impl!r} k={br.get('composed_k')}")
            check(form == ("mxu" if variant == "auto" else "vpu"),
                  f"{dname} {variant}: the composed path ran form {form!r}")
            check(launched == STEPS // sub == br["launches"]
                  and cs.launches() == launched,
                  f"{dname} {variant}: K3 {form} launched {launched} times "
                  f"({cs.launches()} in all), expected {STEPS // sub}")
            check(bool(torch.isfinite(out.values["value"]).all()),
                  "composed output not finite")
            run_ms = timed_ms(torch, lambda: ex.run_model(model, space,
                                                          STEPS), reps=3)
            med = statistics.median(run_ms)
            row = composed[f"{form} {dname}"] = {
                "substeps": sub, "k": sub, "steps": STEPS,
                "launches": launched, "variant": br["variant"],
                "form": form,
                "conservation_error": rep.conservation_error(),
                "run_ms_median": med, "run_ms_all": run_ms,
                "cell_updates_per_s": N * N * STEPS / (med / 1e3)}
            print(f"composed path {form} ({variant}) {dname} {N}x{N} "
                  f"substeps={sub}: conserved "
                  f"(|d|={rep.conservation_error():.3e}), "
                  f"launches={launched}, run {med:.3f} ms, "
                  f"{med / STEPS:.4f} ms/step, "
                  f"{row['cell_updates_per_s']:.4e} "
                  "cell-updates/s", flush=True)
            del out
        del space
        torch.cuda.empty_cache()

    # the composed path against the K1 path on 512², 64 steps. One call of
    # each approximates the same k exact steps: K1's iterated steps round
    # about 10 times per cell-step, the plain tap pass (2k+1)² times (the
    # binomial form fewer), each at most one f32 ulp of the scale, so one
    # call differs by at most t = ((2k+1)² + 10k) · 2^-23 · scale, plus, for
    # the mxu kernel, phase 3b's 1e-6·k·scale from its plain version (and
    # one bf16 ulp of the scale at bf16); carried through the calls with the
    # per-call gain G as in phase 4.
    for dname, sub in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        x = (1.0 + 0.1 * torch.rand((512, 512), generator=gen,
                                    device=dev)).to(tdt)
        sp = mt.CellularSpace.create(512, 512, 1.0, dtype=dname)
        sp = sp.with_values({"value": x})
        b, _ = model.execute(sp, mt.SerialExecutor("pallas", substeps=sub),
                             steps=STEPS)
        want32 = b.values["value"].float()
        scale = float(want32.abs().max())
        g = gain(lambda o, s: fs.dense_step_plain(o, 0.1, MOORE_OFFSETS, s),
                 sub)
        for form in cs.FORMS:
            a, _ = model.execute(sp, mt.SerialExecutor(
                "composed", substeps=sub, composed_variant=form), steps=STEPS)
            d = float((a.values["value"].float() - want32).abs().max())
            t = ((2 * sub + 1) ** 2 + 10 * sub) * 2.0 ** -23 * scale
            if form == "mxu":
                t += 1e-6 * sub * scale
            if tdt == torch.bfloat16:
                t += bf16_ulp(scale)
            tol = t * sum(g ** i for i in range(STEPS // sub))
            composed[f"{form} {dname}"].update(vs_k1_512_err=d,
                                           vs_k1_512_tol=tol)
            print(f"composed path {form} 512x512 {dname} substeps={sub} vs "
                  f"K1 path, {STEPS} steps: max_abs_err={d:.3e} "
                  f"(atol {tol:g})", flush=True)
            check(d <= tol, f"{dname} {form}: the composed path disagrees "
                            "with K1's")

    # K3 per call and form: kernel, plain, the bounds (the function's and
    # the form's) and conv2d with the same table (TF32 off)
    for dname, k in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        x = (1.0 + 0.1 * torch.rand((N, N), generator=gen, device=dev)).to(tdt)
        y = torch.empty_like(x)
        taps = torch.from_numpy(np.array(cs.composed_taps(
            0.1, MOORE_OFFSETS, k))).to(dev, tdt).view(1, 1, 2 * k + 1,
                                                    2 * k + 1)
        x4 = x.view(1, 1, N, N)
        l_ms = statistics.median(timed_ms(
            torch, lambda: torch.nn.functional.conv2d(x4, taps, padding=k),
            reps=5))
        b_ms, b_by, forms = k3_bounds(cs, torch, (N, N), k, tdt)
        for form in cs.FORMS:
            k_ms = statistics.median(timed_ms(
                torch, lambda: cs.composed_dense_step(
                    x, 0.1, k, out=y, variant=form), reps=10))
            p_ms = statistics.median(timed_ms(
                torch, lambda: cs.composed_dense_step_plain(
                    x, 0.1, k, variant=form), reps=1, warmup=0))
            composed[f"{form} {dname}"].update(
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=b_by, form_bound_ms=forms[form][0],
                form_bound_by=forms[form][1])
            print(f"K3 {form} {dname} {N}x{N} k={k}: kernel {k_ms:.4f} "
                  f"ms/call, plain {p_ms:.3f} ms, conv2d {2 * k + 1}x"
                  f"{2 * k + 1} {l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"the form's bound {forms[form][0]:.4f} ms "
                  f"({forms[form][1]}), {k_ms / k:.4f} ms per step",
                  flush=True)
        del x, y, x4
        torch.cuda.empty_cache()

    # -- 6b. the field path at full width (BASELINE config 4) ----------------
    model4 = mt.Model(config4_flows(mt))
    rng = np.random.default_rng(SEED)
    base4 = {n: torch.from_numpy(rng.uniform(0.5, 2.0, (N4, N4)).astype(
        np.float32)).to(dev) for n in ("a", "b")}
    field_rows = []
    k4_run = {}  # (dtype, substeps) -> its run's row
    for dname, sub in (("float32", 1), ("float32", 8), ("bfloat16", 1),
                       ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        space = mt.CellularSpace.create(N4, N4, {"a": 1.0, "b": 1.0},
                                        dtype=dname)
        space = space.with_values({n: t.to(tdt) for n, t in base4.items()})
        ex = mt.SerialExecutor(step_impl="pallas", substeps=sub)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        out, rep = model4.execute(space, ex, steps=STEPS)  # raises on drift
        ran = kernel_launches()
        peak = torch.cuda.max_memory_allocated()
        check(rep.impl == "pallas" and rep.backend_report["kernel"]
              == "K4 field_stencil", f"field path ran {rep.impl!r} "
              f"{rep.backend_report}")
        check(ran["field_stencil"] == STEPS // sub
              == rep.backend_report["launches"],
              f"{dname} substeps={sub}: K4 launched {ran['field_stencil']} "
              f"times, expected {STEPS // sub}")
        check(sum(ran.values()) == ran["field_stencil"],
              f"another kernel ran on the field path: {ran}")
        for n in ("a", "b"):
            v = out.values[n]
            check(tuple(v.shape) == (N4, N4) and v.dtype == tdt
                  and bool(torch.isfinite(v).all()),
                  "field-path output has the wrong shape or dtype, or is "
                  "not finite")
        run_ms = timed_ms(torch, lambda: ex.run_model(model4, space, STEPS),
                          reps=3)
        med = statistics.median(run_ms)
        row = {"dtype": dname, "substeps": sub, "steps": STEPS,
               "launches": ran["field_stencil"],
               "conservation_error": rep.conservation_error(),
               "run_ms_median": med, "run_ms_all": run_ms,
               "step_ms": med / STEPS,
               "cell_updates_per_s": N4 * N4 * STEPS / (med / 1e3),
               "peak_mem_bytes": peak, "held_before_run_bytes": held,
               "run_peak_above_held_bytes": peak - held}
        field_rows.append(row)
        k4_run[(dname, sub)] = row
        print(f"field path {dname} {N4}x{N4} substeps={sub}: conserved "
              f"(|d|={row['conservation_error']:.3e}), impl=pallas (K4), "
              f"launches={row['launches']}, {row['step_ms']:.4f} ms/step, "
              f"{row['cell_updates_per_s']:.4e} cell-updates/s, peak "
              f"{peak / 2 ** 30:.2f} GiB ({(peak - held) / 2 ** 30:.2f} GiB "
              f"above the {held / 2 ** 30:.2f} GiB held before the run)",
              flush=True)
        del out, space
        torch.cuda.empty_cache()
    space = mt.CellularSpace.create(N4, N4, {"a": 1.0, "b": 1.0})
    space = space.with_values(base4)
    _, rep = model4.execute(space, mt.SerialExecutor("auto", substeps=8),
                            steps=8)
    check(rep.impl == "pallas" and rep.backend_report["kernel"]
          == "K4 field_stencil", f"SerialExecutor('auto') ran {rep.impl!r}")
    del space

    # 512², 64 steps, against the plain version chained call by call
    small = {n: torch.from_numpy(rng.uniform(0.5, 2.0, (512, 512)).astype(
        np.float32)).to(dev) for n in ("a", "b")}
    for dname, sub in (("float32", 1), ("float32", 8), ("bfloat16", 1),
                       ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        x = {n: t.to(tdt) for n, t in small.items()}
        sp = mt.CellularSpace.create(512, 512, {"a": 1.0, "b": 1.0},
                                     dtype=dname).with_values(x)
        a, _ = model4.execute(sp, mt.SerialExecutor("pallas", substeps=sub),
                              steps=STEPS)
        want = x
        for _ in range(STEPS // sub):
            want = k4.field_step_plain(want, model4.flows, nsteps=sub)
        ok = all(torch.equal(a.values[n], want[n]) for n in ("a", "b"))
        d = max(float((a.values[n].float() - want[n].float()).abs().max())
                for n in ("a", "b"))
        print(f"field path 512x512 {dname} substeps={sub} vs chained plain "
              f"K4, {STEPS} steps: bitwise={ok} (max_abs_err={d:.3e})",
              flush=True)
        check(ok, f"{dname} substeps={sub}: the field path is not bitwise "
                  "the plain version")

    # K4 per call: kernel, plain version, bound; the xla step as context
    field_timing = {}
    for dname, ns in (("float32", 8), ("bfloat16", 16), ("float32", 1),
                      ("bfloat16", 1)):
        tdt = getattr(torch, dname)
        x = {n: t.to(tdt) for n, t in base4.items()}
        step = k4.PallasFieldStep((N4, N4), model4.flows, dtype=tdt,
                                  nsteps=ns, names=("a", "b"))
        bufs = [x, {n: torch.empty_like(t) for n, t in x.items()}]

        def kernel_call():
            step(bufs[0], out=bufs[1])
            bufs.reverse()

        k_ms = statistics.median(timed_ms(torch, kernel_call, reps=10))
        p_ms = statistics.median(timed_ms(
            torch, lambda: k4.field_step_plain(x, model4.flows, nsteps=ns),
            reps=3))
        sp = mt.CellularSpace.create(N4, N4, {"a": 1.0, "b": 1.0},
                                     dtype=dname).with_values(x)
        sx = model4.make_step(sp, impl="xla")
        x_ms = statistics.median(timed_ms(torch, lambda: sx(x), reps=3))
        b_ms, b_by = field_bound_ms(step.program, (N4, N4),
                                    x["a"].element_size(), ns, 8)
        field_timing[(dname, ns)] = {
            "nsteps": ns, "ms": k_ms, "plain_ms": p_ms, "xla_step_ms": x_ms,
            "bound_ms": b_ms, "bound_by": b_by, "rows": step.rows,
            "program": step.program.describe(),
            "program_flops": step.program.flops()}
        print(f"K4 {dname} {N4}x{N4} ns={ns}: kernel {k_ms:.4f} ms/call, "
              f"plain {p_ms:.3f} ms, xla step {x_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), window rows {step.rows}, "
              f"{k_ms / ns:.4f} ms per step", flush=True)
        del x, bufs, sp, sx
        torch.cuda.empty_cache()
    del base4, small

    # -- 6c. ensemble serving at full width (bench.py's serving row) ----------
    from mpi_model_tpu_torch.ensemble.batch import (complete_ensemble,
                                                    launch_ensemble,
                                                    padding_scenarios)

    base5 = np.random.default_rng(SEED).uniform(0.5, 2.0, (N5, N5)).astype(
        np.float32)
    lanes5 = [torch.from_numpy(np.roll(base5, 7 * i, axis=0)).to(dev)
              for i in range(B5)]
    del base5
    lane_rates = [0.1 * (1 + 0.05 * i / (B5 - 1)) for i in range(B5)]
    model01 = mt.Model(mt.Diffusion(0.1))

    def lane_spaces(dname):
        tdt = getattr(torch, dname)
        return [mt.CellularSpace(
            {"value": lane.to(tdt)}, N5, N5) for lane in lanes5]

    # gates on lanes 0 and 7, before any timing
    gates = []
    sp32 = lane_spaces("float32")
    models5 = [mt.Model(mt.Diffusion(r)) for r in lane_rates]
    out = models5[0].execute_many(sp32, models=models5, steps=STEPS5)
    for i in (0, B5 - 1):
        want, wrep = models5[i].execute(sp32[i], mt.SerialExecutor("xla"),
                                        steps=STEPS5)
        ok = (torch.equal(out[i][0].values["value"], want.values["value"])
              and out[i][1].final_total == wrep.final_total)
        gates.append({"gate": f"xla float32 lane {i} == serial xla",
                      "bitwise": ok})
        check(ok, f"ensemble xla lane {i} is not bitwise its serial run")
    del out
    # Against K5's plain version chained call by call (the same calls):
    # bit for bit. Against serial K1 at the same substeps: K1 takes the
    # closed form on cells more than `sub` from the edge, where K5 (whose
    # 4096² TPU tiles all touch an edge) takes the exact path, so the two
    # round differently: within the drift bound of phase 4 (a call differs
    # by at most t = 1e-6·sub·(1 + scale), plus one bf16 ulp of the scale
    # at bf16, carried through the calls with the gain G of one call). And
    # f32 within 1e-6·steps of serial xla.
    for dname in ("float32", "bfloat16"):
        sps = sp32 if dname == "float32" else lane_spaces(dname)
        for sub in (1, 8):
            calls = STEPS5 // sub
            g = gain(lambda o, s: fs.dense_step_plain(o, 0.1, MOORE_OFFSETS,
                                                      s), sub)
            out = model01.execute_many(
                sps, steps=STEPS5,
                executor=mt.EnsembleExecutor("pipeline", substeps=sub))
            for i in (0, B5 - 1):
                got = out[i][0].values["value"].float()
                plain = sps[i].values["value"]
                for _ in range(calls):
                    plain = k5.pipeline_step_plain(plain, 0.1,
                                                   MOORE_OFFSETS, sub)
                refs = [("chained pipeline_step_plain", plain, None),
                        (f"serial pallas substeps={sub}",
                         mt.SerialExecutor("pallas", substeps=sub), "drift")]
                if dname == "float32":
                    refs.append(("serial xla", mt.SerialExecutor("xla"),
                                 "rel"))
                for what, ref, rule in refs:
                    want = (ref if rule is None else model01.execute(
                        sps[i], ref, steps=STEPS5)[0].values["value"])
                    w = want.float()
                    err = float((got - w).abs().max())
                    if rule is None:
                        tol = 0.0
                        ok = torch.equal(out[i][0].values["value"], want)
                    elif rule == "drift":
                        scale = float(w.abs().max())
                        t = 1e-6 * sub * (1.0 + scale)
                        if dname == "bfloat16":
                            t += bf16_ulp(scale)
                        tol = t * sum(g ** c for c in range(calls))
                        ok = err <= tol
                    else:
                        tol = 1e-6 * STEPS5
                        ok = bool(((got - w).abs()
                                   <= tol + tol * w.abs()).all())
                    gates.append({"gate": f"pipeline {dname} substeps={sub} "
                                          f"lane {i} vs {what}",
                                  "max_abs_err": err, "tol": tol,
                                  "bitwise": rule is None, "ok": ok})
                    print(f"ensemble gate: pipeline {dname} substeps={sub} "
                          f"lane {i} vs {what}: max_abs_err={err:.3e} "
                          f"({'bit for bit' if rule is None else f'tol {tol:g}'})",
                          flush=True)
                    check(ok, f"pipeline lane {i} ({dname}, substeps={sub}) "
                              f"disagrees with {what}")
                    del want, w
                del got, plain
            del out
        del sps
    del sp32
    torch.cuda.empty_cache()

    # the serving rows: EnsembleService, one counted dispatch, 5 timed
    ens_rows = []
    for impl, dname, sub in (("pipeline", "float32", 1),
                             ("pipeline", "float32", 8),
                             ("pipeline", "bfloat16", 1),
                             ("pipeline", "bfloat16", 8),
                             ("xla", "float32", 1), ("xla", "bfloat16", 1)):
        spaces = lane_spaces(dname)
        models = ([model01] * B5 if impl == "pipeline"
                  else [mt.Model(mt.Diffusion(r)) for r in lane_rates])
        svc = mt.EnsembleService(models[0], steps=STEPS5, impl=impl,
                                 substeps=sub, buckets=mt.buckets_for(B5),
                                 retry="solo")

        def dispatch():
            tickets = [svc.submit(s, model=m)
                       for s, m in zip(spaces, models)]
            return [svc.result(t) for t in tickets]

        dispatch()  # the runner's build
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        res = dispatch()
        ran = kernel_launches()
        peak = torch.cuda.max_memory_allocated()
        want_k5 = (STEPS5 // sub + STEPS5 % sub) if impl == "pipeline" else 0
        check(ran["pipeline_stencil"] == want_k5
              and sum(ran.values()) == want_k5,
              f"ensemble {impl} {dname} substeps={sub}: launches {ran}, "
              f"expected {want_k5} of K5 and nothing else")
        if impl == "pipeline":
            ladder_guard(svc.stats(), ran["pipeline_stencil"],
                         f"6c ensemble {impl} {dname} substeps={sub}")
        for sp, rep in res:
            v = sp.values["value"]
            check(tuple(v.shape) == (N5, N5) and v.dtype == getattr(
                torch, dname) and bool(torch.isfinite(v).all()),
                "ensemble output has the wrong shape or dtype, or is not "
                "finite")
            check(rep.impl == impl, f"ensemble row ran {rep.impl!r}")
        cons = max(rep.conservation_error() for _, rep in res)
        del res
        times = timed_ms(torch, dispatch, reps=5)
        med = statistics.median(times)
        st = svc.stats()
        check(st["runner_builds"] == 1
              and st["runner_cache_hits"] == st["dispatches"] - 1
              and st["batch_occupancy"] == 1.0,
              f"ensemble {impl} {dname}: runner cache or occupancy off: "
              f"{st}")
        row = {"impl": impl, "dtype": dname, "substeps": sub, "B": B5,
               "grid": [N5, N5], "steps": STEPS5,
               "k5_launches_per_dispatch": ran["pipeline_stencil"],
               "launches": ran, "conservation_error": cons,
               "dispatch_ms_median": med, "dispatch_ms_all": times,
               "scenarios_per_s": B5 / (med / 1e3),
               "cell_updates_per_s": B5 * N5 * N5 * STEPS5 / (med / 1e3),
               "batch_occupancy": st["batch_occupancy"],
               "runner_builds": st["runner_builds"],
               "runner_cache_hits": st["runner_cache_hits"],
               "compile_cache_hit_rate": st["compile_cache_hit_rate"],
               "peak_mem_bytes": peak, "held_before_bytes": held,
               "peak_above_held_bytes": peak - held}
        ens_rows.append(row)
        print(f"ensemble {impl} {dname} B={B5} {N5}x{N5} substeps={sub}: "
              f"{row['scenarios_per_s']:.2f} scenarios/s, "
              f"{row['cell_updates_per_s']:.4e} cell-updates/s (dispatch "
              f"{med:.3f} ms), K5 launches/dispatch "
              f"{row['k5_launches_per_dispatch']}, occupancy "
              f"{row['batch_occupancy']}, builds {row['runner_builds']}, "
              f"hits {row['runner_cache_hits']} (rate "
              f"{row['compile_cache_hit_rate']:.3f}), peak "
              f"{(peak - held) / 2 ** 30:.2f} GiB above the "
              f"{held / 2 ** 30:.2f} GiB held", flush=True)
        if impl == "pipeline" and sub == 8:
            row["profile"] = profile_dispatch(torch, dispatch, med)
            print_profile(f"ensemble pipeline {dname} substeps=8 dispatch",
                          row["profile"])
        del spaces, svc
        torch.cuda.empty_cache()

    # the sequential baselines: B serial runs of the same lanes, through
    # the executor alone and (K1) through Model.execute, which also takes
    # the totals, conservation check and report a served scenario carries
    for dname in ("float32", "bfloat16"):
        spaces = lane_spaces(dname)
        for impl, sub, via in (("xla", 1, "run_model"),
                               ("pallas", 8, "run_model"),
                               ("pallas", 8, "execute")):
            ex = mt.SerialExecutor(impl, substeps=sub)

            def sequential():
                for s in spaces:
                    if via == "execute":
                        model01.execute(s, ex, steps=STEPS5)
                    else:
                        ex.run_model(model01, s, STEPS5)

            med = statistics.median(timed_ms(torch, sequential, reps=3))
            name = (f"{B5} x SerialExecutor({impl!r}, substeps={sub})"
                    + (" via Model.execute" if via == "execute" else ""))
            row = {"baseline": name, "via": via,
                   "impl": impl, "dtype": dname, "substeps": sub,
                   "B": B5, "steps": STEPS5, "ms": med,
                   "scenarios_per_s": B5 / (med / 1e3),
                   "cell_updates_per_s": B5 * N5 * N5 * STEPS5 / (med / 1e3)}
            if impl == "pallas" and dname == "float32":
                row["profile"] = profile_dispatch(torch, sequential, med)
                print_profile(f"sequential {name} {dname}", row["profile"])
            ens_rows.append(row)
            print(f"sequential {row['baseline']} {dname}: "
                  f"{row['scenarios_per_s']:.2f} scenarios/s, "
                  f"{row['cell_updates_per_s']:.4e} cell-updates/s "
                  f"({med:.3f} ms)", flush=True)
        del spaces
        torch.cuda.empty_cache()

    # a partial batch: 3 scenarios pad to the 4-bucket; the pad lane stays 0
    sp3 = lane_spaces("float32")[:3]
    svc = mt.EnsembleService(model01, steps=STEPS5, impl="pipeline",
                             substeps=8, buckets=mt.buckets_for(B5))
    k5_0 = k5.launches()
    ts = [svc.submit(s) for s in sp3]
    svc.flush()
    res3 = [svc.result(t) for t in ts]
    st = svc.stats()
    ladder_guard(st, k5.launches() - k5_0, "6c the padded pipeline batch")
    check(st["batch_occupancy"] == 0.75
          and svc.scheduler.dispatch_log[-1]["bucket"] == 4
          and len(res3) == 3, f"B=3 did not pad to the 4-bucket: {st}")
    psp, pmod = padding_scenarios(model01, sp3[0], 1)
    fl = launch_ensemble(model01, sp3 + psp, models=[model01] * 3 + pmod,
                         executor=mt.EnsembleExecutor("pipeline", substeps=8),
                         steps=STEPS5, count=3)
    complete_ensemble(fl)
    pad_zero = float(fl.out[0]["value"][3].abs().max()) == 0.0
    check(pad_zero, "the pad lane of a padded pipeline batch is not zero")
    print(f"ensemble B=3 into the 4-bucket: occupancy "
          f"{st['batch_occupancy']}, pad lane identically zero: {pad_zero}",
          flush=True)
    del sp3, svc, res3, fl, psp
    torch.cuda.empty_cache()

    # K5 per call on the path's batch: kernel, plain, bound, conv2d x ns
    k5_time = {}
    for dname in ("float32", "bfloat16"):
        tdt = getattr(torch, dname)
        x = torch.stack(lanes5).to(tdt)
        y = torch.empty_like(x)
        w = torch.ones((1, 1, 3, 3), device=dev, dtype=tdt)
        x4 = x.view(B5, 1, N5, N5)
        l1 = statistics.median(timed_ms(
            torch, lambda: torch.nn.functional.conv2d(x4, w, padding=1),
            reps=10))
        for ns in (8, 1):
            bufs = [x, y]

            def kernel_call():
                k5.pipeline_dense_step(bufs[0], 0.1, nsteps=ns, out=bufs[1])
                bufs.reverse()

            k_ms = statistics.median(timed_ms(torch, kernel_call, reps=20))
            p_ms = statistics.median(timed_ms(
                torch, lambda: k5.pipeline_step_plain(x, 0.1, MOORE_OFFSETS,
                                                      ns), reps=3))
            blk = k5.pipeline_block((N5, N5), ns)
            inner = int(k5.interior_mask((N5, N5), blk, ns).sum())
            b_ms, b_by = k5_bound_ms(B5, (N5, N5), x.element_size(), ns, 8,
                                     inner)
            # the kernel's forms: output cells of one lane on the closed
            # walk, the exact walk with the full count, the exact walk
            # with per-cell counts (windows reaching the edge band)
            split = {"closed": 0, "exact_full_count": 0, "exact_edge": 0}
            for r0, r1, c0, c1, near, full in k5.launch_windows(
                    (N5, N5), blk, ns, MOORE_OFFSETS):
                key = ("closed" if not near else
                       "exact_full_count" if full else "exact_edge")
                split[key] += (r1 - r0) * (c1 - c0)
            k5_time[(dname, ns)] = {
                "nsteps": ns, "ms": k_ms, "plain_ms": p_ms,
                "library_ms": l1 * ns, "conv2d_one_ms": l1,
                "bound_ms": b_ms, "bound_by": b_by, "block": list(blk),
                "interior_cells_per_lane": inner,
                "window_rows": k5.window_rows(MOORE_OFFSETS, ns),
                "cells_per_lane_by_form": split}
            print(f"K5 {dname} B={B5} {N5}x{N5} ns={ns}: kernel {k_ms:.4f} "
                  f"ms/call, plain {p_ms:.3f} ms, conv2d 3x3 x {ns} "
                  f"{l1 * ns:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"block {blk}, {inner} interior cells a lane; cells a "
                  f"lane by form {split})", flush=True)
        del x, y, x4, bufs
        torch.cuda.empty_cache()
    for row in ens_rows:
        if row.get("impl") == "pipeline" and "dispatch_ms_median" in row:
            kt = k5_time[(row["dtype"], row["substeps"])]
            kernel_ms = row["k5_launches_per_dispatch"] * kt["ms"]
            row.update(k5_ms_per_call=kt["ms"], k5_ms_per_dispatch=kernel_ms,
                       host_share=1.0 - kernel_ms / row["dispatch_ms_median"])
            print(f"ensemble pipeline {row['dtype']} substeps="
                  f"{row['substeps']}: dispatch {row['dispatch_ms_median']:.3f}"
                  f" ms against {kernel_ms:.3f} ms of K5 (host share "
                  f"{row['host_share']:.3f})", flush=True)
    del lanes5

    # -- 6c-serve. always-on serving at full width ------------------------------
    serving = serving_phase(np, torch, mt, dev, reset_counts,
                            kernel_launches)
    torch.cuda.empty_cache()

    # -- 6d. the halo kernels against their plain versions --------------------
    halo_err = halo_kernel_cases(np, torch, mt, dev, gen, record,
                                 neighborhoods)

    # -- 6e. the sharded main path at full width -------------------------------
    sharded = sharded_main_path(np, torch, mt, dev, gen, reset_counts,
                                kernel_launches, oracle)
    sharded["point_off_the_subsystem"] = point_flows_off_the_subsystem(
        np, torch, mt, dev, oracle)
    torch.cuda.empty_cache()

    # -- 6f. the shard-local active path at full width ------------------------
    sharded_active = sharded_active_path(np, torch, mt, dev, reset_counts,
                                         kernel_launches)
    torch.cuda.empty_cache()

    # -- 6g. bf16 interior math, against the plain versions and full width ----
    f32_ms = {f"K1 {d} ns={ns}": timings[(d, ns)] for d, ns in k1_runs}
    f32_ms.update({f"K3 {form} {d} k={k}": composed[f"{form} {d}"]
                   for form in cs.FORMS
                   for d, k in (("float32", 8), ("bfloat16", 16))})
    f32_ms.update({f"K4 {d} ns={ns}": t for (d, ns), t in
                   field_timing.items()})
    f32_ms["K2 float32 ns=8"] = sharded["calls"]["K2"]
    f32_ms.update({f"K3-halo {form} float32": sharded["calls"]["K3-halo"][form]
                   for form in cs.FORMS})
    f32_ms["K4-halo"] = sharded["calls"]["K4-halo"]
    f32_ms[f"K5 float32 {B5}x{N5}"] = k5_time[("float32", 8)]
    bf16 = bf16_interior_phase(np, torch, mt, dev, gen, record, reset_counts,
                               neighborhoods, f32_ms)
    torch.cuda.empty_cache()

    # -- 6h. checkpoints, supervision and migration at full width -------------
    ckpt = checkpoint_phase(
        np, torch, mt, dev,
        Path(__file__).resolve().parent / "chiprun_out" / "ckpt_6h",
        reset_counts, kernel_launches)
    torch.cuda.empty_cache()

    # -- 6i. the Flow IR on the card -------------------------------------------
    ir = ir_phase(np, torch, mt, dev, reset_counts, kernel_launches)
    torch.cuda.empty_cache()

    # -- 6j. observability: tracing, the roofline, the status plane -------------
    t_obs = time.perf_counter()
    # 6k (g) runs here, in the long process the earlier phases profiled
    trace_g = device_trace_in_long_process(
        torch, mt, fs, dev, here / "chiprun_out" / "device_trace_6k")
    # (f) the build cache: the cold process (started before phase 2) built
    # into an empty directory, a warm one loads from it
    cold.wait(timeout=900)
    probes = {"cold": cold_log.read_text()}
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, "
         "sys.argv[1]); import chip_smoke; "
         "chip_smoke.compile_cache_probe(sys.argv[2])", str(here),
         str(cache_dir)], cwd=here, capture_output=True, text=True,
        timeout=600)
    probes["warm"] = proc.stdout + proc.stderr
    check(cold.returncode == 0 and proc.returncode == 0,
          f"6j (f) a build-cache probe failed:\n{probes['cold'][-2000:]}\n"
          f"{probes['warm'][-2000:]}")
    cache = {k: json.loads(v.strip().splitlines()[-1])
             for k, v in probes.items()}
    shutil.rmtree(cache_dir, ignore_errors=True)
    cold_log.unlink()
    for k in ("cold", "warm"):
        b = cache[k]["build"]
        print(f"6j (f) {k} process on --compile-cache={cache_dir.name}: "
              f"built or loaded {sorted(b)}, "
              + ", ".join(f"{n} {v['seconds']:.2f} s cached={v['cached']}"
                          for n, v in b.items())
              + f"; {cache[k]['seconds']:.1f} s the process; row impl "
              f"{cache[k]['row']['impl']}, {cache[k]['row']['kernel_launches']}"
              " launches", flush=True)
    check(list(cache["cold"]["build"]) == ["fused_stencil"]
          and not cache["cold"]["build"]["fused_stencil"]["cached"]
          and cache["cold"]["build_dir"] == str(cache_dir),
          f"6j (f) the cold process did not build fused_stencil alone: "
          f"{cache['cold']['build']}")
    check(list(cache["warm"]["build"]) == ["fused_stencil"]
          and all(v["cached"] for v in cache["warm"]["build"].values()),
          f"6j (f) the warm process ran nvcc: {cache['warm']['build']}")
    check(all(cache[k]["row"]["conserved"] and cache[k]["row"]["impl"]
              == "pallas" for k in cache), "6j (f) a probe's run failed")
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, "
         "sys.argv[1]); import chip_smoke; chip_smoke.observability_main()",
         str(here)], cwd=here, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    check(proc.returncode == 0, "6j: the observability process failed:\n"
                                f"{proc.stderr[-4000:]}")
    observability = json.loads(lines[-1])
    observability.update(f=cache,
                         seconds_total=time.perf_counter() - t_obs)
    print(f"6j: {observability['seconds_total']:.1f} s (its process "
          f"{observability['seconds']:.1f} s)", flush=True)

    # -- 6k. the degradation ladder and the fleet's formats ----------------------
    ladder = ladder_formats_phase(np, torch, mt, dev, reset_counts,
                                  kernel_launches)
    ladder["g"] = trace_g

    # -- 7. CLI and the reference run ------------------------------------------
    from mpi_model_tpu_torch.cli import main as cli_main
    rc = cli_main(["run", "--flow=diffusion", f"--dimx={N}", f"--dimy={N}",
                   "--impl=pallas", "--substeps=8", "--steps=8", "--json"])
    check(rc == 0, "the CLI run failed")
    rc = cli_main(["run", "--flow=diffusion", f"--dimx={N}", f"--dimy={N}",
                   "--impl=active_fused", "--substeps=8", "--steps=8",
                   "--blob=0.05", "--json"])
    check(rc == 0, "the active_fused CLI run failed")
    rc = cli_main(["run", "--flow=coupled", "--channels=2", "--impl=pallas",
                   f"--dimx={N4}", f"--dimy={N4}", "--substeps=8",
                   "--steps=8", "--json"])
    check(rc == 0, "the coupled (K4) CLI run failed")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["run", "--flow=diffusion", f"--dimx={N5}",
                       f"--dimy={N5}", f"--ensemble={B5}",
                       "--ensemble-impl=pipeline", "--substeps=8",
                       f"--steps={STEPS5}", "--json"])
    print(buf.getvalue(), end="", flush=True)
    check(rc == 0, "the ensemble (K5) CLI run failed")
    cli_row_guard(json.loads(buf.getvalue().strip().splitlines()[-1]),
                  "7 the ensemble (K5) CLI row")
    rc = cli_main(["run", "--flow=diffusion", f"--dimx={N}", f"--dimy={N}",
                   "--mesh=2x2", "--impl=pallas", "--halo-depth=8",
                   "--steps=8", "--json"])
    check(rc == 0, "the sharded (K2) CLI run failed")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["run", "--flow=diffusion", f"--dimx={N}",
                       f"--dimy={N}", "--mesh=2x2", "--impl=active_fused",
                       "--blob=0.05", "--steps=8", "--json"])
    print(buf.getvalue(), end="", flush=True)
    cli_row = json.loads(buf.getvalue().strip().splitlines()[-1])
    br = cli_row["backend_report"]
    check(rc == 0 and cli_row["impl"] == "active_fused"
          and br["flags_fused"] > 0
          and cli_row["kernel_launches"] == 2 * br["flags_fused"],
          f"the sharded active_fused CLI run failed: {cli_row}")
    ref_dir = Path(__file__).resolve().parent / "chiprun_out" / "cli_output"
    shutil.rmtree(ref_dir, ignore_errors=True)
    rc = cli_main(["run", "--flow=exponencial", "--source=19,3",
                   "--value=2.2", "--rate=0.1", "--steps=-1",
                   "--dtype=float64", f"--output={ref_dir}", "--json"])
    check(rc == 0, "the reference scenario's CLI run failed")
    want = oracle.reference_run_np(steps=50)
    want_bytes = "".join(f"{x}\t{y}\t{float(want[x, y]):.6g}\n"
                         for x in range(100) for y in range(100)).encode()
    merged = [f for f in ref_dir.iterdir() if f.name.startswith("output ")]
    ok = (len(merged) == 1 and merged[0].read_bytes() == want_bytes
          and (ref_dir / "comm_rank0.txt").read_bytes() == want_bytes)
    print(f"CLI reference scenario --output: merged file and dump equal the "
          f"oracle's values written out: {ok}", flush=True)
    check(ok, "the CLI's --output files disagree with the oracle")

    for steps in (1, 50):
        space = mt.CellularSpace.create(100, 100, 1.0, dtype="float64")
        ref_model = mt.Model(mt.Exponencial(
            mt.Cell(19, 3, mt.Attribute(99, 2.2)), 0.1), 10.0, 0.2)
        out, rep = ref_model.execute(space, steps=steps)
        got = out.values["value"].cpu().numpy()
        want = oracle.reference_run_np(steps=steps)
        diff = float(abs(got - want).max())
        total = float(out.total("value"))
        print(f"reference run steps={steps}: impl={rep.impl} sum={total!r} "
              f"source cell={got[19, 3]!r} max_abs_err vs oracle={diff:.3e} "
              f"bitwise={bool((got == want).all())}", flush=True)
        check(diff <= 1e-12 and abs(total - 10000.0) <= 1e-9,
              "reference run disagrees with the oracle")
        check(rep.impl == "point", f"the reference run ran {rep.impl!r}, "
                                   "not the point subsystem")
        if steps == 1:
            check(abs(got[19, 3] - 0.78) <= 1e-12, "source cell is not 0.78")

    # -- 8. result lines ------------------------------------------------------
    def row_of(impl, sub, frac):
        return next(r for r in active_rows if r["impl"] == impl
                    and r["substeps"] == sub and r["frac"] == frac)

    entries = [{
        "name": f"K1 fused_stencil {dname} ns={ns}",
        "route": "cuda",
        "source": "mpi_model_tpu_torch/csrc/fused_stencil.cu",
        "replaces": "mpi_model_tpu/ops/pallas_stencil.py:526",
        "launches": results[(dname, ns)]["launches"],
        "max_abs_err": main_err[(dname, ns)],
        "ms": timings[(dname, ns)]["ms"],
        "plain_ms": timings[(dname, ns)]["plain_ms"],
        "bound_ms": timings[(dname, ns)]["bound_ms"],
        "bound_by": timings[(dname, ns)]["bound_by"],
        "library_ms": timings[(dname, ns)]["library_ms"],
        "library_one_step_ms": timings[(dname, ns)]["library_one_step_ms"],
        "shape": [N, N], "dtype": dname, "nsteps": ns,
        "main_path": results[(dname, ns)],
    } for dname, ns in k1_runs]
    for form in cs.FORMS:
        for dname in ("float32", "bfloat16"):
            c = composed[f"{form} {dname}"]
            entries.append({
                "name": f"K3 composed_stencil {form} {dname}",
                "route": "cuda",
                "source": "mpi_model_tpu_torch/csrc/composed_stencil.cu",
                "replaces": "mpi_model_tpu/ops/pallas_stencil.py:526",
                "hook": ("mpi_model_tpu/ops/composed_stencil.py:"
                         + ("157" if form == "vpu" else "197")),
                "launches": c["launches"],
                "max_abs_err": k3_err[(form, dname)],
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "form_bound_ms": c["form_bound_ms"],
                "form_bound_by": c["form_bound_by"],
                "library_ms": c["library_ms"],
                "shape": [N, N], "dtype": dname, "k": c["k"], "form": form,
                "main_path": {key: c[key] for key in (
                    "steps", "substeps", "variant", "form",
                    "conservation_error", "run_ms_median",
                    "cell_updates_per_s", "vs_k1_512_err")},
            })
    for k, sub in ((1, 1), (8, 8)):
        kt = k67_time[(0.05, k)]
        row = row_of("active_fused", sub, 0.05)
        b_bytes = 2 * kt["count"] * 128 * 128 * 4 / HBM_BYTES_PER_S * 1e3
        b_ops = (kt["tap_lanes"] * 128 * 128 * 2 * (2 * k + 1) ** 2
                 / F32_FLOPS * 1e3)
        b_ms, b_by = larger(b_bytes, b_ops)
        # the kernel's form: under --fmad=false each multiply and each add
        # of the tap sum is an instruction, at half the FMA peak's rate
        f_ms, f_by = larger(b_bytes, 2 * b_ops)
        entries.append({
            "name": f"K6 fused_compute float32 k={k}",
            "route": "cuda",
            "source": "mpi_model_tpu_torch/csrc/fused_active.cu",
            "replaces": "mpi_model_tpu/ops/pallas_active.py:293",
            "launches": row["launches"]["fused_compute"],
            "max_abs_err": k6_err[k],
            "ms": kt["k6_ms"], "plain_ms": kt["k6_plain_ms"],
            "ms_back_to_back": kt["k6_ms_back_to_back"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "form_bound_ms": f_ms, "form_bound_by": f_by,
            "shape": [N, N], "dtype": "float32", "k": k, "frac": 0.05,
            "active_tiles": kt["count"], "tap_lanes": kt["tap_lanes"],
        })
    kt = k67_time[(0.05, 1)]
    row = row_of("active_fused", 1, 0.05)
    entries.append({
        "name": "K7 fused_scatter float32",
        "route": "cuda",
        "source": "mpi_model_tpu_torch/csrc/fused_active.cu",
        "replaces": "mpi_model_tpu/ops/pallas_active.py:343",
        "launches": row["launches"]["fused_scatter"],
        "max_abs_err": 0.0,
        "ms": kt["k7_ms"], "plain_ms": kt["k7_plain_ms"],
        "ms_back_to_back": kt["k7_ms_back_to_back"],
        "bound_ms": kt["k7_bound_ms"], "bound_by": "bytes",
        "library_ms": kt["k7_library_ms"],
        "library": "index_copy_ of the live tiles' flat cells",
        "grid": "persistent, 3 blocks an SM, 4 rows a warp",
        "shape": [N, N], "dtype": "float32", "frac": 0.05,
        "active_tiles": kt["count"],
        "by_frac": {f"{f}": {key: k67_time[(f, 1)][key] for key in (
            "k7_ms", "k7_ms_back_to_back", "k7_bound_ms", "k7_library_ms",
            "count")} for f in FRACS},
    })
    for dname, ns in (("float32", 8), ("bfloat16", 16), ("float32", 1),
                      ("bfloat16", 1)):
        t = field_timing[(dname, ns)]
        entries.append({
            "name": f"K4 field_stencil {dname} ns={ns}",
            "route": "cuda",
            "source": "mpi_model_tpu_torch/csrc/field_stencil.cuh",
            "generated_by": "mpi_model_tpu_torch/ops/field_codegen.py",
            "replaces": "mpi_model_tpu/ops/pallas_stencil.py:1380",
            "launches": k4_run[(dname, ns)]["launches"],
            "max_abs_err": k4_err[(dname, ns)],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": [N4, N4], "dtype": dname, "nsteps": ns,
            "rows": t["rows"], "xla_step_ms": t["xla_step_ms"],
            "main_path": k4_run[(dname, ns)],
        })
    for dname in ("float32", "bfloat16"):
        t = k5_time[(dname, 8)]
        row = next(r for r in ens_rows if r.get("impl") == "pipeline"
                   and r["dtype"] == dname and r.get("substeps") == 8
                   and "dispatch_ms_median" in r)
        entries.append({
            "name": f"K5 pipeline_stencil {dname}",
            "route": "cuda",
            "source": "mpi_model_tpu_torch/csrc/pipeline_stencil.cu",
            "replaces": "mpi_model_tpu/ops/pallas_stencil.py:728",
            "launches": row["k5_launches_per_dispatch"],
            "max_abs_err": k5_err[dname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": [B5, N5, N5], "dtype": dname, "nsteps": 8,
            "nsteps1": k5_time[(dname, 1)], "main_path": row,
        })
    halo_rows = {"K2": ("fused_stencil_halo", "fused_stencil.cu",
                        "mpi_model_tpu/ops/pallas_stencil.py:757",
                        f"K2 {N}x{N}", None),
                 "K3-halo vpu": ("composed_stencil_halo", "composed_stencil.cu",
                                 "mpi_model_tpu/ops/composed_stencil.py:323",
                                 f"K3-halo vpu {N}x{N}", "vpu"),
                 "K3-halo mxu": ("composed_stencil_halo", "composed_stencil.cu",
                                 "mpi_model_tpu/ops/composed_stencil.py:323",
                                 f"K3-halo mxu {N}x{N}", "mxu"),
                 "K4-halo": ("field_stencil_halo", "field_stencil.cuh",
                             "mpi_model_tpu/ops/pallas_stencil.py:1396",
                             f"K4-halo config 4 {N4}x{N4}", None)}
    for kname, (fn, src, replaces, run_name, form) in halo_rows.items():
        c = (sharded["calls"]["K3-halo"][form] if form
             else sharded["calls"][kname])
        run = next(r for r in sharded["runs"] if r["what"] == run_name
                   and r["mesh"] == "2x2")
        entry = {
            "name": (f"K3-halo {fn} {form} float32" if form
                     else f"{kname} {fn} float32"),
            "route": "cuda",
            "source": f"mpi_model_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": run["launches"],
            "max_abs_err": halo_err[kname],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "shape": c["shape"], "dtype": "float32",
            "main_path": {k: v for k, v in run.items() if k != "profile"},
        }
        if form:
            entry.update(form=form, form_bound_ms=c["form_bound_ms"],
                         form_bound_by=c["form_bound_by"])
        entries.append(entry)
    k67_row = next(r for r in sharded_active["runs"] if r["frac"] == 0.05
                   and r["mesh"] == "2x2" and r["impl"] == "active_fused")
    kt = sharded_active["k67"]["2x2 0.05"]
    main_row = {k: v for k, v in k67_row.items() if k != "profile"}
    for kname, fn, rep_line, key in (
            ("K6", "fused_compute", "mpi_model_tpu/ops/pallas_active.py:293",
             "k6"),
            ("K7", "fused_scatter", "mpi_model_tpu/ops/pallas_active.py:343",
             "k7")):
        entries.append({
            "name": f"{kname} fused_active sharded float32",
            "route": "cuda",
            "source": "mpi_model_tpu_torch/csrc/fused_active.cu",
            "replaces": rep_line,
            "launches": k67_row["launches"][fn],
            "max_abs_err": kt["k6_max_abs_err"] if key == "k6" else 0.0,
            "ms": kt[f"{key}_ms"], "plain_ms": kt[f"{key}_plain_ms"],
            "bound_ms": kt[f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": kt.get(f"{key}_library_ms"),
            "shape": kt["shard"], "dtype": "float32", "k": 1, "frac": 0.05,
            "origin": kt["origin"], "active_tiles": kt["active_tiles"],
            "main_path": main_row,
        })
    # the bf16-interior variants: the main path's counted run, this run's
    # kernel ms beside the f32-compute kernel's, the bound of their form
    for name, src, replaces, call, run in (
            ("K1 fused_stencil float32 ns=8", "fused_stencil.cu",
             "mpi_model_tpu/ops/pallas_stencil.py:526", "K1 float32 ns=8",
             "K1 float32 ns=8"),
            ("K1 fused_stencil bfloat16 ns=16", "fused_stencil.cu",
             "mpi_model_tpu/ops/pallas_stencil.py:526", "K1 bfloat16 ns=16",
             "K1 bfloat16 ns=16"),
            ("K3 composed_stencil vpu float32 k=8", "composed_stencil.cu",
             "mpi_model_tpu/ops/composed_stencil.py:157",
             "K3 vpu float32 k=8", "K3 vpu float32 k=8"),
            ("K3 composed_stencil mxu float32 k=8", "composed_stencil.cu",
             "mpi_model_tpu/ops/composed_stencil.py:197",
             "K3 mxu float32 k=8", "K3 mxu float32 k=8"),
            ("K3 composed_stencil vpu bfloat16 k=16", "composed_stencil.cu",
             "mpi_model_tpu/ops/composed_stencil.py:157",
             "K3 vpu bfloat16 k=16", "K3 vpu bfloat16 k=16"),
            ("K3 composed_stencil mxu bfloat16 k=16", "composed_stencil.cu",
             "mpi_model_tpu/ops/composed_stencil.py:197",
             "K3 mxu bfloat16 k=16", "K3 mxu bfloat16 k=16"),
            ("K3 composed_stencil vpu float32 k=2 (auto)",
             "composed_stencil.cu",
             "mpi_model_tpu/ops/composed_stencil.py:157",
             "K3 auto float32 k=2", "K3 auto float32 k=2"),
            *((f"K4 field_stencil {d} ns={ns}", "field_stencil.cuh",
               "mpi_model_tpu/ops/pallas_stencil.py:1380",
               f"K4 config4 {d} ns={ns}", f"K4 config4 {d} ns={ns}")
              for d, ns in (("float32", 1), ("float32", 8), ("bfloat16", 1),
                            ("bfloat16", 16))),
            ("K2 fused_stencil_halo float32 ns=8", "fused_stencil.cu",
             "mpi_model_tpu/ops/pallas_stencil.py:757",
             "K2 float32 ns=8 shard (8192, 8192)", "K2 2x2 float32 depth=8"),
            ("K3-halo composed_stencil vpu float32 k=8",
             "composed_stencil.cu",
             "mpi_model_tpu/ops/composed_stencil.py:323",
             "K3-halo vpu float32 k=8 shard (8192, 8192)",
             "K3-halo vpu 2x2 float32 depth=8"),
            ("K3-halo composed_stencil mxu float32 k=8",
             "composed_stencil.cu",
             "mpi_model_tpu/ops/composed_stencil.py:323",
             "K3-halo mxu float32 k=8 shard (8192, 8192)",
             "K3-halo mxu 2x2 float32 depth=8"),
            ("K4-halo field_stencil float32 ns=8", "field_stencil.cuh",
             "mpi_model_tpu/ops/pallas_stencil.py:1396",
             "K4-halo config4 float32 ns=8 shard (4096, 4096)",
             "K4-halo config4 2x2 float32 depth=8"),
            (f"K5 pipeline_stencil float32 {B5}x{N5}^2", "pipeline_stencil.cu",
             "mpi_model_tpu/ops/pallas_stencil.py:728",
             f"K5 float32 ns=8 {B5}x{N5}^2",
             f"K5 ensemble {B5}x{N5}^2 float32 substeps=8"),
            (f"K5 pipeline_stencil float32 4x{N4}^2", "pipeline_stencil.cu",
             "mpi_model_tpu/ops/pallas_stencil.py:728",
             f"K5 float32 ns=8 4x{N4}^2",
             f"K5 ensemble 4x{N4}^2 float32 substeps=8")):
        c = bf16["calls"][call]
        entries.append({
            "name": f"{name} bf16-interior", "route": "cuda",
            "source": f"mpi_model_tpu_torch/csrc/{src}",
            "replaces": replaces, "compute_dtype": "bfloat16",
            "launches": bf16["rows"][run]["launches"],
            "max_abs_err": c["max_abs_err"],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "f32_compute_ms": c["f32_compute_ms"],
            "bf16_cells": c.get("bf16_cells"),
            **{key: c[key] for key in ("form_bound_ms", "form_bound_by",
                                       "rows", "rows16") if key in c},
            # K4's bf16 interior math: the walks and kernels a launch the
            # main path's counted run showed in its trace (the f32 walk off
            # the rectangle, the paired walk in it: two kernels, counted as
            # one launch)
            **({key: bf16["rows"][run]["k4_walk"][key]
                for key in ("walk", "kernels_per_launch")}
               | {"generated_by": "mpi_model_tpu_torch/ops/field_codegen.py"}
               if name.startswith("K4") else {}),
            # K3 mxu's bf16 interior math: the persistent walk's instance
            # from the main path's counted run, traced
            **({"instance": bf16["rows"][run]["k3_walk"]["instance"]}
               if "k3_walk" in bf16["rows"][run] else {}),
            # K1/K2's bf16 interior math: the near launch and the paired
            # launch, two kernels counted as one launch, from the main
            # path's counted run, traced, with their instances
            # (and K3 vpu's: the same)
            **next(({key: bf16["rows"][run][w][key]
                     for key in ("walk", "kernels_per_launch")}
                    | {"instances": sorted(bf16["rows"][run][w]["kernels"])}
                    for w in ("k1_walk", "k3_vpu_walk")
                    if w in bf16["rows"][run]), {}),
            # K5's bf16 interior math: the near launch and (with closed
            # tiles) the paired launch, counted as one launch, from the
            # dispatch's trace, and each one's device ms there
            **({"kernels_per_launch": bf16["rows"][run]["k5_walk"][
                    "kernels_per_launch"],
                "instances": sorted(bf16["rows"][run]["k5_walk"]["kernels"]),
                "near_ms": c["near_ms"], "paired_ms": c["paired_ms"]}
               if "k5_walk" in bf16["rows"][run] else {}),
            "main_path": bf16["rows"][run]})
    # K5's two bf16-interior kernels, each its own row: its launches and its
    # device ms from the traced dispatch, its cells' bound
    for B, side in ((B5, N5), (4, N4)):
        call = f"K5 float32 ns=8 {B}x{side}^2"
        run = f"K5 ensemble {B}x{side}^2 float32 substeps=8"
        c, row = bf16["calls"][call], bf16["rows"][run]
        for kname, key in (("pipeline_near_kernel", "near"),
                           ("pipeline_bf16_kernel", "paired")):
            if c[f"{key}_ms"] is None:
                continue  # no closed tile: no paired launch
            entries.append({
                "name": f"K5 {kname} float32 {B}x{side}^2 bf16-interior",
                "route": "cuda",
                "source": "mpi_model_tpu_torch/csrc/pipeline_stencil.cu",
                "replaces": "mpi_model_tpu/ops/pallas_stencil.py:728",
                "compute_dtype": "bfloat16",
                "launches": sum(n for k, n in row["k5_walk"][
                    "kernels"].items() if kname in k),
                "max_abs_err": c["max_abs_err"],
                "ms": c[f"{key}_ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c[f"{key}_bound"][0],
                "bound_by": c[f"{key}_bound"][1], "library_ms": None,
                "ms_from": "the traced dispatch's device time",
                "plain_of": "the whole call", "shape": [B, side, side],
                "nsteps": 8, "main_path": row})
    kernels = {"kernels": entries}
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card_line, "kind": kind, **kernels,
         "active_rows": active_rows, "k67_times": {
             f"{f}/k={k}": v for (f, k), v in k67_time.items()},
         "composed": composed, "field_rows": field_rows,
         "field_timing": {f"{d}/ns={n}": v
                          for (d, n), v in field_timing.items()},
         "ensemble_gates": gates,
         "ensemble_rows": ens_rows,
         "serving": serving,
         "k5_times": {f"{d}/ns={n}": v for (d, n), v in k5_time.items()},
         "count_read_us": sync_us,
         "sharded": sharded, "halo_main_shard_err": halo_err,
         "sharded_active": sharded_active, "bf16_interior": bf16,
         "checkpoint": ckpt, "ir": ir, "observability": observability,
         "ladder_formats": ladder, "build": _build.build_info, "cases": cases,
         "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
