#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device — require CUDA; print the card's name and power limit.
2. build — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together); print the seconds.
3. kernels — each of the twenty-four kernels against its plain PyTorch
   version on the card. The four RandK-wire kernels at the
   production shape of Qwen1.5-0.5B (n = 4 workers, nblk = ceil(d / 1024),
   B = 1024, kb = 20), at PP-MARINA's cohort (n = r = 2) and at a
   forced-duplicates shape (kb = B/2); the PermK uplink at the production
   shape and at n = 2 and 8; the delta epilogue at (nblk, B); the five
   packed-QSGD kernels (s = 7) at every worker count a path gives them
   (n = 4 for the QSGD uplink, n = 1 for the compressed downlink); the
   three natural-compression kernels at n = 4 and n = 1 and on one small
   input of edge values (zeros, subnormals, exact powers of two and the
   floats just below them); the two trimmed epilogues at n = 4 (window
   [1, 3)), n = 2 ([0, 2)), n = 5 (the median [2, 3)) and n = 8 ([2, 6)),
   rows and x in f32 and bf16, and on one small input with a NaN row, ±inf,
   ties and ±0; x in f32 and bf16. Offsets, RandK / PermK values, QSGD
   levels, norms, nibble words, natural codes and scales bit-equal, the
   scatter-mean (``scatter_accum``) and the QSGD dequant-mean bit-equal (the
   latter also at n ∈ ``DEQUANT_MEAN_NS`` × B ∈ ``DEQUANT_MEAN_BLOCKS``, a
   zero norm and |l| = s), the other scatter / dequant / epilogue outputs
   within 1 ulp, the QSGD, natural and trimmed epilogues' g' and x'
   bit-equal (the sign of zero included). ``scatter_accum`` is timed at the
   wire phase's jittered offsets too, and it, the QSGD dequant-mean and the
   QSGD and natural epilogues (at every n and x dtype) are printed against
   1.3× their bound.
   The serving kernels: ``absmax_quant_rows`` / ``absmax_dequant_rows``
   bit-equal at decode's and prefill's row counts of the serve shape
   (W = 64), at R = 2^20 (W = 128) and on edge rows (a zero row, .5 ties,
   ±0, ±127·scale), rows f32 and bf16, and ``absmax_dequant_rows`` at every
   width of ``DEQUANT_WIDTHS`` (its shift path and its tail branch); the
   one-launch int8 page write of a layer's k and v
   (``absmax_quant_write_pages``) at a decode step's and a prefill chunk's
   tokens (``PAGE_WRITE_SHAPES``, idle and padded tokens on the null page),
   every row of pages ≥ 1 bit-equal to its plain version, and timed (host
   µs a call too; ``scripts/serve_kernels_ab.py`` times it against another
   checkout's write);
   ``paged_attn_decode`` at the serve
   shape (8 slots, H = KV = 16, hd = 64, 36 pages of 16), a GQA stress
   shape (64 slots, H = 64, KV = 8, hd = 128, 256 pages of 16, n_valid in
   [1, 4096]), Llama-4-Scout's decode shape (8 slots, H = 40, KV = 8,
   hd = 128, 36 pages of 16: H / KV = 5) and H = 56 at that shape (H / KV
   = 7, DeepSeek-Coder-33B's ratio), f32 and bf16, and at the cluster
   split's edges
   (``paged_edge_n_valid``), within |Δ| ≤ 1e-5·max|v| (f32) or one bf16 ulp
   of each output row's largest magnitude (bf16), with
   ``scaled_dot_product_attention`` on the pre-gathered dense cache printed
   beside it as a comparison. The flat-vector wire's five kernels at full
   width (nblk = ceil(d / 1024), B = 1024, kb = 20, s = 7), x f32 and bf16:
   ``randk_gather`` at jittered host offsets and ``randk_seeded`` under one
   seed (offsets and values bit-equal), ``block_sumsq`` (bit-equal, the
   blockwise norm's order), ``qsgd_quantize`` against the global norm and a
   ``jax.random.uniform`` dither (levels bit-equal) and ``qsgd_dequantize``
   (bit-equal), each on small edge inputs too (±0, ±inf, zero rows, a zero
   norm, |x| = norm, exact ties).
   The launch layer's per-leaf widths (``TRANSPORT_WIDTHS``;
   ``check_transport_widths``): ``scatter_accum`` and ``randk_gather`` at
   Qwen1.5-0.5B's MLP leaf (n = 4, 24,576 rows of L = 2816, kb = 22) and one
   layer of qwen3-32b's (5120 rows of L = 25,600, kb = 200) on offsets drawn
   as the transport draws them, bit-equal to their plain versions; the MLP
   leaf's times against their bounds (the kernel line's ``transport``),
   and there ``randk_gather`` (row 10) against the gather yardstick on the
   same 98,304 rows of 2816 f32 and kb 22 and the 32- / 64-byte sector
   floors of its offsets (``transport_gather_floor``; a redesign due above
   ``TRANSPORT_GATHER_RULE2``× the yardstick).
   The random-gather yardsticks (``kernels/yardstick.py``: no path's
   kernel, no port of a TPU kernel; ``check_gather_floors``): the gather
   yardstick at row 1's production shape and at the wire shape of rows
   10–11, the affine yardstick at row 12's, each against its plain version,
   timed back to back over ``yardstick.SWEEP`` (the fastest is its time,
   ``gather_floor_ms``) and printed as ``gather yardstick …`` beside the
   byte bound and the 32- and 64-byte sector floors of the offsets those
   kernels gather, with each kernel's back-to-back time over the
   yardstick's (``rule 2 …``: a redesign is due above 1.3×) and over its
   32-byte sector floor. The yardstick is a bare gather, not a lower bound:
   a kernel may beat it. The kernel lines of rows 1, 10 and 11 carry the L2
   fetch granularity their launches ran under, read back from the runtime
   (``fetch_granularity_bytes``; the port leaves the runtime's default),
   and rows 1 and 10 ``torch.gather`` at the kernel's own offsets as their
   library call (the gather alone, its int64 offsets converted beforehand:
   ``library_call``).
   For the kernel, its plain version and, where one exists, the one PyTorch
   call that computes the same function: the median single-call time (CUDA
   events around each of 25 calls; 5 for the plain version) and the
   back-to-back time (events around 25 calls in a row, ÷ 25); for the
   serving kernels also the device time from a ``torch.profiler`` trace
   (the kernels' own durations), and the ``absmax_dequant_rows`` wrapper's
   host microseconds, piece by piece (``dequant_host_us``).
4. small input — a reduced dense LM trained 4 steps on the card through the
   kernels and through their plain versions (``flat_backend="ref"``) on
   every main path below, and on MARINA over the ``randk_qsgd`` engine
   (RandK kernels around a plain K-sized QSGD stage) in both round shapes:
   the two trajectories agree. Then the paper's baselines on the same LM,
   4 steps each on the per-leaf tree path (no kernel): DIANA ×
   block_natural, DCGD × block_randk, EC-SGD × topk and GD, each with a
   finite loss and ``tree_payload_bits`` booked every round. Then the
   robust and fault dials through kernels and plain versions: MARINA ×
   block_qsgd recompute under trimmed_mean f = 1 and sign_flip (its carry
   shape is a main path), MARINA × block_natural carry under krum and under
   norm_clip, MARINA × block_randk carry with ``drop`` (the ledger books
   (n − f)/n of ζ); and ``DeadlineMarina`` on the tree path with one client
   always late, bit-identical to MARINA carry with that client dropped and
   its bits scaled by the arrivals. Then serving on a 2-layer reduced GQA
   LM (H = 4, KV = 2): prefix sharing with COW splits, and an undersized
   pool that preempts and swaps, f32 and int8 pages, each through the
   kernels and through their plain versions with identical token streams.
   Last, the per-leaf wires (``SMALL_LEAFWISE``): MARINA × shared_randk,
   × correlated_qsgd (n = 4) and × block_randk under a per-leaf QSGD
   downlink (s = 7), recompute rounds, kernels against plain versions, each
   ledger ``tree_payload_bits`` of its per-leaf compressor. The MARINA ×
   block_randk carry state, its params and carry cast to bf16, goes
   through a checkpoint and back into a state on the card, bit for bit.
   Then the attention and MoE families (``SMALL_FAMILIES``: reduced gemma3
   with five sliding-window layers and a global one, Llama-4-Scout with
   MoE, DeepSeek-V3 with MLA, MoE and the MTP head) through the trainer on
   MARINA × block_randk carry, 4 steps, through the kernels and through
   their plain versions: launches exact, trajectories agree; and so do the
   recurrent families (``SMALL_RECURRENT``: reduced recurrentgemma-2b with
   two RG-LRU layers and a sliding-window one, xlstm-350m's whole 7 mLSTM :
   1 sLSTM period).
5. main paths — Qwen1.5-0.5B at full width, random init from a seed, through
   the port's ``Trainer``: n_workers = 4, batch 8 × 256 tokens per worker,
   B = 1024, p = 0.5, ``MAIN_STEPS`` = 2 steps per path (c_k = 1, 0: one
   round of each type; cut from 4 to make room for phase 14), both
   round shapes
   (``carry_grads=False`` / ``True``) of MARINA × block_randk (kb = 20),
   VR-MARINA × permk (minibatches 2 × 256), PP-MARINA × block_randk
   (r = 2), MARINA × block_qsgd (s = 7) and MARINA × block_natural, and
   MARINA × block_randk under a QSGD downlink (s = 7) and under a natural
   downlink in the carry shape, and two robust carry paths: MARINA ×
   block_qsgd under trimmed_mean f = 1 with 1 of 4 clients sign-flipping
   ×10, and PP-MARINA × block_natural (r = 2) under coordinate_median with
   1 of 4 clients mean-shifting. The launch counts are reset
   just before each path and read just after it: each path must launch
   exactly the kernels its rounds require (``EXPECTED_LAUNCHES``). The
   loss is finite, no round is skipped, and each round's up and down bits
   equal the wire formulas. Median seconds per step by round type and the
   peak device memory, per path.
6. profile — one ``torch.profiler`` trace of a compressed step of a
   full-width carry run: its device time split into model forward +
   backward, the port's kernels and the rest, the device's idle share of
   the step, and the costliest device functions.
7. resume — ``RESUME_PATH`` (MARINA × block_randk, recompute rounds) on
   the same model at full width and depth, on Dirichlet(α = 0.1) token
   streams, through the port's ``Trainer`` three times: U, 4 steps
   uninterrupted; A, steps 0–1, checkpointing after step 1
   (``ckpt_00000001.npz``, ~3.7 GB: params and g, f32) into a
   ``tempfile.mkdtemp()`` directory that must have twice that free; B,
   ``steps = 4`` on the same directory, resuming at step 2. (The carry
   shape's 11.1 GB checkpoint made the phase 64.5 s on an H100, past its
   60 s budget: PERF.md.) B's final params, g and h are bit-equal to U's;
   B's c_k are steps 2–3 of ``EXPECTED_C_K``; its bits ledger starts from
   float32(A's) and adds the two rounds exactly; U, A and B launch their
   rounds' share of
   ``EXPECTED_LAUNCHES[RESUME_PATH]`` (counts reset just before each run,
   read just after). Save and load seconds, GB and free disk; the
   directory is removed.
8. wire — the flat-vector wire on the same model: n = 4 worker gradients
   from the trainer's step-0 batches (8 × 256 tokens each), packed into
   (4, nblk, 1024) f32; per worker ``ops.randk_compress`` (kb = 20), then
   ``ops.randk_decompress_mean`` over the 4 payloads; ``flat.block_compress``
   under ``flat.key_to_seed`` seeds, then ``flat.block_gather`` at its
   offsets; ``ops.qsgd_compress`` (s = 7), then ``ops.qsgd_decompress``,
   averaged. Launches exactly ``WIRE_LAUNCHES``; the seeded payloads equal
   ``randk_seeded_workers``' rows and ``flat.seeded_offsets``; the gather at
   those offsets returns them; |level| ≤ s; the decompressed RandK payload
   is x·B/kb where nonzero; the wire bits are ``wire.py``'s; the same run
   through the plain versions on the card gives identical outputs. Seconds
   per call and peak memory.
9. serve paths — ``repro_torch.launch.serve`` on the same model, greedy:
   16 requests (512:64, 128:16, 64:8, 256:32, four times), 8 slots, 16-token pages,
   128-token prefill chunks — ``serve_continuous`` (f32 pages),
   ``serve_continuous_q8`` (int8 pages) and ``serve_static`` (batches of 8,
   dense cache, no kernel). Launch counts are exact functions of the
   ``ServeReport`` (``serve_launches``: on int8 pages one page write a
   layer per prefill chunk and decode step). Each continuous path runs again
   through the plain versions: f32-page streams equal except where the
   plain run's top-2 logit margin at the diverging token is below 1e-3,
   int8-page streams identical. Tokens/s, first-token and completion p50 /
   p99, median decode-step ms, steps, chunks and peak memory per path.

10. families — the attention and MoE families at full width, f32 random
   init from the seed, each leg's parameters freed before the next, the
   depth cuts listed in the report's ``reduced``: Llama-4-Scout-17B-16E
   (4 of 48 layers, 10.88 B parameters) served continuously on
   ``SERVE_SPEC`` on f32 and int8 pages, each run again through the plain
   versions (streams compared as in phase 9), launches exact by
   ``serve_launches`` at 4 layers, and the (token, k) pairs the MoE capacity
   dropped; gemma3-27b (one period: five sliding-window layers and a global
   one, 3.89 B) through ``run_static`` at 4 × 1536:32, so every 1024-slot
   ring wraps; DeepSeek-V3 (a dense MLA + MLP layer, then MLA + MoE; no
   MTP head, 13.94 B) through ``run_static`` at 2 × 256:16. The static legs
   check 4 decode steps' logits against a teacher-forced ``forward``
   (within 1e-4 of each row's largest logit). Peak memory and seconds per
   leg; the phase must take at most 120 s.

11. recurrent — the recurrent families at full width and depth, f32 random
   init from the seed, each leg's parameters freed before the next:
   recurrentgemma-2b (26 layers, RG-LRU and sliding-window attention)
   through ``run_static`` at 4 × 2304:32 (every 2048-slot ring wraps) and
   xlstm-350m (24 layers, 7 mLSTM : 1 sLSTM) at 8 × 252:64 (prompt and
   teacher-forced steps one 256-position mLSTM chunk), each checking 4
   decode steps against a teacher-forced ``forward`` (within 1e-4 of each
   row's largest logit; xLSTM within 1e-3 in float32, and within 1e-4 with
   the same steps in float64: ``RECURRENT_F32_RTOL``), no kernel launched;
   the xLSTM decode state's bytes equal at max_len 256 and 4096;
   xlstm-350m trained on the MARINA × block_randk carry path (n = 4, 8 ×
   256 tokens per worker, ``MAIN_STEPS`` = 2 steps): launches exactly
   ``MAIN_LAUNCHES["marina_randk_carry"]``, c_k and the ledgers exact,
   the same steps through the plain versions within rtol 1e-5 / atol 1e-6.
   Then sampling at T = 0.7, seed 0, on phase 9's model and ``SERVE_SPEC``:
   the continuous path (f32 pages) twice with identical streams, its
   launches exact and its streams equal to the plain versions' except after
   a token whose perturbed top-2 margin in the plain run is below 1e-3
   (counted), and the static path; one step's Gumbel draw on the card
   against the host path (uniforms bit for bit). Seconds per leg and round
   type, peak memory; the phase must take at most 120 s.

12. launch — the launch layer's worker axis (``run_launch``, ≤ 120 s): a
   process group of world size 1 brought up through
   ``topology.init_from_env`` (``MARINA_MP_*`` set for one process: nccl on
   the card) and destroyed after the phase; a (4, 1) ("data", "model") mesh
   whose data axis hosts all four workers on the one rank (tier
   ``loopback``). ``ml``: Qwen1.5-0.5B at full width and depth (seed 0, f32,
   14 leaves) through ``launch.distributed.build_train_steps`` (randk,
   ``grad_carry``, 8 × 256 tokens a worker): one ``sync_step``, then
   ``LAUNCH_COMPRESSED`` = 2 ``compressed_step``s (cut from 3), then the
   same rounds with
   ``compression_backend="ref"``; params, g and h bit-equal between the
   two; a compressed round books 231,993,856 up-bits a worker (Σ R·kb·64
   over the leaves) and the dense broadcast down, a sync round 32·d up and
   down; ``randk_gather`` and ``scatter_accum`` launch once a leaf a
   compressed round (14 each) and nothing on the sync round. ``mp``: the
   flat-PP path (r = 2 of 4, cohort compute, no carry), one sync round and
   ``LAUNCH_PP_COMPRESSED`` = 1 compressed round (cut from 2) through the
   kernels and the plain versions,
   bit-equal; rows 1 and 2 once a compressed round; r·ζ_Q/n booked, and
   read off the wire: the cohort rows' payloads and seeds all-gathered,
   ×8 ÷ n, equal it (no dense state crosses). Each
   run starts with one untimed ``sync_step`` (the process's first backprop
   and the group's first collective), then the timed rounds. The bytes each
   round's collectives carried are read off the mesh: ×8 ÷ n, an ``ml``
   compressed round's all-gathers must equal its booked uplink and a sync
   round's all-reduce 32 bits a slot of the padded flat buffer. Seconds a
   round by type (host clock ending in a synchronize), the transport's
   seconds a call, peak memory and the collectives issued on the group.

13. mesh_serve — on the launch phase's group, before it is destroyed
   (``run_mesh_serve``, ≤ 120 s): Qwen1.5-0.5B at full width and depth,
   f32, seed 0, on a (1, 1) mesh. (a) ``SERVE_SPEC`` through
   ``launch.serve_steps.build_paged_serve_steps`` (8 slots, pages of 16,
   chunks of 128) driven by the engine (``serve_steps.engine_steps``), on
   f32 and int8 pages (``mesh_serve_f32`` / ``mesh_serve_q8`` in
   ``launches_by_path``): streams bit-equal to ``run_continuous``'s (phase
   9's streams, kept in its report; a phase-only run serves
   them here), launches ``serve_launches`` (rows 22–24), the exchanges' bytes every
   slot's written K/V rows and token a decode step; then the same bundle
   through the plain versions, which may diverge only at phase 9's listed
   near ties. The median decode step (host clock) against its floor,
   ``roofline.decode_bandwidth_bound_s`` of the f32 parameters
   (``param_math``, 4 B each) and the step's live KV pages at 3.35e12 B/s.
   (b) ``build_serve_steps``: a prefill of ``MESH_DENSE`` (8 × 512, last
   logits) and 8 decode steps, every logit row within 1e-4 of its largest
   from a teacher-forced ``forward``. (c) ``param_math``'s counts of the
   ten configs from meta shapes (three held to the reference's), and one
   ``ml`` compressed round's 6·N·D FLOPs at the f32 peak (67 TFLOP/s)
   against the launch phase's host-clock round and the device-busy time of
   one traced round. (d) ``roofline.analyze_step`` on one ``ml``
   compressed round: FLOPs, bytes, collective stats, peak memory, the
   dominant term.

14. mesh_model — the model axis across ranks (``run_mesh_model``, ≤ 120 s):
   two processes on the one card (``topology.spawn_local_cluster``, each
   running ``mesh_model_rank``), a gloo group asked for by name and staged
   through host memory (NCCL refuses two ranks on one device), a (4, 2)
   ("data", "model") mesh: one worker group of all four workers, each rank
   one model slice of every sharded leaf (``sharding.shard_tree``:
   231,994,368 of Qwen1.5-0.5B's 463,987,712 parameters, f32, seed 0, full
   width and depth). Rows 10 and 2 on the rank's columns of ``w_gate``'s
   wire and row 24 at the rank's 8 / 8 heads against their plain versions;
   then one sync round and one compressed randk round with the carry
   (``MESH_MODEL_BATCH`` × ``MESH_MODEL_SEQ`` tokens a worker, no remat)
   through the kernels and through the plain versions (bit-equal), against
   the same rounds on one rank holding the whole model: c_k and the ledgers
   equal, params and g within ``MESH_MODEL_RTOL`` of each leaf's scale, the
   wire's bytes over both ranks ×8 ÷ n equal to the booked uplink every
   round, 27 launches each of rows 10 and 2 a compressed round; then
   ``SERVE_SPEC`` through ``build_paged_serve_steps`` on f32 pages (each
   pool holds 8 of the 16 KV heads; chunks of ``MESH_MODEL_CHUNK``, one a
   prompt): the streams equal one rank's up to the near-tie margins
   (``plain_streams`` on rank 1 while rank 0 runs the one-rank rounds), row
   24 launched 24 times a decode step on each rank. Prints each rank's parameter bytes and peak memory,
   the bytes a round by kind (``model/...`` apart from the wire's), seconds
   a round and the median decode-step ms, both on host-staged gloo, not
   NVLink.

15. mesh_fsdp — the fsdp inner axis (``run_mesh_fsdp``, ≤ 120 s): four
   processes on the one card over host-staged gloo, a (pod 2, data 2,
   model 1) mesh laid out for fsdp (``topology.make_mesh(..., fsdp=True)``:
   each pod a worker of two data ranks), Qwen1.5-0.5B at full width and
   depth, f32, under the fsdp override (``worker_axes="pod"``,
   ``fsdp=True``): 231,994,368 parameters a rank (every leaf halved by the
   data axis but final_norm). One sync round and one compressed randk
   round with the carry, one row of ``MESH_FSDP_SEQ`` tokens a data rank,
   no remat, against the same rounds on one rank (rank 0): params and g
   within ``MESH_MODEL_RTOL`` of each leaf's scale, the ledgers equal, the
   wire's bytes over the four ranks ×8 ÷ n equal to the booked uplink,
   rows 10 and 2 launched on each rank's share (2·(2·leaves − 1) each);
   then ``MESH_FSDP_SERVE`` (2 requests, 8 new tokens each) through the
   paged bundle on f32 pages and 4 slots, one a rank (split over the pods
   and the data ranks, the slots' tokens and K/V rows crossing the data
   group), every F leaf gathered on use: the streams equal one rank's up
   to near-tie margins, row 24 launched. Prints each
   rank's peak memory and the ``fsdp/...`` collectives a worker pass.

16. dryrun — ``launch/dryrun.py`` and ``launch/perf.py`` on the card
   (``run_dryrun``, ≤ 120 s), one device's share of the production program
   on the stand-in mesh: qwen1.5-0.5b × train_4k × single (beside it the
   reference's recorded XLA estimate, printed, not compared; its sync and
   compressed steps), llama4-scout-17b-a16e × train_4k × multi (the fsdp
   layout, 421,211,568 parameters a device; its sync step: the compressed
   one, ~70 s on the card, is the CLI's record) and perf.py's
   qwen1.5-0.5b × decode_32k × single × paged_decode; each step's peak
   memory a device and roofline terms, its counted memory
   (``roofline.memory.MemoryCounter``: peak, temp, argument, output, the
   operator at the peak) beside the allocator's peak less what it held at
   entry beyond the step's arguments, the gap (allocator − counted)
   required within [−1, 128] MiB, and its collectives by op (count and
   priced bytes) beside those of the all-gather sums
   (``DRYRUN_ALL_GATHER_SUMS``); every train step's model-axis sums (m =
   16) through the rank-ordered reduce-scatter + all-gather; rows 10 and 2
   launched by qwen's compressed step, row 24 by the paged decode.

The output ends with a JSON report of every phase, the kernel table (one
JSON line; ``launches`` sums the paths, ``launches_by_path`` splits them),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: where every phase runs; ``main`` requires a CUDA device. With "cpu" each
#: kernel wrapper returns its plain version: tests/test_torch_chip_smoke.py
#: rehearses the main paths that way at a tiny size.
DEVICE = "cuda"
SEED = 0
P_SYNC = 0.5
STEPS = 4
#: c_k of steps 0..3 for seed 0, p = 0.5: jax.random.bernoulli on the first
#: key of split(fold_in(PRNGKey(0), step)) — and of its 3-way split, which
#: PP-MARINA draws from — computed with JAX on the CPU
EXPECTED_C_K = [1, 0, 1, 0]
KB, BLOCK, N_WORKERS, S_LEVELS = 20, 1024, 4, 7
MB_PER_WORKER, R_PARTICIPATING = 2, 2
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16, dense tensor cores
RANDK_SEEDS = [1, 2**31 + 7, 2**32 - 1, 12345]  # the RandK kernels' worker seeds
PERMK_SEED = 2**31 + 12345                      # the PermK kernel's shared seed
PERMK_SUBSET = [3, 1]  # the rows a rank holds of PermK's fleet of 4 (row 12's workers mode)

SOURCES = {
    "randk_seeded_workers": ("src/repro_torch/kernels/csrc/randk.cu",
                             "src/repro/kernels/randk.py:209"),
    "scatter_accum": ("src/repro_torch/kernels/csrc/randk.cu",
                      "src/repro/kernels/randk.py:93"),
    "scatter_epilogue": ("src/repro_torch/kernels/csrc/epilogue.cu",
                         "src/repro/kernels/epilogue.py:287"),
    "mean_epilogue": ("src/repro_torch/kernels/csrc/epilogue.cu",
                      "src/repro/kernels/epilogue.py:109"),
    "permk_seeded_workers": ("src/repro_torch/kernels/csrc/permk.cu",
                             "src/repro/kernels/permk.py:62"),
    "delta_epilogue": ("src/repro_torch/kernels/csrc/epilogue.cu",
                       "src/repro/kernels/epilogue.py:69"),
    "qsgd_block_workers": ("src/repro_torch/kernels/csrc/quantize.cu",
                           "src/repro/kernels/quantize.py:162"),
    "nibble_pack": ("src/repro_torch/kernels/csrc/quantize.cu",
                    "src/repro/kernels/quantize.py:339"),
    "nibble_unpack": ("src/repro_torch/kernels/csrc/quantize.cu",
                      "src/repro/kernels/quantize.py:369"),
    "qsgd_dequant_mean": ("src/repro_torch/kernels/csrc/quantize.cu",
                          "src/repro/kernels/quantize.py:206"),
    "qsgd_epilogue": ("src/repro_torch/kernels/csrc/epilogue.cu",
                      "src/repro/kernels/epilogue.py:335"),
    "natural_block_workers": ("src/repro_torch/kernels/csrc/quantize.cu",
                              "src/repro/kernels/quantize.py:258"),
    "natural_dequant_mean": ("src/repro_torch/kernels/csrc/quantize.cu",
                             "src/repro/kernels/quantize.py:302"),
    "natural_epilogue": ("src/repro_torch/kernels/csrc/epilogue.cu",
                         "src/repro/kernels/epilogue.py:387"),
    "trimmed_delta_epilogue": ("src/repro_torch/kernels/csrc/epilogue.cu",
                               "src/repro/kernels/epilogue.py:185"),
    "trimmed_sync_epilogue": ("src/repro_torch/kernels/csrc/epilogue.cu",
                              "src/repro/kernels/epilogue.py:227"),
    "absmax_quant_rows": ("src/repro_torch/kernels/csrc/quantize.cu",
                          "src/repro/kernels/quantize.py:403"),
    "absmax_dequant_rows": ("src/repro_torch/kernels/csrc/quantize.cu",
                            "src/repro/kernels/quantize.py:434"),
    "paged_attn_decode": ("src/repro_torch/kernels/csrc/paged.cu",
                          "src/repro/kernels/paged.py:76"),
    "randk_gather": ("src/repro_torch/kernels/csrc/randk.cu",
                     "src/repro/kernels/randk.py:48"),
    "randk_seeded": ("src/repro_torch/kernels/csrc/randk.cu",
                     "src/repro/kernels/randk.py:152"),
    "block_sumsq": ("src/repro_torch/kernels/csrc/quantize.cu",
                    "src/repro/kernels/quantize.py:66"),
    "qsgd_quantize": ("src/repro_torch/kernels/csrc/quantize.cu",
                      "src/repro/kernels/quantize.py:90"),
    "qsgd_dequantize": ("src/repro_torch/kernels/csrc/quantize.cu",
                        "src/repro/kernels/quantize.py:118"),
}

#: the main paths: (method, compressor, carry_grads, downlink sampler)
PATHS = {
    "marina_randk_recompute": ("marina", "block_randk", False, None),
    "marina_randk_carry": ("marina", "block_randk", True, None),
    "vr_permk_recompute": ("vr_marina", "permk", False, None),
    "vr_permk_carry": ("vr_marina", "permk", True, None),
    "pp_randk_recompute": ("pp_marina", "block_randk", False, None),
    "pp_randk_carry": ("pp_marina", "block_randk", True, None),
    "marina_qsgd_recompute": ("marina", "block_qsgd", False, None),
    "marina_qsgd_carry": ("marina", "block_qsgd", True, None),
    "marina_randk_downqsgd_carry": ("marina", "block_randk", True, "qsgd"),
    "marina_natural_recompute": ("marina", "block_natural", False, None),
    "marina_natural_carry": ("marina", "block_natural", True, None),
    "marina_randk_downnatural_carry": ("marina", "block_randk", True, "natural"),
    "marina_qsgd_trimmed_carry": ("marina", "block_qsgd", True, None),
    "pp_natural_median_carry": ("pp_marina", "block_natural", True, None),
}
#: the robust paths' aggregator and fault dials (TrainConfig fields)
ROBUST = {
    "marina_qsgd_trimmed_carry": dict(aggregator="trimmed_mean", aggregator_f=1,
                                      faults="sign_flip", faults_frac=0.25,
                                      faults_scale=10.0),
    "pp_natural_median_carry": dict(aggregator="coordinate_median", faults="mean_shift",
                                    faults_frac=0.25, faults_scale=1.0),
}
COMP_KWARGS = {"block_randk": {"kb": KB, "block": BLOCK}, "permk": {"block": BLOCK},
               "block_qsgd": {"s": S_LEVELS, "block": BLOCK},
               "block_natural": {"block": BLOCK}, "topk": {"k": 0.01}, "identity": {},
               "shared_randk": {"k": 0.05}, "correlated_qsgd": {"s": S_LEVELS}}
#: the paper's baselines on the small input: (method, compressor)
BASELINES = (("diana", "block_natural"), ("dcgd", "block_randk"), ("ec_sgd", "topk"),
             ("gd", "identity"))
_NC, _NS = EXPECTED_C_K.count(0), EXPECTED_C_K.count(1)
_QSGD_WIRE = {"qsgd_block_workers": _NC, "nibble_pack": _NC, "nibble_unpack": _NC}
#: what each path must launch in its 4 steps: compressed recompute rounds
#: sample and aggregate the diffs (RandK: scatter-mean kernel; PermK: a plain
#: inverse-permutation gather; QSGD: quantize, the 4-bit words there and
#: back, dequant-mean; natural: quantize, decode-and-mean); carry rounds end
#: in a fused epilogue of either round type (the sync one is the mean
#: epilogue). Under a downlink, a carry compressed round aggregates the
#: uplink (scatter-mean), then quantizes the broadcast (n = 1) and ends in
#: its epilogue.
EXPECTED_LAUNCHES = {
    "marina_randk_recompute": {"randk_seeded_workers": _NC, "scatter_accum": _NC},
    "marina_randk_carry": {"randk_seeded_workers": _NC, "scatter_epilogue": _NC,
                           "mean_epilogue": _NS},
    "vr_permk_recompute": {"permk_seeded_workers": _NC},
    "vr_permk_carry": {"permk_seeded_workers": _NC, "delta_epilogue": _NC,
                       "mean_epilogue": _NS},
    "pp_randk_recompute": {"randk_seeded_workers": _NC, "scatter_accum": _NC},
    "pp_randk_carry": {"randk_seeded_workers": _NC, "scatter_epilogue": _NC,
                       "mean_epilogue": _NS},
    "marina_qsgd_recompute": {**_QSGD_WIRE, "qsgd_dequant_mean": _NC},
    "marina_qsgd_carry": {**_QSGD_WIRE, "qsgd_epilogue": _NC, "mean_epilogue": _NS},
    "marina_randk_downqsgd_carry": {"randk_seeded_workers": _NC, "scatter_accum": _NC,
                                    **_QSGD_WIRE, "qsgd_epilogue": _NC,
                                    "mean_epilogue": _NS},
    "marina_natural_recompute": {"natural_block_workers": _NC,
                                 "natural_dequant_mean": _NC},
    "marina_natural_carry": {"natural_block_workers": _NC, "natural_epilogue": _NC,
                             "mean_epilogue": _NS},
    "marina_randk_downnatural_carry": {"randk_seeded_workers": _NC,
                                       "scatter_accum": _NC,
                                       "natural_block_workers": _NC,
                                       "natural_epilogue": _NC, "mean_epilogue": _NS},
    # robust carry rounds decode every worker's payload (the uplink kernels)
    # and end in a trimmed epilogue of either round type
    "marina_qsgd_trimmed_carry": {**_QSGD_WIRE, "trimmed_delta_epilogue": _NC,
                                  "trimmed_sync_epilogue": _NS},
    "pp_natural_median_carry": {"natural_block_workers": _NC,
                                "trimmed_delta_epilogue": _NC,
                                "trimmed_sync_epilogue": _NS},
}
#: the main paths' steps, and the xLSTM training leg's: c_k = 1, 0, one round
#: of each type (four until the mesh_model phase needed their time), so each
#: path launches one of each EXPECTED_LAUNCHES entry where EXPECTED_C_K's four
#: rounds launch two
MAIN_STEPS = 2
MAIN_C_K = EXPECTED_C_K[:MAIN_STEPS]
assert _NC == _NS == 2 and MAIN_C_K.count(0) == MAIN_C_K.count(1) == 1
MAIN_LAUNCHES = {path: {k: v // 2 for k, v in counts.items()}
                 for path, counts in EXPECTED_LAUNCHES.items()}
#: the resume phase: the main path it runs, the Dirichlet α of its token
#: streams, and the steps of its first leg (A saves after step
#: RESUME_SPLIT − 1; B resumes at RESUME_SPLIT)
RESUME_PATH = "marina_randk_recompute"
RESUME_ALPHA = 0.1
RESUME_SPLIT = 2
#: what a path the resume phase can run launches in one round, by c_k
#: (summed over EXPECTED_C_K: EXPECTED_LAUNCHES[path]); the carry shape is
#: scripts/resume_carry.py's
ROUND_LAUNCHES = {
    "marina_randk_recompute": {0: {"randk_seeded_workers": 1, "scatter_accum": 1}, 1: {}},
    "marina_randk_carry": {0: {"randk_seeded_workers": 1, "scatter_epilogue": 1},
                           1: {"mean_epilogue": 1}},
}
#: the small-input robust and fault runs: (trainer dials, launches). Recompute
#: rounds aggregate robustly in plain PyTorch, as the reference does; Krum and
#: norm-clip end both round types in the delta epilogue; a drop run is the
#: mean's RandK carry path
SMALL_ROBUST = {
    "marina_qsgd_trimmed_recompute": (
        dict(carry=False, method="marina", compressor="block_qsgd",
             **ROBUST["marina_qsgd_trimmed_carry"]), _QSGD_WIRE),
    "marina_natural_krum_carry": (
        dict(carry=True, method="marina", compressor="block_natural", aggregator="krum",
             aggregator_f=1), {"natural_block_workers": _NC, "delta_epilogue": _NC + _NS}),
    "marina_natural_normclip_carry": (
        dict(carry=True, method="marina", compressor="block_natural",
             aggregator="norm_clip"),
        {"natural_block_workers": _NC, "delta_epilogue": _NC + _NS}),
    "marina_randk_drop_carry": (
        dict(carry=True, method="marina", compressor="block_randk", faults="drop",
             faults_frac=0.25),
        {"randk_seeded_workers": _NC, "scatter_epilogue": _NC, "mean_epilogue": _NS}),
}

#: the serve paths: Qwen1.5-0.5B at full width and depth, f32 params from
#: ``init_params(SEED)``, greedy; 16 requests (four of each prompt:gen pair),
#: 8 slots, 16-token pages, 128-token prefill chunks, static batches of 8
SERVE_SPEC = ",".join(["512:64,128:16,64:8,256:32"] * 4)
SERVE_SLOTS, SERVE_PAGE, SERVE_CHUNK, SERVE_BATCH = 8, 16, 128, 8
#: path → int8 pages (None: the static dense-cache baseline)
SERVE_PATHS = {"serve_continuous": False, "serve_continuous_q8": True, "serve_static": None}
#: a divergence between the kernel and plain f32-page streams is accepted only
#: where the plain run's top-2 logit margin was below this
SERVE_TIE_MARGIN = 1e-3
#: paged_attn_decode shapes: (S, H, KV, hd, P, max_pages); the serve shape
#: (Qwen1.5-0.5B, 8 slots, 36 pages of 16), a GQA stress shape (Qwen3-32B's
#: attention, 64 slots of up to 4096 positions), Llama-4-Scout's decode shape
#: of the families phase (H / KV = 40 / 8 = 5) and DeepSeek-Coder-33B's ratio
#: (56 / 8 = 7) at that shape
PAGED_SHAPES = {"serve": (SERVE_SLOTS, 16, 16, 64, SERVE_PAGE, 36),
                "gqa_stress": (64, 64, 8, 128, 16, 256),
                "llama4_scout": (SERVE_SLOTS, 40, 8, 128, SERVE_PAGE, 36),
                "rep7": (SERVE_SLOTS, 56, 8, 128, SERVE_PAGE, 36)}
#: absmax row shapes (R, W): decode's R = S·KV and prefill's R = chunk·KV at
#: the serve width, and R = 2^20 at W = 128
#: absmax_dequant_rows widths checked bit for bit: every power of two of the
#: shift path (the serve path gives it 64, 128), and the tail branch's
#: multiples of 4 that are not powers of two or are below 16
DEQUANT_WIDTHS = (16, 32, 64, 128, 256, 4, 8, 36, 100)
ABSMAX_SHAPES = {"serve_decode": (SERVE_SLOTS * 16, 64),
                 "serve_prefill": (SERVE_CHUNK * 16, 64), "large": (1 << 20, 128)}
#: the int8 page write of one layer, k and v (T tokens, n_real of them at
#: distinct rows of pages ≥ 1, the rest on the null page; KV, W): a decode
#: step over 8 slots with 2 idle, and a 128-token prefill chunk with 28
#: padded tokens, at the serve width, into the serve path's pool
PAGE_WRITE_SHAPES = {"serve_decode": (SERVE_SLOTS, SERVE_SLOTS - 2, 16, 64),
                     "serve_prefill": (SERVE_CHUNK, SERVE_CHUNK - 28, 16, 64)}
PAGE_WRITE_POOL = (1 + SERVE_SLOTS * PAGED_SHAPES["serve"][5], SERVE_PAGE)  # (npage, P)
#: small-input serve runs: (prompt:gen pairs with shared stems, engine dials)
SERVE_SMALL = {
    "share_prefix": ("42:8,20:4,46:6,42:5", dict(slots=2, share_prefix=True)),
    "preempt": ("24:12,9:14,30:10,12:16", dict(slots=3, npage=12)),
}


#: the small-input families: reduced (d_model 64) gemma3 (five local layers
#: and a global one), llama4-scout (MoE) and deepseek-v3 (three MLA + MLP
#: layers, then MLA + MoE, and the MTP head) through the trainer on the
#: MARINA × block_randk carry path: arch → layers
SMALL_FAMILIES = {"gemma3-27b": 6, "llama4-scout-17b-a16e": 2, "deepseek-v3-671b": 4}
#: the families phase, at full width: arch → the repeats kept of each
#: segment (the depth cut; later segments dropped). Llama-4-Scout serves
#: through the paged engine on SERVE_SPEC (f32 and int8 pages); gemma3 (one
#: period: five sliding-window layers and a global one) and DeepSeek-V3 (a
#: dense MLA + MLP layer, then MLA + MoE; no MTP head, which does not serve)
#: through the static dense / ring / latent caches
FAMILY_REPEATS = {"llama4-scout-17b-a16e": (4,), "gemma3-27b": (1,),
                  "deepseek-v3-671b": (1, 1)}
FAMILY_SERVE_PATHS = {"llama4_serve_continuous": False, "llama4_serve_continuous_q8": True}
#: static legs: (requests, batch); 1536-token prompts wrap gemma3's
#: 1024-slot rings
FAMILY_STATIC = {"gemma3-27b": (",".join(["1536:32"] * 4), 4),
                 "deepseek-v3-671b": (",".join(["256:16"] * 2), 2)}
#: decode steps held against a teacher-forced forward, and the bound:
#: |Δ| ≤ FAMILY_LOGIT_RTOL · max |forward logit| of the row; the forward runs
#: on as many requests at once as keep its logits within TEACHER_LOGIT_BYTES
FAMILY_TEACHER_STEPS, FAMILY_LOGIT_RTOL = 4, 1e-4
TEACHER_LOGIT_BYTES = 4e9
#: the MoE decode step's time split: cached positions per slot
FAMILY_PROFILE_LEN = 512
FAMILY_BUDGET_S = 120.0

#: the recurrent phase, at full width and depth (f32 random init from SEED).
#: Static legs (requests, batch): recurrentgemma-2b's 2304-token prompts run
#: past its 2048-position window, so every local-attention ring wraps;
#: xlstm-350m's 252 prompt positions and FAMILY_TEACHER_STEPS teacher-forced
#: steps make one 256-position mLSTM chunk (its forward takes S ≤ 256 or a
#: multiple of 256)
RECURRENT_STATIC = {"recurrentgemma-2b": (",".join(["2304:32"] * 4), 4),
                    "xlstm-350m": (",".join(["252:64"] * 8), 8)}
#: the recurrent legs cut in depth only, at full width (arch → layers): the
#: longest leg, xlstm-350m (55.4 s of the phase's 101.3 s on a slow host),
#: keeps one whole 7 mLSTM : 1 sLSTM period of its three
RECURRENT_DEPTH = {"xlstm-350m": 8}
#: the float32 teacher-forced bound where FAMILY_LOGIT_RTOL is out of float32's
#: reach, and the check then repeated in float64 at FAMILY_LOGIT_RTOL. xLSTM:
#: the chunkwise forward's cumulative log-forget sums (|F| ≈ 177 over 256
#: steps of log σ(0)) lose ~|F|·2^-24 in each exponent, through 24 layers:
#: 1.1e-4 to 3.8e-4 measured on the card, both packages 5.6e-5 to 8.3e-5 at 24
#: reduced layers on the CPU (scripts/xlstm_precision.py); float64 closes the
#: gap to 3e-13 (ROADMAP C)
RECURRENT_F32_RTOL = {"xlstm-350m": 1e-3}
#: the xLSTM decode state's bytes must not depend on max_len
RECURRENT_STATE_LENS = (256, 4096)
#: the training leg: xlstm-350m through the trainer on the MARINA ×
#: block_randk carry path (launches: EXPECTED_LAUNCHES["marina_randk_carry"];
#: ``xc`` in PERF.md's kernel table)
RECURRENT_TRAIN_ARCH = "xlstm-350m"
RECURRENT_TRAIN_PATH = "xlstm_marina_randk_carry"
#: the reduced recurrent families through the trainer in the small-input
#: phase (arch → layers): the whole 7 mLSTM : 1 sLSTM period, and (RG-LRU,
#: RG-LRU, local attention)
SMALL_RECURRENT = {"recurrentgemma-2b": 3, "xlstm-350m": 8}
#: sampling at a temperature: SERVE_SPEC on the Qwen1.5-0.5B serve paths
#: (path → int8 pages, None: static) under one seed; the continuous path
#: (the kernels) runs twice, its streams identical
SAMPLE_TEMPERATURE, SAMPLE_SEED = 0.7, 0
SAMPLE_PATHS = {"sampled_serve_continuous": False, "sampled_serve_static": None}
#: the device's Gumbel draws against the host path's: units of ulp(max(|g|, 1))
GUMBEL_ULPS = 2
RECURRENT_BUDGET_S = 120.0

#: the launch phase (ROADMAP A3, the launch layer's worker axis): one process,
#: an nccl group of world size 1 brought up through ``topology.init_from_env``,
#: a (LAUNCH_N, 1) ("data", "model") mesh whose data axis hosts every worker
#: on the one rank. ``ml``: Qwen1.5-0.5B at full width and depth through
#: ``build_train_steps`` (randk, grad_carry, LAUNCH_BATCH × LAUNCH_SEQ tokens
#: a worker), one sync round then LAUNCH_COMPRESSED compressed rounds, again
#: with ``compression_backend="ref"``; ``mp``: the flat-PP path (cohort
#: LAUNCH_PP, no carry), one sync round then LAUNCH_PP_COMPRESSED compressed
#: rounds, again through the plain versions
LAUNCH_N, LAUNCH_BATCH, LAUNCH_SEQ = 4, 8, 256
LAUNCH_COMPRESSED, LAUNCH_PP, LAUNCH_PP_COMPRESSED = 2, (2, "without"), 1
LAUNCH_BUDGET_S = 120.0
#: Qwen1.5-0.5B's d and the ml path's compressed uplink per worker: Σ over its
#: 14 leaves of R·kb·64 bits (kb = max(1, L // 128) f32 values and int32
#: offsets a row)
QWEN_D, ML_UP_BITS = 463_987_712, 231_993_856
#: the transport's per-leaf widths for scatter_accum (row 2) and randk_gather
#: (row 10), (n, R, L, kb): Qwen1.5-0.5B's MLP leaf (w_gate, 24 layers × 1024
#: rows of 2816; timed) and one layer of qwen3-32b's (5120 rows of 25,600)
TRANSPORT_WIDTHS = {"qwen_mlp": (LAUNCH_N, 24 * 1024, 2816, 22),
                    "qwen3_mlp_layer": (LAUNCH_N, 5120, 25600, 200)}

#: the mesh_serve phase (after the launch phase's paths, on its one-rank
#: group): Qwen1.5-0.5B at full width and depth, f32. SERVE_SPEC through
#: ``serve_steps.build_paged_serve_steps`` on f32 and int8 pages (kernels,
#: then the plain versions); a dense prefill of MESH_DENSE[0] ×
#: MESH_DENSE[1] tokens (last logits) and MESH_DENSE[2] decode steps through
#: ``build_serve_steps``; ``param_math``'s counts of the ten configs; one
#: ``ml`` compressed round's FLOP share of the f32 peak and its roofline
MESH_SERVE_PATHS = {"mesh_serve_f32": False, "mesh_serve_q8": True}
MESH_DENSE = (8, 512, 8)
MESH_SERVE_BUDGET_S = 120.0
#: the mesh_model phase: two processes on the one card, a gloo group staged
#: through host memory (NCCL refuses two ranks on one device), a
#: (MESH_MODEL_N, 2) ("data", "model") mesh: one worker group of every worker,
#: each rank one model slice of every sharded leaf. Qwen1.5-0.5B at full
#: width, cut to MESH_MODEL_DEPTH of its 24 layers (MESH_MODEL_LAYERS: a CPU
#: rehearsal's reduced width and depth instead), randk + grad_carry,
#: MESH_MODEL_BATCH × MESH_MODEL_SEQ tokens a worker: one sync round, then a
#: train_step under each of MESH_MODEL_KEYS (c_k = 0 for p = MESH_MODEL_P),
#: through the kernels and the plain versions, against one rank; then
#: SERVE_SPEC through the paged bundle on f32 pages (row 24 at
#: MESH_MODEL_PAGED: H / KV = 8 / 8 a rank)
MESH_MODEL_ENV = "CHIP_SMOKE_MESH_MODEL"
MESH_MODEL_ARCH, MESH_MODEL_LAYERS = "qwen1.5-0.5b", None
#: the depth cut at full width: the phase took 100.0 s of its 120 at 24
#: layers on a slow host, and its time goes with the layers' staged sums
MESH_MODEL_DEPTH = 12
MESH_MODEL_N, MESH_MODEL_BATCH, MESH_MODEL_SEQ = 4, 1, 256
#: one compressed round: the script's time
MESH_MODEL_KEYS, MESH_MODEL_P = (SEED + 44,), 1.0 / 128
MESH_MODEL_PAGED = (8, 8, 8, 64, 16, 36)
#: the phase's prefill chunk: a whole prompt of SERVE_SPEC (its longest is
#: 512), so each request's prefill stages one set of model-axis sums
MESH_MODEL_CHUNK = 512
MESH_MODEL_BUDGET_S = 120.0
#: the rounds' params and g against one rank's, of each leaf's scale: the
#: autograd rule (1e-5 of a gradient: the row- and vocabulary-parallel sums
#: add in another order) amplified by a compressed round's L/kb = 128, which
#: scales the uplinked Δ = ∇f(x) − h, whose entries cancel to a fraction of g
#: (ROADMAP C); the LM rule (1e-4) holds on the CPU ranks, not here
MESH_MODEL_RTOL = 128 * 1e-5
#: the mesh_fsdp phase: four processes on the one card over host-staged
#: gloo, a (pod 2, data 2, model 1) mesh laid out for fsdp (each pod a
#: worker of two data ranks, every F leaf split between them): Qwen1.5-0.5B
#: at full width cut to MESH_FSDP_DEPTH layers, f32, under the fsdp override (``worker_axes
#: "pod"``, ``fsdp=True``, as the reference's ``workers_pod_data`` variant
#: replaces its arch): a sync round and one compressed randk round with the
#: carry, MESH_FSDP_SEQ tokens on each data rank's row, no remat, against
#: one rank; then MESH_FSDP_SERVE through the paged bundle on f32 pages
MESH_FSDP_ENV = "CHIP_SMOKE_MESH_FSDP"
MESH_FSDP_LAYERS = None     # a CPU rehearsal's reduced width and depth
#: the depth cut at full width (101.9 s of 120 at 24 layers on a slow host)
MESH_FSDP_DEPTH = 12
MESH_FSDP_SEQ, MESH_FSDP_KEY = 256, SEED + 46
#: (8 new tokens, not 16: every decode step gathers each layer's data split
#: through the host, ~3 s a step on a slow host, and the phase has 120 s)
MESH_FSDP_SERVE = "64:8,32:8"
MESH_FSDP_BUDGET_S = 120.0
#: the dry-run phase's card entries (``launch/dryrun.py`` on the stand-in
#: mesh, ``launch/perf.py``'s paged decode) and their budget
DRYRUN_BUDGET_S = 120.0
#: the reference's recorded XLA estimate for qwen1.5-0.5b × train_4k ×
#: single, GB a device (argument + output + temp − alias of its
#: ``memory_analysis``, ``experiments/dryrun/``): a compiler's estimate for
#: the TPU program, printed beside the port's measured peak, not compared
DRYRUN_REF_FILE = os.path.join(ROOT, "experiments", "dryrun",
                               "qwen1.5-0.5b__train_4k__single.json")
#: what the phase's report keeps of a step's counted memory
#: (``roofline.memory.MemoryCounter``) and its comparison with the allocator
DRYRUN_MEMORY_KEYS = ("memory_analysis", "peak_memory_op", "allocated_at_entry",
                      "memory_vs_allocator")
#: the dry-run phase's steps as the card recorded them while the model- and
#: data-axis sums all-gathered the partials (``experiments/dryrun_torch/card/``
#: then): peak bytes a device and ``{op: (collectives, priced bytes)}``,
#: printed beside this run's figures
DRYRUN_ALL_GATHER_SUMS = {
    "qwen1.5-0.5b__train_4k__single": {
        "sync_step": (13_930_090_496, {"model/all-gather": (221, 245_630_420_160),
                                       "all-reduce": (14, 1_740_011_520),
                                       "model/broadcast": (1, 2_048)}),
        "compressed_step": (14_021_760_000, {"model/all-gather": (442, 491_260_840_320),
                                             "model/broadcast": (1, 2_048),
                                             "all-gather": (8, 10_985_040),
                                             "broadcast": (20, 627_336)})},
    "llama4-scout-17b-a16e__train_4k__multi": {
        "sync_step": (77_063_222_784, {"fsdp/all-gather": (387, 25_032_222_720),
                                       "model/all-gather": (1013, 1_229_358_288_480),
                                       "fsdp/all-to-all": (50, 12_637_079_040),
                                       "all-reduce": (18, 1_684_846_272),
                                       "fsdp/broadcast": (1, 10_240),
                                       "model/broadcast": (2, 501_760)})}}
#: Llama-4-Scout's bf16 parameters a device of the (2, 16, 16) mesh with the
#: fsdp split (``sharding.shard_tree``)
LLAMA4_FSDP_DEVICE_PARAMS = 421_211_568
#: the reference's parameter counts (params, active) of three configs
PARAM_COUNTS = {"deepseek-v3-671b": (682_636_457_984, 38_240_368_640),
                "llama4-scout-17b-a16e": (107_769_873_408, 17_172_907_008),
                "qwen1.5-0.5b": (463_987_712, 463_987_712)}
#: the gather yardstick's time at the transport's row-10 shape over the
#: kernel's back-to-back time above which the gather is due a redesign
TRANSPORT_GATHER_RULE2 = 2.0


#: keys a kernel's row adds to the kernel line where it has them, each
#: measured in the run: profiler device ms, the times at every (n, x dtype)
#: of qsgd_epilogue and qsgd_dequant_mean, the page write's host µs per call,
#: the gather yardstick's time at a gather's shape (check_gather_floors),
#: row 12's times in the main path's modes (offsets=False, a rank's workers)
TABLE_EXTRA = ("device_ms", "at_n", "host_us", "wire", "gather_floor_ms", "transport",
               "fetch_granularity_bytes", "library_call", "modes")


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ulp_diff(a, b) -> int:
    """Largest ulp distance between two f32 / bf16 tensors (bit patterns)."""
    import torch

    if a.dtype == torch.float32:
        ia, ib, top = a.view(torch.int32), b.view(torch.int32), 2**31
    else:
        ia, ib, top = a.view(torch.int16), b.view(torch.int16), 2**15
    ia, ib = ia.long(), ib.long()
    ka = torch.where(ia < 0, -top - ia, ia)
    kb = torch.where(ib < 0, -top - ib, ib)
    return int((ka - kb).abs().max()) if ka.numel() else 0


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` single-call times, each between two CUDA events:
    what one call costs a caller that waits for it, the wrapper's host work
    included where it outlasts the device's."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, n: int = 25) -> float:
    """CUDA events around ``n`` calls in a row after a warm-up call, ÷ n: the
    device time per call where the host keeps ahead of the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int = 25):
    """Device time per call from a ``torch.profiler`` trace of ``n`` calls:
    the kernels' own durations (CUPTI), summed, ÷ n — no host time and no
    gaps between launches, which the back-to-back time still holds where a
    call's host work outlasts its kernel. None where the trace shows no
    device activity."""
    by_kernel = device_kernel_ms(fn, n)
    return sum(by_kernel.values()) if by_kernel else None


def device_kernel_ms(fn, n: int = 5) -> dict:
    """Device ms per call of each kernel name in a ``torch.profiler`` trace
    of ``n`` calls (after a warm-up call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / n / 1e3
    return out


def times(kern, plain, lib=None) -> dict:
    """The kernel's, its plain version's and the library call's single-call
    medians (25, 5 and 25 calls) and back-to-back times (25 calls; the plain
    version as many as fit in ~250 ms, at least 3)."""
    t = {"ms": median_ms(kern, 25), "b2b_ms": back_to_back_ms(kern),
         "plain_ms": median_ms(plain, 5), "library_ms": None, "library_b2b_ms": None}
    t["plain_b2b_ms"] = back_to_back_ms(plain, max(3, min(25, int(250 / max(t["plain_ms"],
                                                                          1e-3)))))
    if lib is not None:
        t["library_ms"], t["library_b2b_ms"] = median_ms(lib, 25), back_to_back_ms(lib)
    return t


def times_text(t: dict) -> str:
    """One line's worth of a ``times`` dict."""
    lib = (f", library {t['library_ms']:.4f} ms (back-to-back {t['library_b2b_ms']:.4f})"
           if t["library_ms"] is not None else "")
    return (f"kernel {t['ms']:.4f} ms (back-to-back {t['b2b_ms']:.4f}), plain "
            f"{t['plain_ms']:.4f} ms (back-to-back {t['plain_b2b_ms']:.4f}){lib}")


def bound(bytes_moved: float, flops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def randk_shapes(nblk: int) -> dict:
    """(n, nblk, B, kb) for the RandK-wire kernels: every shape a main path
    gives them (n is PP's cohort r on its compressed rounds, else the worker
    count), then a forced-duplicates shape; only the first is timed."""
    shapes = {"production": (N_WORKERS, nblk, BLOCK, KB)}
    for method, compressor, _, _ in PATHS.values():
        if compressor == "block_randk" and method == "pp_marina":
            shapes.setdefault(f"cohort_n{R_PARTICIPATING}",
                              (R_PARTICIPATING, nblk, BLOCK, KB))
    shapes["duplicates"] = (N_WORKERS, 4096, BLOCK, BLOCK // 2)
    return shapes


def check_kernels(nblk: int, card: str, report: dict) -> dict:
    import torch

    from repro_torch.kernels import epilogue, randk, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}
    for label, (n, nb, B, kb) in randk_shapes(nblk).items():
        timed = label == "production"
        x3d = torch.randn((n, nb, B), generator=gen, device=dev)
        seeds = randk.seeds_tensor(RANDK_SEEDS[:n], dev)
        scale = B / kb
        v, o = randk.randk_seeded_workers(x3d, seeds, kb, scale)
        vr, orf = ref.randk_seeded_workers_ref(x3d, seeds, kb, scale)
        require(torch.equal(o, orf), f"{label}: randk offsets differ")
        require(torch.equal(v, vr), f"{label}: randk values differ")
        err = {"randk_seeded_workers": 0.0}

        s = randk.scatter_accum(v, o, B)
        sr = ref.scatter_accum_ref(v, o, B)
        require(bits_equal(s, sr), f"{label}: scatter_accum not bit-equal")
        err["scatter_accum"] = float((s - sr).abs().max())
        del s, sr

        g = torch.randn((nb, B), generator=gen, device=dev)
        x32 = torch.randn((nb, B), generator=gen, device=dev)
        for xd in (torch.float32, torch.bfloat16):
            x = x32.to(xd)
            for name, out, want in (
                ("scatter_epilogue", epilogue.scatter_epilogue(v, o, g, x, 0.0371),
                 ref.scatter_epilogue_ref(v, o, g, x, 0.0371)),
                ("mean_epilogue", epilogue.mean_epilogue(x3d, x, 0.0371),
                 ref.mean_epilogue_ref(x3d, x, 0.0371)),
            ):
                require(ulp_diff(out[0], want[0]) <= 1, f"{label}: {name} g' beyond 1 ulp")
                require(ulp_diff(out[1], want[1]) <= 1, f"{label}: {name} x' ({xd}) beyond 1 ulp")
                e = max(float((out[0] - want[0]).abs().max()),
                        float((out[1].float() - want[1].float()).abs().max()))
                err[name] = max(err.get(name, 0.0), e)
                del out, want
        torch.cuda.synchronize()
        report[f"kernels_{label}"] = {"shape": [n, nb, B, kb], "max_abs_err": err}
        print(f"kernels {label} (n={n}, nblk={nb}, B={B}, kb={kb}): match, "
              f"max_abs_err {err}", flush=True)
        if not timed:
            del x3d, v, o, vr, orf, g, x32
            continue

        x = x32
        o64 = o.long()  # the library call's int64 offsets, converted beforehand
        cells = {
            "randk_seeded_workers": (
                lambda: randk.randk_seeded_workers(x3d, seeds, kb, scale),
                lambda: ref.randk_seeded_workers_ref(x3d, seeds, kb, scale),
                lambda: torch.gather(x3d, 2, o64),
                n * nb * kb * 12 + 4 * n, n * nb * kb),
            "scatter_accum": scatter_accum_cell(v, o, B),
            "scatter_epilogue": (
                lambda: epilogue.scatter_epilogue(v, o, g, x, 0.0371),
                lambda: ref.scatter_epilogue_ref(v, o, g, x, 0.0371), None,
                n * nb * kb * 8 + 4 * nb * B * 4, n * nb * kb + 4 * nb * B),
            "mean_epilogue": (
                lambda: epilogue.mean_epilogue(x3d, x, 0.0371),
                lambda: ref.mean_epilogue_ref(x3d, x, 0.0371), None,
                (n + 3) * nb * B * 4, (n + 3) * nb * B),
        }
        for name, (kern, plain, lib, nbytes, flops) in cells.items():
            b_ms, b_by = bound(nbytes, flops)
            rows[name] = {**times(kern, plain, lib), "bound_ms": b_ms, "bound_by": b_by,
                          "max_abs_err": err[name], "bytes": nbytes}
            print(f"time {name}: {times_text(rows[name])}, bound {b_ms:.4f} ms ({b_by}) "
                  f"on {card}", flush=True)
        rows["randk_seeded_workers"].update(gather_row_extras())
        del x3d, v, o, o64, vr, orf, g, x32, x, cells
        torch.cuda.empty_cache()
        rows["scatter_accum"]["wire"] = time_scatter_wire(nb, card)
        for at, t in (("production", rows["scatter_accum"]),
                      ("wire", rows["scatter_accum"]["wire"])):
            print_target("scatter_accum", at, t, card)
    return rows


def scatter_accum_cell(v, o, B: int) -> tuple:
    """``scatter_accum``'s timing cell on payloads v, o (n, nblk, kb): the
    kernel, its plain version, the one PyTorch call that computes the same
    mean (``index_add`` into zeros with alpha 1/n), the bytes (the pairs
    read once, the (nblk, B) f32 row written once) and the operations."""
    import torch

    from repro_torch.kernels import randk, ref

    n, nb, kb = v.shape
    flat_idx = (torch.arange(nb, device=v.device)[None, :, None] * B + o.long()).reshape(-1)
    zeros = torch.zeros(nb * B, device=v.device)

    def library_scatter():  # one call: scatter-add into a copy of zeros, ÷ n
        return zeros.index_add(0, flat_idx, v.reshape(-1), alpha=1.0 / n)

    return (lambda: randk.scatter_accum(v, o, B), lambda: ref.scatter_accum_ref(v, o, B),
            library_scatter, n * nb * kb * 8 + nb * B * 4, n * nb * kb + nb * B)


def time_scatter_wire(nblk: int, card: str) -> dict:
    """``scatter_accum`` at the wire phase's shape and offsets: n = 4
    payloads of (nblk, kb = 20) at ``ops.jittered_offsets`` under four keys
    (one offset a stride of B/kb: no duplicate within a worker), as
    ``ops.randk_decompress_mean`` gets them; bit-equal to its plain version,
    then timed with it and ``index_add`` against its bound."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels import ops, randk, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    keys = prng.split(prng.PRNGKey(SEED + 7), N_WORKERS)
    o = torch.stack([ops.jittered_offsets(k, nblk, BLOCK, KB, device=dev) for k in keys])
    v = torch.randn((N_WORKERS, nblk, KB), generator=gen, device=dev)
    s, sr = randk.scatter_accum(v, o, BLOCK), ref.scatter_accum_ref(v, o, BLOCK)
    require(bits_equal(s, sr), "scatter_accum at the wire's offsets: not bit-equal")
    del s, sr
    kern, plain, lib, nbytes, flops = scatter_accum_cell(v, o, BLOCK)
    b_ms, b_by = bound(nbytes, flops)
    t = {**times(kern, plain, lib), "bound_ms": b_ms, "bound_by": b_by,
         "max_abs_err": 0.0, "bytes": nbytes}
    print(f"time scatter_accum at the wire's offsets (n={N_WORKERS}, nblk={nblk}, "
          f"kb={KB}): {times_text(t)}, bound {b_ms:.4f} ms ({b_by}) on {card}", flush=True)
    del kern, plain, lib, v, o
    torch.cuda.empty_cache()
    return t


def print_target(name: str, at: str, t: dict, card: str) -> None:
    """One line: ``name``'s back-to-back time at ``at`` against 1.3× its bound."""
    ratio = t["b2b_ms"] / t["bound_ms"]
    print(f"target {name} {at}: back-to-back {t['b2b_ms']:.4f} ms = {ratio:.3f}× its "
          f"bound {t['bound_ms']:.4f} ms (target ≤ 1.3×: "
          f"{'met' if ratio <= 1.3 else 'missed'}) on {card}", flush=True)


def report_at_n(rows: dict, timings: list, name: str, card: str) -> None:
    """``name``'s times at every (n, x dtype) it was timed at into its table
    row (``at_n``), each printed back to back against 1.3× its bound."""
    at_n = {}
    for t in timings:
        if t["kernel"] == name:
            key = f"n{t['n']}_{t['x'].removeprefix('torch.')}"
            at_n[key] = {k: t[k] for k in ("ms", "b2b_ms", "bound_ms")}
            print_target(name, key, t, card)
    rows[name]["at_n"] = at_n


NO_LIBRARY = "none (no single PyTorch call computes this function)"


def permk_bytes(r: int, nblk: int, n: int, elt: int, offsets: bool) -> tuple:
    """Row 12's bytes for r stacked rows of a fleet of n: what the function
    must move (one x value a slot read, its value and offset written) and
    what the design moves (every staged row of x read in full)."""
    slots = r * nblk * (BLOCK // n)
    out = slots * (elt + (4 if offsets else 0))
    return slots * elt + out, r * nblk * BLOCK * elt + out


def check_permk_delta(nblk: int, card: str, report: dict) -> dict:
    """The PermK uplink at n = 2, 4, 8 and the delta epilogue, x f32 and
    bf16, each against its plain version and timed; the uplink in every
    mode beside ``torch.gather`` at the kernel's own offsets (int64,
    converted beforehand) and, at n = 4, in the main path's modes too
    (``offsets=False``; ``workers`` = PERMK_SUBSET of 4 without offsets),
    bit-equal in each, with its byte bound and design floor. Then the plain PermK decode
    (``permk_concat_mean_ref``, every backend's) timed once at the
    production shape. The table's row is the production shape with offsets
    (n = 4, x f32); its ``modes`` hold the other two."""
    import torch

    from repro_torch.kernels import epilogue, permk, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows, timings = {}, []
    seed = PERMK_SEED

    def timed(x3d, n, kw, label, lib, err):
        r, elt = x3d.shape[0], x3d.element_size()
        nbytes, design = permk_bytes(r, nblk, n, elt, kw.get("offsets", True))
        b_ms, b_by = bound(nbytes, r * nblk * (BLOCK // n))
        t = {"kernel": "permk_seeded_workers", "n": n, "x": str(x3d.dtype), "mode": label,
             **times(lambda: permk.permk_seeded_workers(x3d, seed, **kw),
                     lambda: ref.permk_seeded_workers_ref(x3d, seed, **kw), lib),
             "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
             "floor_ms": design / HBM_BYTES_PER_S * 1e3, "max_abs_err": err}
        timings.append(t)
        print(f"time permk_seeded_workers n={n} x {x3d.dtype} {label}: {times_text(t)}, "
              f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e9:.3f} GB), design floor "
              f"{t['floor_ms']:.4f} ms ({design / 1e9:.3f} GB) on {card}",
              flush=True)
        return t

    for n in (N_WORKERS, 2, 8):
        x32 = torch.randn((n, nblk, BLOCK), generator=gen, device=dev)
        for xd in (torch.float32, torch.bfloat16):
            x3d = x32.to(xd)
            v, o = permk.permk_seeded_workers(x3d, seed)
            vr, orf = ref.permk_seeded_workers_ref(x3d, seed)
            require(torch.equal(o, orf), f"permk n={n} {xd}: offsets differ")
            require(torch.equal(v, vr), f"permk n={n} {xd}: values differ")
            err = float((v.float() - vr.float()).abs().max())
            del vr, orf
            o64 = o.long()  # the library call's offsets, converted beforehand
            t = timed(x3d, n, {}, "offsets", lambda: torch.gather(x3d, 2, o64), err)
            if n == N_WORKERS:
                xs = x3d[PERMK_SUBSET].contiguous()
                sub = {"workers": PERMK_SUBSET, "n": n}
                for offsets in (True, False):
                    sv, so = permk.permk_seeded_workers(xs, seed, offsets=offsets, **sub)
                    require(torch.equal(sv, v[PERMK_SUBSET]) and (
                        so is None if not offsets else torch.equal(so, o[PERMK_SUBSET])),
                        f"permk workers {PERMK_SUBSET} of {n} {xd} offsets={offsets}: "
                        "differ from the whole fleet's rows")
                nv, no = permk.permk_seeded_workers(x3d, seed, offsets=False)
                require(no is None and torch.equal(nv, v), f"permk offsets=False {xd} differs")
                del sv, so, nv
                o64s = o64[PERMK_SUBSET]  # the subset's own offsets, for its library call
                modes = {
                    "no_offsets": timed(x3d, n, {"offsets": False}, "offsets=False",
                                        lambda: torch.gather(x3d, 2, o64), 0.0),
                    "workers": timed(xs, n, {**sub, "offsets": False},
                                     f"workers={PERMK_SUBSET} of {n}, offsets=False",
                                     lambda: torch.gather(xs, 2, o64s), 0.0)}
                # on the kernel line: the measured times of each mode
                t["modes"] = {k: {m: mt[m] for m in ("ms", "b2b_ms", "plain_ms", "plain_b2b_ms",
                                                     "library_ms", "library_b2b_ms")}
                              for k, mt in modes.items()}
                del xs, o64s
                if xd == torch.float32:
                    rows["permk_seeded_workers"] = dict(t, library_call=GATHER_LIBRARY)
                    report["permk_concat_mean"] = time_permk_concat_mean(v, nblk, card)
            del x3d, v, o, o64
        del x32
        torch.cuda.empty_cache()

    delta, g, x32 = (torch.randn((nblk, BLOCK), generator=gen, device=dev)
                     for _ in range(3))
    for xd in (torch.float32, torch.bfloat16):
        x = x32.to(xd)
        out = epilogue.delta_epilogue(delta, g, x, 0.0371)
        want = ref.delta_epilogue_ref(delta, g, x, 0.0371)
        require(ulp_diff(out[0], want[0]) <= 1, f"delta_epilogue g' ({xd}) beyond 1 ulp")
        require(ulp_diff(out[1], want[1]) <= 1, f"delta_epilogue x' ({xd}) beyond 1 ulp")
        err = max(float((out[0] - want[0]).abs().max()),
                  float((out[1].float() - want[1].float()).abs().max()))
        del out, want
        elt = x.element_size()
        b_ms, b_by = bound(nblk * BLOCK * (3 * 4 + 2 * elt), 3 * nblk * BLOCK)
        t = {"kernel": "delta_epilogue", "x": str(xd),
             **times(lambda: epilogue.delta_epilogue(delta, g, x, 0.0371),
                     lambda: ref.delta_epilogue_ref(delta, g, x, 0.0371)),
             "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
        timings.append(t)
        print(f"time delta_epilogue x {xd}: {times_text(t)}, bound {b_ms:.4f} ms "
              f"({b_by}), max_abs_err "
              f"{err}, library {NO_LIBRARY} on {card}", flush=True)
        if xd == torch.float32:
            rows["delta_epilogue"] = t
    del delta, g, x32, x
    torch.cuda.empty_cache()
    report["kernels_permk_delta"] = timings
    return rows


def time_permk_concat_mean(values, nblk: int, card: str) -> dict:
    """The plain PermK decode (``permk_concat_mean_ref``: the payloads
    concatenated in slot order, gathered through the inverse permutation;
    every backend runs it, as the reference does) on the production
    payloads: its single-call and back-to-back ms, and the peak memory it
    adds, of which its int64 (nblk, B) slot index is the largest part. A
    measurement: no kernel replaces it."""
    import torch

    from repro_torch.kernels import ref

    def call():
        return ref.permk_concat_mean_ref(values, PERMK_SEED, BLOCK)

    out = call()
    require(tuple(out.shape) == (nblk, BLOCK) and bool(torch.isfinite(out).all()),
            "permk_concat_mean_ref: not a finite (nblk, B) mean")
    del out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    t = {"ms": median_ms(call, 5), "b2b_ms": back_to_back_ms(call, 10),
         "peak_added_gb": peak, "index_gb": nblk * BLOCK * 8 / 1e9,
         "bytes_bound_ms": bound(values.numel() * 4 + nblk * BLOCK * 4, 0)[0]}
    print(f"time permk_concat_mean_ref (n={values.shape[0]}, nblk={nblk}, B={BLOCK}, f32): "
          f"{t['ms']:.4f} ms (back-to-back {t['b2b_ms']:.4f}), peak memory added "
          f"{peak:.3f} GB, of it the int64 slot index {t['index_gb']:.3f} GB; byte bound "
          f"{t['bytes_bound_ms']:.4f} ms on {card}", flush=True)
    return t


def worker_counts(compressor: str, downlink: str) -> dict:
    """{n: label} for a packed wire's kernels: every worker count a main path
    gives them — the uplink's (PP's cohort r on its compressed rounds, else
    the worker count) for ``compressor``, and the compressed downlink's single
    broadcast payload (n = 1) for ``downlink``."""
    counts = {}
    for path, (method, comp, _, down) in PATHS.items():
        if comp == compressor:
            counts.setdefault(R_PARTICIPATING if method == "pp_marina" else N_WORKERS,
                              path)
        if down == downlink:
            counts.setdefault(1, path)
    return counts


def time_kernel(rows: dict, timings: list, card: str, name: str, n: int, xd,
                kern, plain, nbytes: float, flops: float, err: float) -> None:
    """Time a kernel and its plain version at one (n, x dtype); the table's
    row is the production uplink's (n = 4, x f32)."""
    import torch

    b_ms, b_by = bound(nbytes, flops)
    t = {"kernel": name, "n": n, "x": str(xd), **times(kern, plain), "bound_ms": b_ms,
         "bound_by": b_by, "max_abs_err": err, "bytes": nbytes}
    timings.append(t)
    print(f"time {name} n={n} x {xd}: {times_text(t)}, bound {b_ms:.4f} ms ({b_by}), "
          f"max_abs_err "
          f"{err}, library {NO_LIBRARY} on {card}", flush=True)
    if n == N_WORKERS and xd == torch.float32:
        rows[name] = t


def check_quantize(nblk: int, card: str, report: dict) -> dict:
    """The five packed-QSGD kernels (s = 7) at every worker count of
    ``worker_counts("block_qsgd", "qsgd")``, x in f32 and bf16, against their plain
    versions: levels, norms and words bit-equal, the dequantized mean
    bit-equal (and at ``DEQUANT_MEAN_NS`` × ``DEQUANT_MEAN_BLOCKS``), the
    epilogue's g' and x' bit-equal; each timed at its shape. The table's
    rows are the production uplink's (n = 4, x f32); the rows of
    ``qsgd_epilogue`` and ``qsgd_dequant_mean`` also hold their times at
    every (n, x dtype) they were timed at (``at_n``), each printed against
    1.3× its bound."""
    import torch

    from repro_torch.kernels import epilogue, quantize, randk, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    s, B, gamma = S_LEVELS, BLOCK, 0.0371
    rows, timings = {}, []

    def timed(*args):
        time_kernel(rows, timings, card, *args)

    for n, path in sorted(worker_counts("block_qsgd", "qsgd").items(), reverse=True):
        x32 = torch.randn((n, nblk, B), generator=gen, device=dev)
        seeds = randk.seeds_tensor([3, 2**31 + 11, 2**32 - 1, 777][:n], dev)
        size = n * nblk * B
        g = torch.randn((nblk, B), generator=gen, device=dev)
        xp32 = torch.randn((nblk, B), generator=gen, device=dev)
        for xd in (torch.float32, torch.bfloat16):
            x3d = x32.to(xd)
            lv, nm = quantize.qsgd_block_workers(x3d, seeds, s)
            lr, nr = ref.qsgd_block_workers_ref(x3d, seeds, s)
            require(torch.equal(nm, nr), f"qsgd n={n} {xd}: norms differ")
            require(torch.equal(lv, lr), f"qsgd n={n} {xd}: levels differ")
            require(int(lv.abs().max()) <= s, f"qsgd n={n} {xd}: |level| > s")
            del lr, nr
            elt = x3d.element_size()
            timed("qsgd_block_workers", n, xd,
                  lambda: quantize.qsgd_block_workers(x3d, seeds, s),
                  lambda: ref.qsgd_block_workers_ref(x3d, seeds, s),
                  size * (elt + 1) + n * nblk * 4 + n * 4, 6 * size, 0.0)
            del x3d
            if xd == torch.float32:  # the 4-bit words and the server side, once per n
                q2d = lv.reshape(n * nblk, B)
                words = quantize.nibble_pack(q2d)
                require(torch.equal(words, ref.nibble_pack_ref(q2d)),
                        f"nibble_pack n={n}: words differ")
                back = quantize.nibble_unpack(words, B)
                require(torch.equal(back, q2d), f"nibble_unpack n={n}: not the levels")
                require(torch.equal(back, ref.nibble_unpack_ref(words, B)),
                        f"nibble_unpack n={n}: differs from its plain version")
                full = torch.randint(-8, 8, (n * nblk, B), generator=gen, device=dev,
                                     dtype=torch.int8)  # every nibble, −8 included
                require(torch.equal(quantize.nibble_unpack(quantize.nibble_pack(full), B),
                                    full), f"nibble words n={n}: [−8, 7] round trip")
                require(torch.equal(quantize.nibble_pack(full), ref.nibble_pack_ref(full)),
                        f"nibble_pack n={n}: [−8, 7] words differ")
                del full, back
                timed("nibble_pack", n, xd, lambda: quantize.nibble_pack(q2d),
                      lambda: ref.nibble_pack_ref(q2d), size + size // 2, 0, 0.0)
                timed("nibble_unpack", n, xd, lambda: quantize.nibble_unpack(words, B),
                      lambda: ref.nibble_unpack_ref(words, B), size // 2 + size, 0, 0.0)
                del words
                dm = quantize.qsgd_dequant_mean(lv, nm, s)
                dr = ref.qsgd_dequant_mean_ref(lv, nm, s)
                require(bits_equal(dm, dr), f"qsgd_dequant_mean n={n} not bit-equal")
                err = float((dm - dr).abs().max())
                del dm, dr
                timed("qsgd_dequant_mean", n, xd,
                      lambda: quantize.qsgd_dequant_mean(lv, nm, s),
                      lambda: ref.qsgd_dequant_mean_ref(lv, nm, s),
                      size + n * nblk * 4 + nblk * B * 4, 2 * size + nblk * B, err)
            xp = xp32.to(xd)
            out = epilogue.qsgd_epilogue(lv, nm, g, xp, gamma, s)
            want = ref.qsgd_epilogue_ref(lv, nm, g, xp, gamma, s)
            require(bits_equal(out[0], want[0]), f"qsgd_epilogue n={n} g' not bit-equal")
            require(bits_equal(out[1], want[1]), f"qsgd_epilogue n={n} x' ({xd}) not bit-equal")
            err = max(float((out[0] - want[0]).abs().max()),
                      float((out[1].float() - want[1].float()).abs().max()))
            del out, want
            timed("qsgd_epilogue", n, xd,
                  lambda: epilogue.qsgd_epilogue(lv, nm, g, xp, gamma, s),
                  lambda: ref.qsgd_epilogue_ref(lv, nm, g, xp, gamma, s),
                  size + n * nblk * 4 + nblk * B * (2 * 4 + 2 * xp.element_size()),
                  2 * size + 4 * nblk * B, err)
            del lv, nm, xp
        print(f"kernels qsgd n={n} (for {path}, nblk={nblk}, B={B}, s={s}): match",
              flush=True)
        del x32, g, xp32
        torch.cuda.empty_cache()
    check_dequant_mean_shapes(dev)
    report["kernels_qsgd"] = timings
    report_at_n(rows, timings, "qsgd_epilogue", card)
    report_at_n(rows, timings, "qsgd_dequant_mean", card)
    return rows


#: qsgd_dequant_mean's small shapes, each held bit-equal: n over the unrolled
#: counts (1–4) and the runtime loop (5, 8), the exact multiply by 1/n (1, 2,
#: 4, 8) and the true divide (3, 5); B over the widths the kernel takes
DEQUANT_MEAN_NS, DEQUANT_MEAN_BLOCKS = (1, 2, 3, 4, 5, 8), (128, 1024, 4096)


def check_dequant_mean_shapes(dev) -> None:
    """``qsgd_dequant_mean`` bit-equal to its plain version at every n of
    ``DEQUANT_MEAN_NS`` and B of ``DEQUANT_MEAN_BLOCKS`` (s = 7, 5 blocks),
    levels over [−s, s] with whole rows at ±s, a row whose norm is 0 and
    norms spread over many octaves."""
    import torch

    from repro_torch.kernels import quantize, ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    s, nb = S_LEVELS, 5
    for n in DEQUANT_MEAN_NS:
        for B in DEQUANT_MEAN_BLOCKS:
            lv = torch.randint(-s, s + 1, (n, nb, B), generator=gen, device=dev,
                               dtype=torch.int8)
            lv[0, 1], lv[-1, 2] = s, -s
            nm = torch.rand((n, nb), generator=gen, device=dev) * 2.0 ** torch.randint(
                -30, 30, (n, nb), generator=gen, device=dev)
            nm[-1, 0] = 0.0
            require(bits_equal(quantize.qsgd_dequant_mean(lv, nm, s),
                               ref.qsgd_dequant_mean_ref(lv, nm, s)),
                    f"qsgd_dequant_mean n={n} B={B}: not bit-equal")
    print(f"kernels qsgd_dequant_mean n in {DEQUANT_MEAN_NS}, B in {DEQUANT_MEAN_BLOCKS}: "
          "bit-equal", flush=True)


def natural_edge_input(dev, B: int):
    """(2, 4, B) f32 rows of the natural wire's edge values: exact powers of
    two from 2^-126 to 2^120 (built from bits), the floats just below them,
    their negatives, zeros, −0.0 and subnormals; an all-subnormal row, a row
    whose max lies near 2^-100 (its smallest codes decode below 2^-126), an
    all-zero row, and normal rows spread over 40 octaves."""
    import torch

    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    x = torch.randn((2, 4, B), generator=gen, device=dev)
    x *= ref.pow2_ref(torch.randint(-20, 20, (2, 4, 1), generator=gen, device=dev))
    pw = ref.pow2_ref(torch.arange(-126, 121, 7, device=dev))
    edge = torch.cat([pw, torch.nextafter(pw, torch.zeros_like(pw)), -pw,
                      torch.tensor([0.0, -0.0, 1e-40, -3e-39, 2.0**-149], device=dev)])
    x[0, 0, :edge.numel()] = edge
    x[0, 1] = 1e-39
    x[0, 2] = torch.randn(B, generator=gen, device=dev) * 2.0**-100
    x[1, 3] = 0.0
    return x


def check_natural(nblk: int, card: str, report: dict) -> dict:
    """The three natural-compression kernels at every worker count of
    ``worker_counts("block_natural", "natural")`` (full width) and on the edge-value input,
    x in f32 and bf16, against their plain versions: codes and scales
    bit-equal, the decode-and-mean within 1 ulp, the epilogue's g' and x'
    bit-equal; each timed at its full-width shape. The table's rows are the
    production uplink's (n = 4, x f32); ``natural_epilogue``'s row also
    holds its times at every (n, x dtype) (``at_n``), each printed against
    1.3× its bound."""
    import torch

    from repro_torch.kernels import epilogue, quantize, randk, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    B, gamma = BLOCK, 0.0371
    rows, timings = {}, []

    def timed(*args):
        time_kernel(rows, timings, card, *args)

    def match(label, x3d, seeds, g, xp):
        """Every natural kernel on these inputs against its plain version;
        returns the payload and the two outputs' max_abs_err."""
        codes, scales = quantize.natural_block_workers(x3d, seeds)
        cr, sr = ref.natural_block_workers_ref(x3d, seeds)
        require(torch.equal(scales, sr), f"natural {label}: scales differ")
        require(torch.equal(codes, cr), f"natural {label}: codes differ")
        del cr, sr
        dm = quantize.natural_dequant_mean(codes, scales)
        dr = ref.natural_dequant_mean_ref(codes, scales)
        require(ulp_diff(dm, dr) <= 1, f"natural_dequant_mean {label} beyond 1 ulp")
        err_dm = float((dm - dr).abs().max())
        del dm, dr
        out = epilogue.natural_epilogue(codes, scales, g, xp, gamma)
        want = ref.natural_epilogue_ref(codes, scales, g, xp, gamma)
        require(bits_equal(out[0], want[0]), f"natural_epilogue {label} g' not bit-equal")
        require(bits_equal(out[1], want[1]), f"natural_epilogue {label} x' not bit-equal")
        err_ep = max(float((out[0] - want[0]).abs().max()),
                     float((out[1].float() - want[1].float()).abs().max()))
        return codes, scales, err_dm, err_ep

    edge = natural_edge_input(dev, B)
    eseeds = randk.seeds_tensor([9, 2**32 - 2], dev)
    eg = torch.randn((4, B), generator=gen, device=dev)
    for xd in (torch.float32, torch.bfloat16):
        match(f"edge values x {xd}", edge.to(xd), eseeds, eg, eg.to(xd))
    print("kernels natural edge values (n=2, nblk=4): match", flush=True)

    for n, path in sorted(worker_counts("block_natural", "natural").items(),
                          reverse=True):
        x32 = torch.randn((n, nblk, B), generator=gen, device=dev)
        seeds = randk.seeds_tensor([13, 2**31 + 5, 2**32 - 3, 4242][:n], dev)
        size = n * nblk * B
        g = torch.randn((nblk, B), generator=gen, device=dev)
        xp32 = torch.randn((nblk, B), generator=gen, device=dev)
        for xd in (torch.float32, torch.bfloat16):
            x3d, xp = x32.to(xd), xp32.to(xd)
            codes, scales, err_dm, err_ep = match(f"n={n} x {xd}", x3d, seeds, g, xp)
            elt = x3d.element_size()
            timed("natural_block_workers", n, xd,
                  lambda: quantize.natural_block_workers(x3d, seeds),
                  lambda: ref.natural_block_workers_ref(x3d, seeds),
                  size * (elt + 1) + n * nblk * 4 + n * 4, 6 * size, 0.0)
            del x3d
            if xd == torch.float32:  # the decode-and-mean reads no x: once per n
                timed("natural_dequant_mean", n, xd,
                      lambda: quantize.natural_dequant_mean(codes, scales),
                      lambda: ref.natural_dequant_mean_ref(codes, scales),
                      size + n * nblk * 4 + nblk * B * 4, 2 * size + nblk * B, err_dm)
            timed("natural_epilogue", n, xd,
                  lambda: epilogue.natural_epilogue(codes, scales, g, xp, gamma),
                  lambda: ref.natural_epilogue_ref(codes, scales, g, xp, gamma),
                  size + n * nblk * 4 + nblk * B * (2 * 4 + 2 * xp.element_size()),
                  2 * size + 4 * nblk * B, err_ep)
            del codes, scales, xp
        print(f"kernels natural n={n} (for {path}, nblk={nblk}, B={B}): match",
              flush=True)
        del x32, g, xp32
        torch.cuda.empty_cache()
    report["kernels_natural"] = timings
    report_at_n(rows, timings, "natural_epilogue", card)
    return rows


#: (n, lo, hi) of the trimmed epilogues: the production sync round under
#: trimmed_mean f = 1, PP-MARINA's cohort under the median (r = 2), the odd
#: median, and a four-value window (where the sum order matters)
TRIM_WINDOWS = ((N_WORKERS, 1, 3), (R_PARTICIPATING, 0, 2), (5, 2, 3), (8, 2, 6))
#: blocks of the two windows no main path runs (n = 5, 8): 2^16 × B values
TRIM_SMALL_NBLK = 1 << 16


def trimmed_edge_rows(dev, n: int, B: int):
    """(n, 4, B) f32 rows of the trimmed epilogues' edge values: ties across
    workers, ±0 across workers, ±inf, and a NaN row (block 2 of worker 0)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 5 + n)
    rows = torch.randn((n, 4, B), generator=gen, device=dev)
    rows[1, :, : B // 4] = rows[0, :, : B // 4]
    rows[:, 0, :16] = 0.0
    rows[: n // 2, 0, :16] = -0.0
    rows[0, 0, 16:24] = -0.0
    rows[n - 1, 1, :8] = float("inf")
    rows[0, 1, 8:16] = float("-inf")
    rows[0, 2] = float("nan")
    return rows


def check_trimmed(nblk: int, card: str, report: dict) -> dict:
    """The two trimmed epilogues at every window of ``TRIM_WINDOWS`` (n = 4
    and 2 at full width, n = 5 and 8 over ``TRIM_SMALL_NBLK`` blocks) and on
    the edge rows, rows and x in f32 and bf16, against their plain versions:
    g' and x' bit-equal, the sign of zero included. Timed at n = 4 and 2
    (rows and x f32); the table's rows are the production shape's (n = 4)."""
    import torch

    from repro_torch.kernels import epilogue, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    B, gamma = BLOCK, 0.0371
    rows_out, timings = {}, []

    def bits(t):
        return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)

    def calls(rows, g, x, lo, hi):
        return {
            "trimmed_delta_epilogue": (
                lambda: epilogue.trimmed_delta_epilogue(rows, g, x, gamma, lo, hi),
                lambda: ref.trimmed_delta_epilogue_ref(rows, g, x, gamma, lo, hi)),
            "trimmed_sync_epilogue": (
                lambda: epilogue.trimmed_sync_epilogue(rows, x, gamma, lo, hi),
                lambda: ref.trimmed_sync_epilogue_ref(rows, x, gamma, lo, hi)),
        }

    def match(label, rows, g, x, lo, hi) -> dict:
        """Each kernel against its plain version; {name: max |Δ| of g', x'}
        (NaN where an input row holds a non-finite value)."""
        err = {}
        for name, (kern, plain) in calls(rows, g, x, lo, hi).items():
            out, want = kern(), plain()
            require(torch.equal(bits(out[0]), bits(want[0])),
                    f"{name} {label}: g' differs from its plain version")
            require(torch.equal(bits(out[1]), bits(want[1])),
                    f"{name} {label}: x' differs from its plain version")
            err[name] = max(float((out[0] - want[0]).abs().max()),
                            float((out[1].float() - want[1].float()).abs().max()))
            del out, want
        return err

    for n, lo, hi in TRIM_WINDOWS:
        edge = trimmed_edge_rows(dev, n, B)
        eg = torch.randn((4, B), generator=gen, device=dev)
        eg[0, :32] = -0.0
        for bd in (torch.float32, torch.bfloat16):
            for xd in (torch.float32, torch.bfloat16):
                match(f"edge rows n={n} [{lo}, {hi}) {bd} x {xd}", edge.to(bd), eg,
                      eg.to(xd), lo, hi)
    print("kernels trimmed edge rows (NaN row, ±inf, ties, ±0): match", flush=True)

    for n, lo, hi in TRIM_WINDOWS:
        nb = nblk if n in (N_WORKERS, R_PARTICIPATING) else TRIM_SMALL_NBLK
        rows32 = torch.randn((n, nb, B), generator=gen, device=dev)
        g = torch.randn((nb, B), generator=gen, device=dev)
        x32 = torch.randn((nb, B), generator=gen, device=dev)
        for bd in (torch.float32, torch.bfloat16):
            rows = rows32.to(bd)
            for xd in (torch.float32, torch.bfloat16):
                e = match(f"n={n} [{lo}, {hi}) {bd} x {xd}", rows, g, x32.to(xd), lo, hi)
                if bd == xd == torch.float32:
                    err = e
            del rows
        if nb == nblk:
            ops = n * (n - 1) // 2 + (hi - lo) + 3  # compare-selects, sum, ÷, update
            for name, (kern, plain) in calls(rows32, g, x32, lo, hi).items():
                io = n + (4 if name == "trimmed_delta_epilogue" else 3)
                time_kernel(rows_out, timings, card, name, n, torch.float32, kern, plain,
                            io * 4 * nb * B, ops * nb * B, err[name])
        print(f"kernels trimmed n={n} [{lo}, {hi}) (nblk={nb}, B={B}): match", flush=True)
        del rows32, g, x32
        torch.cuda.empty_cache()
    report["kernels_trimmed"] = timings
    return rows_out


# ---------------------------------------------------------------------------
# phases 4 and 5: the trainer
# ---------------------------------------------------------------------------


def train(cfg, params, carry: bool, backend: str = "auto", steps: int = STEPS,
          step_hook=None, method: str = "marina", compressor: str = "block_randk",
          downlink=None, sampler=None, down_compressor=None, **kw):
    """Train ``steps`` steps through the port's ``Trainer``. ``sampler``
    swaps the trainer's flat engine for one of that sampler over the same
    layout (``randk_qsgd``, which no compressor name selects);
    ``down_compressor`` gives the optimizer a per-leaf downlink beside its
    flat engine (the trainer builds a downlink engine there)."""
    import dataclasses

    from repro_torch.train import TrainConfig, Trainer

    tc = TrainConfig(method=method, compressor=compressor,
                     comp_kwargs=COMP_KWARGS[compressor], gamma=0.02, p=P_SYNC,
                     n_workers=N_WORKERS, r_participating=R_PARTICIPATING,
                     steps=steps, log_every=steps, seed=SEED, carry_grads=carry,
                     flat_backend=backend, downlink=downlink,
                     downlink_kwargs={"s": S_LEVELS}, **kw)
    tr = Trainer(cfg, tc, params, device=DEVICE)
    if sampler is not None:
        engine = dataclasses.replace(tr.engine, sampler=sampler, s=S_LEVELS)
        tr.method = dataclasses.replace(tr.method, engine=engine)
    if down_compressor is not None:
        tr.method = dataclasses.replace(tr.method, down_compressor=down_compressor)
    return tr.run(step_hook)


def expected_bits(method: str, compressor: str, c_k: int, d: int, nblk: int) -> float:
    """One round's uplink bits per worker from the wire formulas."""
    from repro_torch.core import wire

    zeta = {"block_randk": wire.seeded_randk_bits(nblk, KB),
            "permk": wire.permk_bits(nblk * BLOCK, N_WORKERS),
            "block_qsgd": wire.block_qsgd_bits(nblk, BLOCK, S_LEVELS),
            "block_natural": wire.block_natural_bits(nblk, BLOCK)}[compressor]
    if method == "pp_marina":
        total = (wire.pp_sync_total_bits(N_WORKERS, d) if c_k
                 else wire.pp_uplink_total_bits(R_PARTICIPATING, zeta))
        return total / N_WORKERS
    return wire.dense_f32_bits(d) if c_k else zeta


def expected_down_bits(downlink, c_k: int, d: int, nblk: int) -> float:
    """One round's downlink bits per worker: the dense estimator on sync
    rounds and without a downlink, else the broadcast's QSGD or natural
    payload."""
    from repro_torch.core import wire

    if c_k:
        return wire.dense_f32_bits(d)
    if downlink is None:
        return wire.downlink_dense_bits(d)
    if downlink == "natural":
        return wire.block_natural_bits(nblk, BLOCK)
    return wire.block_qsgd_bits(nblk, BLOCK, S_LEVELS)


def check_small_input(report: dict) -> None:
    """The kernels' trajectory against the plain versions' on a small LM,
    for every (method, compressor) of the main paths and for MARINA over the
    ``randk_qsgd`` engine, both round shapes; then the baselines."""
    import torch

    from repro_torch import kernels
    import numpy as np

    from repro_torch.core import make_compressor, make_engine, tree_payload_bits, wire
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.models import ModelConfig, dense_stack, init_params

    cfg = ModelConfig(name="tiny-dense", arch_type="dense", d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
                      segments=dense_stack(2), qkv_bias=True,
                      tie_embeddings=True, rope_theta=1_000_000.0)
    worst = 0.0
    params = init_params(SEED, cfg, device=DEVICE)
    runs = [(path, dict(carry=carry, method=method, compressor=compressor,
                        downlink=downlink, **ROBUST.get(path, {})), None)
            for path, (method, compressor, carry, downlink) in PATHS.items()]
    runs += [(f"marina_randk_qsgd_{'carry' if carry else 'recompute'}",
              dict(carry=carry, method="marina", compressor="block_randk"),
              "randk_qsgd") for carry in (False, True)]
    for path, kw, sampler in runs:
        kw.update(batch_per_worker=2, mb_per_worker=1)
        kernels.reset_launch_counts()
        s_k, h_k = train(cfg, params, sampler=sampler, **kw)
        launched = {k: v for k, v in kernels.launch_counts().items() if v}
        s_r, h_r = train(cfg, params, backend="ref", sampler=sampler, **kw)
        require(h_k.round_sync == h_r.round_sync == EXPECTED_C_K,
                f"small input {path}: c_k {h_k.round_sync} vs {h_r.round_sync}")
        require(h_k.round_bits == h_r.round_bits, f"small input {path}: ledgers differ")
        for a, b in zip(tree_leaves(s_k.params), tree_leaves(s_r.params)):
            require(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
                    f"small input {path}: kernels and plain versions diverge")
            worst = max(worst, float((a - b).abs().max()))
        if path == "marina_randk_carry":
            check_checkpoint_roundtrip(s_k, report)
        if sampler == "randk_qsgd":  # the RandK kernels around the plain stage
            want = ({"randk_seeded_workers": 2, "scatter_epilogue": 2, "mean_epilogue": 2}
                    if kw["carry"] else {"randk_seeded_workers": 2, "scatter_accum": 2})
            require(launched == want, f"small input {path}: launches {launched}")
            lay = make_engine(params, kb=KB, block=BLOCK, device=DEVICE).layout
            want_bits = wire.randk_qsgd_bits(lay.nblk, KB, S_LEVELS)
            require(h_k.round_bits[1] == want_bits,
                    f"small input {path}: ledger {h_k.round_bits[1]} != {want_bits}")
    report["small_input_max_abs_param_diff"] = worst
    print(f"small input: kernels' and plain versions' trajectories agree on "
          f"{len(runs)} paths (max |Δparams| {worst:.3e})", flush=True)

    base = {}
    for method, compressor in BASELINES:
        kernels.reset_launch_counts()
        _, hist = train(cfg, params, carry=False, method=method, compressor=compressor,
                        batch_per_worker=2)
        require(all(math.isfinite(v) for v in hist.loss),
                f"baseline {method} x {compressor}: loss not finite")
        require(hist.skipped_cum[-1] == 0.0, f"baseline {method}: a round was skipped")
        # GD's identity payload is the dense 32·d
        want = tree_payload_bits(make_compressor(compressor, **COMP_KWARGS[compressor]),
                                 params)
        require(hist.round_bits == [want] * STEPS,
                f"baseline {method} x {compressor}: ledger {hist.round_bits} != {want}")
        require(not any(kernels.launch_counts().values()),
                f"baseline {method}: the tree path launched a kernel")
        base[f"{method}_{compressor}"] = {"loss": hist.loss, "round_bits": hist.round_bits}
        print(f"small input baseline {method} x {compressor}: loss {hist.loss}, "
              f"bits/round {want}", flush=True)
    report["small_input_baselines"] = base

    robust = {}
    for path, (kw, want) in SMALL_ROBUST.items():
        kernels.reset_launch_counts()
        s_k, h_k = train(cfg, params, batch_per_worker=2, **kw)
        launched = {k: v for k, v in kernels.launch_counts().items() if v}
        s_r, h_r = train(cfg, params, backend="ref", batch_per_worker=2, **kw)
        require(launched == want, f"small input {path}: launches {launched} != {want}")
        require(h_k.round_sync == h_r.round_sync == EXPECTED_C_K,
                f"small input {path}: c_k {h_k.round_sync}")
        require(h_k.round_bits == h_r.round_bits, f"small input {path}: ledgers differ")
        require(all(math.isfinite(v) for v in h_k.loss) and h_k.skipped_cum[-1] == 0.0,
                f"small input {path}: loss {h_k.loss}, skipped {h_k.skipped_cum[-1]}")
        for a, b in zip(tree_leaves(s_k.params), tree_leaves(s_r.params)):
            require(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
                    f"small input {path}: kernels and plain versions diverge")
        if kw.get("faults") == "drop":  # (n − f)/n of ζ, in float32 as the reference
            lay = make_engine(params, kb=KB, block=BLOCK, device=DEVICE).layout
            zeta = np.float32(wire.seeded_randk_bits(lay.nblk, KB))
            want_bits = float(zeta * np.float32((N_WORKERS - 1) / N_WORKERS))
            require(all(b == want_bits for c, b in zip(h_k.round_sync, h_k.round_bits)
                        if not c), f"small input {path}: drop ledger {h_k.round_bits}")
        robust[path] = {"loss": h_k.loss, "round_bits": h_k.round_bits,
                        "launches": launched}
        print(f"small input robust {path}: loss {h_k.loss}, launches {launched}, "
              f"kernels and plain versions agree", flush=True)
    report["small_input_robust"] = robust
    check_deadline(cfg, params, report)
    check_leafwise(cfg, params, report)


#: the per-leaf runs of the small-input phase: (trainer dials, per-leaf
#: downlink or None, launches). SharedRandK and CorrelatedQ compress leaf by
#: leaf in plain PyTorch (no kernel, as in the reference); the block_randk
#: engine uplinks through the RandK kernels and the broadcast crosses a
#: per-leaf QSGD downlink
SMALL_LEAFWISE = {
    "marina_shared_randk_recompute": (dict(compressor="shared_randk"), None, {}),
    "marina_correlated_qsgd_recompute": (dict(compressor="correlated_qsgd"), None, {}),
    "marina_randk_downleafqsgd_recompute": (
        dict(compressor="block_randk"), "qsgd",
        {"randk_seeded_workers": _NC, "scatter_accum": _NC}),
}


def check_leafwise(cfg, params, report: dict) -> None:
    """MARINA on the per-leaf tree wires (recompute rounds, n = 4) through
    the kernels and through the plain versions: SharedRandK, CorrelatedQ,
    and block_randk under a per-leaf QSGD downlink (s = 7). Finite losses,
    c_k, the launches of ``SMALL_LEAFWISE``, the uplink and downlink
    ledgers (``tree_payload_bits`` of the per-leaf compressor), and the two
    trajectories agree."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import make_compressor, make_layout, tree_payload_bits, wire
    from repro_torch.core.tree_util import tree_leaves

    d = sum(t.numel() for t in tree_leaves(params))
    nblk = make_layout(params, block=BLOCK).nblk
    out = {}
    for path, (dials, down, want) in SMALL_LEAFWISE.items():
        down_comp = make_compressor(down, s=S_LEVELS) if down else None
        kw = dict(carry=False, method="marina", batch_per_worker=2,
                  down_compressor=down_comp, **dials)
        kernels.reset_launch_counts()
        s_k, h_k = train(cfg, params, **kw)
        launched = {k: v for k, v in kernels.launch_counts().items() if v}
        s_r, h_r = train(cfg, params, backend="ref", **kw)
        require(launched == want, f"small input {path}: launches {launched} != {want}")
        require(h_k.round_sync == h_r.round_sync == EXPECTED_C_K,
                f"small input {path}: c_k {h_k.round_sync}")
        require(all(math.isfinite(v) for v in h_k.loss) and h_k.skipped_cum[-1] == 0.0,
                f"small input {path}: loss {h_k.loss}, skipped {h_k.skipped_cum[-1]}")
        comp = dials["compressor"]
        up = (wire.seeded_randk_bits(nblk, KB) if comp == "block_randk" else
              tree_payload_bits(make_compressor(comp, **COMP_KWARGS[comp]), params))
        down_bits = (tree_payload_bits(down_comp, params) if down_comp is not None
                     else wire.downlink_dense_bits(d))
        for c_k, bits, dbits in zip(h_k.round_sync, h_k.round_bits, h_k.round_down_bits):
            require(bits == (wire.dense_f32_bits(d) if c_k else up),
                    f"small input {path}: ledger {bits}")
            require(dbits == (wire.dense_f32_bits(d) if c_k else down_bits),
                    f"small input {path}: down ledger {dbits}")
        require(h_k.round_bits == h_r.round_bits, f"small input {path}: ledgers differ")
        for a, b in zip(tree_leaves(s_k.params), tree_leaves(s_r.params)):
            require(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
                    f"small input {path}: kernels and plain versions diverge")
        out[path] = {"loss": h_k.loss, "round_bits": h_k.round_bits,
                     "round_down_bits": h_k.round_down_bits, "launches": launched}
        print(f"small input per-leaf {path}: loss {h_k.loss}, bits {h_k.round_bits}, "
              f"down bits {h_k.round_down_bits}, launches {launched}", flush=True)
    report["small_input_leafwise"] = out


def check_deadline(cfg, params, report: dict) -> None:
    """``DeadlineMarina`` on the tree path (BlockRandK per leaf) of the small
    LM, client 0 always past the deadline (tau_max = 0): bit-identical to
    MARINA carry with client 0 dropped, and its compressed rounds book
    (n − 1)·ζ/n."""
    import numpy as np
    import torch

    from repro_torch import kernels, prng
    from repro_torch.core import (DeadlineMarina, Marina, RoundTimeModel, make_compressor,
                                  tree_payload_bits)
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.train import TrainConfig, Trainer

    tr = Trainer(cfg, TrainConfig(method="marina", n_workers=N_WORKERS, seed=SEED),
                 params, device=DEVICE)
    grad_fn = tr.method.grad_fn
    comp = make_compressor("block_randk", **COMP_KWARGS["block_randk"])
    times = RoundTimeModel(dist="fixed", mean_s=1.0, slow_ids=(0,), slow_factor=8.0)
    dm = DeadlineMarina(grad_fn, comp, 0.02, P_SYNC, deadline=2.0, times=times)
    ref = Marina(grad_fn, comp, 0.02, P_SYNC, carry=True, faults=dm.static_miss_faults())
    zeta = tree_payload_bits(comp, params)
    kernels.reset_launch_counts()
    batches = tr._batches(0, 2)
    s_d, s_m = dm.init(params, batches), ref.init(params, batches)
    for step in range(STEPS):
        key = prng.fold_in(prng.PRNGKey(SEED), step)
        batches = tr._batches(step + 1, 2)
        s_d, m_d = dm.step(s_d, key, batches)
        s_m, m_m = ref.step(s_m, key, batches)
        require(m_d.sync_round == EXPECTED_C_K[step], f"deadline: c_k at step {step}")
        require(m_d.bits_per_worker == m_m.bits_per_worker,
                f"deadline: ledger {m_d.bits_per_worker} != drop's {m_m.bits_per_worker}")
        if not m_d.sync_round:
            require(m_d.uploaded == N_WORKERS - 1, f"deadline: {m_d.uploaded} uploads")
            want = float(np.float32(np.float32(N_WORKERS - 1) * np.float32(zeta))
                         * np.float32(1.0 / N_WORKERS))
            require(m_d.bits_per_worker == want, f"deadline: ledger {m_d.bits_per_worker}")
        for a, b in zip(tree_leaves(s_d.params), tree_leaves(s_m.params)):
            require(torch.equal(a, b), "deadline: params differ from the drop run")
    require(not any(kernels.launch_counts().values()), "deadline: the tree path launched")
    report["small_input_deadline"] = {"zeta": zeta, "uploaded_compressed": N_WORKERS - 1}
    print(f"small input deadline: DeadlineMarina ≡ MARINA carry with client 0 dropped "
          f"({STEPS} steps), compressed rounds book (n−1)·ζ/n of ζ = {zeta}", flush=True)


def _union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profile_step(cfg, params, report: dict) -> None:
    """One ``torch.profiler`` trace of step 1 of a full-width carry run (a
    compressed round; step 0, a sync round, warms the profiler up), read
    back from its Chrome trace: the step's device time split into the
    model's forward + backward (kernels launched inside the trainer's
    ``train.grad`` span), the port's kernels (by name) and everything else
    (pack / unpack, stacking copies, tree ops, the finite guard), and the
    device's idle share of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.train.trainer import SPAN_GRAD, SPAN_STEP

    require(EXPECTED_C_K[:2] == [1, 0], "profile: steps 0, 1 must be sync, compressed")
    trace = os.path.join(ROOT, "build", "carry_step_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(trace)) as prof:
        _, hist = train(cfg, params, True, steps=2, step_hook=lambda _: prof.step())
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    trace_mb = os.path.getsize(trace) / 1e6
    os.remove(trace)

    spans = {SPAN_STEP: [], SPAN_GRAD: []}
    launch_ts, device = {}, []
    for e in events:
        cat, args = e.get("cat", ""), e.get("args", {})
        if cat == "user_annotation" and e.get("name") in spans:
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_ts[args["correlation"]] = e["ts"]
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((e["ts"], e["ts"] + e["dur"], e["name"], args.get("correlation")))
    require(len(spans[SPAN_STEP]) == 1, f"profile: {len(spans[SPAN_STEP])} step spans")
    t0, t1 = spans[SPAN_STEP][0]
    grads = spans[SPAN_GRAD]
    step_dev = [ev for ev in device if t0 <= ev[0] and ev[1] <= t1]
    require(step_dev, "profile: no device activity in the compressed step")

    split = {"model_fwd_bwd": 0.0, "port_kernels": 0.0, "other": 0.0}
    by_name: dict = {}
    for s, e, name, corr in step_dev:
        if any(k in name for k in SOURCES):
            part = "port_kernels"
        elif any(a <= launch_ts.get(corr, -1.0) <= b for a, b in grads):
            part = "model_fwd_bwd"
        else:
            part = "other"
        split[part] += e - s
        key = (part, name[:80])
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    busy = _union_us([(s, e) for s, e, _, _ in step_dev])
    wall = t1 - t0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    report["profile_carry_compressed_step"] = out = {
        "wall_ms": wall / 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / wall,
        "device_ms": {k: v / 1e3 for k, v in split.items()},
        "device_events": len(step_dev), "trace_mb": trace_mb,
        "step_seconds": hist.step_seconds,
        "top_device_ms": [[part, name, ms / 1e3] for (part, name), ms in top],
    }
    print(f"profile (carry compressed step, traced): wall {out['wall_ms']:.1f} ms, "
          f"device busy {out['device_busy_ms']:.1f} ms, idle share "
          f"{out['device_idle_share']:.3f}, device ms {out['device_ms']}", flush=True)
    for part, name, ms in out["top_device_ms"]:
        print(f"profile top: {ms:10.3f} ms  {part:14s} {name}", flush=True)
    del prof, events
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the flat-vector wire: its five kernels, then the wire phase
# ---------------------------------------------------------------------------

#: what the wire phase launches: per worker, ops.randk_compress (one gather
#: at the jittered offsets), flat.block_compress (the seeded gather) then
#: flat.block_gather at its offsets (a second gather), ops.qsgd_compress
#: (Σx², then the levels) and ops.qsgd_decompress; one scatter-mean over the
#: n RandK payloads
WIRE_LAUNCHES = {"randk_gather": 2 * N_WORKERS, "randk_seeded": N_WORKERS,
                 "scatter_accum": 1, "block_sumsq": N_WORKERS,
                 "qsgd_quantize": N_WORKERS, "qsgd_dequantize": N_WORKERS}


def bits_equal(a, b) -> bool:
    """Equal shapes, dtypes and bit patterns (signed zeros told apart)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = torch.int32 if a.dtype == torch.float32 else torch.int16
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def check_wire_edges(dev) -> None:
    """The five flat-wire kernels on small edge inputs, against their plain
    versions bit for bit and against the values they must give: ±0, ±inf and
    the block's first and last slots for the gathers; zero rows and one
    nonzero for Σx²; a zero norm, |x| = norm and exact ties (floor arguments
    m + 0.5 + 0.5 = m + 1 and one ulp below) for the levels; a zero norm and
    every level for the dequantize."""
    import torch

    from repro_torch.kernels import quantize, randk, ref

    B, kb, s = 128, 8, S_LEVELS
    inf = float("inf")
    x = torch.zeros((3, B), device=dev)
    x[0, :4] = torch.tensor([-0.0, inf, -inf, 2.5])
    x[1, -1] = -3.0
    x[2] = torch.linspace(-4, 4, B, device=dev)
    offs = torch.tensor([[0, 1, 2, 3, 5, 64, 126, B - 1]] * 3, dtype=torch.int32, device=dev)
    for xd in (torch.float32, torch.bfloat16):
        xx = x.to(xd)
        got = randk.randk_gather(xx, offs, B / kb)
        require(bits_equal(got, ref.randk_block_compress_ref(xx, offs, B / kb)),
                f"randk_gather edges ({xd}) differ from the plain version")
        require(bits_equal(got[0, :2], torch.tensor([-0.0, inf], dtype=xd, device=dev)),
                f"randk_gather edges ({xd}): -0 or inf not kept")
        for seed in (0, 2**32 - 1):
            v, o = randk.randk_seeded(xx, seed, kb, B / kb)
            vr, orf = ref.randk_seeded_ref(xx, seed, kb, B / kb)
            require(torch.equal(o, orf) and bits_equal(v, vr),
                    f"randk_seeded edges ({xd}, seed {seed}) differ")
        z = torch.zeros((3, B), dtype=xd, device=dev)
        z[1, 7] = -3.0
        z[2] = -0.0
        sq = quantize.block_sumsq(z)
        require(bits_equal(sq, ref.block_sumsq_ref(z)) and sq.tolist() == [0.0, 9.0, 0.0],
                f"block_sumsq edges ({xd}): {sq.tolist()}")
    # levels against norm 7 and s = 7: the floor argument is |x| + u exactly
    m = torch.arange(7, device=dev, dtype=torch.float32)
    half = torch.full_like(m, 0.5)
    below = torch.nextafter(half, torch.zeros_like(half))
    xq = torch.cat([m + 0.5, -(m + 0.5), m + 0.5, torch.tensor([7.0, -7.0, 0.0], device=dev)])
    uq = torch.cat([half, half, below, torch.tensor([0.999, 0.999, 0.999], device=dev)])
    pad = (-xq.numel()) % 4
    xq = torch.nn.functional.pad(xq, (0, pad))[None]
    uq = torch.nn.functional.pad(uq, (0, pad))[None]
    # one ulp below 0.5 the sum still rounds to m + 1 once m + 1 > 1 (the
    # add is rounded before the floor, as in the plain version)
    want = torch.cat([m + 1, -(m + 1), torch.floor((m + 0.5) + below),
                      torch.tensor([7.0, -7.0, 0.0], device=dev)])
    for norm in (7.0, 0.0):
        nt = torch.tensor(norm, device=dev)
        for xd in (torch.float32, torch.bfloat16):
            q = quantize.qsgd_quantize(xq.to(xd).contiguous(), uq, nt, s)
            require(torch.equal(q, ref.qsgd_quantize_ref(xq.to(xd), uq, nt, s)),
                    f"qsgd_quantize edges (norm {norm}, {xd}) differ")
            if norm == 7.0:
                require(torch.equal(q[0, :want.numel()].float(), want),
                        f"qsgd_quantize ties: {q[0].tolist()}")
        lv = torch.arange(-s, s + 1, device=dev, dtype=torch.int8)
        lv = torch.nn.functional.pad(lv, (0, (-lv.numel()) % 4))[None]
        dq = quantize.qsgd_dequantize(lv, nt, s)
        require(bits_equal(dq, ref.qsgd_dequantize_ref(lv, nt, s)),
                f"qsgd_dequantize edges (norm {norm}) differ")
        if norm == 7.0:
            require(torch.equal(dq, lv.float()), "qsgd_dequantize: norm = s gives the levels")
    print("kernels flat wire: edge inputs match", flush=True)


def check_wire_kernels(nblk: int, card: str, report: dict) -> dict:
    """The flat-vector wire's five kernels at full width (nblk blocks of
    B = 1024, kb = 20 host or seeded offsets per block, s = 7), x in f32
    and bf16, against their plain versions: offsets, gathered values, Σx²,
    levels and dequantized values bit-equal; then the edge inputs. Each is
    timed with its plain version and, where one PyTorch call computes the
    same function, that call. The table's rows are x f32."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels import ops, quantize, randk, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    B, kb, s = BLOCK, KB, S_LEVELS
    scale = B / kb
    key = prng.PRNGKey(SEED + 6)
    size, slots = nblk * B, nblk * kb
    rows, timings = {}, []

    def timed(name, xd, kern, plain, lib, nbytes, flops, err, **extra):
        b_ms, b_by = bound(nbytes, flops)
        t = {"kernel": name, "x": str(xd), **times(kern, plain, lib),
             "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err, "bytes": nbytes,
             **extra}
        timings.append(t)
        lib_text = "" if lib is not None else f", library {NO_LIBRARY}"
        more = "".join(f", {k} {v:.4f} ms" for k, v in extra.items())
        print(f"time {name} x {xd}: {times_text(t)}, bound {b_ms:.4f} ms ({b_by})"
              f"{more}{lib_text} on {card}", flush=True)
        if xd == torch.float32:
            rows[name] = t

    offsets = ops.jittered_offsets(key, nblk, B, kb, device=dev)
    offsets64 = offsets.long()  # the library call's int64 offsets, converted beforehand
    u2d = prng.uniform(prng.fold_in(key, 1), (nblk, B), device=dev)
    x32 = torch.randn((nblk, B), generator=gen, device=dev)
    seed = 2**31 + 99
    for xd in (torch.float32, torch.bfloat16):
        x = x32.to(xd)
        elt = x.element_size()
        # a gathered value pulls its whole 32-byte sector of x
        floor = {"sector_floor_ms": slots * (32 + 4 + elt) / HBM_BYTES_PER_S * 1e3}
        v = randk.randk_gather(x, offsets, scale)
        require(bits_equal(v, ref.randk_block_compress_ref(x, offsets, scale)),
                f"randk_gather ({xd}) differs from its plain version")
        # and its 64-byte floor: each row's distinct segments of x read once,
        # the offset read and the value written a slot
        seg = {"segment_floor_ms": sector_floors(offsets, 4 + elt)["segment_floor_ms"]}
        timed("randk_gather", xd, lambda: randk.randk_gather(x, offsets, scale),
              lambda: ref.randk_block_compress_ref(x, offsets, scale),
              lambda: torch.gather(x, 1, offsets64),
              slots * (4 + 2 * elt), slots, 0.0, **floor, **seg)
        v, o = randk.randk_seeded(x, seed, kb, scale)
        vr, orf = ref.randk_seeded_ref(x, seed, kb, scale)
        require(torch.equal(o, orf), f"randk_seeded ({xd}): offsets differ")
        require(bits_equal(v, vr), f"randk_seeded ({xd}): values differ")
        seeded64 = o.long()  # its library call's offsets, converted beforehand
        del v, o, vr, orf
        timed("randk_seeded", xd, lambda: randk.randk_seeded(x, seed, kb, scale),
              lambda: ref.randk_seeded_ref(x, seed, kb, scale),
              lambda: torch.gather(x, 1, seeded64),
              slots * (4 + 2 * elt), slots, 0.0, **floor)
        del seeded64

        sq = quantize.block_sumsq(x)
        require(bits_equal(sq, ref.block_sumsq_ref(x)), f"block_sumsq ({xd}) differs")
        timed("block_sumsq", xd, lambda: quantize.block_sumsq(x),
              lambda: ref.block_sumsq_ref(x), lambda: torch.einsum("ij,ij->i", x, x),
              size * elt + nblk * 4, 2 * size, 0.0)
        norm = ops.global_norm(sq)
        q = quantize.qsgd_quantize(x, u2d, norm, s)
        require(torch.equal(q, ref.qsgd_quantize_ref(x, u2d, norm, s)),
                f"qsgd_quantize ({xd}): levels differ")
        require(int(q.abs().max()) <= s, f"qsgd_quantize ({xd}): |level| > s")
        timed("qsgd_quantize", xd, lambda: quantize.qsgd_quantize(x, u2d, norm, s),
              lambda: ref.qsgd_quantize_ref(x, u2d, norm, s), None,
              size * (elt + 4 + 1), 5 * size, 0.0)
        if xd == torch.float32:  # the dequantize reads int8 whatever x was
            dq = quantize.qsgd_dequantize(q, norm, s)
            require(bits_equal(dq, ref.qsgd_dequantize_ref(q, norm, s)),
                    "qsgd_dequantize differs from its plain version")
            qscale = norm / torch.tensor(float(s), device=dev)
            require(bits_equal(dq, torch.mul(q, qscale)), "qsgd_dequantize != q·(norm/s)")
            del dq
            timed("qsgd_dequantize", xd, lambda: quantize.qsgd_dequantize(q, norm, s),
                  lambda: ref.qsgd_dequantize_ref(q, norm, s),
                  lambda: torch.mul(q, qscale), size * (1 + 4), size, 0.0)
        del x, sq, q
        torch.cuda.empty_cache()
    for name in ("randk_gather", "randk_seeded"):
        rows[name].update(gather_row_extras())
    del x32, u2d, offsets, offsets64
    torch.cuda.empty_cache()
    check_wire_edges(dev)
    report["kernels_wire"] = timings
    return rows


#: the library column of the gathers (rows 1, 10, 11 and 12), marked on
#: their kernel lines
GATHER_LIBRARY = ("torch.gather alone, at the kernel's own offsets converted to int64 "
                  "beforehand (the scale would be a second call)")


def gather_row_extras() -> dict:
    """The kernel-line keys of a RandK gather's row: the L2 fetch
    granularity its launches ran under, read back from the runtime (None
    off the card), and what its library column timed."""
    from repro_torch.kernels import randk

    return {"fetch_granularity_bytes": randk.fetch_granularity()
            if DEVICE == "cuda" else None, "library_call": GATHER_LIBRARY}


def sector_floors(offs, write_bytes: int) -> dict:
    """The least device-memory traffic of gathering f32 values at ``offs``
    (rows, k) int32 offsets into rows of 4 KiB-aligned f32: each row's
    distinct 32-byte sectors (and 64-byte segments) read once, plus
    ``write_bytes`` a gathered value written, as ms at the card's memory
    rate."""
    out = {}
    for key, shift, size in (("sector_floor_ms", 3, 32), ("segment_floor_ms", 4, 64)):
        ids = (offs.reshape(-1, offs.shape[-1]) >> shift).sort(dim=-1).values
        distinct = ids.shape[0] + int((ids.diff(dim=-1) != 0).sum())
        out[key] = (distinct * size + offs.numel() * write_bytes) / HBM_BYTES_PER_S * 1e3
    return out


def sweep_floor(make_call) -> dict:
    """Back-to-back ms of a yardstick at every (unroll, threads) of
    ``yardstick.SWEEP``; its time (``gather_floor_ms``) is the fastest."""
    from repro_torch.kernels import yardstick

    sweep = {f"u{u}_t{t}": back_to_back_ms(make_call(u, t)) for u, t in yardstick.SWEEP}
    return {"gather_floor_ms": min(sweep.values()), "sweep_b2b_ms": sweep}


def check_gather_floors(nblk: int, card: str, report: dict, rows: dict) -> None:
    """The random-gather yardsticks (``kernels/yardstick.py``, no path's
    kernel) at three shapes, each checked against its plain version and
    timed over ``yardstick.SWEEP``: the gather yardstick at row 1's
    production shape (n·nblk rows of B = 1024, kb = 20) and at the wire
    shape of rows 10–11 (nblk rows), the affine yardstick at row 12's (n =
    4, its seed). Each time goes into its kernels' table rows
    (``gather_floor_ms``, the one number of this phase on the kernel line)
    and is printed beside the byte bound and the sector floors of the
    offsets those kernels gather here (``sector_floor_ms``,
    ``segment_floor_ms``: every distinct 32-byte sector or 64-byte segment
    a row touches read once, computed, in ``report["gather_floors"]``),
    with the kernel's back-to-back time over the yardstick's."""
    import torch

    from repro_torch.kernels import randk, ref, yardstick

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    floors = {}
    for label, nrows in (("randk_seeded_workers", N_WORKERS * nblk), ("wire", nblk)):
        x2d = torch.randn((nrows, BLOCK), generator=gen, device=dev)
        v, o = yardstick.gather(x2d, KB)
        require(bits_equal(v, yardstick.gather_ref(x2d, KB)[0]) and torch.equal(
            o, yardstick.gather_offsets_ref(nrows, BLOCK, KB, dev)),
            f"gather yardstick at {label}: differs from its plain version")
        del v, o
        floors[label] = sweep_floor(lambda u, t: lambda: yardstick.gather(x2d, KB, u, t))
        del x2d
        torch.cuda.empty_cache()
    ctr = torch.arange(nblk * KB, dtype=torch.int64, device=dev).view(1, nblk, KB)
    seeds = randk.seeds_tensor(RANDK_SEEDS[:N_WORKERS], dev)
    o = (ref.murmur_bits_ref(seeds.long().view(-1, 1, 1) & 0xFFFFFFFF, ctr)
         & (BLOCK - 1)).to(torch.int32)  # row 1's offsets under the production seeds
    floors["randk_seeded_workers"].update(sector_floors(o, 8))
    del ctr, o

    x3d = torch.randn((N_WORKERS, nblk, BLOCK), generator=gen, device=dev)
    v, o = yardstick.affine(x3d, PERMK_SEED)
    vr, orf = yardstick.affine_ref(x3d, PERMK_SEED)
    require(bits_equal(v, vr) and torch.equal(o, orf),
            "affine yardstick differs from its plain version (row 12's offsets)")
    floors["permk_seeded_workers"] = {
        **sweep_floor(lambda u, t: lambda: yardstick.affine(x3d, PERMK_SEED, u, t)),
        **sector_floors(o, 8)}
    del x3d, v, o, vr, orf
    torch.cuda.empty_cache()

    shapes = {"randk_seeded_workers": f"n={N_WORKERS}, nblk={nblk}, B={BLOCK}, kb={KB}",
              "wire": f"nblk={nblk}, B={BLOCK}, kb={KB}",
              "permk_seeded_workers": f"affine, n={N_WORKERS}, nblk={nblk}, B={BLOCK}"}
    report["gather_floors"] = floors
    for label, f in floors.items():
        names = ("randk_gather", "randk_seeded") if label == "wire" else (label,)
        for name in names:
            row = rows[name]
            row["gather_floor_ms"] = f["gather_floor_ms"]
            for key in ("sector_floor_ms", "segment_floor_ms"):
                row.setdefault(key, f.get(key))
                f.setdefault(key, row[key])  # the wire phase's sector floor
            ratio = row["b2b_ms"] / f["gather_floor_ms"]
            sec, seg = (("n/a" if row[k] is None else f"{row[k]:.4f}")
                        for k in ("sector_floor_ms", "segment_floor_ms"))
            print(f"gather yardstick {name} ({shapes[label]}): {f['gather_floor_ms']:.4f} ms "
                  f"(fastest of {json.dumps(f['sweep_b2b_ms'])}), byte bound "
                  f"{row['bound_ms']:.4f}, 32-byte sector floor {sec}, 64-byte {seg} ms; "
                  f"kernel back-to-back {row['b2b_ms']:.4f} = {ratio:.3f}× the yardstick's "
                  f"on {card}", flush=True)
    for name in ("randk_seeded_workers", "randk_gather", "randk_seeded", "permk_seeded_workers"):
        t = rows[name]
        ratio = t["b2b_ms"] / t["gather_floor_ms"]
        sector = t.get("sector_floor_ms")
        over = "n/a" if sector is None else f"{t['b2b_ms'] / sector:.3f}×"
        print(f"rule 2 {name}: back-to-back {t['b2b_ms']:.4f} ms = {ratio:.3f}× the gather "
              f"yardstick's {t['gather_floor_ms']:.4f} ms (a redesign above 1.3×: "
              f"{'due' if ratio > 1.3 else 'not due'}), {over} its 32-byte sector floor "
              f"on {card}", flush=True)


def _sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def wire_round(x3d, d: int, keys: list, seeds: list, backend: str, secs: dict) -> dict:
    """The flat-vector wire on n packed worker gradients x3d (n, nblk, B)
    under ``backend``: per worker, ``ops.randk_compress`` (kb = 20) of the
    flat gradient, then ``ops.randk_decompress_mean`` over the n payloads;
    ``flat.block_compress`` under the worker's seed, then
    ``flat.block_gather`` at the offsets it returned; ``ops.qsgd_compress``
    (s = 7), then ``ops.qsgd_decompress``, averaged. Each call's host seconds
    (to a synchronize) go into ``secs``; returns every output."""
    import torch

    from repro_torch.core import flat
    from repro_torch.kernels import ops, ref

    def call(label, fn):
        t0 = time.perf_counter()
        res = fn()
        _sync()
        secs.setdefault(label, []).append(time.perf_counter() - t0)
        return res

    n = x3d.shape[0]
    scale = BLOCK / KB
    out = {k: [] for k in ("vals", "offs", "bvals", "boffs", "gvals", "q", "norm")}
    for w in range(n):
        xw = x3d[w].reshape(-1)[:d]
        v, o = call("randk_compress",
                    lambda: ops.randk_compress(xw, keys[w][0], KB, BLOCK, backend))
        out["vals"].append(v)
        out["offs"].append(o)
    out["dense"] = call("randk_decompress_mean", lambda: ops.randk_decompress_mean(
        torch.stack(out["vals"]), torch.stack(out["offs"]), d, BLOCK, backend))
    for w in range(n):
        bv, bo = call("block_compress",
                      lambda: flat.block_compress(x3d[w], seeds[w], KB, scale, backend))
        out["bvals"].append(bv)
        out["boffs"].append(bo)
        out["gvals"].append(call("block_gather",
                                 lambda: flat.block_gather(x3d[w], bo, scale, backend)))
    acc = None
    for w in range(n):
        xw = x3d[w].reshape(-1)[:d]
        q, nm = call("qsgd_compress", lambda: ops.qsgd_compress(xw, keys[w][1], S_LEVELS,
                                                                 BLOCK, backend))
        deq = call("qsgd_decompress",
                   lambda: ops.qsgd_decompress(q, nm, S_LEVELS, d, BLOCK, backend))
        acc = deq if acc is None else acc + deq
        out["q"].append(q)
        out["norm"].append(nm)
    out["qsgd_mean"] = ref.div_n(acc, n)
    return out


def run_wire_path(report: dict) -> dict:
    """The wire phase: full-width Qwen1.5-0.5B from ``SEED``, n = 4 worker
    gradients from the trainer's step-0 batches (8 × 256 tokens each),
    packed into (n, nblk, B) f32, through :func:`wire_round` on the kernels
    (launch counts reset just before, read just after: ``WIRE_LAUNCHES``)
    and again through the plain versions on the card, which must give
    identical outputs. Also: each seeded payload is row w of
    ``randk_seeded_workers`` and ``flat.seeded_offsets``, the gather at its
    offsets returns it, |level| ≤ s, a worker's decompressed RandK payload
    is x·B/kb where it is nonzero, and the wire bits are ``wire.py``'s."""
    import torch

    from repro_torch import kernels, prng
    from repro_torch.configs import get_arch
    from repro_torch.core import flat, make_compressor, make_layout, pack_stacked, wire
    from repro_torch.core.marina import _per_worker_grads
    from repro_torch.kernels import ops, randk, ref
    from repro_torch.models import init_params
    from repro_torch.train import TrainConfig, Trainer

    dev = torch.device(DEVICE)
    cfg = get_arch("qwen1.5-0.5b").model
    params = init_params(SEED, cfg, device=DEVICE)
    tr = Trainer(cfg, TrainConfig(method="marina", compressor="block_randk",
                                  comp_kwargs=COMP_KWARGS["block_randk"],
                                  n_workers=N_WORKERS, seed=SEED), params, device=DEVICE)
    lay = make_layout(params, block=BLOCK)
    d, nblk = lay.d, lay.nblk
    x3d = pack_stacked(lay, _per_worker_grads(tr.method.grad_fn, params,
                                              tr._batches(0, tr.tcfg.batch_per_worker)))
    del tr, params
    gc.collect()
    torch.cuda.empty_cache()
    wkeys = prng.split(prng.fold_in(prng.PRNGKey(SEED), 0), N_WORKERS)
    sub = [prng.split(k, 3) for k in wkeys]
    keys = [(k[0], k[1]) for k in sub]
    seeds = [flat.key_to_seed(k[2]) for k in sub]

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    secs: dict = {}
    out = wire_round(x3d, d, keys, seeds, "auto", secs)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = {name: WIRE_LAUNCHES.get(name, 0) for name in kernels.KERNELS}
    require(counts == want, f"wire launches {counts} != {want}")

    # the checks below launch kernels to compare; they are not the path's
    scale = BLOCK / KB
    wv, wo = randk.randk_seeded_workers(x3d, randk.seeds_tensor(seeds, dev), KB, scale)
    for w in range(N_WORKERS):
        require(torch.equal(out["boffs"][w], wo[w]) and bits_equal(out["bvals"][w], wv[w]),
                f"wire: block_compress of worker {w} != randk_seeded_workers row {w}")
        require(torch.equal(out["boffs"][w], flat.seeded_offsets(seeds[w], nblk, BLOCK, KB,
                                                                 device=dev)),
                f"wire: worker {w}'s offsets != flat.seeded_offsets")
        require(bits_equal(out["gvals"][w], out["bvals"][w]),
                f"wire: block_gather at worker {w}'s offsets != its payload")
        require(int(out["q"][w].abs().max()) <= S_LEVELS, f"wire: worker {w} |level| > s")
    del wv, wo
    one = ops.randk_decompress_mean(out["vals"][0][None], out["offs"][0][None], d)
    nz = one != 0
    require(bits_equal(one[nz], ref.scale_values(x3d[0].reshape(-1)[:d][nz], scale)),
            "wire: randk_decompress_mean's nonzeros != x·B/kb")
    require(int(nz.sum()) <= nblk * KB, "wire: more nonzeros than sampled slots")
    del one, nz
    x64 = torch.sqrt(torch.sum(x3d[0].double() ** 2))
    norm_rel = float(abs(out["norm"][0].double() - x64) / x64)
    require(norm_rel <= 2.0**-22, f"wire: global norm off by {norm_rel} (relative)")
    bits = {"randk_compress": make_compressor("randk", k=nblk * KB).payload_bits(d),
            "block_compress": flat.seeded_payload_bits(nblk, KB),
            "qsgd_compress": wire.qsgd_global_bits(d, S_LEVELS)}
    require(bits["randk_compress"] == 32 * (out["vals"][0].numel() + out["offs"][0].numel()),
            f"wire: randk payload bits {bits['randk_compress']}")
    require(bits["block_compress"] == wire.SEED_BITS + 32 * out["bvals"][0].numel(),
            f"wire: seeded payload bits {bits['block_compress']}")
    require(bits["qsgd_compress"] == wire.F32_BITS + wire.qsgd_level_bits(S_LEVELS) * d,
            f"wire: qsgd payload bits {bits['qsgd_compress']}")

    kernels.reset_launch_counts()
    plain = wire_round(x3d, d, keys, seeds, "ref", {})
    require(not any(kernels.launch_counts().values()), "wire: the plain run launched")
    for name, got in out.items():
        ref_v = plain[name]
        same = (all(bits_equal(a, b) for a, b in zip(got, ref_v)) if isinstance(got, list)
                else bits_equal(got, ref_v))
        require(same, f"wire: {name} differs between the kernels and the plain versions")
    del plain, out
    per_call = {k: statistics.median(v) for k, v in secs.items()}
    report["wire"] = {"d": d, "nblk": nblk, "launches": counts, "seconds_per_call": per_call,
                      "peak_mem_gb": peak, "norm_rel_err_vs_f64": norm_rel, "bits": bits}
    print(f"wire: d={d}, nblk={nblk}, launches {dict((k, v) for k, v in counts.items() if v)}, "
          f"median s/call {per_call}, peak memory {peak:.2f} GB, bits/worker {bits}; "
          f"kernels and plain versions identical", flush=True)
    del x3d
    gc.collect()
    torch.cuda.empty_cache()
    return {"wire": counts}


# ---------------------------------------------------------------------------
# serving: the paged-attention and int8 KV-row kernels, the serve paths
# ---------------------------------------------------------------------------


def paged_inputs(dev, gen, S, H, KV, hd, P, maxp, dtype):
    """q, the k / v pools, block tables (a seeded permutation of the pages)
    and n_valid seeded in [1, max_pages·P] with both ends present."""
    import torch

    npage = 1 + S * maxp
    q = torch.randn((S, H, hd), generator=gen, device=dev).to(dtype)
    kp = torch.randn((npage, P, KV, hd), generator=gen, device=dev).to(dtype)
    vp = torch.randn((npage, P, KV, hd), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(npage - 1, generator=gen, device=dev) + 1
    tables = perm.to(torch.int32).reshape(S, maxp).contiguous()
    n_valid = torch.randint(1, maxp * P + 1, (S,), generator=gen, device=dev)
    n_valid[0], n_valid[-1] = 1, maxp * P
    return q, kp, vp, tables, n_valid.to(torch.int32)


def paged_bytes(n_valid, H, KV, hd, elt) -> float:
    """The bytes the paged attention must move: the valid K and V rows, q
    and the output."""
    return float(n_valid.sum()) * KV * hd * elt * 2 + 2 * len(n_valid) * H * hd * elt


def paged_within_bound(out, want, vp) -> tuple[bool, float, float, float]:
    """ROADMAP C's bound: f32 |Δ| ≤ 1e-5·max|v|; bf16 |Δ| ≤ one bf16 ulp of
    each output row's largest magnitude. (ok, max |Δ|, the bound (f32) or
    the largest |Δ| / ulp (bf16), the bit-equal share)."""
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()
    diff = (out.float() - want.float()).abs()
    err = float(diff.max())
    if out.dtype == torch.float32:
        limit = 1e-5 * float(vp.abs().max())
        ok = err <= limit
    else:
        top = want.float().abs().amax(dim=-1, keepdim=True)
        ulp = torch.exp2(torch.floor(torch.log2(top.clamp_min(2.0**-126))) - 7)
        ok = bool((diff <= ulp).all())
        limit = float((diff / ulp).max())
    return ok, err, limit, float((diff == 0).float().mean())


def paged_edge_n_valid(dev, gen, S: int, P: int, maxp: int, C: int):
    """n_valid at the cluster split's edges, then seeded: 1 (every other
    rank empty), 0 (uniform over the row), past L (clamped), C pages (a
    split boundary: each rank one page) and one past it, a page boundary, a
    negative count, L, one past a page boundary."""
    import torch

    L = maxp * P
    edge = [1, 0, L + 100, C * P, C * P + 1, P, -3, L, P + 1]
    n = torch.randint(1, L + 1, (S,), generator=gen, device=dev)
    k = min(S, len(edge))
    n[:k] = torch.tensor(edge[:k], device=dev)
    return n.to(torch.int32)


def absmax_edge_rows(dev, W: int):
    """(6, W) f32 rows: zero, exact .5 ties, ±0, ±127·scale and tiny values."""
    import torch

    rows = torch.zeros((6, W), device=dev)
    rows[1] = 127.0
    rows[1, ::2] = torch.arange(W // 2, device=dev) % 127 + 0.5
    rows[2, : W // 2] = -0.0
    rows[3] = torch.linspace(-254.0, 254.0, W, device=dev)
    rows[4] = 2.5 * torch.sign(torch.arange(W, device=dev) % 3 - 1.0)
    rows[4, 0] = 317.5
    rows[5] = 1e-30 * (torch.arange(W, device=dev) - W / 2)
    return rows


def host_us(fn, calls: int = 200, runs: int = 5) -> float:
    """Host µs per call: the median of ``runs`` runs of ``calls`` calls on
    the host clock, the device synchronized before each run (a call that
    only enqueues work returns before the device runs it)."""
    import torch

    per = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per)


def page_write_inputs(dev, gen, T: int, n_real: int, KV: int, W: int, dtype):
    """k and v rows (T, KV, W) in ``dtype`` (two tensors, as the model's
    projections give them), a zeroed int8 pool of ``PAGE_WRITE_POOL`` and
    (T,) int32 maps: the first ``n_real`` tokens at distinct seeded rows of
    pages ≥ 1, the rest on the null page at seeded (repeating) rows."""
    import torch

    npage, P = PAGE_WRITE_POOL
    k = (torch.randn((T, KV, W), generator=gen, device=dev) * 3).to(dtype)
    v = (torch.randn((T, KV, W), generator=gen, device=dev) * 3).to(dtype)
    slots = torch.randperm((npage - 1) * P, generator=gen, device=dev)[:n_real]
    page = torch.zeros((T,), dtype=torch.int32, device=dev)
    row = torch.randint(0, P, (T,), generator=gen, device=dev, dtype=torch.int32)
    page[:n_real] = (1 + slots // P).to(torch.int32)
    row[:n_real] = (slots % P).to(torch.int32)
    shape = (npage, P, KV, W)
    pool = {"kq": torch.zeros(shape, dtype=torch.int8, device=dev),
            "vq": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(shape[:3], dtype=torch.float32, device=dev),
            "v_scale": torch.zeros(shape[:3], dtype=torch.float32, device=dev)}
    return k, v, pool, page, row


def pools_equal_from_page_one(got: dict, want: dict) -> bool:
    """Every row of pages ≥ 1 of the four int8-pool tensors bit-equal."""
    import torch

    for key in ("kq", "vq", "k_scale", "v_scale"):
        a, b = got[key][1:], want[key][1:]
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            return False
    return True


def dequant_host_us(c, sc) -> dict:
    """Host µs per call of the ``absmax_dequant_rows`` wrapper and of each
    piece of host work such a wrapper can do (a generic buffer check,
    ``torch.empty`` or ``new_empty``, a library lookup, ``current_stream()``
    with or without the device index; the wrapper does ``new_empty`` and
    ``current_stream(index)``), beside ``torch.mul``: the median of 5 runs
    of 200 calls on the host clock, the device synchronized before each
    run."""
    import torch

    from repro_torch.kernels import _build, quantize

    R, W = c.shape
    out = torch.empty((R, W), dtype=torch.float32, device=c.device)
    entry = _build.entry("quantize", "absmax_dequant_rows")
    stream = torch.cuda.current_stream().cuda_stream
    idx = c.get_device()
    c1, sc1 = c[:128].contiguous(), sc[:128].contiguous()
    parts = {
        "wrapper": lambda: quantize.absmax_dequant_rows(c, sc),
        "wrapper (128 rows)": lambda: quantize.absmax_dequant_rows(c1, sc1),
        "torch.mul": lambda: torch.mul(c, sc[:, None]),
        "check_cuda_buffers": lambda: quantize.check_cuda_buffers(c, sc),
        "torch.empty": lambda: torch.empty((R, W), dtype=torch.float32, device=c.device),
        "new_empty": lambda: c.new_empty((R, W), dtype=torch.float32),
        "data_ptr x3": lambda: (c.data_ptr(), sc.data_ptr(), out.data_ptr()),
        "library lookup": lambda: getattr(_build.library("quantize"), "absmax_dequant_rows"),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(idx).cuda_stream,
        "ctypes call": lambda: entry(c.data_ptr(), sc.data_ptr(), out.data_ptr(), R, W,
                                     stream),
    }
    return {name: host_us(fn) for name, fn in parts.items()}


def check_serve_kernels(card: str, report: dict) -> dict:
    """Rows 22–24 against their plain versions on the card: the int8 KV-row
    pair bit-equal at every shape of ``ABSMAX_SHAPES`` and on the edge rows,
    rows f32 and bf16; the one-launch page write (``absmax_quant_write_pages``)
    bit-equal on every row of pages ≥ 1 at ``PAGE_WRITE_SHAPES``, with
    null-page duplicates, rows f32 and bf16, and timed (host µs a call
    too);
    ``paged_attn_decode`` at ``PAGED_SHAPES`` in f32 and bf16, held to
    |Δ| ≤ 1e-5·max|v| (f32) or one bf16 ulp of max|out| (bf16). Each is
    timed; the table rows are the serve path's shapes (the quantizer: the
    decode step's page write; dequant: the int8 decode read's S·L·KV
    rows)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged, quantize, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    rows, timings = {}, []

    def timed(name, label, dtype, kern, plain, lib, nbytes, flops, err, ops_per_s):
        b_ms, b_by = bound(nbytes, flops, ops_per_s)
        t = {"kernel": name, "shape": label, "dtype": str(dtype), **times(kern, plain, lib),
             "device_ms": device_ms(kern),
             "library_device_ms": device_ms(lib) if lib is not None else None,
             "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err, "bytes": nbytes}
        timings.append(t)
        print(f"time {name} {label} {dtype}: {times_text(t)}, device (profiler) "
              f"{t['device_ms']} ms (library {t['library_device_ms']}), bound {b_ms:.4f} ms "
              f"({b_by}), max_abs_err {err} on {card}", flush=True)
        return t

    # int8 KV rows
    for W in (64, 128):
        for xd in (torch.float32, torch.bfloat16):
            x = absmax_edge_rows(dev, W).to(xd)
            c, sc = quantize.absmax_quant_rows(x)
            cr, sr = ref.absmax_quant_rows_ref(x)
            require(torch.equal(c, cr) and torch.equal(sc.view(torch.int32),
                                                       sr.view(torch.int32)),
                    f"absmax_quant_rows edge rows W={W} {xd} differ")
            require(torch.equal(quantize.absmax_dequant_rows(c, sc).view(torch.int32),
                                ref.absmax_dequant_rows_ref(c, sc).view(torch.int32)),
                    f"absmax_dequant_rows edge rows W={W} differ")
    print("kernels absmax edge rows (W = 64, 128; f32, bf16): bit-equal", flush=True)
    for W in DEQUANT_WIDTHS:  # the shift path, and the tail branch (a partial last thread)
        c = torch.randint(-128, 128, (333, W), generator=gen, device=dev).to(torch.int8)
        sc = torch.randn((333,), generator=gen, device=dev)
        require(torch.equal(quantize.absmax_dequant_rows(c, sc).view(torch.int32),
                            ref.absmax_dequant_rows_ref(c, sc).view(torch.int32)),
                f"absmax_dequant_rows W={W} differs")
    print(f"kernels absmax_dequant_rows W in {DEQUANT_WIDTHS} (333 rows): bit-equal",
          flush=True)
    for label, (R, W) in ABSMAX_SHAPES.items():
        x32 = torch.randn((R, W), generator=gen, device=dev) * 3
        for xd in (torch.float32, torch.bfloat16):
            x = x32.to(xd)
            c, sc = quantize.absmax_quant_rows(x)
            cr, sr = ref.absmax_quant_rows_ref(x)
            require(torch.equal(c, cr) and torch.equal(sc, sr),
                    f"absmax_quant_rows {label} {xd} differ")
            elt = x.element_size()
            timed("absmax_quant_rows", label, xd, lambda: quantize.absmax_quant_rows(x),
                  lambda: ref.absmax_quant_rows_ref(x), None, R * W * (elt + 1) + 4 * R,
                  3 * R * W, 0.0, F32_OPS_PER_S)
        d = quantize.absmax_dequant_rows(c, sc)
        require(torch.equal(d.view(torch.int32),
                            ref.absmax_dequant_rows_ref(c, sc).view(torch.int32)),
                f"absmax_dequant_rows {label} differ")
        timed("absmax_dequant_rows", label, torch.int8,
              lambda: quantize.absmax_dequant_rows(c, sc),
              lambda: ref.absmax_dequant_rows_ref(c, sc),
              lambda: torch.mul(c, sc[:, None]), R * W * 5 + 4 * R, R * W, 0.0,
              F32_OPS_PER_S)
        del x32, x, c, sc, cr, sr, d
    for label, (T, n_real, KV, W) in PAGE_WRITE_SHAPES.items():
        for xd in (torch.float32, torch.bfloat16):
            k, v, pool, page, row = page_write_inputs(dev, gen, T, n_real, KV, W, xd)
            got = {key: t.clone() for key, t in pool.items()}
            want = {key: t.clone() for key, t in pool.items()}
            quantize.absmax_quant_write_pages(k, v, got, page, row)
            ref.absmax_quant_write_pages_ref(k, v, want, page, row)
            require(pools_equal_from_page_one(got, want),
                    f"absmax_quant_write_pages {label} {xd}: pages >= 1 differ")
            elt = k.element_size()
            t = timed("absmax_quant_rows", f"write_{label}", xd,
                      lambda: quantize.absmax_quant_write_pages(k, v, got, page, row),
                      lambda: ref.absmax_quant_write_pages_ref(k, v, want, page, row), None,
                      2 * T * KV * (W * (elt + 1) + 4) + 2 * T * 4, 6 * T * KV * W, 0.0,
                      F32_OPS_PER_S)
            if DEVICE == "cuda":
                t["host_us"] = host_us(
                    lambda: quantize.absmax_quant_write_pages(k, v, got, page, row))
                print(f"host µs per call, absmax_quant_rows write_{label} {xd} (T={T}, "
                      f"{T - n_real} on the null page): {t['host_us']:.2f}", flush=True)
            if label == "serve_decode" and xd == torch.float32:
                rows["absmax_quant_rows"] = t
            del k, v, pool, got, want
    print(f"kernels absmax_quant_write_pages at {PAGE_WRITE_SHAPES} (pool "
          f"{PAGE_WRITE_POOL}; f32, bf16): pages >= 1 bit-equal", flush=True)
    S, H, KV, hd, P, maxp = PAGED_SHAPES["serve"]
    R = S * maxp * P * KV  # the int8 decode read: every gathered row
    c = torch.randint(-127, 128, (R, hd), generator=gen, device=dev).to(torch.int8)
    sc = torch.rand((R,), generator=gen, device=dev)
    require(torch.equal(quantize.absmax_dequant_rows(c, sc),
                        ref.absmax_dequant_rows_ref(c, sc)), "absmax_dequant_rows read differ")
    rows["absmax_dequant_rows"] = timed(
        "absmax_dequant_rows", "serve_decode_read", torch.int8,
        lambda: quantize.absmax_dequant_rows(c, sc),
        lambda: ref.absmax_dequant_rows_ref(c, sc), lambda: torch.mul(c, sc[:, None]),
        R * hd * 5 + 4 * R, R * hd, 0.0, F32_OPS_PER_S)
    if DEVICE == "cuda":
        report["absmax_dequant_host_us"] = dequant_host_us(c, sc)
        print("host µs per call, absmax_dequant_rows at the decode read: "
              + json.dumps(report["absmax_dequant_host_us"]), flush=True)
    del c, sc

    # paged attention
    for label, (S, H, KV, hd, P, maxp) in PAGED_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16):
            q, kp, vp, tables, n_valid = paged_inputs(dev, gen, S, H, KV, hd, P, maxp, dt)
            C, smem = paged.launch_plan(S, KV, hd, H // KV, P, maxp, q.element_size())
            out = paged.paged_attn_decode(q, kp, vp, tables, n_valid)
            want = ref.paged_attn_decode_ref(q, kp, vp, tables, n_valid)
            ok, err, limit, same = paged_within_bound(out, want, vp)
            require(ok, f"paged_attn_decode {label} {dt}: max |Δ| {err} beyond the bound "
                        f"({limit})")
            print(f"kernels paged_attn_decode {label} {dt} (S={S}, H={H}, KV={KV}, hd={hd}, "
                  f"P={P}, max_pages={maxp}, Σn_valid={int(n_valid.sum())}; cluster {C}, "
                  f"{smem} B shared): max |Δ| {err}, bound measure {limit}, bit-equal "
                  f"share {same:.4f}", flush=True)
            edge = paged_edge_n_valid(dev, gen, S, P, maxp, C)
            out = paged.paged_attn_decode(q, kp, vp, tables, edge)
            want = ref.paged_attn_decode_ref(q, kp, vp, tables, edge)
            e_ok, e_err, e_limit, _ = paged_within_bound(out, want, vp)
            require(e_ok, f"paged_attn_decode {label} {dt} edge n_valid "
                          f"{edge.tolist()[:9]}: max |Δ| {e_err} beyond the bound ({e_limit})")
            print(f"kernels paged_attn_decode {label} {dt} edge n_valid "
                  f"{edge.tolist()[:9]}: max |Δ| {e_err}, bound measure {e_limit}",
                  flush=True)
            del out, want, edge
            torch.cuda.empty_cache()
            elt = q.element_size()
            nbytes = paged_bytes(n_valid, H, KV, hd, elt)
            flops = 4.0 * float(n_valid.sum()) * H * hd
            t = timed("paged_attn_decode", label, dt,
                      lambda: paged.paged_attn_decode(q, kp, vp, tables, n_valid),
                      lambda: ref.paged_attn_decode_ref(q, kp, vp, tables, n_valid), None,
                      nbytes, flops, err,
                      F32_OPS_PER_S if dt == torch.float32 else BF16_OPS_PER_S)
            t.update(cluster=C, smem_bytes=smem)
            # yardstick only: SDPA over the pre-gathered dense cache (gather excluded)
            kd = ref.paged_gather_ref(kp, tables).transpose(1, 2).contiguous()
            vd = ref.paged_gather_ref(vp, tables).transpose(1, 2).contiguous()
            mask = (torch.arange(maxp * P, device=dev)[None, :]
                    < n_valid[:, None])[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(q[:, :, None, :], kd, vd,
                                                      attn_mask=mask, enable_gqa=True)

            t["sdpa_dense_ms"], t["sdpa_dense_b2b_ms"] = median_ms(sdpa, 25), back_to_back_ms(sdpa)
            t["sdpa_dense_device_ms"] = device_ms(sdpa)
            print(f"compare paged_attn_decode {label} {dt}: scaled_dot_product_attention "
                  f"on the pre-gathered dense cache (gather excluded) "
                  f"{t['sdpa_dense_ms']:.4f} ms (back-to-back {t['sdpa_dense_b2b_ms']:.4f}, "
                  f"device {t['sdpa_dense_device_ms']}) vs the kernel {t['ms']:.4f} ms "
                  f"(back-to-back {t['b2b_ms']:.4f}, device {t['device_ms']})", flush=True)
            if label == "serve" and dt == torch.float32:
                rows["paged_attn_decode"] = t
            del q, kp, vp, tables, n_valid, kd, vd, mask
            torch.cuda.empty_cache()
    report["kernels_serve"] = timings
    return rows


def serve_launches(quantized: bool | None, rep: dict) -> dict:
    """What a serve path must launch: the paged attention once per layer of
    every decode step on f32 pages; on int8 pages (``quantized``) the row
    quantizer once per layer of every prefill chunk and decode step (the
    page write, k and v in one launch) and the dequantizer twice (k, v) per
    layer of every decode step; nothing on the static dense-cache path
    (``quantized`` None)."""
    layers = rep["n_layers"]
    if quantized is False:
        return {"paged_attn_decode": layers * rep["decode_steps"]}
    if quantized:
        return {"absmax_quant_rows": layers * (rep["prefill_chunks"] + rep["decode_steps"]),
                "absmax_dequant_rows": 2 * layers * rep["decode_steps"]}
    return {}


def plain_streams(params, cfg, pairs, serve_kw: dict, temperature: float = 0.0,
                  seed: int = 0) -> tuple[list, dict]:
    """The continuous engine over the plain versions (``backend="ref"``),
    with its prefill and decode steps rebuilt to keep the logits (as the
    reference's serving tests do): every request's stream and, per
    generated token, the top-2 margin of the logits that chose it — at
    ``temperature`` > 0 of the perturbed logits (logits × f32(1/T) + the
    Gumbel noise of the step's key, split as the engine splits it)."""
    import numpy as np
    import torch

    from repro_torch import prng
    from repro_torch.launch import serve
    from repro_torch.models import paged_decode_step, paged_prefill_chunk

    kw = dict(serve_kw)
    reqs = serve.make_workload(cfg, pairs)
    layout = serve.paged_layout(reqs, slots=kw.pop("slots"), page_size=kw.pop("page_size"),
                                npage=kw.pop("npage", None))
    eng = serve.build_engine(params, cfg, layout, backend="ref", **kw)
    dev = params["embed"].device
    margins: dict = {}

    def tensor(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    keys = serve.KeyStream(seed)

    def greedy(lg):
        if temperature > 0:
            lg = (prng.gumbel(keys.next(), tuple(lg.shape), device=lg.device)
                  + serve.scale_logits(lg, temperature, jitted=True))
        top = torch.topk(lg.float(), 2, dim=-1).values
        return (torch.argmax(lg, dim=-1).to(torch.int32).cpu().numpy(),
                (top[..., 0] - top[..., 1]).cpu().tolist())

    @torch.inference_mode()
    def prefill_fn(cache, toks, start, row, nv):
        req = min((r for r in eng.sched.active if r.prefilling), key=lambda r: r.t_admit)
        lg, cache = paged_prefill_chunk(params, cfg, cache, tensor(toks), int(start),
                                        tensor(row), int(nv), backend="ref")
        tok, m = greedy(lg)
        if req.prefill_done + int(nv) == req.prompt_len:
            margins.setdefault(req.rid, []).append(m)
        return tok, cache

    @torch.inference_mode()
    def decode_fn(cache, toks, lengths, tables):
        slots = list(eng.sched.slots)
        lg, cache = paged_decode_step(params, cfg, cache, tensor(toks), tensor(lengths),
                                      tensor(tables), backend="ref")
        out, m = greedy(lg)
        for s, req in enumerate(slots):
            if req is not None and req.decoding and lengths[s] > 0:
                margins.setdefault(req.rid, []).append(m[s])
        return out, cache

    eng.prefill_fn, eng.decode_fn = prefill_fn, decode_fn
    eng.run(reqs)
    eng.sched.pool.check_conservation(eng.sched.tables)
    return [r.generated for r in reqs], margins


def compare_streams(label: str, got: list, want: list, margins: dict | None) -> list:
    """Identical streams (``margins`` None), or identical up to the first
    token where the plain run's top-2 margin was below SERVE_TIE_MARGIN (that
    request is not compared further). Returns the divergences."""
    diverged = []
    for rid, (a, b) in enumerate(zip(got, want)):
        require(len(a) == len(b), f"{label}: request {rid} lengths {len(a)} != {len(b)}")
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        m = None if margins is None else margins[rid][j]
        print(f"{label}: request {rid} diverges at token {j}; plain top-2 margin {m}",
              flush=True)
        require(m is not None and m < SERVE_TIE_MARGIN,
                f"{label}: request {rid} diverges at token {j} (margin {m})")
        diverged.append({"rid": rid, "token": j, "margin": m})
    return diverged


def timed_paged_steps(params, cfg) -> tuple[dict, list]:
    """The serve engine's paged steps, the decode step timed on the host
    clock: (steps, the list each decode step appends its seconds to). A
    step ends in a copy of its tokens to the host, so the clock waits for
    the device."""
    from repro_torch.launch import serve

    decode_s = []
    steps = serve.build_paged_steps(params, cfg)

    def timed_decode(*a, _fn=steps["decode"]):
        t0 = time.perf_counter()
        out = _fn(*a)
        decode_s.append(time.perf_counter() - t0)
        return out

    steps["decode"] = timed_decode
    return steps, decode_s


def serve_paths(params, cfg, paths: dict, label: str) -> tuple[dict, dict]:
    """Serve SERVE_SPEC on each of ``paths`` (path → int8 pages, or None for
    the static dense-cache batches), each with its launch counts reset just
    before and read just after and held to ``serve_launches``; the
    continuous paths then run again through the plain versions and their
    streams are compared. Returns (runs, launches) by path."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch import serve

    pairs = serve.parse_requests(SERVE_SPEC)
    kw = dict(slots=SERVE_SLOTS, page_size=SERVE_PAGE, chunk=SERVE_CHUNK)
    runs, launches = {}, {}
    for path, quantized in paths.items():
        reqs = serve.make_workload(cfg, pairs)
        steps, decode_s = timed_paged_steps(params, cfg)
        gc.collect()  # e.g. the comparison engine's pool: its steps close over it
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        drops = moe_drop_counter(cfg)
        if quantized is None:
            rep = serve.run_static(params, cfg, reqs, batch=SERVE_BATCH)
        else:
            rep = serve.run_continuous(params, cfg, reqs, quantized=quantized, steps=steps,
                                       **kw).to_dict()
        torch.cuda.synchronize()
        launches[path] = kernels.launch_counts()
        rep["n_layers"] = cfg.num_layers
        rep["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        rep["median_decode_step_ms"] = (statistics.median(decode_s) * 1e3 if decode_s
                                        else None)
        if drops is not None:
            rep["moe_dropped_pairs"] = read_moe_drops(drops)
        want = {name: serve_launches(quantized, rep).get(name, 0) for name in kernels.KERNELS}
        require(launches[path] == want, f"{path} launches {launches[path]} != {want}")
        require(rep["n_requests"] == len(pairs) and rep["total_new_tokens"]
                == sum(g for _, g in pairs), f"{path}: {rep}")
        for r, (p, g) in zip(reqs, pairs):
            require(len(r.generated) == g and all(0 <= t < cfg.vocab_size
                                                  for t in r.generated),
                    f"{path}: request {r.rid} stream {r.generated}")
        if quantized is not None:
            got = [r.generated for r in reqs]
            rep["streams"] = got  # the mesh_serve phase holds its bundles to these
            want_streams, margins = plain_streams(params, cfg, pairs,
                                                  dict(kw, quantized=quantized))
            rep["diverged"] = compare_streams(path, got, want_streams,
                                              None if quantized else margins)
        runs[path] = rep
        print(f"{label} serve path {path}: tokens/s {rep['tokens_per_s']:.1f}, first token "
              f"p50 / p99 {rep['first_token_p50_ms']:.1f} / {rep['first_token_p99_ms']:.1f} "
              f"ms, completion p50 / p99 {rep['completion_p50_ms']:.1f} / "
              f"{rep['completion_p99_ms']:.1f} ms, median decode step "
              f"{rep['median_decode_step_ms']} ms, decode_steps {rep.get('decode_steps')}, "
              f"prefill_chunks {rep.get('prefill_chunks')}, peak memory "
              f"{rep['peak_mem_gb']:.2f} GB, MoE dropped pairs "
              f"{rep.get('moe_dropped_pairs')}, launches "
              f"{ {k: v for k, v in launches[path].items() if v} }", flush=True)
        del reqs
        torch.cuda.empty_cache()
    return runs, launches


def moe_drop_counter(cfg):
    """Start counting the (token, k) pairs the MoE capacity drops (a device
    counter in ``moe_ff.drops``), or None for a model without MoE."""
    import torch

    from repro_torch.models import moe

    if cfg.moe is None:
        return None
    moe.moe_ff.drops = torch.zeros((), dtype=torch.long, device=DEVICE)
    return moe.moe_ff.drops


def read_moe_drops(drops) -> int:
    from repro_torch.models import moe

    moe.moe_ff.drops = None
    return int(drops)


def run_serve_paths(report: dict) -> dict:
    """The three serve paths on Qwen1.5-0.5B at full width and depth (f32
    params from ``init_params(SEED)``), and the continuous paths' tokens/s
    over the static path's."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params

    cfg = get_arch("qwen1.5-0.5b").model
    params = init_params(SEED, cfg, device=DEVICE)
    runs, launches = serve_paths(params, cfg, SERVE_PATHS, "qwen1.5-0.5b")
    static = runs["serve_static"]["tokens_per_s"]
    for path in ("serve_continuous", "serve_continuous_q8"):
        runs[path]["tokens_per_s_over_static"] = runs[path]["tokens_per_s"] / static
        print(f"serve {path} / serve_static tokens/s: "
              f"{runs[path]['tokens_per_s_over_static']:.3f}", flush=True)
    report["serve_paths"] = runs
    del params
    torch.cuda.empty_cache()
    return launches


def serve_small_cfg():
    """The 2-layer reduced GQA LM of the small-input serve runs: Qwen1.5-0.5B's
    family at d_model 128 with 2 kv heads for 4 query heads."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import reduced

    return dataclasses.replace(reduced(get_arch("qwen1.5-0.5b").model, layers=2,
                                       d_model=128), num_kv_heads=2)


def check_serve_small_input(report: dict) -> None:
    """Prefix sharing (COW) and an undersized pool (preemption and swap) on a
    reduced GQA LM, f32 and int8 pages: kernels and plain versions give
    identical streams, the pool's audit passes, and the runs shared, split
    and preempted."""
    from repro_torch import kernels
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    cfg = serve_small_cfg()
    params = init_params(SEED, cfg, device=DEVICE)
    out = {}
    for label, (spec, dials) in SERVE_SMALL.items():
        pairs = serve.parse_requests(spec)
        for quantized in (False, True):
            streams, reps = [], []
            for backend in ("auto", "ref"):
                reqs = serve.make_workload(cfg, pairs)
                if label == "share_prefix":  # requests 2, 3 extend / repeat 0's prompt
                    reqs[2].prompt[:reqs[0].prompt_len] = reqs[0].prompt
                    reqs[3].prompt[:] = reqs[0].prompt
                kernels.reset_launch_counts()
                rep = serve.run_continuous(params, cfg, reqs, page_size=4, chunk=8,
                                           quantized=quantized, backend=backend, **dials)
                launched = {k: v for k, v in kernels.launch_counts().items() if v}
                require(bool(launched) == (backend == "auto"),
                        f"small serve {label}: launches {launched} ({backend})")
                streams.append([r.generated for r in reqs])
                reps.append(rep.to_dict())
            key = f"{label}_{'q8' if quantized else 'f32'}"
            require(streams[0] == streams[1], f"small serve {key}: streams differ")
            require(reps[0]["cow_splits"] > 0 if label == "share_prefix"
                    else reps[0]["preemptions"] > 0, f"small serve {key}: {reps[0]}")
            out[key] = {k: reps[0][k] for k in ("decode_steps", "prefill_chunks",
                                                "shared_tokens", "cow_splits",
                                                "preemptions", "swapped_pages")}
            print(f"small input serve {key}: kernels' and plain streams identical, "
                  f"{out[key]}", flush=True)
    report["small_input_serve"] = out


def check_checkpoint_roundtrip(state, report: dict) -> None:
    """A carry-mode MARINA state (params, the packed g, the workers' carry
    h, the step) with its params and h cast to bf16 → ``save_checkpoint``
    → ``load_checkpoint`` into a zeroed state on the card: every leaf
    bit-equal, of its dtype and on the card, the step an int."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.tree_util import tree_map

    def bf16(tree):
        return tree_map(lambda t: t.to(torch.bfloat16), tree)

    state = dataclasses.replace(state, params=bf16(state.params), h=bf16(state.h))
    like = dataclasses.replace(
        state, step=0, g=torch.zeros_like(state.g),
        params=tree_map(torch.zeros_like, state.params),
        h=tree_map(torch.zeros_like, state.h))
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        save_checkpoint(ckdir, state.step, state)
        back = load_checkpoint(ckdir, state.step, like)
    finally:
        shutil.rmtree(ckdir)
    require(back.step == state.step and isinstance(back.step, int),
            f"checkpoint round trip: step {back.step!r}")
    pairs = state_leaf_pairs(state, back)
    require(all(b.dtype == a.dtype and b.device == a.device for a, b in pairs),
            "checkpoint round trip: a leaf changed dtype or device")
    require(states_bit_equal(state, back), "checkpoint round trip: not bit-equal")
    n_bf16 = sum(a.dtype == torch.bfloat16 for a, _ in pairs)
    report["small_input_checkpoint"] = {"leaves": len(pairs), "bf16_leaves": n_bf16}
    print(f"small input checkpoint: a carry state with {n_bf16} bf16 leaves of "
          f"{len(pairs)} round-trips bit for bit on {pairs[0][1].device}", flush=True)


def tensor_leaves(state) -> list:
    """(path, tensor) for every tensor leaf of an optimizer state (params,
    g, h; not the step)."""
    from repro_torch.core.tree_util import tree_flatten_with_path

    return [(p, x) for p, x in tree_flatten_with_path(state)[0] if not isinstance(x, int)]


def state_leaf_pairs(a, b) -> list:
    """The tensor leaves of two optimizer states, paired in path order."""
    la, lb = tensor_leaves(a), tensor_leaves(b)
    require([p for p, _ in la] == [p for p, _ in lb], "states of different structure")
    return [(x, y) for (_, x), (_, y) in zip(la, lb)]


def states_bit_equal(a, b) -> bool:
    """Every tensor leaf (params, g, h) bit-equal (the sign of zero and NaN
    payloads included) and the steps equal."""
    import torch

    def raw(t):
        return t.contiguous().reshape(-1).view(torch.uint8)

    return a.step == b.step and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(raw(x), raw(y))
        for x, y in state_leaf_pairs(a, b))


def state_gb(state) -> float:
    """Bytes of a state's tensor leaves, in GB (a checkpoint's size)."""
    return sum(x.numel() * x.element_size() for _, x in tensor_leaves(state)) / 1e9


def resume_launches(path: str, c_ks) -> dict:
    """What ``path`` launches over rounds with these c_k."""
    out: dict = {}
    for c in c_ks:
        for name, k in ROUND_LAUNCHES[path][c].items():
            out[name] = out.get(name, 0) + k
    return out


def resumed_bits(first_leg_bits: float, rounds: list) -> float:
    """A resumed run's final bits ledger: the first leg's as saved (float32)
    plus the resumed rounds' exact entries."""
    import numpy as np

    return float(np.float32(first_leg_bits)) + sum(rounds)


class _Timed:
    """Wrap ``module.name`` to record each call's seconds; restored on exit."""

    def __init__(self, module, name: str):
        self.module, self.name, self.secs = module, name, []

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def timed(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            self.secs.append(time.perf_counter() - t)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def run_resume(report: dict, path: str = RESUME_PATH) -> dict:
    """Phase 7: U (4 steps), A (2 steps, checkpoint after step 1), B (resume
    to step 4) on ``path`` at full width; see the module docstring."""
    import shutil
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.train import trainer as trainer_mod

    t_phase = time.perf_counter()
    cfg = get_arch("qwen1.5-0.5b").model
    params = init_params(SEED, cfg, device=DEVICE)
    method, compressor, carry, _ = PATHS[path]
    require(resume_launches(path, EXPECTED_C_K) == EXPECTED_LAUNCHES[path],
            "ROUND_LAUNCHES disagrees with EXPECTED_LAUNCHES")
    kw = dict(method=method, compressor=compressor, alpha=RESUME_ALPHA)

    def leg(**dials):
        kernels.reset_launch_counts()
        state, hist = train(cfg, params, carry, **kw, **dials)
        return state, hist, {k: v for k, v in kernels.launch_counts().items() if v}

    s_u, h_u, l_u = leg()
    want_u = resume_launches(path, EXPECTED_C_K)
    require(l_u == want_u, f"resume U: launches {l_u} != {want_u}")
    require(h_u.round_sync == EXPECTED_C_K, f"resume U: c_k {h_u.round_sync}")
    gb = state_gb(s_u)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        free_gb = shutil.disk_usage(ckdir).free / 1e9
        print(f"resume: checkpoint {gb:.3f} GB, {free_gb:.1f} GB free in {ckdir}",
              flush=True)
        require(free_gb >= 2 * gb, f"resume: {free_gb:.1f} GB free, need {2 * gb:.1f}")
        with _Timed(trainer_mod, "save_checkpoint") as saves:
            s_a, h_a, l_a = leg(steps=RESUME_SPLIT, ckpt_dir=ckdir, ckpt_every=RESUME_SPLIT)
        del s_a
        names = sorted(os.listdir(ckdir))
        require(names == [f"ckpt_{RESUME_SPLIT - 1:08d}.npz"], f"resume A wrote {names}")
        file_gb = os.path.getsize(os.path.join(ckdir, names[0])) / 1e9
        with _Timed(trainer_mod, "load_checkpoint") as loads:
            s_b, h_b, l_b = leg(steps=STEPS, ckpt_dir=ckdir, ckpt_every=0)
    finally:
        shutil.rmtree(ckdir)
    want_a = resume_launches(path, EXPECTED_C_K[:RESUME_SPLIT])
    want_b = resume_launches(path, EXPECTED_C_K[RESUME_SPLIT:])
    require(l_a == want_a, f"resume A: launches {l_a} != {want_a}")
    require(l_b == want_b, f"resume B: launches {l_b} != {want_b}")
    require(len(saves.secs) == 1 and len(loads.secs) == 1,
            f"resume: {len(saves.secs)} saves, {len(loads.secs)} loads")
    require(h_b.step[0] == RESUME_SPLIT - 1, f"resume B: started at {h_b.step[0] + 1}")
    require(h_b.round_sync == EXPECTED_C_K[RESUME_SPLIT:], f"resume B: c_k {h_b.round_sync}")
    require(h_b.round_bits == h_u.round_bits[RESUME_SPLIT:], "resume B: round ledger")
    want_bits = resumed_bits(h_a.bits_cum[-1], h_b.round_bits)
    require(h_b.bits_cum[-1] == want_bits,
            f"resume B: bits {h_b.bits_cum[-1]} != {want_bits}")
    require(all(math.isfinite(v) for v in h_b.loss), "resume B: loss not finite")
    require(states_bit_equal(s_u, s_b), "resume: B's params, g, h differ from U's")
    secs = time.perf_counter() - t_phase
    report["resume"] = {
        "path": path, "alpha": RESUME_ALPHA, "state_gb": gb, "file_gb": file_gb,
        "free_gb": free_gb, "save_s": saves.secs[0], "load_s": loads.secs[0],
        "phase_s": secs, "c_k": h_b.round_sync, "bits_cum": h_b.bits_cum,
        "launches": {"U": l_u, "A": l_a, "B": l_b}, "loss_u": h_u.loss, "loss_b": h_b.loss}
    print(f"resume: save {saves.secs[0]:.2f} s, load {loads.secs[0]:.2f} s, "
          f"file {file_gb:.3f} GB", flush=True)
    print(f"resume {path} (alpha {RESUME_ALPHA}): B resumed at step {RESUME_SPLIT}, "
          f"its state (params, g, h) bit-equal to U's; c_k {h_b.round_sync}, bits "
          f"{h_b.bits_cum[-1]}, launches B {l_b}; phase {secs:.1f} s", flush=True)
    del s_u, s_b, params
    torch.cuda.empty_cache()
    return {"resume": {name: l_b.get(name, 0) for name in kernels.KERNELS}}


def run_main_path(report: dict) -> dict:
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, param_count

    cfg = get_arch("qwen1.5-0.5b").model
    params = init_params(SEED, cfg, device=DEVICE)
    d = param_count(params)
    nblk = math.ceil(d / BLOCK)
    runs, launches = {}, {}
    for path, (method, compressor, carry, downlink) in PATHS.items():
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        state, hist = train(cfg, params, carry, steps=MAIN_STEPS, method=method,
                            compressor=compressor, downlink=downlink,
                            mb_per_worker=MB_PER_WORKER, **ROBUST.get(path, {}))
        launches[path] = kernels.launch_counts()
        want = {name: MAIN_LAUNCHES[path].get(name, 0) for name in kernels.KERNELS}
        require(launches[path] == want,
                f"{path} launches {launches[path]} != {want}")
        require(hist.round_sync == MAIN_C_K,
                f"{path}: c_k {hist.round_sync} != {MAIN_C_K}")
        require(all(math.isfinite(v) for v in hist.loss), f"{path}: loss not finite")
        require(hist.skipped_cum[-1] == 0.0, f"{path}: a round was skipped")
        for c_k, bits, down in zip(hist.round_sync, hist.round_bits,
                                   hist.round_down_bits):
            want_bits = expected_bits(method, compressor, c_k, d, nblk)
            require(bits == want_bits, f"{path}: ledger {bits} != {want_bits}")
            want_down = expected_down_bits(downlink, c_k, d, nblk)
            require(down == want_down, f"{path}: down ledger {down} != {want_down}")
        require(hist.bits_cum[-1] == sum(hist.round_bits), f"{path}: ledger sum")
        require(hist.down_cum[-1] == sum(hist.round_down_bits), f"{path}: down ledger sum")
        by_type = {}
        for c_k, sec in zip(hist.round_sync, hist.step_seconds):
            by_type.setdefault("sync" if c_k else "compressed", []).append(sec)
        runs[path] = {
            "loss": hist.loss, "c_k": hist.round_sync, "round_bits": hist.round_bits,
            "round_down_bits": hist.round_down_bits,
            "step_seconds": hist.step_seconds, "launches": launches[path],
            "median_step_s": {k: statistics.median(v) for k, v in by_type.items()},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        print(f"main path {path}: loss {hist.loss}, c_k {hist.round_sync}, "
              f"launches {launches[path]}, median s/step {runs[path]['median_step_s']}, "
              f"peak memory {runs[path]['peak_mem_gb']:.2f} GB", flush=True)
        del state, hist
        torch.cuda.empty_cache()
    report["main_path"] = {"d": d, "nblk": nblk, "runs": runs}
    print(f"main paths: d={d}, nblk={nblk}", flush=True)
    profile_step(cfg, params, report)
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the attention and MoE families
# ---------------------------------------------------------------------------


def check_families_small_input(report: dict, families: dict | None = None,
                               key: str = "small_input_families") -> None:
    """``families`` (arch → layers; SMALL_FAMILIES by default) reduced to
    d_model 64 through the trainer, MARINA × block_randk carry, 4 steps,
    through the kernels and through their plain versions: the launches of
    ``EXPECTED_LAUNCHES["marina_randk_carry"]`` exactly, c_k, equal ledgers
    and agreeing trajectories; the runs go to ``report[key]``."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.models import init_params, reduced

    out = {}
    want = EXPECTED_LAUNCHES["marina_randk_carry"]
    for name, layers in (SMALL_FAMILIES if families is None else families).items():
        cfg = reduced(get_arch(name).model, layers=layers, d_model=64)
        params = init_params(SEED, cfg, device=DEVICE)
        kw = dict(carry=True, batch_per_worker=2)
        kernels.reset_launch_counts()
        s_k, h_k = train(cfg, params, **kw)
        launched = {k: v for k, v in kernels.launch_counts().items() if v}
        s_r, h_r = train(cfg, params, backend="ref", **kw)
        require(launched == want, f"small input {name}: launches {launched} != {want}")
        require(h_k.round_sync == h_r.round_sync == EXPECTED_C_K,
                f"small input {name}: c_k {h_k.round_sync}")
        require(h_k.round_bits == h_r.round_bits, f"small input {name}: ledgers differ")
        require(all(math.isfinite(v) for v in h_k.loss) and h_k.skipped_cum[-1] == 0.0,
                f"small input {name}: loss {h_k.loss}")
        worst = 0.0
        for a, b in zip(tree_leaves(s_k.params), tree_leaves(s_r.params)):
            require(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
                    f"small input {name}: kernels and plain versions diverge")
            worst = max(worst, float((a - b).abs().max()))
        out[name] = {"layers": layers, "loss": h_k.loss, "launches": launched,
                     "max_abs_param_diff": worst}
        print(f"small input family {name} ({layers} layers, d_model 64): loss {h_k.loss}, "
              f"launches {launched}, max |Δparams| {worst:.3e}", flush=True)
    report[key] = out


def family_cfg(name: str):
    """The full-width config of ``name`` cut to FAMILY_REPEATS' depth, with
    its MTP head off (it does not serve), and the list of cuts."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import Segment

    cfg = get_arch(name).model
    keep = FAMILY_REPEATS[name]
    segs = tuple(Segment(period=seg.period, repeat=r) for seg, r in zip(cfg.segments, keep))
    cut = dataclasses.replace(cfg, segments=segs, mtp_depth=0)
    reduced = [f"layers {cfg.num_layers} -> {cut.num_layers} (segment repeats "
               f"{[seg.repeat for seg in cfg.segments]} -> {list(keep)})"]
    if cfg.mtp_depth:
        reduced.append(f"mtp_depth {cfg.mtp_depth} -> 0 (the MTP head does not serve; "
                       "tests/test_torch_families.py holds it)")
    return cut, reduced


def depth_cut(cfg, layers: int):
    """``cfg`` at full width with its first ``layers`` layers (whole periods
    of its segments, in order), and the cut as a line of ``reduced``."""
    import dataclasses

    segs, left = [], layers
    for seg in cfg.segments:
        if left <= 0:
            break
        rep = min(seg.repeat, left // len(seg.period))
        require(rep * len(seg.period) == min(left, seg.num_layers),
                f"{cfg.name}: {layers} layers are not whole periods")
        segs.append(dataclasses.replace(seg, repeat=rep))
        left -= rep * len(seg.period)
    cut = dataclasses.replace(cfg, segments=tuple(segs))
    return cut, f"layers {cfg.num_layers} -> {cut.num_layers} (depth only, full width)"


def teacher_forced_check(params, cfg, reqs, rtol: float = FAMILY_LOGIT_RTOL,
                         served: bool = True) -> dict:
    """Each request's prompt prefilled and its first FAMILY_TEACHER_STEPS
    generated tokens fed to ``decode_step``: every step's logits against a
    teacher-forced ``forward`` over the prompt and those tokens (as many
    requests at a time as keep the logits within TEACHER_LOGIT_BYTES),
    |Δ| ≤ ``rtol`` · max |forward logit| per row; with
    ``served`` the served stream's next tokens are the decode logits' argmax
    (up to a top-2 margin below SERVE_TIE_MARGIN). An MoE drops no pair in
    decode (each expert's capacity, at least 8, holds the batch's tokens),
    so the forward runs with the capacity of every token (a capacity factor
    of E / top_k): with the served one it would drop pairs the decode
    keeps. All prompts have one length (no padding)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import decode_step, forward, prefill

    n = FAMILY_TEACHER_STEPS
    dev = params["embed"].device
    prompts = torch.as_tensor(np.stack([r.prompt for r in reqs]), device=dev)
    gen = torch.as_tensor([r.generated[:n + 1] for r in reqs], device=dev)
    P = prompts.shape[1]
    tf_cfg = cfg if cfg.moe is None else dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    worst, ties = 0.0, 0
    with torch.inference_mode():
        _, cache = prefill(params, cfg, prompts, max_len=P + n)
        drops = moe_drop_counter(cfg)
        dec = []
        for i in range(n):
            lg, cache = decode_step(params, cfg, cache, gen[:, i], P + i)
            dec.append(lg)
        require(drops is None or read_moe_drops(drops) == 0, "a decode step dropped pairs")
        del cache
        group = max(1, int(TEACHER_LOGIT_BYTES // (
            (P + n) * cfg.vocab_size * params["embed"].element_size())))
        for b0 in range(0, len(reqs), group):
            seq = torch.cat([prompts[b0:b0 + group], gen[b0:b0 + group, :n]], dim=1)
            full = forward(params, tf_cfg, seq)[0][:, P:].double()
            for b in range(b0, b0 + len(seq)):
                for i, lg in enumerate(dec):
                    want = full[b - b0, i]
                    err = float((lg[b].double() - want).abs().max() / want.abs().max())
                    worst = max(worst, err)
                    top = torch.topk(lg[b].float(), 2).values
                    same = int(torch.argmax(lg[b])) == int(gen[b, i + 1])
                    require(not served or same or float(top[0] - top[1]) < SERVE_TIE_MARGIN,
                            f"teacher-forced step {i}: the served token is not the decode "
                            "argmax")
                    ties += not same
            del full
        del dec
    require(worst <= rtol,
            f"decode logits {worst} of the row's scale from the teacher-forced forward")
    return {"steps": n, "max_rel_logit_err": worst, "bound": rtol,
            "dtype": str(params["embed"].dtype), "near_tie_tokens": ties}


def profile_moe_decode(params, cfg) -> dict:
    """Where an MoE paged decode step spends its time, at SERVE_SLOTS slots
    of FAMILY_PROFILE_LEN cached positions (f32 pages): the step on the host
    clock (median of 5, each ending in a synchronize); its device time by
    kernel (``device_kernel_ms``), split into the paged kernel, GEMMs
    (``gemm`` in the name: the experts' batched products, the attention,
    shared-expert and unembedding products) and the rest; the MoE FF of one
    layer on the step's input (device ms, × layers); and the expert
    weights' byte bound (every expert is read: the capacity buffer runs all
    of them)."""
    import torch

    from repro_torch.models import init_paged_cache, moe, paged_decode_step
    from repro_torch.models.model import _slice

    S, Pg, L = SERVE_SLOTS, SERVE_PAGE, FAMILY_PROFILE_LEN
    maxp = -(-(L + 1) // Pg)
    dev = params["embed"].device
    cache = init_paged_cache(cfg, 1 + S * maxp, Pg, device=dev)
    tables = (1 + torch.arange(S * maxp, device=dev, dtype=torch.int32)).reshape(S, maxp)
    lengths = torch.full((S,), L, dtype=torch.int32, device=dev)
    toks = torch.arange(S, device=dev)

    def step():
        with torch.inference_mode():
            return paged_decode_step(params, cfg, cache, toks, lengths, tables)

    host = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    by_kernel = device_kernel_ms(step)
    paged_ms = sum(v for k, v in by_kernel.items() if "paged_attn_decode" in k)
    gemm_ms = sum(v for k, v in by_kernel.items() if "gemm" in k.lower())
    ff = _slice(params["segments"][0][0], 0)["ff"]
    x = torch.randn((S, 1, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 23))
    with torch.inference_mode():
        moe_ms = device_ms(lambda: moe.moe_ff(ff, cfg, x), 5)
    m, layers = cfg.moe, cfg.num_layers
    expert_bytes = 3.0 * m.num_experts * cfg.d_model * m.d_expert * 4 * layers
    del cache
    return {"slots": S, "cached": L, "layers": layers,
            "step_host_ms": statistics.median(host[2:]),
            "step_device_ms": sum(by_kernel.values()), "paged_device_ms": paged_ms,
            "gemm_device_ms": gemm_ms,
            "other_device_ms": sum(by_kernel.values()) - paged_ms - gemm_ms,
            "moe_device_ms": None if moe_ms is None else layers * moe_ms,
            "expert_bytes_bound_ms": expert_bytes / HBM_BYTES_PER_S * 1e3,
            "top": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]}


def static_leg(params, cfg, spec: str, batch: int, label: str,
               rtol: float = FAMILY_LOGIT_RTOL) -> tuple[dict, list]:
    """``run_static`` on ``spec`` in batches of ``batch``: no kernel
    launched (the static caches are plain PyTorch), every request served in
    full, then FAMILY_TEACHER_STEPS decode steps against a teacher-forced
    ``forward`` within ``rtol``. Returns the ServeReport with the MoE drops
    and the teacher-forced check, and the requests."""
    from repro_torch import kernels
    from repro_torch.launch import serve

    pairs = serve.parse_requests(spec)
    reqs = serve.make_workload(cfg, pairs)
    kernels.reset_launch_counts()
    drops = moe_drop_counter(cfg)
    rep = serve.run_static(params, cfg, reqs, batch=batch)
    if drops is not None:
        rep["moe_dropped_pairs"] = read_moe_drops(drops)
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    require(not launched, f"{label}: the static path launched {launched}")
    require(rep["total_new_tokens"] == sum(g for _, g in pairs) and all(
        len(r.generated) == g and all(0 <= t < cfg.vocab_size for t in r.generated)
        for r, (_, g) in zip(reqs, pairs)), f"{label}: {rep}")
    rep["teacher_forced"] = teacher_forced_check(params, cfg, reqs, rtol)
    print(f"{label} static {spec} (batch {batch}): tokens/s "
          f"{rep['tokens_per_s']:.1f}, first token p50 / p99 "
          f"{rep['first_token_p50_ms']:.1f} / {rep['first_token_p99_ms']:.1f} ms, "
          f"completion p50 / p99 {rep['completion_p50_ms']:.1f} / "
          f"{rep['completion_p99_ms']:.1f} ms, MoE dropped pairs "
          f"{rep.get('moe_dropped_pairs')}, teacher-forced "
          f"{rep['teacher_forced']}", flush=True)
    return rep, reqs


def run_families(report: dict) -> dict:
    """The attention and MoE families at full width (random f32 init from
    SEED), each leg's parameters freed before the next: Llama-4-Scout served
    continuously on f32 and int8 pages (FAMILY_SERVE_PATHS, launches exact,
    streams against the plain versions), then gemma3 and DeepSeek-V3
    served statically (FAMILY_STATIC) with FAMILY_TEACHER_STEPS decode steps
    against a teacher-forced forward. Peak memory and seconds per leg; the
    phase must take at most FAMILY_BUDGET_S."""
    import torch

    from repro_torch.models import init_params, param_count

    t_phase = time.perf_counter()
    out, launches = {}, {}
    for name in FAMILY_REPEATS:
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, cuts = family_cfg(name)
        params = init_params(SEED, cfg, device=DEVICE)
        torch.cuda.synchronize()
        leg = {"reduced": cuts, "params_b": param_count(params) / 1e9,
               "init_s": time.perf_counter() - t0}
        print(f"families {name}: {leg['params_b']:.2f} B parameters (f32), cuts {cuts}, "
              f"init {leg['init_s']:.1f} s", flush=True)
        if name in FAMILY_STATIC:
            leg["serve_static"] = static_leg(params, cfg, *FAMILY_STATIC[name],
                                             f"families {name}")[0]
        else:
            runs, by_path = serve_paths(params, cfg, FAMILY_SERVE_PATHS, name)
            leg.update(runs)
            launches.update(by_path)
            leg["decode_profile"] = prof = profile_moe_decode(params, cfg)
            print(f"families {name} decode step at {prof['slots']} slots × "
                  f"{prof['cached']} positions: host {prof['step_host_ms']:.2f} ms, "
                  f"device {prof['step_device_ms']:.3f} ms (GEMMs "
                  f"{prof['gemm_device_ms']:.3f}, paged attention "
                  f"{prof['paged_device_ms']:.4f}, other {prof['other_device_ms']:.3f}); "
                  f"the MoE FF of {prof['layers']} layers alone {prof['moe_device_ms']} ms "
                  f"(expert bytes bound {prof['expert_bytes_bound_ms']:.2f}); top "
                  f"{prof['top']}", flush=True)
        leg["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params
        gc.collect()
        torch.cuda.empty_cache()
        leg["seconds"] = time.perf_counter() - t0
        out[name] = leg
        print(f"families {name}: peak memory {leg['peak_mem_gb']:.2f} GB, "
              f"{leg['seconds']:.1f} s", flush=True)
    secs = time.perf_counter() - t_phase
    report["families"] = dict(out, seconds=secs)
    print(f"families phase: {secs:.1f} s (budget {FAMILY_BUDGET_S:.0f})", flush=True)
    require(secs <= FAMILY_BUDGET_S, f"families phase took {secs:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# the recurrent families and sampling at a temperature
# ---------------------------------------------------------------------------


def state_bytes(cfg, B: int) -> dict:
    """The decode state's bytes (``init_cache`` on the meta device) at each
    of RECURRENT_STATE_LENS."""
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.models import init_cache

    return {L: sum(t.numel() * t.element_size() for t in tree_leaves(
        init_cache(cfg, B, L, device="meta"))) for L in RECURRENT_STATE_LENS}


def run_recurrent_train(cfg, params) -> tuple[dict, dict]:
    """RECURRENT_TRAIN_ARCH through the trainer at full width on the MARINA
    × block_randk carry path (n = 4, 8 × 256 tokens per worker, MAIN_STEPS
    steps): launches exactly ``MAIN_LAUNCHES["marina_randk_carry"]``, c_k, the
    up and down ledgers, finite losses; then the same steps through the
    plain versions (``backend="ref"``), parameters within rtol 1e-5 / atol
    1e-6. Returns (the run, its launches)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.models import param_count

    d = param_count(params)
    nblk = math.ceil(d / BLOCK)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    state, hist = train(cfg, params, True, steps=MAIN_STEPS)
    launched = kernels.launch_counts()
    want = {name: MAIN_LAUNCHES["marina_randk_carry"].get(name, 0)
            for name in kernels.KERNELS}
    require(launched == want, f"{RECURRENT_TRAIN_PATH} launches {launched} != {want}")
    require(hist.round_sync == MAIN_C_K, f"{RECURRENT_TRAIN_PATH}: c_k {hist.round_sync}")
    require(all(math.isfinite(v) for v in hist.loss) and hist.skipped_cum[-1] == 0.0,
            f"{RECURRENT_TRAIN_PATH}: loss {hist.loss}")
    for c_k, bits, down in zip(hist.round_sync, hist.round_bits, hist.round_down_bits):
        require(bits == expected_bits("marina", "block_randk", c_k, d, nblk),
                f"{RECURRENT_TRAIN_PATH}: ledger {bits}")
        require(down == expected_down_bits(None, c_k, d, nblk),
                f"{RECURRENT_TRAIN_PATH}: down ledger {down}")
    require(hist.bits_cum[-1] == sum(hist.round_bits), f"{RECURRENT_TRAIN_PATH}: ledger sum")
    peak = torch.cuda.max_memory_allocated() / 1e9
    kept = [t.clone() for t in tree_leaves(state.params)]
    del state
    gc.collect()
    torch.cuda.empty_cache()
    s_r, h_r = train(cfg, params, True, backend="ref", steps=MAIN_STEPS)
    require(h_r.round_sync == hist.round_sync and h_r.round_bits == hist.round_bits,
            f"{RECURRENT_TRAIN_PATH}: the plain run's c_k or ledger differ")
    worst = 0.0
    for a, b in zip(kept, tree_leaves(s_r.params)):
        require(torch.allclose(a, b, rtol=1e-5, atol=1e-6),
                f"{RECURRENT_TRAIN_PATH}: kernels and plain versions diverge")
        worst = max(worst, float((a - b).abs().max()))
    del s_r, kept
    by_type = {}
    for c_k, sec in zip(hist.round_sync, hist.step_seconds):
        by_type.setdefault("sync" if c_k else "compressed", []).append(sec)
    run = {"d": d, "nblk": nblk, "loss": hist.loss, "c_k": hist.round_sync,
           "round_bits": hist.round_bits, "step_seconds": hist.step_seconds,
           "median_step_s": {k: statistics.median(v) for k, v in by_type.items()},
           "plain_step_seconds": h_r.step_seconds, "launches": launched,
           "max_abs_param_diff": worst, "peak_mem_gb": peak}
    print(f"recurrent {RECURRENT_TRAIN_PATH}: d={d}, loss {hist.loss}, c_k "
          f"{hist.round_sync}, launches { {k: v for k, v in launched.items() if v} }, "
          f"median s/step {run['median_step_s']}, plain run s/step {h_r.step_seconds}, "
          f"max |Δparams| against the plain run {worst:.3e}, peak memory {peak:.2f} GB",
          flush=True)
    return run, {RECURRENT_TRAIN_PATH: launched}


def check_gumbel_draws(vocab: int) -> dict:
    """One decode step's draw at SERVE_SLOTS × vocab under the first key
    the engine would split: the device's uniforms (``minval`` = tiny) bit
    for bit the host path's, the device's Gumbel values within GUMBEL_ULPS
    units of ulp(max(|g|, 1)) of the host path's."""
    import numpy as np

    from repro_torch import prng

    key = prng.split(prng.PRNGKey(SAMPLE_SEED))[1]
    shape = (SERVE_SLOTS, vocab)
    u_dev = prng.uniform(key, shape, prng.TINY, 1.0, device=DEVICE).cpu().numpy()
    u_host = prng.uniform(key, shape, prng.TINY, 1.0)
    require(np.array_equal(u_dev.view(np.int32), u_host.view(np.int32)),
            "the device's Gumbel uniforms differ from the host path's")
    g_dev = prng.gumbel(key, shape, device=DEVICE).cpu().numpy()
    g_host = prng.gumbel(key, shape)
    unit = np.spacing(np.maximum(np.abs(g_host), np.float32(1))).astype(np.float64)
    units = float(np.max(np.abs(g_dev.astype(np.float64) - g_host) / unit))
    require(units <= GUMBEL_ULPS, f"device Gumbel values {units} units from the host's")
    out = {"shape": list(shape), "uniform_bit_equal": True, "gumbel_max_units": units,
           "gumbel_bit_equal": bool(np.array_equal(g_dev.view(np.int32),
                                                   g_host.view(np.int32)))}
    print(f"sampling: one step's draw {shape}: device uniforms bit-equal to the host's, "
          f"Gumbel values within {units} units of the host's "
          f"(bit-equal: {out['gumbel_bit_equal']})", flush=True)
    return out


def run_sampled_serve(report: dict) -> dict:
    """SERVE_SPEC on Qwen1.5-0.5B at SAMPLE_TEMPERATURE under SAMPLE_SEED on
    each path of SAMPLE_PATHS, the continuous path twice with identical
    streams; its launches held to ``serve_launches`` and its streams to the plain
    versions' (equal but after a token whose perturbed top-2 margin in the
    plain run is below SERVE_TIE_MARGIN: counted); the static path launches
    nothing. Returns the continuous path's launches."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch("qwen1.5-0.5b").model
    params = init_params(SEED, cfg, device=DEVICE)
    pairs = serve.parse_requests(SERVE_SPEC)
    kw = dict(slots=SERVE_SLOTS, page_size=SERVE_PAGE, chunk=SERVE_CHUNK)
    runs, launches = {}, {}
    for path, quantized in SAMPLE_PATHS.items():
        streams = []
        for rerun in range(2 if quantized is not None else 1):
            reqs = serve.make_workload(cfg, pairs)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            if quantized is None:
                rep = serve.run_static(params, cfg, reqs, batch=SERVE_BATCH,
                                       temperature=SAMPLE_TEMPERATURE, seed=SAMPLE_SEED)
            else:
                rep = serve.run_continuous(params, cfg, reqs, quantized=quantized,
                                           temperature=SAMPLE_TEMPERATURE,
                                           seed=SAMPLE_SEED, **kw).to_dict()
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            rep["n_layers"] = cfg.num_layers
            want = {k: serve_launches(quantized, rep).get(k, 0) for k in kernels.KERNELS}
            require(counts == want, f"{path} launches {counts} != {want}")
            require(all(len(r.generated) == g and all(0 <= t < cfg.vocab_size
                                                       for t in r.generated)
                        for r, (_, g) in zip(reqs, pairs)), f"{path}: {rep}")
            streams.append([r.generated for r in reqs])
            if rerun == 0:
                launches[path] = counts
                runs[path] = rep
        require(streams[0] == streams[-1], f"{path}: two runs under one seed differ")
        rep = runs[path]
        if quantized is not None:
            want_streams, margins = plain_streams(
                params, cfg, pairs, dict(kw, quantized=quantized),
                temperature=SAMPLE_TEMPERATURE, seed=SAMPLE_SEED)
            rep["diverged"] = compare_streams(path, streams[0], want_streams, margins)
        print(f"sampling {path} (T = {SAMPLE_TEMPERATURE}, seed {SAMPLE_SEED}): tokens/s "
              f"{rep['tokens_per_s']:.1f}, first token p50 / p99 "
              f"{rep['first_token_p50_ms']:.1f} / {rep['first_token_p99_ms']:.1f} ms, "
              f"completion p50 / p99 {rep['completion_p50_ms']:.1f} / "
              f"{rep['completion_p99_ms']:.1f} ms, runs {len(streams)} (identical), near-tie "
              f"divergences from the plain run {len(rep.get('diverged', []))}, launches "
              f"{ {k: v for k, v in launches[path].items() if v} }", flush=True)
    runs["gumbel"] = check_gumbel_draws(cfg.vocab_size)
    runs["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["sampling"] = runs
    del params
    gc.collect()
    torch.cuda.empty_cache()
    runs["seconds"] = time.perf_counter() - t0
    print(f"sampling: peak memory {runs['peak_mem_gb']:.2f} GB, {runs['seconds']:.1f} s, "
          "no cuts (Qwen1.5-0.5B at full width and depth)", flush=True)
    return {k: v for k, v in launches.items() if any(v.values())}


def run_recurrent(report: dict) -> dict:
    """The recurrent families at full width and depth (random f32 init from
    SEED), each leg's parameters freed before the next: recurrentgemma-2b
    and xlstm-350m served statically (RECURRENT_STATIC) with
    FAMILY_TEACHER_STEPS decode steps against a teacher-forced forward, the
    xLSTM decode state's bytes equal at RECURRENT_STATE_LENS, xlstm-350m
    trained (``run_recurrent_train``); sampling at a temperature
    (``run_sampled_serve``). Seconds, peak memory and cuts per leg; the phase
    must take at most RECURRENT_BUDGET_S. (The reduced recurrent families,
    SMALL_RECURRENT, go through the trainer in the small-input phase.)"""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.tree_util import tree_map
    from repro_torch.models import init_params, param_count

    t_phase = time.perf_counter()
    out, launches = {}, {}
    for name, (spec, batch) in RECURRENT_STATIC.items():
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, cuts = get_arch(name).model, []
        if cfg.num_layers > RECURRENT_DEPTH.get(name, cfg.num_layers):
            cfg, cut = depth_cut(cfg, RECURRENT_DEPTH[name])
            cuts.append(cut)
        params = init_params(SEED, cfg, device=DEVICE)
        torch.cuda.synchronize()
        leg = {"reduced": cuts, "layers": cfg.num_layers,
               "params_b": param_count(params) / 1e9, "init_s": time.perf_counter() - t0}
        print(f"recurrent {name}: {leg['params_b']:.3f} B parameters (f32), "
              f"{cfg.num_layers} layers, cuts {cuts or 'none'}, init {leg['init_s']:.1f} s",
              flush=True)
        leg["serve_static"], reqs = static_leg(params, cfg, spec, batch,
                                               f"recurrent {name}",
                                               RECURRENT_F32_RTOL.get(name, FAMILY_LOGIT_RTOL))
        if name in RECURRENT_F32_RTOL:  # the same steps in float64: the hand-off is exact
            p64 = tree_map(lambda t: t.double(), params)
            leg["teacher_forced_f64"] = tf = teacher_forced_check(p64, cfg, reqs, served=False)
            print(f"recurrent {name}: teacher-forced in float64 {tf}", flush=True)
            del p64
        del reqs
        if name == "xlstm-350m":
            leg["state_bytes"] = sb = state_bytes(cfg, batch)
            require(len(set(sb.values())) == 1, f"xLSTM decode state grows: {sb}")
            print(f"recurrent {name}: decode state {sb} bytes at batch {batch}", flush=True)
        leg["serve_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if name == RECURRENT_TRAIN_ARCH:
            t1 = time.perf_counter()
            leg["train"], by_path = run_recurrent_train(cfg, params)
            leg["train"]["seconds"] = time.perf_counter() - t1
            launches.update(by_path)
        leg["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params
        gc.collect()
        torch.cuda.empty_cache()
        leg["seconds"] = time.perf_counter() - t0
        out[name] = leg
        print(f"recurrent {name}: peak memory {leg['peak_mem_gb']:.2f} GB, "
              f"{leg['seconds']:.1f} s", flush=True)
    launches.update(run_sampled_serve(out))
    secs = time.perf_counter() - t_phase
    report["recurrent"] = dict(out, seconds=secs)
    print(f"recurrent phase: {secs:.1f} s (budget {RECURRENT_BUDGET_S:.0f})", flush=True)
    require(secs <= RECURRENT_BUDGET_S, f"recurrent phase took {secs:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# the launch layer: per-leaf widths, and the worker axis on an nccl group
# ---------------------------------------------------------------------------


def check_transport_widths(card: str, report: dict, rows: dict) -> None:
    """``scatter_accum`` and ``randk_gather`` at the transport's per-leaf
    widths (``TRANSPORT_WIDTHS``), on offsets drawn as the transport draws
    them (``prng.randint`` over [0, L)): both bit-equal to their plain
    versions; at Qwen1.5-0.5B's MLP leaf both timed against their bounds
    (the kernel line's ``transport``)."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels import randk, ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    out = {}
    for label, (n, R, L, kb) in TRANSPORT_WIDTHS.items():
        o = prng.randint(prng.PRNGKey(SEED + 11), (n, R, kb), 0, L, device=dev)
        v = torch.randn((n, R, kb), generator=gen, device=dev)
        s, sr = randk.scatter_accum(v, o, L), ref.scatter_accum_ref(v, o, L)
        require(bits_equal(s, sr), f"scatter_accum at L={L}: not bit-equal")
        del s, sr
        x = torch.randn((n * R, L), generator=gen, device=dev)
        o2 = o.reshape(n * R, kb)
        gv, gr = randk.randk_gather(x, o2, L / kb), ref.randk_block_compress_ref(x, o2, L / kb)
        require(bits_equal(gv, gr), f"randk_gather at L={L}: not bit-equal")
        del gv, gr
        out[label] = {"shape": [n, R, L, kb], "bit_equal": True}
        print(f"transport width {label} (n={n}, R={R}, L={L}, kb={kb}): scatter_accum and "
              f"randk_gather bit-equal to their plain versions", flush=True)
        if label == "qwen_mlp":
            kern, plain, lib, nbytes, flops = scatter_accum_cell(v, o, L)
            b_ms, b_by = bound(nbytes, flops)
            rows["scatter_accum"]["transport"] = t = {
                **times(kern, plain, lib), "bound_ms": b_ms, "bound_by": b_by,
                "max_abs_err": 0.0, "bytes": nbytes, "shape": [n, R, L, kb]}
            print(f"time scatter_accum at {label}: {times_text(t)}, bound {b_ms:.4f} ms "
                  f"({b_by}) on {card}", flush=True)
            print_target("scatter_accum", label, t, card)
            gbytes = n * R * kb * (4 + 4 + 4)  # offsets and sampled x read, values written
            b_ms, b_by = bound(gbytes, n * R * kb)
            o64 = o2.long()  # the library call's int64 offsets, converted beforehand
            rows["randk_gather"]["transport"] = t = {
                **times(lambda: randk.randk_gather(x, o2, L / kb),
                        lambda: ref.randk_block_compress_ref(x, o2, L / kb),
                        lambda: torch.gather(x, 1, o64)),
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0, "bytes": gbytes,
                "shape": [n * R, L, kb]}
            print(f"time randk_gather at {label}: {times_text(t)}, bound {b_ms:.4f} ms "
                  f"({b_by}) on {card}", flush=True)
            t.update(transport_gather_floor(x, o2, kb, label, card))
            del kern, plain, lib, o64
        del x, o, o2, v
        torch.cuda.empty_cache()
    report["transport_widths"] = out


def transport_gather_floor(x, o2, kb: int, label: str, card: str) -> dict:
    """Row 10 (``randk_gather``) at the transport's shape against a bare
    gather: the gather yardstick on the same (rows, L) f32 buffer and kb
    (checked against its plain version, timed over ``yardstick.SWEEP``) and
    the 32- / 64-byte sector floors of the kernel's own offsets (``o2``: 4
    bytes of offset read and 4 of value written a gathered value). Prints
    the kernel's back-to-back time over the yardstick's, a redesign due
    above ``TRANSPORT_GATHER_RULE2``."""
    import torch

    from repro_torch.kernels import randk, yardstick

    v, o = yardstick.gather(x, kb)
    vr, orf = yardstick.gather_ref(x, kb)
    require(bits_equal(v, vr) and torch.equal(o, orf),
            f"gather yardstick at {label}: differs from its plain version")
    del v, o, vr, orf
    out = {**sweep_floor(lambda u, t: lambda: yardstick.gather(x, kb, u, t)),
           **sector_floors(o2, 8)}
    L = x.shape[1]
    b2b = back_to_back_ms(lambda: randk.randk_gather(x, o2, L / kb))
    out["kernel_b2b_ms"] = b2b
    out["over_yardstick"] = ratio = b2b / out["gather_floor_ms"]
    print(f"gather yardstick randk_gather ({label}: {x.shape[0]} rows of {L}, kb={kb}): "
          f"{out['gather_floor_ms']:.4f} ms (fastest of {json.dumps(out['sweep_b2b_ms'])}), "
          f"32-byte sector floor {out['sector_floor_ms']:.4f}, 64-byte "
          f"{out['segment_floor_ms']:.4f} ms; kernel back-to-back {b2b:.4f} ms = "
          f"{ratio:.3f}× the yardstick's on {card}", flush=True)
    print(f"rule 2 randk_gather at {label}: {ratio:.3f}× the gather yardstick (a redesign "
          f"above {TRANSPORT_GATHER_RULE2:.1f}×: "
          f"{'due' if ratio > TRANSPORT_GATHER_RULE2 else 'not due'}), "
          f"{b2b / out['sector_floor_ms']:.3f}× its 32-byte sector floor on {card}", flush=True)
    return {"yardstick": out}


def ml_up_bits(params) -> float:
    """The ml path's compressed uplink per worker, from the leaf shapes: Σ
    R·kb·64 (kb = max(1, L // 128) f32 values and int32 offsets a row)."""
    from repro_torch.core.tree_util import tree_leaves

    total = 0
    for t in tree_leaves(params):
        L = t.shape[-1]
        total += (t.numel() // L) * max(1, L // 128) * 64
    return float(total)


@contextlib.contextmanager
def timed_exchanges(transport, secs: dict):
    """Record the seconds of each ``sync_mean``, ``uplink_mean`` and
    ``downlink`` call of ``transport`` into ``secs`` (lists by name), the
    device synchronized before and after each call."""
    names = ("sync_mean", "uplink_mean", "downlink")
    for name in names:
        fn = getattr(transport, name)

        def timed(*a, _fn=fn, _name=name, **k):
            _sync()
            t = time.perf_counter()
            out = _fn(*a, **k)
            _sync()
            secs.setdefault(_name, []).append(time.perf_counter() - t)
            return out

        setattr(transport, name, timed)
    try:
        yield
    finally:
        for name in names:
            delattr(transport, name)


def launch_rounds(fns: dict, state: tuple, batch: dict, compressed: int, mesh, sels=None,
                  key0: int = SEED + 20) -> tuple:
    """One untimed ``sync_step`` from ``state`` (it warms the backprop and
    the group; its output is dropped), then from ``state`` one timed
    ``sync_step`` and ``compressed`` ``compressed_step``s (keys
    ``PRNGKey(key0 + i)``; cohort ``sels[i]`` under PP), each timed on the
    host clock ending in a synchronize; launches and the bytes the mesh's
    collectives carried counted by round. Returns (state, seconds by round
    type, launches by round, payload bytes by round)."""
    from repro_torch import kernels, prng

    warm = fns["sync_step"](*state, batch)
    _sync()
    del warm
    gc.collect()
    mesh.reset_counts()
    secs, per_round, wire = {"sync": [], "compressed": []}, [], []
    for i in range(compressed + 1):
        kernels.reset_launch_counts()
        before = dict(mesh.payload_bytes)
        t0 = time.perf_counter()
        if i == 0:
            state = fns["sync_step"](*state, batch)
        else:
            extra = () if sels is None else (sels[i - 1],)
            state = fns["compressed_step"](*state, batch, prng.PRNGKey(key0 + i), *extra)
        _sync()
        secs["sync" if i == 0 else "compressed"].append(time.perf_counter() - t0)
        per_round.append({k: v for k, v in kernels.launch_counts().items() if v})
        wire.append({k: v - before.get(k, 0) for k, v in mesh.payload_bytes.items()
                     if v != before.get(k, 0)})
    return state, secs, per_round, wire


def run_launch(report: dict) -> dict:
    """Phase 12 (module doc): bring up a one-rank process group through
    ``topology.init_from_env`` (``MARINA_MP_*`` set here for one process:
    nccl on the card), run ``_launch_paths`` on it, destroy it. Must take at
    most LAUNCH_BUDGET_S."""
    import socket

    from repro_torch.launch import topology as topo

    t_phase = time.perf_counter()
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    os.environ[topo.PROCESS_ENV] = "0/1"
    os.environ[topo.COORD_ENV] = f"127.0.0.1:{port}"
    try:
        require(topo.init_from_env(device=DEVICE) == (0, 1), "bring-up")
        out, launches = _launch_paths(report)
        secs = time.perf_counter() - t_phase
        report["launch"] = dict(out, seconds=secs)
        print(f"launch phase: {secs:.1f} s (budget {LAUNCH_BUDGET_S:.0f})", flush=True)
        require(secs <= LAUNCH_BUDGET_S, f"launch phase took {secs:.1f} s")
        launches.update(run_mesh_serve(report))
    finally:
        topo.shutdown()
        for name in (topo.PROCESS_ENV, topo.COORD_ENV):
            os.environ.pop(name, None)
    return launches


def live_kv_bytes(lengths, page_size: int, row_bytes: int) -> int:
    """The KV bytes a paged decode step reads: every page an active slot
    (length > 0) holds once its new token is written, whole, at
    ``row_bytes`` a token row of every layer."""
    return sum(-(-(int(n) + 1) // page_size) * page_size * row_bytes
               for n in lengths if int(n) > 0)


def first_divergences(got: list, want: list) -> set:
    """(request, token) of the first token where each stream differs."""
    out = set()
    for rid, (a, b) in enumerate(zip(got, want)):
        require(len(a) == len(b), f"request {rid}: lengths {len(a)} != {len(b)}")
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            out.add((rid, j))
    return out


def mesh_paged_path(arch, params, mesh, quantized: bool, backend: str) -> tuple:
    """SERVE_SPEC through ``build_paged_serve_steps`` on ``mesh``, the
    engine driven by ``serve_steps.engine_steps``; each decode step timed
    on the host clock (it ends in the tokens' copy to the host) beside the
    live KV bytes it reads. Returns (streams, ServeReport dict, launches,
    [(seconds, kv bytes)] by decode step, the mesh's bytes by kind)."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.launch import serve
    from repro_torch.launch.serve_steps import build_paged_serve_steps, engine_steps

    cfg = arch.model
    pairs = serve.parse_requests(SERVE_SPEC)
    reqs = serve.make_workload(cfg, pairs)
    layout = serve.paged_layout(reqs, slots=SERVE_SLOTS, page_size=SERVE_PAGE)
    b = build_paged_serve_steps(arch, mesh, n_slots=SERVE_SLOTS, npage=layout.npage,
                                page_size=SERVE_PAGE, max_pages=layout.max_pages,
                                chunk=SERVE_CHUNK, dtype=torch.float32, quantized=quantized,
                                backend=backend)
    row_bytes = sum(leaf[:, 0, 0].numel() * leaf.element_size()
                    for leaf in tree_leaves(b.meta["cache_shapes"]))
    steps = engine_steps(b, params)
    rec = []

    def timed(cache, toks, lengths, tables, _fn=steps["decode"]):
        t0 = time.perf_counter()
        out = _fn(cache, toks, lengths, tables)
        rec.append((time.perf_counter() - t0, live_kv_bytes(lengths, SERVE_PAGE, row_bytes)))
        return out

    steps["decode"] = timed
    gc.collect()
    _sync()
    mesh.reset_counts()
    kernels.reset_launch_counts()
    rep = serve.run_continuous(params, cfg, reqs, quantized=quantized, steps=steps,
                               slots=SERVE_SLOTS, page_size=SERVE_PAGE,
                               chunk=SERVE_CHUNK).to_dict()
    _sync()
    launches = kernels.launch_counts()
    rep["n_layers"] = cfg.num_layers
    rep["row_bytes"] = row_bytes
    return [r.generated for r in reqs], rep, launches, rec, dict(mesh.payload_bytes)


def device_busy_ms(fn) -> "dict | None":
    """One call of ``fn`` under ``torch.profiler``: the union of its device
    intervals (kernels, copies, sets) and the host wall of the call, in ms
    (None on the CPU: no device)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if DEVICE == "cpu":
        fn()
        return None
    trace = os.path.join(ROOT, "build", "mesh_serve_ml_round.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    os.remove(trace)
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    require(dev, "mesh_serve: the ml round's trace holds no device activity")
    return {"device_busy_ms": _union_us(dev) / 1e3, "wall_ms": wall * 1e3,
            "device_events": len(dev)}


def run_mesh_serve(report: dict) -> dict:
    """Phase 13 (module doc): the serving bundles and the roofline on the
    launch phase's group. Must take at most MESH_SERVE_BUDGET_S."""
    import torch

    from repro_torch import configs, prng
    from repro_torch.core.tree_util import tree_leaves, tree_map
    from repro_torch.launch import param_math as pm
    from repro_torch.launch import serve
    from repro_torch.launch import topology as topo
    from repro_torch.launch.distributed import build_train_steps
    from repro_torch.launch.serve_steps import build_serve_steps
    from repro_torch.models import forward, init_params
    from repro_torch.roofline import HW, analyze_step, decode_bandwidth_bound_s
    from repro_torch.roofline.analysis import H100_F32_PEAK_FLOPS

    t_phase = time.perf_counter()
    card = report.get("card", "")
    out: dict = {}
    launches: dict = {}
    arch = configs.get_arch("qwen1.5-0.5b")
    cfg = arch.model
    params = init_params(SEED, cfg, device=DEVICE)
    mesh = topo.make_test_mesh(1, 1, device=DEVICE)
    param_bytes = 4.0 * pm.count_params(cfg)
    n_params = pm.count_params(cfg)
    require(n_params == sum(t.numel() for t in tree_leaves(params)),
            f"param_math counts {n_params} parameters the model does not have")

    # (a) the paged bundles on SERVE_SPEC
    pairs = serve.parse_requests(SERVE_SPEC)
    listed = report.get("serve_paths", {})
    for path, quantized in MESH_SERVE_PATHS.items():
        # run_continuous's streams: phase 9's, or here in a phase-only run
        want = listed.get("serve_continuous_q8" if quantized else "serve_continuous",
                          {}).get("streams")
        if want is None:
            want_reqs = serve.make_workload(cfg, pairs)
            serve.run_continuous(params, cfg, want_reqs, quantized=quantized,
                                 slots=SERVE_SLOTS, page_size=SERVE_PAGE, chunk=SERVE_CHUNK)
            want = [r.generated for r in want_reqs]
            del want_reqs
        got, rep, counts, rec, wire = mesh_paged_path(arch, params, mesh, quantized, "auto")
        require(got == want, f"{path}: streams differ from run_continuous's")
        exp = {name: serve_launches(quantized, rep).get(name, 0) for name in counts}
        require(counts == exp, f"{path} launches {counts} != {exp}")
        launches[path] = counts
        steps = rep["decode_steps"]
        require(wire.get("tokens") == steps * SERVE_SLOTS * 4
                and wire.get("kv_rows") == steps * SERVE_SLOTS * rep["row_bytes"],
                f"{path}: the exchanges carried {wire}")
        plain, _, plain_counts, _, _ = mesh_paged_path(arch, params, mesh, quantized, "ref")
        require(not any(plain_counts.values()), f"{path}: the plain run launched {plain_counts}")
        near = {(d["rid"], d["token"]) for d in listed.get(
            "serve_continuous_q8" if quantized else "serve_continuous", {}).get("diverged", [])}
        diverged = first_divergences(got, plain)
        require(diverged <= near, f"{path}: the plain run diverges at {sorted(diverged)}, "
                                  f"not among phase 9's near ties {sorted(near)}")
        secs = [t for t, _ in rec]
        bounds = [decode_bandwidth_bound_s(kv, param_bytes, 1, HW())["bound_s"]
                  for _, kv in rec]
        step_ms, bound_ms = statistics.median(secs) * 1e3, statistics.median(bounds) * 1e3
        out[path] = run = {
            "decode_steps": steps, "prefill_chunks": rep["prefill_chunks"],
            "tokens_per_s": rep["tokens_per_s"], "median_decode_step_ms": step_ms,
            "median_bound_ms": bound_ms, "floor_share": bound_ms / step_ms,
            "param_bytes": param_bytes,
            "median_kv_bytes": statistics.median(kv for _, kv in rec),
            "wire_bytes": wire, "plain_diverged": sorted(diverged),
            "launches": {k: v for k, v in counts.items() if v}}
        print(f"mesh_serve {path}: streams equal run_continuous's; median decode step "
              f"{step_ms:.3f} ms, its floor (decode_bandwidth_bound_s: {param_bytes:.0f} B "
              f"of f32 params + median {run['median_kv_bytes']:.0f} B of live KV pages at "
              f"3.35e12 B/s) {bound_ms:.4f} ms = {run['floor_share']:.4f} of the step; "
              f"{steps} decode steps, {rep['prefill_chunks']} chunks, launches "
              f"{run['launches']}, exchanges {wire}, the plain run's divergences "
              f"{run['plain_diverged']} on {card}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    # (b) the dense bundles: prefill with last logits, decode, teacher-forced
    B, S, n = MESH_DENSE
    toks = prng.randint(prng.PRNGKey(SEED + 30), (B, S), 0, cfg.vocab_size, device=DEVICE)
    pre = build_serve_steps(arch, mesh, batch=B, seq_len=S + n, mode="prefill",
                            dtype=torch.float32, last_logits=True)
    dec = build_serve_steps(arch, mesh, batch=B, seq_len=S + n, mode="decode",
                            dtype=torch.float32)
    t0 = time.perf_counter()
    lg, cache = pre.fns["prefill_step"](params, toks)
    logits = [lg]
    for i in range(n):
        lg, cache = dec.fns["decode_step"](params, cache, torch.argmax(logits[-1], -1), S + i)
        logits.append(lg)
    _sync()
    dense_s = time.perf_counter() - t0
    del cache
    gen = torch.stack([torch.argmax(lg, -1) for lg in logits[:n]], dim=1)
    with torch.inference_mode():
        full = forward(params, cfg, torch.cat([toks, gen.to(toks.dtype)], dim=1))[0]
    worst = 0.0
    for i, lg in enumerate(logits):
        want_lg = full[:, S - 1 + i].double()
        err = ((lg.double() - want_lg).abs().amax(-1) / want_lg.abs().amax(-1)).max()
        worst = max(worst, float(err))
    del full, logits
    require(worst <= FAMILY_LOGIT_RTOL,
            f"mesh_serve dense: logits {worst} of the row's largest from the teacher-forced "
            "forward")
    out["dense"] = {"batch": B, "prompt": S, "decode_steps": n, "seconds": dense_s,
                    "max_rel_logit_err": worst, "bound": FAMILY_LOGIT_RTOL,
                    "wire_bytes": dict(mesh.payload_bytes)}
    print(f"mesh_serve dense: prefill {B} × {S} (last logits) + {n} decode steps in "
          f"{dense_s:.2f} s; logits within {worst:.3g} of each row's largest from a "
          f"teacher-forced forward (bound {FAMILY_LOGIT_RTOL})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (c) param_math: the ten configs from meta shapes, the ml round's FLOPs
    counts = {}
    for name in sorted(configs.PUBLIC_TO_MODULE):
        c = configs.get_arch(name).model
        counts[name] = [pm.count_params(c), pm.count_active_params(c)]
        if name in PARAM_COUNTS and c.name == name:
            require(tuple(counts[name]) == PARAM_COUNTS[name],
                    f"{name}: counts {counts[name]} != the reference's {PARAM_COUNTS[name]}")
    tokens = LAUNCH_N * LAUNCH_BATCH * LAUNCH_SEQ
    mf = pm.model_flops(cfg, tokens)
    flop_s = mf / H100_F32_PEAK_FLOPS
    host_s = report["launch"]["ml_auto"]["median_s"]["compressed"]
    out["param_counts"] = counts
    print(f"mesh_serve param_math: (params, active) {json.dumps(counts)}", flush=True)

    # (d) the ml round: device busy under the profiler, then analyze_step
    lmesh = topo.make_test_mesh(LAUNCH_N, 1, device=DEVICE)
    b = build_train_steps(arch, lmesh, False, grad_carry=True, global_batch=tokens // LAUNCH_SEQ,
                          seq_len=LAUNCH_SEQ, dtype=torch.float32)
    gen_t = torch.Generator(device=lmesh.device).manual_seed(SEED + 21)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (LAUNCH_N, LAUNCH_BATCH, LAUNCH_SEQ),
                                     generator=gen_t, device=lmesh.device)}
    state = b.fns["sync_step"](params, tree_map(torch.zeros_like, params),
                               tree_map(lambda t: t.new_zeros((LAUNCH_N, *t.shape)), params),
                               batch)
    comp = b.fns["compressed_step"]
    busy = device_busy_ms(lambda: comp(*state, batch, prng.PRNGKey(SEED + 31)))
    gc.collect()
    torch.cuda.empty_cache()
    hw32 = HW(peak_flops=H100_F32_PEAK_FLOPS)
    roof = analyze_step(comp, *state, batch, prng.PRNGKey(SEED + 32), n_devices=1,
                        model_flops_total=mf, topology=topo.detect_topology(lmesh),
                        mesh=lmesh, hw=hw32, device=lmesh.device)
    del state
    out["ml_round"] = ml = {
        "model_flops": mf, "flop_s_at_f32_peak": flop_s, "host_s": host_s,
        "share_of_peak_host": flop_s / host_s,
        **({} if busy is None else {**busy, "share_of_peak_busy":
                                    flop_s / (busy["device_busy_ms"] / 1e3)}),
        "roofline": roof.to_dict()}
    busy_txt = ("device busy not measured (no device)" if busy is None else
                f"device busy {busy['device_busy_ms']:.1f} ms of a {busy['wall_ms']:.1f} ms "
                f"traced round: {ml['share_of_peak_busy']:.3f} of the peak")
    print(f"mesh_serve ml round: 6·N·D = {mf:.4g} FLOP = {flop_s:.4f} s at "
          f"{H100_F32_PEAK_FLOPS:.3g} FLOP/s; host clock {host_s:.4f} s a round (launch phase): "
          f"{ml['share_of_peak_host']:.3f} of the peak; {busy_txt} on {card}", flush=True)
    print(f"mesh_serve ml round roofline (analyze_step, HW f32 peak): counted FLOPs "
          f"{roof.flops_per_device:.4g} (useful ratio {roof.useful_ratio:.3f}), bytes "
          f"{roof.bytes_per_device:.4g}, collective {roof.collective.per_device_bytes:.4g} B "
          f"({roof.collective.counts}), peak memory {roof.peak_memory_per_device}, terms "
          f"compute {roof.compute_s:.4f} s / memory {roof.memory_s:.4f} s / collective "
          f"{roof.collective_s:.4g} s, dominant {roof.dominant}", flush=True)
    del params, b
    gc.collect()
    torch.cuda.empty_cache()

    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    report["mesh_serve"] = out
    print(f"mesh_serve phase: {secs:.1f} s (budget {MESH_SERVE_BUDGET_S:.0f})", flush=True)
    require(secs <= MESH_SERVE_BUDGET_S, f"mesh_serve phase took {secs:.1f} s")
    return launches


def _launch_paths(report: dict) -> tuple:
    """The ml and mp paths on the phase's mesh (the group is up)."""
    import torch

    from repro_torch import kernels, prng
    from repro_torch.configs import get_arch
    from repro_torch.core.tree_util import tree_leaves, tree_map
    from repro_torch.launch import topology as topo
    from repro_torch.launch.distributed import BLOCK as PP_BLOCK
    from repro_torch.launch.distributed import KB as PP_KB
    from repro_torch.launch.distributed import build_train_steps, pp_cohort_schedule
    from repro_torch.models import init_params, param_count

    torch.cuda.reset_peak_memory_stats()
    mesh = topo.make_test_mesh(LAUNCH_N, 1, device=DEVICE)
    tier = topo.detect_topology(mesh).tier_for_axes(("data",))
    require(tier == "loopback", f"worker-axis tier {tier} on one rank")
    arch = get_arch("qwen1.5-0.5b")
    cfg = arch.model
    t0 = time.perf_counter()
    params = init_params(SEED, cfg, device=DEVICE)
    d = param_count(params)
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 21)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (LAUNCH_N, LAUNCH_BATCH, LAUNCH_SEQ),
                                     generator=gen, device=mesh.device)}
    kw = dict(global_batch=LAUNCH_N * LAUNCH_BATCH, seq_len=LAUNCH_SEQ, dtype=torch.float32)
    up_want = ml_up_bits(params)
    if d == QWEN_D:
        require(up_want == ML_UP_BITS, f"ml uplink formula {up_want} != {ML_UP_BITS}")
    nleaf = len(tree_leaves(params))
    out = {"mesh": dict(mesh.shape), "backend": mesh.backend, "world": mesh.world,
           "tier": tier, "d": d, "leaves": nleaf}
    launches, final = {}, None
    print(f"launch: mesh {mesh.shape} on {mesh.backend} (world {mesh.world}), tier {tier}, "
          f"d={d}, {nleaf} leaves, init {time.perf_counter() - t0:.1f} s", flush=True)

    # ml: mesh × randk × carry, through the kernels and then the plain versions
    for backend in ("auto", "ref"):
        b = build_train_steps(arch, mesh, False, grad_carry=True,
                              compression_backend=backend, **kw)
        exchange = {}
        with timed_exchanges(b.transport, exchange if backend == "auto" else {}):
            state, secs, per_round, wire = launch_rounds(
                b.fns, (params, tree_map(torch.zeros_like, params),
                        tree_map(lambda t: t.new_zeros((LAUNCH_N, *t.shape)), params)),
                batch, LAUNCH_COMPRESSED, mesh)
        if exchange:
            exchange["sync_mean"] = exchange["sync_mean"][1:]  # drop the warm-up's
        led = b.transport.ledger
        sync_up = led.total_bits(scope="sync_step", direction="up")
        sync_down = led.total_bits(scope="sync_step", direction="down")
        comp_up = led.total_bits(scope="compressed_step", direction="up")
        comp_down = led.total_bits(scope="compressed_step", direction="down")
        require(sync_up == sync_down == 32.0 * d, f"ml sync ledger {sync_up}, {sync_down}")
        require(comp_up == up_want, f"ml compressed uplink {comp_up} != {up_want}")
        require(comp_down == 32.0 * d, f"ml compressed downlink {comp_down} != {32.0 * d}")
        require(set(t for (_s, _d, t, _k) in led.bits) == {tier}, "ml ledger tiers")
        # the wire against the ledger: bytes the collectives carried (one
        # rank: the whole fleet's), ×8 ÷ n
        padded = b.transport.sync_layout.padded
        wire_up = [sum(w.values()) * 8.0 / LAUNCH_N for w in wire]
        require(set(wire[0]) == {"all_reduce"} and wire_up[0] == 32.0 * padded,
                f"ml sync round wire {wire[0]} != 32 bits x {padded} padded slots a worker")
        for i, w in enumerate(wire[1:], 1):
            require(set(w) == {"all_gather"} and wire_up[i] == comp_up,
                    f"ml round {i} wire {w}: {wire_up[i]} bits a worker != booked {comp_up}")
        require(all(math.isfinite(float(x.float().abs().max())) for x in tree_leaves(state)),
                "ml state not finite")
        want_round = ({"randk_gather": nleaf, "scatter_accum": nleaf}
                      if backend == "auto" else {})
        for i, got in enumerate(per_round[1:], 1):
            require(got == want_round, f"ml round {i} ({backend}) launches {got}")
        require(per_round[0] == {}, f"ml sync round ({backend}) launches {per_round[0]}")
        run = {"seconds": secs, "median_s": {k: statistics.median(v) for k, v in secs.items()},
               "exchange_s": exchange,
               "collectives": dict(mesh.collectives), "launches_by_round": per_round,
               "up_bits": {"sync": sync_up, "compressed": comp_up},
               "wire_bytes_by_round": wire, "wire_up_bits_by_round": wire_up,
               "down_bits": {"sync": sync_down, "compressed": comp_down},
               "ledger": led.to_dict(), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        out[f"ml_{backend}"] = run
        if exchange:
            print(f"launch ml: the transport's seconds a call (synchronized): {exchange}",
                  flush=True)
        print(f"launch ml ({backend}): s/round {run['median_s']} ({secs}), up bits/worker "
              f"sync {sync_up:.0f} compressed {comp_up:.0f} (wire, by round: {wire_up}), "
              f"down {comp_down:.0f}, "
              f"collectives {run['collectives']}, launches/round {per_round[1]}, "
              f"peak {run['peak_mem_gb']:.2f} GB", flush=True)
        if backend == "auto":
            launches["ml"] = _summed(per_round)
            final = state
        else:
            same = all(bits_equal(a, b_) for a, b_ in zip(tree_leaves(final),
                                                        tree_leaves(state)))
            require(same, "ml: the kernel run's params, g and h differ from the plain run's")
            out["ml_bit_equal"] = True
            print("launch ml: params, g and h bit-equal between the kernel and plain runs",
                  flush=True)
        del state, b
        gc.collect()
        torch.cuda.empty_cache()
    del final
    gc.collect()
    torch.cuda.empty_cache()

    # mp: mesh × PP (flat PP, cohort compute), kernels and plain versions
    r, scheme = LAUNCH_PP
    sels = pp_cohort_schedule(prng.PRNGKey(SEED + 22), LAUNCH_PP_COMPRESSED, LAUNCH_N, r,
                              scheme)
    finals = []
    for backend in ("auto", "ref"):
        b = build_train_steps(arch, mesh, False, participation=LAUNCH_PP,
                              compression_backend=backend, **kw)
        require(b.meta["flat_pp"] and b.meta["cohort_compute"], f"mp meta {b.meta}")
        state, secs, per_round, wire = launch_rounds(
            b.fns, (params, tree_map(torch.zeros_like, params)), batch, LAUNCH_PP_COMPRESSED,
            mesh, sels=sels)
        led = b.transport.ledger
        comp_up = led.total_bits(scope="compressed_step", direction="up")
        nblk = math.ceil(d / PP_BLOCK)
        pp_up = r * (32.0 + 32.0 * nblk * PP_KB) / LAUNCH_N
        require(comp_up == pp_up, f"mp compressed uplink {comp_up} != {pp_up}")
        # the r payload rows and their seeds cross by all-gather, read off
        # the wire as the ledger books them; no dense state crosses
        for i, w in enumerate(wire[1:], 1):
            bits = sum(w.values()) * 8.0 / LAUNCH_N
            require(set(w) == {"all_gather"} and bits == comp_up,
                    f"mp round {i} wire {w}: {bits} bits a worker != booked {comp_up}")
        want_round = ({"randk_seeded_workers": 1, "scatter_accum": 1}
                      if backend == "auto" else {})
        for i, got in enumerate(per_round[1:], 1):
            require(got == want_round, f"mp round {i} ({backend}) launches {got}")
        run = {"seconds": secs, "median_s": {k: statistics.median(v) for k, v in secs.items()},
               "collectives": dict(mesh.collectives), "launches_by_round": per_round,
               "up_bits_compressed": comp_up, "wire_bytes_by_round": wire,
               "meta": {k: str(v) for k, v in b.meta.items()},
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        out[f"mp_{backend}"] = run
        print(f"launch mp ({backend}): s/round {run['median_s']} ({secs}), compressed up "
              f"bits/worker {comp_up:.0f} (wire by round {wire}), collectives "
              f"{run['collectives']}, launches/round {per_round[1]}", flush=True)
        if backend == "auto":
            launches["mp"] = _summed(per_round)
        finals.append(state)
        del b
    require(all(bits_equal(a, b_) for a, b_ in zip(tree_leaves(finals[0]),
                                                   tree_leaves(finals[1]))),
            "mp: the kernel run's params and g differ from the plain run's")
    out["mp_bit_equal"] = True
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del finals, state, params
    gc.collect()
    torch.cuda.empty_cache()
    return out, {path: {name: counts.get(name, 0) for name in kernels.KERNELS}
                 for path, counts in launches.items()}


# ---------------------------------------------------------------------------
# phase 14: mesh_model — the model axis across two ranks on the one card
# ---------------------------------------------------------------------------


def _mesh_model_spec() -> dict:
    """What the two ranks run, read by ``mesh_model_rank`` from the
    environment (the children import this file afresh)."""
    return {"device": DEVICE, "arch": MESH_MODEL_ARCH, "layers": MESH_MODEL_LAYERS,
            "depth": MESH_MODEL_DEPTH,
            "n": MESH_MODEL_N, "batch": MESH_MODEL_BATCH, "seq": MESH_MODEL_SEQ,
            "keys": list(MESH_MODEL_KEYS), "serve_spec": SERVE_SPEC, "slots": SERVE_SLOTS,
            "page": SERVE_PAGE, "chunk": MESH_MODEL_CHUNK}


def _mm_arch(spec: dict):
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import reduced

    arch = get_arch(spec["arch"])
    if spec["layers"]:
        arch = dataclasses.replace(arch, model=reduced(arch.model, layers=spec["layers"],
                                                       d_model=64))
    elif spec["depth"]:
        arch = dataclasses.replace(arch, model=depth_cut(arch.model, spec["depth"])[0])
    return arch


def mesh_cuts(spec: dict) -> list:
    """The depth cut of a mesh phase's Qwen1.5-0.5B as ``reduced`` lists it
    (none for a CPU rehearsal's reduced config, which reports its own)."""
    from repro_torch.configs import get_arch

    if spec["layers"] or not spec["depth"]:
        return []
    cut = depth_cut(get_arch(spec.get("arch", "qwen1.5-0.5b")).model, spec["depth"])[1]
    print(f"mesh phase cut: {cut}", flush=True)
    return [cut]


def split_params(cfg) -> int:
    """Qwen1.5-0.5B's parameters a rank when every leaf is halved but
    ``final_norm`` (d_model, replicated): 231,994,368 at full depth."""
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.models import init_params

    whole = sum(t.numel() for t in tree_leaves(init_params(SEED, cfg, device="meta")))
    return (whole - cfg.d_model) // 2 + cfg.d_model


def _mm_rounds(fns: dict, state: tuple, batch: dict, keys: list, mesh) -> tuple:
    """One ``sync_step`` (c_k = 1), then a round under each key as
    ``train_step`` takes it (c_k ~ Be(p) from the key's first half; the
    compressed round under its second), through the bundle's scoped steps
    so the ledger books each round type under its own scope; each timed on
    the host clock ending in a synchronize; launches, the bytes of the
    mesh's collectives and their count by op, by round. Returns (state, c_k,
    seconds, launches, bytes, ops)."""
    from repro_torch import kernels, prng

    c_k, secs, per_round, wire, ops = [], [], [], [], []
    for i in range(len(keys) + 1):
        kernels.reset_launch_counts()
        before, before_ops = dict(mesh.payload_bytes), dict(mesh.op_counts)
        t0 = time.perf_counter()
        if i == 0:
            state = fns["sync_step"](*state, batch)
            c_k.append(1)
        else:
            k_b, k_q = prng.split(prng.PRNGKey(keys[i - 1]))
            c_k.append(int(bool(prng.bernoulli(k_b, MESH_MODEL_P))))
            state = (fns["sync_step"](*state, batch) if c_k[-1]
                     else fns["compressed_step"](*state, batch, k_q))
        _sync()
        secs.append(time.perf_counter() - t0)
        per_round.append({k: v for k, v in kernels.launch_counts().items() if v})
        wire.append({k: v - before.get(k, 0) for k, v in mesh.payload_bytes.items()
                     if v != before.get(k, 0)})
        ops.append({k: v - before_ops.get(k, 0) for k, v in mesh.op_counts.items()
                    if v != before_ops.get(k, 0)})
    return state, c_k, secs, per_round, wire, ops


def _mm_kernels(mesh, b) -> dict:
    """Rows 10 and 2 on this rank's share of the MLP leaf ``w_gate``'s wire
    (its columns; the offsets drawn as the transport draws them, the others
    sent to the dropped column) and row 24 at this rank's heads, each
    against its plain version."""
    import torch

    from repro_torch import prng
    from repro_torch.kernels import paged, randk, ref

    dev = mesh.device
    tr = b.transport
    j = next(i for i, s in enumerate(tr.leaf_shapes) if tr.leaf_dims[i][1] == len(s) - 1
             and len(s) == 3 and s[-1] != s[-2])      # w_gate: (layers, d, F), F split
    shape, sp = tr._leaf(j, None)
    R, L = int(shape[0] * shape[1]), int(shape[2])
    n = len(mesh.workers(b.n_workers))
    _, mine, loc, kb, Ll = tr._cols_draw(prng.PRNGKey(SEED + 43), shape, sp, n, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    x = torch.randn((n * R, Ll), generator=gen, device=dev)
    o = loc.clamp(max=Ll - 1).reshape(n * R, kb).contiguous()
    g_k, g_p = randk.randk_gather(x, o, L / kb), ref.randk_block_compress_ref(x, o, L / kb)
    v = torch.where(mine, g_k.reshape(n, R, kb), torch.zeros_like(g_k.reshape(n, R, kb)))
    s_k, s_p = randk.scatter_accum(v, loc, Ll + 1), ref.scatter_accum_ref(v, loc, Ll + 1)
    out = {"leaf_shape": list(shape), "cols": Ll, "kb": kb, "mine_share": float(mine.float().mean()),
           "randk_gather_err": float((g_k - g_p).abs().max()),
           "scatter_accum_err": float((s_k - s_p).abs().max())}
    require(bits_equal(g_k, g_p) and bits_equal(s_k, s_p),
            f"mesh_model: rows 10 / 2 on the rank's columns differ from their plain versions "
            f"({out})")
    if DEVICE == "cuda":
        out["randk_gather_b2b_ms"] = back_to_back_ms(lambda: randk.randk_gather(x, o, L / kb))
        out["scatter_accum_b2b_ms"] = back_to_back_ms(lambda: randk.scatter_accum(v, loc, Ll + 1))
    del x, o, v, g_k, g_p, s_k, s_p
    S, H, KV, hd, P, maxp = MESH_MODEL_PAGED
    q, kp, vp, tables, n_valid = paged_inputs(dev, gen, S, H, KV, hd, P, maxp, torch.float32)
    got = paged.paged_attn_decode(q, kp, vp, tables, n_valid)
    want = ref.paged_attn_decode_ref(q, kp, vp, tables, n_valid)
    ok, err, limit, _ = paged_within_bound(got, want, vp)
    require(ok, f"mesh_model: row 24 at {H} / {KV} heads off by {err} (bound {limit})")
    out["paged_attn_decode_err"] = err
    if DEVICE == "cuda":
        out["paged_attn_decode_b2b_ms"] = back_to_back_ms(
            lambda: paged.paged_attn_decode(q, kp, vp, tables, n_valid))
    return out


def mesh_model_rank() -> None:
    """One rank of the mesh_model phase (module doc, phase 14): prints one
    ``MESH_MODEL {json}`` line."""
    import torch

    from repro_torch.core.tree_util import tree_leaves, tree_map
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import topology as topo
    from repro_torch.launch.distributed import build_train_steps
    from repro_torch.launch.serve_steps import build_paged_serve_steps, engine_steps
    from repro_torch.models import init_params

    global DEVICE
    spec = json.loads(os.environ[MESH_MODEL_ENV])
    DEVICE = spec["device"]
    pid, nproc = topo.init_from_env(device=DEVICE, backend="gloo")
    # the two ranks share the host's cores: torch's host threads split
    # between them (oversubscribed, the host-side ops and the staging stall)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * nproc)))
    out: dict = {"rank": pid, "section_s": {}}
    t_sec = [time.perf_counter()]

    def section(name):
        _sync()
        now = time.perf_counter()
        out["section_s"][name] = now - t_sec[0]
        t_sec[0] = now

    try:
        arch = _mm_arch(spec)
        cfg = arch.model
        n = spec["n"]
        mesh = topo.make_test_mesh(n, nproc, device=DEVICE)
        require(mesh.model == nproc and mesh.world == 1
                and mesh.staged == (DEVICE == "cuda"), f"mesh_model mesh {mesh}")
        tier = topo.detect_topology(mesh).tier_for_axes(("model",))
        require(tier == "dcn", f"model-axis tier {tier} under host-staged gloo")
        full = init_params(SEED, cfg, torch.float32, device=DEVICE)
        params = shd.shard_tree(full, mesh)
        shapes = init_params(SEED, cfg, torch.float32, device="meta")
        out["param_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        out["params"] = sum(t.numel() for t in tree_leaves(params))
        gen = torch.Generator(device=mesh.device).manual_seed(SEED + 41)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (n, spec["batch"], spec["seq"]),
                                         generator=gen, device=mesh.device)}
        # no remat: its second forward would stage every layer's sums again
        kw = dict(global_batch=n * spec["batch"], seq_len=spec["seq"], dtype=torch.float32,
                  p=MESH_MODEL_P, grad_carry=True, remat=False)
        keys = spec["keys"]
        section("init")

        def fresh(p):
            return (p, tree_map(torch.zeros_like, p),
                    tree_map(lambda t: t.new_zeros((n, *t.shape)), p))

        runs, finals = {}, {}
        for backend_k in ("auto", "ref"):
            b = build_train_steps(arch, mesh, False, compression_backend=backend_k, **kw)
            if backend_k == "auto":
                out["kernels"] = _mm_kernels(mesh, b)
            mesh.reset_counts()
            if DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
            state, c_k, secs, per_round, wire, ops = _mm_rounds(b.fns, fresh(params), batch,
                                                                 keys, mesh)
            runs[backend_k] = {"c_k": c_k, "seconds": secs, "launches": per_round,
                               "wire": wire, "ops": ops,
                               "ledger": sorted([list(k), v] for k, v in
                                                b.transport.ledger.bits.items())}
            finals[backend_k] = state
            del b
            section(f"train_{backend_k}")
        same = all(bits_equal(a, c) for a, c in zip(tree_leaves(finals["auto"]),
                                                   tree_leaves(finals["ref"])))
        require(same, "mesh_model: the kernel run's params, g and h differ from the plain run's")
        out["train"] = runs
        out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if DEVICE == "cuda" else 0.0)
        x, g, _h = finals.pop("auto")
        mine = tree_leaves(x) + tree_leaves(g)
        del finals, x, g, _h
        whole = scales = None
        pairs = serve.parse_requests(spec["serve_spec"])
        serve_kw = dict(slots=spec["slots"], page_size=spec["page"], chunk=spec["chunk"])
        if pid == 1:
            # one rank's serving, with each token's top-2 margin, while model
            # rank 0 runs the one-rank rounds
            want, margins = plain_streams(full, cfg, pairs, serve_kw)
            out["plain"] = {"streams": want, "margins": [margins[r] for r in range(len(want))]}
            section("one_rank_serve")
        if pid == 0:
            # the same rounds on one rank holding the whole model
            solo = topo.Mesh(axis_names=("data", "model"), sizes=(n, nproc), device=mesh.device)
            b = build_train_steps(arch, solo, False, **kw)
            state, c_k, secs, _pr, _w, _o = _mm_rounds(b.fns, fresh(full), batch, keys, solo)
            whole = tree_leaves(state[0]) + tree_leaves(state[1])
            scales = torch.tensor([float(c.abs().max()) or 1.0 for c in whole],
                                  dtype=torch.float64, device=mesh.device)
            out["one_rank"] = {"c_k": c_k, "seconds": secs,
                               "ledger": sorted([list(k), v] for k, v in
                                                b.transport.ledger.bits.items())}
            del b, state
            section("one_rank_train")
        # each rank's slices of the one-rank state, sent from model rank 0
        # (its own it keeps), held against the rank's own
        scales = mesh.model_bcast(scales, (len(mine),), torch.float64)
        dims = shd.model_dims(shapes, mesh) * 2
        errs = []
        for j, a in enumerate(mine):
            want = None
            for r in range(nproc):
                part = None
                if pid == 0:
                    part = whole[j] if dims[j] is None else whole[j].chunk(nproc, dims[j])[r]
                if r == 0:
                    want = part if pid == 0 else want
                    continue
                got = mesh.model_bcast(None if part is None else part.contiguous(),
                                       a.shape, a.dtype)
                want = got if mesh.model_rank == r else want
            errs.append(float((a - want).abs().max()) / float(scales[j]))
        out["errs"] = errs
        del whole, mine
        section("held_to_one_rank")
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()

        del full
        # serving: SERVE_SPEC through the paged bundle, f32 pages, this rank's heads
        reqs = serve.make_workload(cfg, pairs)
        layout = serve.paged_layout(reqs, slots=spec["slots"], page_size=spec["page"])
        b = build_paged_serve_steps(arch, mesh, n_slots=spec["slots"], npage=layout.npage,
                                    page_size=spec["page"], max_pages=layout.max_pages,
                                    chunk=spec["chunk"], dtype=torch.float32)
        out["pool_heads"] = sorted({t.shape[3] for t in tree_leaves(b.meta["cache_shapes"])})
        steps = engine_steps(b, params)
        rec = []

        def timed(cache, toks, lengths, tables, _fn=steps["decode"]):
            t0 = time.perf_counter()
            res = _fn(cache, toks, lengths, tables)
            rec.append(time.perf_counter() - t0)
            return res

        steps["decode"] = timed
        from repro_torch import kernels

        mesh.reset_counts()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rep = serve.run_continuous(params, cfg, reqs, steps=steps, slots=spec["slots"],
                                   page_size=spec["page"], chunk=spec["chunk"]).to_dict()
        _sync()
        out["serve"] = {"seconds": time.perf_counter() - t0,
                        "decode_steps": rep["decode_steps"],
                        "prefill_chunks": rep["prefill_chunks"],
                        "median_decode_step_ms": statistics.median(rec) * 1e3,
                        "launches": {k: v for k, v in kernels.launch_counts().items() if v},
                        "bytes": dict(mesh.payload_bytes),
                        "streams": [r.generated for r in reqs]}
        del b, steps
        section("serve")
        out["peak_mem_gb"] = max(out["peak_mem_gb"], torch.cuda.max_memory_allocated() / 1e9
                                 if DEVICE == "cuda" else 0.0)
    finally:
        topo.shutdown()
    print("MESH_MODEL " + json.dumps(out), flush=True)


def run_mesh_model(report: dict) -> dict:
    """Phase 14 (module doc): two ranks on the one card, sharded Qwen1.5-0.5B
    trained and served on a (MESH_MODEL_N, 2) mesh, against one rank. Must
    take at most MESH_MODEL_BUDGET_S."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.launch import topology as topo
    from repro_torch.models import init_params

    t_phase = time.perf_counter()
    card = report.get("card", "")
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
        print(f"mesh_model: this process holds {torch.cuda.memory_reserved() / 1e9:.2f} GB of "
              "the card while its two ranks run", flush=True)
    spec = _mesh_model_spec()
    prog = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            "chip_smoke.mesh_model_rank()")
    res = topo.spawn_local_cluster(prog, num_processes=2, devices_per_process=1,
                                   timeout=MESH_MODEL_BUDGET_S + 60,
                                   extra_env={MESH_MODEL_ENV: json.dumps(spec)})
    outs = []
    for r in res:
        sys.stdout.write("".join(line + "\n" for line in r.stdout.splitlines()
                                 if not line.startswith("MESH_MODEL ")))
        require(r.returncode == 0, f"mesh_model rank exited {r.returncode}: {r.stderr[-3000:]}")
        outs += [json.loads(line[len("MESH_MODEL "):]) for line in r.stdout.splitlines()
                 if line.startswith("MESH_MODEL ")]
    require(len(outs) == 2, f"mesh_model: {len(outs)} rank reports")
    outs.sort(key=lambda o: o["rank"])
    lead = outs[0]
    cfg = _mm_arch(spec).model
    shapes = tree_leaves(init_params(SEED, cfg, device="meta"))
    whole = sum(t.numel() for t in shapes)
    out = {"ranks": 2, "mesh": [spec["n"], 2], "backend": "gloo (host-staged)",
           "param_bytes": [o["param_bytes"] for o in outs], "whole_param_bytes": 4 * whole,
           "peak_mem_gb": [o["peak_mem_gb"] for o in outs], "kernels": [o["kernels"] for o in outs],
           "reduced": mesh_cuts(spec)}
    if spec["arch"] == "qwen1.5-0.5b" and not spec["layers"]:
        require([o["params"] for o in outs] == [split_params(cfg)] * 2,
                f"mesh_model: parameters a rank {[o['params'] for o in outs]}")
    print(f"mesh_model: parameter bytes a rank {out['param_bytes']} of {4 * whole} "
          f"({[round(b / 1e9, 3) for b in out['param_bytes']]} of {4 * whole / 1e9:.3f} GB); "
          f"peak memory a rank {[round(g, 2) for g in out['peak_mem_gb']]} GB", flush=True)
    # training: c_k, ledgers, the wire against the ledger, the LM rule
    one = lead["one_rank"]
    nleaf = len(shapes)
    errs = [max(o["errs"][j] for o in outs) for j in range(2 * nleaf)]
    one.update(params_errs=errs[:nleaf], g_errs=errs[nleaf:], params_err=max(errs[:nleaf]),
               g_err=max(errs[nleaf:]))
    out["section_s"] = [o["section_s"] for o in outs]
    print(f"mesh_model: seconds by section a rank {out['section_s']}; against one rank, of "
          f"each leaf's scale (leaves in tree order): params {one['params_errs']}, g "
          f"{one['g_errs']}", flush=True)
    for o in outs:
        for bk in ("auto", "ref"):
            run = o["train"][bk]
            require(run["c_k"] == one["c_k"], f"mesh_model c_k {run['c_k']} != {one['c_k']}")
            require(run["ledger"] == one["ledger"], f"mesh_model ledger {run['ledger']}")
    require(max(one["params_err"], one["g_err"]) <= MESH_MODEL_RTOL,
            f"mesh_model: params {one['params_err']}, g {one['g_err']} of a leaf's scale from "
            f"one rank's (bound {MESH_MODEL_RTOL})")
    n = spec["n"]
    rounds = []
    for i, c in enumerate(one["c_k"]):
        by_kind, by_op = {}, {}
        for o in outs:
            for k, v in o["train"]["auto"]["wire"][i].items():
                by_kind[k] = by_kind.get(k, 0) + v
            for k, v in o["train"]["auto"]["ops"][i].items():
                by_op[k] = by_op.get(k, 0) + v
        wire_bits = sum(v for k, v in by_kind.items()
                        if not k.startswith("model/")) * 8.0 / n
        scope = "sync_step" if c else "compressed_step"
        booked = sum(v for k, v in one["ledger"] if k[0] == scope and k[1] == "up")
        require(wire_bits == booked, f"mesh_model round {i}: wire {wire_bits} bits a worker "
                                     f"!= booked {booked} ({by_kind})")
        launches: dict = {}
        for o in outs:
            for k, v in o["train"]["auto"]["launches"][i].items():
                launches[k] = launches.get(k, 0) + v
        secs = [o["train"]["auto"]["seconds"][i] for o in outs]
        rounds.append({"c_k": c, "bytes": by_kind, "collectives": by_op,
                       "wire_up_bits": wire_bits, "booked_up_bits": booked,
                       "launches": launches, "seconds": max(secs)})
        print(f"mesh_model round {i} (c_k {c}): {max(secs):.3f} s on host-staged gloo (not "
              f"NVLink), wire {wire_bits:.0f} bits a worker = booked, bytes by kind "
              f"{by_kind}, collectives by op {by_op}, launches {launches}", flush=True)
    out["rounds"] = rounds
    out["one_rank"] = {k: one[k] for k in ("c_k", "seconds", "params_err", "g_err",
                                           "params_errs", "g_errs")}
    if DEVICE == "cuda":
        for r in rounds[1:]:
            if r["c_k"] == 0:
                # a leaf a rank, the replicated one (final_norm) on model rank 0 only
                require(r["launches"] == {"randk_gather": 2 * nleaf - 1,
                                          "scatter_accum": 2 * nleaf - 1},
                        f"mesh_model compressed round launches {r['launches']}")
    # serving
    serve_rep = [o["serve"] for o in outs]
    require(serve_rep[0]["streams"] == serve_rep[1]["streams"], "mesh_model: ranks' streams")
    plain = outs[1]["plain"]
    diverged = compare_streams("mesh_model serve (2 ranks vs 1)", serve_rep[0]["streams"],
                               plain["streams"], plain["margins"])
    require(all(o["pool_heads"] == [cfg.num_kv_heads // 2] for o in outs),
            f"mesh_model pools hold {[o['pool_heads'] for o in outs]} KV heads")
    sl: dict = {}
    for s in serve_rep:
        for k, v in s["launches"].items():
            sl[k] = sl.get(k, 0) + v
    steps = serve_rep[0]["decode_steps"]
    if DEVICE == "cuda":
        require(sl == {"paged_attn_decode": 2 * cfg.num_layers * steps},
                f"mesh_model serve launches {sl}")
    out["serve"] = {"decode_steps": steps, "prefill_chunks": serve_rep[0]["prefill_chunks"],
                    "median_decode_step_ms": [s["median_decode_step_ms"] for s in serve_rep],
                    "seconds": [s["seconds"] for s in serve_rep],
                    "bytes": [s["bytes"] for s in serve_rep],
                    "diverged": diverged, "launches": sl}
    print(f"mesh_model serve: streams equal one rank's (divergences at near ties: "
          f"{diverged}); median decode step "
          f"{[round(s['median_decode_step_ms'], 3) for s in serve_rep]} ms on host-staged "
          f"gloo (not NVLink); {steps} decode steps; launches {sl}; bytes by kind a rank "
          f"{serve_rep[0]['bytes']}", flush=True)
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    report["mesh_model"] = out
    print(f"mesh_model phase: {secs:.1f} s (budget {MESH_MODEL_BUDGET_S:.0f}) on {card}",
          flush=True)
    require(secs <= MESH_MODEL_BUDGET_S, f"mesh_model phase took {secs:.1f} s")
    names = kernels.KERNELS
    return {"mesh_model_train": {k: sum(r["launches"].get(k, 0) for r in rounds)
                                 for k in names},
            "mesh_model_serve": {k: sl.get(k, 0) for k in names}}


def _mf_spec() -> dict:
    return {"device": DEVICE, "layers": MESH_FSDP_LAYERS, "depth": MESH_FSDP_DEPTH,
            "seq": MESH_FSDP_SEQ,
            "key": MESH_FSDP_KEY, "serve": MESH_FSDP_SERVE, "slots": 4, "page": SERVE_PAGE,
            "chunk": 64}


def _mf_arch(spec: dict):
    """Qwen1.5-0.5B under the fsdp override (reduced where ``spec`` says)."""
    import dataclasses

    arch = _mm_arch({"arch": "qwen1.5-0.5b", "layers": spec["layers"], "depth": spec["depth"]})
    return dataclasses.replace(arch, worker_axes="pod", fsdp=True)


def mesh_fsdp_rank() -> None:
    """One rank of the mesh_fsdp phase (module doc, phase 15): prints one
    ``MESH_FSDP {json}`` line."""
    import torch

    from repro_torch import kernels, prng
    from repro_torch.core.tree_util import tree_leaves, tree_map
    from repro_torch.launch import serve
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import topology as topo
    from repro_torch.launch.distributed import build_train_steps
    from repro_torch.launch.serve_steps import build_paged_serve_steps, engine_steps
    from repro_torch.models import init_params

    global DEVICE
    spec = json.loads(os.environ[MESH_FSDP_ENV])
    DEVICE = spec["device"]
    pid, nproc = topo.init_from_env(device=DEVICE, backend="gloo")
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * nproc)))
    out: dict = {"rank": pid, "section_s": {}}
    t_sec = [time.perf_counter()]

    def section(name):
        _sync()
        now = time.perf_counter()
        out["section_s"][name] = now - t_sec[0]
        t_sec[0] = now
        print(f"mesh_fsdp rank {pid}: {name} {out['section_s'][name]:.2f} s", flush=True)

    try:
        arch = _mf_arch(spec)
        cfg = arch.model
        mesh = topo.make_mesh((2, 2, 1), ("pod", "data", "model"), device=DEVICE, fsdp=True)
        require((mesh.world, mesh.fsdp, mesh.model) == (2, 2, 1)
                and mesh.staged == (DEVICE == "cuda"), f"mesh_fsdp mesh {mesh}")
        full = init_params(SEED, cfg, torch.float32, device=DEVICE)
        params = shd.shard_tree(full, mesh, True)
        shapes = init_params(SEED, cfg, torch.float32, device="meta")
        out["params"] = sum(t.numel() for t in tree_leaves(params))
        out["param_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        gen = torch.Generator(device=mesh.device).manual_seed(SEED + 47)
        # two workers (the pods) × two rows: one row a data rank
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2, spec["seq"]),
                                         generator=gen, device=mesh.device)}
        kw = dict(global_batch=4, seq_len=spec["seq"], dtype=torch.float32, grad_carry=True,
                  remat=False)
        key = prng.PRNGKey(spec["key"])
        section("init")

        def rounds(m, p):
            b = build_train_steps(arch, m, True, **kw)
            state = (p, tree_map(torch.zeros_like, p),
                     tree_map(lambda t: t.new_zeros((1, *t.shape)), p))
            rec = []
            for name in ("sync_step", "compressed_step"):
                kernels.reset_launch_counts()
                before, calls = dict(m.payload_bytes), dict(m.collectives)
                t0 = time.perf_counter()
                args = (*state, batch) if name == "sync_step" else (*state, batch, key)
                state = b.fns[name](*args)
                _sync()
                rec.append({"seconds": time.perf_counter() - t0,
                            "launches": {k: v for k, v in kernels.launch_counts().items()
                                         if v},
                            "wire": {k: v - before.get(k, 0) for k, v in
                                     m.payload_bytes.items() if v != before.get(k, 0)},
                            "calls": {k: v - calls.get(k, 0) for k, v in m.collectives.items()
                                      if v != calls.get(k, 0)}})
            return state, rec, sorted([list(k), v] for k, v in b.transport.ledger.bits.items())

        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        state, rec, led = rounds(mesh, params)
        out["train"], out["ledger"] = rec, led
        out["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                              if DEVICE == "cuda" else 0.0)
        section("train")
        got = [shd.gather_tree(t, mesh, shapes, True) for t in state[:2]]
        del state
        if pid == 0:
            solo = topo.Mesh(axis_names=("pod", "data", "model"), sizes=(2, 2, 1),
                             device=mesh.device)
            one, _rec, one_led = rounds(solo, full)
            errs = []
            for a, c in zip(tree_leaves(got), tree_leaves(one[:2])):
                errs.append(float((a - c).abs().max()) / (float(c.abs().max()) or 1.0))
            out["one_rank"] = {"errs": errs, "ledger": one_led}
            del one
            section("one_rank_train")
        del got
        pairs = serve.parse_requests(spec["serve"])
        serve_kw = dict(slots=spec["slots"], page_size=spec["page"], chunk=spec["chunk"])
        if pid == 1:
            want, margins = plain_streams(full, cfg, pairs, serve_kw)
            out["plain"] = {"streams": want, "margins": [margins[r] for r in range(len(want))]}
            section("one_rank_serve")
        del full
        gc.collect()
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        reqs = serve.make_workload(cfg, pairs)
        layout = serve.paged_layout(reqs, slots=spec["slots"], page_size=spec["page"])
        b = build_paged_serve_steps(arch, mesh, n_slots=spec["slots"], npage=layout.npage,
                                    page_size=spec["page"], max_pages=layout.max_pages,
                                    chunk=spec["chunk"], dtype=torch.float32)
        steps = engine_steps(b, params)
        mesh.reset_counts()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rep = serve.run_continuous(params, cfg, reqs, steps=steps, **serve_kw).to_dict()
        _sync()
        out["serve"] = {"seconds": time.perf_counter() - t0,
                        "decode_steps": rep["decode_steps"],
                        "launches": {k: v for k, v in kernels.launch_counts().items() if v},
                        "bytes": dict(mesh.payload_bytes),
                        "kinds": sorted(mesh.collectives),
                        "streams": [r.generated for r in reqs]}
        section("serve")
        out["peak_mem_gb"] = max(out["peak_mem_gb"], torch.cuda.max_memory_allocated() / 1e9
                                 if DEVICE == "cuda" else 0.0)
    finally:
        topo.shutdown()
    print("MESH_FSDP " + json.dumps(out), flush=True)


def run_mesh_fsdp(report: dict) -> dict:
    """Phase 15 (module doc): four ranks on the one card, Qwen1.5-0.5B under
    the fsdp override on a (2, 2, 1) mesh, against one rank. Must take at
    most MESH_FSDP_BUDGET_S."""
    import torch

    from repro_torch import kernels
    from repro_torch.core.tree_util import tree_leaves
    from repro_torch.launch import topology as topo
    from repro_torch.models import init_params

    t_phase = time.perf_counter()
    card = report.get("card", "")
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    spec = _mf_spec()
    prog = (f"import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; "
            "chip_smoke.mesh_fsdp_rank()")
    res = topo.spawn_local_cluster(prog, num_processes=4, devices_per_process=1,
                                   timeout=MESH_FSDP_BUDGET_S + 60,
                                   extra_env={MESH_FSDP_ENV: json.dumps(spec)})
    outs = []
    for r in res:
        sys.stdout.write("".join(line + "\n" for line in r.stdout.splitlines()
                                 if not line.startswith("MESH_FSDP ")))
        outs += [json.loads(line[len("MESH_FSDP "):]) for line in r.stdout.splitlines()
                 if line.startswith("MESH_FSDP ")]
    bad = [(i, r.returncode, r.stderr[-2500:]) for i, r in enumerate(res) if r.returncode]
    require(not bad, "mesh_fsdp ranks exited nonzero: " + " | ".join(
        f"rank {i} ({code}): {err}" for i, code, err in bad))
    require(len(outs) == 4, f"mesh_fsdp: {len(outs)} rank reports")
    outs.sort(key=lambda o: o["rank"])
    lead = outs[0]
    cfg = _mf_arch(spec).model
    nleaf = len(tree_leaves(init_params(SEED, cfg, device="meta")))
    if not spec["layers"]:
        require([o["params"] for o in outs] == [split_params(cfg)] * 4,
                f"mesh_fsdp: parameters a rank {[o['params'] for o in outs]}")
    errs = lead["one_rank"]["errs"]
    require(max(errs) <= MESH_MODEL_RTOL,
            f"mesh_fsdp: params / g {max(errs)} of a leaf's scale from one rank's "
            f"(bound {MESH_MODEL_RTOL})")
    for o in outs:
        require(o["ledger"] == lead["one_rank"]["ledger"], f"mesh_fsdp ledger {o['ledger']}")
    out = {"ranks": 4, "mesh": [2, 2, 1], "backend": "gloo (host-staged)",
           "reduced": mesh_cuts(spec), "params_a_rank": [o["params"] for o in outs],
           "param_bytes": [o["param_bytes"] for o in outs],
           "peak_mem_gb": [o["peak_mem_gb"] for o in outs],
           "section_s": [o["section_s"] for o in outs], "one_rank_err": max(errs),
           "rounds": []}
    launches_total: dict = {}
    for i, scope in enumerate(("sync_step", "compressed_step")):
        by_kind, calls, launches = {}, {}, {}
        for o in outs:
            r = o["train"][i]
            for d, src in ((by_kind, r["wire"]), (calls, r["calls"]),
                           (launches, r["launches"])):
                for k, v in src.items():
                    d[k] = d.get(k, 0) + v
        wire_bits = sum(v for k, v in by_kind.items()
                        if not k.startswith(("model/", "fsdp/"))) * 8.0 / 2
        booked = sum(v for k, v in lead["ledger"] if k[0] == scope and k[1] == "up")
        require(wire_bits == booked, f"mesh_fsdp {scope}: wire {wire_bits} bits a worker != "
                                     f"booked {booked} ({by_kind})")
        fs_calls = sum(v for k, v in calls.items() if k.startswith("fsdp/")) // 2
        secs = max(o["train"][i]["seconds"] for o in outs)
        out["rounds"].append({"scope": scope, "seconds": secs, "wire_up_bits": wire_bits,
                              "bytes": by_kind, "fsdp_calls_a_worker": fs_calls,
                              "launches": launches})
        for k, v in launches.items():
            launches_total[k] = launches_total.get(k, 0) + v
        print(f"mesh_fsdp {scope}: {secs:.3f} s on host-staged gloo (not NVLink), wire "
              f"{wire_bits:.0f} bits a worker = booked, fsdp/... collectives a worker pass "
              f"{fs_calls}, bytes by kind {by_kind}, launches {launches}", flush=True)
    if DEVICE == "cuda":
        comp = out["rounds"][1]["launches"]
        # rows 10 and 2 on each rank's share: every leaf a data-rank pair,
        # final_norm (held whole over "data") on data rank 0 only
        require(comp.get("randk_gather") == comp.get("scatter_accum") == 2 * (2 * nleaf - 1),
                f"mesh_fsdp compressed round launches {comp}")
    serve_rep = [o["serve"] for o in outs]
    require(all(s["streams"] == serve_rep[0]["streams"] for s in serve_rep),
            "mesh_fsdp: ranks' streams")
    # one slot a rank: the slots' tokens and K/V rows crossed the data group
    require(all({"fsdp/tokens", "fsdp/kv_rows"} <= set(s["kinds"]) for s in serve_rep),
            f"mesh_fsdp serve kinds {serve_rep[0]['kinds']}")
    plain = outs[1]["plain"]
    diverged = compare_streams("mesh_fsdp serve (4 ranks vs 1)", serve_rep[0]["streams"],
                               plain["streams"], plain["margins"])
    sl: dict = {}
    for s in serve_rep:
        for k, v in s["launches"].items():
            sl[k] = sl.get(k, 0) + v
    if DEVICE == "cuda":
        require(sl.get("paged_attn_decode", 0) > 0, f"mesh_fsdp serve launches {sl}")
    out["serve"] = {"decode_steps": serve_rep[0]["decode_steps"], "launches": sl,
                    "seconds": [s["seconds"] for s in serve_rep], "diverged": diverged,
                    "bytes": serve_rep[0]["bytes"]}
    print(f"mesh_fsdp: parameters a rank {out['params_a_rank']} "
          f"({[round(b / 1e9, 3) for b in out['param_bytes']]} GB); peak memory a rank "
          f"{[round(g, 2) for g in out['peak_mem_gb']]} GB; against one rank {max(errs):.3g} "
          f"of a leaf's scale; serve streams equal one rank's (near ties {diverged}), "
          f"launches {sl}; sections {out['section_s']}", flush=True)
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    report["mesh_fsdp"] = out
    print(f"mesh_fsdp phase: {secs:.1f} s (budget {MESH_FSDP_BUDGET_S:.0f}) on {card}",
          flush=True)
    require(secs <= MESH_FSDP_BUDGET_S, f"mesh_fsdp phase took {secs:.1f} s")
    names = kernels.KERNELS
    return {"mesh_fsdp_train": {k: launches_total.get(k, 0) for k in names},
            "mesh_fsdp_serve": {k: sl.get(k, 0) for k in names}}


def _memory_line(entry: dict) -> str:
    """A card step's counted memory (``roofline.memory.MemoryCounter``:
    peak, temp, argument, output, the operator at the peak) beside the
    allocator's peak less what it held at entry beyond the arguments."""
    ma, cmp = entry["memory_analysis"], entry["memory_vs_allocator"]
    return (f"memory counted peak {cmp['counted'] / 1e9:.3f} GB at {entry['peak_memory_op']} "
            f"(temp {ma['temp_size_in_bytes'] / 1e9:.3f}, argument "
            f"{ma['argument_size_in_bytes'] / 1e9:.3f}, output "
            f"{ma['output_size_in_bytes'] / 1e9:.3f}, alias {ma['alias_size_in_bytes'] / 1e9:.3f}"
            f" GB); allocator peak {cmp['allocator'] / 1e9:.3f} GB beyond what it held at entry "
            f"({entry['peak_memory_per_device'] / 1e9:.3f} raw, "
            f"{entry['allocated_at_entry'] / 1e9:.3f} at entry): gap {cmp['gap'] / 1e9:+.3f} GB "
            f"({cmp['gap'] / cmp['allocator'] * 100:+.2f} %), allowed "
            f"{cmp['tolerance'][0] / 2**20:+.0f} to {cmp['tolerance'][1] / 2**20:+.0f} MiB")


def _check_memory(what: str, entry: dict) -> None:
    """Print a card step's counted memory beside the allocator's and
    require the gap within tolerance."""
    cmp = entry.get("memory_vs_allocator")
    require(cmp is not None, f"{what}: no counted memory ({entry.get('memory_analysis')})")
    print(f"{what}: {_memory_line(entry)}", flush=True)
    require(cmp["within"], f"{what}: counted peak {cmp['counted']:.0f} B against the "
                           f"allocator's {cmp['allocator']:.0f} B: gap {cmp['gap']:+.0f} B outside "
                           f"{cmp['tolerance']}")


def _roofline_line(entry: dict) -> str:
    peak = entry.get("peak_memory_per_device")
    return (f"peak {peak / 1e9:.3f} GB a device, " if peak is not None else "") + (
        f"compute {entry['compute_s'] * 1e3:.2f} ms, memory {entry['memory_s'] * 1e3:.2f} "
        f"ms, collective {entry['collective_s'] * 1e3:.2f} ms, dominant {entry['dominant']}, "
        f"inputs {entry['arg_bytes_per_device'] / 1e9:.3f} GB")


def _collectives_line(entry: dict, before: tuple) -> str:
    """A step's collectives by op (count × priced GB) and peak memory, each
    beside the all-gather sums' figures (``DRYRUN_ALL_GATHER_SUMS``)."""
    peak0, ops0 = before
    counts, wire = entry["collective_counts"], entry["collective_by_kind_bytes"]
    ops = ", ".join(
        f"{op} {counts.get(op, 0)} × {wire.get(op, 0) / 1e9:.4f} GB (before "
        f"{ops0[op][0]} × {ops0[op][1] / 1e9:.4f})" if op in ops0 else
        f"{op} {counts[op]} × {wire[op] / 1e9:.4f} GB (before none)"
        for op in sorted(set(counts) | set(ops0)))
    peak = entry.get("peak_memory_per_device")
    total0 = sum(b for _c, b in ops0.values())
    return (f"collectives {entry['collective_bytes_per_device'] / 1e9:.4f} GB a device "
            f"(before {total0 / 1e9:.4f}), collective {entry['collective_s']:.4f} s; {ops}; "
            f"peak {peak / 1e9:.3f} GB (before {peak0 / 1e9:.3f})")


def run_dryrun(report: dict) -> dict:
    """Phase 16 (module doc): the dry run's card entries on the stand-in
    mesh. Must take at most DRYRUN_BUDGET_S."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch import dryrun, perf

    t_phase = time.perf_counter()
    card = report.get("card", "")
    gc.collect()
    torch.cuda.empty_cache()
    out, launches = {}, {}
    with open(DRYRUN_REF_FILE) as f:
        ref = json.load(f)
    xla = {}
    for name, s in ref["steps"].items():
        ma = s["memory_analysis"]
        xla[name] = (ma["argument_size_in_bytes"] + ma["output_size_in_bytes"]
                     + ma["temp_size_in_bytes"] - ma["alias_size_in_bytes"]) / 1e9
    # the steps the phase runs (the time): train_step repeats the compressed
    # step here (c_k = 0 under the key); llama4's compressed step takes ~70 s
    # on the card, so its sync step stands for the fsdp layout here and the
    # CLI (``--device cuda``) records the rest
    for arch, shape, mesh, steps in (
            ("qwen1.5-0.5b", "train_4k", "single", ("sync_step", "compressed_step")),
            ("llama4-scout-17b-a16e", "train_4k", "multi", ("sync_step",))):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = dryrun.run_one(arch, shape, mesh, device=DEVICE, steps=steps)
        _sync()
        key = f"{arch}__{shape}__{mesh}"
        launches[key] = {k: v for k, v in kernels.launch_counts().items() if v}
        for sname, s in res["steps"].items():
            require(s.get("ok"), f"dryrun {key} {sname}: {s.get('error')}")
            extra = (f"; the reference's XLA estimate {xla[sname]:.2f} GB a device (a "
                     "compiler's estimate for the TPU program, not compared)"
                     if arch == "qwen1.5-0.5b" else "")
            print(f"dryrun {key} {sname}: {_roofline_line(s)}{extra}", flush=True)
            _check_memory(f"dryrun {key} {sname}", s)
            print(f"dryrun {key} {sname}: "
                  f"{_collectives_line(s, DRYRUN_ALL_GATHER_SUMS[key][sname])}", flush=True)
            # every sum of the step over a group of 16 ran as a rank-ordered
            # reduce-scatter (an all-to-all) then an all-gather
            sums = s["collective_counts"].get("model/all-to-all", 0)
            require(sums > 0, f"dryrun {key} {sname}: no model-axis sum went through the "
                              f"reduce-scatter ({s['collective_counts']})")
        out[key] = {"seconds": time.perf_counter() - t0, "launches": launches[key],
                    "steps": {n: {k: s.get(k) for k in (
                        "peak_memory_per_device", "compute_s", "memory_s", "collective_s",
                        "dominant", "flops_per_device", "bytes_per_device",
                        "collective_bytes_per_device", "arg_bytes_per_device", "run_s",
                        "collective_counts", "collective_by_kind_bytes", *DRYRUN_MEMORY_KEYS)}
                        for n, s in res["steps"].items()}}
        if arch.startswith("llama4"):
            b = res.get("local_params")
            require(b == LLAMA4_FSDP_DEVICE_PARAMS, f"dryrun llama4 parameters a device {b}")
        gc.collect()
        torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = perf.run_variant("qwen1.5-0.5b", "decode_32k", "single", "paged_decode",
                           device=DEVICE)
    _sync()
    key = "qwen1.5-0.5b__decode_32k__single__paged_decode"
    launches[key] = {k: v for k, v in kernels.launch_counts().items() if v}
    for sname, s in res["steps"].items():
        require(s.get("ok"), f"perf {key} {sname}: {s.get('error')}")
        print(f"perf {key} {sname}: {_roofline_line(s)}", flush=True)
        _check_memory(f"perf {key} {sname}", s)
    require(launches[key].get("paged_attn_decode", 0) > 0, f"perf {key} launches "
                                                           f"{launches[key]}")
    out[key] = {"seconds": time.perf_counter() - t0, "launches": launches[key],
                "decode_bound": res["steps"]["paged_decode_step"].get("decode_bound"),
                "steps": {n: {k: s.get(k) for k in (
                    "peak_memory_per_device", "compute_s", "memory_s", "collective_s",
                    "dominant", "arg_bytes_per_device", "run_s", *DRYRUN_MEMORY_KEYS)}
                    for n, s in res["steps"].items()}}
    gc.collect()
    torch.cuda.empty_cache()
    k = "qwen1.5-0.5b__train_4k__single"
    require(launches[k].get("randk_gather", 0) > 0 and launches[k].get("scatter_accum", 0) > 0,
            f"dryrun {k} launches {launches[k]}")
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    report["dryrun"] = out
    print(f"dryrun phase: {secs:.1f} s (budget {DRYRUN_BUDGET_S:.0f}) on {card}; launches "
          f"{launches}", flush=True)
    require(secs <= DRYRUN_BUDGET_S, f"dryrun phase took {secs:.1f} s")
    names = kernels.KERNELS
    total: dict = {}
    for counts in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return {"dryrun": {k: total.get(k, 0) for k in names}}


def _summed(per_round: list) -> dict:
    total: dict = {}
    for counts in per_round:
        for name, k in counts.items():
            total[name] = total.get(name, 0) + k
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.core import make_layout
    from repro_torch.kernels import _build
    from repro_torch.models import init_params

    card = nvidia_smi_line()
    print(f"device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    report: dict = {"card": card}
    secs, logs = _build.build_all()
    report["build_seconds"] = secs
    print(f"build: {secs:.2f} s for {len(logs)} sources", flush=True)
    for name, log in logs.items():  # registers, shared memory, spills (paged: by kernel)
        keep = ("Used", "spill", "entry function") if name == "paged" else ("Used", "spill")
        print("\n".join(f"ptxas {name}: {line.strip()}" for line in log.splitlines()
                        if any(k in line for k in keep)), flush=True)

    shapes = init_params(SEED, get_arch("qwen1.5-0.5b").model, device="meta")
    nblk = make_layout(shapes, block=BLOCK).nblk
    rows = check_kernels(nblk, card, report)
    rows.update(check_permk_delta(nblk, card, report))
    rows.update(check_quantize(nblk, card, report))
    rows.update(check_natural(nblk, card, report))
    rows.update(check_trimmed(nblk, card, report))
    rows.update(check_serve_kernels(card, report))
    rows.update(check_wire_kernels(nblk, card, report))
    check_gather_floors(nblk, card, report, rows)
    check_transport_widths(card, report, rows)
    check_small_input(report)
    check_families_small_input(report)
    check_families_small_input(report, SMALL_RECURRENT, "small_input_recurrent")
    check_serve_small_input(report)
    launches = run_main_path(report)
    launches.update(run_resume(report))
    launches.update(run_wire_path(report))
    launches.update(run_serve_paths(report))
    launches.update(run_families(report))
    launches.update(run_recurrent(report))
    launches.update(run_launch(report))
    launches.update(run_mesh_model(report))
    launches.update(run_mesh_fsdp(report))
    launches.update(run_dryrun(report))

    table = []
    for name, (source, replaces) in SOURCES.items():
        by_path = {path: counts[name] for path, counts in launches.items()}
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": sum(by_path.values()),
                      "launches_by_path": by_path,
                      **{k: rows[name][k] for k in (
                          "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms", "b2b_ms", "plain_b2b_ms", "library_b2b_ms")},
                      **{k: rows[name][k] for k in TABLE_EXTRA if k in rows[name]}})
    print("report: " + json.dumps(report))
    print(json.dumps({"kernels": table}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
