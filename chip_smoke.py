"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its lines:

1. card: the card's name and power limit as nvidia-smi prints them, then
   the nvcc builds of the two kernel libraries (the three verify kernels
   and the challenge kernel in one unit, ``g1_aggregate`` in another) and
   of the probe unit, all three nvcc calls started together, from the
   sources in this checkout, with
   each kernel's registers, stack and spills as ptxas reports them; then
   the g++ build of the native host runtime (``hyperdrive_tpu_torch/
   native``: signer, packers, host verifier) and its host times a
   signature, a packed item and a host verification beside the
   pure-Python oracle's, on a line that begins ``native: loaded``
   (``HD_NO_NATIVE`` set, or a failed build, is an error here, not a
   fallback);
1b. the multi-device programs (``phase_mesh``, lines ``mesh``; early, so
   it is its own probe of NCCL) on a world-size-1 NCCL group (the card
   machine has one card): ``sharded_verify_tally`` (A) and
   ``sharded_chalwire_tally`` (B) on a 16 x 256 window with four corrupt
   lanes, masks against the host oracle and counts and flags against the
   single-device tally, one ``ed25519_verify`` launch (A) and one each of
   ``ed25519_challenge`` and ``ed25519_semiwire`` (B) a call, ms a call,
   the all-reduce's share, bound and CUDA kernels a call;
   ``challenge_from_round`` at 15 rounds in the 4,096-lane bucket against
   its plain version (zero-digest padding lanes included), and past 255
   rounds: 256 rounds x 16 validators (a full 256-row digest table, the
   grouped form) and 300 rounds x 8 (301 rows with the zero row, the
   per-lane form), each one counted ``ed25519_challenge`` launch equal
   byte for byte to the plain version; the sharded
   ``VoteGrid``'s counts against the single-device grid's over a seeded
   settle sequence and both grids' ``update_and_tally`` time; (C) the main
   path with ``tally_mesh`` on the invariant, every count checked
   (``CheckedTallyView``), two launches a settle, in turns with the
   single-device two-launch run; (D) ``make_sharded_step``'s example args
   counting nothing;
2. kernels against their plain PyTorch versions on the card, mask for mask
   on every lane, on mixed lanes made from a fixed seed:
   - ``ed25519_verify`` (packed limbs) at the verifier's bucket sizes (64,
     256, 1024, 4096) and one 65,536-lane batch (16 launches of 4096);
   - ``ed25519_wire`` (raw wire rows) at 64 to 4096 lanes, with the
     decompression edge encodings as A and as R in raw rows that no
     prevalid mask covers;
   - ``ed25519_semiwire`` (table-indexed A) at 64 to 65,536 lanes, with
     the edge encodings as R and lanes on a table slot that holds a bogus
     pubkey;
   each with a 256-lane sample against the host oracle, kernel and plain
   times (CUDA events), threads per signature, the operation bound (the
   multiply instructions of the 8 x 32-bit field for the same work) and
   its share; then the 256-lane time of each wire kernel over
   ``ed25519_verify``'s in the same run;
3. ``ed25519_challenge`` (SHA-512 and the reduction mod L in one kernel,
   two warps a 32 lanes): k rows of a 256-lane sample equal the host's
   challenge scalars on both forms (per-lane and grouped digests); edge
   lanes against the plain version (n = 1, 31, 33; indices outside the
   table and digest indices at or above U, which read zeros); kernel
   against its plain version (the PyTorch-ops leg) byte for byte on both
   forms at 64 lanes (the deployment capstone's bucket), 256, 1,024 (the
   pipelined runs' coalesced batch) and 4,096, with edge digests (all-zero
   and all-0xff M) and R = 0xff...; before the timings, from the probe
   unit (``csrc/ed25519_probe.cu``, built beside the libraries): the
   empty kernel's device time at the kernel's grid (``floor:``), the
   dependent latency and issue interval of the round's integer
   instructions (``latency:``) and the kernel's SASS, executed
   instructions by warp and dependent chain (``sass:``); kernel and plain
   times, the integer-instruction bound and its share; at each width the
   kernel alone (``kernel ed25519_challenge alone:``): its device time
   under the profiler (or, when CUPTI records none, between CUDA events
   queued behind a spin kernel; ``device_ms_by=`` says which) over direct
   ``hd_ed25519_challenge`` calls, 100
   back-to-back wrapper and direct calls between two CUDA events with the
   host's enqueue time a call, the throughput bound, the latency bound
   (``depth_challenge`` at the measured latency) and, as diagnostics, the
   busiest warp's issue time and the floor; phase stamps of the kernel at
   256 and 4,096 lanes (``stamps:``, clock64 cycles since entry by warp);
   the ratio to the first design's recorded times (``redesign:``); and
   ``chal_semiwire_verify`` (both kernels in one library call) against
   the two wrapper calls at 256 and 4,096 lanes, verdicts and k rows
   equal, with both paths' host times (``chal_semiwire:``);
4. the vote grid (``ops/votegrid.py``, PyTorch ops, no hand-written
   kernel) at the main path's shape (n = V = 256, R = 4): one seeded
   sequence of settles (scatters with resets and L28 lanes, an empty
   launch, fused merges with lanes written twice and replicas that do not
   participate) replayed on the card and on the CPU, grids and counts
   equal bit for bit after every step; one fused call whose verify is
   ``ed25519_verify`` on a 256-lane mixed window, its mask equal to
   ``verify_plain``'s and its counts to the CPU grid's fed that mask; then
   the device time (CUDA events) of ``update_and_tally`` at 65,536 rows,
   of the fused call with and without the verify kernel, and of the
   verify alone, the CUDA kernels one call launches (``torch.profiler``)
   and the bound (the grid's bytes read once at the memory rate), on
   lines that begin ``programs:``;
5. main path: the signed 256-validator burst network
   (``Simulation(n=256, sign=True, burst=True, dedup_verify=True,
   small_window_host=False)``, its lockstep windows ingested on the
   columnar path, the default) to height 5, five times, every settle
   verified on the card: through the packed verifier (``ed25519_verify``),
   through ``TorchWireVerifier`` with a ``ValidatorTable`` of the 256
   validator keys (grouped challenge route, ``ed25519_challenge`` then
   ``ed25519_semiwire``), through ``TorchWireVerifier`` with no table
   (full wire route, ``ed25519_wire``), and with ``device_tally=True,
   tally_check=CheckedTallyView`` through the packed verifier (every
   vote-bearing settle verified, merged and tallied in one fused call)
   and through the table's challenge route (verify, then a separate tally
   launch on every settle); the challenge routes make one library call a
   settle (``chal_semiwire_calls``). Each run is checked for safety, against one
   run with the host verifier (digest, steps, heights), and for having
   launched its own kernels, each at least once per vote-bearing settle,
   and no other; the device-tally runs also for device counts consulted
   (and equal to the host's) and for their settle routes. Every run signs,
   packs and host-verifies natively; ``packed`` runs once more in a child
   process with ``HD_NO_NATIVE=1`` (``packed (python host)``) for the
   shares of the pure-Python host in the same call;
6. pipelined heights: the same network with ``pipeline_heights=True``
   (``packed+pipe``, ``chal+pipe``, and ``packed+tally+pipe``, the
   README's config-4 call with ``device_tally=True,
   tally_check=CheckedTallyView``), each verifier on the buckets of the
   JAX package's config-4 pipelined benchmark (1,024 lanes up), so that
   the device-work queue coalesces settles into fewer launches than it
   was handed commands. Each run commits the host run's digest; each own
   kernel launched once for every chunk of every queue launch and no
   other kernel ran; the device-tally run dispatched on the host counters
   (no fused settle, no tally launch, no host-routed settle). Then the
   sequential and the pipelined packed run in turns, two pairs each
   way, on lines that begin ``pairs:`` (walls, median, spread);
7. burst-mode delivery (``phase_burst``, lines ``burst``): (i) the main
   path on the object path (``columnar_ingest=False``: packed,
   packed+tally, chal+tally) and per delivery (``shared_superstep=False``,
   packed), each checked as in phase 5 and printed beside the invariant's
   15 settle passes, 10 vote-bearing and 2,565 signatures, then the
   columnar and the object path in turns (``pairs:``); (ii) redundant
   verification (``dedup_verify=False``: every receiver's copy on the
   card) on the challenge route (``ValidatorTable``) and the full wire
   route, each with ``pipeline_verify`` on (replica groups of one bucket,
   ``verify_signatures_begin(items, repeats=)``) and off, launches, begin
   calls, wall and verify share; (iii) BASELINE config 3's adversaries at
   its size (n = 64, seed 1003, replicas 1-21 offline, reorder, 20 s
   timeouts, 1 ms a delivery), signed and dedup-verified, cut to 2
   heights, on four legs: ``HostVerifier``, the packed verifier on every
   settle, the same with device tallies (``CheckedTallyView``), and
   ``AdaptiveVerifier`` on the packed verifier (calibrated on one
   512-signature window first), each committing the host leg's digest in
   its steps, with settles, window p50, launches, wall and the calibration
   record; (iv) one signed n = 256 window through
   ``DeviceTallyFlusher.settle_block`` on the card against the object-path
   flush of the same window (commits, counts, checkpoint bytes);
8. lock-step delivery (``phase_lockstep``, lines ``lockstep``):
   ``Simulation(burst=False)``, one message at a time, on BASELINE config
   2's network (n = 16, seed 1002, 20 s timeouts, 1 ms a delivery, cut to
   20 heights) and config 3's (n = 64, seed 1003, replicas 1-21 offline,
   reorder, cut to 2 heights), every leg on the JAX package's commit
   digest and steps: unsigned (its dump equal to the JAX package's bytes
   by SHA-256 prefix and size); signed with a ``HostVerifier`` a replica;
   with a card ``TorchBatchVerifier`` a replica (``verifier_for``, one
   ``ed25519_verify`` launch a flushed window); with ``QueueFlusher``
   replicas sharing one card verifier behind a ``DeviceWorkQueue`` at
   depths 8 and 64 (``devsched=``, ``flusher_for=``: one launch a drain,
   the JAX run's queue launches); with ``DeviceTallyFlusher`` replicas on
   one ``TorchWireVerifier`` with the ring's ``ValidatorTable`` behind the
   queue (``ed25519_challenge`` and ``ed25519_semiwire`` once a queue
   launch, a grid call a window); config 3 unsigned (dump against the
   JAX bytes) and signed on the shared card verifier at depth 64. Each
   line: wall, steps, digest, launches of each kernel, the queue's
   submitted / launches / coalesced. Then the config-2 queue leg's and
   the n = 256 main path's records dumped, loaded and replayed on the
   card (``Simulation.replay``: a shared card verifier a replica; the
   packed batch verifier on the main path's supersteps) to the live
   runs' commits, and the main path with ``record=False`` against the
   default in turns (``pairs:``);
9. the aggregation overlay and table generations (``phase_overlay``, lines
   ``overlay`` and ``generations``): the overlay bench's network (seed 29,
   2 heights, 1 ms a delivery), every leg on the all-to-all chain in the
   JAX run's steps, frames, garbage frames and verify rows: n = 256
   unsigned beside its all-to-all run; n = 256 signed, each vote verified
   once network-wide by one shared card ``TorchBatchVerifier`` behind the
   queue (an ``ed25519_verify`` launch a verify row: the overlay drains
   after every submit); n = 1,024 signed with ``coalesce_ingest`` and
   ``record=False`` (cut from the bench's 4,096); Byzantine contributors
   at n = 64 (100 garbage frames, only peer 2 demoted); ``bls_partials``
   at n = 16 (a ``g1_aggregate`` launch a merge, through the
   ``G1SumLauncher``); the n = 16 unsigned dump against the JAX bytes,
   replayed with no overlay wiring. Then a ``DeviceTallyFlusher`` on a
   table ``TorchWireVerifier`` rotating to the next generation (one member
   rekeyed) between its queued windows, two windows a generation in one
   drain: one launch a generation, with a table that keeps the retired key
   (``ed25519_challenge`` + ``ed25519_semiwire`` twice) and with the next
   table only (the old generation on ``ed25519_wire``), verdicts against
   ``HostVerifier`` and the plain version; config 2's network with
   stake-driven epochs and a ``DeviceLedgerExecutor`` a replica on the
   card (the JAX run's digest, steps and committees); BLS certificates in
   an epoch run with ``bls_certificates="device"`` (``g1_aggregate``
   launches counted);
10. chaos and open-loop load (``phase_chaos``, lines ``chaos``): config
   2's network (n = 16, seed 1002, 1 ms a delivery, 20 heights), signed,
   1 s timeouts, under ``FaultPlan.seeded(1002, 16)`` (a partition of
   five replicas, one of them crashed and restored from its checkpoint,
   three faulty links), an ``InvariantMonitor`` armed, every leg on the
   JAX package's digest and steps: ``queue`` (``QueueFlusher`` replicas on
   one card ``TorchBatchVerifier`` behind a depth-8 queue: ``ed25519_verify``
   only, the JAX run's queue counts, lifecycle and dump bytes); ``cancel``
   (the crash moved to step 254 and restored one step later: the restore
   cancels a window in flight, which is never launched); ``tally``
   (``DeviceTallyFlusher`` replicas on one ``TorchWireVerifier`` with the
   ring's ``ValidatorTable``, 8 heights: rows 3 and 4 only, the victim's
   grid plane reset after its restore); ``replay`` (the queue leg's
   record, with its crash and restore, dumped, loaded and replayed on the
   card verifier a replica, to the live commits); ``overload``
   (``FaultPlan.overload(1002, 16)``: the same chain, the JAX run's
   overload snapshot, launches and verified rows beside the queue leg's);
   ``escalation`` (the same with ``pin=False``: the controller watches
   the card queue; the JAX run's level and transitions);
11. attack campaigns (``phase_campaign``, lines ``campaign``): the storm,
   capture and coincidence families at ``CampaignConfig()`` (1,024
   validators, committee 64, seed 0) through ``run_campaign`` on a card
   ``TorchBatchVerifier`` (one ``ed25519_verify`` launch a wave), each on
   the JAX run's digest with no violation, its launches equal to its
   verify calls and their rows, and replayed (``replay_campaign(device=
   "cuda")``) to the same digest; then the storm at the campaign bench's
   shape (committee 32, 8 attackers, 120 waves) with the reputation loop
   on and off: digests, launches, rows verified and failed, demotions,
   wall and verify share; one wave of every storm leg with its card mask
   against ``verify_plain``'s and ``HostVerifier``'s;
12. the multi-tenant verify service (``phase_service``, lines
   ``service``): the multi-tenant bench's series (16-validator tenants, M
   = 1, 2, 4, 8, 16, a warm-up wave and 4 heights) through one shared
   ``ShardVerifyService`` and through M dedicated ones on the same card
   verifier: digests equal to a ``HostVerifier`` run, 5 launches shared
   (16 M rows each) and 5 M dedicated, walls and votes/s; the fairness
   leg (a 48-validator firehose and a 4-validator victim, FIFO against
   ``DeficitRoundRobin``, 3 repetitions): the starvation bound, the
   victim's p99; a ``ServicePort`` on 127.0.0.1 with a
   ``RemoteServiceClient`` tenant beside three local ones, pinned at
   CRITICAL_ONLY until the first busy answer: its digest equal to its
   local run, fewer launches than submissions, every certificate
   verified, the shed window resubmitted; execution-attached tenants:
   roots equal to the host executor's, a proof query verified against
   the certified root, a rotation to generation 1 mid-serve reaching the
   card verifier's ``set_generation`` with roots and digest unchanged;
13. the deployment path: threaded replicas on a loopback-TCP full mesh,
   one worker process per port (``python -m
   hyperdrive_tpu_torch.harness.deploy ... card``), each process with one
   ``TorchWireVerifier`` (a ``ValidatorTable`` of the network's keys:
   ``ed25519_challenge`` then ``ed25519_semiwire`` on every flush) and one
   ``DeviceTallyFlusher`` (an n = 1 vote grid, every count checked by
   ``CheckedTallyView``) per replica, replicas on their own threads with
   wall-clock timeouts. Two runs: ``capstone`` (the JAX package's
   two-process capstone: n = 4, two processes x two replicas, ten
   heights, 64-lane buckets, every flush's card mask held against
   ``HostVerifier``'s) and ``full`` (n = 256, four processes x 64
   replicas, three heights, default buckets, 20 s timeouts, 300 s
   deadline). Each checked for equal digests across the processes, the
   device counts consulted, grouped lanes, and both kernels launched in
   every worker; each worker's wall, heights/s, flushes, launches, lanes,
   verify and tally shares, commit rounds and shed frames on lines that
   begin ``deploy``. Before them, ``deploy contention:`` lines: a flush's
   grid call (n = 1, V = 256) and verify call (100 grouped lanes), host
   wall per call from one thread and from 64 threads of this process;
14. Shamir reconstruct (``ops/shamir.py``, PyTorch ops, no hand-written
   kernel): ``BatchReconstructor`` on the card at k = 171 (n = 256, f =
   85) for 16, 64 and 1,024 blocks, every payload equal byte for byte to
   the oracle's ``reconstruct_payload`` (at 1,024 blocks: to the payload,
   to the host leg, and 40 sampled blocks to the oracle's
   ``reconstruct_block``); ms of ``reconstruct_kernel`` (CUDA events),
   CUDA kernels a call, the bound and its share, the wrapper's and the
   host leg's wall; ``AdaptiveReconstructor``'s calibration record at
   1,024 blocks; on lines that begin ``programs: shamir``;
15. the RLC batch equation (``rlc_check`` on ``ops/msm.py``, PyTorch ops):
   one 64-lane MSM equal to the oracle's point sum; then
   ``TorchBatchVerifier(rlc=True)`` at 64 and 4,096 lanes: a
   clean batch accepted by one check with no fallback and no ladder
   launch, a batch with one forged lane falling back once with its mask
   equal to ``ed25519_verify``'s and the oracle's, and (64 lanes) the
   order-8 torsion vector accepted by the RLC and rejected by the ladder;
   ms and CUDA kernels of ``rlc_check`` beside the ladder's time at the
   same lanes; on lines that begin ``programs: rlc``;
16. config 5 (BASELINE configs[4]) as the JAX package's bench runs it
   (n = 256, k = 171, 496-byte payloads, seed 1005, 20 s timeouts,
   burst, 10 heights), signed (every settle on ``ed25519_verify``): the
   host run (``HostVerifier``), a run with
   ``BatchReconstructor`` pinned on the card (one reconstruct launch a
   committed value) and one with the adaptive default (16-block commits
   on the host leg: no launch); each equal to the host run in digest,
   steps and every replica's reconstructed payloads; heights/s, the
   reconstruct share of wall and its p50, launches; lines ``config5``;
17. certificates: the main path with ``certificates=True`` through the
   packed verifier with ``rlc=False`` and ``rlc=True``: digest
   ``215413db54656240`` in 656,640 steps, chain digests equal across
   replicas and to a host run's, every certificate re-verified and
   round-tripped through its codec, the RLC run's checks, fallbacks and
   wall; lines ``certs``;
18. the execution layer (``exec/``, ``ops/ledger.py``, ``ops/merkle.py``,
   PyTorch ops, no hand-written kernel) at the JAX package's documented
   sizes: one Merkleized apply step at 65,536 accounts and 16,384
   (incremental tree update) and 65,536 txs (full rebuild), every output
   equal to the host executor's, ms (CUDA events), CUDA kernels a call and
   the bound by bytes (``programs: exec``); leg A, the n = 256 network
   sequential with a ``DeviceLedgerExecutor`` a replica (65,536 accounts,
   16,384-tx blocks, three heights), every replica's commit record equal
   to the value and the host executor's root, heights/s, apply and
   block-synthesis shares; leg B, pipelined, speculative and signed (4,096
   accounts, 1,024 txs a block, every 7th signature forged, five
   heights), fused on the card, fused with the host executor and
   two-kind on the card: rollbacks, no discarded root committed, commits
   equal across the three and the JAX package's digest, fewer
   ``ed25519_verify`` launches fused, and the blocks' signature rows
   verified by ``ed25519_verify``; lines ``exec``;
19. BLS12-381 (``phase_bls``): ``fp381.mul`` (PyTorch ops) on 4,096 products
   against Python ints; the ``g1_aggregate`` kernel (``csrc/g1_aggregate.cu``,
   built in phase 1 beside the ed25519 library, one nvcc a unit, both
   started together) against its plain version ``aggregate_kernel`` at the
   JAX package's bench widths (256, 1,024 and 4,096 lanes, masks about
   two-thirds set), on edge lanes (an all-masked committee, identity rows,
   P and -P, P twice), at odd widths 5 and 255, at widths 1, 2 and 3, at
   32,768 lanes (above what a cluster's shared memory holds: the sums in
   the global scratch) and on a batched 8 x 256 call through
   ``G1SumLauncher`` (one launch), every coordinate equal after
   ``canonical`` and every affine sum equal to the oracle's fold; kernel
   ms (CUDA events), blocks and cluster, plain ms, host-fold s, the bound
   (multiply instructions of a 12 x 32-bit field), the ratio to the
   earlier design's recorded times (``redesign:``) and the plain
   version's CUDA kernels a call; ``g1_msm_kernel`` (PyTorch ops, 8 lanes, 64 windows)
   against the oracle; the n = 256 certificate minted on the kernel and
   on the host fold (equal aggregates, the light-client check passing and
   a forged height failing); then the certified sim (``Simulation(n=16,
   target_height=5, seed=1, sign=True, burst=True, dedup_verify=True,
   small_window_host=False, bls_certificates="device")``) on the card
   against its host run with the host fold: digest, steps and chain
   digests equal, ``g1_aggregate`` launched once a replica a commit and
   no kernel but it and ``ed25519_verify``, one certificate a height
   re-verified; heights/s and the aggregate's share of wall; lines
   ``bls``, ``kernel g1_aggregate`` and ``programs: bls``, after the
   card's name and power limit;
20. observability (``phase_obs``, lines ``obs``; it runs right after
   phase 6): the main path observed (``observe=True``) on the packed
   route, in turns with unobserved runs (unobserved, observed, observed,
   unobserved), each on the invariant; the observed run's journal equal,
   event for event, to an observed ``HostVerifier`` run's once the
   device-only kinds (``fetch.sync``, ``verify.occupancy.*``) are taken
   out, one ``verify.occupancy.rows`` a ``ed25519_verify`` launch, one
   ``fetch.sync`` a device fetch of the verifier (counted apart from the
   recorder), the same launches observed and not; the pipelined packed
   run observed under ``utils.trace.profile``: one launch record a
   kernel launch, each with a sync and its lanes from the bucket ladder,
   ``devtel.launches`` in ``metrics_snapshot()`` equal to the launches,
   the profiler's Chrome trace naming ``hd_ed25519_verify_kernel`` and
   the journal's Perfetto export holding one device launch slice a
   launch; then a ``DeviceWorkQueue`` probed by ``DeviceTelemetry`` on
   ``time.perf_counter`` with a ``VerifyLauncher`` on a card verifier, 20
   drains of 256 and 20 of 4,096 pre-signed lanes: p50 pack / dispatch /
   sync / unpack ms, the sync share, and the four splits summing to each
   launch's wall within 5%.
21. observability on the other subsystems (``phase_obs_net``, lines
   ``obs_net``; after phase 12): the overlay bench's network observed,
   n = 256 signed and n = 16 with ``bls_partials`` (rows 1 and 5), each
   journal equal to the JAX run's once the device-only kinds are out;
   the overload chaos leg observed with the monitor's journal check, the
   JAX run's count of every kind; the campaign bench's storm with a
   registry and a recorder, both digests the JAX run's; the M = 16
   service with every hook (a metrics scrape naming the queue's
   launches, per-tenant verify latency, a traced remote tenant whose
   journal merges with the service's without orphan); the capstone's
   network traced as four deployment workers of one replica each on the
   chal route (rows 3 and 4, 10 heights), the four journals they save
   merged with no orphaned ``trace.recv``.
22. the CLIs (``phase_cli``, lines ``cli``; after phase 18, before phase
   19): each ``python -m hyperdrive_tpu_torch.<sub>`` called in process
   through its ``main(argv)`` on the card, at small shapes: ``obs metrics
   --pipeline`` (n = 4, 5 heights; row 1) with ``record``, ``report``,
   ``export`` and ``benchdiff`` on its outputs; ``campaign run --family
   all`` at 64 validators (row 1, its stdout equal to the ``--device
   cpu`` run's) and ``replay`` of the storm's dump; ``ops msm-parity
   --rlc`` (row 1) and ``ops bls-parity --n 8`` (row 5); ``exec parity
   --pipelined`` (its signed legs verified by row 1, none on the host)
   and ``exec prove``; ``parallel serve --tenants 4 --heights 4
   --verifier device --remote-tenants 1`` (row 1); ``chaos soak`` (2
   scenarios, n = 4, target 3, every leg at cadence 1 or 2; rows 1 and 5,
   its stdout equal to the ``--device cpu`` run's with the paths and the
   metrics scrape's size masked), the same soak with ``HD_SANITIZE=1``
   (equal stdout) and ``chaos replay`` of the churn record it dumped. Each
   must exit 0 with every "ok" line of the reference; each CLI's wall and
   its launches of rows 1 and 5.
23. the runtime sanitizer (``phase_sanitize``, lines ``sanitize``; after
   phase 6, before phase 7) with ``HD_SANITIZE=1`` for the phase alone:
   the main path's invariant run armed on packed+tally and chal+tally
   (digest, steps, 15 settle passes, 10 vote-bearing, 2,565 signatures,
   all 256 replicas sanitized, every commit recounted from the host
   logs); the Byzantine-tally scenario with a card vote grid claiming a
   quorum the host logs lack, which must die with HDS001; one
   ``DeviceTallyFlusher`` on its default ``tally_check`` (HDS004), which
   must check at least one query; the phase's wall and row launches.
24. the entry points of ``entry.py`` (``phase_entry``, lines ``entry``; after
   phase 22, before phase 19): ``entry()``'s wire verify + tally step on
   signed votes (2 rounds x 32 validators, 13 corrupted lanes) on the card,
   lane for lane and count for count equal to the same step on
   ``device="cpu"``, in one counted ``ed25519_wire`` launch; then
   ``dryrun_multichip(1)`` over NCCL at world size 1 (rows 1, 4 and 3).

Each path of phases 1b, 5, 6, 7, 8, 10, 11, 12, 15, 16, 17, 18, 20, 21,
22, 23 and 24 is driven with the kernel counts set to 0 just before it and
read just after.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero; without CUDA it exits non-zero before printing a result.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

SEED = 20260
SIZES = (64, 256, 1024, 4096)
BIG = 65_536
POOL = 512
HEIGHT = 5
N_VALIDATORS = 256
#: Verify buckets of the pipelined runs: the JAX package's config-4
#: pipelined benchmark verifier (``benches/run_all.py``,
#: ``TpuBatchVerifier(buckets=(1024, 4096, 16384))``). With the default
#: ladder a 256-lane vote window fills its bucket alone, and the queue's
#: spill rule closes every pipeline slot after one settle.
PIPE_BUCKETS = (1024, 4096, 16384)
#: The largest coalesced settle batch of the pipelined runs (three vote
#: settles and a proposal) and the most distinct digests in one of them;
#: ``run_path`` checks both against the ``chal+pipe`` run, and
#: ``phase_challenge`` holds the kernel against its plain version there.
PIPE_BATCH, PIPE_DIGESTS = 770, 5
PATH_LANES = 256  # a vote window at n=256: one lane per validator
#: INT32 multiply-adds per SM per clock on compute capability 9.0 (the
#: CUDA C++ Programming Guide's arithmetic-instruction throughput table).
IMAD_PER_SM_CLOCK = 64
#: Device memory rate of an H100 SXM (NVIDIA's data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
BOGUS = b"\xff" * 32  # y >= p: never decompresses
#: Threads that work on one signature (lane), per kernel.
THREADS_PER_SIG = {"ed25519_verify": 4, "ed25519_wire": 4, "ed25519_semiwire": 4,
                   "ed25519_challenge": 1}
KERNELS = {
    "ed25519_verify": ("hyperdrive_tpu_torch/csrc/ed25519_verify.cu",
                       "hyperdrive_tpu/ops/ed25519_pallas.py:373"),
    "ed25519_wire": ("hyperdrive_tpu_torch/csrc/ed25519_wire.cu",
                     "hyperdrive_tpu/ops/ed25519_pallas.py:486"),
    "ed25519_semiwire": ("hyperdrive_tpu_torch/csrc/ed25519_wire.cu",
                         "hyperdrive_tpu/ops/ed25519_pallas.py:522"),
    "ed25519_challenge": ("hyperdrive_tpu_torch/csrc/ed25519_challenge.cu",
                          "hyperdrive_tpu/ops/sha512_jax.py:146 (with :345, under "
                          "hyperdrive_tpu/ops/ed25519_wire.py:328)"),
    "g1_aggregate": ("hyperdrive_tpu_torch/csrc/g1_aggregate.cu",
                     "hyperdrive_tpu/ops/g1.py:182 (batched by :246)"),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return float(out)


# Multiply instructions of the field operations of csrc/fe25519_w32.cuh (8
# x 32-bit limbs on carry chains): a product is 64 low and 64 high halves
# plus the fold's 16 + 2, a squaring 28 cross products (56 halves), 8
# squares (16) and the fold; an addition folds its carry twice as 38 * c;
# a subtraction folds its borrow with a mask; a canonical reduction
# multiplies bit 255 by 19; a table row of 20 x 13-bit limbs converts with
# one addition and one x38. The bound counts the work of one signature once
# (the reference's formulas, 2Z as an addition), in these costs, for the
# three verify kernels: the copies that the four-thread layout runs on
# idle threads are not counted, so it stays a lower bound.
MUL, SQR, ADD, SUB, CANON, LIMBS13 = 146, 90, 2, 0, 1, 3


def _dbl(need_t: bool) -> int:
    """_dbl: 4 squarings, 3 products (4 with T), X + Y, 2 Z^2 and G as
    additions, -A, E (two), F and H as subtractions."""
    return 4 * SQR + (4 if need_t else 3) * MUL + 3 * ADD + 5 * SUB


def _padd() -> int:
    """_padd with T: 8 products; Y + X, 2 Z z, G, H; Y - X, E, F."""
    return 8 * MUL + 4 * ADD + 3 * SUB


def _madd(need_t: bool) -> int:
    """_madd: 6 products (7 with T); Y + X, 2 Z, G, H; Y - X, E, F."""
    return (7 if need_t else 6) * MUL + 4 * ADD + 3 * SUB


def imad_ladder() -> int:
    """One signature's ladder: A' in niels form (1 product, 1 addition, 1
    subtraction), the [0..8]A' table (9 entries of 1 product, 2 additions
    and 1 subtraction; 8 affine additions with T), 64 windows of 4
    doublings, one projective and one affine addition and 2 entry
    negations, and the check (2 products, 2 subtractions, 2 canonical
    reductions)."""
    table = MUL + ADD + SUB + 9 * (MUL + 2 * ADD + SUB) + 8 * _madd(True)
    window = 3 * _dbl(False) + _dbl(True) + _padd() + _madd(False) + 2 * SUB
    check = 2 * MUL + 2 * SUB + 2 * CANON
    return table + 64 * window + check


def imad_decompress() -> int:
    """One decompression (csrc/decompress.cuh): 255 squarings and 18
    products (251 and 11 of them in the pow22523 chain), 2 additions, 3
    subtractions and 4 canonical reductions (3 zero tests, the parity)."""
    return 255 * SQR + 18 * MUL + 2 * ADD + 3 * SUB + 4 * CANON


def imad_per_signature(kernel: str) -> int:
    if kernel == "ed25519_verify":  # five limb rows converted
        return imad_ladder() + 5 * LIMBS13
    if kernel == "ed25519_wire":  # two decompressions, -A and t = x' * y
        return imad_ladder() + 2 * imad_decompress() + SUB + MUL
    return imad_ladder() + imad_decompress() + 3 * LIMBS13


#: Bytes each lane reads and writes once: packed limbs 5 x 80 + 2 x 256
#: in; wire rows 4 x 32 in; semiwire idx 4 + R, s, k rows 96 + its table
#: row 3 x 80 + 1 valid byte in; 1 verdict byte out.
BYTES_PER_LANE = {"ed25519_verify": 913, "ed25519_wire": 129,
                  "ed25519_semiwire": 342}


# Integer instructions of the challenge kernel (csrc/ed25519_challenge.cu),
# one for each 32-bit operation of the code: a 64-bit addition is 2 (a
# carry chain over the halves), a 64-bit rotation or shift 2 (funnel
# shifts), a three-input logic function of 64-bit words 2 (one LOP3 a
# half), a byte swap 1 (PRMT); in the reduction a 32 x 32 -> 64-bit
# multiply-add with its carry 2, a carry step or a subtraction step 2, a
# select 1. Counted at the same cc 9.0 rate as the multiply-adds (32-bit
# add, logic, shift and multiply-add all run at 64 per SM per clock).
ADD64, ROT64, LOGIC64, BSWAP, MACW, STEP = 2, 2, 2, 1, 2, 2
#: (limbs of ~b, limbs of the result) of each fold: hd_sc_reduce.
SC_FOLDS = ((9, 13), (5, 9), (1, 8))


def ops_challenge() -> int:
    """One lane: the 64 scheduled words (sigma0, sigma1: three rotations
    or shifts and one three-input xor each; three additions), the 80
    rounds (Sigma0, Sigma1, Ch, Maj; seven additions), the feed-forward,
    24 byte-swapped words in and 16 limbs out, the three folds (the a + c
    chain, ~b, the rows of 4 multiply-adds and their carry runs) and the
    two conditional subtractions of L."""
    sigma = 3 * ROT64 + LOGIC64
    schedule = 64 * (2 * sigma + 3 * ADD64)
    rounds = 80 * (2 * sigma + 2 * LOGIC64 + 7 * ADD64)
    digest = 8 * ADD64 + (24 + 16) * BSWAP
    folds = sum(nr * STEP + nb * (STEP + 4 * MACW)
                + STEP * sum(nr - 4 - i for i in range(nb)) for nb, nr in SC_FOLDS)
    return schedule + rounds + digest + folds + 2 * 8 * (STEP + 1)


# The challenge kernel's latency bound: one lane's dependent chain, in
# instructions, times the cycles from one integer instruction to the next
# that reads its result. Counted in the kernel's SASS (``sass_chain`` over
# ``cuobjdump -sass`` of the sm_90a build; ``phase_challenge`` prints the
# counts of the build it runs): the loop body of 16 rounds is 81
# instructions deep, 5 a round (a round's e and a chains run side by side:
# a funnel shift, a LOP3, a three-input addition and its carry, and one
# more addition for d + t1 or t1 + Sigma0 + Maj); the feed-forward, the
# three folds, the two subtractions of L and the store's selects after the
# rounds are 93 deep. The loads of the rows are not counted.
ROUND_DEPTH = 5
REDUCE_DEPTH = 93
#: Cycles from an integer instruction to one that reads its result on an
#: H100: the median over IADD3 (4.31), IADD3 -> IADD3.X carry pairs (5.06),
#: SHF (4.16), LOP3 (3.96) and IMAD (4.13), chip_smoke.py's chain probes
#: (``Probe.chains``; ``latency:`` lines, NVIDIA H100 80GB HBM3, 700.00 W).
DEP_LATENCY_CYCLES = 4.157


def depth_challenge() -> int:
    """One lane's dependent instructions (the rule above)."""
    return 80 * ROUND_DEPTH + REDUCE_DEPTH


def challenge_latency_ms(clock_mhz: float) -> float:
    return depth_challenge() * DEP_LATENCY_CYCLES / (clock_mhz * 1e3)


def challenge_bytes(lanes: int, uniq: int) -> int:
    """Bytes the challenge kernel must move: per lane the index 4, the R
    row and the A row 64 and the k row out 32; then the digest index 1 a
    lane and the digest table once (grouped, ``uniq`` rows), or a digest
    row a lane (per-lane, ``uniq`` 0)."""
    return lanes * 100 + (lanes + 32 * uniq if uniq else lanes * 32)


def bound_ms(kernel: str, lanes: int, clock_mhz: float, sms: int, uniq: int = 16):
    """(bound ms, bound_by): the larger of the operation time at the cc 9.0
    INT32 rate and the byte time at the memory rate. ``uniq``: the
    challenge kernel's digest-table rows (0: per-lane digests)."""
    if kernel == "ed25519_challenge":
        n_ops, n_bytes = lanes * ops_challenge(), challenge_bytes(lanes, uniq)
    else:
        n_ops, n_bytes = lanes * imad_per_signature(kernel), lanes * BYTES_PER_LANE[kernel]
    ops = n_ops / (sms * IMAD_PER_SM_CLOCK * clock_mhz * 1e6)
    byt = n_bytes / HBM_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= byt else (byt * 1e3, "bytes")


def time_ms(fn, reps: int, warm: bool = True, keep=None) -> float:
    """Median over ``reps`` of one call's device time (CUDA events), after
    one warm-up call unless ``warm`` is False; ``keep`` (a list) receives
    each call's result."""
    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        got = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        if keep is not None:
            keep.append(got)
    return statistics.median(times)


def burst_ms(fn, reps: int = 100) -> tuple:
    """(device ms a call, host ms a call) over ``reps`` back-to-back calls
    between two CUDA events, after one warm-up call: when the host enqueues
    slower than the card runs, the device time is the host's."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    host = (time.perf_counter() - t0) * 1e3 / reps
    b.synchronize()
    return a.elapsed_time(b) / reps, host


def queued_ms(fn, reps: int = 50) -> float:
    """Device ms a call over ``reps`` back-to-back calls of ``fn`` between
    two CUDA events, enqueued behind a spin kernel so that the card runs
    them back to back whatever the host's enqueue rate; the spin must still
    be running when the last call is enqueued, or the time is refused."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for cycles in (20_000_000, 400_000_000):
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued = not a.query()
        b.synchronize()
        if queued:
            return a.elapsed_time(b) / reps
    raise AssertionError("the spin kernel ended before the calls were enqueued")


def device_ms(fn, kernel: str, reps: int = 50) -> tuple:
    """(mean device ms of one launch of ``kernel``, the method that gave it).
    The method is "profiler": ``kernel`` (a substring of its name) over
    ``reps`` calls of ``fn`` under ``torch.profiler`` (CUDA activity), after
    one warm-up call, each call launching it once. CUPTI now and then
    records no kernel in a session: after three such sessions the method is
    "queued", ``queued_ms`` (which also counts the card's gap between two
    launches)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if kernel in e.key]
        if sum(e.count for e in evs) == reps:
            return sum(e.device_time_total for e in evs) / reps / 1e3, "profiler"
        seen.append([(e.key[:48], e.count) for e in evs])
    print(f"profiler: {kernel} not recorded in 3 sessions (saw {seen}); "
          "timed with CUDA events behind a spin kernel instead", flush=True)
    return queued_ms(fn, reps), "queued"


def _ring():
    from hyperdrive_tpu_torch.crypto.keys import KeyRing

    return KeyRing.deterministic(32, namespace=b"chip-smoke")


def mixed_pool(size: int, rng):
    """Signed (pub, digest, sig) items of every verdict class: valid,
    flipped s bit, wrong digest, malformed point, s >= L."""
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed

    ring = _ring()
    items = []
    for i in range(size):
        kp = ring[i % 32]
        digest = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        sig = kp.sign_digest(digest)
        kind = i % 5
        if kind == 1:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        elif kind == 2:
            digest = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        elif kind == 3:
            sig = b"\xff" * 64
        elif kind == 4 and i % 10 == 4:
            s = int.from_bytes(sig[32:], "little") + host_ed.L
            sig = sig[:32] + s.to_bytes(32, "little")
        items.append((kp.public, digest, sig))
    return items


def edge_encodings() -> list:
    """The decompression edge encodings: identity, the sign bit on x = 0,
    y = 0 (both signs), y = p - 1, y = p, y = p + 1, y = 2^255 - 1, and a
    non-residue."""
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed

    p = host_ed.P

    def enc(y, sign=0):
        return int.to_bytes(y | (sign << 255), 32, "little")

    nonres = next(enc(y) for y in range(2, 50)
                  if host_ed.point_decompress(enc(y)) is None)
    return [enc(1), enc(1, 1), enc(0), enc(0, 1), enc(p - 1), enc(p),
            enc(p + 1), enc((1 << 255) - 1), nonres]


def ptxas_report(log: str) -> list:
    """Per entry kernel: (name, registers, stack bytes, spill stores, spill
    loads) from the -Xptxas -v log, where each entry's figures follow its
    "Compiling entry function" line."""
    out = []
    for m in re.finditer(
        r"Compiling entry function '[^']*?(hd_\w+?_kernel)[^']*'.*?"
        r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
        r".*?Used (\d+) registers", log, re.S,
    ):
        name, stack, st, ld, regs = m.groups()
        out.append((name, int(regs), int(stack), int(st), int(ld)))
    return out


def phase_card():
    """Build every kernel library and the probe unit from the sources in
    this checkout, one nvcc a unit, all started together, and print what
    ptxas reports. Returns the paths of the ed25519 library and the probe
    library."""
    from concurrent.futures import ThreadPoolExecutor

    from hyperdrive_tpu_torch.ops import ed25519_cuda, g1_cuda

    print(card_line(), flush=True)

    def timed_build(mod):
        t0 = time.perf_counter()
        lib = mod.build(force=True)
        return lib, time.perf_counter() - t0

    class _Probe:  # the probe unit, built like the kernel libraries
        @staticmethod
        def build(force=False):
            return ed25519_cuda.build_library("probe", "ed25519_probe.cu", PROBE_SOURCES,
                                              force)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        built = list(pool.map(timed_build, (ed25519_cuda, g1_cuda, _Probe)))
    wall = time.perf_counter() - t0
    report = []
    for lib, build_s in built[:2]:
        entries = ptxas_report((lib.parent / "nvcc.log").read_text())
        report += entries
        print(f"build: nvcc {build_s:.2f} s for {lib.name} ({len(entries)} kernels, "
              f"one unit)", flush=True)
    print(f"build: nvcc {built[2][1]:.2f} s for {built[2][0].name} (probes, one unit)",
          flush=True)
    if len(report) != len(KERNELS):
        raise AssertionError(f"expected {len(KERNELS)} kernels in the ptxas logs, got {report}")
    print(f"build: {len(built)} units in parallel, {wall:.2f} s wall", flush=True)
    for name, regs, stack, st, ld in report:
        print(f"ptxas: {name} registers={regs} stack_bytes={stack} "
              f"spill_stores={st} spill_loads={ld}", flush=True)
        if name == "hd_ed25519_challenge_kernel" and (stack or st or ld):
            raise AssertionError("the challenge kernel uses a stack or spills")
    return built[0][0], built[2][0]


def _host_us(fn, count: int, reps: int = 5) -> float:
    """Median host time of ``fn()`` over ``reps`` calls, in µs per item
    (``count`` items a call)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) / count * 1e6


def phase_native() -> None:
    """Build the native host runtime and time it on this machine's host
    beside the pure-Python oracle, on 256 signed items of one ring."""
    from hyperdrive_tpu_torch import native
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
    from hyperdrive_tpu_torch.ops import ed25519 as ted
    from hyperdrive_tpu_torch.verifier import HostVerifier

    if os.environ.get("HD_NO_NATIVE"):
        raise AssertionError("HD_NO_NATIVE is set: this script measures the native host")
    prebuilt = any(os.path.exists(path) for _, path in native._build_plans())
    t0 = time.perf_counter()
    packer = native.instance()
    build_s = time.perf_counter() - t0
    if packer is None:
        raise AssertionError(f"native runtime did not load: {native.last_error()}")
    ring = _ring()
    rng = np.random.default_rng(SEED + 5)
    digests = [bytes(rng.integers(0, 256, 32, dtype=np.uint8)) for _ in range(PATH_LANES)]
    items = [(ring[i % 32].public, d, ring[i % 32].sign_digest(d))
             for i, d in enumerate(digests)]
    for i in range(8):  # the signer's bytes are the oracle's
        if items[i][2] != host_ed.sign(ring[i % 32].seed, digests[i]):
            raise AssertionError("native signature differs from the oracle's")

    def sign_all():
        for i, d in enumerate(digests):
            ring[i % 32].sign_digest(d)

    fast = ted.Ed25519BatchHost(buckets=(PATH_LANES,))
    slow = ted.Ed25519BatchHost(buckets=(PATH_LANES,), use_native=False)
    got, want = fast.pack(items), slow.pack(items)
    if not (all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
            and np.array_equal(got[1], want[1])):
        raise AssertionError("native packer differs from the Python packer")
    host = HostVerifier()
    if not host.verify_signatures(items).all():
        raise AssertionError("native host verifier rejected a valid signature")
    sign_us = _host_us(sign_all, PATH_LANES)
    pack_us = _host_us(lambda: fast.pack(items), PATH_LANES)
    verify_us = _host_us(lambda: host.verify_signatures(items), PATH_LANES)
    py_sign_us = _host_us(lambda: [host_ed.sign(ring[i].seed, digests[i]) for i in range(16)],
                          16, reps=3)
    py_pack_us = _host_us(lambda: slow.pack(items[:16]), 16, reps=3)
    py_verify_us = _host_us(lambda: [host_ed.verify(*it) for it in items[:16]], 16, reps=3)
    print(f"native: loaded build_s={build_s:.2f} prebuilt={prebuilt} sign_us={sign_us:.1f} "
          f"pack_us_per_item={pack_us:.1f} verify_us={verify_us:.1f} "
          f"python_sign_us={py_sign_us:.1f} python_pack_us_per_item={py_pack_us:.1f} "
          f"python_verify_us={py_verify_us:.1f} (host CPU, {PATH_LANES} items of one "
          f"32-key ring; Python times over 16)", flush=True)


def compare_sizes(kernel: str, pool, run_kernel, run_plain, sizes, rng,
                  clock_mhz: float, sms: int, must_include=()) -> dict:
    """Kernel against plain, mask for mask, at each size (batches above
    4096 run as launches of 4096), then the timings. ``pool`` is a tuple
    of POOL-lane tensors on the card; ``must_include`` lanes join every
    batch."""
    rows = {}
    keep = np.asarray(must_include, dtype=np.int64)
    for size in sizes:
        idx = np.concatenate([keep, rng.integers(0, POOL, size - len(keep))])
        idx_t = torch.from_numpy(idx).to("cuda")
        batch = [t[idx_t].contiguous() for t in pool]
        chunk = min(size, SIZES[-1])
        parts = [[t[lo:lo + chunk] for t in batch] for lo in range(0, size, chunk)]

        def kern(parts=parts):
            return [run_kernel(*p) for p in parts]

        def plain(parts=parts):
            return [run_plain(*p) for p in parts]

        k_mask = torch.cat(kern()).cpu().numpy()
        # The plain version runs once: the compared call is the timed one.
        p_ms = time_ms(plain, 1, warm=False, keep=(out := []))
        p_mask = torch.cat(out[0]).cpu().numpy()
        err = int(np.abs(k_mask.astype(np.int32) - p_mask.astype(np.int32)).max())
        if err:
            bad = int((k_mask != p_mask).sum())
            raise AssertionError(f"{kernel}: kernel != plain on {bad} of {size} lanes")
        k_ms = time_ms(kern, 7)
        b_ms, b_by = bound_ms(kernel, size, clock_mhz, sms)
        rows[size] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "err": err}
        print(f"kernel {kernel}: lanes={size} threads_per_sig={THREADS_PER_SIG[kernel]} "
              f"launches={len(parts)} kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.2f} sigs_per_s={size / k_ms * 1e3:.0f} "
              f"bound_ms={b_ms:.4f} bound_by={b_by} bound_share={b_ms / k_ms:.4f} "
              f"valid_lanes={int(k_mask.sum())} mismatches=0", flush=True)
    return rows


def phase_verify_kernel(clock_mhz: float, sms: int) -> dict:
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
    from hyperdrive_tpu_torch.ops import ed25519 as ted
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    rng = np.random.default_rng(SEED)
    items = mixed_pool(POOL, rng)
    host = ted.Ed25519BatchHost(buckets=(POOL,))
    t0 = time.perf_counter()
    arrays, prevalid, _ = host.pack(items[:256])
    pack_ms = (time.perf_counter() - t0) * 1e3
    pool, pool_valid, _ = host.pack(items)
    # Raw lanes outside the packer's precondition (s nibbles of s + L on a
    # valid row) and an explicit all-zero lane.
    pool = [a.copy() for a in pool]
    for j in range(0, POOL, 50):
        if pool_valid[j]:
            s = sum(int(v) << (4 * k) for k, v in enumerate(pool[5][j])) + host_ed.L
            pool[5][j] = [(s >> (4 * k)) & 0xF for k in range(64)]
    for a in pool:
        a[POOL - 1] = 0

    sample = [torch.from_numpy(a).to("cuda") for a in arrays]
    got = ed25519_cuda.verify(*sample).cpu().numpy() & prevalid
    oracle = np.array([host_ed.verify(*it) for it in items[:256]])
    if not np.array_equal(got[:256], oracle):
        raise AssertionError("ed25519_verify disagrees with the host oracle")
    print(f"kernel ed25519_verify: oracle sample 256 lanes agree; "
          f"pack_ms(256 items)={pack_ms:.1f}", flush=True)
    pool_t = tuple(torch.from_numpy(a).to("cuda") for a in pool)
    return compare_sizes("ed25519_verify", pool_t, ed25519_cuda.verify, ted.verify_plain,
                         SIZES + (BIG,), rng, clock_mhz, sms, must_include=[0, 50, POOL - 1])


def _raw_lanes(arrays, slots, edges, rng):
    """Overwrite the pool's last 32 lanes with raw rows outside the
    packer's precondition, built on lane 0 (a valid signature): each edge
    encoding in each of ``slots`` (the A and R rows of ``arrays``), then
    random bytes in the last slot. Returns the lanes."""
    lanes = list(range(POOL - 32, POOL))
    for a in arrays:
        a[lanes] = a[0]
    cases = [(slot, e) for e in edges for slot in slots]
    for lane, (slot, e) in zip(lanes, cases):
        arrays[slot][lane] = np.frombuffer(e, dtype=np.uint8)
    for lane in lanes[len(cases):]:
        arrays[slots[-1]][lane] = rng.integers(0, 256, 32, dtype=np.uint8)
    return lanes


def phase_wire_kernels(clock_mhz: float, sms: int):
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops import ed25519_wire as wire

    rng = np.random.default_rng(SEED + 1)
    items = mixed_pool(POOL, rng)
    edges = edge_encodings()
    host = wire.Ed25519WireHost(buckets=(POOL,))
    dev = torch.device("cuda")

    # Full wire: the packer's rows, then raw edge rows as A and as R.
    rows, prevalid, _ = host.pack_wire(items)
    rows = [r.copy() for r in rows]
    raw = _raw_lanes(rows, (0, 1), edges, rng)
    t = [torch.from_numpy(r).to(dev) for r in rows]
    got = ed25519_cuda.wire_verify(*(x[:256] for x in t)).cpu().numpy() & prevalid[:256]
    oracle = np.array([host_ed.verify(*it) for it in items[:256]])
    if not np.array_equal(got, oracle):
        raise AssertionError("ed25519_wire disagrees with the host oracle")
    print("kernel ed25519_wire: oracle sample 256 lanes agree", flush=True)
    wire_rows = compare_sizes("ed25519_wire", tuple(t), ed25519_cuda.wire_verify,
                              wire.wire_verify_plain, SIZES, rng, clock_mhz, sms,
                              must_include=raw)

    # Semiwire: a table of the pool's keys plus one bogus pubkey; every
    # seventh lane points at the bogus slot; raw edge rows as R.
    ring = _ring()
    table = wire.ValidatorTable(ring.signatories + [BOGUS], device=dev)
    rows, prevalid, _ = host.pack_wire_indexed(items, table)
    rows = [r.copy() for r in rows]  # idx, R, s, k
    rows[0][6::7] = table.index[BOGUS]
    raw = _raw_lanes(rows, (1,), edges, rng)
    pubs = ring.signatories + [BOGUS]
    eff = [(pubs[rows[0][i]], d, sig) for i, (_, d, sig) in enumerate(items)]
    pool = (table.upload_index(rows[0]),
            *(torch.from_numpy(r).to(dev) for r in rows[1:]))
    got = ed25519_cuda.semiwire_verify(*(x[:256] for x in pool),
                                       *table.arrays()).cpu().numpy() & prevalid[:256]
    oracle = np.array([host_ed.verify(*it) for it in eff[:256]])
    if not np.array_equal(got, oracle):
        raise AssertionError("ed25519_semiwire disagrees with the host oracle")
    print("kernel ed25519_semiwire: oracle sample 256 lanes agree "
          f"(bogus-slot lanes {len(range(6, 256, 7))})", flush=True)

    def semi(i, r, s, k):
        return ed25519_cuda.semiwire_verify(i, r, s, k, *table.arrays())

    def semi_plain(i, r, s, k):
        return wire.semiwire_verify_plain(i, r, s, k, *table.arrays())

    semi_rows = compare_sizes("ed25519_semiwire", pool, semi, semi_plain,
                              SIZES + (BIG,), rng, clock_mhz, sms, must_include=raw)
    return wire_rows, semi_rows, (items, table, pool, eff)


def _challenge_inputs(lanes: int, table, pool, rng, digests: int = 16):
    """A lanes-wide batch for the challenge kernel: table indices over
    every slot (the bogus one included), R rows from the wire pool (its
    raw edge lanes included) with lane 2 set to 0xff..., random digest
    rows with lane 0 all zero and lane 1 all 0xff, and a 16-row digest
    table whose first ``digests`` rows are live (the same two edge rows
    among them, the rest zero as ``group_digests`` pads them), at random
    digest indices."""
    dev = torch.device("cuda")
    idx = torch.from_numpy(rng.integers(0, table.n, lanes).astype(np.int32)).to(dev)
    pick = torch.from_numpy(rng.integers(0, POOL, lanes)).to(dev)
    r_rows = pool[1][pick].contiguous()
    r_rows[2] = 0xFF
    m_rows = torch.from_numpy(rng.integers(0, 256, (lanes, 32), dtype=np.uint8)).to(dev)
    m_rows[0], m_rows[1] = 0, 0xFF
    m_uniq = m_rows[:16].clone()
    m_uniq[digests:] = 0
    m_idx = torch.from_numpy(rng.integers(0, digests, lanes).astype(np.uint8)).to(dev)
    m_idx[0], m_idx[1] = 0, 1
    return idx, r_rows, m_rows, m_idx, m_uniq


def phase_challenge(state, clock_mhz: float, sms: int, lib, probe_lib) -> dict:
    from hyperdrive_tpu_torch.crypto import ed25519 as host_ed
    from hyperdrive_tpu_torch.ops import bucketing, ed25519_cuda
    from hyperdrive_tpu_torch.ops import ed25519_wire as wire

    items, table, pool, eff = state
    idx, r_rows = pool[0][:256], pool[1][:256]
    m = np.frombuffer(b"".join(d for _, d, _ in items[:256]), dtype=np.uint8).reshape(256, 32)
    m_t = torch.from_numpy(m.copy()).to("cuda")
    per_lane = ed25519_cuda.challenge(idx, r_rows, m_t, table.rows).cpu().numpy()
    m_uniq = m_t[:16].contiguous()
    m_idx = (torch.arange(256, device="cuda") % 16).to(torch.uint8)
    grouped = ed25519_cuda.challenge_grouped(idx, r_rows, m_idx, m_uniq,
                                             table.rows).cpu().numpy()
    r_host = r_rows.cpu().numpy()
    for i in range(256):
        pub, _, _ = eff[i]
        want = host_ed.challenge_scalar(bytes(r_host[i]), pub, bytes(m[i]))
        if bytes(per_lane[i]) != want.to_bytes(32, "little"):
            raise AssertionError(f"per-lane challenge differs from the host on lane {i}")
        want = host_ed.challenge_scalar(bytes(r_host[i]), pub, bytes(m[i % 16]))
        if bytes(grouped[i]) != want.to_bytes(32, "little"):
            raise AssertionError(f"grouped challenge differs from the host on lane {i}")
    print("kernel ed25519_challenge: oracle sample 256 lanes agree (per-lane and grouped)",
          flush=True)
    _challenge_edges(table, pool, np.random.default_rng(SEED + 3))

    probe = Probe(probe_lib)
    diag = _challenge_probes(probe, lib, clock_mhz)
    rng = np.random.default_rng(SEED + 2)
    rows = {}
    # The deployment capstone's 64-lane bucket, a sequential vote window, a
    # coalesced settle batch of the pipelined runs (its bucket and digest
    # count), and the largest default bucket.
    pipe_lanes = bucketing.bucket_for(PIPE_BATCH, PIPE_BUCKETS)
    for lanes, digests in ((SIZES[0], 16), (PATH_LANES, 16), (pipe_lanes, PIPE_DIGESTS),
                           (SIZES[-1], 16)):
        idx, r_rows, m_rows, m_idx, m_uniq = _challenge_inputs(lanes, table, pool, rng,
                                                               digests)
        forms = {
            "per_lane": (ed25519_cuda.challenge, wire.challenge,
                         (idx, r_rows, m_rows, table.rows), 0),
            "grouped": (ed25519_cuda.challenge_grouped, wire.challenge_grouped,
                        (idx, r_rows, m_idx, m_uniq, table.rows), len(m_uniq)),
        }
        for form, (kern, plain, args, uniq) in forms.items():
            got = kern(*args).cpu().numpy().astype(np.int32)
            want = plain(*args).cpu().numpy().astype(np.int32)
            err = int(np.abs(got - want).max())
            if err:
                bad = int((got != want).any(axis=1).sum())
                raise AssertionError(
                    f"ed25519_challenge ({form}): kernel != plain on {bad} of {lanes} lanes")
            k_ms = time_ms(lambda kern=kern, args=args: kern(*args), 7)
            p_ms = time_ms(lambda plain=plain, args=args: plain(*args), 5)
            b_ms, b_by = bound_ms("ed25519_challenge", lanes, clock_mhz, sms, uniq)
            print(f"kernel ed25519_challenge: form={form} lanes={lanes} "
                  f"digests={digests if uniq else lanes} warps_per_32_lanes=2 "
                  f"launches=1 kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} "
                  f"lanes_per_s={lanes / k_ms * 1e3:.0f} bound_ms={b_ms:.6f} "
                  f"bound_by={b_by} bound_share={b_ms / k_ms:.4f} mismatches=0", flush=True)
            if form == "grouped":
                alone = _challenge_alone(lanes, args, k_ms, b_ms, clock_mhz, diag)
                rows[lanes] = {"ms": alone, "plain_ms": p_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "err": err}
    for lanes in (PATH_LANES, SIZES[-1]):
        idx, r_rows, _, m_idx, m_uniq = _challenge_inputs(lanes, table, pool, rng)
        got = probe.stamps((idx, r_rows, m_idx, m_uniq, table.rows), lanes)
        print(f"stamps: challenge lanes={lanes} clock_mhz={clock_mhz:.0f} "
              f"cycles_since_entry={json.dumps(got['warps'], sort_keys=True)} "
              f"entry_spread_ns={got['entry_spread_ns']} span_ns={got['span_ns']}", flush=True)
    print("redesign: challenge kernel alone, PR 11's recorded time over this run's "
          + " ".join(f"lanes={n}: device {CHAL_PR11_DEVICE[n] / rows[n]['ms']:.2f}x"
                     for n in sorted(rows)), flush=True)
    _chal_semiwire_check(state, np.random.default_rng(SEED + 4))
    return rows


#: The first design's recorded times (PERF.md section 6, row 4: PR 11 run
#: 8, device time of one launch under the profiler, grouped form, NVIDIA
#: H100 80GB HBM3, 700.00 W), ms by lanes; 1,024 stands for the pipelined
#: batch's bucket.
CHAL_PR11_DEVICE = {64: 0.0071, 256: 0.0069, 1024: 0.0078, 4096: 0.0080}
#: Lanes and threads of a challenge block, and the trips of its chunk loop
#: (chunks 2-5; ``csrc/ed25519_challenge.cu``).
CHAL_LANES, CHAL_THREADS, CHAL_LOOP_TRIPS = 32, 64, 4


def _challenge_edges(table, pool, rng) -> None:
    """The kernel against its plain version on edge lanes, both forms: n =
    1, 31 and 33 (a lone lane, a short block, one lane past a block), and
    a 64-lane batch with table indices outside the table (V, V + 7, -1,
    2^31 - 1) and digest indices at or above U (U, 255). The kernel reads
    zeros there, so the plain version runs on tables with a zero row
    appended and those indices pointed at it."""
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops import ed25519_wire as wire

    v, u = table.rows.shape[0], 16
    zrow = torch.zeros((1, 32), dtype=torch.uint8, device="cuda")
    tz = torch.cat([table.rows, zrow])
    checked = 0
    for lanes in (1, 31, 33, 64):
        idx, r_rows, m_rows, m_idx, m_uniq = _challenge_inputs(max(lanes, 3), table, pool,
                                                               rng)
        idx, r_rows, m_rows, m_idx = idx[:lanes], r_rows[:lanes], m_rows[:lanes], m_idx[:lanes]
        if lanes == 64:
            idx[3], idx[4], idx[5], idx[6] = v, v + 7, -1, 2**31 - 1
            m_idx[7], m_idx[8] = u, 255
        ip = torch.where((idx >= 0) & (idx < v), idx, v).to(torch.int32)
        mp = torch.where(m_idx < u, m_idx, u).to(torch.uint8)
        mz = torch.cat([m_uniq, zrow])
        got = ed25519_cuda.challenge(idx, r_rows, m_rows, table.rows)
        want = wire.challenge(ip, r_rows, m_rows, tz)
        gg = ed25519_cuda.challenge_grouped(idx, r_rows, m_idx, m_uniq, table.rows)
        wg = wire.challenge_grouped(ip, r_rows, mp, mz, tz)
        if not (torch.equal(got, want) and torch.equal(gg, wg)):
            raise AssertionError(f"ed25519_challenge differs from plain on the edge lanes "
                                 f"(n={lanes})")
        checked += 2 * lanes
    print(f"kernel ed25519_challenge: edge lanes agree with plain, both forms (n = 1, 31, "
          f"33; 64 lanes with 4 indices outside the table and 2 digest indices >= U; "
          f"{checked} lanes)", flush=True)


def sass_warp_split(ins, trips: int) -> dict:
    """The challenge kernel's SASS by warp: the code between EXITs that
    holds the producer's releases (BAR.ARV) and the round warp's waits
    (BAR.SYNC), each as (instructions executed with its chunk loop taken
    ``trips`` times, the loop body's dependent chain per round, the chain
    after the loop: the feed-forward, reduction and store). The shared
    prologue counts in the part where the compiler put it."""
    parts, cur = [], []
    for item in ins:
        cur.append(item)
        if item[0] == "EXIT":
            parts.append(cur)
            cur = []
    parts.append(cur)
    out = {}
    for part in parts:
        role = ("producer" if any(m.startswith("BAR.ARV") for m, _, _ in part)
                else "rounds" if any(m.startswith("BAR.SYNC") for m, _, _ in part) else None)
        if role is None:
            continue
        loop = sass_loop(part)
        body = loop[1] - loop[0] if loop else 0
        out[role] = (len(part) + (trips - 1) * body,
                     sass_chain(part[loop[0]:loop[1]]) / 16 if loop else 0.0,
                     sass_chain(part[loop[1]:]) if loop else 0)
    return out


def _challenge_probes(probe, lib, clock_mhz: float) -> dict:
    """Print the launch floor, the chain probes and the challenge kernel's
    SASS by warp; returns the diagnostics ``_challenge_alone`` prints."""
    floors = {}
    for lanes in (PATH_LANES, SIZES[-1]):
        blocks = -(-lanes // CHAL_LANES)
        (dev, by), one, back, host = probe.floor(blocks, CHAL_THREADS)
        floors[lanes] = dev
        print(f"floor: empty kernel blocks={blocks} threads={CHAL_THREADS} "
              f"device_ms={dev:.5f} device_ms_by={by} one_launch_ms={one:.5f} "
              f"burst_ms={back:.5f} host_ms={host:.5f}", flush=True)
    chains = probe.chains(clock_mhz)
    lat = statistics.median(chains[k][0] for k in CHAIN_TYPES)
    issue = statistics.median(chains[k][2] for k in CHAIN_TYPES)
    print("latency: dependent cycles " + " ".join(f"{k}={v[0]:.3f}" for k, v in chains.items())
          + f" median={lat:.3f} (in use: {DEP_LATENCY_CYCLES})", flush=True)
    print("latency: issue cycles (8 chains, one warp) "
          + " ".join(f"{k}={v[2]:.3f}" for k, v in chains.items())
          + f" median={issue:.3f}", flush=True)
    sass = next(v for k, v in sass_functions(lib).items() if "challenge_kernel" in k)
    warps = sass_warp_split(sass, CHAL_LOOP_TRIPS)
    busiest = max(n for n, _, _ in warps.values())
    rounds = warps["rounds"]
    print(f"sass: hd_ed25519_challenge_kernel instructions={len(sass)} executed: "
          + " ".join(f"{k}={v[0]}" for k, v in sorted(warps.items()))
          + f" round_chain_per_round={rounds[1]:.2f} after_loop_chain={rounds[2]} "
          f"(in use: ROUND_DEPTH={ROUND_DEPTH} REDUCE_DEPTH={REDUCE_DEPTH}, "
          f"dependent_instructions={depth_challenge()})", flush=True)
    return {"floor": floors, "issue_ms": busiest * issue / (clock_mhz * 1e3)}


def _challenge_alone(lanes: int, args, call_ms: float, b_ms: float, clock_mhz: float,
                     diag: dict) -> float:
    """The grouped challenge kernel's own time: its device time
    (``device_ms``: the profiler, else queued CUDA events) over 50 direct
    calls of ``hd_ed25519_challenge`` on pre-made inputs and output (no
    Python checks, no allocation), beside 100
    back-to-back wrapper calls and 100 back-to-back direct calls between
    two CUDA events (host-bound when the host enqueues slower than the card
    runs), the single wrapper call's time, the throughput bound, the
    latency bound and, as diagnostics that are not the bound, the busiest
    warp's issue time and the empty kernel's device time at this grid.
    Returns the device time."""
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    idx, r_rows, m_idx, m_uniq, trows = args
    wrap_ms, wrap_host = burst_ms(lambda: ed25519_cuda.challenge_grouped(*args))
    index = torch.cuda.current_device()
    fn = ed25519_cuda._library(index).lib.hd_ed25519_challenge
    out = torch.empty((lanes, 32), dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    call = (index, idx.data_ptr(), r_rows.data_ptr(), m_uniq.data_ptr(), m_idx.data_ptr(),
            m_uniq.shape[0], trows.data_ptr(), trows.shape[0], out.data_ptr(), lanes, stream)

    def direct():
        if fn(*call) != 0:
            raise AssertionError("hd_ed25519_challenge launch failed")

    direct_ms, direct_host = burst_ms(direct)
    dev_ms, dev_by = device_ms(direct, "hd_ed25519_challenge_kernel")
    if not torch.equal(out, ed25519_cuda.challenge_grouped(*args)):
        raise AssertionError("direct hd_ed25519_challenge calls != the wrapper's")
    lat = challenge_latency_ms(clock_mhz)
    floor = diag["floor"].get(lanes)
    print(f"kernel ed25519_challenge alone: form=grouped lanes={lanes} "
          f"device_ms={dev_ms:.5f} device_ms_by={dev_by} "
          f"wrapper_call_ms={call_ms:.4f} wrapper_burst_ms={wrap_ms:.4f} "
          f"wrapper_host_ms={wrap_host:.4f} direct_burst_ms={direct_ms:.4f} "
          f"direct_host_ms={direct_host:.4f} host_bound={direct_host >= 0.9 * direct_ms} "
          f"bound_ms={b_ms:.6f} latency_bound_ms={lat:.6f} "
          f"dependent_instructions={depth_challenge()} "
          f"latency_share={lat / dev_ms:.4f} issue_bound_ms={diag['issue_ms']:.6f} "
          f"floor_ms={'not measured' if floor is None else f'{floor:.5f}'}", flush=True)
    return dev_ms


def _chal_semiwire_check(state, rng) -> None:
    """``chal_semiwire_verify`` (one library call, both kernels) against
    ``challenge[_grouped]`` then ``semiwire_verify`` at 256 and 4,096
    lanes, both forms: verdicts and k rows equal, one launch counted under
    each kernel; then each path's host time a call and back-to-back device
    time (100 calls)."""
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    items, table, pool, _ = state
    arrays = table.arrays()
    for lanes in (PATH_LANES, SIZES[-1]):
        pick = rng.integers(0, POOL, lanes)
        pt = torch.from_numpy(pick).to("cuda")
        idx, r_rows, s_rows = (pool[i][pt].contiguous() for i in range(3))
        m = np.stack([np.frombuffer(items[i][1], dtype=np.uint8) for i in pick])
        m_rows = torch.from_numpy(m).to("cuda")
        m_uniq = m_rows[:16].contiguous()
        m_idx = torch.from_numpy((np.arange(lanes) % 16).astype(np.uint8)).to("cuda")
        k_rows = torch.empty((lanes, 32), dtype=torch.uint8, device="cuda")
        forms = {
            "per_lane": (lambda: ed25519_cuda.chal_semiwire_verify(
                idx, r_rows, s_rows, m_rows, table.rows, *arrays, k_rows),
                lambda: ed25519_cuda.challenge(idx, r_rows, m_rows, table.rows)),
            "grouped": (lambda: ed25519_cuda.chal_semiwire_verify(
                idx, r_rows, s_rows, m_uniq, table.rows, *arrays, k_rows, m_idx=m_idx),
                lambda: ed25519_cuda.challenge_grouped(idx, r_rows, m_idx, m_uniq,
                                                       table.rows)),
        }
        for form, (combined, chal) in forms.items():
            ed25519_cuda.reset_stats()
            ok = combined()
            launched = (ed25519_cuda.stats["ed25519_challenge"].launches,
                        ed25519_cuda.stats["ed25519_semiwire"].launches)
            k = chal()
            want = ed25519_cuda.semiwire_verify(idx, r_rows, s_rows, k, *arrays)
            if launched != (1, 1) or not torch.equal(ok, want) or not torch.equal(k_rows, k):
                raise AssertionError(f"chal_semiwire_verify ({form}, {lanes} lanes) != the "
                                     f"two launches (launches {launched})")

            def separate(chal=chal):
                return ed25519_cuda.semiwire_verify(idx, r_rows, s_rows, chal(), *arrays)

            c_ms, c_host = burst_ms(combined)
            s_ms, s_host = burst_ms(separate)
            print(f"chal_semiwire: form={form} lanes={lanes} verdicts_equal=True "
                  f"accepted={int(ok.sum())} combined_host_ms={c_host:.4f} "
                  f"separate_host_ms={s_host:.4f} combined_burst_ms={c_ms:.4f} "
                  f"separate_burst_ms={s_ms:.4f}", flush=True)


#: The probe unit (``csrc/ed25519_probe.cu``): the launch floor, the
#: integer latency and issue probes and the stamped challenge kernel.
PROBE_SOURCES = ("fe25519_w32.cuh", "ed25519_challenge.cu", "ed25519_probe.cu")
#: (label, op of ``hd_probe_chain_run``, SASS mnemonics counted in its loop).
PROBE_OPS = (("IADD3", 0, ("IADD3",)), ("IADD3.X", 1, ("IADD3", "IMAD")), ("SHF", 2, ("SHF",)),
             ("LOP3", 3, ("LOP3",)), ("IMAD", 4, ("IMAD",)),
             ("LOP3+IMAD", 5, ("LOP3", "IMAD")), ("IMAD.HI", 6, ("IMAD",)))
PROBE_ITERS = 64
#: The instructions on the round's dependent chains, whose median latency
#: and issue interval the bound and the diagnostics use.
CHAIN_TYPES = ("IADD3", "IADD3.X", "SHF", "LOP3", "IMAD")
SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
SASS_REG = re.compile(r"\b(R\d+|P[0-6]|UR\d+|UP[0-6])\b")


def sass_functions(lib) -> dict:
    """``cuobjdump -sass`` of a built library: {function name: [(mnemonic,
    operands, address), ...]} in program order."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        out[name.strip()] = [(m.group(2), m.group(3).strip(), int(m.group(1), 16))
                             for m in SASS_LINE.finditer(body)]
    return out


def _clock_region(ins) -> list:
    """The instructions between the first two reads of the clock."""
    at = [i for i, (_, ops, _) in enumerate(ins) if "SR_CLOCKLO" in ops]
    return ins[at[0] + 1: at[1]]


def sass_chain(ins) -> int:
    """The longest chain of register dependences through ``ins`` (straight
    code), in instructions: an instruction writes its first operand (and the
    next register with a 64-bit result) and the predicates that follow it
    (carries out), and reads every other register and predicate it names.
    Memory, barriers and branches are not links."""
    last, best = {}, 0
    for mn, ops, _ in ins:
        base = mn.split(".")[0]
        toks = [t.strip() for t in ops.split(",")] if ops else []
        dests, i = [], 0
        if base not in ("STS", "STG", "BAR", "BRA", "EXIT", "NOP", "WARPSYNC", "BSSY",
                        "BSYNC") and toks and re.fullmatch(r"R\d+|P[0-6]|UR\d+", toks[0]):
            dests.append(toks[0])
            if (".64" in mn or "WIDE" in mn or base == "CS2R") and toks[0][0] == "R":
                dests.append(f"R{int(toks[0][1:]) + 1}")
            i = 1
            while i < len(toks) and re.fullmatch(r"P[0-6T]", toks[i]):
                dests += [toks[i]] if toks[i] != "PT" else []
                i += 1
        srcs = [r for t in toks[i:] for r in SASS_REG.findall(t)]
        d = max([last.get(r, 0) for r in srcs] + [0]) + (1 if dests else 0)
        for r in dests:
            last[r] = d
        best = max(best, d)
    return best


def sass_loop(ins):
    """(start, end) indices of the body of the first loop in ``ins`` (a
    branch back to an earlier address), or None."""
    for i, (mn, ops, addr) in enumerate(ins):
        if mn == "BRA" and ops.startswith("0x") and int(ops.split()[0], 16) < addr:
            target = int(ops.split()[0], 16)
            start = next(k for k, (_, _, a) in enumerate(ins) if a == target)
            return start, i + 1
    return None


class Probe:
    """The probe library, loaded, with the constant block on device 0."""

    def __init__(self, lib):
        import ctypes

        from hyperdrive_tpu_torch.ops import ed25519_cuda

        self.path = lib
        self.lib = ctypes.CDLL(str(lib))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        self.lib.hd_probe_set_consts.argtypes = [ci, vp]
        self.lib.hd_probe_empty_launch.argtypes = [ci, ci, ci, vp]
        self.lib.hd_probe_chain_run.argtypes = [ci, ci, ci, vp, vp, vp, ci, vp]
        self.lib.hd_probe_read_stamps.argtypes = [ci, vp]
        self.lib.hd_ed25519_challenge.argtypes = [ci] + [vp] * 4 + [ci, vp, ci, vp, ci, vp]
        geo = [ctypes.c_int() for _ in range(3)]
        self.lib.hd_probe_stamp_geometry(*(ctypes.byref(g) for g in geo))
        self.geometry = tuple(g.value for g in geo)
        consts = ed25519_cuda.consts_block_w32()
        if self.lib.hd_probe_set_consts(0, consts.ctypes.data_as(vp)) != 0:
            raise AssertionError("probe constant upload failed")
        self.sass = sass_functions(lib)

    def floor(self, blocks: int, threads: int) -> tuple:
        """The empty kernel on ``blocks`` x ``threads``: ((device ms a
        launch, its method) from ``device_ms``, ms of one launch between two
        CUDA events, back-to-back ms a launch, host ms a launch)."""
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            if self.lib.hd_probe_empty_launch(0, blocks, threads, stream) != 0:
                raise AssertionError("empty kernel launch failed")

        return (device_ms(launch, "hd_probe_empty"), time_ms(launch, 50),
                *burst_ms(launch))

    def chains(self, clock_mhz: float) -> dict:
        """{label: (latency cycles, issue interval cycles)} of each chain
        probe, from clock64 and the instructions in its timed loop."""
        rng = np.random.default_rng(SEED + 7)
        inp = torch.from_numpy(rng.integers(0, 2**31, 32).astype(np.int32)).cuda()
        out = torch.empty(32, dtype=torch.int32, device="cuda")
        cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        got = {}
        for label, op, mnems in PROBE_OPS:
            row = []
            for chains in (1, 8):
                name = next(k for k in self.sass
                            if re.search(rf"hd_probe_chainILi{op}ELi{chains}E", k))
                loop = _clock_region(self.sass[name])
                count = sum(1 for m, _, _ in loop if m.split(".")[0] in mnems)
                for _ in range(2):  # the first run warms the instruction cache
                    rc = self.lib.hd_probe_chain_run(0, op, chains, inp.data_ptr(),
                                                     out.data_ptr(), cyc.data_ptr(),
                                                     PROBE_ITERS, stream)
                    if rc != 0:
                        raise AssertionError(f"chain probe {label} failed: {rc}")
                torch.cuda.synchronize()
                row.append(int(cyc.item()) / (PROBE_ITERS * count))
                row.append(count)
            got[label] = tuple(row)
        return got

    def stamps(self, args, lanes: int) -> dict:
        """The stamped challenge kernel once on the grouped ``args`` (after
        a warm-up launch): per warp the median over blocks of each slot's
        cycles since entry, and the globaltimer spread of entries and the
        span from the first entry to the last exit (ns)."""
        import ctypes

        idx, r_rows, m_idx, m_uniq, trows = args
        k = torch.empty((lanes, 32), dtype=torch.uint8, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        nb, nw, ns = self.geometry
        host = np.zeros(nb * nw * ns, dtype=np.uint64)
        for _ in range(2):
            rc = self.lib.hd_ed25519_challenge(
                0, idx.data_ptr(), r_rows.data_ptr(), m_uniq.data_ptr(), m_idx.data_ptr(),
                m_uniq.shape[0], trows.data_ptr(), trows.shape[0], k.data_ptr(), lanes,
                stream)
            if rc != 0:
                raise AssertionError(f"stamped challenge launch failed: {rc}")
            if self.lib.hd_probe_read_stamps(0, host.ctypes.data_as(ctypes.c_void_p)) != 0:
                raise AssertionError("stamp read failed")
        from hyperdrive_tpu_torch.ops import ed25519_cuda

        if not torch.equal(k, ed25519_cuda.challenge_grouped(*args)):
            raise AssertionError("the stamped challenge kernel differs from the kernel")
        blocks = min(nb, -(-lanes // 32))
        st = host.reshape(nb, nw, ns)[:blocks].astype(np.int64)
        per_warp = {}
        for w in range(nw):
            if not st[:, w, 0].any():
                continue
            rel = st[:, w, :14] - st[:, w, :1]
            per_warp[w] = {s: int(np.median(rel[:, s])) for s in range(1, 14)
                           if st[:, w, s].any()}
        entry, exit_ = st[:, 0, 14], st[:, 0, 15]
        return {"warps": per_warp, "entry_spread_ns": int(entry.max() - entry.min()),
                "span_ns": int(exit_.max() - entry.min())}


#: The grid at the main path's shape: n replicas x V validators x R slots.
GRID_N, GRID_R = N_VALIDATORS, 4
#: Bytes of the grid read once: values [n, 2, R, V, 8] int32 + present
#: [n, 2, R, V] bool.
GRID_BYTES = GRID_N * 2 * GRID_R * N_VALIDATORS * (8 * 4 + 1)
#: Rows one two-launch tally scatters at the main path's shape: every
#: replica accepts one vote from every validator.
GRID_ROWS = GRID_N * N_VALIDATORS
VALUES = [b"\xaa" * 32, b"\x11" * 32, bytes(32), bytes(range(0x80, 0xA0))]


def _words(value: bytes) -> np.ndarray:
    return np.frombuffer(value, dtype="<i4").astype(np.int32)


def _grid_meta(rng, n, R):
    """Seeded per-replica metadata: targets from VALUES on most rounds,
    an L28 lane on about half the replicas, f = 85."""
    palette = np.stack([_words(v) for v in VALUES])
    targets = palette[rng.integers(0, 2, (n, R))]
    tvalid = rng.random((n, R)) < 0.7
    l28_slot = np.where(rng.random(n) < 0.5, rng.integers(0, R, n), -1).astype(np.int32)
    l28_target = palette[rng.integers(0, 4, n)]
    return targets, tvalid, l28_slot, l28_target, np.full(n, n // 3, dtype=np.int32)


def _scatter_args(rng, n, V, R, k):
    lanes = rng.choice(n * 2 * R * V, size=k, replace=False)
    idx = np.stack(np.unravel_index(lanes, (n, 2, R, V)), axis=1).astype(np.int32)
    words = np.stack([_words(v) for v in VALUES])[rng.integers(0, 4, k)]
    reset = rng.random(n) < 0.1
    return (idx, words, reset, *_grid_meta(rng, n, R))


def _fused_args(rng, n, V, R, lanes, present):
    """One fused launch's inputs: about ``lanes`` claimed grid lanes
    gated by verify lanes 0..255, some of them already present in the grid
    (the presence guard keeps the first vote)."""
    upd_lane = np.full((2, R, V), -1, dtype=np.int32)
    pick = rng.choice(2 * R * V, size=lanes, replace=False)
    upd_lane.reshape(-1)[pick] = rng.integers(0, PATH_LANES, lanes)
    again = np.argwhere(present.any(axis=0))[:64]
    upd_lane[tuple(again.T)] = rng.integers(0, PATH_LANES, len(again))
    upd_vals = np.stack([_words(v) for v in VALUES])[rng.integers(0, 4, (2, R, V))]
    reset = rng.random(n) < 0.1
    participate = rng.random(n) < 0.8
    targets, tvalid, l28_slot, l28_target, fs = _grid_meta(rng, n, R)
    return (upd_lane, upd_vals, reset, participate, targets, tvalid, l28_slot,
            l28_target, fs)


def _same_grids(step, cuda, cpu, got, want):
    for key in want:
        if not np.array_equal(np.asarray(got[key]), np.asarray(want[key])):
            raise AssertionError(f"votegrid step {step}: counts[{key}] differ cuda vs cpu")
    if not (torch.equal(cuda._values.cpu(), cpu._values)
            and torch.equal(cuda._present.cpu(), cpu._present)):
        raise AssertionError(f"votegrid step {step}: grids differ cuda vs cpu")


def _kernels_per_call(fn) -> str:
    """The CUDA kernels one call of ``fn`` launches, from torch.profiler
    (memory copies and sets not counted), as "N (name, ...)"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    if not names:
        return "not_measured (the profiler recorded no device events)"
    short = sorted({re.sub(r"<.*", "", n)[:48] for n in names})
    return f"{len(names)} ({'; '.join(short)})"


def phase_votegrid() -> None:
    from hyperdrive_tpu_torch.ops import ed25519 as ted
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops.votegrid import VoteGrid

    n, V, R = GRID_N, N_VALIDATORS, GRID_R
    rng = np.random.default_rng(SEED + 3)
    cuda = VoteGrid(n, V, r_slots=R, device="cuda")
    cpu = VoteGrid(n, V, r_slots=R, device="cpu")
    zeros = ([np.zeros((PATH_LANES, 20), dtype=np.int32)] * 5
             + [np.zeros((PATH_LANES, 64), dtype=np.int32)] * 2)
    steps = [("scatter", 4096), ("scatter", 0), ("fused", 1500), ("scatter", GRID_ROWS),
             ("fused", 2 * R * V), ("scatter", 900), ("fused", 600)]
    for step, (kind, k) in enumerate(steps):
        if kind == "scatter":
            args = _scatter_args(rng, n, V, R, k)
            _same_grids(step, cuda, cpu, cuda.update_and_tally(*args),
                        cpu.update_and_tally(*args))
            continue
        mask = rng.random(PATH_LANES) < 0.8
        mask_cuda, mask_cpu = torch.from_numpy(mask).to("cuda"), torch.from_numpy(mask)
        cuda.attach_fused(lambda b: lambda *a: mask_cuda)
        cpu.attach_fused(lambda b: lambda *a: mask_cpu)
        args = _fused_args(rng, n, V, R, k, cpu._present.numpy())
        got = cuda.fused_update_and_tally(zeros, *args)
        want = cpu.fused_update_and_tally(zeros, *args)
        if not np.array_equal(got.mask(), want.mask()):
            raise AssertionError(f"votegrid step {step}: fused masks differ")
        _same_grids(step, cuda, cpu, got.counts(), want.counts())
    print(f"programs: votegrid n={n} V={V} R={R} grid_bytes={GRID_BYTES} "
          f"steps={len(steps)} (scatters of 4096/0/{GRID_ROWS}/900 rows with resets and "
          f"L28 lanes; fused merges with rewritten lanes and non-participants) "
          f"cuda_equals_cpu=True present_lanes={int(cuda._present.sum())}", flush=True)

    # The fused call with the row 1 kernel as its verify, on a mixed window.
    bv = ted.TorchBatchVerifier(device="cuda")
    cuda.attach_fused(bv.fused_inner)
    items = mixed_pool(PATH_LANES, np.random.default_rng(SEED + 4))
    arrays, prevalid, _ = bv.host.pack(items)
    upd_lane = np.full((2, R, V), -1, dtype=np.int32)
    upd_vals = np.zeros((2, R, V, 8), dtype=np.int32)
    for j in range(PATH_LANES):
        upd_lane[j % 2, j % R, j] = j
        upd_vals[j % 2, j % R, j] = _words(VALUES[j % 4])
    args = (upd_lane, upd_vals, np.zeros(n, bool), np.ones(n, bool),
            *_grid_meta(rng, n, R))
    ed25519_cuda.reset_stats()
    got = cuda.fused_update_and_tally(arrays, *args)
    mask = got.mask()
    if ed25519_cuda.stats["ed25519_verify"].launches != 1:
        raise AssertionError("the fused call did not launch ed25519_verify once")
    plain = ted.verify_plain(*(torch.from_numpy(a).to("cuda") for a in arrays)).cpu()
    if not np.array_equal(mask, plain.numpy()):
        raise AssertionError("fused mask != verify_plain's mask")
    cpu.attach_fused(lambda b: lambda *a: plain)
    _same_grids("fused+verify", cuda, cpu, got.counts(),
                cpu.fused_update_and_tally(arrays, *args).counts())
    print(f"programs: votegrid fused verify=ed25519_verify lanes={PATH_LANES} "
          f"mask_equals_verify_plain=True valid_lanes={int((mask & prevalid).sum())} "
          f"counts_equal_cpu_grid=True", flush=True)

    # Device times at the main path's shapes.
    dev_arrays = [torch.from_numpy(a).to("cuda") for a in arrays]
    stub = torch.ones(PATH_LANES, dtype=torch.bool, device="cuda")
    scatter = _scatter_args(rng, n, V, R, GRID_ROWS)
    b_ms = GRID_BYTES / HBM_BYTES_PER_S * 1e3
    stub_grid = VoteGrid(n, V, r_slots=R, device="cuda")
    stub_grid.attach_fused(lambda b: lambda *a: stub)
    calls = [
        ("update_and_tally", f"rows={GRID_ROWS} (one vote window, every replica)",
         lambda: cuda.update_and_tally(*scatter)["total"]),
        ("fused_update_and_tally", f"lanes={PATH_LANES} (verify + merge + tally)",
         lambda: cuda.fused_update_and_tally(arrays, *args).mask()),
        ("merge_tally", f"lanes={PATH_LANES} (fused call, verify a constant mask)",
         lambda: stub_grid.fused_update_and_tally(arrays, *args).mask()),
        ("verify", f"lanes={PATH_LANES} (ed25519_verify alone)",
         lambda: ed25519_cuda.verify(*dev_arrays)),
    ]
    for name, what, fn in calls:
        ms = time_ms(fn, 7)
        kern = _kernels_per_call(fn)
        bound = (f" bound_ms={b_ms:.6f} bound_by=bytes bound_share={b_ms / ms:.4f}"
                 if name != "verify" else "")
        print(f"programs: votegrid {name} {what} ms={ms:.4f}{bound} "
              f"cuda_kernels_per_call={kern}", flush=True)


# ------------------------------------------------ multi-device programs

#: The mesh legs' window: 16 rounds x the main path's 256 validators (4,096
#: lanes, one a (round, validator)), and its corrupt lanes.
MESH_ROUNDS = 16
MESH_CORRUPT = frozenset({(0, 3), (5, 200), (9, 17), (15, 255)})
#: ``challenge_from_round``'s check: 15 rounds x 256 lanes in a 4,096-lane
#: bucket, so its last 256 lanes hash the zero digest.
MESH_CHAL_ROUNDS = 15
#: ``challenge_from_round`` past 255 rounds in the 4,096-lane bucket:
#: (rounds, validators). 256 x 16 fills the bucket (no zero row: a full
#: 256-row table, the grouped form); 300 x 8 pads it (301 rows: the
#: per-lane form).
MESH_C1_SHAPES = ((256, 16), (300, 8))


def _grid_items(ring, rounds: int, validators: int, digest_of, corrupt) -> list:
    """The (pub, digest, sig) items ``parallel.grid_pack*`` sign, made
    again here for the host oracle: one vote a (round, validator), the
    corrupt lanes' s with one bit flipped."""
    items = []
    for r in range(rounds):
        digest = digest_of(r)
        for v in range(validators):
            sig = ring[v].sign_digest(digest)
            if (r, v) in corrupt:
                sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
            items.append((ring[v].public, digest, sig))
    return items


class _NoFused:
    """A batch verifier without ``fused_inner``: a device-tally run on it
    takes the two-launch settle on one device."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name == "fused_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)


def phase_mesh(clock_mhz: float, sms: int) -> dict:
    """The multi-device programs (``parallel/mesh.py``, the sharded
    ``VoteGrid``, ``Simulation(tally_mesh=)``) at world size 1 over NCCL,
    the card's only shape (one card): A ``sharded_verify_tally`` and B
    ``sharded_chalwire_tally`` on a 16 x 256 window, masks against the
    host oracle, counts against the single-device tally; C the main path
    with the sharded grid on the invariant, in turns with the
    single-device two-launch run; D ``make_sharded_step``'s example args.
    Returns the launches of rows 1, 3 and 4 in the legs' checked calls."""
    import torch.distributed as dist

    from hyperdrive_tpu_torch import parallel
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda, tally, votegrid
    from hyperdrive_tpu_torch.ops import ed25519_wire as wire
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.parallel.mesh import mesh_device
    from hyperdrive_tpu_torch.verifier import HostVerifier

    rows = ("ed25519_verify", "ed25519_semiwire", "ed25519_challenge")
    launches = dict.fromkeys(rows, 0)

    def counted(fn, keep: bool = True):
        """Run a mesh path with the counts set to 0 just before it and read
        just after; ``keep`` adds them to the phase's launches."""
        ed25519_cuda.reset_stats()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
        for k in rows:
            launches[k] += got.get(k, 0) if keep else 0
        return out, got

    t0 = time.perf_counter()
    legs = {}  # seconds a leg

    def leg(name):
        legs[name] = time.perf_counter() - t0 - sum(legs.values())

    mesh = parallel.make_mesh(device="cuda")
    try:
        backend = dist.get_backend()
        if backend != "nccl" or mesh.shape != (1, 1):
            raise AssertionError(f"mesh: backend {backend}, shape {mesh.shape}")
        dev = mesh_device(mesh)
        print(f"mesh: world_size={dist.get_world_size()} backend={backend} "
              f"shape={tuple(mesh.shape)} device={dev} init_s={time.perf_counter() - t0:.3f}",
              flush=True)
        R, V, lanes = MESH_ROUNDS, N_VALIDATORS, MESH_ROUNDS * N_VALIDATORS
        ring = KeyRing.deterministic(V, namespace=b"mesh-card")
        values = [bytes([r + 1]) * 32 for r in range(R)]
        vote = torch.from_numpy(np.stack([tally.pack_values([values[r]] * V)
                                          for r in range(R)])).to(dev)
        target = torch.from_numpy(tally.pack_values(values)).to(dev)
        f = V // 3
        pattern = np.array([[(r, v) not in MESH_CORRUPT for v in range(V)] for r in range(R)])
        oracle = HostVerifier()

        def check_step(label, out, items):
            counts, flags, ok = out
            host = np.asarray(oracle.verify_signatures(items), dtype=bool).reshape(R, V)
            if not (np.array_equal(ok.cpu().numpy(), host) and np.array_equal(host, pattern)):
                raise AssertionError(f"mesh {label}: mask != the host oracle's verdicts")
            mask = torch.from_numpy(host).to(dev)
            want = tally.tally_counts(vote, mask, target)
            want_flags = tally.quorum_flags(want, f)
            for d, w in ((counts, want), (flags, want_flags)):
                for k in w:
                    if not torch.equal(d[k], w[k]):
                        raise AssertionError(f"mesh {label}: {k} != the single-device tally's")
            return counts

        def all_reduce_ms(t):
            group = mesh.get_group("val")
            return time_ms(lambda: dist.all_reduce(t, group=group), 20)

        # Leg A: sharded_verify_tally, row 1.
        shaped, prevalid = parallel.grid_pack(ring, R, V, values, corrupt=MESH_CORRUPT,
                                              device=dev)
        if not prevalid.all():
            raise AssertionError("mesh A: a corrupt lane failed to parse")
        window = parallel.global_window_from_local(mesh, shaped)
        step_a = parallel.sharded_verify_tally(mesh)
        out, got = counted(lambda: step_a(*window, vote, target, f))
        if got != {"ed25519_verify": 1}:
            raise AssertionError(f"mesh A: launched {got}, want one ed25519_verify")
        counts_a = check_step("A", out, _grid_items(
            ring, R, V, lambda r: values[r] + bytes([r]), MESH_CORRUPT))
        ms_a = time_ms(lambda: step_a(*window, vote, target, f), 7)
        ar_ms = all_reduce_ms(torch.zeros((3, R), dtype=torch.int32, device=dev))
        b_a, by_a = bound_ms("ed25519_verify", lanes, clock_mhz, sms)
        print(f"mesh A sharded_verify_tally: rounds={R} validators={V} lanes={lanes} "
              f"corrupt={len(MESH_CORRUPT)} ed25519_verify_launches=1 "
              f"mask_equals_host_oracle=True counts_equal_single_device=True "
              f"matching={counts_a['matching'].tolist()} ms={ms_a:.4f} "
              f"all_reduce_ms={ar_ms:.4f} all_reduce_share={ar_ms / ms_a:.4f} "
              f"bound_ms={b_a:.6f} bound_by={by_a} bound_share={b_a / ms_a:.4f} "
              f"cuda_kernels_per_call="
              f"{_kernels_per_call(lambda: step_a(*window, vote, target, f))}", flush=True)

        leg("A")

        # Leg B: sharded_chalwire_tally, rows 4 and 3.
        (idx, r_rows, s_rows, m_round), table, prevalid = parallel.grid_pack_wire(
            ring, R, V, values, corrupt=MESH_CORRUPT, device=dev)
        if not prevalid.all():
            raise AssertionError("mesh B: a corrupt lane failed to parse")
        step_b = parallel.sharded_chalwire_tally(mesh)
        tab = table.arrays_chal()
        out, got = counted(lambda: step_b(idx, r_rows, s_rows, m_round, *tab, vote, target,
                                          f))
        if got != {"ed25519_challenge": 1, "ed25519_semiwire": 1}:
            raise AssertionError(f"mesh B: launched {got}, want one challenge + one semiwire")
        m_np = m_round.cpu().numpy()
        counts_b = check_step("B", out, _grid_items(
            ring, R, V, lambda r: m_np[r].tobytes(), MESH_CORRUPT))
        if any(not torch.equal(counts_a[k], counts_b[k]) for k in counts_a):
            raise AssertionError("mesh B: counts differ from leg A's")
        ms_b = time_ms(lambda: step_b(idx, r_rows, s_rows, m_round, *tab, vote, target, f), 7)
        b_b = (bound_ms("ed25519_challenge", lanes, clock_mhz, sms,
                        uniq=wire.digest_table_rows(lanes, R, V))[0]
               + bound_ms("ed25519_semiwire", lanes, clock_mhz, sms)[0])
        # challenge_from_round at 15 rounds in the 4,096-lane bucket against
        # its plain version (the reference's repeat-and-pad form).
        flat_idx, flat_r = idx.reshape(-1), r_rows.reshape(-1, 32)
        m15 = m_round[:MESH_CHAL_ROUNDS].contiguous()
        chal = wire.make_challenge_round_fn(V)
        k_rows = chal(flat_idx, flat_r, m15, table.rows)
        k_plain = wire.challenge_from_round_plain(flat_idx, flat_r, m15, table.rows, V)
        if not torch.equal(k_rows, k_plain):
            raise AssertionError("mesh B: challenge_from_round != its plain version")
        pad = lanes - MESH_CHAL_ROUNDS * V
        ms_c = time_ms(lambda: chal(flat_idx, flat_r, m15, table.rows), 20)
        plain_c = time_ms(lambda: wire.challenge_from_round_plain(
            flat_idx, flat_r, m15, table.rows, V), 3)
        b_c = bound_ms("ed25519_challenge", lanes, clock_mhz, sms,
                       uniq=wire.digest_table_rows(lanes, MESH_CHAL_ROUNDS, V))[0]
        print(f"mesh B sharded_chalwire_tally: lanes={lanes} ed25519_challenge_launches=1 "
              f"ed25519_semiwire_launches=1 mask_equals_host_oracle=True "
              f"counts_equal_leg_A=True ms={ms_b:.4f} all_reduce_share={ar_ms / ms_b:.4f} "
              f"bound_ms={b_b:.6f} bound_by=operations bound_share={b_b / ms_b:.4f} "
              f"cuda_kernels_per_call="
              f"{_kernels_per_call(lambda: step_b(idx, r_rows, s_rows, m_round, *tab, vote, target, f))}",
              flush=True)
        print(f"mesh B challenge_from_round: rounds={MESH_CHAL_ROUNDS} lanes={lanes} "
              f"zero_digest_lanes={pad} equals_plain=True max_abs_err=0 ms={ms_c:.4f} "
              f"plain_ms={plain_c:.4f} bound_ms={b_c:.6f} bound_share={b_c / ms_c:.4f} "
              f"cuda_kernels_per_call="
              f"{_kernels_per_call(lambda: chal(flat_idx, flat_r, m15, table.rows))}",
              flush=True)
        # Past 255 rounds: each shape one counted launch, byte for byte
        # its plain version.
        gen = torch.Generator().manual_seed(SEED + 21)
        for rounds, v in MESH_C1_SHAPES:
            m_c1 = torch.randint(0, 256, (rounds, 32), dtype=torch.uint8,
                                 generator=gen).to(dev)
            idx_c1 = (torch.arange(lanes, device=dev) % v).to(torch.int32)
            chal_c1 = wire.make_challenge_round_fn(v)
            k_c1, got = counted(lambda: chal_c1(idx_c1, flat_r, m_c1, table.rows))
            if got != {"ed25519_challenge": 1}:
                raise AssertionError(f"mesh B C1 {rounds}x{v}: launched {got}")
            k_plain = wire.challenge_from_round_plain(idx_c1, flat_r, m_c1, table.rows, v)
            if not torch.equal(k_c1, k_plain):
                raise AssertionError(f"mesh B C1 {rounds}x{v}: challenge_from_round != "
                                     "its plain version")
            t_rows = wire.digest_table_rows(lanes, rounds, v)
            grouped = wire.grouped_digest_index(lanes, rounds, v, "cpu") is not None
            ms_c1 = time_ms(lambda: chal_c1(idx_c1, flat_r, m_c1, table.rows), 20)
            b_c1, by_c1 = bound_ms("ed25519_challenge", lanes, clock_mhz, sms,
                                   uniq=t_rows if grouped else 0)
            print(f"mesh B challenge_from_round C1: rounds={rounds} validators={v} "
                  f"lanes={lanes} table_rows={t_rows} "
                  f"form={'grouped' if grouped else 'per-lane'} ed25519_challenge_launches=1 "
                  f"equals_plain=True max_abs_err=0 ms={ms_c1:.4f} bound_ms={b_c1:.6f} "
                  f"bound_by={by_c1} bound_share={b_c1 / ms_c1:.4f}", flush=True)

        leg("B")

        # The sharded grid's update_and_tally at the main path's shape,
        # beside the single-device grid, over one seeded settle sequence.
        n, GR = GRID_N, GRID_R
        rng = np.random.default_rng(SEED + 9)
        sharded = votegrid.VoteGrid(n, V, r_slots=GR, mesh=mesh, device="cuda")
        single = votegrid.VoteGrid(n, V, r_slots=GR, device="cuda")
        for k in (4096, 0, GRID_ROWS, 900):
            args = _scatter_args(rng, n, V, GR, k)
            got_c, want_c = sharded.update_and_tally(*args), single.update_and_tally(*args)
            for key in want_c:
                if not np.array_equal(got_c[key], want_c[key]):
                    raise AssertionError(f"mesh grid k={k}: {key} differs from one device")
        scatter = _scatter_args(rng, n, V, GR, GRID_ROWS)
        b_g = GRID_BYTES / HBM_BYTES_PER_S * 1e3
        for label, grid in (("mesh", sharded), ("single", single)):
            fn = lambda g=grid: g.update_and_tally(*scatter)["total"]  # noqa: E731
            ms = time_ms(fn, 7)
            print(f"mesh grid update_and_tally {label}: rows={GRID_ROWS} ms={ms:.4f} "
                  f"bound_ms={b_g:.6f} bound_by=bytes bound_share={b_g / ms:.4f} "
                  f"cuda_kernels_per_call={_kernels_per_call(fn)}", flush=True)
        packed = torch.zeros((n, 2 * GR * 3 + 1), dtype=torch.int32, device=dev)
        print(f"mesh grid: counts_equal_single_device=True steps=4 all_reduce_ms="
              f"{all_reduce_ms(packed):.4f} (packed counts [{n}, {2 * GR * 3 + 1}] int32)",
              flush=True)

        leg("grid")

        # Leg C: the main path with the sharded grid, then in turns with
        # the single-device two-launch run (the same routing: propose
        # settles on the host verifier).
        main = dict(n=N_VALIDATORS, seed=1, target_height=HEIGHT, sign=True, burst=True,
                    dedup_verify=True, device_tally=True)

        def leg_c(sharded_grid: bool) -> dict:
            views = []

            def check(view, proc):
                views.append(votegrid.CheckedTallyView(view, proc))
                return views[-1]

            kw = (dict(tally_mesh=mesh) if sharded_grid else
                  dict(batch_verifier=_NoFused(TorchBatchVerifier(device="cuda")),
                       small_window_host=True))
            sim = Simulation(**main, **kw, tally_check=check)
            sim.batch_verifier.warmup()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res, got = counted(sim.run, keep=sharded_grid)
            wall = time.perf_counter() - t
            digest = res.commit_digest(up_to=HEIGHT)[:16]
            settles = (sim.settle_passes, sim.vote_settles, sim.verified_sigs)
            hits = sum(v.hits for v in views)
            if (digest, res.steps, settles) != (MAIN_DIGEST, MAIN_STEPS, MAIN_SETTLES) \
                    or not res.completed or not hits:
                raise AssertionError(f"mesh C: {digest} {res.steps} {settles} hits={hits}")
            routes = (sim.fused_settles, sim.tally_launches, sim.host_routed_settles)
            if routes != (0, sim.settle_passes, 0) or sim._fused_ok:
                raise AssertionError(f"mesh C: routes {routes}, want two launches a settle")
            if set(got) != {"ed25519_verify"}:
                raise AssertionError(f"mesh C: launched {got}")
            return dict(wall=wall, launches=got["ed25519_verify"], grid_calls=sim.tally_launches,
                        hits=hits, sharded=sim.vote_grid._group is not None)

        walls = {True: [], False: []}
        runs = [leg_c(s) for s in (True, False, False, True)]
        for s, run in zip((True, False, False, True), runs):
            walls[s].append(run["wall"])
            if run["sharded"] != s:
                raise AssertionError("mesh C: the grid was not the one asked for")
        c = runs[0]
        print(f"mesh C main path sharded grid: n={N_VALIDATORS} height={HEIGHT} "
              f"digest={MAIN_DIGEST} steps={MAIN_STEPS} settles={MAIN_SETTLES[0]} "
              f"vote_settles={MAIN_SETTLES[1]} verified_sigs={MAIN_SETTLES[2]} "
              f"ed25519_verify_launches={c['launches']} grid_calls={c['grid_calls']} "
              f"all_reduces={c['grid_calls']} tally_hits={c['hits']} "
              f"wall_s_mesh={' '.join(f'{w:.3f}' for w in walls[True])} "
              f"wall_s_single_two_launch={' '.join(f'{w:.3f}' for w in walls[False])} "
              f"(in turns: mesh, single, single, mesh) "
              f"single_launches={runs[1]['launches']} matches_invariant=True", flush=True)

        leg("C")

        # Leg D: make_sharded_step's example args count nothing.
        step_d, example_args = parallel.make_sharded_step(mesh)
        args = example_args(R, V)
        (counts_d, flags_d, ok_d), got = counted(lambda: step_d(*args))
        if int(counts_d["total"].sum()) or bool(flags_d["quorum_any"].any()) \
                or bool(ok_d.any()) or got != {"ed25519_verify": 1}:
            raise AssertionError(f"mesh D: zero signatures counted or launched {got}")
        print(f"mesh D make_sharded_step: rounds={R} validators={V} zero_counts=True "
              f"ed25519_verify_launches=1", flush=True)
        leg("D")
    finally:
        dist.destroy_process_group()
    print(f"mesh: launches={launches} legs_s="
          + ",".join(f"{k}={v:.1f}" for k, v in legs.items())
          + f" phase_s={time.perf_counter() - t0:.1f}", flush=True)
    return launches


def _timed(spent, depth, key, fn):
    # Outermost calls only: the packer calls itself on a dedup fan-out.
    def run(*args, **kwargs):
        depth[key] = depth.get(key, 0) + 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            depth[key] -= 1
            if not depth[key]:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
    return run


def run_path(label: str, own: tuple, verifier, ref: dict, tally: bool = False,
             pipe: bool = False, prefix: str = "main", stats: dict = None,
             **sim_kw) -> dict:
    """One n=256 network run with ``verifier`` on every settle; checks it
    against the host-verifier result ``ref`` (digest, steps, heights) and
    the kernel counts (each kernel of ``own`` at least once per
    vote-bearing settle, no other kernel at all), prints the line. With
    ``tally`` the run keeps its counts in the device vote grid, every
    count checked against the host counters (``CheckedTallyView``), and
    its settle routes are checked: a verifier with ``fused_inner`` fuses
    every vote-bearing settle, any other verifies and then tallies in a
    launch of its own on every settle. With ``pipe`` the run pipelines
    heights: its digest, steps and heights must equal the host run's (an
    honest pipelined run is superstep-identical to the sequential one),
    its queue must have coalesced (fewer launches than commands), no
    batch may be larger, or hold more digests, than ``phase_challenge``
    checked the challenge kernel at, each own kernel must have
    launched once for every chunk of every queue launch, and a tallied
    run dispatches on the host counters (no fused settle, no tally
    launch, no host-routed settle; the grid is never read). ``sim_kw``
    overrides the network's knobs (``dedup_verify``, ``columnar_ingest``,
    ``shared_superstep``, ``pipeline_verify``); the line begins with
    ``prefix``. ``stats``, a dict, receives the run's settle passes,
    vote-bearing settles, verified signatures, steps, digest and
    replicas. Returns each own kernel's launches."""
    from hyperdrive_tpu_torch.crypto.keys import KeyPair
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import bucketing, ed25519_cuda
    from hyperdrive_tpu_torch.ops import votegrid

    views = []

    def check(view, proc):
        views.append(votegrid.CheckedTallyView(view, proc))
        return views[-1]

    knobs = dict(dict(dedup_verify=True), **sim_kw)
    sim = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True,
                     burst=True, small_window_host=False,
                     batch_verifier=verifier, pipeline_heights=pipe,
                     **(dict(device_tally=True, tally_check=check) if tally else {}),
                     **knobs)
    bv = sim.batch_verifier
    bv.warmup()
    torch.cuda.synchronize()
    spent: dict = {}
    depth: dict = {}
    calls: list = []  # items per verify_signatures call
    digests: list = []  # distinct digests per verify_signatures call
    verify_signatures = bv.verify_signatures

    def counted(items):
        calls.append(len(items))
        digests.append(len({d for _, d, _ in items}))
        return verify_signatures(items)

    bv.verify_signatures = counted
    for name in ("pack", "pack_wire", "pack_wire_challenge", "group_digests", "index_lanes"):
        if hasattr(bv.host, name):
            setattr(bv.host, name, _timed(spent, depth, "pack", getattr(bv.host, name)))
    chal_calls: list = []  # library calls of the challenge routes
    if hasattr(bv, "_chal_semi"):
        chal_semi = bv._chal_semi

        def chal_counted(*args, **kwargs):
            chal_calls.append(args[1].shape[0])
            return chal_semi(*args, **kwargs)

        bv._chal_semi = _timed(spent, depth, "chal", chal_counted)
    bv.verify_signatures = _timed(spent, depth, "verify", bv.verify_signatures)
    begin_calls: list = []  # verify_signatures_begin calls (items, repeats)
    patched = [(KeyPair, "sign_digest", "sign")]
    if hasattr(bv, "verify_signatures_begin"):
        from hyperdrive_tpu_torch.ops.ed25519_wire import PendingVerify

        begin = bv.verify_signatures_begin

        def begin_counted(items, repeats=1):
            begin_calls.append((len(items), repeats))
            return begin(items, repeats=repeats)

        # The redundant settle enqueues through begin and waits in mask():
        # both are the verify share.
        bv.verify_signatures_begin = _timed(spent, depth, "verify", begin_counted)
        patched.append((PendingVerify, "mask", "verify"))
    # The tally share: the grid calls and the waits for their results.
    if tally:
        for name in ("update_and_tally", "fused_update_and_tally"):
            setattr(sim.vote_grid, name,
                    _timed(spent, depth, "tally", getattr(sim.vote_grid, name)))
        patched += [(votegrid._FusedOut, "mask", "tally"),
                    (votegrid.LazyCounts, "_materialize", "tally")]
    saved = [(cls, name, getattr(cls, name)) for cls, name, _ in patched]
    for cls, name, key in patched:
        setattr(cls, name, _timed(spent, depth, key, getattr(cls, name)))
    try:
        ed25519_cuda.reset_stats()
        if hasattr(bv, "reset_stats"):
            bv.reset_stats()
        t0 = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: (v.launches, v.lanes) for k, v in ed25519_cuda.stats.items()}
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)

    if not res.completed or min(res.heights) <= HEIGHT:
        raise AssertionError(f"{label}: network did not reach height {HEIGHT}: {res.heights}")
    res.assert_safety()
    if res.commit_digest(up_to=HEIGHT) != ref["digest"]:
        raise AssertionError(f"{label}: commit digest differs from the host-verifier run")
    if (res.steps, res.heights) != (ref["steps"], ref["heights"]):
        raise AssertionError(f"{label}: steps or heights differ from the host-verifier run")
    launches = {k: counts[k][0] for k in own}
    extra = ""
    if pipe:
        q = sim._sched
        cap = bucketing.launch_target(bv.host.buckets)
        chunks = sum(math.ceil(n / cap) for n in calls)
        if not (q.launches < q.submitted and q.coalesced > 0 and q.depth == 0):
            raise AssertionError(
                f"{label}: queue submitted={q.submitted} launches={q.launches} "
                f"coalesced={q.coalesced} depth={q.depth}: nothing coalesced")
        if len(calls) != q.launches or any(n != chunks for n in launches.values()):
            raise AssertionError(
                f"{label}: {launches} kernel launches for {q.launches} queue launches "
                f"({len(calls)} verify calls, {chunks} chunks)")
        if max(calls) > PIPE_BATCH or max(digests) > PIPE_DIGESTS:
            raise AssertionError(
                f"{label}: batches {calls} with {digests} digests exceed the "
                f"{PIPE_BATCH} items and {PIPE_DIGESTS} digests phase_challenge checked")
        extra = (f" queue_submitted={q.submitted} queue_launches={q.launches} "
                 f"queue_coalesced={q.coalesced} items_per_launch={calls} "
                 f"digests_per_launch={digests}")
    for k, n in launches.items():
        if not pipe and (n < sim.vote_settles or n == 0):
            raise AssertionError(
                f"{label}: {n} {k} launches for {sim.vote_settles} vote-bearing settles")
    moved = {k: c for k, c in counts.items() if k not in own and c[0]}
    if moved:
        raise AssertionError(f"{label}: other kernels launched: {moved}")
    if begin_calls:
        # verify_signatures calls begin once itself: the rest came from the
        # redundant settle's replica groups.
        extra += (f" verify_calls={len(calls)} begin_calls={len(begin_calls)}"
                  f" begin_repeats_max={max(r for _, r in begin_calls)}")
    if "ed25519_challenge" in own:
        # One library call (hd_ed25519_chal_semiwire_verify) a chunk,
        # which launches both kernels.
        if not (len(chal_calls) == launches["ed25519_challenge"]
                == launches["ed25519_semiwire"]):
            raise AssertionError(f"{label}: {len(chal_calls)} chal_semiwire calls for "
                                 f"{launches} launches")
        extra += f" chal_semiwire_calls={len(chal_calls)}"
    if hasattr(bv, "stats"):
        key = "lanes_grouped" if bv.table is not None else "lanes_wire"
        if bv.stats[key] != sim.verified_sigs:
            raise AssertionError(
                f"{label}: {key}={bv.stats[key]} for {sim.verified_sigs} verified signatures")
        extra += (f" {key}={bv.stats[key]} bytes_per_lane={bv.bytes_per_lane():.2f}")
    if tally:
        hits = sum(v.hits for v in views)
        if not hits and not pipe:
            raise AssertionError(f"{label}: the device counts were never consulted")
        routes = (sim.fused_settles, sim.tally_launches, sim.host_routed_settles)
        want = ((0, 0, 0) if pipe
                else (sim.vote_settles, 0, 0) if sim._fused_ok
                else (0, sim.settle_passes, 0))
        if routes != want or not sim.vote_settles:
            raise AssertionError(
                f"{label}: (fused settles, tally launches, host-routed settles) = "
                f"{routes}, want {want}")
        extra += (f" fused_settles={sim.fused_settles} tally_launches={sim.tally_launches}"
                  f" host_routed_settles={sim.host_routed_settles} tally_views={len(views)}"
                  f" tally_hits={hits}")
    shares = " ".join(f"{k}_share={spent.get(k, 0.0) / wall:.3f}"
                      for k in ("sign", "pack", "chal", "verify", "tally"))
    knob_text = "".join(f" {k}={v}" for k, v in sim_kw.items())
    print(f"{prefix} {label}:{knob_text} n={N_VALIDATORS} height={HEIGHT} "
          f"completed={res.completed} "
          f"steps={res.steps} wall_s={wall:.2f} heights_per_s={HEIGHT / wall:.3f} "
          f"verified_sigs={sim.verified_sigs} "
          f"verified_sigs_per_s={sim.verified_sigs / wall:.0f} "
          f"settle_passes={sim.settle_passes} vote_settles={sim.vote_settles} "
          + "".join(f"{k}_launches={counts[k][0]} {k}_lanes={counts[k][1]} " for k in own)
          + f"launches_per_height={sum(launches.values()) / HEIGHT:.1f}{extra} {shares} "
          f"digest={res.commit_digest(up_to=HEIGHT)[:16]} matches_host=True", flush=True)
    if stats is not None:
        stats.update(settle_passes=sim.settle_passes, vote_settles=sim.vote_settles,
                     verified_sigs=sim.verified_sigs, steps=res.steps,
                     digest=res.commit_digest(up_to=HEIGHT)[:16], replicas=sim.replicas)
    return launches


def python_host_child(ref: dict) -> int:
    """``packed`` with the pure-Python host (run in a child process whose
    environment sets ``HD_NO_NATIVE=1``; the kernel library is the
    parent's build)."""
    from hyperdrive_tpu_torch import native
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

    if native.available():
        raise AssertionError("the python-host run loaded the native runtime")
    run_path("packed (python host)", ("ed25519_verify",),
             TorchBatchVerifier(device="cuda"), ref)
    return 0


def run_python_host(ref: dict) -> None:
    env = dict(os.environ, HD_NO_NATIVE="1")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--python-host", json.dumps(ref)],
        env=env, capture_output=True, text=True, timeout=600,
    )
    sys.stdout.write(proc.stdout)
    sys.stdout.flush()
    if proc.returncode != 0:
        raise AssertionError(f"packed (python host) failed ({proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")


def phase_main_path() -> tuple:
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.ops.ed25519_wire import TorchWireVerifier, ValidatorTable
    from hyperdrive_tpu_torch.verifier import HostVerifier

    t0 = time.perf_counter()
    host = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True,
                      burst=True, dedup_verify=True, small_window_host=False,
                      batch_verifier=HostVerifier()).run()
    ref = {"digest": host.commit_digest(up_to=HEIGHT), "steps": host.steps,
           "heights": host.heights}
    print(f"main host: host_verifier_wall_s={time.perf_counter() - t0:.2f} "
          f"steps={host.steps} digest={ref['digest'][:16]}", flush=True)
    ring = KeyRing.deterministic(N_VALIDATORS, namespace=b"sim-1")
    table = ValidatorTable(ring.signatories, device="cuda")
    launches = {
        **run_path("packed", ("ed25519_verify",), TorchBatchVerifier(device="cuda"), ref),
        **run_path("chal", ("ed25519_challenge", "ed25519_semiwire"),
                   TorchWireVerifier(device="cuda", table=table), ref),
        **run_path("wire", ("ed25519_wire",), TorchWireVerifier(device="cuda"), ref),
    }
    # The device-tally path: fused on the packed verifier, two launches on
    # the challenge route. The kernel table keeps the runs above.
    run_path("packed+tally", ("ed25519_verify",), TorchBatchVerifier(device="cuda"), ref,
             tally=True)
    run_path("chal+tally", ("ed25519_challenge", "ed25519_semiwire"),
             TorchWireVerifier(device="cuda", table=table), ref, tally=True)
    run_python_host(ref)
    # Pipelined heights: settles coalesce in the device-work queue.
    run_path("packed+pipe", ("ed25519_verify",),
             TorchBatchVerifier(buckets=PIPE_BUCKETS, device="cuda"), ref, pipe=True)
    run_path("chal+pipe", ("ed25519_challenge", "ed25519_semiwire"),
             TorchWireVerifier(buckets=PIPE_BUCKETS, device="cuda", table=table), ref,
             pipe=True)
    run_path("packed+tally+pipe", ("ed25519_verify",),
             TorchBatchVerifier(buckets=PIPE_BUCKETS, device="cuda"), ref, tally=True,
             pipe=True)
    phase_pairs(ref)
    return launches, ref


#: The main path's invariant: what every route of the n = 256, seed 1,
#: 5-height run must give (and has given on every route since it ran).
INVARIANT = {"digest": "215413db54656240", "steps": 656_640, "settle_passes": 15,
             "vote_settles": 10, "verified_sigs": 2_565}


def _armed():
    """``HD_SANITIZE=1`` for the body alone; the environment comes back
    after."""
    return mock.patch.dict(os.environ, {"HD_SANITIZE": "1"})


def _lying_grid_commit():
    """The reference's Byzantine-tally scenario with a card tally: one
    sanitized Process (f = 1) logs a valid proposal and ONE precommit; a
    vote grid on the card holds three precommits for the value from
    validators the host never heard, and its TallyView hands that forged
    quorum to the rule cascade. Returns the SanitizerError (None if the
    cascade committed) and the app's commits."""
    from types import SimpleNamespace

    from hyperdrive_tpu_torch.analysis import sanitizer
    from hyperdrive_tpu_torch.messages import Precommit, Propose
    from hyperdrive_tpu_torch.ops import votegrid
    from hyperdrive_tpu_torch.process import Process
    from hyperdrive_tpu_torch.testutil import (
        BroadcasterCallbacks,
        CommitterCallback,
        MockProposer,
        MockValidator,
    )
    from hyperdrive_tpu_torch.types import INVALID_ROUND, NIL_VALUE

    value, proposer = b"\xab" * 32, b"\x02" * 32
    commits = []
    proc = Process(whoami=b"\x01" * 32, f=1, timer=None,
                   scheduler=SimpleNamespace(schedule=lambda h, r: proposer),
                   proposer=MockProposer(value=value), validator=MockValidator(ok=True),
                   broadcaster=BroadcasterCallbacks(),
                   committer=CommitterCallback(
                       on_commit=lambda h, v: (commits.append((h, v)), (0, None))[1]),
                   catcher=None, height=1)
    sanitizer.maybe_install(proc)
    proc.start()
    proc.propose(Propose(height=1, round=0, valid_round=INVALID_ROUND, value=value,
                         sender=proposer))
    proc.precommit(Precommit(height=1, round=0, value=value, sender=b"\x03" * 32))
    R = 4
    grid = votegrid.VoteGrid(1, 4, r_slots=R, buckets=(16,), device="cuda")
    targets = np.zeros((1, R, 8), dtype=np.int32)
    tvalid = np.zeros((1, R), dtype=bool)
    targets[0, 0], tvalid[0, 0] = _words(value), True
    counts = grid.update_and_tally(
        np.array([[0, 1, 0, v] for v in (1, 2, 3)], dtype=np.int32),
        np.stack([_words(value)] * 3), np.zeros(1, dtype=bool), targets, tvalid,
        np.array([-1], dtype=np.int32), np.zeros((1, 8), dtype=np.int32),
        np.ones(1, dtype=np.int32))
    view = votegrid.TallyView(0, 1, counts, R, {0: value}, -1, NIL_VALUE)
    claimed = view.precommits_for(0, value)
    try:
        proc.ingest_cascade(({0}, set()), tallies=view)
    except sanitizer.SanitizerError as e:
        return e, commits, claimed
    return None, commits, claimed


def _hds004_flusher() -> tuple:
    """One DeviceTallyFlusher on the card built without a ``tally_check``
    under the sanitizer, so it takes HDS004's view: a signed n = 256
    window (propose, every prevote and precommit) through
    ``settle_block``. Returns (queries HDS004 checked, commits, launches)."""
    from hyperdrive_tpu_torch import batch, messages
    from hyperdrive_tpu_torch.analysis import sanitizer
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.replica import Replica, ReplicaOptions
    from hyperdrive_tpu_torch.tallyflush import DeviceTallyFlusher
    from hyperdrive_tpu_torch.testutil import CommitterCallback
    from hyperdrive_tpu_torch.types import INVALID_ROUND

    ring = KeyRing.deterministic(N_VALIDATORS, namespace=b"sim-1")
    sigs = ring.signatories
    value = hashlib.sha256(b"sanitize-hds004").digest()
    window = [ring[1].sign_message(messages.Propose(
        height=1, round=0, valid_round=INVALID_ROUND, value=value, sender=sigs[1]))]
    for kind in (messages.Prevote, messages.Precommit):
        window += [ring[i].sign_message(kind(height=1, round=0, value=value,
                                             sender=sigs[i])) for i in range(N_VALIDATORS)]
    bv = TorchBatchVerifier(device="cuda")
    bv.warmup()
    fl = DeviceTallyFlusher(bv, sigs, device="cuda")
    if fl.tally_check is not sanitizer.maybe_tally_check():
        raise AssertionError(f"sanitize hds004: the flusher's tally_check is "
                             f"{fl.tally_check}, not HDS004's")
    views = []
    hds004 = fl.tally_check
    fl.tally_check = lambda view, proc: views.append(hds004(view, proc)) or views[-1]
    commits: dict = {}
    rep = Replica(ReplicaOptions(), whoami=sigs[0], signatories=list(sigs), timer=None,
                  proposer=None, validator=None,
                  committer=CommitterCallback(on_commit=lambda h, v: (
                      commits.__setitem__(h, v), (0, None))[1]),
                  catcher=None, broadcaster=None, flusher=fl)
    if not isinstance(rep.proc.committer, sanitizer._SanitizedCommitter):
        raise AssertionError("sanitize hds004: the replica is not sanitized")
    rep.start()
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    fl.settle_block(rep, batch.MessageBlock.from_messages(window))
    torch.cuda.synchronize()
    launches = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
    if commits != {1: value}:
        raise AssertionError(f"sanitize hds004: commits {commits}")
    return sum(v.hits for v in views), len(views), launches


def phase_sanitize(ref: dict) -> dict:
    """The runtime consensus sanitizer on the card (lines ``sanitize``),
    with ``HD_SANITIZE=1`` for this phase alone: the main path's invariant
    run armed on the packed+tally and chal+tally routes (every replica
    sanitized, every commit recounted from the host logs: HDS001-HDS003);
    the Byzantine-tally scenario with a vote grid on the card claiming a
    quorum the host logs lack, which must die with HDS001; and one
    DeviceTallyFlusher run on its default tally_check, HDS004's, which must
    check at least one query. Returns the launches by row."""
    from hyperdrive_tpu_torch.analysis import sanitizer
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.ops.ed25519_wire import TorchWireVerifier, ValidatorTable

    t_phase = time.perf_counter()
    before = os.environ.get("HD_SANITIZE")
    launches: dict = {}
    checked = []
    real_commit = sanitizer._SanitizedCommitter.commit

    def counted(self, height, value):
        checked.append(height)
        return real_commit(self, height, value)

    with _armed():
        if not sanitizer.enabled():
            raise AssertionError("sanitize: HD_SANITIZE=1 did not arm the sanitizer")
        table = ValidatorTable(KeyRing.deterministic(N_VALIDATORS, namespace=b"sim-1")
                               .signatories, device="cuda")
        sanitizer._SanitizedCommitter.commit = counted
        try:
            for label, own, verifier in (
                    ("packed+tally", ("ed25519_verify",), TorchBatchVerifier(device="cuda")),
                    ("chal+tally", ("ed25519_challenge", "ed25519_semiwire"),
                     TorchWireVerifier(device="cuda", table=table))):
                stats: dict = {}
                checked.clear()
                got = run_path(label, own, verifier, ref, tally=True, prefix="sanitize",
                               stats=stats)
                armed = sum(isinstance(r.proc.committer, sanitizer._SanitizedCommitter)
                            for r in stats.pop("replicas"))
                want = dict(INVARIANT)
                if {k: stats[k] for k in want} != want or armed != N_VALIDATORS:
                    raise AssertionError(f"sanitize {label}: {stats}, {armed} sanitized "
                                         f"replicas; want {want} and {N_VALIDATORS}")
                if len(checked) < N_VALIDATORS * HEIGHT:
                    raise AssertionError(f"sanitize {label}: {len(checked)} commits "
                                         "went through the sanitizer")
                for k, n in got.items():
                    launches[k] = launches.get(k, 0) + n
                print(f"sanitize {label}: sanitized_replicas={armed} "
                      f"commits_recounted={len(checked)} invariant_held=True", flush=True)
        finally:
            sanitizer._SanitizedCommitter.commit = real_commit

        err, commits, claimed = _lying_grid_commit()
        if (err is None or err.rule != "HDS001" or commits or claimed != 3
                or "no host-log quorum" not in str(err)):
            raise AssertionError(f"sanitize lying tally: {err!r}, commits {commits}, "
                                 f"card grid claims {claimed}, want 3")
        print(f"sanitize lying tally: card_grid_claims={claimed} host_precommits=1 "
              f"rule={err.rule} commits=0 no_host_log_quorum=True", flush=True)

        hits, views, got = _hds004_flusher()
        if hits < 1 or got != {"ed25519_verify": 1}:
            raise AssertionError(f"sanitize hds004: {hits} queries checked, launches {got}")
        launches["ed25519_verify"] = launches.get("ed25519_verify", 0) + 1
        print(f"sanitize hds004: flusher_views={views} queries_checked={hits} "
              f"launches={got}", flush=True)
    if os.environ.get("HD_SANITIZE") != before:
        raise AssertionError("sanitize: the environment was not restored")
    ed25519_cuda.reset_stats()
    print(f"sanitize: wall_s={time.perf_counter() - t_phase:.3f} "
          + " ".join(f"{k}_launches={n}" for k, n in sorted(launches.items()))
          + f" card={card_line()!r}", flush=True)
    return launches


def phase_pairs(ref: dict, legs=None, pairs: int = 2) -> None:
    """Wall of two variants of the packed network in turns (a, b, b, a;
    ``pairs`` times), each run checked for the host digest: walls are
    compared only within one call. ``legs``: two (label, verifier,
    Simulation options) triples; by default the sequential and the
    pipelined run, which differ in launches and syncs."""
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

    if legs is None:
        legs = (("packed", TorchBatchVerifier(device="cuda"), {}),
                ("packed+pipe", TorchBatchVerifier(buckets=PIPE_BUCKETS, device="cuda"),
                 dict(pipeline_heights=True)))
    walls: dict = {label: [] for label, _, _ in legs}
    for _, bv, _ in legs:
        bv.warmup()
    for _ in range(pairs):
        for label, bv, kw in (legs[0], legs[1], legs[1], legs[0]):
            sim = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True,
                             burst=True, dedup_verify=True, small_window_host=False,
                             batch_verifier=bv, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sim.run()
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
            if res.commit_digest(up_to=HEIGHT) != ref["digest"]:
                raise AssertionError(f"pairs: digest differs ({label})")
    for label, _, kw in legs:
        w = sorted(walls[label])
        q1, med, q3 = np.percentile(w, [25, 50, 75])
        knobs = "".join(f" {k}={v}" for k, v in kw.items())
        print(f"pairs: {label}:{knobs} runs={len(w)} "
              f"wall_s={[round(x, 4) for x in walls[label]]} "
              f"median_s={med:.4f} iqr_s={q3 - q1:.4f} heights_per_s={HEIGHT / med:.3f}",
              flush=True)


# ------------------------------------------------- burst-mode delivery

#: BASELINE config 3 at its published size (``benches/run_all.py``
#: ``config_3``: 64 replicas, seed 1003, replicas 1..21 offline, 20 s
#: timeouts, 1 ms a delivery, adversarial reorder), signed with dedup
#: verification as config 8(a) runs its adversarial leg; cut to 2 heights.
ADV = dict(n=64, target_height=2, seed=1003, reorder=True, offline=set(range(1, 22)),
           timeout=20.0, delivery_cost=0.001, sign=True, burst=True, dedup_verify=True)
ADV_HEIGHTS = 2
#: The adversarial legs' AdaptiveVerifier calibrates on one window this
#: large (its ``calibrate_at`` is 384; no settle window of the run is).
ADV_CALIBRATE = 512
#: The main path's settle passes, vote-bearing settles and verified
#: signatures, equal on every route and in the host run.
MAIN_SETTLES = (15, 10, 2565)


def _adversarial_leg(label: str, verifier, ref, **extra) -> dict:
    """One leg of the n = 64 adversarial run: commits, steps and heights
    equal to the host leg's ``ref`` (None for the host leg itself); the
    kernel counts read around the run; returns the leg's result."""
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    sim = Simulation(**ADV, batch_verifier=verifier, device="cuda", **extra)
    bv = sim.batch_verifier
    sizes: list = []
    inner = bv.verify_signatures

    def recorded(items):
        sizes.append(len(items))
        return inner(items)

    bv.verify_signatures = recorded
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    t0 = time.perf_counter()
    res = sim.run(max_steps=50_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
    res.assert_safety()
    got = (res.commit_digest(up_to=ADV_HEIGHTS), res.steps, res.heights)
    if not res.completed:
        raise AssertionError(f"burst adversarial {label}: stalled at {set(res.heights)}")
    if ref is not None and got != ref:
        raise AssertionError(f"burst adversarial {label}: digest, steps or heights "
                             f"differ from the host leg")
    return dict(sim=sim, res=res, wall=wall, launches=launches, sizes=sizes, got=got)


def _adversarial_line(label: str, leg: dict, extra: str = "") -> None:
    sim, res, sizes = leg["sim"], leg["res"], leg["sizes"]
    print(f"burst adversarial {label}: n={ADV['n']} heights={ADV_HEIGHTS} "
          f"online={ADV['n'] - len(ADV['offline'])} steps={res.steps} "
          f"wall_s={leg['wall']:.3f} heights_per_s={ADV_HEIGHTS / leg['wall']:.4f} "
          f"settles={sim.settle_passes} vote_settles={sim.vote_settles} "
          f"verify_calls={len(sizes)} window_p50={statistics.median(sizes)} "
          f"window_max={max(sizes)} verified_sigs={sim.verified_sigs} "
          f"launches={leg['launches']} host_routed_settles={sim.host_routed_settles}"
          f"{extra} digest={leg['got'][0][:16]} matches_host=True", flush=True)


def phase_adversarial() -> None:
    """(iii) of the burst phase: the n = 64 adversarial network, per-delivery
    superstep (reorder), every settle through one verify call, on four
    legs: HostVerifier; the packed verifier with small_window_host=False
    (one ``ed25519_verify`` launch a settle); the same with
    ``device_tally=True`` and ``CheckedTallyView`` (two launches a settle:
    verify, then ``update_and_tally``); ``AdaptiveVerifier`` whose device
    leg is the packed verifier on the card, calibrated on one
    ``ADV_CALIBRATE``-signature window before the run (its cross-check
    against the host leg included), then routing each window by the
    crossover it measured. Every leg commits the host leg's digest in its
    steps."""
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.ops import votegrid
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.verifier import AdaptiveVerifier, HostVerifier

    host = _adversarial_leg("host", HostVerifier(), None)
    if host["launches"]:
        raise AssertionError(f"burst adversarial host: kernels launched: {host['launches']}")
    _adversarial_line("host", host)
    ref = host["got"]

    packed = TorchBatchVerifier(device="cuda")
    packed.warmup()
    leg = _adversarial_leg("packed", packed, ref, small_window_host=False)
    if leg["launches"] != {"ed25519_verify": len(leg["sizes"])}:
        raise AssertionError(f"burst adversarial packed: {leg['launches']} for "
                             f"{len(leg['sizes'])} verify calls")
    _adversarial_line("packed", leg)

    views = []

    def check(view, proc):
        views.append(votegrid.CheckedTallyView(view, proc))
        return views[-1]

    leg = _adversarial_leg("packed+tally", packed, ref, small_window_host=False,
                           device_tally=True, tally_check=check)
    sim = leg["sim"]
    hits = sum(v.hits for v in views)
    if leg["launches"] != {"ed25519_verify": len(leg["sizes"])}:
        raise AssertionError(f"burst adversarial packed+tally: {leg['launches']}")
    if not (hits and sim.tally_launches == sim.settle_passes and not sim.fused_settles):
        raise AssertionError(f"burst adversarial packed+tally: {hits} checked counts, "
                             f"{sim.tally_launches} tally launches for "
                             f"{sim.settle_passes} settles, {sim.fused_settles} fused")
    _adversarial_line("packed+tally", leg,
                      f" tally_launches={sim.tally_launches} tally_hits={hits}")

    av = AdaptiveVerifier(device=TorchBatchVerifier(device="cuda"))
    av.device.warmup()
    ring = KeyRing.deterministic(ADV["n"], namespace=b"sim-%d" % ADV["seed"])
    cal = []
    for j in range(ADV_CALIBRATE):
        d = hashlib.sha256(b"calibrate-%d" % j).digest()
        sig = ring[j % ADV["n"]].sign_digest(d)
        cal.append((ring.signatories[j % ADV["n"]], d, bytes(64) if j % 37 == 5 else sig))
    mask = [bool(b) for b in av.verify_signatures(cal)]
    if not av.calibrated or mask != [j % 37 != 5 for j in range(ADV_CALIBRATE)]:
        raise AssertionError("burst adversarial adaptive: calibration failed")
    host_calls = [0]
    host_verify = av.host.verify_signatures

    def host_counted(items):
        host_calls[0] += 1
        return host_verify(items)

    av.host.verify_signatures = host_counted
    leg = _adversarial_leg("adaptive", av, ref)
    device_windows = sum(1 for n in leg["sizes"] if n >= av.crossover)
    if (leg["launches"].get("ed25519_verify", 0) != device_windows
            or set(leg["launches"]) - {"ed25519_verify"}
            or host_calls[0] != len(leg["sizes"]) - device_windows):
        raise AssertionError(f"burst adversarial adaptive: {leg['launches']} launches, "
                             f"{host_calls[0]} host windows, crossover {av.crossover}")
    rates = {k: float(f"{v:.6g}") for k, v in av.rates.items()}
    _adversarial_line("adaptive", leg,
                      f" crossover={av.crossover} device_windows={device_windows} "
                      f"host_windows={host_calls[0]} rates={json.dumps(rates)}")


def phase_settle_block() -> None:
    """(iv) of the burst phase: one signed n = 256 window (the height-1
    propose, every prevote and precommit, three prevotes forged) through
    ``DeviceTallyFlusher.settle_block`` on the card (one ``ed25519_verify``
    launch, the grid on the card), against the same window inserted into
    the replica's queue and flushed on the object path with the host
    verifier: equal commits, tally counts and checkpoint bytes."""
    from hyperdrive_tpu_torch import batch, messages
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.ops import ed25519_cuda, votegrid
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.replica import Replica, ReplicaOptions
    from hyperdrive_tpu_torch.tallyflush import DeviceTallyFlusher
    from hyperdrive_tpu_torch.testutil import CommitterCallback
    from hyperdrive_tpu_torch.types import INVALID_ROUND
    from hyperdrive_tpu_torch.utils.checkpoint import checkpoint_bytes
    from hyperdrive_tpu_torch.verifier import HostVerifier

    ring = KeyRing.deterministic(N_VALIDATORS, namespace=b"sim-1")
    sigs = ring.signatories
    value = hashlib.sha256(b"settle-block").digest()
    window = [ring[1].sign_message(messages.Propose(
        height=1, round=0, valid_round=INVALID_ROUND, value=value, sender=sigs[1]))]
    forged = {7, 100, 200}
    for kind in (messages.Prevote, messages.Precommit):
        for i in range(N_VALIDATORS):
            m = ring[i].sign_message(kind(height=1, round=0, value=value, sender=sigs[i]))
            if kind is messages.Prevote and i in forged:
                m = m.with_signature(bytes(64))
            window.append(m)

    def replica(verifier):
        commits: dict = {}
        views: list = []

        def check(view, proc):
            views.append(votegrid.CheckedTallyView(view, proc))
            return views[-1]

        fl = DeviceTallyFlusher(verifier, sigs, tally_check=check, device="cuda")
        rep = Replica(ReplicaOptions(), whoami=sigs[0], signatories=list(sigs), timer=None,
                      proposer=None, validator=None,
                      committer=CommitterCallback(on_commit=lambda h, v: (
                          commits.__setitem__(h, v), (0, None))[1]),
                      catcher=None, broadcaster=None, flusher=fl)
        rep.start()
        return rep, fl, commits, views

    bv = TorchBatchVerifier(device="cuda")
    bv.warmup()
    rep, fl, commits, views = replica(bv)
    obj, obj_fl, obj_commits, obj_views = replica(HostVerifier())
    block = batch.MessageBlock.from_messages(window)
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    t0 = time.perf_counter()
    fl.settle_block(rep, block)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
    for m in window:
        getattr(obj.mq, f"insert_{type(m).__name__.lower()}")(m)
    t0 = time.perf_counter()
    obj_fl.flush(obj)
    obj_wall = time.perf_counter() - t0
    keys = ("matching", "nil", "total", "l28")
    got = [{k: v.view.counts[k].tolist() for k in keys} for v in views]
    want = [{k: v.view.counts[k].tolist() for k in keys} for v in obj_views]
    if launches != {"ed25519_verify": 1}:
        raise AssertionError(f"burst settle_block: launches {launches}")
    if commits != obj_commits or commits != {1: value} or got != want:
        raise AssertionError("burst settle_block: commits or counts differ from the "
                             "object path")
    if checkpoint_bytes(rep.proc) != checkpoint_bytes(obj.proc):
        raise AssertionError("burst settle_block: checkpoint bytes differ")
    if not sum(v.hits for v in views):
        raise AssertionError("burst settle_block: the device counts were never consulted")
    print(f"burst settle_block: n={N_VALIDATORS} rows={len(block)} forged={len(forged)} "
          f"launches={launches} fastpath_rows={fl.fastpath_rows} tally_launches="
          f"{fl.launches} commits={sorted(commits)} wall_ms={wall * 1e3:.2f} "
          f"object_path_wall_ms={obj_wall * 1e3:.2f} counts_equal=True "
          f"checkpoint_equal=True", flush=True)


def phase_burst(ref: dict) -> None:
    """The burst phase: (i) the main path on its other delivery routes,
    (ii) the redundant settle with and without ``pipeline_verify``, (iii)
    the n = 64 adversarial network, (iv) ``settle_block`` on the card.
    Each path is driven with the kernel counts set to 0 just before it and
    read just after. ``ref`` is the main path's host run."""
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.ops.ed25519_wire import TorchWireVerifier, ValidatorTable

    if ref["digest"][:16] != MAIN_DIGEST or ref["steps"] != MAIN_STEPS:
        raise AssertionError("burst: the main path's host run moved off the invariant")
    print(f"burst: invariant digest={MAIN_DIGEST} steps={MAIN_STEPS} "
          f"settles/vote_settles/verified_sigs={'/'.join(map(str, MAIN_SETTLES))}",
          flush=True)
    ring = KeyRing.deterministic(N_VALIDATORS, namespace=b"sim-1")
    table = ValidatorTable(ring.signatories, device="cuda")
    packed = ("ed25519_verify",)
    chal = ("ed25519_challenge", "ed25519_semiwire")
    # (i) the main path on the object path and per delivery.
    run_path("packed", packed, TorchBatchVerifier(device="cuda"), ref, prefix="burst",
             columnar_ingest=False)
    run_path("packed", packed, TorchBatchVerifier(device="cuda"), ref, prefix="burst",
             shared_superstep=False)
    run_path("packed+tally", packed, TorchBatchVerifier(device="cuda"), ref, tally=True,
             prefix="burst", columnar_ingest=False)
    run_path("chal+tally", chal, TorchWireVerifier(device="cuda", table=table), ref,
             tally=True, prefix="burst", columnar_ingest=False)
    # The main path's columnar settle against the object path, in turns.
    phase_pairs(ref, legs=(("packed (columnar)", TorchBatchVerifier(device="cuda"), {}),
                           ("packed (objects)", TorchBatchVerifier(device="cuda"),
                            dict(columnar_ingest=False))))
    # (ii) redundant verification: every receiver's copy on the card.
    for label, own, table_ in (("chal", chal, table), ("wire", ("ed25519_wire",), None)):
        for pv in (True, False):
            run_path(label, own, TorchWireVerifier(device="cuda", table=table_), ref,
                     prefix="burst", dedup_verify=False, pipeline_verify=pv)
    phase_adversarial()
    phase_settle_block()


# ------------------------------------------------- lock-step delivery

#: BASELINE config 2's network as ``benches/run_all.py`` runs it (16
#: replicas, seed 1002, 20 s timeouts, 1 ms a delivery), lock-step, cut
#: from 1,000 heights to 20; config 3's (64 replicas, seed 1003, replicas
#: 1-21 offline, reorder), lock-step, cut from 20 heights to 2.
LOCK2 = dict(n=16, target_height=20, seed=1002, timeout=20.0, delivery_cost=0.001)
LOCK3 = dict(n=64, target_height=2, seed=1003, offline=set(range(1, 22)), reorder=True,
             timeout=20.0, delivery_cost=0.001)
#: What the JAX package's lock-step runs of those networks give (commit
#: digest, steps; the unsigned dump's SHA-256 prefix and bytes): a queue
#: that drains at depth 64 moves config 2 to 10,496 steps and config 3 to
#: 240,347, on the same chain.
LOCK2_DIGEST, LOCK2_STEPS, LOCK2_DEEP_STEPS = "43d6ecfa0a44321d", 10_480, 10_496
LOCK2_DUMP = ("c436b3d9b3d06ea6", 937_123)
LOCK3_DIGEST, LOCK3_STEPS, LOCK3_DEEP_STEPS = "4d1df1abe052651e", 240_367, 240_347
LOCK3_DUMP = ("7c5dd3ebfebc6de7", 14_241_505)
#: Queue launches of the shared-verifier legs on config 2 (JAX runs).
LOCK2_QUEUE_LAUNCHES = {8: 1_120, 64: 160}
#: Heights of the lock-step execution leg (config 2's network with leg B's
#: ledger, below), cut from leg B's 5 to keep the phase short.
LOCK_EXEC_HEIGHTS = 3


def _dump_check(label: str, record, tmp: str, want=None) -> tuple:
    """Dump ``record``, load it back, return (loaded record, SHA-256 prefix,
    bytes, dump s, load s); with ``want`` the prefix and size must match."""
    from hyperdrive_tpu_torch.harness import ScenarioRecord

    path = os.path.join(tmp, label.replace(" ", "_") + ".bin")
    t0 = time.perf_counter()
    record.dump(path)
    t1 = time.perf_counter()
    with open(path, "rb") as fh:
        data = fh.read()
    rec = ScenarioRecord.load(path)
    t2 = time.perf_counter()
    os.remove(path)
    sha = hashlib.sha256(data).hexdigest()[:16]
    if want is not None and (sha, len(data)) != want:
        raise AssertionError(f"lockstep {label}: dump {sha} of {len(data)} bytes, "
                             f"want {want[0]} of {want[1]}")
    if len(rec.messages) != len(record.messages) or rec.bursts != record.bursts:
        raise AssertionError(f"lockstep {label}: the loaded record differs")
    return rec, sha, len(data), t1 - t0, t2 - t1


def _lockstep_leg(label: str, kw: dict, want: tuple, own: tuple = (), queue=None,
                  warm=(), extra_line: str = "", **sim_kw) -> dict:
    """One lock-step run: the kernel counts set to 0 just before it and read
    just after; commits, steps and digest checked against ``want``
    (digest prefix, steps); each kernel of ``own`` launched, no other;
    one line with wall, steps, digest, launches and the queue's counts."""
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    sim = Simulation(**kw, **sim_kw)
    for r in sim.replicas:
        f = r.flusher
        if f is not None and hasattr(f, "warmup"):
            f.warmup()
    for v in warm:
        v.warmup()
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
    res.assert_safety()
    digest = res.commit_digest()[:16]
    if not res.completed or (digest, res.steps) != want:
        raise AssertionError(f"lockstep {label}: digest {digest} in {res.steps} steps "
                             f"(completed={res.completed}), want {want[0]} in {want[1]}")
    if set(launches) != set(own) or not all(launches.values()):
        raise AssertionError(f"lockstep {label}: launched {launches}, want {own}")
    q = queue
    qtext = (f" queue_submitted={q.submitted} queue_launches={q.launches} "
             f"queue_coalesced={q.coalesced}" if q is not None else "")
    if q is not None and (q.depth or not q.launches < q.submitted):
        raise AssertionError(f"lockstep {label}:{qtext} depth={q.depth}: nothing coalesced")
    print(f"lockstep {label}: n={kw['n']} heights={kw['target_height']} steps={res.steps} "
          f"wall_s={wall:.3f} heights_per_s={kw['target_height'] / wall:.3f} "
          f"launches={launches}{qtext}{extra_line} digest={digest}", flush=True)
    return dict(sim=sim, res=res, wall=wall, launches=launches)


def phase_lockstep(ref: dict) -> None:
    """Lock-step delivery (``Simulation(burst=False)``, one message at a
    time) on BASELINE config 2's and config 3's networks: unsigned; signed
    with a ``HostVerifier`` a replica (``device="cpu"``); with a card
    ``TorchBatchVerifier`` a replica (the default); with ``QueueFlusher``
    replicas on one shared
    card verifier behind a ``DeviceWorkQueue`` (``devsched=``,
    ``flusher_for=``); with ``DeviceTallyFlusher`` replicas on one
    ``TorchWireVerifier`` with a ``ValidatorTable`` (rows 3 and 4 and a
    vote grid a replica); with execution (``sign_txs``, speculated on an
    injected queue, the blocks verified by the queue's exec launcher on its
    default card verifier) against the same run on the CPU. Records: the
    unsigned dumps against the JAX
    package's bytes, the config-2 queue leg and the n = 256 main path
    dumped, loaded and replayed on the card to the same commits; the main
    path with ``record=False`` against the default in turns. Each path is
    driven with the kernel counts set to 0 just before it and read just
    after. ``ref`` is the main path's host run."""
    import tempfile

    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.devsched import DeviceWorkQueue, QueueFlusher
    from hyperdrive_tpu_torch.exec import ExecutionConfig
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.ops.ed25519_wire import TorchWireVerifier, ValidatorTable
    from hyperdrive_tpu_torch.tallyflush import DeviceTallyFlusher
    from hyperdrive_tpu_torch.verifier import NullVerifier

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "hyperdrive_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="lockstep-", dir=build)
    packed = ("ed25519_verify",)
    want2 = (LOCK2_DIGEST, LOCK2_STEPS)
    try:
        # Config 2: unsigned, its dump against the JAX package's bytes.
        leg = _lockstep_leg("config2 unsigned", LOCK2, want2)
        _, sha, size, dump_s, load_s = _dump_check("config2 unsigned", leg["res"].record,
                                                   tmp, LOCK2_DUMP)
        print(f"lockstep config2 unsigned dump: bytes={size} sha256={sha} "
              f"dump_s={dump_s:.3f} load_s={load_s:.3f} equals_jax=True", flush=True)
        signed = dict(LOCK2, sign=True)
        leg = _lockstep_leg("config2 host", signed, want2, device="cpu")
        if not all(type(r.verifier).__name__ == "HostVerifier" for r in leg["sim"].replicas):
            raise AssertionError("lockstep config2 host: not a HostVerifier a replica")
        # The default on the card: a TorchBatchVerifier a replica, one
        # launch a flushed window.
        calls = []
        inner = TorchBatchVerifier.verify_signatures

        def counted(self, items):
            calls.append(len(items))
            return inner(self, items)

        TorchBatchVerifier.verify_signatures = counted
        try:
            leg = _lockstep_leg("config2 card per replica", signed, want2, packed)
        finally:
            TorchBatchVerifier.verify_signatures = inner
        mine = [r.verifier for r in leg["sim"].replicas]
        if (len({id(v) for v in mine}) != LOCK2["n"]
                or not all(type(v) is TorchBatchVerifier for v in mine)
                or leg["launches"] != {"ed25519_verify": len(calls)}):
            raise AssertionError(f"lockstep config2 card per replica: {leg['launches']} "
                                 f"for {len(calls)} verify calls")
        print(f"lockstep config2 card per replica: verifiers={len(mine)} "
              f"verify_calls={len(calls)} window_max={max(calls)}", flush=True)
        # One card verifier shared by every replica's QueueFlusher: the
        # queue coalesces their windows into one launch a drain.
        shared = TorchBatchVerifier(device="cuda")
        queue_rec = None
        for depth in (8, 64):
            q = DeviceWorkQueue(max_depth=depth)
            leg = _lockstep_leg(
                f"config2 queue depth={depth}", signed,
                (LOCK2_DIGEST, LOCK2_STEPS if depth == 8 else LOCK2_DEEP_STEPS), packed, q,
                warm=(shared,), devsched=q,
                flusher_for=lambda i, v, q=q: QueueFlusher(shared, q))
            if (q.launches != LOCK2_QUEUE_LAUNCHES[depth]
                    or leg["launches"]["ed25519_verify"] != q.launches):
                raise AssertionError(f"lockstep config2 queue depth={depth}: "
                                     f"{leg['launches']} for {q.launches} queue launches")
            if depth == 8:
                queue_rec = leg
        # Rows 3 and 4 and the vote grid: a DeviceTallyFlusher a replica on
        # one TorchWireVerifier with the ring's table, behind the queue.
        ring = KeyRing.deterministic(LOCK2["n"], namespace=b"sim-%d" % LOCK2["seed"])
        wire = TorchWireVerifier(device="cuda",
                                 table=ValidatorTable(ring.signatories, device="cuda"))
        q = DeviceWorkQueue(max_depth=8)
        leg = _lockstep_leg(
            "config2 tally queue depth=8", signed, want2,
            ("ed25519_challenge", "ed25519_semiwire"), q, devsched=q,
            flusher_for=lambda i, v: DeviceTallyFlusher(wire, v, queue=q))
        grid = sum(r.flusher.launches for r in leg["sim"].replicas)
        la = leg["launches"]
        if not (la["ed25519_challenge"] == la["ed25519_semiwire"] == q.launches and grid):
            raise AssertionError(f"lockstep config2 tally: {la}, {q.launches} queue "
                                 f"launches, {grid} grid calls")
        print(f"lockstep config2 tally queue depth=8: grid_calls={grid} "
              f"lanes_grouped={wire.stats['lanes_grouped']}", flush=True)

        # Execution under lock-step: sign_txs blocks applied at propose time
        # on an injected queue, their signatures verified by the queue's
        # exec launcher on its default card verifier (row 1); against the
        # same run on the CPU, where that launcher is a HostVerifier.
        def exec_run(dev):
            q, nv = DeviceWorkQueue(max_depth=8), NullVerifier()
            return q, dict(LOCK2, target_height=LOCK_EXEC_HEIGHTS, device=dev,
                           exec_speculate=True, execution=ExecutionConfig(**EXEC_LEG_B),
                           devsched=q, flusher_for=lambda i, v: QueueFlusher(nv, q))

        host = Simulation(**exec_run("cpu")[1]).run()
        host.assert_safety()
        if not host.completed:
            raise AssertionError("lockstep config2 exec: the CPU run did not complete")
        q, ekw = exec_run("cuda")
        leg = _lockstep_leg("config2 exec speculate", ekw,
                            (host.commit_digest()[:16], host.steps), packed, q)
        kind = type(leg["sim"]._exec_launcher.verifier)
        if kind is not TorchBatchVerifier or leg["res"].commits != host.commits:
            raise AssertionError(f"lockstep config2 exec: {kind.__name__}, commits "
                                 f"equal {leg['res'].commits == host.commits}")

        # Config 3: unsigned (its dump against the JAX bytes), then signed
        # on the shared card verifier behind a depth-64 queue. The signed
        # sequential host leg is left out: ~240,000 deliveries verified one
        # window at a time on the host (about 56 s on the JAX package).
        leg = _lockstep_leg("config3 unsigned", LOCK3, (LOCK3_DIGEST, LOCK3_STEPS))
        _, sha, size, dump_s, load_s = _dump_check("config3 unsigned", leg["res"].record,
                                                   tmp, LOCK3_DUMP)
        print(f"lockstep config3 unsigned dump: bytes={size} sha256={sha} "
              f"dump_s={dump_s:.3f} load_s={load_s:.3f} equals_jax=True", flush=True)
        q = DeviceWorkQueue(max_depth=64)
        leg = _lockstep_leg(
            "config3 queue depth=64", dict(LOCK3, sign=True),
            (LOCK3_DIGEST, LOCK3_DEEP_STEPS), packed, q, devsched=q,
            flusher_for=lambda i, v: QueueFlusher(shared, q))
        if leg["launches"]["ed25519_verify"] != q.launches:
            raise AssertionError(f"lockstep config3 queue: {leg['launches']} for "
                                 f"{q.launches} queue launches")

        # Replays on the card: the config-2 queue leg through the shared
        # card verifier a replica, the main path through the packed batch
        # verifier, each to the live run's commits.
        rec, sha, size, dump_s, load_s = _dump_check("config2 queue",
                                                     queue_rec["res"].record, tmp)
        ed25519_cuda.reset_stats()
        t0 = time.perf_counter()
        rep = Simulation.replay(rec, sign=True, verifier_for=lambda i: shared)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
        if rep.commits != queue_rec["res"].commits or set(launched) != set(packed):
            raise AssertionError(f"lockstep replay config2 queue: commits differ or "
                                 f"launched {launched}")
        print(f"lockstep replay config2 queue: deliveries={len(rec.messages)} bytes={size} "
              f"dump_s={dump_s:.3f} load_s={load_s:.3f} replay_s={wall:.3f} "
              f"launches={launched} same_commits=True", flush=True)
        bv = TorchBatchVerifier(device="cuda")
        bv.warmup()
        main_kw = dict(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True, burst=True,
                       dedup_verify=True, small_window_host=False, batch_verifier=bv)
        live = Simulation(**main_kw).run()
        if live.commit_digest(up_to=HEIGHT) != ref["digest"] or live.steps != MAIN_STEPS:
            raise AssertionError("lockstep replay main: the live run left the invariant")
        rec, sha, size, dump_s, load_s = _dump_check("main path", live.record, tmp)
        ed25519_cuda.reset_stats()
        t0 = time.perf_counter()
        rep = Simulation.replay(rec, sign=True, batch_verifier=bv, dedup_verify=True,
                                small_window_host=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
        if rep.commits != live.commits or set(launched) != set(packed):
            raise AssertionError(f"lockstep replay main: commits differ or launched "
                                 f"{launched}")
        print(f"lockstep replay main: n={N_VALIDATORS} deliveries={len(rec.messages)} "
              f"bursts={len(rec.bursts)} bytes={size} sha256={sha} dump_s={dump_s:.3f} "
              f"load_s={load_s:.3f} replay_s={wall:.3f} settles={rep.sim.settle_passes} "
              f"launches={launched} digest={rep.commit_digest(up_to=HEIGHT)[:16]} "
              f"same_commits=True", flush=True)
    finally:
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    # Recording is on by default, as in the reference: its cost on the
    # main path, in turns.
    phase_pairs(ref, legs=(("packed (recorded)", TorchBatchVerifier(device="cuda"), {}),
                           ("packed (record=False)", TorchBatchVerifier(device="cuda"),
                            dict(record=False))))


# ------------------------------------------- aggregation overlay, epochs

#: The overlay bench's network (``benches/overlay_bench.py``: seed 29, 2
#: heights, 1 ms a delivery). Every leg commits the all-to-all chain,
#: ``OVERLAY_DIGEST``, in the JAX package's steps on the same seeds; the
#: widest signed leg is cut from the bench's n = 4,096 to 1,024.
OVERLAY_NET = dict(seed=29, target_height=2, delivery_cost=1e-3)
OVERLAY_DIGEST = "ebccdb2654a1642c"
OVERLAY_BYZANTINE = dict(byzantine=(2, 9, 17), withhold_levels=(1,), garbage_rate=0.5)
#: What the JAX package's runs give a leg: steps, frames, garbage frames,
#: verify rows (= queue submissions = row-1 launches: the overlay drains
#: after every submit) and G1 merges (row-5 launches).
OVERLAY_LEGS = {
    "all-to-all n=256 unsigned": (240_896, None, None, None, None),
    "n=256 unsigned": (36_966, 33_412, 0, 0, 0),
    "n=256 signed": (35_495, 31_917, 0, 1_244, 0),
    "n=1024 signed coalesce": (181_184, 166_745, 0, 5_122, 0),
    "n=64 signed byzantine": (5_653, 4_993, 100, 259, 0),
    "n=16 signed bls_partials": (965, 878, 0, 67, 1_731),
}
#: The n = 16 unsigned overlay run's dump (JAX package): steps, SHA-256
#: prefix and bytes.
OVERLAY_DUMP = (993, "e80f5a9427fb46cf", 73_763)
#: Config 2's network with stake-driven epochs (the JAX run): 12 heights,
#: epochs of 4 with a committee of 12 and one rekey each; its digest,
#: steps and the committees of epochs 1-3.
EPOCH_EXEC = dict(n=16, target_height=12, seed=1002, timeout=20.0, delivery_cost=1e-3,
                  certificates=True)
EPOCH_EXEC_LEDGER = dict(accounts=4096, txs_per_block=1024, stake_every=4,
                         stake_accounts=16, seed=9)
EPOCH_EXEC_WANT = ("41427182d6b6241a", 6_256)
EPOCH_EXEC_COMMITTEES = (
    (1, 12, 10, 8, 6, 7, 0, 15, 3, 9, 4, 14),
    (1, 9, 0, 10, 3, 5, 7, 6, 15, 2, 13, 11),
    (1, 9, 5, 7, 6, 8, 10, 11, 2, 14, 4, 3),
)
#: BLS certificates in an epoch run (n = 8, seed 5, epochs of 3 with one
#: rekey, 9 heights; the JAX run's digest and steps).
EPOCH_BLS = dict(n=8, target_height=9, seed=5, certificates=True)
EPOCH_BLS_WANT = ("62c737c294b02dda", 1_200)


def _overlay_leg(label: str, n: int, want: tuple, **kw) -> dict:
    """One overlay (or all-to-all) run on the card: the kernel counts set
    to 0 just before it and read just after; digest, steps, frames, garbage
    frames, verify rows and launches held to the JAX run's; one line."""
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda, g1_cuda

    sim = Simulation(n=n, **OVERLAY_NET, **kw)
    launcher = sim._overlay._bls_launcher if sim._overlay is not None else None
    merged = []
    if launcher is not None:
        # Keep every merge launch's points and sums, to hold each sum
        # against the host fold after the run.
        inner = launcher.launch

        def recorded(payloads):
            sums = inner(payloads)
            merged.extend(zip([list(p) for p in payloads], sums))
            return sums

        launcher.launch = recorded
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    g1_cuda.reset_stats()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
    g1 = g1_cuda.stats["g1_aggregate"].launches
    res.assert_safety()
    digest = res.commit_digest()[:16]
    steps, frames, garbage, rows, merges = want
    if not res.completed or (digest, res.steps) != (OVERLAY_DIGEST, steps):
        raise AssertionError(f"overlay {label}: digest {digest} in {res.steps} steps, "
                             f"want {OVERLAY_DIGEST} in {steps}")
    snap = sim.overlay_snapshot() if sim._overlay is not None else None
    verify = launches.get("ed25519_verify", 0)
    text = ""
    if snap is not None:
        q = sim._sched
        got = (snap["frames"], snap["frames_garbage"], snap["verify_rows"], g1)
        if got != (frames, garbage, rows, merges):
            raise AssertionError(f"overlay {label}: frames, garbage, verify rows, merges "
                                 f"{got}, want {(frames, garbage, rows, merges)}")
        subs = q.submitted if q is not None else 0
        if (set(launches) - {"ed25519_verify"} or verify != rows
                or (q is not None and (q.launches != subs or q.coalesced))):
            raise AssertionError(f"overlay {label}: launched {launches}, queue "
                                 f"{subs} submitted / {q and q.launches} launches")
        if snap["bls_partial_rejects"]:
            raise AssertionError(f"overlay {label}: {snap['bls_partial_rejects']} partial "
                                 "aggregates rejected")
        if launcher is not None:
            from hyperdrive_tpu_torch.crypto import bls

            # Every g1_aggregate launch of the run against the host fold of
            # the same points (the plain version of the masked sum).
            bad = sum(s != bls.aggregate_signatures(p) for p, s in merged)
            if (bad or len(merged) != merges or launcher.launched != g1
                    or snap["bls_partials_attached"] != frames):
                raise AssertionError(f"overlay {label}: {bad} of {len(merged)} merges differ "
                                     f"from the host fold; launcher {launcher.launched}, "
                                     f"kernel {g1} launches, "
                                     f"{snap['bls_partials_attached']} frames with partials")
        text = (f" frames={snap['frames']} frames_garbage={snap['frames_garbage']} "
                f"frames_withheld={snap['frames_withheld']} verify_rows={snap['verify_rows']} "
                f"queue_submitted={subs} queue_launches={q.launches if q else 0} "
                f"bls_partials_attached={snap['bls_partials_attached']} "
                f"demoted={snap['scores']['demoted']} honest_demoted={snap['honest_demoted']} "
                f"bls_partial_rejects={snap['bls_partial_rejects']}")
        if merged:
            text += (f" merges_equal_host_fold={len(merged)} "
                     f"max_merge_width={max(len(p) for p, _ in merged)}")
    elif launches or g1:
        raise AssertionError(f"overlay {label}: launched {launches}, g1 {g1}")
    print(f"overlay {label}: n={n} heights={OVERLAY_NET['target_height']} steps={res.steps} "
          f"wall_s={wall:.3f} launches={{'ed25519_verify': {verify}, 'g1_aggregate': {g1}}}"
          f"{text} digest={digest}", flush=True)
    return dict(sim=sim, res=res, snap=snap, wall=wall)


def _rotated_flusher_leg(union: bool) -> dict:
    """A ``DeviceTallyFlusher(TorchWireVerifier(table=...), queue=q)`` that
    rotates to the next generation between its windows (one member
    rekeyed): two windows a generation, one drain. The queue splits the
    drain into one launch a generation; it never calls a verifier's
    ``set_generation``, so both launches verify against the table installed
    at the boundary. ``union``: that table keeps the retired key beside the
    new one (its votes stay valid below their stale height), and every
    window rides the challenge route, one ``ed25519_challenge`` and one
    ``ed25519_semiwire`` launch a generation. Without it the old
    generation's windows, which carry the retired key, take the full wire
    route (``ed25519_wire``). Each launch's verdicts equal ``HostVerifier``'s
    and the plain version's (the same verifier on the CPU)."""
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.devsched import DeviceWorkQueue
    from hyperdrive_tpu_torch.messages import Precommit, Prevote
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops.ed25519_wire import TorchWireVerifier, ValidatorTable
    from hyperdrive_tpu_torch.replica import Replica, ReplicaOptions
    from hyperdrive_tpu_torch.tallyflush import DeviceTallyFlusher
    from hyperdrive_tpu_torch.testutil import CommitterCallback, MockProposer, MockValidator
    from hyperdrive_tpu_torch.verifier import HostVerifier

    n = 16
    ring0 = KeyRing.deterministic(n, namespace=b"rotate-0")
    keys0 = [ring0[i] for i in range(n)]
    # The next generation rekeys one member, as EpochConfig(rekey_per_epoch=1).
    keys1 = list(keys0)
    keys1[5] = KeyRing.deterministic(1, namespace=b"rotate-1")[0]
    sigs0 = [kp.public for kp in keys0]
    sigs1 = [kp.public for kp in keys1]
    table1 = sigs1 + [sigs0[5]] if union else sigs1
    wire = TorchWireVerifier(device="cuda", table=ValidatorTable(sigs0, device="cuda"))
    q = DeviceWorkQueue()
    fl = DeviceTallyFlusher(wire, sigs0, queue=q)
    rep = Replica(ReplicaOptions(), whoami=sigs0[0], signatories=sigs0, timer=None,
                  proposer=MockProposer(fn=lambda h, r: bytes(32)),
                  validator=MockValidator(ok=True),
                  committer=CommitterCallback(on_commit=lambda h, v: (0, None)),
                  catcher=None, broadcaster=None, verifier=None, flusher=fl)
    value = hashlib.sha256(b"rotate").digest()
    calls = []
    inner = wire.verify_signatures

    def recorded(items):
        mask = inner(items)
        calls.append((list(items), [bool(b) for b in mask]))
        return mask

    wire.verify_signatures = recorded

    def window(keys, kind, round_, forged=()):
        # One flushed window: every member but the replica itself, one
        # signature zeroed.
        for i, kp in enumerate(keys[1:], start=1):
            msg = kp.sign_message(kind(height=1, round=round_, value=value,
                                       sender=kp.public))
            if i in forged:
                msg = msg.with_signature(bytes(64))
            getattr(rep.mq, f"insert_{kind.__name__.lower()}")(msg)
        fl.flush(rep)

    window(keys0, Prevote, 0, forged=(3,))
    window(keys0, Precommit, 0)
    # The epoch boundary: the wire verifier takes the next table (as
    # TcpNode.rotate_epoch installs it), the flusher the next committee.
    wire.install_table(ValidatorTable(table1, device="cuda"), 1)
    fl.rotate_validators(sigs1)
    window(keys1, Prevote, 1, forged=(7,))
    window(keys1, Precommit, 1)
    depth = q.depth
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    t0 = time.perf_counter()
    q.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
    wire.verify_signatures = inner
    want = ({"ed25519_challenge": 2, "ed25519_semiwire": 2} if union else
            {"ed25519_wire": 1, "ed25519_challenge": 1, "ed25519_semiwire": 1})
    label = "union table" if union else "next table only"
    if (depth, q.launches, q.coalesced, fl.generation) != (4, 2, 2, 1) or launches != want:
        raise AssertionError(f"generations rotated flusher {label}: depth {depth}, "
                             f"{q.launches} launches, {q.coalesced} coalesced, {launches}")
    plain = TorchWireVerifier(device="cpu", table=ValidatorTable(table1, device="cpu"))
    host = HostVerifier()
    for items, mask in calls:
        if (mask != [bool(b) for b in plain.verify_signatures(items)]
                or mask != [bool(b) for b in host.verify_signatures(items)]):
            raise AssertionError(f"generations rotated flusher {label}: verdicts differ "
                                 "from the plain version or the host's")
    rejected = sum(m.count(False) for _, m in calls)
    if rejected != 2 or fl.launches != 4:
        raise AssertionError(f"generations rotated flusher {label}: {rejected} rejected, "
                             f"{fl.launches} grid calls")
    print(f"generations rotated flusher {label}: n={n} windows={depth} generations=2 "
          f"queue_launches={q.launches} queue_coalesced={q.coalesced} launches={launches} "
          f"rows={[len(i) for i, _ in calls]} rejected={rejected} grid_calls={fl.launches} "
          f"drain_ms={wall * 1e3:.3f} verdicts_equal_plain=True", flush=True)
    return launches


def phase_overlay() -> None:
    """The aggregation overlay (``Simulation(overlay=OverlayConfig())``) on
    the overlay bench's network, and table generations on the device queue
    (epochs' device half). Overlay legs, each committing the all-to-all
    chain in the JAX run's steps: n = 256 unsigned beside its all-to-all
    run, n = 256 signed (one shared card ``TorchBatchVerifier`` behind the
    queue: an ``ed25519_verify`` launch a verify row), n = 1,024 signed
    with ``coalesce_ingest`` and ``record=False``, Byzantine contributors
    at n = 64 (garbage and withheld frames; only the Byzantine peer
    demoted), ``bls_partials`` at n = 16 (every merge a ``g1_aggregate``
    launch through the ``G1SumLauncher``), and the n = 16 unsigned dump
    against the JAX bytes, replayed without the overlay. Generation legs:
    a rotated ``DeviceTallyFlusher`` on a table ``TorchWireVerifier`` (one
    challenge + semiwire launch a generation); config 2's network with
    stake-driven epochs and a ``DeviceLedgerExecutor`` a replica on the
    card; BLS certificates in an epoch run with ``bls_certificates=
    "device"``. Each leg is driven with the counts set to 0 just before it
    and read just after."""
    import tempfile

    from hyperdrive_tpu_torch.epochs import EpochConfig
    from hyperdrive_tpu_torch.exec import ExecutionConfig
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda, g1_cuda
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.overlay import OverlayConfig, OverlayFaults

    TorchBatchVerifier(device="cuda").warmup()
    legs = OVERLAY_LEGS
    base = _overlay_leg("all-to-all n=256 unsigned", 256,
                        legs["all-to-all n=256 unsigned"])
    leg = _overlay_leg("n=256 unsigned", 256, legs["n=256 unsigned"], overlay=OverlayConfig())
    print(f"overlay n=256 steps: all_to_all={base['res'].steps} "
          f"overlay={leg['res'].steps} ratio={base['res'].steps / leg['res'].steps:.3f} "
          f"wall_ratio={base['wall'] / leg['wall']:.3f}", flush=True)
    leg = _overlay_leg("n=256 signed", 256, legs["n=256 signed"],
                       sign=True, overlay=OverlayConfig())
    if type(leg["sim"]._overlay._verifier) is not TorchBatchVerifier:
        raise AssertionError("overlay n=256 signed: not the card verifier")
    _overlay_leg("n=1024 signed coalesce", 1024,
                 legs["n=1024 signed coalesce"], sign=True, record=False,
                 overlay=OverlayConfig(coalesce_ingest=True))
    leg = _overlay_leg("n=64 signed byzantine", 64,
                       legs["n=64 signed byzantine"], sign=True,
                       overlay=OverlayConfig(faults=OverlayFaults(**OVERLAY_BYZANTINE)))
    if leg["snap"]["scores"]["demoted"] != [2] or leg["snap"]["honest_demoted"]:
        raise AssertionError(f"overlay byzantine: demoted {leg['snap']['scores']['demoted']}")
    _overlay_leg("n=16 signed bls_partials", 16, legs["n=16 signed bls_partials"],
                 sign=True, overlay=OverlayConfig(bls_partials=True))
    # The n = 16 unsigned dump: the JAX package's bytes, replayed with no
    # overlay wiring to the same commits.
    steps, sha_want, size_want = OVERLAY_DUMP
    live = Simulation(n=16, overlay=OverlayConfig(), device="cuda", **OVERLAY_NET).run()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "hyperdrive_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="overlay-", dir=build)
    try:
        rec, sha, size, dump_s, load_s = _dump_check("overlay n=16", live.record, tmp,
                                                     (sha_want, size_want))
    finally:
        os.rmdir(tmp)
    again = Simulation.replay(rec, device="cuda")
    if live.steps != steps or again.commits != live.commits:
        raise AssertionError("overlay n=16 dump: steps or replayed commits differ")
    print(f"overlay n=16 unsigned dump: steps={live.steps} bytes={size} sha256={sha} "
          f"dump_s={dump_s:.3f} load_s={load_s:.3f} equals_jax=True "
          f"replayed_without_overlay=True", flush=True)

    _rotated_flusher_leg(union=True)
    _rotated_flusher_leg(union=False)
    # Stake-driven epochs: a DeviceLedgerExecutor a replica on the card,
    # the elections read by the host stake oracle.
    sim = Simulation(**EPOCH_EXEC, device="cuda",
                     execution=ExecutionConfig(device=True, **EPOCH_EXEC_LEDGER),
                     epochs=EpochConfig(epoch_length=4, committee_size=12,
                                        rekey_per_epoch=1))
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    g1_cuda.reset_stats()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # An unsigned run without BLS certificates: no kernel of rows 1-5.
    launches = {k: v.launches for k, v in ed25519_cuda.stats.items()}
    launches["g1_aggregate"] = g1_cuda.stats["g1_aggregate"].launches
    committees = [tuple(v.index for v in sim.epoch_schedule.transition(e).committee)
                  for e in range(1, sim.epoch + 1)]
    ex = sim.executors[0]
    if ((res.commit_digest()[:16], res.steps) != EPOCH_EXEC_WANT or sim.epoch != 3
            or tuple(committees) != EPOCH_EXEC_COMMITTEES
            or type(ex).__name__ != "DeviceLedgerExecutor" or ex.device.type != "cuda"
            or type(sim._exec_oracle).__name__ != "HostLedgerExecutor"
            or any(launches.values())):
        raise AssertionError(f"generations stake epochs: {res.commit_digest()[:16]} in "
                             f"{res.steps} steps, epoch {sim.epoch}, {committees}, "
                             f"launches {launches}")
    print(f"generations stake epochs: n={EPOCH_EXEC['n']} heights={EPOCH_EXEC['target_height']} "
          f"steps={res.steps} wall_s={wall:.3f} epoch={sim.epoch} executor=cuda "
          f"launches={launches} committees={committees} digest={res.commit_digest()[:16]}",
          flush=True)
    # BLS certificates in an epoch run, aggregated by g1_aggregate: one
    # launch a replica a height, and every replica's certificate chain
    # equal to the host fold's run of the same configuration.
    epochs = dict(epoch_length=3, rekey_per_epoch=1)
    sim = Simulation(**EPOCH_BLS, bls_certificates="device", device="cuda",
                     epochs=EpochConfig(**epochs))
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    g1_cuda.reset_stats()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    g1 = g1_cuda.stats["g1_aggregate"].launches
    verify = sum(v.launches for v in ed25519_cuda.stats.values())
    certs = [len(c.certs) for c in sim.certifiers]
    host = Simulation(**EPOCH_BLS, bls_certificates=True, device="cuda",
                      epochs=EpochConfig(**epochs)).run()
    if ((res.commit_digest()[:16], res.steps) != EPOCH_BLS_WANT or sim.epoch != 3
            or set(certs) != {EPOCH_BLS["target_height"]}
            or g1 != EPOCH_BLS["n"] * EPOCH_BLS["target_height"] or verify
            or g1_cuda.stats["g1_aggregate"].launches != g1  # none in the host run
            or res.cert_digests != host.cert_digests
            or host.commit_digest() != res.commit_digest()):
        raise AssertionError(f"generations bls epochs: {res.commit_digest()[:16]} in "
                             f"{res.steps} steps, epoch {sim.epoch}, certs {certs}, "
                             f"{g1} g1_aggregate and {verify} ed25519 launches, "
                             f"chains equal the host fold's: "
                             f"{res.cert_digests == host.cert_digests}")
    print(f"generations bls epochs: n={EPOCH_BLS['n']} heights={EPOCH_BLS['target_height']} "
          f"steps={res.steps} wall_s={wall:.3f} epoch={sim.epoch} certs_per_replica="
          f"{certs[0]} launches={{'g1_aggregate': {g1}, 'ed25519': {verify}}} "
          f"cert_chains_equal_host_fold=True digest={res.commit_digest()[:16]}", flush=True)


# ------------------------------------------- chaos, open-loop load

#: The chaos network: config 2's (``LOCK2``: n = 16, seed 1002, 1 ms a
#: delivery), signed, with the chaos tests' and the soak's 1 s timeouts,
#: under ``FaultPlan.seeded(1002, 16)`` (a partition of replicas 2, 3, 12,
#: 13 and 14 from 0.366 to 1.620 virtual seconds, replica 12 crashed at
#: step 568 and restored 247 steps later, three link faults). What the
#: JAX package's runs give, with ``QueueFlusher`` replicas on one
#: ``HostVerifier`` behind ``DeviceWorkQueue(max_depth=8)`` and an
#: ``InvariantMonitor`` armed: commit digest and steps, the queue's
#: submitted / launches / coalesced, the lifecycle of the record and its
#: dump's SHA-256 prefix and bytes.
CHAOS_NET = dict(n=16, seed=1002, timeout=1.0, delivery_cost=1e-3, sign=True)
CHAOS_HEIGHTS = 20
CHAOS_A = dict(want=("9f217d6e5981ef8d", 11_544), queue=(9_839, 1_237, 8_602),
               lifecycle=[(0, 492, 12, 0), (1, 664, 12, 2), (2, 680, 2, 2), (2, 680, 3, 2),
                          (2, 680, 13, 2), (2, 680, 14, 2)],
               dump=("090056a27f703cff", 1_734_452))
#: The same plan with the crash moved to step 254 and the restore one step
#: later: the first step at or above 250 (the family's lowest crash step)
#: at which the JAX run cancels a window in flight. No plan of the seeded
#: family cancels one: a restore comes at least 200 steps after its
#: crash, and every drain in between resolves the dead replica's windows.
CHAOS_CANCEL = dict(crash_at_step=254, restart_after_steps=1)
CHAOS_CANCEL_WANT = dict(want=("9f217d6e5981ef8d", 11_546), queue=(9_839, 1_237, 8_601),
                         cancelled=1)
#: The tally leg, cut to 8 heights (past the restore at height 2): the JAX
#: run's digest and steps and its queue launches.
CHAOS_TALLY_HEIGHTS = 8
CHAOS_B = dict(want=("9087b1e5729b3053", 5_208), launches=565)
#: ``FaultPlan.overload(1002, 16)`` (leg A's plan with
#: ``LoadProfile.seeded(1002)``, pinned at SHED_DUPLICATES): the JAX run's
#: overload snapshot and queue counts; with ``pin=False`` (the controller
#: watching the queue) the same.
CHAOS_D = dict(queue=(12_975, 1_629, 11_346), rows=12_975,
               snapshot={"injected": 59_008, "injected_sheddable": 51_008,
                         "offered": 63_983, "admitted": 12_975,
                         "shed": {"duplicate": 51_008}, "level": 1, "transitions": 1})


def _chaos_leg(label: str, plan, want: tuple, own: tuple, queue, heights: int = CHAOS_HEIGHTS,
               load=None, **sim_kw) -> dict:
    """One chaos run on the card with an ``InvariantMonitor`` armed: the
    kernel counts set to 0 just before it and read just after; digest and
    steps held to the JAX run's, ``check_final``, at least one crash,
    restore and heal, each kernel of ``own`` launched and no other, the
    queue coalesced and empty at the end."""
    from hyperdrive_tpu_torch.chaos import InvariantMonitor
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    sim = Simulation(**CHAOS_NET, target_height=heights, chaos=plan, load=load,
                     devsched=queue, **sim_kw)
    mon = InvariantMonitor(sim)
    for r in sim.replicas:
        f = r.flusher
        if f is not None and hasattr(f, "warmup"):
            f.warmup()
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
    mon.check_final(res)
    digest = res.commit_digest()[:16]
    if (digest, res.steps) != want:
        raise AssertionError(f"chaos {label}: digest {digest} in {res.steps} steps, "
                             f"want {want[0]} in {want[1]}")
    if not (mon.crashes and mon.restores and mon.heals):
        raise AssertionError(f"chaos {label}: crashes {mon.crashes}, restores "
                             f"{mon.restores}, heals {mon.heals}")
    if set(launches) != set(own) or not all(launches.values()):
        raise AssertionError(f"chaos {label}: launched {launches}, want {own}")
    if queue.depth or not queue.launches < queue.submitted:
        raise AssertionError(f"chaos {label}: queue depth {queue.depth}, "
                             f"{queue.launches} launches for {queue.submitted} submitted")
    return dict(sim=sim, res=res, mon=mon, wall=wall, launches=launches)


def phase_chaos() -> None:
    """Chaos and open-loop load on the card (``phase_chaos``, lines
    ``chaos``), config 2's signed network under ``FaultPlan.seeded(1002,
    16)``, every leg on the JAX run's digest and steps:

    - A, ``chaos queue``: ``QueueFlusher`` replicas on one shared card
      ``TorchBatchVerifier`` behind ``DeviceWorkQueue(max_depth=8)``;
      ``ed25519_verify`` the only kernel, the JAX run's queue counts,
      lifecycle and dump bytes. Then ``chaos cancel``, the same with the
      crash restored one step later: the restore cancels the dead
      incarnation's window in flight, and the cancelled command is never
      launched (submitted = launched + cancelled);
    - B, ``chaos tally``: ``DeviceTallyFlusher`` replicas on one
      ``TorchWireVerifier`` with the ring's ``ValidatorTable`` behind the
      queue (rows 3 and 4 and a vote grid a replica), 8 heights; the
      victim's flusher drops its height claim at the restore, and its
      grid-plane resets after it are counted;
    - C, ``chaos replay``: leg A's record (with ``OP_CRASH`` and
      ``OP_RESTORE``) dumped, loaded and replayed on the shared card
      verifier a replica, to leg A's commits;
    - D, ``overload``: ``FaultPlan.overload(1002, 16)``, leg A's plan with a
      pinned ``LoadProfile``: leg A's digest and steps, the JAX run's
      overload snapshot (``offered == admitted + shed``, shed classes
      within ``SHED_CLASSES``), row-1 launches and verified rows beside
      leg A's;
    - E, ``escalation``: D with ``pin=False``, the controller watching the
      card queue: the JAX run's level and transitions."""
    import tempfile

    from hyperdrive_tpu_torch.chaos import FaultPlan
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.devsched import DeviceWorkQueue, QueueFlusher
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.load.backpressure import SHED_CLASSES
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.ops.ed25519_wire import TorchWireVerifier, ValidatorTable
    from hyperdrive_tpu_torch.tallyflush import DeviceTallyFlusher

    packed = ("ed25519_verify",)
    plan = FaultPlan.seeded(CHAOS_NET["seed"], CHAOS_NET["n"])
    shared = TorchBatchVerifier(device="cuda")
    shared.warmup()
    rows = [0]
    inner = shared.verify_signatures

    def counted(items):
        rows[0] += len(items)
        return inner(items)

    shared.verify_signatures = counted

    def queued(label, plan, want, queue_want, load=None):
        q = DeviceWorkQueue(max_depth=8)
        flushers = []

        def make(i, v):
            flushers.append(QueueFlusher(shared, q))
            return flushers[-1]

        rows[0] = 0
        leg = _chaos_leg(label, plan, want, packed, q, load=load, flusher_for=make)
        cancelled = sum(f.cancelled for f in flushers)
        if ((q.submitted, q.launches, q.coalesced) != queue_want
                or leg["launches"]["ed25519_verify"] != q.launches
                or q.submitted != q.launches + q.coalesced + cancelled):
            raise AssertionError(f"chaos {label}: queue {q.submitted}/{q.launches}/"
                                 f"{q.coalesced} cancelled {cancelled}, launched "
                                 f"{leg['launches']}, want {queue_want}")
        leg.update(q=q, cancelled=cancelled, rows=rows[0])
        return leg

    def line(label, leg, extra=""):
        q, mon = leg["q"], leg["mon"]
        print(f"chaos {label}: n={CHAOS_NET['n']} heights={leg['sim'].target_height} "
              f"steps={leg['res'].steps} wall_s={leg['wall']:.3f} "
              f"launches={leg['launches']} queue_submitted={q.submitted} "
              f"queue_launches={q.launches} queue_coalesced={q.coalesced} "
              f"cancelled={leg['cancelled']} crashes={len(mon.crashes)} "
              f"restores={len(mon.restores)} heals={len(mon.heals)}{extra} "
              f"digest={leg['res'].commit_digest()[:16]}", flush=True)

    # A: the seeded plan, then the same with the restore one step after the
    # crash, which lands while the victim's window is in flight.
    leg_a = queued("queue", plan, CHAOS_A["want"], CHAOS_A["queue"])
    record = leg_a["res"].record
    if record.lifecycle != CHAOS_A["lifecycle"]:
        raise AssertionError(f"chaos queue: lifecycle {record.lifecycle}")
    line("queue", leg_a, f" rows={leg_a['rows']}")
    crash = dataclasses.replace(plan.crashes[0], **CHAOS_CANCEL)
    leg = queued("cancel", dataclasses.replace(plan, crashes=(crash,)),
                 CHAOS_CANCEL_WANT["want"], CHAOS_CANCEL_WANT["queue"])
    if leg["cancelled"] != CHAOS_CANCEL_WANT["cancelled"]:
        raise AssertionError(f"chaos cancel: {leg['cancelled']} windows cancelled")
    line("cancel", leg, f" rows={leg['rows']} launched_commands="
         f"{leg['q'].launches + leg['q'].coalesced}")

    # B: rows 3 and 4 and a vote grid a replica behind the queue.
    ring = KeyRing.deterministic(CHAOS_NET["n"], namespace=b"sim-%d" % CHAOS_NET["seed"])
    wire = TorchWireVerifier(device="cuda",
                             table=ValidatorTable(ring.signatories, device="cuda"))
    q = DeviceWorkQueue(max_depth=8)
    victim = plan.crashes[0].replica
    at_restore = {}

    def make_tally(i, v):
        f = DeviceTallyFlusher(wire, v, queue=q)
        if i == victim:
            reset = f.reset

            def noted(replica=None):
                reset(replica)
                at_restore.update(resets=f.plane_resets, claim=f._height)

            f.reset = noted
        return f

    leg = _chaos_leg("tally", plan, CHAOS_B["want"], ("ed25519_challenge", "ed25519_semiwire"),
                     q, heights=CHAOS_TALLY_HEIGHTS, flusher_for=make_tally)
    la = leg["launches"]
    vf = leg["sim"].replicas[victim].flusher
    after = vf.plane_resets - at_restore.get("resets", vf.plane_resets)
    if not (la["ed25519_challenge"] == la["ed25519_semiwire"] == q.launches
            == CHAOS_B["launches"]) or at_restore.get("claim", 0) is not None or after < 1:
        raise AssertionError(f"chaos tally: launched {la} for {q.launches} queue launches, "
                             f"victim claim at restore {at_restore}, resets after {after}")
    leg.update(q=q, cancelled=sum(r.flusher.cancelled for r in leg["sim"].replicas))
    line("tally", leg, f" grid_calls={sum(r.flusher.launches for r in leg['sim'].replicas)} "
         f"victim={victim} victim_plane_resets_after_restore={after}")

    # C: leg A's record dumped, loaded and replayed on the card.
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "hyperdrive_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chaos-", dir=build)
    try:
        rec, sha, size, dump_s, load_s = _dump_check("chaos queue", record, tmp,
                                                     CHAOS_A["dump"])
    finally:
        os.rmdir(tmp)
    ed25519_cuda.reset_stats()
    t0 = time.perf_counter()
    rep = Simulation.replay(rec, sign=True, verifier_for=lambda i: shared)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
    if rep.commits != leg_a["res"].commits or set(launched) != set(packed):
        raise AssertionError(f"chaos replay: commits differ or launched {launched}")
    print(f"chaos replay: deliveries={len(rec.messages)} lifecycle={len(rec.lifecycle)} "
          f"bytes={size} sha256={sha} equals_jax=True dump_s={dump_s:.3f} "
          f"load_s={load_s:.3f} replay_s={wall:.3f} launches={launched} "
          f"same_commits=True", flush=True)

    # D and E: open-loop load on leg A's plan, pinned, then escalating.
    plan_d, profile = FaultPlan.overload(CHAOS_NET["seed"], CHAOS_NET["n"])
    if plan_d != plan:
        raise AssertionError("overload: the family's plan is not leg A's")
    for label, prof in (("overload", profile),
                        ("escalation", dataclasses.replace(profile, pin=False))):
        leg = queued(label, plan_d, CHAOS_A["want"], CHAOS_D["queue"], load=prof)
        snap = leg["sim"].overload_snapshot()
        ctrl = leg["sim"].load_controller
        watched = leg["q"].controller is ctrl
        if (snap != CHAOS_D["snapshot"] or leg["rows"] != CHAOS_D["rows"]
                or snap["offered"] != snap["admitted"] + sum(snap["shed"].values())
                or not set(snap["shed"]) <= set(SHED_CLASSES)
                or not snap["injected"] or watched != (not prof.pin)):
            raise AssertionError(f"chaos {label}: snapshot {snap}, rows {leg['rows']}, "
                                 f"controller watching the queue {watched}")
        line(label, leg, f" rows={leg['rows']} rows_leg_a={leg_a['rows']} "
             f"launches_leg_a={leg_a['launches']['ed25519_verify']} pin={prof.pin} "
             f"watched={watched} injected={snap['injected']} offered={snap['offered']} "
             f"admitted={snap['admitted']} shed={snap['shed']} level={snap['level']} "
             f"transitions={snap['transitions']}")


#: ``CampaignConfig()`` (1,024 validators, committee 64, 8 epochs x 4
#: heights, seed 0): each family's digest prefix and verify calls, the
#: JAX package's run on the CPU (its ``HostVerifier``).
CAMPAIGN_A = {
    "storm": dict(digest="c664eb809469ffb3", rows=[352, 96, 96, 96, 96, 96]),
    "capture": dict(digest="958189e10b1d775a", rows=[]),
    "coincidence": dict(digest="6caa95725a68985c", calls=8, total=1_084, widest=282),
}
#: The storm at the campaign bench's shape (``benches/campaign_bench.py``:
#: committee 32, 8 attackers, 120 waves, 2 votes, attack rate 8), with the
#: reputation loop on and off: digest, verify calls, rows verified and
#: failed, demotions (the JAX run on the CPU).
CAMPAIGN_B = {
    True: dict(digest="13fe190186500e8c", calls=120, rows=6_144, failed=384, demotions=24),
    False: dict(digest="a020be739b407aac", calls=120, rows=21_120, failed=15_360,
                demotions=0),
}
CAMPAIGN_BENCH = dict(committee_size=32, attackers=8, waves=120, wave_votes=2, attack_rate=8)


class _TimedVerifier:
    """A card verifier seen from outside: the rows and host seconds of
    each ``verify_signatures`` call (the mask comes back on the host, so
    the call ends synchronised), and the items and mask of the first call
    that both accepts and rejects rows. Every other attribute is the inner
    verifier's."""

    def __init__(self, inner):
        self.inner = inner
        self.rows: list = []
        self.seconds = 0.0
        self.sample = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def verify_signatures(self, items):
        t0 = time.perf_counter()
        mask = self.inner.verify_signatures(items)
        self.seconds += time.perf_counter() - t0
        self.rows.append(len(items))
        if self.sample is None and mask.any() and not mask.all():
            self.sample = (list(items), np.asarray(mask).copy())
        return mask


def _plain_mask_check(label: str, verifier) -> int:
    """The sampled call's card mask against the plain version's
    (``verify_plain`` on the same packed rows, on the card) and the host
    verifier's; returns the rows compared. The plain run counts no
    launch."""
    from hyperdrive_tpu_torch.ops import ed25519 as ted
    from hyperdrive_tpu_torch.verifier import HostVerifier

    if verifier.sample is None:
        raise AssertionError(f"{label}: no call both accepted and rejected rows")
    items, mask = verifier.sample
    arrays, prevalid, n = verifier.inner.host.pack(items)
    plain = ted.verify_plain(*(torch.from_numpy(a).to("cuda") for a in arrays)).cpu().numpy()
    plain = (plain & prevalid)[:n]
    host = np.asarray(HostVerifier().verify_signatures(items), dtype=bool)
    if not (np.array_equal(mask, plain) and np.array_equal(mask, host)):
        raise AssertionError(f"{label}: card mask differs from the plain version's "
                             f"or the host's on a {n}-row wave")
    return n


def phase_campaign() -> None:
    """Attack campaigns on the card (``phase_campaign``, lines
    ``campaign``): the storm and coincidence families batch-verify through
    ``TorchBatchVerifier`` (``ed25519_verify``, one launch a wave).

    - A, ``campaign defaults``: the three families at ``CampaignConfig()``
      through ``run_campaign`` on the card verifier: the JAX run's digest, no
      violation, launches equal to verify calls and their rows (storm
      352 + 5 x 96, capture none, coincidence 1,084 over 8 calls); then
      ``replay_campaign(record, device="cuda")`` of each record (its own
      card verifier) to the same digest;
    - B, ``campaign storm``: the campaign bench's storm shape, reputation
      on and off: digests, 120 launches, rows verified and failed,
      demotions, wall and verify share;
    - in every storm leg one wave's card mask against the plain version's
      and the host's."""
    from hyperdrive_tpu_torch.campaign import CampaignConfig
    from hyperdrive_tpu_torch.campaign.runner import replay_campaign, run_campaign
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

    card = TorchBatchVerifier(device="cuda")
    card.warmup()
    torch.cuda.synchronize()

    def leg(cfg, timed):
        ed25519_cuda.reset_stats()
        t0 = time.perf_counter()
        out = run_campaign(cfg, verifier=timed)
        wall = time.perf_counter() - t0
        launched = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
        if not out.ok:
            raise AssertionError(f"campaign {cfg.family}: violations {out.violations}")
        if launched.get("ed25519_verify", 0) != len(timed.rows) or set(launched) - {
                "ed25519_verify"}:
            raise AssertionError(f"campaign {cfg.family}: launched {launched} for "
                                 f"{len(timed.rows)} verify calls")
        return out, wall

    for family, want in CAMPAIGN_A.items():
        cfg = CampaignConfig(family=family)
        timed = _TimedVerifier(card)
        out, wall = leg(cfg, timed)
        digest = out.digest.hex()[:16]
        rows = timed.rows
        if "rows" in want:
            ok = rows == want["rows"]
        else:
            ok = (len(rows), sum(rows), max(rows)) == (want["calls"], want["total"],
                                                      want["widest"])
        if digest != want["digest"] or not ok:
            raise AssertionError(f"campaign {family}: digest {digest}, verify rows {rows}, "
                                 f"want {want}")
        compared = _plain_mask_check(f"campaign {family}", timed) if family == "storm" else 0
        ed25519_cuda.reset_stats()
        t0 = time.perf_counter()
        same, fresh = replay_campaign(out.record, device="cuda")
        replay_s = time.perf_counter() - t0
        if not same or ed25519_cuda.stats["ed25519_verify"].launches != len(rows):
            raise AssertionError(f"campaign {family}: replay digest {fresh.digest.hex()[:16]}, "
                                 f"{ed25519_cuda.stats['ed25519_verify'].launches} launches")
        print(f"campaign defaults {family}: digest={digest} violations=0 "
              f"launches={len(rows)} rows={sum(rows)} widest={max(rows, default=0)} "
              f"wall_s={wall:.3f} verify_s={timed.seconds:.3f} replay_s={replay_s:.3f} "
              f"replay_digest_equal=True mask_rows_vs_plain={compared}", flush=True)

    for reputation, want in CAMPAIGN_B.items():
        cfg = CampaignConfig(reputation=reputation, **CAMPAIGN_BENCH)
        timed = _TimedVerifier(card)
        out, wall = leg(cfg, timed)
        waves = out.summary["waves"]
        got = dict(digest=out.digest.hex()[:16], calls=len(timed.rows),
                   rows=sum(w["verified_rows"] for w in waves),
                   failed=sum(w["failed_rows"] for w in waves),
                   demotions=out.summary["gate"]["demotions"])
        if got != want or got["rows"] != sum(timed.rows):
            raise AssertionError(f"campaign storm reputation={reputation}: {got}, "
                                 f"want {want}")
        compared = _plain_mask_check(f"campaign storm reputation={reputation}", timed)
        print(f"campaign storm reputation={reputation}: digest={got['digest']} "
              f"launches={got['calls']} rows={got['rows']} failed={got['failed']} "
              f"demotions={got['demotions']} wall_s={wall:.3f} verify_s={timed.seconds:.3f} "
              f"verify_share={timed.seconds / wall:.4f} mask_rows_vs_plain={compared}",
              flush=True)


#: ``benches/multitenant_bench.py``'s shapes: 16-validator tenants at
#: M = 1..16 (a warm-up wave, then 4 heights), and the fairness leg's
#: firehose (48 validators) and victim (4 validators, 10 heights) under
#: FIFO and ``DeficitRoundRobin``, 3 repetitions.
SERVICE_M = (1, 2, 4, 8, 16)
SERVICE_VALIDATORS = 16
SERVICE_HEIGHTS = 4
SERVICE_DRR = dict(capacity_rows=16, quantum_rows=4, starve_after=3)
SERVICE_FAIR = dict(fire=48, victim=4, heights=10, reps=3)


def _waves(services, tenants, heights: int) -> float:
    """Lock-step waves, the bench's drive: every tenant submits one
    window, then every service drains once. Wall seconds."""
    t0 = time.perf_counter()
    for _ in range(heights):
        for t in tenants:
            t.pump(max_inflight=1)
        for svc in services:
            svc.drain()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _p99(xs) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(0.99 * len(xs)))]


def phase_service() -> None:
    """The multi-tenant verify service on the card (``phase_service``,
    lines ``service``): tenants share one card ``TorchBatchVerifier``
    behind one ``DeviceWorkQueue``, every drain one ``ed25519_verify``
    launch.

    - A, ``service M=``: the multi-tenant bench's series, one shared
      service against M dedicated services on the same verifier object:
      every tenant's digest equal across the two and to a ``HostVerifier``
      run, 5 launches shared (16 M rows each) and 5 M dedicated; walls,
      votes/s and their ratio;
    - B, ``service fairness``: the firehose and the victim under FIFO and
      ``DeficitRoundRobin``: the starvation bound held
      (``InvariantMonitor.check_tenant_fairness``), the victim's p99;
    - C, ``service remote``: a ``ServicePort`` on 127.0.0.1 and an
      in-process ``RemoteServiceClient`` tenant beside three local ones,
      the controller pinned at CRITICAL_ONLY until the first busy answer:
      the remote digest equal to its local run, fewer launches than
      submissions, every certificate verified, the shed window resubmitted;
    - D, ``service exec``: an execution-attached remote tenant's roots
      equal to the host executor's, a proof query verified against the
      certified root; a local one rotated to generation 1 mid-serve
      (``set_generation`` on the card verifier), roots and digest equal to
      the rotation-free run."""
    import threading

    from hyperdrive_tpu_torch.chaos import InvariantMonitor
    from hyperdrive_tpu_torch.devsched import DeficitRoundRobin
    from hyperdrive_tpu_torch.exec import ExecutionConfig
    from hyperdrive_tpu_torch.exec.ledger import HostLedgerExecutor
    from hyperdrive_tpu_torch.load.backpressure import CRITICAL_ONLY, BackpressureController
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.parallel.service import (
        STATUS_COMMITTED,
        RemoteServiceClient,
        ShardVerifyService,
        TenantShard,
    )
    from hyperdrive_tpu_torch.verifier import HostVerifier

    card = TorchBatchVerifier(device="cuda")
    card.warmup()
    torch.cuda.synchronize()

    def launches():
        got = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
        if set(got) - {"ed25519_verify"}:
            raise AssertionError(f"service: launched {got}")
        return got.get("ed25519_verify", 0)

    def tenants(svcs, m, heights, prefix="tenant"):
        return [TenantShard(f"{prefix}-{i}", n_validators=SERVICE_VALIDATORS,
                            target_height=heights).attach_local(svcs[i % len(svcs)])
                for i in range(m)]

    # A: shared against dedicated, both on the one card verifier.
    total = {"shared": 0, "dedicated": 0}
    for m in SERVICE_M:
        heights = SERVICE_HEIGHTS + 1
        host_svc = ShardVerifyService(HostVerifier(), max_depth=0)
        host = tenants([host_svc], m, heights)
        _waves([host_svc], host, heights)
        legs = {}
        for label in ("shared", "dedicated"):
            timed = _TimedVerifier(card)
            svcs = [ShardVerifyService(timed, max_depth=0)
                    for _ in range(1 if label == "shared" else m)]
            ts = tenants(svcs, m, heights)
            ed25519_cuda.reset_stats()
            _waves(svcs, ts, 1)
            wall = _waves(svcs, ts, SERVICE_HEIGHTS)
            n = launches()
            if not all(t.done and not t.rejected for t in ts) or [
                    t.commit_digest() for t in ts] != [t.commit_digest() for t in host]:
                raise AssertionError(f"service M={m} {label}: digests differ from the "
                                     f"host run's or a tenant did not commit")
            want_n = heights if label == "shared" else heights * m
            rows_ok = (label != "shared"
                       or timed.rows == [SERVICE_VALIDATORS * m] * heights)
            if n != want_n or len(timed.rows) != n or not rows_ok:
                raise AssertionError(f"service M={m} {label}: {n} launches, rows "
                                     f"{timed.rows}, want {want_n}")
            total[label] += n
            legs[label] = (wall, n, timed.seconds)
        votes = m * SERVICE_HEIGHTS * SERVICE_VALIDATORS
        (sw, sn, sv), (dw, dn, dv) = legs["shared"], legs["dedicated"]
        print(f"service M={m}: validators={SERVICE_VALIDATORS} heights={SERVICE_HEIGHTS} "
              f"shared_wall_s={sw:.4f} dedicated_wall_s={dw:.4f} "
              f"shared_votes_per_s={votes / sw:.1f} dedicated_votes_per_s={votes / dw:.1f} "
              f"dedicated_over_shared={dw / sw:.4f} shared_launches={sn} "
              f"dedicated_launches={dn} shared_rows_per_launch={SERVICE_VALIDATORS * m} "
              f"digests_equal_host=True", flush=True)
    if total != {"shared": 5 * len(SERVICE_M), "dedicated": 5 * sum(SERVICE_M)}:
        raise AssertionError(f"service: launches over the series {total}")

    # B: fairness, FIFO against DRR, on the card.
    fair = SERVICE_FAIR
    p99 = {"fifo": [], "drr": []}
    for rep in range(fair["reps"]):
        for label in ("fifo", "drr"):
            policy = DeficitRoundRobin(**SERVICE_DRR) if label == "drr" else None
            svc = ShardVerifyService(card, max_depth=0, policy=policy)
            fire = TenantShard("firehose", n_validators=fair["fire"],
                               target_height=fair["heights"] * 2).attach_local(svc)
            victim = TenantShard("victim", n_validators=fair["victim"],
                                 target_height=fair["heights"]).attach_local(svc)
            ed25519_cuda.reset_stats()
            for _ in range(100 * fair["heights"]):
                if victim.done:
                    break
                fire.pump(max_inflight=4)
                victim.pump(max_inflight=1)
                svc.drain()
            n = launches()
            if not victim.done or victim.rejected or fire.rejected or n != svc.queue.launches:
                raise AssertionError(f"service fairness {label}: victim done {victim.done}, "
                                     f"{n} launches for {svc.queue.launches} queue launches")
            if policy is not None:
                InvariantMonitor.check_tenant_fairness(policy)
                if policy.max_deferrals > policy.starve_after:
                    raise AssertionError(f"service fairness: {policy.max_deferrals} "
                                         f"deferrals")
            p99[label].append(_p99(victim.commit_latencies))
            extra = (f" deferred={policy.deferred_total} forced={policy.forced_total} "
                     f"max_deferrals={policy.max_deferrals}" if policy is not None else "")
            print(f"service fairness rep={rep} {label}: victim_p99_s={p99[label][-1]:.5f} "
                  f"launches={n} queue_submitted={svc.queue.submitted}{extra}", flush=True)
    print(f"service fairness: fifo_over_drr_p99="
          + " ".join(f"{f / d:.4f}" for f, d in zip(p99["fifo"], p99["drr"])), flush=True)

    # C: a remote tenant over localhost TCP beside three local tenants.
    heights = 6
    svc = ShardVerifyService(card, max_depth=0)
    controller = BackpressureController()
    controller.watch(svc.queue)
    controller.floor = CRITICAL_ONLY
    port = svc.remote_port(controller=controller)
    client = None
    try:
        client = RemoteServiceClient(*port.address)
        remote = TenantShard("remote", n_validators=SERVICE_VALIDATORS,
                             target_height=heights).attach_remote(client)
        local = tenants([svc], 3, heights, prefix="local")
        ed25519_cuda.reset_stats()
        t0 = time.perf_counter()
        errors: list = []

        def drive():
            try:
                remote.run_remote(max_inflight=4, timeout=20.0)
            except Exception as err:  # reported by the drive loop below
                errors.append(err)

        worker = threading.Thread(target=drive, daemon=True)
        worker.start()
        while worker.is_alive() and time.perf_counter() - t0 < 60.0:
            port.pump()
            if controller.floor and port.remote_sheds:
                controller.floor = 0
            for t in local:
                t.pump(max_inflight=1)
            svc.drain()
            time.sleep(0.0005)
        worker.join(5.0)
        wall = time.perf_counter() - t0
        if worker.is_alive() or errors or not remote.done or remote.rejected:
            raise AssertionError(f"service remote: done {remote.done}, rejected "
                                 f"{remote.rejected}, errors {errors}")
    finally:
        if client is not None:
            client.close()
        port.close()
    while not all(t.done for t in local):
        for t in local:
            t.pump(max_inflight=1)
        svc.drain()
    n = launches()
    solo_svc = ShardVerifyService(HostVerifier(), max_depth=0)
    solo = TenantShard("remote", n_validators=SERVICE_VALIDATORS,
                       target_height=heights).attach_local(solo_svc)
    _waves([solo_svc], [solo], heights)
    q = svc.queue
    if (remote.commit_digest() != solo.commit_digest() or n != q.launches
            or not q.launches < q.submitted
            or port.remote_sheds < 1 or remote.shed_retries < 1
            or port.remote_resolves != port.remote_submits):
        raise AssertionError(f"service remote: digest equal "
                             f"{remote.commit_digest() == solo.commit_digest()}, queue "
                             f"{q.submitted}/{q.launches}, sheds {port.remote_sheds}, "
                             f"retries {remote.shed_retries}")
    print(f"service remote: heights={heights} local_tenants=3 wall_s={wall:.3f} "
          f"remote_submits={port.remote_submits} remote_resolves={port.remote_resolves} "
          f"remote_sheds={port.remote_sheds} shed_retries={remote.shed_retries} "
          f"queue_submitted={q.submitted} queue_launches={q.launches} "
          f"queue_coalesced={q.coalesced} launches={n} certs_verified={len(remote.commits)} "
          f"digest_equal_local=True", flush=True)

    # D: execution-attached tenants: remote roots and a proof; rotation.
    cfg = ExecutionConfig(accounts=1024, txs_per_block=64, stake_every=3,
                          stake_accounts=64, seed=17)
    host_ex = HostLedgerExecutor(cfg)
    svc = ShardVerifyService(card, max_depth=0)
    svc.attach_execution("rx", cfg)
    port = svc.remote_port()
    client = None
    try:
        client = RemoteServiceClient(*port.address)
        remote = TenantShard("rx", n_validators=SERVICE_VALIDATORS,
                             target_height=4).attach_remote(client)
        worker = threading.Thread(target=remote.run_remote, kwargs={"timeout": 20.0},
                                  daemon=True)
        worker.start()
        t0 = time.perf_counter()
        while worker.is_alive() and time.perf_counter() - t0 < 60.0:
            port.pump()
            svc.drain()
            time.sleep(0.0005)
        worker.join(5.0)
        fut = client.query(5)
        while not fut.done() and time.perf_counter() - t0 < 60.0:
            port.pump()
            time.sleep(0.0005)
        status, proof = fut.proof_result(timeout=5.0)
    finally:
        if client is not None:
            client.close()
        port.close()
    roots_ok = remote.done and all(remote.state_roots[h] == host_ex.advance_to(h)
                                   for h in range(1, 5))
    if (not roots_ok or status != STATUS_COMMITTED
            or not remote.verify_balance(proof, remote.state_roots[proof.height])):
        raise AssertionError(f"service exec: roots equal {roots_ok}, proof status {status}")

    def serve(rotate_at):
        verifier = TorchBatchVerifier(device="cuda")
        svc = ShardVerifyService(verifier, max_depth=0)
        t = TenantShard("rot", n_validators=SERVICE_VALIDATORS, target_height=6,
                        execution=cfg).attach_local(svc)
        ed25519_cuda.reset_stats()
        while not t.done:
            if rotate_at is not None and len(t.commits) >= rotate_at:
                svc.rotate(generation=1)
                t.generation, rotate_at = 1, None
            t.pump(max_inflight=1)
            svc.drain()
        return t, verifier.generation, launches()

    rotated, gen, n_rot = serve(3)
    base, gen0, n_base = serve(None)
    if (gen, gen0) != (1, 0) or rotated.state_roots != base.state_roots or (
            rotated.commit_digest() != base.commit_digest()) or n_rot != 6 or n_base != 6 or any(
            base.state_roots[h] != host_ex.advance_to(h) for h in range(1, 7)):
        raise AssertionError(f"service exec rotation: generations {gen}/{gen0}, launches "
                             f"{n_rot}/{n_base}, roots or digest differ")
    print(f"service exec: accounts={cfg.accounts} remote_heights=4 roots_equal_host=True "
          f"proof_account=5 proof_height={proof.height} proof_depth={len(proof.siblings)} "
          f"proof_verified=True rotated_generation={gen} rotation_launches={n_rot} "
          f"roots_equal_rotation_free=True digest={rotated.commit_digest()[:16]}", flush=True)


#: The deployment runs: (label, processes, replicas per process, heights,
#: seconds until an unfinished run fails, worker options).
DEPLOY_RUNS = (
    ("capstone", 2, 2, 10, 420, ("--buckets", "64", "--check-host")),
    ("full", 4, 64, 3, 300, ()),
)


def _free_ports(n: int) -> list:
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def run_deploy(label: str, procs: int, per: int, heights: int, deadline: float,
               opts) -> list:
    """Start ``procs`` deployment workers on the card, wait for all of
    them, check them against each other, print their lines; returns each
    worker's fields."""
    ports = _free_ports(procs)
    root = os.path.dirname(os.path.abspath(__file__))
    opts = ("--deadline", str(deadline), *opts)
    cmd = [sys.executable, "-m", "hyperdrive_tpu_torch.harness.deploy",
           *map(str, ports)]
    t0 = time.perf_counter()
    workers = [
        subprocess.Popen(cmd + [str(rank), str(per), str(heights), "card", *opts],
                         cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for rank in range(procs)
    ]
    end = t0 + deadline + 120
    outs = []
    try:
        for w in workers:
            outs.append(w.communicate(timeout=max(1.0, end - time.perf_counter()))[0])
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    wall = time.perf_counter() - t0
    fields = []
    for rank, (w, out) in enumerate(zip(workers, outs)):
        lines = out.strip().splitlines()
        if w.returncode != 0 or not lines or not lines[-1].startswith(
                f"TRANSPORT_OK rank={rank} heights={heights} "):
            raise AssertionError(f"deploy {label}: worker {rank} failed "
                                 f"({w.returncode}):\n" + "\n".join(lines[-40:]))
        for line in lines:
            if line.startswith(("DEPLOY_", "TRANSPORT_OK")):
                print(f"deploy {label}: {line}", flush=True)
        got = {}
        for line in lines:
            if line.startswith(("DEPLOY_STATS", "DEPLOY_TRACE", "TRANSPORT_OK")):
                got.update(kv.split("=", 1) for kv in line.split()[1:])
        fields.append(got)
    digests = {f["digest"] for f in fields}
    if len(digests) != 1:
        raise AssertionError(f"deploy {label}: digests differ across processes: {digests}")
    for rank, f in enumerate(fields):
        if f["mode"] != "card" or int(f["consulted"]) <= 0 or int(f["grouped"]) <= 0:
            raise AssertionError(f"deploy {label}: worker {rank}: {f}")
        for k in ("ed25519_challenge", "ed25519_semiwire"):
            if int(f[f"{k}_launches"]) <= 0:
                raise AssertionError(f"deploy {label}: worker {rank} launched no {k}")
        if "--check-host" in opts and not (
                0 < int(f["flushes"]) == int(f["masks_checked"])):
            raise AssertionError(f"deploy {label}: worker {rank}: {f['masks_checked']} "
                                 f"masks held against the host for {f['flushes']} flushes")
    print(f"deploy {label}: n={procs * per} processes={procs} replicas_per_process={per} "
          f"heights={heights} phase_s={wall:.2f} digest={digests.pop()[:16]} "
          f"equal_digests=True", flush=True)
    return fields


#: Rows of one flush's scatter and lanes of one flush's verify in the
#: in-process contention probe: about what a replica's flush carries at
#: n = 256 (the full run's grouped lanes over its flushes, ~100).
FLUSH_ROWS = FLUSH_LANES = 100


def _threaded_ms(threads: int, calls: int, make, call) -> list:
    """Per-thread host wall per call (ms): ``threads`` threads, each with
    its own state from ``make()`` and a CUDA stream of its own, start
    together and run ``call(state)`` ``calls`` times."""
    import threading

    states = [make() for _ in range(threads)]
    streams = [torch.cuda.Stream() for _ in range(threads)]
    torch.cuda.synchronize()
    start = threading.Barrier(threads)
    per: list = []
    errors: list = []

    def work(i):
        try:
            with torch.cuda.stream(streams[i]):
                call(states[i])
                start.wait()
                t0 = time.perf_counter()
                for _ in range(calls):
                    call(states[i])
                per.append((time.perf_counter() - t0) / calls * 1e3)
        except Exception as e:  # re-raised below
            errors.append(e)
            start.abort()

    workers = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    if errors:
        raise errors[0]
    return per


def deploy_contention() -> None:
    """What one replica thread pays for a flush's grid call and verify
    call, alone and with 63 other threads of one process doing the same
    (each on its own grid and stream), as host wall per call: the
    deployment's in-process cost without sockets, consensus or other
    processes on the card."""
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.ops.ed25519_wire import TorchWireVerifier, ValidatorTable
    from hyperdrive_tpu_torch.ops.votegrid import VoteGrid

    V, R = N_VALIDATORS, 8
    rng = np.random.default_rng(SEED + 7)
    scatter = _scatter_args(rng, 1, V, R, FLUSH_ROWS)
    ring = KeyRing.deterministic(V, namespace=b"deploy-probe")
    table = ValidatorTable(ring.signatories, device="cuda")
    digest = bytes(range(32))
    items = [(ring[i].public, digest, ring[i].sign_digest(digest))
             for i in range(FLUSH_LANES)]
    wv = TorchWireVerifier(table=table, device="cuda")
    wv.warmup()
    if not wv.verify_signatures(items).all():
        raise AssertionError("deploy contention: a valid signature was rejected")
    probes = (
        ("update_and_tally", f"n=1 V={V} R={R} rows={FLUSH_ROWS}",
         lambda: VoteGrid(1, V, r_slots=R, buckets=(256, 1024, 4096), device="cuda"),
         lambda g: g.update_and_tally(*scatter)["total"]),
        ("verify_signatures", f"grouped lanes={FLUSH_LANES} (one shared verifier)",
         lambda: wv, lambda v: v.verify_signatures(items)),
    )
    for name, shape, make, call in probes:
        alone = statistics.median(_threaded_ms(1, 20, make, call))
        crowd = _threaded_ms(64, 10, make, call)
        print(f"deploy contention: {name} {shape} threads=1 ms_per_call={alone:.3f} "
              f"threads=64 ms_per_call_median={statistics.median(crowd):.3f} "
              f"max={max(crowd):.3f} calls_per_s={64 * 1e3 / statistics.median(crowd):.0f}",
              flush=True)


def phase_deploy() -> None:
    deploy_contention()
    for run in DEPLOY_RUNS:
        run_deploy(*run)


# ------------------------------------------------ Shamir payloads, RLC, QCs

#: Config 5 (``BASELINE.json`` configs[4]) as the JAX package's bench runs
#: it (``benches/run_all.py`` ``config_5``): n = 256, k = 2f + 1 = 171,
#: 496-byte payloads, seed 1005, 20 s timeouts, burst. Signed here
#: (``sign=True, dedup_verify=True``, every settle on the batch verifier)
#: so that row 1 is on its path; the bench's 10 heights, uncut.
C5_N, C5_PAYLOAD, C5_SEED, C5_TIMEOUT, C5_HEIGHTS = 256, 496, 1005, 20.0, 10
#: Block counts of the standalone reconstruct: the bench's commit-sized
#: 16 blocks (a 496-byte payload with its 0x80 pad is 17), the bench's
#: 64-block launch, and a wide batch past the adaptive router's
#: calibration point (512 blocks).
SHAMIR_BLOCKS = (16, 64, 1024)
RLC_SIZES = (64, 4096)
#: The main-path invariant (seed 1, n = 256, five heights).
MAIN_DIGEST, MAIN_STEPS = "215413db54656240", 656_640


def _solved_shares(secrets, xs, lams, rng):
    """Shares at ``xs`` of polynomials with the given secrets: every
    share but the last is random, the last solved so that the Lagrange
    sum at zero is the secret (any k points define one polynomial of
    degree k - 1). Costs k products a block, where splitting all n
    shares costs n Horner evaluations of degree k - 1 (17 s at 1,024
    blocks)."""
    from hyperdrive_tpu_torch.crypto.shamir import P

    inv_last = pow(lams[-1], P - 2, P)
    out = []
    for s in secrets:
        ys = [int.from_bytes(rng.bytes(32), "little") % P for _ in xs[:-1]]
        acc = sum(lam * y for lam, y in zip(lams, ys)) % P
        ys.append((s - acc) * inv_last % P)
        out.append(list(zip(xs, ys)))
    return out


def phase_shamir() -> None:
    """BatchReconstructor on the card at k = 171, byte-exact against the
    oracle; ms, CUDA kernels and bound of one reconstruct call; the host
    leg's time beside it; AdaptiveReconstructor's calibration record."""
    from hyperdrive_tpu_torch.crypto import shamir
    from hyperdrive_tpu_torch.ops import shamir as tshamir

    n = N_VALIDATORS
    k = 2 * (n // 3) + 1
    rng = np.random.default_rng(SEED + 5)
    xs = sorted(int(x) + 1 for x in rng.choice(n, size=k, replace=False))
    lams = shamir.lagrange_coeffs_at_zero(xs)
    recon = tshamir.BatchReconstructor(device="cuda")
    props = torch.cuda.get_device_properties(0)
    imad_s = IMAD_PER_SM_CLOCK * props.multi_processor_count * sm_clock_mhz() * 1e6
    for blocks in SHAMIR_BLOCKS:
        payload = rng.bytes(shamir.BLOCK_BYTES * blocks - 1)
        padded = payload + b"\x80"
        secrets = [int.from_bytes(padded[i:i + 31], "little")
                   for i in range(0, len(padded), 31)]
        shares = _solved_shares(secrets, xs, lams, rng)
        got = recon.reconstruct_payload_shares(shares)
        if blocks <= 64:
            want = shamir.reconstruct_payload(shares)
            oracle = "reconstruct_payload_equal=True"
        else:
            # The oracle recomputes the k weights for every block (~60 ms
            # a block at k = 171): 40 sampled blocks through it, all
            # blocks through the payload's own bytes and the host leg.
            picks = rng.choice(blocks, size=40, replace=False)
            if any(shamir.reconstruct_block(shares[b]) != secrets[b] for b in picks):
                raise AssertionError("shamir: oracle reconstruct_block != secret")
            want = payload
            oracle = "reconstruct_block_sample=40_equal=True"
        host = tshamir.AdaptiveReconstructor(recon)
        host_out = host.host_reconstruct(shares)  # weights cached from here on
        if not (got == want == payload == host_out):
            raise AssertionError(f"shamir: {blocks} blocks differ from the oracle")
        host_s = min(_host_s(lambda: host.host_reconstruct(shares)) for _ in range(3))
        wrap_s = min(_host_s(lambda: recon.reconstruct_payload_shares(shares))
                     for _ in range(3))
        y = torch.from_numpy(tshamir._limbs_of_ints(
            v for i in range(k) for v in (sh[i][1] for sh in shares))
            .reshape(k, blocks, 20)).to("cuda")
        lam_t = torch.from_numpy(tshamir._limbs_of_ints(lams)).to("cuda")
        fn = lambda: tshamir.reconstruct_kernel(y, lam_t)  # noqa: E731
        ms = time_ms(fn, 7)
        kern = _kernels_per_call(fn)
        # Bound: k x B field products and additions and B canonical
        # reductions, in the multiply instructions of the 8 x 32-bit field
        # (the unit of imad_per_signature), at the cc 9.0 rate; or the
        # shares and weights read once and the secrets written once, 32 B
        # a field element, at the memory rate; whichever is larger.
        ops_ms = (k * blocks * (MUL + ADD) + blocks * CANON) / imad_s * 1e3
        byt_ms = (k * blocks + k + blocks) * 32 / HBM_BYTES_PER_S * 1e3
        b_ms, b_by = (ops_ms, "operations") if ops_ms >= byt_ms else (byt_ms, "bytes")
        print(f"programs: shamir reconstruct k={k} n={n} blocks={blocks} "
              f"{oracle} ms={ms:.4f} bound_ms={b_ms:.6f} bound_by={b_by} "
              f"bound_share={b_ms / ms:.5f} chunk_blocks={tshamir._chunk_blocks(k)} "
              f"cuda_kernels_per_call={kern} wrapper_s={wrap_s:.5f} "
              f"host_leg_s={host_s:.5f}", flush=True)
    adaptive = tshamir.AdaptiveReconstructor(tshamir.BatchReconstructor(device="cuda"))
    if adaptive.reconstruct_payload_shares(shares) != payload or not adaptive.calibrated:
        raise AssertionError("shamir: calibration run failed")
    r = adaptive.rates
    print(f"programs: shamir adaptive calibration blocks={len(shares)} "
          f"host_blocks_per_s={r['host_blocks_per_s']:.1f} "
          f"device_blocks_per_s={r['device_blocks_per_s']:.1f} "
          f"device_overhead_s={r['device_overhead_s']:.5f} "
          f"crossover_blocks={adaptive.crossover_blocks}", flush=True)


def _host_s(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _valid_items(lanes: int, rng) -> list:
    ring = _ring()
    out = []
    for i in range(lanes):
        kp = ring[i % 32]
        digest = rng.bytes(32)
        out.append((kp.public, digest, kp.sign_digest(digest)))
    return out


def _order8_item():
    """(pub, digest, sig) valid under the cofactored equation and invalid
    under the strict one: A = R = an order-8 point, s = 0 (the JAX
    package's ``tests/test_msm.py`` vector)."""
    from hyperdrive_tpu_torch.crypto import ed25519 as hed

    for seed in range(2, 50):
        p = hed.point_decompress(bytes([seed]) + bytes(31))
        if p is None:
            continue
        q = hed.scalar_mult(hed.L, p)
        o, acc = 1, q
        while not hed.point_equal(acc, hed.IDENTITY) and o <= 8:
            acc = hed.point_add(acc, q)
            o += 1
        if o == 8:
            break
    enc = hed.point_compress(q)
    for i in range(64):
        msg = b"small-order-%d" % i
        k = hed.challenge_scalar(enc, enc, msg)
        if not hed.point_equal(hed.IDENTITY, hed.point_add(q, hed.scalar_mult(k, q))):
            return enc, msg, enc + bytes(32)
    raise AssertionError("no diverging message found")


def phase_rlc() -> None:
    """TorchBatchVerifier(rlc=True) on the card: a clean batch in one
    rlc_check, a forged lane through the fallback (mask equal to the
    ladder's and the oracle's), the order-8 divergence, one MSM against
    the oracle's point sum; then ms and CUDA kernels of rlc_check beside
    the ladder's time at the same lanes."""
    from hyperdrive_tpu_torch.crypto import ed25519 as hed
    from hyperdrive_tpu_torch.ops import ed25519 as ted
    from hyperdrive_tpu_torch.ops import ed25519_cuda, msm
    from hyperdrive_tpu_torch.verifier import HostVerifier

    rng = np.random.default_rng(SEED + 6)
    oracle = HostVerifier()
    props = torch.cuda.get_device_properties(0)
    imad_s = IMAD_PER_SM_CLOCK * props.multi_processor_count * sm_clock_mhz() * 1e6

    # One 64-lane MSM against the oracle's sum (host points, any Z).
    pts = [hed.scalar_mult(int(rng.integers(1, 1 << 62)) * 977 + 5, hed.BASE)
           for _ in range(64)]
    scalars = [int.from_bytes(rng.bytes(32), "little") % hed.L for _ in range(64)]
    scalars[7] = 0
    pts[9] = pts[3]
    nib = torch.tensor([[(v >> (4 * w)) & 0xF for w in range(64)] for v in scalars],
                       dtype=torch.int32, device="cuda")
    px, py, pt = (torch.from_numpy(a).to("cuda") for a in ted.pack_affine(pts))
    got = ted.affine_of(ted.msm_kernel(px, py, pt, ted._recode_signed(nib)))
    acc = hed.IDENTITY
    for p, v in zip(pts, scalars):
        acc = hed.point_add(acc, hed.scalar_mult(v, p))
    zi = pow(acc[2], hed.P - 2, hed.P)
    if got != (acc[0] * zi % hed.P, acc[1] * zi % hed.P):
        raise AssertionError("msm_kernel (64 lanes) != the oracle's point sum")
    print("programs: msm 64 lanes x 64 windows equals_oracle_sum=True", flush=True)

    for lanes in RLC_SIZES:
        bv = ted.TorchBatchVerifier(buckets=(lanes,), rlc=True, device="cuda")
        bv.warmup()
        items = _valid_items(lanes, rng)
        ed25519_cuda.reset_stats()
        if not bv.verify_signatures(items).all():
            raise AssertionError(f"rlc {lanes}: a clean batch was rejected")
        if (bv.rlc_calls, bv.rlc_fallbacks,
                ed25519_cuda.stats["ed25519_verify"].launches) != (1, 0, 0):
            raise AssertionError(f"rlc {lanes}: clean batch took {bv.rlc_calls} checks, "
                                 f"{bv.rlc_fallbacks} fallbacks")
        bad = list(items)
        j = lanes // 2
        sig = bad[j][2]
        bad[j] = (bad[j][0], bad[j][1], sig[:40] + bytes([sig[40] ^ 1]) + sig[41:])
        mask = bv.verify_signatures(bad)
        arrays, prevalid, _ = bv.host.pack(bad)
        ladder = ed25519_cuda.verify(*(torch.from_numpy(a).to("cuda") for a in arrays))
        ladder = ladder.cpu().numpy() & prevalid
        want = np.asarray(oracle.verify_signatures(bad), dtype=bool)
        sample = [j] + [int(i) for i in rng.choice(lanes, size=min(lanes, 32), replace=False)]
        if not (np.array_equal(mask, ladder[:lanes]) and np.array_equal(mask, want)
                and all(mask[i] == hed.verify(*bad[i]) for i in sample)
                and not mask[j] and int(mask.sum()) == lanes - 1):
            raise AssertionError(f"rlc {lanes}: fallback mask differs from the ladder's "
                                 f"or the oracle's")
        if (bv.rlc_calls, bv.rlc_fallbacks) != (2, 1):
            raise AssertionError(f"rlc {lanes}: the forged batch did not fall back once")
        extra = ""
        if lanes == RLC_SIZES[0]:
            batch = items[:3] + [_order8_item()]
            strict = ted.TorchBatchVerifier(buckets=(lanes,), device="cuda")
            if (strict.verify_signatures(batch).tolist() != [True, True, True, False]
                    or bv.verify_signatures(batch).tolist() != [True] * 4
                    or bv.rlc_fallbacks != 1 or hed.verify(*batch[3])):
                raise AssertionError("rlc: the order-8 vector did not show the "
                                     "cofactored divergence")
            extra = " order8_rlc_accepts=True order8_ladder_rejects=True"
        tensors = [torch.from_numpy(a).to("cuda") for a in arrays]
        m_nib, z_nib, c_nib = (torch.from_numpy(a).to("cuda") for a in ted.rlc_scalars(
            arrays[5], arrays[6], prevalid, ted.rlc_binder(items)))
        fn = lambda: ted.rlc_check(*tensors[:5], m_nib, z_nib, c_nib)  # noqa: E731
        ms = time_ms(fn, 3, warm=False)  # bv.warmup() ran it at this shape
        ladder_ms = time_ms(lambda: ed25519_cuda.verify(*tensors), 7)
        # The profiler's pass over ~10^5 kernels costs seconds: one size.
        kern = _kernels_per_call(fn) if lanes == RLC_SIZES[-1] else "-"
        G, g = msm.plan_groups(lanes)
        # Bound: the accumulation's mixed additions alone (one a lane a
        # window over 64 + 33 windows), in the multiply instructions of the
        # 8 x 32-bit field (the unit of imad_per_signature), at the cc 9.0
        # rate.
        b_ms = (msm.ED25519_FULL_WINDOWS + msm.ED25519_HALF_WINDOWS) * lanes \
            * _madd(True) / imad_s * 1e3
        print(f"programs: rlc lanes={lanes} clean_checks=1 clean_fallbacks=0 "
              f"forged_fallbacks=1 mask_equals_ladder=True mask_equals_oracle=True{extra} "
              f"rlc_check_ms={ms:.2f} ladder_ms={ladder_ms:.4f} "
              f"rlc_over_ladder={ms / ladder_ms:.1f} bound_ms={b_ms:.6f} "
              f"bound_by=operations bound_share={b_ms / ms:.6f} groups={G}x{g} "
              f"cuda_kernels_per_call={kern}", flush=True)


def _sim_run(**kw):
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    sim = Simulation(**kw)
    if hasattr(sim.batch_verifier, "warmup"):
        sim.batch_verifier.warmup()
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    t0 = time.perf_counter()
    res = sim.run(max_steps=20_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ed25519_cuda.stats["ed25519_verify"].launches
    moved = {k: v.launches for k, v in ed25519_cuda.stats.items()
             if k != "ed25519_verify" and v.launches}
    if moved:
        raise AssertionError(f"other kernels launched: {moved}")
    res.assert_safety()
    return sim, res, wall, launches


def phase_config5() -> None:
    """Config 5, signed: the host run (HostVerifier, adaptive
    reconstructor), a run with BatchReconstructor pinned on the card (a
    reconstruct launch at every committed height) and one with the
    adaptive default (16-block commits on the host leg: no launch); each
    card run equal to the host run in digest, steps and every replica's
    reconstructed payloads, and row 1 launched at every vote settle."""
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.ops.shamir import AdaptiveReconstructor, BatchReconstructor
    from hyperdrive_tpu_torch.verifier import HostVerifier

    base = dict(n=C5_N, target_height=C5_HEIGHTS, seed=C5_SEED, timeout=C5_TIMEOUT,
                sign=True, burst=True, dedup_verify=True, small_window_host=False,
                payload_bytes=C5_PAYLOAD, device="cuda")
    runs = [("host", dict(batch_verifier=HostVerifier())),
            ("pinned", dict(batch_verifier=TorchBatchVerifier(device="cuda"),
                            reconstructor=BatchReconstructor(device="cuda"))),
            ("adaptive", dict(batch_verifier=TorchBatchVerifier(device="cuda")))]
    ref = None
    for label, opts in runs:
        sim, res, wall, launches = _sim_run(**base, **opts)
        if not res.completed:
            raise AssertionError(f"config5 {label}: stalled at {res.heights}")
        got = (res.commit_digest(up_to=C5_HEIGHTS), res.steps, sim.reconstructed)
        if ref is None:
            ref = got
        elif got != ref:
            raise AssertionError(f"config5 {label}: digest, steps or payloads differ "
                                 f"from the host run")
        recon = sim.reconstructor
        if isinstance(recon, AdaptiveReconstructor):
            recon = recon.device
        committed = len(set(res.commits[0].values()))
        if label == "pinned" and not (
                recon.launches == len(sim.reconstruct_latency) == committed):
            raise AssertionError(f"config5 pinned: {recon.launches} reconstruct launches "
                                 f"for {committed} committed values")
        if label == "adaptive" and recon.launches:
            raise AssertionError("config5 adaptive: a 16-block commit went to the card")
        if label != "host" and launches < sim.vote_settles:
            raise AssertionError(f"config5 {label}: {launches} ed25519_verify launches "
                                 f"for {sim.vote_settles} vote settles")
        lat = sorted(sim.reconstruct_latency)
        blocks = -(-(C5_PAYLOAD + 1) // 31)
        print(f"config5 {label}: n={C5_N} k={sim.k} payload_bytes={C5_PAYLOAD} "
              f"blocks={blocks} heights={C5_HEIGHTS} completed={res.completed} "
              f"steps={res.steps} wall_s={wall:.2f} heights_per_s={C5_HEIGHTS / wall:.3f} "
              f"reconstructions={len(lat)} reconstruct_share={sum(lat) / wall:.4f} "
              f"reconstruct_p50_s={statistics.median(lat):.5f} "
              f"reconstruct_launches={recon.launches} ed25519_verify_launches={launches} "
              f"vote_settles={sim.vote_settles} payloads_equal_host=True "
              f"digest={got[0][:16]} matches_host=True", flush=True)


def phase_certs() -> None:
    """The main path with certificates=True: rlc=False (row 1 on every
    settle) and rlc=True (one rlc_check a settle); the main-path
    invariant, chain digests equal across replicas and to the host run's,
    every certificate re-verified and round-tripped through the codec."""
    from hyperdrive_tpu_torch.certificates import marshal_certificate, unmarshal_certificate
    from hyperdrive_tpu_torch.codec import Reader, Writer
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.verifier import HostVerifier

    base = dict(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True, burst=True,
                dedup_verify=True, small_window_host=False, certificates=True)
    _, host, _, _ = _sim_run(batch_verifier=HostVerifier(), **base)
    for rlc in (False, True):
        bv = TorchBatchVerifier(device="cuda", rlc=rlc)
        sim, res, wall, launches = _sim_run(batch_verifier=bv, **base)
        digest = res.commit_digest(up_to=HEIGHT)
        if digest[:16] != MAIN_DIGEST or res.steps != MAIN_STEPS or not res.completed:
            raise AssertionError(f"certs rlc={rlc}: digest {digest[:16]} in {res.steps} "
                                 f"steps, want {MAIN_DIGEST} in {MAIN_STEPS}")
        if len(set(res.cert_digests)) != 1 or res.cert_digests != host.cert_digests:
            raise AssertionError(f"certs rlc={rlc}: chain digests differ across replicas "
                                 f"or from the host run")
        certs = 0
        for c in sim.certifiers:
            for cert in c.certs.values():
                w = Writer()
                marshal_certificate(cert, w)
                if not c.verify(cert) or unmarshal_certificate(Reader(w.data())) != cert:
                    raise AssertionError(f"certs rlc={rlc}: a certificate failed")
                certs += 1
        if rlc and (launches or bv.rlc_fallbacks or not bv.rlc_calls):
            raise AssertionError(f"certs rlc=True: {bv.rlc_calls} checks, "
                                 f"{bv.rlc_fallbacks} fallbacks, {launches} ladder launches")
        if not rlc and launches < sim.vote_settles:
            raise AssertionError(f"certs rlc=False: {launches} ed25519_verify launches")
        print(f"certs rlc={rlc}: n={N_VALIDATORS} height={HEIGHT} steps={res.steps} "
              f"wall_s={wall:.2f} heights_per_s={HEIGHT / wall:.3f} certificates={certs} "
              f"reverified_and_roundtripped={certs} chain_digests_equal=True "
              f"chain_equals_host=True rlc_calls={bv.rlc_calls} "
              f"rlc_fallbacks={bv.rlc_fallbacks} ed25519_verify_launches={launches} "
              f"settle_passes={sim.settle_passes} digest={digest[:16]}", flush=True)


# ------------------------------------------------------ the execution layer

#: The JAX package's documented execution deployments, not cut. 65,536
#: accounts: the README "Trustless reads" ledger and the largest of
#: ``benches/proof_bench.py``'s sizes; blocks of 16,384 and 65,536 txs: the
#: smallest and largest of ``benches/exec_bench.py`` ``E2E_SIZES`` (:78),
#: with that bench's stake lane and amount cap.
EXEC_ACCOUNTS = 65_536
EXEC_PROBE_TXS = (16_384, 65_536)
EXEC_LEG_A = dict(accounts=EXEC_ACCOUNTS, txs_per_block=16_384, stake_every=4,
                  amount_cap=64)
EXEC_A_HEIGHTS = 3
#: Leg B: ``benches/exec_bench.py``'s apply ledger (4,096 accounts, :87),
#: signed, every 7th signature forged.
EXEC_LEG_B = dict(accounts=4096, txs_per_block=1024, stake_every=4, sign_txs=True,
                  bad_sig_every=7)
EXEC_B_HEIGHTS = 5
#: Leg B's commit digest as the JAX package's Simulation gives it for the
#: same call with its host verifier, fused and two-kind alike.
EXEC_B_DIGEST = "d9ddcebeaffe5645"


def exec_step_bytes(accounts: int, txs: int, branch: str) -> int:
    """Bytes one Merkleized apply step must move: the two int32 state
    arrays read and written, the [5, T] int32 columns read, and the tree
    levels at 4 B a uint32 word, written, and read too on the incremental
    branch (a full rebuild only writes them). The mix matrix is a
    splitmix function of the word index, which a kernel computes in
    registers: no bytes."""
    from hyperdrive_tpu_torch.ops import merkle

    nodes = 2 * merkle.leaf_count(accounts) - 1
    tree = nodes * merkle.NODE_WORDS * 4
    return (2 * 2 * accounts * 4 + 5 * txs * 4
            + (2 if branch == "incremental" else 1) * tree)


def phase_exec_probe() -> None:
    """One Merkleized apply step (``apply_block_chain_merkle_cols_torch``)
    on the card at 65,536 accounts for each probe block size, from the
    genesis ledger: every output (state, applied count, root, digest, every
    tree level) equal to the host reference executor stepping the same
    block; ms (CUDA events, best of five), CUDA kernels a call, the bound
    by bytes and its share."""
    from hyperdrive_tpu_torch.exec import ExecutionConfig
    from hyperdrive_tpu_torch.exec.ledger import HostLedgerExecutor
    from hyperdrive_tpu_torch.ops import ledger
    from hyperdrive_tpu_torch.ops.rootmix import root_words

    dev = torch.device("cuda")
    for txs in EXEC_PROBE_TXS:
        cfg = ExecutionConfig(**dict(EXEC_LEG_A, txs_per_block=txs,
                                     stake_accounts=N_VALIDATORS))
        host = HostLedgerExecutor(cfg)
        state = (np.array(host.balances, np.int32), np.array(host.stakes, np.int32))
        tree, root = [lvl.copy() for lvl in host._tree], host._root_words.copy()
        cols = ledger.pack_block_cols(*host.source.block(1)._np)
        host.advance_to(1)
        args = ledger.from_reference(*state, root, tree, cols, device=dev)
        mix = ledger.mix_tensor(4 * cfg.accounts, dev)
        fn = lambda: ledger.apply_block_chain_merkle_cols_torch(  # noqa: E731
            *args[:4], 1, args[4], mix)
        bal, stk, count, new_root, digest, new_tree = fn()
        want_tree = [lvl.astype(np.int64) for lvl in host._tree]
        if not (np.array_equal(bal.cpu().numpy(), host.balances)
                and np.array_equal(stk.cpu().numpy(), host.stakes)
                and int(count) == host.applied_total
                and np.array_equal(new_root.cpu().numpy(), root_words(host.roots[1]))
                and np.array_equal(digest.cpu().numpy(), host._last_digest)
                and len(new_tree) == len(want_tree)
                and all(np.array_equal(g.cpu().numpy(), w)
                        for g, w in zip(new_tree, want_tree))):
            raise AssertionError(f"exec probe txs={txs}: the card's step differs from "
                                 f"the host executor")
        branch = "full" if 2 * cols.shape[1] >= len(tree[0]) else "incremental"
        ms = min(time_ms(fn, 1, warm=False) for _ in range(5))
        kern = _kernels_per_call(fn)
        b_ms = exec_step_bytes(cfg.accounts, cols.shape[1], branch) / HBM_BYTES_PER_S * 1e3
        print(f"programs: exec apply+merkle accounts={cfg.accounts} txs={txs} "
              f"branch={branch} applied={host.applied_total} equal_host=True ms={ms:.4f} "
              f"cuda_kernels_per_call={kern} bound_ms={b_ms:.6f} bound_by=bytes "
              f"bound_share={b_ms / ms:.5f}", flush=True)


class _ExecClock:
    """Seconds spent in the executors' ``advance_to``, ``speculate`` and
    ``resolve`` (apply, digest, tree, fold, rollback and the window's host
    copy, block synthesis included), in ``BlockSource.block``
    (synthesis) and in ``BlockSource.sig_items`` (signing the block's
    transactions), outermost calls only; and, per
    verify launcher launch, or (in a sequential run) per batch-verifier
    call, that carries a block's signature rows, the ``ed25519_verify``
    launches it made. Installed for one run."""

    def __init__(self):
        from hyperdrive_tpu_torch.devsched.queue import VerifyLauncher
        from hyperdrive_tpu_torch.exec.ledger import BlockSource, HostLedgerExecutor
        from hyperdrive_tpu_torch.ops import ed25519_cuda
        from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier

        self.spent: dict = {}
        self.exec_rows = self.exec_launches = self.exec_kernels = 0
        self._lists: dict = {}
        depth: dict = {}
        in_launch = [0]
        sig_items = BlockSource.sig_items

        def register(src, blk):
            items = sig_items(src, blk)
            self._lists[id(items)] = items
            return items

        launch = VerifyLauncher.launch

        def count(rows, before):
            if rows:
                self.exec_rows += rows
                self.exec_launches += 1
                self.exec_kernels += ed25519_cuda.stats["ed25519_verify"].launches - before

        def counted(launcher, payloads):
            before = ed25519_cuda.stats["ed25519_verify"].launches
            in_launch[0] += 1
            try:
                out = launch(launcher, payloads)
            finally:
                in_launch[0] -= 1
            count(sum(len(p) for p in payloads if id(p) in self._lists), before)
            return out

        verify = TorchBatchVerifier.verify_signatures

        def verified(verifier, items):
            before = ed25519_cuda.stats["ed25519_verify"].launches
            out = verify(verifier, items)
            if not in_launch[0] and id(items) in self._lists:
                count(len(items), before)
            return out

        # The executors' entry points (DeviceLedgerExecutor inherits them).
        entry = ("advance_to", "speculate", "resolve")
        self._saved = [(cls, name, getattr(cls, name)) for cls, name in (
            *((HostLedgerExecutor, e) for e in entry), (BlockSource, "block"),
            (BlockSource, "sig_items"), (VerifyLauncher, "launch"),
            (TorchBatchVerifier, "verify_signatures"))]
        for name in entry:
            setattr(HostLedgerExecutor, name, _timed(
                self.spent, depth, "exec", getattr(HostLedgerExecutor, name)))
        BlockSource.block = _timed(self.spent, depth, "synth", BlockSource.block)
        BlockSource.sig_items = _timed(self.spent, depth, "txsign", register)
        VerifyLauncher.launch = counted
        TorchBatchVerifier.verify_signatures = verified

    def close(self) -> None:
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)


def _exec_run(label: str, **kw):
    """One n = 256 network with the execution layer on the card, timed and
    counted by an :class:`_ExecClock`; ``_sim_run`` checks safety and that
    no kernel but ``ed25519_verify`` launched."""
    clock = _ExecClock()
    try:
        sim, res, wall, launches = _sim_run(n=N_VALIDATORS, seed=1, sign=True,
                                            burst=True, device="cuda", **kw)
    finally:
        clock.close()
    if not res.completed:
        raise AssertionError(f"exec {label}: stalled at {res.heights}")
    return sim, res, wall, launches, clock


def phase_exec() -> None:
    """The execution layer on the card: the apply probe; leg A (sequential,
    a device executor a replica, 65,536 accounts, 16,384-tx blocks), every
    replica's commit record the value and the host executor's root; leg B
    (pipelined, speculative, signed: fused on the card, fused with the host
    executor, two-kind on the card), with rollbacks, no discarded root
    committed, equal commits, fewer verify launches fused, and
    ``ed25519_verify`` launched on the blocks' signature rows; leg C (leg
    B's signed blocks, sequential, a device executor a replica), the
    commits leg B's and each block verified once by ``ed25519_verify``,
    none by an executor; and a card executor without a height's
    signature verdicts refusing to verify them on the host."""
    from hyperdrive_tpu_torch.exec import ExecutionConfig
    from hyperdrive_tpu_torch.exec.device import DeviceLedgerExecutor
    from hyperdrive_tpu_torch.exec.ledger import HostLedgerExecutor

    print(card_line(), flush=True)
    phase_exec_probe()

    cfg = ExecutionConfig(device=True, **EXEC_LEG_A)
    sim, res, wall, launches, clock = _exec_run(
        "A", target_height=EXEC_A_HEIGHTS, dedup_verify=True, execution=cfg,
        dedup_exec=False)
    host = HostLedgerExecutor(sim._execution)
    roots = {h: host.advance_to(h) for h in range(1, EXEC_A_HEIGHTS + 1)}
    if not (len(sim._exec_unique) == N_VALIDATORS
            and all(isinstance(ex, DeviceLedgerExecutor) for ex in sim._exec_unique)):
        raise AssertionError("exec A: not one device executor a replica")
    for i, commits in enumerate(res.commits):
        for h in range(1, EXEC_A_HEIGHTS + 1):
            v = commits.get(h)
            if v is None or len(v) != 64 or v[32:] != roots[h]:
                raise AssertionError(f"exec A: replica {i} height {h}: record is not "
                                     f"the value and the host executor's root")
    if launches < sim.vote_settles:
        raise AssertionError(f"exec A: {launches} ed25519_verify launches for "
                             f"{sim.vote_settles} vote settles")
    synth = clock.spent.get("synth", 0.0)
    apply_s = clock.spent["exec"] - synth
    print(f"exec A sequential: n={N_VALIDATORS} accounts={cfg.accounts} "
          f"txs_per_block={cfg.txs_per_block} heights={EXEC_A_HEIGHTS} "
          f"executors={len(sim._exec_unique)} applies={N_VALIDATORS * EXEC_A_HEIGHTS} "
          f"steps={res.steps} wall_s={wall:.2f} "
          f"heights_per_s={EXEC_A_HEIGHTS / wall:.3f} apply_share={apply_s / wall:.3f} "
          f"synthesis_share={synth / wall:.4f} ed25519_verify_launches={launches} "
          f"roots_equal_host=True digest={res.commit_digest(up_to=EXEC_A_HEIGHTS)[:16]}",
          flush=True)

    runs = {}
    for label, device, fused in (("device+fused", True, True), ("host+fused", False, True),
                                 ("device+two_kind", True, False)):
        cfg = ExecutionConfig(device=device, **EXEC_LEG_B)
        sim, res, wall, launches, clock = _exec_run(
            label, target_height=EXEC_B_HEIGHTS, pipeline_heights=True, execution=cfg,
            fused_exec_drain=fused)
        ex = sim._exec_unique[0]
        committed = {v[32:] for c in res.commits for v in c.values()}
        if not (ex.spec_rolled_back > 0 and ex.discarded_roots
                and not ex.discarded_roots & committed):
            raise AssertionError(f"exec B {label}: rollbacks={ex.spec_rolled_back}, "
                                 f"or a discarded root was committed")
        if not (clock.exec_launches and clock.exec_kernels):
            raise AssertionError(f"exec B {label}: no ed25519_verify launch on the "
                                 f"blocks' signature rows")
        runs[label] = (res.commits, launches)
        print(f"exec B {label}: n={N_VALIDATORS} accounts={cfg.accounts} "
              f"txs_per_block={cfg.txs_per_block} heights={EXEC_B_HEIGHTS} "
              f"steps={res.steps} wall_s={wall:.2f} heights_per_s={EXEC_B_HEIGHTS / wall:.3f} "
              f"apply_share={(clock.spent['exec'] - clock.spent['synth']) / wall:.3f} "
              f"synthesis_share={clock.spent['synth'] / wall:.4f} "
              f"tx_sign_share={clock.spent.get('txsign', 0.0) / wall:.3f} "
              f"rolled_back={ex.spec_rolled_back} confirmed={ex.spec_confirmed} "
              f"discarded_roots={len(ex.discarded_roots)} discarded_committed=0 "
              f"queue_submitted={sim._sched.submitted} queue_launches={sim._sched.launches} "
              f"ed25519_verify_launches={launches} exec_rows={clock.exec_rows} "
              f"exec_row_launches={clock.exec_launches} "
              f"exec_row_kernel_launches={clock.exec_kernels} "
              f"digest={res.commit_digest(up_to=EXEC_B_HEIGHTS)[:16]}", flush=True)
        if res.commit_digest(up_to=EXEC_B_HEIGHTS)[:16] != EXEC_B_DIGEST:
            raise AssertionError(f"exec B {label}: digest differs from the JAX package's "
                                 f"{EXEC_B_DIGEST}")
    want = runs["device+fused"][0]
    if any(r[0] != want for r in runs.values()):
        raise AssertionError("exec B: commits differ across device/host or fused/two-kind")
    if not runs["device+fused"][1] < runs["device+two_kind"][1]:
        raise AssertionError(f"exec B: fused {runs['device+fused'][1]} verify launches, "
                             f"two-kind {runs['device+two_kind'][1]}")
    print(f"exec B: commits_equal=True fused_verify_launches={runs['device+fused'][1]} "
          f"two_kind_verify_launches={runs['device+two_kind'][1]}", flush=True)

    cfg = ExecutionConfig(device=True, **EXEC_LEG_B)
    sim, res, wall, launches, clock = _exec_run(
        "C", target_height=EXEC_A_HEIGHTS, dedup_verify=True, execution=cfg,
        dedup_exec=False)
    heights = range(1, EXEC_A_HEIGHTS + 1)
    if any(c.get(h) != w[h] for c, w in zip(res.commits, want) for h in heights):
        raise AssertionError("exec C: commits differ from leg B's")
    if not (len(sim._exec_unique) == N_VALIDATORS
            and all(isinstance(ex, DeviceLedgerExecutor) and ex._verifier is None
                    for ex in sim._exec_unique)):
        raise AssertionError("exec C: not one device executor a replica, or an "
                             "executor verified a block itself")
    if not (clock.exec_launches == EXEC_A_HEIGHTS
            and clock.exec_rows == EXEC_A_HEIGHTS * cfg.txs_per_block
            and clock.exec_kernels >= EXEC_A_HEIGHTS):
        raise AssertionError(f"exec C: {clock.exec_launches} verifies of "
                             f"{clock.exec_rows} block rows ({clock.exec_kernels} "
                             f"ed25519_verify launches), not one a block on the card")
    print(f"exec C sequential signed: n={N_VALIDATORS} accounts={cfg.accounts} "
          f"txs_per_block={cfg.txs_per_block} heights={EXEC_A_HEIGHTS} "
          f"executors={len(sim._exec_unique)} steps={res.steps} wall_s={wall:.2f} "
          f"heights_per_s={EXEC_A_HEIGHTS / wall:.3f} "
          f"apply_share={(clock.spent['exec'] - clock.spent['synth']) / wall:.3f} "
          f"tx_sign_share={clock.spent.get('txsign', 0.0) / wall:.3f} "
          f"ed25519_verify_launches={launches} exec_rows={clock.exec_rows} "
          f"exec_row_verifies={clock.exec_launches} "
          f"exec_row_kernel_launches={clock.exec_kernels} commits_equal_leg_B=True",
          flush=True)
    bare = DeviceLedgerExecutor(ExecutionConfig(**EXEC_LEG_B, stake_accounts=N_VALIDATORS))
    try:
        bare.advance_to(1)
    except RuntimeError as e:
        if "no admission mask" not in str(e):
            raise
    else:
        raise AssertionError("exec: a card executor verified a signed block on the host")


# ------------------------------------------------------------ BLS12-381

#: Committee widths of the JAX package's BLS bench (``benches/bls_bench.py``
#: ``AGG_SIZES``), its odd widths and its batched launcher shape.
BLS_SIZES = (256, 1024, 4096)
BLS_ODD = (5, 255)
#: The smallest widths (one lane; one addition; an odd tail on the first
#: level) and one above what a cluster's shared memory holds
#: (``g1_cuda.MAX_SHARED_WIDTH``), whose sums live in the global scratch.
BLS_SMALL = (1, 2, 3)
BLS_WIDE = 32_768
#: The recorded times (one wrapper call) of the kernel's earlier design
#: (one block a committee, 30 x 13-bit CIOS) at the bench widths, three
#: runs on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md section 6, row 5).
G1_EARLIER_MS = {256: (0.6337, 0.7054), 1024: (1.1814, 1.2082), 4096: (3.3593, 3.4238)}
BLS_BATCH, BLS_BATCH_WIDTH = 8, 256
BLS_PRODUCTS = 4096
#: The certified sim: n = 16 (every certifier signs each counted partial in
#: pure Python, ~12 ms a signature on one x86 CPU core, so n = 256 would
#: take minutes a height); the n = 256 committee runs through Certifier
#: directly.
BLS_SIM = dict(n=16, target_height=5, seed=1, sign=True, burst=True, dedup_verify=True,
               small_window_host=False)
BLS_CERT_N = 256
#: Multiply instructions of a product of a 12 x 32-bit word field (2 * 12^2
#: for a * b, 2 * 12^2 for m * p, 12 for m), products a complete addition,
#: bytes a lane in (three 30-limb int32 coordinates and the mask word) and
#: a committee out.
G1_IMAD_PER_PRODUCT = 2 * 12 * 12 * 2 + 12
G1_PRODUCTS_PER_ADD = 12
G1_LANE_BYTES, G1_OUT_BYTES = 3 * 30 * 4 + 4, 3 * 30 * 4


def g1_bound_ms(selected, lanes: int, clock_mhz: float, sms: int):
    """(bound ms, bound_by) of masked sums: k - 1 complete additions for a
    committee with k selected lanes (what this run's masks need), each 12
    products, at the cc 9.0 multiply rate; or each input lane read once and
    each committee's sum written once, at the memory rate."""
    n_ops = sum(max(int(k) - 1, 0) for k in selected) * G1_PRODUCTS_PER_ADD \
        * G1_IMAD_PER_PRODUCT
    ops = n_ops / (sms * IMAD_PER_SM_CLOCK * clock_mhz * 1e6)
    byt = (lanes * G1_LANE_BYTES + len(selected) * G1_OUT_BYTES) / HBM_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= byt else (byt * 1e3, "bytes")


def derive_g1_points(n: int) -> list:
    """n distinct G1 points by a doubling/adding chain from the generator
    (``bls_bench._derive_points``)."""
    from hyperdrive_tpu_torch.crypto import bls

    pts, p = [], bls.G1_GEN
    for i in range(n):
        p = bls.g1_double(p) if i % 3 else bls.g1_add(p, bls.G1_GEN)
        pts.append(p)
    return pts


def _g1_compare(label: str, points_rows, masks: np.ndarray, timed: bool = False):
    """g1_aggregate against the plain aggregate_kernel on the card on one
    [B, N] batch: every coordinate equal after canonical, every affine sum
    equal to the oracle's fold. Returns (max difference after canonical,
    kernel ms, plain ms, affine sums, limbs equal: False where the
    kernel's canonical limbs differ from the plain version's redundant
    ones)."""
    from hyperdrive_tpu_torch.crypto import bls
    from hyperdrive_tpu_torch.ops import fp381 as fp
    from hyperdrive_tpu_torch.ops import g1

    coords = [np.stack([g1.pack_points(r)[c] for r in points_rows]) for c in range(3)]
    args = g1.from_reference(coords + [masks.astype(np.int32)], "cuda")
    got = g1.g1_aggregate(*args)
    p_ms = time_ms(lambda: g1.aggregate_kernel(*args), 1, warm=False, keep=(out := []))
    want = out[0]
    err = max(int((fp.canonical(a) - fp.canonical(b)).abs().max()) for a, b in zip(got, want))
    limbs_equal = all(torch.equal(a, b) for a, b in zip(got, want))
    sums = g1.unpack_points(got[0][:, 0], got[1][:, 0], got[2][:, 0])
    folds = [bls.aggregate_signatures([p for p, m in zip(r, row) if m])
             for r, row in zip(points_rows, masks)]
    if err or sums != folds:
        raise AssertionError(f"bls {label}: kernel != plain (max {err}) or != the oracle")
    k_ms = None
    if timed:
        k_ms = {"call": time_ms(lambda: g1.g1_aggregate(*args), 5),
                "alone": _g1_alone_ms(args, got)}
    return err, k_ms, p_ms, sums, limbs_equal


def _g1_alone_ms(args, want) -> float:
    """The g1_aggregate kernel alone: 100 back-to-back ``hd_g1_aggregate``
    calls through the library on pre-made outputs (and scratch), between
    two CUDA events; their outputs must equal ``want``, the wrapper's."""
    from hyperdrive_tpu_torch.ops import g1_cuda

    px, py, pz, mask = args
    bsz, n, _ = px.shape
    index = torch.cuda.current_device()
    lib = g1_cuda._library(index)
    outs = [torch.empty_like(w) for w in want]
    words = g1_cuda.scratch_words(n)
    scratch = torch.empty(bsz * words, dtype=torch.int32, device="cuda") if words else None
    call = (index, px.data_ptr(), py.data_ptr(), pz.data_ptr(), mask.data_ptr(), bsz, n,
            None if scratch is None else scratch.data_ptr(),
            *(o.data_ptr() for o in outs), torch.cuda.current_stream().cuda_stream)

    def direct():
        if lib.hd_g1_aggregate(*call) != 0:
            raise AssertionError("hd_g1_aggregate launch failed")

    ms, _ = burst_ms(direct)
    if not all(torch.equal(o, w) for o, w in zip(outs, want)):
        raise AssertionError("direct hd_g1_aggregate calls != the wrapper's")
    return ms


#: ``phase_cli``'s campaign shape: the reference CLI's families at 64
#: validators (committee 16, 4 attackers, 2 epochs of 2 waves).
def phase_cli() -> dict:
    """The ported CLIs on the card (lines ``cli``): each ``main(argv)`` in
    process with the default ``--device`` (the card), at small shapes and
    ``campaign run`` at the CLI's defaults; exit
    code 0 and every "ok" line of the reference; the launches of rows 1
    (``ed25519_verify``) and 5 (``g1_aggregate``) a CLI, counted from 0
    just before it. ``exec parity``'s signed legs must verify on the card:
    no ``HostVerifier`` call in it. Returns the launches by row."""
    import contextlib
    import io
    import shutil
    import tempfile

    from hyperdrive_tpu_torch.campaign.__main__ import main as campaign_main
    from hyperdrive_tpu_torch.chaos.__main__ import main as chaos_main
    from hyperdrive_tpu_torch.exec.__main__ import main as exec_main
    from hyperdrive_tpu_torch.obs.__main__ import main as obs_main
    from hyperdrive_tpu_torch.ops import ed25519_cuda, g1_cuda
    from hyperdrive_tpu_torch.ops.__main__ import main as ops_main
    from hyperdrive_tpu_torch.parallel.__main__ import main as parallel_main
    from hyperdrive_tpu_torch.verifier import HostVerifier

    launches = {"ed25519_verify": 0, "g1_aggregate": 0}
    host_calls = []
    real_host = HostVerifier.verify_signatures

    def host_spy(self, items):
        host_calls.append(len(items))
        return real_host(self, items)

    def run(name, main, argv, oks=(), need=()):
        """One CLI: its stdout, after checking its exit code, its "ok"
        lines (``oks``: substrings each of some line) and the rows in
        ``need`` launched."""
        ed25519_cuda.reset_stats()
        g1_cuda.reset_stats()
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"ed25519_verify": ed25519_cuda.stats["ed25519_verify"].launches,
               "g1_aggregate": g1_cuda.stats["g1_aggregate"].launches}
        text = out.getvalue()
        missing = [k for k in oks if k not in text]
        if rc != 0 or missing:
            raise AssertionError(f"cli {name}: rc={rc} missing {missing}\n{text}\n"
                                 f"{err.getvalue()}")
        for row in need:
            if not got[row]:
                raise AssertionError(f"cli {name}: {row} launched no time")
        for row in launches:
            launches[row] += got[row]
        print(f"cli {name}: rc=0 ok_lines={len(oks)} wall_s={wall:.3f} "
              f"ed25519_verify_launches={got['ed25519_verify']} "
              f"g1_aggregate_launches={got['g1_aggregate']}", flush=True)
        return text

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "hyperdrive_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli-", dir=build)
    t_phase = time.perf_counter()
    try:
        def path(name):
            return os.path.join(tmp, name)

        # obs: the pipelined sim's registry on the card, then the host tools
        # on what it and a recorded run wrote.
        text = run("obs metrics --pipeline", obs_main,
                   ["metrics", "--pipeline", "--replicas", "4", "--heights", "5",
                    "-o", path("snap.json"), "--prometheus", path("metrics.prom")],
                   ['"completed": true'], need=("ed25519_verify",))
        snap = json.loads(open(path("snap.json")).read())
        if snap["counters"].get("devtel.launches", 0) < 1:
            raise AssertionError(f"cli obs metrics: devtel.launches missing ({text})")
        run("obs record", obs_main, ["record", "-o", path("journal.json")],
            ['"completed": true'])
        run("obs report", obs_main, ["report", path("journal.json")], ["commits ·"])
        run("obs export", obs_main, ["export", path("journal.json"), "-o",
                                     path("trace.json")], ['"trace": '])
        run("obs benchdiff", obs_main, ["benchdiff", path("snap.json"), path("snap.json")],
            ["PASS"])

        # campaign: the three families on the card at the CLI's defaults
        # (1,024 validators), equal to the CPU run; the storm's dump replayed.
        argv = ["run", "--family", "all", "--dump-ok", path("dumps")]
        text = run("campaign run", campaign_main, argv,
                   ["campaign storm", "campaign capture", "campaign coincidence"],
                   need=("ed25519_verify",))
        if text.count(" ok\n") != 3:
            raise AssertionError(f"cli campaign run: not three clean families\n{text}")
        with contextlib.redirect_stdout(io.StringIO()) as cpu_out:
            campaign_main(argv[:-1] + [path("dumps-cpu"), "--device", "cpu"])
        if cpu_out.getvalue().replace("dumps-cpu", "dumps") != text:
            raise AssertionError("cli campaign run: the card's stdout differs from the CPU's")
        storm = next(f for f in sorted(os.listdir(path("dumps")))
                     if f.startswith("campaign-storm") and f.endswith(".bin"))
        run("campaign replay", campaign_main,
            ["replay", os.path.join(path("dumps"), storm)], ["digest-identical"],
            need=("ed25519_verify",))

        # ops: the MSM with the RLC leg (row 1), BLS at 8 lanes (row 5).
        run("ops msm-parity --rlc", ops_main, ["msm-parity", "--rlc"],
            ["ok msm-kernel", "ok rlc-msm", "msm parity ok"], need=("ed25519_verify",))
        run("ops bls-parity", ops_main, ["bls-parity", "--n", "8"],
            ["ok fp381-mul", "ok g1-msm", "ok g1-aggregate", "ok bls-e2e", "bls parity ok"],
            need=("g1_aggregate",))

        # exec: the signed legs' masks from the card, none from the host.
        HostVerifier.verify_signatures = host_spy
        try:
            run("exec parity --pipelined", exec_main, ["parity", "--pipelined"],
                ["ok exec-apply", "ok exec-signed", "ok exec-insolvent", "ok exec-pipelined:",
                 "ok exec-pipelined-signed", "exec parity ok"], need=("ed25519_verify",))
        finally:
            HostVerifier.verify_signatures = real_host
        if host_calls:
            raise AssertionError(f"cli exec parity: {len(host_calls)} host verifications")
        run("exec prove", exec_main, ["prove"], ["ok prove", "exec prove ok"])

        # parallel: the multi-tenant service on its default verifier (the
        # card), one remote tenant in a child process over TCP; --parity
        # re-runs every tenant on a dedicated service and holds the commit
        # digests equal.
        text = run("parallel serve", parallel_main,
                   ["serve", "--tenants", "4", "--heights", "4", "--remote-tenants", "1",
                    "--parity", "--json"], ['"completed": true', '"parity_ok": true'],
                   need=("ed25519_verify",))
        summary = json.loads(text)
        child = summary["remote"]["children"]
        if (len(child) != 1 or not child[0]["done"] or summary["launches"] < 1
                or summary["verifier"] != "device" or not summary["parity_ok"]):
            raise AssertionError(f"cli parallel serve: {summary}")

        # chaos: the soak with every leg at cadence 1 or 2 on the card (the
        # BLS overlay leg folds through row 5, the exec-pipeline leg
        # verifies through row 1), its stdout equal to the CPU run's once
        # paths and the metrics scrape's size (wall-clock latencies) are
        # masked; the same soak armed (HD_SANITIZE=1); a replay of the
        # passing churn record it dumped.
        def soak_argv(tag):
            return ["soak", "--scenarios", "2", "--n", "4", "--target", "3",
                    "--replay-every", "1", "--pipelined-every", "1", "--certs-every", "1",
                    "--overload-every", "1", "--bls-certs-every", "2", "--churn-every", "1",
                    "--overlay-every", "2", "--tenants-every", "2", "--exec-every", "2",
                    "--exec-pipeline-every", "1", "--proofs-every", "2",
                    "--fuzz-frames-every", "2", "--metrics-every", "2",
                    "--campaign-every", "2", "--out", path(f"chaos-{tag}"),
                    "--dump-ok", path(f"chaos-ok-{tag}")]

        def masked(text, tag):
            text = text.replace(path(f"chaos-ok-{tag}"), "<ok>")
            return re.sub(r"(ok metrics .* )bytes=\d+", r"\1bytes=<n>", text)

        chaos_oks = ["ok bls", "ok overload", "ok tenants", "ok proofs", "ok churn",
                     "ok overlay", "ok exec ", "ok wire-fuzz", "ok metrics",
                     "ok exec-pipeline", "ok campaign", "soak ok: 2 scenarios, 0 violations"]
        text = run("chaos soak", chaos_main, soak_argv("card"), chaos_oks,
                   need=("ed25519_verify", "g1_aggregate"))
        with contextlib.redirect_stdout(io.StringIO()) as cpu_out:
            rc = chaos_main(soak_argv("cpu") + ["--device", "cpu"])
        if rc != 0 or masked(cpu_out.getvalue(), "cpu") != masked(text, "card"):
            raise AssertionError(f"cli chaos soak: the card's stdout differs from the "
                                 f"CPU's (rc={rc})\n{cpu_out.getvalue()}\n{text}")
        with _armed():
            armed = run("chaos soak (HD_SANITIZE=1)", chaos_main, soak_argv("armed"),
                        chaos_oks, need=("ed25519_verify", "g1_aggregate"))
        if masked(armed, "armed") != masked(text, "card"):
            raise AssertionError(f"cli chaos soak: the armed stdout differs\n{armed}")
        text = run("chaos replay", chaos_main,
                   ["replay", os.path.join(path("chaos-ok-card"), "churn_seed_1.bin")],
                   ["replayed seed=1 n=4", "epoch chain ok"])
        print(f"cli chaos: rc=0 cpu_stdout_equal=True armed_stdout_equal=True "
              f"replay={text.splitlines()[0]!r}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"cli: wall_s={time.perf_counter() - t_phase:.3f} "
          f"ed25519_verify_launches={launches['ed25519_verify']} "
          f"g1_aggregate_launches={launches['g1_aggregate']}", flush=True)
    return launches


def phase_entry() -> dict:
    """The entry points of ``entry.py`` on the card (lines ``entry``):
    ``entry()``'s step on signed votes, held lane for lane and count for
    count to the same step with ``device="cpu"`` (the plain version), in
    one counted row-2 launch and no other; then ``dryrun_multichip(1)`` over
    NCCL at world size 1 with its launches of rows 1, 4 and 3. Returns the
    launches by row."""
    import torch.distributed as dist

    from hyperdrive_tpu_torch.entry import dryrun_multichip, entry, signed_example_args
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    t_phase = time.perf_counter()
    fn, example = entry()
    if any(t.device.type != "cuda" for t in example[:6]):
        raise AssertionError("entry: the example args are not on the card")
    zeros = fn(*example)[0]
    if bool(zeros.any()):
        raise AssertionError("entry: an all-zero lane verified")
    args, _ = signed_example_args()
    cpu_args, _ = signed_example_args(device="cpu")
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    t0 = time.perf_counter()
    ok, counts, flags = fn(*args)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    got = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
    if got != {"ed25519_wire": 1}:
        raise AssertionError(f"entry: launches {got}, want one ed25519_wire")
    want_ok, want_counts, want_flags = entry(device="cpu")[0](*cpu_args)
    same = (torch.equal(ok.cpu(), want_ok)
            and all(torch.equal(counts[k].cpu(), want_counts[k]) for k in want_counts)
            and all(torch.equal(flags[k].cpu(), want_flags[k]) for k in want_flags))
    if not same or counts["matching"].tolist() != [31, 20]:
        raise AssertionError(f"entry: the card's step differs from the CPU's: "
                             f"{counts} {flags}")
    launches = dict(got)
    print(f"entry step: lanes={ok.numel()} verified={int(ok.sum())} "
          f"matching={counts['matching'].tolist()} "
          f"quorum_matching={flags['quorum_matching'].tolist()} "
          f"ed25519_wire_launches=1 wall_ms={step_ms:.3f} equal_to_cpu=True", flush=True)

    started = not dist.is_initialized()
    ed25519_cuda.reset_stats()
    t0 = time.perf_counter()
    try:
        line = dryrun_multichip(1)
        torch.cuda.synchronize()
        backend = dist.get_backend()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    wall = time.perf_counter() - t0
    got = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
    for row in ("ed25519_verify", "ed25519_challenge", "ed25519_semiwire"):
        if not got.get(row):
            raise AssertionError(f"entry dryrun: {row} launched no time ({got})")
        launches[row] = launches.get(row, 0) + got[row]
    if backend != "nccl":
        raise AssertionError(f"entry dryrun: ran on {backend}, not NCCL")
    print(f"entry dryrun: backend={backend} world_size=1 wall_s={wall:.3f} "
          + " ".join(f"{k}_launches={n}" for k, n in sorted(got.items())), flush=True)
    print(f"entry: wall_s={time.perf_counter() - t_phase:.3f} "
          + " ".join(f"{k}_launches={n}" for k, n in sorted(launches.items()))
          + f" card={card_line()!r}", flush=True)
    if not line.startswith("dryrun_multichip ok: mesh=(1x1)"):
        raise AssertionError(f"entry dryrun: {line}")
    return launches


def phase_bls(clock_mhz: float, sms: int):
    """BLS12-381 on the card: fp381.mul against Python ints; the g1_aggregate
    kernel against its plain version at the bench's widths, edge lanes, odd
    widths and the batched launcher; g1_msm_kernel against the oracle; the
    n = 256 certificate on the kernel and the host fold; the certified
    n = 16 sim, its counts zeroed before it and read after. Returns the
    kernel's rows by width and its launches on the sim."""
    from hyperdrive_tpu_torch.certificates import (
        Certifier, certificate_size, verify_bls_certificate,
    )
    from hyperdrive_tpu_torch.crypto import bls
    from hyperdrive_tpu_torch.devsched.queue import DeviceWorkQueue
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519_cuda, g1, g1_cuda
    from hyperdrive_tpu_torch.ops import fp381 as fp
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.verifier import HostVerifier

    print(f"bls card: {card_line()}", flush=True)
    rng = np.random.default_rng(SEED + 13)

    # 1. The field product against Python ints.
    xs = [int.from_bytes(rng.bytes(48), "little") % fp.P_INT for _ in range(BLS_PRODUCTS)]
    ys = [int.from_bytes(rng.bytes(48), "little") % fp.P_INT for _ in range(BLS_PRODUCTS)]
    a, b = (fp.from_reference(fp.to_mont(v), "cuda") for v in (xs, ys))
    prod = fp.mul(a, b)
    if fp.from_mont(prod) != [x * y % fp.P_INT for x, y in zip(xs, ys)]:
        raise AssertionError("bls: fp381.mul on the card != Python ints")
    if not torch.equal(prod.cpu(), fp.mul(a.cpu(), b.cpu())):
        raise AssertionError("bls: fp381.mul on the card != on the CPU, limb for limb")
    mul_ms = time_ms(lambda: fp.mul(a, b), 5)
    mul_bound = BLS_PRODUCTS * G1_IMAD_PER_PRODUCT / (sms * IMAD_PER_SM_CLOCK * clock_mhz * 1e3)
    print(f"programs: bls fp381.mul products={BLS_PRODUCTS} equals_python_ints=True "
          f"limbs_equal_cpu=True ms={mul_ms:.4f} bound_ms={mul_bound:.6f} "
          f"bound_by=operations bound_share={mul_bound / mul_ms:.6f} "
          f"cuda_kernels_per_call={_kernels_per_call(lambda: fp.mul(a, b))}", flush=True)

    # 2-3. The kernel against its plain version, with times and bounds.
    pts = derive_g1_points(max(*BLS_SIZES, BLS_BATCH * BLS_BATCH_WIDTH))
    rows, worst = {}, 0
    for width in BLS_SIZES:
        mask = (rng.random((1, width)) < 2 / 3).astype(np.int32)
        err, k_ms, p_ms, _, same = _g1_compare(f"{width} lanes", [pts[:width]], mask,
                                               timed=True)
        sel = [p for p, m in zip(pts[:width], mask[0]) if m]
        t0 = time.perf_counter()
        bls.aggregate_signatures(sel)
        host_s = time.perf_counter() - t0
        b_ms, b_by = g1_bound_ms(mask.sum(axis=1), width, clock_mhz, sms)
        rows[width] = {"ms": k_ms["alone"], "call_ms": k_ms["call"], "plain_ms": p_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "err": err}
        worst = max(worst, err)
        print(f"kernel g1_aggregate: lanes={width} selected={len(sel)} "
              f"blocks={g1_cuda.CLUSTER} cluster={g1_cuda.CLUSTER} "
              f"sums_in={'global' if g1_cuda.scratch_words(width) else 'shared'} "
              f"kernel_ms={k_ms['alone']:.4f} wrapper_call_ms={k_ms['call']:.4f} "
              f"plain_ms={p_ms:.2f} host_fold_s={host_s:.4f} "
              f"bound_ms={b_ms:.6f} bound_by={b_by} bound_share={b_ms / k_ms['alone']:.6f} "
              f"equal_after_canonical=True limbs_equal={same} equals_oracle=True",
              flush=True)
    # The earlier design was timed as one wrapper call between two events:
    # wrapper_call_ms is the like-for-like figure, kernel_ms (back-to-back
    # launches) the kernel's own.
    print("redesign: g1_aggregate over the earlier design's recorded times (one block a "
          "committee): "
          + " ".join(f"lanes={w} kernel_ms={rows[w]['ms']:.4f} "
                     f"wrapper_call_ms={rows[w]['call_ms']:.4f} earlier_ms={lo}-{hi} "
                     f"kernel_ratio={rows[w]['ms'] / hi:.4f}-{rows[w]['ms'] / lo:.4f} "
                     f"call_ratio={rows[w]['call_ms'] / hi:.4f}-{rows[w]['call_ms'] / lo:.4f}"
                     for w, (lo, hi) in G1_EARLIER_MS.items()), flush=True)
    args256 = g1.from_reference(
        [c[None] for c in g1.pack_points(pts[:256])] + [np.ones((1, 256), np.int32)], "cuda")
    print(f"programs: bls aggregate_kernel (plain) lanes=256 cuda_kernels_per_call="
          f"{_kernels_per_call(lambda: g1.aggregate_kernel(*args256))}", flush=True)

    # Edge lanes in one batch: all masked out, identity rows, P and -P, P twice.
    w = BLS_BATCH_WIDTH
    edge_rows = [pts[:w],
                 [None if i % 4 == 0 else p for i, p in enumerate(pts[:w])],
                 [bls.g1_neg(pts[i // 2]) if i % 2 else pts[i // 2] for i in range(w)],
                 [pts[i // 2] for i in range(w)]]
    edge_masks = np.ones((4, w), np.int32)
    edge_masks[0] = 0
    edge_masks[2, 5] = 0  # one unpaired lane
    err, _, _, sums, _ = _g1_compare("edges", edge_rows, edge_masks)
    worst = max(worst, err)
    if sums[0] is not None:
        raise AssertionError("bls edges: an all-masked committee is not the identity")
    for width in BLS_ODD:
        mask = (rng.random((1, width)) < 2 / 3).astype(np.int32)
        worst = max(worst, _g1_compare(f"odd {width}", [pts[:width]], mask)[0])
    for width in BLS_SMALL:  # all set, and one lane set
        masks = np.ones((2, width), np.int32)
        masks[1, :-1] = 0
        worst = max(worst, _g1_compare(f"width {width}", [pts[:width]] * 2, masks)[0])
    # Above the cluster's shared memory: the sums in the global scratch.
    if g1_cuda.scratch_words(BLS_WIDE) == 0:
        raise AssertionError(f"bls: {BLS_WIDE} lanes fit in shared memory; pick a wider width")
    wide = derive_g1_points(BLS_WIDE)
    mask = (rng.random((1, BLS_WIDE)) < 2 / 3).astype(np.int32)
    err, w_ms, wp_ms, _, _ = _g1_compare(f"{BLS_WIDE} lanes", [wide], mask, timed=True)
    worst = max(worst, err)
    wb_ms, wb_by = g1_bound_ms(mask.sum(axis=1), BLS_WIDE, clock_mhz, sms)
    print(f"kernel g1_aggregate: lanes={BLS_WIDE} selected={int(mask.sum())} "
          f"blocks={g1_cuda.CLUSTER} cluster={g1_cuda.CLUSTER} sums_in=global "
          f"max_shared_width={g1_cuda.MAX_SHARED_WIDTH} kernel_ms={w_ms['alone']:.4f} "
          f"wrapper_call_ms={w_ms['call']:.4f} plain_ms={wp_ms:.2f} bound_ms={wb_ms:.6f} "
          f"bound_by={wb_by} bound_share={wb_ms / w_ms['alone']:.6f} "
          f"equal_after_canonical=True equals_oracle=True", flush=True)
    # The batched launcher: 8 committees of 256 lanes, one drain, one launch.
    payloads = [pts[i::BLS_BATCH][: w - BLS_BATCH + i] for i in range(BLS_BATCH)]
    batch_masks = np.zeros((BLS_BATCH, w), np.int32)
    for i, pl in enumerate(payloads):
        batch_masks[i, : len(pl)] = 1
    padded = [pl + [None] * (w - len(pl)) for pl in payloads]
    worst = max(worst, _g1_compare("batched", padded, batch_masks)[0])
    queue = DeviceWorkQueue()
    launcher = g1.G1SumLauncher(width=w, device="cuda")
    g1_cuda.reset_stats()
    futs = [queue.submit(launcher, pl) for pl in payloads]
    queue.drain()
    got = [f.result() for f in futs]
    if (launcher.launched, g1_cuda.stats["g1_aggregate"].launches) != (1, 1) or got != [
            bls.aggregate_signatures(pl) for pl in payloads]:
        raise AssertionError("bls: G1SumLauncher did not fold 8 payloads in one launch")
    rows["edges"] = {"err": worst}
    print(f"bls edges: all_masked=identity identity_rows P_minus_P P_twice odd_widths="
          f"{','.join(map(str, BLS_ODD))} small_widths={','.join(map(str, BLS_SMALL))} "
          f"wide={BLS_WIDE} batched={BLS_BATCH}x{w} (G1SumLauncher: 1 "
          f"launch for {BLS_BATCH} payloads) equal_after_canonical=True "
          f"equals_oracle=True max_abs_err={worst}", flush=True)

    # 4. The MSM (PyTorch ops), 8 lanes, a zero scalar and an identity point.
    msm_pts = pts[:7] + [None]
    ks = [int.from_bytes(rng.bytes(32), "little") % bls.R_ORDER for _ in range(8)]
    ks[0] = 0
    mx, my, mz = g1.from_reference(g1.pack_points(msm_pts), "cuda")
    (digits,) = g1.from_reference([g1.recode_scalars(ks)], "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    msum = g1.g1_msm_kernel(mx, my, mz, digits)
    torch.cuda.synchronize()
    msm_s = time.perf_counter() - t0
    acc = None
    for p, k in zip(msm_pts, ks):
        acc = bls.g1_add(acc, bls.g1_mul(p, k))
    if g1.unpack_points(*msum)[0] != acc:
        raise AssertionError("bls: g1_msm_kernel != the oracle's sum of g1_mul")
    print(f"programs: bls g1_msm_kernel lanes=8 windows={g1.G1_WINDOWS} wall_s={msm_s:.2f} "
          f"equals_oracle=True", flush=True)

    # 5. The n = 256 certificate, on the kernel and on the host fold.
    class _CachedSigner:
        # Bench set-up (benches/bls_bench.py bench_certificates): every
        # counted signer shares one of two keys and signs one message.
        def __init__(self, kp):
            self._kp, self._sigs = kp, {}
            self.pk_bytes = kp.pk_bytes

        def sign(self, msg):
            if msg not in self._sigs:
                self._sigs[msg] = self._kp.sign(msg)
            return self._sigs[msg]

    signers = [_CachedSigner(bls.bls_keypair_from_identity(b"bls-bench-%d" % i))
               for i in range(2)]
    n = BLS_CERT_N
    ids = [bytes([i & 0xFF, i >> 8]) * 16 for i in range(n)]
    keyring = {s: signers[1 - i % 2] for i, s in enumerate(ids)}
    quorum = 2 * ((n - 1) // 3) + 1
    certs = {}
    for label, fold in (("kernel", lambda parts: g1.aggregate_points(
            parts, width=n, device="cuda")), ("host", None)):
        c = Certifier(ids, (n - 1) // 3, transcript_source=lambda: b"\x5a" * 32,
                      bls_keyring=keyring, bls_aggregate_fn=fold)
        t0 = time.perf_counter()
        certs[label] = c.observe_commit(3, 0, b"block", ids[:quorum])
        certs[label + "_s"] = time.perf_counter() - t0
    cert = certs["kernel"]
    t0 = time.perf_counter()
    ok = verify_bls_certificate(cert, c.bls_pubkeys(), quorum)
    verify_s = time.perf_counter() - t0
    forged = verify_bls_certificate(dataclasses.replace(cert, height=cert.height + 1),
                                    c.bls_pubkeys(), quorum)
    if (cert.agg_sig != certs["host"].agg_sig or cert.binding != certs["host"].binding
            or not ok or forged
            or certificate_size(n, with_bls=True) != certificate_size(n) + 48):
        raise AssertionError("bls cert: kernel != host fold, or the light-client check failed")
    print(f"bls cert: n={n} quorum={quorum} agg_sig_equal_host=True "
          f"mint_kernel_s={certs['kernel_s']:.4f} mint_host_s={certs['host_s']:.4f} "
          f"light_client_verify_s={verify_s:.2f} verified=True forged_rejected=True "
          f"size_bytes={certificate_size(n, with_bls=True)} "
          f"plain_size_bytes={certificate_size(n)}", flush=True)

    # 6. The certified sim on the card against the host run.
    t0 = time.perf_counter()
    host_sim = Simulation(**BLS_SIM, batch_verifier=HostVerifier(), bls_certificates=True)
    host = host_sim.run(max_steps=20_000_000)
    host_wall = time.perf_counter() - t0
    sim = Simulation(**BLS_SIM, batch_verifier=TorchBatchVerifier(device="cuda"),
                     bls_certificates="device", device="cuda")
    spent = {"agg": 0.0, "bls": 0.0, "calls": 0}

    def timed(fn, key):
        def call(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                spent[key] += time.perf_counter() - t
                spent["calls"] += key == "agg"
        return call

    for c in sim.certifiers:
        c._bls_aggregate_fn = timed(c._bls_aggregate_fn, "agg")
        c._bls_aggregate = timed(c._bls_aggregate, "bls")
    sim.batch_verifier.warmup()
    torch.cuda.synchronize()
    ed25519_cuda.reset_stats()
    g1_cuda.reset_stats()
    t0 = time.perf_counter()
    res = sim.run(max_steps=20_000_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    agg_launches = g1_cuda.stats["g1_aggregate"].launches
    verify_launches = ed25519_cuda.stats["ed25519_verify"].launches
    others = {k: v.launches for k, v in ed25519_cuda.stats.items()
              if k != "ed25519_verify" and v.launches}
    res.assert_safety()
    minted = sum(len(c.certs) for c in sim.certifiers)
    heights = BLS_SIM["target_height"]
    if not res.completed or (res.commit_digest(up_to=heights), res.steps) != (
            host.commit_digest(up_to=heights), host.steps):
        raise AssertionError("bls sim: digest or steps differ from the host run")
    if len(set(res.cert_digests)) != 1 or res.cert_digests != host.cert_digests:
        raise AssertionError("bls sim: chain digests differ across replicas or from the "
                             "host fold's run")
    if others or verify_launches < sim.vote_settles or not (
            agg_launches == spent["calls"] == minted == BLS_SIM["n"] * heights):
        raise AssertionError(f"bls sim: g1_aggregate {agg_launches} launches for {minted} "
                             f"certificates, ed25519_verify {verify_launches}, others "
                             f"{others}")
    pks = sim.certifiers[0].bls_pubkeys()
    for h in range(1, heights + 1):
        cert = sim.certifiers[h % BLS_SIM["n"]].certs[h]
        if len(cert.agg_sig) != 48 or not verify_bls_certificate(cert, pks, 2 * sim.f + 1):
            raise AssertionError(f"bls sim: height {h}'s certificate fails verification")
    print(f"bls sim: n={BLS_SIM['n']} heights={heights} steps={res.steps} "
          f"wall_s={wall:.2f} heights_per_s={heights / wall:.3f} "
          f"host_run_wall_s={host_wall:.2f} certificates={minted} "
          f"g1_aggregate_launches={agg_launches} ed25519_verify_launches={verify_launches} "
          f"vote_settles={sim.vote_settles} aggregate_share={spent['agg'] / wall:.4f} "
          f"bls_share={spent['bls'] / wall:.4f} reverified_heights={heights} "
          f"chain_equals_host=True digest={res.commit_digest(up_to=heights)[:16]} "
          f"matches_host=True", flush=True)
    return rows, agg_launches


# ------------------------------------------------------------ observability

#: Journal kinds only a device verifier emits: its device-to-host copies
#: and its per-launch occupancy. An observed card run and an observed host
#: run of the same network journal everything else event for event.
OBS_DEVICE_KINDS = ("fetch.sync", "verify.occupancy.rows", "verify.occupancy.lanes",
                    "verify.occupancy.pct")
#: Drains a width of the wall-split leg, and the widths (lanes).
OBS_DRAINS = 20
OBS_WIDTHS = (256, 4096)


def _events_digest(events) -> str:
    """``Recorder.digest()`` of an event list (the same canonical JSON)."""
    blob = json.dumps([list(ev) for ev in events], separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def _observed_packed(observe: bool, ref: dict) -> dict:
    """One main-path run on a card ``TorchBatchVerifier``, observed or
    not, with the kernel counts set to 0 just before it and read just
    after, and the device-to-host copies of its verifier counted apart
    from the recorder (a wrapper on the verifier module's
    ``device_fetch`` that counts CUDA tensors)."""
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import ed25519 as ed
    from hyperdrive_tpu_torch.ops import ed25519_cuda

    verifier = ed.TorchBatchVerifier(device="cuda")
    verifier.warmup()
    torch.cuda.synchronize()
    sim = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True, burst=True,
                     dedup_verify=True, small_window_host=False, batch_verifier=verifier,
                     observe=observe)
    fetches: list = []
    real = ed.device_fetch

    def counting(x, *, why=""):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            fetches.append(why)
        return real(x, why=why)

    ed.device_fetch = counting
    try:
        ed25519_cuda.reset_stats()
        t0 = time.perf_counter()
        res = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ed25519_cuda.stats["ed25519_verify"].launches
        moved = {k: v.launches for k, v in ed25519_cuda.stats.items()
                 if k != "ed25519_verify" and v.launches}
    finally:
        ed.device_fetch = real
    label = "observed" if observe else "unobserved"
    if res.commit_digest(up_to=HEIGHT) != ref["digest"] or (
            res.steps, res.heights) != (ref["steps"], ref["heights"]):
        raise AssertionError(f"obs {label}: the run left the host run's chain")
    if (sim.settle_passes, sim.vote_settles, sim.verified_sigs) != MAIN_SETTLES:
        raise AssertionError(
            f"obs {label}: settles/vote_settles/verified_sigs = "
            f"{(sim.settle_passes, sim.vote_settles, sim.verified_sigs)}, "
            f"want {MAIN_SETTLES}")
    if moved or launches < sim.vote_settles:
        raise AssertionError(f"obs {label}: {launches} ed25519_verify launches for "
                             f"{sim.vote_settles} vote settles, other kernels {moved}")
    return {"sim": sim, "res": res, "wall": wall, "launches": launches,
            "fetches": fetches}


def phase_obs(ref: dict) -> None:
    """Observability on the card (lines ``obs``): (1) the main path
    observed on the packed route against an observed ``HostVerifier``
    run, and observed against unobserved walls in turns; (2) the
    pipelined route observed under ``utils.trace.profile``, one launch
    record a kernel launch; (3) a ``DeviceWorkQueue`` with wall-clock
    launch telemetry at 256 and 4,096 lanes, its pack / dispatch / sync /
    unpack split; (4) the profiler's Chrome trace and the journal's
    Perfetto export. ``ref`` is the main path's host run."""
    import shutil
    import tempfile

    from hyperdrive_tpu_torch import obs as hobs
    from hyperdrive_tpu_torch.crypto.keys import KeyRing
    from hyperdrive_tpu_torch.devsched import DeviceWorkQueue
    from hyperdrive_tpu_torch.harness import Simulation
    from hyperdrive_tpu_torch.ops import bucketing, ed25519_cuda
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.utils.trace import profile
    from hyperdrive_tpu_torch.verifier import HostVerifier

    if ref["digest"][:16] != MAIN_DIGEST or ref["steps"] != MAIN_STEPS:
        raise AssertionError("obs: the main path's host run moved off the invariant")
    # (1) The packed route, observed, against an observed host run.
    t0 = time.perf_counter()
    host = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True, burst=True,
                      dedup_verify=True, small_window_host=False,
                      batch_verifier=HostVerifier(), observe=True)
    host.run()
    host_wall = time.perf_counter() - t0
    want = host.obs.snapshot()
    if any(e.kind in OBS_DEVICE_KINDS for e in want):
        raise AssertionError("obs: the host run journaled a device-only event")
    legs = [_observed_packed(o, ref) for o in (False, True, True, False)]
    leg = legs[1]
    sim = leg["sim"]
    got = sim.obs.snapshot()
    kept = [e for e in got if e.kind not in OBS_DEVICE_KINDS]
    if sim.obs.dropped or kept != want:
        from collections import Counter

        a = Counter(e.kind for e in kept)
        b = Counter(e.kind for e in want)
        diff = {k: (a[k], b[k]) for k in set(a) | set(b) if a[k] != b[k]}
        first = next((i for i, (x, y) in enumerate(zip(kept, want)) if x != y), None)
        raise AssertionError(
            f"obs: packed journal differs from the host run's: dropped={sim.obs.dropped} "
            f"kinds (card, host)={diff} first differing event={first}")
    rows = [e for e in got if e.kind == "verify.occupancy.rows"]
    syncs = [e for e in got if e.kind == "fetch.sync"]
    if len(rows) != leg["launches"] or sum(e.detail for e in rows) != sim.verified_sigs:
        raise AssertionError(f"obs: {len(rows)} verify.occupancy.rows for "
                             f"{leg['launches']} ed25519_verify launches")
    if [e.detail for e in syncs] != leg["fetches"]:
        raise AssertionError(f"obs: {len(syncs)} fetch.sync events for "
                             f"{len(leg['fetches'])} device fetches")
    if legs[1]["launches"] != legs[0]["launches"]:
        raise AssertionError("obs: the observed run launched other kernels than the "
                             "unobserved one")
    snap = sim.metrics_snapshot()
    off = [legs[0]["wall"], legs[3]["wall"]]
    on = [legs[1]["wall"], legs[2]["wall"]]
    print(f"obs packed: n={N_VALIDATORS} height={HEIGHT} steps={leg['res'].steps} "
          f"events={len(got)} total={sim.obs.total} dropped={sim.obs.dropped} "
          f"journal_digest={sim.obs.digest()[:16]} "
          f"host_journal_digest={_events_digest(want)[:16]} equal_after_filter=True "
          f"filtered={','.join(OBS_DEVICE_KINDS)} "
          f"verify_occupancy_rows={len(rows)} ed25519_verify_launches={leg['launches']} "
          f"fetch_sync={len(syncs)} device_fetches={len(leg['fetches'])} "
          f"registry_counters={len(snap['counters'])} "
          f"registry_histograms={len(snap['histograms'])} "
          f"host_observed_wall_s={host_wall:.3f} "
          f"wall_unobserved_s={off[0]:.3f},{off[1]:.3f} "
          f"wall_observed_s={on[0]:.3f},{on[1]:.3f} "
          f"observed_over_unobserved={sum(on) / sum(off):.3f} "
          f"digest={leg['res'].commit_digest(up_to=HEIGHT)[:16]}", flush=True)

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "hyperdrive_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="obs-", dir=build)
    try:
        # (2) The pipelined route, observed, under the profiler.
        verifier = TorchBatchVerifier(buckets=PIPE_BUCKETS, device="cuda")
        verifier.warmup()
        torch.cuda.synchronize()
        pipe = Simulation(n=N_VALIDATORS, target_height=HEIGHT, seed=1, sign=True,
                          burst=True, dedup_verify=True, small_window_host=False,
                          batch_verifier=verifier, pipeline_heights=True, observe=True)
        ed25519_cuda.reset_stats()
        t0 = time.perf_counter()
        with profile(os.path.join(tmp, "profile")):
            res = pipe.run()
        wall = time.perf_counter() - t0
        stat = ed25519_cuda.stats["ed25519_verify"]
        if res.commit_digest(up_to=HEIGHT) != ref["digest"] or res.steps != ref["steps"]:
            raise AssertionError("obs pipe: the run left the host run's chain")
        recs = pipe.devtel.records
        q = pipe._sched
        if len(recs) != stat.launches or len(recs) != q.launches:
            raise AssertionError(f"obs pipe: {len(recs)} launch records for "
                                 f"{stat.launches} kernel launches ({q.launches} queue)")
        for r in recs:
            if r.syncs < 1 or r.lanes != bucketing.bucket_for(r.rows, PIPE_BUCKETS):
                raise AssertionError(f"obs pipe: launch record {r.as_dict()}")
        if sum(r.lanes for r in recs) != stat.lanes:
            raise AssertionError(f"obs pipe: record lanes {[r.lanes for r in recs]} for "
                                 f"{stat.lanes} kernel lanes")
        psnap = pipe.metrics_snapshot()
        if psnap["counters"].get("devtel.launches") != stat.launches:
            raise AssertionError(f"obs pipe: devtel.launches="
                                 f"{psnap['counters'].get('devtel.launches')}")
        print(f"obs pipe: launches={stat.launches} lanes={stat.lanes} "
              f"records={[(r.launch_id, r.commands, r.rows, r.lanes, r.syncs) for r in recs]} "
              f"devtel_launches={psnap['counters']['devtel.launches']} "
              f"devtel_submitted={psnap['counters']['devtel.submitted']} "
              f"events={len(pipe.obs)} wall_s={wall:.3f} (under the profiler)", flush=True)
        # (4) The profiler's trace names the kernel; the journal exports.
        with open(profile.last_path) as fh:
            chrome = fh.read()
        kernel_name = "hd_ed25519_verify_kernel"
        named = chrome.count(kernel_name)
        if not named:
            raise AssertionError(f"obs trace: {profile.last_path} does not name "
                                 f"{kernel_name}")
        doc_path = os.path.join(tmp, "journal.trace.json")
        hobs.export(pipe.obs.snapshot(), doc_path)
        with open(doc_path) as fh:
            doc = json.load(fh)
        slices = [e for e in doc["traceEvents"]
                  if e.get("tid") == hobs.DEVICE_TID and e.get("ph") == "X"]
        if len(slices) != stat.launches:
            raise AssertionError(f"obs trace: {len(slices)} device launch slices for "
                                 f"{stat.launches} launches")
        print(f"obs trace: profile_bytes={len(chrome)} kernel_mentions={named} "
              f"perfetto_events={len(doc['traceEvents'])} launch_slices={len(slices)}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (3) Wall splits of a probed queue on the card.
    ring = KeyRing.deterministic(N_VALIDATORS, namespace=b"obs-splits")
    verifier = TorchBatchVerifier(device="cuda")
    verifier.warmup()
    torch.cuda.synchronize()
    tel = hobs.DeviceTelemetry(time_fn=time.perf_counter)
    q = DeviceWorkQueue(devtel=tel)
    launcher = q.verify_launcher(verifier)
    for lanes in OBS_WIDTHS:
        items = []
        for j in range(lanes):
            kp = ring[j % N_VALIDATORS]
            d = hashlib.sha256(b"obs-%d-%d" % (lanes, j)).digest()
            items.append((kp.public, d, kp.sign_digest(d)))
        ed25519_cuda.reset_stats()
        for _ in range(OBS_DRAINS):
            fut = q.submit(launcher, items, rows=lanes)
            q.drain()
            if not all(fut.result()):
                raise AssertionError(f"obs splits: a valid signature failed at {lanes}")
        recs = tel.records[-OBS_DRAINS:]
        stat = ed25519_cuda.stats["ed25519_verify"]
        if stat.launches != OBS_DRAINS or any(r.syncs != 1 for r in recs):
            raise AssertionError(f"obs splits: {stat.launches} launches, syncs "
                                 f"{[r.syncs for r in recs]}")
        for r in recs:
            parts = r.t_pack + r.t_dispatch + r.t_sync + r.t_unpack
            if abs(parts - r.wall) > 0.05 * r.wall:
                raise AssertionError(f"obs splits: {parts} s of splits for {r.wall} s wall")

        def p50(attr, recs=recs):
            return statistics.median(getattr(r, attr) for r in recs) * 1e3

        share = sum(r.t_sync for r in recs) / sum(r.wall for r in recs)
        print(f"obs splits: lanes={lanes} drains={OBS_DRAINS} "
              f"pack_ms_p50={p50('t_pack'):.4f} dispatch_ms_p50={p50('t_dispatch'):.4f} "
              f"sync_ms_p50={p50('t_sync'):.4f} unpack_ms_p50={p50('t_unpack'):.4f} "
              f"wall_ms_p50={p50('wall'):.4f} sync_share={share:.3f} "
              f"splits_sum_within_5pct=True card={card_line()}", flush=True)


#: The JAX package's observed runs of ``phase_obs_net``'s legs, on the
#: CPU with ``HostVerifier`` (the card machine has no jax): (a) the overlay
#: bench's network signed at n = 256 and with ``bls_partials`` at n = 16,
#: the whole journal's digest and its kinds; (b) the overload leg of
#: ``phase_chaos`` (``FaultPlan.overload(1002, 16)``, ``QueueFlusher``s on
#: one shared verifier behind ``DeviceWorkQueue(max_depth=8)``) with a
#: ring large enough to keep every event: its lifecycle and the count of
#: every kind (the launch records' lane details follow the verifier's
#: bucket ladder, so the digest is not compared); (c) the campaign bench's
#: storm with a registry and a recorder on a zero clock: both digests, the
#: campaign.* kinds and the registry's counters.
OBS_NET_OVERLAY = {
    256: dict(journal="c27e2da59735a444", events=14_148,
              kinds={"commit": 512, "overlay.frame": 10_666, "overlay.level.timeout": 145,
                     "overlay.withhold": 12, "round.start": 768, "step.precommitting": 512,
                     "step.prevoting": 768, "timeout.propose.scheduled": 765}),
    16: dict(journal="27c2b6bbe5dc6fd1", events=461,
             kinds={"commit": 32, "overlay.frame": 256, "round.start": 48,
                    "step.precommitting": 32, "step.prevoting": 48,
                    "timeout.propose.scheduled": 45}),
}
OBS_NET_CHAOS = dict(
    capacity=1 << 18,
    lifecycle=[(0, 3052, 12, 0), (1, 6104, 12, 2), (2, 6184, 2, 2), (2, 6184, 3, 2),
               (2, 6184, 13, 2), (2, 6184, 14, 2)],
    kinds={"admission.level": 1, "admission.shed": 51_008, "chaos.crash": 1,
           "chaos.heal": 1, "chaos.partition": 1, "chaos.restore": 1, "commit": 315,
           "height.resync": 5, "ingest.window": 12_975, "load.burst": 922,
           "load.offered": 922, "round.skip": 15, "round.start": 368,
           "sched.coalesce": 1_629, "sched.drain": 1_629, "sched.launch.begin": 1_629,
           "sched.launch.cmd": 12_975, "sched.launch.end": 1_629,
           "sched.launch.lanes": 1_629, "sched.launch.occupancy": 1_629,
           "sched.launch.queue_wait": 1_629, "sched.launch.rows": 1_629,
           "sched.launch.submit": 12_975, "sched.submit": 12_975,
           "step.precommitting": 347, "step.prevoting": 352, "timeout.precommit.fired": 17,
           "timeout.precommit.scheduled": 27, "timeout.prevote.fired": 16,
           "timeout.prevote.scheduled": 16, "timeout.propose.fired": 17,
           "timeout.propose.scheduled": 345})
OBS_NET_CAMPAIGN = dict(
    journal="1fd02fc595d8dbec", registry="df54149dbdaf7099", events=15_528,
    kinds={"admission.level": 6, "admission.reputation.charge": 384,
           "admission.reputation.demote": 24, "admission.reputation.recover": 16,
           "admission.shed": 14_976, "campaign.done": 1, "campaign.family": 1,
           "campaign.wave": 120},
    counters={"admission.admitted": 6_144, "admission.offered": 21_120,
              "admission.reputation.demotions": 24, "admission.reputation.recoveries": 16,
              "admission.transitions": 6, "campaign.runs": {"storm": 1}})
#: The traced deployment: the capstone's network (n = 4, 10 heights, the
#: chal route, buckets 64, every mask held to the host) as four worker
#: processes of one replica each, so that each of four TcpNodes stamps and
#: journals on a process and a clock of its own: (processes, replicas per
#: process, heights, seconds until an unfinished run fails).
OBS_NET_DEPLOY = (4, 1, 10, 420)


def _kinds(events, drop=()) -> dict:
    """Kind -> count over ``events``, kinds in ``drop`` left out."""
    from collections import Counter

    return dict(sorted(Counter(e.kind for e in events if e.kind not in drop).items()))


def phase_obs_net() -> None:
    """Observability on the remaining subsystems (``phase_obs_net``, lines
    ``obs_net``), each leg driven with the kernel counts set to 0 just
    before it and read just after:

    - (a) the overlay bench's network observed: n = 256 signed (row 1, a
      launch a verify row) and n = 16 signed with ``bls_partials`` (row 5,
      a launch a merge, each sum held to the host fold): the JAX run's
      digest, steps, row-1 launches and whole journal;
    - (b) ``phase_chaos``'s overload leg observed, ``InvariantMonitor``
      armed (``check_final`` runs ``_check_journal``): the chaos queue
      leg's digest and steps, the JAX run's queue counts, lifecycle and the
      count of every kind;
    - (c) the campaign bench's storm with a registry and a recorder,
      verifying on the card: the JAX run's journal and registry digests;
    - (d) the multi-tenant series at M = 16 on a service with ``obs``,
      ``tracer``, ``devtel`` and ``registry``: a metrics scrape answers the
      queue's launch count, per-tenant verify latency p50/p99, and a traced
      remote tenant whose journal merges with the service's, no orphan;
    - (e) a traced deployment: the capstone's network as four worker
      processes on the chal route (rows 3 and 4), each ``TcpNode`` with
      ``trace=`` and ``registry=``, their four saved journals merged with
      no orphaned ``trace.recv``."""
    import tempfile
    import threading

    from hyperdrive_tpu_torch.campaign import CampaignConfig
    from hyperdrive_tpu_torch.campaign.runner import run_campaign
    from hyperdrive_tpu_torch.chaos import FaultPlan
    from hyperdrive_tpu_torch.devsched import DeviceWorkQueue, QueueFlusher
    from hyperdrive_tpu_torch.obs import (
        DeviceTelemetry,
        Recorder,
        Registry,
        TraceSource,
        load_journal,
        merge_journals,
        merged_digest,
    )
    from hyperdrive_tpu_torch.ops import ed25519_cuda
    from hyperdrive_tpu_torch.ops.ed25519 import TorchBatchVerifier
    from hyperdrive_tpu_torch.overlay import OverlayConfig
    from hyperdrive_tpu_torch.parallel.service import (
        STATUS_COMMITTED,
        RemoteServiceClient,
        ShardVerifyService,
        TenantShard,
    )
    from hyperdrive_tpu_torch.utils.trace import Tracer
    from hyperdrive_tpu_torch.verifier import HostVerifier

    card = TorchBatchVerifier(device="cuda")
    card.warmup()
    torch.cuda.synchronize()

    # (a) The overlay, observed.
    for n, label, kw in ((256, "n=256 signed", {}),
                         (16, "n=16 signed bls_partials", {"bls_partials": True})):
        want = OBS_NET_OVERLAY[n]
        leg = _overlay_leg(f"{label} observed", n, OVERLAY_LEGS[label], sign=True,
                           overlay=OverlayConfig(**kw), observe=True)
        sim = leg["sim"]
        # The card verifier's mask copies journal fetch.sync (device-only
        # kinds, as in phase_obs); every other event is the JAX run's.
        events = [e for e in sim.obs.snapshot() if e.kind not in OBS_DEVICE_KINDS]
        digest = _events_digest(events)[:16]
        kinds = _kinds(events)
        if (digest, len(events), kinds, sim.obs.dropped) != (
                want["journal"], want["events"], want["kinds"], 0):
            raise AssertionError(f"obs_net overlay {label}: journal {digest} of "
                                 f"{len(events)} events, kinds {kinds}, want {want}")
        syncs = sum(e.kind == "fetch.sync" for e in sim.obs.snapshot())
        print(f"obs_net overlay {label}: events={len(sim.obs)} fetch_sync={syncs} "
              f"journal_digest_without_device_kinds={digest} equals_jax=True "
              f"overlay_frame={kinds.get('overlay.frame', 0)} "
              f"overlay_level_timeout={kinds.get('overlay.level.timeout', 0)} "
              f"overlay_withhold={kinds.get('overlay.withhold', 0)} "
              f"bls_events={sum(v for k, v in kinds.items() if k.startswith('bls.'))} "
              f"verify_rows={leg['snap']['verify_rows']} wall_s={leg['wall']:.3f}", flush=True)

    # (b) Chaos with the pinned load, observed, the monitor armed.
    plan, profile = FaultPlan.overload(CHAOS_NET["seed"], CHAOS_NET["n"])
    q = DeviceWorkQueue(max_depth=8)
    leg = _chaos_leg("overload observed", plan, CHAOS_A["want"], ("ed25519_verify",), q,
                     load=profile, observe=True, obs_capacity=OBS_NET_CHAOS["capacity"],
                     flusher_for=lambda i, v: QueueFlusher(card, q))
    sim = leg["sim"]
    kinds = _kinds(sim.obs.snapshot(), OBS_DEVICE_KINDS)
    queue = (q.submitted, q.launches, q.coalesced)
    lifecycle = leg["res"].record.lifecycle
    if (queue != CHAOS_D["queue"] or lifecycle != OBS_NET_CHAOS["lifecycle"]
            or kinds != OBS_NET_CHAOS["kinds"] or sim.obs.dropped
            or leg["launches"]["ed25519_verify"] != q.launches):
        raise AssertionError(f"obs_net chaos: queue {queue}, lifecycle {lifecycle}, "
                             f"dropped {sim.obs.dropped}, kinds {kinds}")
    fams = {k: v for k, v in kinds.items() if k.split(".")[0] in ("chaos", "admission", "load")}
    print(f"obs_net chaos: n={CHAOS_NET['n']} heights={CHAOS_HEIGHTS} "
          f"steps={leg['res'].steps} events={len(sim.obs)} kinds_equal_jax=True "
          f"check_journal=passed {' '.join(f'{k}={v}' for k, v in fams.items())} "
          f"launches={leg['launches']['ed25519_verify']} wall_s={leg['wall']:.3f} "
          f"digest={leg['res'].commit_digest()[:16]}", flush=True)

    # (c) The campaign bench's storm with a registry and a recorder.
    rec, reg = Recorder(time_fn=lambda: 0.0), Registry(time_fn=lambda: 0.0)
    ed25519_cuda.reset_stats()
    t0 = time.perf_counter()
    out = run_campaign(CampaignConfig(reputation=True, **CAMPAIGN_BENCH), verifier=card,
                       registry=reg,
                       obs=rec.scoped(-1))
    wall = time.perf_counter() - t0
    launched = {k: v.launches for k, v in ed25519_cuda.stats.items() if v.launches}
    want = OBS_NET_CAMPAIGN
    counters = reg.snapshot()["counters"]
    got = dict(journal=rec.digest()[:16], registry=reg.digest()[:16], events=len(rec),
               kinds=_kinds(rec.snapshot()),
               counters={k: counters.get(k) for k in want["counters"]})
    if (got != want or out.digest.hex()[:16] != CAMPAIGN_B[True]["digest"]
            or launched != {"ed25519_verify": CAMPAIGN_B[True]["calls"]}):
        raise AssertionError(f"obs_net campaign: {got}, digest {out.digest.hex()[:16]}, "
                             f"launched {launched}, want {want}")
    print(f"obs_net campaign: digest={out.digest.hex()[:16]} events={len(rec)} "
          f"journal_digest={got['journal']} registry_digest={got['registry']} "
          f"equals_jax=True campaign_wave={got['kinds']['campaign.wave']} "
          f"reputation_charges={got['kinds']['admission.reputation.charge']} "
          f"launches={launched['ed25519_verify']} wall_s={wall:.3f}", flush=True)

    # (d) The service with every hook: the M = 16 series, a scrape and a
    # traced remote tenant.
    m, heights = SERVICE_M[-1], SERVICE_HEIGHTS + 1
    host_svc = ShardVerifyService(HostVerifier(), max_depth=0)
    host = [TenantShard(f"tenant-{i}", n_validators=SERVICE_VALIDATORS,
                        target_height=heights).attach_local(host_svc) for i in range(m)]
    _waves([host_svc], host, heights)
    srec, crec = Recorder(threadsafe=True), Recorder(threadsafe=True)
    reg = Registry()
    svc = ShardVerifyService(card, max_depth=0, obs=srec.scoped(-1), tracer=Tracer(),
                             devtel=DeviceTelemetry(registry=reg), registry=reg)
    tenants = [TenantShard(f"tenant-{i}", n_validators=SERVICE_VALIDATORS,
                           target_height=heights).attach_local(svc) for i in range(m)]
    ed25519_cuda.reset_stats()
    wall = _waves([svc], tenants, heights)
    series_launches = ed25519_cuda.stats["ed25519_verify"].launches
    if ([t.commit_digest() for t in tenants] != [t.commit_digest() for t in host]
            or series_launches != heights or svc.queue.launches != heights):
        raise AssertionError(f"obs_net service: {series_launches} launches, digests equal "
                             f"{[t.commit_digest() for t in tenants] == [t.commit_digest() for t in host]}")
    port = svc.remote_port(trace=TraceSource(1, obs=srec.scoped(-1)))
    client = None
    try:
        client = RemoteServiceClient(*port.address, obs=crec.scoped(-1),
                                     trace=TraceSource(2, obs=crec.scoped(-1)))
        remote = TenantShard("remote", n_validators=SERVICE_VALIDATORS,
                             target_height=heights).attach_remote(client)
        errors: list = []

        def drive():
            try:
                remote.run_remote(max_inflight=4, timeout=20.0)
            except Exception as err:  # reported below
                errors.append(err)

        worker = threading.Thread(target=drive, daemon=True)
        worker.start()
        t0 = time.perf_counter()
        while worker.is_alive() and time.perf_counter() - t0 < 60.0:
            port.pump()
            svc.drain()
            time.sleep(0.0005)
        worker.join(5.0)
        if worker.is_alive() or errors or not remote.done or remote.rejected:
            raise AssertionError(f"obs_net service remote: done {remote.done}, errors "
                                 f"{errors}")
        scrape = client.metrics()
        t0 = time.perf_counter()
        while not scrape._event.is_set() and time.perf_counter() - t0 < 10.0:
            port.pump()
            time.sleep(0.001)
        status, text = scrape.metrics_result(5.0)
    finally:
        if client is not None:
            client.close()
        port.close()
    launches_line = f"hd_service_queue_launches {svc.queue.launches}"
    if status != STATUS_COMMITTED or launches_line not in text.splitlines():
        raise AssertionError(f"obs_net service scrape: status {status}, text lacks "
                             f"{launches_line!r}")
    merged = merge_journals([srec.journal(meta={"origin": 1}),
                             crec.journal(meta={"origin": 2})])
    sends = sum(ev[4] == "trace.send" for ev in merged["events"])
    recvs = sum(ev[4] == "trace.recv" for ev in merged["events"])
    if merged["meta"]["orphans"] or not recvs:
        raise AssertionError(f"obs_net service trace: orphans {merged['meta']['orphans']}, "
                             f"{recvs} receives")
    hist = reg.snapshot()["histograms"]["tenant.verify.latency"]
    p50 = statistics.median(h["p50"] for h in hist.values()) * 1e3
    p99 = max(h["p99"] for h in hist.values()) * 1e3
    print(f"obs_net service: M={m} validators={SERVICE_VALIDATORS} heights={heights} "
          f"series_launches={series_launches} series_wall_s={wall:.4f} "
          f"digests_equal_host=True scrape=ok scrape_bytes={len(text)} "
          f"'{launches_line}' tenants_with_latency={len(hist)} "
          f"tenant_verify_p50_ms_median={p50:.4f} tenant_verify_p99_ms_max={p99:.4f} "
          f"remote_submits={port.remote_submits} trace_sends={sends} trace_recvs={recvs} "
          f"orphans=0 merged_digest={merged_digest(merged)[:16]}", flush=True)

    # (e) The capstone's network traced across processes (OBS_NET_DEPLOY):
    # each worker resets its kernel counts after its warm-up and reports
    # them in its DEPLOY_STATS line.
    with tempfile.TemporaryDirectory() as tdir:
        fields = run_deploy("obs_net traced", *OBS_NET_DEPLOY,
                            ("--buckets", "64", "--check-host", "--trace", tdir))
        merged = merge_journals([load_journal(os.path.join(tdir, f"journal-{r}.json"))
                                 for r in range(len(fields))])
    sends = sum(ev[4] == "trace.send" for ev in merged["events"])
    recvs = sum(ev[4] == "trace.recv" for ev in merged["events"])
    launched = {k: sum(int(f[f"{k}_launches"]) for f in fields)
                for k in ("ed25519_challenge", "ed25519_semiwire", "ed25519_wire")}
    if merged["meta"]["orphans"] or not recvs or launched["ed25519_wire"]:
        raise AssertionError(f"obs_net deploy: orphans {merged['meta']['orphans']}, "
                             f"{recvs} receives, launched {launched}")
    wire = sum(int(f["wire_frame_events"]) for f in fields)
    reconnects = sum(int(f["transport_reconnect"]) for f in fields)
    procs, per, heights, _ = OBS_NET_DEPLOY
    print(f"obs_net deploy: processes={procs} replicas_per_process={per} heights={heights} "
          f"route=chal launches={launched} journals={len(fields)} "
          f"merged_events={len(merged['events'])} trace_sends={sends} trace_recvs={recvs} "
          f"orphans=0 merged_digest={merged_digest(merged)[:16]} wire_frame_events={wire} "
          f"transport_reconnect={reconnects} digest={fields[0]['digest'][:16]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--python-host"]:
        return python_host_child(json.loads(sys.argv[2]))
    props = torch.cuda.get_device_properties(0)
    clock = sm_clock_mhz()
    sms = props.multi_processor_count
    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    lib, probe_lib = phase_card()
    phase_native()
    mark("card")
    mesh_launches = phase_mesh(clock, sms)
    mark("mesh")
    rows = {"ed25519_verify": phase_verify_kernel(clock, sms)}
    rows["ed25519_wire"], rows["ed25519_semiwire"], state = phase_wire_kernels(clock, sms)
    base = rows["ed25519_verify"][PATH_LANES]["ms"]
    print(f"ratio: {PATH_LANES}-lane kernel time over ed25519_verify's in this run: "
          + " ".join(f"{k}={rows[k][PATH_LANES]['ms'] / base:.4f}"
                     for k in ("ed25519_wire", "ed25519_semiwire")), flush=True)
    rows["ed25519_challenge"] = phase_challenge(state, clock, sms, lib, probe_lib)
    mark("kernels")
    phase_votegrid()
    mark("votegrid")
    launches, ref = phase_main_path()
    mark("main")
    sanitize_launches = phase_sanitize(ref)
    mark("sanitize")
    phase_obs(ref)
    mark("obs")
    phase_burst(ref)
    mark("burst")
    phase_lockstep(ref)
    mark("lockstep")
    phase_overlay()
    mark("overlay")
    phase_chaos()
    mark("chaos")
    phase_campaign()
    mark("campaign")
    phase_service()
    mark("service")
    phase_obs_net()
    mark("obs_net")
    phase_deploy()
    mark("deploy")
    phase_shamir()
    mark("shamir")
    phase_rlc()
    mark("rlc")
    phase_config5()
    mark("config5")
    phase_certs()
    mark("certs")
    phase_exec()
    mark("exec")
    cli_launches = phase_cli()
    mark("cli")
    entry_launches = phase_entry()
    mark("entry")
    rows["g1_aggregate"], launches["g1_aggregate"] = phase_bls(clock, sms)
    mark("bls")
    print("phases_s: " + " ".join(f"{name}={t - marks[i][1]:.1f}"
                                  for i, (name, t) in enumerate(marks[1:]))
          + f" total={marks[-1][1] - marks[0][1]:.1f}", flush=True)
    table = []
    for name, (source, replaces) in KERNELS.items():
        row = rows[name][PATH_LANES]
        table.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": (launches[name] + mesh_launches.get(name, 0)
                         + cli_launches.get(name, 0) + sanitize_launches.get(name, 0)
                         + entry_launches.get(name, 0)),
            "max_abs_err": max(r["err"] for r in rows[name].values()),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
