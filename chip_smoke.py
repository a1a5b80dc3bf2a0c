#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tendermint_tpu_torch) on one GPU.

    python3 chip_smoke.py

Drives the port's main path — range-batched ed25519 commit verification —
on the card and checks every hand-written kernel on it. Phases (any
failure exits non-zero, nothing is caught and carried past):

  1. build the CUDA kernels from csrc/ (nvcc, sm_90a), print the seconds
     and each kernel's register/spill report;
  2. hold each kernel against its plain PyTorch version on the card, at
     sizes the main path gives it (B1 at 8,192, 64 and 1 elements, B2
     at 8,319, B3 at 8,192 and 256 chains of 15 steps, with an all-511
     chain, a y == x chain and signed limbs among them; phase 11 checks
     that the main path gives these sizes), with torch.equal (integer
     arithmetic: the tolerance is zero); time each kernel alone
     (torch.profiler, three repeats), through its wrapper (CUDA events,
     three repeats), and its plain version (K7a and K7b: phase 14);
  3. verify_commit_range over 54 commits of a 150-validator set (one
     8,192-signature bucket, 150 unique keys) with the launch counts set
     to 0 just before and read just after; then verify_batch_eq over every
     signature of those commits (8,100, the bench.py headline shape);
  4. the same range with one tampered signature: verify_commit_range must
     raise with the right failed_index, and verify_resolved must
     attribute exactly that signature through kernel_sig;
  5. cross-check 256 bitmap entries against host single verification;
  6. a breakdown of one range-sized `kernel_eq`: host prep, copy, wall
     time, the card's busy time and idle share, each kernel's summed
     device time (torch.profiler), and B1's host time in `field.mul`
     with its calls by size;
  7. sr25519: verify_commit_range over 8 commits of a 150-validator
     sr25519 set (808 signatures, the 1,024 bucket), without a hub: B1,
     B2 and B3 must each launch; a tampered signature gives the right
     failed_index; 256 bitmap entries agree with host sr25519
     verification; prints sigs/s, the wall and the host resolve seconds
     (ristretto decoding and the Merlin transcript);
  8. the mixed ed25519 + secp256k1 set of BASELINE config 4 (150
     validators, 4 commits) through verify_commit_light inside a running
     VerifyHub — a hub and host check that launches no kernel: every
     signature verifies on its own on the host (route "cpu"), each
     commit verifies exactly its light-semantics tally of signatures,
     every verdict is the host's, and a tampered secp256k1 signature
     raises; prints the wall and the dispatch routes;
  9. the adaptive cutoff measured on the card (`batch._measure_cutoff`):
     the device call at 64 signatures, the host rate, the measured and
     the clamped MIN_TPU_BATCH;
 10. the hub: with max_batch 8,192 the 54-commit range of phase 3 through
     verify_commit_range on the backfill lane — every dispatch's route
     must be "cuda" and B1–B3 must launch; the same range again must come
     wholly from the verdict cache with no launch; then, at the default
     max_batch (512), the split of dispatches between "cuda" and "cpu"
     (printed, not asserted). The hub's max_batch must be the one asked
     for. Prints the hub's stats, wall and sigs/s beside phase 3's
     direct call; `running_hub()` is None after release;
 12. block-sync (run after phase 10, before the audit): bench.py's
     block-sync bench (BASELINE config 3) on the port — a 256-block
     kvstore chain (cut from 1,024 to make room for phase 19) of the
     150-validator set, built through the port's executor on the host
     (device="cpu": set-up, its seconds printed),
     replayed by a fresh node's BlockSyncReactor on the card, window 108,
     one in-process peer serving blocks through a Channel, no hub. Each
     range goes to verify_commit_range once (a full window is 10,908
     signatures: two 8,192-signature `kernel_eq` chunks); every range must
     route as the router's measured cutoff says ("cuda" from
     MIN_TPU_BATCH, which is at most 2,048), B1–B3 must launch, every
     block but the tip must be applied, and the final app hash, height
     and validators hash must be the source chain's. Prints blocks/s,
     each range's blocks, signatures, route and wall, the launches, and
     the ranges' verification wall against `CPUBatchVerifier(parallel=
     True)` over the same signatures. Then a tampered pass: the commit
     for height 100 carries a flipped signature bit, served first as the
     last block of a range (whose batch fails on the card: kernel_eq,
     then kernel_sig), then, after the punishment, inside two windows;
     the reactor must punish that height twice with a fatal PeerError
     naming the peer, request it again, and apply nothing from it on;
 13. the light client (run after phase 12, before the audit): bench.py's
     light-client bench (BASELINE config 2) on the port, cut from 1,000 to
     500 signed headers of the 150-validator set (to make room for phases
     20-22), built on the host as bench.py builds them (seconds printed),
     then one verify_adjacent_chain over the 499 after the first on the
     card, at the cutoff measured in phase 9: one verify_commit_range of
     50,399 signatures, which must route "cuda" and run as 7 `kernel_eq`
     chunks that all hold, with B1–B3 launched and the trusted head at
     height 500; prints headers/s, the
     wall, the range's share of it and the launches beside
     `CPUBatchVerifier(parallel=True)` over the same triples. Then a
     LightClient over a list provider of the chain with one honest
     witness: sequential (four verify_adjacent_chain windows of ≤ 128
     headers, each routed by the cutoff's rule, their routes and walls
     printed) and skipping (one verify_non_adjacent through
     verify_commit_light_trusting; its routes printed, not asserted).
     Then a tampered pass: the commit for height 490 carries a flipped
     signature bit, at place 49,293 of the range, in the last chunk:
     verify_adjacent_chain must raise VerificationError naming height 490
     and the signature, that chunk alone must fail and kernel_sig must
     run once. Last a divergence: a witness serves a header at height
     500 with another app hash, signed by the same 150 keys; the client
     must raise Divergence, keep nothing past its anchor, and report one
     LightClientAttackEvidence to the primary, whose bytes decode back
     equal; prints its attributed validators;
 14. BLS aggregate commits (run after phase 13, before the audit):
     bench.py's bench_commit_ab(150, 4), its bls_aggregate half, cut to 2
     commits (to make room for phase 19) — 150 bls12381 validators (seed
     b"ab-bls_aggregate", chain "ab-chain") and 2 commits folded by
     aggregate_commit, built on the host (seconds printed); with no hub
     and the hash-to-curve memo cleared before each pass, verify_commit on
     each commit, then one verify_commit_range over the 2: every check one
     pairing item of 151 pairs, so K7a (bls_miller) and K7b
     (bls_final_exp) each launch 4 times, all at the (2, 256) bucket;
     each pass prints its wall, the host split
     (hash-to-curve, line preparation, packing, the copy), each kernel's
     device ms and the card's idle share (torch.profiler). Then the
     pure-Python floor (bls.aggregate_verify) and the card's
     verify_commit on one commit in turns (floor, card, card, floor); a
     tampered aggregate (validator 7 signs other bytes before the aggregation) must
     raise "aggregate signature verification failed" after one launch of
     each kernel; one per-signature BLS commit through verify_commit_range
     inside a running hub: its 101 signatures take the "bls" partition,
     one dispatch on the card at the (128, 2) bucket, and with a flipped
     signature bit (a fresh hub) it must name commit 0 and signature 7.
     K7a and K7b are held torch.equal to their plain versions on the card
     at every shape these paths gave them, on the paths' inputs and on
     worst-case ones (p - 1 in every input, zero lines, pad pairs; for K7b
     also an item whose product is zero, which must come out zero and not
     one), and K7b against bls_math.final_exp on 2 items of the (128, 2)
     bucket; each gets a timed `kernels` row (CUDA events around many
     launches, through its wrapper) at (2, 256) and at (128, 2);
 15. state sync (run after phase 14, before the audit): bench.py's
     bench_statesync(64, 21) (BASELINE config 5) on the port — a 64-block
     kvstore chain of 21 ed25519 validators of power 10 (a tx every third
     height, the app's snapshots every 10), built on the host (seconds
     printed), restored by a joining StateSyncReactor from the snapshot at
     60 and backfilled through verify_backfill_batch (59 headers, one
     window of 885 signatures) on the card, and the same scenario on the
     host in turns (floor, card, card, floor): every run must hold the
     same 60 headers and restore the same State; prints each run's wall,
     headers/s, the route of every batch (reported, not asserted: at 885
     signatures the router's cutoff sends the window to the host) and the
     launches. A tampered window (height 30's commit with a flipped bit in
     signature 0) must make the joiner punish the donor with a ban and
     stop the backfill. Then the BLS-committee backfill: 16 heights of 21
     bls12381 validators, each commit folded into its aggregate, through
     verify_backfill_batch on the card: backfill_agg_heights must be 16,
     K7a and K7b must each launch 16 times at the (2, 32) bucket, and are
     then held torch.equal to their plain versions there (path and
     worst-case inputs); prints the wall per height and the host split; a
     tampered aggregate at the sixth height must raise naming that height
     and count nothing;
 16. SHA-256 (B8, one launch a batch, padding on the card): the kernel
     torch.equal to its plain version (the reference's host packing and
     buckets), and its digests equal to hashlib's, at 1, 31, 32, 33,
     4,096, 4,097 and 16,384 messages of 0 to 503 bytes across the padding
     edges mixed in each launch, packed after a prefix of n % 16 bytes so
     that messages start at every alignment; a 504-byte message must raise
     through `sha256_device` and `sha256_bytes`. Then bench_merkle's
     leaves half (bench.py:855-947): 64 / 1,024 / 16,384 leaves of 250
     bytes, scalar recursive, batched on the host, and batched through the
     HashHub's device route (`use_device`, with MIN_DEVICE_BATCH = 1 as
     bench.py sets it): every root equal to the scalar one, and B8 launched
     exactly once a device batch; prints leaves/s, the route's split at the
     16,384-leaf level and an 8,192-node inner level (the `hash` trace
     spans of one `hash_hub.sha256_many` call, CUDA events around the one
     launch), and the narrowest batch width at which the route beats the
     hashlib loop for 251-byte leaves and 65-byte nodes; B8 gets `kernels`
     rows at 16,384 x 251, 8,192 x 65 and 4,096 x 251 bytes, each bound by
     the largest of its bytes, its int32 instructions at the card's int32
     rate, and its serial chain (the rounds' dependent chain, 193
     instructions a block counted from the source, timed alone by one
     thread with clock64, x the message's blocks / clocks.max.sm); what
     one warp alone issues for a block is reported beside it;
 17. the light fleet (run after phase 16): bench.py's bench_light_fleet(150,
     64, 6) on the port, per scheme — per_sig (150 ed25519 validators) and
     bls_aggregate (150 bls12381 validators, every hop folded into its
     aggregate), seeds b"lf-" + scheme, chains built on the host (seconds
     printed) — under asyncio.wait_for and a LoopWatchdog: a cold
     LightClient alone to height 6, then 64 concurrent LightD.sync(6) on one
     LightD (LightDConfig(max_sessions=32)) on the card, then hop_proof(6).
     Every client's block must be the chain's header at 6, hops_verified
     equal in both schemes, and K7a and K7b launched by the aggregate
     scheme's cold client and LightD; the per_sig scheme's routes are
     printed, not asserted (a hop's 101 signatures are under the cutoff).
     The served aggregate HopProof, carried by its bytes, is re-verified
     through verify_hop_proof on the card in a fresh hub with the memos
     cleared: each kernel launches once (the hop's second check of the same
     aggregate is the hub's cached verdict); with one flipped aggregate bit
     it must raise HopProofError with scheme "bls-aggregate". A LightD whose
     primary is a LunaticProvider (height 6 forged by 51 colluders) and
     whose witness is honest must raise Divergence, count one divergence
     and report LightClientAttackEvidence that decodes back equal. Prints
     the bench's fields per scheme (syncs/s, p50/p99, hit and shed rates,
     amortization, sigs covered/s, wire bytes, chain build), the routes and
     launches, and for the aggregate re-verification K7a/K7b device ms, the
     idle share and the host split;
 18. BootFleet (run after phase 17): bench.py's bench_statesync_fleet(64,
     21, 8) on the port — the join wave (testing.statesync_fleet_scenario:
     8 cold joiners on one donor's BootD over the reactor protocol, every
     reactor on the card, the 64-block donor chain of 21 validators built
     on the host): all 8 must join with equal States; prints joiners/s,
     chunks/s, p50/p99, sheds, the chunk cache's amortization and the
     joiners' backfill signatures and routes. Then the backfill A/B over 64
     validators through verify_backfill_batch on the card, the memos
     cleared: the bench's 32 ed25519 heights (1,376 signatures under light
     semantics; its route must be the cutoff's), 48 heights (2,064: the
     route must be "cuda" and B1-B3 must launch), and 6 bls12381 heights
     (cut from 32; 64 validators kept), each commit folded by
     aggregate_commit: K7a and K7b must launch once a height at the (2,
     128) bucket (profiled: device ms, idle share, host split). K7a and K7b
     are then held torch.equal to their plain versions at every shape
     phases 17-18 gave them (path and worst-case inputs), and each shape
     phase 14 did not time gets a timed `kernels` row;
 19. the sharded verifier (B6, run after phase 18, before the audit): the
     mesh is the first 4 (then 3) cards when the machine has them, else 4
     (then 3) logical shards of cuda:0 (printed). On phase 3's range at
     the 8,192 bucket (8,193 at 3 shards), one `make_sharded_kernel_eq`
     call against an unsharded `kernel_eq` on the same operands: bitmap
     and eq_ok torch.equal, the folded total projectively equal to the
     unsharded R-side MSM, B1 launched and B2 and B3 exactly n_dev + 1
     times each; then phase 4's tampered range through
     verify_commit_range on the mesh with TMTPU_FORCE_SHARDED=1: the right
     failed_index, the sharded kernel_sig (one kernel_sig a shard) singling
     out the signature, and last_dispatch_info() listing n_dev shards that
     hold the range; then the hub at its default max_batch (512) over the
     4-shard mesh: mesh_devices 4 and capacity 2,048, its dispatches'
     routes and shards printed. Prints each call's wall, the card's busy
     time and idle share and each kernel's launches and device ms (the
     profiler, the card's activity only) beside the unsharded call's, and
     the least time of its launches (each launch's bound at its shape,
     summed); each B2 and B3 size of a sharded kernel_eq (a shard, the
     epilogue) and its largest B1 size gets a timed `kernels` row;
 20. the verifyd sidecar (run after phase 19): a VerifyDaemon on cuda:0
     on its own event-loop thread in this process (so its launches and
     input shapes are this process's), serving worker processes
     (`python -c "import chip_smoke; chip_smoke._verifyd_worker(...)"`,
     port modules only, each a hub on the card at the cutoff phase 9
     measured). (a) bench.py's bench_verifyd(4, 1000): 4 workers of 1,000
     single ed25519 signatures, client hubs at their defaults (max_batch
     512, window 2 ms), through a daemon at the CLI's defaults, then each
     worker on its own hub: sigs/s, p50/p99 a signature, attach counts
     (1 for the sidecar against 4 local), the daemon's occupancy, its
     cross-client packs and the route of its batches; every dispatch of
     the sidecar workers must route "verifyd". (b) phase 3's 54 commits in
     4 contiguous ranges, one a worker, each through verify_commit_range
     on a hub at max_batch 8,192, released together into a daemon at
     max_batch 8,192 whose 1,000 ms window lets them meet: a dispatch of
     at least 2 tenants must run kernel_eq on the card with B1-B3
     launched here; then phase 4's tampered signature in its worker's
     range: that worker must name commit 20 and signature 5, the other
     tenants, packed in the same dispatch, stay true. (c) the daemon is
     stopped mid-flood and restarted on the same path: every verdict
     stays right, each worker counts fall-backs and a breaker opening,
     and re-adopts the daemon within TMTPU_VERIFYD_BREAKER_RESET (1 s) of
     the restart. (d) a 21-validator bls12381 aggregate commit through
     verify_commit over the sidecar: one remote aggregate, K7a and K7b
     launched once each here; a tampered aggregate (validator 7 signs
     other bytes) answers False. (e) `python -m tendermint_tpu_torch.cli
     verifyd --stats` against the running daemon, and a CLI daemon
     started once, queried and stopped with SIGTERM (exit 0). Normal runs
     count no daemon error, hub error or fall-back, and the daemon's
     batches run on the card;
 21. the tx front door (after phase 20): bench.py's bench_tx_flood(10_000,
     2) as it sets it (20,000 seeded envelope txs of 10,000 senders; hub
     max_batch 512, window 2 ms, cache 65,536; ingress depth 2,048, 64
     verify workers, a 250 ms park; the pool sized to the flood): admitted
     tx/s, CheckTx p50/p99, shed rate, parked/expired/adopted, sig_failed,
     the hub's occupancy and its batches' route split (the host, under
     the cutoff). Then the same txs and 20 copies with a flipped signature
     bit, all submitted at once, through a hub at max_batch 8,192 (window
     500 ms) and an ingress as deep as the flood with 8,192 workers:
     nothing shed, every batch at or above the cutoff on the card with
     B1-B3 launched, and the admitted txs equal, byte for byte and in
     order, to the same txs through the port's ingress with no hub;
 22. the evidence pool (after phase 21): a 150-validator kvstore chain of
     8 blocks; a duplicate vote (height 3) and a LunaticProvider attack
     (51 colluders forge height 6 against common height 2), each with a
     tampered copy, through EvidencePool(device="cuda") in a running hub:
     verdicts, errors and the routes (each check's signatures are under
     the cutoff: the host); then the reactor carries both valid
     evidences from one pool to another over Channels;
 23. consensus ingest (after phase 22): bench.py's bench_consensus_ingest
     (:1396-1571) at 150 validators (the bench's 64 raised to the north
     star's), 6 waves, 8 peers, 98 votes per (round, type) so that no
     tally reaches 2/3 (392 a wave), into one parked observer
     `harness.Node(genesis, None, device="cuda")`. (a) The bench's own
     shape, a hub on the card at max_batch 256 and a 2 ms window: the
     sequential facade (2 waves), then the pipeline (6 waves, 256 in
     flight) beside a 128-signature backfill feeder; votes/s of each, the
     speed-up, the hub's occupancy, the live/backfill lane split, the
     ingest's pre_verified / dedup_drops / unverified / hub_errors and the
     route of every dispatch (printed, not asserted: each is under the
     cutoff); every vote must be pre-verified, none unverified. (b) The
     wide burst: the observer's HeightVoteSet opened to round 13
     (set_round(12)), all 2,744 votes of rounds 0-13 fed at once by 8
     peers, 4,096 in flight, a hub at max_batch 8,192 whose 1,000 ms
     window lets them meet: a dispatch at or above the cutoff must route
     "cuda" and run kernel_eq with every chunk holding and B1-B3
     launched, every vote tallied, pre_verified 2,744 and unverified and
     hub_errors 0. (c) The same burst signed anew with one vote's
     signature bit flipped, that vote coming through a ConsensusReactor's
     vote Channel from peer "p3": kernel_eq must fail and kernel_sig find
     exactly that signature false, sig_invalid 1, one PeerError naming
     "p3", and the other 2,743 votes tallied;
 24. live consensus on the card (after phase 23): the frozen-clock recipe
     of tests/test_bls.py:655-730 (3 equal-power validators, a ManualClock
     500 ms behind genesis, 60 s propose/prevote/precommit timeouts, so
     that round 0 always completes and every block is a pure function of
     its height), each network's nodes sharing one hub on the card at its
     defaults. (a) LocalNetwork(3, device="cuda") to height 4: blocks 1-4
     and the seen commit at 4 byte-equal to the same network's on the host
     (device="cpu", no hub); heights/s, the hub's routes and cache hits,
     the ingest's pre_verified / unverified. (c) On that network, node 0
     crashes at fail point 3 (block saved, end-height marker written)
     at a height whose successor it proposes, its WAL's last write torn;
     a second Node on its stores, app and WAL directory (device="cuda")
     repairs the WAL (`report_wal_repair`'s lines printed), replays, and
     commits the next height with the others. (b) LocalNetwork(3,
     key_type="bls12381") with commit_scheme "bls-aggregate" to height 3:
     blocks 2 and 3 carry aggregate LastCommits whose checks launch K7a
     and K7b on the card, each check's wall and host/card split printed,
     and blocks 1-3 byte-equal to the same network on the host (a hub on
     the CPU, whose verdict cache answers repeated checks). K7a and K7b
     are held at its pairing shape with phases 17-18's;
 25. node-to-node block-sync over TCP with the secret connection (after
     phase 24): phase 12's 150-validator chain (built once, shared) in a
     source `node.Node` on the card (the chain's stores and app,
     block-sync off, one TCPTransport on 127.0.0.1) and a fresh joiner
     Node (block-sync on) that dials it through its peer manager; both
     start with VerifyHubConfig(max_batch=16,384) and share one hub. The
     joiner syncs through its Router in the reactor's default windows of
     64 blocks (6,464 signatures at light semantics, one hub dispatch
     each), the source serving the chain's first 192 blocks (cut from
     256 for phase 27): blocks 1-191 must be byte-equal to the chain and its
     State the chain's at 191; every range must route as the cutoff says
     ("cuda" from MIN_TPU_BATCH), at least two on the card, with B1-B3
     launched, no PeerError and no hub error. Prints blocks/s beside
     phase 12's hand-fed replay (the difference is the router's and the
     secret connection's cost), each range, the hub's dispatches by route
     and the bytes each TCP connection moved (flowrate Meters). Then a
     byzantine source (a copy of the chain's stores) that serves up to
     block 101, whose LastCommit carries a flipped signature bit: a second
     joiner that knows only it (its first range waits until its pool
     holds those 101 blocks, so the range holding height 100 is blocks
     65-100 in every run) must fail that range on the card (the
     card's bitmap flags exactly that signature), punish height 100 with
     a fatal PeerError naming it (the Router drops it, the peer manager's
     score falls below its connect score), apply nothing from height 100
     on; the byzantine node then stops, the joiner is given the honest
     source and finishes byte-equal to the chain;
 26. a validator network of full Nodes (after phase 25): the frozen-clock
     recipe on three `node.Node`s over one MemoryNetwork (3 equal-power
     ed25519 validators, NodeConfig(clock=ManualClock(...)) 500 ms behind
     genesis), a tx in the first proposer's mempool before its consensus
     starts, to height 4 on the card (the nodes' hub on the card) and then
     on the host (device="cpu", no hub): every node must store the same
     blocks, the tx must be committed in block 1 and queried on every
     node, and the two runs' block bytes and app-hash chains must be
     equal. Commits of 3 signatures stay under the cutoff: no Edwards
     kernel is expected here (phase 25 reaches them); heights/s printed
     for both runs;
 27. the scenario harness on the card (after phase 26; consensus/
     scenarios.py over RouterNet: N consensus nodes, each behind its own
     p2p Router over a chaos-wrapped memory transport with a real
     ConsensusReactor, the nodes sharing one hub on the card): (a) every
     scenario of the registry (17: network, storage, clock and Byzantine
     faults) at 4 validators with bench.py's chaos_soak parameters (target
     height 3, seed 7, stall 25 s), each `ok` with a green safety audit;
     per scenario its blocks/s, recover_s, fault counters, the hub's
     dispatches by route and the launches; (b) the determinism
     construction of tests/test_routernet.py:315 (3 validators, frozen
     clock, corruption, clock skew and a one-way cut on the byte path) on
     the card and on the host: blocks 1-3 and the app-hash chain
     byte-equal; (c) 4 bls12381 validators with aggregate commits over
     RouterNet under lossy_links' fault rates to height 3: blocks 2-3
     carry aggregate LastCommits, every aggregate check launches K7a and
     K7b, whose shapes join phases 17-18's and 24's in the pairing audit;
     (d) run_boot_wave(n_vals=4, n_joiners=2) and run_light_attack(
     n_vals=3), both `ok`, the lunatic fork detected and its evidence
     committed; (e) baseline at 50 validators with bench.py's committee
     parameters (target 2, time_scale 4, stall 90 s, degree 8, seed 7).
     A device error raises out of the runner: no wedge hides one;
 11. the shape audit: every input shape that the ed25519 and sr25519
     ranges (phases 3 and 7), their tampered twins (phases 4 and 7: the
     per-commit search and the attribution through kernel_sig), the
     block-sync replay and its tampered pass (phase 12, two-chunk ranges
     included), the light paths (phase 13: the 7-chunk range, the
     client's windows, the tampered range), the 48-height per-signature
     backfill of phase 18, the sharded paths of phase 19, the daemon's
     packed ranges (phase 20), the wide tx flood (phase 21) and the wide
     and tampered vote bursts (phase 23) and the node block-sync and its
     byzantine pass (phase 25) gave B1, B2 and B3 is held
     against the plain version with torch.equal, on the inputs the path
     gave and on worst-case inputs of the same shapes; phase 2's sizes
     must be sizes the main path gives; the largest size of each kernel
     on the ed25519, sr25519, block-sync and light paths and the 48-height
     backfill gets a timed `kernels` row of its own.

Each path's launch counts are set to 0 just before it and read just
after (the block-sync reactor verifies in a worker thread; its launches
count too). Prints the card's name and power limit, `breakdown`,
`sr25519`, `mixed`, `cutoff`, `hub`, `blocksync`, `light`, `bls`,
`statesync`, `sha256`, `light_fleet`, `statesync_fleet`, `sharded`,
`verifyd`, `tx_ingress`, `evidence`, `consensus_ingest`,
`consensus_live`, `node_blocksync`, `node_net`, `scenarios`,
`fleet_pairing_shapes` (K7a/K7b at phases 17-18's, 24's and 27's
shapes), `shapes`, `sharded_rows`, `slice`,
`kernels` and `script_wall_s`
JSON lines, and last {"ok": true,
"device": {...}}. Imports nothing of JAX or of the JAX
package. Build output goes to build/torch_ext/.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import random
import subprocess
import sys
import time

N_VALS = 150
N_COMMITS = 54
N_SR_COMMITS = 8
N_MIXED_COMMITS = 4
CHAIN_ID = "smoke-chain"
TAMPER_COMMIT, TAMPER_VAL = 20, 5
SR_TAMPER_COMMIT, SR_TAMPER_VAL = 3, 7
HUB_MAX_BATCH = 8192
SEED = 20261016
# phase 12, bench.py's block-sync bench (BASELINE config 3): 150
# validators of power 10, a kvstore chain of 256 blocks (cut from 1,024, and
# bench.py's 10k, to keep the script in its time limit with phase 19),
# window 108
N_BS_BLOCKS = 256
BS_WINDOW = 108
BS_CHAIN_ID = "bs-bench"
# the tampered pass: the commit for BS_TAMPER_HEIGHT carries one flipped
# signature bit; the peer serves up to the block that carries it, then,
# once the reactor has punished the height, two windows
BS_TAMPER_HEIGHT, BS_TAMPER_VAL = 100, 5
BS_TAMPER_TOP = 2 * BS_WINDOW + 1
BS_TIMEOUT_S = 600
# phase 13, bench.py's light-client bench (BASELINE config 2): 150
# validators of power 10, 500 signed headers (cut from bench.py's 1,000 to
# make room for phases 20-22), one verify_adjacent_chain
N_LC_HEADERS = 500
LC_CHAIN_ID = "light-bench"
LC_BASE_TS = 1_700_000_000_000_000_000
# the tampered pass: the commit for LC_TAMPER_HEIGHT carries one flipped
# signature bit; its place in the range, (490 - 2) * 101 + 5 = 49,293,
# lies past 6 * 8,192, in the last kernel_eq chunk
LC_TAMPER_HEIGHT, LC_TAMPER_VAL = 490, 5
# phase 14, bench.py's bench_commit_ab(150, 4), its bls_aggregate half:
# 150 bls12381 validators, 2 commits (cut from 4, to keep the script in its
# time limit with phase 19: each costs ~7 s to sign and ~18 s to verify
# twice, hash-to-curve and line preparation on the host) folded into
# aggregates
N_AB_COMMITS = 2
AB_CHAIN_ID = "ab-chain"
AB_SEED = b"ab-bls_aggregate"
AB_BASE_TS = 1_700_000_000_000_000_000
# the tampered aggregate: this validator signs other bytes before the
# aggregation; the tampered per-signature commit: a flipped bit in its
# signature
AB_TAMPER_VAL = 7
# phase 15, bench.py's bench_statesync(64, 21) (BASELINE config 5): 21
# ed25519 validators of power 10, a 64-block kvstore chain (snapshots every
# 10 heights: the restore takes the one at 60 and backfills 59 headers in
# one window); the tampered window's commit at this height carries a
# flipped bit in signature 0. Then the BLS-committee backfill: a light
# chain of this many heights of 21 bls12381 validators, each commit folded
# into its aggregate; the tampered height's aggregate has validator
# AB_TAMPER_VAL's signature over other bytes
N_SS_BLOCKS = 64
N_SS_VALS = 21
# the newest snapshot whose heights h + 1 and h + 2 exist to verify it
SS_SNAPSHOT_HEIGHT = 60
SS_TAMPER_HEIGHT = 30
N_SS_BLS_HEIGHTS = 16
SS_BLS_TAMPER_INDEX = 5
SS_CHAIN_ID = "ss-bls-chain"
# phase 17, bench.py's bench_light_fleet(150, 64, 6): 64 clients syncing to
# height 6 through one LightD (LightDConfig(max_sessions=32)), per scheme:
# per_sig (ed25519) and bls_aggregate (bls12381), seeds b"lf-" + scheme
LF_VALS, LF_CLIENTS, LF_HEIGHTS = 150, 64, 6
LF_SESSIONS = 32
LF_CHAIN_ID = "lf-chain"
LF_TIMEOUT_S = 420.0
# the lunatic primary forges height 6; its colluders hold more than a
# third of the power (51 of 150), so the forgery passes the trusting check
LF_LUNATIC_SEED, LF_TRAITORS = 17, 51
# phase 18, bench.py's bench_statesync_fleet(64, 21, 8): the join wave of 8
# joiners on one donor, then the backfill A/B over 64 validators (seeds
# b"ssab-" + scheme). A 32-height per-signature window tallies 43 of the 64
# signatures a height (light semantics): 1,376, under the clamped cutoff
# (2,048); the 48-height window (2,064) reaches it. The BLS half is cut
# from 32 heights to 6, to keep phases 17-18 near 200 s: a height costs
# ~3.5 s to sign (pure Python, ~55 ms a signature) and ~4.3 s to verify
# (64 hash-to-curve calls and 65 line preparations on the host)
SSF_BLOCKS, SSF_VALS, SSF_JOINERS = 64, 21, 8
SSF_AB_VALS, SSF_AB_HEIGHTS, SSF_DEEP_HEIGHTS, SSF_BLS_HEIGHTS = 64, 32, 48, 6
SSF_CHAIN_ID = "ssab-chain"
SSF_TIMEOUT_S = 420.0
# phase 16, bench.py's bench_merkle leaves half: 250-byte leaves
MERKLE_LEAVES = (64, 1024, 16384)
# phase 16's checks of B8: the batch widths (around its 32 messages a
# thread block, the reference's 4,096 bucket, the 16,384-leaf level) and
# the message lengths mixed in each (the padding edges, the leaves)
SHA_COUNTS = (1, 31, 32, 33, 4096, 4097, 16384)
SHA_LENGTHS = (0, 1, 55, 56, 63, 64, 65, 119, 120, 250, 251, 503)
# the batch widths at which phase 16 races the device route against hashlib
CROSSOVER_WIDTHS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, and the
# CUDA-core float32 rate (an FMA counted as two operations). All three
# kernels run their convolutions in FP32 FFMA at that rate; the int32
# carries issue at half of it, so for those the operation bound below is
# optimistic by up to 2x.
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12

# Operations per element, counted from the kernels' arithmetic (a
# multiply-add is two operations, as in the peak rate):
#   multiply: 32x32 convolution (2048), fold x38 (64), 4 carry passes of
#   and/shift/add over 32 limbs plus the x38 wrap (4 * 97)
#   squaring: the 496 cross products and 32 squares (2 * 528), doubling
#   the 64 cross sums (64), then the same fold and carries
FE_CARRY_OPS = 4 * (3 * 32 + 1)
FE_MUL_OPS = 2 * 32 * 32 + 2 * 32 + FE_CARRY_OPS
FE_SQR_OPS = 2 * 528 + 64 + 2 * 32 + FE_CARRY_OPS
FE_SUB_OPS = 32 + 2 * (3 * 32 + 1)  # - b (the 8p added is zero), two carry passes
FE_ADD_OPS = 32 + (3 * 32 + 1)
# the pow22523 chain: 251 squarings + 11 multiplies (csrc/fe_pow22523.cu)
POW22523_OPS = 251 * FE_SQR_OPS + 11 * FE_MUL_OPS
ADD_CACHED_OPS = 8 * FE_MUL_OPS + 3 * FE_SUB_OPS + 3 * FE_ADD_OPS
LIMB_BYTES = 32 * 4

# The BLS kernels (K7a, K7b), counted in 381-bit products, as the
# reference's formulas give them, whatever the kernels compute instead:
# an Fq12 product is 144 Fp products; a Miller step 2 Fq12 products, 3 on
# the 5 steps with an addition line; the final exponentiation the pair
# product (one fewer than the lanes), 8 Fq12 products and 6 Frobenius^2
# maps (12 Fp products each) in the easy part, 612 Fp products of the
# Fermat inverse and its norm, then the scan of the hard part's bits
# (bls_pairing.HARD_STEP_BITS: 1,267 squarings and 632 multiplies). The
# work is what this run's data needs: a pad lane (every line exactly 1)
# needs no Miller loop and a lane of value one no product, so the bound
# counts the other lanes (PR 7's rows counted every lane). One 381-bit
# product is priced at 12 x 12 32-bit multiply-adds, twice for the
# reduction, at the rate above (a multiply-add is two operations).
FP381_OPS = 2 * 2 * 12 * 12
F12_FP = 144
BLS_LIMB_BYTES = 49 * 4
MILLER_F12 = 63 * 2 + 5


def _miller_cost(m: int, npairs: int, real: int) -> tuple[int, int]:
    """K7a's (bytes, operations) with `real` lanes that are not pads: px,
    py and four (63, lanes, 2, 49) line arrays in (every lane is read),
    (lanes, 6, 2, 49) out."""
    lanes = m * npairs
    n_bytes = BLS_LIMB_BYTES * lanes * (2 + 4 * 63 * 2 + 12)
    return n_bytes, real * MILLER_F12 * F12_FP * FP381_OPS


def _final_exp_chain(lanes: int) -> tuple[int, int]:
    """The reference's chain for an item of `lanes` lanes: (Fq12
    products, Fp products)."""
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP

    f12 = max(lanes - 1, 0) + 8 + len(BP.HARD_STEP_BITS) + int(BP.HARD_STEP_BITS.sum())
    return f12, f12 * F12_FP + 6 * 12 + 612


def _final_exp_cost(m: int, npairs: int, real: list) -> tuple[int, int]:
    """K7b's (bytes, operations), item i with real[i] lanes that are not
    one: (m, npairs, 6, 2, 49) in, (m, 6, 2, 49) and m flags out."""
    n_bytes = BLS_LIMB_BYTES * 12 * (m * npairs + m) + m
    return n_bytes, sum(_final_exp_chain(n)[1] for n in real) * FP381_OPS


# B8 (sha256) is 32-bit integer work: the H100's rate for it is 64 INT32
# lanes per SM (the SM's four partitions of 16), 132 SMs, at the SM clock
# (`nvidia-smi --query-gpu=clocks.max.sm`; 1,980 MHz on the H100 SXM). Its
# operations per compression block, counted as sm_90 instructions (any
# logic of three inputs is one LOP3, a sum of three one IADD3, a rotation
# one SHF): 48 schedule words of 10 (sigma0 and sigma1 4 each: two
# rotations, a shift, one LOP3; the four-term sum 2), 64 rounds of 14
# (Sigma1 4, Ch 1, T1's five terms 2, Sigma0 4, Maj 1, e 1, a 1), and the
# 8 adds into the state. Phase 16 also counts the integer instructions in
# the block loop of the built SASS, which holds both of the kernel's ways of
# reading a block's words (whole, or with the padding), so more than a
# block issues; the bound takes the smaller count.
INT32_LANES_PER_SM = 64
H100_SMS = 132
SHA256_BLOCK_OPS = 48 * 10 + 64 * 14 + 8
#: the rounds' dependent chain, counted from csrc/sha256.cu: e's recurrence
#: e' = (d + h + K + W) + Sigma1(e) + Ch(e, f, g), the bracket ready before
#: e, is three dependent instructions a round (Sigma1's SHFs, their LOP3,
#: the IADD3; Ch's LOP3 beside them); a's is no longer. 64 rounds and the
#: add into the state a block.
SHA256_ROUND_DEPTH = 3
SHA256_BLOCK_DEPTH = 64 * SHA256_ROUND_DEPTH + 1
#: SASS opcodes counted as integer work (moves, loads, stores, compares
#: and branches are left out)
_SASS_INT_OPS = {"LOP3", "LOP", "IADD3", "IADD", "SHF", "SHL", "SHR", "IMAD", "PRMT", "LEA"}


def _sass_block_ops(source: str = "sha256", kernel: str = "sha256_bytes_kernel") -> int | None:
    """The integer instructions in `kernel`'s block loop in the SASS of
    the built csrc/`source`.cu (cuobjdump): those between the loop's
    backward branch and its target, of the opcodes in _SASS_INT_OPS,
    IMAD.MOV (a move) left out. None when the toolkit has no cuobjdump."""
    import re
    from pathlib import Path

    from tendermint_tpu_torch.crypto.cuda import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    lib = _build.build_all()[source]
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    body = next(f for f in sass.split("Function : ")[1:] if kernel in f.split("\n", 1)[0])
    code, labels, pending = [], {}, []
    for line in body.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if ins:
            addr = int(ins.group(1), 16)
            labels.update((name, addr) for name in pending)
            pending = []
            code.append((addr, re.sub(r"^@!?U?P\w+\s+", "", ins.group(2))))
    loops = []
    for addr, text in code:
        if text.split()[0].split(".")[0] != "BRA":
            continue
        label, hexa = re.search(r"`\((\.L_x_\d+)\)", text), re.search(r"0x([0-9a-f]+)", text)
        to = labels.get(label.group(1)) if label else int(hexa.group(1), 16) if hexa else None
        if to is not None and to <= addr:
            loops.append((addr - to, to, addr))
    if not loops:
        raise AssertionError(f"{kernel}: no loop found in the SASS of {lib}")
    _, lo, hi = max(loops)
    return sum(1 for addr, text in code if lo <= addr <= hi
               and text.split()[0].split(".")[0] in _SASS_INT_OPS
               and not text.startswith("IMAD.MOV"))


def _sm_max_hz() -> float:
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return float(mhz) * 1e6


def _int32_ops_per_s() -> float:
    return H100_SMS * INT32_LANES_PER_SM * _sm_max_hz()


def _block_cycles(dev, reps: int = 5) -> dict:
    """B8's cycles a block, by one thread alone on the card
    (csrc/sha256.cu's sha256_cycles_kernel, timed by clock64), the least
    of `reps` launches at 55 bytes (one block) and 503 (eight): what one
    warp issues for a block (its block loop, the difference over seven),
    and the rounds' dependent chain alone (eight blocks of 64 rounds of
    SHA256_ROUND_DEPTH dependent instructions and the add into the
    state), the serial-chain bound's cycles a block."""
    import ctypes

    import torch

    from tendermint_tpu_torch.crypto.cuda import _build

    fn = ctypes.CDLL(str(_build.build_all()["sha256"])).sha256_cycles_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    msg = bytes((7 * j + 3) % 256 for j in range(503))
    src = torch.frombuffer(bytearray(msg), dtype=torch.uint8).to(dev)
    out = torch.empty(32, dtype=torch.uint8, device=dev)
    clk = torch.zeros(3, dtype=torch.int64, device=dev)
    least, chain = {}, []
    for n in (55, 503):
        runs = []
        for _ in range(reps):
            if fn(src.data_ptr(), n, out.data_ptr(), clk.data_ptr(), *_build.stream_args(src)):
                raise RuntimeError("sha256_cycles_kernel failed to launch")
            torch.cuda.synchronize()
            loop, rounds, _ = clk.tolist()
            runs.append(loop)
            chain.append(rounds)
            if bytes(out.cpu().tolist()) != hashlib.sha256(msg[:n]).digest():
                raise AssertionError(f"sha256_cycles_kernel ({n} bytes): digest differs from hashlib")
        least[n] = min(runs)
    chain_block = min(chain) / 8
    return {"one_warp_cycles_1_block": least[55], "one_warp_cycles_8_blocks": least[503],
            "one_warp_cycles_per_block": (least[503] - least[55]) / 7,
            "chain_cycles_per_block": chain_block, "chain_depth_per_block": SHA256_BLOCK_DEPTH,
            "cycles_per_dependent_instruction": chain_block / SHA256_BLOCK_DEPTH}


def _bound(n_bytes: float, n_ops: float, ops_per_s: float = CORE_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _time_ms(fn, reps: int) -> float:
    """Milliseconds per call on the card's clock (CUDA events around
    `reps` calls after a warm-up): what a caller pays, host gaps between
    launches included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(fn, reps: int = 1) -> list[tuple[str, int]]:
    """The card's own activity records (kernels, copies) of `reps` calls,
    from torch.profiler (CUPTI), as (name, ns). The profiler records the
    card's activity only, and its raw records are read without building
    its event tree: over the ~42k operations of a kernel_eq (~100k
    sharded) that tree takes seconds to tens of seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def _device_ms(fn, reps: int, name: str | None = None) -> float | None:
    """Device milliseconds per call: the summed duration of the card's
    activity records of one call (of kernels whose name holds `name`,
    when given). None when the profiler recorded no device activity."""
    events = [ns for n, ns in _device_events(fn, reps) if name is None or name in n]
    if not events:
        return None
    return sum(events) / reps / 1e6


def _limbs(gen, dev, shape, lo=0, hi=512):
    import torch

    return torch.randint(lo, hi, tuple(shape), generator=gen, dtype=torch.int32).to(dev)


def _field_inputs(gen, dev, shape):
    """A B1/B2 operand of `shape` (..., 32): the first half of its rows in
    [0, 512) with row 0 at 511 in every limb, the rest in [-511, 512)."""
    import torch

    rows = 1
    for d in shape[:-1]:
        rows *= d
    half = (rows + 1) // 2
    t = torch.cat([_limbs(gen, dev, (half, 32)), _limbs(gen, dev, (rows - half, 32), -511)])
    t[0] = 511
    return t.reshape(shape)


def _scan_inputs(gen, dev, chains, steps):
    """B3's operands: limbs in [0, 512), chain 0 at 511 in every limb
    (where the true 8p and the reference's zero part ways), chain 1 with
    y == x, and the upper half of the chains in [-300, 300)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import curve

    half = chains // 2
    first = [torch.cat([_limbs(gen, dev, (half, 32)),
                        _limbs(gen, dev, (chains - half, 32), -300, 300)])
             for _ in range(4)]
    rest = [torch.cat([_limbs(gen, dev, (steps, half, 32)),
                       _limbs(gen, dev, (steps, chains - half, 32), -300, 300)], 1)
            for _ in range(4)]
    for t in first:
        t[0] = 511
    for t in rest:
        t[:, 0] = 511
    if chains > 1:
        first[1][1] = first[0][1]
    return curve.Point(*first), curve.CachedPoint(*rest)


def _as_tensor(out):
    import torch

    return torch.stack(list(out)) if isinstance(out, tuple) else out


def _hold(kernel, what, run, plain) -> int:
    """Run `kernel`'s wrapper and its plain version; fail unless they are
    equal (integer arithmetic: the tolerance is zero). Returns the
    largest absolute difference (0)."""
    import torch

    got, want = _as_tensor(run()), _as_tensor(plain())
    if got.is_cuda:
        torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{kernel.name} ({what}): kernel disagrees with its plain version")
    return int((got - want).abs().max().item())


def _kernel_row(kernel, m, run, plain, n_bytes, n_ops, reps, ops_per_s=CORE_OPS_PER_S) -> dict:
    """A `kernels` row: held against the plain version, then timed."""
    err = _hold(kernel, f"m={m}", run, plain)
    bound_ms, bound_by = _bound(n_bytes, n_ops, ops_per_s)
    # the kernel alone on the card (profiler), three repeats
    repeats = [_device_ms(run, reps, name=f"{kernel.name}_kernel") for _ in range(3)]
    wrappers = [_time_ms(run, reps) for _ in range(3)]
    measured = sorted(r for r in repeats if r is not None)
    ms = measured[len(measured) // 2] if measured else None
    wrapper_ms = sorted(wrappers)[1]
    plain_ms = _time_ms(plain, max(1, reps // 5))
    return {
        "name": kernel.name,
        "m": m,
        "route": "cuda",
        "source": f"tendermint_tpu_torch/crypto/cuda/csrc/{kernel.source}.cu",
        "replaces": kernel.replaces,
        "max_abs_err": err,
        "match": True,
        # else the CUDA-event time per wrapper call, which includes the
        # host's launch gap
        "ms": ms if ms is not None else wrapper_ms,
        "ms_source": "profiler" if ms is not None else "cuda_events",
        "ms_repeats": repeats,
        "share_of_bound": bound_ms / (ms if ms is not None else wrapper_ms),
        # CUDA events per call through the wrapper: what a caller pays
        "wrapper_ms": wrapper_ms,
        "wrapper_ms_repeats": wrappers,
        "plain_ms": plain_ms,
        "plain_device_ms": _device_ms(plain, 1),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_ops_per_s": ops_per_s,
        "library_ms": None,  # no single PyTorch call computes these
    }


def check_kernels(dev) -> list[dict]:
    """Phase 2: each kernel against its plain version on the card."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import _build, msm
    from tendermint_tpu_torch.crypto.cuda import field as F

    gen = torch.Generator(device="cpu").manual_seed(SEED)

    def limbs(*shape):
        return _limbs(gen, dev, shape + (32,))

    rows = []

    def record(*args, **kw):
        rows.append(_kernel_row(*args, **kw))

    # B1 at 8,192 elements (the R-side width), row 0 the all-511 worst
    # case; and at 1 and 64 elements, where most main-path launches land
    for m, reps in ((8192, 200), (64, 1000), (1, 1000)):
        a, b = limbs(m), limbs(m)
        a[0], b[0] = 511, 511
        record(F.FE_MUL, m, lambda a=a, b=b: F.mul(a, b), lambda a=a, b=b: F._mul_plain(a, b),
               3 * LIMB_BYTES * m, FE_MUL_OPS * m, reps=reps)

    # B2 at 8,319 elements: the 8,192 R points and 127 keys, one decompress
    z = limbs(8319)
    z[0] = 511
    record(F.FE_POW22523, 8319, lambda: F.pow22523(z), lambda: F._pow22523_plain(z),
           2 * LIMB_BYTES * 8319, POW22523_OPS * 8319, reps=20)

    # B3 at the R-side MSM (16 windows x g = 512 blocks = 8,192 chains of
    # 15 cached additions) and at the A side (16 windows x 16 blocks)
    steps = msm._BLOCK - 1
    for chains, reps in ((16 * 512, 20), (16 * 16, 100)):
        first, rest = _scan_inputs(gen, dev, chains, steps)
        record(msm.SCAN_BLOCKS, chains, lambda f=first, r=rest: msm.scan_blocks(f, r),
               lambda f=first, r=rest: msm._scan_blocks_plain(f, r),
               chains * LIMB_BYTES * 4 * (1 + steps + steps + 1),
               chains * steps * ADD_CACHED_OPS, reps=reps)
    for k in _build.KERNELS.values():
        k.launches = 0
    return rows


class ShapeAudit:
    """The shapes each kernel wrapper is given on a path: `recording(path)`
    wraps field.mul (B1), field.pow22523 (B2) and msm.scan_blocks (B3)
    while a path runs, and keeps, per kernel and input shapes, the first
    inputs given at those shapes and the calls on each path. The wrappers
    themselves and their launch counts are untouched."""

    def __init__(self):
        #: (kernel name, input shapes) -> {"inputs": [...], "calls": {path: n}}
        self.seen: dict[tuple, dict] = {}

    @contextlib.contextmanager
    def recording(self, path: str):
        from tendermint_tpu_torch.crypto.cuda import field as F
        from tendermint_tpu_torch.crypto.cuda import msm

        real_mul, real_pow, real_scan = F.mul, F.pow22523, msm.scan_blocks

        def note(kernel, tensors):
            key = (kernel.name, tuple(tuple(t.shape) for t in tensors))
            rec = self.seen.get(key)
            if rec is None:
                rec = self.seen[key] = {"inputs": [t.clone() for t in tensors], "calls": {}}
            rec["calls"][path] = rec["calls"].get(path, 0) + 1

        def mul(a, b):
            note(F.FE_MUL, (a, b))
            return real_mul(a, b)

        def pow22523(z):
            note(F.FE_POW22523, (z,))
            return real_pow(z)

        def scan_blocks(first, rest):
            note(msm.SCAN_BLOCKS, (*first, *rest))
            return real_scan(first, rest)

        F.mul, F.pow22523, msm.scan_blocks = mul, pow22523, scan_blocks
        try:
            yield
        finally:
            F.mul, F.pow22523, msm.scan_blocks = real_mul, real_pow, real_scan


def _kernel_case(name: str, inputs: list, gen, dev) -> tuple:
    """(kernel, m, run, plain, bytes moved, operations) for one call of
    kernel `name` on `inputs`, or, with `gen`, on worst-case inputs of
    the same shapes: row 0 at 511 in every limb, equal operands (row 1
    of a multiply, chain 1 of a scan with y == x) and signed limbs."""
    from tendermint_tpu_torch.crypto.cuda import curve, msm
    from tendermint_tpu_torch.crypto.cuda import field as F

    if name == F.FE_MUL.name:
        a, b = inputs
        if gen is not None:
            a, b = _field_inputs(gen, dev, a.shape), _field_inputs(gen, dev, b.shape)
            if a.shape == b.shape and a.numel() >= 2 * F.LIMBS:
                b.view(-1, F.LIMBS)[1] = a.view(-1, F.LIMBS)[1]
        m = max(a.numel(), b.numel()) // F.LIMBS
        return (F.FE_MUL, m, lambda: F.mul(a, b), lambda: F._mul_plain(a, b),
                4 * (a.numel() + b.numel()) + LIMB_BYTES * m, FE_MUL_OPS * m)
    if name == F.FE_POW22523.name:
        (z,) = inputs
        if gen is not None:
            z = _field_inputs(gen, dev, z.shape)
        m = z.numel() // F.LIMBS
        return (F.FE_POW22523, m, lambda: F.pow22523(z), lambda: F._pow22523_plain(z),
                2 * LIMB_BYTES * m, POW22523_OPS * m)
    chains, steps = inputs[0].shape[0], inputs[4].shape[0]
    if gen is not None:
        first, rest = _scan_inputs(gen, dev, chains, steps)
    else:
        first, rest = curve.Point(*inputs[:4]), curve.CachedPoint(*inputs[4:])
    return (msm.SCAN_BLOCKS, chains, lambda: msm.scan_blocks(first, rest),
            lambda: msm._scan_blocks_plain(first, rest),
            chains * LIMB_BYTES * 4 * (1 + steps + steps + 1), chains * steps * ADD_CACHED_OPS)


#: repeats of a timed `kernels` row added by the shape audit
_AUDIT_REPS = {"fe_mul": 200, "fe_pow22523": 20, "scan_blocks": 50}


def audit_shapes(dev, audit: ShapeAudit, rows: list[dict], timed_paths: tuple) -> dict:
    """Phase 11: hold each kernel against its plain version at every input
    shape a recorded path gave it, on the inputs the path gave it there
    and on worst-case inputs of those shapes (torch.equal: the tolerance
    is zero). Fail unless phase 2 timed each kernel at sizes the first of
    `timed_paths` (the main path) gave it. Then add a timed `kernels` row
    for the largest size of each kernel on each of `timed_paths` that
    has no row yet. Returns the shapes held, by kernel."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(SEED + 11)
    held: dict[str, list] = {}
    sizes: dict[tuple, dict] = {}  # (path, kernel) -> {m: inputs}
    for (name, shapes), rec in sorted(audit.seen.items(), key=lambda kv: kv[0]):
        for source, g in (("path", None), ("worst case", gen)):
            kernel, m, run, plain, _b, _o = _kernel_case(name, rec["inputs"], g, dev)
            _hold(kernel, f"shapes {list(shapes)}, {source} inputs", run, plain)
        held.setdefault(name, []).append({"shapes": [list(x) for x in shapes],
                                          "m": m, "calls": rec["calls"]})
        for path in rec["calls"]:
            sizes.setdefault((path, name), {}).setdefault(m, rec["inputs"])
    main = timed_paths[0]
    for row in rows:
        if row["m"] not in sizes.get((main, row["name"]), {}):
            raise AssertionError(f"{row['name']} timed at m={row['m']}, a size {main} "
                                 f"never gives it: {sorted(sizes.get((main, row['name']), {}))}")
    timed = {(r["name"], r["m"]) for r in rows}
    for path in timed_paths:
        for (p, name), by_m in sorted(sizes.items()):
            m = max(by_m)
            if p != path or (name, m) in timed:
                continue
            kernel, m, run, plain, n_bytes, n_ops = _kernel_case(name, by_m[m], gen, dev)
            row = _kernel_row(kernel, m, run, plain, n_bytes, n_ops, reps=_AUDIT_REPS[name])
            row["shape_of"] = path
            rows.append(row)
            timed.add((name, m))
    return held


def build_commits(n_vals: int, n_commits: int, key_types=("ed25519",)):
    from tendermint_tpu_torch import testing as tt

    vals, keys = tt.make_validator_set(n_vals, key_types=key_types)
    entries = []
    for h in range(1, n_commits + 1):
        bid = tt.make_block_id(b"smoke-%d" % h)
        entries.append((vals, bid, h, tt.make_commit(CHAIN_ID, h, 0, bid, vals, keys)))
    return entries


def all_items(entries):
    return [
        (vals.validators[i].pub_key.bytes(), commit.vote_sign_bytes(CHAIN_ID, i), cs.signature)
        for vals, _bid, _h, commit in entries
        for i, cs in enumerate(commit.signatures)
    ]


def range_items(entries, chain_id=CHAIN_ID):
    """The (pub, msg, sig) triples verify_commit_range batches: per commit,
    block votes in index order up to the first tally above 2/3."""
    out = []
    for vals, _bid, _h, commit in entries:
        need, tallied = vals.total_voting_power() * 2 // 3, 0
        for i, cs in enumerate(commit.signatures):
            if not cs.is_commit():
                continue
            val = vals.validators[i]
            out.append((val.pub_key.bytes(), commit.vote_sign_bytes(chain_id, i), cs.signature))
            tallied += val.voting_power
            if tallied > need:
                break
    return out


def tamper(entries, ci: int, vi: int):
    from dataclasses import replace

    vals, bid, h, commit = entries[ci]
    sigs = list(commit.signatures)
    s = sigs[vi].signature
    sigs[vi] = replace(sigs[vi], signature=s[:40] + bytes([s[40] ^ 1]) + s[41:])
    out = list(entries)
    out[ci] = (vals, bid, h, replace(commit, signatures=tuple(sigs)))
    return out


def drive_main_path(dev, entries, audit: ShapeAudit) -> dict:
    """Phase 3: the port's main path, with the launch counts around it;
    its first call's kernel shapes go into `audit` (a dictionary lookup
    per wrapper call, and a copy of the inputs at each new shape)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import _build, verify as V
    from tendermint_tpu_torch.types.validation import verify_commit_range

    n_range = len(range_items(entries))
    for k in _build.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    with audit.recording(ED_MAIN):
        verify_commit_range(CHAIN_ID, entries, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in _build.KERNELS.items()}

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        verify_commit_range(CHAIN_ID, entries, device=dev)
        walls.append(time.perf_counter() - t0)
    walls.sort()

    items = all_items(entries)
    t0 = time.perf_counter()
    bitmap = V.verify_batch_eq(items, dev)
    batch_s = time.perf_counter() - t0
    if not bitmap.all() or len(bitmap) != len(items):
        raise AssertionError("verify_batch_eq rejected valid signatures")

    # the host floor: the same range signatures, one by one on every core
    from tendermint_tpu_torch.crypto.batch import CPUBatchVerifier
    from tendermint_tpu_torch.crypto.ed25519 import _HAVE_OPENSSL, Ed25519PubKey

    cpu_items = range_items(entries)
    bv = CPUBatchVerifier(parallel=True)
    for pub, msg, sig in cpu_items:
        bv.add(Ed25519PubKey(pub), msg, sig)
    t0 = time.perf_counter()
    ok, _ = bv.verify()
    cpu_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("host verification rejected valid signatures")
    return {
        "launches": launches,
        "slice": {
            "entry": "verify_commit_range",
            "commits": len(entries),
            "validators": len(entries[0][0]),
            "sigs": n_range,
            "bucket": V._bucket(n_range),
            "group_bucket": V._group_bucket(len(entries[0][0])),
            "first_wall_s": first_s,
            "wall_s": walls[1],
            "sigs_per_s": n_range / walls[1],
            "batch_eq": {
                "entry": "verify_batch_eq",
                "sigs": len(items),
                "bucket": V._bucket(len(items)),
                "wall_s": batch_s,
                "sigs_per_s": len(items) / batch_s,
            },
            "cpu_floor": {
                "entry": "CPUBatchVerifier(parallel=True)",
                "sigs": len(cpu_items),
                "cores": os.cpu_count(),
                "openssl": _HAVE_OPENSSL,
                "wall_s": cpu_s,
                "sigs_per_s": len(cpu_items) / cpu_s,
            },
        },
    }


def breakdown(dev, entries) -> dict:
    """Where one range-sized batch spends its time: host resolve and prep,
    the copy to the card, and one `kernel_eq` call — its wall time, the
    card's busy time inside it (profiler), the idle share, and the kernels
    that took the most device time."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import verify as V

    items = range_items(entries)
    t0 = time.perf_counter()
    resolved = [V.resolve_ed25519(*it) for it in items]
    t1 = time.perf_counter()
    ops = V.prepare_batch_eq(resolved, pad_to=V._bucket(len(items)))
    t2 = time.perf_counter()
    dev_ops = V._to_device(ops, dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()

    def step():
        _bitmap, eq_ok = V.kernel_eq(*dev_ops)
        if not bool(eq_ok):
            raise AssertionError("kernel_eq rejected a valid batch")

    step()  # warm
    t4 = time.perf_counter()
    step()
    wall = time.perf_counter() - t4
    events = _device_events(step)

    # B1's host side inside one kernel_eq: seconds spent in field.mul (the
    # wrapper, its checks and the ctypes launch), and its calls by size
    from tendermint_tpu_torch.crypto.cuda import field as F

    real_mul, mul_s, mul_calls = F.mul, [0.0], {}

    def timed_mul(a, b):
        t = time.perf_counter()
        out = real_mul(a, b)
        mul_s[0] += time.perf_counter() - t
        m = out.numel() // F.LIMBS
        mul_calls[m] = mul_calls.get(m, 0) + 1
        return out

    F.mul = timed_mul
    try:
        t5 = time.perf_counter()
        step()
        timed_wall = time.perf_counter() - t5
    finally:
        F.mul = real_mul
    busy = sum(ns for _, ns in events) / 1e9
    by_name: dict[str, list] = {}
    for name, ns in events:
        rec = by_name.setdefault(name, [0.0, 0])
        rec[0] += ns / 1e6
        rec[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    ported = {
        k: sum(ms for name, (ms, _n) in by_name.items() if f"{k}_kernel" in name)
        for k in ("fe_mul", "fe_pow22523", "scan_blocks")
    }
    return {
        "entry": "kernel_eq",
        "sigs": len(items),
        "bucket": V._bucket(len(items)),
        "host_resolve_s": t1 - t0,
        "host_prep_s": t2 - t1,
        "to_device_s": t3 - t2,
        "kernel_eq_wall_s": wall,
        "device_busy_s": busy if events else None,
        "device_idle_share": (1 - busy / wall) if events else None,
        "device_activities": len(events),
        "ported_kernels_device_ms": ported,
        "fe_mul_calls": sum(mul_calls.values()),
        "fe_mul_host_s": mul_s[0],
        "fe_mul_host_ms_per_call": mul_s[0] / max(1, sum(mul_calls.values())) * 1e3,
        "fe_mul_calls_by_m": {str(m): n for m, n in sorted(mul_calls.items())},
        "kernel_eq_wall_s_with_fe_mul_timed": timed_wall,
        "top_device_ms": [[name[:140], ms, n] for name, (ms, n) in top],
    }


def drive_tampered(dev, entries) -> None:
    """Phases 4 and 5: a planted bad signature is found, attributed, and
    the bitmap agrees with host single verification."""
    from tendermint_tpu_torch.crypto.cuda import verify as V
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from tendermint_tpu_torch.types.validation import InvalidCommitError, verify_commit_range

    bad = tamper(entries, TAMPER_COMMIT, TAMPER_VAL)
    try:
        verify_commit_range(CHAIN_ID, bad, device=dev)
    except InvalidCommitError as e:
        if getattr(e, "failed_index", None) != TAMPER_COMMIT:
            raise AssertionError(f"failed_index {getattr(e, 'failed_index', None)}") from e
        if f"index {TAMPER_VAL}" not in str(e):
            raise AssertionError(f"wrong signature blamed: {e}") from e
    else:
        raise AssertionError("tampered range verified")

    items = range_items(bad)
    per_commit = len(items) // len(bad)
    bad_pos = TAMPER_COMMIT * per_commit + TAMPER_VAL
    calls = []
    kernel_sig = V.kernel_sig

    def counted_kernel_sig(*ops):
        calls.append(1)
        return kernel_sig(*ops)

    V.kernel_sig = counted_kernel_sig
    try:
        bitmap = V.verify_resolved([V.resolve_ed25519(*it) for it in items], dev)
    finally:
        V.kernel_sig = kernel_sig
    if calls != [1] or bitmap[bad_pos] or int(bitmap.sum()) != len(items) - 1:
        raise AssertionError("verify_resolved did not attribute the tampered signature")

    rng = random.Random(SEED)
    sample = sorted(set(rng.sample(range(len(items)), min(255, len(items)))) | {bad_pos})
    for i in sample:
        pub, msg, sig = items[i]
        if bool(bitmap[i]) != Ed25519PubKey(pub).verify_signature(msg, sig):
            raise AssertionError(f"bitmap entry {i} disagrees with host verification")
    print(f"cross-check: {len(sample)} bitmap entries agree with host verification")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _launch_counts(reset: bool = False) -> dict:
    """The kernels' launch counts (and set them to 0 when `reset`)."""
    from tendermint_tpu_torch.crypto.cuda import _build

    counts = {name: k.launches for name, k in _build.KERNELS.items()}
    if reset:
        for k in _build.KERNELS.values():
            k.launches = 0
    return counts


#: the kernels of the Edwards paths (B1-B3); phase 14 checks K7a and K7b
EDWARDS_KERNELS = ("fe_mul", "fe_pow22523", "scan_blocks")


def _require_all_launched(path: str, launches: dict, names=EDWARDS_KERNELS) -> None:
    missing = [name for name in names if launches[name] == 0]
    if missing:
        raise AssertionError(f"{path}: {missing} were not launched")


def _expect_failure(fn, commit: int, val: int):
    """Run `fn`; it must raise InvalidCommitError naming signature `val` of
    commit `commit`. Returns the error."""
    from tendermint_tpu_torch.types.validation import InvalidCommitError

    try:
        fn()
    except InvalidCommitError as e:
        if getattr(e, "failed_index", commit) != commit:
            raise AssertionError(f"failed_index {getattr(e, 'failed_index', None)}") from e
        if f"index {val}" not in str(e):
            raise AssertionError(f"wrong signature blamed: {e}") from e
        return e
    raise AssertionError("a tampered signature verified")


ED_MAIN = "verify_commit_range[ed25519]"
ED_TAMPERED = "verify_commit_range[ed25519, tampered]"
SR_MAIN = "verify_commit_range[sr25519]"
SR_TAMPERED = "verify_commit_range[sr25519, tampered]"


def drive_sr25519(dev, audit: ShapeAudit) -> dict:
    """Phase 7: an sr25519 range through the same three kernels; the
    kernel shapes of the range and of the tampered range go into
    `audit`."""
    from tendermint_tpu_torch.crypto import sr25519
    from tendermint_tpu_torch.crypto.cuda import verify as V
    from tendermint_tpu_torch.types.validation import verify_commit_range

    t0 = time.perf_counter()
    entries = build_commits(N_VALS, N_SR_COMMITS, key_types=("sr25519",))
    sign_s = time.perf_counter() - t0
    items = range_items(entries)

    _launch_counts(reset=True)
    t0 = time.perf_counter()
    with audit.recording(SR_MAIN):
        verify_commit_range(CHAIN_ID, entries, device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    _require_all_launched("sr25519 verify_commit_range", launches)

    t0 = time.perf_counter()
    for it in items:
        V.resolve_sr25519(*it)
    resolve_s = time.perf_counter() - t0

    bad = tamper(entries, SR_TAMPER_COMMIT, SR_TAMPER_VAL)
    bad_items = range_items(bad)
    bad_pos = SR_TAMPER_COMMIT * (len(bad_items) // len(bad)) + SR_TAMPER_VAL
    with audit.recording(SR_TAMPERED):
        _expect_failure(lambda: verify_commit_range(CHAIN_ID, bad, device=dev),
                        SR_TAMPER_COMMIT, SR_TAMPER_VAL)
        bitmap = V.verify_resolved([V.resolve_sr25519(*it) for it in bad_items], dev)
    if bitmap[bad_pos] or int(bitmap.sum()) != len(bad_items) - 1:
        raise AssertionError("sr25519 bitmap does not single out the tampered signature")
    rng = random.Random(SEED + 7)
    sample = sorted(set(rng.sample(range(len(bad_items)), min(255, len(bad_items)))) | {bad_pos})
    for i in sample:
        if bool(bitmap[i]) != sr25519.verify(*bad_items[i]):
            raise AssertionError(f"sr25519 bitmap entry {i} disagrees with host verification")
    print(f"sr25519 cross-check: {len(sample)} bitmap entries agree with host verification")
    return {
        "entry": "verify_commit_range",
        "key_type": "sr25519",
        "commits": len(entries),
        "validators": len(entries[0][0]),
        "sigs": len(items),
        "bucket": V._bucket(len(items)),
        "sign_s": sign_s,
        "wall_s": wall,
        "sigs_per_s": len(items) / wall,
        "host_resolve_s": resolve_s,
        "host_resolve_us_per_sig": resolve_s / len(items) * 1e6,
        "launches": launches,
    }


def _dispatch_routes() -> list[str]:
    """Routes of the hub.dispatch spans in the trace ring, oldest first."""
    from tendermint_tpu_torch.libs import trace

    return [s["attrs"]["route"] for s in trace.RECORDER.dump(subsystem="hub")
            if s["name"] == "dispatch"]


def drive_mixed(dev) -> dict:
    """Phase 8: BASELINE config 4 — a mixed ed25519 + secp256k1 set
    through verify_commit_light inside a running hub."""
    from tendermint_tpu_torch.crypto import verify_hub
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.types.validation import verify_commit_light

    entries = build_commits(N_VALS, N_MIXED_COMMITS, key_types=("ed25519", "secp256k1"))
    vals = entries[0][0]
    types = sorted({v.pub_key.TYPE for v in vals.validators})
    if types != ["ed25519", "secp256k1"]:
        raise AssertionError(f"mixed set holds {types}")
    # the verdicts the host gives, signature by signature
    host = [vals.validators[i].pub_key.verify_signature(
                commit.vote_sign_bytes(CHAIN_ID, i), cs.signature)
            for _v, _b, _h, commit in entries for i, cs in enumerate(commit.signatures)]
    if not all(host):
        raise AssertionError("host verification rejected a valid mixed-set signature")
    secp = next(i for i, v in enumerate(vals.validators) if v.pub_key.TYPE == "secp256k1")
    bad = tamper(entries, 1, secp)
    trace.RECORDER.clear()
    hub = verify_hub.acquire_hub(device=dev)

    def requests():
        st = hub.stats()
        return st["submitted"] + st["cache_hits"] + st["coalesced"]

    try:
        _launch_counts(reset=True)
        per_commit = []
        t0 = time.perf_counter()
        for v, bid, h, commit in entries:
            before = requests()
            verify_commit_light(CHAIN_ID, v, bid, h, commit, device=dev)
            per_commit.append(requests() - before)
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        _v, bid, h, commit = bad[1]
        _expect_failure(lambda: verify_commit_light(CHAIN_ID, vals, bid, h, commit, device=dev),
                        1, secp)
        stats = verify_hub.running_hub().stats()
    finally:
        verify_hub.release_hub()
    if verify_hub.running_hub() is not None:
        raise AssertionError("release_hub left a running hub")
    routes = _dispatch_routes()
    sigs = len(range_items(entries))
    # light semantics: each commit's block votes in index order up to the
    # first tally above 2/3, each verified on its own on the host
    tally = [len(range_items([e])) for e in entries]
    if per_commit != tally:
        raise AssertionError(f"signatures verified per commit {per_commit}, light tally {tally}")
    if set(routes) != {"cpu"} or any(launches.values()):
        raise AssertionError(f"mixed set left the host: routes {set(routes)}, {launches}")
    return {
        "entry": "verify_commit_light",
        "key_types": types,
        "commits": len(entries),
        "validators": len(vals),
        "sigs": sigs,
        "wall_s": wall,
        "sigs_per_s": sigs / wall,
        "dispatches": {r: routes.count(r) for r in sorted(set(routes))},
        "hub_submitted": stats["submitted"],
        "host_verified_per_commit": per_commit,
        "light_tally_per_commit": tally,
        "launches": launches,
    }


def drive_hub(dev, entries, direct: dict) -> dict:
    """Phase 10: the VerifyHub in front of verify_commit_range."""
    from tendermint_tpu_torch.crypto import verify_hub
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.types.validation import verify_commit_range

    n_range = len(range_items(entries))
    trace.configure(enabled=True)

    def run(label: str, **hub_kw) -> list[dict]:
        trace.RECORDER.clear()
        hub = verify_hub.acquire_hub(device=dev, **hub_kw)
        passes = []
        try:
            for _ in range(2):
                before = hub.stats()
                _launch_counts(reset=True)
                t0 = time.perf_counter()
                verify_commit_range(CHAIN_ID, entries, device=dev)
                _sync(dev)
                wall = time.perf_counter() - t0
                routes = _dispatch_routes()
                trace.RECORDER.clear()
                after = hub.stats()
                passes.append({
                    "hub": label,
                    "max_batch": hub.max_batch,
                    "wall_s": wall,
                    "sigs_per_s": n_range / wall,
                    "dispatches": {r: routes.count(r) for r in sorted(set(routes))},
                    "cache_hits": after["cache_hits"] - before["cache_hits"],
                    "launches": _launch_counts(),
                    "stats": after,
                })
        finally:
            verify_hub.release_hub()
        if verify_hub.running_hub() is not None:
            raise AssertionError("release_hub left a running hub")
        return passes

    first, cached = run("max_batch", max_batch=HUB_MAX_BATCH)
    if first["max_batch"] != HUB_MAX_BATCH:
        raise AssertionError(f"hub runs at max_batch {first['max_batch']}, not {HUB_MAX_BATCH}")
    if not first["dispatches"] or set(first["dispatches"]) != {"cuda"}:
        raise AssertionError(f"hub dispatches off the card: {first['dispatches']}")
    _require_all_launched("verify_commit_range through the hub", first["launches"])
    if cached["cache_hits"] != n_range or any(cached["launches"].values()) or cached["dispatches"]:
        raise AssertionError(f"second pass not served from the cache: {cached}")
    default, default_again = run("default")
    from tendermint_tpu_torch.config import VerifyHubConfig

    if default["max_batch"] != VerifyHubConfig().max_batch:
        raise AssertionError(f"default hub runs at max_batch {default['max_batch']}")
    return {
        "entry": "verify_commit_range (lane backfill) through acquire_hub",
        "sigs": n_range,
        "direct_wall_s": direct["wall_s"],
        "direct_sigs_per_s": direct["sigs_per_s"],
        "passes": [first, cached, default, default_again],
    }


BS_MAIN = "blocksync[replay]"
BS_TAMPERED = "blocksync[tampered]"


def build_chain(n_vals: int, n_blocks: int) -> dict:
    """The source chain of bench.py's block-sync bench, built through the
    port's own executor on the host (device="cpu": set-up, not the
    measured path). Returns its genesis, validator keys, block and state
    stores, app connections, the state after height n_blocks - 1 (where a
    replay ends), the state after NB_BLOCKS - 1 (where phase 25's sync of
    the chain's first NB_BLOCKS blocks ends) and the seconds taken. Phases
    12 and 25 share it."""
    import asyncio

    from tendermint_tpu_torch import testing as tt

    keys = tt.det_priv_keys(n_vals)
    genesis = tt.make_genesis(keys, BS_CHAIN_ID)
    states = {}

    def on_height(h, _block, _parts, _commit, state):
        if h == n_blocks - 1:
            states["end"] = state
        if h == min(NB_BLOCKS, n_blocks) - 1:
            states["nb"] = state

    t0 = time.perf_counter()
    bstore, sstore, conns, _state = asyncio.run(
        tt.build_kvstore_chain(genesis, keys, n_blocks, device="cpu", on_height=on_height))
    return {"genesis": genesis, "keys": keys, "store": bstore, "state_store": sstore,
            "conns": conns, "end_state": states["end"], "nb_state": states["nb"],
            "build_s": time.perf_counter() - t0}


@contextlib.contextmanager
def _batch_routes():
    """Every `AdaptiveBatchVerifier.verify` call while the block runs: its
    size and route ("cuda" or "cpu"). The router's verify is wrapped, not
    changed."""
    from tendermint_tpu_torch.crypto import batch

    real = batch.AdaptiveBatchVerifier.verify
    routes: list[tuple[int, str]] = []

    def verify(bv):
        out = real(bv)
        routes.append((len(bv._items), bv.last_route))
        return out

    batch.AdaptiveBatchVerifier.verify = verify
    try:
        yield routes
    finally:
        batch.AdaptiveBatchVerifier.verify = real


class RangeLog:
    """Each `verify_commit_range` call of the block-sync reactor: its
    blocks, the signatures it batches (light semantics: block votes in
    index order up to the first tally above 2/3), the routes of the
    batches it ran ("cuda" or "cpu", from `AdaptiveBatchVerifier`), its
    wall seconds, and its (pub, msg, sig) triples for the host floor.
    `recording()` wraps the reactor's name for the function and the
    router's `verify` while a replay runs; neither changes what they do.
    The signatures are counted and rebuilt when the recording ends,
    outside the replay's wall."""

    def __init__(self):
        self.ranges: list[dict] = []
        self.items: list[list] = []

    @contextlib.contextmanager
    def recording(self):
        from tendermint_tpu_torch.blocksync import reactor as R

        real_range = R.verify_commit_range

        def verify_commit_range(chain_id, entries, **kw):
            before = len(routes)
            raised = None
            t0 = time.perf_counter()
            try:
                return real_range(chain_id, entries, **kw)
            except Exception as e:
                raised = f"{type(e).__name__}: {e}"
                raise
            finally:
                calls.append((chain_id, entries))
                self.ranges.append({
                    "first_height": entries[0][2],
                    "blocks": len(entries),
                    "route": routes[before][1] if len(routes) > before else None,
                    "batches": routes[before:],
                    "wall_s": time.perf_counter() - t0,
                    "raised": raised,
                })

        calls: list[tuple] = []
        R.verify_commit_range = verify_commit_range
        try:
            with _batch_routes() as routes:
                yield self
        finally:
            R.verify_commit_range = real_range
            for (chain_id, entries), rec in zip(calls, self.ranges):
                self.items.append(range_items(entries, chain_id))
                rec["sigs"] = len(self.items[-1])


async def _replay(dev, genesis, serve_block, top: int, *, window: int, on_start=None,
                  top_after_punish: int | None = None, stop_after_punishments: int = 0,
                  timeout: float = BS_TIMEOUT_S) -> dict:
    """Block-sync a fresh node through the port's BlockSyncReactor on
    `dev`, fed by one in-process peer ("peer0") that answers status
    requests with `top` (with `top_after_punish` once the reactor has
    punished a height) and block requests up to it with
    `serve_block(height)`, through a Channel (bench.py's
    `_bench_blocksync_async`). No hub runs. Ends when the reactor is
    synced or, with `stop_after_punishments`, once it has punished that
    many times. `on_start()` runs just before the reactor starts."""
    import asyncio

    from tendermint_tpu_torch.abci.kvstore import KVStoreApp
    from tendermint_tpu_torch.blocksync import BLOCKSYNC_CHANNEL
    from tendermint_tpu_torch.blocksync import messages as bsm
    from tendermint_tpu_torch.blocksync.reactor import BlockSyncReactor
    from tendermint_tpu_torch.consensus.replay import Handshaker
    from tendermint_tpu_torch.p2p.peermanager import PeerStatus, PeerUpdate
    from tendermint_tpu_torch.p2p.router import Channel
    from tendermint_tpu_torch.p2p.types import Envelope
    from tendermint_tpu_torch.proxy import AppConns
    from tendermint_tpu_torch.state.execution import BlockExecutor
    from tendermint_tpu_torch.state.state import state_from_genesis
    from tendermint_tpu_torch.state.store import StateStore
    from tendermint_tpu_torch.store.blockstore import BlockStore
    from tendermint_tpu_torch.store.db import MemDB

    conns = AppConns.local(KVStoreApp())
    bstore, sstore = BlockStore(MemDB()), StateStore(MemDB())
    state = await Handshaker(sstore, state_from_genesis(genesis), bstore, genesis,
                             device=dev).handshake(conns)
    sstore.save(state)
    ex = BlockExecutor(sstore, conns.consensus, block_store=bstore, device=dev)
    ch = Channel(BLOCKSYNC_CHANNEL, "blocksync", 5, bsm.encode_message, bsm.decode_message)
    peer_q: asyncio.Queue = asyncio.Queue()
    reactor = BlockSyncReactor(state, ex, bstore, ch, peer_q, window=window, active=True,
                               device=dev)
    requests: dict[int, int] = {}
    punished: list[int] = []
    errors: list = []
    done = asyncio.Event()
    real_punish = reactor._punish

    async def punish(height, provider, next_provider, err):
        punished.append(height)
        await real_punish(height, provider, next_provider, err)
        if stop_after_punishments and len(punished) >= stop_after_punishments:
            done.set()

    reactor._punish = punish

    async def serve():
        while True:
            msg = (await ch.out_q.get()).message
            served = top_after_punish if punished and top_after_punish else top
            if isinstance(msg, bsm.StatusRequest):
                reply = bsm.StatusResponse(served, 1)
            elif isinstance(msg, bsm.BlockRequest) and msg.height <= served:
                requests[msg.height] = requests.get(msg.height, 0) + 1
                reply = bsm.BlockResponse(serve_block(msg.height))
            else:
                continue
            await ch.in_q.put(Envelope(BLOCKSYNC_CHANNEL, reply, from_="peer0"))

    async def watch_errors():
        while True:
            errors.append(await ch.err_q.get())

    async def synced():
        await reactor.synced.wait()
        done.set()

    loop = asyncio.get_running_loop()
    tasks = [loop.create_task(f()) for f in (serve, watch_errors, synced)]
    await peer_q.put(PeerUpdate("peer0", PeerStatus.UP))
    if on_start is not None:
        on_start()
    t0 = time.perf_counter()
    await reactor.start()
    try:
        await asyncio.wait_for(done.wait(), timeout=timeout)
        wall = time.perf_counter() - t0
    finally:
        await reactor.stop()
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await conns.stop()
    return {"reactor": reactor, "state": reactor.state, "store": bstore, "wall_s": wall,
            "punished": punished, "errors": errors, "requests": requests,
            "synced": reactor.synced.is_set()}


def drive_blocksync(dev, audit: ShapeAudit, chain: dict | None = None) -> dict:
    """Phase 12: bench.py's block-sync bench on the port — replay a
    prebuilt kvstore chain (`chain`, from `build_chain`; built here when
    None) through BlockSyncReactor on `dev`, one range verification per
    window; then a short tampered pass."""
    import asyncio
    from dataclasses import replace

    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto.batch import CPUBatchVerifier
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from tendermint_tpu_torch.types.block import Block

    if chain is None:
        chain = build_chain(N_VALS, N_BS_BLOCKS)
    src, genesis = chain["store"], chain["genesis"]
    log = RangeLog()
    with log.recording(), audit.recording(BS_MAIN):
        run = asyncio.run(_replay(dev, genesis, src.load_block, src.height(), window=BS_WINDOW,
                                  on_start=lambda: _launch_counts(reset=True)))
        launches = _launch_counts()
    _sync(dev)
    if not run["synced"]:
        raise AssertionError("block-sync replay did not finish")
    state, end = run["state"], chain["end_state"]
    applied = run["reactor"].metrics["blocks_applied"]
    if state.last_block_height != N_BS_BLOCKS - 1 or applied != N_BS_BLOCKS - 1 \
            or run["store"].height() < N_BS_BLOCKS - 1:
        raise AssertionError(f"replay ended at height {state.last_block_height}, "
                             f"{applied} blocks applied")
    if (state.app_hash, state.last_block_height, state.validators.hash()) != \
            (end.app_hash, end.last_block_height, end.validators.hash()):
        raise AssertionError("replayed state differs from the source chain's")
    if run["punished"] or run["errors"]:
        raise AssertionError(f"an honest replay punished {run['punished']}: {run['errors']}")
    cutoff = batch.MIN_TPU_BATCH
    for r in log.ranges:
        if r["raised"]:
            raise AssertionError(f"an honest range raised: {r}")
        want = "cuda" if r["sigs"] >= cutoff else "cpu"
        if r["route"] != want or any(route != r["route"] for _n, route in r["batches"]):
            raise AssertionError(f"range of {r['sigs']} signatures routed {r['batches']}, "
                                 f"not {want} (cutoff {cutoff})")
    if not any(r["route"] == "cuda" for r in log.ranges):
        raise AssertionError("no range reached the card")
    _require_all_launched("block-sync replay", launches)

    # the host floor over the same ranges' signatures, range by range
    floor = []
    for items in log.items:
        bv = CPUBatchVerifier(parallel=True)
        for pub, msg, sig in items:
            bv.add(Ed25519PubKey(pub), msg, sig)
        t0 = time.perf_counter()
        ok, _ = bv.verify()
        floor.append(time.perf_counter() - t0)
        if not ok:
            raise AssertionError("host verification rejected a replayed signature")
    on_card = [i for i, r in enumerate(log.ranges) if r["route"] == "cuda"]
    sigs = sum(r["sigs"] for r in log.ranges)

    # the tampered pass: the commit for BS_TAMPER_HEIGHT (block
    # BS_TAMPER_HEIGHT + 1's LastCommit) with one bit flipped. The peer
    # first serves up to that block, so it ends whichever range holds
    # the commit: the range's structural checks pass and its batch
    # fails on the signature (on the card from MIN_TPU_BATCH signatures:
    # kernel_eq, then kernel_sig). After the punishment it serves two
    # windows: the re-fetched bad block is then mid-range, which fails
    # the part-set check (its LastCommit is part of the block), and the
    # reactor must punish the height again without applying past it.
    good = src.load_block(BS_TAMPER_HEIGHT + 1)
    lc = good.last_commit
    sigs_t = list(lc.signatures)
    s = sigs_t[BS_TAMPER_VAL].signature
    sigs_t[BS_TAMPER_VAL] = replace(sigs_t[BS_TAMPER_VAL],
                                    signature=s[:40] + bytes([s[40] ^ 1]) + s[41:])
    bad = Block(good.header, good.txs, good.evidence, replace(lc, signatures=tuple(sigs_t)))

    def serve_tampered(h):
        return bad if h == BS_TAMPER_HEIGHT + 1 else src.load_block(h)

    tlog = RangeLog()
    with tlog.recording(), audit.recording(BS_TAMPERED):
        trun = asyncio.run(_replay(dev, genesis, serve_tampered, BS_TAMPER_HEIGHT + 1,
                                   window=BS_WINDOW, top_after_punish=BS_TAMPER_TOP,
                                   stop_after_punishments=2, timeout=120,
                                   on_start=lambda: _launch_counts(reset=True)))
        tlaunches = _launch_counts()
    if trun["punished"] != [BS_TAMPER_HEIGHT] * 2:
        raise AssertionError(f"tampered pass punished {trun['punished']}")
    failing = next(r for r in tlog.ranges if r["first_height"] <= BS_TAMPER_HEIGHT
                   < r["first_height"] + r["blocks"])
    if failing["sigs"] >= cutoff:
        if failing["route"] != "cuda":
            raise AssertionError(f"the range with the bad signature routed {failing}")
        _require_all_launched("tampered block-sync range", tlaunches)
    first = trun["errors"][0] if trun["errors"] else None
    if first is None or first.node_id != "peer0" or not first.fatal:
        raise AssertionError(f"no fatal PeerError named the provider: {trun['errors']}")
    if trun["state"].last_block_height != BS_TAMPER_HEIGHT - 1 \
            or trun["store"].height() > BS_TAMPER_HEIGHT - 1:
        raise AssertionError(f"tampered pass applied past {BS_TAMPER_HEIGHT - 1}: "
                             f"{trun['state'].last_block_height}")
    if trun["requests"].get(BS_TAMPER_HEIGHT, 0) < 2:
        raise AssertionError("the punished height was not requested again")
    return {
        "entry": "BlockSyncReactor (bench.py _bench_blocksync_async), device cuda, no hub",
        "validators": N_VALS,
        "source_blocks": N_BS_BLOCKS,
        "window": BS_WINDOW,
        "chain_build_s": chain["build_s"],
        "blocks_applied": applied,
        "wall_s": run["wall_s"],
        "blocks_per_s": applied / run["wall_s"],
        "sigs_verified": sigs,
        "sigs_verified_reactor_metric": run["reactor"].metrics["sigs_verified"],
        "min_tpu_batch": cutoff,
        "ranges": [{k: r[k] for k in ("first_height", "blocks", "sigs", "route", "wall_s")}
                   for r in log.ranges],
        "two_chunk_ranges": sum(1 for r in log.ranges if r["sigs"] > 8192),
        "launches": launches,
        "range_verify_wall_s": sum(r["wall_s"] for r in log.ranges),
        "cpu_floor": {
            "entry": "CPUBatchVerifier(parallel=True), range by range",
            "sigs": sigs,
            "cores": os.cpu_count(),
            "wall_s": sum(floor),
        },
        "on_card": {
            "ranges": len(on_card),
            "sigs": sum(log.ranges[i]["sigs"] for i in on_card),
            "range_verify_wall_s": sum(log.ranges[i]["wall_s"] for i in on_card),
            "cpu_floor_wall_s": sum(floor[i] for i in on_card),
        },
        "tampered": {
            "blocks_served": [BS_TAMPER_HEIGHT + 1, BS_TAMPER_TOP],
            "tampered_height": BS_TAMPER_HEIGHT,
            "punished": trun["punished"],
            "peer_errors": [[e.node_id, e.fatal] for e in trun["errors"]],
            "last_applied": trun["state"].last_block_height,
            "requests_of_punished_height": trun["requests"].get(BS_TAMPER_HEIGHT, 0),
            # the second punishment's range holds the tampered block
            # mid-range and fails its structural checks before any batch
            # runs: route None
            "ranges": [{k: r[k] for k in ("first_height", "blocks", "sigs", "route", "raised")}
                       for r in tlog.ranges],
            "launches": tlaunches,
            "wall_s": trun["wall_s"],
        },
    }


LC_MAIN = "light[verify_adjacent_chain]"
LC_CLIENT = "light[client, sequential]"
LC_TAMPERED = "light[verify_adjacent_chain, tampered]"


def build_light_bench(n_vals: int, n_headers: int) -> dict:
    """bench.py's light-client chain (`bench_light_client`,
    bench.py:356-384), built on the host with the port's types: chain
    "light-bench", `n_vals` ed25519 validators of power 10, hash-linked
    headers one second apart, each committed by every validator. Returns
    the light blocks, the keys, the trusting period, `now` and the
    seconds taken."""
    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto.hashes import sha256
    from tendermint_tpu_torch.light.types import LightBlock, SignedHeader
    from tendermint_tpu_torch.types.block import BlockID, Header, PartSetHeader

    vals, keys = tt.make_validator_set(n_vals, power=10)
    vh = vals.hash()
    t0 = time.perf_counter()
    blocks = []
    prev_hash = sha256(b"genesis")
    for h in range(1, n_headers + 1):
        hdr = Header(
            chain_id=LC_CHAIN_ID,
            height=h,
            time_ns=LC_BASE_TS + h * 1_000_000_000,
            last_block_id=BlockID(prev_hash, PartSetHeader(1, sha256(b"pp"))),
            data_hash=sha256(b"data-%d" % h),
            validators_hash=vh,
            next_validators_hash=vh,
            consensus_hash=sha256(b"consensus"),
            app_hash=sha256(b"app-%d" % h),
            last_results_hash=sha256(b"res"),
            proposer_address=vals.validators[h % n_vals].address,
        )
        bid = BlockID(hdr.hash(), PartSetHeader(1, sha256(b"parts-%d" % h)))
        commit = tt.make_commit(LC_CHAIN_ID, h, 0, bid, vals, keys, timestamp_ns=hdr.time_ns)
        blocks.append(LightBlock(SignedHeader(hdr, commit), vals))
        prev_hash = hdr.hash()
    return {
        "blocks": blocks,
        "keys": keys,
        "period_ns": 10 * 365 * 24 * 3600 * 10**9,
        "now_ns": LC_BASE_TS + (n_headers + 10) * 1_000_000_000,
        "build_s": time.perf_counter() - t0,
    }


class BatchLog:
    """What the verification funnel did while `recording()` is open: each
    `AdaptiveBatchVerifier.verify` (its signatures and route, "cuda" or
    "cpu", and when it returned), whether each `kernel_eq` chunk's
    equation held, and the `kernel_sig` calls. Wraps the three by their
    module names; none changes what it does."""

    def __init__(self):
        self.batches: list[tuple[int, str]] = []
        self.returned: list[float] = []  # time.perf_counter() as each batch returned
        self.chunks: list[bool] = []
        self.kernel_sig = 0

    @contextlib.contextmanager
    def recording(self):
        from tendermint_tpu_torch.crypto import batch
        from tendermint_tpu_torch.crypto.cuda import verify as V

        real_verify, real_eq, real_sig = batch.AdaptiveBatchVerifier.verify, V.kernel_eq, V.kernel_sig

        def verify(bv):
            out = real_verify(bv)
            self.returned.append(time.perf_counter())
            self.batches.append((len(bv._items), bv.last_route))
            return out

        def kernel_eq(*ops):
            bitmap, eq_ok = real_eq(*ops)
            self.chunks.append(eq_ok)  # a device scalar: read when the recording ends
            return bitmap, eq_ok

        def kernel_sig(*ops):
            self.kernel_sig += 1
            return real_sig(*ops)

        batch.AdaptiveBatchVerifier.verify, V.kernel_eq, V.kernel_sig = verify, kernel_eq, kernel_sig
        try:
            yield self
        finally:
            batch.AdaptiveBatchVerifier.verify, V.kernel_eq, V.kernel_sig = (
                real_verify, real_eq, real_sig)
            self.chunks = [bool(ok) for ok in self.chunks]


def _light_items(blocks):
    """The (pub, msg, sig) triples of verify_adjacent_chain's one range:
    every block but the first, light semantics."""
    return range_items([(lb.validators, lb.signed_header.commit.block_id, lb.height,
                         lb.signed_header.commit) for lb in blocks[1:]], LC_CHAIN_ID)


def _tamper_light(lb, vi: int):
    from dataclasses import replace

    from tendermint_tpu_torch.light.types import LightBlock, SignedHeader

    commit = lb.signed_header.commit
    sigs = list(commit.signatures)
    s = sigs[vi].signature
    sigs[vi] = replace(sigs[vi], signature=s[:40] + bytes([s[40] ^ 1]) + s[41:])
    return LightBlock(SignedHeader(lb.header, replace(commit, signatures=tuple(sigs))),
                      lb.validators)


def _resign_light(lb, keys, **header_fields):
    """`lb` with its header fields changed and a commit over the new
    header by its own validators (a conflicting header, validly signed)."""
    from dataclasses import replace

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.light.types import LightBlock, SignedHeader
    from tendermint_tpu_torch.types.block import BlockID

    hdr = replace(lb.header, **header_fields)
    bid = BlockID(hdr.hash(), lb.signed_header.commit.block_id.part_set_header)
    commit = tt.make_commit(LC_CHAIN_ID, hdr.height, 0, bid, lb.validators, keys,
                            timestamp_ns=hdr.time_ns)
    return LightBlock(SignedHeader(hdr, commit), lb.validators)


class _Forging:
    """A provider over `inner` that serves the blocks of `at` at their
    heights instead of its own, and records the evidence reported to it
    (with `at` empty: an honest provider that records)."""

    def __init__(self, inner, at: dict):
        self.inner, self.at, self.reported = inner, at, []

    def __repr__(self):
        return "forging-witness" if self.at else "primary"

    def chain_id(self):
        return self.inner.chain_id()

    async def light_block(self, height):
        return self.at.get(height) or await self.inner.light_block(height)

    async def report_evidence(self, evidence):
        self.reported.append(evidence)


def _light_client_run(dev, blocks, lc: dict, *, sequential: bool, witnesses=()) -> dict:
    """A LightClient on `dev` over a list provider of `blocks` (trust
    pinned at height 1), witnesses as given: initialize, then verify the
    top height. Each verify_adjacent_chain window's headers, wall and
    routes are recorded. Returns what it did; an exception propagates."""
    import asyncio

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.light import client as C
    from tendermint_tpu_torch.light import verifier

    primary = tt.make_list_provider(blocks, LC_CHAIN_ID)
    opts = C.TrustOptions(lc["period_ns"], 1, blocks[0].header.hash())
    client = C.LightClient(LC_CHAIN_ID, opts, primary, list(witnesses), sequential=sequential,
                           device=dev)
    windows: list[dict] = []
    log = BatchLog()
    real_chain = verifier.verify_adjacent_chain

    def verify_adjacent_chain(chain_id, trusted, chain, *a, **kw):
        before = len(log.batches)
        t0 = time.perf_counter()
        out = real_chain(chain_id, trusted, chain, *a, **kw)
        _sync(dev)
        windows.append({"first_height": chain[0].height, "headers": len(chain),
                        "wall_s": time.perf_counter() - t0,
                        "batches": log.batches[before:]})
        return out

    async def go():
        await client.initialize()
        return await client.verify_light_block_at_height(len(blocks), lc["now_ns"])

    verifier.verify_adjacent_chain = verify_adjacent_chain
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    try:
        with log.recording():
            got = asyncio.run(go())
        _sync(dev)
    finally:
        verifier.verify_adjacent_chain = real_chain
    return {"client": client, "height": got.height,
            "wall_s": time.perf_counter() - t0, "windows": windows, "batches": log.batches,
            "launches": _launch_counts()}


def drive_light(dev, audit: ShapeAudit) -> dict:
    """Phase 13: bench.py's light-client bench (BASELINE config 2) on the
    port, then a LightClient over the same chain, a tampered pass and a
    divergence."""
    import asyncio

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto.batch import CPUBatchVerifier
    from tendermint_tpu_torch.crypto.cuda import verify as V
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from tendermint_tpu_torch.light import client as C
    from tendermint_tpu_torch.light import verifier
    from tendermint_tpu_torch.types import evidence as E

    lc = build_light_bench(N_VALS, N_LC_HEADERS)
    blocks = lc["blocks"]
    print(f"light: built {N_LC_HEADERS} signed headers in {lc['build_s']:.1f} s")
    items = _light_items(blocks)
    sigs = len(items)
    chunks = -(-sigs // V._MAX_BUCKET)
    cutoff = batch.MIN_TPU_BATCH

    # (a) bench.py's call: one verify_adjacent_chain over 999 headers
    range_wall = []
    real_range = verifier.verify_commit_range

    def timed_range(*a, **kw):
        t = time.perf_counter()
        try:
            return real_range(*a, **kw)
        finally:
            _sync(dev)
            range_wall.append(time.perf_counter() - t)

    log = BatchLog()
    verifier.verify_commit_range = timed_range
    try:
        with log.recording(), audit.recording(LC_MAIN):
            _launch_counts(reset=True)
            t0 = time.perf_counter()
            trusted = verifier.verify_adjacent_chain(
                LC_CHAIN_ID, blocks[0], blocks[1:], lc["period_ns"], lc["now_ns"], device=dev)
            _sync(dev)
            wall = time.perf_counter() - t0
            launches = _launch_counts()
    finally:
        verifier.verify_commit_range = real_range
    if trusted.height != N_LC_HEADERS:
        raise AssertionError(f"verify_adjacent_chain ended at height {trusted.height}")
    if log.batches != [(sigs, "cuda" if sigs >= cutoff else "cpu")] or sigs < cutoff:
        raise AssertionError(f"the range of {sigs} signatures routed {log.batches} "
                             f"(cutoff {cutoff})")
    if log.chunks != [True] * chunks or log.kernel_sig:
        raise AssertionError(f"kernel_eq chunks {log.chunks}, kernel_sig {log.kernel_sig}: "
                             f"want {chunks} chunks that hold")
    _require_all_launched("light verify_adjacent_chain", launches)

    bv = CPUBatchVerifier(parallel=True)
    for pub, msg, sig in items:
        bv.add(Ed25519PubKey(pub), msg, sig)
    t0 = time.perf_counter()
    ok, _ = bv.verify()
    floor_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("host verification rejected a light-chain signature")

    # (b) a LightClient over the same chain, one honest witness: the
    # sequential windows (128 headers, two chunks each), then one skip
    witness = tt.make_list_provider(blocks, LC_CHAIN_ID)
    with audit.recording(LC_CLIENT):
        seq = _light_client_run(dev, blocks, lc, sequential=True, witnesses=[witness])
    if seq["height"] != N_LC_HEADERS or seq["client"].store.latest().height != N_LC_HEADERS:
        raise AssertionError(f"sequential client ended at {seq['height']}")
    want_windows = -(-(N_LC_HEADERS - 1) // 128)
    if len(seq["windows"]) != want_windows:
        raise AssertionError(f"{len(seq['windows'])} windows, not {want_windows}")
    for w in seq["windows"]:
        n = len(_light_items(blocks[w["first_height"] - 2:w["first_height"] - 1 + w["headers"]]))
        w["sigs"] = n
        if [r for _n, r in w["batches"]] != ["cuda" if n >= cutoff else "cpu"]:
            raise AssertionError(f"window {w} routed off the cutoff's rule ({cutoff})")
    skip = _light_client_run(dev, blocks, lc, sequential=False, witnesses=[witness])
    if skip["height"] != N_LC_HEADERS or skip["windows"]:
        raise AssertionError(f"skipping client: {skip['height']}, windows {skip['windows']}")

    # (c) the commit for LC_TAMPER_HEIGHT with one flipped signature bit:
    # it sits in the last kernel_eq chunk, which alone fails; kernel_sig
    # attributes it there, and the per-commit search names the height
    bad = list(blocks)
    bad[LC_TAMPER_HEIGHT - 1] = _tamper_light(blocks[LC_TAMPER_HEIGHT - 1], LC_TAMPER_VAL)
    bad_pos = (LC_TAMPER_HEIGHT - 2) * (sigs // (N_LC_HEADERS - 1)) + LC_TAMPER_VAL
    if bad_pos // V._MAX_BUCKET != chunks - 1:
        raise AssertionError(f"signature {bad_pos} is not in the last of {chunks} chunks")
    tlog = BatchLog()
    with tlog.recording(), audit.recording(LC_TAMPERED):
        _launch_counts(reset=True)
        t_bad = time.perf_counter()
        try:
            verifier.verify_adjacent_chain(LC_CHAIN_ID, bad[0], bad[1:], lc["period_ns"],
                                           lc["now_ns"], device=dev)
        except verifier.VerificationError as e:
            raised = str(e)
        else:
            raise AssertionError("a tampered light chain verified")
        _sync(dev)
        tampered_wall = time.perf_counter() - t_bad
        tlaunches = _launch_counts()
    if f"at height {LC_TAMPER_HEIGHT}:" not in raised or f"index {LC_TAMPER_VAL}" not in raised:
        raise AssertionError(f"wrong height or signature blamed: {raised}")
    if tlog.batches[0] != (sigs, log.batches[0][1]) or \
            tlog.chunks != [True] * (chunks - 1) + [False] or tlog.kernel_sig != 1:
        raise AssertionError(f"tampered range: batches {tlog.batches[:2]}, chunks "
                             f"{tlog.chunks}, kernel_sig {tlog.kernel_sig}")
    _require_all_launched("tampered light verify_adjacent_chain", tlaunches)

    # (d) a witness serving, at the top height, a header with another app
    # hash signed by the same keys: the client must raise Divergence and
    # report LightClientAttackEvidence to the primary
    forged = _resign_light(blocks[-1], lc["keys"], app_hash=b"\xde\xad" * 16)
    primary = _Forging(tt.make_list_provider(blocks, LC_CHAIN_ID), {})
    forging = _Forging(tt.make_list_provider(blocks, LC_CHAIN_ID), {N_LC_HEADERS: forged})
    client = C.LightClient(LC_CHAIN_ID, C.TrustOptions(lc["period_ns"], 1, blocks[0].header.hash()),
                           primary, [forging], device=dev)
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    try:
        asyncio.run(client.verify_light_block_at_height(N_LC_HEADERS, lc["now_ns"]))
    except C.Divergence as e:
        diverged_at = e.challenging.height
    else:
        raise AssertionError("the forged witness header raised no Divergence")
    divergence_wall = time.perf_counter() - t0
    dlaunches = _launch_counts()
    if diverged_at != N_LC_HEADERS or len(primary.reported) != 1:
        raise AssertionError(f"divergence at {diverged_at}, {len(primary.reported)} reports")
    (ev,) = primary.reported
    if not isinstance(ev, E.LightClientAttackEvidence):
        raise AssertionError(f"reported {type(ev).__name__}")
    ev.validate_basic()
    back = E.decode_evidence(ev.encode())
    if back.encode() != ev.encode() or back.hash() != ev.hash() \
            or back.conflicting_block.header.hash() != forged.header.hash():
        raise AssertionError("the attack evidence does not decode back equal")
    if client.store.latest().height != 1:
        raise AssertionError("a diverged header reached the trusted store")

    def window_row(w):
        return {"first_height": w["first_height"], "headers": w["headers"], "sigs": w["sigs"],
                "routes": [r for _n, r in w["batches"]], "wall_s": w["wall_s"]}

    return {
        "entry": "light.verifier.verify_adjacent_chain (bench.py bench_light_client), no hub",
        "device": dev.type,
        "validators": N_VALS,
        "headers": N_LC_HEADERS,
        "chain_build_s": lc["build_s"],
        "sigs": sigs,
        "route": log.batches[0][1],
        "kernel_eq_chunks": len(log.chunks),
        "bucket": V._bucket(min(sigs, V._MAX_BUCKET)),
        "min_tpu_batch": cutoff,
        "wall_s": wall,
        "headers_per_s": (N_LC_HEADERS - 1) / wall,
        "sigs_per_s": sigs / wall,
        "range_wall_s": range_wall[0],
        "host_link_checks_s": wall - range_wall[0],
        "launches": launches,
        "cpu_floor": {
            "entry": "CPUBatchVerifier(parallel=True)",
            "sigs": sigs,
            "cores": os.cpu_count(),
            "wall_s": floor_s,
            "sigs_per_s": sigs / floor_s,
            "headers_per_s": (N_LC_HEADERS - 1) / floor_s,
        },
        "client_sequential": {
            "wall_s": seq["wall_s"],
            "headers_per_s": (N_LC_HEADERS - 1) / seq["wall_s"],
            "windows": [window_row(w) for w in seq["windows"]],
            "initialize_batches": seq["batches"][:1],
            "launches": seq["launches"],
        },
        "client_skipping": {
            "wall_s": skip["wall_s"],
            "batches": skip["batches"],
            "launches": skip["launches"],
        },
        "tampered": {
            "height": LC_TAMPER_HEIGHT,
            "signature_position": bad_pos,
            "raised": raised,
            "chunks_held": tlog.chunks,
            "kernel_sig_calls": tlog.kernel_sig,
            "per_commit_search_batches": len(tlog.batches) - 1,
            "per_commit_search_routes": sorted({r for _n, r in tlog.batches[1:]}),
            "wall_s": tampered_wall,
            # the failed range (link checks, its chunks, kernel_sig), then
            # the reference's per-commit search that names the height
            "range_s": tlog.returned[0] - t_bad,
            "per_commit_search_s": t_bad + tampered_wall - tlog.returned[0],
            "launches": tlaunches,
        },
        "divergence": {
            "height": diverged_at,
            "evidence_bytes": len(ev.encode()),
            "common_height": ev.common_height,
            "byzantine_validators": len(ev.byzantine_validators),
            "reported_to_primary": len(primary.reported),
            "wall_s": divergence_wall,
            "launches": dlaunches,
        },
    }


BLS_MAIN = "bls[aggregate: verify_commit x 4, verify_commit_range]"
BLS_TAMPERED = "bls[aggregate, tampered]"
BLS_PERSIG = "bls[per-signature verify_commit_range, hub]"
BLS_PERSIG_TAMPERED = "bls[per-signature, tampered]"


class PairingAudit:
    """The (items, pairs) shapes the pairing wrappers are given on a path:
    `recording(path)` wraps bls_pairing.miller (K7a) and final_exp (K7b)
    and keeps, per kernel and shape, the first inputs given there and the
    calls on each path."""

    def __init__(self):
        #: (kernel name, (m, npairs)) -> {"inputs": [...], "calls": {path: n}}
        self.seen: dict[tuple, dict] = {}

    def shapes(self, path: str) -> list:
        return sorted((name, shape) for (name, shape), rec in self.seen.items()
                      if path in rec["calls"])

    @contextlib.contextmanager
    def recording(self, path: str):
        from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP

        real_miller, real_final = BP.miller, BP.final_exp

        def note(kernel, tensors):
            key = (kernel.name, tuple(tensors[0].shape[:2]))
            rec = self.seen.get(key)
            if rec is None:
                rec = self.seen[key] = {"inputs": [t.clone() for t in tensors], "calls": {}}
            rec["calls"][path] = rec["calls"].get(path, 0) + 1

        def miller(*tensors):
            note(BP.MILLER, tensors)
            return real_miller(*tensors)

        def final_exp(f):
            note(BP.FINAL_EXP, (f,))
            return real_final(f)

        BP.miller, BP.final_exp = miller, final_exp
        try:
            yield
        finally:
            BP.miller, BP.final_exp = real_miller, real_final


def build_bls_commits(n_vals: int, n_commits: int) -> dict:
    """bench_commit_ab's BLS chain shape: `n_vals` bls12381 validators
    (seed b"ab-bls_aggregate") and `n_commits` full commits, each folded
    into its aggregate form; the per-signature commits are kept too."""
    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.types.block import aggregate_commit

    t0 = time.perf_counter()
    vals, keys = tt.make_validator_set(n_vals, key_types=("bls12381",), seed=AB_SEED)
    per_sig, aggs = [], []
    for h in range(1, n_commits + 1):
        bid = tt.make_block_id(b"ab%d" % h)
        c = tt.make_commit(AB_CHAIN_ID, h, 0, bid, vals, keys, timestamp_ns=AB_BASE_TS + h)
        per_sig.append((vals, bid, h, c))
        aggs.append((vals, bid, h, aggregate_commit(c, vals)))
    return {"vals": vals, "keys": keys, "per_sig": per_sig, "aggs": aggs,
            "build_s": time.perf_counter() - t0}


def _bls_host_split() -> dict:
    """Seconds of the BLS host work by part, summed over the `bls` trace
    spans in the ring (bls_pairing emits them)."""
    from tendermint_tpu_torch.libs import trace

    out = {f"{k}_s": 0.0 for k in ("hash_to_curve", "prepare_lines", "pack", "h2d")}
    for span in trace.RECORDER.dump(subsystem="bls"):
        out[f"{span['name']}_s"] += span["duration_ms"] / 1e3
    return out


def _bls_pass(dev, run) -> dict:
    """One timed pass of the aggregate path, traced: the hash-to-curve
    memo cleared first (bench_commit_ab's cold verify), the host split
    from the `bls` trace spans, each kernel's device ms and the card's
    busy time from torch.profiler, and the idle share of the wall."""
    from tendermint_tpu_torch.crypto import bls_math
    from tendermint_tpu_torch.libs import trace

    bls_math._H2_MEMO.clear()
    trace.RECORDER.clear()
    timed = {}

    def timed_run():
        t0 = time.perf_counter()
        timed["calls"] = run()
        _sync(dev)
        timed["wall"] = time.perf_counter() - t0

    events = _device_events(timed_run)
    per_call, wall = timed["calls"], timed["wall"]

    def dev_ms(name=None):
        return sum(ns for n, ns in events if name is None or name in n) / 1e6

    busy_ms = dev_ms()
    host = _bls_host_split()
    return {
        "wall_s": wall,
        "calls": per_call,
        "host_split": host,
        "host_other_s": wall - sum(host.values()) - busy_ms / 1e3,
        "device_ms": {"bls_miller": dev_ms("bls_miller_kernel"),
                      "bls_final_exp": dev_ms("bls_final_exp_kernel")},
        "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / 1e3 / wall,
    }


def _pm1_limbs(dev):
    import torch

    from tendermint_tpu_torch.crypto import bls_math
    from tendermint_tpu_torch.crypto.cuda import bls_field as BF

    return torch.from_numpy(BF.int_to_limbs(bls_math.P - 1)).to(dev)


def _miller_worst(ins, dev) -> list:
    """K7a inputs of the same shapes: by flattened lane index mod 3, p - 1
    in every input, p - 1 with zero lines, or a pad pair."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import bls_field as BF

    pm1 = _pm1_limbs(dev)
    out = [torch.empty_like(t).copy_(pm1.expand_as(t)) for t in ins]
    lanes = ins[0].shape[0] * ins[0].shape[1]
    sel = torch.arange(lanes, device=dev).reshape(ins[0].shape[:2])
    zero_lines, pad = sel % 3 == 1, sel % 3 == 2
    for t in out[2:]:
        t[:, zero_lines | pad] = 0
    out[0][pad] = 0
    out[1][pad] = torch.from_numpy(BF.ONE).to(dev)
    return out


def _final_worst(f, dev, zero: bool = False):
    """K7b input of the same shape: p - 1 everywhere, every third lane
    (flattened index mod 3 == 2) one, as a pad pair leaves it; with
    `zero`, the last item's first lane zero too, so that its product is
    zero (and its final exponentiation zero, not one)."""
    import torch

    from tendermint_tpu_torch.crypto.cuda import bls_field as BF

    out = torch.empty_like(f).copy_(_pm1_limbs(dev).expand_as(f))
    sel = torch.arange(f.shape[0] * f.shape[1], device=dev).reshape(f.shape[:2])
    out[sel % 3 == 2] = BF.f12_one((), dev)
    if zero:
        out[-1, 0] = 0
    return out


def _hold_bls(kernel, what, run, plain) -> int:
    """torch.equal of a BLS wrapper and its plain version on the same
    inputs (both outputs of K7b); returns the largest difference (0)."""
    import torch

    got, want = run(), plain()
    torch.cuda.synchronize()
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{kernel.name} ({what}): kernel disagrees with its plain version")
    return max(int((g.long() - w.long()).abs().max().item()) for g, w in zip(got, want))


def _bls_row(kernel, shape, run, plain, cost, reps) -> dict:
    """A `kernels` row for K7a or K7b at `shape` (m, npairs): `ms` is the
    kernel timed by CUDA events around `reps` launches through its
    wrapper, median of three repeats (torch.profiler recorded no device
    events in most repeats of these rows in PR 7; at these kernels'
    lengths the wrapper's host time hides behind the launches), and its
    plain version once (CUDA events). `cost` is the (bytes, operations)
    of this run's data."""
    import torch

    n_bytes, n_ops = cost
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    repeats = [_time_ms(run, reps) for _ in range(3)]
    ms = sorted(repeats)[1]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain()
    end.record()
    torch.cuda.synchronize()
    return {
        "name": kernel.name,
        "m": shape[0] * (shape[1] if kernel.name == "bls_miller" else 1),
        "shape": list(shape),
        "route": "cuda",
        "source": f"tendermint_tpu_torch/crypto/cuda/csrc/{kernel.source}.cu",
        "replaces": kernel.replaces,
        "max_abs_err": 0,
        "match": True,
        "ms": ms,
        "ms_source": "cuda_events",
        "ms_repeats": repeats,
        "launches_timed": reps,
        "share_of_bound": bound_ms / ms,
        "plain_ms": start.elapsed_time(end),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "bound_ops": n_ops,
        "bound_bytes": n_bytes,
        "library_ms": None,  # no PyTorch call computes a Miller loop or a final exponentiation
    }


def _hold_pairing_shapes(dev, audit: PairingAudit) -> list:
    """K7a and K7b torch.equal to their plain versions at every (items,
    pairs) shape `audit` recorded, on the inputs the path gave and on
    worst-case inputs of the shape (for K7b also with a zero product,
    which must stay zero). Returns what was held, with the calls per
    path."""
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP

    held = []
    for (name, shape), rec in sorted(audit.seen.items()):
        if name == BP.MILLER.name:
            for source, ins in (("path", rec["inputs"]), ("worst case", _miller_worst(rec["inputs"], dev))):
                _hold_bls(BP.MILLER, f"{shape}, {source} inputs",
                          lambda ins=ins: BP.miller(*ins), lambda ins=ins: BP._miller_plain(*ins))
        else:
            (f,) = rec["inputs"]
            zero = _final_worst(f, dev, zero=True)
            for source, x in (("path", f), ("worst case", _final_worst(f, dev)),
                              ("zero product", zero)):
                _hold_bls(BP.FINAL_EXP, f"{shape}, {source} inputs",
                          lambda x=x: BP.final_exp(x), lambda x=x: BP._final_exp_plain(x))
            ok, out = BP.final_exp(zero)
            if bool(ok[-1]) or bool(out[-1].any()):
                raise AssertionError(f"bls_final_exp {shape}: a zero product did not stay zero")
        held.append({"kernel": name, "shape": list(shape), "calls": rec["calls"]})
    return held


def check_bls_kernels(dev, audit: PairingAudit, main_shape, per_sig_shape) -> tuple[list, dict]:
    """Phase 14's kernel checks: K7a and K7b torch.equal to their plain
    versions on the card at every (items, pairs) shape the BLS paths gave
    them, on the inputs the path gave and on worst-case inputs of the
    shape (for K7b also with a zero product, which must stay zero); K7b's
    results against bls_math.final_exp on 2 items of the per-signature
    bucket. Then a timed row per kernel at `main_shape` and at
    `per_sig_shape`."""
    from tendermint_tpu_torch.crypto import bls_math
    from tendermint_tpu_torch.crypto.cuda import bls_field as BF
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP

    held = _hold_pairing_shapes(dev, audit)

    def ints(t):
        c = t.cpu().numpy()
        return tuple(BF.limbs_to_int(c[i, j]) for i in range(6) for j in range(2))

    # K7b against the pure-Python final exponentiation, 2 items
    per_sig = [rec for (name, shape), rec in audit.seen.items()
               if name == BP.FINAL_EXP.name and BLS_PERSIG in rec["calls"]]
    (f,) = per_sig[0]["inputs"]
    ok, out = BP.final_exp(f)
    for item in (0, 1):
        prod = bls_math.F12_ONE
        for lane in range(f.shape[1]):
            prod = bls_math.f12_mul(prod, ints(f[item, lane]))
        want = bls_math.final_exp(prod)
        if ints(out[item]) != want or bool(ok[item]) != (want == bls_math.F12_ONE):
            raise AssertionError(f"bls_final_exp item {item} differs from bls_math.final_exp")
    vs_math = {"items": 2, "shape": list(f.shape[:2]), "equal": True}

    # a timed row per kernel at the aggregate path's bucket and at the
    # per-signature path's, on the inputs each path gave
    rows = [_pairing_row(dev, kernel, shape, audit.seen[(kernel.name, shape)]["inputs"], path)
            for shape, path in ((main_shape, BLS_MAIN), (per_sig_shape, BLS_PERSIG))
            for kernel in (BP.MILLER, BP.FINAL_EXP)]
    return rows, {"held": held, "final_exp_vs_bls_math": vs_math}


def _pairing_row(dev, kernel, shape, ins, path) -> dict:
    """A timed `kernels` row for K7a or K7b at `shape` on the inputs `ins`
    that `path` gave it, bound by the lanes this data needs."""
    from tendermint_tpu_torch.crypto.cuda import bls_field as BF
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP

    m, npairs = shape
    if kernel is BP.MILLER:
        run, plain = (lambda i=ins: BP.miller(*i)), (lambda i=ins: BP._miller_plain(*i))
        real = int((~BP.pad_lanes(*ins[1:])).sum())
        row = _bls_row(kernel, shape, run, plain, _miller_cost(m, npairs, real), 50)
        row["real_lanes"] = real
    else:
        (f,) = ins
        run, plain = (lambda x=f: BP.final_exp(x)), (lambda x=f: BP._final_exp_plain(x))
        real = (~(f == BF.f12_one((), dev)).flatten(2).all(-1)).sum(1).tolist()
        row = _bls_row(kernel, shape, run, plain, _final_exp_cost(m, npairs, real), 20)
        row["lanes_not_one"] = real
    row["path"] = path
    return row


def _expect_aggregate_failure(fn) -> None:
    from tendermint_tpu_torch.types.validation import InvalidCommitError

    try:
        fn()
    except InvalidCommitError as e:
        if str(e) != "aggregate signature verification failed":
            raise AssertionError(f"tampered aggregate raised {e!r}") from e
    else:
        raise AssertionError("a tampered aggregate verified")


def drive_bls(dev) -> dict:
    """Phase 14: bench.py's bench_commit_ab(150, 4), its BLS half, on the
    port: 4 aggregate commits of 150 bls12381 validators through
    verify_commit and verify_commit_range with no hub (each check one
    pairing item of 151 pairs: K7a and K7b at the (2, 256) bucket), the
    pure-Python floor on one commit, a tampered aggregate, and one
    per-signature BLS commit through a running hub's "bls" partition (101
    signatures: the (128, 2) bucket), honest and tampered."""
    from dataclasses import replace

    from tendermint_tpu_torch.crypto import bls, bls_math, verify_hub
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.types.validation import verify_commit, verify_commit_range

    import gc
    import threading

    kernels = (BP.MILLER.name, BP.FINAL_EXP.name)
    host_state = {"threads": sorted(t.name for t in threading.enumerate()),
                  "gc_objects": len(gc.get_objects()), "gc_counts": gc.get_count()}
    ab = build_bls_commits(N_VALS, N_AB_COMMITS)
    print(f"bls: built {N_VALS} validators and {N_AB_COMMITS} aggregate commits in "
          f"{ab['build_s']:.1f} s")
    vals, aggs = ab["vals"], ab["aggs"]
    BP.warmup(device=dev)
    audit = PairingAudit()
    trace.configure(enabled=True)  # the host split comes from the `bls` spans

    # the timed passes, no hub (bench.py's): verify_commit on each, then
    # one verify_commit_range over all of them
    _launch_counts(reset=True)

    def each():
        out = []
        for v, bid, h, agg in aggs:
            before = _bls_host_split()
            t0 = time.perf_counter()
            verify_commit(AB_CHAIN_ID, v, bid, h, agg, device=dev)
            wall = time.perf_counter() - t0
            out.append({"height": h, "wall_s": wall,
                        **{k: x - before[k] for k, x in _bls_host_split().items()}})
        return out

    with audit.recording(BLS_MAIN):
        single = _bls_pass(dev, each)
        ranged = _bls_pass(dev, lambda: verify_commit_range(AB_CHAIN_ID, aggs, device=dev))
    launches = _launch_counts()
    shapes = audit.shapes(BLS_MAIN)
    want_shape = (BP.bucket_items(1), BP.bucket_pairs(N_VALS + 1))
    if shapes != [(k, want_shape) for k in sorted(kernels)] or \
            any(launches[k] != 2 * N_AB_COMMITS for k in kernels):
        raise AssertionError(f"aggregate path: shapes {shapes}, launches {launches}")
    for k in kernels:
        if audit.seen[(k, want_shape)]["calls"][BLS_MAIN] != 2 * N_AB_COMMITS:
            raise AssertionError(f"{k}: {audit.seen[(k, want_shape)]['calls']}")

    # the pure-Python floor (bls.aggregate_verify: the same hashing and
    # line preparation, then 151 Miller loops and one final
    # exponentiation in bls_math) against the card's verify_commit on the
    # same commit, in turns (floor, card, card, floor), the memo cleared
    # before each: the host's speed drifts within a call
    v, bid, h, agg = aggs[0]
    signers = [i for i, cs in enumerate(agg.signatures) if not cs.is_absent()]
    pubs = [v.validators[i].pub_key for i in signers]
    msgs = [agg.vote_sign_bytes(AB_CHAIN_ID, i) for i in signers]

    def floor():
        if not bls.aggregate_verify(pubs, msgs, agg.agg_sig):
            raise AssertionError("bls.aggregate_verify rejected the honest aggregate")

    turns = []
    for label, fn in (("floor", floor),
                      ("card", lambda: verify_commit(AB_CHAIN_ID, v, bid, h, agg, device=dev)),
                      ("card", lambda: verify_commit(AB_CHAIN_ID, v, bid, h, agg, device=dev)),
                      ("floor", floor)):
        bls_math._H2_MEMO.clear()
        t0 = time.perf_counter()
        fn()
        turns.append({"run": label, "wall_s": time.perf_counter() - t0})
    floor_s = sorted(t["wall_s"] for t in turns if t["run"] == "floor")
    card_s = sorted(t["wall_s"] for t in turns if t["run"] == "card")

    # the tampered aggregate: one validator signs other bytes
    _vs, _b, _h, c1 = ab["per_sig"][0]
    sigs = [cs.signature for cs in c1.signatures]
    key = ab["keys"][vals.validators[AB_TAMPER_VAL].address]
    sigs[AB_TAMPER_VAL] = key.sign(b"not the vote")
    bad = replace(agg, agg_sig=bls.aggregate_signatures(sigs))
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    with audit.recording(BLS_TAMPERED):
        _expect_aggregate_failure(lambda: verify_commit(AB_CHAIN_ID, v, bid, h, bad, device=dev))
    tampered_s = time.perf_counter() - t0
    tlaunches = _launch_counts()
    if any(tlaunches[k] != 1 for k in kernels):
        raise AssertionError(f"tampered aggregate: launches {tlaunches}")

    # one per-signature BLS commit through a running hub: the "bls"
    # partition, 101 signatures under the range's light tally

    def per_sig(entry, path, tampered: bool):
        """The range in a fresh hub (an empty verdict cache); a tampered
        range must name the commit and the signature."""
        trace.RECORDER.clear()
        hub = verify_hub.acquire_hub(device=dev)
        err = None
        try:
            _launch_counts(reset=True)
            t0 = time.perf_counter()
            with audit.recording(path):
                if tampered:
                    err = _expect_failure(
                        lambda: verify_commit_range(AB_CHAIN_ID, [entry], device=dev),
                        0, AB_TAMPER_VAL)
                else:
                    verify_commit_range(AB_CHAIN_ID, [entry], device=dev)
            wall = time.perf_counter() - t0
            stats = hub.stats()
        finally:
            verify_hub.release_hub()
        if verify_hub.running_hub() is not None:
            raise AssertionError("release_hub left a running hub")
        return err, {"wall_s": wall, "dispatches": _dispatch_routes(),
                     "scheme_bls_sigs": stats["scheme_bls_sigs"],
                     "scheme_edwards_sigs": stats["scheme_edwards_sigs"],
                     "cache_hits": stats["cache_hits"], "launches": _launch_counts(),
                     "shapes": [list(s) for _k, s in audit.shapes(path)]}

    sigs_needed = len(range_items([ab["per_sig"][0]], AB_CHAIN_ID))
    _err, honest = per_sig(ab["per_sig"][0], BLS_PERSIG, tampered=False)
    ps_shape = (BP.bucket_items(sigs_needed), 2)
    if honest["scheme_bls_sigs"] != sigs_needed or honest["dispatches"] != ["cuda"] \
            or audit.shapes(BLS_PERSIG) != [(k, ps_shape) for k in sorted(kernels)] \
            or any(honest["launches"][k] != 1 for k in kernels):
        raise AssertionError(f"per-signature BLS commit: {honest}")
    bad_entry = tamper(ab["per_sig"], 0, AB_TAMPER_VAL)[0]
    err, tampered_ps = per_sig(bad_entry, BLS_PERSIG_TAMPERED, tampered=True)
    if any(tampered_ps["launches"][k] != 1 for k in kernels):
        raise AssertionError(f"tampered per-signature commit: {tampered_ps}")

    rows, checks = check_bls_kernels(dev, audit, want_shape, ps_shape)
    n_signers = len(signers)
    return {
        "entry": "types.validation.verify_commit / verify_commit_range on aggregate commits "
                 "(bench.py bench_commit_ab, bls_aggregate), no hub",
        "device": dev.type,
        "validators": N_VALS,
        "commits": N_AB_COMMITS,
        "pairs_per_check": n_signers + 1,
        "bucket": list(want_shape),
        "build_s": ab["build_s"],
        "host_at_start": host_state,
        "verify_commit": single,
        "verify_commit_ms_per_commit": single["wall_s"] / N_AB_COMMITS * 1e3,
        "verify_sigs_per_s": n_signers * N_AB_COMMITS / single["wall_s"],
        "verify_commit_range": ranged,
        "catchup_blocks_per_s": N_AB_COMMITS / ranged["wall_s"],
        "launches": launches,
        "floor": {"entry": "crypto.bls.aggregate_verify (pure-Python bls_math), one commit",
                  "turns": turns, "floor_over_card": (floor_s[0] + floor_s[1]) / (card_s[0] + card_s[1])},
        "tampered": {"validator": AB_TAMPER_VAL, "wall_s": tampered_s, "launches": tlaunches,
                     "raised": "aggregate signature verification failed"},
        "per_signature": {"sigs": sigs_needed, "bucket": list(ps_shape), "honest": honest,
                          "tampered": {**tampered_ps, "validator": AB_TAMPER_VAL,
                                       "raised": str(err), "failed_index": err.failed_index}},
        "kernel_checks": checks,
        "rows": rows,
    }


SS_MAIN = "statesync[restore, ed25519 backfill]"
SS_TAMPERED = "statesync[tampered ed25519 window]"
SS_BLS = "statesync[bls backfill]"
SS_BLS_TAMPERED = "statesync[bls backfill, tampered aggregate]"


def _restore(dev, source, *, tamper_height: int | None = None) -> dict:
    """One run of `testing.statesync_restore_scenario(N_SS_BLOCKS,
    N_SS_VALS)` on `dev`, serving `source` through a fresh connection to
    its app (a new lock in this run's event loop). With `tamper_height`,
    the donor serves that height's commit with a flipped bit in signature
    0. Returns the held headers, the restored State's bytes, the held
    header hashes, the joiner's BootD stats, the routes of every batch,
    the backfill windows and the errors the joiner reported."""
    import asyncio
    from dataclasses import replace

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.proxy import AppConns

    bstore, sstore, conns, genesis = source
    load = bstore.load_block_commit
    if tamper_height is not None:
        def load_block_commit(height):
            commit = load(height)
            if height != tamper_height:
                return commit
            sigs = list(commit.signatures)
            bad = sigs[0].signature[:-1] + bytes([sigs[0].signature[-1] ^ 0x01])
            sigs[0] = replace(sigs[0], signature=bad)
            return replace(commit, signatures=tuple(sigs))

        bstore.load_block_commit = load_block_commit
    report: dict = {}
    trace.RECORDER.clear()
    try:
        with _batch_routes() as routes:
            t0 = time.perf_counter()
            held = asyncio.run(tt.statesync_restore_scenario(
                N_SS_BLOCKS, N_SS_VALS, device=dev,
                source=(bstore, sstore, AppConns.local(conns.consensus.app), genesis),
                report=report))
            wall = time.perf_counter() - t0
    finally:
        bstore.load_block_commit = load
    client = report["client"]
    errors = []
    while not client.chunk_ch.err_q.empty():
        e = client.chunk_ch.err_q.get_nowait()
        errors.append({"peer": e.node_id, "err": e.err, "ban": e.ban})
    state = report["state"]
    top = state.last_block_height
    return {
        "held": held,
        "wall_s": wall,
        "sync_s": report["wall_s"],
        "headers_per_s": held / wall,
        "height": top,
        "app_hash": state.app_hash.hex(),
        "state": state.encode(),
        "headers": [report["block_store"].load_block_meta(h).header.hash()
                    for h in range(top - held + 1, top + 1)],
        "stats": dict(client.bootd.stats),
        "donor_stats": {k: v for k, v in report["server"].bootd.stats.items()
                        if k.startswith(("chunk", "cache", "store", "snapshots"))},
        "routes": routes,
        "windows": [s["attrs"] for s in trace.RECORDER.dump(subsystem="boot")
                    if s["name"] == "backfill_verify"],
        "errors": errors,
    }


def build_bls_backfill(n_vals: int, n_heights: int) -> dict:
    """A light chain of `n_heights` heights of `n_vals` bls12381 validators
    (tests/test_boot_fleet.py's bls_blocks shape), each commit folded into
    its aggregate; the per-signature commits are kept too."""
    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.light.types import LightBlock, SignedHeader
    from tendermint_tpu_torch.types.block import aggregate_commit

    t0 = time.perf_counter()
    vals, keys = tt.make_validator_set(n_vals, key_types=("bls12381",))
    chain = tt.make_light_chain(n_heights, vals, keys, SS_CHAIN_ID)
    folded = [LightBlock(SignedHeader(lb.header, aggregate_commit(lb.signed_header.commit, vals)),
                         lb.validators) for lb in chain]
    return {"vals": vals, "keys": keys, "per_sig": chain, "blocks": folded,
            "build_s": time.perf_counter() - t0}


def drive_statesync(dev) -> dict:
    """Phase 15: bench.py's bench_statesync(64, 21) on the port — snapshot
    restore and verified backfill over the statesync reactors on the card,
    against the same scenario on the host in turns (floor, card, card,
    floor); a tampered backfill window; then the BLS-committee backfill
    through verify_backfill_batch (K7a and K7b, one pairing per height)
    and a tampered aggregate."""
    import asyncio
    from dataclasses import replace

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto import bls
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.light.types import LightBlock, SignedHeader
    from tendermint_tpu_torch.statesync import fleet
    from tendermint_tpu_torch.types.validation import InvalidCommitError

    trace.configure(enabled=True)  # the backfill windows and the BLS host split come from spans
    t0 = time.perf_counter()
    source = asyncio.run(tt.build_statesync_source(N_SS_BLOCKS, N_SS_VALS, device="cpu"))
    build_s = time.perf_counter() - t0
    print(f"statesync: built the {N_SS_BLOCKS}-block donor chain of {N_SS_VALS} validators "
          f"in {build_s:.1f} s")

    # the restore in turns: the host floor (device="cpu") and the card
    turns = []
    for label, d in (("floor", "cpu"), ("card", dev), ("card", dev), ("floor", "cpu")):
        _launch_counts(reset=True)
        run = _restore(d, source)
        run["launches"] = _launch_counts()
        run["run"] = label
        turns.append(run)
    card = turns[1]
    for run in turns:
        if (run["held"], run["state"], run["headers"]) != (card["held"], card["state"],
                                                           card["headers"]):
            raise AssertionError(f"statesync: the {run['run']} run restored another chain")
        if run["height"] != SS_SNAPSHOT_HEIGHT or run["held"] != SS_SNAPSHOT_HEIGHT \
                or run["stats"]["backfill_heights"] != SS_SNAPSHOT_HEIGHT - 1:
            raise AssertionError(f"statesync: held {run['held']}, stats {run['stats']}")
    for run in turns:
        del run["state"], run["headers"]
    card_s = sorted(r["wall_s"] for r in turns if r["run"] == "card")
    floor_s = sorted(r["wall_s"] for r in turns if r["run"] == "floor")

    # a tampered backfill window: the joiner must punish the donor and stop
    _launch_counts(reset=True)
    tampered = _restore(dev, source, tamper_height=SS_TAMPER_HEIGHT)
    tampered["launches"] = _launch_counts()
    del tampered["state"], tampered["headers"]
    if tampered["held"] != 1 or tampered["stats"]["backfill_heights"] != 0 \
            or tampered["stats"]["poisoned_rejects"] != 1 \
            or [(e["peer"], e["ban"]) for e in tampered["errors"]] != [("server", True)] \
            or "forged backfill commit" not in tampered["errors"][0]["err"]:
        raise AssertionError(f"tampered backfill window: {tampered}")

    # the BLS-committee backfill: one aggregate pairing per height
    bb = build_bls_backfill(N_SS_VALS, N_SS_BLS_HEIGHTS)
    print(f"statesync: built {N_SS_BLS_HEIGHTS} aggregate heights of {N_SS_VALS} bls12381 "
          f"validators in {bb['build_s']:.1f} s")
    blocks = bb["blocks"]
    BP.warmup(device=dev)
    audit = PairingAudit()
    bootd = fleet.BootD(None)
    _launch_counts(reset=True)
    with audit.recording(SS_BLS):
        bls_pass = _bls_pass(dev, lambda: asyncio.run(
            fleet.verify_backfill_batch(SS_CHAIN_ID, blocks, bootd=bootd, device=dev)))
    bls_launches = _launch_counts()
    _require_all_launched(SS_BLS, bls_launches, names=(BP.MILLER.name, BP.FINAL_EXP.name))
    want_shape = (BP.bucket_items(1), BP.bucket_pairs(N_SS_VALS + 1))
    if bootd.stats["backfill_agg_heights"] != N_SS_BLS_HEIGHTS \
            or bls_pass["calls"] != N_SS_VALS * N_SS_BLS_HEIGHTS \
            or any(bls_launches[k] != N_SS_BLS_HEIGHTS for k in (BP.MILLER.name, BP.FINAL_EXP.name)) \
            or audit.shapes(SS_BLS) != [(k, want_shape) for k in sorted((BP.MILLER.name,
                                                                         BP.FINAL_EXP.name))]:
        raise AssertionError(f"bls backfill: stats {bootd.stats}, launches {bls_launches}, "
                             f"shapes {audit.shapes(SS_BLS)}")

    # the tampered aggregate: one validator signs other bytes at one height
    lb = bb["per_sig"][SS_BLS_TAMPER_INDEX]
    sigs = [cs.signature for cs in lb.signed_header.commit.signatures]
    sigs[AB_TAMPER_VAL] = bb["keys"][bb["vals"].validators[AB_TAMPER_VAL].address].sign(
        b"not the vote")
    agg = blocks[SS_BLS_TAMPER_INDEX].signed_header.commit
    bad = list(blocks)
    bad[SS_BLS_TAMPER_INDEX] = LightBlock(
        SignedHeader(lb.header, replace(agg, agg_sig=bls.aggregate_signatures(sigs))), lb.validators)
    bad_bootd = fleet.BootD(None)
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    with audit.recording(SS_BLS_TAMPERED):
        try:
            asyncio.run(fleet.verify_backfill_batch(SS_CHAIN_ID, bad, bootd=bad_bootd, device=dev))
        except InvalidCommitError as e:
            err = e
        else:
            raise AssertionError("a tampered aggregate backfilled")
    tampered_bls_s = time.perf_counter() - t0
    tampered_bls_launches = _launch_counts()
    named = blocks[err.failed_index].height
    if named != blocks[SS_BLS_TAMPER_INDEX].height or \
            str(err) != "aggregate signature verification failed" or \
            any(v for k, v in bad_bootd.stats.items() if k.startswith("backfill")):
        raise AssertionError(f"tampered aggregate: {err!r} at index {err.failed_index}, "
                             f"stats {bad_bootd.stats}")
    held = _hold_pairing_shapes(dev, audit)
    return {
        "entry": "testing.statesync_restore_scenario (bench.py bench_statesync(64, 21)); "
                 "statesync.fleet.verify_backfill_batch over aggregate commits",
        "device": dev.type,
        "blocks": N_SS_BLOCKS,
        "validators": N_SS_VALS,
        "build_s": build_s,
        "restore": {"turns": turns, "floor_over_card": (floor_s[0] + floor_s[1]) / (card_s[0] + card_s[1])},
        "tampered": {"height": SS_TAMPER_HEIGHT, **tampered},
        "bls_backfill": {
            "heights": N_SS_BLS_HEIGHTS, "validators": N_SS_VALS, "build_s": bb["build_s"],
            "bucket": list(want_shape), "stats": dict(bootd.stats), "launches": bls_launches,
            "wall_s": bls_pass["wall_s"], "wall_per_height_s": bls_pass["wall_s"] / N_SS_BLS_HEIGHTS,
            "pass": bls_pass,
            "tampered": {"height": named, "failed_index": err.failed_index, "raised": str(err),
                         "wall_s": tampered_bls_s, "launches": tampered_bls_launches},
            "kernel_checks": held,
        },
    }


MERKLE_PATH = "merkle[device route, 64 / 1,024 / 16,384 leaves]"


def _merkle_scalar(items: list[bytes]) -> bytes:
    """The recursive RFC 6962 builder (the reference's
    hash_from_byte_slices_scalar; bench_merkle's baseline), on hashlib."""
    import hashlib

    n = len(items)
    if n == 0:
        return hashlib.sha256(b"").digest()
    if n == 1:
        return hashlib.sha256(b"\x00" + items[0]).digest()
    k = 1 << ((n - 1).bit_length() - 1)
    return hashlib.sha256(b"\x01" + _merkle_scalar(items[:k]) + _merkle_scalar(items[k:])).digest()


def _paired_best(fa, fb, reps=5):
    """bench_merkle's interleaved best-of-reps: (best a, best b) seconds."""
    best_a = best_b = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fa()
        t1 = time.perf_counter()
        fb()
        t2 = time.perf_counter()
        best_a, best_b = min(best_a, t1 - t0), min(best_b, t2 - t1)
    return best_a, best_b


def _sha_batch(dev, n, lengths, prefix, seed):
    """n seeded messages of `lengths` (cycled) packed after `prefix` bytes:
    (messages, the buffer on `dev`, the offsets on the host)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    msgs = [rng.integers(0, 256, lengths[i % len(lengths)], dtype=np.uint8).tobytes()
            for i in range(n)]
    buf = torch.frombuffer(bytearray(bytes(prefix) + b"".join(msgs)), dtype=torch.uint8).to(dev)
    offsets = torch.from_numpy(np.cumsum([prefix] + [len(m) for m in msgs]).astype(np.int64))
    return msgs, buf, offsets


def _route_split(dev, msgs) -> dict:
    """The device route's parts for one `hash_hub.sha256_many` call on
    `msgs`: the host's preparation and the copies from the `hash` trace
    spans that `sha256_device` emits, and the launch timed by CUDA events
    around `_bytes_cuda`, which waits for its kernel here so that the copy
    out is the copy alone; `outside_ms` is the rest of the hub's
    `hash.batch` span (the lengths and the routing)."""
    import torch

    from tendermint_tpu_torch.crypto import hash_hub
    from tendermint_tpu_torch.crypto.cuda import sha256 as S
    from tendermint_tpu_torch.libs import trace

    launch = S._bytes_cuda
    kernel_ms = []

    def timed(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        digests = launch(*args)
        end.record()
        end.synchronize()
        kernel_ms.append(start.elapsed_time(end))
        return digests

    trace.configure(enabled=True)
    trace.RECORDER.clear()
    hash_hub.use_device(dev)
    S._bytes_cuda = timed
    try:
        hash_hub.sha256_many(msgs)
    finally:
        S._bytes_cuda = launch
        hash_hub.use_device(None)
    spans = trace.RECORDER.dump(subsystem="hash")
    trace.RECORDER.clear()
    out = {f"{name}_ms": sum(sp["duration_ms"] for sp in spans if sp["name"] == name)
           for name in ("prepare", "h2d", "launch", "d2h", "batch")}
    out["outside_ms"] = out["batch_ms"] - sum(out[f"{k}_ms"] for k in ("prepare", "h2d", "launch", "d2h"))
    out["kernel_ms"] = sum(kernel_ms)
    out["launches"] = len(kernel_ms)
    prep = [sp["attrs"] for sp in spans if sp["name"] == "prepare"]
    if out["launches"] != 1 or len(prep) != 1:
        raise AssertionError(f"hash route split: {out['launches']} launches, spans {spans}")
    out["messages"], out["bytes"] = prep[0]["n"], prep[0]["bytes"]
    out["messages_per_s"] = out["messages"] / out["batch_ms"] * 1e3
    return out


def _crossover(dev, make_msgs) -> dict:
    """The device route against the hashlib loop, both through
    `hash_hub.sha256_many` (MIN_DEVICE_BATCH = 1), at each width of
    CROSSOVER_WIDTHS (bench_merkle's interleaved best of 5): the times and
    the narrowest width at which the route is faster."""
    from tendermint_tpu_torch.crypto import hash_hub

    saved = hash_hub.MIN_DEVICE_BATCH
    hash_hub.MIN_DEVICE_BATCH = 1
    rows = []
    try:
        for w in CROSSOVER_WIDTHS:
            msgs = make_msgs(w)
            hash_hub.use_device(dev)
            if hash_hub.sha256_many(msgs) != [hashlib.sha256(m).digest() for m in msgs]:
                raise AssertionError(f"crossover at {w}: the device route's digests differ")

            def host():
                hash_hub.use_device(None)
                hash_hub.sha256_many(msgs)

            def card():
                hash_hub.use_device(dev)
                hash_hub.sha256_many(msgs)

            th, td = _paired_best(host, card)
            rows.append({"width": w, "hashlib_ms": th * 1e3, "device_ms": td * 1e3})
    finally:
        hash_hub.use_device(None)
        hash_hub.MIN_DEVICE_BATCH = saved
    wins = [r["width"] for r in rows if r["device_ms"] < r["hashlib_ms"]]
    return {"narrowest_win": min(wins) if wins else None, "widths": rows}


def drive_sha256(dev) -> tuple[dict, list]:
    """Phase 16: B8 torch.equal to its plain version and equal to hashlib
    at every batch width of SHA_COUNTS; bench_merkle's leaves half through
    the HashHub's device route (launches counted, one a device batch); the
    route's split and its crossover with hashlib; the B8 rows."""
    import numpy as np

    from tendermint_tpu_torch.crypto import hash_hub, merkle
    from tendermint_tpu_torch.crypto.cuda import sha256 as S

    held = []
    for n in SHA_COUNTS:
        # the lengths cycled from a different place for each n, after n % 16
        # bytes: messages and thread blocks start at every alignment
        lens = SHA_LENGTHS[n % len(SHA_LENGTHS):] + SHA_LENGTHS[: n % len(SHA_LENGTHS)]
        msgs, buf, offsets = _sha_batch(dev, n, lens, n % 16, seed=n)
        err = _hold(S.SHA256, f"n={n}", lambda: S.sha256_bytes(buf, offsets),
                    lambda: S._sha256_bytes_plain(buf, offsets))
        digests = S.sha256_bytes(buf, offsets).cpu().numpy().view("V32").ravel().tolist()
        if digests != [hashlib.sha256(m).digest() for m in msgs]:
            raise AssertionError(f"sha256_bytes (n={n}): digests differ from hashlib")
        held.append({"n": n, "prefix": n % 16, "bytes": buf.numel(), "max_abs_err": err,
                     "hashlib": True})
    over_limit = {}
    for entry, call in (
        ("sha256_device", lambda: S.sha256_device([b"ok", b"x" * 504], device=dev)),
        ("sha256_bytes", lambda: S.sha256_bytes(*_sha_batch(dev, 2, [2, 504], 0, seed=504)[1:])),
    ):
        try:
            call()
        except ValueError as e:
            over_limit[entry] = str(e)
        else:
            raise AssertionError(f"{entry}: a 504-byte message hashed on the device")

    # bench_merkle's leaves half: scalar recursive, batched on the host,
    # batched through the device route from one message (bench.py's
    # MIN_DEVICE_BATCH = 1 for its device half)
    saved = hash_hub.MIN_DEVICE_BATCH
    leaves_rows = {}
    _launch_counts(reset=True)
    try:
        for n in MERKLE_LEAVES:
            leaves = [bytes([i % 256, (i >> 8) % 256]) * 125 for i in range(n)]
            root = _merkle_scalar(leaves)
            hash_hub.use_device(None)
            hash_hub.MIN_DEVICE_BATCH = saved
            if merkle.hash_from_byte_slices(leaves) != root:
                raise AssertionError(f"merkle {n}: the host route's root differs")
            ts, tb = _paired_best(lambda: _merkle_scalar(leaves),
                                  lambda: merkle.hash_from_byte_slices(leaves))
            hash_hub.use_device(dev)
            hash_hub.MIN_DEVICE_BATCH = 1
            hash_hub.reset_stats()
            before = S.SHA256.launches
            if merkle.hash_from_byte_slices(leaves) != root:
                raise AssertionError(f"merkle {n}: the device route's root differs")
            _, td = _paired_best(lambda: None, lambda: merkle.hash_from_byte_slices(leaves))
            stats = hash_hub.stats_snapshot()
            launched = S.SHA256.launches - before
            if stats["device_batches"] == 0 or launched != stats["device_batches"]:
                raise AssertionError(f"merkle {n}: {launched} launches for the device batches "
                                     f"{stats}")
            leaves_rows[str(n)] = {
                "scalar_leaves_per_s": n / ts, "batched_cpu_leaves_per_s": n / tb,
                "device_leaves_per_s": n / td, "device_over_host": tb / td,
                "device_batches": stats["device_batches"], "device_messages": stats["device_messages"],
                "batches": stats["batches"], "launches": launched,
            }
            print(f"merkle {n:>6} leaves: scalar {n / ts:,.0f}/s, host batched {n / tb:,.0f}/s, "
                  f"device {n / td:,.0f}/s ({launched} launches, one a device batch)")
    finally:
        hash_hub.use_device(None)
        hash_hub.MIN_DEVICE_BATCH = saved
    launches = _launch_counts()
    _require_all_launched(MERKLE_PATH, launches, names=(S.SHA256.name,))

    leaves = [bytes([i % 256, (i >> 8) % 256]) * 125 for i in range(16384)]
    split = {"leaf_level_16384": _route_split(dev, [b"\x00" + x for x in leaves]),
             "inner_level_8192": _route_split(dev, [b"\x01" + bytes(64)] * 8192)}
    crossover = {
        "leaves_251": _crossover(dev, lambda w: [b"\x00" + x for x in leaves[:w]]),
        "nodes_65": _crossover(dev, lambda w: [b"\x01" + i.to_bytes(4, "big") * 16
                                               for i in range(w)]),
    }
    print(f"crossover with hashlib: 251-byte leaves from {crossover['leaves_251']['narrowest_win']}, "
          f"65-byte nodes from {crossover['nodes_65']['narrowest_win']} messages")

    # the B8 rows: the 250-byte leaves (251 with the prefix: 5 blocks) at
    # the 16,384-leaf level and at the old rows' 4,096, the 65-byte inner
    # nodes (2 blocks) at the 8,192-node level; the bound is the largest of
    # the bytes, the int32 instructions and the rounds' serial chain. The
    # plain version takes 0.25-2 s a call here: 20 repeats time it 4 times.
    hz = _sm_max_hz()
    ops_per_s = _int32_ops_per_s()
    sass_ops = _sass_block_ops(S.SHA256.source)
    block_ops = min(SHA256_BLOCK_OPS, sass_ops or SHA256_BLOCK_OPS)
    cycles = _block_cycles(dev)
    rows = []
    for n, length in ((16384, 251), (8192, 65), (4096, 251)):
        _msgs, buf, offsets = _sha_batch(dev, n, [length], 0, seed=length)
        blocks = S._padded_blocks(length)
        n_bytes = buf.numel() + 8 * (n + 1) + 32 * n
        row = _kernel_row(S.SHA256, n, lambda b=buf, o=offsets: S.sha256_bytes(b, o),
                          lambda b=buf, o=offsets: S._sha256_bytes_plain(b, o),
                          n_bytes, n * blocks * block_ops, 20, ops_per_s=ops_per_s)
        bounds = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
                  "int32": n * blocks * block_ops / ops_per_s * 1e3,
                  "serial_chain": cycles["chain_cycles_per_block"] * blocks / hz * 1e3}
        kind = max(bounds, key=bounds.get)
        row["bound_ms"] = bounds[kind]
        row["bound_by"] = "bytes" if kind == "bytes" else "operations"
        row["bound_kind"] = kind
        row["bounds_ms"] = bounds
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["shape"] = [n, length]
        row["message_bytes"] = length
        row["real_blocks"] = n * blocks
        row["ops_per_block"] = {"counted": SHA256_BLOCK_OPS, "sass": sass_ops, "bound": block_ops}
        row["block_cycles"] = dict(cycles, sm_max_hz=hz, blocks=blocks)
        # what one warp alone issues for a message's blocks: not a bound
        row["one_warp_ms"] = cycles["one_warp_cycles_per_block"] * blocks / hz * 1e3
        row["bound_rate"] = (f"int32: {H100_SMS} SMs x {INT32_LANES_PER_SM} lanes x clocks.max.sm "
                             f"= {ops_per_s:.4g} op/s")
        row["launches"] = launches[S.SHA256.name]
        row["path"] = MERKLE_PATH
        rows.append(row)
    return {"held": held, "over_limit": over_limit, "leaves": leaves_rows, "launches": launches,
            "device_split": split, "crossover": crossover, "block_cycles": cycles}, rows


LF_COLD = "light_fleet[bls_aggregate: cold client, per-signature hops]"
LF_MAIN = "light_fleet[bls_aggregate: 64 LightD.sync, hop_proof]"
LF_REVERIFY = "light_fleet[verify_hop_proof, aggregate]"
LF_PERSIG = "light_fleet[per_sig: 64 LightD.sync, hop_proof]"
LF_LUNATIC = "light_fleet[lunatic primary, honest witness]"


def _watchdog():
    """bench.py's LoopWatchdog (30 s): a wedged loop writes its stacks to
    chiprun_out/watchdog/."""
    from tendermint_tpu_torch.libs.watchdog import LoopWatchdog

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out", "watchdog")
    return LoopWatchdog(out, threshold_s=30.0)


@contextlib.contextmanager
def _recording(audits, path: str):
    """Record `path` in each of `audits` (ShapeAudit, PairingAudit)."""
    with contextlib.ExitStack() as stack:
        for a in audits:
            stack.enter_context(a.recording(path))
        yield


def _pct(values: list, p: float) -> float:
    """bench.py's percentile: the value at index int(p * n) of the sorted list."""
    s = sorted(values)
    return s[min(len(s) - 1, int(p * len(s)))] if s else 0.0


def build_light_fleet_chain(scheme: str) -> dict:
    """bench_light_fleet's chain for `scheme`: LF_VALS validators (seed
    b"lf-" + scheme, ed25519 or bls12381) and LF_HEIGHTS signed headers."""
    from tendermint_tpu_torch import testing as tt

    t0 = time.perf_counter()
    key_types = ("bls12381",) if scheme == "bls_aggregate" else ("ed25519",)
    vals, keys = tt.make_validator_set(LF_VALS, key_types=key_types, seed=b"lf-" + scheme.encode())
    chain = tt.make_light_chain(LF_HEIGHTS, vals, keys, LF_CHAIN_ID)
    return {"vals": vals, "keys": keys, "chain": chain, "build_s": time.perf_counter() - t0}


def _light_fleet_scheme(dev, chain, aggregate_hops: bool, audits, cold_path,
                        main_path) -> tuple[dict, object]:
    """bench_light_fleet's `_one_scheme` on the port, on `dev`, under
    asyncio.wait_for and a LoopWatchdog: a cold LightClient alone, then
    LF_CLIENTS concurrent `LightD.sync(LF_HEIGHTS)` on one LightD
    (LightDConfig(max_sessions=32, aggregate_hops)), then `hop_proof`.
    Each of the two runs counts launches from 0 and records its batch
    routes and, in each of `audits` (the ShapeAudit and the
    PairingAudit), its kernel shapes; the LightD run also its BLS host
    split. Returns the bench's record and the served HopProof."""
    import asyncio

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.config import LightDConfig
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.light import fleet
    from tendermint_tpu_torch.light.client import LightClient, TrustOptions

    wd = _watchdog()
    trust = TrustOptions(period_ns=10**18, height=1, hash=chain[0].header.hash())
    now = chain[-1].header.time_ns + 10**9

    async def run() -> dict:
        wd.start()
        try:
            # the cold baseline: one client verifying alone
            cold_prov = tt.make_list_provider(chain, LF_CHAIN_ID)
            lc = LightClient(LF_CHAIN_ID, trust, cold_prov, device=dev)
            _launch_counts(reset=True)
            with _batch_routes() as cold_routes, _recording(audits, cold_path):
                t0 = time.perf_counter()
                cold = await lc.verify_light_block_at_height(LF_HEIGHTS, now)
                cold_s = time.perf_counter() - t0
            cold_launches = _launch_counts()

            prov = tt.make_list_provider(chain, LF_CHAIN_ID)
            d = fleet.LightD(LF_CHAIN_ID, trust, prov, config=LightDConfig(
                max_sessions=LF_SESSIONS, aggregate_hops=aggregate_hops), device=dev)
            await d.start()
            latencies, served, shed = [], [], 0

            async def one_client():
                nonlocal shed
                c0 = time.perf_counter()
                try:
                    lb = await d.sync(LF_HEIGHTS, now_ns=now)
                except fleet.LightDBusyError:
                    shed += 1
                    return
                latencies.append(time.perf_counter() - c0)
                served.append(lb)

            trace.RECORDER.clear()
            _launch_counts(reset=True)
            try:
                with _batch_routes() as routes, _recording(audits, main_path):
                    t0 = time.perf_counter()
                    await asyncio.gather(*(one_client() for _ in range(LF_CLIENTS)))
                    elapsed = max(time.perf_counter() - t0, 1e-9)
                    proof = await d.hop_proof(LF_HEIGHTS)
                stats = dict(d.stats)
            finally:
                await d.stop()
            return {"cold": cold, "cold_s": cold_s, "cold_hops": cold_prov.fetches,
                    "cold_routes": cold_routes, "cold_launches": cold_launches,
                    "served": served, "latencies": latencies, "shed": shed, "elapsed": elapsed,
                    "proof": proof, "stats": stats, "fetches": prov.fetches, "routes": routes,
                    "launches": _launch_counts(), "host_split": _bls_host_split()}
        finally:
            wd.stop()

    r = asyncio.run(asyncio.wait_for(run(), LF_TIMEOUT_S))
    want = chain[LF_HEIGHTS - 1].header.hash()
    if r["cold"].header.hash() != want or len(r["served"]) + r["shed"] != LF_CLIENTS \
            or any(lb.header.hash() != want for lb in r["served"]):
        raise AssertionError(f"light fleet: a client's block is not the chain's header at "
                             f"{LF_HEIGHTS}")
    stats, proof, elapsed = r["stats"], r["proof"], r["elapsed"]
    hops = max(stats["hops_verified"], 1.0)
    lookups = stats["hop_cache_hits"] + stats["hop_cache_misses"]
    return {
        "proof_scheme": proof.scheme,
        "hop_proof_wire_bytes": proof.wire_bytes(),
        "sig_bytes_per_hop": 96 if proof.scheme == fleet.SCHEME_AGGREGATE else 64 * LF_VALS,
        "syncs_per_s": len(r["latencies"]) / elapsed,
        "completed": len(r["latencies"]),
        "shed": r["shed"],
        "shed_rate": r["shed"] / LF_CLIENTS,
        "p50_sync_s": _pct(r["latencies"], 0.50),
        "p99_sync_s": _pct(r["latencies"], 0.99),
        "hop_cache_hit_rate": stats["hop_cache_hits"] / lookups if lookups else 0.0,
        "coalesced": stats["coalesced"],
        "hops_verified": stats["hops_verified"],
        "sigs_covered_per_s": hops * LF_VALS / elapsed,
        "cold_client_s": r["cold_s"],
        "cold_client_hops": r["cold_hops"],
        "amortization_factor": r["cold_hops"] * LF_CLIENTS / max(r["fetches"], 1),
        "wall_s": elapsed,
        "stats": stats,
        "cold_routes": r["cold_routes"],
        "cold_launches": r["cold_launches"],
        "routes": r["routes"],
        "launches": r["launches"],
        "host_split": r["host_split"],
        "watchdog_reports": len(wd.reports),
    }, proof


def drive_light_fleet(dev, audit: ShapeAudit, pairing: "PairingAudit") -> dict:
    """Phase 17: bench.py's bench_light_fleet(150, 64, 6) on the port —
    per_sig (ed25519) and bls_aggregate (bls12381) hops; the served
    aggregate HopProof re-verified on the card with the memos cleared,
    then with one flipped aggregate bit; a LightD with a lunatic primary
    and an honest witness. Kernel shapes go to `audit` (B1-B3) and
    `pairing` (K7a/K7b)."""
    import asyncio
    from dataclasses import replace

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto import bls, verify_hub
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.light import byzantine, fleet
    from tendermint_tpu_torch.light.client import Divergence, TrustOptions
    from tendermint_tpu_torch.light.types import LightBlock, SignedHeader
    from tendermint_tpu_torch.types import evidence as E

    pairs = (BP.MILLER.name, BP.FINAL_EXP.name)
    trace.configure(enabled=True)  # the host split comes from the `bls` spans
    BP.warmup(device=dev)
    out: dict = {"n_vals": LF_VALS, "n_clients": LF_CLIENTS, "n_heights": LF_HEIGHTS,
                 "max_sessions": LF_SESSIONS, "device": dev.type, "schemes": {}}
    built = {}
    for scheme, agg, cold_path, main_path in (
            ("per_sig", False, LF_PERSIG + " cold", LF_PERSIG),
            ("bls_aggregate", True, LF_COLD, LF_MAIN)):
        b = built[scheme] = build_light_fleet_chain(scheme)
        print(f"light_fleet: built the {LF_VALS}-validator {scheme} chain of {LF_HEIGHTS} "
              f"headers in {b['build_s']:.1f} s")
        t0 = time.perf_counter()
        rec, b["proof"] = _light_fleet_scheme(dev, b["chain"], agg, (audit, pairing), cold_path,
                                              main_path)
        rec["chain_build_s"] = b["build_s"]
        rec["phase_s"] = time.perf_counter() - t0
        out["schemes"][scheme] = rec
    per, agg = out["schemes"]["per_sig"], out["schemes"]["bls_aggregate"]
    if per["hops_verified"] != agg["hops_verified"] or agg["proof_scheme"] != fleet.SCHEME_AGGREGATE:
        raise AssertionError(f"light fleet: hops verified {per['hops_verified']} / "
                             f"{agg['hops_verified']}, proof {agg['proof_scheme']}")
    _require_all_launched(LF_MAIN, agg["launches"], names=pairs)
    _require_all_launched(LF_COLD, agg["cold_launches"], names=pairs)
    out["wire_ratio"] = per["hop_proof_wire_bytes"] / agg["hop_proof_wire_bytes"]
    out["sig_bytes_ratio"] = per["sig_bytes_per_hop"] / agg["sig_bytes_per_hop"]

    # the served aggregate proof, carried by its bytes, re-verified by a
    # client node on the card: memos cleared, a fresh hub (its verdict
    # cache answers the hop's second check of the same aggregate), one
    # launch of each kernel
    chain = built["bls_aggregate"]["chain"]
    proof = fleet.HopProof.decode(built["bls_aggregate"]["proof"].encode())
    now = chain[-1].header.time_ns + 10**9

    def reverify(p):
        verify_hub.acquire_hub(device=dev)
        try:
            return fleet.verify_hop_proof(LF_CHAIN_ID, chain[0], p, 10**18, now,
                                          device=dev).height
        finally:
            verify_hub.release_hub()

    bls._VERIFY_MEMO.clear()  # _bls_pass clears the hash-to-curve memo
    _launch_counts(reset=True)
    with _recording((audit, pairing), LF_REVERIFY):
        rv = _bls_pass(dev, lambda: reverify(proof))
    rv["launches"] = _launch_counts()
    if rv["calls"] != LF_HEIGHTS or any(rv["launches"][k] != 1 for k in pairs):
        raise AssertionError(f"verify_hop_proof: height {rv['calls']}, launches {rv['launches']}")
    commit = proof.block.signed_header.commit
    sig = commit.agg_sig
    flipped = replace(commit, agg_sig=bytes([sig[0] ^ 1]) + sig[1:])
    bad = fleet.HopProof(LightBlock(SignedHeader(proof.block.header, flipped),
                                    proof.block.validators), proof.scheme)
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    try:
        reverify(bad)
    except fleet.HopProofError as e:
        err = e
    else:
        raise AssertionError("a flipped aggregate bit verified")
    if err.scheme != fleet.SCHEME_AGGREGATE or not str(err).startswith("[bls-aggregate]"):
        raise AssertionError(f"flipped aggregate bit: {err!r}")
    out["verify_hop_proof"] = {
        "entry": "light.fleet.verify_hop_proof in a fresh hub, memos cleared",
        "height": rv.pop("calls"), **rv,
        "tampered": {"raised": str(err), "scheme": err.scheme,
                     "wall_s": time.perf_counter() - t0, "launches": _launch_counts()},
    }

    # a lunatic primary and an honest witness: Divergence, one count, the
    # evidence reported to the witness decodes back equal
    b = built["per_sig"]
    cfg = byzantine.LunaticConfig((LF_HEIGHTS,), seed=LF_LUNATIC_SEED, n_traitors=LF_TRAITORS)
    lunatic = byzantine.LunaticProvider(tt.make_list_provider(b["chain"], LF_CHAIN_ID), cfg,
                                        b["vals"], b["keys"])
    witness = _Forging(tt.make_list_provider(b["chain"], LF_CHAIN_ID), {})
    trust = TrustOptions(10**18, 1, b["chain"][0].header.hash())
    d = fleet.LightD(LF_CHAIN_ID, trust, lunatic, [witness], device=dev)

    async def attack():
        await d.start()
        try:
            await d.sync(LF_HEIGHTS, now_ns=b["chain"][-1].header.time_ns + 10**9)
        except Divergence as e:
            return e.challenging.height
        finally:
            await d.stop()
        raise AssertionError("a lunatic primary raised no Divergence")

    _launch_counts(reset=True)
    t0 = time.perf_counter()
    with _batch_routes() as lroutes, _recording((audit, pairing), LF_LUNATIC):
        diverged_at = asyncio.run(attack())
    lwall = time.perf_counter() - t0
    if d.stats["divergences"] != 1 or len(witness.reported) != 1 or diverged_at != LF_HEIGHTS \
            or lunatic.served_forged != [LF_HEIGHTS]:
        raise AssertionError(f"lunatic: divergences {d.stats['divergences']}, reports "
                             f"{len(witness.reported)}, forged {lunatic.served_forged}")
    (ev,) = witness.reported
    if not isinstance(ev, E.LightClientAttackEvidence):
        raise AssertionError(f"reported {type(ev).__name__}")
    back = E.decode_evidence(ev.encode())
    if back.encode() != ev.encode() or back.hash() != ev.hash():
        raise AssertionError("the lunatic attack evidence does not decode back equal")
    out["lunatic"] = {
        "attack_height": LF_HEIGHTS, "traitors": LF_TRAITORS, "diverged_at": diverged_at,
        "divergences": d.stats["divergences"], "evidence_bytes": len(ev.encode()),
        "common_height": ev.common_height, "byzantine_validators": len(ev.byzantine_validators),
        "routes": lroutes, "wall_s": lwall, "launches": _launch_counts(),
    }
    out["pairing_shapes"] = {path: [[k, list(s)] for k, s in pairing.shapes(path)]
                             for path in (LF_COLD, LF_MAIN, LF_REVERIFY)}
    return out


SSF_WAVE = "statesync_fleet[join wave]"
SSF_PERSIG = "statesync_fleet[per-sig backfill, 32 heights]"
SSF_DEEP = "statesync_fleet[per-sig backfill, 48 heights]"
SSF_BLS = "statesync_fleet[bls backfill]"


def drive_statesync_fleet(dev, audit: ShapeAudit, pairing: "PairingAudit") -> dict:
    """Phase 18: bench.py's bench_statesync_fleet(64, 21, 8) on the port —
    the join wave (8 joiners on one donor, under asyncio.wait_for and a
    LoopWatchdog), then the backfill A/B over 64 validators through
    verify_backfill_batch on the card with the memos cleared: the bench's
    32-height per-signature window, a 48-height one that reaches the
    cutoff (B1-B3), and SSF_BLS_HEIGHTS aggregate heights (K7a/K7b)."""
    import asyncio

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto import batch, bls, bls_math
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.light.types import LightBlock, SignedHeader
    from tendermint_tpu_torch.statesync.fleet import verify_backfill_batch
    from tendermint_tpu_torch.types.block import aggregate_commit

    pairs = (BP.MILLER.name, BP.FINAL_EXP.name)
    out: dict = {"n_blocks": SSF_BLOCKS, "n_vals": SSF_VALS, "n_joiners": SSF_JOINERS,
                 "device": dev.type}

    # -- the join wave ----------------------------------------------------
    t0 = time.perf_counter()
    source = asyncio.run(tt.build_statesync_source(SSF_BLOCKS, SSF_VALS, device="cpu"))
    build_s = time.perf_counter() - t0
    print(f"statesync_fleet: built the {SSF_BLOCKS}-block donor chain of {SSF_VALS} validators "
          f"in {build_s:.1f} s")
    wd = _watchdog()
    report: dict = {}

    async def wave() -> dict:
        wd.start()
        try:
            return await asyncio.wait_for(tt.statesync_fleet_scenario(
                SSF_BLOCKS, SSF_VALS, SSF_JOINERS, device=dev, source=source, report=report),
                SSF_TIMEOUT_S)
        finally:
            wd.stop()

    _launch_counts(reset=True)
    t0 = time.perf_counter()
    with _batch_routes() as routes:
        res = asyncio.run(wave())
    wall = time.perf_counter() - t0
    states = {s.encode() for s in report["states"].values()}
    if res["joined"] != SSF_JOINERS or res["join_errors"] or len(states) != 1:
        raise AssertionError(f"join wave: joined {res['joined']}, errors {res['join_errors']}, "
                             f"{len(states)} distinct States")
    st = res["server_stats"]
    elapsed = max(res["elapsed_s"], 1e-9)
    bf = res["joiner_backfill"]
    out["join_wave"] = {
        "entry": "testing.statesync_fleet_scenario (bench.py bench_statesync_fleet)",
        "joined": res["joined"],
        "restored_height": next(iter(report["states"].values())).last_block_height,
        "joiners_per_s": res["joined"] / elapsed,
        "chunks_per_s": st["chunks_served"] / elapsed,
        "p50_time_to_synced_s": _pct(res["time_to_synced_s"], 0.50),
        "p99_time_to_synced_s": _pct(res["time_to_synced_s"], 0.99),
        "sheds": st["sheds"],
        "cache_hit_rate": st["cache_hits"] / max(st["cache_hits"] + st["cache_misses"], 1),
        "donor_store_reads": st["store_reads"],
        "donor_store_reads_per_joiner": st["store_reads"] / max(res["joined"], 1),
        "chunk_amortization_factor": st["chunks_served"] / max(st["store_reads"], 1),
        "headers_held": res["headers_held"],
        "backfill_sigs": bf["backfill_sigs"],
        "backfill_sigs_per_s": bf["backfill_sigs"] / elapsed,
        "backfill_batches": bf["backfill_batches"],
        "backfill_routes": routes,
        "min_tpu_batch": batch.MIN_TPU_BATCH,
        "elapsed_s": res["elapsed_s"],
        "wall_s": wall,
        "build_s": build_s,
        "launches": _launch_counts(),
        "watchdog_reports": len(wd.reports),
    }

    # -- the backfill A/B ---------------------------------------------------
    ab = {"n_vals": SSF_AB_VALS}

    def backfill(window, path):
        """One cold verify_backfill_batch of `window` (memos cleared), its
        routes, launches and shapes; the BLS window traced and profiled."""
        bls_math._H2_MEMO.clear()
        bls._VERIFY_MEMO.clear()

        def run():
            return asyncio.run(asyncio.wait_for(
                verify_backfill_batch(SSF_CHAIN_ID, window, device=dev), SSF_TIMEOUT_S))

        _launch_counts(reset=True)
        with _batch_routes() as rts, _recording((audit, pairing), path):
            t0 = time.perf_counter()
            if window[0].signed_header.commit.is_aggregate():
                rec = _bls_pass(dev, run)
                n_sigs = rec.pop("calls")
            else:
                rec, n_sigs = {}, run()
            dt = time.perf_counter() - t0
        wall = rec.pop("wall_s", dt)  # the profiled pass's wall, without its post-processing
        return {**rec, "heights": len(window), "verify_sigs": n_sigs, "wall_s": wall,
                "heights_per_s": len(window) / wall,
                "sigs_covered_per_s": len(window) * SSF_AB_VALS / wall,
                "commit_wire_bytes": len(window[0].signed_header.commit.encode()),
                "routes": rts, "launches": _launch_counts()}

    t0 = time.perf_counter()
    vals, keys = tt.make_validator_set(SSF_AB_VALS, seed=b"ssab-per_sig")
    deep = tt.make_light_chain(SSF_DEEP_HEIGHTS, vals, keys, SSF_CHAIN_ID)
    ps_build = time.perf_counter() - t0
    per = backfill(deep[:SSF_AB_HEIGHTS], SSF_PERSIG)
    tally = sum(n for n, _r in per["routes"])
    want = "cuda" if tally >= batch.MIN_TPU_BATCH else "cpu"
    if [r for _n, r in per["routes"]] != [want]:
        raise AssertionError(f"{SSF_PERSIG}: routes {per['routes']}, cutoff {batch.MIN_TPU_BATCH}")
    per.update(build_s=ps_build, tallied_sigs=tally)
    ab["per_sig"] = per
    dp = backfill(deep, SSF_DEEP)
    if [r for _n, r in dp["routes"]] != ["cuda"]:
        raise AssertionError(f"{SSF_DEEP}: routes {dp['routes']}, cutoff {batch.MIN_TPU_BATCH}")
    _require_all_launched(SSF_DEEP, dp["launches"])
    dp["tallied_sigs"] = sum(n for n, _r in dp["routes"])
    ab["per_sig_deep"] = dp

    t0 = time.perf_counter()
    bvals, bkeys = tt.make_validator_set(SSF_AB_VALS, key_types=("bls12381",),
                                         seed=b"ssab-bls_aggregate")
    window = [LightBlock(SignedHeader(lb.signed_header.header,
                                      aggregate_commit(lb.signed_header.commit, bvals)), bvals)
              for lb in tt.make_light_chain(SSF_BLS_HEIGHTS, bvals, bkeys, SSF_CHAIN_ID)]
    bls_build = time.perf_counter() - t0
    print(f"statesync_fleet: built {SSF_BLS_HEIGHTS} aggregate heights of {SSF_AB_VALS} "
          f"bls12381 validators in {bls_build:.1f} s")
    trace.configure(enabled=True)  # the host split comes from the `bls` spans
    agg = backfill(window, SSF_BLS)
    want_shape = (BP.bucket_items(1), BP.bucket_pairs(SSF_AB_VALS + 1))
    if any(agg["launches"][k] != SSF_BLS_HEIGHTS for k in pairs) \
            or pairing.shapes(SSF_BLS) != [(k, want_shape) for k in sorted(pairs)]:
        raise AssertionError(f"{SSF_BLS}: launches {agg['launches']}, shapes "
                             f"{pairing.shapes(SSF_BLS)}")
    agg.update(build_s=bls_build, bucket=list(want_shape), heights_cut_from=SSF_AB_HEIGHTS,
               cut="heights cut from 32 (64 validators kept): pure-Python BLS signing and "
                   "host hash-to-curve and line preparation set this half's wall")
    ab["bls_aggregate"] = agg
    ab["wire_ratio"] = per["commit_wire_bytes"] / agg["commit_wire_bytes"]
    out["backfill_ab"] = ab
    return out


# phase 19: the sharded verifier (B6) over a mesh of 4 and of 3 shards —
# real cards when the machine has that many, else logical shards of one
SH_SHARDS = (4, 3)
SH_HUB = "sharded[hub, max_batch 512, 4 shards]"
SH_UNSHARDED = "sharded[kernel_eq, unsharded]"


def _sh_path(kind: str, n_dev: int) -> str:
    return f"sharded[{kind}, {n_dev} shards]"


def _sharded_by_path(sharded: dict) -> dict:
    """Phase 19's launches by path: the unsharded call, each mesh's
    sharded kernel_eq and tampered range, and the hub."""
    return {
        SH_UNSHARDED: sharded["unsharded"]["launches"],
        **{_sh_path("kernel_eq", int(n)): rec["launches"] for n, rec in sharded["meshes"].items()},
        **{_sh_path("tampered", int(n)): rec["tampered"]["launches"]
           for n, rec in sharded["meshes"].items()},
        SH_HUB: sharded["hub"]["launches"],
    }


def _mesh_of(n_dev: int) -> tuple[list, str]:
    """The first n_dev cards when the machine has that many, else n_dev
    logical shards of cuda:0; and which of the two it is."""
    import torch

    if torch.cuda.device_count() >= n_dev:
        return [torch.device("cuda", i) for i in range(n_dev)], "real"
    return [torch.device("cuda", 0)] * n_dev, "logical"


def _same_point(a, b) -> bool:
    """Projective equality of two extended points (X1·Z2 = X2·Z1,
    Y1·Z2 = Y2·Z1), on the host's integers."""
    from tendermint_tpu_torch.crypto.cuda import field as F

    (x1, y1, z1), (x2, y2, z2) = ([F.limbs_to_int(c) for c in list(p)[:3]] for p in (a, b))
    return z1 % F.P_INT != 0 and (x1 * z2 - x2 * z1) % F.P_INT == 0 \
        and (y1 * z2 - y2 * z1) % F.P_INT == 0


def _path_bound_ms(audit: "ShapeAudit", path: str, dev) -> float:
    """The least time of every launch `path` made, summed: each launch's
    bound (bytes or operations, `_bound`) at its shape, times its calls."""
    total = 0.0
    for (name, _shapes), rec in audit.seen.items():
        calls = rec["calls"].get(path, 0)
        if calls:
            *_k, n_bytes, n_ops = _kernel_case(name, rec["inputs"], None, dev)
            total += calls * _bound(n_bytes, n_ops)[0]
    return total


def _profiled(dev, fn) -> dict:
    """One call of `fn` on the card: its wall, then, in a second call under
    torch.profiler, the card's busy time and idle share and each ported
    kernel's summed device ms."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = _device_events(fn)
    busy = sum(ns for _, ns in events) / 1e9
    return {
        "wall_s": wall,
        "device_busy_s": busy if events else None,
        "device_idle_share": (1 - busy / wall) if events else None,
        "device_ms": {k: sum(ns for name, ns in events if f"{k}_kernel" in name) / 1e6
                      for k in EDWARDS_KERNELS},
    }


def drive_sharded(dev, entries, audit: ShapeAudit) -> dict:
    """Phase 19: the sharded verifier (B6) on the card, at 4 and 3 shards:
    the sharded kernel_eq against the unsharded one on one set of
    operands, the tampered range through verify_commit_range on the mesh,
    and the hub at its default max_batch over the 4-shard mesh."""
    import torch

    from tendermint_tpu_torch.crypto import verify_hub
    from tendermint_tpu_torch.crypto.cuda import mesh, msm
    from tendermint_tpu_torch.crypto.cuda import verify as V
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.types.validation import verify_commit_range

    items = range_items(entries)
    resolved = [V.resolve_ed25519(*it) for it in items]
    rnd = random.Random(SEED + 19).randbytes(16 * len(items))

    def operands(bucket):
        return V._to_device(V.prepare_batch_eq(resolved, pad_to=bucket, rand_bytes=lambda n: rnd[:n]),
                            dev)

    # the unsharded call on the 8,192 bucket: its result, its R-side MSM
    # (the MSM whose digits have 16 windows), launches, wall, device time
    ops = operands(V._bucket(len(items)))
    r_sides, real_msm = [], msm.msm

    def msm_kept(points, digits):
        out = real_msm(points, digits)
        if digits.shape[0] == 16:
            r_sides.append(out)
        return out

    msm.msm = msm_kept
    try:
        _launch_counts(reset=True)
        with audit.recording(SH_UNSHARDED):
            want = V.kernel_eq(*ops)
        _sync(dev)
    finally:
        msm.msm = real_msm
    if not bool(want[1]):
        raise AssertionError("unsharded kernel_eq rejected the valid range")
    unsharded = {"bucket": ops[1].shape[0], "launches": _launch_counts(),
                 "bound_ms": _path_bound_ms(audit, SH_UNSHARDED, dev),
                 **_profiled(dev, lambda: V.kernel_eq(*ops))}
    (r_side,) = r_sides

    out = {"sigs": len(items), "unsharded": unsharded, "meshes": {}}
    for n_dev in SH_SHARDS:
        devices, kind = _mesh_of(n_dev)
        print(f"sharded: a mesh of {n_dev} {kind} shards ({torch.cuda.device_count()} card(s))")
        bucket = V._bucket(len(items), n_dev)
        sh_ops = ops if bucket == ops[1].shape[0] else operands(bucket)
        kernel = V.make_sharded_kernel_eq(devices)
        totals, real_reduce = [], V._reduce_partials
        V._reduce_partials = lambda p: totals.append(real_reduce(p)) or totals[-1]
        try:
            _launch_counts(reset=True)
            t0 = time.perf_counter()
            with audit.recording(_sh_path("kernel_eq", n_dev)):
                got = kernel(*sh_ops)
            _sync(dev)
            first_s = time.perf_counter() - t0
            launches = _launch_counts()
        finally:
            V._reduce_partials = real_reduce
        n = want[0].shape[0]
        if not (torch.equal(got[0][:n], want[0]) and not got[0][n:].any()
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"{n_dev} shards: the bitmap or eq_ok differs from the unsharded call")
        if not _same_point(totals[0], r_side):
            raise AssertionError(f"{n_dev} shards: the folded total is not the unsharded R-side MSM")
        _require_all_launched(_sh_path("kernel_eq", n_dev), launches)
        if launches["fe_pow22523"] != n_dev + 1 or launches["scan_blocks"] != n_dev + 1:
            raise AssertionError(f"{n_dev} shards: B2/B3 launched {launches}, not {n_dev + 1} each")
        rec = {"mesh": kind, "devices": [str(d) for d in devices], "bucket": bucket,
               "shard_rows": bucket // n_dev, "first_wall_s": first_s, "launches": launches,
               "bound_ms": _path_bound_ms(audit, _sh_path("kernel_eq", n_dev), dev),
               **_profiled(dev, lambda: kernel(*sh_ops))}

        # the tampered range of phase 4 through the funnel, every chunk
        # forced onto the mesh: the sharded kernel_sig attributes it
        bad = tamper(entries, TAMPER_COMMIT, TAMPER_VAL)
        bad_items = range_items(bad)
        bad_pos = TAMPER_COMMIT * (len(bad_items) // len(bad)) + TAMPER_VAL
        dispatches, sig_calls = [], []
        real_dispatch, real_sig = V._dispatch_and_collect, V.kernel_sig

        def dispatch_kept(n_sigs, *a, **kw):
            calls_before = len(sig_calls)
            bitmap = real_dispatch(n_sigs, *a, **kw)
            dispatches.append((n_sigs, bitmap, V.last_dispatch_info(), len(sig_calls) - calls_before))
            return bitmap

        V._dispatch_and_collect = dispatch_kept
        V.kernel_sig = lambda *o: sig_calls.append(1) or real_sig(*o)
        os.environ["TMTPU_FORCE_SHARDED"] = "1"
        mesh._devices = devices
        try:
            _launch_counts(reset=True)
            t0 = time.perf_counter()
            with audit.recording(_sh_path("tampered", n_dev)):
                _expect_failure(lambda: verify_commit_range(CHAIN_ID, bad, device=dev),
                                TAMPER_COMMIT, TAMPER_VAL)
            tampered_s = time.perf_counter() - t0
        finally:
            V._dispatch_and_collect, V.kernel_sig = real_dispatch, real_sig
            del os.environ["TMTPU_FORCE_SHARDED"]
            mesh.reset()
        n_sigs, bitmap, info, shard_sigs = dispatches[0]
        if n_sigs != len(bad_items) or bitmap[bad_pos] or int(bitmap.sum()) != n_sigs - 1:
            raise AssertionError(f"{n_dev} shards: the sharded kernel_sig did not single out "
                                 f"signature {bad_pos} of {n_sigs}")
        if shard_sigs != n_dev or info is None or len(info["shards"]) != n_dev \
                or sum(info["shards"]) != len(bad_items):
            raise AssertionError(f"{n_dev} shards: dispatch {info}, {shard_sigs} kernel_sig calls")
        rec["tampered"] = {"wall_s": tampered_s, "launches": _launch_counts(),
                           "failed_index": TAMPER_COMMIT, "bad_position": bad_pos,
                           "kernel_sig_calls": shard_sigs, "dispatch": info,
                           "dispatches_after_the_range": len(dispatches) - 1}
        out["meshes"][str(n_dev)] = rec

    # the hub at its default max_batch over the 4-shard mesh
    devices, kind = _mesh_of(4)
    mesh._devices = devices
    trace.configure(enabled=True)
    trace.RECORDER.clear()
    hub = verify_hub.acquire_hub(device=dev)
    try:
        _launch_counts(reset=True)
        t0 = time.perf_counter()
        with audit.recording(SH_HUB):
            verify_commit_range(CHAIN_ID, entries, device=dev)
        _sync(dev)
        hub_s = time.perf_counter() - t0
        stats = hub.stats()
    finally:
        verify_hub.release_hub()
        mesh.reset()
    if stats["mesh_devices"] != 4 or stats["effective_max_batch"] != 4 * hub.max_batch \
            or hub.max_batch != 512:
        raise AssertionError(f"hub over 4 shards: mesh {stats['mesh_devices']}, capacity "
                             f"{stats['effective_max_batch']}, max_batch {hub.max_batch}")
    spans = [s["attrs"] for s in trace.RECORDER.dump(subsystem="hub") if s["name"] == "dispatch"]
    out["hub"] = {
        "max_batch": hub.max_batch, "mesh_devices": stats["mesh_devices"],
        "effective_max_batch": stats["effective_max_batch"], "wall_s": hub_s,
        "launches": _launch_counts(),
        "dispatches": [{"sigs": a["sigs"], "route": a["route"], "sharded": "shards" in a,
                        "shards": a.get("shards")} for a in spans],
    }
    return out


def _sharded_rows(dev, audit: ShapeAudit, rows: list[dict], by_path: dict) -> None:
    """A timed `kernels` row for each B2 and B3 size and the largest B1
    size that a sharded kernel_eq gave, where no row has that size yet
    (the shard and the epilogue sizes; the audit holds every shape of
    phase 19's paths, the tampered ranges' and the hub's too)."""
    paths = [_sh_path("kernel_eq", n) for n in SH_SHARDS]
    timed = {(r["name"], r.get("m")) for r in rows if r["name"] in EDWARDS_KERNELS}
    largest: dict = {}
    for (name, _shapes), rec in sorted(audit.seen.items()):
        for path in paths:
            if path not in rec["calls"]:
                continue
            kernel, m, *_ = _kernel_case(name, rec["inputs"], None, dev)
            if name == "fe_mul":
                if m > largest.get(path, (0, None))[0]:
                    largest[path] = (m, rec["inputs"])
            elif (name, m) not in timed:
                _add_sharded_row(dev, name, rec["inputs"], path, rows, by_path)
                timed.add((name, m))
    for path, (m, inputs) in sorted(largest.items()):
        if ("fe_mul", m) not in timed:
            _add_sharded_row(dev, "fe_mul", inputs, path, rows, by_path)
            timed.add(("fe_mul", m))


def _add_sharded_row(dev, name, inputs, path, rows, by_path) -> None:
    """A timed row on worst-case inputs of the shapes `path` gave `name`;
    its launches are the path's own run's."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(SEED + 19)
    kernel, m, run, plain, n_bytes, n_ops = _kernel_case(name, inputs, gen, dev)
    row = _kernel_row(kernel, m, run, plain, n_bytes, n_ops, reps=_AUDIT_REPS[name])
    row["shape_of"] = path
    row["launches"] = by_path[path][name]
    row["main_path_device_ms"] = None
    rows.append(row)


# -- phases 20-22: the verifyd sidecar, the tx front door, the evidence pool --

# phase 20: bench.py's bench_verifyd(4, 1000) (:2313-2530): 4 worker
# processes of 1,000 single ed25519 signatures each, client hubs at their
# defaults (max_batch 512, window 2 ms), through one daemon at the CLI's
# defaults, then each on its own hub on the card; then phase 3's 54
# commits split into VD_WORKERS contiguous ranges through a daemon at
# max_batch 8,192 whose window lets the ranges meet
VD_WORKERS = 4
VD_SIGS = 1000
VD_PACK_MAX_BATCH = 8192
VD_PACK_WINDOW_MS = 1000.0
VD_BREAKER_RESET_S = 1.0
VD_AGG_VALS = 21
VD_WORKER_TIMEOUT_S = 300.0
VD_PACKED = "verifyd[4 commit ranges packed]"
VD_TAMPERED = "verifyd[4 commit ranges packed, tampered]"
VD_AGG = "verifyd[bls aggregate, 21 validators]"
# phase 21: bench.py's bench_tx_flood(10_000, 2) (:1574-1709), then the
# same txs plus TX_TAMPERED flipped signatures fed wide enough to reach
# the card
TX_CLIENTS, TX_PER_CLIENT = 10_000, 2
TX_TAMPERED = 20
TX_CARD_WINDOW_MS = 500.0
TX_CARD = "tx_ingress[hub max_batch 8,192]"
# phase 22: a 150-validator kvstore chain of EV_BLOCKS blocks; a duplicate
# vote at EV_DUP_HEIGHT and a lunatic attack at EV_ATTACK_HEIGHT against
# EV_COMMON_HEIGHT by 51 colluders (> 1/3 of the power)
EV_BLOCKS = 8
EV_DUP_HEIGHT, EV_COMMON_HEIGHT, EV_ATTACK_HEIGHT = 3, 2, 6
EV_TRAITORS = 51
EV_CHAIN_ID = "ev-chain"


class _DaemonThread:
    """A VerifyDaemon on its own event loop and thread in this process, so
    its kernel launches and input shapes are this process's. `stop()` is
    abrupt for a client: in-flight requests are cancelled and connections
    closed without a reply, as a killed daemon process would."""

    def __init__(self, sock: str, **kw):
        import threading

        self.sock = sock
        self.kw = kw
        self.daemon = None
        self._loop = None
        self._stop_ev = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, name="verifyd-smoke", daemon=True)
        self._error = None

    def start(self) -> "_DaemonThread":
        self._thread.start()
        if not self._started.wait(120) or self._error is not None:
            raise AssertionError(f"verifyd did not start: {self._error!r}")
        return self

    def _run(self) -> None:
        import asyncio

        from tendermint_tpu_torch.crypto.verifyd import VerifyDaemon

        async def main():
            self._loop = asyncio.get_running_loop()
            self._stop_ev = asyncio.Event()
            self.daemon = VerifyDaemon(self.sock, **self.kw)
            await self.daemon.start()
            self._started.set()
            await self._stop_ev.wait()
            await self.daemon.stop()

        try:
            asyncio.run(main())
        except BaseException as e:  # reported by start()/stop()
            self._error = e
            self._started.set()

    def stop(self) -> None:
        self._loop.call_soon_threadsafe(self._stop_ev.set)
        self._thread.join(30)
        if self._thread.is_alive() or self._error is not None:
            raise AssertionError(f"verifyd did not stop: {self._error!r}")


class _Workers:
    """Worker processes (`_verifyd_worker`), one per spec, driven by lines:
    each prints READY when set up, runs a step on GO and prints RESULT
    with its JSON record."""

    def __init__(self, specs: list[dict], env_extra: dict | None = None):
        import queue
        import threading

        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo, **(env_extra or {}))
        env.pop("TMTPU_VERIFYD_SOCK", None)
        self.procs, self.lines, self.errs = [], [], []
        for spec in specs:
            p = subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; chip_smoke._verifyd_worker(sys.argv[1])",
                 json.dumps(spec)],
                cwd=repo, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, bufsize=1,
            )
            q: queue.Queue = queue.Queue()
            err: list = []
            threading.Thread(target=lambda f=p.stdout, q=q: [q.put(x) for x in f] + [q.put(None)],
                             daemon=True).start()
            threading.Thread(target=lambda f=p.stderr, e=err: e.extend(f), daemon=True).start()
            self.procs.append(p)
            self.lines.append(q)
            self.errs.append(err)

    def expect(self, tag: str, timeout: float = VD_WORKER_TIMEOUT_S) -> list[str]:
        import queue

        out = []
        deadline = time.monotonic() + timeout
        for i, q in enumerate(self.lines):
            while True:
                try:
                    line = q.get(timeout=max(0.1, deadline - time.monotonic()))
                except queue.Empty:
                    line = None
                if line is None:
                    self.close(kill=True)
                    tail = "".join(self.errs[i])[-3000:]
                    raise AssertionError(f"verifyd worker {i} gave no {tag}:\n{tail}")
                if line.startswith(tag):
                    out.append(line[len(tag):].strip())
                    break
        return out

    def results(self) -> list[dict]:
        return [json.loads(x) for x in self.expect("RESULT")]

    def go(self) -> None:
        for p in self.procs:
            p.stdin.write("GO\n")
            p.stdin.flush()

    def close(self, kill: bool = False) -> None:
        for p in self.procs:
            if kill and p.poll() is None:
                p.kill()
            try:
                p.wait(60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        bad = [i for i, p in enumerate(self.procs) if p.returncode != 0]
        if bad and not kill:
            raise AssertionError(f"verifyd workers {bad} exited "
                                 f"{[self.procs[i].returncode for i in bad]}:\n"
                                 + "".join(self.errs[bad[0]])[-3000:])


def _worker_range(n_workers: int, worker: int) -> tuple[int, int]:
    """Worker `worker`'s contiguous slice [lo, hi) of phase 3's commits."""
    base, extra = divmod(N_COMMITS, n_workers)
    lo = worker * base + min(worker, extra)
    return lo, lo + base + (1 if worker < extra else 0)


def _verifyd_worker(spec_json: str) -> None:
    """One node process of phase 20 (run by `_Workers`): a hub on the card,
    routed through the daemon's socket, that runs `spec["modes"]` in turn
    (each with a fresh client, breaker and CLIENT_STATS): "flood" (bench.py's
    _verifyd_worker through the sidecar), "local" (the same on its own hub,
    after its own attach), "range" (its slice of phase 3's commits, honest
    then tampered) and "death" (a flood across the daemon's death)."""
    import torch

    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import verifyd as vdmod
    from tendermint_tpu_torch.libs import trace

    spec = json.loads(spec_json)
    dev = torch.device(spec["device"])
    batch.MIN_TPU_BATCH = spec["min_tpu_batch"]  # the cutoff phase 9 measured
    trace.configure(enabled=True)
    runs = {"flood": _vd_flood, "local": _vd_flood, "range": _vd_range, "death": _vd_death}
    for mode in spec["modes"]:
        vdmod.reset_clients()
        runs[mode](spec, dev, "" if mode == "local" else spec["sock"])


def _vd_step(wid: int) -> None:
    """Say READY, then wait for the smoke process's GO."""
    print("READY", flush=True)
    line = sys.stdin.readline().strip()
    if line != "GO":
        raise SystemExit(f"worker {wid}: expected GO, got {line!r}")


def _vd_report(rec: dict, wid: int) -> None:
    from tendermint_tpu_torch.crypto import backend_telemetry as bt
    from tendermint_tpu_torch.crypto import verifyd as vdmod
    from tendermint_tpu_torch.libs import trace

    rec.update(worker=wid, remote=dict(vdmod.CLIENT_STATS),
               attach_attempts=bt.BACKEND["attach_attempts"],
               compile_cache_hits=bt.BACKEND["compile_cache_hits"],
               dispatch_routes=_dispatch_routes())
    trace.RECORDER.clear()
    print("RESULT " + json.dumps(rec), flush=True)


def _vd_flood(spec: dict, dev, sock: str) -> None:
    """bench.py's _verifyd_worker: one key, n single signatures."""
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import verify_hub as vh
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey

    wid = spec["worker"]
    if not sock:
        batch.warm_backend(dev)  # the local baseline pays its own attach
    priv = Ed25519PrivKey((wid + 1).to_bytes(4, "big") * 8)
    pub = priv.pub_key()
    tag = b"vd-bench-%d-" % (wid + 1)
    items = [(tag + b"%d" % i, priv.sign(tag + b"%d" % i)) for i in range(spec["sigs"])]
    hub = vh.VerifyHub(device=dev, verifyd_sock=sock, window_ms=2.0, cache_size=0)
    hub.start()
    _vd_step(wid)
    lats: list = []
    try:
        futs = []
        t0 = time.perf_counter()
        for msg, sig in items:
            t_sub = time.perf_counter()
            fut = hub.submit_nowait(pub, msg, sig)
            fut.add_done_callback(lambda f, t=t_sub: lats.append(time.perf_counter() - t))
            futs.append(fut)
        hub.flush()
        wrong = sum(1 for f in futs if f.result(timeout=300) is not True)
        dt = time.perf_counter() - t0
        stats = hub.stats()
    finally:
        hub.stop()
    _vd_report({"sigs": len(items), "wrong": wrong, "dt_s": dt, "sigs_per_s": len(items) / dt,
                "p50_ms": _pct(lats, 0.50) * 1e3, "p99_ms": _pct(lats, 0.99) * 1e3,
                "verify_errors": stats["verify_errors"], "hub_dispatches": stats["dispatches"]}, wid)


def _vd_range(spec: dict, dev, sock: str) -> None:
    """This worker's slice of phase 3's commits through verify_commit_range
    on a hub at max_batch 8,192: honest, then with phase 4's tampered
    signature where the slice holds it."""
    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto import verify_hub as vh
    from tendermint_tpu_torch.crypto import verifyd as vdmod
    from tendermint_tpu_torch.types.validation import InvalidCommitError, verify_commit_range

    wid = spec["worker"]
    lo, hi = spec["commits"]
    tc, tv = spec["tamper"]
    vals, keys = tt.make_validator_set(spec["n_vals"])
    entries = []
    for h in range(lo + 1, hi + 1):  # build_commits' heights, this slice only
        bid = tt.make_block_id(b"smoke-%d" % h)
        entries.append((vals, bid, h, tt.make_commit(CHAIN_ID, h, 0, bid, vals, keys)))
    bad = tamper(entries, tc - lo, tv) if lo <= tc < hi else entries
    vh.acquire_hub(device=dev, max_batch=VD_PACK_MAX_BATCH, cache_size=0, verifyd_sock=sock)
    try:
        for label, ents in (("honest", entries), ("tampered", bad)):
            _vd_step(wid)
            before = dict(vdmod.CLIENT_STATS)
            t0 = time.perf_counter()
            rec = {"step": label, "commits": [lo, hi], "sigs": len(range_items(ents))}
            try:
                verify_commit_range(CHAIN_ID, ents, device=dev)
                rec["outcome"] = "ok"
            except InvalidCommitError as e:
                rec["outcome"] = "invalid"
                rec["failed_commit"] = lo + getattr(e, "failed_index", -1 - lo)
                rec["error"] = str(e)
            rec["wall_s"] = time.perf_counter() - t0
            rec["remote_dispatches"] = (vdmod.CLIENT_STATS["remote_dispatches"]
                                        - before["remote_dispatches"])
            rec["verify_errors"] = vh.running_hub().stats()["verify_errors"]
            _vd_report(rec, wid)
    finally:
        vh.release_hub()


def _vd_death(spec: dict, dev, sock: str) -> None:
    """Flood in batches of 64 (one of them tampered) until the daemon's
    death has forced a fall-back and its restart a re-adoption."""
    from tendermint_tpu_torch.crypto import verify_hub as vh
    from tendermint_tpu_torch.crypto import verifyd as vdmod
    from tendermint_tpu_torch.crypto.ed25519 import Ed25519PrivKey

    wid = spec["worker"]
    priv = Ed25519PrivKey((wid + 101).to_bytes(4, "big") * 8)
    pub = priv.pub_key()
    hub = vh.VerifyHub(device=dev, verifyd_sock=sock, window_ms=2.0, cache_size=0)
    hub.start()
    _vd_step(wid)
    wrong = n = rounds = 0
    t_fallback = t_readopt = None
    deadline = time.monotonic() + 60.0
    try:
        while time.monotonic() < deadline and t_readopt is None:
            items = []
            for i in range(64):
                msg = b"vd-death-%d-%d-%d" % (wid, rounds, i)
                items.append((pub, msg, priv.sign(msg) if i else b"\x01" * 64))
            before = dict(vdmod.CLIENT_STATS)
            got = hub.verify_many(items, timeout=120)
            wrong += sum(1 for i, ok in enumerate(got) if ok != (i != 0))
            n += len(items)
            rounds += 1
            now = time.time()
            if t_fallback is None and vdmod.CLIENT_STATS["remote_fallbacks"] > before["remote_fallbacks"]:
                t_fallback = now
            elif (t_fallback is not None
                  and vdmod.CLIENT_STATS["remote_dispatches"] > before["remote_dispatches"]):
                t_readopt = now
        stats = hub.stats()
    finally:
        hub.stop()
    breaker = vdmod.client_for(sock).breaker
    _vd_report({"sigs": n, "rounds": rounds, "wrong": wrong, "t_fallback": t_fallback,
                "t_readopt": t_readopt, "breaker_opens": breaker.opens,
                "breaker_state": breaker.state, "verify_errors": stats["verify_errors"]}, wid)


def _dispatch_log(hub) -> list:
    """Wrap `hub._verify_batch` (this instance only) to log each dispatch's
    signatures, distinct tenants and route; returns the live log."""
    log: list = []
    real = hub._verify_batch

    def verify_batch(batch):
        out = real(batch)
        tenants = set()
        for p in batch:
            tenants.update(p.tenants or ())
        log.append({"sigs": len(batch), "tenants": len(tenants),
                    "route": getattr(hub._route_local, "route", "cpu")})
        return out

    hub._verify_batch = verify_batch
    return log


def _daemon_checks(tel: dict, what: str, dev, ran_kernel_eq: bool = True) -> None:
    """The normal-run invariants of the daemon's telemetry: no error, and,
    once a batch of this process has run kernel_eq, its device as the
    backend's active kind ("cuda" on the card)."""
    if tel["daemon"]["errors"] or tel["hub"]["verify_errors"]:
        raise AssertionError(f"{what}: daemon errors {tel['daemon']} / hub {tel['hub']}")
    if ran_kernel_eq and tel["backend"]["active_kind"] != dev.type:
        raise AssertionError(f"{what}: backend {tel['backend']}")


def _flood_summary(recs: list[dict]) -> dict:
    wall = max(r["dt_s"] for r in recs)
    return {
        "sigs_per_s": sum(r["sigs"] for r in recs) / wall,
        "p50_ms": sorted(r["p50_ms"] for r in recs)[len(recs) // 2],
        "p99_ms": max(r["p99_ms"] for r in recs),
        "attach_attempts": sum(r["attach_attempts"] for r in recs),
        "remote_dispatches": sum(r["remote"]["remote_dispatches"] for r in recs),
        "remote_fallbacks": sum(r["remote"]["remote_fallbacks"] for r in recs),
        "worker_dispatch_routes": sorted({x for r in recs for x in r["dispatch_routes"]}),
    }


def drive_verifyd(dev, audit: "ShapeAudit", pairing: "PairingAudit") -> dict:
    """Phase 20: the verifyd sidecar in this process, serving worker
    processes (see the module docstring). B1-B3's input shapes on the
    packed ranges go to `audit`, K7a/K7b's on the aggregate to
    `pairing`."""
    import signal
    import tempfile

    from tendermint_tpu_torch.crypto import backend_telemetry as bt
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import verify_hub as vh
    from tendermint_tpu_torch.crypto import verifyd as vdmod
    from tendermint_tpu_torch.libs import trace

    trace.configure(enabled=True)
    sock = os.path.join(tempfile.mkdtemp(prefix="vd-smoke-"), "vd.sock")
    cutoff = batch.MIN_TPU_BATCH
    spec = {"sock": sock, "min_tpu_batch": cutoff, "device": str(dev), "n_vals": N_VALS,
            "tamper": [TAMPER_COMMIT, TAMPER_VAL]}
    out: dict = {"sock_dir_tmp": True, "min_tpu_batch": cutoff}

    # one wave of worker processes runs (a) to (c) in turn; between the
    # steps they wait at READY while this process reconfigures its daemon
    ws = _Workers([dict(spec, worker=w, sigs=VD_SIGS, commits=_worker_range(VD_WORKERS, w),
                        modes=["flood", "local", "range", "death"])
                   for w in range(VD_WORKERS)],
                  env_extra={"TMTPU_VERIFYD_BREAKER_RESET": str(VD_BREAKER_RESET_S)})
    d = None
    try:
        # (a) bench_verifyd(4, 1000): through the sidecar, then local
        t0 = time.perf_counter()
        d = _DaemonThread(sock, device=dev).start()
        log = BatchLog()
        ws.expect("READY")
        with log.recording():
            ws.go()
            side = ws.results()
        tel = d.daemon.telemetry()
        d.stop()
        d = None
        ws.expect("READY")
        ws.go()
        local = ws.results()
        for r in side + local:
            if r["wrong"] or r["verify_errors"] or r["remote"]["remote_fallbacks"]:
                raise AssertionError(f"bench_verifyd worker: {r}")
        # its batches are under the cutoff: the host, unless an earlier
        # phase of this process ran kernel_eq
        _daemon_checks(tel, "bench_verifyd", dev, ran_kernel_eq=False)
        a = {"sidecar": _flood_summary(side), "local": _flood_summary(local)}
        a["speedup_vs_local"] = a["sidecar"]["sigs_per_s"] / a["local"]["sigs_per_s"]
        a["attach_count_sidecar"] = tel["backend"]["attach_attempts"] + a["sidecar"]["attach_attempts"]
        a["attach_count_local"] = a["local"]["attach_attempts"]
        a["daemon"] = {"requests": tel["daemon"]["requests"], "sigs": tel["daemon"]["sigs"],
                       "shed": tel["daemon"]["shed"], "batch_occupancy": tel["hub"]["mean_occupancy"],
                       "cross_client_packs": tel["hub"]["cross_tenant_dispatches"],
                       "dispatches": tel["hub"]["dispatches"], "backend": tel["backend"]}
        a["daemon_batches"] = {r: sum(1 for _n, rr in log.batches if rr == r)
                               for r in sorted({rr for _n, rr in log.batches})}
        a["daemon_batch_sigs"] = [n for n, _r in log.batches]
        if (a["sidecar"]["remote_dispatches"] == 0
                or set(a["sidecar"]["worker_dispatch_routes"]) != {"verifyd"}):
            raise AssertionError(f"the sidecar workers did not route through verifyd: {a['sidecar']}")
        # one attach a process that owns the card (none on the host)
        want = (1, VD_WORKERS) if dev.type == "cuda" else (0, 0)
        if (a["attach_count_sidecar"], a["attach_count_local"]) != want:
            raise AssertionError(f"attach counts {a['attach_count_sidecar']} / {a['attach_count_local']}")
        a["phase_s"] = time.perf_counter() - t0
        out["bench_verifyd"] = a

        # (b) phase 3's commits in VD_WORKERS ranges, packed by one daemon
        t0 = time.perf_counter()
        d = _DaemonThread(sock, device=dev, max_batch=VD_PACK_MAX_BATCH,
                          window_ms=VD_PACK_WINDOW_MS, cache_size=0).start()
        dlog = _dispatch_log(d.daemon.hub)
        steps = {}
        for label, path in (("honest", VD_PACKED), ("tampered", VD_TAMPERED)):
            ws.expect("READY")
            del dlog[:]
            log = BatchLog()
            _launch_counts(reset=True)
            with audit.recording(path), log.recording():
                t1 = time.perf_counter()
                ws.go()
                recs = ws.results()
                wall = time.perf_counter() - t1
            _sync(dev)
            steps[label] = {"wall_s": wall, "workers": recs, "dispatches": list(dlog),
                            "batches": log.batches, "chunks_held": log.chunks,
                            "kernel_sig": log.kernel_sig, "launches": _launch_counts()}
        tel = d.daemon.telemetry()
        d.stop()
        d = None
        _daemon_checks(tel, "packed ranges", dev)
        for label, st in steps.items():
            packed = [x for x in st["dispatches"] if x["tenants"] >= 2 and x["route"] == "cuda"]
            if not packed:
                raise AssertionError(f"{label}: no cross-tenant dispatch ran kernel_eq: {st['dispatches']}")
            _require_all_launched(f"verifyd packed ranges ({label})", st["launches"])
            for r in st["workers"]:
                if r["remote_dispatches"] < 1 or r["remote"]["remote_fallbacks"] or r["verify_errors"]:
                    raise AssertionError(f"{label}: worker {r}")
                lo, hi = r["commits"]
                if label == "tampered" and lo <= TAMPER_COMMIT < hi:
                    if (r["outcome"] != "invalid" or r["failed_commit"] != TAMPER_COMMIT
                            or f"index {TAMPER_VAL}" not in r["error"]):
                        raise AssertionError(f"tampered worker: {r}")
                elif r["outcome"] != "ok":
                    raise AssertionError(f"{label}: worker {r}")
        out["packed_ranges"] = {
            "daemon_max_batch": VD_PACK_MAX_BATCH, "daemon_window_ms": VD_PACK_WINDOW_MS,
            "ranges": [_worker_range(VD_WORKERS, w) for w in range(VD_WORKERS)],
            "range_sigs": [r["sigs"] for r in steps["honest"]["workers"]],
            **steps, "cross_client_packs": tel["hub"]["cross_tenant_dispatches"],
            "phase_s": time.perf_counter() - t0,
        }

        # (c) the daemon dies mid-flood, then restarts on the same path
        t0 = time.perf_counter()
        d = _DaemonThread(sock, device=dev).start()
        ws.expect("READY")
        ws.go()
        time.sleep(0.5)
        d.stop()
        d = None
        time.sleep(0.3)
        d = _DaemonThread(sock, device=dev).start()
        restarted = time.time()
        recs = ws.results()
        tel = d.daemon.telemetry()
        d.stop()
        d = None
    except BaseException:
        ws.close(kill=True)
        if d is not None:
            d.stop()
        raise
    ws.close()
    for r in recs:
        if (r["wrong"] or r["verify_errors"] or r["remote"]["remote_fallbacks"] < 1
                or r["breaker_opens"] < 1 or r["t_readopt"] is None):
            raise AssertionError(f"daemon death: worker {r}")
        r["readopt_after_restart_s"] = r["t_readopt"] - restarted
        if r["readopt_after_restart_s"] > VD_BREAKER_RESET_S + 1.0:
            raise AssertionError(f"re-adopted {r['readopt_after_restart_s']:.2f} s after the restart")
    out["daemon_death"] = {"breaker_reset_s": VD_BREAKER_RESET_S, "workers": recs,
                           "restarted_daemon": tel["daemon"], "phase_s": time.perf_counter() - t0}

    # (d) one BLS aggregate commit through the sidecar, and a tampered one
    from dataclasses import replace

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto import bls
    from tendermint_tpu_torch.crypto.cuda import bls_pairing
    from tendermint_tpu_torch.types.block import aggregate_commit
    from tendermint_tpu_torch.types.validation import verify_commit

    t0 = time.perf_counter()
    vals, keys = tt.make_validator_set(VD_AGG_VALS, key_types=("bls12381",), seed=b"vd-bls")
    bid = tt.make_block_id(b"vd-agg")
    per_sig = tt.make_commit(CHAIN_ID, 1, 0, bid, vals, keys)
    agg = aggregate_commit(per_sig, vals)
    sigs = [cs.signature for cs in per_sig.signatures]
    sigs[AB_TAMPER_VAL] = keys[vals.validators[AB_TAMPER_VAL].address].sign(b"not the vote")
    bad = replace(agg, agg_sig=bls.aggregate_signatures(sigs))
    d = _DaemonThread(sock, device=dev).start()
    vdmod.reset_clients()
    vh.acquire_hub(device=dev, verifyd_sock=sock)
    try:
        _launch_counts(reset=True)
        t1 = time.perf_counter()
        with pairing.recording(VD_AGG):
            verify_commit(CHAIN_ID, vals, bid, 1, agg, device=dev)
        honest_s = time.perf_counter() - t1
        honest = {"remote": dict(vdmod.CLIENT_STATS), "launches": _launch_counts(reset=True)}
        t1 = time.perf_counter()
        _expect_aggregate_failure(lambda: verify_commit(CHAIN_ID, vals, bid, 1, bad, device=dev))
        tampered_s = time.perf_counter() - t1
        tampered = {"remote": dict(vdmod.CLIENT_STATS), "launches": _launch_counts()}
        tel = d.daemon.telemetry()
    finally:
        vh.release_hub()
        vdmod.reset_clients()
        d.stop()
    for st, n in ((honest, 1), (tampered, 2)):
        if st["remote"]["remote_agg_dispatches"] != n or st["remote"]["remote_fallbacks"]:
            raise AssertionError(f"aggregate through verifyd: {st['remote']}")
    for name in (bls_pairing.MILLER.name, bls_pairing.FINAL_EXP.name):
        if honest["launches"][name] != 1 or tampered["launches"][name] != 1:
            raise AssertionError(f"aggregate launches {honest['launches']} / {tampered['launches']}")
    _daemon_checks(tel, "aggregate", dev)
    out["aggregate"] = {"validators": VD_AGG_VALS, "honest_s": honest_s, "tampered_s": tampered_s,
                        "honest": honest, "tampered": tampered,
                        "daemon_agg_requests": tel["daemon"]["agg_requests"],
                        "phase_s": time.perf_counter() - t0}

    # (e) the CLI: a CLI daemon started as a subprocess (it starts while
    # `--stats` queries the in-process daemon), which answers one
    # remote_stats and exits 0 on SIGTERM
    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "tendermint_tpu_torch.cli", "verifyd"]
    sock2 = os.path.join(os.path.dirname(sock), "cli.sock")
    proc = subprocess.Popen(cli + ["--sock", sock2, "--device", dev.type], cwd=repo,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        d = _DaemonThread(sock, device=dev).start()
        try:
            st = subprocess.run(cli + ["--sock", sock, "--stats"], cwd=repo, capture_output=True,
                                text=True, timeout=120)
        finally:
            d.stop()
        if st.returncode != 0 or json.loads(st.stdout)["protocol_version"] != vdmod.PROTOCOL_VERSION:
            raise AssertionError(f"cli verifyd --stats: rc {st.returncode}: {st.stderr[-2000:]}")
        cli_tel = None
        deadline = time.monotonic() + 120
        while cli_tel is None and proc.poll() is None and time.monotonic() < deadline:
            client = vdmod.VerifydClient(sock2)  # a fresh breaker each poll
            cli_tel = client.remote_stats()
            client.close()
            if cli_tel is None:
                time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if cli_tel is None or rc != 0:
        raise AssertionError(f"cli verifyd daemon: stats {cli_tel}, exit {rc}: "
                             f"{proc.stderr.read()[-2000:]}")
    out["cli"] = {"stats_rc": st.returncode, "daemon_exit_on_sigterm": rc,
                  "cli_daemon_backend": cli_tel["backend"], "phase_s": time.perf_counter() - t0}
    out["this_process_backend"] = dict(bt.BACKEND, active_kind=bt.ACTIVE["kind"])
    return out


# -- phase 21 -----------------------------------------------------------------


def _tx_app():
    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.abci.application import BaseApplication

    class FloodApp(BaseApplication):
        """bench.py's FloodApp: priority from the tx's last byte."""

        def check_tx(self, req):
            return abci.ResponseCheckTx(priority=req.tx[-1] if req.tx else 0, gas_wanted=1)

    return FloodApp()


async def _tx_run(txs: list, *, depth: int, workers: int, park_ms: float,
                  burst: int | None) -> dict:
    """bench.py's _bench_tx_flood_async on the port: open-loop bursts of
    `burst` (None: every tx in one tick), drain, and the fields it
    reports, with the admitted txs in their insertion order."""
    import asyncio

    from tendermint_tpu_torch.abci.client import LocalClient
    from tendermint_tpu_torch.config import MempoolConfig
    from tendermint_tpu_torch.mempool.ingress import TxIngress
    from tendermint_tpu_torch.mempool.pool import PriorityMempool

    n = len(txs)
    cfg = MempoolConfig(size=n + 16, max_txs_bytes=1 << 30, cache_size=2 * n + 16)
    cfg.ingress.nonce_park_timeout_ms = park_ms
    cfg.ingress.verify_workers = workers
    cfg.ingress.depth = depth
    pool = PriorityMempool(cfg, LocalClient(_tx_app()))
    ingress = TxIngress(cfg.ingress, pool)
    await ingress.start()
    lats: list = []

    def on_done(fut, t_sub):
        if fut.exception() is None:
            lats.append(time.perf_counter() - t_sub)

    try:
        t0 = time.perf_counter()
        step = burst or n
        for i in range(0, n, step):
            for tx in txs[i:i + step]:
                t_sub = time.perf_counter()
                ingress.submit_nowait(tx, source="client").add_done_callback(
                    lambda f, t=t_sub: on_done(f, t))
            await asyncio.sleep(0)
        deadline = time.perf_counter() + 300.0
        while (ingress.occupancy > 0 or ingress.parked_count() > 0) and time.perf_counter() < deadline:
            await asyncio.sleep(0.01)
        dt = time.perf_counter() - t0
        if ingress.occupancy or ingress.parked_count():
            raise AssertionError(f"the ingress did not drain: {ingress.occupancy} in flight")
        await asyncio.sleep(0)  # the last futures' done-callbacks run here
        stats = dict(ingress.stats)
        admitted = int(pool.stats["admitted"])
        return {
            "submitted_total": n, "admitted": admitted, "admitted_tx_per_s": admitted / dt,
            "checktx_p50_ms": _pct(lats, 0.50) * 1e3, "checktx_p99_ms": _pct(lats, 0.99) * 1e3,
            "shed": int(stats["shed"]), "shed_rate": stats["shed"] / n,
            "parked": int(stats["parked"]), "park_expired": int(stats["park_expired"]),
            "park_adopted": int(stats["park_adopted"]), "sig_failed": int(stats["sig_failed"]),
            "flood_dt_s": dt,
            "order": [w.tx for w in sorted(pool._txs.values(), key=lambda w: w.seq)],
        }
    finally:
        await ingress.stop()
        pool.close()


def _split_by_route(batches: list) -> dict:
    out: dict = {}
    for n, route in batches:
        rec = out.setdefault(route, {"batches": 0, "sigs": 0})
        rec["batches"] += 1
        rec["sigs"] += n
    return out


def drive_tx_flood(dev, audit: "ShapeAudit") -> dict:
    """Phase 21: the tx front door (see the module docstring)."""
    import asyncio

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import verify_hub as vh

    out: dict = {"min_tpu_batch": batch.MIN_TPU_BATCH}
    t0 = time.perf_counter()
    txs = tt.make_envelope_flood(TX_CLIENTS, TX_PER_CLIENT)
    bad_txs = tt.make_envelope_flood(TX_CLIENTS, TX_PER_CLIENT, tampered={
        (c, 1) for c in range(0, TX_CLIENTS, TX_CLIENTS // TX_TAMPERED)})
    flipped = [b for a, b in zip(txs, bad_txs) if a != b]
    out["sign_s"] = time.perf_counter() - t0
    if len(flipped) != TX_TAMPERED:
        raise AssertionError(f"{len(flipped)} flipped txs")

    # (a) bench_tx_flood(10_000, 2) as bench.py sets it
    log = BatchLog()
    vh.acquire_hub(device=dev, max_batch=512, window_ms=2.0, cache_size=65536)
    try:
        with log.recording():
            a = asyncio.run(_tx_run(txs, depth=2048, workers=64, park_ms=250.0, burst=256))
        hs = vh.running_hub().stats()
    finally:
        vh.release_hub()
    a.pop("order")
    a["hub_occupancy"] = hs["mean_occupancy"]
    a["hub_backfill_sigs"] = hs["lane_backfill_dispatched"]
    a["hub_verify_errors"] = hs["verify_errors"]
    a["routes"] = _split_by_route(log.batches)
    if hs["verify_errors"] or a["sig_failed"]:
        raise AssertionError(f"bench_tx_flood: {a}")
    out["bench_tx_flood"] = a

    # (b) the same txs plus the flipped ones, wide enough for the card,
    # against the host path (no hub)
    wide = txs + flipped
    log = BatchLog()
    vh.acquire_hub(device=dev, max_batch=VD_PACK_MAX_BATCH, window_ms=TX_CARD_WINDOW_MS,
                   cache_size=0)
    try:
        _launch_counts(reset=True)
        with audit.recording(TX_CARD), log.recording():
            card = asyncio.run(_tx_run(wide, depth=len(wide), workers=VD_PACK_MAX_BATCH,
                                       park_ms=250.0, burst=None))
        _sync(dev)
        launches = _launch_counts()
        hs = vh.running_hub().stats()
    finally:
        vh.release_hub()
    host = asyncio.run(_tx_run(wide, depth=len(wide), workers=VD_PACK_MAX_BATCH,
                               park_ms=250.0, burst=None))
    wide_batches = [(n, r) for n, r in log.batches if n >= batch.MIN_TPU_BATCH]
    if not wide_batches or any(r != "cuda" for _n, r in wide_batches):
        raise AssertionError(f"hub dispatches at or above the cutoff: {log.batches}")
    _require_all_launched("tx ingress at max_batch 8,192", launches)
    if card["shed"] or host["shed"] or hs["verify_errors"]:
        raise AssertionError(f"wide flood: shed {card['shed']} / {host['shed']}, {hs}")
    if card["sig_failed"] != TX_TAMPERED or host["sig_failed"] != TX_TAMPERED:
        raise AssertionError(f"sig_failed {card['sig_failed']} / {host['sig_failed']}")
    if card["order"] != host["order"]:
        raise AssertionError("the card run admitted another tx list than the host run")
    n_admitted = len(card.pop("order"))
    host.pop("order")
    out["wide"] = {"txs": len(wide), "hub_max_batch": VD_PACK_MAX_BATCH,
                   "hub_window_ms": TX_CARD_WINDOW_MS, "card": card, "host": host,
                   "admitted_equal_bytes_in_order": n_admitted,
                   "routes": _split_by_route(log.batches), "batches": log.batches,
                   "chunks_held": log.chunks, "launches": launches,
                   "hub_occupancy": hs["mean_occupancy"]}
    out["phase_s"] = time.perf_counter() - t0
    return out


# -- phase 22 -----------------------------------------------------------------


def _sidecar_by_path(vd: dict, tx: dict, ev: dict) -> dict:
    """Phases 20-22's launch counts by path, for the `kernels` rows."""
    out = {
        VD_PACKED: vd["packed_ranges"]["honest"]["launches"],
        VD_TAMPERED: vd["packed_ranges"]["tampered"]["launches"],
        VD_AGG: vd["aggregate"]["honest"]["launches"],
        VD_AGG + " tampered": vd["aggregate"]["tampered"]["launches"],
        TX_CARD: tx["wide"]["launches"],
    }
    for name, check in ev["checks"].items():
        out[f"evidence[{name}]"] = check["launches"]
    return out


def drive_evidence(dev) -> dict:
    """Phase 22: the evidence pool on the card inside a running hub, and
    its reactor between two pools (see the module docstring)."""
    import asyncio
    from dataclasses import replace

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.crypto import verify_hub as vh
    from tendermint_tpu_torch.evidence import EVIDENCE_CHANNEL
    from tendermint_tpu_torch.evidence.pool import EvidencePool
    from tendermint_tpu_torch.evidence.reactor import EvidenceReactor
    from tendermint_tpu_torch.p2p.peermanager import PeerStatus, PeerUpdate
    from tendermint_tpu_torch.p2p.router import Channel
    from tendermint_tpu_torch.p2p.types import Envelope
    from tendermint_tpu_torch.store.db import MemDB
    from tendermint_tpu_torch.types.evidence import decode_evidence

    t0 = time.perf_counter()
    keys = tt.det_priv_keys(N_VALS)
    by_addr = {k.pub_key().address(): k for k in keys}
    bstore, sstore, _conns, _state = asyncio.run(tt.build_kvstore_chain(
        tt.make_genesis(keys, EV_CHAIN_ID), keys, EV_BLOCKS, device=dev))
    out: dict = {"validators": N_VALS, "blocks": EV_BLOCKS, "chain_build_s": time.perf_counter() - t0}
    dup = tt.make_duplicate_vote_evidence(EV_CHAIN_ID, bstore, sstore, keys[1], EV_DUP_HEIGHT)
    lca = asyncio.run(tt.make_lunatic_evidence(
        EV_CHAIN_ID, bstore, sstore, by_addr, common_height=EV_COMMON_HEIGHT,
        attack_height=EV_ATTACK_HEIGHT, n_traitors=EV_TRAITORS, seed=SEED))

    def flip(sig):
        return bytes([sig[0] ^ 1]) + sig[1:]

    sh = lca.conflicting_block.signed_header
    sigs = list(sh.commit.signatures)
    sigs[0] = replace(sigs[0], signature=flip(sigs[0].signature))
    bad_lca = replace(lca, conflicting_block=replace(
        lca.conflicting_block,
        signed_header=replace(sh, commit=replace(sh.commit, signatures=tuple(sigs)))))
    bad_dup = replace(dup, vote_b=replace(dup.vote_b, signature=flip(dup.vote_b.signature)))
    cases = (("duplicate_vote", dup, True), ("duplicate_vote, tampered", bad_dup, False),
             ("light_client_attack", lca, True), ("light_client_attack, tampered", bad_lca, False))

    vh.acquire_hub(device=dev)
    checks = {}
    try:
        for name, ev, valid in cases:
            pool = EvidencePool(MemDB(), sstore, bstore, device=dev)
            log = BatchLog()
            _launch_counts(reset=True)
            t1 = time.perf_counter()
            with log.recording():
                try:
                    pool.add_evidence(ev)
                    verdict, err = True, None
                except Exception as e:  # noqa: BLE001 — the verdict is checked below
                    verdict, err = False, f"{type(e).__name__}: {e}"
            checks[name] = {"verdict": verdict, "error": err, "wall_s": time.perf_counter() - t1,
                            "routes": _split_by_route(log.batches), "launches": _launch_counts()}
            if verdict != valid:
                raise AssertionError(f"evidence {name}: {checks[name]}")
        hs = vh.running_hub().stats()

        # the reactor: pool A offers the valid evidence to pool B
        async def gossip():
            pools = [EvidencePool(MemDB(), sstore, bstore, device=dev) for _ in range(2)]
            pools[0].add_evidence(dup)
            pools[0].add_evidence(lca)
            chans = [Channel(EVIDENCE_CHANNEL, "evidence", 6, lambda e: e.encode(), decode_evidence)
                     for _ in pools]
            ups = [asyncio.Queue(), asyncio.Queue()]
            reactors = [EvidenceReactor(p, c, u) for p, c, u in zip(pools, chans, ups)]
            names = ("node-a", "node-b")

            async def pump(src):
                while True:
                    env = await chans[src].out_q.get()
                    await chans[1 - src].in_q.put(Envelope(
                        EVIDENCE_CHANNEL, env.message.encode(), from_=names[src]))

            for r in reactors:
                await r.start()
            pumps = [asyncio.ensure_future(pump(i)) for i in (0, 1)]
            try:
                await ups[0].put(PeerUpdate(names[1], PeerStatus.UP))
                await ups[1].put(PeerUpdate(names[0], PeerStatus.UP))
                for _ in range(3000):
                    if len(pools[1].pending_evidence(1 << 20)[0]) == 2:
                        break
                    await asyncio.sleep(0.01)
                return sorted(e.hash() for e in pools[1].pending_evidence(1 << 20)[0])
            finally:
                for t in pumps:
                    t.cancel()
                await asyncio.gather(*pumps, return_exceptions=True)
                for r in reactors:
                    await r.stop()

        t1 = time.perf_counter()
        received = asyncio.run(gossip())
        gossip_s = time.perf_counter() - t1
    finally:
        vh.release_hub()
    if received != sorted([dup.hash(), lca.hash()]):
        raise AssertionError("the reactor did not carry both valid evidences")
    if hs["verify_errors"]:
        raise AssertionError(f"evidence hub: {hs}")
    out.update(checks=checks, reactor={"received": 2, "wall_s": gossip_s},
               attributed=len(lca.byzantine_validators), hub_dispatches=hs["dispatches"],
               phase_s=time.perf_counter() - t0)
    return out


# -- phase 23 -----------------------------------------------------------------

# phase 23: bench.py's bench_consensus_ingest (:1396-1571) at the north
# star's 150 validators (the bench's 64 raised), 6 waves and 8 peers: one
# parked observer node (no private validator), every (round, type) tally
# held below 2/3 (98 votes, `testing.ingest_cap`); then the wide burst,
# every vote of the observer's open rounds 0-13 at once, and its tampered
# twin, whose bad vote comes through a ConsensusReactor's vote Channel
CI_VALS, CI_WAVES, CI_SEQ_WAVES, CI_PEERS = 150, 6, 2, 8
CI_INFLIGHT, CI_MAX_BATCH, CI_WINDOW_MS = 256, 256, 2.0
CI_BACKFILL = 128
CI_WIDE_SET_ROUND = 12  # set_round(12) opens rounds 0-13
CI_WIDE_INFLIGHT, CI_WIDE_MAX_BATCH, CI_WIDE_WINDOW_MS = 4096, 8192, 1000.0
CI_TAMPER_PEER = "p3"
CI_TIMEOUT_S = 120.0
CI_MAIN = "consensus_ingest[wide burst, 2,744 votes]"
CI_TAMPERED = "consensus_ingest[wide burst, tampered]"
# phase 24: the frozen-clock recipe of tests/test_bls.py:655-730 on the card
CL_VALS = 3
CL_ED_HEIGHT, CL_BLS_HEIGHT = 4, 3
CL_TIMEOUT_S = 240.0
CL_ED = "consensus_live[ed25519, 3 validators]"
CL_BLS = "consensus_live[bls-aggregate, 3 validators]"


@contextlib.contextmanager
def _hub_dispatches(hub):
    """Every dispatch of `hub` while open: its signatures, route and the
    signatures it found false."""
    log: list[dict] = []
    real = hub._verify_batch

    def verify_batch(batch):
        results = real(batch)
        log.append({"n": len(batch), "route": getattr(hub._route_local, "route", "cpu"),
                    "false": [p.sig for p, ok in zip(batch, results) if not ok]})
        return results

    hub._verify_batch = verify_batch
    try:
        yield log
    finally:
        del hub._verify_batch


async def _observer_run(dev, genesis, waves, *, pipeline: bool, inflight: int,
                        rounds: int = 2, set_round: int | None = None,
                        reactor_vote=None) -> dict:
    """bench.py's run_mode on the port: a parked observer Node on `dev`
    fed each wave by CI_PEERS concurrent peers (and `reactor_vote`, if
    any, through a ConsensusReactor's vote Channel from CI_TAMPER_PEER),
    waiting until every valid vote is tallied, the vote set reset between
    waves. Returns votes/s, the wall from the first submit to the last
    apply, the ingest stats and the reactor's PeerErrors."""
    import asyncio
    import shutil
    import tempfile

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.consensus import harness
    from tendermint_tpu_torch.consensus import messages as m
    from tendermint_tpu_torch.consensus.reactor import VOTE_CHANNEL, ConsensusReactor
    from tendermint_tpu_torch.consensus.types import HeightVoteSet
    from tendermint_tpu_torch.p2p.types import Envelope
    from tendermint_tpu_torch.types.keys import SignedMsgType

    cfg = harness.fast_config()
    cfg.ingest_pipeline = pipeline
    cfg.ingest_max_inflight = inflight
    cfg.timeout_propose_ns = 3_600 * 10**9  # park the observer: tally, never drive rounds
    cfg.timeout_commit_ns = 0
    wal_dir = tempfile.mkdtemp(prefix="ci-wal-")
    node = harness.Node(genesis, None, config=cfg, wal_dir=wal_dir, device=dev)
    await node.start()
    cs = node.cs
    chans, reactor, drains, errors = None, None, [], []
    if reactor_vote is not None:
        chans = tt.consensus_channels()
        reactor = ConsensusReactor(cs, *chans, asyncio.Queue())
        await reactor.start()

        async def drain(ch):  # no peer: drop what the reactor sends
            while True:
                await ch.out_q.get()

        drains = [asyncio.ensure_future(drain(ch)) for ch in chans]
    applied = []
    handle = cs._handle_msg

    def record(mi):
        applied.append(time.perf_counter())
        return handle(mi)

    cs._handle_msg = record
    vals = cs.rs.validators

    def tallied() -> int:
        n = 0
        for r in range(rounds):
            for t in (SignedMsgType.PREVOTE, SignedMsgType.PRECOMMIT):
                vs = cs.rs.votes.prevotes(r) if t == SignedMsgType.PREVOTE else cs.rs.votes.precommits(r)
                n += sum(1 for v in vs.votes if v is not None)
        return n

    async def peer(votes):
        for v in votes:
            await cs.add_vote(v, "bench-peer")

    total, walls = 0, []
    try:
        t0 = time.perf_counter()
        for votes in waves:
            if set_round is not None:
                cs.rs.votes.set_round(set_round)
            t_wave = time.perf_counter()
            tasks = [asyncio.ensure_future(peer(votes[p::CI_PEERS])) for p in range(CI_PEERS)]
            if reactor_vote is not None:
                await chans[2].in_q.put(Envelope(VOTE_CHANNEL, m.VoteMessage(reactor_vote),
                                                 from_=CI_TAMPER_PEER))
            await asyncio.gather(*tasks)
            deadline = time.perf_counter() + CI_TIMEOUT_S
            while tallied() < len(votes):
                if time.perf_counter() > deadline:
                    raise AssertionError(f"tallied {tallied()} of {len(votes)} votes")
                await asyncio.sleep(0.002)
            if reactor_vote is not None:
                deadline = time.perf_counter() + CI_TIMEOUT_S
                while not errors and time.perf_counter() < deadline:
                    try:
                        errors.append(await asyncio.wait_for(chans[2].err_q.get(), 0.05))
                    except asyncio.TimeoutError:
                        pass
                await asyncio.sleep(0.1)  # any second report would be queued by now
                while not chans[2].err_q.empty():
                    errors.append(chans[2].err_q.get_nowait())
            walls.append(max(applied) - t_wave)
            total += len(votes)
            if reactor_vote is not None:
                rv = reactor_vote
                vs = cs.rs.votes.prevotes(rv.round) if rv.type == SignedMsgType.PREVOTE \
                    else cs.rs.votes.precommits(rv.round)
                if vs.get_vote(rv.validator_index) is not None:
                    raise AssertionError("the tampered vote was tallied")
            cs.rs.votes = HeightVoteSet(cs.state.chain_id, cs.rs.height, vals)
        dt = time.perf_counter() - t0
        stats = dict(cs.ingest.stats) if cs.ingest else {}
    finally:
        for d in drains:
            d.cancel()
        await asyncio.gather(*drains, return_exceptions=True)
        if reactor is not None:
            await reactor.stop()
        await node.stop()
        shutil.rmtree(wal_dir, ignore_errors=True)
    return {"votes": total, "votes_per_s": total / dt, "dt_s": dt,
            "first_submit_to_last_apply_s": walls, "ingest": stats,
            "peer_errors": [(e.node_id, e.err) for e in errors]}


def drive_consensus_ingest(dev, audit: "ShapeAudit") -> dict:
    """Phase 23: one node's vote ingest at 150 validators (see the module
    docstring)."""
    import asyncio
    import threading
    from dataclasses import replace

    from tendermint_tpu_torch import testing as tt
    from tendermint_tpu_torch.consensus import harness
    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.crypto import verify_hub as vh
    from tendermint_tpu_torch.state.state import state_from_genesis

    t0 = time.perf_counter()
    genesis, keys = harness.make_genesis(CI_VALS)
    vals = state_from_genesis(genesis).validators
    chain = genesis.chain_id
    cap = tt.ingest_cap(CI_VALS)
    waves = tt.make_vote_waves(chain, vals, keys, 1, CI_WAVES)
    wide_rounds = CI_WIDE_SET_ROUND + 2
    wide = tt.make_vote_waves(chain, vals, keys, 1, 1, rounds=wide_rounds, first_wave=CI_WAVES)[0]
    bad_wide = tt.make_vote_waves(chain, vals, keys, 1, 1, rounds=wide_rounds,
                                  first_wave=CI_WAVES + 1)[0]
    bad_at = len(bad_wide) // 2 + 17
    sig = bad_wide[bad_at].signature
    bad_vote = replace(bad_wide[bad_at], signature=bytes([sig[0] ^ 1]) + sig[1:])
    others = bad_wide[:bad_at] + bad_wide[bad_at + 1:]
    out: dict = {"validators": CI_VALS, "cap": cap, "waves": CI_WAVES, "peers": CI_PEERS,
                 "min_tpu_batch": batch.MIN_TPU_BATCH, "sign_s": time.perf_counter() - t0}
    if len(waves[0]) != 4 * cap or len(wide) != 2 * wide_rounds * cap:
        raise AssertionError(f"wave sizes {len(waves[0])} / {len(wide)}")

    # (a) the bench's own shape: the sequential facade, then the pipeline
    # with the backfill feeder
    hub = vh.acquire_hub(device=dev, max_batch=CI_MAX_BATCH, window_ms=CI_WINDOW_MS,
                         cache_size=8192)
    try:
        with _hub_dispatches(hub) as log:
            seq = asyncio.run(_observer_run(dev, genesis, waves[:CI_SEQ_WAVES], pipeline=False,
                                            inflight=CI_INFLIGHT))
        hs = hub.stats()
    finally:
        vh.release_hub()
    seq.update(occupancy=hs["mean_occupancy"], routes=_split_by_route(
        [(d["n"], d["route"]) for d in log]), hub_verify_errors=hs["verify_errors"])
    hub = vh.acquire_hub(device=dev, max_batch=CI_MAX_BATCH, window_ms=CI_WINDOW_MS,
                         cache_size=8192)
    try:
        bf_pub = keys[0].pub_key()
        bf_items = [(bf_pub, b"ingest-backfill-%d" % i, keys[0].sign(b"ingest-backfill-%d" % i))
                    for i in range(CI_BACKFILL)]
        bf_out: list = []
        feeder = threading.Thread(target=lambda: bf_out.append(
            hub.verify_many(bf_items, lane="backfill")))
        with _hub_dispatches(hub) as log:
            feeder.start()
            pipe = asyncio.run(_observer_run(dev, genesis, waves, pipeline=True,
                                             inflight=CI_INFLIGHT))
            feeder.join()
        hs = hub.stats()
    finally:
        vh.release_hub()
    if bf_out != [[True] * CI_BACKFILL]:
        raise AssertionError("the backfill feeder's verdicts")
    ing = pipe["ingest"]
    n_votes = CI_WAVES * 4 * cap
    if (ing["pre_verified"], ing["unverified"], ing["hub_errors"]) != (n_votes, 0, 0) \
            or hs["verify_errors"] or seq["hub_verify_errors"]:
        raise AssertionError(f"pipelined ingest: {ing}, hub {hs}")
    out["bench"] = {
        "sequential": seq, "pipelined": pipe,
        "sequential_votes_per_s": seq["votes_per_s"],
        "pipelined_votes_per_s": pipe["votes_per_s"],
        "speedup_vs_sequential": pipe["votes_per_s"] / seq["votes_per_s"],
        "mean_batch_occupancy": hs["mean_occupancy"],
        "lane_live_sigs": hs["lane_live_dispatched"],
        "lane_backfill_sigs": hs["lane_backfill_dispatched"],
        "lane_promotions": hs["lane_promotions"],
        "pre_verified": ing["pre_verified"], "dedup_drops": ing["dedup_drops"],
        "unverified": ing["unverified"], "hub_errors": ing["hub_errors"],
        "routes": _split_by_route([(d["n"], d["route"]) for d in log]),
        "dispatch_sizes": [d["n"] for d in log],
    }

    # (b) the wide burst, then (c) its tampered twin
    for name, path, feed, rv in (("wide", CI_MAIN, wide, None),
                                 ("tampered", CI_TAMPERED, others, bad_vote)):
        hub = vh.acquire_hub(device=dev, max_batch=CI_WIDE_MAX_BATCH,
                             window_ms=CI_WIDE_WINDOW_MS, cache_size=0)
        blog = BatchLog()
        try:
            _launch_counts(reset=True)
            with audit.recording(path), blog.recording(), _hub_dispatches(hub) as log:
                run = asyncio.run(_observer_run(
                    dev, genesis, [feed], pipeline=True, inflight=CI_WIDE_INFLIGHT,
                    rounds=wide_rounds, set_round=CI_WIDE_SET_ROUND, reactor_vote=rv))
            _sync(dev)
            launches = _launch_counts()
            hs = hub.stats()
        finally:
            vh.release_hub()
        ing = run["ingest"]
        wide_ds = [d for d in log if d["n"] >= batch.MIN_TPU_BATCH]
        if not wide_ds or any(d["route"] != "cuda" for d in wide_ds):
            raise AssertionError(f"{name}: dispatches {[(d['n'], d['route']) for d in log]}")
        _require_all_launched(path, launches)
        n_sub = len(feed) + (rv is not None)
        false = [s for d in log for s in d["false"]]
        if rv is None:
            if not blog.chunks or not all(blog.chunks) or false:
                raise AssertionError(f"wide burst: chunks {blog.chunks}, false {len(false)}")
            want = (len(wide), 0, 0, 0)
        else:
            if all(blog.chunks) or blog.kernel_sig < 1 or false != [bad_vote.signature]:
                raise AssertionError(f"tampered burst: chunks {blog.chunks}, kernel_sig "
                                     f"{blog.kernel_sig}, false {len(false)}")
            errs = run["peer_errors"]
            if len(errs) != 1 or errs[0][0] != CI_TAMPER_PEER:
                raise AssertionError(f"peer errors {errs}")
            want = (len(others), 1, 0, 0)
        got = (ing["pre_verified"], ing["sig_invalid"], ing["unverified"], ing["hub_errors"])
        if got != want or ing["submitted"] != n_sub or hs["verify_errors"]:
            raise AssertionError(f"{name}: ingest {ing}, hub {hs}")
        out[name] = {
            "votes": n_sub, "votes_per_s": run["votes_per_s"],
            "first_submit_to_last_apply_s": run["first_submit_to_last_apply_s"][0],
            "hub_max_batch": CI_WIDE_MAX_BATCH, "hub_window_ms": CI_WIDE_WINDOW_MS,
            "ingest_max_inflight": CI_WIDE_INFLIGHT,
            "dispatches": [(d["n"], d["route"]) for d in log],
            "kernel_eq_chunks_held": blog.chunks, "kernel_sig_calls": blog.kernel_sig,
            "launches": launches, "ingest": ing, "peer_errors": run["peer_errors"],
            "hub_occupancy": hs["mean_occupancy"],
        }
        if rv is not None:
            out[name]["tampered_vote"] = {"round": rv.round, "type": int(rv.type),
                                          "validator_index": rv.validator_index}
    out["phase_s"] = time.perf_counter() - t0
    return out


# -- phase 24 -----------------------------------------------------------------


def _frozen_config(scheme: str = "per-sig"):
    """The frozen-clock recipe's config: fast_config with 60 s propose,
    prevote and precommit timeouts, so that round 0 always completes."""
    from tendermint_tpu_torch.consensus import harness

    cfg = harness.fast_config()
    cfg.commit_scheme = scheme
    for f in ("timeout_propose_ns", "timeout_prevote_ns", "timeout_precommit_ns"):
        setattr(cfg, f, 60_000 * 1_000_000)
    return cfg


def _frozen_net(dev, key_type: str = "ed25519", scheme: str = "per-sig"):
    from tendermint_tpu_torch.consensus import harness
    from tendermint_tpu_torch.libs.clock import ManualClock

    return harness.LocalNetwork(
        CL_VALS, config=_frozen_config(scheme), key_type=key_type, device=dev,
        base_clock=ManualClock(harness.GENESIS_TIME_NS - 500 * 1_000_000))


def _chain_bytes(net, height: int) -> tuple[list, bytes]:
    """Blocks 1..height (every node must store the same ones) and node 0's
    seen commit at `height`, encoded."""
    blocks = [net.nodes[0].block_store.load_block(h).encode() for h in range(1, height + 1)]
    for n in net.nodes[1:]:
        if [n.block_store.load_block(h).encode() for h in range(1, height + 1)] != blocks:
            raise AssertionError("the nodes stored different blocks")
    return blocks, net.nodes[0].block_store.load_seen_commit(height).encode()


def _ingest_sums(net) -> dict:
    keys = ("pre_verified", "unverified", "sig_invalid", "hub_errors")
    return {k: sum(n.cs.ingest.stats[k] for n in net.nodes if n.cs is not None) for k in keys}


async def _host_chain(key_type: str, scheme: str, height: int, hub: bool) -> tuple:
    """The same frozen-clock network on the host (device="cpu"; a CPU hub
    when `hub`, whose verdict cache answers repeated aggregate checks)."""
    import shutil

    from tendermint_tpu_torch.crypto import verify_hub as vh

    if hub:
        vh.acquire_hub(device="cpu")
    net = _frozen_net("cpu", key_type, scheme)
    try:
        await net.start()
        t0 = time.perf_counter()
        await net.wait_for_height(height, CL_TIMEOUT_S)
        wall = time.perf_counter() - t0
        return _chain_bytes(net, height), wall
    finally:
        await net.stop()
        for n in net.nodes:
            shutil.rmtree(n.wal_dir, ignore_errors=True)
        if hub:
            vh.release_hub()


async def _crash_and_resume(dev, net) -> dict:
    """Phase 24(c), on the running ed25519 network `net`: node 0 crashes
    at fail point 3 (its block saved and the WAL's end-height marker
    written, before ApplyBlock) at a height H whose successor node 0
    proposes; its WAL's last write is torn; a second Node is built on its
    stores, app and WAL directory; it must repair and replay the WAL and
    commit H + 1 with the others."""
    import asyncio
    import io
    import logging
    import sys as _sys

    from tendermint_tpu_torch.consensus import harness
    from tendermint_tpu_torch.consensus.replay import report_wal_repair
    from tendermint_tpu_torch.libs import fail

    node0 = net.nodes[0]
    cs0 = node0.cs
    me = node0.priv_val.get_pub_key().address()
    vals = cs0.state.validators
    cur = cs0.rs.height
    height = next(h for h in range(cur + 2, cur + 2 + 2 * CL_VALS)
                  if vals.copy_increment_proposer_priority(h + 1 - cur).get_proposer().address == me)
    crashed = asyncio.Event()

    def crash(point):
        cs = _sys._getframe(2).f_locals.get("self")  # fail_point's caller: _finalize_commit
        if cs is cs0 and cs.rs.height == height:
            crashed.set()
            raise fail.InjectedCrash(point)

    fail.set_crash_callback(crash, index=3)
    try:
        await asyncio.wait_for(crashed.wait(), CL_TIMEOUT_S)
    finally:
        fail.reset()
    await node0.stop()  # its receive task is dead: the crashed process
    with open(f"{node0.wal_dir}/wal", "ab") as f:
        f.write(b"\x2a\x00\x00\x00\x30\x00\x00\x00torn")  # a torn last write
    node = harness.Node(net.genesis, net.keys[0], config=node0.config, clock=node0.clock,
                        wal_dir=node0.wal_dir, app=node0.app,
                        block_store=node0.block_store, state_store=node0.state_store,
                        device=dev)
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    logger = logging.getLogger("replay")
    logger.addHandler(handler)
    try:
        report_wal_repair(node.wal)
    finally:
        logger.removeHandler(handler)
    t0 = time.perf_counter()
    await node.start()
    node.cs.broadcast_hook = net._make_hook(0)
    net.nodes[0] = node
    await asyncio.gather(*(n.cs.wait_for_height(height + 1, CL_TIMEOUT_S) for n in net.nodes))
    if len({n.block_store.load_block(height + 1).encode() for n in net.nodes}) != 1:
        raise AssertionError("the resumed node stored another block")
    return {"crash_height": height, "crash_point": 3, "resumed_commit_height": height + 1,
            "report_wal_repair": buf.getvalue().splitlines(),
            "wal_repairs": len(node.wal.last_repair),
            "resume_to_commit_s": time.perf_counter() - t0}


def drive_consensus_live(dev, pairing: "PairingAudit") -> dict:
    """Phase 24: live consensus on the card, byte-checked against the host
    (see the module docstring)."""
    import asyncio
    import shutil

    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.crypto import verify_hub as vh
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP
    from tendermint_tpu_torch.libs import trace
    from tendermint_tpu_torch.types.block import Block

    t_phase = time.perf_counter()
    out: dict = {}
    trace.configure(enabled=True)  # the BLS host split comes from the `bls` spans

    async def card_run(key_type, scheme, height, resume=False):
        hub = vh.acquire_hub(device=dev)
        net = _frozen_net(dev, key_type, scheme)
        resumed = None
        try:
            with _hub_dispatches(hub) as log:
                await net.start()
                t0 = time.perf_counter()
                await net.wait_for_height(height, CL_TIMEOUT_S)
                wall = time.perf_counter() - t0
                chain = _chain_bytes(net, height)
                ingest = _ingest_sums(net)
                if resume:
                    resumed = await _crash_and_resume(dev, net)
            hs = hub.stats()
        finally:
            await net.stop()
            for n in net.nodes:
                shutil.rmtree(n.wal_dir, ignore_errors=True)
            vh.release_hub()
        return chain, wall, ingest, hs, log, resumed

    # (a) ed25519, with (c) the crash and resume on the same network
    _launch_counts(reset=True)
    (blocks, seen), wall, ingest, hs, log, resumed = asyncio.run(
        card_run("ed25519", "per-sig", CL_ED_HEIGHT, resume=True))
    launches = _launch_counts()
    (h_blocks, h_seen), h_wall = asyncio.run(_host_chain("ed25519", "per-sig", CL_ED_HEIGHT, False))
    if blocks != h_blocks or seen != h_seen:
        raise AssertionError("the card's ed25519 chain differs from the host's")
    if ingest["hub_errors"] or hs["verify_errors"]:
        raise AssertionError(f"ed25519 net: ingest {ingest}, hub {hs}")
    out["ed25519"] = {
        "validators": CL_VALS, "height": CL_ED_HEIGHT, "wall_s": wall,
        "heights_per_s": CL_ED_HEIGHT / wall, "host_wall_s": h_wall,
        "host_heights_per_s": CL_ED_HEIGHT / h_wall,
        "blocks_and_seen_commit_equal_to_host": True, "block_bytes": [len(b) for b in blocks],
        "routes": _split_by_route([(d["n"], d["route"]) for d in log]),
        "hub_cache_hits": hs["cache_hits"], "hub_dispatches": hs["dispatches"],
        "ingest": ingest, "launches": launches,
    }
    out["crash_resume"] = resumed

    # (b) BLS aggregate commits: each aggregate LastCommit check timed, its
    # host split from the `bls` spans and the card's share in the kernels
    checks: list = []
    real_agg = B.bls_aggregate_verify
    real_miller, real_final = BP.miller, BP.final_exp
    in_kernels = [0.0]

    def timed(fn):
        def call(*a):
            _sync(dev)
            t = time.perf_counter()
            r = fn(*a)
            _sync(dev)
            in_kernels[0] += time.perf_counter() - t
            return r
        return call

    def agg_verify(pub_keys, msgs, agg_sig, device=None):
        before = _bls_host_split()
        in_kernels[0] = 0.0
        t = time.perf_counter()
        ok = real_agg(pub_keys, msgs, agg_sig, device)
        wall_s = time.perf_counter() - t
        split = {k: v - before[k] for k, v in _bls_host_split().items()}
        checks.append({"signers": len(pub_keys), "ok": ok, "wall_s": wall_s, "host_split": split,
                       "card_kernels_s": in_kernels[0],
                       "host_other_s": wall_s - sum(split.values()) - in_kernels[0]})
        return ok

    _launch_counts(reset=True)
    B.bls_aggregate_verify = agg_verify
    BP.miller, BP.final_exp = timed(real_miller), timed(real_final)
    try:
        with pairing.recording(CL_BLS):
            (bls_blocks, bls_seen), bls_wall, bls_ingest, bls_hs, bls_log, _ = asyncio.run(
                card_run("bls12381", "bls-aggregate", CL_BLS_HEIGHT))
        _sync(dev)
    finally:
        B.bls_aggregate_verify = real_agg
        BP.miller, BP.final_exp = real_miller, real_final
    bls_launches = _launch_counts()
    _require_all_launched(CL_BLS, bls_launches, (BP.MILLER.name, BP.FINAL_EXP.name))
    for h in (2, 3):
        if not Block.decode(bls_blocks[h - 1]).last_commit.is_aggregate():
            raise AssertionError(f"block {h}'s LastCommit is not aggregate")
    if not checks or not all(c["ok"] for c in checks):
        raise AssertionError(f"aggregate checks {checks}")
    (hb_blocks, hb_seen), hb_wall = asyncio.run(
        _host_chain("bls12381", "bls-aggregate", CL_BLS_HEIGHT, True))
    if bls_blocks != hb_blocks or bls_seen != hb_seen:
        raise AssertionError("the card's BLS chain differs from the host's")
    if bls_ingest["hub_errors"] or bls_hs["verify_errors"]:
        raise AssertionError(f"bls net: ingest {bls_ingest}, hub {bls_hs}")
    out["bls_aggregate"] = {
        "validators": CL_VALS, "height": CL_BLS_HEIGHT, "wall_s": bls_wall,
        "wall_per_height_s": bls_wall / CL_BLS_HEIGHT, "host_wall_s": hb_wall,
        "blocks_equal_to_host": True, "aggregate_last_commits": [2, 3],
        "aggregate_checks": checks, "launches": bls_launches,
        "routes": _split_by_route([(d["n"], d["route"]) for d in bls_log]),
        "hub_cache_hits": bls_hs["cache_hits"], "ingest": bls_ingest,
        "pairing_shapes": pairing.shapes(CL_BLS),
    }
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# phase 25: node-to-node block-sync over TCP with the secret connection —
# phase 12's 150-validator chain served by a source Node, synced by a
# fresh joiner Node through their Routers in the blocksync reactor's
# default windows of 64 blocks, every node sharing one hub at
# NB_HUB_MAX_BATCH (the first acquirer's config wins)
NB_WINDOW = 64
#: phase 25 syncs the first NB_BLOCKS blocks of phase 12's chain (cut from
#: all 256 to make room for phase 27)
NB_BLOCKS = 192
NB_HUB_MAX_BATCH = 16384
NB_TIMEOUT_S = 300.0
# the byzantine source serves up to NB_TAMPER_HEIGHT + 1, that block's
# LastCommit (the commit for NB_TAMPER_HEIGHT) with one flipped bit
NB_TAMPER_HEIGHT, NB_TAMPER_VAL = 100, 5
NB_MAIN = "node_blocksync[tcp + secret connection, 150 validators]"
NB_TAMPERED = "node_blocksync[byzantine source]"
NN_PATH = "node_net[3 validators, memory transport]"
# phase 26: the frozen-clock recipe on full Nodes over the memory transport
NN_HEIGHT = 4
NN_TIMEOUT_S = 120.0
NN_TX = b"mercury=planet"


def _node_key(tag: str):
    from tendermint_tpu_torch.crypto import ed25519

    return ed25519.Ed25519PrivKey(hashlib.sha256(f"chip-smoke:{tag}".encode()).digest())


def _memdb_copy(db):
    """A second MemDB holding `db`'s entries (the byzantine source's stores:
    its own, so nothing it does reaches the honest source's)."""
    from tendermint_tpu_torch.store.db import MemDB

    out = MemDB()
    out._data = dict(db._data)
    return out


async def _tcp_node(dev, chain, tag: str, *, source: bool, block_db=None, state_db=None):
    """A Node on `dev` with one TCPTransport listening on 127.0.0.1 (an
    ephemeral port) and the phase's hub config. A source takes the
    chain's stores (or `block_db` / `state_db`) and app, with block-sync
    off; a joiner starts from genesis with block-sync on."""
    from tendermint_tpu_torch.abci.kvstore import KVStoreApp
    from tendermint_tpu_torch.config import VerifyHubConfig
    from tendermint_tpu_torch.node import Node, NodeConfig
    from tendermint_tpu_torch.p2p.tcp import TCPTransport
    from tendermint_tpu_torch.proxy import AppConns

    transport = TCPTransport()
    await transport.listen("127.0.0.1:0")
    cfg = NodeConfig(block_sync=not source, moniker=tag,
                     verify_hub=VerifyHubConfig(max_batch=NB_HUB_MAX_BATCH))
    if source:
        # a fresh client on the chain's app: the local client's lock binds
        # to the loop that first uses it
        node = Node(cfg, chain["genesis"], AppConns.local(chain["conns"].consensus.app),
                    _node_key(tag), [transport], device=dev,
                    block_db=block_db or chain["store"].db,
                    state_db=state_db or chain["state_store"].db)
    else:
        node = Node(cfg, chain["genesis"], KVStoreApp(), _node_key(tag), [transport], device=dev)
    node.tcp = transport
    return node


def _serve_prefix(node, top: int, top_block=None) -> None:
    """Make a source node serve its chain up to block `top` only (the
    reactor answers status and block requests from its store), with
    `top_block` in place of the stored block `top` when given."""
    real_load = node.block_store.load_block
    node.block_store.height = lambda: top
    node.block_store.load_block = lambda h: (
        (top_block or real_load(h)) if h == top else real_load(h) if h < top else None)


def _tcp_address(node):
    from tendermint_tpu_torch.p2p.types import NodeAddress

    host, port = node.tcp.endpoint().rsplit(":", 1)
    return NodeAddress(node_id=node.node_id, protocol="tcp", host=host, port=int(port))


def _peer_bytes(node) -> dict:
    """Bytes each of `node`'s live connections moved (flowrate Meters)."""
    return {nid[:12]: {"sent": p.conn.send_meter.total, "received": p.conn.recv_meter.total}
            for nid, p in node.router._peers.items()}


def _record_errors(node) -> list:
    """Every PeerError the node's peer manager is told of, from now on."""
    errors: list = []
    real = node.peer_manager.errored

    def errored(err):
        errors.append(err)
        real(err)

    node.peer_manager.errored = errored
    return errors


async def _stop_all(nodes) -> None:
    """Stop every node (each within 60 s) and remove its WAL directory."""
    import asyncio
    import shutil

    for n in nodes:
        await asyncio.wait_for(n.stop(), 60)
        if n.consensus is not None:
            shutil.rmtree(n.consensus.wal.dir, ignore_errors=True)


async def _node_sync_run(dev, chain) -> dict:
    """Phase 25's honest pass: one source, one joiner, over TCP."""
    import asyncio

    from tendermint_tpu_torch.crypto import verify_hub as vh

    src = await _tcp_node(dev, chain, "source", source=True)
    joiner = await _tcp_node(dev, chain, "joiner", source=False)
    try:
        await src.start()
        _serve_prefix(src, NB_BLOCKS)
        hub = vh.running_hub()
        errors = _record_errors(joiner)
        with _hub_dispatches(hub) as dispatches:
            t0 = time.perf_counter()
            await joiner.start()
            joiner.peer_manager.add_address(_tcp_address(src))
            await asyncio.wait_for(joiner.blocksync_reactor.synced.wait(), NB_TIMEOUT_S)
            wall = time.perf_counter() - t0
        moved = _peer_bytes(joiner)
        hs = hub.stats()
        return {"joiner": joiner, "source_id": src.node_id, "wall_s": wall, "errors": errors,
                "bytes": moved, "hub": hs, "hub_max_batch": hub.max_batch,
                "dispatches": [(d["n"], d["route"]) for d in dispatches]}
    finally:
        await _stop_all([joiner, src])


async def _node_tampered_run(dev, chain, bad_block) -> dict:
    """Phase 25's tampered pass: a second joiner first knows only a
    byzantine source, which serves the chain up to NB_TAMPER_HEIGHT + 1
    with `bad_block` there; once the joiner has punished it, the
    byzantine node goes away and the joiner is given the honest source."""
    import asyncio

    from tendermint_tpu_torch.crypto import verify_hub as vh

    top = NB_TAMPER_HEIGHT + 1
    byz = await _tcp_node(dev, chain, "byzantine", source=True,
                          block_db=_memdb_copy(chain["store"].db),
                          state_db=_memdb_copy(chain["state_store"].db))
    src = await _tcp_node(dev, chain, "source-2", source=True)
    joiner = await _tcp_node(dev, chain, "joiner-2", source=False)
    try:
        await byz.start()
        # serve a shorter chain whose top block carries the bad commit
        _serve_prefix(byz, top, bad_block)
        await src.start()
        _serve_prefix(src, NB_BLOCKS)
        hub = vh.running_hub()
        errors = _record_errors(joiner)
        punished: list = []
        ups: list = []
        with _hub_dispatches(hub) as dispatches:
            await joiner.start()
            reactor = joiner.blocksync_reactor
            real_punish = reactor._punish
            first = asyncio.Event()

            async def punish(height, provider, next_provider, err):
                punished.append((height, provider))
                await real_punish(height, provider, next_provider, err)
                first.set()

            reactor._punish = punish
            # the first range waits until the pool holds every block the
            # byzantine node serves, so that the range holding height
            # NB_TAMPER_HEIGHT is the one after a whole window in every run
            # (the reactor verifies whatever run the pool holds: without
            # this wait that range was as short as 5 blocks, below the
            # cutoff, in one run on the card)
            real_verify = reactor._verify_and_apply
            gate = asyncio.Event()

            async def verify_and_apply(run):
                if not gate.is_set():
                    while len(reactor.pool.peek_range(top + 1)) < top:
                        await asyncio.sleep(0.01)
                    gate.set()
                    run = reactor.pool.peek_range(reactor.window + 1)
                await real_verify(run)

            reactor._verify_and_apply = verify_and_apply
            updates = joiner.peer_manager.subscribe()
            joiner.peer_manager.add_address(_tcp_address(byz))
            await asyncio.wait_for(first.wait(), NB_TIMEOUT_S)
            applied_at_punish = joiner.block_store.height()
            score = joiner.peer_manager.peer_score(byz.node_id)
            await byz.stop()
            while not updates.empty():
                ups.append(updates.get_nowait())
            t0 = time.perf_counter()
            joiner.peer_manager.add_address(_tcp_address(src))
            await asyncio.wait_for(reactor.synced.wait(), NB_TIMEOUT_S)
            wall = time.perf_counter() - t0
        return {"joiner": joiner, "byzantine_id": byz.node_id, "source_id": src.node_id,
                "punished": punished, "errors": errors, "applied_at_punish": applied_at_punish,
                "byzantine_score": score, "byzantine_connected_at_end":
                    byz.node_id in joiner.peer_manager.connected_peers(),
                "byzantine_ups": sum(1 for u in ups if u.node_id == byz.node_id
                                     and u.status.value == "up"),
                "finish_wall_s": wall, "hub": hub.stats(),
                "dispatches": [(d["n"], d["route"], d["false"]) for d in dispatches]}
    finally:
        await _stop_all([joiner, src, byz])


def _check_synced_chain(joiner, chain, what: str) -> None:
    """The joiner holds blocks 1..NB_BLOCKS-1 byte-equal to the chain and
    the chain's State at NB_BLOCKS - 1."""
    src, end = chain["store"], chain["nb_state"]
    top = NB_BLOCKS - 1
    if joiner.block_store.height() != top:
        raise AssertionError(f"{what}: joiner at {joiner.block_store.height()}, want {top}")
    for h in range(1, top + 1):
        if joiner.block_store.load_block(h).encode() != src.load_block(h).encode():
            raise AssertionError(f"{what}: block {h} differs from the chain's")
    state = joiner.state_store.load()
    if state.encode() != end.encode():
        raise AssertionError(f"{what}: the joiner's State differs from the chain's")


def drive_node_blocksync(dev, audit: ShapeAudit, chain: dict) -> dict:
    """Phase 25: a full Node block-syncs phase 12's chain from another
    over TCP with the secret connection (see the module docstring)."""
    import asyncio
    from dataclasses import replace

    from tendermint_tpu_torch.crypto import batch
    from tendermint_tpu_torch.types.block import Block

    cutoff = batch.MIN_TPU_BATCH
    log = RangeLog()
    with log.recording(), audit.recording(NB_MAIN):
        _launch_counts(reset=True)
        run = asyncio.run(_node_sync_run(dev, chain))
        launches = _launch_counts()
    _sync(dev)
    joiner = run["joiner"]
    _check_synced_chain(joiner, chain, "node block-sync")
    if run["errors"]:
        raise AssertionError(f"an honest sync reported {run['errors']}")
    if run["hub"]["verify_errors"] or run["hub_max_batch"] != NB_HUB_MAX_BATCH:
        raise AssertionError(f"hub: {run['hub']}")
    for r in log.ranges:
        if r["raised"]:
            raise AssertionError(f"an honest range raised: {r}")
        want = "cuda" if r["sigs"] >= cutoff else "cpu"
        if r["route"] != want or any(route != want for _n, route in r["batches"]):
            raise AssertionError(f"range of {r['sigs']} signatures routed {r['batches']}, "
                                 f"not {want} (cutoff {cutoff})")
    if sum(1 for r in log.ranges if r["route"] == "cuda") < 2:
        raise AssertionError(f"fewer than two windows on the card: {log.ranges}")
    _require_all_launched("node block-sync", launches)
    applied = joiner.blocksync_reactor.metrics["blocks_applied"]

    # the tampered pass
    top = NB_TAMPER_HEIGHT + 1
    good = chain["store"].load_block(top)
    lc = good.last_commit
    sigs = list(lc.signatures)
    s = sigs[NB_TAMPER_VAL].signature
    sigs[NB_TAMPER_VAL] = replace(sigs[NB_TAMPER_VAL],
                                  signature=s[:40] + bytes([s[40] ^ 1]) + s[41:])
    bad = Block(good.header, good.txs, good.evidence, replace(lc, signatures=tuple(sigs)))
    tlog = RangeLog()
    with tlog.recording(), audit.recording(NB_TAMPERED):
        _launch_counts(reset=True)
        trun = asyncio.run(_node_tampered_run(dev, chain, bad))
        tlaunches = _launch_counts()
    _sync(dev)
    byz = trun["byzantine_id"]
    if not trun["punished"] or trun["punished"][0] != (NB_TAMPER_HEIGHT, byz):
        raise AssertionError(f"tampered pass punished {trun['punished']}")
    if trun["applied_at_punish"] >= NB_TAMPER_HEIGHT:
        raise AssertionError(f"applied up to {trun['applied_at_punish']} from the byzantine node")
    first_err = trun["errors"][0] if trun["errors"] else None
    if first_err is None or first_err.node_id != byz or not first_err.fatal:
        raise AssertionError(f"no fatal PeerError named the byzantine node: {trun['errors']}")
    if trun["byzantine_score"] is None or trun["byzantine_score"] >= 1:
        raise AssertionError(f"the byzantine node's score is {trun['byzantine_score']}")
    failing = next(r for r in tlog.ranges if r["first_height"] <= NB_TAMPER_HEIGHT
                   < r["first_height"] + r["blocks"])
    if failing["sigs"] < cutoff or failing["route"] != "cuda":
        raise AssertionError(f"the range with the bad signature did not run on the card: {failing}")
    flagged = [d for d in trun["dispatches"] if d[2]]
    if {f for d in flagged for f in d[2]} != {sigs[NB_TAMPER_VAL].signature} \
            or flagged[0][1] != "cuda":
        raise AssertionError(f"the card's bitmap flagged {flagged}")
    _require_all_launched("tampered node block-sync", tlaunches)
    _check_synced_chain(trun["joiner"], chain, "tampered node block-sync")
    if trun["hub"]["verify_errors"]:
        raise AssertionError(f"hub: {trun['hub']}")
    return {
        "entry": "node.Node x 2 over TCPTransport (secret connection), device cuda, "
                 f"hub max_batch {NB_HUB_MAX_BATCH}",
        "transport": "tcp 127.0.0.1",
        "validators": N_VALS, "source_blocks": NB_BLOCKS, "window": NB_WINDOW,
        "blocks_applied": applied, "wall_s": run["wall_s"],
        "blocks_per_s": applied / run["wall_s"],
        "sigs_verified": sum(r["sigs"] for r in log.ranges),
        "min_tpu_batch": cutoff,
        "ranges": [{k: r[k] for k in ("first_height", "blocks", "sigs", "route", "wall_s")}
                   for r in log.ranges],
        "range_verify_wall_s": sum(r["wall_s"] for r in log.ranges),
        "hub_dispatches": _split_by_route(run["dispatches"]),
        "hub": {k: run["hub"][k] for k in ("dispatches", "dispatched_sigs", "cache_hits",
                                          "verify_errors", "effective_max_batch")},
        "bytes_per_connection": run["bytes"],
        "launches": launches,
        "tampered": {
            "tampered_height": NB_TAMPER_HEIGHT, "served_top": top,
            "punished": [h for h, _p in trun["punished"]],
            "applied_at_punish": trun["applied_at_punish"],
            "peer_errors": [[e.node_id[:12], e.err[:60], e.fatal] for e in trun["errors"]],
            "byzantine_score": trun["byzantine_score"],
            "byzantine_reconnects_before_stop": max(0, trun["byzantine_ups"] - 1),
            "ranges": [{k: r[k] for k in ("first_height", "blocks", "sigs", "route", "raised")}
                       for r in tlog.ranges],
            "flagged_dispatch": [flagged[0][0], flagged[0][1]],
            "finish_from_honest_s": trun["finish_wall_s"],
            "launches": tlaunches,
        },
    }


async def _node_net_run(dev, *, hub: bool) -> dict:
    """Phase 26's network: the frozen-clock recipe's 3 equal-power
    validators as full Nodes over one MemoryNetwork on `dev`, to height
    NN_HEIGHT, NN_TX in the first proposer's mempool before its consensus
    starts (so block 1 carries it on every run). Returns every node's
    blocks, the app-hash chain, the tx's query on each node and the wall."""
    import asyncio

    from tendermint_tpu_torch.abci import types as abci
    from tendermint_tpu_torch.abci.kvstore import KVStoreApp
    from tendermint_tpu_torch.config import VerifyHubConfig
    from tendermint_tpu_torch.consensus import harness
    from tendermint_tpu_torch.libs.clock import ManualClock
    from tendermint_tpu_torch.node import Node, NodeConfig
    from tendermint_tpu_torch.p2p.memory import MemoryNetwork
    from tendermint_tpu_torch.p2p.types import NodeAddress, node_id_from_pubkey
    from tendermint_tpu_torch.privval import MockPV

    genesis, keys = harness.make_genesis(CL_VALS)
    clock = ManualClock(harness.GENESIS_TIME_NS - 500 * 1_000_000)
    memory = MemoryNetwork()
    proposer = genesis.validator_set().get_proposer().address
    nodes, apps = [], []
    for i, k in enumerate(keys):
        nk = _node_key(f"validator-{i}")
        app = KVStoreApp()
        node = Node(NodeConfig(consensus=_frozen_config(), clock=clock, moniker=f"v{i}",
                               verify_hub=VerifyHubConfig(enabled=hub)),
                    genesis, app, nk, [memory.create_transport(node_id_from_pubkey(nk.pub_key()))],
                    priv_validator=MockPV(k), device=dev)
        if k.pub_key().address() == proposer:
            real_start = node._start_consensus

            async def start_consensus(node=node, real_start=real_start):
                await node.mempool.check_tx(NN_TX)
                await real_start()

            node._start_consensus = start_consensus
        nodes.append(node)
        apps.append(app)
    try:
        for n in nodes:
            await n.start()
        t0 = time.perf_counter()
        for i, a in enumerate(nodes):
            for b in nodes[i + 1:]:
                a.peer_manager.add_address(NodeAddress(node_id=b.node_id, protocol="memory"))
        await asyncio.gather(*(n.wait_for_height(NN_HEIGHT, NN_TIMEOUT_S) for n in nodes))
        wall = time.perf_counter() - t0
        blocks = [[n.block_store.load_block(h).encode() for h in range(1, NN_HEIGHT + 1)]
                  for n in nodes]
        app_hashes = [n.block_store.load_block(h).header.app_hash.hex()
                      for n in nodes[:1] for h in range(1, NN_HEIGHT + 1)]
        values = [a.query(abci.RequestQuery(data=NN_TX.split(b"=")[0])).value for a in apps]
        return {"blocks": blocks, "app_hashes": app_hashes, "values": values, "wall_s": wall,
                "ingest_hub_errors": sum(n.consensus.ingest.stats["hub_errors"]
                                         for n in nodes if n.consensus.ingest is not None)}
    finally:
        await _stop_all(nodes)


def drive_node_net(dev) -> dict:
    """Phase 26: a validator network of full Nodes over the memory
    transport, on the card and then on the host; the two chains must be
    byte-equal."""
    import asyncio

    from tendermint_tpu_torch.crypto import verify_hub as vh

    _launch_counts(reset=True)
    card = asyncio.run(_node_net_run(dev, hub=True))
    launches = _launch_counts()
    if vh.running_hub() is not None:
        raise AssertionError("the hub outlived the network's last node")
    host = asyncio.run(_node_net_run("cpu", hub=False))
    for run, where in ((card, "card"), (host, "host")):
        if any(b != run["blocks"][0] for b in run["blocks"]):
            raise AssertionError(f"{where}: the nodes stored different blocks")
        if run["values"] != [NN_TX.split(b"=")[1]] * CL_VALS:
            raise AssertionError(f"{where}: the tx was not committed everywhere: {run['values']}")
        if run["ingest_hub_errors"]:
            raise AssertionError(f"{where}: ingest hub errors {run['ingest_hub_errors']}")
    if card["blocks"][0] != host["blocks"][0] or card["app_hashes"] != host["app_hashes"]:
        raise AssertionError("the card's chain differs from the host's")
    from tendermint_tpu_torch.types.block import Block

    if NN_TX not in Block.decode(card["blocks"][0][0]).txs:
        raise AssertionError("block 1 does not carry the tx")
    return {
        "entry": "node.Node x 3 over MemoryNetwork (frozen clock), device cuda, then cpu",
        "validators": CL_VALS, "height": NN_HEIGHT,
        "wall_s": card["wall_s"], "heights_per_s": NN_HEIGHT / card["wall_s"],
        "host_wall_s": host["wall_s"], "host_heights_per_s": NN_HEIGHT / host["wall_s"],
        "blocks_equal_to_host": True, "app_hashes": card["app_hashes"],
        "block_bytes": [len(b) for b in card["blocks"][0]],
        "tx_in_block": 1, "launches": launches,
    }


# -- phase 27 -----------------------------------------------------------------

# phase 27: the scenario harness (consensus/scenarios.py, RouterNet,
# libs/chaos.py) on the card. bench.py's chaos_soak rows (bench.py:598-640):
# every scenario of the registry at 4 validators, and baseline at 50
SC_SOAK = dict(n_vals=4, target_height=3, seed=7, timeout_s=75.0, stall_s=25.0,
               time_scale=1.0, degree=8)
SC_WIDE = dict(n_vals=50, target_height=2, seed=7, timeout_s=300.0, stall_s=90.0,
               time_scale=4.0, degree=8)
SC_BLS_HEIGHT = 3
SC_TIMEOUT_S = 240.0
SC_SWEEP = "scenarios[registry, 4 validators]"
SC_DET = "scenarios[determinism construction, card]"
SC_BLS = "scenarios[bls12381 RouterNet, lossy links]"
SC_BOOT = "scenarios[run_boot_wave, 4 validators + 2 joiners]"
SC_LIGHT = "scenarios[run_light_attack, 3 validators]"
SC_WIDE_PATH = "scenarios[baseline, 50 validators]"


def _nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


async def _with_hub(dev, coro_fn):
    """Run `coro_fn()` inside a hub on `dev` acquired first (the net's own
    acquire then shares it, refcounted), logging every hub dispatch with
    its route. Returns (result, dispatch log, hub stats)."""
    from tendermint_tpu_torch.crypto import verify_hub as vh

    hub = vh.acquire_hub(device=dev)
    try:
        with _hub_dispatches(hub) as log:
            out = await coro_fn()
        return out, log, hub.stats()
    finally:
        vh.release_hub()


def _scenario_row(res, log, hs, launches) -> dict:
    d = res.as_dict()
    if d["outcome"] != "ok" or not (d["audit"] or {}).get("ok"):
        raise AssertionError(f"scenario {d['scenario']}: {json.dumps(d, default=str)[:4000]}")
    if hs["verify_errors"]:
        raise AssertionError(f"scenario {d['scenario']}: hub errors {hs}")
    fs = {}
    for per_node in d["fs_faults"].values():
        for k, v in per_node.items():
            fs[k] = fs.get(k, 0) + v
    return {
        "scenario": d["scenario"], "n_vals": d["n_vals"], "outcome": d["outcome"],
        "heights": d["heights"], "elapsed_s": d["elapsed_s"],
        "blocks_per_s": d["blocks_per_s"], "recover_s": d["recover_s"],
        "events": d["events_applied"], "faults": _nonzero(d["faults"]),
        "fs_faults": _nonzero(fs), "audit_ok": True,
        "evidence_lag_heights": d["audit"]["evidence_lag_heights"],
        "byz": {str(b["index"]): b["counts"] for b in d["byz_actions"]},
        "routes": _split_by_route([(x["n"], x["route"]) for x in log]),
        "hub_cache_hits": hs["cache_hits"], "launches": _nonzero(launches),
    }


async def _determinism_run(dev) -> dict:
    """tests/test_routernet.py:315's construction on `dev`: 3 equal-power
    validators on a frozen clock behind genesis, generous timeouts,
    corruption + clock skew on the byte path, node0 -> node1 cut."""
    from tendermint_tpu_torch.config import ConsensusConfig
    from tendermint_tpu_torch.consensus import harness
    from tendermint_tpu_torch.consensus.routernet import RouterNet
    from tendermint_tpu_torch.libs.chaos import ChaosConfig, ChaosNetwork
    from tendermint_tpu_torch.libs.clock import ManualClock

    ms = 1_000_000
    cfg = ConsensusConfig(
        timeout_propose_ns=3000 * ms, timeout_propose_delta_ns=500 * ms,
        timeout_prevote_ns=2000 * ms, timeout_prevote_delta_ns=500 * ms,
        timeout_precommit_ns=2000 * ms, timeout_precommit_delta_ns=500 * ms,
        timeout_commit_ns=80 * ms, skip_timeout_commit=True)
    chaos = ChaosNetwork(ChaosConfig(seed=424, corrupt_rate=0.015, delay_ms=2.0,
                                     clock_skew_ms=80.0))
    net = RouterNet(3, config=cfg, chaos=chaos,
                    base_clock=ManualClock(harness.GENESIS_TIME_NS - 500 * ms),
                    stall_refresh_s=0.3, device=dev)
    chaos.partition_oneway({net.nodes[0].node_id}, {net.nodes[1].node_id})
    await net.start()
    try:
        t0 = time.perf_counter()
        await net.wait_for_height(3, 90)
        wall = time.perf_counter() - t0
        if not net.hashes_agree(3):
            raise AssertionError("determinism run: the nodes disagree")
        return {"blocks": net.block_fingerprints(3), "app_hashes": net.app_hash_chain(3),
                "wall_s": wall, "faults": _nonzero(dict(chaos.faults))}
    finally:
        await net.stop()


async def _bls_committee(dev) -> dict:
    """4 bls12381 validators with aggregate commits over RouterNet, under
    lossy_links' fault rates, to SC_BLS_HEIGHT."""
    from dataclasses import replace

    from tendermint_tpu_torch.consensus import scenarios as sc
    from tendermint_tpu_torch.consensus.routernet import RouterNet
    from tendermint_tpu_torch.libs.chaos import ChaosNetwork
    from tendermint_tpu_torch.types.block import Block

    chaos = ChaosNetwork(replace(sc.SCENARIOS["lossy_links"].chaos, seed=SC_SOAK["seed"]))
    cfg = _frozen_config("bls-aggregate")
    net = RouterNet(4, config=cfg, chaos=chaos, key_type="bls12381", device=dev)
    await net.start()
    try:
        t0 = time.perf_counter()
        await net.wait_for_height(SC_BLS_HEIGHT, SC_TIMEOUT_S)
        wall = time.perf_counter() - t0
        aggregate = [h for h, b in enumerate(net.block_fingerprints(SC_BLS_HEIGHT), 1)
                     if h > 1 and Block.decode(b).last_commit.is_aggregate()]
        if aggregate != list(range(2, SC_BLS_HEIGHT + 1)) or not net.hashes_agree(SC_BLS_HEIGHT):
            raise AssertionError(f"bls committee: aggregate LastCommits at {aggregate}")
        return {"wall_s": wall, "heights": net.heights(), "faults": _nonzero(dict(chaos.faults)),
                "aggregate_last_commits": aggregate}
    finally:
        await net.stop()


def drive_scenarios(dev, pairing: "PairingAudit") -> dict:
    """Phase 27: the scenario harness on the card (see the module
    docstring)."""
    import asyncio

    from tendermint_tpu_torch.consensus import scenarios as sc
    from tendermint_tpu_torch.crypto import batch as B
    from tendermint_tpu_torch.crypto import verify_hub as vh
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP

    out: dict = {"soak_parameters": SC_SOAK}
    t_phase = time.perf_counter()

    # (a) the whole registry at 4 validators
    rows, sweep_launches = [], {}
    t0 = time.perf_counter()
    for name in sc.SCENARIOS:
        _launch_counts(reset=True)
        res, log, hs = asyncio.run(_with_hub(
            dev, lambda name=name: sc.run_scenario(name, device=dev, **SC_SOAK)))
        launches = _launch_counts()
        for k, v in launches.items():
            sweep_launches[k] = sweep_launches.get(k, 0) + v
        rows.append(_scenario_row(res, log, hs, launches))
    out["registry"] = {"rows": rows, "wall_s": time.perf_counter() - t0,
                       "launches": sweep_launches}
    if vh.running_hub() is not None:
        raise AssertionError("the hub outlived the sweep")

    # (b) card against host, under the determinism construction
    _launch_counts(reset=True)
    card = asyncio.run(_determinism_run(dev))
    det_launches = _launch_counts()
    host = asyncio.run(_determinism_run("cpu"))
    if card["blocks"] != host["blocks"] or card["app_hashes"] != host["app_hashes"]:
        raise AssertionError("determinism run: the card's chain differs from the host's")
    if not {"corrupt", "asym_drop", "clock_skew"} <= set(card["faults"]):
        raise AssertionError(f"determinism run: faults {card['faults']}")
    out["determinism"] = {
        "validators": 3, "height": 3, "wall_s": card["wall_s"], "host_wall_s": host["wall_s"],
        "card_to_host_wall": card["wall_s"] / host["wall_s"],
        "blocks_and_app_hashes_equal_to_host": True,
        "block_bytes": [len(b) for b in card["blocks"]], "faults": card["faults"],
        "host_faults": host["faults"], "launches": _nonzero(det_launches),
    }

    # (c) a BLS committee: K7a and K7b on every aggregate check
    checks: list = []
    real_agg = B.bls_aggregate_verify

    def agg_verify(pub_keys, msgs, agg_sig, device=None):
        before = _launch_counts()
        t = time.perf_counter()
        ok = real_agg(pub_keys, msgs, agg_sig, device)
        _sync(dev)
        after = _launch_counts()
        checks.append({"signers": len(pub_keys), "ok": ok, "wall_s": time.perf_counter() - t,
                       "k7a": after[BP.MILLER.name] - before[BP.MILLER.name],
                       "k7b": after[BP.FINAL_EXP.name] - before[BP.FINAL_EXP.name]})
        return ok

    _launch_counts(reset=True)
    B.bls_aggregate_verify = agg_verify
    try:
        with pairing.recording(SC_BLS):
            bls, bls_log, bls_hs = asyncio.run(_with_hub(dev, lambda: _bls_committee(dev)))
        _sync(dev)
    finally:
        B.bls_aggregate_verify = real_agg
    bls_launches = _launch_counts()
    _require_all_launched(SC_BLS, bls_launches, (BP.MILLER.name, BP.FINAL_EXP.name))
    if not checks or not all(c["ok"] and c["k7a"] >= 1 and c["k7b"] >= 1 for c in checks):
        raise AssertionError(f"bls committee: aggregate checks {checks}")
    if bls_hs["verify_errors"]:
        raise AssertionError(f"bls committee: hub {bls_hs}")
    bls.update(launches=_nonzero(bls_launches), aggregate_checks=checks,
               routes=_split_by_route([(x["n"], x["route"]) for x in bls_log]),
               hub_cache_hits=bls_hs["cache_hits"], pairing_shapes=pairing.shapes(SC_BLS))
    out["bls_committee"] = bls

    # (d) the two lifecycles
    _launch_counts(reset=True)
    boot, boot_log, boot_hs = asyncio.run(_with_hub(
        dev, lambda: sc.run_boot_wave(n_vals=4, n_joiners=2, device=dev)))
    boot_launches = _launch_counts()
    if boot["outcome"] != "ok" or boot["joined"] != 2 or not boot["honest_chain_ok"]:
        raise AssertionError(f"boot wave: {json.dumps(boot, default=str)[:4000]}")
    _launch_counts(reset=True)
    light, light_log, light_hs = asyncio.run(_with_hub(
        dev, lambda: sc.run_light_attack(n_vals=3, device=dev)))
    light_launches = _launch_counts()
    if (light["outcome"] != "ok" or not light["divergence_detected"]
            or light["lca_committed_at"] is None):
        raise AssertionError(f"light attack: {json.dumps(light, default=str)[:4000]}")
    out["boot_wave"] = {k: boot[k] for k in (
        "joined", "time_to_synced_s", "joiner_heights", "chunks_served", "cache_hits",
        "backfill_sigs", "elapsed_s", "heights")}
    out["boot_wave"].update(launches=_nonzero(boot_launches),
                            routes=_split_by_route([(x["n"], x["route"]) for x in boot_log]))
    out["light_attack"] = {k: light[k] for k in (
        "attack_height", "divergence_detected", "served_forged", "lca_committed_at",
        "time_to_lca_commit_heights", "elapsed_s", "heights")}
    out["light_attack"].update(launches=_nonzero(light_launches),
                               routes=_split_by_route([(x["n"], x["route"]) for x in light_log]))

    # (e) one row at full width: baseline at 50 validators
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    res, log, hs = asyncio.run(_with_hub(
        dev, lambda: sc.run_scenario("baseline", device=dev, **SC_WIDE)))
    wide_launches = _launch_counts()
    out["wide"] = _scenario_row(res, log, hs, wide_launches)
    out["wide"]["parameters"] = SC_WIDE
    out["wide"]["wall_s"] = time.perf_counter() - t0
    if vh.running_hub() is not None:
        raise AssertionError("the hub outlived phase 27")
    out["launches"] = {
        SC_SWEEP: sweep_launches, SC_DET: det_launches, SC_BLS: bls_launches,
        SC_BOOT: boot_launches, SC_LIGHT: light_launches, SC_WIDE_PATH: wide_launches,
    }
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "tendermint_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    from tendermint_tpu_torch.crypto.cuda import _build
    from tendermint_tpu_torch.crypto.cuda import bls_pairing as BP  # (registers K7a, K7b)
    from tendermint_tpu_torch.crypto.cuda import sha256  # noqa: F401  (registers B8)

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for stem, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")

    t0 = time.perf_counter()
    rows = check_kernels(dev)
    print(f"check_kernels: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    entries = build_commits(N_VALS, N_COMMITS)
    print(f"signed {N_VALS * N_COMMITS} votes in {time.perf_counter() - t0:.1f} s")
    audit = ShapeAudit()
    run = drive_main_path(dev, entries, audit)
    for row in rows:
        row["launches"] = run["launches"][row["name"]]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} was not launched on the main path")
    with audit.recording(ED_TAMPERED):
        drive_tampered(dev, entries)
    bd = breakdown(dev, entries)
    print(json.dumps({"breakdown": bd}))
    for row in rows:
        # the kernel's summed device time inside one main-path kernel_eq
        row["main_path_device_ms"] = bd["ported_kernels_device_ms"][row["name"]]

    sr = drive_sr25519(dev, audit)
    print(json.dumps({"sr25519": sr}))
    mixed = drive_mixed(dev)
    print(json.dumps({"mixed": mixed}))

    from tendermint_tpu_torch.crypto import batch

    cutoff = batch._measure_cutoff(dev)
    if cutoff is None:
        raise AssertionError("TMTPU_MIN_TPU_BATCH pins the cutoff: unset it to measure")
    print(json.dumps({"cutoff": cutoff}))
    hub = drive_hub(dev, entries, run["slice"])
    print(json.dumps({"hub": hub}))
    chain = build_chain(N_VALS, N_BS_BLOCKS)
    print(f"blocksync: built the {N_BS_BLOCKS}-block source chain in {chain['build_s']:.1f} s")
    t0 = time.perf_counter()
    bs = drive_blocksync(dev, audit, chain)
    bs["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"blocksync": bs}))
    t0 = time.perf_counter()
    light = drive_light(dev, audit)
    light["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"light": light}))
    t0 = time.perf_counter()
    bls = drive_bls(dev)
    bls["phase_s"] = time.perf_counter() - t0
    bls_rows = bls.pop("rows")
    print(json.dumps({"bls": bls}))
    t0 = time.perf_counter()
    ss = drive_statesync(dev)
    ss["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"statesync": ss}))
    t0 = time.perf_counter()
    sha, sha_rows = drive_sha256(dev)
    sha["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"sha256": sha}))
    fleet_pairing = PairingAudit()
    t0 = time.perf_counter()
    lf = drive_light_fleet(dev, audit, fleet_pairing)
    lf["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"light_fleet": lf}))
    t0 = time.perf_counter()
    ssf = drive_statesync_fleet(dev, audit, fleet_pairing)
    ssf["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"statesync_fleet": ssf}))
    t0 = time.perf_counter()
    sharded = drive_sharded(dev, entries, audit)
    sharded["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"sharded": sharded}))
    t0 = time.perf_counter()
    # the aggregate's K7a/K7b shape, (2, 32), is phase 15's: held there
    vd = drive_verifyd(dev, audit, PairingAudit())
    vd["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"verifyd": vd}))
    t0 = time.perf_counter()
    tx = drive_tx_flood(dev, audit)
    tx["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"tx_ingress": tx}))
    t0 = time.perf_counter()
    ev = drive_evidence(dev)
    ev["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"evidence": ev}))
    t0 = time.perf_counter()
    ci = drive_consensus_ingest(dev, audit)
    ci["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"consensus_ingest": ci}))
    t0 = time.perf_counter()
    cl = drive_consensus_live(dev, fleet_pairing)
    cl["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"consensus_live": cl}))
    t0 = time.perf_counter()
    nb = drive_node_blocksync(dev, audit, chain)
    nb["phase12_blocks_per_s"] = bs["blocks_per_s"]
    nb["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"node_blocksync": nb}))
    del chain
    t0 = time.perf_counter()
    nn = drive_node_net(dev)
    nn["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"node_net": nn}))
    t0 = time.perf_counter()
    scn = drive_scenarios(dev, fleet_pairing)
    scn["phase_s"] = time.perf_counter() - t0
    print(json.dumps({"scenarios": scn}))
    # K7a and K7b at every shape phases 17-18, 24 and 27 gave them, path
    # and worst-case inputs
    t0 = time.perf_counter()
    fleet_held = _hold_pairing_shapes(dev, fleet_pairing)

    by_path = {
        "verify_commit_range[ed25519]": run["launches"],
        "verify_commit_range[sr25519]": sr["launches"],
        "verify_commit_light[ed25519+secp256k1, hub]": mixed["launches"],
        "verify_commit_range[hub, max_batch 8192]": hub["passes"][0]["launches"],
        "verify_commit_range[hub, cached]": hub["passes"][1]["launches"],
        "verify_commit_range[hub, max_batch 512]": hub["passes"][2]["launches"],
        f"blocksync[replay of the {N_BS_BLOCKS}-block chain]": bs["launches"],
        "blocksync[tampered pass]": bs["tampered"]["launches"],
        f"light[verify_adjacent_chain, {N_LC_HEADERS:,} headers]": light["launches"],
        "light[client, sequential]": light["client_sequential"]["launches"],
        "light[client, skipping]": light["client_skipping"]["launches"],
        "light[tampered pass]": light["tampered"]["launches"],
        "light[divergence]": light["divergence"]["launches"],
        BLS_MAIN: bls["launches"],
        BLS_TAMPERED: bls["tampered"]["launches"],
        BLS_PERSIG: bls["per_signature"]["honest"]["launches"],
        BLS_PERSIG_TAMPERED: bls["per_signature"]["tampered"]["launches"],
        # the first run on the card of the four restore turns
        SS_MAIN: ss["restore"]["turns"][1]["launches"],
        SS_TAMPERED: ss["tampered"]["launches"],
        SS_BLS: ss["bls_backfill"]["launches"],
        SS_BLS_TAMPERED: ss["bls_backfill"]["tampered"]["launches"],
        MERKLE_PATH: sha["launches"],
        LF_PERSIG + " cold": lf["schemes"]["per_sig"]["cold_launches"],
        LF_PERSIG: lf["schemes"]["per_sig"]["launches"],
        LF_COLD: lf["schemes"]["bls_aggregate"]["cold_launches"],
        LF_MAIN: lf["schemes"]["bls_aggregate"]["launches"],
        LF_REVERIFY: lf["verify_hop_proof"]["launches"],
        LF_REVERIFY + " flipped bit": lf["verify_hop_proof"]["tampered"]["launches"],
        LF_LUNATIC: lf["lunatic"]["launches"],
        SSF_WAVE: ssf["join_wave"]["launches"],
        SSF_PERSIG: ssf["backfill_ab"]["per_sig"]["launches"],
        SSF_DEEP: ssf["backfill_ab"]["per_sig_deep"]["launches"],
        SSF_BLS: ssf["backfill_ab"]["bls_aggregate"]["launches"],
        **_sharded_by_path(sharded),
        **_sidecar_by_path(vd, tx, ev),
        CI_MAIN: ci["wide"]["launches"],
        CI_TAMPERED: ci["tampered"]["launches"],
        CL_ED: cl["ed25519"]["launches"],
        CL_BLS: cl["bls_aggregate"]["launches"],
        NB_MAIN: nb["launches"],
        NB_TAMPERED: nb["tampered"]["launches"],
        NN_PATH: nn["launches"],
        **scn["launches"],
    }
    run["slice"]["launches_by_path"] = by_path
    run["slice"]["min_tpu_batch"] = cutoff["min_tpu_batch"]

    # a timed row for each (kernel, shape) of phases 17-18 that phase 14
    # did not time
    timed_shapes = {(r["name"], tuple(r["shape"])) for r in bls_rows}
    fleet_rows = []
    for (name, shape), rec in sorted(fleet_pairing.seen.items()):
        if (name, shape) in timed_shapes:
            continue
        path = next(iter(rec["calls"]))
        kernel = {k.name: k for k in (BP.MILLER, BP.FINAL_EXP)}[name]
        row = _pairing_row(dev, kernel, shape, rec["inputs"], path)
        row["launches"] = by_path[path][name]
        device_ms = ssf["backfill_ab"]["bls_aggregate"]["device_ms"][name] \
            if path == SSF_BLS else None
        row["main_path_device_ms"] = device_ms / row["launches"] if device_ms else None
        fleet_rows.append(row)
    print(json.dumps({"fleet_pairing_shapes": fleet_held,
                      "seconds": time.perf_counter() - t0}))

    held = audit_shapes(dev, audit, rows, (ED_MAIN, SR_MAIN, BS_MAIN, LC_MAIN, SSF_DEEP))
    for name in EDWARDS_KERNELS:
        paths = {p for rec in held.get(name, []) for p in rec["calls"]}
        if not {ED_MAIN, ED_TAMPERED, SR_MAIN, SR_TAMPERED, BS_MAIN, LC_MAIN,
                LC_TAMPERED, SSF_DEEP, *(_sh_path("kernel_eq", n) for n in SH_SHARDS),
                VD_PACKED, VD_TAMPERED, TX_CARD, CI_MAIN, CI_TAMPERED,
                NB_MAIN, NB_TAMPERED} <= paths:
            raise AssertionError(f"{name}: shapes recorded on {sorted(paths)} only")
    print(json.dumps({"shapes": held}))
    for row in rows:
        row["launches"] = run["launches"][row["name"]]
        row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()}
        row.setdefault("main_path_device_ms", bd["ported_kernels_device_ms"][row["name"]])
    for row in bls_rows:
        row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()}
        if row["path"] == BLS_MAIN:
            # the BLS slice's main run: the aggregate passes of phase 14,
            # whose device time the profiler took
            row["launches"] = bls["launches"][row["name"]]
            row["main_path_device_ms"] = (bls["verify_commit"]["device_ms"][row["name"]]
                                          / N_AB_COMMITS)
        else:
            # the per-signature pass's own run, counted from 0; it is not
            # profiled
            row["launches"] = by_path[row["path"]][row["name"]]
            row["main_path_device_ms"] = None
        rows.append(row)
    for row in sha_rows + fleet_rows:
        row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()}
        rows.append(row)
    # phase 19's new sizes: every B2 and B3 size, each path's largest B1
    t0 = time.perf_counter()
    n_rows = len(rows)
    _sharded_rows(dev, audit, rows, by_path)
    for row in rows[n_rows:]:
        row["launches_by_path"] = {path: n[row["name"]] for path, n in by_path.items()}
    print(json.dumps({"sharded_rows": len(rows) - n_rows, "seconds": time.perf_counter() - t0}))

    print(json.dumps({"slice": run["slice"]}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"script_wall_s": time.perf_counter() - t_start}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
