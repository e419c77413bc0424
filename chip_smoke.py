#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training, KGE (its grid and
its launcher included), state sharding, ring, GAT,
full-graph, RGCN and GIN paths, the numerics sentry, the serving
fleet, the chaos, preemption and live planes, and the data plane
(quantized and out-of-core books, bfloat16 compute, remat), then lint
the port.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
Each phase prints JSON lines:

1. ``device``  — the card's name, the count of cards, the nvidia-smi
   name and power limit, and the host CPU's name and core count; TF32
   is switched off for the whole run.
2. ``build``   — every ``dgl_operator_tpu_torch/csrc/*.cu`` built by
   nvcc for sm_90a, with ptxas' register and spill lines, the host
   graph core ``native/graphcore.cc`` built by the host C++ compiler,
   with its warnings, and the control plane's ``tpu-operator`` and
   ``tpu-watcher`` (``native/controlplane/``) with their seconds (all in
   parallel).
3. ``setup``   — a synthetic ogbn-products graph (cut to ``--scale``),
   a full-width DistSAGE (100 -> 256 -> 47, fanouts 10 and 25, seeded
   random weights) and its ``SampledTrainer`` (batch 1000, calibrated
   caps), and one sampled training batch whose shapes the kernel phase
   uses.
4. ``graph``   — the graph core against its plain numpy versions on
   that graph: ``build_csr`` identical; ``sample_fanout`` on one
   training batch's two frontiers identical on every seed of degree at
   most the fanout, distinct in-edges of the seed on every other row;
   ``compact_frontier`` identical uncapped and, capped, keeping the
   frontier prefix and sorted new ids with every kept slot resolving
   to its sampled id. Host times of each call and of one batch (library
   and plain), and batches per second of ``sample_pipeline`` with 1, 2
   and 4 sampler threads.
5. ``kernel``  — one line per kernel and shape: each hand-written
   kernel (``fanout_agg``, ``gather_rows``, ``scatter_add_rows``)
   against its plain torch version on the card (max abs error and
   tolerance), and the times of the kernel, the plain version and one
   PyTorch call that computes the same function (a yardstick the port
   never calls), each with the L2 cache flushed before every launch,
   beside the least time the card's HBM allows for the bytes the call
   must move. ``fanout_agg`` lines name the launch the kernel chose
   (TMA bulk copies or registers); ``scatter_add_rows`` lines, which
   sum over a host-built ``scatter_plan``, show that two launches give
   the same bits and whether they equal the CPU's ``index_add_``
   (``bitwise_equal_to_cpu``), including a hub target named by every
   row; ``gather_rows`` lines name the path it took (TMA bulk copies
   or registers and their access width), and untimed ``gather_rows``
   lines hold it bit for bit at each path's edges (1,600-byte rows at
   1, 1,023 and 1,024 rows, a hub, repeated rows, a table 8 bytes off a
   16-byte boundary, bf16 at D = 100, the attention's 8-, 4- and
   188-byte rows, a table of more than 2^31 elements). A
   ``floor`` line gives the same timers around a near-empty launch
   (``torch.cuda._sleep(1)``).
6. ``serve``   — the graph split in 2 parts by the port's multilevel
   partitioner (its seconds, edge cut, part sizes and halo rows), the
   model written as a serving export, a ``ServeEngine`` on the card
   answering ``--requests`` requests of 1 to 64 seeds through the
   ``MicroBatcher``, and the same fixed request run on the CPU engine
   for comparison.
7. ``train``   — one epoch of ``SampledTrainer.train`` over the first
   40,000 training ids (40 steps of 1000 seeds, dropout 0.5,
   evaluation at its end): losses, kernel launches per step, step
   times, the host time of a batch's sampling and of its scatter plans,
   and the device time of one step's forward, backward and Adam.
8. ``train_cpu`` — the same seeded weights with dropout 0 stepped on the
   card and on the CPU over the first 5 batches, the card taking the
   CPU's parameters and Adam state before every step: each step's loss
   within 1e-5 relative and each gradient within 1e-4 of its largest
   entry, every step's gradient gap reported.
9. ``resume`` — ``SampledTrainer`` with dropout 0 over an epoch of 10
   steps: a run with checkpoints every 5 steps is cut after 5, and a
   fresh trainer resumes it; its parameters and losses must equal an
   uninterrupted run's bit for bit (cuBLAS with a fixed workspace,
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``).
10. ``dist``  — ``DistTrainer`` at full width over the serving phase's
   2-part assignment, each part's train split cut to 20,000 ids (20
   steps an epoch; the weights drawn from ``--seed`` as the entry point
   draws them): the first 3 steps on the card and on the CPU, synced
   before each step as in phase 8 (``dist_cpu``); an epoch in the
   replicated layout and one in the owner layout (hot-halo cache of
   0.25 of the halo, the rest exchanged each step), whose losses must
   equal the replicated ones, each with its kernel launches per step,
   step times, host stall and dispatch, device time per step by CUDA
   events, bytes shipped and halo rows exchanged; ``evaluate`` on the
   card against the CPU's single-graph ``sage_inference`` of the same
   weights; ``kernel`` lines at the path's shapes (the exchange's
   gather over every slot's store among them); and a ``resume`` line as
   in phase 9, cut after 10 of the 20 steps.
11. ``dist_mp`` — the multi-process form on the same book and weights:
   (a) the single-process ``DistTrainer`` at sampler widths 1 and 2 in
   the order 1, 2, 2, 1, each layout: identical batch streams and
   losses, step, stall and seeds/s per width; (b) an in-process NCCL
   group of world size 1, both parts on rank 0: each layout's epoch
   equal to phase 10's bit for bit (losses, parameters, ``evaluate``),
   with its launches and the µs of the gradient ``all_reduce`` and the
   two exchange ``all_to_all_single`` calls at the owner step's shapes;
   the group is destroyed after; (c) two processes through the entry
   point ``examples/train_dist.py`` on the card over gloo (NCCL refuses
   two ranks on one card), one part each, from a 2-line hostfile: equal
   losses on both ranks, within 1e-6 relative of (b)'s at every step,
   with each rank's launches and, in a second gloo group after the
   run, the µs of the step's three collectives on CUDA tensors of the
   owner step's shapes; a rank that fails or hangs past 300 s
   fails the run; (d) a ``kernel`` line of ``gather_rows`` at the
   two-rank owner-serve shape.

12. ``device_sampler`` — the device sampler and ``steps_per_call``:
   the card's draws, tree blocks (1,000 seeds, fanouts 10 and 25: caps
   1,000, 26,000, 286,000), input ids and device-built tree plans equal
   to the CPU's bit for bit, with the sampling's host and device ms;
   ``kernel`` lines at the tree's shapes (``tree_feats``,
   ``tree_block0``, ``tree_block1``, ``tree_block1_bwd`` over the
   device-built plan); ``SampledTrainer`` with the device sampler over
   the train phase's 40 steps at K = 1 and at K = 4 (a CUDA graph
   replay a call), dropout 0.5, losses and parameters bit-equal,
   launches per step (1 gather, 2 fanout, 1 scatter, graph replays
   included), step, sample and dispatch ms and seeds/s; 5 device-sampler
   steps against the CPU, synced as in phase 8; ``profile`` lines
   (``torch.profiler`` over 5 calls) of the host sampler at K = 1 and
   the device sampler at K = 1 and K = 4: wall ms, device µs, launches
   per step by kernel, the device's idle share, the host's top ops;
   ``DistTrainer`` with the device sampler over phase 10's book and
   weights, each layout at K = 1 and K = 4, all bit-equal; the same at
   K = 4 under an in-process NCCL group of world size 1 (captured); two
   ranks through ``examples/train_dist.py --sampler device`` over gloo
   (owner layout) within 1e-6 relative of one process; and a resume at
   K = 2 cut after 10 of 20 steps, bit-exact.

13. ``kge`` — the DGL-KE slice at the reference job's width (ComplEx,
   dim 400, gamma 143, lr 0.25, batch 1024, 256 negatives shared by the
   batch, ``-adv`` at temperature 1) on synthetic FB15k at full size
   (14,951 entities, 1,345 relations, 483,142 train triples):
   ``KGETrainer`` for 200 steps (a depth cut of the job's 1000), its
   launches checked against 2 gathers and 2 scatters a step, with step
   time, stall, dispatch, steps/s, triples/s, H2D bytes and the device
   time of single updates; ``kernel`` lines of ``gather_rows`` (the
   entity and relation lookups) and ``scatter_add_rows`` (the entity and
   relation pushes, the relation push's long targets on the second
   launch) at the step's shapes; a ``profile`` line from
   ``torch.profiler`` over 5 more steps (device µs and launches per
   step of each kernel, the relation push's two launches apart, the
   host µs of the 10 CPU ops with the most self time); 5 steps against
   the CPU, synced before
   each; every scorer's loss and row gradients against the CPU on one
   batch of each side (RESCAL and TransR at dim 100); ``DistKGETrainer``
   over the 2-part book that ``examples/partition_kg.py`` writes, 50
   steps: both slots in one process, under an in-process NCCL group of
   world size 1 and as two ranks through ``examples/train_kge.py`` on
   ``cuda:0`` over gloo (with ``--eval``), all bit-equal, with the µs of
   the step's collectives; a run cut after 25 of the 50 steps and
   resumed, bit-exact; ``full_ranking_eval`` and
   ``sharded_ranking_eval`` raw and filtered on 500 test triples against
   each other and the CPU.
13a. ``kge_grid`` — ``DistKGETrainer`` at the job's width on 4 slots
   over synthetic FB15k cut into 4 ranks: a 2 x 2 grid
   (``make_mesh_2d``) against a 1-D mesh of 4 slots, 20 steps on the
   same batches (loss within 2e-4 relative, tables within 2e-5;
   ``grid_vs_line``, with launches a step: 2 gathers, 5 scatters); 3
   updates of the grid on the card and the CPU, synced
   (``grid_cpu``); device negatives (``device_negatives``): the
   counter-hash draws of 6 ``(seed_u, slot)`` keys bit-equal card and
   CPU, 50 steps twice bit-equal, one update with
   ``torch.cuda.set_sync_debug_mode`` reporting no host sync, 3 synced
   updates against the CPU; two clients a slot (``clients``: 2 steps,
   4 updates, card against CPU, then 20 steps on the card timed);
   ``step_ms`` of the grid with host and device negatives, with two
   clients a slot and of 1-D, in one call; ``kernel`` lines
   ``kge_grid_entity``, ``kge_grid_relation``, ``kge_grid_entity_push``
   (the host plan of 9,216 ids), ``kge_device_entity`` and
   ``kge_device_entity_push`` (the device-drawn ids and the plan built
   on the card; its bound counts the distinct rows, its padded targets'
   bytes are ``padding_bytes``).
13b. ``kgejob`` — ``launcher/tpukerun.py`` in this process with a
   one-entry hostfile over ``LocalFabric``: phases 1-2 run the port's
   ``partition_kg.py`` by path on FB15k, phases 3-5 dispatch, revise
   and start ``train_kge.py --num_dp 2 --num_mp 2 --neg_sampler
   device`` on the card for 100 steps, under a chaos plan whose one
   ``exec`` fault the retry layer absorbs; the saved tables' shapes and
   the child's summary (its card, updates and launches) are checked,
   and the same driver run again skips all three phases by its ledger.
   The driver runs under ``obs_run``: the chaos fault and the retry are
   read from the run's ``events.jsonl``, and a ``kgejob_obs`` line
   checks the collected ``obs/job/`` view (the driver's phases 3-5, the
   child's sentry records and its process's metrics).
13c. ``obs`` — the obs file and job planes: ``obsjob`` runs ``tpurun``
   phases 3-5 over ``LocalFabric`` under ``obs_run`` (phase 10's 2-part
   book, two local hostfile entries since the launcher starts one
   process a partition; rank 0 trains both parts) with
   ``examples/train_dist.py`` started by path through a child wrapper
   at full width (device sampler, owner layout, one epoch of 20 steps),
   then ``collect_obs``: ``obs/job/`` holds one ``heartbeat`` a call
   and the ``train_done``, the epoch span, the phase histograms,
   ``prof_peak_flops`` equal to the peak table's H100 float32 entry,
   ``0 < train_mfu <= 1`` from the counted cost, compiles and none
   ``steady``, the comm ledger's ops; ``python -m
   dgl_operator_tpu_torch.obs.doctor`` exits 0, the critical-path
   fractions sum to 1, ``prof_summary`` has the pinned keys and the
   child launched all three kernels. ``overhead`` times
   ``SampledTrainer`` (device sampler, K = 4, 40 steps) with an obs
   directory and without, off, on, on, off, bit-equal.
13d. ``tune`` — the knob search on the card: ``successive_halving``
   (n0 4, eta 2, 8 base steps, seed 0) over ``num_samplers`` (0, 2) and
   ``feats_layout`` (replicated, owner), every probe a ``python -m
   dgl_operator_tpu_torch.autotune.probe`` child training ``DistTrainer``
   (``DistSAGE`` hidden 16, batch 1000, fanouts 10,25) on a 2-part book
   whose parts train 8 steps an epoch, scored from its obs files: the
   rung schedule is ``rung_schedule(4, 8, 2)`` (7 probes), every
   probe's record is ok with steps, a relaunch over the ledger runs no
   probe, and the winner's manifest round-trips through
   ``write_manifest``, ``load_manifest`` and ``apply_tuned``. The line
   holds each rung's scores, the winner, each probe's seconds.
13e. ``elastic`` — ``tpurun --elastic`` over ``LocalFabric`` with two
   local hostfile entries: one child a partition (rank = partition), an
   independent full-width ``SampledTrainer`` (device sampler, batch
   1000, 2 epochs of 4 steps, a checkpoint every 2 steps, seed 100 +
   part), chaos ``host:die:5`` on the second host. The driver shrinks
   to the survivor (``elastic.json`` width 1, epoch 1, the fence epoch
   in the relaunched children), and each partition's final parameter
   digest and steps equal the undisturbed run's, taken in this process;
   the readmitted host then regrows the plan (full width, epoch 2). The
   line holds the driver's and the relaunch's seconds and the
   children's launches.
13f. ``controlplane`` — a ``FakeCluster`` job through Partitioning,
   Partitioned, Training and Completed on the port's reconciler, the
   watcher barrier once over the rendered partfile, and a job whose
   health feed is the ``elastic`` phase's job view: the controller
   fails its launcher with reason ``HostDead`` and names the dead host.
13g. ``shard`` — state sharding (``parallel/dp.py::ShardPlan``) through
   ``DistTrainer`` SAGE at full width over the products graph split in
   4 parts (the serving phase's 2-part assignment halved by node id
   parity), each part's train split cut to 8 steps, replicated layout,
   host sampler: ``shard_update``, ``shard_rules`` on stage 1,
   ``zero_stage=3`` with ``gather_depth`` 1 and 4, each bit-equal to
   the replicated run (losses, weights, the logical Adam state;
   ``max_abs_diff`` 0), and ``zero_stage=3, tp_axis_size=2`` with the
   kernels in blocks over ``mp`` on a 2 x 2 mesh bit-equal to the
   replicated run on its 2 dp slots; each run's launches, the byte
   model's ``sharding_summary`` beside the measured MiB of each slot's
   state tensors; the stage-3 checkpoint written at 4 slots restored
   bit for bit into the 2 x 2 trainer and into a replicated one at 2
   slots; two gloo ranks on the card with ``shard_update`` (each rank's
   optimizer-state bytes on the card against the replicated trainer's);
   and the KGE grid (2 x 2, the KGE job's width) with relation
   ``shard_rules`` bit-equal to the unsharded grid.
13h. ``ring`` — ``ring_lookup`` and ``ring_push_adagrad`` on 4 shards at
   the KGE job's batch and width against ``sharded_lookup`` (bit for
   bit) and ``sharded_push_adagrad`` (within 1e-6), with each form's
   peak device memory; ``ring_dot_attention`` and ``ring_gat_attention``
   on 4 shards against their dense forms (within 1e-5), with the dense
   and ring milliseconds at three lengths and the measured crossover
   written for ``use_ring`` (``parallel/ring_attention.py``);
   ``gat_hub_attention`` on the products graph's highest-degree nodes,
   bucketed by ``bucket_by_degree``, at the GAT phase's first-layer
   width, against the full-graph ``GATConv`` layer over their in-edges
   (within 1e-4), with the ring's and the one-shard dense form's peak
   bytes.

14. ``gat`` — ``DistGAT`` and ``DistGATv2`` at the entry point's width
   (2 heads of 256 concatenated, then one head of 47; fanouts 10 and 25,
   batch 1000) on phase 3's graph: each stack's logits of one batch on
   the card within 1e-4 of the largest CPU logit, then 3 steps synced
   against the CPU as in phase 8, twice from the same state: each side
   on its own LeakyReLU branches (gradients within 1e-2 of their
   largest entry, the bound ``leaky_branch_probe.py`` sets), then the
   CPU on the card's branches (:class:`Branches`; phase 8's limits, at
   most 8 inputs whose own branch differs); ``SampledTrainer`` with
   each stack over the train phase's 40 steps (dropout 0.5): the host
   sampler (evaluation by ``gat_inference`` on the card), the device
   sampler at K = 1 and K = 4 (bit-equal), launches per step (GAT: 5
   gathers and 3 scatters; GATv2: 3 and 2), peak device memory; a
   ``profile`` line of each stack at K = 4; ``kernel`` lines of
   ``gather_rows`` and ``scatter_add_rows`` at the attention's shapes
   on one tree batch (``gat_x_block0``: 260,000 ids of 400-byte rows;
   ``gat_el_block0``: 8-byte rows; ``gatv2_fs_block0``: 2 KB rows;
   ``gat_x_block1``: 25,000 ids of 2 KB rows; ``gat_el_block1``: 4-byte
   rows; ``gatv2_fs_block1``: 188-byte rows; and the backward of each
   whose table needs a gradient, over the per-slot plans);
   ``DistTrainer`` with ``DistGAT`` over phase 10's book, 20 steps in
   each layout (equal losses), ``evaluate`` against the CPU's
   single-graph ``gat_inference`` and that inference on the card (its
   logits, its peak memory beside the 12.3 GB ``[E, H * D]`` table it
   does not build), and a bit-exact resume; ``DistTrainer`` with
   ``DistGATv2`` and the device sampler (replicated K = 1 and K = 4,
   owner K = 4, bit-equal); a ``ServeEngine`` serving ``DistGAT`` from
   a flax export (8 requests, then one request against the CPU
   engine); and ``train_full_graph`` through
   ``examples/node_classification.py`` with GCN and GAT on the
   synthetic Cora, 20 epochs, twice on the card and twice on the CPU:
   each pair bit-equal in every loss and final parameter, the card's
   launches per epoch checked, the first 3 epochs against the CPU, and
   the 20-epoch gap beside a float64 CPU run's.

15. ``message_passing`` — the full-graph message-passing vocabulary
   and link prediction, each run twice on the card (bit-equal, launches
   per epoch checked) and once on the CPU (3 epochs within 1e-4):
   ``examples/message_passing.py`` plain and ``--weighted`` (20 epochs
   on Cora), ``examples/link_predict.py`` with the dot and the MLP
   predictor (100 epochs, the AUC on both sides within 0.01 and at
   least 0.8); ``examples/graphsage.py`` for one epoch at ``--scale``
   on the card (launches per step); pool ``sage_inference`` at full
   width over phase 3's graph against the CPU, its launches (a gather a
   destination chunk) and peak memory, and ``DistTrainer.evaluate``
   with pool over phase 10's book against it; ``kernel`` lines of
   ``gather_rows`` and ``scatter_add_rows`` at the full-graph Cora
   shapes (``cora_gather16``, ``cora_segment_sum``).

16. ``rgcn_gin`` — RGCN link prediction, GIN graph classification and
   the sampled pool aggregator: ``examples/link_predict_rgcn.py`` at its
   defaults (60 epochs, hidden 32, 8 bases) on the full-size synthetic
   FB15k twice on the card (losses, AUC and parameters bit-equal,
   launches per epoch checked, epoch ms, the peak device memory above
   the call's start below the JAX layer's 1.98 GB ``[E, I, O]``
   table), 2 epochs from one set of carried weights on the card and on
   the CPU in float64, synced as in phase 8 (each loss within 1e-5
   relative, every gradient and the pre-sigmoid scores within 1e-4 of
   their largest entry), and 10 epochs of the same library run on the
   synthetic FB15k-237 (14,541 entities, 237 relations, 272,115 train triples);
   ``examples/graph_classification.py`` at its defaults twice on the
   card (bit-equal, launches) and once on the CPU (all 140 steps within
   1e-4 relative, each side's test accuracy); a pool ``DistSAGE`` at
   the SAGE widths from one set of weights against the CPU (3 steps
   each of the host sampler, the device sampler and ``DistTrainer``,
   synced as in phase 8), then ``SampledTrainer`` for 20 steps with
   the host sampler and with the device sampler at K = 4 (5 calls), and
   ``DistTrainer`` for an epoch of phase 10's book, each twice, and the
   device sampler at K = 1 once, all bit-equal, launches per step
   checked (the pool's slots gathered by ``gather_rows``, no
   ``fanout_agg``), step ms, the host sampler's per-slot plan ms; and
   ``kernel`` lines at the RGCN's shapes (``rgcn_hb_src`` 483,142 ids
   of 1 KB rows and ``_bwd``,
   ``rgcn_coef_etype`` 32-byte rows and ``_bwd`` into 1,345 targets,
   ``rgcn_segment_mean`` 128-byte rows into 14,952 segments,
   ``rgcn_distmult_head``, ``rgcn_distmult_rel`` and ``_bwd``) and the
   pool's block 0 (``pool_block0``, 400-byte rows, and ``_bwd`` over
   the per-slot plan).

17. ``sentry`` — the numerics sentry (``obs/quality.py``) on the full
   width DistSAGE: ``SampledTrainer`` over the train phase's 40 steps
   with the sentry off and on (order off, on, on, off) for the host
   sampler at K = 1 and the device sampler at K = 1 and K = 4
   (captured): losses and parameters bit-equal, launches per run
   checked, the steady ms a step of each side and the overhead, the
   last call's stats; phase 10's ``DistTrainer`` epoch in both layouts
   off and on, bit-equal and equal to phase 10's losses, each slot's
   loss and non-finite count; one step's stats on the card against the
   CPU's from the same weights and batch (within 1e-5 relative); and
   the fault drill: the feature rows of 3 train nodes that the first 2
   batches do not read set to NaN, the card and the CPU (host sampler,
   same seed) raise ``NumericsFault`` at the same global step; the
   card's run, checkpointing every step under a fence of epoch 1
   (``TPU_OPERATOR_ELASTIC_EPOCH``), has every checkpoint at or past
   the fault quarantined, and a trainer over the clean rows resumes
   from the survivor and completes the epoch.

18. ``fleet`` — two ``ServingPlane`` replicas on the card (HTTP
   servers over a ``ServeEngine`` each, the serve phase's 2-part book,
   the train phase's weights; named so that the ring gives each one
   partition) behind a ``RouterPlane``: the serve
   phase's ``--requests`` requests of 1 to 64 seeds through HTTP to the
   router (p50/p99 beside the serve phase's direct batcher numbers), a
   fixed request's reply equal to its replica's ``predict`` at the same
   sample seed, ``/healthz``, ``/metrics`` and ``/livez``; a canary
   (``CanaryController`` over ``ServingPromotion``): a NaN-filled
   candidate rolled back on the engine's non-finite logits with the
   fence and the incumbent untouched, then the trained weights promoted
   to both replicas at fence epoch 1; and partition 0's replica killed
   under 4 concurrent clients: every request answered, the replica
   drained, ``fleet_replicas_up`` 1. The chaos plan drives both drills:
   ``promote:bad`` poisons the first candidate after its checksum, and
   ``replica:die:3`` kills a spare plane of the victim's name, built
   under the plan and swapped into the ring, at its third request.

19. ``chaos`` — the chaos, preemption and live planes on phase 3's
   graph and widths (``TPU_OPERATOR_CHAOS`` plans set around each run):
   ``train:kill`` on ``SampledTrainer`` with the device sampler at
   K = 4 (captured, dropout 0) over 20 steps: the flush at step 8, a
   fresh trainer resuming there and ending bit-equal to the
   uninterrupted run; ``DistTrainer`` (owner layout, host sampler,
   sampler width 2) killed mid-epoch with no sampler, exchange, writer
   or comm-watcher thread left; ``numerics:nan`` at K = 4: the card faulting at
   the CPU's step and partition, the checkpoints at or past it
   quarantined, a relaunch on the same workspace not poisoned again and
   finishing; ``ckpt:corrupt`` (the restore falls back past the stomped
   archive); ``step:slow:0.05`` (the stall phase grows by the drag a
   call); ``host:die`` in a child process on the card (exit 113, the
   dead-host marker, no checkpoint past the last periodic one; with an
   obs directory, its ``flight-<pid>.json`` of reason ``host_died``
   holding the heartbeats up to the death, the ``flight`` line); the
   live sidecar (``TPU_OPERATOR_LIVE_PORT=0``) polled from a thread
   during a 40-step run and read done after it; the KGE sentry
   (``KGETrainer`` on synthetic FB15k at the job's width, 50 steps with
   the sentry off, on, on, off: bit-equal, its overhead in ms a step;
   one step's stats against the CPU's within 1e-5 relative; a NaN
   entity row faulting the card at the CPU's step); and the owner
   layout's exchange pipeline (``DistTrainer``, host sampler, phase
   10's book: synchronous, ``staged``, ``fused`` at K = 1 and 2, 20
   steps each, bit-equal, launches checked, each run's step time and
   ``overlap_ratio``).

20. ``dataplane`` — quantized and out-of-core books, bfloat16 compute
   and remat on phase 3's graph and widths: ``book`` (the graph written
   again by ``partition_graph(ooc=True, ooc_budget_mb=64,
   feat_dtype="int8")``: maps, every ``graph.npz`` array, labels, masks
   and JSON byte-equal to phase 6's book; the spill MiB, both
   partitions' seconds, the code files' bytes against the float32
   features'); ``train`` (``DistTrainer`` on an int8 book of phase 10's
   cut: the owner layout with the host sampler and with the device
   sampler at K = 4, an int8 store against a float32 store of the
   host-dequantized codes, bit-equal; the replicated layout on int8; a
   bfloat16 store; each run's store MiB a slot, exchange bytes a step
   and step ms; the int8 losses within 10% of phase 10's float32
   owner run); ``kernel`` lines of ``gather_rows`` on the int8 stores
   (the slot inputs, the owner's local rows, the exchange, a D = 602
   table; untimed uint8, D = 37 and D = 1,024 edges), bit for bit;
   ``serve`` (``ServeEngine`` on the int8 book: phase 6's requests,
   logits bit-equal to an engine on a float32 book of the dequantized
   codes, p50 and p99, the stores' MiB and rows paged); ``bf16``
   (``DistSAGE`` and ``DistGAT`` with ``compute_dtype="bfloat16"``:
   one batch's logits within 4 · 2 layers · 2^-8 of the float32
   logits' largest, 16 ``SampledTrainer`` steps host and device K = 4
   beside float32 from the same weights, the loss falling, then
   ``examples/train_dist.py --bf16`` over phase 10's book);
   ``remat`` (one step's loss and gradients bit-equal to the plain
   stack's; host K = 1 and device K = 4 runs bit-equal, the peak device
   memory and steady ms of each).

21. ``lint`` — the port's lint, ``python3 -m
   dgl_operator_tpu_torch.analysis --json`` in a child over the
   package and this script against the committed empty baseline: rc 0,
   no finding, no unparsable file, more than 100 files checked; the
   line gives the files, the counts (the two reasoned suppressions
   among them) and the seconds.

Then a ``{"kernels": [...]}`` line (one entry per hand-written kernel:
launches during the serving, training, dist, dist_mp, device_sampler,
kge, kge_grid, kgejob (the child's own count), obs (the obsjob
child's and the overhead runs'), tune (the probes' own counts),
elastic (the children's own counts), shard (the gloo ranks' own
counts included), ring, gat, message_passing,
rgcn_gin, sentry, fleet, chaos and dataplane phases
(both ranks of each
two-rank run and every graph replay included), split by path, worst
error, the times of its calls in one SAGE training step and, under
``kge``, in one KGE step, under ``device_sampler``, in one
device-sampled step, under ``gat`` and ``gatv2``, in one device-sampled
step of that stack, under ``full_graph``, in one edge gather or
segment sum of the Cora loop, under ``rgcn_gin``, in one call at
each RGCN and pool shape, under ``dataplane``, in one call at the
int8 slot-input and exchange shapes and, under ``kge_grid`` and
``kge_device``, in one grid update's entity lookup and push;
``tree_sample``'s entry: its launches on every path that samples on the
card, with the device-sampled step's one call at the trainer's shapes;
the kgejob, obsjob, KGE and shard children and the knob search's probes
count the other three kernels only), a ``total`` line with the run's seconds, the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``. Any failed check exits nonzero
before that last line is printed; without a CUDA card the script exits
1 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import platform
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

REPO = os.path.dirname(os.path.abspath(__file__))

# the port's peak table (H100 SXM data sheet), which the MFU gauge reads
# too: loaded by path, so that a timer of another checkout's kernels
# (kernel_ab.py) takes this one's
PEAKS_FILE = os.path.join(REPO, "dgl_operator_tpu_torch", "obs", "peaks.py")
L2_FLUSH_BYTES = 256 << 20      # > the 50 MB L2
# a spin kernel (~0.5 ms) that keeps the card busy while the host runs a
# wrapper's Python and enqueues its launch, so that timing events
# bracket device work only
SPIN_CYCLES = 1_000_000
FEAT, HIDDEN, CLASSES = 100, 256, 47
FANOUTS = (10, 25)
BATCH = 64             # serving: seeds per forward
BATCH_TRAIN = 1000     # training: seeds per step
TRAIN_IDS = 40_000     # the train phase's epoch: 40 steps (a depth cut)
LR = 0.003
CPU_STEPS = 5          # steps of the card-against-CPU comparison
SAMPLED_RESUME_AT = 5  # SampledTrainer resume: cut after 5 of 10 steps
# the dist phase's epoch: each part's first 20,000 train ids, 20 steps
# (a depth cut); its resume check cuts the run after 10 of them
DIST_IDS_PER_PART = 20_000
DIST_CPU_STEPS = 3     # dist steps of the card-against-CPU comparison


# the last record printed by each phase
LAST = {}
# the script's start, for the whole run's seconds
T_START = time.perf_counter()


def emit(**record) -> None:
    if "phase" in record:
        LAST[record["phase"]] = record
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def host_cpu() -> str:
    """The host CPU's model name from ``/proc/cpuinfo``; where that
    reads "unknown" (as in some virtual machines), its vendor, family, model
    and stepping instead."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break           # the first processor's block
                key, _, value = line.partition(":")
                fields[key.strip()] = value.strip()
    except OSError:
        pass
    name = fields.get("model name", "")
    if name and name != "unknown":
        return name
    if "vendor_id" in fields:
        return (f"{fields['vendor_id']} family {fields.get('cpu family')} "
                f"model {fields.get('model')} stepping "
                f"{fields.get('stepping')} (model name {name or 'absent'})")
    return platform.processor() or platform.machine()


def host_ms(fn, repeats: int) -> float:
    """Median host wall time of ``fn`` over ``repeats`` calls, in ms."""
    times = []
    for _ in range(repeats):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return float(sorted(times)[len(times) // 2])


def time_cold_ms(torch, fn, flush, iters: int, clean: bool = False
                 ) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, with the L2
    cache evicted before each, by CUDA events; a spin kernel after the
    flush covers the host's time in ``fn``. The flush writes ``flush``,
    which leaves the L2 full of dirty lines that ``fn``'s own traffic
    must write back to HBM; ``clean`` reads it instead."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if clean:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def time_warm_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches with its
    inputs left in L2 by the previous launch (when they fit). A spin
    kernel before each keeps the card busy while the host enqueues, so
    the events bracket the kernel and not the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


@functools.lru_cache(maxsize=None)
def card_peaks() -> Tuple[float, float]:
    """HBM bytes/s and float32 (CUDA-core) operations/s of the H100, from
    the port's peak table."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("port_peaks", PEAKS_FILE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.H100_PEAKS["hbm_gbps"] * 1e9, mod.H100_PEAKS["fp32"]


def bound_ms(nbytes: int, ops: int):
    """The least time for a call: the larger of its bytes over HBM
    bandwidth and its operations over the float32 rate."""
    hbm_bytes_per_s, fp32_ops_per_s = card_peaks()
    t_bytes = nbytes / hbm_bytes_per_s * 1e3
    t_ops = ops / fp32_ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def fanout_bound(nbr, mask, d: int, itemsize: int):
    """One aggregation call must read each distinct valid source row
    once, write the output once and read nbr and mask once; it adds
    each valid row. Counts what this data needs."""
    nd, f = nbr.shape
    valid = mask > 0
    uniq = int(nbr[valid].unique().numel()) if nd else 0
    nbytes = uniq * d * itemsize + nd * d * itemsize + nd * f * 5
    return (*bound_ms(nbytes, int(valid.sum()) * d), uniq, nbytes)


def gather_bound(idx, d: int, itemsize: int):
    """A gather must read each distinct row once, write the output once
    and read idx once; it does no arithmetic."""
    m = idx.numel()
    uniq = int(idx.unique().numel()) if m else 0
    nbytes = (uniq + m) * d * itemsize + m * idx.element_size()
    return (*bound_ms(nbytes, 0), uniq, nbytes)


def scatter_bound(idx, mask, n: int, d: int, itemsize: int,
                  padded: bool = False):
    """A scatter-add must write the [n, d] float32 output once and read
    g, idx and mask once; it adds (and divides) each valid slot's row.
    The kernel reads the plan, the same table transposed, instead of
    idx and mask (its bytes are reported apart). Where the plan's
    targets are ``padded`` past the distinct ids (a plan built on the
    device), the function needs only the distinct rows written."""
    nd, f = idx.shape
    valid = (mask > 0) if mask is not None else idx >= 0
    uniq = int(idx[valid].unique().numel()) if nd else 0
    nbytes = ((uniq if padded else n) * d * 4 + nd * d * itemsize
              + nd * f * (idx.element_size() + (mask is not None)))
    return (*bound_ms(nbytes, int(valid.sum()) * d + nd * d), uniq, nbytes)


def time_record(torch, flush, iters: int, kernel, plain, library):
    """Cold (L2 flushed by a write, as the earlier runs timed; and by a
    read), and warm kernel times, the plain version's and the library
    yardstick's cold times, in ms."""
    return dict(
        ms=time_cold_ms(torch, kernel, flush, iters),
        clean_ms=time_cold_ms(torch, kernel, flush, iters, clean=True),
        warm_ms=time_warm_ms(torch, kernel, iters),
        plain_ms=time_cold_ms(torch, plain, flush, iters),
        library_ms=time_cold_ms(torch, library, flush, iters))


def err_of(got, want) -> Tuple[float, float]:
    """Max abs error of ``got`` against ``want`` and max |want| (at
    least 1), in float32."""
    if got.numel() == 0:
        return 0.0, 1.0
    err = float((got.float() - want.float()).abs().max())
    return err, max(1.0, float(want.float().abs().max()))


def launch_path(h) -> str:
    """The path ``csrc/fanout_agg.cu`` takes for ``h``: TMA bulk copies
    for rows of at least 512 bytes, a multiple of 16, at a 16-byte
    aligned address; registers otherwise."""
    row = h.shape[1] * h.element_size()
    return ("bulk" if row >= 512 and row % 16 == 0 and h.data_ptr() % 16 == 0
            else "registers")


def gather_path(table) -> str:
    """The path ``csrc/gather_rows.cu`` takes for ``table`` (its output
    is 16-byte aligned): TMA bulk copies for rows of at least 512 bytes,
    a multiple of 16, at a 16-byte aligned address; registers otherwise,
    with the widest access (16, 8, 4, 2 or 1 bytes) that the row and the
    address allow."""
    row = table.shape[1] * table.element_size()
    addr = table.data_ptr()
    if row >= 512 and row % 16 == 0 and addr % 16 == 0:
        return "bulk"
    width = next(w for w in (16, 8, 4, 2, 1)
                 if row % w == 0 and addr % w == 0)
    return f"registers{width}"


def floor_record(torch, flush, iters: int, card: str) -> None:
    """The timers' floor: ``time_cold_ms`` and ``time_warm_ms`` of one
    near-empty launch (``torch.cuda._sleep(1)``) under the same flush
    and spin as every kernel line. Measured only; no check subtracts
    it."""
    def launch():
        torch.cuda._sleep(1)
    emit(phase="kernel", kernel="floor", what="torch.cuda._sleep(1)",
         card=card, time_cold_ms=time_cold_ms(torch, launch, flush, iters),
         time_warm_ms=time_warm_ms(torch, launch, iters))


def fanout_records(torch, fanout, cases, flush, iters: int, card: str):
    """``fanout_agg`` against its plain version (sum and mean) on each
    case, timed for the mean, with ``F.embedding_bag`` as the
    yardstick."""
    import torch.nn.functional as F

    records = []
    for name, h, nbr, mask in cases:
        n, d = h.shape
        nd, f = nbr.shape
        rec = {"phase": "kernel", "kernel": "fanout_agg", "shape": name,
               "n": n, "nd": nd, "f": f, "d": d,
               "dtype": str(h.dtype).replace("torch.", ""), "card": card,
               "launch": launch_path(h)}
        worst = 0.0
        for mean in (False, True):
            before = fanout.fanout_agg.launches
            got = fanout.fanout_agg(h, nbr, mask, mean)
            torch.cuda.synchronize()
            check(fanout.fanout_agg.launches == before + (1 if nd else 0),
                  f"{name}: one launch per call with rows, none without")
            want = fanout.fanout_agg_plain(h, nbr, mask, mean)
            check(got.shape == want.shape == (nd, d) and
                  got.dtype == h.dtype, f"{name}: output shape and dtype")
            err, scale = err_of(got, want)
            # f32: the same fp32 terms summed in another order; bf16:
            # both round one fp32 sum, which may land either side of a
            # tie — one bf16 step (2^-7 relative) at the largest value
            tol = (1e-5 if h.dtype == torch.float32 else 2 ** -7) * scale
            check(err <= tol, f"{name} {rec['dtype']} mean={mean}: "
                  f"max abs err {err} > {tol}")
            if not (mask > 0).any():
                check(not got.any(), f"{name}: all-masked rows give 0")
            worst = max(worst, err)
        rec.update(max_abs_err=worst, tol_scale=scale)
        if nd:
            b_ms, b_by, uniq, nbytes = fanout_bound(nbr, mask, d,
                                                    h.element_size())
            pad = torch.where(mask > 0, nbr, torch.full_like(nbr, n)).long()
            table = torch.cat([h, torch.zeros(1, d, device="cuda",
                                              dtype=h.dtype)])
            lib = F.embedding_bag(pad, table, mode="mean", padding_idx=n)
            rec.update(
                **time_record(
                    torch, flush, iters,
                    lambda: fanout.fanout_agg(h, nbr, mask, True),
                    lambda: fanout.fanout_agg_plain(h, nbr, mask, True),
                    lambda: F.embedding_bag(pad, table, mode="mean",
                                            padding_idx=n)),
                library_max_abs_err=err_of(lib, fanout.fanout_agg_plain(
                    h, nbr, mask, True))[0],
                bound_ms=b_ms, bound_by=b_by, unique_rows=uniq,
                bytes=nbytes)
        records.append(rec)
        emit(**rec)
    return records


def gather_records(torch, gather, cases, flush, iters: int, card: str,
                   timed: bool = True):
    """``gather_rows`` against its plain version (a copy: exact) on each
    case, with ``torch.index_select`` as the yardstick; ``timed=False``
    checks without timing."""
    records = []
    for name, table, idx in cases:
        n, d = table.shape
        m = idx.numel()
        rec = {"phase": "kernel", "kernel": "gather_rows", "shape": name,
               "n": n, "m": m, "d": d,
               "dtype": str(table.dtype).replace("torch.", ""),
               "idx_dtype": str(idx.dtype).replace("torch.", ""),
               "card": card, "path": gather_path(table)}
        before = gather.gather_rows.launches
        got = gather.gather_rows(table, idx)
        torch.cuda.synchronize()
        check(gather.gather_rows.launches == before + (1 if m else 0),
              f"{name}: one gather launch with rows, none without")
        want = gather.gather_rows_plain(table, idx)
        check(got.shape == (m, d) and got.dtype == table.dtype,
              f"{name}: gather shape and dtype")
        err, _ = err_of(got, want)
        check(torch.equal(got, want), f"{name}: gather is a copy, "
              f"max abs err {err}")
        rec.update(max_abs_err=err, tol=0.0)
        if m and timed:
            b_ms, b_by, uniq, nbytes = gather_bound(idx, d,
                                                    table.element_size())
            rec.update(
                **time_record(
                    torch, flush, iters,
                    lambda: gather.gather_rows(table, idx),
                    lambda: gather.gather_rows_plain(table, idx),
                    lambda: torch.index_select(table, 0, idx)),
                bound_ms=b_ms, bound_by=b_by, unique_rows=uniq,
                bytes=nbytes)
        records.append(rec)
        emit(**rec)
    return records


def scatter_records(torch, scatter, cases, flush, iters: int, card: str,
                    padded=frozenset()):
    """``scatter_add_rows`` over its plan against its plain version on
    each case (the backward of an aggregation, or of a gather when
    ``mask`` is None), run on the CPU in float64: the float32 plain
    version on the card adds by atomics in no fixed order, and over a
    target of 84,500 entries its own rounding reaches the 1e-5 × max
    limit. Two launches must give the same bits, and the line says
    whether they equal the CPU's sequential float32 ``index_add_``.
    The backward of ``F.embedding_bag`` (or ``index_add_`` for the
    gather's) is the yardstick. The cases named in ``padded`` have a
    plan whose targets are padded past the distinct ids: their bound
    counts the distinct rows, and the line gives the padded rows' bytes
    as ``padding_bytes``."""
    import torch.nn.functional as F

    records = []
    for name, g, idx, mask, n, mean, plan in cases:
        nd, f = idx.shape
        d = g.shape[1]
        plan_ms = None       # the sampler's plan: built in its thread
        if plan is None:     # built here, from the host copy of the table
            t0 = time.perf_counter()
            plan = scatter.scatter_plan(
                idx.cpu().numpy(),
                None if mask is None else mask.cpu().numpy(), n)
            plan_ms = (time.perf_counter() - t0) * 1e3
        plan = plan.to("cuda")
        rec = {"phase": "kernel", "kernel": "scatter_add_rows",
               "shape": name, "n": n, "nd": nd, "f": f, "d": d,
               "mean": mean, "masked": mask is not None,
               "dtype": str(g.dtype).replace("torch.", ""), "card": card,
               "plan_bytes": plan.nbytes(), "plan_host_ms": plan_ms,
               "long_targets": plan.long_rows.numel(),
               "pieces": plan.num_chunks}
        before = scatter.scatter_add_rows.launches
        got = scatter.scatter_add_rows(g, idx, mask, n, mean, plan=plan)
        again = scatter.scatter_add_rows(g, idx, mask, n, mean, plan=plan)
        torch.cuda.synchronize()
        check(scatter.scatter_add_rows.launches
              == before + (2 if n * d else 0),
              f"{name}: one scatter launch a call with output rows")
        check(torch.equal(got, again),
              f"{name}: two launches give different bits")
        mask_cpu = None if mask is None else mask.cpu()
        want = scatter.scatter_add_rows_plain(g.cpu().double(), idx.cpu(),
                                              mask_cpu, n, mean).to(g.device)
        check(got.shape == (n, d) and got.dtype == torch.float32,
              f"{name}: scatter shape and dtype")
        err, scale = err_of(got, want)
        tol = 1e-5 * scale
        check(err <= tol, f"{name} {rec['dtype']}: max abs err {err} > "
              f"{tol}")
        if mask is not None and not (mask > 0).any():
            check(not got.any(), f"{name}: all-masked rows add nothing")
        cpu = scatter.scatter_add_rows_plain(g.cpu(), idx.cpu(), mask_cpu,
                                             n, mean)
        rec.update(max_abs_err=err, tol_scale=scale,
                   deterministic=True,
                   bitwise_equal_to_cpu=bool(torch.equal(got.cpu(), cpu)))
        if nd:
            b_ms, b_by, uniq, nbytes = scatter_bound(
                idx, mask, n, d, g.element_size(), name in padded)
            if name in padded:
                rec["padding_bytes"] = (n - uniq) * d * 4
            if mask is None:
                flat = idx[:, 0].long()

                def library():
                    return torch.zeros(n, d, device="cuda",
                                       dtype=g.dtype).index_add_(0, flat, g)
                lib = library()
            else:
                pad = torch.where(mask > 0, idx,
                                  torch.full_like(idx, n)).long()
                table = torch.zeros(n + 1, d, device="cuda", dtype=g.dtype,
                                    requires_grad=True)
                out = F.embedding_bag(pad, table,
                                      mode="mean" if mean else "sum",
                                      padding_idx=n)

                def library():
                    return torch.autograd.grad(out, table, g,
                                               retain_graph=True)[0]
                lib = library()[:n]
            rec.update(
                **time_record(
                    torch, flush, iters,
                    lambda: scatter.scatter_add_rows(g, idx, mask, n, mean,
                                                     plan=plan),
                    lambda: scatter.scatter_add_rows_plain(g, idx, mask, n,
                                                           mean),
                    library),
                library_max_abs_err=err_of(lib, want)[0],
                bound_ms=b_ms, bound_by=b_by, unique_rows=uniq,
                bytes=nbytes)
        records.append(rec)
        emit(**rec)
    return records


def gather_edge_records(torch, gather, randn, gen, card: str):
    """``gather_rows`` bit for bit against its plain version, untimed,
    on each path's edges at the KGE width (1,600-byte rows): one row, a
    grid one row short of 1,024 and at 1,024, a hub (every id one row),
    rows named again within a block (also at 400 bytes),
    a table starting 8 bytes past a 16-byte boundary (the narrower
    register moves, not the bulk path), bf16 at D = 100 (200-byte rows),
    the attention logits' 8-byte rows (1, 1,023, 1,024 and 260,000 ids,
    a hub, a table 4 bytes off an 8-byte boundary), the one-head logits'
    4-byte rows and GATv2's 188-byte block-1 rows (1, 1,023, 1,024 and
    25,000 ids, a hub, rows named again; 188 bytes also 4 bytes off a
    16-byte boundary) and a table of more than 2^31 elements gathered
    at its last rows."""
    def ids(n, m, dtype=torch.int32):
        return torch.randint(0, n, (m,), device="cuda", generator=gen,
                             dtype=dtype)
    kge = randn(14_951, KGE_DIM)
    flat = randn(2 + 14_951 * KGE_DIM)
    shifted = flat[2:2 + 14_951 * KGE_DIM].view(14_951, KGE_DIM)
    el = randn(286_000, 2)
    el_shifted = randn(1 + 286_000 * 2)[1:].view(286_000, 2)
    el1 = randn(26_000, 1)
    fs1 = randn(26_000, CLASSES)
    fs1_shifted = randn(1 + 26_000 * CLASSES)[1:].view(26_000, CLASSES)
    cases = [("rows1600_m1", kge, ids(14_951, 1)),
             ("rows1600_m1023", kge, ids(14_951, 1023, torch.int64)),
             ("rows1600_m1024", kge, ids(14_951, 1024)),
             ("rows1600_hub", kge, torch.full((2304,), 7, device="cuda",
                                               dtype=torch.int64)),
             ("rows1600_repeats", kge, ids(6, 2304)),
             ("rows400_repeats", randn(14_951, 100), ids(6, 2304)),
             ("rows1600_shifted8", shifted, ids(14_951, 2304)),
             ("rows200_bf16", randn(14_951, 100, dtype=torch.bfloat16),
              ids(14_951, 2305, torch.int64)),
             # the attention logits' rows: 2 heads of f32, 8 bytes
             ("rows8_m1", el, ids(286_000, 1)),
             ("rows8_m1023", el, ids(286_000, 1023, torch.int64)),
             ("rows8_m1024", el, ids(286_000, 1024)),
             ("rows8_m260000", el, ids(286_000, 260_000)),
             ("rows8_hub", el, torch.full((25_000,), 3, device="cuda",
                                          dtype=torch.int32)),
             ("rows8_shifted4", el_shifted, ids(286_000, 25_000)),
             # the last layer's one head: 4-byte logits, 188-byte rows
             ("rows4_m1", el1, ids(26_000, 1)),
             ("rows4_m1023", el1, ids(26_000, 1023, torch.int64)),
             ("rows4_m1024", el1, ids(26_000, 1024)),
             ("rows4_m25000", el1, ids(26_000, 25_000)),
             ("rows4_hub", el1, torch.full((25_000,), 5, device="cuda",
                                           dtype=torch.int32)),
             ("rows188_m1", fs1, ids(26_000, 1)),
             ("rows188_m1023", fs1, ids(26_000, 1023, torch.int64)),
             ("rows188_m1024", fs1, ids(26_000, 1024)),
             ("rows188_m25000", fs1, ids(26_000, 25_000)),
             ("rows188_repeats", fs1, ids(6, 2304)),
             ("rows188_shifted4", fs1_shifted, ids(26_000, 25_000))]
    records = gather_records(torch, gather, cases, None, 0, card,
                             timed=False)
    del kge, flat, shifted, el, el_shifted, el1, fs1, fs1_shifted, cases
    n = 5_400_000               # x 400 f32: 2.16e9 elements, 8.6 GB
    big = torch.zeros(n, KGE_DIM, device="cuda")
    big[-4096:] = randn(4096, KGE_DIM)
    last = ids(4096, 3000, torch.int64) + (n - 4096)
    records += gather_records(torch, gather, [
        ("over_2e31_elements", big, last),
        ("over_2e31_elements", big, last.int())], None, 0, card,
        timed=False)
    del big
    torch.cuda.empty_cache()
    return records


def kernel_phase(torch, args, ops, trainer, mb, card: str):
    """Every kernel against its plain version on the card: at the
    serving shapes, at the training step's own shapes (one sampled
    batch: its input ids, its blocks' nbr and mask, the features on
    the card) in both dtypes, and at edge cases."""
    fanout, gather, scatter = ops
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    def rand_block(n, nd, f, kind="random"):
        nbr = torch.randint(0, n, (nd, f), device="cuda", generator=gen,
                            dtype=torch.int32)
        if kind == "none":
            return nbr, torch.zeros(nd, f, device="cuda", dtype=torch.uint8)
        mask = (torch.rand(nd, f, device="cuda", generator=gen)
                < 0.8).to(torch.uint8)
        if nd:
            mask[-nd // 8:] = 0      # padded dst rows
        return nbr, mask

    blocks, inputs, _ = trainer.ship(mb)
    (nbr0, mask0), (nbr1, mask1) = [(b.nbr, b.mask) for b in blocks]
    caps = trainer.caps
    feats = trainer.feats
    h0 = gather.gather_rows(feats, inputs)          # block 0's input rows
    h1 = randn(caps[1], HIDDEN)
    serve0, serve1 = rand_block(18304, 1664, 10), rand_block(1664, 64, 25)
    fan_cases = [
        ("serve_block0", randn(18304, FEAT), *serve0),
        ("serve_block1", randn(1664, HIDDEN), *serve1),
        ("serve_block0", randn(18304, FEAT, dtype=torch.bfloat16), *serve0),
        ("serve_block1", randn(1664, HIDDEN, dtype=torch.bfloat16),
         *serve1),
        ("train_block0", h0, nbr0, mask0),
        ("train_block1", h1, nbr1, mask1),
        ("train_block1", h1.bfloat16(), nbr1, mask1),
        ("fanout1_width37", randn(2048, 37), *rand_block(2048, 512, 1)),
        ("all_masked", randn(4096, 128), *rand_block(4096, 256, 10, "none")),
        ("no_rows", randn(4096, FEAT), *rand_block(4096, 0, 10)),
    ]
    records = fanout_records(torch, fanout, fan_cases, flush, args.iters,
                             card)
    feats16 = feats.bfloat16()
    gather_cases = [
        ("train_feats", feats, inputs),
        ("train_feats", feats16, inputs),
        ("train_feats_int64", feats, inputs.long()),
        ("serve_feats", feats, torch.randint(
            0, feats.shape[0], (18304,), device="cuda", generator=gen)),
        ("width37", randn(2048, 37), torch.randint(
            0, 2048, (512,), device="cuda", generator=gen,
            dtype=torch.int32)),
        ("no_rows", feats, inputs[:0]),
    ]
    records += gather_records(torch, gather, gather_cases, flush,
                              args.iters, card)
    floor_record(torch, flush, args.iters, card)
    records += gather_edge_records(torch, gather, randn, gen, card)
    g1 = randn(BATCH_TRAIN, HIDDEN)
    # every dst row of block 1 names source row 7 (in its first slot)
    hub_nbr, hub_mask = nbr1.clone(), mask1.clone()
    hub_nbr[:, 0], hub_mask[:, 0] = 7, 1
    plan1 = mb.blocks[1].plan       # attached by the trainer's sampler
    scatter_cases = [
        # name, g, idx, mask, rows of dst, mean, plan (None: built here)
        ("train_block1_bwd", g1, nbr1, mask1, caps[1], True, plan1),
        ("train_block1_bwd", g1.bfloat16(), nbr1, mask1, caps[1], True,
         plan1),
        ("train_block1_hub", g1, hub_nbr, hub_mask, caps[1], True, None),
        # every slot masked: the kernel only writes dst, its floor here
        ("train_block1_none", g1, nbr1, torch.zeros_like(mask1), caps[1],
         True, None),
        ("train_block0_bwd", randn(caps[1], FEAT), nbr0, mask0, caps[2],
         True, None),
        ("train_feats_bwd", randn(caps[2], FEAT), inputs.view(-1, 1), None,
         feats.shape[0], False, None),
        ("all_masked", randn(256, 128), *rand_block(4096, 256, 10, "none"),
         4096, True, None),
        ("no_rows", randn(0, FEAT), *rand_block(4096, 0, 10), 4096, True,
         None),
    ]
    records += scatter_records(torch, scatter, scatter_cases, flush,
                               args.iters, card)
    return records


def check_sampled_rows(g, csc, frontier, fan, nbr, nbr_eid, what):
    """Rows of seeds of degree above ``fan`` hold ``fan`` distinct
    in-edges of their seed (by edge id) and those edges' sources."""
    import numpy as np

    indptr = csc[0]
    big = (indptr[1:] - indptr[:-1])[frontier] > fan
    eid = nbr_eid[big].astype(np.int64)
    check(bool((eid >= 0).all()), f"{what}: every slot of a row above "
          "the fanout is filled")
    check(bool((g.dst[eid] == frontier[big][:, None]).all()),
          f"{what}: each pick is an in-edge of its seed")
    check(bool((g.src[eid] == nbr[big]).all()),
          f"{what}: each pick names its edge's source")
    srt = np.sort(eid, axis=1)
    check(bool((srt[:, 1:] != srt[:, :-1]).all()),
          f"{what}: picks are distinct")
    return int(big.sum())


def check_compaction(frontier, nbr, cap, out, what):
    """The compaction contract: the frontier prefix, sorted new ids, at
    most ``cap`` ids, and every kept slot resolving to its sampled id."""
    import numpy as np

    src, pos, mask = out
    nf = len(frontier)
    check(np.array_equal(src[:nf], frontier), f"{what}: frontier prefix")
    check(bool((np.diff(src[nf:]) > 0).all()), f"{what}: new ids sorted")
    check(cap is None or len(src) <= max(cap, nf), f"{what}: within cap")
    kept = mask > 0
    check(bool((src[pos[kept]] == nbr[kept]).all()),
          f"{what}: every kept slot resolves to its sampled id")
    check(bool((pos[~kept] == 0).all() and (nbr[kept] >= 0).all()),
          f"{what}: dropped and empty slots are masked")


def graph_phase(args, g, trainer, card: str, host: str):
    """The graph core against its plain versions at the training
    batch's shapes, with host times, and the sampler pipeline's
    throughput by thread count."""
    import numpy as np

    from dgl_operator_tpu_torch.graph import _native
    from dgl_operator_tpu_torch.graph.blocks import build_fanout_blocks

    rec = {"phase": "graph", "card": card, "host_cpu": host,
           "nodes": g.num_nodes, "edges": g.num_edges}
    csc = _native.build_csr(g.dst, g.src, g.num_nodes)
    plain_csc = _native.build_csr_plain(g.dst, g.src, g.num_nodes)
    check(all(np.array_equal(a, b) and a.dtype == b.dtype
              for a, b in zip(csc, plain_csc)), "build_csr: identical")
    check(all(np.array_equal(a, b) for a, b in zip(csc, trainer.csc)),
          "build_csr: the trainer's CSC")
    rec["build_csr_ms"] = host_ms(
        lambda: _native.build_csr(g.dst, g.src, g.num_nodes), 3)
    rec["build_csr_plain_ms"] = host_ms(
        lambda: _native.build_csr_plain(g.dst, g.src, g.num_nodes), 3)
    indptr, indices, eids = csc
    seeds = np.asarray(trainer.train_ids[:BATCH_TRAIN], np.int64)
    frontier = seeds
    layers = []
    for layer, fan in enumerate(reversed(FANOUTS)):
        seed = 3 + 1315423911 * (layer + 1)
        what = f"layer {layer} ({len(frontier)} x {fan})"
        nat = _native.sample_fanout(indptr, indices, eids, frontier, fan,
                                    seed)
        pla = _native.sample_fanout_plain(indptr, indices, eids, frontier,
                                          fan, seed)
        small = (indptr[1:] - indptr[:-1])[frontier] <= fan
        check(np.array_equal(nat[0][small], pla[0][small]) and
              np.array_equal(nat[1][small], pla[1][small]),
              f"{what}: rows of degree <= fanout identical")
        above = check_sampled_rows(g, csc, frontier, fan, *nat,
                                   f"{what} library")
        check_sampled_rows(g, csc, frontier, fan, *pla, f"{what} plain")
        nbr = nat[0]
        full = _native.compact_frontier(frontier, nbr, None, seed)
        full_plain = _native.compact_frontier_plain(frontier, nbr, None,
                                                    seed)
        check(all(np.array_equal(a, b) and a.dtype == b.dtype
                  for a, b in zip(full, full_plain)),
              f"{what}: uncapped compaction identical")
        cap = len(frontier) + (len(full[0]) - len(frontier)) // 2
        capped = _native.compact_frontier(frontier, nbr, cap, seed)
        check_compaction(frontier, nbr, cap, capped, f"{what} capped")
        check_compaction(frontier, nbr, cap,
                         _native.compact_frontier_plain(frontier, nbr, cap,
                                                        seed),
                         f"{what} capped plain")
        check(len(capped[0]) == cap, f"{what}: capped to {cap}")
        layers.append(dict(
            rows=len(frontier), fanout=fan, rows_above_fanout=above,
            new_ids=len(full[0]) - len(frontier), cap_tested=cap,
            sample_ms=host_ms(lambda: _native.sample_fanout(
                indptr, indices, eids, frontier, fan, seed), 5),
            sample_plain_ms=host_ms(lambda: _native.sample_fanout_plain(
                indptr, indices, eids, frontier, fan, seed), 3),
            compact_ms=host_ms(lambda: _native.compact_frontier(
                frontier, nbr, None, seed), 5),
            compact_plain_ms=host_ms(lambda: _native.compact_frontier_plain(
                frontier, nbr, None, seed), 3)))
        frontier = full[0]
    rec["layers"] = layers
    caps = trainer.caps[1:]

    def batch(plain):
        return build_fanout_blocks(csc, seeds, FANOUTS, seed=3,
                                   src_caps=caps, plain=plain)
    rec["blocks_ms"] = host_ms(lambda: batch(False), 5)
    rec["blocks_plain_ms"] = host_ms(lambda: batch(True), 3)
    rec["blocks_speedup"] = rec["blocks_plain_ms"] / rec["blocks_ms"]
    # the trainer's whole batch: sampling, padding and the scatter plans
    rec["trainer_sample_ms"] = host_ms(lambda: trainer.sample(seeds, 3), 5)
    rng = np.random.default_rng(args.seed + 3)
    batches = [(rng.choice(trainer.train_ids, BATCH_TRAIN, replace=False),
                100 + i) for i in range(8)]
    cfg = trainer.cfg
    streams, per_s = [], {}
    try:
        for threads in (1, 2, 4):
            trainer.cfg = dataclasses.replace(cfg, num_samplers=threads)
            t = time.perf_counter()
            out = list(trainer.sample_pipeline(batches, depth=4))
            per_s[threads] = len(out) / (time.perf_counter() - t)
            streams.append(out)
    finally:
        trainer.cfg = cfg
    for other in streams[1:]:
        check(all(np.array_equal(a.input_nodes, b.input_nodes) and
                  all(np.array_equal(x.nbr, y.nbr)
                      for x, y in zip(a.blocks, b.blocks))
                  for a, b in zip(streams[0], other)),
              "sample_pipeline: one stream whatever the thread count")
    rec["pipeline_batches_per_s"] = per_s
    emit(**rec)


def serve_phase(torch, args, wrappers, g, work: str, card: str):
    """The port's partitioner splits ``g`` in 2 parts (its book under
    ``work``), and a ``ServeEngine`` on the card answers requests from
    it. Returns the launches of the served requests and the node map."""
    import numpy as np

    from dgl_operator_tpu_torch.graph.partition import (edge_cut,
                                                         partition_graph)
    from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                    state_dict_to_flax)
    from dgl_operator_tpu_torch.obs import get_obs
    from dgl_operator_tpu_torch.runtime.checkpoint import export_for_serving
    from dgl_operator_tpu_torch.serve.engine import ServeConfig, ServeEngine

    t0 = time.perf_counter()
    # the port's own partitioner: multilevel, 2 parts, seed 0
    cfg_json = partition_graph(g, "ogbn-products", 2,
                               os.path.join(work, "book"))
    partition_s = time.perf_counter() - t0
    with open(cfg_json) as f:
        book = json.load(f)
    node_map = np.load(os.path.join(work, "book", "node_map.npy"))
    sizes = [book[f"part-{p}"]["num_inner_nodes"] for p in range(2)]
    halo_rows = [book[f"part-{p}"]["num_local_nodes"] - sizes[p]
                 for p in range(2)]
    cut = edge_cut(g, node_map)
    check(book["part_method"] == "multilevel-native",
          f"book from the multilevel partitioner: {book['part_method']}")
    check(sum(sizes) == g.num_nodes and min(sizes) > 0 and
          sizes == np.bincount(node_map, minlength=2).tolist(),
          f"parts {sizes} cover the {g.num_nodes} nodes")
    check(max(sizes) <= 1.1 * g.num_nodes / 2 + 1,
          f"parts {sizes} within the 1.1 balance slack")
    check(cut < 0.5, f"edge cut {cut} below a random split's 0.5")
    setup_s = time.perf_counter() - t0
    model = DistSAGE(FEAT, HIDDEN, CLASSES, device="cuda",
                     generator=torch.Generator().manual_seed(args.seed))
    export = export_for_serving(os.path.join(work, "export") + os.sep,
                                state_dict_to_flax(model.state_dict()))
    cfg = ServeConfig(fanouts=FANOUTS, batch_size=BATCH,
                      halo_cache_frac=0.25, cap_policy="worst")
    eng = ServeEngine(model, cfg_json, params_path=export, cfg=cfg,
                      device="cuda")
    check(eng.ready, "engine warm")
    metrics = get_obs().metrics
    hits = metrics.counter("serve_halo_cache_hits_total")
    # catalogued in docs/serving.md, whose backtick pairing (an odd
    # count of backticks before its metrics table) hides it from TPU006
    # tpu-lint: disable=TPU006
    remote = metrics.counter("serve_halo_remote_rows_total")
    h0, r0 = hits.value(), remote.value()
    rng = np.random.default_rng(args.seed + 1)
    requests = [rng.choice(g.num_nodes, size=int(rng.integers(1, 65)),
                           replace=False) for _ in range(args.requests)]
    lat_ms = []
    # the main path: every kernel count starts at 0 here
    reset_counts(wrappers)
    forwards0 = eng.forward_calls
    served_from = time.perf_counter()
    batcher = eng.make_batcher()
    try:
        for ids in requests:
            t = time.perf_counter()
            pred = batcher.submit(ids).result(timeout=120)
            lat_ms.append((time.perf_counter() - t) * 1e3)
            check(pred.shape == ids.shape and pred.min() >= 0
                  and pred.max() < CLASSES,
                  "predictions are classes in [0, 47)")
    finally:
        batcher.stop()
    served_to = time.perf_counter()
    launches = read_counts(wrappers)
    forwards = eng.forward_calls - forwards0
    check(forwards >= len(requests) > 0,
          "at least one forward per request")
    check(launches == {"fanout_agg": 2 * forwards, "gather_rows": 0,
                       "scatter_add_rows": 0, "tree_sample": 0},
          f"2 fanout_agg launches per forward and no other: "
          f"{launches} launches, {forwards} forwards")
    check(eng.nonfinite_logits == 0, "finite logits")
    d_hits, d_remote = hits.value() - h0, remote.value() - r0
    check(d_hits > 0 and d_remote > 0,
          "halo cache hits and owner fetches counted")
    # one fixed request and sample seed, on the card and on the CPU
    fixed = np.sort(rng.choice(g.num_nodes, size=BATCH, replace=False))
    lg_gpu = eng.predict_logits(fixed, sample_seed=7)
    cpu_model = DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu")
    eng_cpu = ServeEngine(cpu_model, cfg_json, params_path=export,
                          cfg=cfg, device="cpu", warm=False)
    lg_cpu = eng_cpu.predict_logits(fixed, sample_seed=7)
    check(bool(np.isfinite(lg_gpu).all()) and lg_gpu.shape ==
          (BATCH, CLASSES), "fixed request: finite [64, 47] logits")
    cpu_err = float(np.abs(lg_gpu - lg_cpu).max())
    cpu_tol = 1e-4 * max(1.0, float(np.abs(lg_cpu).max()))
    check(cpu_err <= cpu_tol,
          f"card vs CPU logits: max abs err {cpu_err} > {cpu_tol}")
    check(bool((lg_gpu.argmax(-1) == lg_cpu.argmax(-1)).all()),
          "card vs CPU predictions")
    lat = np.asarray(lat_ms)
    # the engine's spans over the served window: host sample+gather
    # per part chunk, and ship+forward+fetch (ends in a device sync)
    spans = [s for s in get_obs().spans
             if served_from <= s["t0"] <= served_to]
    span_ms = {name: float(np.mean([(s["t1"] - s["t0"]) * 1e3
                                    for s in spans
                                    if s["name"] == name]))
               for name in ("engine_fanout", "forward_dispatch")}
    emit(phase="serve", card=card, nodes=g.num_nodes, edges=g.num_edges,
         parts=2, partition_s=partition_s, edge_cut=cut,
         part_sizes=sizes, halo_rows=halo_rows,
         part_method=book["part_method"],
         setup_s=setup_s, warmup_s=eng.warmup_seconds,
         load_s=eng.load_seconds, caps=eng.caps,
         requests=len(requests),
         seeds=int(sum(len(r) for r in requests)),
         forwards=forwards, launches=launches,
         halo_cache_hits=d_hits, halo_remote_rows=d_remote,
         p50_ms=float(np.percentile(lat, 50)),
         p99_ms=float(np.percentile(lat, 99)),
         sample_gather_ms_mean=span_ms["engine_fanout"],
         forward_dispatch_ms_mean=span_ms["forward_dispatch"],
         max_wait_ms=cfg.max_wait_ms,
         cpu_max_abs_err=cpu_err, cpu_tol=cpu_tol)
    return launches, node_map


def reset_counts(wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def read_counts(wrappers) -> dict:
    """Launches per kernel, by the wrapper's (and kernel's) name."""
    return {w.__name__: w.launches for w in wrappers}


def tree_launches(samples: int, slot_plans: bool = False) -> int:
    """The tree-sampling kernel's launches for ``samples`` device-sampled
    trees at ``FANOUTS``: one a layer, and one more for the last block's
    plan when the model asks for slot plans (GAT, pool)."""
    return samples * (len(FANOUTS) + int(slot_plans))


def setup_phase(torch, args, card: str):
    """The graph, the full-width model, its trainer (calibrated caps)
    and one sampled batch of the training stream."""
    import numpy as np

    from dgl_operator_tpu_torch.graph import datasets
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    t0 = time.perf_counter()
    g = datasets.ogbn_products(seed=args.seed, scale=args.scale).graph
    graph_s = time.perf_counter() - t0
    train_ids = np.nonzero(g.ndata["train_mask"])[0][:TRAIN_IDS]
    model = DistSAGE(FEAT, HIDDEN, CLASSES, device="cuda",
                     generator=torch.Generator().manual_seed(args.seed))
    cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                      eval_every=1, num_epochs=1, seed=args.seed)
    t1 = time.perf_counter()
    trainer = SampledTrainer(model, g, cfg, train_ids=train_ids)
    trainer_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    mb = trainer.sample(train_ids[:BATCH_TRAIN], 0)
    sample_s = time.perf_counter() - t2
    emit(phase="setup", card=card, nodes=g.num_nodes, edges=g.num_edges,
         train_ids=len(train_ids), caps=trainer.caps, graph_s=graph_s,
         trainer_s=trainer_s, sample_one_batch_s=sample_s,
         valid_slots=[int((np.asarray(b.mask) > 0).sum())
                      for b in mb.blocks])
    return g, trainer, mb


def step_device_ms(torch, trainer, mbs):
    """Per batch: the host time of sampling (its scatter plans
    included), of building those plans alone, and of shipping it to the
    card, then the device time of its step's forward (gather, model,
    loss), backward and Adam update by CUDA events. A spin kernel first
    keeps the card busy while the host enqueues the step, so the events
    bracket device work and not the host's launch cost."""
    import numpy as np

    from dgl_operator_tpu_torch.ops.scatter import scatter_plan

    rows = []
    for seeds, step_seed in mbs:
        t = time.perf_counter()
        mb = trainer.sample(seeds, step_seed)
        sample_ms = (time.perf_counter() - t) * 1e3
        # the part of the sampling that builds the blocks' plans, again
        t = time.perf_counter()
        for b in mb.blocks[1:]:
            scatter_plan(b.nbr, b.mask, b.num_src)
        plan_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = trainer.ship(mb)
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        trainer.optimizer.zero_grad(set_to_none=True)
        torch.cuda._sleep(100_000_000)
        ev[0].record()
        loss, _ = trainer.loss(batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
        trainer.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        rows.append([sample_ms, plan_ms, h2d_ms]
                    + [ev[k].elapsed_time(ev[k + 1]) for k in range(3)])
    # the first batch pays one-time costs (Adam's state allocation)
    mean = np.mean(rows[1:], axis=0)
    plan_bytes = sum(b.plan.nbytes() for b in mb.blocks[1:])
    nbytes = (sum(b.nbr.nbytes + b.mask.nbytes for b in mb.blocks)
              + plan_bytes + mb.input_nodes.nbytes + mb.seeds.nbytes)
    return dict(sample_ms=mean[0], plan_ms=mean[1], h2d_ms=mean[2],
                h2d_bytes=int(nbytes), plan_bytes=int(plan_bytes),
                forward_ms=mean[3], backward_ms=mean[4], adam_ms=mean[5],
                **adam_flag_ms(torch, list(trainer.model.parameters())))


def adam_flag_ms(torch, params, n: int = 10) -> dict:
    """Device ms of an Adam step on copies of ``params`` and their
    gradients, plain and ``capturable``, alternated over ``n`` steps
    after one that allocates the state (the queue filled first, as in
    ``step_device_ms``): what the flag costs a step that is never
    captured."""
    import numpy as np

    opts = {}
    for cap in (False, True):
        copies = [p.detach().clone().requires_grad_() for p in params]
        for c, p in zip(copies, params):
            c.grad = p.grad.detach().clone()
        opts[cap] = torch.optim.Adam(copies, lr=LR, capturable=cap)
    ms = {False: [], True: []}
    for i in range(n + 1):
        for cap, opt in opts.items():
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda._sleep(10_000_000)
            ev[0].record()
            opt.step()
            ev[1].record()
            torch.cuda.synchronize()
            if i:
                ms[cap].append(ev[0].elapsed_time(ev[1]))
    return dict(adam_plain_copy_ms=float(np.mean(ms[False])),
                adam_capturable_copy_ms=float(np.mean(ms[True])))


def train_phase(torch, args, wrappers, trainer, card: str):
    """One epoch of ``SampledTrainer.train`` (the main path), then the
    device time of single steps."""
    import numpy as np

    # the main path: every kernel count starts at 0 here
    reset_counts(wrappers)
    t0 = time.perf_counter()
    out = trainer.train()
    wall_s = time.perf_counter() - t0
    launches = read_counts(wrappers)
    steps = out["step"]
    rec = out["history"][0]
    losses = np.asarray(rec["losses"])
    check(steps == len(trainer.train_ids) // BATCH_TRAIN == len(losses)
          > 2 * 5, f"{steps} steps over {len(trainer.train_ids)} ids")
    # the warm-up forward before the first step adds one gather and two
    # aggregations; each step launches 1 gather, 2 aggregations and the
    # backward of block 1's aggregation (block 0's input needs none)
    check(launches == {"fanout_agg": 2 * steps + 2,
                       "gather_rows": steps + 1,
                       "scatter_add_rows": steps, "tree_sample": 0},
          f"per step 1 gather_rows, 2 fanout_agg, 1 scatter_add_rows: "
          f"{launches} launches in {steps} steps")
    check(bool(np.isfinite(losses).all()), "finite losses")
    check(losses[-5:].mean() < losses[:5].mean(),
          f"loss decreases: first 5 {losses[:5].mean()}, last 5 "
          f"{losses[-5:].mean()}")
    val, test = rec.get("val_acc"), rec.get("test_acc")
    check(val is not None and test is not None and 0 <= val <= 1
          and 0 <= test <= 1, f"val_acc {val} and test_acc {test} in [0, 1]")
    step_ms = np.asarray(rec["step_s"]) * 1e3
    rng = np.random.default_rng(args.seed + 2)
    probe = [(rng.choice(trainer.train_ids, BATCH_TRAIN, replace=False),
              10_000 + i) for i in range(4)]
    dev = step_device_ms(torch, trainer, probe)
    device_ms = dev["forward_ms"] + dev["backward_ms"] + dev["adam_ms"]
    emit(phase="train", card=card, caps=trainer.caps, steps=steps,
         seeds=int(steps * BATCH_TRAIN), launches=launches,
         launches_per_step={k: (v - {"fanout_agg": 2, "gather_rows": 1}
                                .get(k, 0)) / steps
                            for k, v in launches.items()},
         loss_first5=float(losses[:5].mean()),
         loss_last5=float(losses[-5:].mean()), losses=losses.tolist(),
         step_ms_mean=float(step_ms.mean()),
         step_ms_p50=float(np.percentile(step_ms, 50)),
         **{f"{k}_ms_per_step": rec.get(k, 0.0) * 1e3 / steps
            for k in ("sample", "stall", "dispatch")},
         seeds_per_sec=rec["seeds_per_sec"], epoch_s=rec["time"],
         train_call_s=wall_s, eval_s=rec["eval_s"], val_acc=val,
         test_acc=test, **{f"probe_{k}": v for k, v in dev.items()},
         probe_device_ms=device_ms,
         device_busy_share=device_ms / float(step_ms.mean()))
    return launches


def synced_step_gaps(torch, card_tr, cpu_tr, batches, step):
    """Step ``card_tr`` and ``cpu_tr`` over ``batches`` with ``step(tr,
    batch) -> loss``; before each step the card takes the CPU's
    parameters and Adam state, so every step's gap is that step's alone.
    Returns the card's and the CPU's losses, each step's gradient gap
    (max abs error over max abs, per parameter) and the seconds each
    side spent."""
    import copy

    def grads(tr):
        return {n: q.grad.detach().cpu().clone()
                for n, q in tr.model.named_parameters()}

    card_l, cpu_l, gaps, secs = [], [], [], [0.0, 0.0]
    for batch in batches:
        card_tr.model.load_state_dict(cpu_tr.model.state_dict())
        # a deep copy: Adam keeps its step counts as host tensors, which
        # a shallow load would share between the two optimizers
        card_tr.optimizer.load_state_dict(
            copy.deepcopy(cpu_tr.optimizer.state_dict()))
        for k, (tr, losses) in enumerate(((card_tr, card_l),
                                          (cpu_tr, cpu_l))):
            t0 = time.perf_counter()
            losses.append(float(step(tr, batch)))
            secs[k] += time.perf_counter() - t0
        want = grads(cpu_tr)
        gaps.append({n: float((got - want[n]).abs().max())
                     / max(float(want[n].abs().max()), 1e-30)
                     for n, got in grads(card_tr).items()})
    return card_l, cpu_l, gaps, secs


def check_step_gaps(what: str, card_l, cpu_l, gaps) -> Tuple[list, list]:
    """Every step's loss within 1e-5 relative and every gradient within
    1e-4 of its largest entry; returns the relative loss gaps and each
    step's worst gradient gap."""
    rel = [abs(g - c) / abs(c) for g, c in zip(card_l, cpu_l)]
    for i, (r, gap) in enumerate(zip(rel, gaps)):
        check(r <= 1e-5, f"{what} step {i + 1} loss card {card_l[i]} vs "
              f"CPU {cpu_l[i]}: relative {r} > 1e-5")
        for name, e in gap.items():
            check(e <= 1e-4, f"{what} step {i + 1} grad {name}: max abs "
                  f"err {e} x max > 1e-4")
    return rel, [max(gap.values()) for gap in gaps]


def train_cpu_phase(torch, args, g, trainer, card: str):
    """The same seeded weights, dropout 0 and the first batches of the
    training stream, stepped on the card and on the CPU, the card
    taking the CPU's parameters and Adam state before every step."""
    import numpy as np

    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    # caps do not matter here: both take the main trainer's batches
    cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                      dropout=0.0, cap_policy="worst", seed=args.seed)
    ids = np.random.default_rng(args.seed).permutation(trainer.train_ids)
    mbs = [trainer.sample(ids[b * BATCH_TRAIN:(b + 1) * BATCH_TRAIN], b)
           for b in range(CPU_STEPS)]
    trainers = [SampledTrainer(
        DistSAGE(FEAT, HIDDEN, CLASSES, device=dev,
                 generator=torch.Generator().manual_seed(args.seed + 1)),
        g, cfg, train_ids=trainer.train_ids, device=dev)
        for dev in ("cuda", "cpu")]
    gl, cl, gaps, (gs, cs) = synced_step_gaps(
        torch, *trainers, mbs, lambda tr, mb: tr.train_step(mb)[0])
    rel, worst = check_step_gaps("train", gl, cl, gaps)
    emit(phase="train_cpu", card=card, steps=CPU_STEPS, synced=True,
         card_losses=gl, cpu_losses=cl, loss_rel_err=rel,
         grad_rel_err_max=worst, grad_rel_err=gaps, card_s=gs, cpu_s=cs)


class Killed(RuntimeError):
    """The end of a run that a resume check cuts short."""


def resume_check(torch, name, make, w0, want, kill_at: int, ckpt_dir: str,
                 card: str, method: str = "train_step") -> None:
    """``make(**fields)`` builds a fresh trainer whose ``TrainConfig``
    takes ``fields``. A run from the weights ``w0`` (a flax params
    tree) that checkpoints every ``kill_at`` steps dies as it begins
    step ``kill_at + 1`` (the trainer's ``method``: ``train_step``, one
    step a call, or ``train_call``, whose losses count its steps); a
    fresh trainer resumes it from the newest checkpoint and must end on
    the uninterrupted run's parameters and losses (``want``) bit for
    bit."""
    from dgl_operator_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                           train_state)

    want_params, want_losses = want
    first = make(ckpt_dir=ckpt_dir, ckpt_every=kill_at)
    step, taken = getattr(first, method), []

    def dying_step(batch):
        if len(taken) >= kill_at:
            raise Killed(f"{name}: killed after {len(taken)} steps")
        out = step(batch)
        taken.extend([1] * (len(out[0]) if method == "train_call" else 1))
        return out

    setattr(first, method, dying_step)
    try:
        first.train(init_params=w0)
        cut = False
    except Killed:
        cut = True
    check(cut, f"{name}: the first run was not cut")
    saved = CheckpointManager(ckpt_dir).latest_step()
    check(saved == kill_at, f"{name}: newest checkpoint at step {saved}, "
          f"expected {kill_at}")
    resumed = make(ckpt_dir=ckpt_dir)
    t0 = time.perf_counter()
    out = resumed.train()
    train_s = time.perf_counter() - t0
    losses = [x for rec in out["history"] for x in rec["losses"]]
    check(out["step"] == len(want_losses),
          f"{name}: resumed run ends at step {out['step']}, the "
          f"uninterrupted one at {len(want_losses)}")
    check(losses == want_losses[kill_at:],
          f"{name}: resumed losses {losses} differ from the uninterrupted "
          f"run's {want_losses[kill_at:]}")
    diff = {k: float((v.float() - want_params[k].float()).abs().max())
            for k, v in out["params"].items()}
    check(out["params"].keys() == want_params.keys() and all(
        torch.equal(v, want_params[k]) for k, v in out["params"].items()),
        f"{name}: resumed parameters differ from the uninterrupted run's: "
        f"max abs diff {diff}")
    # one synchronous save of the resumed trainer's state
    t0 = time.perf_counter()
    CheckpointManager(os.path.join(ckpt_dir, "timed")).save(
        out["step"], train_state(resumed.model, resumed.optimizer))
    save_ms = (time.perf_counter() - t0) * 1e3
    emit(phase="resume", trainer=name, card=card, killed_at=kill_at,
         checkpoint_step=saved, resumed_steps=len(losses),
         final_step=out["step"], bit_exact=True, max_abs_diff=diff,
         resumed_train_s=train_s, sync_save_ms=save_ms,
         cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))


def sampled_resume_phase(torch, args, g, trainer, work: str,
                         card: str) -> None:
    """``SampledTrainer`` resume on the card (dropout 0): an epoch of
    ``2 * SAMPLED_RESUME_AT`` steps over the train phase's first ids,
    uninterrupted and cut at ``SAMPLED_RESUME_AT`` then resumed."""
    from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                    state_dict_to_flax)
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    ids = trainer.train_ids[:2 * SAMPLED_RESUME_AT * BATCH_TRAIN]
    w0 = state_dict_to_flax(DistSAGE(
        FEAT, HIDDEN, CLASSES, device="cpu",
        generator=torch.Generator().manual_seed(args.seed + 2)).state_dict())

    def make(**fields):
        cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                          dropout=0.0, num_epochs=1, eval_every=0,
                          seed=args.seed, **fields)
        return SampledTrainer(DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0,
                                       device="cuda"), g, cfg, train_ids=ids)

    full = make().train(init_params=w0)
    want = ({k: v.clone() for k, v in full["params"].items()},
            full["history"][0]["losses"])
    resume_check(torch, "SampledTrainer", make, w0, want, SAMPLED_RESUME_AT,
                 os.path.join(work, "ckpt_sampled"), card)


def dist_device_ms(torch, tr, batches):
    """Per host batch of ``tr`` (a ``DistTrainer``): the host time of
    shipping it to the card, then the device time of its step (the
    exchange, every slot's forward and backward, Adam) by CUDA events,
    with a spin kernel first so that the events bracket device work."""
    import numpy as np

    rows = []
    for batch in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        slots, serve = tr.ship(batch)
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(100_000_000)
        ev[0].record()
        tr.device_step(slots, serve)
        ev[1].record()
        torch.cuda.synchronize()
        rows.append([h2d_ms, ev[0].elapsed_time(ev[1])])
    mean = np.mean(rows, axis=0)
    return dict(h2d_ms=float(mean[0]), device_ms=float(mean[1]))


def dist_kernel_records(torch, args, ops, rep, own, card: str):
    """Each kernel against its plain version at the dist path's shapes:
    slot 0 of one batch in each layout, and the owner layout's
    exchange over every slot's store."""
    import numpy as np

    from dgl_operator_tpu_torch.parallel.halo import exchange_index

    fanout, gather, scatter = ops
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 5)
    rng = np.random.default_rng(args.seed + 5)
    perm = [rng.permutation(t) for t in rep.train_ids]
    host, _ = rep._sample_all(perm, 0, 20_000)
    rslots, _ = rep.ship(host)
    oslots, serve = own.ship(own._sample_all(perm, 0, 20_000)[0])
    b0, b1 = rslots[0]["blocks"]
    inputs = rslots[0]["inputs"]
    records = gather_records(torch, gather, [
        ("dist_slot_inputs", rep.feats[0], inputs),
        ("dist_owner_local", own.feats[0], oslots[0]["exch_loc"]),
        ("dist_exchange", own._flat, exchange_index(serve,
                                                    own._rows_per_slot)),
    ], flush, args.iters, card)
    h1 = torch.randn(b1.num_src, HIDDEN, device="cuda", generator=gen)
    records += fanout_records(torch, fanout, [
        ("dist_block0", gather.gather_rows(rep.feats[0], inputs), b0.nbr,
         b0.mask),
        ("dist_block1", h1, b1.nbr, b1.mask),
    ], flush, args.iters, card)
    g1 = torch.randn(BATCH_TRAIN, HIDDEN, device="cuda", generator=gen)
    records += scatter_records(torch, scatter, [
        ("dist_block1_bwd", g1, b1.nbr, b1.mask, b1.num_src, True,
         host["mbs"][0].blocks[1].plan),
    ], flush, args.iters, card)
    return records


def dist_run_record(torch, tr, out, launches, probe, wall_s: float):
    """The numbers of one ``DistTrainer.train`` run on the card."""
    import numpy as np

    P = tr.num_parts
    rec = out["history"][0]
    steps = out["step"]
    step_ms = np.asarray(rec["step_s"]) * 1e3
    dev = dist_device_ms(torch, tr, probe)
    return dict(
        layout=tr.cfg.feats_layout, parts=P, steps=steps,
        seeds=int(steps * P * BATCH_TRAIN), caps=tr.caps, n_pad=tr.n_pad,
        c_pad=tr.c_pad, h_pad=tr.h_pad, cache_rows=tr.cache_rows,
        pair_cap=tr.pair_cap,
        halo_rows_per_step=rec.get("halo_rows_per_step", 0.0),
        exchange_bytes_per_step=tr.exchange_bytes_per_step,
        h2d_bytes_per_step=rec["h2d_bytes_per_step"],
        launches=launches,
        launches_per_step={k: v / steps for k, v in launches.items()},
        loss_first5=float(np.mean(rec["losses"][:5])),
        loss_last5=float(np.mean(rec["losses"][-5:])),
        losses=rec["losses"],
        step_ms_mean=float(step_ms.mean()),
        step_ms_p50=float(np.percentile(step_ms, 50)),
        **{f"{k}_ms_per_step": rec.get(k, 0.0) * 1e3 / steps
           for k in ("sample", "stall", "dispatch")},
        seeds_per_sec=rec["seeds_per_sec"], epoch_s=rec["time"],
        train_call_s=wall_s, eval_s=rec["eval_s"],
        val_acc=rec["val_acc"], test_acc=rec["test_acc"],
        **{f"probe_{k}": v for k, v in dev.items()},
        device_busy_share=dev["device_ms"] / float(step_ms.mean()))


def cut_book(g, node_map, ids_per_part: int, path: str, num_parts: int = 2):
    """The graph split by ``node_map`` into a ``num_parts``-part book at
    ``path``, each part's train split cut to its first ``ids_per_part``
    ids. Returns the book and the cut graph."""
    import numpy as np

    from dgl_operator_tpu_torch.graph.graph import Graph
    from dgl_operator_tpu_torch.graph.partition import partition_graph

    train = np.asarray(g.ndata["train_mask"], bool)
    mask = np.zeros(g.num_nodes, bool)
    for p in range(num_parts):
        mask[np.nonzero(train & (node_map == p))[0][:ids_per_part]] = 1
    cut = Graph(g.src, g.dst, g.num_nodes)
    cut.ndata = {**g.ndata, "train_mask": mask}
    return partition_graph(cut, "ogbn-products", num_parts, path,
                           parts=node_map), cut


def dist_phase(torch, args, ops, wrappers, g, node_map, work: str,
               card: str):
    """``DistTrainer`` on the card over the serving phase's 2-part
    assignment, with each part's train split cut to its first
    ``DIST_IDS_PER_PART`` ids (20 steps an epoch): 3 steps against the
    CPU, an epoch in the replicated layout, an epoch in the owner layout
    (same weights and stream: same losses), ``evaluate`` against the
    CPU's single-graph inference, the kernels at the path's shapes and
    resume. Returns the launches of the two epochs."""
    import numpy as np

    from dgl_operator_tpu_torch.models.sage import (DistSAGE, sage_inference,
                                                    state_dict_from_flax,
                                                    state_dict_to_flax)
    from dgl_operator_tpu_torch.runtime.dist import DistTrainer
    from dgl_operator_tpu_torch.runtime.loop import TrainConfig

    t0 = time.perf_counter()
    book, cut = cut_book(g, node_map, DIST_IDS_PER_PART,
                         os.path.join(work, "dist_book"))
    book_s = time.perf_counter() - t0
    # the weights the entry point draws from TrainConfig.seed
    w0 = state_dict_to_flax(DistSAGE(
        FEAT, HIDDEN, CLASSES, device="cpu",
        generator=torch.Generator().manual_seed(args.seed)).state_dict())

    def make(layout="replicated", device="cuda", **fields):
        cfg = TrainConfig(**{**dict(
            num_epochs=1, batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
            eval_every=1, seed=args.seed, cap_policy="auto",
            feats_layout=layout, halo_cache_frac=0.25), **fields})
        return DistTrainer(DistSAGE(FEAT, HIDDEN, CLASSES, device=device),
                           book, cfg, device=device)

    t0 = time.perf_counter()
    rep = make()
    rep_s = time.perf_counter() - t0
    P = rep.num_parts
    check(rep.steps_per_epoch == DIST_IDS_PER_PART // BATCH_TRAIN,
          f"{rep.steps_per_epoch} steps an epoch from "
          f"{[len(t) for t in rep.train_ids]} train ids")

    # the first steps of the training stream, on the card and on the CPU
    rng = np.random.default_rng(args.seed)
    perm = [rng.permutation(t) for t in rep.train_ids]
    batches = [rep._sample_all(perm, b, b)[0] for b in range(DIST_CPU_STEPS)]
    cpu = make(device="cpu")
    cpu.model.load_state_dict(state_dict_from_flax(w0))
    card_l, cpu_l, gaps, (card_s, cpu_s) = synced_step_gaps(
        torch, rep, cpu, batches, lambda tr, b: tr.train_step(b)[0])
    loss_rel, grad_rel = check_step_gaps("dist", card_l, cpu_l, gaps)
    emit(phase="dist_cpu", card=card, steps=DIST_CPU_STEPS, synced=True,
         card_losses=card_l, cpu_losses=cpu_l, loss_rel_err=loss_rel,
         grad_rel_err=grad_rel, grad_rel_err_by_param=gaps, card_s=card_s,
         cpu_s=cpu_s)

    # the main path, replicated: every kernel count starts at 0 here
    reset_counts(wrappers)
    t0 = time.perf_counter()
    out_rep = rep.train(init_params=w0)
    rep_wall = time.perf_counter() - t0
    launches_rep = read_counts(wrappers)
    steps = out_rep["step"]
    losses = out_rep["history"][0]["losses"]
    want = ({k: v.clone() for k, v in out_rep["params"].items()}, losses)
    check(steps == rep.steps_per_epoch == len(losses),
          f"{steps} steps, {len(losses)} losses")
    check(launches_rep == {"fanout_agg": 2 * P * steps,
                           "gather_rows": P * steps,
                           "scatter_add_rows": P * steps,
                           "tree_sample": 0},
          f"per step and slot 1 gather_rows, 2 fanout_agg, 1 "
          f"scatter_add_rows: {launches_rep} launches in {steps} steps")
    check(bool(np.isfinite(losses).all()), "finite dist losses")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"dist loss decreases: {losses}")

    # evaluate on the card against the CPU's single-graph inference
    cpu_model = DistSAGE(FEAT, HIDDEN, CLASSES, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in want[0].items()})
    t0 = time.perf_counter()
    with torch.no_grad():
        pred = sage_inference(cpu_model, g, torch.from_numpy(
            g.ndata["feat"])).argmax(-1).numpy()
    single_s = time.perf_counter() - t0
    rec = out_rep["history"][0]
    eval_cmp = {}
    for key, name in (("val_acc", "val_mask"), ("test_acc", "test_mask")):
        m = np.asarray(g.ndata[name], bool)
        n = int(m.sum())
        single = float((pred[m] == g.ndata["label"][m]).mean())
        nodes = abs(rec[key] - single) * n
        slack = max(2, n // 10_000)
        check(nodes <= slack + 1e-6, f"evaluate {key} {rec[key]} on the card "
              f"vs {single} single-graph on the CPU: {nodes} nodes apart > "
              f"{slack}")
        eval_cmp[key] = dict(card=rec[key], cpu_single_graph=single,
                             nodes_apart=round(nodes), slack_nodes=slack)
    probe = [rep._sample_all(perm, b, 10_000 + b)[0] for b in range(4)]
    rep_rec = dist_run_record(torch, rep, out_rep, launches_rep, probe,
                              rep_wall)
    emit(phase="dist", card=card, book_s=book_s, trainer_s=rep_s,
         **rep_rec, eval_vs_single_graph=eval_cmp, single_graph_cpu_s=single_s)

    # the main path, owner layout: every kernel count starts at 0 here
    t0 = time.perf_counter()
    own = make("owner")
    own_s = time.perf_counter() - t0
    reset_counts(wrappers)
    t0 = time.perf_counter()
    out_own = own.train(init_params=w0)
    own_wall = time.perf_counter() - t0
    launches_own = read_counts(wrappers)
    own_losses = out_own["history"][0]["losses"]
    # the epoch's end state: the probe steps below train the model on
    own_params = {k: v.clone() for k, v in out_own["params"].items()}
    check(out_own["step"] == steps, f"owner layout: {out_own['step']} steps")
    check(launches_own == {"fanout_agg": 2 * P * steps,
                           "gather_rows": (P + 1) * steps,
                           "scatter_add_rows": P * steps,
                           "tree_sample": 0},
          f"per step 1 exchange gather_rows, and per slot 1 gather_rows, 2 "
          f"fanout_agg, 1 scatter_add_rows: {launches_own} launches in "
          f"{steps} steps")
    check(bool(np.isfinite(own_losses).all()), "finite owner losses")
    loss_rel = float(np.max(np.abs(np.subtract(own_losses, losses))
                            / np.abs(losses)))
    check(loss_rel <= 1e-6, f"owner losses {own_losses} vs replicated "
          f"{losses}: relative {loss_rel} > 1e-6")
    param_diff = max(float((v - want[0][k]).abs().max())
                     for k, v in out_own["params"].items())
    probe = [own._sample_all(perm, b, 10_000 + b)[0] for b in range(4)]
    emit(phase="dist", card=card, trainer_s=own_s,
         **dist_run_record(torch, own, out_own, launches_own, probe,
                           own_wall),
         loss_rel_to_replicated=loss_rel,
         param_max_abs_diff_to_replicated=param_diff)

    records = dist_kernel_records(torch, args, ops, rep, own, card)
    resume_check(torch, "DistTrainer",
                 lambda **fields: make(eval_every=0, **fields), w0, want,
                 steps // 2, os.path.join(work, "ckpt_dist"), card)
    ctx = dict(book=book, w0=w0, make=make, perm=perm, own=own,
               seed=args.seed, pair_cap=own.pair_cap, cut=cut,
               node_map=node_map, want={
        "replicated": (want[0], losses, (rec["val_acc"], rec["test_acc"])),
        "owner": (own_params, own_losses, (out_own["history"][0]["val_acc"],
                               out_own["history"][0]["test_acc"]))})
    return ({k: launches_rep[k] + launches_own[k] for k in launches_rep},
            records, ctx)


LAYOUTS = ("replicated", "owner")
MP_CHILD_TIMEOUT_S = 300
# one rank of the dist_mp phase's two-rank run: the entry point's main on
# the card, with the kernel counts of this process and the result
# written for the parent (the printed final loss has 4 decimals); then,
# in a second gloo group, the µs of the step's three collectives on
# CUDA tensors of the step's shapes
DIST_MP_CHILD = """
import datetime, json, os, sys, time
spec = json.loads(sys.argv[1])
sys.path.insert(0, spec["repo"])
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from dgl_operator_tpu_torch.examples.train_dist import main
from dgl_operator_tpu_torch.ops import fanout, gather, scatter
from dgl_operator_tpu_torch.ops.device_sample import tree_sample
wrappers = (fanout.fanout_agg, gather.gather_rows, scatter.scatter_add_rows,
            tree_sample)
for w in wrappers:
    w.launches = 0
out = main(spec["argv"])
rec = out["history"][0]
np.savez(spec["out"] + ".npz",
         **{k: v.cpu().numpy() for k, v in out["params"].items()})
dist = torch.distributed
dist.init_process_group(
    "gloo", init_method=f"tcp://127.0.0.1:{spec['probe_port']}",
    world_size=2, rank=int(os.environ["TPU_OPERATOR_RANK"]),
    timeout=datetime.timedelta(seconds=120))
# every parameter, then the 2 slots' losses and non-finite counts
numel = sum(v.numel() for v in out["params"].values()) + 2 * 2
bucket = torch.zeros(numel, device="cuda")
req = torch.zeros(2 * spec["pair_cap"], dtype=torch.int32, device="cuda")
rows = torch.zeros(2 * spec["pair_cap"], spec["feat"], device="cuda")
req_out, rows_out = torch.empty_like(req), torch.empty_like(rows)


def us(fn, n=20):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


collective_us = {
    "all_reduce": us(lambda: dist.all_reduce(bucket)),
    "all_to_all_requests": us(lambda: dist.all_to_all_single(req_out, req)),
    "all_to_all_rows": us(lambda: dist.all_to_all_single(rows_out, rows))}
dist.destroy_process_group()
with open(spec["out"] + ".json", "w") as f:
    json.dump({"collective_us": collective_us,
               "losses": rec["losses"], "step_s": rec["step_s"],
               "stall_s": rec.get("stall", 0.0),
               "dispatch_s": rec.get("dispatch", 0.0),
               "seeds_per_sec": rec["seeds_per_sec"],
               "val_acc": rec["val_acc"], "test_acc": rec["test_acc"],
               "eval_s": rec["eval_s"],
               "launches": {w.__name__: w.launches for w in wrappers}}, f)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def same_batches(a, b) -> bool:
    """Two ``DistTrainer`` host batches hold the same arrays."""
    import numpy as np

    arrays = []
    for x in (a, b):
        arrays.append([mb.input_nodes for mb in x["mbs"]]
                      + [mb.seeds for mb in x["mbs"]]
                      + [getattr(blk, f) for mb in x["mbs"]
                         for blk in mb.blocks for f in ("nbr", "mask")]
                      + [np.asarray(v) for mb in x["mbs"]
                         for blk in mb.blocks[1:]
                         for v in vars(blk.plan).values()
                         if isinstance(v, np.ndarray)]
                      + [x[k] for k in sorted(x) if k.startswith("exch")])
    return len(arrays[0]) == len(arrays[1]) and all(
        np.array_equal(u, v) for u, v in zip(*arrays))


def step_numbers(rec, steps: int) -> dict:
    """Step ms, stall ms per step and seeds/s of one epoch record."""
    import numpy as np

    return dict(step_ms_mean=float(np.mean(rec["step_s"]) * 1e3),
                stall_ms_per_step=rec.get("stall", 0.0) * 1e3 / steps,
                dispatch_ms_per_step=rec.get("dispatch", 0.0) * 1e3 / steps,
                seeds_per_sec=rec["seeds_per_sec"])


def sampler_widths(torch, ctx, card: str) -> None:
    """(a) The single-process ``DistTrainer`` at sampler widths 1 and 2,
    in the order 1, 2, 2, 1 per layout: bit-identical batch streams and
    losses, and each width's step numbers."""
    import numpy as np

    make, w0, perm = ctx["make"], ctx["w0"], ctx["perm"]
    for layout in LAYOUTS:
        trs = {w: make(layout, num_samplers=w, eval_every=0) for w in (1, 2)}
        for b in range(3):
            one, two = (trs[w]._sample_all(perm, b, 30_000 + b)[0]
                        for w in (1, 2))
            check(same_batches(one, two), f"{layout}: batch {b} differs "
                  "between sampler widths 1 and 2")
        trs[2]._close_sampler_pool()
        runs = {1: [], 2: []}
        for w in (1, 2, 2, 1):
            out = trs[w].train(init_params=w0)
            rec = out["history"][0]
            check(rec["losses"] == ctx["want"][layout][1],
                  f"{layout} width {w}: losses differ from the dist phase's")
            runs[w].append(step_numbers(rec, out["step"]))
        emit(phase="dist_mp", part="sampler_widths", card=card, layout=layout,
             batches_identical=True, losses_identical=True,
             **{f"width{w}": {k: [r[k] for r in rows] for k in rows[0]}
                for w, rows in runs.items()},
             **{f"width{w}_{k}_mean": float(np.mean([r[k] for r in rows]))
                for w, rows in runs.items() for k in rows[0]})


def collective_us(torch, dist, tr, cap: int, iters: int = 50) -> dict:
    """µs of one gradient ``all_reduce`` (every parameter, the slot
    losses and the slot non-finite counts in one bucket) and of the two
    exchange ``all_to_all_single``
    calls (int32 requests, float32 rows) at the owner step's shapes, by
    CUDA events."""
    P = tr.num_parts
    L = len(tr.parts)
    W = dist.get_world_size()
    numel = sum(p.numel() for p in tr.model.parameters()) + 2 * P
    bucket = torch.zeros(numel, device="cuda")
    req = torch.zeros(W * L * L * cap, dtype=torch.int32, device="cuda")
    rows = torch.zeros(W * L * L * cap, tr.feats.shape[-1], device="cuda")
    req_out, rows_out = torch.empty_like(req), torch.empty_like(rows)
    return dict(
        all_reduce_us=time_warm_ms(torch, lambda: dist.all_reduce(bucket),
                                   iters) * 1e3,
        all_reduce_bytes=bucket.numel() * 4,
        all_to_all_requests_us=time_warm_ms(
            torch, lambda: dist.all_to_all_single(req_out, req), iters) * 1e3,
        all_to_all_requests_bytes=req.numel() * 4,
        all_to_all_rows_us=time_warm_ms(
            torch, lambda: dist.all_to_all_single(rows_out, rows),
            iters) * 1e3,
        all_to_all_rows_bytes=rows.numel() * 4)


def nccl_world_one(torch, wrappers, ctx, card: str) -> dict:
    """(b) ``DistTrainer`` under an in-process NCCL group of world size
    1, both parts on rank 0: each layout's 20-step epoch from the dist
    phase's weights must equal that phase's bit for bit. Returns the
    launches; the group is destroyed before this returns."""
    import datetime

    import torch.distributed as dist

    make, w0 = ctx["make"], ctx["w0"]
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=MP_CHILD_TIMEOUT_S))
    total = {}
    try:
        for layout in LAYOUTS:
            tr = make(layout)
            check(tr.my_parts == [0, 1] and tr.world_size == 1,
                  f"world 1 holds both parts: {tr.my_parts}")
            # the main path under NCCL: every kernel count starts at 0
            reset_counts(wrappers)
            t0 = time.perf_counter()
            out = tr.train(init_params=w0)
            wall = time.perf_counter() - t0
            launches = read_counts(wrappers)
            steps = out["step"]
            want_params, want_losses, want_acc = ctx["want"][layout]
            rec = out["history"][0]
            check(rec["losses"] == want_losses, f"NCCL {layout}: losses "
                  f"{rec['losses']} differ from the single process's "
                  f"{want_losses}")
            check(all(torch.equal(v, want_params[k])
                      for k, v in out["params"].items()),
                  f"NCCL {layout}: parameters differ from the single "
                  "process's")
            check((rec["val_acc"], rec["test_acc"]) == want_acc,
                  f"NCCL {layout}: evaluate {rec['val_acc']}, "
                  f"{rec['test_acc']} vs {want_acc}")
            gathers = 3 if layout == "owner" else 2
            check(launches == {"fanout_agg": 4 * steps,
                               "gather_rows": gathers * steps,
                               "scatter_add_rows": 2 * steps,
                               "tree_sample": 0},
                  f"NCCL {layout}: {launches} launches in {steps} steps")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            extra = {}
            if layout == "owner":
                extra = collective_us(torch, dist, tr, tr.pair_cap)
            emit(phase="dist_mp", part="nccl_world1", card=card,
                 layout=layout, backend=dist.get_backend(), world_size=1,
                 steps=steps, bit_identical_to_single_process=True,
                 launches=launches, pair_cap=tr.pair_cap,
                 **step_numbers(rec, steps), train_call_s=wall,
                 eval_s=rec["eval_s"], **extra)
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the NCCL group is gone")
    return total


def two_rank_hostfile(tmp: str) -> str:
    """A hostfile of two ranks on this host, at a free port."""
    path = os.path.join(tmp, "hostfile")
    port = free_port()
    with open(path, "w") as f:
        f.write(f"127.0.0.1 {port} worker-0 slots=1\n"
                f"127.0.0.1 {port} worker-1 slots=1\n")
    return path


def run_two_ranks(code: str, spec_of, tmp: str, what: str) -> list:
    """Run ``python -c code <spec>`` as ranks 0 and 1 of a
    ``TPU_OPERATOR_DIST=1`` job, ``spec_of(r)`` the JSON spec of rank
    ``r``; a rank that fails or hangs past ``MP_CHILD_TIMEOUT_S`` ends
    both and fails the run. Returns each rank's output."""
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in (0, 1):
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, json.dumps(spec_of(r))],
                env=dict(os.environ, TPU_OPERATOR_DIST="1",
                         TPU_OPERATOR_RANK=str(r)),
                stdout=logs[-1], stderr=subprocess.STDOUT))
        while (time.perf_counter() - t0 < MP_CHILD_TIMEOUT_S
               and any(p.poll() is None for p in procs)
               and not any(p.poll() for p in procs)):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"{what}: rank {r} failed or hung past "
              f"{MP_CHILD_TIMEOUT_S} s (rc {p.returncode}):\n{out[-4000:]}")
    return outs


def two_ranks(torch, ctx, work: str, card: str) -> dict:
    """(c) Two processes on the card over gloo (which takes CUDA tensors
    for ``all_reduce``, ``all_gather`` and ``all_to_all_single``; NCCL
    refuses two ranks on one GPU), each with its own part, through the
    entry point: equal losses on both ranks, within rtol 1e-6 of the
    single process's at every step; then each rank's µs of the step's
    three collectives in a second gloo group. Returns both ranks'
    launches."""
    import numpy as np

    total = {}
    for layout in LAYOUTS:
        tmp = os.path.join(work, f"mp_{layout}")
        os.makedirs(tmp, exist_ok=True)
        hostfile = two_rank_hostfile(tmp)
        argv = ["--graph_name", "ogbn-products", "--ip_config", hostfile,
                "--part_config", ctx["book"], "--num_epochs", "1",
                "--batch_size", str(BATCH_TRAIN), "--fan_out",
                ",".join(map(str, FANOUTS)), "--lr", str(LR),
                "--num_hidden", str(HIDDEN), "--num_classes", str(CLASSES),
                "--eval_every", "1", "--feats_layout", layout,
                "--device", "cuda:0", "--backend", "gloo",
                "--seed", str(ctx["seed"])]
        probe_port = free_port()
        t0 = time.perf_counter()
        outs = run_two_ranks(DIST_MP_CHILD, lambda r: {
            "repo": REPO, "argv": argv, "out": os.path.join(tmp, f"rank{r}"),
            "probe_port": probe_port, "pair_cap": ctx["pair_cap"],
            "feat": FEAT}, tmp, layout)
        wall = time.perf_counter() - t0
        res = []
        for r in (0, 1):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                res.append(json.load(f))
        done = [[ln for ln in out.splitlines() if "done, final loss" in ln]
                for out in outs]
        losses = res[0]["losses"]
        check(res[1]["losses"] == losses,
              f"{layout}: the ranks' losses differ")
        want_params, want_losses, want_acc = ctx["want"][layout]
        rel = np.abs(np.subtract(losses, want_losses)) / np.abs(want_losses)
        check(len(losses) == len(want_losses) and float(rel.max()) <= 1e-6,
              f"{layout}: two-rank losses {losses} vs the single "
              f"process's {want_losses}: relative {rel.tolist()} > 1e-6")
        with np.load(os.path.join(tmp, "rank0.npz")) as z:
            pdiff = max(float(np.abs(z[k] - want_params[k].cpu().numpy())
                              .max()) for k in want_params)
        steps = len(losses)
        gathers = 2 if layout == "owner" else 1
        for r in (0, 1):
            want = {"fanout_agg": 2 * steps, "gather_rows": gathers * steps,
                    "scatter_add_rows": steps, "tree_sample": 0}
            check(res[r]["launches"] == want, f"{layout} rank {r}: "
                  f"{res[r]['launches']} launches in {steps} steps")
            for k, v in res[r]["launches"].items():
                total[k] = total.get(k, 0) + v
        emit(phase="dist_mp", part="two_ranks", card=card, layout=layout,
             backend="gloo", device="cuda:0", world_size=2, steps=steps,
             done_lines=[d[0] if d else None for d in done],
             losses_equal_across_ranks=True,
             loss_rel_err_max=float(rel.max()),
             param_max_abs_diff_to_single_process=pdiff,
             val_acc=res[0]["val_acc"], test_acc=res[0]["test_acc"],
             single_process_acc=list(want_acc),
             launches_per_rank=[x["launches"] for x in res],
             step_ms_mean=[float(np.mean(x["step_s"]) * 1e3) for x in res],
             stall_ms_per_step=[x["stall_s"] * 1e3 / steps for x in res],
             dispatch_ms_per_step=[x["dispatch_s"] * 1e3 / steps
                                   for x in res],
             seeds_per_sec=[x["seeds_per_sec"] for x in res],
             eval_s=[x["eval_s"] for x in res], wall_s=wall,
             gloo_cuda_collective_us=[x["collective_us"] for x in res],
             collective_shapes=dict(all_reduce_floats=sum(
                 v.numel() for v in want_params.values()) + 2,
                 all_to_all_ids=2 * ctx["pair_cap"],
                 all_to_all_rows=[2 * ctx["pair_cap"], FEAT]))
    return total


def owner_serve_records(torch, args, ops, ctx, card: str):
    """(d) ``gather_rows`` at the two-rank owner-serve shape: the rows
    owner part 0 serves both requesters from its own store (its core and
    cache rows, then a zero row) in one step of the owner layout."""
    import numpy as np

    _, gather, _ = ops
    own = ctx["own"]
    R = own._rows_per_slot
    serve = own._sample_all(ctx["perm"], 0, 20_000)[0]["exch_serve"]
    store = torch.cat([own.feats[0], own.feats.new_zeros(1,
                                                         own.feats.shape[-1])])
    idx = torch.from_numpy(np.where(serve[0] >= 0, serve[0], R)
                           .astype(np.int64).reshape(-1)).to("cuda")
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    return gather_records(torch, gather, [("dist_mp_owner_serve", store, idx)],
                          flush, args.iters, card)


def dist_mp_phase(torch, args, ops, wrappers, ctx, work: str, card: str):
    """The multi-process form of ``DistTrainer``: (a) sampler widths,
    (b) an NCCL group of world size 1, (c) two ranks on the card over
    gloo, (d) the owner-serve gather's kernel line. Returns the
    launches of (b) and (c) and the kernel records."""
    sampler_widths(torch, ctx, card)
    nccl = nccl_world_one(torch, wrappers, ctx, card)
    ranks = two_ranks(torch, ctx, work, card)
    records = owner_serve_records(torch, args, ops, ctx, card)
    return {k: nccl[k] + ranks[k] for k in nccl}, records


# ------------------------------------------------------- device sampler
DEV_K = 4              # steps_per_call of the captured runs
DEV_RESUME_K = 2       # the device-mode resume: calls of 2 steps
DEV_CPU_STEPS = 5      # device-sampler steps of the card-against-CPU check
PROFILE_CALLS = 5      # calls traced by torch.profiler in each mode
PROFILE_TRACES = 3     # traces of a mode until its kernel counts match
PROFILE_RANGE = "gnn_profile.calls"  # the counted calls' host range


def gnn_kernel_kind(name: str) -> str:
    """What launched a device kernel of a GNN step: one of the port's
    kernels, cuBLAS, a copy, or one of PyTorch's plain ops."""
    for kernel, key in (("fanout_agg", "fanout_agg"),
                        ("gather_rows", "gather_rows"),
                        ("scatter_add_rows", "segment_sum_kernel"),
                        ("scatter_add_rows", "add_partials_kernel"),
                        ("tree_sample", "tree_sample_layer")):
        if key in name:
            return kernel
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "cublas", "cutlass", "xmma")):
        return "cublas"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "plain"


def gnn_profile(torch, wrappers, mode: str, steps_per_call: int, run_call,
                card: str, phase: str = "device_sampler",
                kernels=("fanout_agg", "gather_rows", "scatter_add_rows",
                         "tree_sample")) -> dict:
    """``PROFILE_CALLS`` calls of ``run_call()`` (``steps_per_call``
    steps each, warmed up by one call before) under ``torch.profiler``
    with CPU and CUDA activities: wall ms, device µs and launches per
    step, device µs per step by kernel kind and by kernel, the device's
    idle share of the wall time, and the host µs per step of the 10 CPU
    ops with the most self time. Each kernel's launches in the trace
    must equal what its wrapper counted over the traced calls: in a
    graph replay, the counts ``GraphedCall`` adds. The tracer has
    dropped a step's kernels from a trace (one of 20 steps, once), so a
    mode is traced again, up to ``PROFILE_TRACES`` times, until the two
    agree; the record keeps the disagreements. It has also missed the
    first kernels of a trace's first graph replay (GAT at K = 4, late in
    a smoke run, every time), so each trace starts with one more call
    and a marker kernel, and counts only the device events after the
    marker and the host events inside ``PROFILE_RANGE``. Each of
    ``kernels`` must have device time in the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_call()
    torch.cuda.synchronize()
    steps = PROFILE_CALLS * steps_per_call
    misses = []
    for _ in range(PROFILE_TRACES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_call()
            torch.cuda.synchronize()
            torch.cuda._sleep(1)        # the marker: spin_kernel
            torch.cuda.synchronize()
            before = read_counts(wrappers)
            # idle margins inside the trace's window on both sides
            time.sleep(0.005)
            with torch.profiler.record_function(PROFILE_RANGE):
                t0 = time.perf_counter()
                for _ in range(PROFILE_CALLS):
                    run_call()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(0.005)
        counted = {k: v - before[k]
                   for k, v in read_counts(wrappers).items()}
        marks = [e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "spin_kernel" in e.name]
        check(marks, f"profile {mode}: no marker kernel in the trace")
        # the device-side copies of host annotations (Adam's step range)
        # span kernels counted on their own
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.time_range.start > marks[-1]
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith("Optimizer.")]
        check(events,
              f"profile {mode}: the profiler recorded no device event")
        # one event a wrapper's launch (a long-target scatter plan's
        # second kernel, add_partials_kernel, is not a launch of its own)
        traced = {w: sum(key in e.name for e in events)
                  for w, key in (("fanout_agg", "fanout_agg"),
                                 ("gather_rows", "gather_rows"),
                                 ("scatter_add_rows", "segment_sum_kernel"),
                                 ("tree_sample", "tree_sample_layer"))}
        if traced == counted:
            break
        first = sorted(events, key=lambda e: e.time_range.start)[:12]
        misses.append({"traced": traced, "counted": counted,
                       "first_kernels": [short_kernel_name(e.name)[:60]
                                         for e in first]})
    check(traced == counted, f"profile {mode}: in {PROFILE_TRACES} traces "
          f"the kernel launches differ from the wrappers' counts: {misses}")
    by_name, count, by_kind = {}, {}, {}
    for e in events:
        us_ = e.time_range.elapsed_us()
        name = short_kernel_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + us_
        count[name] = count.get(name, 0) + 1
        kind = gnn_kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + us_
    for kernel in kernels:
        check(by_kind.get(kernel, 0.0) > 0,
              f"profile {mode}: no {kernel} device time")
    window = next(e.time_range for e in prof.events()
                  if e.name == PROFILE_RANGE)
    host = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CPU and e.name != PROFILE_RANGE
                and window.start <= e.time_range.start
                and e.time_range.end <= window.end):
            agg = host.setdefault(e.key, [0.0, 0])
            agg[0] += e.self_cpu_time_total
            agg[1] += 1
    cpu = sorted(host.items(), key=lambda kv: kv[1][0], reverse=True)
    device_us = sum(by_kind.values()) / steps
    rec = dict(phase=phase, part="profile", card=card, mode=mode,
               steps_per_call=steps_per_call, calls=PROFILE_CALLS,
               steps=steps, device_events_recorded=bool(events),
               launches_traced_per_step={k: v / steps
                                         for k, v in traced.items()},
               trace_misses=misses,
               wall_ms_per_step=wall_ms / steps,
               device_us_per_step=device_us,
               device_idle_share=1.0 - device_us * 1e-3 / (wall_ms / steps),
               launches_per_step=len(events) / steps,
               device_us_per_step_by_kind={k: v / steps for k, v in
                                           sorted(by_kind.items())},
               by_kernel=sorted(({"name": k, "us_per_step": v / steps,
                                  "launches_per_step": count[k] / steps}
                                 for k, v in by_name.items()),
                                key=lambda r: -r["us_per_step"])[:25],
               host_top10=[{"op": op, "self_cpu_us_per_step": us_ / steps,
                            "calls_per_step": n / steps}
                           for op, (us_, n) in cpu[:10]],
               host_self_cpu_us_per_step=sum(us_ for _, (us_, _) in cpu)
               / steps)
    emit(**rec)


def tree_check_phase(torch, args, ops, tr, card: str):
    """The card's draws, tree blocks, input ids and tree plans against
    the CPU's for one batch of the training stream (bit for bit, the key
    given as an int and as a device step counter), the sampling's host
    and device ms, then each kernel against its plain version at the
    tree's shapes. Returns the kernel records."""
    import numpy as np

    from dgl_operator_tpu_torch.ops.device_sample import (TreeSampler,
                                                          device_csr,
                                                          draw_counters,
                                                          draw_key,
                                                          tree_draws)
    from dgl_operator_tpu_torch.ops.scatter import ScatterPlan

    fanout, gather, scatter = ops
    seeds_np = tr.train_ids[:BATCH_TRAIN].astype(np.int32)
    seeds = torch.from_numpy(seeds_np).to("cuda")
    key = draw_key(args.seed, 7)
    counter = torch.full((1,), 7, dtype=torch.int64, device="cuda")
    card_counters = draw_counters(BATCH_TRAIN, FANOUTS, "cuda")
    card_draws = tree_draws(draw_key(args.seed, counter), card_counters,
                            FANOUTS)
    cpu_tree = TreeSampler(BATCH_TRAIN, FANOUTS, "cpu")
    cpu_draws = tree_draws(key, draw_counters(BATCH_TRAIN, FANOUTS, "cpu"),
                           FANOUTS)
    check(all(torch.equal(a.cpu(), b) for a, b in zip(card_draws,
                                                      cpu_draws)),
          "the card's draws differ from the CPU's")
    blocks, inputs = tr._tree.sample(tr._indptr, tr._indices, seeds, key)
    ip, ix = device_csr(tr.csc, "cpu")
    cblocks, cinputs = cpu_tree.sample(ip, ix, torch.from_numpy(seeds_np),
                                       key)
    check(torch.equal(inputs.cpu(), cinputs), "input ids differ")
    for b, c in zip(blocks, cblocks):
        check(b.num_src == c.num_src and torch.equal(b.nbr.cpu(), c.nbr)
              and torch.equal(b.mask.cpu(), c.mask), "tree blocks differ")
    for k in ScatterPlan.FIELDS:
        check(torch.equal(getattr(blocks[1].plan, k).cpu(),
                          getattr(cblocks[1].plan, k)),
              f"the card's tree plan {k} differs from the CPU's")
    torch.cuda.synchronize()
    sample_host_ms = host_ms(lambda: tr._tree.sample(
        tr._indptr, tr._indices, seeds, key), 20)
    sample_ms = time_warm_ms(torch, lambda: tr._tree.sample(
        tr._indptr, tr._indices, seeds, key), args.iters)
    emit(phase="device_sampler", part="draws_cpu", card=card,
         seeds=BATCH_TRAIN, caps=tr.caps,
         draws=[list(d.shape) for d in card_draws],
         valid_slots=[int((b.mask > 0).sum()) for b in blocks],
         unique_inputs=int(inputs.unique().numel()),
         plan_nnz=int(blocks[1].plan.offsets[-1]),
         draws_equal=True, blocks_equal=True, inputs_equal=True,
         plan_equal=True, sample_host_ms=sample_host_ms,
         sample_device_ms=sample_ms)

    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 9)
    b0, b1 = blocks
    records = [tree_sample_record(torch, tr, seeds, counter, flush,
                                  args.iters, card)]
    records += gather_records(torch, gather, [("tree_feats", tr.feats,
                                                inputs)],
                              flush, args.iters, card)
    h1 = torch.randn(b1.num_src, HIDDEN, device="cuda", generator=gen)
    records += fanout_records(torch, fanout, [
        ("tree_block0", gather.gather_rows(tr.feats, inputs), b0.nbr,
         b0.mask),
        ("tree_block1", h1, b1.nbr, b1.mask)], flush, args.iters, card)
    g1 = torch.randn(BATCH_TRAIN, HIDDEN, device="cuda", generator=gen)
    records += scatter_records(torch, scatter, [
        ("tree_block1_bwd", g1, b1.nbr, b1.mask, b1.num_src, True,
         b1.plan)], flush, args.iters, card)
    return records


def tree_sample_record(torch, tr, seeds, counter, flush, iters: int,
                       card: str) -> dict:
    """The tree-sampling kernel (``csrc/tree_sample.cu``, one launch a
    layer) at the trainer's shapes, keyed on a device step counter,
    against the plain torch path it replaced (the draws' hash, the
    tree's index ops and ``tree_scatter_plan``): bit for bit, launches a
    call, µs cold and warm, the plain path's µs cold, and the bound of
    its least bytes: each row's ``indptr`` pair and each slot's
    ``indices`` entry read, the seeds read, the input ids, the masks
    and the plans written."""
    from dgl_operator_tpu_torch.ops import device_sample as ds
    from dgl_operator_tpu_torch.ops.scatter import ScatterPlan

    ip, ix, sampler = tr._indptr, tr._indices, tr._tree
    counters = ds.draw_counters(BATCH_TRAIN, FANOUTS, "cuda")

    def kernel():
        return sampler.sample(ip, ix, seeds, ds.draw_key(7, counter))

    def plain():
        return ds.sample_fanout_tree_from_draws(
            ip, ix, seeds, FANOUTS,
            ds.tree_draws(ds.draw_key(7, counter), counters, FANOUTS),
            positions=sampler.positions, plans=True,
            slot_plans=sampler.slot_plans)

    before = ds.tree_sample.launches
    (gb, gi), (wb, wi) = kernel(), plain()
    torch.cuda.synchronize()
    launches = ds.tree_sample.launches - before
    check(launches == len(FANOUTS) + sampler.slot_plans,
          f"tree_sample: {launches} launches a call")
    check(torch.equal(gi, wi), "tree_sample: input ids differ")
    for g_, w_ in zip(gb, wb):
        check(torch.equal(g_.mask, w_.mask) and torch.equal(g_.nbr, w_.nbr)
              and (g_.plan is None) == (w_.plan is None),
              "tree_sample: blocks differ")
        if w_.plan is not None:
            check(all(torch.equal(getattr(g_.plan, k), getattr(w_.plan, k))
                      for k in ScatterPlan.FIELDS),
                  "tree_sample: plans differ")
    isz = ip.element_size()
    nbytes = seeds.numel() * seeds.element_size() + gi.numel() * isz
    for blk in gb:
        n, f = blk.mask.shape
        nbytes += n * 2 * isz + n * f * (isz + 1)
        if blk.plan is not None:
            nbytes += blk.plan.nbytes()
    b_ms, b_by = bound_ms(nbytes, 0)
    rec = dict(phase="kernel", kernel="tree_sample", shape="tree_sample",
               dtype=str(ip.dtype).replace("torch.", ""),
               batch=BATCH_TRAIN, fanouts=list(FANOUTS), card=card,
               launches_per_call=launches, bit_equal=True, max_abs_err=0.0,
               ms=time_cold_ms(torch, kernel, flush, iters),
               warm_ms=time_warm_ms(torch, kernel, iters),
               plain_ms=time_cold_ms(torch, plain, flush, iters),
               library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
    emit(**rec)
    return rec


def device_run_record(rec: dict, steps: int, k: int) -> dict:
    """Step numbers of one device-sampler epoch record of calls of
    ``k`` steps: host ms per step (a replay returns before the card
    finishes, so a call's host time is its enqueue), and the epoch's
    wall time, which ends in a sync, per step after the first call (the
    warm-up and capture at K > 1)."""
    import numpy as np

    step_ms = np.asarray(rec["step_s"]) * 1e3
    first_ms = float(step_ms[:k].sum())
    return dict(first_call_ms=first_ms,
                steady_ms_per_step=(rec["time"] * 1e3 - first_ms)
                / max(steps - k, 1),
                step_ms_mean=float(step_ms.mean()),
                step_ms_p50=float(np.percentile(step_ms, 50)),
                **{f"{k}_ms_per_step": rec.get(k, 0.0) * 1e3 / steps
                   for k in ("sample", "stall", "dispatch")},
                seeds_per_sec=rec["seeds_per_sec"], epoch_s=rec["time"],
                calls=rec["calls"], graph=rec["graph"],
                graph_replays=rec["graph_replays"])


def device_sampled_phase(torch, args, wrappers, g, trainer, card: str):
    """``SampledTrainer`` with the device sampler over the train phase's
    40,000 ids (40 steps, dropout 0.5): K = 1 and K = 4 (a CUDA graph a
    call), losses and parameters bit-equal, launches per step; then 5
    steps on the card against the CPU (dropout 0, synced as in
    ``train_cpu``), and the ``profile`` lines of host K = 1, device
    K = 1 and device K = 4. Returns the launches of the two runs."""
    import numpy as np

    from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                    state_dict_to_flax)
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    w0 = state_dict_to_flax(DistSAGE(
        FEAT, HIDDEN, CLASSES, device="cpu",
        generator=torch.Generator().manual_seed(args.seed + 3)).state_dict())

    def make(device="cuda", **fields):
        cfg = TrainConfig(**{**dict(
            batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR, num_epochs=1,
            eval_every=0, seed=args.seed, sampler="device"), **fields})
        return SampledTrainer(DistSAGE(FEAT, HIDDEN, CLASSES, device=device),
                              g, cfg, train_ids=trainer.train_ids,
                              device=device)

    runs, total = {}, {}
    for K in (1, DEV_K):
        tr = make(steps_per_call=K)
        # the main path: every kernel count starts at 0 here
        reset_counts(wrappers)
        t0 = time.perf_counter()
        out = tr.train(init_params=w0)
        wall = time.perf_counter() - t0
        launches = read_counts(wrappers)
        steps = out["step"]
        rec = out["history"][0]
        check(steps == len(trainer.train_ids) // BATCH_TRAIN
              == len(rec["losses"]), f"device K={K}: {steps} steps")
        # the warm-up forward adds 1 gather, 2 aggregations and its
        # tree's samples
        check(launches == sage_launches(steps, device=True),
              f"device K={K}: per step 1 gather_rows, 2 fanout_agg, 1 "
              f"scatter_add_rows, 2 tree_sample: {launches} in {steps} "
              f"steps")
        check(bool(np.isfinite(rec["losses"]).all()), "finite losses")
        check(rec["graph"] is (K > 1), f"device K={K}: graph {rec['graph']}")
        if K > 1:
            check(rec["graph_replays"] == steps // K - 1,
                  f"{rec['graph_replays']} replays of {steps // K} calls")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        runs[K] = (tr, out)
        emit(phase="device_sampler", part="sampled", card=card,
             steps_per_call=K, steps=steps, seeds=steps * BATCH_TRAIN,
             caps=tr.caps, launches=launches,
             launches_per_step={k: (v - sage_launches(0, device=True)[k])
                                / steps for k, v in launches.items()},
             loss_first5=float(np.mean(rec["losses"][:5])),
             loss_last5=float(np.mean(rec["losses"][-5:])),
             losses=rec["losses"], train_call_s=wall,
             **device_run_record(rec, steps, K))
    (_, one), (tr4, four) = runs[1], runs[DEV_K]
    check(one["history"][0]["losses"] == four["history"][0]["losses"],
          f"device K={DEV_K} losses differ from K=1: "
          f"{four['history'][0]['losses']} vs {one['history'][0]['losses']}")
    check(all(torch.equal(v, one["params"][k])
              for k, v in four["params"].items()),
          f"device K={DEV_K} parameters differ from K=1")
    emit(phase="device_sampler", part="sampled_k_equal", card=card,
         steps_per_call=[1, DEV_K], dropout=0.5, losses_bit_equal=True,
         params_bit_equal=True)

    # the card against the CPU, each step from the CPU's state
    cpu_card = [make(device=dev, dropout=0.0) for dev in ("cuda", "cpu")]
    ids = np.random.default_rng(args.seed).permutation(trainer.train_ids)
    for tr_ in cpu_card:
        tr_.model.load_state_dict({k: v.to(tr_.device) for k, v in
                                   one["params"].items()})
        tr_._start_device_run(len(ids) // BATCH_TRAIN).stage([ids])
    gl, cl, gaps, (gs, cs) = synced_step_gaps(
        torch, *cpu_card, list(range(DEV_CPU_STEPS)),
        lambda tr_, b: tr_.train_call((b, b, 1))[0][0])
    rel, worst = check_step_gaps("device_sampler", gl, cl, gaps)
    emit(phase="device_sampler", part="sampled_cpu", card=card,
         steps=DEV_CPU_STEPS, synced=True, card_losses=gl, cpu_losses=cl,
         loss_rel_err=rel, grad_rel_err_max=worst, card_s=gs, cpu_s=cs)

    # the traces: host K = 1 (the train phase's trainer), device K = 1,
    # device K = 4
    rng = np.random.default_rng(args.seed + 4)
    # the warm-up's and each trace's calls cycle over one trace's batches
    mbs = itertools.cycle([trainer.sample(
        rng.choice(trainer.train_ids, BATCH_TRAIN, replace=False), 20_000 + i)
        for i in range(PROFILE_CALLS + 1)])
    gnn_profile(torch, wrappers, "host_k1", 1,
                lambda: trainer.train_step(next(mbs)), card,
                kernels=("fanout_agg", "gather_rows", "scatter_add_rows"))
    spe = len(ids) // BATCH_TRAIN
    for K, (tr, _) in runs.items():
        tr._start_device_run(spe).stage([ids])
        gnn_profile(torch, wrappers, f"device_k{K}", K,
                    bank_calls(tr, K, spe), card)
        tr._run = None
    return total


def bank_calls(tr, k: int, spe: int):
    """A device-sampler trainer's next call of ``k`` steps, from bank
    rows that cycle within an epoch of ``spe`` steps."""
    calls = iter(range(10**6))

    def run_call():
        c = next(calls)
        b = (c * k) % (spe - k + 1)
        return tr.train_call((b, c * k, k))
    return run_call


def device_dist_phase(torch, args, wrappers, ctx, work: str, card: str):
    """``DistTrainer`` with the device sampler over the dist phase's book
    and weights (20 steps an epoch): each layout at K = 1 and K = 4, all
    four bit-equal; the same at K = 4 under an in-process NCCL group of
    world size 1 (captured); two ranks through ``examples/train_dist.py
    --sampler device`` over gloo (owner layout); and a device-mode resume
    at K = 2 cut after 10 of the 20 steps. Returns the launches."""
    import datetime

    import numpy as np
    import torch.distributed as dist

    make, w0 = ctx["make"], ctx["w0"]
    P = 2
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def want_launches(layout, steps, group):
        # replicated: a gather a slot; owner: one gather over every
        # slot's requests (a process's, in a group)
        gathers = P if layout == "replicated" else 1
        return {"fanout_agg": 2 * P * steps, "gather_rows": gathers * steps,
                "scatter_add_rows": P * steps,
                "tree_sample": tree_launches(P * steps)}

    want = None
    profiled = {}
    for layout in LAYOUTS:
        for K in (1, DEV_K):
            tr = make(layout, sampler="device", steps_per_call=K,
                      eval_every=0)
            profiled[layout, K] = tr
            # the main path: every kernel count starts at 0 here
            reset_counts(wrappers)
            t0 = time.perf_counter()
            out = tr.train(init_params=w0)
            wall = time.perf_counter() - t0
            launches = read_counts(wrappers)
            steps = out["step"]
            rec = out["history"][0]
            check(launches == want_launches(layout, steps, False),
                  f"dist device {layout} K={K}: {launches} in {steps} steps")
            check(rec["graph"] is (K > 1), f"dist device {layout} K={K}: "
                  f"graph {rec['graph']}")
            check(bool(np.isfinite(rec["losses"]).all()), "finite losses")
            add(launches)
            if want is None:
                want = ({k: v.clone() for k, v in out["params"].items()},
                        rec["losses"])
            check(rec["losses"] == want[1], f"dist device {layout} K={K}: "
                  f"losses {rec['losses']} differ from replicated K=1's "
                  f"{want[1]}")
            check(all(torch.equal(v, want[0][k])
                      for k, v in out["params"].items()),
                  f"dist device {layout} K={K}: parameters differ")
            emit(phase="device_sampler", part="dist", card=card,
                 layout=layout, steps_per_call=K, parts=P, steps=steps,
                 seeds=steps * P * BATCH_TRAIN, caps=tr.caps,
                 launches=launches,
                 launches_per_step={k: v / steps for k, v in
                                    launches.items()},
                 bit_equal_to_replicated_k1=True, losses=rec["losses"],
                 h2d_bytes_per_step=rec["h2d_bytes_per_step"],
                 halo_rows_per_step=rec.get("halo_rows_per_step"),
                 exchange_bytes_per_step=tr.exchange_bytes_per_step,
                 train_call_s=wall, **device_run_record(rec, steps, K))

    perm = profiled["replicated", 1]._permute(np.random.default_rng(
        args.seed))
    for (layout, K), tr in profiled.items():
        tr._start_device_run().stage(perm)
        gnn_profile(torch, wrappers, f"dist_{layout}_device_k{K}", K,
                    bank_calls(tr, K, tr.steps_per_epoch), card)
        tr._run = None
    del profiled

    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=MP_CHILD_TIMEOUT_S))
    try:
        for layout in LAYOUTS:
            tr = make(layout, sampler="device", steps_per_call=DEV_K,
                      eval_every=0)
            reset_counts(wrappers)
            t0 = time.perf_counter()
            out = tr.train(init_params=w0)
            wall = time.perf_counter() - t0
            launches = read_counts(wrappers)
            steps = out["step"]
            rec = out["history"][0]
            check(rec["graph"] is True, "NCCL: the K-step call is a graph")
            check(rec["losses"] == want[1] and all(
                torch.equal(v, want[0][k]) for k, v in
                out["params"].items()), f"NCCL device {layout}: losses "
                f"{rec['losses']} or parameters differ from one process's")
            check(launches == want_launches(layout, steps, True),
                  f"NCCL device {layout}: {launches} in {steps} steps")
            add(launches)
            emit(phase="device_sampler", part="nccl_world1", card=card,
                 layout=layout, backend=dist.get_backend(), world_size=1,
                 steps_per_call=DEV_K, steps=steps, launches=launches,
                 bit_identical_to_single_process=True, train_call_s=wall,
                 **device_run_record(rec, steps, DEV_K))
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the NCCL group is gone")

    layout = "owner"
    tmp = os.path.join(work, "mp_device")
    os.makedirs(tmp, exist_ok=True)
    argv = ["--graph_name", "ogbn-products", "--ip_config",
            two_rank_hostfile(tmp), "--part_config", ctx["book"],
            "--num_epochs", "1", "--batch_size", str(BATCH_TRAIN),
            "--fan_out", ",".join(map(str, FANOUTS)), "--lr", str(LR),
            "--num_hidden", str(HIDDEN), "--num_classes", str(CLASSES),
            "--eval_every", "1", "--feats_layout", layout,
            "--sampler", "device", "--device", "cuda:0", "--backend",
            "gloo", "--seed", str(ctx["seed"])]
    probe_port = free_port()
    t0 = time.perf_counter()
    run_two_ranks(DIST_MP_CHILD, lambda r: {
        "repo": REPO, "argv": argv, "out": os.path.join(tmp, f"rank{r}"),
        "probe_port": probe_port, "pair_cap": 64, "feat": FEAT}, tmp,
        "device two ranks")
    wall = time.perf_counter() - t0
    res = []
    for r in (0, 1):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res.append(json.load(f))
    losses = res[0]["losses"]
    check(res[1]["losses"] == losses, "device two ranks: losses differ")
    rel = np.abs(np.subtract(losses, want[1])) / np.abs(want[1])
    check(len(losses) == len(want[1]) and float(rel.max()) <= 1e-6,
          f"device two ranks: losses {losses} vs one process's {want[1]}: "
          f"relative {rel.tolist()} > 1e-6")
    steps = len(losses)
    for r in (0, 1):
        check(res[r]["launches"] == {"fanout_agg": 2 * steps,
                                     "gather_rows": steps,
                                     "scatter_add_rows": steps,
                                     "tree_sample": tree_launches(steps)},
              f"device two ranks rank {r}: {res[r]['launches']}")
        add(res[r]["launches"])
    emit(phase="device_sampler", part="two_ranks", card=card, layout=layout,
         backend="gloo", device="cuda:0", world_size=2, steps=steps,
         losses_equal_across_ranks=True, loss_rel_err_max=float(rel.max()),
         launches_per_rank=[x["launches"] for x in res],
         step_ms_mean=[float(np.mean(x["step_s"]) * 1e3) for x in res],
         dispatch_ms_per_step=[x["dispatch_s"] * 1e3 / steps for x in res],
         seeds_per_sec=[x["seeds_per_sec"] for x in res],
         val_acc=res[0]["val_acc"], test_acc=res[0]["test_acc"],
         wall_s=wall)

    resume_check(torch, "DistTrainer device K=2",
                 lambda **fields: make("replicated", sampler="device",
                                       steps_per_call=DEV_RESUME_K,
                                       eval_every=0, **fields),
                 w0, want, 10, os.path.join(work, "ckpt_device"), card,
                 method="train_call")
    return total


def device_sampler_phase(torch, args, ops, wrappers, g, trainer, ctx,
                         work: str, card: str):
    """The device sampler and ``steps_per_call``: draws and plans against
    the CPU, the kernels at the tree's shapes, ``SampledTrainer`` and
    ``DistTrainer`` runs. Returns their launches and the kernel
    records."""
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    probe = SampledTrainer(
        DistSAGE(FEAT, HIDDEN, CLASSES, device="cuda"), g,
        TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS,
                    sampler="device", seed=args.seed),
        train_ids=trainer.train_ids)
    records = tree_check_phase(torch, args, ops, probe, card)
    del probe
    sampled = device_sampled_phase(torch, args, wrappers, g, trainer, card)
    dist_launches = device_dist_phase(torch, args, wrappers, ctx, work, card)
    return {k: sampled[k] + dist_launches[k] for k in sampled}, records


# ------------------------------------------------------------------ kge
# the reference's DGL-KE job: ComplEx on FB15k, dim 400, gamma 143, lr
# 0.25, batch 1024, 256 negatives shared by the whole batch, -adv at
# temperature 1, 1000 steps (cut to the depths below)
KGE_DIM, KGE_GAMMA, KGE_LR = 400, 143.0, 0.25
KGE_BATCH, KGE_NEG = 1024, 256
KGE_STEPS = 200        # KGETrainer: a depth cut of the job's 1000 steps
KGE_CPU_STEPS = 5      # card-against-CPU steps
KGE_DIST_STEPS = 50    # DistKGETrainer over the 2-part book
KGE_RESUME_AT = 25     # its resume check: cut after 25 of the 50 steps
KGE_EVAL = 500         # test triples ranked
# RESCAL's and TransR's relation rows are D^2 wide
KGE_SCORER_DIM = {"RESCAL": 100, "TransR": 100}
# ranks may differ only where a candidate's score ties the target's to
# within the two devices' float32 rounding: metrics within these bounds
KGE_EVAL_TOL = {"MR": 0.01, "MRR": 0.005, "HITS@1": 0.005,
                "HITS@3": 0.005, "HITS@10": 0.005}
# one rank of the kge phase's two-rank run: the entry point's main on the
# card, the kernel counts of this process and the result written for the
# parent; then, in a second gloo group, the µs of the step's all_to_all
# of rows and its all_reduce on CUDA tensors of the step's shapes
KGE_MP_CHILD = """
import datetime, json, os, sys, time
spec = json.loads(sys.argv[1])
sys.path.insert(0, spec["repo"])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from dgl_operator_tpu_torch.examples.train_kge import main
from dgl_operator_tpu_torch.ops import fanout, gather, scatter
wrappers = (fanout.fanout_agg, gather.gather_rows, scatter.scatter_add_rows)
for w in wrappers:
    w.launches = 0
out = main(spec["argv"])
launches = {w.__name__: w.launches for w in wrappers}
dist = torch.distributed
dist.init_process_group(
    "gloo", init_method=f"tcp://127.0.0.1:{spec['probe_port']}",
    world_size=2, rank=int(os.environ["TPU_OPERATOR_RANK"]),
    timeout=datetime.timedelta(seconds=120))
rows = torch.zeros(spec["rows"], spec["dim"], device="cuda")
rows_out = torch.empty_like(rows)
bucket = torch.zeros(spec["bucket"], device="cuda")


def us(fn, n=20):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


collective_us = {
    "all_to_all_rows": us(lambda: dist.all_to_all_single(rows_out, rows)),
    "all_reduce": us(lambda: dist.all_reduce(bucket))}
dist.destroy_process_group()
with open(spec["out"] + ".json", "w") as f:
    json.dump({"losses": out["losses"], "step_s": out["step_s"],
               "stall_s": out["stall_s"], "dispatch_s": out["dispatch_s"],
               "train_time_s": out["train_time_s"], "eval": out["eval"],
               "launches": launches, "collective_us": collective_us}, f)
"""


def kge_configs(ds, seed: int, **fields):
    """The job's model and training configurations on ``ds``."""
    from dgl_operator_tpu_torch.models.kge import KGEConfig
    from dgl_operator_tpu_torch.runtime.kge import KGETrainConfig

    cfg = KGEConfig(model_name="ComplEx", n_entities=ds.n_entities,
                    n_relations=ds.n_relations, hidden_dim=KGE_DIM,
                    gamma=KGE_GAMMA, neg_sample_size=KGE_NEG,
                    neg_adversarial_sampling=True,
                    adversarial_temperature=1.0)
    tcfg = KGETrainConfig(**{**dict(
        lr=KGE_LR, max_step=KGE_STEPS, batch_size=KGE_BATCH,
        neg_sample_size=KGE_NEG, log_interval=100, seed=seed), **fields})
    return cfg, tcfg


def kge_stream(td, rank: int, seeds):
    """The bidirectional batch stream of edge partition ``rank`` of
    ``td`` with head and tail sampler seeds ``seeds``."""
    from dgl_operator_tpu_torch.graph.kge_sampler import (
        BidirectionalOneShotIterator)

    head, tail = (td.create_sampler(KGE_BATCH, KGE_NEG, KGE_BATCH, mode=m,
                                    rank=rank, seed=s)
                  for m, s in zip(("head", "tail"), seeds))
    return BidirectionalOneShotIterator(head, tail)


def kge_state_gaps(got: dict, want: dict) -> dict:
    """Max abs difference over max abs of every state array."""
    import numpy as np

    return {k: float(np.abs(got[k] - want[k]).max())
            / max(float(np.abs(want[k]).max()), 1e-30) for k in want}


def kge_kernel_records(torch, args, ops, tr, hs, card: str):
    """Both kernels at the KGE step's shapes, from one tail-mode host
    step ``hs`` of ``tr`` (a ``KGETrainer`` on the card): the entity
    lookup (``h || t || neg``, 2,304 int32 ids into the 14,951 x 400
    table) and the relation lookup (1,024 ids), then the entity push
    (2,304 gradient rows into their distinct rows) and the relation push
    (1,024 rows), each over the plan the host built. The relation push's
    plan must hold targets of more than ``CHUNK`` entries, which the
    kernel sums in its second, dependent launch."""
    from dgl_operator_tpu_torch.ops.scatter import CHUNK, ScatterPlan

    _, gather, scatter = ops
    arrs = tr.ship(hs)
    ent = hs.ent_route.rebuilt(arrs[:hs.n_ent])
    rel_ids, union, inv, *plan = arrs[hs.n_ent:]
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    records = gather_records(torch, gather, [
        ("kge_entity", tr.entity, ent.serve),
        ("kge_relation", tr.relation, rel_ids)], flush, args.iters, card)
    records += scatter_records(torch, scatter, [
        ("kge_entity_push", torch.randn(ent.serve.numel(), KGE_DIM,
                                        device="cuda", generator=gen),
         ent.push.inverse, None, ent.push.num_rows, False,
         ent.push.scatter),
        ("kge_relation_push", torch.randn(rel_ids.numel(), KGE_DIM,
                                          device="cuda", generator=gen),
         inv, None, union.numel(), False, ScatterPlan(*plan))],
        flush, args.iters, card)
    rel_push = records[-1]
    check(rel_push["long_targets"] > 0,
          f"the relation push has no target of more than {CHUNK} entries")
    return records


def kge_device_ms(torch, tr, batches) -> dict:
    """Per batch: the host time of its host step (routes and push plans)
    and of shipping its buffer, then the device time of its update
    (lookups, scoring, backward, pushes) by CUDA events, with a spin
    kernel first that keeps the card busy while the host enqueues the
    update, so the events bracket device work."""
    import numpy as np

    rows = []
    for b in batches:
        t = time.perf_counter()
        hs = tr.host_step([b])
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        t = time.perf_counter()
        arrs = tr.ship(hs)
        torch.cuda.synchronize()
        h2d_ms = (time.perf_counter() - t) * 1e3
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(100_000_000)
        ev[0].record()
        tr.update(hs, arrs)
        ev[1].record()
        torch.cuda.synchronize()
        rows.append([host_ms, h2d_ms, ev[0].elapsed_time(ev[1]),
                     hs.buf.nbytes])
    mean = np.mean(rows[1:], axis=0)    # the first pays one-time costs
    return dict(host_step_ms=float(mean[0]), h2d_ms=float(mean[1]),
                device_ms=float(mean[2]), h2d_bytes=int(mean[3]))


KGE_PROFILE_STEPS = 5   # KGETrainer steps traced by torch.profiler


def short_kernel_name(name: str) -> str:
    """A device kernel's name without its return type, namespace and
    arguments."""
    for junk in ("void ", "(anonymous namespace)::"):
        name = name.replace(junk, "")
    return (name.split("(", 1)[0].strip() or name)[:100]


def kernel_kind(name: str) -> str:
    """What launched a device kernel of the KGE step: one of the port's
    kernels (the relation and entity pushes are told apart by order),
    cuBLAS, a copy, or one of PyTorch's plain ops."""
    if "gather_rows" in name:
        return "gather_rows"
    if "segment_sum_kernel" in name:
        return "scatter_first"
    if "add_partials_kernel" in name:
        return "scatter_second"
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "cublas", "cutlass", "xmma")):
        return "cublas"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "plain"


def kge_profile(torch, tr, batches, card: str) -> None:
    """``KGE_PROFILE_STEPS`` steps of ``tr`` (their host steps built
    first) under ``torch.profiler`` with CPU and CUDA activities: device
    µs per step of each kernel, the port's split out (the relation
    push, a step's first ``scatter_add_rows``, by its first and its
    dependent second launch; the entity push), launches per step, and
    the host µs per step of the 10 CPU ops with the most self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = len(batches)
    hss = [tr.host_step([b]) for b in batches]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for hs in hss:
            tr.device_step(hs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    check(events, "the profiler recorded no device event")
    by_name, count, by_kind = {}, {}, {}
    pushes = {"relation_first": 0.0, "relation_second": 0.0,
              "entity_first": 0.0, "entity_second": 0.0}
    firsts, push = 0, "relation"
    for e in events:
        us_ = e.time_range.elapsed_us()
        name = short_kernel_name(e.name)
        by_name[name] = by_name.get(name, 0.0) + us_
        count[name] = count.get(name, 0) + 1
        kind = kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + us_
        if kind == "scatter_first":
            # a step pushes the relation rows, then the entity rows
            push = "relation" if firsts % 2 == 0 else "entity"
            firsts += 1
            pushes[f"{push}_first"] += us_
        elif kind == "scatter_second":
            pushes[f"{push}_second"] += us_
    check(firsts == 2 * steps, f"{firsts} scatter first launches in {steps} "
          f"steps, not 2 a step")
    check(by_kind.get("gather_rows", 0) > 0, "no gather_rows device time")
    cpu = sorted((a for a in prof.key_averages()
                  if a.device_type == DeviceType.CPU),
                 key=lambda a: a.self_cpu_time_total, reverse=True)
    emit(phase="kge", part="profile", card=card, trainer="KGETrainer",
         steps=steps, wall_ms_per_step=wall_ms / steps,
         device_us_per_step=sum(by_kind.values()) / steps,
         launches_per_step=len(events) / steps,
         device_us_per_step_by_kind={k: v / steps
                                     for k, v in sorted(by_kind.items())},
         push_us_per_step={k: v / steps for k, v in pushes.items()},
         by_kernel=sorted(({"name": k, "us_per_step": v / steps,
                          "launches_per_step": count[k] / steps}
                         for k, v in by_name.items()),
                        key=lambda r: -r["us_per_step"]),
         host_top10=[{"op": a.key,
                      "self_cpu_us_per_step": a.self_cpu_time_total / steps,
                      "cpu_us_per_step": a.cpu_time_total / steps,
                      "calls_per_step": a.count / steps}
                     for a in cpu[:10]],
         host_self_cpu_us_per_step=sum(a.self_cpu_time_total
                                       for a in cpu) / steps)


def kge_train(torch, args, wrappers, ds, card: str):
    """``KGETrainer`` on the card, ``KGE_STEPS`` steps (the main path),
    with its launches checked against 2 gathers and 2 scatters a step;
    then the host and device time of single steps. Returns the trainer,
    its launches and a tail-mode host step for the kernel lines."""
    import numpy as np

    from dgl_operator_tpu_torch.graph.kge_sampler import TrainDataset
    from dgl_operator_tpu_torch.runtime.kge import KGETrainer

    td = TrainDataset(ds.train, ds.n_entities, ds.n_relations, ranks=1)
    tr = KGETrainer(*kge_configs(ds, args.seed), device="cuda")
    reset_counts(wrappers)
    t0 = time.perf_counter()
    out = tr.train(td)
    wall_s = time.perf_counter() - t0
    launches = read_counts(wrappers)
    steps = KGE_STEPS
    losses = np.asarray(out["losses"])
    # a step gathers h || t || neg and r, and pushes both
    check(launches == {"fanout_agg": 0, "gather_rows": 2 * steps,
                       "scatter_add_rows": 2 * steps, "tree_sample": 0},
          f"per step 2 gather_rows and 2 scatter_add_rows: {launches} in "
          f"{steps} steps")
    check(len(losses) == steps and bool(np.isfinite(losses).all()),
          "finite losses")
    check(losses[-20:].mean() < losses[:20].mean(),
          f"loss decreases: first 20 {losses[:20].mean()}, last 20 "
          f"{losses[-20:].mean()}")
    it = kge_stream(td, 0, (args.seed + 10, args.seed + 11))
    probe = [next(it) for _ in range(9)]
    dev = kge_device_ms(torch, tr, probe)
    kge_profile(torch, tr, [next(it) for _ in range(KGE_PROFILE_STEPS)],
                card)
    step_ms = np.asarray(out["step_s"]) * 1e3
    emit(phase="kge", part="train", card=card, trainer="KGETrainer",
         model="ComplEx", dim=KGE_DIM, entities=ds.n_entities,
         relations=ds.n_relations, train_triples=len(ds.train[0]),
         steps=steps, launches=launches,
         launches_per_step={k: v / steps for k, v in launches.items()},
         loss_first20=float(losses[:20].mean()),
         loss_last20=float(losses[-20:].mean()),
         step_ms_mean=float(step_ms.mean()),
         step_ms_p50=float(np.percentile(step_ms, 50)),
         stall_ms_per_step=out["stall_s"] * 1e3 / steps,
         dispatch_ms_per_step=out["dispatch_s"] * 1e3 / steps,
         steps_per_s=steps / out["train_time_s"],
         triples_per_s=steps * KGE_BATCH / out["train_time_s"],
         h2d_bytes_per_step=out["h2d_bytes_per_step"],
         train_time_s=out["train_time_s"], train_call_s=wall_s,
         **{f"probe_{k}": v for k, v in dev.items()},
         device_busy_share=dev["device_ms"] / float(step_ms.mean()))
    tail = next(b for b in probe if b.neg_mode == "tail")
    return tr, launches, tr.host_step([tail])


def kge_cpu(torch, args, ds, card: str) -> None:
    """``KGE_CPU_STEPS`` steps of the trainer's stream on the card and on
    the CPU, the card taking the CPU's tables and Adagrad sums before
    every step: each step's loss within 1e-5 relative, each table within
    1e-4 of its largest entry."""
    from dgl_operator_tpu_torch.graph.kge_sampler import TrainDataset
    from dgl_operator_tpu_torch.runtime.kge import KGETrainer

    td = TrainDataset(ds.train, ds.n_entities, ds.n_relations, ranks=1)
    card_tr, cpu_tr = (KGETrainer(*kge_configs(ds, args.seed), device=d)
                       for d in ("cuda", "cpu"))
    it = kge_stream(td, 0, (args.seed, args.seed + 1))
    rel, gaps, secs = [], [], [0.0, 0.0]
    for i in range(KGE_CPU_STEPS):
        hs = cpu_tr.host_step([next(it)])
        card_tr.load_state_dict(cpu_tr.state_dict())
        losses = []
        for k, tr in enumerate((card_tr, cpu_tr)):
            t0 = time.perf_counter()
            losses.append(float(tr.device_step(hs)))
            secs[k] += time.perf_counter() - t0
        rel.append(abs(losses[0] - losses[1]) / abs(losses[1]))
        gaps.append(kge_state_gaps(card_tr.state_dict(),
                                   cpu_tr.state_dict()))
        check(rel[-1] <= 1e-5, f"kge step {i + 1}: loss card {losses[0]} vs "
              f"CPU {losses[1]}: relative {rel[-1]} > 1e-5")
        for name, e in gaps[-1].items():
            check(e <= 1e-4, f"kge step {i + 1} {name}: max abs err {e} x "
                  "max > 1e-4")
    emit(phase="kge", part="train_cpu", card=card, steps=KGE_CPU_STEPS,
         synced=True, loss_rel_err=rel, state_rel_err=gaps,
         loss_tol=1e-5, state_tol=1e-4, card_s=secs[0], cpu_s=secs[1])


def kge_scorers(torch, args, ds, card: str) -> None:
    """Every scorer on one batch of each corruption side, card against
    CPU: the loss within 1e-5 relative and its gradients with respect to
    the gathered entity and relation rows within 1e-4 of their largest
    entry; the tables drawn as the trainers draw them."""
    import numpy as np

    from dgl_operator_tpu_torch.graph.kge_sampler import TrainDataset
    from dgl_operator_tpu_torch.models.kge import (KGEConfig, KGEModel,
                                                   init_kge_params)
    from dgl_operator_tpu_torch.nn.kge import KGE_SCORERS
    from dgl_operator_tpu_torch.ops.gather import gather_rows

    td = TrainDataset(ds.train, ds.n_entities, ds.n_relations, ranks=1)
    it = kge_stream(td, 0, (args.seed + 20, args.seed + 21))
    batches = [next(it), next(it)]
    out = {}
    for name in sorted(KGE_SCORERS):
        d = KGE_SCORER_DIM.get(name, KGE_DIM)
        cfg = KGEConfig(model_name=name, n_entities=ds.n_entities,
                        n_relations=ds.n_relations, hidden_dim=d,
                        gamma=KGE_GAMMA, neg_sample_size=KGE_NEG,
                        neg_adversarial_sampling=True)
        model = KGEModel(cfg)
        host = init_kge_params(cfg, torch.Generator().manual_seed(args.seed))
        for b in batches:
            res = []
            for dev in ("cuda", "cpu"):
                tabs = {k: v.to(dev) for k, v in host.items()}
                ids = [torch.from_numpy(np.concatenate(
                    [b.h, b.t, b.neg_ids.reshape(-1)])).to(dev),
                    torch.from_numpy(b.r).to(dev)]
                e = gather_rows(tabs["entity"], ids[0]).requires_grad_()
                r = gather_rows(tabs["relation"], ids[1]).requires_grad_()
                loss = model.rows_loss(e[:KGE_BATCH], r,
                                       e[KGE_BATCH:2 * KGE_BATCH],
                                       e[2 * KGE_BATCH:].view(1, KGE_NEG, d),
                                       b.neg_mode)
                res.append([loss.item()] + [g.cpu() for g in
                                            torch.autograd.grad(loss,
                                                                (e, r))])
            (lc, *gc), (lp, *gp) = res
            loss_rel = abs(lc - lp) / abs(lp)
            grad_rel = [float((x - y).abs().max())
                        / max(float(y.abs().max()), 1e-30)
                        for x, y in zip(gc, gp)]
            check(loss_rel <= 1e-5, f"{name} {b.neg_mode}: loss card {lc} "
                  f"vs CPU {lp}: relative {loss_rel} > 1e-5")
            check(max(grad_rel) <= 1e-4, f"{name} {b.neg_mode}: row "
                  f"gradients {grad_rel} x max > 1e-4")
            out[f"{name}/{b.neg_mode}"] = dict(dim=d, loss=lp,
                                               loss_rel_err=loss_rel,
                                               grad_rel_err=grad_rel)
    emit(phase="kge", part="scorers", card=card, batch=KGE_BATCH,
         negatives=KGE_NEG, loss_tol=1e-5, grad_tol=1e-4, scorers=out)


def kge_dist(torch, args, wrappers, ds, work: str, card: str):
    """``DistKGETrainer`` over the 2-part book that the partition entry
    point writes, ``KGE_DIST_STEPS`` steps, each form from the tables
    drawn from ``--seed``: (a) both slots in one process; (b) under an
    in-process NCCL group of world size 1, equal to (a) bit for bit; (c)
    two ranks through the entry point on the card over gloo, both equal
    to (a) bit for bit (losses and saved tables); (d) a run cut after
    ``KGE_RESUME_AT`` steps and resumed, equal to (a) bit for bit.
    Returns (a)'s trainer and the launches of (a), (b) and (c)."""
    import datetime

    import numpy as np
    import torch.distributed as dist

    from dgl_operator_tpu_torch.examples import partition_kg
    from dgl_operator_tpu_torch.examples.train_kge import EVAL_TRIPLES
    from dgl_operator_tpu_torch.graph.kge_sampler import (TrainDataset,
                                                          load_kg_partition)
    from dgl_operator_tpu_torch.runtime.kge import DistKGETrainer

    t0 = time.perf_counter()
    ws = os.path.join(work, "kge")
    book = partition_kg.main(["--workspace", ws, "--num_parts", "2",
                              "--dataset", "FB15k", "--graph_name", "FB15k"])
    book_s = time.perf_counter() - t0
    # what the entry point trains on with --num_dp: every part, in order
    parts = [load_kg_partition(book, p)[0] for p in range(2)]
    triples = tuple(np.concatenate([p[i] for p in parts]) for i in range(3))
    td = TrainDataset(triples, ds.n_entities, ds.n_relations, ranks=2)
    steps = KGE_DIST_STEPS

    def make(**fields):
        cfg, tcfg = kge_configs(ds, args.seed, max_step=steps,
                                log_interval=25, **fields)
        return DistKGETrainer(cfg, tcfg, num_slots=2, device="cuda")

    def run(tr):
        reset_counts(wrappers)
        t = time.perf_counter()
        out = tr.train(td)
        return out, read_counts(wrappers), time.perf_counter() - t

    def step_numbers(out):
        step_ms = np.asarray(out["step_s"]) * 1e3
        return dict(step_ms_mean=float(step_ms.mean()),
                    step_ms_p50=float(np.percentile(step_ms, 50)),
                    stall_ms_per_step=out["stall_s"] * 1e3 / steps,
                    dispatch_ms_per_step=out["dispatch_s"] * 1e3 / steps,
                    steps_per_s=steps / out["train_time_s"],
                    triples_per_s=2 * steps * KGE_BATCH
                    / out["train_time_s"])

    # (a) one process: one gather of every slot's entity rows and one of
    # their relation rows a step; one entity push and a relation push
    # for each slot
    in_process = {"fanout_agg": 0, "gather_rows": 2 * steps,
                  "scatter_add_rows": 3 * steps, "tree_sample": 0}
    tr_a = make()
    out_a, launches_a, wall_a = run(tr_a)
    want_losses, want = out_a["losses"], tr_a.state_dict()
    check(launches_a == in_process, f"kge dist: {launches_a} launches in "
          f"{steps} steps")
    check(bool(np.isfinite(want_losses).all()), "kge dist: finite losses")
    emit(phase="kge", part="dist", card=card, form="one_process",
         slots=2, steps=steps, book_s=book_s,
         part_triples=[len(p[0]) for p in parts], launches=launches_a,
         h2d_bytes_per_step=out_a["h2d_bytes_per_step"],
         loss_first=want_losses[0], loss_last=want_losses[-1],
         train_call_s=wall_a, **step_numbers(out_a))
    # the step's all_reduce bucket: the relation accumulator over the
    # slots' distinct relations, and the slots' losses
    hs = tr_a.host_step([next(kge_stream(td, s, (args.seed + 30 + s,
                                                 args.seed + 32 + s)))
                         for s in range(2)])
    bucket_floats = hs.shapes[hs.n_ent + 1][0] * KGE_DIM + 2
    # (b) an NCCL group of world size 1
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=MP_CHILD_TIMEOUT_S))
    try:
        tr_b = make()
        check(tr_b.my_slots == [0, 1] and tr_b.world_size == 1,
              f"world 1 holds both slots: {tr_b.my_slots}")
        out_b, launches_b, wall_b = run(tr_b)
        check(out_b["losses"] == want_losses, "kge NCCL: losses differ from "
              "the single process's")
        got = tr_b.state_dict()
        check(all(np.array_equal(got[k], want[k]) for k in want),
              "kge NCCL: tables differ from the single process's")
        check(launches_b == in_process, f"kge NCCL: {launches_b} launches")
        bucket = torch.zeros(bucket_floats, device="cuda")
        reduce_us = time_warm_ms(torch, lambda: dist.all_reduce(bucket),
                                 50) * 1e3
        emit(phase="kge", part="dist", card=card, form="nccl_world1",
             backend=dist.get_backend(), world_size=1, steps=steps,
             bit_identical_to_one_process=True, launches=launches_b,
             all_reduce_us=reduce_us, all_reduce_bytes=bucket.numel() * 4,
             train_call_s=wall_b, **step_numbers(out_b))
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the NCCL group is gone")
    # (c) two ranks on the card over gloo, one slot each
    tmp = os.path.join(work, "kge_ranks")
    os.makedirs(tmp, exist_ok=True)
    hostfile = two_rank_hostfile(tmp)
    save = os.path.join(tmp, "save")
    argv = ["--graph_name", "FB15k", "--ip_config", hostfile,
            "--part_config", book, "--model_name", "ComplEx",
            "--hidden_dim", str(KGE_DIM), "--gamma", str(KGE_GAMMA),
            "--lr", str(KGE_LR), "--batch_size", str(KGE_BATCH),
            "--neg_sample_size", str(KGE_NEG), "--max_step", str(steps),
            "--log_interval", "25", "-adv", "--adversarial_temperature",
            "1.0", "--save_path", save, "--eval", "--num_dp", "2",
            "--device", "cuda:0", "--backend", "gloo",
            "--seed", str(args.seed)]
    probe_port = free_port()
    t0 = time.perf_counter()
    outs = run_two_ranks(KGE_MP_CHILD, lambda r: {
        "repo": REPO, "argv": argv, "out": os.path.join(tmp, f"rank{r}"),
        "probe_port": probe_port, "rows": 2 * KGE_BATCH + KGE_NEG,
        "dim": KGE_DIM, "bucket": bucket_floats},
        tmp, "kge")
    wall_c = time.perf_counter() - t0
    res = []
    for r in (0, 1):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res.append(json.load(f))
    eval_batches = 2 * -(-EVAL_TRIPLES // 128)
    # a group step: the owner's gather, the gather back into request
    # order, the gather of the gradient rows by owner, the relation
    # gather; one entity and one relation push. Each ranking batch of
    # --eval: two gathers of the lookup and one of the relations
    per_rank = {"fanout_agg": 0,
                "gather_rows": 4 * steps + 3 * eval_batches,
                "scatter_add_rows": 2 * steps}
    launches_c = {}
    for r, x in enumerate(res):
        check(x["losses"] == want_losses, f"kge rank {r}: losses differ "
              "from the single process's")
        check(x["launches"] == per_rank, f"kge rank {r}: {x['launches']} "
              f"launches, expected {per_rank}")
        with np.load(os.path.join(save, f"FB15k_ComplEx_rank{r}.npz")) as z:
            check(np.array_equal(z["entity"], want["entity"])
                  and np.array_equal(z["relation"], want["relation"]),
                  f"kge rank {r}: saved tables differ from the single "
                  "process's")
        for k, v in x["launches"].items():
            launches_c[k] = launches_c.get(k, 0) + v
    check(res[0]["eval"] == res[1]["eval"], "kge ranks: eval differs")
    emit(phase="kge", part="dist", card=card, form="two_ranks",
         backend="gloo", device="cuda:0", world_size=2, steps=steps,
         bit_identical_to_one_process=True, saved_tables_identical=True,
         done_lines=[[ln for ln in o.splitlines() if "trained" in ln]
                     for o in outs],
         launches_per_rank=[x["launches"] for x in res],
         eval=res[0]["eval"],
         step_ms_mean=[float(np.mean(x["step_s"]) * 1e3) for x in res],
         stall_ms_per_step=[x["stall_s"] * 1e3 / steps for x in res],
         dispatch_ms_per_step=[x["dispatch_s"] * 1e3 / steps for x in res],
         steps_per_s=[steps / x["train_time_s"] for x in res],
         gloo_cuda_collective_us=[x["collective_us"] for x in res],
         collective_shapes=dict(all_to_all_rows=[2 * KGE_BATCH + KGE_NEG,
                                                 KGE_DIM],
                                all_reduce_floats=bucket_floats),
         wall_s=wall_c)
    # (d) cut after KGE_RESUME_AT steps, resumed by a fresh trainer
    ckpt_dir = os.path.join(work, "kge_ckpt")
    first = make(ckpt_dir=ckpt_dir, ckpt_every=KGE_RESUME_AT)
    step, taken = first.device_step, []

    def dying_step(hs):
        if len(taken) == KGE_RESUME_AT:
            raise Killed(f"kge: killed after {KGE_RESUME_AT} steps")
        taken.append(1)
        return step(hs)

    first.device_step = dying_step
    try:
        first.train(td)
        cut = False
    except Killed:
        cut = True
    check(cut, "kge: the first run was not cut")
    resumed = make(ckpt_dir=ckpt_dir)
    out_d = resumed.train(td)
    got = resumed.state_dict()
    check(out_d["start_step"] == KGE_RESUME_AT
          and out_d["losses"] == want_losses[KGE_RESUME_AT:],
          "kge: resumed losses differ from the uninterrupted run's")
    check(all(np.array_equal(got[k], want[k]) for k in want),
          "kge: resumed tables differ from the uninterrupted run's")
    emit(phase="kge", part="resume", card=card, trainer="DistKGETrainer",
         killed_at=KGE_RESUME_AT, resumed_steps=len(out_d["losses"]),
         bit_exact=True)
    total = {k: launches_a[k] + launches_b[k] + launches_c.get(k, 0)
             for k in launches_a}
    return tr_a, total


def kge_eval(torch, tr, ds, card: str) -> None:
    """``full_ranking_eval`` and ``sharded_ranking_eval`` of ``tr``'s
    tables on the card, raw and filtered (known answers from every
    split), over ``KGE_EVAL`` test triples, and ``full_ranking_eval`` of
    the same tables on the CPU: the metrics agree within
    ``KGE_EVAL_TOL``."""
    import numpy as np

    from dgl_operator_tpu_torch.runtime.kge import (build_filter,
                                                    full_ranking_eval)

    ev = tuple(a[:KGE_EVAL] for a in ds.test)
    t0 = time.perf_counter()
    filt = build_filter(tuple(np.concatenate(x) for x in zip(
        ds.train, ds.valid, ds.test)), ds.n_entities)
    filter_s = time.perf_counter() - t0
    params = tr.gathered_params()
    cpu_params = {k: v.cpu() for k, v in params.items()}
    for label, f in (("raw", None), ("filtered", filt)):
        got, secs = {}, {}
        for name, fn in (
                ("full", lambda: full_ranking_eval(tr.model, params, ev,
                                                   filters=f)),
                ("sharded", lambda: tr.sharded_ranking_eval(ev, filters=f)),
                ("cpu_full", lambda: full_ranking_eval(tr.model, cpu_params,
                                                       ev, filters=f))):
            t0 = time.perf_counter()
            got[name] = fn()
            secs[name] = time.perf_counter() - t0
        for other in ("sharded", "cpu_full"):
            for k, tol in KGE_EVAL_TOL.items():
                a, b = got["full"][k], got[other][k]
                bound = tol * (b if k == "MR" else 1.0)
                check(abs(a - b) <= bound, f"kge eval {label}: {k} full "
                      f"{a} vs {other} {b}")
        emit(phase="kge", part="eval", card=card, filtered=label,
             triples=KGE_EVAL, metrics=got, seconds=secs,
             filter_build_s=filter_s, tol=KGE_EVAL_TOL,
             sharded_equal=got["sharded"] == got["full"],
             cpu_equal=got["cpu_full"] == got["full"])


def kge_phase(torch, args, ops, wrappers, work: str, card: str):
    """The DGL-KE slice at the reference job's width on synthetic FB15k
    at full size: the kernels at the step's shapes, ``KGETrainer`` (the
    main path), card against CPU, every scorer, ``DistKGETrainer`` in
    its three forms and resumed, and the ranking evaluations. Returns
    the kernel records, the launches of the main-path runs and the
    dataset."""
    from dgl_operator_tpu_torch.graph import datasets

    t0 = time.perf_counter()
    ds = datasets.fb15k(seed=args.seed)
    check((ds.n_entities, ds.n_relations, len(ds.train[0]))
          == (14_951, 1_345, 483_142), "FB15k at its real shape")
    emit(phase="kge", part="setup", card=card, entities=ds.n_entities,
         relations=ds.n_relations, train_triples=len(ds.train[0]),
         test_triples=len(ds.test[0]), data_s=time.perf_counter() - t0)
    tr, launches, hs = kge_train(torch, args, wrappers, ds, card)
    records = kge_kernel_records(torch, args, ops, tr, hs, card)
    kge_cpu(torch, args, ds, card)
    kge_scorers(torch, args, ds, card)
    tr_a, dist_launches = kge_dist(torch, args, wrappers, ds, work, card)
    kge_eval(torch, tr_a, ds, card)
    return records, {k: launches[k] + dist_launches[k] for k in launches}, ds


# ------------------------------------------------------------- kge_grid
KGE_GRID_STEPS = 20      # the grid against 1-D, host negatives
KGE_GRID_SYNCED = 3      # card-against-CPU updates on the grid
KGE_DEVICE_STEPS = 50    # the grid with device negatives, run twice
KGE_CLIENT_STEPS = 2     # num_client=2: 4 updates, card and CPU
KGE_CLIENT_TIMED = 20    # num_client=2 on the card, steps timed
KGEJOB_STEPS = 100       # train_kge.py under tpukerun


def kge_grid_trainer(ds, seed: int, shape, device, **fields):
    """``DistKGETrainer`` of the job on a ``(dp, mp)`` grid or a 1-D
    mesh of ``shape``."""
    from dgl_operator_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from dgl_operator_tpu_torch.runtime.kge import DistKGETrainer

    cfg, tcfg = kge_configs(ds, seed, log_interval=1000, **fields)
    mesh = make_mesh(*shape) if len(shape) == 1 else make_mesh_2d(*shape)
    return DistKGETrainer(cfg, tcfg, device=device, mesh=mesh)


def grid_run(torch, wrappers, tr, td, what: str, updates: int):
    """``tr.train(td)`` with the launches counted from 0; every update
    on 4 slots gathers twice (the entity rows, negatives included, and
    the relation rows) and scatters 5 times (the entity push and one
    relation push a slot)."""
    import numpy as np

    reset_counts(wrappers)
    t0 = time.perf_counter()
    out = tr.train(td)
    wall = time.perf_counter() - t0
    launches = read_counts(wrappers)
    check(launches == {"fanout_agg": 0, "gather_rows": 2 * updates,
                       "scatter_add_rows": 5 * updates, "tree_sample": 0},
          f"{what}: {launches} launches in {updates} updates")
    losses = np.asarray(out["losses"])
    check(len(losses) == updates and bool(np.isfinite(losses).all()),
          f"{what}: {len(losses)} finite losses of {updates}")
    step_ms = np.asarray(out["step_s"][1:]) * 1e3
    return out, launches, dict(
        steps=out["steps"], updates=out["updates"], train_call_s=wall,
        step_ms_mean=float(step_ms.mean()),
        step_ms_p50=float(np.percentile(step_ms, 50)),
        stall_ms_per_step=out["stall_s"] * 1e3 / out["steps"],
        dispatch_ms_per_step=out["dispatch_s"] * 1e3 / out["steps"],
        h2d_bytes_per_update=out["h2d_bytes_per_step"],
        loss_last=float(losses[-5:].mean()))


def grid_sync_check(torch, ds, td, seed: int, what: str, updates: int,
                    **fields):
    """``updates`` updates of the grid on the card and on the CPU from
    the CPU's host steps, the card taking the CPU's state before each:
    each loss within 1e-5 relative, each table within 1e-4 of its
    largest entry."""
    card_tr, cpu_tr = (kge_grid_trainer(ds, seed, (2, 2), d, **fields)
                       for d in ("cuda", "cpu"))
    iters = cpu_tr.iterators(td)
    rel, gaps = [], []
    for i in range(updates):
        hs = cpu_tr.host_step([next(it) for it in iters], 1000 + i)
        card_tr.load_state_dict(cpu_tr.state_dict())
        losses = [float(tr.device_step(hs)) for tr in (card_tr, cpu_tr)]
        rel.append(abs(losses[0] - losses[1]) / abs(losses[1]))
        gaps.append(kge_state_gaps(card_tr.state_dict(),
                                   cpu_tr.state_dict()))
        check(rel[-1] <= 1e-5, f"{what} update {i + 1}: loss card "
              f"{losses[0]} vs CPU {losses[1]}")
        for name, e in gaps[-1].items():
            check(e <= 1e-4, f"{what} update {i + 1} {name}: {e} x max")
    return rel, gaps


def kge_grid_records(torch, args, ops, grid, dev, td, card: str):
    """Both kernels at the grid's new call sites: the entity lookup of
    4 slots' ``h || t || neg`` (9,216 ids) and its push over the host
    plan; with device negatives, the lookup of the same count of ids,
    the negatives drawn on the card, and the push over the plan built
    on the card (9,217 targets)."""
    from dgl_operator_tpu_torch.ops.adagrad import device_push_plan
    from dgl_operator_tpu_torch.ops.kge_negatives import update_seed

    _, gather, scatter = ops
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    batches = [next(it) for it in grid.iterators(td)]
    hs = grid.host_step(batches)
    arrs = grid.ship(hs)
    rt = hs.ent_route.rebuilt(arrs[:hs.n_ent])
    seed_u = update_seed(args.seed, 7, 1, 0)
    dbatches = [next(it) for it in dev.iterators(td)]
    dhs = dev.host_step(dbatches, seed_u)
    darrs = dev.ship(dhs)
    ids = torch.cat([darrs[0].view(4, -1),
                     dev.negatives(seed_u).reshape(4, -1)], 1).reshape(-1)
    plan = device_push_plan(ids)
    records = gather_records(torch, gather, [
        ("kge_grid_entity", grid.entity, rt.serve),
        ("kge_grid_relation", grid.relation, arrs[hs.n_ent]),
        ("kge_device_entity", dev.entity, ids)], flush, args.iters, card)
    records += scatter_records(torch, scatter, [
        ("kge_grid_entity_push",
         torch.randn(rt.serve.numel(), KGE_DIM, device="cuda", generator=gen),
         rt.push.inverse, None, rt.push.num_rows, False, rt.push.scatter),
        ("kge_device_entity_push",
         torch.randn(ids.numel(), KGE_DIM, device="cuda", generator=gen),
         plan.inverse, None, plan.num_rows, False, plan.scatter)],
        flush, args.iters, card, padded={"kge_device_entity_push"})
    return records


def update_syncs(torch, tr, td, seed_u: int) -> list:
    """The host syncs one device-negatives update makes
    (the warnings ``torch.cuda.set_sync_debug_mode`` raises at a
    synchronizing call), its host step and copy made before."""
    import warnings

    hs = tr.host_step([next(it) for it in tr.iterators(td)], seed_u)
    arrs = tr.ship(hs)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tr.update(hs, arrs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # the mode's own notice that it is a prototype is not a sync
    return [str(w.message)[:200] for w in caught
            if "called a synchronizing" in str(w.message)]


def kge_grid_phase(torch, args, ops, wrappers, ds, card: str):
    """The 2 x 2 grid, device negatives and two clients a slot on
    synthetic FB15k at its real size, at the job's width. Returns the
    kernel records and the launches of the grid's main-path runs (host
    and device negatives, two clients a slot)."""
    import numpy as np

    from dgl_operator_tpu_torch.graph.kge_sampler import TrainDataset
    from dgl_operator_tpu_torch.ops.kge_negatives import (draw_counters,
                                                          draw_negatives,
                                                          update_seed)

    t0 = time.perf_counter()
    ne, nr = ds.n_entities, ds.n_relations
    td4 = TrainDataset(ds.train, ne, nr, ranks=4)
    steps = KGE_GRID_STEPS
    # (a) the grid against 1-D, host negatives, identical batches
    grid = kge_grid_trainer(ds, args.seed, (2, 2), "cuda", max_step=steps)
    out_g, l_grid, rec_g = grid_run(torch, wrappers, grid, td4, "kge grid",
                                    steps)
    line = kge_grid_trainer(ds, args.seed, (4,), "cuda", max_step=steps)
    out_l, _, rec_l = grid_run(torch, wrappers, line, td4, "kge 1-D", steps)
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(out_g["losses"], out_l["losses"]))
    sg, sl = grid.state_dict(), line.state_dict()
    table_gap = {k: float(np.abs(sg[k] - sl[k]).max()) for k in sg}
    check(loss_rel <= 2e-4, f"kge grid against 1-D: loss rel {loss_rel}")
    check(max(table_gap.values()) <= 2e-5,
          f"kge grid against 1-D: table gaps {table_gap}")
    emit(phase="kge_grid", part="grid_vs_line", card=card, steps=steps,
         grid=rec_g, line=rec_l, num_shards=[grid.spec.num_shards,
                                             line.spec.num_shards],
         loss_rel_max=loss_rel, table_abs_gap=table_gap, loss_rtol=2e-4,
         table_atol=2e-5, bit_equal=bool(loss_rel == 0 and not any(
             table_gap.values())))
    # (b) card against CPU, synced, host negatives
    rel, gaps = grid_sync_check(torch, ds, td4, args.seed, "kge grid cpu",
                                KGE_GRID_SYNCED, max_step=steps)
    emit(phase="kge_grid", part="grid_cpu", card=card,
         updates=KGE_GRID_SYNCED, synced=True, loss_rel_err=rel,
         state_rel_err=gaps, loss_tol=1e-5, state_tol=1e-4)
    # (c) device negatives: the draws card against CPU, two runs
    n_chunks = KGE_BATCH // KGE_BATCH
    cnt = {d: draw_counters(n_chunks, KGE_NEG, d) for d in ("cuda", "cpu")}
    keys = [(update_seed(args.seed, s, k, c), slot)
            for s, k, c in ((0, 1, 0), (13, 1, 0), (999, 2, 1))
            for slot in (0, 3)]
    draws_equal = all(torch.equal(
        draw_negatives(u, [sl], cnt["cuda"], n_chunks, ne).cpu(),
        draw_negatives(u, [sl], cnt["cpu"], n_chunks, ne))
        for u, sl in keys)
    check(draws_equal, "kge device negatives: card and CPU draws differ")
    dsteps = KGE_DEVICE_STEPS
    dev = kge_grid_trainer(ds, args.seed, (2, 2), "cuda", max_step=dsteps,
                           neg_sampler="device")
    out_a, l_dev, rec_a = grid_run(torch, wrappers, dev, td4,
                                   "kge device negatives", dsteps)
    twin = kge_grid_trainer(ds, args.seed, (2, 2), "cuda", max_step=dsteps,
                            neg_sampler="device")
    out_b = twin.train(td4)
    sa, sb = dev.state_dict(), twin.state_dict()
    check(out_a["losses"] == out_b["losses"]
          and all(np.array_equal(sa[k], sb[k]) for k in sa),
          "kge device negatives: two runs differ")
    syncs = update_syncs(torch, twin, td4, update_seed(args.seed, 77, 1, 0))
    check(not syncs, f"a device-negatives update syncs the host: {syncs}")
    drel, dgaps = grid_sync_check(torch, ds, td4, args.seed,
                                  "kge device negatives cpu",
                                  KGE_GRID_SYNCED, max_step=dsteps,
                                  neg_sampler="device")
    emit(phase="kge_grid", part="device_negatives", card=card,
         draw_keys=len(keys), draws_bit_equal=draws_equal, steps=dsteps,
         run=rec_a, two_runs_bit_equal=True, host_syncs=len(syncs),
         cpu_loss_rel_err=drel, cpu_state_rel_err=dgaps)
    # (d) two clients a slot, card against CPU
    td8 = TrainDataset(ds.train, ne, nr, ranks=8)
    csteps = KGE_CLIENT_STEPS
    outs = []
    for d in ("cuda", "cpu"):
        tr = kge_grid_trainer(ds, args.seed, (2, 2), d, max_step=csteps,
                              num_client=2)
        outs.append((tr.train(td8), tr.state_dict()))
    (oc, sc), (op, sp) = outs
    check(oc["updates"] == 2 * csteps and len(oc["losses"]) == 2 * csteps,
          f"num_client=2: {oc['updates']} updates in {csteps} steps")
    crel = max(abs(a - b) / abs(b) for a, b in zip(oc["losses"],
                                                   op["losses"]))
    cgaps = kge_state_gaps(sc, sp)
    check(crel <= 1e-4 and max(cgaps.values()) <= 1e-4,
          f"num_client=2 card against CPU: loss {crel}, tables {cgaps}")
    timed = kge_grid_trainer(ds, args.seed, (2, 2), "cuda",
                             max_step=KGE_CLIENT_TIMED, num_client=2)
    _, l_cli, rec_c = grid_run(torch, wrappers, timed, td8,
                               "kge num_client=2", 2 * KGE_CLIENT_TIMED)
    emit(phase="kge_grid", part="clients", card=card, num_client=2,
         steps=csteps, updates=oc["updates"], loss_rel_err=crel,
         state_rel_err=cgaps, loss_tol=1e-4, state_tol=1e-4, run=rec_c)
    # (e) ms a step, one call: host against device negatives, 1-D
    # against the grid, 2 clients a slot against 1
    emit(phase="kge_grid", part="step_ms", card=card,
         grid_host=rec_g["step_ms_p50"], line_host=rec_l["step_ms_p50"],
         grid_device=rec_a["step_ms_p50"],
         grid_clients=rec_c["step_ms_p50"],
         device_over_host=rec_a["step_ms_p50"] / rec_g["step_ms_p50"],
         grid_over_line=rec_g["step_ms_p50"] / rec_l["step_ms_p50"],
         clients_over_grid=rec_c["step_ms_p50"] / rec_g["step_ms_p50"],
         h2d_bytes_host=rec_g["h2d_bytes_per_update"],
         h2d_bytes_device=rec_a["h2d_bytes_per_update"])
    records = kge_grid_records(torch, args, ops, grid, dev, td4, card)
    emit(phase="kge_grid", part="done", card=card,
         seconds=time.perf_counter() - t0)
    return records, {k: l_grid[k] + l_dev[k] + l_cli[k] for k in l_grid}


# --------------------------------------------------------------- kgejob
def read_jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def kgejob_obs(obs_dir: str, since: float, card: str) -> None:
    """The KGE job's view (``obs/job/``, which ``tpukerun`` collected
    after phase 5): the driver's phases 3-5 and what the child recorded,
    its sentry's ``model_health`` records and its process's metrics."""
    job = os.path.join(obs_dir, "job")
    events = [e for e in read_jsonl(os.path.join(job, "events.jsonl"))
              if e["ts"] >= since]
    phases = sorted({e["phase"] for e in events
                     if e.get("role") == "tpukerun"
                     and e["event"] == "phase_finish"})
    health = [e for e in events if e.get("role") == "trainer-0"
              and e["event"] == "model_health"]
    with open(os.path.join(job, "metrics.json")) as f:
        procs = sorted(json.load(f)["procs"])
    child = [p for p in procs if p.endswith(":trainer-0")]
    check(phases == [3, 4, 5] and health and child,
          f"kgejob_obs: phases {phases}, {len(health)} model_health "
          f"records, procs {procs}")
    emit(phase="kgejob_obs", card=card, job_dir=job, phases=phases,
         model_health_records=len(health), procs=procs,
         events=len(events),
         files=sorted(f for f in os.listdir(job)
                      if not f.startswith(".")))


def kgejob_phase(torch, work: str, card: str):
    """``tpukerun`` with one card: phases 1-2 (``Partitioner``) run the
    port's ``partition_kg.py`` on FB15k at its real size, phases 3-5
    train ``train_kge.py --num_dp 2 --num_mp 2 --neg_sampler device``
    on the card for ``KGEJOB_STEPS`` steps through ``LocalFabric``, one
    ``exec`` fault of a chaos plan absorbed by the retry layer; then the
    same driver again, which skips every phase by its ledger. Returns
    the child's launches."""
    import io

    import numpy as np

    from dgl_operator_tpu_torch.examples.train_kge import SUMMARY_ENV
    from dgl_operator_tpu_torch.launcher import tpukerun
    from dgl_operator_tpu_torch.launcher.chaos import CHAOS_ENV
    from dgl_operator_tpu_torch.models.kge import KGEConfig, relation_dim
    from dgl_operator_tpu_torch.parallel.bootstrap import (PHASE_ENV,
                                                           HostEntry,
                                                           write_hostfile)

    t0 = time.perf_counter()
    root = os.path.join(work, "kgejob")
    ws, conf, save = (os.path.join(root, d) for d in ("ws", "conf", "save"))
    os.makedirs(conf)
    port = free_port()
    for name in ("hostfile", "leadfile"):
        write_hostfile(os.path.join(conf, name),
                       [HostEntry("127.0.0.1", port, "kge-worker-0", 1)])
    examples = os.path.join(REPO, "dgl_operator_tpu_torch", "examples")
    common = ["--graph-name", "FB15k", "--num-partitions", "1",
              "--workspace", ws, "--conf-dir", conf, "--fabric", "local",
              "--dataset", "FB15k"]
    saved_env = {k: os.environ.get(k) for k in (
        PHASE_ENV, CHAOS_ENV, "TPU_OPERATOR_RETRY_BASE_S", SUMMARY_ENV)}

    def driver(argv, **env):
        for k, v in saved_env.items():
            os.environ.pop(k, None)
        os.environ.update(env)
        out = io.StringIO()
        t = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                tpukerun.main(argv)
        except SystemExit as exc:
            check(False, f"tpukerun exited {exc.code}:\n{out.getvalue()}")
        finally:
            for k, v in saved_env.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
        return out.getvalue(), time.perf_counter() - t

    part_log, part_s = driver(
        common + ["--partition-entry-point",
                  os.path.join(examples, "partition_kg.py")],
        **{PHASE_ENV: "Partitioner"})
    check(part_log.count("finished") == 2, "kgejob: phases 1-2")
    # the driver runs under obs_run: its events land in the run's files
    obs_dir = os.path.join(ws, "obs")
    since = time.time()
    train = common + [
        "--train-entry-point", os.path.join(examples, "train_kge.py"),
        "--max-step", str(KGEJOB_STEPS), "--log-interval", "50",
        "--save-path", save,
        "--train-args", "--num_dp 2 --num_mp 2 --neg_sampler device"]
    summaries = os.path.join(root, "summary")
    log, first_s = driver(train, **{CHAOS_ENV: "exec:fail:1",
                                    "TPU_OPERATOR_RETRY_BASE_S": "0.05",
                                    SUMMARY_ENV: summaries})
    events = [e for e in read_jsonl(os.path.join(obs_dir, "events.jsonl"))
              if e["ts"] >= since]
    retries = [e for e in events if e["event"] == "fabric_retry"]
    faults = [e for e in events if e["event"] == "chaos_fault"]
    check(log.count("finished") == 3, f"kgejob: phases 3-5:\n{log}")
    check(len(faults) == 1 and len(retries) == 1
          and "injected" in retries[0]["error"],
          f"kgejob: faults {faults}, retries {retries}")
    check(os.path.exists(os.path.join(ws, "hostfile_revised")),
          "kgejob: hostfile_revised")
    with open(os.path.join(summaries, "rank0.json")) as f:
        summary = json.load(f)
    cfg = KGEConfig(model_name="ComplEx", n_entities=14_951,
                    n_relations=1_345, hidden_dim=KGE_DIM)
    with np.load(os.path.join(save, "FB15k_ComplEx_rank0.npz")) as z:
        shapes = {k: z[k].shape for k in z.files}
        finite = all(bool(np.isfinite(z[k]).all()) for k in z.files)
    check(shapes == {"entity": (14_951, KGE_DIM),
                     "relation": (1_345, relation_dim(cfg))} and finite,
          f"kgejob: saved tables {shapes}, finite {finite}")
    check(summary["device"] == torch.cuda.get_device_name(0),
          f"kgejob: the child trained on {summary['device']}")
    updates = KGEJOB_STEPS
    check(summary["updates"] == updates and summary["launches"] == {
        "fanout_agg": 0, "gather_rows": 2 * updates,
        "scatter_add_rows": 5 * updates},
        f"kgejob: the child's run {summary}")
    kgejob_obs(obs_dir, since, card)
    again_log, again_s = driver(train)
    skipped = again_log.count("skipped (ledger)")
    check(skipped == 3, f"kgejob relaunch: {skipped} phases skipped")
    emit(phase="kgejob", card=card, partition_s=part_s, first_s=first_s,
         relaunch_s=again_s, relaunch_skipped=skipped,
         faults=len(faults), retries=len(retries), child=summary,
         saved=shapes, seconds=time.perf_counter() - t0)
    return summary["launches"]


# ------------------------------------------------------------------ obs
OBS_TRAIN_ARGS = ("--device cuda:0 --sampler device --feats_layout owner "
                  "--eval_every 0 --log_every 5")
OBS_BEATS = 500     # heartbeats timed alone, with a directory and without
# the obsjob child: examples/train_dist.py started by path by tpurun's
# phase 5, then its launches, card and counted cost into a summary
OBSJOB_CHILD = """
import json, os, sys
sys.path.insert(0, os.environ["OBSJOB_REPO"])
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from dgl_operator_tpu_torch.examples.train_dist import main
from dgl_operator_tpu_torch.obs.prof import get_profiler
from dgl_operator_tpu_torch.ops import fanout, gather, scatter
wrappers = (fanout.fanout_agg, gather.gather_rows, scatter.scatter_add_rows)
for w in wrappers:
    w.launches = 0
out = main(sys.argv[1:])
if out is not None:
    prof = get_profiler()
    rec = out["history"][0]
    with open(os.environ["OBSJOB_SUMMARY"], "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0),
                   "steps": out["step"], "losses": rec["losses"],
                   "cost_source": prof.cost_source(),
                   "programs": prof._programs, "peaks": prof.peaks,
                   "last": prof.last, "time": rec["time"],
                   "launches": {w.__name__: w.launches for w in wrappers}},
                  f)
"""


def prom_values(path: str) -> dict:
    """A ``metrics.prom`` file as {sample with labels: value}."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                out[key] = float(value)
    return out


def obsjob(torch, ctx, work: str, card: str) -> dict:
    """``tpurun`` phases 3-5 over ``LocalFabric`` on the card, under
    ``obs_run``: the 2-part book of phase 10, ``examples/train_dist.py``
    at full width (``DistSAGE`` 100 -> 256 -> 47, fanouts 10,25, batch
    1000, the device sampler, the owner layout, one epoch of 20 steps)
    started by path through :data:`OBSJOB_CHILD`, then ``collect_obs``.
    The launcher starts one process a partition, so the hostfile has
    two local entries: rank 0 trains both parts, rank 1 loads its part
    and exits. Checks the job view, the doctor, the critical path, the
    utilization gauges from the counted cost and the child's launches.
    Returns them."""
    import io

    from dgl_operator_tpu_torch.benchkeys import PROF_KEYS
    from dgl_operator_tpu_torch.launcher import tpurun
    from dgl_operator_tpu_torch.launcher.chaos import CHAOS_ENV
    from dgl_operator_tpu_torch.obs import OBS_DIR_ENV
    from dgl_operator_tpu_torch.obs import prof as P
    from dgl_operator_tpu_torch.obs import xray
    from dgl_operator_tpu_torch.obs.peaks import H100_PEAKS
    from dgl_operator_tpu_torch.parallel.bootstrap import (PHASE_ENV,
                                                           HostEntry,
                                                           write_hostfile)

    t0 = time.perf_counter()
    root = os.path.join(work, "obsjob")
    ws, conf = os.path.join(root, "ws"), os.path.join(root, "conf")
    os.makedirs(conf)
    write_hostfile(os.path.join(conf, "hostfile"),
                   [HostEntry("127.0.0.1", free_port(), f"obs-worker-{i}", 1)
                    for i in range(2)])
    entry = os.path.join(root, "train_obsjob.py")
    with open(entry, "w") as f:
        f.write(OBSJOB_CHILD)
    summary_path = os.path.join(root, "summary.json")
    argv = ["--graph-name", "ogbn-products", "--num-partitions", "2",
            "--partition-config-path", ctx["book"],
            "--train-entry-point", entry, "--workspace", ws,
            "--conf-dir", conf, "--num-epochs", "1",
            "--batch-size", str(BATCH_TRAIN), "--fabric", "local",
            "--train-args",
            f"{OBS_TRAIN_ARGS} --fan_out {','.join(map(str, FANOUTS))} "
            f"--num_hidden {HIDDEN} --num_classes {CLASSES} --lr {LR} "
            f"--seed {ctx['seed']}"]
    with chaos_env(**{PHASE_ENV: None, CHAOS_ENV: None, OBS_DIR_ENV: None,
                      "OBSJOB_REPO": REPO, "OBSJOB_SUMMARY": summary_path}):
        log = io.StringIO()
        try:
            with contextlib.redirect_stdout(log):
                tpurun.main(argv)
        except SystemExit as exc:
            check(False, f"obsjob: tpurun exited {exc.code}:\n"
                  f"{log.getvalue()[-3000:]}")
    driver_s = time.perf_counter() - t0
    check(log.getvalue().count("finished") == 3,
          f"obsjob: phases 3-5:\n{log.getvalue()[-2000:]}")
    with open(summary_path) as f:
        child = json.load(f)
    obs_dir = os.path.join(ws, "obs")
    job = os.path.join(obs_dir, "job")
    events = read_jsonl(os.path.join(job, "events.jsonl"))
    trainer = [e for e in events if e.get("role") == "trainer-0"]
    beats = [e["step"] for e in trainer if e["event"] == "heartbeat"]
    done = [e for e in trainer if e["event"] == "train_done"]
    steps = child["steps"]
    check(steps == DIST_IDS_PER_PART // BATCH_TRAIN
          and beats == list(range(1, steps + 1)) and len(done) == 1,
          f"obsjob: {steps} steps, heartbeats {beats}, train_done {done}")
    with open(os.path.join(job, "trace.json")) as f:
        trace = json.load(f)["traceEvents"]
    spans = {e["name"] for e in trace if e.get("ph") == "X"}
    check("epoch 0" in spans and "train" in spans,
          f"obsjob: the trainer's spans in the trace {sorted(spans)[:20]}")
    prom = prom_values(os.path.join(job, "metrics.prom"))
    mfu = prom.get("train_mfu")
    comm_ops = sorted({k.split('op="')[1].split('"')[0] for k in prom
                       if k.startswith("comm_bytes_total{")})
    compiles = [e for e in events if e["event"] == "jit_compile"]
    check(any(k.startswith("train_phase_seconds_bucket") for k in prom)
          and prom.get("prof_peak_flops") == H100_PEAKS["fp32"]
          and mfu is not None and 0 < mfu <= 1
          and child["cost_source"] == "flop_counter"
          and any(k.startswith("jit_compiles_total{") for k in prom)
          and not [e for e in compiles if e.get("steady")]
          and {"grad_pmean", "halo_ring"} <= set(comm_ops),
          f"obsjob: metrics mfu {mfu}, peak {prom.get('prof_peak_flops')}, "
          f"cost {child['cost_source']}, compiles {compiles}, comm "
          f"{comm_ops}")
    doctor = subprocess.run(
        [sys.executable, "-m", "dgl_operator_tpu_torch.obs.doctor", obs_dir],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    check(doctor.returncode == 0
          and os.path.exists(os.path.join(job, "report.json")),
          f"obsjob: doctor exit {doctor.returncode}:\n{doctor.stdout}"
          f"{doctor.stderr[-2000:]}")
    xr = xray.xray_summary(obs_dir)
    fracs = {c: xr[f"critpath_frac_{c}"] for c in xray.CATEGORIES}
    check(abs(sum(fracs.values()) - 1.0) <= 1e-6,
          f"obsjob: critical-path fractions {fracs}")
    summary = P.prof_summary(obs_dir)
    keys = tuple(k for k in summary if k not in ("peak_flops",
                                                  "peak_hbm_gbps"))
    check(keys == PROF_KEYS, f"obsjob: prof summary keys {keys}")
    launches = child["launches"]
    check(child["device"] == torch.cuda.get_device_name(0)
          and all(v > 0 for v in launches.values()),
          f"obsjob: the child ran on {child['device']}, launches {launches}")
    step_prog = child["programs"].get("dp_train_step", {})
    emit(phase="obs", part="obsjob", card=card, steps=steps,
         heartbeats=len(beats), events=len(events),
         files=sorted(os.listdir(job)), trace_events=len(trace),
         train_mfu=mfu, cost_source=child["cost_source"],
         counted_flops_per_step=step_prog.get("flops"),
         counted_bytes_per_step=step_prog.get("bytes"),
         peaks=child["peaks"], roofline=child["last"].get("fracs"),
         compiles=[{k: e.get(k) for k in ("fn", "call", "seconds",
                                           "steady", "nvcc_seconds")}
                   for e in compiles],
         comm_ops=comm_ops,
         comm_bytes={k: v for k, v in prom.items()
                     if k.startswith("comm_bytes_total{")},
         doctor_rc=doctor.returncode,
         doctor_findings=json.load(open(os.path.join(
             job, "report.json")))["findings"],
         critpath=fracs, prof_summary=summary, launches=launches,
         epoch_s=child["time"], driver_s=driver_s,
         seconds=time.perf_counter() - t0)
    return launches


def obs_overhead(torch, args, wrappers, g, trainer, work: str,
                 card: str) -> dict:
    """The file plane's cost: ``SampledTrainer`` with the device sampler
    at K = 4 over the train phase's 40 steps, with an obs directory
    (``obs_run``) and without, in the order off, on, on, off; the runs
    bit-equal, the steady ms a step of each side and their ratio, and
    the ``train_mfu`` of the K = 4 step; then the µs of one heartbeat
    alone each way. Returns the launches."""
    import numpy as np

    from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                    state_dict_to_flax)
    from dgl_operator_tpu_torch.obs import obs_run
    from dgl_operator_tpu_torch.obs import prof as P
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig, heartbeat)

    w0 = state_dict_to_flax(DistSAGE(
        FEAT, HIDDEN, CLASSES, device="cpu",
        generator=torch.Generator().manual_seed(args.seed + 17)).state_dict())
    runs = {False: [], True: []}
    total, mfus, ref = {}, [], None
    for i, on in enumerate((False, True, True, False)):
        cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                          num_epochs=1, eval_every=0, seed=args.seed,
                          sampler="device", steps_per_call=DEV_K)
        tr = SampledTrainer(DistSAGE(FEAT, HIDDEN, CLASSES, device="cuda"),
                            g, cfg, train_ids=trainer.train_ids,
                            device="cuda")
        obs_dir = os.path.join(work, f"obs_overhead{i}")
        reset_counts(wrappers)
        with (obs_run(obs_dir, role="trainer-0") if on
              else contextlib.nullcontext()):
            out = tr.train(init_params=w0)
        launches = read_counts(wrappers)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        steps = out["step"]
        check(launches == sage_launches(steps, device=True),
              f"obs overhead on={on}: {launches} in {steps} steps")
        if ref is None:
            ref = out
        check(same_run(out, ref), f"obs overhead: the run with the obs "
              f"directory {'on' if on else 'off'} differs from the first")
        rec = device_run_record(out["history"][0], steps, DEV_K)
        runs[on].append(rec["steady_ms_per_step"])
        if on:
            mfus.append(P.prof_summary(obs_dir)["train_mfu"])
            check(0 < mfus[-1] <= 1, f"obs overhead: train_mfu {mfus[-1]}")
    off, on_ms = float(np.mean(runs[False])), float(np.mean(runs[True]))
    # the host's cost of one heartbeat (the profiler's tick with its
    # CUDA event, the events line with a directory), alone
    beat_us = {False: [], True: []}
    timer = tr.timer
    for i, on in enumerate((False, True, True, False)):
        with (obs_run(os.path.join(work, f"obs_beats{i}"),
                      role="trainer-0") if on
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            for b in range(OBS_BEATS):
                heartbeat(b, 0, timer, sps=1.0, loss=1.0, grad_norm=1.0)
            beat_us[on].append((time.perf_counter() - t0) / OBS_BEATS
                               * 1e6)
    emit(phase="obs", part="overhead", card=card, steps_per_call=DEV_K,
         steps=ref["step"], order="off,on,on,off", bit_equal=True,
         steady_ms_per_step_off=runs[False],
         steady_ms_per_step_on=runs[True], off_ms_mean=off,
         on_ms_mean=on_ms, ratio=on_ms / off, overhead=(on_ms - off) / off,
         train_mfu_k4=mfus, cost_source=P.get_profiler().cost_source(),
         heartbeat_us_off=beat_us[False], heartbeat_us_on=beat_us[True])
    return total


def obs_phase(torch, args, wrappers, g, trainer, ctx, work: str,
              card: str) -> dict:
    """The obs file and job planes on the card (:func:`obsjob`) and the
    file plane's cost (:func:`obs_overhead`). Returns their launches."""
    t0 = time.perf_counter()
    job = obsjob(torch, ctx, work, card)
    over = obs_overhead(torch, args, wrappers, g, trainer, work, card)
    total = {k: job.get(k, 0) + over[k] for k in over}
    emit(phase="obs", part="done", card=card, launches=total,
         seconds=time.perf_counter() - t0)
    return total


# ----------------------------------------------------------- tune
# the knob search: successive halving over the probe entry point on the
# card. The space's num_samplers values include the registry default
# (0), so the draw's default candidate is a grid point and the grid's 4
# points are the whole field: 4 -> 2 -> 1 candidates, 7 probes
TUNE_SPACE = {"num_samplers": (0, 2), "feats_layout": ("replicated", "owner")}
TUNE_N0, TUNE_ETA, TUNE_BASE_STEPS, TUNE_SEED = 4, 2, 8, 0
TUNE_IDS_PER_PART = 8 * BATCH_TRAIN   # an epoch of 8 steps a part
PROBE_TIMEOUT_S = 300


def tune_phase(torch, args, g, ctx, work: str, card: str,
               device: str = "cuda") -> dict:
    """``successive_halving`` over the port's ``make_probe_fn`` on the
    card: every probe a ``python -m dgl_operator_tpu_torch.autotune.probe``
    child (``DistTrainer``, ``DistSAGE`` hidden 16, batch 1000, fanouts
    10,25, both slots in the child) over a 2-part book of the products
    graph with each part's train split cut to 8 steps an epoch, scored
    from its own obs files. Checks the rung schedule, every probe's
    record, that a relaunch over the ledger runs no probe, and the
    manifest's round trip through ``apply_tuned``. Returns the probes'
    kernel launches (each child's own count)."""
    from dgl_operator_tpu_torch.autotune import knobs as AK
    from dgl_operator_tpu_torch.autotune.probe import (ProbeSpec,
                                                       make_probe_fn)
    from dgl_operator_tpu_torch.autotune.search import (config_key,
                                                        rung_schedule,
                                                        successive_halving)
    from dgl_operator_tpu_torch.runtime.loop import TrainConfig

    t0 = time.perf_counter()
    root = os.path.join(work, "tune")
    book, _ = cut_book(g, ctx["node_map"], TUNE_IDS_PER_PART,
                       os.path.join(root, "book"))
    book_s = time.perf_counter() - t0
    spec = ProbeSpec(part_config=book, num_parts=2, batch_size=BATCH_TRAIN,
                     fanouts=FANOUTS, seed=args.seed,
                     timeout_s=PROBE_TIMEOUT_S, device=device)
    probe_fn = make_probe_fn(spec, os.path.join(root, "probes"))
    probe_s = {}

    def timed(knobs, steps, rung):
        t = time.perf_counter()
        out = probe_fn(knobs, steps, rung)
        probe_s[f"r{rung}:s{steps}:{config_key(knobs)}"] = \
            time.perf_counter() - t
        return out

    ledger = os.path.join(root, "ledger.json")
    search = dict(n0=TUNE_N0, eta=TUNE_ETA, base_steps=TUNE_BASE_STEPS,
                  seed=TUNE_SEED, ledger_path=ledger)
    t1 = time.perf_counter()
    res = successive_halving(TUNE_SPACE, timed, **search)
    search_s = time.perf_counter() - t1
    want = rung_schedule(TUNE_N0, TUNE_BASE_STEPS, TUNE_ETA)
    check([tuple(s) for s in res["schedule"]] == want
          and res["probes_run"] == sum(n for _, _, n in want)
          and res["probes_skipped"] == 0,
          f"tune: schedule {res['schedule']} against {want}, "
          f"{res['probes_run']} probes run")
    with open(ledger) as f:
        probes = json.load(f)["probes"]
    launches, records = {}, {}
    for key, rec in sorted(probes.items()):
        with open(rec["record"]) as f:
            record = json.load(f)
        records[key] = record
        check(record.get("ok") is True and record["probe"]["steps"] > 0
              and record["probe"]["steps"] >= rec["steps"]
              and record["device"].startswith(device)
              and rec["score"] > 0,
              f"tune: probe {key}: {rec.get('error')} {record}")
        add_counts(launches, record["probe"]["launches"])
    if device == "cuda":
        check(all(v > 0 for v in launches.values()),
              f"tune: the probes' launches {launches}")
    # a relaunch over the same ledger pays for nothing
    calls = []
    again = successive_halving(
        TUNE_SPACE, lambda k, s, r: calls.append(k) or probe_fn(k, s, r),
        **search)
    check(calls == [] and again["probes_run"] == 0
          and again["winner"] == res["winner"]
          and again["rungs"] == res["rungs"],
          f"tune: the relaunch ran {len(calls)} probes, winner "
          f"{again['winner']} against {res['winner']}")
    # the manifest, loaded back and applied to a default TrainConfig
    manifest = os.path.join(root, "tuned.json")
    # the defaults are candidate 0, scored on rung 0
    base = res["rungs"][0]["scores"][config_key(
        {k: AK.default_of(k) for k in TUNE_SPACE})]
    AK.write_manifest(manifest, res["winner"], score=res["winner_score"],
                      baseline_score=base,
                      search={"signature": res["signature"],
                              "probes_run": res["probes_run"]})
    man = AK.load_manifest(manifest)
    with chaos_env(**{AK.TUNED_MANIFEST_ENV: manifest}):
        tuned = AK.apply_tuned(TrainConfig())
    check(man["knobs"] == res["winner"]
          and all(getattr(tuned, k) == v for k, v in res["winner"].items()),
          f"tune: manifest {man['knobs']}, applied "
          f"{ {k: getattr(tuned, k) for k in res['winner']} }")
    emit(phase="tune", card=card, space={k: list(v) for k, v in
                                         TUNE_SPACE.items()},
         n0=TUNE_N0, eta=TUNE_ETA, base_steps=TUNE_BASE_STEPS,
         schedule=res["schedule"],
         rungs=[{"rung": r["rung"], "steps": r["steps"],
                 "scores": r["scores"], "survivors": r["survivors"]}
                for r in res["rungs"]],
         winner=res["winner"], winner_score=res["winner_score"],
         baseline_score=base, probes_run=res["probes_run"],
         relaunch_probes_run=again["probes_run"],
         probe_s=probe_s, probe_child_s={
             k: r["total_s"] for k, r in records.items()},
         probe_steps={k: r["probe"]["steps"] for k, r in records.items()},
         probe_mfu={k: r["probe"].get("mfu") for k, r in records.items()},
         hbm_budget={k: r["hbm_budget"] for k, r in records.items()},
         launches=launches, book_s=book_s, search_s=search_s,
         seconds=time.perf_counter() - t0)
    return launches


# -------------------------------------------------------- elastic
ELASTIC_IDS = 8 * BATCH_TRAIN   # 4,000 a part: 4 steps an epoch
ELASTIC_EPOCHS = 2
ELASTIC_DIE_AT = 5              # mid-run: the second epoch's first step
# the elastic job's child: tpurun phase 5 starts it by path on every
# hostfile line, and line i trains partition i (the rank): an
# independent full-width SampledTrainer over its share of the cut train
# split, checkpointing every 2 steps; one JSON line per run appended to
# results-<part>.jsonl (its digest, steps, fence epoch and launches)
ELASTIC_CHILD = """
import argparse, hashlib, json, os, sys
spec = json.loads(os.environ["ELASTIC_SPEC"])
sys.path.insert(0, spec["repo"])
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ap = argparse.ArgumentParser()
for f in ("--graph_name", "--ip_config", "--part_config"):
    ap.add_argument(f)
for f in ("--num_epochs", "--batch_size", "--num_workers"):
    ap.add_argument(f, type=int)
a = ap.parse_args()
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.ops import fanout, gather, scatter
from dgl_operator_tpu_torch.ops.device_sample import tree_sample
from dgl_operator_tpu_torch.runtime.loop import (Preempted, SampledTrainer,
                                                 TrainConfig)
part = int(os.environ["TPU_OPERATOR_RANK"])
ws = os.environ["TPU_OPERATOR_WORKSPACE"]
g = getattr(datasets, spec["graph"][0])(**spec["graph"][1]).graph
ids = np.nonzero(g.ndata["train_mask"])[0][:spec["ids"]][part::spec["parts"]]
cfg = TrainConfig(num_epochs=a.num_epochs, batch_size=a.batch_size,
                  fanouts=tuple(spec["fanouts"]), lr=spec["lr"],
                  eval_every=0, log_every=1000, dropout=0.0,
                  sampler="device", seed=100 + part,
                  ckpt_dir=os.path.join(ws, "ckpt", f"part-{part}"),
                  ckpt_every=2)
model = DistSAGE(*spec["widths"], dropout=0.0, device=spec["device"],
                 generator=torch.Generator().manual_seed(100 + part))
tr = SampledTrainer(model, g, cfg, train_ids=ids, device=spec["device"])
try:
    out = tr.train()
except Preempted:
    raise SystemExit(75)
h = hashlib.sha256()
for k in sorted(out["params"]):
    h.update(out["params"][k].detach().cpu().numpy().tobytes())
dev = torch.device(spec["device"])
with open(os.path.join(spec["out"], f"results-{part}.jsonl"), "a") as f:
    f.write(json.dumps({
        "part": part, "step": out["step"], "digest": h.hexdigest(),
        "epoch_env": os.environ.get("TPU_OPERATOR_ELASTIC_EPOCH"),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "launches": {w.__name__: w.launches for w in (
            fanout.fanout_agg, gather.gather_rows,
            scatter.scatter_add_rows, tree_sample)}}) + "\\n")
"""


def params_digest(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def elastic_baseline(torch, wrappers, g, spec: dict, part: int):
    """The undisturbed run of partition ``part``, in this process: the
    child's model, seeds and stream keys, no checkpoints (math-inert).
    Returns its digest, steps and launches."""
    import numpy as np

    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    ids = np.nonzero(g.ndata["train_mask"])[0][:spec["ids"]]
    cfg = TrainConfig(num_epochs=ELASTIC_EPOCHS, batch_size=BATCH_TRAIN,
                      fanouts=tuple(spec["fanouts"]), lr=spec["lr"],
                      eval_every=0, log_every=1000, dropout=0.0,
                      sampler="device", seed=100 + part)
    model = DistSAGE(*spec["widths"], dropout=0.0, device=spec["device"],
                     generator=torch.Generator().manual_seed(100 + part))
    tr = SampledTrainer(model, g, cfg, train_ids=ids[part::spec["parts"]],
                        device=spec["device"])
    reset_counts(wrappers)
    out = tr.train()
    return params_digest(out["params"]), out["step"], read_counts(wrappers)


def elastic_phase(torch, args, wrappers, g, ctx, work: str, card: str,
                  device: str = "cuda", graph=None) -> Tuple[dict, str]:
    """``tpurun --elastic`` over ``LocalFabric`` with two local hostfile
    entries: the dist book's 2 parts dispatched, :data:`ELASTIC_CHILD`
    started by path, one process a partition, and chaos
    ``host:die:5@host=el-worker-1`` killing partition 1's process at
    its fifth step. The driver must shrink to the survivor (width 1,
    epoch 1), relaunch phases 3-5 on it from the fenced checkpoints, and
    each partition's final parameters and steps must equal the
    undisturbed run's; then the readmitted host regrows the plan (full
    width, epoch 2). Returns the children's launches and the run's obs
    directory."""
    import argparse as _argparse
    import io

    from dgl_operator_tpu_torch.launcher import elastic, tpurun
    from dgl_operator_tpu_torch.launcher.chaos import (CHAOS_ENV,
                                                       WORKSPACE_ENV,
                                                       dead_hosts,
                                                       readmit_host)
    from dgl_operator_tpu_torch.launcher.fabric import LocalFabric
    from dgl_operator_tpu_torch.obs import OBS_DIR_ENV
    from dgl_operator_tpu_torch.parallel.bootstrap import (FENCE_EPOCH_ENV,
                                                           PHASE_ENV,
                                                           HostEntry,
                                                           parse_hostfile,
                                                           write_hostfile)

    t0 = time.perf_counter()
    root = os.path.join(work, "elastic")
    ws, conf, out = (os.path.join(root, d) for d in ("ws", "conf", "out"))
    for d in (ws, conf, out):
        os.makedirs(d)
    hostfile = os.path.join(conf, "hostfile")
    hosts = [f"el-worker-{i}" for i in range(2)]
    write_hostfile(hostfile, [HostEntry("127.0.0.1", free_port(), h, 1)
                              for h in hosts])
    spec = dict(repo=REPO, graph=graph or ["ogbn_products", {
        "seed": args.seed, "scale": args.scale}], ids=ELASTIC_IDS, parts=2,
        fanouts=list(FANOUTS), lr=LR, widths=[FEAT, HIDDEN, CLASSES],
        device=device, out=out)
    entry = os.path.join(root, "train_elastic.py")
    with open(entry, "w") as f:
        f.write(ELASTIC_CHILD)
    base = {}
    t1 = time.perf_counter()
    for p in range(2):
        base[p] = elastic_baseline(torch, wrappers, g, spec, p)
    base_s = time.perf_counter() - t1
    steps = base[1][1]
    check(steps == ELASTIC_EPOCHS * (ELASTIC_IDS // 2 // BATCH_TRAIN)
          and ELASTIC_DIE_AT < steps,
          f"elastic: the undisturbed run's {steps} steps")
    argv = ["--graph-name", "ogbn-products", "--num-partitions", "2",
            "--partition-config-path", ctx["book"],
            "--train-entry-point", entry, "--workspace", ws,
            "--conf-dir", conf, "--num-epochs", str(ELASTIC_EPOCHS),
            "--batch-size", str(BATCH_TRAIN), "--fabric", "local",
            "--elastic"]
    log = io.StringIO()
    with chaos_env(**{PHASE_ENV: None, OBS_DIR_ENV: None,
                      FENCE_EPOCH_ENV: None, WORKSPACE_ENV: None,
                      CHAOS_ENV: f"host:die:{ELASTIC_DIE_AT}@host={hosts[1]}",
                      "TPU_OPERATOR_RETRY_BASE_S": "0.05",
                      "ELASTIC_SPEC": json.dumps(spec)}):
        t2 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(log):
                tpurun.main(argv)
        except SystemExit as exc:
            check(False, f"elastic: tpurun exited {exc.code}:\n"
                  f"{log.getvalue()[-3000:]}")
        driver_s = time.perf_counter() - t2
        t_end = time.time()
        fence_exported = os.environ.get(FENCE_EPOCH_ENV)
        runs = {p: read_jsonl(os.path.join(out, f"results-{p}.jsonl"))
                for p in range(2)}
        plan = elastic.load_plan(ws)
        placed = [e.name for e in parse_hostfile(
            os.path.join(ws, "hostfile_elastic"))]
        obs_dir = os.path.join(ws, "obs")
        events = read_jsonl(os.path.join(obs_dir, "events.jsonl"))
        died = [e for e in events if e["event"] == "host_died"]
        shrink = [e for e in events if e["event"] == "elastic_shrink"]
        check(len(died) == 1 and died[0]["host_name"] == hosts[1]
              and died[0]["step"] == ELASTIC_DIE_AT and len(shrink) == 1
              and dead_hosts(ws) == [hosts[1]],
              f"elastic: host_died {died}, shrinks {shrink}")
        check(plan["width"] == 1 and plan["epoch"] == 1
              and plan["dead"] == [hosts[1]]
              and placed == [hosts[0], hosts[0]]
              and fence_exported == "1",
              f"elastic: plan {plan}, hostfile {placed}, fence "
              f"{fence_exported}")
        finals = {p: runs[p][-1] for p in range(2)}
        for p in range(2):
            check(finals[p]["digest"] == base[p][0]
                  and finals[p]["step"] == base[p][1]
                  and finals[p]["epoch_env"] == "1",
                  f"elastic: partition {p}'s final run {finals[p]} against "
                  f"the undisturbed {base[p][:2]}")
        check(os.path.isdir(os.path.join(ws, "ckpt", "part-1", "epoch-1")),
              "elastic: the relaunch checkpointed under epoch-1")
        launches = {}
        for p in range(2):
            for r in runs[p]:
                add_counts(launches, r["launches"])
        check(device != "cuda" or (
            all(v > 0 for v in launches.values())
            and all(r["device"] == torch.cuda.get_device_name(0)
                    for p in range(2) for r in runs[p])),
            f"elastic: the children's launches {launches}")
        # regrow at the plan level: the dead host answers again
        readmit_host(hosts[1], ws)
        rargs = _argparse.Namespace()
        hf = elastic.resolve(rargs, ws, ctx["book"], hostfile, LocalFabric())
        plan2 = elastic.load_plan(ws)
        check(hf == hostfile and plan2["dead"] == [] and plan2["epoch"] == 2
              and plan2["width"] == plan2["full_width"] == 2
              and rargs.elastic_sig == "epoch-2"
              and os.environ.get(FENCE_EPOCH_ENV) == "2",
              f"elastic: regrow plan {plan2}, sig "
              f"{getattr(rargs, 'elastic_sig', None)}")
    relaunch_s = t_end - shrink[0]["ts"]
    emit(phase="elastic", card=card, die_at=ELASTIC_DIE_AT, steps=steps,
         dead=plan["dead"], width=plan["width"], epoch=plan["epoch"],
         assignment=plan["assignment"], rates=plan.get("rates"),
         hostfile_elastic=placed, regrow_epoch=plan2["epoch"],
         regrow_width=plan2["width"],
         runs={p: [{k: r[k] for k in ("step", "epoch_env")}
                   for r in runs[p]] for p in range(2)},
         bit_equal=True, launches=launches,
         baseline_launches={p: base[p][2] for p in range(2)},
         baseline_s=base_s, driver_s=driver_s, relaunch_s=relaunch_s,
         seconds=time.perf_counter() - t0)
    return launches, obs_dir


# --------------------------------------------------- controlplane
def controlplane_phase(elastic_obs: str, work: str, card: str,
                       build_s: dict) -> None:
    """The control plane on the card's host: the port's ``tpu-operator``
    and ``tpu-watcher``, built from its sources beside the kernels
    (``build_s``: their compile seconds) and found again here, a
    ``FakeCluster`` job driven Partitioning -> Partitioned -> Training ->
    Completed, the watcher's barrier run once over the rendered
    partfile, and a second job whose health feed is the ``elastic``
    phase's job view: the controller must fail its launcher with reason
    ``HostDead``, naming the dead host. No ``--config``: yaml is never
    imported."""
    from dgl_operator_tpu_torch.controlplane import (Controller,
                                                     FakeCluster,
                                                     simple_job)
    from dgl_operator_tpu_torch.controlplane import controller as C
    from dgl_operator_tpu_torch.controlplane.api import (
        DEFAULT_LAUNCHER_COMMAND)
    from dgl_operator_tpu_torch.obs import get_obs

    t0 = time.perf_counter()
    with chaos_env(**{C.BIN_DIR_ENV: None}):
        again = C.ensure_built()
        built = (C.operator_binary(), C.watcher_binary())
        check(all(os.path.dirname(b) == os.path.join(
            REPO, "dgl_operator_tpu_torch", "_build") for b in built)
            and set(build_s) == set(again)
            and not any(again.values()),
            f"controlplane: binaries {built}, rebuilt {again}")

        def drive(name: str, status_dir: str):
            cluster = FakeCluster(status_dir=status_dir)
            ctl = Controller(cluster)
            job = simple_job(name, 2)
            ctl.reconcile(job)
            cluster.set_pod_phase(f"{name}-partitioner", "Running")
            phases = [ctl.reconcile_until(job, "Partitioning")]
            return cluster, ctl, job, phases

        root = os.path.join(work, "controlplane")
        cluster, ctl, job, phases = drive("smoke", os.path.join(root, "st"))
        partfile = os.path.join(root, "partfile")
        with open(partfile, "w") as f:
            f.write(cluster.config_maps["smoke-config"]["data"]["partfile"])
        watcher = subprocess.Popen(
            [C.watcher_binary(), "--watch-file", partfile, "--status-dir",
             cluster.status_dir, "--mode", "finished", "--timeout-ms",
             "20000", "--poll-ms", "20"])
        tw = time.perf_counter()
        time.sleep(0.2)
        waiting = watcher.poll() is None
        cluster.set_pod_phase("smoke-partitioner", "Succeeded")
        watcher_rc = watcher.wait(timeout=30)
        watcher_s = time.perf_counter() - tw
        check(waiting and watcher_rc == 0,
              f"controlplane: the watcher barrier (waiting {waiting}, "
              f"exit {watcher_rc})")
        phases.append(ctl.reconcile_until(job, "Partitioned"))
        ctl.reconcile(job)
        for n in ("smoke-worker-0", "smoke-worker-1", "smoke-launcher"):
            cluster.set_pod_phase(n, "Running")
        phases.append(ctl.reconcile_until(job, "Training"))
        cluster.set_pod_phase("smoke-launcher", "Succeeded")
        phases.append(ctl.reconcile_until(job, "Completed"))
        ctl.reconcile(job)
        launcher_cmd = cluster.pods["smoke-launcher"]["spec"][
            "containers"][0]["command"]
        check(phases == ["Partitioning", "Partitioned", "Training",
                         "Completed"]
              and "smoke-worker-0" not in cluster.pods
              and launcher_cmd == list(DEFAULT_LAUNCHER_COMMAND),
              f"controlplane: phases {phases}, pods {cluster.pod_names()}, "
              f"launcher {launcher_cmd}")

        # the health-triggered restart from the elastic job's view
        hcluster, hctl, hjob, _ = drive("heal", os.path.join(root, "hst"))
        hcluster.set_pod_phase("heal-partitioner", "Succeeded")
        hctl.reconcile_until(hjob, "Partitioned")
        hctl.reconcile(hjob)
        for n in ("heal-worker-0", "heal-worker-1", "heal-launcher"):
            hcluster.set_pod_phase(n, "Running")
        hctl.reconcile_until(hjob, "Training")
        feed = C.job_health_feed(elastic_obs)
        snap = feed()
        n0 = len([e for e in get_obs().events
                  if e["kind"] == "job_host_dead"])
        final = hctl.reconcile_until(hjob, max_iters=5, backoff_limit=1,
                                     health=feed)
        named = [e for e in get_obs().events
                 if e["kind"] == "job_host_dead"][n0:]
        launcher = hcluster.pods["heal-launcher"]["status"]
        check(snap.get("dead") and "el-worker-1" in snap.get("dead_hosts",
                                                             [])
              and launcher.get("reason") == "HostDead"
              and named and "el-worker-1" in named[0]["dead_hosts"],
              f"controlplane: health {snap}, launcher {launcher}, "
              f"events {named}")
    emit(phase="controlplane", card=card, build_s=build_s,
         binaries=[os.path.basename(b) for b in built], phases=phases,
         watcher_rc=watcher_rc, watcher_s=watcher_s,
         health_source=snap.get("source"), dead=snap.get("dead"),
         dead_hosts=snap.get("dead_hosts"), restart_reason=launcher["reason"],
         final_phase=final, yaml_imported="yaml" in sys.modules,
         seconds=time.perf_counter() - t0)
    check("yaml" not in sys.modules, "controlplane: yaml was imported")


# ------------------------------------------------------------------ shard
# the shard phase's book: the serving phase's 2-part assignment halved
# by node id parity into 4 parts, each part's train split cut to 8
# steps (a depth cut)
SHARD_IDS_PER_PART = 8 * BATCH_TRAIN
SHARD_RULES = (("neigh", "dp"), (".*", None))
SHARD_TP_RULES = (("kernel", (None, "mp")), (".*", "dp"))
KGE_REL_RULES = (("relation", "dp"), (".*", None))
KGE_SHARD_STEPS = 10   # the KGE grid with and without relation rules
# one rank of the shard phase's gloo pair on the card: DistTrainer with
# shard_update over its 2 of the 4 parts, its optimizer state's bytes on
# the card, its kernel counts and its weights written for the parent
SHARD_CHILD = """
import datetime, json, sys
spec = json.loads(sys.argv[1])
sys.path.insert(0, spec["repo"])
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.ops import fanout, gather, scatter
from dgl_operator_tpu_torch.runtime.dist import DistTrainer
from dgl_operator_tpu_torch.runtime.loop import TrainConfig
torch.distributed.init_process_group(
    "gloo", init_method=f"tcp://127.0.0.1:{spec['port']}", world_size=2,
    rank=spec["rank"], timeout=datetime.timedelta(seconds=120))
wrappers = (fanout.fanout_agg, gather.gather_rows, scatter.scatter_add_rows)
model = DistSAGE(*spec["widths"], device="cuda")
with np.load(spec["w0"]) as z:
    model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
tr = DistTrainer(model, spec["book"], TrainConfig(**spec["cfg"]),
                 device="cuda")
for w in wrappers:
    w.launches = 0
out = tr.train()
torch.cuda.synchronize()
opt = sum(v.numel() * v.element_size()
          for st in tr.optimizer.state.values() for v in st.values()
          if isinstance(v, torch.Tensor) and v.is_cuda)
np.savez(spec["out"] + ".npz",
         **{k: v.cpu().numpy() for k, v in out["params"].items()})
with open(spec["out"] + ".json", "w") as f:
    json.dump({"losses": out["history"][0]["losses"],
               "opt_state_bytes_on_card": opt,
               "memory_allocated": torch.cuda.memory_allocated(),
               "slots": tr._plan.slots,
               "launches": {w.__name__: w.launches for w in wrappers}}, f)
torch.distributed.destroy_process_group()
"""


def state_bytes(tr) -> dict:
    """The measured bytes a slot of a trainer's state tensors: its
    plan's (a shard, a block or the full parameter, and the optimizer's
    tensors of those), or every parameter and Adam tensor when
    replicated."""
    if tr._plan is not None:
        return tr._plan.slot_bytes()
    params = sum(p.numel() * p.element_size()
                 for p in tr.model.parameters())
    opt = sum(v.numel() * v.element_size()
              for st in tr.optimizer.state.values() for v in st.values()
              if hasattr(v, "numel"))
    return {s: {"params": params, "opt_state": opt}
            for s in range(tr.num_parts)}


def moment_bytes(tr, slot: int = 0) -> int:
    """Adam's moments (its step counters aside) of ``slot``'s state."""
    if tr._plan is None:
        return sum(v.numel() * v.element_size()
                   for st in tr.optimizer.state.values()
                   for k, v in st.items() if k != "step")
    plan = tr._plan
    m = plan.mesh.size // plan.n
    total = 0
    for lf in plan.leaves:
        t = (lf.parts[lf.coords.index(slot // m)] if lf.kind == "flat"
             else lf.parts[0])
        total += sum(v.numel() * v.element_size() for k, v in
                     plan.optimizer.state[t].items() if k != "step")
    return total


def state_diff(torch, a: dict, b: dict) -> float:
    """Largest absolute difference of two runs' weights and logical Adam
    states (0.0: bit for bit)."""
    d = max(float((a["params"][k] - b["params"][k]).abs().max())
            for k in a["params"])
    sa, sb = a["opt_state"]["state"], b["opt_state"]["state"]
    check(sorted(sa) == sorted(sb), "the Adam states name other tensors")
    for i in sa:
        for k in sa[i]:
            x, y = (torch.as_tensor(s[i][k]).float().cpu() for s in (sa, sb))
            d = max(d, float((x - y).abs().max()))
    return d


def shard_phase(torch, args, wrappers, g, ctx, kg, work: str,
                card: str) -> dict:
    """State sharding through ``DistTrainer`` on the card (see the
    module docstring, 13g). Returns the launches of its runs, the gloo
    ranks' included."""
    import numpy as np

    from dgl_operator_tpu_torch.graph.kge_sampler import TrainDataset
    from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                    state_dict_from_flax)
    from dgl_operator_tpu_torch.parallel.mesh import (make_mesh,
                                                      make_train_mesh)
    from dgl_operator_tpu_torch.runtime.dist import DistTrainer
    from dgl_operator_tpu_torch.runtime.loop import (TrainConfig,
                                                     open_checkpoints)

    t_phase = time.perf_counter()
    total = {w.__name__: 0 for w in wrappers}
    node_map4 = (np.asarray(ctx["node_map"], np.int64) * 2
                 + np.arange(g.num_nodes) % 2)
    t0 = time.perf_counter()
    book, _ = cut_book(g, node_map4, SHARD_IDS_PER_PART,
                       os.path.join(work, "shard_book"), num_parts=4)
    book_s = time.perf_counter() - t0
    ckpt = os.path.join(work, "shard_ckpt")
    base = dict(num_epochs=1, batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                eval_every=0, seed=args.seed)
    runs = {}

    def run(name, mesh=None, **fields):
        t0 = time.perf_counter()
        tr = DistTrainer(DistSAGE(FEAT, HIDDEN, CLASSES, device="cuda"),
                         book, TrainConfig(**base, **fields), device="cuda",
                         mesh=mesh)
        make_s = time.perf_counter() - t0
        P = tr.num_parts
        # the main path: every kernel count starts at 0 here
        reset_counts(wrappers)
        t0 = time.perf_counter()
        out = tr.train(init_params=ctx["w0"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts(wrappers)
        steps = out["step"]
        check(steps == tr.steps_per_epoch == SHARD_IDS_PER_PART // BATCH_TRAIN,
              f"shard {name}: {steps} steps")
        check(launches == {"fanout_agg": 2 * P * steps,
                           "gather_rows": P * steps,
                           "scatter_add_rows": P * steps, "tree_sample": 0},
              f"shard {name}: {launches} launches in {steps} steps")
        losses = out["history"][0]["losses"]
        check(bool(np.isfinite(losses).all()), f"shard {name}: losses")
        for k, v in launches.items():
            total[k] += v
        runs[name] = (tr, out)
        return dict(run=name, mesh=tr.mesh.shape, slots=tr.mesh.size,
                    dp=P, steps=steps, launches=launches, trainer_s=make_s,
                    train_s=wall, ms_per_step=wall / steps * 1e3,
                    losses=losses)

    mib = 1.0 / 2**20

    def measured(tr) -> dict:
        return {str(s): {k: round(v * mib, 3) for k, v in b.items()}
                for s, b in state_bytes(tr).items()}

    rec = run("replicated")
    emit(phase="shard", card=card, book_s=book_s, **rec,
         summary=runs["replicated"][0].state_summary,
         measured_mib_per_slot=measured(runs["replicated"][0]))
    ref_tr, ref = runs["replicated"]
    repl_moments = moment_bytes(ref_tr)
    repl_params = sum(p.numel() * 4 for p in ref_tr.model.parameters())
    for name, mesh, fields, against in (
            ("shard_update", None, dict(shard_update=True), "replicated"),
            ("shard_rules", None, dict(shard_rules=SHARD_RULES),
             "replicated"),
            ("zero3_gd1", None, dict(zero_stage=3, gather_depth=1,
                                     ckpt_dir=ckpt), "replicated"),
            ("zero3_gd4", None, dict(zero_stage=3, gather_depth=4),
             "replicated"),
            ("replicated_dp2", make_mesh(2), {}, None),
            ("zero3_tp2", make_train_mesh(2, 2),
             dict(zero_stage=3, tp_axis_size=2, shard_rules=SHARD_TP_RULES),
             "replicated_dp2")):
        rec = run(name, mesh, **fields)
        tr, out = runs[name]
        extra = {}
        if against is not None:
            want = runs[against][1]
            same_losses = (out["history"][0]["losses"]
                           == want["history"][0]["losses"])
            d = state_diff(torch, out, want)
            check(same_losses and d == 0.0,
                  f"shard {name}: losses equal {same_losses}, weights and "
                  f"Adam state {d} apart from {against}")
            plan = tr._plan
            extra = dict(bit_equal_to=against, losses_equal=True,
                         max_abs_diff=d, zero_stage=plan.zero_stage,
                         kinds=sorted({lf.kind for lf in plan.leaves}))
            if plan.zero_stage == 1 and name == "shard_update":
                ratio = moment_bytes(tr) / repl_moments
                check(ratio <= 0.30, f"shard {name}: a slot's moments "
                      f"{ratio} of the replicated")
                extra["opt_moments_ratio_to_replicated"] = ratio
            if plan.zero_stage == 3 and mesh is None:
                ratio = state_bytes(tr)[0]["params"] / repl_params
                check(ratio <= 0.30, f"shard {name}: a slot's params "
                      f"{ratio} of the replicated")
                extra["params_ratio_to_replicated"] = ratio
        emit(phase="shard", card=card, **rec, **extra,
             summary=tr.state_summary, measured_mib_per_slot=measured(tr))

    # the stage-3 checkpoint written at 4 slots, restored at 2
    want = runs["zero3_gd1"][1]
    restored = {}
    for name in ("zero3_tp2", "replicated_dp2"):
        tr = runs[name][0]
        cfg = dataclasses.replace(tr.cfg, ckpt_dir=ckpt, resume="auto")
        _, step = open_checkpoints(cfg, tr.model, tr.optimizer,
                                   plan=tr._plan)
        if tr._plan is not None:
            st = tr._plan.train_state()
            got = {"params": st["params"], "opt_state": {"state": {
                int(i): v for i, v in st["opt"].items()}}}
        else:
            got = {"params": tr.model.state_dict(),
                   "opt_state": tr.optimizer.state_dict()}
        d = state_diff(torch, got, want)
        check(step == want["step"] and d == 0.0,
              f"shard checkpoint into {name}: step {step}, {d} apart")
        restored[name] = dict(step=step, max_abs_diff=d,
                              mesh=tr.mesh.shape)
    emit(phase="shard", card=card, part="checkpoint", written_by="zero3_gd1",
         written_mesh=runs["zero3_gd1"][0].mesh.shape, restored=restored)

    # two gloo ranks on the card with shard_update
    tmp = os.path.join(work, "shard_mp")
    os.makedirs(tmp, exist_ok=True)
    w0_path = os.path.join(tmp, "w0.npz")
    np.savez(w0_path, **{k: v.numpy() for k, v in
                         state_dict_from_flax(ctx["w0"]).items()})
    port = free_port()
    t0 = time.perf_counter()
    run_two_ranks(SHARD_CHILD, lambda r: {
        "repo": REPO, "rank": r, "port": port, "book": book, "w0": w0_path,
        "widths": [FEAT, HIDDEN, CLASSES],
        "cfg": {**base, "fanouts": list(FANOUTS), "shard_update": True},
        "out": os.path.join(tmp, f"rank{r}")}, tmp, "shard two ranks")
    wall = time.perf_counter() - t0
    res = []
    for r in (0, 1):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res.append(json.load(f))
        for k, v in res[r]["launches"].items():
            total[k] += v
    one = runs["shard_update"][1]
    repl_opt = sum(v.numel() * v.element_size()
                   for st in ref_tr.optimizer.state.values()
                   for v in st.values() if getattr(v, "is_cuda", False))
    with np.load(os.path.join(tmp, "rank0.npz")) as z:
        pdiff = max(float(np.abs(z[k] - v.cpu().numpy()).max())
                    for k, v in one["params"].items())
    ratios = [x["opt_state_bytes_on_card"] / repl_opt for x in res]
    check(res[0]["losses"] == res[1]["losses"]
          and max(ratios) <= 0.55 and pdiff <= 1e-5,
          f"shard two ranks: losses {[x['losses'] for x in res]}, optimizer "
          f"bytes {ratios} of replicated, weights {pdiff} from one process")
    emit(phase="shard", card=card, part="two_ranks", backend="gloo",
         device="cuda:0", world_size=2, wall_s=wall,
         slots_per_rank=[x["slots"] for x in res],
         opt_state_bytes_on_card=[x["opt_state_bytes_on_card"] for x in res],
         replicated_opt_state_bytes_on_card=repl_opt,
         opt_state_ratio_to_replicated=ratios,
         memory_allocated=[x["memory_allocated"] for x in res],
         losses_equal_across_ranks=True,
         param_max_abs_diff_to_one_process=pdiff,
         launches_per_rank=[x["launches"] for x in res])

    # the KGE grid with relation shard_rules against the unsharded grid
    td4 = TrainDataset(kg.train, kg.n_entities, kg.n_relations, ranks=4)
    outs = {}
    for name, fields in (("unsharded", {}),
                         ("relation_rules",
                          dict(shard_rules=KGE_REL_RULES))):
        tr = kge_grid_trainer(kg, args.seed, (2, 2), "cuda",
                              max_step=KGE_SHARD_STEPS, **fields)
        out, launches, rec = grid_run(torch, wrappers, tr, td4,
                                      f"kge {name}", KGE_SHARD_STEPS)
        for k, v in launches.items():
            total[k] += v
        outs[name] = (tr, out, rec)
    (p_tr, p_out, _), (s_tr, s_out, s_rec) = outs.values()
    sd_p, sd_s = p_tr.state_dict(), s_tr.state_dict()
    same = (p_out["losses"] == s_out["losses"]
            and all(np.array_equal(sd_p[k], sd_s[k]) for k in sd_p))
    check(same and s_tr._rel_sharded, "kge relation rules: not bit-equal "
          "to the unsharded grid")
    emit(phase="shard", card=card, part="kge_relation_rules", grid=[2, 2],
         bit_equal_to_unsharded=True,
         relation_rows_padded=s_tr._rel_pad,
         summary=s_tr.state_sharding_summary(),
         unsharded_summary=p_tr.state_sharding_summary(), **s_rec)
    emit(phase="shard", card=card, part="done",
         seconds=time.perf_counter() - t_phase)
    return total


# ------------------------------------------------------------------- ring
RING_SHARDS = 4
RING_ATTN = dict(N=64, H=4, D=64)          # queries, heads, width
RING_LENGTHS = (2048, 8192, 32768)          # the key axis timed
RING_HUBS = 256        # the highest-degree nodes of the hub attention
RING_HUB_BATCH = 64    # bucket_by_degree's max_batch


def peak_call(torch, fn):
    """``fn()``'s result and the device bytes it held at its peak above
    what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def event_ms(torch, fn, iters: int = 3) -> float:
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ring_phase(torch, args, wrappers, g, kg, card: str) -> dict:
    """The ring forms on the card (see the module docstring, 13h).
    Returns the launches of the ring forms and the hub attention."""
    import numpy as np

    from dgl_operator_tpu_torch.graph.graph import Graph
    from dgl_operator_tpu_torch.models.gat import (bucket_by_degree,
                                                   gat_hub_attention)
    from dgl_operator_tpu_torch.nn.conv import GATConv
    from dgl_operator_tpu_torch.parallel import ring_attention as ra
    from dgl_operator_tpu_torch.parallel.embedding import (
        ShardedTableSpec, pad_rows, route, sharded_lookup,
        sharded_push_adagrad)
    from dgl_operator_tpu_torch.parallel.ring import (ring_lookup,
                                                      ring_push_adagrad)

    t_phase = time.perf_counter()
    total = {w.__name__: 0 for w in wrappers}
    rng = np.random.default_rng(args.seed)

    # (a) the embedding ring at the KGE job's batch and width: every
    # slot's h || t || neg (one chunk of negatives)
    M = 2 * KGE_BATCH + KGE_NEG
    spec = ShardedTableSpec(kg.n_entities, KGE_DIM, RING_SHARDS)
    table = torch.from_numpy(pad_rows(rng.normal(
        size=(kg.n_entities, KGE_DIM)), spec.padded_rows)).cuda()
    state = torch.zeros(spec.padded_rows, device="cuda")
    ids = rng.integers(0, kg.n_entities, size=(RING_SHARDS, M))
    grads = torch.from_numpy(rng.normal(size=(RING_SHARDS, M, KGE_DIM))
                             .astype(np.float32)).cuda()
    rt = route([ids.reshape(-1)], spec, 0).to("cuda")
    want, dense_peak = peak_call(torch, lambda: sharded_lookup(table, rt))
    reset_counts(wrappers)
    got, ring_peak = peak_call(torch, lambda: ring_lookup(table, ids, spec))
    look = read_counts(wrappers)
    check(torch.equal(got.view(-1, KGE_DIM), want), "ring_lookup is not "
          "sharded_lookup bit for bit")
    t_s, s_s = table.clone(), state.clone()
    _, dense_push_peak = peak_call(torch, lambda: sharded_push_adagrad(
        t_s, s_s, grads.view(-1, KGE_DIM), rt, KGE_LR))
    t_r, s_r = table.clone(), state.clone()
    reset_counts(wrappers)
    _, ring_push_peak = peak_call(torch, lambda: ring_push_adagrad(
        t_r, s_r, ids, grads, spec, KGE_LR))
    push = read_counts(wrappers)
    terr = float((t_r - t_s).abs().max())
    serr = float((s_r - s_s).abs().max())
    check(terr <= 1e-6 and serr <= 1e-6 * max(1.0, float(s_s.abs().max())),
          f"ring_push_adagrad {terr}, {serr} from sharded_push_adagrad")
    check(look["gather_rows"] > 0 and push["scatter_add_rows"] > 0,
          f"ring launches: lookup {look}, push {push}")
    for d in (look, push):
        for k, v in d.items():
            total[k] += v
    emit(phase="ring", card=card, part="embedding", shards=RING_SHARDS,
         ids_per_slot=M, dim=KGE_DIM, rows=kg.n_entities,
         lookup_bit_equal=True, push_table_max_abs_err=terr,
         push_state_max_abs_err=serr,
         peak_bytes={"sharded_lookup": dense_peak, "ring_lookup": ring_peak,
                     "sharded_push": dense_push_peak,
                     "ring_push": ring_push_peak},
         ms={"sharded_lookup": event_ms(torch, lambda: sharded_lookup(
             table, rt)), "ring_lookup": event_ms(
                 torch, lambda: ring_lookup(table, ids, spec))},
         launches={"lookup": look, "push": push})

    # (b) ring attention against dense, and the crossover
    N, H, D = RING_ATTN["N"], RING_ATTN["H"], RING_ATTN["D"]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    timings, crossover = [], None
    for S in RING_LENGTHS:
        q, k, v = randn(N, H, D), randn(N, S, H, D), randn(N, S, H, D)
        mask = (torch.rand(N, S, device="cuda", generator=gen)
                < 0.8).float()
        mask[:, :8] = 1.0
        el, er = randn(N, S, H), randn(N, H)
        ring_dot = lambda: ra.ring_dot_attention(q, k, v, mask, RING_SHARDS)
        dense_dot = lambda: ra.dense_dot_attention(q, k, v, mask)
        ring_gat = lambda: ra.ring_gat_attention(el, er, v, mask,
                                                 RING_SHARDS)
        dense_gat = lambda: ra.dense_gat_attention(el, er, v, mask)
        rd, rd_peak = peak_call(torch, ring_dot)
        dd, dd_peak = peak_call(torch, dense_dot)
        rg, dg = ring_gat(), dense_gat()
        errs = [float((rd - dd).abs().max()), float((rg - dg).abs().max())]
        check(max(errs) <= 1e-5, f"ring attention at S={S}: {errs} from "
              "dense")
        row = dict(S=S, dot_max_abs_err=errs[0], gat_max_abs_err=errs[1],
                   ring_dot_ms=event_ms(torch, ring_dot),
                   dense_dot_ms=event_ms(torch, dense_dot),
                   ring_gat_ms=event_ms(torch, ring_gat),
                   dense_gat_ms=event_ms(torch, dense_gat),
                   ring_dot_peak_bytes=rd_peak,
                   dense_dot_peak_bytes=dd_peak,
                   dense_attention_bytes=ra.dense_attention_bytes(
                       N, S, H, D, D))
        timings.append(row)
        if crossover is None and row["ring_dot_ms"] < row["dense_dot_ms"]:
            crossover = S
        del q, k, v, el, er, mask, rd, dd, rg, dg
    shape = {"N": N, "H": H, "shards": RING_SHARDS, "D": D}
    record = ra.write_crossover("cuda", crossover, shape)
    check(ra.recorded_crossover("cuda") == (
        None if crossover is None else {"crossover_s": crossover,
                                        "shape": shape}),
          "the crossover record does not read back")
    emit(phase="ring", card=card, part="attention", shards=RING_SHARDS,
         shape=shape, timings=timings, crossover_s=crossover,
         record=os.path.relpath(record, REPO))

    # (c) hub attention on the highest-degree nodes
    indptr, indices, _ = g.csc()
    deg = np.diff(indptr)
    hubs = np.argsort(deg, kind="stable")[-RING_HUBS:]
    buckets = bucket_by_degree(g, hubs, growth=4.0,
                               max_batch=RING_HUB_BATCH)
    conv = GATConv(FEAT, HIDDEN, num_heads=GAT_HEADS, device="cuda",
                   generator=torch.Generator().manual_seed(args.seed))
    x = torch.from_numpy(np.asarray(g.ndata["feat"], np.float32)).cuda()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    outs = [gat_hub_attention(conv, g, x, b, RING_SHARDS) for b in buckets]
    torch.cuda.synchronize()
    hub_s = time.perf_counter() - t0
    hub_launches = read_counts(wrappers)
    check(hub_launches["gather_rows"] == 2 * RING_SHARDS * len(buckets),
          f"hub attention: {hub_launches} launches over {len(buckets)} "
          "buckets")
    for k, v in hub_launches.items():
        total[k] += v
    errs = []
    for b, out in zip(buckets, outs):
        # the full-graph layer over the bucket's in-edges: exact on them
        src = np.concatenate([indices[indptr[d]:indptr[d + 1]] for d in b])
        dst = np.repeat(b, deg[b])
        sub = Graph(src.astype(np.int32), dst.astype(np.int32), g.num_nodes)
        with torch.no_grad():
            ref = conv(sub.to_device("cuda"), x)[torch.from_numpy(b).cuda()]
        errs.append(float((out - ref).abs().max())
                    / max(1.0, float(ref.abs().max())))
    check(max(errs) <= 1e-4, f"hub attention {errs} from the full-graph "
          "GATConv")
    big = max(buckets, key=lambda b: len(b) * int(deg[b].max()))
    _, ring_peak = peak_call(torch, lambda: gat_hub_attention(
        conv, g, x, big, RING_SHARDS))
    _, dense_peak = peak_call(torch, lambda: gat_hub_attention(
        conv, g, x, big, 1))
    emit(phase="ring", card=card, part="hub_attention", hubs=RING_HUBS,
         buckets=[[len(b), int(deg[b].min()), int(deg[b].max())]
                  for b in buckets], heads=GAT_HEADS, width=HIDDEN,
         shards=RING_SHARDS, rel_err=errs, hub_s=hub_s,
         launches=hub_launches,
         peak_bytes_largest_bucket={"ring": ring_peak, "dense": dense_peak},
         largest_bucket=[len(big), int(deg[big].max())])
    emit(phase="ring", card=card, part="done",
         seconds=time.perf_counter() - t_phase)
    return total

# ------------------------------------------------------------------ gat
# DistGAT and DistGATv2 at the width examples/train_dist.py builds with
# --num_hidden 256: 100 -> 2 heads x 256 concatenated -> 47 (one head)
GAT_HEADS = 2
GAT_CPU_STEPS = 3      # card-against-CPU steps of each stack
# the card-against-CPU steps on each side's own LeakyReLU branches: a
# gradient within 1e-2 of its largest entry (the probe's float32
# against float64 gaps reach 8.5e-3 at 3 to 4 flipped inputs,
# leaky_branch_probe.py); on shared branches, at most 8 inputs of a
# stack's 3 steps whose own branch differs (0 and 1 seen on the H100)
GAT_FREE_GRAD_GAP = 1e-2
GAT_MAX_FLIPS = 8
GAT_KINDS = ("gat", "gatv2")


def gat_model(torch, kind: str, device, seed: int, dropout: float = 0.5):
    """A full-width ``DistGAT`` (``kind="gat"``) or ``DistGATv2``, its
    weights drawn from ``seed``."""
    from dgl_operator_tpu_torch.models import DistGAT, DistGATv2

    cls = DistGATv2 if kind == "gatv2" else DistGAT
    return cls(FEAT, HIDDEN, CLASSES, num_heads=GAT_HEADS, dropout=dropout,
               device=device, generator=torch.Generator().manual_seed(seed))


def gat_launches(kind: str, steps: int, slots: int = 1, warm: int = 0,
                 exchange: int = 0, device: bool = False) -> dict:
    """The kernel launches of ``steps`` steps of ``slots`` slots and
    ``warm`` forwards without a gradient: each slot's input rows and the
    neighbour gathers of both layers (GAT: ``el[nbr]`` and ``x[nbr]``;
    GATv2: ``fs[nbr]``), then the backward of every gather whose table
    needs a gradient (GAT: block 0's logits, block 1's logits and rows;
    GATv2: both blocks' projections); plus ``exchange`` gathers; with
    the device sampler, each slot's tree with its slot plans."""
    gathers = 3 if kind == "gatv2" else 5
    scatters = 2 if kind == "gatv2" else 3
    samples = steps * slots + warm
    return {"fanout_agg": 0,
            "gather_rows": samples * gathers + exchange,
            "scatter_add_rows": steps * slots * scatters,
            "tree_sample": tree_launches(samples, True) if device else 0}


class Branches:
    """Within ``with``: each LeakyReLU module of ``source`` records its
    branches (``x > 0``) and runs as usual; each of ``target`` takes the
    recorded branches in order (``x`` or ``slope * x``, the same
    arithmetic) and counts, in ``flips``, the inputs whose own branch
    differs, of ``elems``. Forward hooks on the models' ``nn.LeakyReLU``
    modules (the attention layers' ``act``), removed on exit."""

    def __init__(self, source, target):
        self.source, self.target = source, target
        self.masks, self.flips, self.elems = [], 0, 0
        self.hooks = []

    def record(self, act, args, out):
        self.masks.append((args[0] > 0).cpu())

    def replay(self, act, args, out):
        x = args[0]
        mask = self.masks.pop(0).to(x.device)
        self.flips += int((mask != (x > 0)).sum())
        self.elems += x.numel()
        return x.where(mask, x * act.negative_slope)

    def __enter__(self):
        import torch

        for model, hook in ((self.source, self.record),
                            (self.target, self.replay)):
            self.hooks += [m.register_forward_hook(hook)
                           for m in model.modules()
                           if isinstance(m, torch.nn.LeakyReLU)]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()
        self.hooks = []
        return False


def gat_cpu(torch, args, g, trainer, card: str) -> None:
    """Each stack at dropout 0 on the card and on the CPU: the logits of
    one batch of the training stream within 1e-4 of their largest
    entry, then ``GAT_CPU_STEPS`` steps synced as in ``train_cpu``,
    twice from the same state. First each side on its own branches:
    losses within 1e-5, gradients within ``GAT_FREE_GRAD_GAP`` of their
    largest entry (a LeakyReLU input that card and CPU round to either
    side of 0 scales its gradient term by the other slope:
    ``leaky_branch_probe.py``). Then the CPU on the card's branches
    (:class:`Branches`): the ``check_step_gaps`` limits, and at most
    ``GAT_MAX_FLIPS`` inputs whose own branch differs."""
    import copy

    import numpy as np

    from dgl_operator_tpu_torch.ops.gather import gather_rows
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                      dropout=0.0, seed=args.seed)
    ids = np.random.default_rng(args.seed + 6).permutation(
        trainer.train_ids)

    def step(tr, mb):
        return tr.train_step(mb)[0]

    for kind in GAT_KINDS:
        card_tr, cpu_tr = [SampledTrainer(
            gat_model(torch, kind, dev, args.seed + 6, 0.0), g, cfg,
            train_ids=trainer.train_ids, device=dev)
            for dev in ("cuda", "cpu")]
        mbs = [card_tr.sample(ids[b * BATCH_TRAIN:(b + 1) * BATCH_TRAIN], b)
               for b in range(GAT_CPU_STEPS)]
        logits = []
        for tr in (card_tr, cpu_tr):
            tr.model.eval()
            blocks, inputs, _ = tr.ship(mbs[0])
            with torch.no_grad():
                logits.append(tr.model(blocks, gather_rows(
                    tr.feats, inputs)).cpu())
            tr.model.train()
        err, scale = err_of(logits[0], logits[1])
        check(err <= 1e-4 * scale, f"gat {kind}: card logits {err} from "
              f"the CPU's > 1e-4 x {scale}")
        start = (copy.deepcopy(cpu_tr.model.state_dict()),
                 copy.deepcopy(cpu_tr.optimizer.state_dict()))
        fl, fc, free_gaps, _ = synced_step_gaps(torch, card_tr, cpu_tr, mbs,
                                                step)
        free_rel = [abs(a - b) / abs(b) for a, b in zip(fl, fc)]
        free_worst = [max(gap.values()) for gap in free_gaps]
        for i, (r, w) in enumerate(zip(free_rel, free_worst)):
            check(r <= 1e-5, f"gat {kind} step {i + 1}, own branches: loss "
                  f"card {fl[i]} vs CPU {fc[i]}: relative {r} > 1e-5")
            check(w <= GAT_FREE_GRAD_GAP, f"gat {kind} step {i + 1}, own "
                  f"branches: grad max abs err {w} x max > "
                  f"{GAT_FREE_GRAD_GAP}")
        cpu_tr.model.load_state_dict(start[0])
        cpu_tr.optimizer.load_state_dict(start[1])
        with Branches(card_tr.model, cpu_tr.model) as branches:
            gl, cl, gaps, (gs, cs) = synced_step_gaps(torch, card_tr,
                                                      cpu_tr, mbs, step)
        check(branches.elems > 0 and not branches.masks,
              "every recorded branch was replayed")
        check(branches.flips <= GAT_MAX_FLIPS,
              f"gat {kind}: {branches.flips} of {branches.elems} LeakyReLU "
              f"branches differ between card and CPU > {GAT_MAX_FLIPS}")
        rel, worst = check_step_gaps(f"gat {kind}", gl, cl, gaps)
        emit(phase="gat", part="cpu", kind=kind, card=card,
             caps=card_tr.caps, logits_max_abs_err=err, logits_scale=scale,
             steps=GAT_CPU_STEPS, synced=True,
             own_branches=dict(card_losses=fl, cpu_losses=fc,
                               loss_rel_err=free_rel,
                               grad_rel_err_max=free_worst,
                               grad_limit=GAT_FREE_GRAD_GAP),
             card_losses=gl, cpu_losses=cl, loss_rel_err=rel,
             grad_rel_err_max=worst, leaky_branches_differing=branches.flips,
             leaky_branches_limit=GAT_MAX_FLIPS,
             leaky_elements=branches.elems, card_s=gs, cpu_s=cs)


def gat_sampled(torch, args, wrappers, g, trainer, card: str):
    """``SampledTrainer`` with each stack over the train phase's 40,000
    ids (40 steps, dropout 0.5): the host sampler (evaluation at the
    epoch's end), the device sampler at K = 1 and at K = 4 (a CUDA graph
    a call), K = 4 bit-equal to K = 1, launches per step, peak device
    memory; then a ``profile`` line of each stack at K = 4. Returns the
    launches and the runs."""
    import numpy as np

    from dgl_operator_tpu_torch.models import flax_params
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    def make(kind, **fields):
        cfg = TrainConfig(**{**dict(
            batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR, num_epochs=1,
            eval_every=0, seed=args.seed), **fields})
        return SampledTrainer(gat_model(torch, kind, "cuda", args.seed),
                              g, cfg, train_ids=trainer.train_ids)

    runs, total = {}, {}
    for kind in GAT_KINDS:
        w0 = flax_params(gat_model(torch, kind, "cpu", args.seed + 7))
        for sampler, K in (("host", 1), ("device", 1), ("device", DEV_K)):
            tr = make(kind, sampler=sampler, steps_per_call=K,
                      eval_every=int(sampler == "host"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # the main path: every kernel count starts at 0 here
            reset_counts(wrappers)
            t0 = time.perf_counter()
            out = tr.train(init_params=w0)
            wall = time.perf_counter() - t0
            launches = read_counts(wrappers)
            peak = torch.cuda.max_memory_allocated()
            steps = out["step"]
            rec = out["history"][0]
            losses = rec["losses"]
            check(steps == len(trainer.train_ids) // BATCH_TRAIN
                  == len(losses), f"gat {kind} {sampler} K={K}: {steps}")
            # the warm-up forward before the first step adds its gathers
            # (and, with the device sampler, its tree)
            device = sampler == "device"
            want = gat_launches(kind, steps, warm=1, device=device)
            check(launches == want, f"gat {kind} {sampler} K={K}: "
                  f"{launches} launches in {steps} steps, expected {want}")
            check(bool(np.isfinite(losses).all()), "finite GAT losses")
            check(np.mean(losses[-5:]) < np.mean(losses[:5]),
                  f"gat {kind} {sampler} K={K}: loss decreases: {losses}")
            check(rec["graph"] is (K > 1),
                  f"gat {kind} K={K}: graph {rec['graph']}")
            if sampler == "host":
                check(0 <= rec["val_acc"] <= 1 and 0 <= rec["test_acc"] <= 1,
                      f"gat {kind}: accuracies {rec['val_acc']}, "
                      f"{rec['test_acc']}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            runs[kind, sampler, K] = (tr, out)
            emit(phase="gat", part="sampled", kind=kind, card=card,
                 sampler=sampler, steps_per_call=K, steps=steps,
                 caps=tr.caps, launches=launches,
                 launches_per_step={
                     k: (v - gat_launches(kind, 0, warm=1,
                                          device=device)[k]) / steps
                     for k, v in launches.items()},
                 loss_first5=float(np.mean(losses[:5])),
                 loss_last5=float(np.mean(losses[-5:])), losses=losses,
                 val_acc=rec.get("val_acc"), test_acc=rec.get("test_acc"),
                 eval_s=rec.get("eval_s"), train_call_s=wall,
                 peak_memory_bytes=peak, **device_run_record(rec, steps, K))
        one = runs[kind, "device", 1][1]
        four = runs[kind, "device", DEV_K][1]
        check(one["history"][0]["losses"] == four["history"][0]["losses"],
              f"gat {kind}: device K={DEV_K} losses differ from K=1")
        check(all(torch.equal(v, one["params"][k])
                  for k, v in four["params"].items()),
              f"gat {kind}: device K={DEV_K} parameters differ from K=1")
        emit(phase="gat", part="sampled_k_equal", kind=kind, card=card,
             steps_per_call=[1, DEV_K], dropout=0.5, losses_bit_equal=True,
             params_bit_equal=True)
    ids = np.random.default_rng(args.seed).permutation(trainer.train_ids)
    spe = len(ids) // BATCH_TRAIN
    for kind in GAT_KINDS:
        tr = runs[kind, "device", DEV_K][0]
        tr._start_device_run(spe).stage([ids])
        gnn_profile(torch, wrappers, f"{kind}_device_k{DEV_K}", DEV_K,
                    bank_calls(tr, DEV_K, spe), card, phase="gat",
                    kernels=("gather_rows", "scatter_add_rows",
                             "tree_sample"))
        tr._run = None
    return total, runs


def gat_kernel_records(torch, args, ops, tr, card: str):
    """``gather_rows`` and ``scatter_add_rows`` against their plain
    versions at the attention's shapes on one device-sampled tree batch
    of ``tr`` (a GAT ``SampledTrainer``): the neighbour gathers of each
    block at the widths the stacks give them (block 0, 260,000 ids:
    GAT's ``x[nbr]`` of 400-byte rows and ``el[nbr]`` of 8-byte rows,
    two heads; GATv2's ``fs[nbr]`` of 2 KB rows. Block 1, 25,000 ids,
    one head: GAT's ``x[nbr]`` of 2 KB rows and ``el[nbr]`` of 4-byte
    rows; GATv2's ``fs[nbr]`` of 188-byte rows) and the backward of
    each whose table needs a gradient, over the blocks' per-slot
    plans."""
    import numpy as np

    from dgl_operator_tpu_torch.ops.device_sample import draw_key

    _, gather, scatter = ops
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 11)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    seeds = torch.from_numpy(tr.train_ids[:BATCH_TRAIN].astype(
        np.int32)).to(tr._indptr.dtype).to("cuda")
    (b0, b1), inputs = tr._tree.sample(tr._indptr, tr._indices, seeds,
                                       draw_key(args.seed, 11))
    check(b0.plan is not None and b0.plan.cnt.numel() == b0.nbr.numel(),
          "the GAT tree blocks carry per-slot plans from block 0")
    x0 = gather.gather_rows(tr.feats, inputs)
    wide = GAT_HEADS * HIDDEN
    i0, i1 = b0.nbr.view(-1), b1.nbr.view(-1)
    records = gather_records(torch, gather, [
        ("gat_x_block0", x0, i0),
        ("gat_el_block0", randn(b0.num_src, GAT_HEADS), i0),
        ("gatv2_fs_block0", randn(b0.num_src, wide), i0),
        ("gat_x_block1", randn(b1.num_src, wide), i1),
        ("gat_el_block1", randn(b1.num_src, 1), i1),
        ("gatv2_fs_block1", randn(b1.num_src, CLASSES), i1),
    ], flush, args.iters, card)
    m0, m1 = i0.numel(), i1.numel()
    s0 = (b0.nbr.view(-1, 1), b0.mask.view(-1, 1), b0.num_src, False,
          b0.plan)
    s1 = (b1.nbr.view(-1, 1), b1.mask.view(-1, 1), b1.num_src, False,
          b1.plan)
    records += scatter_records(torch, scatter, [
        ("gat_el_block0_bwd", randn(m0, GAT_HEADS), *s0),
        ("gatv2_fs_block0_bwd", randn(m0, wide), *s0),
        ("gat_x_block1_bwd", randn(m1, wide), *s1),
        ("gat_el_block1_bwd", randn(m1, 1), *s1),
        ("gatv2_fs_block1_bwd", randn(m1, CLASSES), *s1),
    ], flush, args.iters, card)
    return records


def gat_dist(torch, args, wrappers, g, ctx, work: str, card: str) -> dict:
    """``DistGAT`` in ``DistTrainer`` over the dist phase's book (20
    steps of 2 slots, the host sampler, the weights drawn from
    ``--seed`` as the entry point draws them): the replicated and owner
    layouts with equal losses and their launches; ``evaluate`` (the
    slots' local edge softmax) against the CPU's single-graph
    ``gat_inference`` of the same weights, and that inference on the
    card (logits within 1e-4 of their largest entry, its peak memory
    beside the ``[E, H * D]`` message table it does not build); and a
    bit-exact resume. Returns the launches of the two epochs."""
    import numpy as np

    from dgl_operator_tpu_torch.models import flax_params, gat_inference
    from dgl_operator_tpu_torch.runtime.dist import DistTrainer
    from dgl_operator_tpu_torch.runtime.loop import TrainConfig

    book = ctx["book"]
    w0 = flax_params(gat_model(torch, "gat", "cpu", args.seed))

    def make(layout="replicated", kind="gat", **fields):
        cfg = TrainConfig(**{**dict(
            num_epochs=1, batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
            eval_every=1, seed=args.seed, feats_layout=layout,
            halo_cache_frac=0.25), **fields})
        return DistTrainer(gat_model(torch, kind, "cuda", args.seed), book,
                           cfg)

    total, runs = {}, {}
    for layout in LAYOUTS:
        tr = make(layout)
        reset_counts(wrappers)
        t0 = time.perf_counter()
        out = tr.train(init_params=w0)
        wall = time.perf_counter() - t0
        launches = read_counts(wrappers)
        P, steps = tr.num_parts, out["step"]
        losses = out["history"][0]["losses"]
        params = {k: v.clone() for k, v in out["params"].items()}
        check(steps == tr.steps_per_epoch == len(losses),
              f"gat dist {layout}: {steps} steps")
        want = gat_launches("gat", steps, P,
                            exchange=steps if layout == "owner" else 0)
        check(launches == want, f"gat dist {layout}: {launches} launches "
              f"in {steps} steps, expected {want}")
        check(bool(np.isfinite(losses).all()), "finite GAT dist losses")
        check(np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"gat dist {layout}: loss decreases: {losses}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        runs[layout] = (out, params)
        rng = np.random.default_rng(args.seed)
        perm = [rng.permutation(t) for t in tr.train_ids]
        probe = [tr._sample_all(perm, b, 10_000 + b)[0] for b in range(4)]
        emit(phase="gat", part="dist", kind="gat", card=card,
             **dist_run_record(torch, tr, out, launches, probe, wall))
    (rep, rep_params), (own, own_params) = runs["replicated"], runs["owner"]
    rl, ol = rep["history"][0]["losses"], own["history"][0]["losses"]
    rel = float(np.max(np.abs(np.subtract(ol, rl)) / np.abs(rl)))
    check(rel <= 1e-6, f"gat dist owner losses {ol} vs replicated {rl}: "
          f"relative {rel} > 1e-6")
    emit(phase="gat", part="dist_layouts", card=card,
         loss_rel_owner_to_replicated=rel, losses_bit_equal=ol == rl,
         params_bit_equal=all(torch.equal(v, rep_params[k])
                              for k, v in own_params.items()))

    # evaluate against the single-graph inference of the same weights
    cpu_model = gat_model(torch, "gat", "cpu", 0)
    cpu_model.load_state_dict({k: v.cpu() for k, v in rep_params.items()})
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_logits = gat_inference(cpu_model, g, torch.from_numpy(
            g.ndata["feat"]))
    single_s = time.perf_counter() - t0
    pred = cpu_logits.argmax(-1).numpy()
    rec = rep["history"][0]
    eval_cmp = {}
    for key, name in (("val_acc", "val_mask"), ("test_acc", "test_mask")):
        m = np.asarray(g.ndata[name], bool)
        n = int(m.sum())
        single = float((pred[m] == g.ndata["label"][m]).mean())
        nodes = abs(rec[key] - single) * n
        slack = max(2, n // 10_000)
        check(nodes <= slack + 1e-6, f"gat evaluate {key} {rec[key]} on the "
              f"card vs {single} single-graph on the CPU: {nodes} nodes "
              f"apart > {slack}")
        eval_cmp[key] = dict(card=rec[key], cpu_single_graph=single,
                             nodes_apart=round(nodes), slack_nodes=slack)
    card_model = gat_model(torch, "gat", "cuda", 0)
    card_model.load_state_dict(rep_params)
    feats = torch.from_numpy(g.ndata["feat"]).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with torch.no_grad():
        card_logits = gat_inference(card_model, g, feats)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    err, scale = err_of(card_logits.cpu(), cpu_logits)
    check(err <= 1e-4 * scale, f"gat_inference on the card {err} from the "
          f"CPU's > 1e-4 x {scale}")
    edges = g.num_edges
    emit(phase="gat", part="eval", card=card, eval_vs_single_graph=eval_cmp,
         single_graph_cpu_s=single_s, inference_card_s=card_s,
         inference_logits_max_abs_err=err, inference_logits_scale=scale,
         inference_peak_bytes_above_inputs=peak,
         message_table_bytes_not_built=edges * GAT_HEADS * HIDDEN * 4,
         edges=edges)
    check(peak < edges * GAT_HEADS * HIDDEN * 4,
          f"gat_inference peak {peak} B reaches an [E, H*D] table")
    del card_model, feats, card_logits
    resume_check(torch, "DistTrainer GAT",
                 lambda **fields: make(eval_every=0, **fields), w0,
                 (rep_params, rl), len(rl) // 2,
                 os.path.join(work, "ckpt_gat_dist"), card)
    for k, v in gat_dist_device(torch, args, wrappers, make, card).items():
        total[k] += v
    return total


def gat_dist_device(torch, args, wrappers, make, card: str) -> dict:
    """``DistGATv2`` in ``DistTrainer`` with the device sampler over the
    same book (20 steps of 2 slots): replicated at K = 1 and K = 4 (a
    CUDA graph a call) and owner at K = 4, all three bit-equal, with
    their launches (a slot's neighbour gathers and their backward, and
    the input rows: a gather a slot replicated, one over every slot's
    requests in the owner layout). Returns the launches."""
    import numpy as np

    from dgl_operator_tpu_torch.models import flax_params

    w0 = flax_params(gat_model(torch, "gatv2", "cpu", args.seed))
    total, want = {}, None
    for layout, K in (("replicated", 1), ("replicated", DEV_K),
                      ("owner", DEV_K)):
        tr = make(layout, "gatv2", sampler="device", steps_per_call=K,
                  eval_every=0)
        P = tr.num_parts
        # the main path: every kernel count starts at 0 here
        reset_counts(wrappers)
        t0 = time.perf_counter()
        out = tr.train(init_params=w0)
        wall = time.perf_counter() - t0
        launches = read_counts(wrappers)
        steps = out["step"]
        rec = out["history"][0]
        losses = rec["losses"]
        expect = gat_launches("gatv2", steps, P, device=True)
        if layout == "owner":
            expect["gather_rows"] -= (P - 1) * steps
        check(launches == expect, f"gat dist gatv2 device {layout} K={K}: "
              f"{launches} in {steps} steps, expected {expect}")
        check(rec["graph"] is (K > 1), f"gat dist gatv2 device K={K}: "
              f"graph {rec['graph']}")
        check(bool(np.isfinite(losses).all()), "finite GATv2 dist losses")
        check(np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"gat dist gatv2 device {layout} K={K}: loss decreases: "
              f"{losses}")
        if want is None:
            want = ({k: v.clone() for k, v in out["params"].items()}, losses)
        check(losses == want[1] and all(
            torch.equal(v, want[0][k]) for k, v in out["params"].items()),
            f"gat dist gatv2 device {layout} K={K}: losses {losses} or "
            f"parameters differ from replicated K=1's {want[1]}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        emit(phase="gat", part="dist_device", kind="gatv2", card=card,
             layout=layout, steps_per_call=K, parts=P, steps=steps,
             caps=tr.caps, launches=launches,
             launches_per_step={k: v / steps for k, v in launches.items()},
             bit_equal_to_replicated_k1=True, losses=losses,
             halo_rows_per_step=rec.get("halo_rows_per_step"),
             train_call_s=wall, **device_run_record(rec, steps, K))
    return total


def gat_serve(torch, args, wrappers, g, ctx, work: str, card: str
              ) -> dict:
    """A ``ServeEngine`` serving a full-width ``DistGAT`` from a flax
    serving export over the dist phase's book: 8 requests of 1 to 64
    seeds through the ``MicroBatcher`` on the card (4 gathers a
    forward: ``el[nbr]`` and ``x[nbr]`` of both blocks), then one fixed
    request on the card and on the CPU engine, logits within 1e-4 of
    the largest. Returns the launches."""
    import numpy as np

    from dgl_operator_tpu_torch.models import flax_params
    from dgl_operator_tpu_torch.runtime.checkpoint import export_for_serving
    from dgl_operator_tpu_torch.serve.engine import ServeConfig, ServeEngine

    export = export_for_serving(
        os.path.join(work, "gat_export") + os.sep,
        flax_params(gat_model(torch, "gat", "cpu", args.seed + 8)))
    cfg = ServeConfig(fanouts=FANOUTS, batch_size=BATCH,
                      halo_cache_frac=0.25, cap_policy="worst")
    eng = ServeEngine(gat_model(torch, "gat", "cuda", 0), ctx["book"],
                      params_path=export, cfg=cfg, device="cuda")
    check(eng.ready, "GAT engine warm")
    n = g.num_nodes
    rng = np.random.default_rng(args.seed + 8)
    requests = [rng.choice(n, size=int(rng.integers(1, 65)), replace=False)
                for _ in range(8)]
    lat_ms = []
    # the main path: every kernel count starts at 0 here
    reset_counts(wrappers)
    forwards0 = eng.forward_calls
    batcher = eng.make_batcher()
    try:
        for ids in requests:
            t = time.perf_counter()
            pred = batcher.submit(ids).result(timeout=120)
            lat_ms.append((time.perf_counter() - t) * 1e3)
            check(pred.shape == ids.shape and pred.min() >= 0
                  and pred.max() < CLASSES,
                  "GAT predictions are classes in [0, 47)")
    finally:
        batcher.stop()
    launches = read_counts(wrappers)
    forwards = eng.forward_calls - forwards0
    check(forwards >= len(requests) > 0, "a GAT forward per request")
    want = {"fanout_agg": 0, "gather_rows": 4 * forwards,
            "scatter_add_rows": 0, "tree_sample": 0}
    check(launches == want, f"GAT serve: {launches} launches in "
          f"{forwards} forwards, expected {want}")
    check(eng.nonfinite_logits == 0, "finite GAT serve logits")
    fixed = np.sort(rng.choice(n, size=BATCH, replace=False))
    lg_card = eng.predict_logits(fixed, sample_seed=7)
    eng_cpu = ServeEngine(gat_model(torch, "gat", "cpu", 0), ctx["book"],
                          params_path=export, cfg=cfg, device="cpu",
                          warm=False)
    lg_cpu = eng_cpu.predict_logits(fixed, sample_seed=7)
    check(bool(np.isfinite(lg_card).all()) and lg_card.shape ==
          (BATCH, CLASSES), "GAT fixed request: finite [64, 47] logits")
    err = float(np.abs(lg_card - lg_cpu).max())
    scale = float(np.abs(lg_cpu).max())
    check(err <= 1e-4 * scale, f"GAT serve card vs CPU logits: max abs "
          f"err {err} > 1e-4 x {scale}")
    lat = np.asarray(lat_ms)
    emit(phase="gat", part="serve", kind="gat", card=card,
         requests=len(requests), forwards=forwards, launches=launches,
         caps=eng.caps, p50_ms=float(np.percentile(lat, 50)),
         p99_ms=float(np.percentile(lat, 99)), cpu_max_abs_err=err,
         cpu_logits_scale=scale)
    return launches


# launches of one full-graph training epoch and of one forward, per
# model, as (gather_rows, scatter_add_rows): each edge gather that needs
# a gradient adds a scatter to the backward, each segment sum a gather;
# a layer whose input needs no gradient has no backward
FULL_GRAPH_LAUNCHES = {
    "gcn": ((4, 4), (2, 2)),       # 2 x (gather + sum), both projected
    "gat": ((14, 12), (10, 4)),    # 2 x (el, er, smax, denom, feat; 2 sums)
    "sage": ((3, 3), (2, 2)),      # layer 0's input is the features
    "weighted": ((3, 3), (2, 2)),
    "link": ((7, 7), (6, 2)),      # + the pos and neg graphs' 2 gathers
}


def full_graph_want(model: str, epochs: int, forwards: int) -> dict:
    """The launches ``epochs`` training epochs and ``forwards``
    evaluation forwards of ``model`` make (:data:`FULL_GRAPH_LAUNCHES`)."""
    (tg, ts), (fg, fs) = FULL_GRAPH_LAUNCHES[model]
    return {"fanout_agg": 0, "gather_rows": epochs * tg + forwards * fg,
            "scatter_add_rows": epochs * ts + forwards * fs,
            "tree_sample": 0}


def run_example(torch, wrappers, module, argv, **kw):
    """``module.main(argv, **kw)`` with its stdout captured: its result,
    its seconds and, on the card, its launches (every count set to 0
    just before)."""
    import contextlib
    import io

    reset_counts(wrappers)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = module.main(argv, **kw)
    if "cpu" not in argv:
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_counts(wrappers)


def flax_leaves(tree, path: str = "") -> dict:
    """The arrays of a flax params tree by their ``/``-joined path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flax_leaves(v, f"{path}{k}/"))
        else:
            out[f"{path}{k}"] = v
    return out


def same_params(a: dict, b: dict) -> bool:
    import numpy as np

    la, lb = flax_leaves(a), flax_leaves(b)
    return la.keys() == lb.keys() and all(
        np.array_equal(la[k], lb[k]) for k in la)


def gat_full_graph(torch, args, wrappers, card: str) -> dict:
    """``examples/node_classification.py`` (``train_full_graph``) with
    GCN and with GAT (4 heads of 16) on the synthetic Cora, 20 epochs,
    twice on the card and twice on the CPU from the same seeded weights:
    each pair equal in every loss and every final parameter bit for bit
    (the gathers and segment sums run over the graph's transpose plans);
    the card's launches per epoch as :data:`FULL_GRAPH_LAUNCHES` says;
    the first 3 epochs' losses within 1e-4 relative of the CPU's, finite
    losses that fall, the seconds of each call (the dataset's synthesis
    included). The later epochs' card-to-CPU gap is reported beside the
    gap of a float64 run of the same weights on the CPU from the CPU's
    float32 run and from the card's: GAT's losses at Adam's lr 1e-2
    oscillate, and float32 rounding grows with every epoch. Returns the
    card runs' launches."""
    import numpy as np

    from dgl_operator_tpu_torch.examples import node_classification
    from dgl_operator_tpu_torch.graph import datasets
    from dgl_operator_tpu_torch.models import GAT, GCN
    from dgl_operator_tpu_torch.runtime.loop import (TrainConfig,
                                                     train_full_graph)

    epochs, held = 20, 3
    total = {}
    cora = datasets.cora().graph
    for model in ("gcn", "gat"):
        runs, secs = {}, {}
        for side, dev in (("card", "cuda"), ("card2", "cuda"),
                          ("cpu", "cpu"), ("cpu2", "cpu")):
            argv = ["--model", model, "--num_epochs", str(epochs),
                    "--device", dev, "--seed", str(args.seed)]
            runs[side], secs[side], launches = run_example(
                torch, wrappers, node_classification, argv)
            if dev == "cuda":
                evals = 1 + sum("val_acc" in h
                                for h in runs[side]["history"])
                want = full_graph_want(model, epochs, evals)
                check(launches == want, f"full graph {model}: {launches} "
                      f"launches in {epochs} epochs, expected {want}")
                card_launches = launches
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
        losses = {side: [h["loss"] for h in run["history"]]
                  for side, run in runs.items()}
        for a, b in (("card", "card2"), ("cpu", "cpu2")):
            check(losses[a] == losses[b] and same_params(
                runs[a]["params"], runs[b]["params"]),
                f"full graph {model}: two {a} runs part: {losses[a]} vs "
                f"{losses[b]}")
        # the same weights in float64 on the CPU
        gen = torch.Generator().manual_seed(args.seed)
        net = (GAT(1433, 16, 7, num_heads=4, device="cpu", generator=gen)
               if model == "gat" else
               GCN(1433, 16, 7, device="cpu", generator=gen))
        f64 = train_full_graph(net.double(), cora, TrainConfig(
            num_epochs=epochs, lr=0.01, eval_every=0), device="cpu")
        l64 = [h["loss"] for h in f64["history"]]
        card_l, cpu_l = losses["card"], losses["cpu"]

        def rel(a, b):
            return (np.abs(np.subtract(a, b)) / np.abs(b)).tolist()

        gap = rel(card_l, cpu_l)
        check(len(gap) == epochs and max(gap[:held]) <= 1e-4,
              f"full graph {model}: card losses {card_l[:held]} vs CPU "
              f"{cpu_l[:held]}: relative {gap[:held]} > 1e-4")
        check(bool(np.isfinite(card_l).all()) and card_l[-1] < card_l[0],
              f"full graph {model}: loss decreases: {card_l}")
        emit(phase="gat", part="full_graph", model=model, card=card,
             dataset="cora", epochs=epochs, epochs_held=held,
             card_runs_bit_equal=True, cpu_runs_bit_equal=True,
             launches_per_card_run=card_launches,
             card_losses=card_l, cpu_losses=cpu_l, cpu_f64_losses=l64,
             loss_rel_err=gap, card_to_cpu_f64=rel(card_l, l64),
             cpu_to_cpu_f64=rel(cpu_l, l64),
             test_acc=runs["card"]["test_acc"],
             cpu_test_acc=runs["cpu"]["test_acc"],
             card_call_s=secs["card"], card_call2_s=secs["card2"],
             cpu_call_s=secs["cpu"])
    return total


def gat_phase(torch, args, ops, wrappers, g, trainer, ctx, work: str,
              card: str):
    """The GAT slice at full width: card against CPU, ``SampledTrainer``
    with both samplers and K = 4, the kernels at the attention's shapes
    and ``DistTrainer`` in both layouts with evaluation and resume.
    Returns the main-path launches, the full-graph runs' launches
    and the kernel records."""
    t0 = time.perf_counter()
    gat_cpu(torch, args, g, trainer, card)
    sampled, runs = gat_sampled(torch, args, wrappers, g, trainer, card)
    records = gat_kernel_records(torch, args, ops,
                                 runs["gat", "device", 1][0], card)
    del runs
    torch.cuda.empty_cache()
    dist = gat_dist(torch, args, wrappers, g, ctx, work, card)
    served = gat_serve(torch, args, wrappers, g, ctx, work, card)
    full = gat_full_graph(torch, args, wrappers, card)
    emit(phase="gat", part="done", card=card,
         seconds=time.perf_counter() - t0)
    return ({k: sampled[k] + dist[k] + served[k] for k in sampled}, full,
            records)


MP_EPOCHS = 20          # message_passing.py epochs, card against CPU
MP_HELD = 3             # epochs held within 1e-4 relative of the CPU's


def full_graph_pair(torch, wrappers, module, argv, model: str, what: str,
                    forwards, **kw):
    """An example twice on the card (bit-equal losses and parameters,
    launches as :func:`full_graph_want` says for ``forwards(result)``
    evaluation forwards) and once on the CPU; the first ``MP_HELD``
    losses within 1e-4 relative. Returns the card's and the CPU's
    results, the card runs' launches and the card's seconds."""
    import numpy as np

    card, secs, total = [], [], {}
    for _ in range(2):
        out, sec, launches = run_example(torch, wrappers, module,
                                         argv + ["--device", "cuda"], **kw)
        hist = out["history"]
        epochs = len(hist)
        want = full_graph_want(model, epochs, forwards(out))
        check(launches == want, f"{what}: {launches} launches in {epochs} "
              f"epochs, expected {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        card.append(out)
        secs.append(sec)
    cpu, cpu_s, _ = run_example(torch, wrappers, module,
                                argv + ["--device", "cpu"], **kw)

    def losses(out):
        return [h if isinstance(h, float) else h["loss"]
                for h in out["history"]]

    check(losses(card[0]) == losses(card[1]) and same_params(
        card[0]["params"], card[1]["params"]),
        f"{what}: two card runs part")
    card_l, cpu_l = losses(card[0]), losses(cpu)
    gap = (np.abs(np.subtract(card_l, cpu_l)) / np.abs(cpu_l)).tolist()
    check(max(gap[:MP_HELD]) <= 1e-4, f"{what}: card losses "
          f"{card_l[:MP_HELD]} vs CPU {cpu_l[:MP_HELD]}: relative "
          f"{gap[:MP_HELD]} > 1e-4")
    check(bool(np.isfinite(card_l).all()) and card_l[-1] < card_l[0],
          f"{what}: loss decreases: {card_l}")
    return card[0], cpu, dict(launches_per_card_run=launches,
                              card_losses=card_l, cpu_losses=cpu_l,
                              loss_rel_err=gap, card_call_s=secs,
                              cpu_call_s=cpu_s)


def csr_chunk_floor(g, d: int) -> int:
    """The fewest destination chunks ``gspmm``'s host max can cut
    ``g``'s merged adjacency into at row width ``d``."""
    from dgl_operator_tpu_torch.ops import spmm

    nnz = int(g.adjacency("cpu").values().numel())
    return -(-nnz * d // spmm.CHUNK_ELEMS)


def pool_inference(torch, args, wrappers, g, ctx, card: str) -> dict:
    """``sage_inference`` with the pool aggregator at full width (100 ->
    256 -> 47, seeded weights) over phase 3's graph on the card against
    the CPU (logits within 1e-4 of their largest entry), its launches
    (one ``gather_rows`` per destination chunk) and peak memory beside
    the ``[E, D]`` tables it does not build; then ``DistTrainer.evaluate``
    of the same weights over the dist phase's book against that CPU
    inference (within max(2, n / 10,000) nodes). Returns the launches."""
    import numpy as np

    from dgl_operator_tpu_torch.models.sage import DistSAGE, sage_inference
    from dgl_operator_tpu_torch.runtime.dist import DistTrainer
    from dgl_operator_tpu_torch.runtime.loop import TrainConfig

    def model(device):
        return DistSAGE(FEAT, HIDDEN, CLASSES, aggregator="pool",
                        device=device,
                        generator=torch.Generator().manual_seed(args.seed))

    x = torch.from_numpy(g.ndata["feat"])
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_logits = sage_inference(model("cpu"), g, x)
    cpu_s = time.perf_counter() - t0
    card_model, feats = model("cuda"), x.to("cuda")
    g.adjacency("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    with torch.no_grad():
        card_logits = sage_inference(card_model, g, feats)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = read_counts(wrappers)
    peak = torch.cuda.max_memory_allocated() - base
    floor = csr_chunk_floor(g, FEAT) + csr_chunk_floor(g, HIDDEN)
    check(launches["scatter_add_rows"] == launches["fanout_agg"] == 0
          and floor <= launches["gather_rows"] <= 2 * g.num_nodes,
          f"pool inference: {launches} launches, at least {floor} gathers "
          "(one a destination chunk)")
    err, scale = err_of(card_logits.cpu(), cpu_logits)
    check(err <= 1e-4 * scale, f"pool sage_inference on the card {err} "
          f"from the CPU's > 1e-4 x {scale}")
    table = g.num_edges * HIDDEN * 4
    check(peak < table, f"pool inference peak {peak} B reaches an [E, D] "
          "table")
    emit(phase="message_passing", part="pool_inference", card=card,
         nodes=g.num_nodes, edges=g.num_edges, launches=launches,
         gather_chunks_floor=floor, card_s=card_s, cpu_s=cpu_s,
         logits_max_abs_err=err, logits_scale=scale,
         peak_bytes_above_inputs=peak, message_table_bytes_not_built=table)
    del card_model, feats, card_logits

    cfg = TrainConfig(num_epochs=1, batch_size=BATCH_TRAIN, fanouts=FANOUTS,
                      lr=LR, eval_every=1, seed=args.seed)
    tr = DistTrainer(model("cuda"), ctx["book"], cfg)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    got = tr.evaluate()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = read_counts(wrappers)
    check(eval_launches["gather_rows"] >= tr.num_parts * 2,
          f"pool evaluate: {eval_launches} launches")
    pred = cpu_logits.argmax(-1).numpy()
    cmp = {}
    for key, name in (("val_mask", "val_mask"), ("test_mask", "test_mask")):
        m = np.asarray(g.ndata[name], bool)
        n = int(m.sum())
        single = float((pred[m] == g.ndata["label"][m]).mean())
        nodes = abs(got[key] - single) * n
        slack = max(2, n // 10_000)
        check(nodes <= slack + 1e-6, f"pool evaluate {key} {got[key]} on "
              f"the card vs {single} single-graph on the CPU: {nodes} nodes "
              f"apart > {slack}")
        cmp[key] = dict(card=got[key], cpu_single_graph=single,
                        nodes_apart=round(nodes), slack_nodes=slack)
    emit(phase="message_passing", part="pool_evaluate", card=card,
         parts=tr.num_parts, launches=eval_launches, eval_s=eval_s,
         eval_vs_single_graph=cmp)
    del tr
    torch.cuda.empty_cache()
    return {k: launches[k] + eval_launches[k] for k in launches}


def full_graph_kernel_records(torch, args, ops, card: str):
    """``gather_rows`` and ``scatter_add_rows`` against their plain
    versions at the full-graph Cora shapes (``node_classification.py``'s
    GCN): the 16-wide edge gather ``h[src]`` and the segment sum into
    ``N + 1`` segments over the graph's ``dst_plan``."""
    from dgl_operator_tpu_torch.graph import datasets

    _, gather, scatter = ops
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 13)
    dg = datasets.cora().graph.to_device("cuda")
    n, e = dg.num_nodes, dg.num_edges
    table = torch.randn(n, 16, device="cuda", generator=gen)
    rows = torch.randn(e, 16, device="cuda", generator=gen)
    records = gather_records(torch, gather, [("cora_gather16", table,
                                              dg.src)], flush, args.iters,
                             card)
    records += scatter_records(torch, scatter, [
        ("cora_segment_sum", rows, dg.dst.view(-1, 1), None, n + 1, False,
         dg.dst_plan)], flush, args.iters, card)
    return records


def message_passing_phase(torch, args, ops, wrappers, g, ctx, card: str):
    """The message-passing vocabulary and link prediction (full graph,
    over a ``DeviceGraph``'s plans), the standalone sampled entry point,
    and pool inference: ``examples/message_passing.py`` plain and
    ``--weighted`` and ``examples/link_predict.py`` with the dot and the
    MLP predictor (:func:`full_graph_pair`; the AUC on both sides),
    ``examples/graphsage.py`` for one epoch at ``--scale`` on the card
    (launches per step as the train phase's; not run on the CPU:
    dropout draws differ by device, and phase 8 holds the trainer to
    the CPU), :func:`pool_inference` and the kernels at the full-graph
    Cora shapes. Returns the launches and the kernel records."""
    import numpy as np

    from dgl_operator_tpu_torch.examples import (graphsage, link_predict,
                                                 message_passing)

    t0 = time.perf_counter()
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def nc_forwards(out):
        return 1 + sum("val_acc" in h for h in out["history"])

    for weighted in (False, True):
        argv = ["--num_epochs", str(MP_EPOCHS), "--seed", str(args.seed)]
        argv += ["--weighted"] if weighted else []
        name = "weighted" if weighted else "sage"
        card_out, cpu_out, rec = full_graph_pair(
            torch, wrappers, message_passing, argv, name,
            f"message_passing {name}", nc_forwards)
        add(rec["launches_per_card_run"])
        add(rec["launches_per_card_run"])
        emit(phase="message_passing", part="message_passing", model=name,
             card=card, dataset="cora", epochs=MP_EPOCHS,
             epochs_held=MP_HELD, test_acc=card_out["test_acc"],
             cpu_test_acc=cpu_out["test_acc"], **rec)
    for predictor in ("dot", "mlp"):
        card_out, cpu_out, rec = full_graph_pair(
            torch, wrappers, link_predict,
            ["--predictor", predictor, "--seed", str(args.seed)], "link",
            f"link_predict {predictor}", lambda out: 1)
        add(rec["launches_per_card_run"])
        add(rec["launches_per_card_run"])
        check(abs(card_out["auc"] - cpu_out["auc"]) <= 0.01
              and card_out["auc"] >= 0.8,
              f"link_predict {predictor}: AUC {card_out['auc']} on the "
              f"card, {cpu_out['auc']} on the CPU")
        emit(phase="message_passing", part="link_predict",
             predictor=predictor, card=card, epochs=len(rec["card_losses"]),
             epochs_held=MP_HELD, auc=card_out["auc"],
             cpu_auc=cpu_out["auc"], **rec)

    out, sec, launches = run_example(torch, wrappers, graphsage, [
        "--num_epochs", "1", "--dataset_scale", str(args.scale),
        "--seed", str(args.seed)])
    steps = out["step"]
    rec = out["history"][0]
    losses = np.asarray(rec["losses"])
    check(launches == {"fanout_agg": 2 * steps + 2,
                       "gather_rows": steps + 1,
                       "scatter_add_rows": steps, "tree_sample": 0},
          f"graphsage.py: per step 1 gather_rows, 2 fanout_agg, 1 "
          f"scatter_add_rows: {launches} launches in {steps} steps")
    check(steps == len(losses) > 10 and bool(np.isfinite(losses).all())
          and losses[-5:].mean() < losses[:5].mean(),
          f"graphsage.py: {steps} steps, losses {losses.tolist()}")
    add(launches)
    step_ms = np.asarray(rec["step_s"]) * 1e3
    emit(phase="message_passing", part="graphsage", card=card,
         scale=args.scale, steps=steps, launches=launches,
         loss_first5=float(losses[:5].mean()),
         loss_last5=float(losses[-5:].mean()),
         step_ms_mean=float(step_ms.mean()),
         stall_ms_per_step=rec.get("stall", 0.0) * 1e3 / steps,
         val_acc=rec.get("val_acc"), test_acc=rec.get("test_acc"),
         eval_s=rec.get("eval_s"), call_s=sec)

    add(pool_inference(torch, args, wrappers, g, ctx, card))
    records = full_graph_kernel_records(torch, args, ops, card)
    emit(phase="message_passing", part="done", card=card, launches=total,
         seconds=time.perf_counter() - t0)
    return total, records


# launches of the RGCN example (gather_rows, scatter_add_rows): a
# training epoch (per layer: HB[src], coef[etype] and the segment
# mean's sum forward; the segment's gather and two scatters backward;
# DistMult: 6 gathers forward, 6 scatters backward) and the evaluation
# forward
RGCN_EPOCH_LAUNCHES = (12, 12)
RGCN_EVAL_LAUNCHES = (10, 2)
# GIN: a training step (per layer h[src] and its segment sum, the
# readout's sum; backward the readout's and layer 1's gathers and layer
# 1's source scatter: layer 0's input needs no gradient) and a test batch
GIN_STEP_LAUNCHES = (4, 4)
GIN_TEST_LAUNCHES = (2, 3)
RGCN_CPU_EPOCHS = 2     # epochs of the card-against-CPU comparison
RGCN_237_EPOCHS = 10    # epochs at FB15k-237's size
POOL_STEPS = 20         # pool SampledTrainer steps: 5 calls at K = 4
POOL_CPU_STEPS = 3      # pool steps of each card-against-CPU check
# the [E, I, O] per-edge weight table the JAX layer builds on FB15k at
# hidden 32 (483,142 train triples)
JAX_RGCN_TABLE_BYTES = 483_142 * 32 * 32 * 4


def counts_of(gathers: int, scatters: int, trees: int = 0) -> dict:
    return {"fanout_agg": 0, "gather_rows": gathers,
            "scatter_add_rows": scatters, "tree_sample": trees}


def rgcn_launches(epochs: int) -> dict:
    (eg, es), (vg, vs) = RGCN_EPOCH_LAUNCHES, RGCN_EVAL_LAUNCHES
    return counts_of(epochs * eg + vg, epochs * es + vs)


def rel_gaps(a, b) -> list:
    import numpy as np

    return (np.abs(np.subtract(a, b)) / np.abs(b)).tolist()


class RgcnSide:
    """One side of the RGCN card-against-CPU check, as
    ``examples/link_predict_rgcn.py`` trains: the train triples' message
    graph and edge types, the positive triples with their plans, an
    ``RGCNLinkPredict`` holding the flax tree ``w0`` (its widths read
    from the tree) in ``dtype`` (float32 when None) and Adam at the
    example's lr, on ``device``; the scores of each step go to
    ``scores``."""

    def __init__(self, torch, ds, w0, device, dtype=None):
        import numpy as np

        from dgl_operator_tpu_torch.graph.graph import Graph
        from dgl_operator_tpu_torch.models import state_dict_from_flax
        from dgl_operator_tpu_torch.models.rgcn import (RGCNLinkPredict,
                                                        Triples)

        h, r, t = (np.asarray(a) for a in ds.train)
        ne, nr = ds.n_entities, ds.n_relations
        tree = w0["params"]
        self.dg = Graph(h.astype(np.int32), t.astype(np.int32),
                        ne).to_device(device)
        self.etypes = self.dg.edge_types(r, nr)
        self.pos = Triples.build(h, r, t, ne, nr, device)
        self.model = RGCNLinkPredict(
            ne, tree["w_rel"].shape[1], nr,
            num_bases=tree["rgcn_0"]["basis"].shape[0], device=device)
        self.model.to(dtype or torch.float32)
        self.model.load_state_dict(state_dict_from_flax(w0))
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=0.01)
        self.scores = []


def rgcn_step(side: RgcnSide, tails):
    """One epoch of the example on ``side`` with the corrupted ``tails``;
    returns the loss and keeps the pre-sigmoid scores."""
    import torch

    from dgl_operator_tpu_torch.models.link_predict import bce_link_loss

    side.optimizer.zero_grad(set_to_none=True)
    pos_s, neg_s = side.model(side.dg, side.etypes, side.pos,
                              side.pos.with_tails(tails))
    loss = bce_link_loss(pos_s, neg_s)
    loss.backward()
    side.optimizer.step()
    side.scores.append(torch.cat([pos_s, neg_s]).detach().cpu())
    return loss.detach()


def rgcn_synced_gaps(torch, card: RgcnSide, cpu: RgcnSide, ds, epochs: int,
                     seed: int):
    """``epochs`` epochs of :func:`rgcn_step` on both sides, synced as in
    phase 8, on the example's negatives for ``seed``; each epoch's loss,
    every gradient and the pre-sigmoid scores held (``check_step_gaps``'
    limits, the scores within 1e-4 of their largest entry). ``cpu`` runs
    in float64: a relation's gradient (``w_rel``, ``coef``) is the small
    difference of its positives' and negatives' sums over up to 84,500
    triples, which the CPU's float32 sum rounds to 2e-4 of the largest
    entry on FB15k and the card's pieces to 5e-6. Returns the losses,
    the loss gaps, each epoch's worst gradient gap, the score gaps and
    the seconds of each side."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_tr = len(ds.train[2])
    tails = [rng.integers(0, ds.n_entities, size=n_tr).astype(np.int64)
             for _ in range(epochs)]
    gl, cl, gaps, secs = synced_step_gaps(torch, card, cpu, tails,
                                          rgcn_step)
    rel, worst = check_step_gaps("rgcn", gl, cl, gaps)
    score_gaps = [float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(card.scores, cpu.scores)]
    for i, e in enumerate(score_gaps):
        check(e <= 1e-4, f"rgcn epoch {i + 1} scores: max abs err {e} x "
              f"max > 1e-4")
    return gl, cl, rel, worst, score_gaps, secs


# a spin of about 20 ms before a timed epoch: the host enqueues the
# whole epoch while the card spins, so the events bracket device time
EPOCH_SPIN_CYCLES = 40_000_000


def rgcn_epoch_probe(torch, args, card: str) -> None:
    """Where an RGCN epoch's time goes, at the example's defaults on the
    full-size synthetic FB15k: the host ms of a set of corrupted tails'
    draw and of its plan (``Triples.with_tails``), and the device ms of
    one training epoch (forward, backward, Adam) by CUDA events after a
    spin that covers its enqueue (the enqueue's host ms reported
    beside it, and whether the spin outlasted it), each the median of
    5."""
    import numpy as np

    from dgl_operator_tpu_torch.graph import datasets
    from dgl_operator_tpu_torch.graph.graph import Graph
    from dgl_operator_tpu_torch.models.link_predict import bce_link_loss
    from dgl_operator_tpu_torch.models.rgcn import RGCNLinkPredict, Triples

    ds = datasets.fb15k(seed=args.seed)
    h, r, t = (np.asarray(a) for a in ds.train)
    ne, nr = ds.n_entities, ds.n_relations
    dg = Graph(h.astype(np.int32), t.astype(np.int32), ne).to_device("cuda")
    et = dg.edge_types(r, nr)
    pos = Triples.build(h, r, t, ne, nr, "cuda")
    rng = np.random.default_rng(args.seed)
    tails = rng.integers(0, ne, size=len(t))
    draw_ms = host_ms(lambda: rng.integers(0, ne, size=len(t)), 5)
    plan_ms = host_ms(lambda: pos.with_tails(tails), 5)
    neg = pos.with_tails(tails)
    model = RGCNLinkPredict(ne, 32, nr, device="cuda",
                            generator=torch.Generator().manual_seed(
                                args.seed))
    opt = torch.optim.Adam(model.parameters(), lr=0.01)

    def epoch():
        opt.zero_grad(set_to_none=True)
        bce_link_loss(*model(dg, et, pos, neg)).backward()
        opt.step()

    epoch()
    torch.cuda.synchronize()
    dev, enq, spin = [], [], []
    for _ in range(5):
        z, s, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        z.record()
        torch.cuda._sleep(EPOCH_SPIN_CYCLES)
        t0 = time.perf_counter()
        s.record()
        epoch()
        e.record()
        enq.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        spin.append(z.elapsed_time(s))
        dev.append(s.elapsed_time(e))
    emit(phase="rgcn_gin", part="rgcn_probe", card=card,
         tails_draw_host_ms=draw_ms, tails_plan_host_ms=plan_ms,
         epoch_device_ms=float(np.median(dev)),
         epoch_enqueue_host_ms=float(np.median(enq)),
         spin_ms=float(np.median(spin)),
         spin_covers_enqueue=max(enq) < min(spin))


def rgcn_runs(torch, args, wrappers, card: str) -> dict:
    """``examples/link_predict_rgcn.py`` at its defaults on the full-size
    synthetic FB15k twice on the card (losses, AUC and parameters
    bit-equal; launches; the peak device memory above what was allocated
    before the call, beside the JAX layer's ``[E, I, O]`` table); from
    one set of carried weights ``RGCN_CPU_EPOCHS`` epochs on the card and
    on the CPU in float64, synced (:func:`rgcn_synced_gaps`); and the
    same library run (``link_predict_rgcn.run``) for ``RGCN_237_EPOCHS``
    epochs on the synthetic FB15k-237. :func:`rgcn_epoch_probe` runs
    between them (its launches are not the main path's). Returns the
    launches."""
    import numpy as np

    from dgl_operator_tpu_torch.examples import link_predict_rgcn
    from dgl_operator_tpu_torch.graph import datasets
    from dgl_operator_tpu_torch.models import RGCNLinkPredict, flax_params

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, sec, launches = run_example(
            torch, wrappers, link_predict_rgcn,
            ["--seed", str(args.seed), "--device", "cuda"])
        peak = torch.cuda.max_memory_allocated() - base
        hist = out["history"]
        want = rgcn_launches(len(hist))
        check(launches == want, f"rgcn: {launches} launches in "
              f"{len(hist)} epochs, expected {want}")
        check(len(hist) == 60 and bool(np.isfinite(hist).all())
              and hist[-1] < hist[0] and 0.0 <= out["auc"] <= 1.0,
              f"rgcn: losses {hist}, AUC {out['auc']}")
        check(peak < JAX_RGCN_TABLE_BYTES, f"rgcn: peak {peak} B above the "
              f"start reaches the {JAX_RGCN_TABLE_BYTES} B [E, I, O] table")
        add(launches)
        runs.append(out)
        ep_ms = np.asarray(out["epoch_s"]) * 1e3
        emit(phase="rgcn_gin", part="rgcn", card=card, dataset="fb15k",
             epochs=len(hist), launches=launches, auc=out["auc"],
             loss_first=hist[0], loss_last=hist[-1],
             epoch_ms_first=float(ep_ms[0]),
             epoch_ms_mean_after_first=float(ep_ms[1:].mean()),
             epoch_ms_p50=float(np.percentile(ep_ms, 50)), call_s=sec,
             peak_bytes_above_start=peak,
             jax_edge_table_bytes=JAX_RGCN_TABLE_BYTES)
    a, b = runs
    check(a["history"] == b["history"] and a["auc"] == b["auc"]
          and same_params(a["params"], b["params"]),
          "rgcn: two card runs part")
    emit(phase="rgcn_gin", part="rgcn_bit_equal", card=card,
         losses_bit_equal=True, auc_bit_equal=True, params_bit_equal=True)
    rgcn_epoch_probe(torch, args, card)

    ds = datasets.fb15k(seed=args.seed)
    w0 = flax_params(RGCNLinkPredict(
        ds.n_entities, 32, ds.n_relations, device="cpu",
        generator=torch.Generator().manual_seed(args.seed + 5)))
    sides = [RgcnSide(torch, ds, w0, "cuda"),
             RgcnSide(torch, ds, w0, "cpu", dtype=torch.float64)]
    gl, cl, rel, worst, score_gaps, (card_s, cpu_s) = rgcn_synced_gaps(
        torch, *sides, ds, RGCN_CPU_EPOCHS, args.seed)
    del sides
    emit(phase="rgcn_gin", part="rgcn_cpu", card=card,
         epochs=RGCN_CPU_EPOCHS, synced=True, cpu_dtype="float64",
         card_losses=gl,
         cpu_losses=cl, loss_rel_err=rel, grad_rel_err_max=worst,
         score_rel_err=score_gaps, card_s=card_s, cpu_s=cpu_s)

    ds = datasets.kg_dataset("fb15k-237", seed=args.seed)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    out = link_predict_rgcn.run(ds, num_epochs=RGCN_237_EPOCHS,
                                seed=args.seed, device="cuda",
                                log=lambda *_: None)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_counts(wrappers)
    hist = out["history"]
    check(launches == rgcn_launches(RGCN_237_EPOCHS),
          f"rgcn fb15k-237: {launches} launches")
    check(bool(np.isfinite(hist).all()) and hist[-1] < hist[0],
          f"rgcn fb15k-237: losses {hist}")
    add(launches)
    emit(phase="rgcn_gin", part="rgcn_fb15k237", card=card,
         entities=ds.n_entities, relations=ds.n_relations,
         train_triples=len(ds.train[0]), epochs=len(hist),
         launches=launches, losses=hist, auc=out["auc"],
         epoch_ms_mean_after_first=float(np.mean(out["epoch_s"][1:]) * 1e3),
         call_s=sec)
    return total


def gin_runs(torch, args, wrappers, card: str) -> dict:
    """``examples/graph_classification.py`` at its defaults twice on the
    card (every step's loss and the parameters bit-equal, launches) and
    once on the CPU (every step's loss within 1e-4 relative; each run's
    test accuracy). Returns the launches."""
    import numpy as np

    from dgl_operator_tpu_torch.examples import graph_classification

    argv = ["--seed", str(args.seed)]
    total, runs = {}, []
    tests = len(range(int(0.8 * 300), 300 - 32 + 1, 32))
    for _ in range(2):
        out, sec, launches = run_example(torch, wrappers,
                                         graph_classification,
                                         argv + ["--device", "cuda"])
        steps = sum(len(h) for h in out["history"])
        (sg, ss), (tg, ts) = GIN_STEP_LAUNCHES, GIN_TEST_LAUNCHES
        want = counts_of(steps * sg + tests * tg, steps * ss + tests * ts)
        check(steps == 20 * 7 and launches == want,
              f"gin: {launches} launches in {steps} steps, expected {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        runs.append((out, sec, launches))
    (a, sec, launches), (b, _, _) = runs
    check(a["history"] == b["history"] and a["test_acc"] == b["test_acc"]
          and same_params(a["params"], b["params"]),
          "gin: two card runs part")
    cpu, cpu_s, _ = run_example(torch, wrappers, graph_classification,
                                argv + ["--device", "cpu"])
    card_l, cpu_l = np.ravel(a["history"]), np.ravel(cpu["history"])
    gap = rel_gaps(card_l, cpu_l)
    check(bool(np.isfinite(card_l).all()) and len(card_l) == len(cpu_l)
          and max(gap) <= 1e-4, f"gin: card losses {card_l.tolist()} vs "
          f"CPU {cpu_l.tolist()}: relative {gap}")
    emit(phase="rgcn_gin", part="gin", card=card, steps=len(card_l),
         launches=launches, bit_equal=True, test_acc=a["test_acc"],
         cpu_test_acc=cpu["test_acc"], steps_held=len(card_l),
         loss_rel_err=gap, card_losses_first_epoch=a["history"][0],
         card_loss_last_epoch_mean=float(np.mean(a["history"][-1])),
         cpu_loss_last_epoch_mean=float(np.mean(cpu["history"][-1])),
         card_call_s=sec, cpu_call_s=cpu_s,
         step_ms=sec * 1e3 / len(card_l))
    return total


def pool_cpu_checks(torch, args, g, ctx, ids, w0, card: str) -> None:
    """The pool ``DistSAGE`` from the flax tree ``w0`` (dropout 0) on the
    card and on the CPU, synced as in phase 8 and held to
    ``check_step_gaps``' limits: ``POOL_CPU_STEPS`` ``SampledTrainer``
    steps on the host sampler and on the device sampler (calls of one
    step; :func:`pool_runs` holds K = 4's graph replays to them bit for
    bit), and ``POOL_CPU_STEPS`` ``DistTrainer`` steps over phase 10's
    book, replicated."""
    import numpy as np

    from dgl_operator_tpu_torch.models import state_dict_from_flax
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.runtime.dist import DistTrainer
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    def model(dev):
        m = DistSAGE(FEAT, HIDDEN, CLASSES, aggregator="pool", device=dev)
        m.load_state_dict(state_dict_from_flax(w0))
        return m

    def sampled(dev, sampler, k):
        cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                          num_epochs=1, eval_every=0, seed=args.seed,
                          dropout=0.0, sampler=sampler, steps_per_call=k)
        return SampledTrainer(model(dev), g, cfg, train_ids=ids, device=dev)

    def dist(dev):
        cfg = TrainConfig(num_epochs=1, batch_size=BATCH_TRAIN,
                          fanouts=FANOUTS, lr=LR, eval_every=0,
                          seed=args.seed, dropout=0.0, cap_policy="auto",
                          feats_layout="replicated")
        return DistTrainer(model(dev), ctx["book"], cfg, device=dev)

    host = [sampled(dev, "host", 1) for dev in ("cuda", "cpu")]
    mbs = [host[0].sample(ids[b * BATCH_TRAIN:(b + 1) * BATCH_TRAIN], b)
           for b in range(POOL_CPU_STEPS)]
    dev = [sampled(d, "device", 1) for d in ("cuda", "cpu")]
    for tr in dev:
        tr._start_device_run(len(ids) // BATCH_TRAIN).stage([ids])
    reps = [dist(d) for d in ("cuda", "cpu")]
    perm = [np.random.default_rng(args.seed).permutation(t)
            for t in reps[0].train_ids]
    batches = [reps[0]._sample_all(perm, b, b)[0]
               for b in range(POOL_CPU_STEPS)]

    def step(tr, b):
        return tr.train_step(b)[0]

    for name, pair, items, fn in (
            ("host", host, mbs, step),
            ("device_k1", dev, list(range(POOL_CPU_STEPS)),
             lambda tr, b: tr.train_call((b, b, 1))[0][0]),
            ("dist_replicated", reps, batches, step)):
        gl, cl, gaps, (gs, cs) = synced_step_gaps(torch, *pair, items, fn)
        rel, worst = check_step_gaps(f"pool {name}", gl, cl, gaps)
        emit(phase="rgcn_gin", part="pool_cpu", run=name, card=card,
             steps=len(items), synced=True, card_losses=gl, cpu_losses=cl,
             loss_rel_err=rel, grad_rel_err_max=worst, card_s=gs,
             cpu_s=cs)


def pool_runs(torch, args, wrappers, g, trainer, ctx, card: str):
    """A pool ``DistSAGE`` at the SAGE cell's widths (100 -> 256 -> 47,
    fanouts 10 and 25, batch 1000): ``SampledTrainer`` for
    ``POOL_STEPS`` steps with the host sampler and with the device
    sampler at K = 4 (a CUDA graph a call), and ``DistTrainer`` for an
    epoch of the dist phase's book, replicated; each run twice from one
    set of weights, and the device sampler once more at K = 1 (eager),
    losses and parameters bit-equal (the pool's slots
    gathered by ``gather_rows`` over per-slot plans, its backward the
    plan's ``scatter_add_rows``), with its launches and step times; the
    host sampler's ms for a batch with its per-slot plans beside the
    plans alone (and the mean's row plans); and, first, the same weights
    against the CPU (:func:`pool_cpu_checks`). Returns the launches and
    the device-sampler trainer."""
    import numpy as np

    from dgl_operator_tpu_torch.models import flax_params
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.ops.scatter import attach_plans
    from dgl_operator_tpu_torch.runtime.dist import DistTrainer
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    ids = trainer.train_ids[:POOL_STEPS * BATCH_TRAIN]
    w0 = flax_params(DistSAGE(
        FEAT, HIDDEN, CLASSES, aggregator="pool", device="cpu",
        generator=torch.Generator().manual_seed(args.seed + 9)))

    pool_cpu_checks(torch, args, g, ctx, ids, w0, card)

    def model():
        return DistSAGE(FEAT, HIDDEN, CLASSES, aggregator="pool",
                        device="cuda")

    def sampled(sampler, k):
        cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                          num_epochs=1, eval_every=0, seed=args.seed,
                          sampler=sampler, steps_per_call=k)
        return SampledTrainer(model(), g, cfg, train_ids=ids)

    def dist():
        cfg = TrainConfig(num_epochs=1, batch_size=BATCH_TRAIN,
                          fanouts=FANOUTS, lr=LR, eval_every=0,
                          seed=args.seed, cap_policy="auto",
                          feats_layout="replicated")
        return DistTrainer(model(), ctx["book"], cfg)

    def warm3(steps):           # the warm-up forward's three gathers
        return counts_of(3 * steps + 3, 2 * steps)

    def warm3_device(steps):    # and each step's tree, slot plans included
        return counts_of(3 * steps + 3, 2 * steps,
                         tree_launches(steps + 1, True))

    def dist_want(steps):       # per slot: the feature gather, the pool's
        return counts_of(3 * 2 * steps, 2 * 2 * steps)

    total, device_tr, graphed = {}, None, None
    for name, make, want_of, runs in (
            ("host", lambda: sampled("host", 1), warm3, 2),
            (f"device_k{DEV_K}", lambda: sampled("device", DEV_K),
             warm3_device, 2),
            ("device_k1", lambda: sampled("device", 1), warm3_device, 1),
            ("dist_replicated", dist, dist_want, 2)):
        outs = []
        for _ in range(runs):
            tr = make()
            torch.cuda.synchronize()
            reset_counts(wrappers)
            t0 = time.perf_counter()
            out = tr.train(init_params=w0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts(wrappers)
            steps = out["step"]
            rec = out["history"][0]
            check(launches == want_of(steps), f"pool {name}: {launches} "
                  f"launches in {steps} steps, expected {want_of(steps)}")
            check(bool(np.isfinite(rec["losses"]).all()),
                  f"pool {name}: losses {rec['losses']}")
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            outs.append((tr, out, wall, launches))
        (tr, a, wall, launches), b = outs[0], outs[-1][1]
        if name == "device_k1":         # eager against the graph replays
            b = graphed
        check(a["history"][0]["losses"] == b["history"][0]["losses"]
              and all(torch.equal(v, b["params"][k])
                      for k, v in a["params"].items()),
              f"pool {name}: two runs part")
        rec = a["history"][0]
        steps = a["step"]
        extra = {}
        if name == f"device_k{DEV_K}":
            check(rec["graph"] and rec["graph_replays"] == steps // DEV_K - 1,
                  f"pool {name}: {rec['graph_replays']} replays of "
                  f"{steps // DEV_K} calls")
            device_tr, graphed = tr, a
        if name == "host":
            seeds = ids[:BATCH_TRAIN]
            mb = tr.sample(seeds, 3)
            extra = dict(
                sample_with_plans_ms=host_ms(lambda: tr.sample(seeds, 3), 5),
                slot_plans_ms=host_ms(lambda: attach_plans(mb.blocks, True),
                                      5),
                row_plans_ms=host_ms(lambda: attach_plans(mb.blocks, False),
                                     5))
        if name.startswith("device"):
            extra = device_run_record(rec, steps, tr.cfg.steps_per_call)
        step_ms = np.asarray(rec.get("step_s", [])) * 1e3
        line = dict(phase="rgcn_gin", part="pool", run=name, card=card,
                    steps=steps, launches=launches, bit_equal=True,
                    losses=rec["losses"], train_call_s=wall,
                    wall_ms_per_step=wall * 1e3 / steps,
                    step_ms_mean=(float(step_ms.mean()) if step_ms.size
                                  else None),
                    **{f"{k}_ms_per_step": rec.get(k, 0.0) * 1e3 / steps
                       for k in ("sample", "stall", "dispatch")})
        line.update(extra)
        emit(**line)
    return total, device_tr


def rgcn_gin_kernel_records(torch, args, ops, pool_tr, card: str):
    """``gather_rows`` and ``scatter_add_rows`` against their plain
    versions at the RGCN's shapes on the full-size synthetic FB15k
    (483,142 train triples, 14,951 entities, 1,345 relations, hidden 32,
    8 bases): ``HB[src]`` (1,024-byte rows) and its backward,
    ``coef[etype]`` (32-byte rows) and its backward into 1,345 targets
    (relation 0 a hub), the segment mean's sum (128-byte rows into
    14,952 segments), the DistMult head and relation gathers (128-byte
    rows) and the relation's backward; and the pool's block-0 slot
    gather (400-byte rows) and its backward over the per-slot plan, on
    one device-sampled batch of ``pool_tr``."""
    import numpy as np

    from dgl_operator_tpu_torch.graph import datasets
    from dgl_operator_tpu_torch.graph.graph import Graph
    from dgl_operator_tpu_torch.models.rgcn import Triples
    from dgl_operator_tpu_torch.ops.device_sample import draw_key

    _, gather, scatter = ops
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 17)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    ds = datasets.fb15k(seed=args.seed)
    h, r, t = (np.asarray(a) for a in ds.train)
    ne, nr = ds.n_entities, ds.n_relations
    dg = Graph(h.astype(np.int32), t.astype(np.int32), ne).to_device("cuda")
    et = dg.edge_types(r, nr)
    tri = Triples.build(h, r, t, ne, nr, "cuda")
    e = dg.num_edges
    records = gather_records(torch, gather, [
        ("rgcn_hb_src", randn(ne, 8 * 32), dg.src),
        ("rgcn_coef_etype", randn(nr, 8), et.ids),
        ("rgcn_distmult_head", randn(ne, 32), tri.head),
        ("rgcn_distmult_rel", randn(nr, 32), tri.rel),
    ], flush, args.iters, card)
    records += scatter_records(torch, scatter, [
        ("rgcn_hb_src_bwd", randn(e, 8 * 32), dg.src.view(-1, 1), None, ne,
         False, dg.src_plan),
        ("rgcn_coef_etype_bwd", randn(e, 8), et.ids.view(-1, 1), None, nr,
         False, et.plan),
        ("rgcn_segment_mean", randn(e, 32), dg.dst.view(-1, 1), None,
         ne + 1, False, dg.dst_plan),
        ("rgcn_distmult_rel_bwd", randn(e, 32), tri.rel.view(-1, 1), None,
         nr, False, tri.rel_plan),
    ], flush, args.iters, card)
    del dg, et, tri

    seeds = torch.from_numpy(pool_tr.train_ids[:BATCH_TRAIN].astype(
        np.int32)).to(pool_tr._indptr.dtype).to("cuda")
    (b0, _), inputs = pool_tr._tree.sample(pool_tr._indptr,
                                           pool_tr._indices, seeds,
                                           draw_key(args.seed, 17))
    check(b0.plan is not None and b0.plan.cnt.numel() == b0.nbr.numel(),
          "the pool tree blocks carry per-slot plans from block 0")
    with torch.no_grad():
        x0 = gather.gather_rows(pool_tr.feats, inputs)
        p0 = torch.relu(pool_tr.model.layers[0].pool(x0)).contiguous()
    i0 = b0.nbr.view(-1)
    records += gather_records(torch, gather, [("pool_block0", p0, i0)],
                              flush, args.iters, card)
    records += scatter_records(torch, scatter, [
        ("pool_block0_bwd", randn(i0.numel(), FEAT), b0.nbr.view(-1, 1),
         b0.mask.view(-1, 1), b0.num_src, False, b0.plan)],
        flush, args.iters, card)
    return records


def rgcn_gin_phase(torch, args, ops, wrappers, g, trainer, ctx, card: str):
    """RGCN link prediction, GIN graph classification and the sampled
    pool aggregator on the port's kernels (:func:`rgcn_runs`,
    :func:`gin_runs`, :func:`pool_runs`), then the kernels at their
    shapes. Returns the launches and the kernel records."""
    t0 = time.perf_counter()
    total = rgcn_runs(torch, args, wrappers, card)
    for k, v in gin_runs(torch, args, wrappers, card).items():
        total[k] += v
    pool, pool_tr = pool_runs(torch, args, wrappers, g, trainer, ctx, card)
    for k, v in pool.items():
        total[k] += v
    torch.cuda.empty_cache()
    records = rgcn_gin_kernel_records(torch, args, ops, pool_tr, card)
    del pool_tr
    torch.cuda.empty_cache()
    emit(phase="rgcn_gin", part="done", card=card, launches=total,
         seconds=time.perf_counter() - t0)
    return total, records


SENTRY_MODES = (("host_k1", dict(sampler="host")),
                ("device_k1", dict(sampler="device")),
                ("device_k4", dict(sampler="device", steps_per_call=DEV_K)))
SENTRY_STATS_TOL = 1e-5   # one step's stats, card against CPU, relative
SENTRY_STATS_STEPS = 4    # synced steps of that comparison
SENTRY_SAFE_STEPS = 2     # the drill's poisoned rows miss these batches
SENTRY_CKPT_EPOCH = 1     # the drill's checkpoint fence


def sage_launches(steps: int, warm: int = 1, device: bool = False) -> dict:
    """A SAGE run's launches: per step 1 gather, 2 aggregations and the
    backward of block 1's aggregation; ``warm`` warm-up forwards add a
    gather and two aggregations each; with the device sampler, each
    step and warm-up samples its tree (:func:`tree_launches`)."""
    return {"fanout_agg": 2 * (steps + warm), "gather_rows": steps + warm,
            "scatter_add_rows": steps,
            "tree_sample": tree_launches(steps + warm) if device else 0}


def same_run(a, b) -> bool:
    """Two ``train()`` results with the same losses and parameters, bit
    for bit."""
    la = [x for r in a["history"] for x in r["losses"]]
    lb = [x for r in b["history"] for x in r["losses"]]
    return la == lb and a["params"].keys() == b["params"].keys() and all(
        v.equal(b["params"][k]) for k, v in a["params"].items())


def sentry_sampled(torch, args, wrappers, g, trainer, card: str) -> dict:
    """``SampledTrainer`` over the train phase's 40 steps with the sentry
    off and on, in the order off, on, on, off: the host sampler at
    K = 1 and the device sampler at K = 1 and at K = 4 (captured);
    losses and parameters bit-equal, launches checked, the steady ms a
    step of each side and the sentry's overhead. Returns the launches."""
    import numpy as np

    from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                    state_dict_to_flax)
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    w0 = state_dict_to_flax(DistSAGE(
        FEAT, HIDDEN, CLASSES, device="cpu",
        generator=torch.Generator().manual_seed(args.seed + 5)).state_dict())
    total = {}
    for mode, fields in SENTRY_MODES:
        k = fields.get("steps_per_call", 1)
        device = fields["sampler"] == "device"
        runs = {False: [], True: []}
        for sentry in (False, True, True, False):
            cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                              num_epochs=1, eval_every=0, seed=args.seed,
                              sentry=sentry, **fields)
            tr = SampledTrainer(DistSAGE(FEAT, HIDDEN, CLASSES,
                                         device="cuda"),
                                g, cfg, train_ids=trainer.train_ids,
                                device="cuda")
            # the main path: every kernel count starts at 0 here
            reset_counts(wrappers)
            out = tr.train(init_params=w0)
            launches = read_counts(wrappers)
            steps = out["step"]
            check(steps == len(trainer.train_ids) // BATCH_TRAIN,
                  f"sentry {mode}: {steps} steps")
            check(launches == sage_launches(steps, device=device),
                  f"sentry {mode} on={sentry}: {launches} in {steps} steps")
            check((tr.last_stats is not None) == sentry,
                  f"sentry {mode} on={sentry}: last_stats")
            if sentry:
                st = {key: float(v) for key, v in tr.last_stats.items()}
                check(st["nonfinite"] == 0 and st["grad_norm"] > 0,
                      f"sentry {mode}: last stats {st}")
            for key, v in launches.items():
                total[key] = total.get(key, 0) + v
            rec = device_run_record(out["history"][0], steps, k)
            runs[sentry].append((out, rec, tr.last_stats))
        ref = runs[False][0][0]
        for sentry, rs in runs.items():
            for out, _, _ in rs:
                check(same_run(out, ref), f"sentry {mode}: the run with "
                      f"the sentry {'on' if sentry else 'off'} differs "
                      "from the first run without it")
        ms = {s: [r["steady_ms_per_step"] for _, r, _ in rs]
              for s, rs in runs.items()}
        off, on = float(np.mean(ms[False])), float(np.mean(ms[True]))
        last = runs[True][0][2]
        emit(phase="sentry", part="sampled", mode=mode, card=card,
             steps_per_call=k, steps=ref["step"], order="off,on,on,off",
             bit_equal=True,
             launches_per_run=sage_launches(ref["step"], device=device),
             steady_ms_per_step_off=ms[False],
             steady_ms_per_step_on=ms[True], off_ms_mean=off,
             on_ms_mean=on, overhead=(on - off) / off,
             stall_ms_per_step_on=[r["stall_ms_per_step"]
                                   for _, r, _ in runs[True]],
             graph=runs[True][0][1]["graph"],
             last_stats={key: float(v) for key, v in last.items()})
    return total


def sentry_dist(torch, wrappers, ctx, card: str) -> dict:
    """Phase 10's ``DistTrainer`` epoch in both layouts with the sentry
    off and on: bit-equal, launches checked, each slot's loss and
    non-finite count of the last step. Returns the launches."""
    total = {}
    for layout in LAYOUTS:
        outs, ms = {}, {}
        for sentry in (False, True):
            tr = ctx["make"](layout, eval_every=0, sentry=sentry)
            P = tr.num_parts
            reset_counts(wrappers)
            t0 = time.perf_counter()
            out = tr.train(init_params=ctx["w0"])
            wall = time.perf_counter() - t0
            launches = read_counts(wrappers)
            steps = out["step"]
            exchange = steps if layout == "owner" else 0
            check(launches == {"fanout_agg": 2 * P * steps,
                               "gather_rows": P * steps + exchange,
                               "scatter_add_rows": P * steps,
                               "tree_sample": 0},
                  f"sentry dist {layout}: {launches} in {steps} steps")
            for key, v in launches.items():
                total[key] = total.get(key, 0) + v
            outs[sentry], ms[sentry] = out, wall * 1e3 / steps
            stats = tr.last_stats
        check(same_run(outs[True], outs[False]),
              f"sentry dist {layout}: the sentry changed the run")
        check(outs[True]["history"][0]["losses"]
              == ctx["want"][layout][1], f"sentry dist {layout}: losses "
              "differ from the dist phase's")
        part_nonfinite = stats["part_nonfinite"].tolist()
        check(part_nonfinite == [0] * P,
              f"sentry dist {layout}: part_nonfinite {part_nonfinite}")
        emit(phase="sentry", part="dist", layout=layout, card=card,
             steps=outs[True]["step"], bit_equal=True,
             equal_to_dist_phase=True, ms_per_step_off=ms[False],
             ms_per_step_on=ms[True],
             part_loss=stats["part_loss"].tolist(),
             part_nonfinite=part_nonfinite,
             grad_norm=float(stats["grad_norm"]))
    return total


def sentry_stats_cpu(torch, args, g, trainer, card: str) -> None:
    """Each step's stats on the card against the CPU's over
    ``SENTRY_STATS_STEPS`` batches, the card taking the CPU's weights and
    Adam state before every step (dropout 0, as phase 8): every step
    after the first within ``SENTRY_STATS_TOL`` relative, no non-finite
    element. The first step of a fresh Adam divides each gradient
    element by its own magnitude, so its update ratio carries the
    rounding of elements near zero; it is reported, not held."""
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.obs.quality import STAT_KEYS
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                      dropout=0.0, cap_policy="worst", seed=args.seed)
    mbs = [trainer.sample(trainer.train_ids[b * BATCH_TRAIN:
                                            (b + 1) * BATCH_TRAIN], 70 + b)
           for b in range(SENTRY_STATS_STEPS)]
    trainers = [SampledTrainer(
        DistSAGE(FEAT, HIDDEN, CLASSES, device=dev,
                 generator=torch.Generator().manual_seed(args.seed + 6)),
        g, cfg, train_ids=trainer.train_ids, device=dev)
        for dev in ("cuda", "cpu")]
    stats = {id(tr): [] for tr in trainers}

    def step(tr, mb):
        loss, _, rows = tr.step_shipped(tr.ship(mb))
        stats[id(tr)].append(dict(zip(STAT_KEYS, rows.tolist())))
        return loss

    synced_step_gaps(torch, *trainers, mbs, step)
    card_st, cpu_st = (stats[id(tr)] for tr in trainers)
    rel = [{k: abs(c[k] - h[k]) / max(abs(h[k]), 1e-30)
            for k in STAT_KEYS if k != "nonfinite"}
           for c, h in zip(card_st, cpu_st)]
    check(all(c["nonfinite"] == h["nonfinite"] == 0
              for c, h in zip(card_st, cpu_st)),
          f"sentry stats: non-finite {card_st} {cpu_st}")
    worst = max(max(r.values()) for r in rel[1:])
    check(worst <= SENTRY_STATS_TOL,
          f"sentry stats card vs CPU: relative {rel} > {SENTRY_STATS_TOL}")
    emit(phase="sentry", part="stats_cpu", card=card,
         steps=SENTRY_STATS_STEPS, synced=True, card_stats=card_st,
         cpu_stats=cpu_st, rel_err=rel, held_from_step=2,
         rel_err_max_held=worst, tol=SENTRY_STATS_TOL)


def sentry_drill(torch, args, wrappers, g, trainer, work: str,
                 card: str) -> dict:
    """The fault drill: the feature rows of 3 train nodes that the first
    ``SENTRY_SAFE_STEPS`` batches do not read are set to NaN; the card
    and the CPU, host sampler, same seed, raise ``NumericsFault`` at the
    same global step; on the card a checkpoint a step under a fenced
    manager (``TPU_OPERATOR_ELASTIC_EPOCH=1``) has every checkpoint at
    or past that step quarantined; a fresh trainer over the clean rows
    resumes from the survivor and completes the epoch. Returns the
    launches of the two card runs."""
    import numpy as np

    from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                    state_dict_to_flax)
    from dgl_operator_tpu_torch.obs.quality import NumericsFault
    from dgl_operator_tpu_torch.parallel.bootstrap import FENCE_EPOCH_ENV
    from dgl_operator_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                           read_fence)
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    B = BATCH_TRAIN
    w0 = state_dict_to_flax(DistSAGE(
        FEAT, HIDDEN, CLASSES, device="cpu",
        generator=torch.Generator().manual_seed(args.seed + 7)).state_dict())
    perm = np.random.default_rng(args.seed).permutation(trainer.train_ids)
    read = set()
    for b in range(SENTRY_SAFE_STEPS):
        read.update(trainer.sample(perm[b * B:(b + 1) * B], b)
                    .input_nodes.tolist())
    nxt = perm[SENTRY_SAFE_STEPS * B:(SENTRY_SAFE_STEPS + 1) * B]
    poisoned = np.asarray([v for v in nxt if int(v) not in read][:3])
    check(len(poisoned) == 3, f"3 train nodes unread by the first "
          f"{SENTRY_SAFE_STEPS} batches: {poisoned}")
    ckpt = os.path.join(work, "sentry_ckpt")

    def make(dev, **fields):
        cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                          num_epochs=1, eval_every=0, seed=args.seed,
                          dropout=0.0, **fields)
        return SampledTrainer(DistSAGE(FEAT, HIDDEN, CLASSES, device=dev),
                              g, cfg, train_ids=trainer.train_ids,
                              device=dev)

    faults, launches, steps_s = {}, {}, {}
    prev = os.environ.get(FENCE_EPOCH_ENV)
    os.environ[FENCE_EPOCH_ENV] = str(SENTRY_CKPT_EPOCH)
    try:
        for side, dev in (("card", "cuda"), ("cpu", "cpu")):
            tr = (make(dev, ckpt_dir=ckpt, ckpt_every=1) if side == "card"
                  else make(dev, quality_action="halt"))
            # a copy: on the CPU the trainer's table shares the graph's
            # memory, which the resume below needs clean
            tr.feats = tr.feats.clone()
            tr.feats[torch.from_numpy(poisoned).to(tr.device)] = float("nan")
            reset_counts(wrappers)
            t0 = time.perf_counter()
            try:
                tr.train(init_params=w0)
                raise RuntimeError(f"sentry drill: no fault on the {side}")
            except NumericsFault as exc:
                faults[side] = exc
            steps_s[side] = time.perf_counter() - t0
            launches[side] = read_counts(wrappers)
        step = faults["card"].step
        check((faults["card"].step, faults["card"].partition,
               faults["card"].kind) == (faults["cpu"].step,
                                        faults["cpu"].partition,
                                        faults["cpu"].kind),
              f"sentry drill: card fault {vars(faults['card'])} vs CPU "
              f"{vars(faults['cpu'])}")
        check(SENTRY_SAFE_STEPS < step <= SENTRY_SAFE_STEPS + 1,
              f"sentry drill: fault at step {step}")
        # the card ran on past the fault until the tap showed it (the
        # call after it, when its copy has landed by then)
        ran = launches["card"]["scatter_add_rows"]
        check(ran > step and launches["card"] == sage_launches(ran),
              f"sentry drill: {launches['card']} launches, fault {step}")
        check(read_fence(ckpt)["epoch"] == SENTRY_CKPT_EPOCH,
              f"sentry drill: fence {read_fence(ckpt)}")
        active = os.path.join(ckpt, f"epoch-{SENTRY_CKPT_EPOCH}")
        files = sorted(os.listdir(active))
        bad = sorted(int(f[5:-8]) for f in files if f.endswith(".npz.bad"))
        survivor = CheckpointManager(ckpt).latest_step()
        check(step in bad and all(step <= s <= ran for s in bad)
              and survivor is not None and survivor < step,
              f"sentry drill: quarantined {bad}, survivor {survivor}, "
              f"fault {step}: {files}")
        # the rows restored: a fresh trainer resumes from the survivor
        resumed = make("cuda", ckpt_dir=ckpt, ckpt_every=10)
        reset_counts(wrappers)
        t0 = time.perf_counter()
        out = resumed.train()
        resume_s = time.perf_counter() - t0
        launches["resume"] = read_counts(wrappers)
    finally:
        if prev is None:
            os.environ.pop(FENCE_EPOCH_ENV, None)
        else:
            os.environ[FENCE_EPOCH_ENV] = prev
    total = len(trainer.train_ids) // B
    losses = out["history"][0]["losses"]
    check(out["step"] == total and len(losses) == total - survivor
          and bool(np.isfinite(losses).all()),
          f"sentry drill: resumed at {survivor}, ended at {out['step']}")
    check(launches["resume"] == sage_launches(total - survivor),
          f"sentry drill resume: {launches['resume']}")
    emit(phase="sentry", part="drill", card=card,
         poisoned_nodes=poisoned.tolist(), fault_step=step,
         fault_partition=faults["card"].partition,
         fault_kind=faults["card"].kind, cpu_fault_step=faults["cpu"].step,
         card_steps_run=ran,
         fence_epoch=SENTRY_CKPT_EPOCH, quarantined=bad, survivor=survivor,
         resumed_steps=len(losses), final_step=out["step"],
         card_s=steps_s["card"], cpu_s=steps_s["cpu"], resume_s=resume_s)
    return {key: launches["card"][key] + launches["resume"][key]
            for key in launches["resume"]}


def sentry_phase(torch, args, wrappers, g, trainer, ctx, work: str,
                 card: str) -> dict:
    """The numerics sentry: bit-equal runs with it off and on, one
    step's stats against the CPU, and the fault drill. Returns the
    launches of its card runs."""
    parts = [sentry_sampled(torch, args, wrappers, g, trainer, card),
             sentry_dist(torch, wrappers, ctx, card)]
    sentry_stats_cpu(torch, args, g, trainer, card)
    parts.append(sentry_drill(torch, args, wrappers, g, trainer, work, card))
    return {k: sum(p[k] for p in parts) for k in parts[0]}


FLEET_CLIENTS = 4          # concurrent clients of the failover drill
FLEET_FAILOVER_REQUESTS = 12   # requests per client; the kill after 3
FLEET_MAX_CANARY = 400     # requests a canary verdict may take
FLEET_DIE_AFTER = 3        # replica:die: the victim's accepted requests


def fleet_requests(args, g):
    """The serve phase's requests: ``--requests`` of 1 to 64 seeds."""
    import numpy as np

    rng = np.random.default_rng(args.seed + 1)
    return [rng.choice(g.num_nodes, size=int(rng.integers(1, 65)),
                       replace=False) for _ in range(args.requests)]


def fleet_phase(torch, args, wrappers, g, trainer, work: str,
                card: str) -> dict:
    """Two ``ServingPlane`` replicas on the card over the serve phase's
    2-part book, serving the trained weights, behind a ``RouterPlane``:
    the serve phase's requests through HTTP (p50/p99 beside the serve
    phase's direct batcher numbers), a fixed request's reply against the
    engine's own ``predict``, a canary poisoned by the chaos plan's
    ``promote:bad`` rolled back and the trained weights promoted through
    ``ServingPromotion``, and partition 0's replica killed by
    ``replica:die`` under concurrent clients with no request dropped (a
    spare plane of its name, built with the plan, takes its place in the
    ring first). Returns the launches of the served requests."""
    import threading
    import urllib.request

    import numpy as np

    from dgl_operator_tpu_torch.launcher.chaos import CHAOS_ENV
    from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                    state_dict_to_flax)
    from dgl_operator_tpu_torch.obs import get_obs
    from dgl_operator_tpu_torch.runtime.checkpoint import (
        ServingPromotion, export_for_serving, load_params, promotion_history,
        read_fence)
    from dgl_operator_tpu_torch.serve import (CanaryController, FleetRouter,
                                              HashRing, Replica,
                                              RouterPlane, ServeConfig,
                                              ServeEngine, ServingPlane)
    from dgl_operator_tpu_torch.serve.router import _http_json

    book = os.path.join(work, "book", "ogbn-products.json")
    trained = state_dict_to_flax({k: v.detach().cpu() for k, v in
                                  trainer.model.state_dict().items()})
    export = export_for_serving(os.path.join(work, "fleet") + os.sep,
                                trained)
    cfg = ServeConfig(fanouts=FANOUTS, batch_size=BATCH,
                      halo_cache_frac=0.25, cap_policy="worst")
    # the first pair of replica names whose ring gives each replica one
    # of the 2 partitions, so both serve traffic
    names = next(pair for pair in itertools.combinations(
        [f"r{i}" for i in range(8)], 2)
        if len({HashRing(pair).candidates(f"part-{p}")[0]
                for p in range(2)}) == 2)
    victim_name = HashRing(names).candidates("part-0")[0]
    spare_key = victim_name + "-spare"
    t0 = time.perf_counter()
    planes = {}
    router_plane = None
    try:
        for key, name, plan in [(n, n, None) for n in names] + [
                (spare_key, victim_name,
                 f"replica:die:{FLEET_DIE_AFTER}@host={victim_name}")]:
            eng = ServeEngine(DistSAGE(FEAT, HIDDEN, CLASSES, device="cuda"),
                              book, params_path=export, cfg=cfg,
                              device="cuda")
            with chaos_env(**{CHAOS_ENV: plan}):
                planes[key] = ServingPlane(eng, port=0, name=name).start()
        node_map = np.asarray(planes[names[0]].engine.node_map)
        router = FleetRouter([Replica(n, "127.0.0.1", planes[n].port,
                                      plane=planes[n]) for n in names],
                             node_map=node_map, probe_timeout_s=2.0)
        router_plane = RouterPlane(router).start(probe_interval_s=0.5)
        setup_s = time.perf_counter() - t0
        port = router_plane.port
        for p in planes.values():
            code, hz = _http_json("GET", "127.0.0.1", p.port, "/healthz")
            check(code == 200 and hz["ok"] and hz["device"].startswith(
                "cuda"), f"fleet: /healthz of {p.name}: {code} {hz}")

        def post(ids):
            return _http_json("POST", "127.0.0.1", port, "/predict",
                              {"nodes": [int(v) for v in ids]})

        forwards0 = {n: p.engine.forward_calls for n, p in planes.items()}
        # the main path: every kernel count starts at 0 here
        reset_counts(wrappers)
        lat_ms = []
        for ids in fleet_requests(args, g):
            t = time.perf_counter()
            code, payload = post(ids)
            lat_ms.append((time.perf_counter() - t) * 1e3)
            preds = np.asarray(payload.get("predictions", []))
            check(code == 200 and preds.shape == ids.shape
                  and preds.min() >= 0 and preds.max() < CLASSES,
                  f"fleet: request of {len(ids)} seeds: {code} {payload}")
        lat = np.asarray(lat_ms)
        served_forwards = {n: p.engine.forward_calls - forwards0[n]
                           for n, p in planes.items()}
        # a fixed request against its replica's own predict at the batch
        # sequence number its micro-batch takes
        rng = np.random.default_rng(args.seed + 8)
        fixed = np.sort(rng.choice(g.num_nodes, size=BATCH, replace=False))
        rep = router.route(fixed)[0]
        seq = rep.plane.batcher._seq
        code, payload = post(fixed)
        want = rep.plane.engine.predict(fixed, sample_seed=seq)
        check(code == 200 and payload["predictions"] == want.tolist(),
              f"fleet: the fixed request's reply differs from "
              f"{rep.name}'s predict(sample_seed={seq})")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{rep.port}/metrics", timeout=30) as r:
            code, metrics = r.status, r.read().decode()
        check(code == 200 and "serve_quantile_seconds" in metrics,
              "fleet: /metrics renders the latency quantiles")
        code, livez = _http_json("GET", "127.0.0.1", rep.port, "/livez")
        check(code == 200 and livez["ready"], f"fleet: /livez {livez}")
        emit(phase="fleet", part="traffic", card=card, replicas=list(names),
             setup_s=setup_s, requests=len(lat),
             p50_ms=float(np.percentile(lat, 50)),
             p99_ms=float(np.percentile(lat, 99)),
             serve_phase_p50_ms=LAST["serve"]["p50_ms"],
             serve_phase_p99_ms=LAST["serve"]["p99_ms"],
             forwards_by_replica=served_forwards,
             fixed_request_replica=rep.name, fixed_request_seq=seq,
             fixed_request_equal=True, livez_p99_ms=livez.get("p99_ms"),
             livez_qps=livez.get("qps"))

        # the canary: a NaN-filled candidate, then the trained weights
        traffic = fleet_requests(args, g)
        promo = ServingPromotion(os.path.join(work, "promo"))
        canary = CanaryController(router, promo, frac=0.5,
                                  divergence_threshold=0.5, min_mirrors=4)
        # mirrors come from the traffic the other replica serves
        canary_name = router.ring.candidates("part-1")[0]
        probe = fixed[:16]
        before = planes[canary_name].engine.predict(probe, sample_seed=3)
        verdicts = []
        for round_ in ("nan", "trained"):
            # promote:bad poisons the staged file after its checksum:
            # integrity checks pass, only the canary's detectors can tell
            with chaos_env(**{CHAOS_ENV: "promote:bad" if round_ == "nan"
                              else None}):
                cand = promo.stage(trained)
            leaf = load_params(cand)["params"]["FanoutSAGEConv_0"]["self"]
            check(bool(np.isnan(leaf["kernel"]).all()) == (round_ == "nan"),
                  f"fleet canary {round_}: the staged candidate")
            canary.start(cand, replica=canary_name)
            sent = 0
            while canary.active and sent < FLEET_MAX_CANARY:
                code, _ = post(traffic[sent % len(traffic)])
                check(code == 200, f"fleet canary: {code}")
                sent += 1
            check(not canary.active, f"fleet canary {round_}: no verdict "
                  f"after {sent} requests")
            verdicts.append(dict(round=round_, requests=sent,
                                 **canary.state(),
                                 nonfinite_logits=canary.nonfinite))
            if round_ == "nan":
                check(canary.verdict == "rollback" and canary.nonfinite > 0,
                      f"fleet canary: NaN candidate {verdicts[-1]}")
                check(read_fence(promo.directory) is None,
                      "fleet canary: the fence moved on a rollback")
                after = planes[canary_name].engine.predict(probe,
                                                           sample_seed=3)
                check(np.array_equal(before, after),
                      "fleet canary: the incumbent was not restored")
            else:
                check(canary.verdict == "promote",
                      f"fleet canary: trained candidate {verdicts[-1]}")
                check(read_fence(promo.directory)["epoch"] == 1,
                      f"fleet canary: fence {read_fence(promo.directory)}")
                check(all(planes[n].engine.params is canary._candidate
                          for n in names),
                      "fleet canary: both replicas swapped")
        check([h["action"] for h in promotion_history(promo.directory)]
              == ["rolled_back", "promoted"], "fleet: promotion history")
        emit(phase="fleet", part="canary", card=card, canary=canary_name,
             rounds=verdicts,
             fence=read_fence(promo.directory)["epoch"])

        # failover: partition 0's replica, the spare built under
        # replica:die, dies after its third request under concurrent
        # clients
        check(router.ring.candidates("part-0")[0] == victim_name,
              "fleet failover: the victim owns partition 0")
        victim = planes[spare_key]
        rep = router.replica(victim_name)
        rep.port, rep.plane = victim.port, victim
        codes = []
        lock = threading.Lock()

        def client(c):
            for i in range(FLEET_FAILOVER_REQUESTS):
                ids = traffic[(c * FLEET_FAILOVER_REQUESTS + i)
                              % len(traffic)]
                code, payload = post(ids)
                with lock:
                    codes.append(code == 200 and len(
                        payload.get("predictions", [])) == len(ids))

        retries0 = router._m_retries.value()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=FLEET_CLIENTS) as pool:
            list(pool.map(client, range(FLEET_CLIENTS)))
        failover_s = time.perf_counter() - t0
        check(victim.dead and victim._accepted == FLEET_DIE_AFTER
              and len(codes) == FLEET_CLIENTS * FLEET_FAILOVER_REQUESTS
              and all(codes),
              f"fleet failover: dead {victim.dead} after "
              f"{victim._accepted} requests; {codes.count(False)} of "
              f"{len(codes)} requests dropped")
        deadline = time.monotonic() + 30
        while router.replicas_up() != 1 and time.monotonic() < deadline:
            time.sleep(0.1)
        up = get_obs().metrics.gauge("fleet_replicas_up").value()
        check(router.replica(victim_name).state == "down" and up == 1,
              f"fleet failover: fleet_replicas_up {up}")
        forwards = sum(p.engine.forward_calls - forwards0[n]
                       for n, p in planes.items())
        launches = read_counts(wrappers)
        # engine.predict of the fixed request and the canary probes
        # are forwards too
        check(launches == {"fanout_agg": 2 * forwards, "gather_rows": 0,
                           "scatter_add_rows": 0, "tree_sample": 0},
              f"fleet: 2 fanout_agg launches per forward: {launches}, "
              f"{forwards} forwards")
        emit(phase="fleet", part="failover", card=card,
             clients=FLEET_CLIENTS, chaos=f"replica:die:{FLEET_DIE_AFTER}",
             victim=victim.name,
             requests=FLEET_CLIENTS * FLEET_FAILOVER_REQUESTS, dropped=0,
             retries=router._m_retries.value() - retries0,
             fleet_replicas_up=up, seconds=failover_s, forwards=forwards,
             launches=launches)
    finally:
        if router_plane is not None:
            router_plane.stop()
        for p in planes.values():
            p.stop()
    return launches


# ---------------------------------------------------------------- chaos
CHAOS_IDS = 20_000         # the chaos runs' epoch: 20 steps of 1000 seeds
CHAOS_K = 4                # device-sampler calls of 4 steps (captured)
CHAOS_KILL_AT = 8          # train:kill at the end of the second call
CHAOS_NAN_AT = 4           # numerics:nan after the first call
CHAOS_DIE_AT = 5           # host:die in the child, checkpoints every 2
CHAOS_SLOW_S = 0.05        # step:slow's drag a call
CHAOS_SLOW_IDS = 8_000     # its runs: 8 steps, 2 calls
CHAOS_LIVE_IDS = 40_000    # the sidecar's run: 40 steps of K = 1
CHAOS_KGE_STEPS = 50       # KGETrainer steps of each sentry run
CHAOS_PIPE_MODES = (("synchronous", None, 1), ("staged", "staged", 1),
                    ("fused_k1", "fused", 1), ("fused_k2", "fused", 2))
# the threads a run may start: sampler pipelines, the sampler pool, the
# checkpoint writer, the live sidecar and the comm watcher
CHAOS_THREADS = ("sampler", "slot-sampler", "ckpt-writer", "tpu-livez",
                 "tpu-commwatch")
# the host:die child: the setup phase's graph and a device-sampler
# SampledTrainer at the SAGE widths that checkpoints every 2 steps
CHAOS_DIE_CHILD = """
import json, sys
spec = json.loads(sys.argv[1])
sys.path.insert(0, spec["repo"])
import numpy as np
import torch
from dgl_operator_tpu_torch.graph import datasets
from dgl_operator_tpu_torch.models.sage import DistSAGE
from dgl_operator_tpu_torch.runtime.loop import SampledTrainer, TrainConfig
g = datasets.ogbn_products(seed=spec["seed"], scale=spec["scale"]).graph
ids = np.nonzero(g.ndata["train_mask"])[0][:spec["ids"]]
cfg = TrainConfig(batch_size=spec["batch"], fanouts=(10, 25), num_epochs=1,
                  eval_every=0, dropout=0.0, sampler="device",
                  ckpt_dir=spec["ckpt"], ckpt_every=2)
SampledTrainer(DistSAGE(100, 256, 47, device="cuda"), g, cfg,
               train_ids=ids).train()
print("survived", flush=True)
"""


@contextlib.contextmanager
def chaos_env(**values):
    """The environment variables ``values`` set (a value of None
    unsets one) inside the block, restored after it."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def chaos_threads() -> list:
    import threading

    return [t.name for t in threading.enumerate()
            if t.name.startswith(CHAOS_THREADS)]


def add_counts(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def chaos_sampled(torch, g, trainer, ids, device="cuda", **fields):
    """A full-width ``SampledTrainer`` over ``ids`` with the device
    sampler (dropout 0) on ``device``."""
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    cfg = TrainConfig(**{**dict(
        batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR, num_epochs=1,
        eval_every=0, dropout=0.0, sampler="device",
        steps_per_call=CHAOS_K), **fields})
    return SampledTrainer(DistSAGE(FEAT, HIDDEN, CLASSES, dropout=0.0,
                                   device=device), g, cfg, train_ids=ids,
                          device=device)


def chaos_kill(torch, args, wrappers, g, trainer, ctx, w0, work: str,
               card: str) -> dict:
    """``train:kill`` at K = 4 (captured): the flush lands at the kill
    step, a fresh trainer resumes there and ends on the uninterrupted
    run's parameters and losses bit for bit; then ``DistTrainer`` in the
    owner layout, host sampler, sampler width 2, killed mid-epoch,
    leaves no thread behind. Returns the launches."""
    from dgl_operator_tpu_torch.launcher.chaos import CHAOS_ENV
    from dgl_operator_tpu_torch.runtime.checkpoint import CheckpointManager
    from dgl_operator_tpu_torch.runtime.loop import Preempted

    ids = trainer.train_ids[:CHAOS_IDS]
    total, launches = {}, {}
    reset_counts(wrappers)
    full = chaos_sampled(torch, g, trainer, ids).train(init_params=w0)
    launches["full"] = read_counts(wrappers)
    steps = full["step"]
    ckpt = os.path.join(work, "chaos_kill")
    with chaos_env(**{CHAOS_ENV: f"train:kill:{CHAOS_KILL_AT}"}):
        reset_counts(wrappers)
        t0 = time.perf_counter()
        try:
            chaos_sampled(torch, g, trainer, ids,
                          ckpt_dir=ckpt).train(init_params=w0)
            raise RuntimeError("chaos kill: the run was not preempted")
        except Preempted as exc:
            message = str(exc)
        kill_s = time.perf_counter() - t0
        launches["killed"] = read_counts(wrappers)
        flushed = CheckpointManager(ckpt).latest_step()
        reset_counts(wrappers)
        resumed = chaos_sampled(torch, g, trainer, ids, ckpt_dir=ckpt).train()
        launches["resumed"] = read_counts(wrappers)
    check(flushed == CHAOS_KILL_AT and f"step {CHAOS_KILL_AT}" in message,
          f"chaos kill: flushed {flushed}: {message}")
    want = [x for h in full["history"] for x in h["losses"]]
    got = [x for h in resumed["history"] for x in h["losses"]]
    check(resumed["step"] == steps and got == want[CHAOS_KILL_AT:]
          and all(torch.equal(v, full["params"][k])
                  for k, v in resumed["params"].items()),
          f"chaos kill: the resumed run differs from the uninterrupted one "
          f"(steps {resumed['step']} of {steps})")
    check(launches["full"] == sage_launches(steps, device=True)
          and launches["killed"] == sage_launches(CHAOS_KILL_AT, device=True)
          and launches["resumed"] == sage_launches(steps - CHAOS_KILL_AT,
                                                   device=True),
          f"chaos kill launches: {launches}")
    for v in launches.values():
        add_counts(total, v)
    emit(phase="chaos", part="train_kill", card=card, trainer="SampledTrainer",
         sampler="device", steps_per_call=CHAOS_K, steps=steps,
         kill_at=CHAOS_KILL_AT, flushed_step=flushed,
         resumed_steps=len(got), bit_equal=True, kill_run_s=kill_s,
         graph=resumed["history"][0]["graph"], launches=launches,
         cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"))

    dist_ckpt = os.path.join(work, "chaos_kill_dist")
    tr = ctx["make"]("owner", eval_every=0, num_samplers=2,
                     ckpt_dir=dist_ckpt)
    kill = tr.steps_per_epoch // 4 + 1
    with chaos_env(**{CHAOS_ENV: f"train:kill:{kill}"}):
        reset_counts(wrappers)
        try:
            tr.train(init_params=ctx["w0"])
            raise RuntimeError("chaos kill: DistTrainer was not preempted")
        except Preempted:
            pass
        dist_launches = read_counts(wrappers)
    left = chaos_threads()
    flushed = CheckpointManager(dist_ckpt).latest_step()
    P = tr.num_parts
    check(left == [] and flushed == kill,
          f"chaos kill DistTrainer: threads {left}, flushed {flushed}")
    # the fused pipeline (K = 1) had the next batch's exchange enqueued
    exchanges = min(kill + 1, tr.steps_per_epoch)
    check(dist_launches == {"fanout_agg": 2 * P * kill,
                            "gather_rows": P * kill + exchanges,
                            "scatter_add_rows": P * kill,
                            "tree_sample": 0},
          f"chaos kill DistTrainer launches {dist_launches}")
    add_counts(total, dist_launches)
    emit(phase="chaos", part="train_kill", card=card, trainer="DistTrainer",
         layout="owner", sampler="host", num_samplers=2, kill_at=kill,
         flushed_step=flushed, threads_left=left, launches=dist_launches)
    return total


def chaos_numerics(torch, args, wrappers, g, trainer, w0, work: str,
                   card: str) -> dict:
    """``numerics:nan`` at K = 4: the card faults at the CPU's step and
    partition under the same plan, the checkpoints at or past the fault
    are quarantined, and a relaunch on the same workspace is not
    poisoned again and finishes. Returns the card's launches."""
    import numpy as np

    from dgl_operator_tpu_torch.launcher.chaos import CHAOS_ENV
    from dgl_operator_tpu_torch.obs import quality as Q
    from dgl_operator_tpu_torch.runtime.checkpoint import CheckpointManager

    ids = trainer.train_ids[:CHAOS_IDS]
    ckpt = os.path.join(work, "chaos_nan_ckpt")
    faults, launches, run_s = {}, {}, {}
    for side in ("cpu", "card"):
        ws = os.path.join(work, f"chaos_nan_{side}")
        os.makedirs(ws)
        with chaos_env(**{CHAOS_ENV: f"numerics:nan:{CHAOS_NAN_AT}",
                          Q.WORKSPACE_ENV: ws}):
            if side == "cpu":
                tr = chaos_sampled(torch, g, trainer, ids, device="cpu",
                                   quality_action="halt")
            else:
                tr = chaos_sampled(torch, g, trainer, ids, ckpt_dir=ckpt,
                                   ckpt_every=CHAOS_K)
            reset_counts(wrappers)
            t0 = time.perf_counter()
            try:
                tr.train(init_params=w0)
                raise RuntimeError(f"chaos numerics: no fault on the {side}")
            except Q.NumericsFault as exc:
                faults[side] = exc
            run_s[side] = time.perf_counter() - t0
            launches[side] = read_counts(wrappers)
            check(os.path.exists(os.path.join(ws, Q.NUMERICS_FIRED_MARKER)),
                  f"chaos numerics: no fired marker on the {side}")
    step = faults["card"].step
    check((step, faults["card"].partition, faults["card"].kind)
          == (faults["cpu"].step, faults["cpu"].partition,
              faults["cpu"].kind) and step == CHAOS_NAN_AT + CHAOS_K,
          f"chaos numerics: card fault {vars(faults['card'])} vs CPU "
          f"{vars(faults['cpu'])}")
    files = sorted(os.listdir(ckpt))
    bad = sorted(int(f[5:-8]) for f in files if f.endswith(".npz.bad"))
    survivor = CheckpointManager(ckpt).latest_step()
    check(step in bad and all(s >= step for s in bad)
          and survivor == CHAOS_NAN_AT,
          f"chaos numerics: quarantined {bad}, survivor {survivor}: {files}")
    # the relaunch: same plan and workspace, the fired marker disarms it
    ws = os.path.join(work, "chaos_nan_card")
    with chaos_env(**{CHAOS_ENV: f"numerics:nan:{CHAOS_NAN_AT}",
                      Q.WORKSPACE_ENV: ws}):
        reset_counts(wrappers)
        out = chaos_sampled(torch, g, trainer, ids, ckpt_dir=ckpt,
                            ckpt_every=CHAOS_K).train()
        launches["relaunch"] = read_counts(wrappers)
    losses = out["history"][0]["losses"]
    total = len(ids) // BATCH_TRAIN
    check(out["step"] == total and len(losses) == total - survivor
          and bool(np.isfinite(losses).all())
          and all(bool(torch.isfinite(v).all())
                  for v in out["params"].values()),
          f"chaos numerics relaunch: ended at {out['step']}")
    ran = launches["card"]["scatter_add_rows"]
    check(launches["card"] == sage_launches(ran, device=True)
          and launches["relaunch"] == sage_launches(total - survivor,
                                                    device=True),
          f"chaos numerics launches {launches}")
    emit(phase="chaos", part="numerics_nan", card=card, sampler="device",
         steps_per_call=CHAOS_K, nan_at=CHAOS_NAN_AT, fault_step=step,
         fault_partition=faults["card"].partition,
         fault_kind=faults["card"].kind, cpu_fault_step=faults["cpu"].step,
         card_steps_run=ran, quarantined=bad, survivor=survivor,
         relaunch_steps=len(losses), final_step=out["step"],
         card_s=run_s["card"], cpu_s=run_s["cpu"], launches=launches)
    return {k: launches["card"][k] + launches["relaunch"][k]
            for k in launches["card"]}


def chaos_ckpt_corrupt(torch, trainer, work: str, card: str) -> None:
    """``ckpt:corrupt``: of the trainer's state saved at steps 2 and 4
    the second is stomped after its publish; the restore falls back to
    step 2, and a later save is intact (the rule fires once)."""
    from dgl_operator_tpu_torch.launcher.chaos import CHAOS_ENV
    from dgl_operator_tpu_torch.runtime.checkpoint import (CheckpointManager,
                                                           train_state)

    d = os.path.join(work, "chaos_corrupt")
    state = train_state(trainer.model, trainer.optimizer)
    with chaos_env(**{CHAOS_ENV: "ckpt:corrupt:3"}):
        mgr = CheckpointManager(d)
        for step in (2, 4):
            mgr.save(step, state)
        step, restored = mgr.restore(None, state)
        fallback = step
        same = all(torch.equal(restored["params"][k], v)
                   for k, v in state["params"].items())
        mgr.save(6, state)
        later = mgr.restore(None, state)[0]
    check(fallback == 2 and same and later == 6,
          f"chaos ckpt:corrupt: restored {fallback}, then {later}")
    emit(phase="chaos", part="ckpt_corrupt", card=card, saved=[2, 4, 6],
         corrupted=4, restored_step=fallback, later_restore=later)


def chaos_step_slow(torch, wrappers, g, trainer, card: str) -> dict:
    """``step:slow``: the stall phase of a device-sampler run grows by
    at least the drag a call. Returns the launches."""
    from dgl_operator_tpu_torch.launcher.chaos import CHAOS_ENV

    ids = trainer.train_ids[:CHAOS_SLOW_IDS]
    recs, total = {}, {}
    for plan in (None, f"step:slow:{CHAOS_SLOW_S}"):
        with chaos_env(**{CHAOS_ENV: plan}):
            reset_counts(wrappers)
            out = chaos_sampled(torch, g, trainer, ids).train()
            add_counts(total, read_counts(wrappers))
        recs[plan is not None] = out["history"][0]
    calls = recs[True]["calls"]
    grew = recs[True].get("stall", 0.0) - recs[False].get("stall", 0.0)
    check(grew >= CHAOS_SLOW_S * calls,
          f"chaos step:slow: stall grew {grew} s over {calls} calls")
    emit(phase="chaos", part="step_slow", card=card, seconds=CHAOS_SLOW_S,
         calls=calls, stall_s_off=recs[False].get("stall", 0.0),
         stall_s_on=recs[True].get("stall", 0.0), stall_growth_s=grew,
         epoch_s_off=recs[False]["time"], epoch_s_on=recs[True]["time"])
    return total


def chaos_host_die(args, work: str, card: str) -> None:
    """``host:die`` in a child process on the card: it exits with 113
    after the dead-host marker, and no checkpoint is published past the
    last periodic one. With an obs directory the child leaves its flight
    recorder's dump (``flight-<pid>.json``, reason ``host_died``), the
    ``flight`` line."""
    from dgl_operator_tpu_torch.launcher.chaos import (CHAOS_ENV,
                                                       HOST_DIED_EXIT,
                                                       dead_hosts)
    from dgl_operator_tpu_torch.runtime.checkpoint import CheckpointManager

    ws, ckpt = (os.path.join(work, n) for n in ("chaos_die_ws",
                                                  "chaos_die_ckpt"))
    os.makedirs(ws)
    hostfile = os.path.join(work, "chaos_die_hosts")
    with open(hostfile, "w") as f:
        f.write("127.0.0.1 30050 w0 slots=1\n127.0.0.1 30051 w1 slots=1\n")
    spec = dict(repo=REPO, seed=args.seed, scale=args.scale, ckpt=ckpt,
                ids=10 * BATCH_TRAIN, batch=BATCH_TRAIN)
    obs_dir = os.path.join(work, "chaos_die_obs")
    env = dict(os.environ, TPU_OPERATOR_CHAOS=f"host:die:{CHAOS_DIE_AT}"
               "@host=w1", TPU_OPERATOR_WORKSPACE=ws,
               TPU_OPERATOR_HOSTFILE_PATH=hostfile, TPU_OPERATOR_RANK="1",
               TPU_OPERATOR_OBS_DIR=obs_dir)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CHAOS_DIE_CHILD,
                           json.dumps(spec)], env=env, capture_output=True,
                          text=True, timeout=MP_CHILD_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    # the periodic checkpoint of step 4 may still have been in its
    # writer when the process vanished; nothing past it may exist
    latest = CheckpointManager(ckpt).latest_step()
    check(proc.returncode == HOST_DIED_EXIT
          and "survived" not in proc.stdout
          and dead_hosts(ws) == ["w1"] and latest in (2, 4),
          f"chaos host:die: exit {proc.returncode}, dead {dead_hosts(ws)}, "
          f"latest checkpoint {latest}: {proc.stderr[-2000:]}")
    emit(phase="chaos", part="host_die", card=card, die_at=CHAOS_DIE_AT,
         exit_code=proc.returncode, dead_hosts=dead_hosts(ws),
         latest_checkpoint=latest, child_s=child_s)
    flights = sorted(f for f in os.listdir(obs_dir)
                     if f.startswith("flight-"))
    check(len(flights) == 1, f"flight: the host:die child's dumps {flights}")
    with open(os.path.join(obs_dir, flights[0])) as f:
        dump = json.load(f)
    beats = [x for x in dump["samples"] if x["kind"] == "heartbeat"]
    check(dump["reason"] == "host_died" and beats
          and beats[-1]["step"] == CHAOS_DIE_AT,
          f"flight: reason {dump['reason']}, heartbeats "
          f"{[x['step'] for x in beats]}")
    died = [e for e in read_jsonl(os.path.join(obs_dir, "events.jsonl"))
            if e["event"] == "host_died"]
    check(len(died) == 1 and died[0]["pid"] == dump["pid"],
          f"flight: host_died events {died}")
    emit(phase="flight", card=card, file=flights[0], reason=dump["reason"],
         pid=dump["pid"], samples=len(dump["samples"]),
         last_heartbeat_step=beats[-1]["step"], inflight=dump["inflight"],
         window_s=dump["window_s"])


def chaos_live(torch, wrappers, g, trainer, card: str) -> dict:
    """The live sidecar: ``TPU_OPERATOR_LIVE_PORT=0`` during a 40-step
    run, ``/livez`` polled from a thread shows the step advancing and a
    heartbeat rate above 0, and reads done after the run; then the host
    ms of one heartbeat. Returns the launches."""
    import threading
    import urllib.request

    from dgl_operator_tpu_torch.obs import live
    from dgl_operator_tpu_torch.runtime.loop import heartbeat

    polls, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            sc = live._sidecar
            if sc is not None:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{sc.port}/livez",
                        timeout=10) as r:
                    polls.append(json.loads(r.read()))
            stop.wait(0.005)

    ids = trainer.train_ids[:CHAOS_LIVE_IDS]
    live.reset_feed()
    poller = threading.Thread(target=poll, name="chaos-livez-poll")
    with chaos_env(**{live.LIVE_PORT_ENV: 0}):
        tr = chaos_sampled(torch, g, trainer, ids, steps_per_call=1)
        reset_counts(wrappers)
        poller.start()
        try:
            out = tr.train()
        finally:
            stop.set()
            poller.join(timeout=30)
        launches = read_counts(wrappers)
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{live._sidecar.port}/livez",
                    timeout=10) as r:
                after = json.loads(r.read())
        finally:
            live.stop_sidecar()
    steps = [p["step"] for p in polls if p["step"] is not None]
    rates = [p["heartbeat_hz"] for p in polls if p["heartbeat_hz"]]
    check(not poller.is_alive() and len(set(steps)) >= 2
          and steps == sorted(steps) and rates and max(rates) > 0,
          f"chaos live: /livez steps {steps[:5]}..{steps[-5:]}, "
          f"heartbeat_hz {rates[-3:]}")
    check(after["done"] and after["step"] == out["step"],
          f"chaos live: after the run {after}")
    check(launches == sage_launches(out["step"], device=True),
          f"chaos live launches {launches}")
    # one heartbeat (gauges, an event, a tick of the feed) with the
    # run's timer, as the loop calls it after every call
    hb_ms = host_ms(lambda: heartbeat(out["step"], 0, tr.timer, sps=1.0,
                                      loss=0.5, grad_norm=1.0), 1000)
    emit(phase="chaos", part="live", card=card, steps=out["step"],
         heartbeat_ms=hb_ms,
         polls=len(polls), distinct_steps=len(set(steps)),
         first_step=steps[0], last_polled_step=steps[-1],
         heartbeat_hz_max=max(rates), after_done=after["done"],
         after_step=after["step"], stall_frac=after["stall_frac"],
         loss=after["loss"])
    return launches


def chaos_kge(torch, args, wrappers, ds, card: str) -> dict:
    """The KGE sentry at the job's width on synthetic FB15k at full
    size: ``KGETrainer`` for ``CHAOS_KGE_STEPS`` steps with the sentry
    off and on (order off, on, on, off): bit-equal, launches checked,
    ms a step; one synced step's stats against the CPU's; and a NaN
    entity row, first read by step 3, faults the card at the CPU's
    step. Returns the launches."""
    import numpy as np

    from dgl_operator_tpu_torch.graph.kge_sampler import TrainDataset
    from dgl_operator_tpu_torch.obs.quality import NumericsFault
    from dgl_operator_tpu_torch.runtime.kge import KGETrainer

    td = TrainDataset(ds.train, ds.n_entities, ds.n_relations, ranks=1)
    runs, total = {False: [], True: []}, {}
    sd0 = None
    for sentry in (False, True, True, False):
        tr = KGETrainer(*kge_configs(ds, args.seed, max_step=CHAOS_KGE_STEPS,
                                     sentry=sentry), device="cuda")
        sd0 = sd0 or tr.state_dict()
        reset_counts(wrappers)
        out = tr.train(td)
        launches = read_counts(wrappers)
        check(launches == {"fanout_agg": 0,
                           "gather_rows": 2 * CHAOS_KGE_STEPS,
                           "scatter_add_rows": 2 * CHAOS_KGE_STEPS,
                           "tree_sample": 0},
              f"chaos kge sentry={sentry}: {launches}")
        add_counts(total, launches)
        runs[sentry].append((out, tr.state_dict(), tr.last_stats))
    ref_out, ref_sd, _ = runs[False][0]
    for sentry, rs in runs.items():
        for out, sd, _ in rs:
            check(out["losses"] == ref_out["losses"]
                  and all(np.array_equal(sd[k], ref_sd[k]) for k in sd),
                  f"chaos kge: the run with the sentry "
                  f"{'on' if sentry else 'off'} differs")
    # train_time_s ends in the sync of the losses' fetch
    ms = {s: [out["train_time_s"] * 1e3 / CHAOS_KGE_STEPS
              for out, _, _ in rs] for s, rs in runs.items()}
    off, on = float(np.mean(ms[False])), float(np.mean(ms[True]))
    last = {k: v.tolist() for k, v in runs[True][0][2].items()}

    # one synced step: the card and the CPU from the same tables
    it = kge_stream(td, 0, (args.seed + 20, args.seed + 21))
    batch = next(it)
    stats = {}
    for dev in ("cuda", "cpu"):
        tr = KGETrainer(*kge_configs(ds, args.seed), device=dev)
        tr.load_state_dict(sd0)
        tr.device_step(tr.host_step([batch]))
        stats[dev] = {k: np.asarray(v.cpu(), np.float64)
                      for k, v in tr.last_stats.items()}
    rel = {k: float(np.max(np.abs(stats["cuda"][k] - stats["cpu"][k])
                           / np.maximum(np.abs(stats["cpu"][k]), 1e-30)))
           for k in ("grad_norm", "part_loss")}
    check(max(rel.values()) <= SENTRY_STATS_TOL
          and stats["cuda"]["nonfinite"] == stats["cpu"]["nonfinite"] == 0,
          f"chaos kge stats card vs CPU: {rel}")

    # the NaN drill: a row the stream first reads at step 3
    it = kge_stream(td, 0, (args.seed, args.seed + 1))
    seen = [set(np.concatenate([b.h, b.t, b.neg_ids.reshape(-1)]).tolist())
            for b in (next(it) for _ in range(3))]
    row = min(seen[2] - seen[0] - seen[1])
    sd = {k: np.array(v, copy=True) for k, v in sd0.items()}
    sd["entity"][row] = np.nan
    faults = {}
    for dev in ("cpu", "cuda"):
        tr = KGETrainer(*kge_configs(ds, args.seed, max_step=CHAOS_KGE_STEPS,
                                     quality_action="halt"), device=dev)
        tr.load_state_dict(sd)
        reset_counts(wrappers)
        try:
            tr.train(td)
            raise RuntimeError(f"chaos kge drill: no fault on {dev}")
        except NumericsFault as exc:
            faults[dev] = exc
        if dev == "cuda":
            add_counts(total, read_counts(wrappers))
    check((faults["cuda"].step, faults["cuda"].partition)
          == (faults["cpu"].step, faults["cpu"].partition)
          and faults["cuda"].step == 3,
          f"chaos kge drill: card {vars(faults['cuda'])} vs CPU "
          f"{vars(faults['cpu'])}")
    emit(phase="chaos", part="kge_sentry", card=card, model="ComplEx",
         dim=KGE_DIM, steps=CHAOS_KGE_STEPS, order="off,on,on,off",
         bit_equal=True, ms_per_step_off=ms[False], ms_per_step_on=ms[True],
         off_ms_mean=off, on_ms_mean=on, overhead_ms=on - off,
         overhead=(on - off) / off, last_stats=last,
         stats_rel_err_to_cpu=rel, nan_row=row,
         fault_step=faults["cuda"].step,
         fault_partition=faults["cuda"].partition,
         cpu_fault_step=faults["cpu"].step)
    return total


def chaos_pipeline(torch, wrappers, ctx, card: str) -> dict:
    """The overlap pipeline: ``DistTrainer`` in the owner layout with the
    host sampler, 20 steps synchronous (the exchange in the step),
    ``staged``, and ``fused`` at K = 1 and 2: losses and parameters
    bit-equal, launches checked, the step time and ``overlap_ratio`` of
    each. Returns the launches."""
    import numpy as np

    tr = ctx["make"]("owner", eval_every=0)
    P, total, runs = tr.num_parts, {}, {}
    for name, mode, depth in CHAOS_PIPE_MODES:
        tr._pipelined = mode is not None
        if mode is not None:
            tr.cfg = dataclasses.replace(tr.cfg, pipeline_mode=mode,
                                         pipeline_depth=depth)
        reset_counts(wrappers)
        t0 = time.perf_counter()
        out = tr.train(init_params=ctx["w0"])
        wall = time.perf_counter() - t0
        launches = read_counts(wrappers)
        steps = out["step"]
        check(launches == {"fanout_agg": 2 * P * steps,
                           "gather_rows": (P + 1) * steps,
                           "scatter_add_rows": P * steps, "tree_sample": 0},
              f"chaos pipeline {name}: {launches} in {steps} steps")
        add_counts(total, launches)
        runs[name] = (out, wall, launches)
    ref = runs["synchronous"][0]
    for name, (out, _, _) in runs.items():
        check(out["history"][0]["losses"] == ref["history"][0]["losses"]
              and all(torch.equal(v, ref["params"][k])
                      for k, v in out["params"].items()),
              f"chaos pipeline: {name} differs from the synchronous run")
    emit(phase="chaos", part="pipeline", card=card, layout="owner",
         sampler="host", steps=ref["step"], bit_equal=True,
         runs={name: dict(
             mode=mode, depth=depth,
             overlap_ratio=runs[name][0]["history"][0].get("overlap_ratio"),
             step_ms_mean=float(np.mean(runs[name][0]["history"][0]
                                        ["step_s"])) * 1e3,
             epoch_s=runs[name][0]["history"][0]["time"],
             stall_ms_per_step=runs[name][0]["history"][0].get("stall", 0.0)
             * 1e3 / ref["step"], wall_s=runs[name][1],
             launches=runs[name][2])
             for name, mode, depth in CHAOS_PIPE_MODES})
    return total


def chaos_phase(torch, args, wrappers, g, trainer, ctx, kg, work: str,
                card: str) -> dict:
    """The chaos, preemption and live planes on the SAGE cell's graph
    and widths, the KGE sentry and the overlap pipeline. Returns the
    launches of its card runs."""
    from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                    state_dict_to_flax)

    t0 = time.perf_counter()
    w0 = state_dict_to_flax(DistSAGE(
        FEAT, HIDDEN, CLASSES, device="cpu",
        generator=torch.Generator().manual_seed(args.seed + 9)).state_dict())
    total = {}
    add_counts(total, chaos_kill(torch, args, wrappers, g, trainer, ctx, w0,
                                 work, card))
    add_counts(total, chaos_numerics(torch, args, wrappers, g, trainer, w0,
                                     work, card))
    chaos_ckpt_corrupt(torch, trainer, work, card)
    add_counts(total, chaos_step_slow(torch, wrappers, g, trainer, card))
    chaos_host_die(args, work, card)
    add_counts(total, chaos_live(torch, wrappers, g, trainer, card))
    add_counts(total, chaos_kge(torch, args, wrappers, kg, card))
    add_counts(total, chaos_pipeline(torch, wrappers, ctx, card))
    check(chaos_threads() == [], f"chaos: threads left {chaos_threads()}")
    emit(phase="chaos", part="done", card=card,
         seconds=time.perf_counter() - t0, launches=total)
    return total


DP_BUDGET_MB = 64      # the ooc book's working-set budget (MiB)
DP_STEPS = 16          # bf16 and remat SampledTrainer runs: 16 steps
DP_LOSS_REL = 0.10     # int8 losses against the float32 book's, relative
# bfloat16 keeps 8 significant bits (unit roundoff 2^-8); a sampled
# layer rounds its input, its aggregate, its two GEMM outputs and their
# sum: about 4 roundings a layer, so an L-layer bfloat16 forward may part
# from the float32 one by up to 4 * L * 2^-8 of the largest logit
BF16_U = 2.0 ** -8


def bf16_tol(num_layers: int, ref_max: float) -> float:
    return 4 * num_layers * BF16_U * max(1.0, ref_max)


def same_npz(a: str, b: str, drop=()) -> bool:
    """Two npz files hold the same arrays, dtypes included (but the
    keys in ``drop``)."""
    import numpy as np

    with np.load(a) as za, np.load(b) as zb:
        fa = sorted(set(za.files) - set(drop))
        return fa == sorted(set(zb.files) - set(drop)) and all(
            za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])
            for k in fa)


def dataplane_book(torch, args, g, work: str, card: str) -> str:
    """The serve phase's graph written again by ``partition_graph(ooc=
    True, ooc_budget_mb=64, feat_dtype="int8")``: the same multilevel
    assignment at the same seed, so its maps, every ``graph.npz`` array
    (the halo manifest among them), its labels and masks and its JSON
    but the feature entries must equal the serve phase's book byte for
    byte. Returns the int8 book's JSON path."""
    import filecmp

    import numpy as np

    from dgl_operator_tpu_torch.graph.partition import partition_graph

    base, book = os.path.join(work, "book"), os.path.join(work, "book_int8")
    t0 = time.perf_counter()
    cfg = partition_graph(g, "ogbn-products", 2, book, ooc=True,
                          ooc_budget_mb=DP_BUDGET_MB, feat_dtype="int8")
    ooc_s = time.perf_counter() - t0
    for name in ("node_map.npy", "edge_map.npy"):
        check(filecmp.cmp(os.path.join(base, name), os.path.join(book, name),
                          shallow=False), f"dataplane book: {name} differs")
    metas = []
    for d in (base, book):
        with open(os.path.join(d, "ogbn-products.json")) as f:
            m = json.load(f)
        for key in ("feat_quant", "feat_files", "ooc_spill_mib"):
            m.pop(key, None)
        for p in range(2):
            m[f"part-{p}"].pop("node_feat_files", None)
        metas.append(m)
    check(metas[0] == metas[1], "dataplane book: the JSON differs")
    code_bytes, float_bytes = 0, 0
    for p in range(2):
        for name in ("graph.npz", "edge_feat.npz"):
            check(same_npz(os.path.join(base, f"part{p}", name),
                           os.path.join(book, f"part{p}", name)),
                  f"dataplane book: part{p}/{name} differs")
        check(same_npz(os.path.join(base, f"part{p}", "node_feat.npz"),
                       os.path.join(book, f"part{p}", "node_feat.npz"),
                       drop=("feat",)),
              f"dataplane book: part{p} labels or masks differ")
        codes = np.load(os.path.join(book, f"part{p}", "node_feat.feat.npy"),
                        mmap_mode="r")
        check(codes.dtype == np.int8 and codes.shape[1] == FEAT,
              f"dataplane book: part{p} codes {codes.dtype} {codes.shape}")
        code_bytes += os.path.getsize(os.path.join(
            book, f"part{p}", "node_feat.feat.npy"))
        with np.load(os.path.join(base, f"part{p}", "node_feat.npz")) as z:
            float_bytes += int(z["feat"].nbytes)
    with open(cfg) as f:
        meta = json.load(f)
    emit(phase="dataplane", part="book", card=card, parts=2,
         ooc_budget_mb=DP_BUDGET_MB, feat_dtype="int8",
         byte_equal_to_serve_book=True, ooc_partition_s=ooc_s,
         serve_partition_s=LAST["serve"]["partition_s"],
         ooc_spill_mib=meta["ooc_spill_mib"],
         code_file_bytes=code_bytes, float32_feat_bytes=float_bytes,
         bytes_ratio=float_bytes / code_bytes)
    return cfg


def dataplane_train(torch, args, ops, wrappers, ctx, work: str, card: str):
    """``DistTrainer`` on an int8 book of the dist phase's cut (the same
    assignment): the owner layout with the host sampler (the fused
    exchange pipeline) and the device sampler at K = 4 (captured), each
    with an int8 store and with a float32 store of the host-dequantized
    codes, bit-equal; the replicated layout with an int8 store (its
    losses within 1e-6 of the owner's, as in the dist phase); a
    bfloat16 store of the float book; the int8 losses within 10% of the
    float book's float32 run; ``kernel`` lines of the gather on the int8
    store. Returns the launches and the kernel records."""
    import numpy as np

    from dgl_operator_tpu_torch.graph.partition import partition_graph
    from dgl_operator_tpu_torch.models.sage import DistSAGE
    from dgl_operator_tpu_torch.parallel.halo import exchange_index
    from dgl_operator_tpu_torch.runtime.dist import DistTrainer
    from dgl_operator_tpu_torch.runtime.loop import TrainConfig

    t0 = time.perf_counter()
    book8 = partition_graph(ctx["cut"], "ogbn-products", 2,
                            os.path.join(work, "dist_book_int8"),
                            parts=ctx["node_map"], feat_dtype="int8")
    book_s = time.perf_counter() - t0
    P, w0, total = 2, ctx["w0"], {}

    def make(book, layout, fdt, **fields):
        cfg = TrainConfig(**{**dict(
            num_epochs=1, batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
            eval_every=0, seed=args.seed, cap_policy="auto",
            feats_layout=layout, halo_cache_frac=0.25, feat_dtype=fdt),
            **fields})
        return DistTrainer(DistSAGE(FEAT, HIDDEN, CLASSES, device="cuda"),
                           book, cfg, device="cuda")

    def run(name, book, layout, fdt, k=1):
        fields = (dict(sampler="device", steps_per_call=k) if k > 1
                  else {})
        tr = make(book, layout, fdt, **fields)
        # the main path: every kernel count starts at 0 here
        reset_counts(wrappers)
        t0 = time.perf_counter()
        out = tr.train(init_params=w0)
        wall = time.perf_counter() - t0
        launches = read_counts(wrappers)
        steps, rec = out["step"], out["history"][0]
        gathers = (P if layout == "replicated" else
                   1 if k > 1 else P + 1)
        check(launches == {"fanout_agg": 2 * P * steps,
                           "gather_rows": gathers * steps,
                           "scatter_add_rows": P * steps,
                           "tree_sample": (tree_launches(P * steps) if k > 1
                                           else 0)},
              f"dataplane {name}: {launches} in {steps} steps")
        check(steps == DIST_IDS_PER_PART // BATCH_TRAIN, f"{name}: {steps}")
        check(bool(np.isfinite(rec["losses"]).all()), f"{name}: losses")
        add_counts(total, launches)
        step_ms = np.asarray(rec["step_s"]) * 1e3
        numbers = (device_run_record(rec, steps, k) if k > 1 else dict(
            step_ms_mean=float(step_ms.mean()),
            step_ms_p50=float(np.percentile(step_ms, 50)),
            stall_ms_per_step=rec.get("stall", 0.0) * 1e3 / steps))
        return tr, out, dict(
            layout=layout, feat_dtype=fdt, store_dtype=str(tr.feats.dtype),
            sampler="device" if k > 1 else "host", steps_per_call=k,
            steps=steps, launches=launches,
            data_feat_mib_per_slot=tr.data_feat_mib_per_slot,
            exchange_bytes_per_step=tr.exchange_bytes_per_step,
            halo_rows_per_step=rec.get("halo_rows_per_step"),
            h2d_bytes_per_step=rec["h2d_bytes_per_step"],
            overlap_ratio=rec.get("overlap_ratio"), losses=rec["losses"],
            train_call_s=wall, **numbers)

    runs = {}
    for name, book, layout, fdt, k in (
            ("owner_int8_host", book8, "owner", "int8", 1),
            ("owner_float32_host", book8, "owner", "float32", 1),
            ("owner_int8_device_k4", book8, "owner", "int8", DEV_K),
            ("owner_float32_device_k4", book8, "owner", "float32", DEV_K),
            ("replicated_int8_host", book8, "replicated", "int8", 1),
            ("owner_bfloat16_host", ctx["book"], "owner", "bfloat16", 1)):
        runs[name] = run(name, book, layout, fdt, k)
    gaps = {}
    for a, b in (("owner_int8_host", "owner_float32_host"),
                 ("owner_int8_device_k4", "owner_float32_device_k4")):
        oa, ob = runs[a][1], runs[b][1]
        la, lb = oa["history"][0]["losses"], ob["history"][0]["losses"]
        gaps[a] = float(np.max(np.abs(np.subtract(la, lb))))
        check(la == lb and all(torch.equal(v, ob["params"][k])
                               for k, v in oa["params"].items()),
              f"dataplane {a} against {b}: largest loss gap {gaps[a]}")
    own, rep = (runs[n][1]["history"][0]["losses"]
                for n in ("owner_int8_host", "replicated_int8_host"))
    rep_rel = float(np.max(np.abs(np.subtract(own, rep)) / np.abs(own)))
    check(rep_rel <= 1e-6, f"dataplane: replicated int8 {rep_rel} from owner")
    flat = ctx["want"]["owner"][1]
    flat_rel = float(np.max(np.abs(np.subtract(own, flat)) / np.abs(flat)))
    check(flat_rel <= DP_LOSS_REL, f"dataplane: int8 losses {own} vs the "
          f"float32 book's {flat}: relative {flat_rel} > {DP_LOSS_REL}")
    bf = runs["owner_bfloat16_host"][1]["history"][0]["losses"]
    check(np.mean(bf[-5:]) < np.mean(bf[:5]), f"bfloat16 store: {bf}")
    for name, (_, _, rec) in runs.items():
        emit(phase="dataplane", part="train", run=name, card=card, **rec)
    emit(phase="dataplane", part="train_compare", card=card, book_s=book_s,
         int8_vs_float32_store_max_loss_gap=gaps, bit_equal=True,
         replicated_vs_owner_rel=rep_rel,
         int8_vs_float32_book_max_rel=flat_rel, limit=DP_LOSS_REL,
         float32_book_losses=flat)

    # the gather on the int8 stores at this path's shapes
    fanout, gather, scatter = ops
    rep8, own8 = (runs[n][0] for n in ("replicated_int8_host",
                                       "owner_int8_host"))
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    rng = np.random.default_rng(args.seed + 5)
    perm = [rng.permutation(t) for t in rep8.train_ids]
    rslots, _ = rep8.ship(rep8._sample_all(perm, 0, 20_000)[0])
    oslots, serve = own8.ship(own8._sample_all(perm, 0, 20_000)[0])
    inputs = rslots[0]["inputs"]
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 6)
    wide = torch.randint(-127, 128, (rep8.n_pad, 602), device="cuda",
                         generator=gen, dtype=torch.int8)
    check(rep8.feats.dtype == own8._flat.dtype == torch.int8,
          "dataplane: int8 stores")
    records = gather_records(torch, gather, [
        ("dataplane_slot_inputs", rep8.feats[0], inputs),
        ("dataplane_owner_local", own8.feats[0], oslots[0]["exch_loc"]),
        ("dataplane_exchange", own8._flat,
         exchange_index(serve, own8._rows_per_slot)),
        ("dataplane_d602", wide, inputs),
    ], flush, args.iters, card)
    records += gather_records(torch, gather, [
        ("dataplane_uint8_d100", rep8.feats[0].view(torch.uint8), inputs),
        ("dataplane_uint8_d602", wide.view(torch.uint8), inputs),
        ("dataplane_d37", wide[:, :37].contiguous(), inputs),
        ("dataplane_d1024", torch.randint(
            -127, 128, (4096, 1024), device="cuda", generator=gen,
            dtype=torch.int8), inputs % 4096),
    ], flush, args.iters, card, timed=False)
    return total, records


def dataplane_serve(torch, args, wrappers, g, cfg8: str, node_map,
                    work: str, card: str) -> dict:
    """``ServeEngine`` on the int8 book answers the serve phase's
    requests: every request's logits bit-equal to an engine on a float32
    book of the dequantized codes (the same sample seeds), then the
    requests through the ``MicroBatcher`` for p50 and p99, with the
    stores' resident and backing MiB and the rows paged. Returns the
    launches."""
    import numpy as np

    from dgl_operator_tpu_torch.graph import quant
    from dgl_operator_tpu_torch.graph.graph import Graph
    from dgl_operator_tpu_torch.graph.partition import (GraphPartition,
                                                         partition_graph)
    from dgl_operator_tpu_torch.models.sage import (DistSAGE,
                                                    state_dict_to_flax)
    from dgl_operator_tpu_torch.runtime.checkpoint import export_for_serving
    from dgl_operator_tpu_torch.serve.engine import ServeConfig, ServeEngine

    sc = GraphPartition(cfg8, 0).feat_sidecar("feat")
    deq = Graph(g.src, g.dst, g.num_nodes)
    deq.ndata = {**g.ndata, "feat": quant.dequantize(quant.quantize(
        g.ndata["feat"], sc["scale"], sc["zero"], "int8"), sc["scale"],
        sc["zero"])}
    cfgf = partition_graph(deq, "ogbn-products", 2,
                           os.path.join(work, "book_dequant"),
                           parts=node_map)
    del deq
    model = DistSAGE(FEAT, HIDDEN, CLASSES, device="cuda",
                     generator=torch.Generator().manual_seed(args.seed))
    export = export_for_serving(os.path.join(work, "export_dp") + os.sep,
                                state_dict_to_flax(model.state_dict()))
    cfg = ServeConfig(fanouts=FANOUTS, batch_size=BATCH,
                      halo_cache_frac=0.25, cap_policy="worst")
    eng8, engf = (ServeEngine(DistSAGE(FEAT, HIDDEN, CLASSES, device="cuda"),
                              c, params_path=export, cfg=cfg, device="cuda")
                  for c in (cfg8, cfgf))
    check(eng8.feat_dtype == "int8" and engf.feat_dtype == "float32",
          f"dataplane serve: stores {eng8.feat_dtype}, {engf.feat_dtype}")
    requests = fleet_requests(args, g)
    for i, ids in enumerate(requests):
        a = eng8.predict_logits(ids, sample_seed=i)
        b = engf.predict_logits(ids, sample_seed=i)
        check(np.array_equal(a, b) and np.isfinite(a).all(),
              f"dataplane serve: request {i} logits differ, max "
              f"{float(np.abs(a - b).max())}")
    lat_ms = []
    # the main path: every kernel count starts at 0 here
    reset_counts(wrappers)
    forwards0 = eng8.forward_calls
    batcher = eng8.make_batcher()
    try:
        for ids in requests:
            t = time.perf_counter()
            pred = batcher.submit(ids).result(timeout=120)
            lat_ms.append((time.perf_counter() - t) * 1e3)
            check(pred.shape == ids.shape and pred.min() >= 0
                  and pred.max() < CLASSES, "dataplane serve: classes")
    finally:
        batcher.stop()
    launches = read_counts(wrappers)
    forwards = eng8.forward_calls - forwards0
    check(launches == {"fanout_agg": 2 * forwards, "gather_rows": 0,
                       "scatter_add_rows": 0, "tree_sample": 0},
          f"dataplane serve: {launches} in {forwards} forwards")
    st8, stf = eng8.stats(), engf.stats()
    lat = np.asarray(lat_ms)
    emit(phase="dataplane", part="serve", card=card, requests=len(requests),
         logits_bit_equal_to_dequantized_float32_book=True,
         forwards=forwards, launches=launches, feat_dtype=st8["feat_dtype"],
         resident_mib=st8["feat_resident_mib"],
         backing_mib=st8["feat_backing_mib"],
         paged_rows=st8["feat_paged_rows"],
         float32_resident_mib=stf["feat_resident_mib"],
         float32_backing_mib=stf["feat_backing_mib"],
         p50_ms=float(np.percentile(lat, 50)),
         p99_ms=float(np.percentile(lat, 99)),
         serve_phase_p50_ms=LAST["serve"]["p50_ms"],
         serve_phase_p99_ms=LAST["serve"]["p99_ms"])
    return launches


def dp_model(torch, kind: str, seed: int, **kw):
    """A full-width ``DistSAGE`` or ``DistGAT`` on the card."""
    from dgl_operator_tpu_torch.models import DistGAT, DistSAGE

    gen = torch.Generator().manual_seed(seed)
    if kind == "gat":
        return DistGAT(FEAT, HIDDEN, CLASSES, num_heads=GAT_HEADS,
                       device="cuda", generator=gen, **kw)
    return DistSAGE(FEAT, HIDDEN, CLASSES, device="cuda", generator=gen, **kw)


def dp_launches(kind: str, steps: int, slots: int = 1, warm: int = 1,
                device: bool = False):
    if kind == "gat":
        return gat_launches(kind, steps, slots=slots, warm=warm,
                            device=device)
    return {"fanout_agg": 2 * (steps * slots + warm),
            "gather_rows": steps * slots + warm,
            "scatter_add_rows": steps * slots,
            "tree_sample": (tree_launches(steps * slots + warm) if device
                            else 0)}


def dataplane_bf16(torch, args, wrappers, g, trainer, ctx, work: str,
                   card: str) -> dict:
    """``compute_dtype="bfloat16"`` against float32 from the same
    weights: ``DistSAGE`` and ``DistGAT`` through ``SampledTrainer``
    (host sampler, and the device sampler at K = 4), 16 steps each, the
    loss falling and the steady ms a step of both; one batch's logits
    within the bfloat16 bound (:func:`bf16_tol`) of the float32
    logits; then ``examples/train_dist.py --bf16`` for both stacks over
    the dist phase's book. Returns the launches."""
    import numpy as np

    from dgl_operator_tpu_torch.examples import train_dist
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    ids = trainer.train_ids[:DP_STEPS * BATCH_TRAIN]
    mb = trainer.sample(ids[:BATCH_TRAIN], 0)
    h = torch.from_numpy(g.ndata["feat"][mb.input_nodes]).to("cuda")
    blocks = [b.to("cuda") for b in mb.blocks]
    total = {}
    for kind in ("sage", "gat"):
        sd = dp_model(torch, kind, args.seed + 11).state_dict()
        logits = {}
        for dtype in (None, "bfloat16"):
            m = dp_model(torch, kind, args.seed, compute_dtype=dtype)
            m.load_state_dict(sd)
            m.eval()
            with torch.no_grad():
                logits[dtype] = m(blocks, h)
        ref = logits[None]
        gap = float((logits["bfloat16"] - ref).abs().max())
        tol = bf16_tol(2, float(ref.abs().max()))
        check(logits["bfloat16"].dtype == torch.float32 and gap <= tol,
              f"bf16 {kind}: logits {gap} from float32 > {tol}")
        check(gap > 0, f"bf16 {kind}: no bfloat16 rounding seen")
        rows = {}
        for sampler, k in (("host", 1), ("device", DEV_K)):
            for dtype in (None, "bfloat16"):
                m = dp_model(torch, kind, args.seed, compute_dtype=dtype)
                m.load_state_dict(sd)
                cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS,
                                  lr=LR, num_epochs=1, eval_every=0,
                                  seed=args.seed, sampler=sampler,
                                  steps_per_call=k)
                tr = SampledTrainer(m, g, cfg, train_ids=ids, device="cuda")
                reset_counts(wrappers)
                out = tr.train()
                launches = read_counts(wrappers)
                steps, rec = out["step"], out["history"][0]
                losses = rec["losses"]
                check(steps == DP_STEPS and launches == dp_launches(
                    kind, steps, device=sampler == "device"),
                    f"bf16 {kind} {sampler} {dtype}: "
                    f"{launches} in {steps} steps")
                check(bool(np.isfinite(losses).all())
                      and np.mean(losses[-4:]) < np.mean(losses[:4]),
                      f"bf16 {kind} {sampler} {dtype}: losses {losses}")
                add_counts(total, launches)
                rows[f"{sampler}_k{k}_{dtype or 'float32'}"] = dict(
                    loss_first4=float(np.mean(losses[:4])),
                    loss_last4=float(np.mean(losses[-4:])),
                    **device_run_record(rec, steps, k))
        emit(phase="dataplane", part="bf16", kind=kind, card=card,
             steps=DP_STEPS, logits_max_abs_gap=gap, logits_tol=tol,
             runs=rows)
    hostfile = os.path.join(work, "hostfile_dp")
    with open(hostfile, "w") as f:
        f.write(f"127.0.0.1 {free_port()} worker-0 slots=1\n")
    for kind in ("sage", "gat"):
        argv = ["--graph_name", "ogbn-products", "--ip_config", hostfile,
                "--part_config", ctx["book"], "--num_epochs", "1",
                "--batch_size", str(BATCH_TRAIN), "--fan_out", "10,25",
                "--num_hidden", str(HIDDEN), "--eval_every", "0",
                "--model", kind, "--bf16", "--device", "cuda"]
        reset_counts(wrappers)
        t0 = time.perf_counter()
        out = train_dist.main(argv)
        wall = time.perf_counter() - t0
        launches = read_counts(wrappers)
        steps, losses = out["step"], out["history"][0]["losses"]
        want = (dp_launches(kind, steps, slots=2, warm=0) if kind == "gat"
                else {"fanout_agg": 4 * steps, "gather_rows": 2 * steps,
                      "scatter_add_rows": 2 * steps, "tree_sample": 0})
        check(launches == want, f"train_dist --bf16 {kind}: {launches}")
        check(bool(np.isfinite(losses).all())
              and np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"train_dist --bf16 {kind}: losses {losses}")
        add_counts(total, launches)
        emit(phase="dataplane", part="bf16_entry_point", kind=kind,
             card=card, steps=steps, launches=launches, losses=losses,
             step_ms_mean=float(np.mean(out["history"][0]["step_s"]))
             * 1e3, train_call_s=wall)
    return total


def dataplane_remat(torch, args, wrappers, g, trainer, card: str) -> dict:
    """``remat=True`` on ``DistSAGE``: one step's loss and gradients
    (dropout 0.5, the masks from one seeded generator) bit-equal to the
    plain stack's; then ``SampledTrainer`` at host K = 1 and device
    K = 4 (captured: the recompute runs inside the graph), remat off and
    on, bit-equal (the remat runs launch two more aggregations a step,
    the recompute), with the peak device memory and steady ms of each.
    Returns the launches."""
    import numpy as np

    from dgl_operator_tpu_torch.runtime.forward import masked_loss
    from dgl_operator_tpu_torch.runtime.loop import (SampledTrainer,
                                                     TrainConfig)

    ids = trainer.train_ids[:DP_STEPS * BATCH_TRAIN]
    sd = dp_model(torch, "sage", args.seed + 13).state_dict()
    mb = trainer.sample(ids[:BATCH_TRAIN], 1)
    h = torch.from_numpy(g.ndata["feat"][mb.input_nodes]).to("cuda")
    labels = torch.from_numpy(np.asarray(g.ndata["label"],
                                         np.int64)).to("cuda")
    seeds = torch.from_numpy(np.asarray(mb.seeds, np.int64)).to("cuda")
    grads = []
    for remat in (False, True):
        m = dp_model(torch, "sage", args.seed, remat=remat)
        m.load_state_dict(sd)
        m.train()
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 3)
        loss = masked_loss(m([b.to("cuda") for b in mb.blocks], h, gen),
                           labels, seeds)[0]
        loss.backward()
        grads.append((loss.detach(), {k: p.grad for k, p in
                                      m.named_parameters()}))
    (l0, g0), (l1, g1) = grads
    check(torch.equal(l0, l1) and all(torch.equal(g0[k], g1[k])
                                      for k in g0),
          "remat: one step's loss or gradients differ from the plain stack")
    total, rows = {}, {}
    for sampler, k in (("host", 1), ("device", DEV_K)):
        outs = []
        for remat in (False, True):
            m = dp_model(torch, "sage", args.seed, remat=remat)
            m.load_state_dict(sd)
            cfg = TrainConfig(batch_size=BATCH_TRAIN, fanouts=FANOUTS, lr=LR,
                              num_epochs=1, eval_every=0, seed=args.seed,
                              sampler=sampler, steps_per_call=k)
            tr = SampledTrainer(m, g, cfg, train_ids=ids, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(wrappers)
            out = tr.train()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            launches = read_counts(wrappers)
            steps, rec = out["step"], out["history"][0]
            want = dp_launches("sage", steps, device=sampler == "device")
            if remat:
                # the backward recomputes both layers' aggregations
                want["fanout_agg"] += 2 * steps
            check(launches == want,
                  f"remat {sampler} {remat}: {launches} in {steps} steps")
            check(rec["graph"] is (k > 1), f"remat {sampler}: graph")
            add_counts(total, launches)
            outs.append(out)
            rows[f"{sampler}_k{k}_remat_{'on' if remat else 'off'}"] = dict(
                peak_memory_bytes=peak, **device_run_record(rec, steps, k))
        check(same_run(outs[0], outs[1]),
              f"remat {sampler} K={k}: the run differs from the plain one")
    emit(phase="dataplane", part="remat", card=card, steps=DP_STEPS,
         one_step_bit_equal=True, runs_bit_equal=True, runs=rows)
    return total


def dataplane_phase(torch, args, ops, wrappers, g, trainer, ctx, work: str,
                    card: str):
    """Quantized and out-of-core books through ``DistTrainer`` and
    ``ServeEngine``, bfloat16 compute and remat, on the SAGE cell's
    graph and widths. Returns the launches of its card runs and its
    kernel records."""
    t0 = time.perf_counter()
    cfg8 = dataplane_book(torch, args, g, work, card)
    total, records = dataplane_train(torch, args, ops, wrappers, ctx, work,
                                     card)
    add_counts(total, dataplane_serve(torch, args, wrappers, g, cfg8,
                                      ctx["node_map"], work, card))
    add_counts(total, dataplane_bf16(torch, args, wrappers, g, trainer, ctx,
                                     work, card))
    add_counts(total, dataplane_remat(torch, args, wrappers, g, trainer,
                                      card))
    emit(phase="dataplane", part="done", card=card,
         seconds=time.perf_counter() - t0, launches=total)
    return total, records


def lint_phase(card: str) -> None:
    """The port's lint over its own surface (``dgl_operator_tpu_torch``
    and this script) as a user runs it: ``python3 -m
    dgl_operator_tpu_torch.analysis --json`` in a child on this
    machine's interpreter, against the committed empty baseline. It
    must exit 0 with no finding and no unparsable file over more than
    100 files."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "dgl_operator_tpu_torch.analysis", "--json"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    try:
        report = json.loads(proc.stdout)
    except ValueError:
        report = {}
    counts = report.get("counts", {})
    emit(phase="lint", card=card, rc=proc.returncode,
         files_checked=report.get("files_checked"), counts=counts,
         seconds=seconds)
    check(proc.returncode == 0 and counts.get("findings") == 0
          and counts.get("errors") == 0
          and report.get("files_checked", 0) > 100,
          f"lint: rc {proc.returncode}, {report.get('files_checked')} "
          f"files, counts {counts}, findings {report.get('findings')}, "
          f"stderr {proc.stderr[-2000:]}")


def kernel_entry(records, name, main_shapes, launches, replaces,
                 kge_shapes=(), kge_launches=0, tree_shapes=(),
                 gat_shapes=None, gat_launches=0, mp_launches=0,
                 rgcn_launches=0, chaos_launches=0, dataplane_launches=0,
                 more_launches=None):
    """The kernels line's entry: worst error over every shape, times
    summed over the calls of one SAGE training step (and, under
    ``kge``, of one KGE training step; under ``device_sampler``, of one
    device-sampled step; under each key of ``gat_shapes``, of one
    device-sampled step of that stack, or under ``full_graph`` of one
    edge gather or segment sum of the full-graph Cora loop, or under
    ``rgcn_gin`` of one call at each RGCN and pool shape), launches of
    every path (``mp_launches``: the full-graph and message-passing
    runs and ``examples/graphsage.py``; ``rgcn_launches``: the
    ``rgcn_gin`` phase's runs; ``chaos_launches``: the ``chaos``
    phase's runs; ``dataplane_launches``: the ``dataplane`` phase's
    runs; ``more_launches``: ``launches_<key>`` of each later phase)."""
    more_launches = more_launches or {}
    mine = [r for r in records if r["kernel"] == name]

    def step_sums(shapes):
        main = [r for r in mine if (r["shape"], r["dtype"]) in shapes]
        check(len(main) == len(shapes), f"{name}: main-path records")
        # library_ms None: no library call does this kernel's work
        out = {k: (None if any(r[k] is None for r in main)
                   else sum(r[k] for r in main))
               for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
        out["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                          for r in main) else "operations")
        return out

    total = step_sums(main_shapes)
    entry = {"name": name, "route": "cuda",
             "source": f"dgl_operator_tpu_torch/csrc/{name}.cu",
             "replaces": replaces,
             "launches": launches + kge_launches + gat_launches
             + mp_launches + rgcn_launches + chaos_launches
             + dataplane_launches + sum(more_launches.values()),
             "max_abs_err": max(r["max_abs_err"] for r in mine),
             "ms": total["ms"], "plain_ms": total["plain_ms"],
             "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
             "library_ms": total["library_ms"],
             "launches_sage": launches, "launches_kge": kge_launches,
             "launches_gat": gat_launches,
             "launches_message_passing": mp_launches,
             "launches_rgcn_gin": rgcn_launches,
             "launches_chaos": chaos_launches,
             "launches_dataplane": dataplane_launches,
             **{f"launches_{k}": v for k, v in more_launches.items()}}
    if kge_shapes:
        entry["kge"] = step_sums(kge_shapes)
    if tree_shapes:
        entry["device_sampler"] = step_sums(tree_shapes)
    for key, shapes in (gat_shapes or {}).items():
        entry[key] = step_sums(shapes)
    return entry


def main(argv=None) -> int:
    global T_START
    T_START = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="ogbn-products graph size (1.0 = 2.45M nodes)")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--iters", type=int, default=50,
                    help="launches per kernel timing")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # a fixed cuBLAS workspace: the resume checks compare two runs of
    # the same GEMM shapes bit for bit
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dgl_operator_tpu_torch.ops import (_build, device_sample, fanout,
                                            gather, scatter)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    host = host_cpu()
    emit(phase="device", kind=kind, count=count, nvidia_smi=smi,
         host_cpu=host, cpu_count=os.cpu_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], tf32=False)

    ops = (fanout, gather, scatter)
    wrappers = (fanout.fanout_agg, gather.gather_rows,
                scatter.scatter_add_rows, device_sample.tree_sample)
    sources = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    check(sources == sorted(f"{w.__name__}.cu" for w in wrappers),
          f"one source per kernel: {sources}")
    from dgl_operator_tpu_torch.controlplane import controller as cplane
    os.environ.pop(cplane.BIN_DIR_ENV, None)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources) + 2) as pool:
        host_build = pool.submit(_build.build_host, "graphcore.cc")
        cp_build = pool.submit(cplane.ensure_built)
        builds = list(pool.map(_build.build, sources))
        core = host_build.result()
        cp_seconds = cp_build.result()
    for src, b in zip(sources, builds):
        emit(phase="build", source=src, seconds=b.seconds,
             wall_s=time.perf_counter() - t0,
             ptxas=[ln.strip() for ln in b.log.splitlines()
                    if "registers" in ln or "spill" in ln])
    emit(phase="build", source="native/graphcore.cc",
         compiler=_build.host_cxx(), flags=list(_build.HOST_CXXFLAGS),
         seconds=core.seconds, wall_s=time.perf_counter() - t0,
         warnings=[ln.strip() for ln in core.log.splitlines()
                   if "warning" in ln])
    emit(phase="build", source="native/controlplane",
         compiler=_build.host_cxx(), flags=list(_build.HOST_EXE_CXXFLAGS),
         seconds=cp_seconds, wall_s=time.perf_counter() - t0)

    g, trainer, mb = setup_phase(torch, args, smi)
    graph_phase(args, g, trainer, smi, host)
    records = kernel_phase(torch, args, ops, trainer, mb, smi)
    work = os.path.join(REPO, "_chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        served, node_map = serve_phase(torch, args, wrappers, g, work, smi)
        trained = train_phase(torch, args, wrappers, trainer, smi)
        train_cpu_phase(torch, args, g, trainer, smi)
        sampled_resume_phase(torch, args, g, trainer, work, smi)
        dist, dist_records, ctx = dist_phase(torch, args, ops, wrappers, g,
                                             node_map, work, smi)
        dist_mp, mp_records = dist_mp_phase(torch, args, ops, wrappers, ctx,
                                            work, smi)
        device, device_records = device_sampler_phase(
            torch, args, ops, wrappers, g, trainer, ctx, work, smi)
        kge_records, kge, kg = kge_phase(torch, args, ops, wrappers, work,
                                         smi)
        grid_records, grid = kge_grid_phase(torch, args, ops, wrappers, kg,
                                            smi)
        job = kgejob_phase(torch, work, smi)
        obs = obs_phase(torch, args, wrappers, g, trainer, ctx, work, smi)
        tune = tune_phase(torch, args, g, ctx, work, smi)
        elastic, elastic_obs = elastic_phase(torch, args, wrappers, g, ctx,
                                             work, smi)
        controlplane_phase(elastic_obs, work, smi, cp_seconds)
        shard = shard_phase(torch, args, wrappers, g, ctx, kg, work, smi)
        ring = ring_phase(torch, args, wrappers, g, kg, smi)
        gat, full, gat_records = gat_phase(torch, args, ops, wrappers, g,
                                           trainer, ctx, work, smi)
        mpass, mpass_records = message_passing_phase(
            torch, args, ops, wrappers, g, ctx, smi)
        rgin, rgin_records = rgcn_gin_phase(torch, args, ops, wrappers, g,
                                            trainer, ctx, smi)
        sentry = sentry_phase(torch, args, wrappers, g, trainer, ctx, work,
                              smi)
        fleet = fleet_phase(torch, args, wrappers, g, trainer, work, smi)
        chaos = chaos_phase(torch, args, wrappers, g, trainer, ctx, kg, work,
                            smi)
        dplane, dplane_records = dataplane_phase(torch, args, ops, wrappers,
                                                 g, trainer, ctx, work, smi)
        lint_phase(smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    records += (dist_records + mp_records + device_records + kge_records
                + grid_records + gat_records + mpass_records + rgin_records
                + dplane_records)
    # the full-graph and message-passing paths, and the standalone
    # sampled entry point
    for k, v in full.items():
        mpass[k] += v

    def launches(name):
        return (served[name] + trained[name] + dist[name] + dist_mp[name]
                + device[name] + sentry[name] + fleet[name])

    pg = "dgl_operator_tpu/ops/pallas_gather.py"

    def f32(*names):
        return {(n, "float32") for n in names}

    def i8(*names):
        return {(n, "int8") for n in names}

    emit(kernels=[
        kernel_entry(records, "fanout_agg",
                     f32("train_block0", "train_block1"),
                     launches("fanout_agg"), f"{pg}:221",
                     tree_shapes=f32("tree_block0", "tree_block1"),
                     gat_launches=gat["fanout_agg"],
                     mp_launches=mpass["fanout_agg"],
                     rgcn_launches=rgin["fanout_agg"],
                     chaos_launches=chaos.get("fanout_agg", 0),
                     dataplane_launches=dplane.get("fanout_agg", 0),
                     more_launches={"kge_grid": grid["fanout_agg"],
                                    "kgejob": job["fanout_agg"],
                                    "obs": obs["fanout_agg"],
                                    "tune": tune["fanout_agg"],
                                    "elastic": elastic["fanout_agg"],
                                    "shard": shard["fanout_agg"],
                                    "ring": ring["fanout_agg"]}),
        kernel_entry(records, "gather_rows", f32("train_feats"),
                     launches("gather_rows"), f"{pg}:120",
                     f32("kge_entity", "kge_relation"), kge["gather_rows"],
                     tree_shapes=f32("tree_feats"),
                     gat_shapes={
                         "gat": f32("tree_feats", "gat_x_block0",
                                    "gat_el_block0", "gat_x_block1",
                                    "gat_el_block1"),
                         "gatv2": f32("tree_feats", "gatv2_fs_block0",
                                      "gatv2_fs_block1"),
                         "full_graph": f32("cora_gather16"),
                         "rgcn_gin": f32("rgcn_hb_src", "rgcn_coef_etype",
                                         "rgcn_distmult_head",
                                         "rgcn_distmult_rel",
                                         "pool_block0"),
                         "dataplane": i8("dataplane_slot_inputs",
                                         "dataplane_exchange"),
                         "kge_grid": f32("kge_grid_entity",
                                         "kge_grid_relation"),
                         "kge_device": f32("kge_device_entity",
                                           "kge_grid_relation")},
                     gat_launches=gat["gather_rows"],
                     mp_launches=mpass["gather_rows"],
                     rgcn_launches=rgin["gather_rows"],
                     chaos_launches=chaos.get("gather_rows", 0),
                     dataplane_launches=dplane.get("gather_rows", 0),
                     more_launches={"kge_grid": grid["gather_rows"],
                                    "kgejob": job["gather_rows"],
                                    "obs": obs["gather_rows"],
                                    "tune": tune["gather_rows"],
                                    "elastic": elastic["gather_rows"],
                                    "shard": shard["gather_rows"],
                                    "ring": ring["gather_rows"]}),
        kernel_entry(records, "scatter_add_rows", f32("train_block1_bwd"),
                     launches("scatter_add_rows"), f"{pg}:234",
                     f32("kge_entity_push", "kge_relation_push"),
                     kge["scatter_add_rows"],
                     tree_shapes=f32("tree_block1_bwd"),
                     gat_shapes={
                         "gat": f32("gat_el_block0_bwd", "gat_x_block1_bwd",
                                    "gat_el_block1_bwd"),
                         "gatv2": f32("gatv2_fs_block0_bwd",
                                      "gatv2_fs_block1_bwd"),
                         "full_graph": f32("cora_segment_sum"),
                         "rgcn_gin": f32("rgcn_hb_src_bwd",
                                         "rgcn_coef_etype_bwd",
                                         "rgcn_segment_mean",
                                         "rgcn_distmult_rel_bwd",
                                         "pool_block0_bwd"),
                         "kge_grid": f32("kge_grid_entity_push"),
                         "kge_device": f32("kge_device_entity_push")},
                     gat_launches=gat["scatter_add_rows"],
                     mp_launches=mpass["scatter_add_rows"],
                     rgcn_launches=rgin["scatter_add_rows"],
                     chaos_launches=chaos.get("scatter_add_rows", 0),
                     dataplane_launches=dplane.get("scatter_add_rows", 0),
                     more_launches={"kge_grid": grid["scatter_add_rows"],
                                    "kgejob": job["scatter_add_rows"],
                                    "obs": obs["scatter_add_rows"],
                                    "tune": tune["scatter_add_rows"],
                                    "elastic": elastic["scatter_add_rows"],
                                    "shard": shard["scatter_add_rows"],
                                    "ring": ring["scatter_add_rows"]}),
        # no Pallas twin: the JAX sampler is plain jnp; the knob search's
        # probes count the three kernels above only
        kernel_entry(records, "tree_sample",
                     {(r["shape"], r["dtype"]) for r in records
                      if r["kernel"] == "tree_sample"},
                     launches("tree_sample"),
                     "none: the JAX sampler is plain jnp",
                     gat_launches=gat["tree_sample"],
                     mp_launches=mpass["tree_sample"],
                     rgcn_launches=rgin["tree_sample"],
                     chaos_launches=chaos.get("tree_sample", 0),
                     dataplane_launches=dplane.get("tree_sample", 0),
                     more_launches={"kge_grid": grid["tree_sample"],
                                    "obs": obs["tree_sample"],
                                    "elastic": elastic["tree_sample"],
                                    "shard": shard["tree_sample"],
                                    "ring": ring["tree_sample"]}),
    ])
    emit(phase="total", seconds=time.perf_counter() - T_START)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": kind, "count": count})
    return 0


if __name__ == "__main__":
    sys.exit(main())
