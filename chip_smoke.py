"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero with no result:

1. env: the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 is switched off for fp32 matmuls and convolutions.
   device: in a fresh process with no CUDA context,
   ``discover(allow_cuda=False)`` must read the card through NVML
   (source "env", the model nvidia-h100-80gb-hbm3) and leave CUDA
   unstarted; then, with CUDA started, the device rung must report the
   same name, UUID and memory (within DEVICE_MEM_TOL).  The MIG mode is
   printed; on a card in MIG mode NVML's GPU instance profiles and
   possible placements are held against ``topology/known.py``.  Nothing
   is created or destroyed and no MIG mode is changed.
2. build: nvcc builds every kernel in nos_tpu_torch/ops/csrc/ (all
   sources at once) into nos_tpu_torch/_kernels/, and reports each
   compiled tile's ptxas registers and spill bytes; then g++ builds the
   native scheduling shim (``native/gpu_shim.cc``) there, so that no
   later phase adds a library to the directory.
3. kernels: each kernel's wrapper at every tile it is compiled for
   (``ops.attention.KERNEL_TILES``; TILES below) against its plain
   PyTorch version on the card, with the stated tolerances: the forward
   (K1) at the serving shape, and the fused backward (K2), the dq kernel
   (K3) and the dk/dv kernel (K4) at the training shape, at S 1, 63, 64,
   65, 127, 128, 129 and 200 causal and not (the edges of the 64- and
   128-row tiles), on strided views, and all four at the MFU sweep's
   B16 S2048 H8 causal with grouped K/V (4 heads repeated to 8, as the
   model's ``repeat_kv`` gives them); two launches of each tile of K3
   and K4 at the training shape must agree bitwise.  Kernel, plain and
   library times (CUDA events, median of several samples of
   back-to-back launches) of every tile at the serving and the training
   shape, and each bound from the card's published peaks
   (nos_tpu_torch.ops.roofline).  Then a timing-only long-context row,
   B1 S32768 H8 causal, where the split pair is the backward
   ``backward_impl`` picks: every tile of K2, K3, K4 and the SDPA
   backward timed, split held against fused and each tile against the
   default (the plain versions would need 34 GB of fp32 scores there).
   The autotune phase follows: ``autotune.tune_and_record`` at B8 S512
   H8 and B8 S2048 H8 causal into a cache in a temporary directory,
   every candidate's ms, ``lookup`` returning the recorded winners, the
   split backward's candidates searched, and an explicit tile that no
   kernel is compiled for refused by the op and by the C entry point.
   Every later phase sees the committed ``PRETUNED`` table and no
   measured cache, and reports its launches by tile.
4. serve: BENCH_350M at full width and depth (24 layers), bf16
   parameters from a seed, flash attention, through ``generate`` for 8
   requests: 448 prompt tokens and 64 greedy steps each.  The launch
   counts are zeroed just before the run and read just after it.  Then
   one forward on the same buffer with the plain (dense) attention,
   compared with the kernel path's logits, and one with a deliberately
   wrong (non-causal) dense attention, which the same limit must fail.
5. train: BENCH_350M_TRAIN at full width and depth (24 layers, fp32
   parameters from seed 0, flash attention, "rots" remat) through
   ``Trainer.train_step`` on the synthetic 8 x 2048 batches: 2 untimed
   and 10 timed steps under the fused backward, then one under the
   split backward, with the launch counts zeroed just before and read
   just after, and per step.  It checks the launches per step, the first
   loss against its expected value and every loss for finiteness; that
   two loss-and-gradient passes from one state repeat (bitwise under the
   split backward, within a limit under the fused one); and, at a cut
   depth of 4 layers, that the flash path's loss and gradients agree
   with the dense path's and the fused backward's with the split one's.
6. train_main: the training main, ``nos_tpu_torch.cmd.train.train``, on
   BENCH_350M_TRAIN at full width and depth with its defaults (flash,
   "rots", 8 x 2048 synthetic batches from seed 0) through a process
   group of one rank (NCCL) and FSDP2: MAIN_STEPS steps logged each,
   whose step-0 loss must match the train phase's Trainer and which must
   launch 24 K1 + 24 K2 per step; then, under the split backward, 6
   steps straight, 4 steps with a checkpoint at step 4 into a temporary
   directory, and a restart into that directory to step 6, which must
   resume at step 4 and end on the straight run's loss bitwise.  The
   launch counts are zeroed before the first run and read after the
   last.  It reports ms/step, tokens/s and MFU from the main's own log
   records, save and restore times, the checkpoint's bytes and the peak
   device memory, then leaves the process group.
7. moe: the MoE family at BENCH_350M_TRAIN's widths and depth (24
   layers of 8 experts, top-2, capacity 1.25; flash attention, fp32
   parameters, bf16 activations, every block rematerialised) through
   ``make_ep_trainer`` (optax adam(1e-3)) in a one-rank NCCL group
   (ep = 1) on the train phase's 8 x 2048 batches: a forward without
   grad on batch 0 for the step-0 loss terms and each layer's drop rate,
   then MOE_UNTIMED untimed and MOE_TIMED timed steps with the counts zeroed
   just before and read just after (48 K1 + 24 K2 per step: full remat
   replays K1).  It checks every loss for finiteness, that the loss falls
   over the timed steps, the step-0 xent, the launches per step, two
   gradient passes from one state bitwise under the split backward, and,
   at a 2-layer cut on a 2 x 2048 batch, the index dispatch against the
   einsum reference (``moe_mlp_reference``) and flash against dense
   attention, loss and gradients.
8. grant: the training main as a pod runs it, ``python -m
   nos_tpu_torch.cmd.train``, in three fresh processes at once on
   train_main's configuration (BENCH_350M_TRAIN, 8 x 2048, seed 0, 2
   steps), each reusing the built kernels (nvcc hidden from it, the kernel directory
   unchanged): (a) the card's UUID and a 24 GB timeshare grant must exit
   0 with the grant verified, train_main's step-0 loss, 24 K1 + 24 K2
   a step and its peak under the installed cap; (b) an 8 GB grant, a cap
   below that peak, must fail with the cap's OutOfMemoryError; (c) a
   UUID of no device on the machine must stop with ConfinementError
   before any step.  Each child's exit code, wall seconds, fraction, cap
   and peak go on the phase's line; its launches stay off the kernels
   line, which counts the in-process paths.
9. partition: the MPS partitioning planner and its loop.  (a)
   ``GeometryPlanner.plan`` on ``testing/fleet.py``'s fleet (32 nodes x
   8 H100 80GB, half full, 200 pending pods, seed 0) on the card
   machine's host, once untimed and PLAN_TIMED times timed on fresh
   snapshots: the plans must be identical, hold no GPU over 80 GB of
   shares, keep every used share, and hash to the digest
   ``testing/fleet.py`` pins (the JAX package's plan, held in the CPU
   tests).  (b) The card's own node (the model and memory discovery
   found, one GPU) in the MPS loop on an in-memory API server, on
   ``time.monotonic`` with batch windows of 0.2 s idle and 2 s timeout:
   the partitioner controller from its factory, the node's chip agent
   (the timeshare plugin and the reporter) and the scheduler from
   ``build_scheduler``.  Four pending 24 GB pods are polled through a
   scheduler cycle, the controller and the agent until three are bound
   and Running (30 s at most); exactly
   one plan cycle must have run, the ConfigMap must hold one key for
   the node giving GPU 0 three 24 GB replicas, the plugin must
   advertise ``nvidia.com/gpu-24gb: 3``, the node's status plan id must
   equal its spec plan id (the handshake closed), the reporter must show
   GPU 0 ``24gb-used: 3``, and the fourth pod must stay pending and
   Unschedulable.  One rescan interval later the controller's next
   cycle runs on the fourth pod and must write nothing.  The loop's
   chip-second waste ledger must conserve and show the node's
   ``actuation`` GPU-seconds between the plan and the status catching
   up.  Each bound pod's grant comes from the node side: the UUID, through discovery,
   of a GPU of the applied config on which the reporter shows a used
   share of the pod's size, and the GB of its request; the smoke hands
   it over, standing in for the kubelet
   plugin's Allocate (``device/deviceplugin``, which needs grpcio, absent
   from the card's machine).  Then one ``python -m
   nos_tpu_torch.cmd.train`` child per bound pod, all three at once,
   under its grant with grant's configuration and nvcc hidden: each as
   grant (a) must, and the three step windows (first step's start to
   last step's log line, on the host's clock) must intersect, so that
   the three ran their steps on the card at once.  The three reserved
   peaks together stay under the card's memory, which the per-child
   caps already imply.  Then the three pods are marked Succeeded: the
   reporter must show GPU 0 ``24gb-free: 3``, and the scheduler must
   bind the fourth pod onto a freed share with no new plan.  The phase's line
   carries the card's ``name, power.limit``, the plan cycles' host ms
   (``nos_tpu_plan_seconds``), the agent's host ms per tick,
   ``nos_tpu_actuation_latency_seconds`` and each pod's wall ms from
   creation to bound; the children's launches go on it, as grant's do.
10. mig: the MIG strategy and node side; no MIG instance is created or
   destroyed on the card and no MIG mode changed.  (a)
   ``testing/fleet.py``'s MIG fleet (32 nodes x 8 H100 80GB labelled
   ``mig``, half full, 200 pending pods, seed 0) planned MIG_PLANS
   times, each timed on a fresh snapshot: the plans must be identical,
   hash to ``MIG_FLEET_DIGEST`` (the CPU tests' plan), give every GPU one
   of the H100's maximal geometries (``enumerate_geometries``) within 7
   compute slices and 8 memory slots, and keep every used instance.
   (b) The MIG agent's reporter over ``NvmlGpuRuntime`` for the card's
   node (its model from discovery), with a pod-resources view holding
   no device: its status and placement annotations must be NVML's MIG
   devices and placements, none with MIG off; the MIG mode NVML read
   and the annotations go on the line.  (c) One H100 node through the
   MIG loop on an in-memory API server (``_MigLoop``): node controller
   with the virgin-node initializer, the MIG partitioner controller
   from its factory (``time.monotonic``, batch idle 0.2 s, timeout 2
   s), a ``SliceAgent`` with its kubelet simulator over
   ``FakeGpuRuntime(H100_80GB, 1)`` (named on the line as the fake it
   is) and the scheduler.  The virgin node is carved to 7g.80gb; five
   pods (3g.40gb, 2g.20gb, three 1g.10gb) take one re-carve, closed in
   one plan cycle with four bound and Running and the fifth
   Unschedulable; a rescan cycle writes nothing; a bound 1g.10gb pod is
   deleted and the fifth binds onto its instance with no new plan.
   Every distinct state the loop writes to the node and the pods must
   equal ``MIG_LOOP_WRITES``.  The line carries the plan cycles' host
   ms, the agent's host ms per tick, the actuation latency, each pod's
   pending-to-bound ms and the runtime's create and delete calls.
   (d) The loop of (c) again with the agent on ``NvmlGpuRuntime`` over
   the fake NVML library (``testing/nvml.py``, one H100 in MIG mode):
   its writes must equal ``MIG_LOOP_WRITES`` too; the line carries the
   library's create and destroy calls.  (e) ``NvmlGpuRuntime`` on the
   card's NVML through a proxy that counts every create and destroy
   call and passes none to the driver: every lifecycle symbol resolves;
   with MIG off, ``create_slices(0, ["1g.10gb"])`` raises
   ``MigModeDisabled``; a block shard (BLOCK_PROFILE) is created on GPU
   0, listed, left out of ``placements()`` and deleted, ``gpu_uuids()``
   naming the card; a second shard is all that ``delete_all_except``
   deletes; the proxy must count no create or destroy.  On a card in
   MIG mode only the symbols and the shard's refusal are checked.  (f)
   ``device/nvml_layout.cc``, compiled with the host compiler against
   the toolkit's ``nvml.h`` into the kernels' build directory, prints
   each bound struct's size and member offsets and each NVML constant
   the module uses: all must equal the ctypes declarations.  (g)
   ``python -m nos_tpu_torch.cmd.sliceagent --device cuda`` for the
   card's node on the in-memory API: its /healthz answers 200, its
   startup cleanup deletes nothing, and it exits 0 on SIGTERM.  (g)
   runs only where NVML reads every GPU's MIG mode as disabled (on a
   shared card in MIG mode a startup cleanup would destroy instances it
   does not own); otherwise the line says why it was skipped.
11. quota: Elastic Resource Quotas and the scheduler's preemption.  (a)
   On the host, ``testing/fleet.py``'s quota fleet (32 nodes x 8 H100
   80GB carved alike, 20,480 GB; train-a, train-b and serve quotas and
   the composite research, their mins summing to the fleet; wave 1
   train-a borrowing with 128 pods of 80gb, wave 2 serve and research up
   to their mins, research's 80gb pods fitting only by preemption; the
   bench's gang jobs cut) run QUOTA_FLEET_RUNS times, each cycle followed
   by the kubelet's admission and both reconcilers, until a cycle binds
   and evicts nothing: every run must hash to ``QUOTA_FLEET_DIGEST``
   (the JAX package's run in the CPU tests) and its waste waterfall (a
   ledger of its own, QUOTA_FLEET_CYCLE_S a cycle), which must
   conserve, to ``QUOTA_FLEET_WASTE_DIGEST`` (JAX's ledger on the same
   run), every victim must carry the over-quota label when chosen, no
   quota may hold more than its max, and each quota's status.used must
   be its Running pods' GB.  The line carries the host ms per cycle and
   per reconcile (median, max), the binds, preemptions, victims by
   label, pods left pending and the waterfall.  (b) The
   card's node in partition (b)'s MPS loop (``_QuotaLoop``) with the
   quota webhooks and both reconcilers bound to their watches, team-a
   holding min 40 and max 80 GB, team-b min 40: team-a's three 24 GB
   pods are carved three shares and bound in one plan cycle, labelled
   one in-quota and two over-quota (borrowing team-b's min), and one
   child per pod trains under its grant; once each has logged a step,
   team-b's 24 GB pod is created, and the next scheduler cycle must
   evict ``QUOTA_VICTIM`` alone (the JAX package's choice on the CPU)
   and bind team-b's pod on its share with no new plan, while all three
   children still run.  The smoke, as the kubelet, sends the victim's
   child SIGTERM: it must exit by the signal within QUOTA_STOP_LIMIT_S,
   having logged, before any step, its grant verified on the card at
   its fraction and cap.  Then team-b's child trains GRANT_STEPS steps
   and the two survivors end their QUOTA_SURVIVOR_STEPS steps, each
   under its grant as grant (a) must (exit 0, the grant verified,
   train_main's step-0 loss, 24 K1 + 24 K2 a step, its peak under its
   cap).  Every distinct state the loop writes to the node, the pods
   and the quotas must equal ``QUOTA_LOOP_WRITES``.  The line carries
   the scheduler's host ms per cycle, eviction to rebind and eviction to
   child-stopped ms, each pod's creation-to-bound ms, the children's
   walls and the launches of the children that ended.
12. gang: gang scheduling, all or nothing inside one NVLink domain, and
   gang preemption.  (a) On the host, ``testing/fleet.py``'s gang fleet
   (the quota fleet's nodes and quotas, nodes 0-15 in NVLink domain
   nvl-0, 16-27 in nvl-1, 28-31 unlabelled; after its two waves a
   third of bench_utilization.py's gang jobs at priority 10, a gang
   waiting for a member it never gets, and a gang whose 8x16 mesh only
   nvl-0 holds) run GANG_FLEET_RUNS times: every run must hash to
   ``GANG_FLEET_DIGEST`` (the JAX package's run in the CPU tests) and
   its conserved waterfall to ``GANG_FLEET_WASTE_DIGEST``; at no
   cycle's end may a gang be bound in part or over two domains; the
   mesh gang must have been bound in nvl-0 alone and the waiting gang
   never; every victim must have been over quota, or of the preemptor's
   namespace with its quota over min, when chosen; no quota may hold
   more than its max.  The line carries the host ms per cycle, per gang
   admitted and per gang rejected, the gangs admitted and rejected, the
   gang preemptions, the victims by label and what is left pending.
   (b) The card's node in the MPS loop with the quota webhooks and both
   reconcilers (team-a min 24 max 80 GB, team-b min 48): team-a's
   PodGroup ``ga`` (two members) and its first 24 GB member go through
   GANG_WAIT_CYCLES scheduler cycles, each leaving it unbound and marked
   waiting for members (1/2); the second member arrives, one plan
   carves the shares and both bind in one scheduler cycle; one child per
   member trains under its grant; once both have logged a step,
   team-b's gang ``gb`` (two 24 GB members, within its min) is created,
   and the next cycle must evict ``ga`` whole (the JAX package's choice
   on the CPU), bind no member of ``gb``, and leave ``ga``'s PodGroup
   Pending 0; ``gb`` must bind whole on a later cycle.  The smoke, as
   the kubelet, sends both of ``ga``'s children SIGTERM: each must exit
   by the signal within QUOTA_STOP_LIMIT_S, having logged its grant
   verified on the card at its fraction and cap.  Then ``gb``'s two
   children train GRANT_STEPS steps at once, each under its grant as
   grant (a) must.  Every distinct state the loop writes to the node,
   the pods, the quotas and the PodGroups must equal
   ``GANG_LOOP_WRITES``.  The line carries eviction to rebind and to
   children-stopped ms, SIGTERM to exit s, the children's walls and
   step windows, each pod's creation-to-bound ms, the scheduler's host
   ms per cycle and ``gb``'s children's launches, which the kernels line
   counts as the ``gang`` path.
   (c) block: an NVLink block gang (ROADMAP item 7.2) over one domain of
   four one-GPU MIG nodes, the card's at index 0 and three stubs, each
   agent on the fake runtime (the card is not in MIG mode; the NVML
   runtime's block shard on the card is the mig phase's part (e)).
   A single under the spare progress holds index 1, a nearly done one
   index 2.  The operator main's hook rewrites the gang's two members,
   ``nvidia.com/gpu: 2`` with the mesh 2x1, into
   ``nvlink-block-2x1: 1`` each.  The first cycle must lease the window
   [0, 1] (the annotation on both nodes); drain preemption
   (BLOCK_DRAIN_AFTER cycles, BLOCK_DRAIN_FRACTION) must evict the
   straggler alone in cycle BLOCK_DRAIN_AFTER + 2; the group pass must
   carve both nodes as shards and both members bind in one cycle on the
   window, and the lease go the cycle after.  The card member's child
   trains GRANT_STEPS steps of BENCH_350M_TRAIN under the grant the
   device plugin's ``block_allocate_envs`` gives, the card whole by its
   UUID (verified, no memory cap), with no kernel built; the stub
   member's bind is checked through the API only.  The line carries the
   lease, the eviction and bind cycles, the child's steps and its
   launches, which the kernels line counts as the ``block`` path.

13. recovery: fleet planning by pool and node-loss recovery.  (a) On
   the host, partition (a)'s fleet with the gang fleet's NVLink domains
   (nodes 0-15 nvl-0, 16-27 nvl-1, 28-31 unlabelled: three plan pools)
   planned by ``ParallelGeometryPlanner`` (``plan_shard_min_hosts`` 0)
   at each of PARALLEL_WORKERS workers, one untimed and PARALLEL_TIMED
   timed plans on fresh snapshots: every plan's desired state and
   journal must be the same at every worker count and hash to
   ``PARALLEL_FLEET_DIGEST`` (the JAX package's parallel planner in the
   CPU tests); the sequential planner on the same fleet is timed beside
   it.  (b) ``testing/fleet.py``'s recovery fleet (bench_nodeloss.py's
   trace on the gang fleet through the MPS loop on a virtual clock: a
   warm spare a domain, three kills, a wedged agent that later dies)
   once: its summary must hash to ``RECOVERY_FLEET_DIGEST`` (the JAX
   package's run in the CPU tests) and its conserved waterfall to
   ``RECOVERY_FLEET_WASTE_DIGEST``, no displaced job may be left
   unbound, and suspicion, promotion, migration and the straggler
   eviction must each have happened; the same kill schedule with every
   recovery step off (bench_nodeloss.py's baseline) runs after it, and
   the recovery run must lose at most ``fleet.RECOVERY_LOST_HALVING``
   of the baseline's GPU-seconds.  The line names the slowest
   controller poll (its ms, trace time and the journal categories it
   wrote).  (c) The card's node in the MPS
   loop over the REST substrate: ``tests/k8s_stub.py``'s
   ``StubApiServer`` (stdlib only, loaded by path), the loop's node and
   pod controllers, partitioner controller, chip agent and scheduler on
   a ``kube/rest.py`` ``KubeClient`` against it (the stub's binding
   moves a bound pod to Running, the kubelet's part), heartbeat
   suspicion (RECOVERY_SUSPECT_AFTER_S) and a migrate grace
   (RECOVERY_GRACE_S, longer than a step and a save): ``rj`` (48 GB)
   binds and its child trains under its grant as a deployed pod runs
   (``POD_NAME``/``POD_NAMESPACE``, a JSON kubeconfig naming the stub, a
   health address), RECOVERY_STEPS steps of the split backward with a
   checkpoint after each, beside a straight child of the same steps;
   ``bq`` (48 GB) waits Unschedulable.  Once ``rj``'s child landed its
   first checkpoint the smoke scrapes it once (``/healthz`` 200 ``ok``,
   ``/metrics`` Prometheus text with ``nos_tpu_train_step`` >= 1, the
   pod's ``job-progress`` 0.2500) and the agent stops ticking: the
   detector must quarantine the node as suspect, the node must get the
   migrate drain and ``rj`` the migrate stamp and a JOB_DISPLACED
   record; ``rj``'s child must read the stamp at its next landed
   checkpoint and exit 0 there, before the grace and with no signal
   sent; the smoke marks the pod Succeeded (the kubelet's part),
   deletes it and recreates it with the displaced stamp (the owning
   controller's), and the recovery plane must have evicted no one;
   while the node is drained MigrationDrainGuard must refuse both pods.
   The agent resumes: the node must be released and its drain healed,
   ``rj`` must bind before the older ``bq`` with no new plan written,
   and its new child must resume at the step the first one left at (no
   step lost), train to the end under its grant and end on the straight
   child's loss bitwise.  Every distinct state the stub commits (its
   commit log, ``_StubTap``) must equal ``RECOVERY_LOOP_WRITES``.  The
   line carries the plans' host ms per worker count, the fleet's counts
   and host ms per controller poll, freeze to suspicion, suspicion to
   stamp, stamp to the child's own exit beside the grace, the child's
   exit code and cause, the progress values written, the resumed
   child's start step and the steps lost, release to rebind, the host
   ms per loop pass over REST, the children's walls and the resumed
   child's launches, which the kernels line counts as the ``recovery``
   path.
14. mains: the control plane as the deployment runs it, each main a
   process of its own (``python -m nos_tpu_torch.cmd.<main> --config``,
   ``apiVersion`` nos.tpu/v1beta2, a JSON kubeconfig naming the REST
   stub, a health address on a free port) against ``StubApiServer``,
   where the smoke registered the card's node (MPS, the model discovery
   found) and team-a's and team-b's ElasticQuotas: two partitioner
   replicas (``mps``, leader election, the card phase's batch windows),
   a scheduler, an operator (``webhook_port`` 0: it must warn that quota
   admission is unenforced) and the chip agent (``--node``, ``model:
   auto`` through NVML with no CUDA context, heartbeat, MAINS_REPORT_S
   reports).  Each must answer ``/healthz`` and ``/readyz``, and exactly
   one partitioner holds the lease and runs the partitioner loop.  Two
   24 GB pods, one a team, are placed by the mains alone (one plan on
   the leader's ``/metrics``, the plugin applied, both bound, the
   stub's binding Running); the operator must write each quota's
   ``status.used`` as 24 GB.  Each pod's grant is derived from the
   stub's objects (the applied plugin config, the reporter's used
   shares) and one ``cmd.train`` child per pod starts at once
   (BENCH_350M_TRAIN at full width, GRANT_STEPS fused steps, a
   checkpoint at the end, ``POD_NAME``/``POD_NAMESPACE`` and the
   kubeconfig).  The leader gets SIGTERM: it must exit 0 and release
   the lease (deadline 0), the standby must take it within its 2 s
   retry and a step, and a third 24 GB pod, created after the handover,
   must be planned by the new leader alone (a new plan id, one plan on
   its ``/metrics``) and bound; the old leader writes the lease no more
   (the stub's commit log, ``_StubTap``).  The children must pass as
   grant (a)'s and write ``job-progress`` 1.0000; the smoke marks the
   pods Succeeded and the quotas' use must return to 0.  The scheduler
   main's ``/snapshot`` must answer 200 with a conserved waste
   waterfall of the node's one GPU, in which, between a read after both
   pods were placed and one just before the third pod's creation,
   productive must be 48/80 of the GPU-seconds within one scheduler
   cycle at each edge (MAINS_CYCLE_S); its ``/debug/slo`` must answer
   200 with a schedule-latency verdict for the pods' class.  The
   one-shot exporter must exit 0 on a dump of the stub
   (``kube/serialize``) and on the scheduler's ``/snapshot``, each
   payload with the MPS node and its GPU, the latter with the
   waterfall; ``python -m nos_tpu_torch.obs waste --url`` on the
   scheduler must exit 0 with the waterfall's categories.  The actuation
   holds live in the partitioners' processes, so the scheduler's
   waterfall reads none.  SIGTERM to every main: each exits 0 within MAINS_EXIT_LIMIT_S
   and no lease is left held.  The final objects must equal
   ``MAINS_LOOP_WRITES`` (the same topology as processes in the CPU
   tests).  The line carries each main's start to ``/healthz``,
   creation to bound per pod, the plan counts, SIGTERM to the new
   holder, handover to the third pod's bind, the quota values seen, the
   exporter's exit codes, the waterfall while both pods ran and at the
   end, the SLO verdict, each main's exit code and seconds to exit and
   the children's walls; their launches are the kernels line's
   ``mains`` path.  These mains run the card's node as an MPS node; the
   MIG agent's main runs on the card in the mig phase's part (g).

15. elastic: elastic gangs and the MIG defragmenter.  (a) On the host,
   ``testing/fleet.py``'s defrag fleet (bench_defrag.py's trace on the
   MIG stand-in: 24 one-GPU nodes, fillers, whole-GPU demand and a
   burst, two elastic sponge gangs) through the MIG loop on the fake
   runtime (no MIG instance on the card is touched), defrag and grow on
   ELASTIC_FLEET_RUNS times, the baseline with both off and
   propose-only once: every defrag-on run must hash to
   ``DEFRAG_FLEET_DIGEST`` and its conserved waterfall to
   ``DEFRAG_FLEET_WASTE_DIGEST`` (the JAX package's run in the CPU
   tests); every move must be of a movable pod (no serving pod, none
   past the spare progress, no rigid gang's member), no job moved more
   than twice; the baseline and propose-only must decide alike; the
   utilisation floor must reach the bench's 0.95, and the frag halving
   is held only where the JAX package's runs meet it
   (``DEFRAG_FRAG_HALVING_MET``).  A straight child of ELASTIC_STEPS
   split steps trains beside it.  (b) The card's node in the MPS loop
   over the REST stub with the quotas (team-a min 24 max 80 GB, team-b
   min 48) and both reconcilers run each pass: team-a's elastic PodGroup
   ``eg`` (min 2, max 3 replicas, two 24 GB members) and a plain 24 GB
   pod bind after one plan, each child training under its grant (the
   members: the split backward, a checkpoint each step,
   ``POD_NAME``/``POD_NAMESPACE``, the stub's kubeconfig,
   ``NOS_TPU_DP_REPLICAS`` the gang's count); the plain pod's child ends
   and its pod is marked Succeeded: a cycle's grow pass must create
   ``eg-e2`` and stamp dp-resize 3 on both members, and ``eg-e2`` bind
   on the freed share with no new plan; each member's child must leave
   at its next landed checkpoint and is restarted at 3 replicas (0
   steps lost), ``eg-e2``'s starts; then team-b's 24 GB pod: a cycle
   must delete ``ELASTIC_VICTIM`` alone (the JAX package's choice), the
   PodGroup staying admitted, stamp dp-resize 2 on the survivors, and
   bind team-b's pod with no new plan; the victim's child gets SIGTERM
   and must exit by it within QUOTA_STOP_LIMIT_S; the survivors leave
   at their checkpoints, restart at 2 and end on the straight child's
   loss bitwise; team-b's child trains as grant (a)'s.  Every distinct
   state the stub commits must equal ``ELASTIC_LOOP_WRITES``.  The line
   carries the fleet's host ms per defrag step and plan cycle (on and
   off), its proposals, moves, GPUs unlocked, grows, shrinks and
   utilisation floor; each pod's creation to bound, release to the
   grown pod's bind, each stamp to each child's exit, eviction to
   rebind, SIGTERM to exit, the steps lost, the scheduler's host ms per
   cycle and the children's walls; the members' runs' launches are the
   kernels line's ``elastic`` path.

16. serving: the serving tier.  (a) On the host, ``testing/fleet.py``'s
   serving fleets (bench_serving.py's run mapped onto H100 nodes: 24
   one-GPU MIG nodes of the stand-in {1g.20gb, 3g.40gb, 7g.80gb} and two
   two-GPU MPS nodes, its quotas, batch and best-effort fillers and the
   ``chat`` and ``embed`` services on the replica autoscaler; 30 s of
   its trace at its 0.04 s tick), router off once and router on at 0 and
   4 router workers (bench_requests.py's run: chat disaggregated,
   embed aggregated): every run must hash to ``SERVING_FLEET_DIGEST`` or
   ``REQUEST_FLEET_DIGEST`` (the JAX package's runs of the mapped trace
   in the CPU tests), conserve its waste waterfall and meet every bench
   invariant the JAX runs meet (``SERVING_FLEET_MET``,
   ``REQUEST_FLEET_MET``); the router-on journals must be byte-identical
   at both worker counts.  (b) The card's node over the REST stub: the
   mains of phase 14 (one partitioner) and ``python -m
   nos_tpu_torch.cmd.autoscaler`` (chat: 24 GB shares, 1 to 2 replicas,
   target 0.4) as processes, namespace serve (min 48 GB) and a
   best-effort namespace filler (min 32 GB); the autoscaler creates
   ``chat-r0`` and the smoke two 24 GB fillers, one plan carves three
   shares and the three bind; each replica's child serves BENCH_350M at
   full width through ``generate`` under its grant until SIGTERM, each
   filler's child trains as grant (a)'s.  The request router, a process
   of its own over ``KubeClient`` on a virtual clock the smoke advances
   one publish at a time (``serving_story``), takes a seeded burst sized
   by Little's law on the cost model (BENCH_350M's widths, the card's
   name, 24 GB): the published load must pass twice the target, the
   autoscaler create ``chat-r1``, the next scheduler cycle evict
   ``SERVING_FILLER_VICTIM`` (over quota: serving outranks best-effort)
   and bind ``chat-r1`` with no new plan; the evicted filler's child
   exits by SIGTERM; the two replicas' serving windows must overlap; the
   drain publishes the drained replica's sessions as 0 and the
   autoscaler must delete ``SERVING_VICTIM`` alone, whose child exits by
   SIGTERM.  Every distinct state the loop writes must equal
   ``SERVING_LOOP_WRITES`` (the same story on the JAX package's mains,
   autoscaler and router in the CPU tests), and every main and the
   router exit 0.  The line carries the fleets' host ms per router tick,
   reconcile and scheduler cycle, their requests, scale events, phase
   p50 and p99 and utilisation floor; creation to bound per pod, load
   stamp to scale-up to bound, SIGTERM to exit, each child's ms per
   forward and launches beside the cost model's prefill and decode step
   at the card's kind; the replicas' children's launches are the kernels
   line's ``serving`` path.

17. capacity: the capacity plane.  (a) On the host,
   ``testing/fleet.py``'s capacity fleets (bench_capacity.py's runs on
   8-GPU H100 nodes in MIG mode, a job eight 7g.80gb: the swing, 4
   nodes' demand doubling and halving back; the storm, two NVLink
   domains of 3 nodes and two warm spares, a zonal stockout as demand
   steps up; the quiescent run armed, and with the plane off), each
   CAPACITY_FLEET_RUNS times: every armed run must hash to
   ``CAPACITY_FLEET_DIGESTS`` (the JAX package's runs of the same traces
   in the CPU tests), repeated runs alike, conserve its waste waterfall,
   and hold the bench's gates (swing utilisation >= 0.95, >= 4 nodes
   landed and >= 3 released, the pool within one node of its base,
   ``provisioning`` GPU-seconds booked; the storm's breaker opened, 2
   borrows, no job left unbound, no cloud operation left); the armed
   quiescent journal must be the plane-off one byte for byte.  The
   provisioner's host ms per reconcile (median, max) go on the line.
   (b) The card's node provisioned on demand, over the REST stub: a
   partitioner (``mps``), a scheduler, an operator and ``python -m
   nos_tpu_torch.cmd.provisioner`` (enabled, its in-memory stand-in
   cloud, CAPACITY_KNOBS) as processes; NVLink domain nvl-card holds
   index 0, a one-GPU H100 stand-in (no agent) whose GPU a bound,
   Running 80 GB filler holds, and ``obs capacity`` must render the
   pool 1/1.  A pending 40 GB pod makes the deficit: the provisioner
   must journal PROVISION_REQUESTED for nvl-card-h1; once the stand-in
   cloud's operation is DONE (its flight block), the smoke plays the new
   VM's kubelet: the Node with the create's labels, then the chip agent
   main for it on the card (``model: auto``).  The agent's report lands
   it (PROVISION_LANDED), the pod binds there, ``obs capacity`` renders
   2/2, and the pod's child (``cmd.train`` under the grant derived from
   the stub's objects, train_main's configuration for GRANT_STEPS
   steps) must pass as grant (a)'s.  The pod completes and is deleted:
   the provisioner must release the empty node (its cloud delete, the
   Node's deletion committed before the size record returns to 1) and
   journal SCALE_DOWN; ``obs capacity`` renders 1/1, no breaker is open,
   ``/metrics`` counts one request, one landing and one scale-down, and
   every main exits 0 on SIGTERM.  The line carries pending to
   requested, requested to joined and landed, landed to bound, bound to
   the child's first step and deleted to SCALE_DOWN, and each main's
   ``provisioning`` GPU-seconds (the holds live in the provisioner's
   process); the child's launches are the kernels line's ``capacity``
   path.
18. sim: the simulator on the host, touching no GPU.  (a) ``python -m
   nos_tpu_torch.sim --smoke`` twice, with ``--seed 1`` and with
   ``--what-if hosts=+120`` (one day, 480 nodes of 8 GPUs), four child
   processes at once; (b) then the default week, 10,000 nodes of 8 GPUs
   over 7 days.  Each child must print one JSON line whose report, less
   its wall time, hashes to ``SIM_DIGESTS`` (the JAX package's report of
   the same arguments) with a conserving ledger, and exit as JAX's run
   does (``SIM_RUNS``: seed 1's day fails the gate in both, two breaches
   unexplained).  (c) In process, ``assemble_control_plane`` on JAX's
   small scenario in the port's names (two 8-GPU H100 MIG nodes, a
   quota, two pods of eight 7g.80gb; a node killed at 4 s),
   event-styled and tick-styled: equal journals at
   ``SIM_HARNESS_DIGEST``, both pods Running; the host ms of each tick
   go on the line.  The kubelet device plugins are not run: the card's
   machine has no grpcio.
19. fleet: the native scheduling shim on the host, touching no GPU: its
   build report (phase 2 built it) and GIL handshake, then (a) the 1024-node MIG plan at 1
   and 4 plan workers and (b) the 1024-node scheduler cycle, each with
   the native paths and without them, to the same decisions.
20. determinism: the port's analyzer and its dual-run harness on the
   host, touching no GPU.  (a) ``nos_tpu_torch.analysis.run`` with
   ``default_rules()`` (N001-N012) over ``nos_tpu_torch/``: any
   violation fails.  (b) The harness's 12-cell matrix
   (``PYTHONHASHSEED`` 0, 1, random x plan workers 1, 4 x the watch-fed
   scheduler cache or a full rescan each cycle), 2 scheduler cycles: one
   ``python -m nos_tpu_torch.analysis --determinism-child`` per cell,
   DETERMINISM_CHILDREN at a time on the card's host, each reusing the
   shim phase 2 built (none imports torch).  Every journal must be
   byte-identical to the first cell's and longer than
   DETERMINISM_MIN_RECORDS records; a child's non-zero exit or timeout
   fails.  (a) runs in this process while (b)'s children run.  The
   line carries the files, violations, suppressed findings and seconds
   of (a), and of (b) each child's wall and trace seconds and its
   records.
onramp: the deploy on-ramp on the host, touching no GPU:
   ``hack/render-chart-torch.py`` as a process (exit 0; its manifest,
   kind, ConfigMap and CRD counts and the manifests it writes equal to
   the port's renderer's in this process), the two workers of
   ``hack/kind/cluster-torch.yaml`` built with the model the host's
   discovery reads through NVML (one MIG node, one MPS node), and the
   example pods of ``deploy/config-torch/`` planned and bound over them
   by the port's partitioners, node agents (the MIG agent on the fake
   runtime) and scheduler in memory: the training pod on the MIG node,
   the serving replica on the MPS node.
21. demo: the GPU sharing demo (``demos/gpu-sharing-comparison/run.py``),
   its own functions at its full sizes: seven client processes started
   at once, each under a timeshare grant of the card (its UUID, GRANT_GB
   = 10 GB, through ``workload_env``), each building BENCH_350M (flash
   attention, no remat, fp32 parameters from one seed) and warming it;
   the rows at 1, 2, 4 and 7 clients release the first N at one
   instant, each client a warm request and 6 timed requests of the
   8 x 2048 forward's last-position logits summed and fetched.  It fails
   unless every row holds clients x 6 requests, every client launched
   24 K1 a request (warm ones included) and no other kernel, all the
   clients' scalars and last logits are bitwise equal, those logits are
   within LOGITS_TOL of the same forward with dense attention (computed
   in this process once), the dense model with non-causal attention
   moves those logits past LOGITS_TOL (the limit can see a wrong K1 at
   this shape), and no client's peak reserved memory reached its cap.  The rows and the summary (the dedicated mean and the
   degradation ratios) come on lines before the phase's; the isolated
   row is skipped on a one-card host.  No speed limit is set.
22. mfu: the MFU sweep (``scripts/mfu_explore_torch.py``), its quick
   variants (batch 8 unfused, 8 fused, 16 fused; "mats" remat; seq
   2048) through ``ShardedTrainer`` on a one-rank mesh in this process,
   the launch counts zeroed just before and read just after: each row a
   band of ms per step over 3 repeats of 4 steps (CUDA events), tokens/s
   and MFU over ``peaks_for``, peak memory and the launches per step.
   It fails on an ``error`` row, a first warm-up loss off
   EXPECTED_LOSS0 by more than LOSS0_TOL, a non-finite loss, an MFU
   outside (0, 1], or a row whose steps launched no K1 or none of the
   backward kernels the trainer routes to.

The host-only work, (a) of phases 11 to 17, phases 18 to 20 and the
on-ramp whole,
runs in one background process started after phase 7 (HOST_JOBS, at
nice HOST_NICE, in the order the phases read it) while this process
drives the card phases: a phase waits for its part where it reads it,
and a check that fails there fails the smoke with its message.  The
lines come out in the phases' order.  Their host ms are taken beside
the card phases, on a shared host, and are not for comparison between
runs (``scripts/time_native_fleet.py`` is phase 19's A/B).

Phases 21 and 22 run after the host lines.  Then the kernel summary
line (one entry per compiled tile, with its launches by path, the gang,
recovery, mains, elastic, serving, capacity and demo children's among
them; a tile no path ran must have run in the autotune phase), the
card's ``name, power.limit`` and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import datetime
import functools
import gc
import json
import logging
import math
import pathlib
import re
import statistics
import subprocess
import signal
import sys
import tempfile
import threading
import time
from typing import Callable, NoReturn

import torch

O_TOL = 2e-2       # bf16 o: a few bf16 ulps of |o| <= ~1
LSE_TOL = 1e-3     # fp32 row statistics
# dq, dk and dv: within 2e-2 of the reference's max |value| (the JAX
# package's rule for its backward kernels, tests/test_compute.py), and
# the fused backward within 3e-2 of the split one.
GRAD_TOL = 2e-2
FUSED_SPLIT_TOL = 3e-2
# Flash vs dense logits: both paths round to bf16 at every layer, in a
# different order, through 24 layers.  |logit| averages ~0.5 (std 0.02 x
# sqrt(1024) from the tied embedding after the final norm).  The serve
# phase prints that average and the reading of a non-causal attention,
# and fails if the latter is within this limit.
LOGITS_TOL = 0.1


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> NoReturn:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, inner: int = 10, samples: int = 25) -> float:
    """Median device ms per call.  A sleep kernel holds the stream while
    the host queues each sample, so the events bracket device work and
    not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(samples):
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_env() -> str:
    from nos_tpu_torch.ops.roofline import card_line

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card_line("cuda")
    emit({"phase": "env", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return smi


# name -> (source, kernel function, design): one name per compiled tile,
# the default tile's under the kernel's own name.
KERNELS = {
    "flash_fwd": ("flash_fwd", "flash_fwd_kernel", "wgmma+tma"),
    "flash_fwd_64x64": ("flash_fwd", "flash_fwd_kernel", "wgmma+tma"),
    "flash_bwd_fused": ("flash_bwd", "flash_bwd_kernel", "wgmma+tma"),
    "flash_bwd_fused_64x64": ("flash_bwd", "flash_bwd_kernel", "wgmma+tma"),
    "flash_dq": ("flash_bwd_split", "flash_dq_kernel", "wgmma+tma"),
    "flash_dq_64x64": ("flash_bwd_split", "flash_dq_kernel", "wgmma+tma"),
    "flash_dkv": ("flash_bwd_split", "flash_bwd_kernel", "wgmma+tma"),
    "flash_dkv_64x64": ("flash_bwd_split", "flash_bwd_kernel", "wgmma+tma"),
}
# name -> (the wrapper's kernel in ops.attention.KERNEL_TILES, its tile
# (block_q, block_k), the template arguments of the compiled instance as
# ptxas's mangled entry name spells them).
TILES = {
    "flash_fwd": ("flash_fwd", (128, 128), "ILi2ELi128EE"),
    "flash_fwd_64x64": ("flash_fwd", (64, 64), "ILi1ELi64EE"),
    "flash_bwd_fused": ("flash_bwd_fused", (64, 128), "ILb1ELi2ELi2EE"),
    "flash_bwd_fused_64x64": ("flash_bwd_fused", (64, 64),
                              "ILb1ELi2ELi1EE"),
    "flash_dq": ("flash_dq", (128, 64), "ILi2ELi4EE"),
    "flash_dq_64x64": ("flash_dq", (64, 64), "ILi1ELi2EE"),
    "flash_dkv": ("flash_dkv", (64, 128), "ILb0ELi4ELi2EE"),
    "flash_dkv_64x64": ("flash_dkv", (64, 64), "ILb0ELi2ELi1EE"),
}


def phase_build() -> dict[str, dict]:
    """Build every source, and the native scheduling shim after them
    (so that no later phase, nor the host work beside the card phases,
    adds a library to the directory); per compiled tile of KERNELS,
    ptxas's registers (at entry) and spill bytes (None where the library
    came from the cache)."""
    from nos_tpu_torch.device import native
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    shim = native.build_report()
    resources = {}
    for name, (source, function, _) in KERNELS.items():
        entry = function + TILES[name][2]
        found = [r for fn, r in _build.ptxas_resources(
            report[source]["ptxas"]).items() if entry in fn]
        resources[name] = found[0] if len(found) == 1 else {
            "registers": None, "spill_stores": None, "spill_loads": None}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": report, "resources": resources,
          "shim": {"cached": shim["cached"], "seconds": shim["seconds"],
                   "library": str(shim["path"].relative_to(ROOT))}})
    return resources


def _qkv(gen, b, s, h, d=128, kv_heads=None):
    """q, k, v [b, s, h, d]; with ``kv_heads``, k and v are drawn at that
    many heads and repeated to h as the model's ``repeat_kv`` does."""
    from nos_tpu_torch.ops.attention import repeat_kv

    kv = h if kv_heads is None else kv_heads
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for n in (h, kv, kv))
    return [q, repeat_kv(k, h // kv), repeat_kv(v, h // kv)]


def _errors(q, k, v, causal, tile=None, ref=None):
    """(max |o - plain o|, max |lse - plain lse|) of K1 at ``tile`` (None:
    its default); ``ref`` is the plain version's (o, lse) where the
    caller has it."""
    from nos_tpu_torch.ops import attention as A

    o, lse = A.flash_attention_fwd(q, k, v, causal, tile)
    o_ref, lse_ref = (A.flash_attention_fwd_reference(q, k, v, causal)
                      if ref is None else ref)
    torch.cuda.synchronize()
    if o.shape != o_ref.shape or lse.shape != lse_ref.shape:
        fail(f"flash_fwd shapes {tuple(o.shape)}/{tuple(lse.shape)}")
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        fail("flash_fwd produced non-finite values")
    return ((o.float() - o_ref.float()).abs().max().item(),
            (lse - lse_ref).abs().max().item())


def _bound(flops: float, nbytes: float, peaks) -> dict:
    t_ops = flops / peaks[0] * 1e3
    t_bytes = nbytes / peaks[1] * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (floored at 1e-3: where a gradient
    is 0 in exact arithmetic both sides hold only rounding)."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-3)).item()


def _bwd_inputs(gen, b, s, h, causal, views=False, kv_heads=None):
    """q, k, v, dO (views into one wider tensor when ``views``; k and v
    grouped as ``_qkv`` makes them with ``kv_heads``) and the plain
    forward's lse and delta, so kernel and plain version see the same
    inputs."""
    from nos_tpu_torch.ops import attention as A

    if views:
        wide = torch.randn(b, s, h, 4 * 128, generator=gen, device="cuda",
                           dtype=torch.bfloat16)
        q, k, v, do = (wide[..., i * 128:(i + 1) * 128] for i in range(4))
    else:
        q, k, v = _qkv(gen, b, s, h, kv_heads=kv_heads)
        do = torch.randn(b, s, h, 128, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    o, lse = A.flash_attention_fwd_reference(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _bwd_kernels():
    """name -> (wrapper, plain version, TPU kernel replaced, source,
    matrix products per block pair, outputs)."""
    from nos_tpu_torch.ops import attention as A

    return {
        "flash_bwd_fused": (
            A.flash_attention_bwd_fused,
            A.flash_attention_bwd_fused_reference,
            "nos_tpu/ops/attention.py:336", "flash_bwd.cu", 5, 3),
        "flash_dq": (
            lambda *a: (A.flash_attention_dq(*a),),
            lambda *a: (A.flash_attention_dq_reference(*a),),
            "nos_tpu/ops/attention.py:267", "flash_bwd_split.cu", 3, 1),
        "flash_dkv": (
            A.flash_attention_dkv, A.flash_attention_dkv_reference,
            "nos_tpu/ops/attention.py:299", "flash_bwd_split.cu", 4, 2),
    }


def _sdpa_ms(q, k, v) -> float:
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))


def _sdpa_backward_ms(q, k, v, do) -> float:
    """One scaled_dot_product_attention backward at the same shape, timed
    as torch.autograd.grad over a graph retained from one forward."""
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                               retain_graph=True),
                   inner=5, samples=10)


# The MFU sweep's largest quick batch (phase 22): BENCH_350M's 8 heads
# over 4 K/V heads.
SWEEP_CASE, SWEEP_SHAPE, SWEEP_KV_HEADS = (
    "sweep B16 S2048 H8 kv4 causal", (16, 2048, 8), 4)


# Sequence lengths around the tile edges (K1: 128 or 64 q rows and 128 or
# 64 keys; K2 and K4: 128 or 64 keys and 64 q rows; K3: 128 or 64 q rows
# and 64 keys), and one ragged length.
EDGE_SEQS = (1, 63, 64, 65, 127, 128, 129, 200)
# The long-context row: at 8 heads and batch 1 the JAX rule's dq partials
# are 2^31 bytes, past FUSED_PARTIAL_BUDGET, so the split pair runs.
LONG_SHAPE = (1, 32768, 8)


def _design(name: str, resources: dict) -> dict:
    """The kernel's design and ptxas's registers (at entry, before any
    setmaxnreg) and spill bytes from this run's build."""
    return {"design": KERNELS[name][2],
            "ptxas_registers": resources[name]["registers"],
            "ptxas_spill_bytes": {"stores": resources[name]["spill_stores"],
                                  "loads": resources[name]["spill_loads"]}}


def _tiles_of(kernel: str) -> list[tuple[str, tuple[int, int]]]:
    """(name, tile) of every compiled tile of ``kernel``, default first."""
    return [(name, tile) for name, (k, tile, _) in TILES.items()
            if k == kernel]


def phase_kernels(resources: dict) -> list[dict]:
    from nos_tpu_torch.ops import attention as A
    from nos_tpu_torch.ops.roofline import peaks_for

    peaks = peaks_for(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    fwd_tiles = _tiles_of("flash_fwd")

    # K1, the forward, at every tile: the serving shape, ragged and
    # strided cases, and the MFU sweep's grouped B16 shape.
    checks = []
    b, s, h, d = 8, 512, 8, 128          # the serving shape
    q, k, v = _qkv(gen, b, s, h, d)
    cases = [("serving B8 S512 H8 causal", (q, k, v), True)]
    for seq in EDGE_SEQS:
        for causal in (True, False):
            cases.append((f"ragged B2 S{seq} H4 causal={causal}",
                          tuple(_qkv(gen, 2, seq, 4)), causal))
    # strided: q/k/v are views into wider rows (row stride 2*H*D)
    wide = torch.randn(2, 130, 4, 256, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    cases.append(("strided B2 S130 H4 causal=True",
                  (wide[..., :128], wide[..., 128:], wide[..., 64:192]), True))
    cases.append((SWEEP_CASE, tuple(_qkv(gen, *SWEEP_SHAPE,
                                         kv_heads=SWEEP_KV_HEADS)), True))
    for case, (cq, ck, cv), causal in cases:
        ref = A.flash_attention_fwd_reference(cq, ck, cv, causal)
        for name, tile in fwd_tiles:
            o_err, lse_err = _errors(cq, ck, cv, causal, tile, ref)
            checks.append({"kernel": name, "case": case,
                           "o_max_abs_err": o_err, "lse_max_abs_err": lse_err})
            if not (o_err <= O_TOL and lse_err <= LSE_TOL):
                fail(f"{name} vs plain at {case}: o {o_err} (tol {O_TOL}), "
                     f"lse {lse_err} (tol {LSE_TOL})")

    serving_plain = time_ms(
        lambda: A.flash_attention_fwd_reference(q, k, v, True))
    serving_sdpa = _sdpa_ms(q, k, v)
    serving_bound = _bound(2 * b * h * s * s * d,   # causal: half of 4BHS^2D
                           4 * b * s * h * d * 2 + b * h * s * 4, peaks)
    serving = {name: {
        "ms": time_ms(lambda t=tile: A.flash_attention_fwd(q, k, v, True, t)),
        "plain_ms": serving_plain, "library_ms": serving_sdpa,
        **serving_bound} for name, tile in fwd_tiles}
    # the backward kernels at the serving shape, for the tile comparison
    sq, sk, sv, sdo, slse, sdelta = _bwd_inputs(gen, b, s, h, True)
    del q, k, v

    # The training shape: K1 and the three backward kernels.
    b, s, h = 8, 2048, 8
    bhs2d = b * h * s * s * d                   # one causal S x S x D product
    act = b * s * h * d * 2                     # one bf16 [B, S, H, D]
    stat = b * h * s * 4                        # one fp32 [B, H, S]
    tq, tk, tv, tdo, tlse, tdelta = _bwd_inputs(gen, b, s, h, True)
    train_plain = time_ms(
        lambda: A.flash_attention_fwd_reference(tq, tk, tv, True),
        inner=2, samples=5)
    train_sdpa = _sdpa_ms(tq, tk, tv)
    train_bound = _bound(2 * bhs2d, 4 * act + stat, peaks)
    train_fwd = {name: {
        "ms": time_ms(lambda t=tile: A.flash_attention_fwd(
            tq, tk, tv, True, t)),
        "plain_ms": train_plain, "library_ms": train_sdpa,
        **train_bound} for name, tile in fwd_tiles}
    ref = A.flash_attention_fwd_reference(tq, tk, tv, True)
    for name, tile in fwd_tiles:
        o_err, lse_err = _errors(tq, tk, tv, True, tile, ref)
        checks.append({"kernel": name, "case": "training B8 S2048 H8 "
                       "causal", "o_max_abs_err": o_err,
                       "lse_max_abs_err": lse_err})
        if not (o_err <= O_TOL and lse_err <= LSE_TOL):
            fail(f"{name} vs plain at the training shape: o {o_err}, "
                 f"lse {lse_err}")
    del ref

    bwd_cases = [("training B8 S2048 H8 causal",
                  (tq, tk, tv, tdo, tlse, tdelta), True)]
    for seq in EDGE_SEQS:
        for causal in (True, False):
            bwd_cases.append((f"ragged B2 S{seq} H4 causal={causal}",
                              _bwd_inputs(gen, 2, seq, 4, causal), causal))
    bwd_cases.append(("strided B2 S130 H3 causal=True",
                      _bwd_inputs(gen, 2, 130, 3, True, views=True), True))
    bwd_cases.append((SWEEP_CASE, _bwd_inputs(
        gen, *SWEEP_SHAPE, True, kv_heads=SWEEP_KV_HEADS), True))
    kernels = _bwd_kernels()
    errs = {name: 0.0 for name in TILES}
    outputs = {}
    for case, args, causal in bwd_cases:
        for kernel, (fn, plain, *_rest) in kernels.items():
            want = plain(*args, causal)
            for name, tile in _tiles_of(kernel):
                got = fn(*args, causal, tile)
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if g.shape != w.shape or not torch.isfinite(g).all():
                        fail(f"{name} at {case}: shape {tuple(g.shape)} or "
                             f"non-finite values")
                err = max(_rel_err(g, w) for g, w in zip(got, want))
                checks.append({"kernel": name, "case": case,
                               "max_rel_err": err})
                if not err <= GRAD_TOL:
                    fail(f"{name} vs plain at {case}: {err} of max |ref| "
                         f"(tol {GRAD_TOL})")
                errs[name] = max(errs[name], err)
                if case.startswith("training") and name == kernel:
                    outputs[name] = got
                del got
            del want
    fused, split = outputs["flash_bwd_fused"], (
        *outputs["flash_dq"], *outputs["flash_dkv"])
    fused_vs_split = max(
        ((f.float() - t.float()).abs().max()
         / t.float().abs().max()).item() for f, t in zip(fused, split))
    if not fused_vs_split <= FUSED_SPLIT_TOL:
        fail(f"fused vs split backward at the training shape: "
             f"{fused_vs_split} (tol {FUSED_SPLIT_TOL})")
    del outputs, fused, split, cases, bwd_cases

    targs = (tq, tk, tv, tdo, tlse, tdelta, True)
    # The split pair writes every output row from one CTA after a loop in
    # a fixed order, at every tile: two launches on the same inputs agree
    # bitwise.
    repeat = {}
    for kernel in ("flash_dq", "flash_dkv"):
        for name, tile in _tiles_of(kernel):
            first = kernels[kernel][0](*targs, tile)
            second = kernels[kernel][0](*targs, tile)
            torch.cuda.synchronize()
            repeat[name] = all(torch.equal(x, y)
                               for x, y in zip(first, second))
            if not repeat[name]:
                fail(f"two {name} launches on the training inputs differ")
            del first, second
    library_ms = _sdpa_backward_ms(tq, tk, tv, tdo)
    serving_library_ms = _sdpa_backward_ms(sq, sk, sv, sdo)
    sargs = (sq, sk, sv, sdo, slse, sdelta, True)
    entries = []
    for name, tile in fwd_tiles:
        entries.append({
            "name": name, "route": "cuda",
            "source": "nos_tpu_torch/ops/csrc/flash_fwd.cu",
            "replaces": "nos_tpu/ops/attention.py:171",
            "tile": list(tile), "launches": None, **_design(name, resources),
            "max_abs_err": max(c["o_max_abs_err"] for c in checks
                               if c["kernel"] == name),
            "lse_max_abs_err": max(c["lse_max_abs_err"] for c in checks
                                   if c["kernel"] == name),
            **serving[name], "shape": "serving B8 S512 H8 causal",
            "train_shape": train_fwd[name]})
    sb, ss, sh = sq.shape[0], sq.shape[1], sq.shape[2]
    for kernel, (fn, plain, replaces, source, mats, outs) in kernels.items():
        bound = _bound(mats * bhs2d, (4 + outs) * act + 2 * stat, peaks)
        sbound = _bound(mats * sb * sh * ss * ss * d,
                        (4 + outs) * sb * ss * sh * d * 2
                        + 2 * sb * sh * ss * 4, peaks)
        plain_ms = time_ms(lambda: plain(*targs), inner=1, samples=3)
        serving_plain_ms = time_ms(lambda: plain(*sargs), inner=2, samples=5)
        for name, tile in _tiles_of(kernel):
            entries.append({
                "name": name, "route": "cuda",
                "source": f"nos_tpu_torch/ops/csrc/{source}",
                "replaces": replaces, "tile": list(tile), "launches": None,
                **_design(name, resources),
                "max_abs_err": errs[name],
                "error_measure": "max |kernel - plain| / max |plain|",
                "ms": time_ms(lambda t=tile: fn(*targs, t), inner=5,
                              samples=10),
                "plain_ms": plain_ms,
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": library_ms,
                "library": "SDPA backward (dq, dk and dv), "
                           "torch.autograd.grad on a retained graph",
                "shape": "training B8 S2048 H8 causal",
                "serving_shape": {
                    "ms": time_ms(lambda t=tile: fn(*sargs, t), inner=5,
                                  samples=10),
                    "plain_ms": serving_plain_ms,
                    "bound_ms": sbound["bound_ms"],
                    "bound_by": sbound["bound_by"],
                    "library_ms": serving_library_ms,
                    "shape": "B8 S512 H8 causal"}})
    del tq, tk, tv, tdo, tlse, tdelta, targs, sq, sk, sv, sdo, sargs
    long_rows = _long_context(gen, peaks, kernels)
    for entry in entries:
        if entry["name"] in long_rows:
            entry["long_context"] = long_rows[entry["name"]]
    emit({"phase": "kernels", "checks": checks,
          "tolerance": {"o": O_TOL, "lse": LSE_TOL, "grad": GRAD_TOL,
                        "fused_vs_split": FUSED_SPLIT_TOL},
          "fused_vs_split_rel": fused_vs_split,
          "split_repeat_bitwise": repeat,
          "serving_flash_fwd": serving, "train_flash_fwd": train_fwd,
          "train_backward": {e["name"]: {key: e[key] for key in (
              "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
              for e in entries if "serving_shape" in e},
          "serving_backward": {e["name"]: e["serving_shape"]
                               for e in entries if "serving_shape" in e}})
    return entries


def _long_context(gen, peaks, kernels) -> dict[str, dict]:
    """K2, K3 and K4 at LONG_SHAPE, causal, at every tile: split against
    fused within FUSED_SPLIT_TOL at the default tiles and each tile's
    outputs against the default's, then kernel and SDPA-backward times
    and each bound.  lse comes from K1 (the plain forward would need the
    fp32 scores)."""
    from nos_tpu_torch.ops import attention as A

    b, s, h = LONG_SHAPE
    d = 128
    q, k, v = _qkv(gen, b, s, h)
    do = torch.randn(b, s, h, d, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    impl = A.backward_impl(q, k)
    if impl != "split":
        fail(f"backward_impl picks {impl!r} at B{b} S{s} H{h}, not 'split'")
    o, lse = A.flash_attention_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    del o
    args = (q, k, v, do, lse, delta, True)
    fused = A.flash_attention_bwd_fused(*args)
    split = (A.flash_attention_dq(*args), *A.flash_attention_dkv(*args))
    torch.cuda.synchronize()
    if not all(torch.isfinite(x).all() for x in (*fused, *split)):
        fail(f"non-finite gradients at B{b} S{s} H{h}")
    fused_vs_split = max(
        ((f.float() - t.float()).abs().max()
         / t.float().abs().max()).item() for f, t in zip(fused, split))
    if not fused_vs_split <= FUSED_SPLIT_TOL:
        fail(f"fused vs split backward at B{b} S{s} H{h}: {fused_vs_split} "
             f"(tol {FUSED_SPLIT_TOL})")
    default_out = {"flash_bwd_fused": fused, "flash_dq": split[:1],
                   "flash_dkv": split[1:]}
    library_ms = _sdpa_backward_ms(q, k, v, do)
    bhs2d = b * h * s * s * d
    act, stat = b * s * h * d * 2, b * h * s * 4
    rows, vs_default = {}, {}
    for kernel, (fn, _plain, _rep, _src, mats, outs) in kernels.items():
        bound = _bound(mats * bhs2d, (4 + outs) * act + 2 * stat, peaks)
        for name, tile in _tiles_of(kernel):
            if name != kernel:
                got = fn(*args, tile)
                torch.cuda.synchronize()
                vs_default[name] = max(_rel_err(g, w) for g, w in zip(
                    got, default_out[kernel]))
                del got
                if not vs_default[name] <= FUSED_SPLIT_TOL:
                    fail(f"{name} against {kernel} at B{b} S{s} H{h}: "
                         f"{vs_default[name]} (tol {FUSED_SPLIT_TOL})")
            rows[name] = {
                "ms": time_ms(lambda t=tile: fn(*args, t), inner=5,
                              samples=10),
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": library_ms,
                "shape": f"B{b} S{s} H{h} causal"}
    del fused, split, default_out
    emit({"phase": "long_context", "shape": f"B{b} S{s} H{h} causal",
          "backward_impl": impl, "fused_vs_split_rel": fused_vs_split,
          "variant_vs_default_rel": vs_default,
          "tolerance": FUSED_SPLIT_TOL, "kernels": rows})
    return rows


# The autotune phase's shapes: serving and training, causal.
AUTOTUNE_SHAPES = ((8, 512, 8), (8, 2048, 8))


def _no_measured_cache(tmp: str) -> None:
    """Point the autotune cache at a file that does not exist, so that
    lookups see the committed PRETUNED table only."""
    import os

    from nos_tpu_torch.ops import autotune as T

    os.environ[T._CACHE_ENV] = str(pathlib.Path(tmp) / "none.json")
    T.reload_cache()
    if T._load_cache():
        fail("a measured autotune cache is visible to the run")


def phase_autotune() -> dict:
    """``tune_and_record`` at AUTOTUNE_SHAPES into a cache in a temporary
    directory, with every candidate's ms; ``lookup`` must return the
    recorded winners, in this process and from the file.  Then the split
    backward's candidates searched at the training shape (not recorded),
    and an explicit pair no kernel is compiled for, which must raise in
    the op and be refused by the C entry point."""
    import os

    from nos_tpu_torch.ops import attention as A
    from nos_tpu_torch.ops import autotune as T

    gen = torch.Generator(device="cuda").manual_seed(3)
    kind = torch.cuda.get_device_name(0)
    results = {}
    _zero_launch_counts()
    with tempfile.TemporaryDirectory(prefix="nos-autotune-") as tmp:
        path = pathlib.Path(tmp) / "flash_autotune.json"
        os.environ[T._CACHE_ENV] = str(path)
        T.reload_cache()
        for b, s, h in AUTOTUNE_SHAPES:
            q, k, v = _qkv(gen, b, s, h)
            res = T.tune_and_record(q, k, v, True)
            for reload in (False, True):
                if reload:
                    T.reload_cache()
                for pass_ in ("fwd", "bwd"):
                    got = T.lookup(kind, pass_, s, 128, "bfloat16", True)
                    if got is None or list(got) != res[pass_]:
                        fail(f"autotune lookup {pass_} at S{s} gave {got}, "
                             f"recorded {res[pass_]} (reloaded: {reload})")
            for pass_ in ("fwd", "bwd"):
                tile = A._tile_for(
                    "flash_fwd" if pass_ == "fwd" else "flash_bwd_fused",
                    q, k, True, None, None)
                if list(tile) != res[pass_]:
                    fail(f"the op resolves {tile} for {pass_} at S{s}, "
                         f"the cache holds {res[pass_]}")
            results[f"B{b} S{s} H{h} causal"] = res
        entries = json.loads(path.read_text())["entries"]
        prev = A.set_backward_impl("split")
        try:
            split_best, split_times = T.search("bwd", q, k, v, True)
        finally:
            A.set_backward_impl(prev)
        refused = {}
        for label, call in (
                ("op forward (32, 32)",
                 lambda: A.flash_attention(q, k, v, True, 32, 32)),
                ("op backward (128, 128)",
                 lambda: A.flash_attention(
                     *(x.detach().requires_grad_() for x in (q, k, v)),
                     True, 128, 128).sum().backward()),
                ("C entry nos_flash_fwd (32, 32)",
                 lambda: A._run("nos_flash_fwd", [
                     q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     o.data_ptr(), lse.data_ptr()], q, k,
                     A._strides(q, k, v, o), True, (32, 32)))):
            o, lse = torch.empty_like(q), torch.empty(
                b, h, s, device="cuda", dtype=torch.float32)
            try:
                call()
            except (ValueError, RuntimeError) as e:
                refused[label] = f"{type(e).__name__}: {e}"
            else:
                fail(f"{label}: an uncompiled tile ran")
        # cudaErrorInvalidValue, not a launch at another tile
        if not refused["C entry nos_flash_fwd (32, 32)"].endswith(
                "CUDA error 1"):
            fail(f"nos_flash_fwd at (32, 32): {refused}")
        torch.cuda.synchronize()
        del q, k, v
    PATH_TILES["autotune"] = _tile_counts()
    out = {"phase": "autotune", "device_class": T.device_class(kind),
           "results": results, "cache_entries": entries,
           "split_search_ms": {f"{bq}x{bk}": t * 1e3
                               for (bq, bk), t in split_times.items()},
           "split_best": list(split_best), "refused": refused,
           "tile_launches": PATH_TILES["autotune"]}
    emit(out)
    return out


def _noncausal_logits(dense, tokens: torch.Tensor) -> torch.Tensor:
    """Logits of ``dense`` with its attention made non-causal: the wrong
    answer the logits limit must reject."""
    from nos_tpu_torch.models import llama as L

    causal_attention = L.dense_attention
    L.dense_attention = lambda q, k, v, causal: causal_attention(
        q, k, v, causal=False)
    try:
        with torch.no_grad():
            return dense(tokens)
    finally:
        L.dense_attention = causal_attention


def phase_serve() -> dict[str, int]:
    from nos_tpu_torch.entry import (PROMPT_LEN, SERVE_BATCH, STEPS,
                                     bench_model, serve_prompt)
    from nos_tpu_torch.models.generate import generate
    from nos_tpu_torch.models.llama import Llama

    model = bench_model(device="cuda")
    cfg = model.cfg
    prompt = serve_prompt("cuda")

    _zero_launch_counts()
    out = generate(model, prompt, STEPS)
    torch.cuda.synchronize()
    launches = _launch_counts()
    PATH_TILES["serve"] = _tile_counts()
    _check_launches("the serve run", launches, {
        "flash_fwd": STEPS * cfg.num_layers, "flash_bwd_fused": 0,
        "flash_dq": 0, "flash_dkv": 0})
    total = PROMPT_LEN + STEPS
    if tuple(out.shape) != (SERVE_BATCH, total):
        fail(f"generate returned {tuple(out.shape)}")
    if not torch.equal(out[:, :PROMPT_LEN], prompt):
        fail("generate changed the prompt")
    if not ((out >= 0) & (out < cfg.vocab_size)).all():
        fail("generated tokens outside the vocabulary")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    again = generate(model, prompt, STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if not torch.equal(out, again):
        fail("a second generate run gave other tokens")
    peak = torch.cuda.max_memory_allocated()

    dense = Llama(dataclasses.replace(cfg, attn_impl="dense"), device="cuda")
    dense.load_state_dict(model.state_dict(), assign=True)
    with torch.no_grad():
        logits_flash = model(out)
        logits_dense = dense(out)
    torch.cuda.synchronize()
    if not (torch.isfinite(logits_flash).all()
            and torch.isfinite(logits_dense).all()):
        fail("non-finite logits")
    diff = (logits_flash - logits_dense).abs().max().item()
    if diff > LOGITS_TOL:
        fail(f"flash vs dense logits differ by {diff} (tol {LOGITS_TOL})")
    del logits_flash
    wrong_diff = (_noncausal_logits(dense, out)
                  - logits_dense).abs().max().item()
    if not wrong_diff > LOGITS_TOL:
        fail(f"a non-causal attention moves the logits by only {wrong_diff}"
             f", within the limit {LOGITS_TOL}: the check cannot see it")
    emit({"phase": "serve", "model": "BENCH_350M", "layers": cfg.num_layers,
          "param_count": model.param_count(), "batch": SERVE_BATCH,
          "prompt_len": PROMPT_LEN, "steps": STEPS, "launches": launches,
          "tile_launches": PATH_TILES["serve"],
          "ms_per_step": seconds / STEPS * 1e3,
          "tokens_per_s": SERVE_BATCH * STEPS / seconds,
          "peak_mem_bytes": peak,
          "logits_max_abs_diff_vs_dense": diff,
          "logits_max_abs_diff_noncausal": wrong_diff,
          "logits_max_abs": logits_dense.abs().max().item(),
          "logits_mean_abs": logits_dense.abs().mean().item(),
          "logits_tol": LOGITS_TOL})
    return launches


# Step 0's loss on random weights: ln(vocab) plus half the logit
# variance.  After the final norm (scale 1) each activation row has unit
# RMS, so a logit x . e_v with e_v ~ N(0, 0.02^2) has variance
# 1024 * 0.02^2 = 0.41, and E[log sum exp] = ln 32000 + 0.41 / 2 for
# Gaussian logits: 10.58.  The target's own logit has mean 0.
EXPECTED_LOSS0 = math.log(32000) + 1024 * 0.02 ** 2 / 2
LOSS0_TOL = 0.2
# Flash vs dense at 4 layers: bf16 activations, and the kernels round p
# and ds to bf16 where the dense autograd keeps fp32, so the loss agrees
# to ~1e-3 and each gradient to a few bf16 ulps of its largest entry.
CUT_LOSS_TOL = 1e-2
CUT_GRAD_TOL = 5e-2
# Two loss-and-gradient passes from one state on one batch, under each
# backward.  The forward sums in a fixed order, so the losses must repeat
# bitwise, and so must the split pair's gradients (K3 and K4 sum in a
# fixed order).  The fused backward adds dq by fp32 reductions from many
# CTAs whose order may vary, so a dq entry may round to the neighbouring
# bf16 value, and the difference grows through 24 layers of bf16
# backward: two fused passes are two computations that may differ in
# rounding, as flash and dense do, and are held to the same CUT_GRAD_TOL
# of each gradient's largest |value|.  The earlier kernel (scalar atomics)
# read 1.6e-2, at layer 0's q projection, whose gradient is small at init
# (attention near uniform); a race in the kernel would move a gradient by
# O(1).
REPEAT_GRAD_TOL = CUT_GRAD_TOL
CUT_LAYERS = 4
TRAIN_UNTIMED, TRAIN_TIMED = 2, 10


def _launch_counts() -> dict[str, int]:
    from nos_tpu_torch.ops import attention as A

    return {"flash_fwd": A.FLASH_FWD_LAUNCHES,
            "flash_bwd_fused": A.FLASH_BWD_FUSED_LAUNCHES,
            "flash_dq": A.FLASH_DQ_LAUNCHES,
            "flash_dkv": A.FLASH_DKV_LAUNCHES}


def _zero_launch_counts() -> None:
    from nos_tpu_torch.ops import attention as A

    A.FLASH_FWD_LAUNCHES = A.FLASH_BWD_FUSED_LAUNCHES = 0
    A.FLASH_DQ_LAUNCHES = A.FLASH_DKV_LAUNCHES = 0
    A.TILE_LAUNCHES.clear()


def _tile_counts() -> dict[str, int]:
    """Launches by compiled tile (the names of TILES)."""
    from nos_tpu_torch.ops import attention as A

    return {name: A.TILE_LAUNCHES[(kernel, tile)]
            for name, (kernel, tile, _) in TILES.items()}


# Each phase's launches by compiled tile, read where it reads its
# launches: which tile each kernel ran on each path.
PATH_TILES: dict[str, dict[str, int]] = {}


def _step_counted(trainer, batch) -> tuple[float, dict[str, int]]:
    before = _launch_counts()
    loss = trainer.train_step(batch).item()
    return loss, {k: v - before[k] for k, v in _launch_counts().items()}


def _grads_of(trainer, batch, impl: str) -> tuple[float, dict]:
    from nos_tpu_torch.ops import attention as A

    prev = A.set_backward_impl(impl)
    try:
        loss = trainer.loss_and_grads(batch).item()
    finally:
        A.set_backward_impl(prev)
    return loss, {n: p.grad.detach().clone()
                  for n, p in trainer.model.named_parameters()}


def _worst_grad_err(got: dict, want: dict) -> tuple[float, str]:
    return max((_rel_err(got[n], want[n]), n) for n in want)


def _check_launches(label: str, got: dict, want: dict) -> None:
    if got != want:
        fail(f"{label}: kernel launches {got}, expected {want}")


def phase_train() -> tuple[dict[str, int], float]:
    from nos_tpu_torch.entry import (TRAIN_BATCH, TRAIN_SEQ, bench_trainer,
                                     train_loader)
    from nos_tpu_torch.ops import attention as A
    from nos_tpu_torch.ops.roofline import model_flops_per_step, peaks_for

    trainer = bench_trainer("cuda")
    cfg = trainer.cfg
    layers = cfg.num_layers
    loader = train_loader()
    per_fused = {"flash_fwd": layers, "flash_bwd_fused": layers,
                 "flash_dq": 0, "flash_dkv": 0}
    per_split = {"flash_fwd": layers, "flash_bwd_fused": 0,
                 "flash_dq": layers, "flash_dkv": layers}
    if A.set_backward_impl("fused") != "fused":
        fail("the default flash backward is not the fused one")

    losses, step_launches = [], []
    _zero_launch_counts()
    for i in range(TRAIN_UNTIMED):
        loss, launches = _step_counted(trainer, loader.batch_at(i))
        losses.append(loss)
        step_launches.append(launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = []
    # An event between steps: the stream's time from one step's first
    # kernel to the next's, gaps the host leaves included.
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TRAIN_TIMED + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    for j, i in enumerate(range(TRAIN_UNTIMED, TRAIN_UNTIMED + TRAIN_TIMED)):
        timed.append(trainer.train_step(loader.batch_at(i)))
        marks[j + 1].record()
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / TRAIN_TIMED
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    peak = torch.cuda.max_memory_allocated()
    losses += [x.item() for x in timed]
    A.set_backward_impl("split")
    try:
        split_loss, split_launches = _step_counted(
            trainer, loader.batch_at(TRAIN_UNTIMED + TRAIN_TIMED))
    finally:
        A.set_backward_impl("fused")
    torch.cuda.synchronize()
    launches = _launch_counts()
    PATH_TILES["train"] = _tile_counts()
    losses.append(split_loss)
    n_fused = TRAIN_UNTIMED + TRAIN_TIMED
    want = {k: n_fused * per_fused[k] + per_split[k] for k in per_fused}
    _check_launches("the train run", launches, want)
    for i, got in enumerate(step_launches):
        _check_launches(f"fused step {i}", got, per_fused)
    _check_launches("the split step", split_launches, per_split)
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training loss: {losses}")
    if not abs(losses[0] - EXPECTED_LOSS0) <= LOSS0_TOL:
        fail(f"step 0 loss {losses[0]}, expected {EXPECTED_LOSS0} +- "
             f"{LOSS0_TOL}")

    flops = model_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    peak_flops = peaks_for(torch.cuda.get_device_name(0))[0]

    # Two passes from the initial state on batch 0, under each backward.
    trainer.init_state(0)
    repeat = {}
    for impl in ("fused", "split"):
        (loss_a, g_a), (loss_b, g_b) = (
            _grads_of(trainer, loader.batch_at(0), impl) for _ in range(2))
        err, worst_leaf = _worst_grad_err(g_b, g_a)
        repeat[impl] = {
            "losses": [loss_a, loss_b], "max_grad_rel": err,
            "worst_param": worst_leaf,
            "bitwise": all(torch.equal(g_a[n], g_b[n]) for n in g_a)}
        del g_a, g_b
        if loss_a != loss_b:
            fail(f"two {impl} passes from one state: losses {loss_a} and "
                 f"{loss_b} (the forward must repeat bitwise)")
    if not repeat["split"]["bitwise"]:
        fail(f"two split backward passes from one state differ: "
             f"{repeat['split']}")
    if not repeat["fused"]["max_grad_rel"] <= REPEAT_GRAD_TOL:
        fail(f"two fused backward passes from one state differ by "
             f"{repeat['fused']['max_grad_rel']} of a gradient's max "
             f"|value| (tol {REPEAT_GRAD_TOL}) at "
             f"{repeat['fused']['worst_param']}")
    param_count = trainer.model.param_count()
    del trainer

    # The cut depth: flash (fused, split) against dense attention.
    batch = loader.batch_at(0)
    flash = bench_trainer("cuda", num_layers=CUT_LAYERS)
    loss_f, g_f = _grads_of(flash, batch, "fused")
    loss_s, g_s = _grads_of(flash, batch, "split")
    del flash
    dense = bench_trainer("cuda", num_layers=CUT_LAYERS, attn_impl="dense")
    loss_d, g_d = _grads_of(dense, batch, "fused")
    del dense
    flash_vs_dense, worst = _worst_grad_err(g_f, g_d)
    fused_vs_split, worst_fs = _worst_grad_err(g_f, g_s)
    if not (abs(loss_f - loss_d) <= CUT_LOSS_TOL
            and flash_vs_dense <= CUT_GRAD_TOL):
        fail(f"{CUT_LAYERS}-layer flash vs dense: loss {loss_f} vs "
             f"{loss_d}, gradients {flash_vs_dense} at {worst} (tol "
             f"{CUT_LOSS_TOL}, {CUT_GRAD_TOL})")
    if not (abs(loss_f - loss_s) <= CUT_LOSS_TOL
            and fused_vs_split <= FUSED_SPLIT_TOL):
        fail(f"{CUT_LAYERS}-layer fused vs split: loss {loss_f} vs {loss_s}"
             f", gradients {fused_vs_split} at {worst_fs}")

    emit({"phase": "train", "model": "BENCH_350M_TRAIN", "layers": layers,
          "param_count": param_count,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "remat_policy": cfg.remat_policy,
          "steps": {"untimed": TRAIN_UNTIMED, "timed": TRAIN_TIMED,
                    "split": 1},
          "ms_per_step": seconds * 1e3, "stream_ms_per_step": step_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / seconds,
          "model_flops_per_step": flops, "peak_flops": peak_flops,
          "mfu": flops / seconds / peak_flops,
          "peak_mem_bytes": peak, "losses": losses,
          "expected_loss0": EXPECTED_LOSS0, "loss0_tol": LOSS0_TOL,
          "launches": launches, "tile_launches": PATH_TILES["train"],
          "launches_per_fused_step": per_fused,
          "launches_split_step": split_launches,
          "repeat": {**repeat, "grad_tol_fused": REPEAT_GRAD_TOL},
          "cut": {"layers": CUT_LAYERS, "loss_flash_fused": loss_f,
                  "loss_flash_split": loss_s, "loss_dense": loss_d,
                  "grad_rel_flash_vs_dense": flash_vs_dense,
                  "worst_param": worst,
                  "grad_rel_fused_vs_split": fused_vs_split,
                  "loss_tol": CUT_LOSS_TOL, "grad_tol": CUT_GRAD_TOL,
                  "fused_vs_split_tol": FUSED_SPLIT_TOL}})
    return launches, losses[0]


# The main's steps, logged each; then the resume runs under the split
# backward: straight to RESUME_STEPS, and to RESUME_AT with a checkpoint
# there, then restarted to RESUME_STEPS.
MAIN_STEPS = 6
RESUME_STEPS, RESUME_AT = 6, 4
# The main's step-0 loss against the Trainer's on the same seed and
# batch: the same parameter draws and the same products (FSDP2 over one
# rank gathers and reduces by copies), so they agree to rounding.
MAIN_LOSS0_RTOL = 1e-4


class _Records(logging.Handler):
    """The structured fields (``extra=``) of the port's log records."""

    FIELDS = ("train_step", "train_loss", "tokens_per_s", "mfu",
              "start_step", "checkpoint_step", "checkpoint_save_s",
              "checkpoint_restore_s")

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.records: list[dict] = []

    def emit(self, record: logging.LogRecord) -> None:
        fields = {k: getattr(record, k) for k in self.FIELDS
                  if hasattr(record, k)}
        if fields:
            self.records.append(fields)

    def take(self, key: str) -> list:
        out = [r for r in self.records if key in r]
        self.records = [r for r in self.records if key not in r]
        return out


def _bytes_under(path: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _release() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_main(trainer_loss0: float) -> dict[str, int]:
    import torch.distributed as dist

    from nos_tpu_torch.cmd.train import TrainConfig, train
    from nos_tpu_torch.entry import TRAIN_BATCH, TRAIN_SEQ
    from nos_tpu_torch.models.llama import BENCH_350M_TRAIN
    from nos_tpu_torch.ops import attention as A

    layers = BENCH_350M_TRAIN.num_layers
    port_log = logging.getLogger("nos_tpu_torch")
    port_log.setLevel(logging.INFO)
    records = _Records()
    port_log.addHandler(records)
    if A.set_backward_impl("fused") != "fused":
        fail("the default flash backward is not the fused one")

    def cfg(**kw) -> TrainConfig:
        c = TrainConfig(model="bench350m", log_every=1, **kw)
        c.validate()
        return c

    _release()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    main_loss = train(cfg(steps=MAIN_STEPS))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    main_launches = _launch_counts()
    if not (dist.is_initialized() and dist.get_world_size() == 1
            and dist.get_backend() == "nccl"):
        fail("the main did not run in a one-rank NCCL group")
    _check_launches("the main's run", main_launches, {
        "flash_fwd": MAIN_STEPS * layers,
        "flash_bwd_fused": MAIN_STEPS * layers, "flash_dq": 0,
        "flash_dkv": 0})
    steps = records.take("train_loss")
    if [r["train_step"] for r in steps] != list(range(1, MAIN_STEPS + 1)):
        fail(f"the main logged steps {[r['train_step'] for r in steps]}")
    losses = [r["train_loss"] for r in steps]
    if not all(math.isfinite(x) for x in losses) or losses[-1] != main_loss:
        fail(f"the main's losses {losses}, returned {main_loss}")
    loss0_rel = abs(losses[0] - trainer_loss0) / abs(trainer_loss0)
    if not loss0_rel <= MAIN_LOSS0_RTOL:
        fail(f"the main's step-0 loss {losses[0]} against the Trainer's "
             f"{trainer_loss0}: {loss0_rel} relative (tol "
             f"{MAIN_LOSS0_RTOL})")
    step_ms = [TRAIN_BATCH * TRAIN_SEQ / r["tokens_per_s"] * 1e3
               for r in steps]

    # Resume under the deterministic (split) backward.
    A.set_backward_impl("split")
    _release()
    try:
        straight = train(cfg(steps=RESUME_STEPS))
        _release()
        with tempfile.TemporaryDirectory(prefix="nos-ck-") as tmp:
            first = train(cfg(steps=RESUME_AT, checkpoint_every=RESUME_AT,
                              checkpoint_dir=tmp))
            ck_bytes = _bytes_under(pathlib.Path(tmp) / str(RESUME_AT))
            _release()
            resumed = train(cfg(steps=RESUME_STEPS,
                                checkpoint_every=RESUME_AT,
                                checkpoint_dir=tmp))
    finally:
        A.set_backward_impl("fused")
    torch.cuda.synchronize()
    launches = _launch_counts()
    PATH_TILES["train_main"] = _tile_counts()
    port_log.removeHandler(records)
    _release()
    split_steps = RESUME_STEPS + RESUME_AT + (RESUME_STEPS - RESUME_AT)
    _check_launches("the train_main phase", launches, {
        "flash_fwd": (MAIN_STEPS + split_steps) * layers,
        "flash_bwd_fused": MAIN_STEPS * layers,
        "flash_dq": split_steps * layers, "flash_dkv": split_steps * layers})
    starts = [r["start_step"] for r in records.take("start_step")]
    if starts != [RESUME_AT]:
        fail(f"the restarted main resumed at {starts}, not [{RESUME_AT}]")
    if resumed != straight:
        fail(f"the resumed run ended on loss {resumed!r}, the straight run "
             f"on {straight!r}: not bitwise equal")
    saves = [r["checkpoint_save_s"]
             for r in records.take("checkpoint_save_s")]
    restores = [r["checkpoint_restore_s"]
                for r in records.take("checkpoint_restore_s")]
    mfu = [r["mfu"] for r in steps]
    emit({"phase": "train_main", "model": "BENCH_350M_TRAIN",
          "layers": layers, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "world_size": dist.get_world_size(),
          "backend": dist.get_backend(), "steps": MAIN_STEPS,
          "losses": losses, "trainer_loss0": trainer_loss0,
          "loss0_rel_diff": loss0_rel, "loss0_rtol": MAIN_LOSS0_RTOL,
          "ms_per_step": step_ms,
          "ms_per_step_median": statistics.median(step_ms[1:]),
          "tokens_per_s": [r["tokens_per_s"] for r in steps],
          "mfu": mfu, "mfu_median": statistics.median(mfu[1:]),
          "peak_mem_bytes": peak, "launches_main_run": main_launches,
          "launches": launches, "tile_launches": PATH_TILES["train_main"],
          "resume": {"backward": "split", "straight_loss": straight,
                     "first_loss": first, "resumed_loss": resumed,
                     "start_step": starts[0], "bitwise": True,
                     "save_ms": [x * 1e3 for x in saves],
                     "restore_ms": [x * 1e3 for x in restores],
                     "checkpoint_bytes": ck_bytes}})
    dist.destroy_process_group()
    return launches, losses[0]


# The moe phase: untimed and timed steps; the cut's depth and batch rows.
# From random weights optax adam(1e-3) (no warm-up, no clip) overshoots:
# on the H100 the loss rose over the first 3 steps, to 11.42 from 10.86,
# then came down with a spread of ~0.1 from step to step (PERF.md §6).
# The untimed steps cover the rise; the check holds the later half of the
# timed steps' losses, on average, below the earlier half.
MOE_UNTIMED, MOE_TIMED = 4, 8
MOE_CUT_LAYERS, MOE_CUT_ROWS = 2, 2


def _moe_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one MoE step, counting the k experts each token is
    routed to and no capacity padding: the dense model's (one SwiGLU per
    token, ``ops.roofline.model_flops_per_step``) plus k - 1 more SwiGLUs,
    3 D F weights each at 6 FLOPs per weight and token (forward 2,
    backward 4).  The router's 6 T D E per layer is left out, and remat's
    recompute is not credited."""
    from nos_tpu_torch.ops.roofline import model_flops_per_step

    extra = 6 * batch * seq * (cfg.top_k - 1) * 3 * cfg.hidden_size \
        * cfg.intermediate_size * cfg.num_layers
    return model_flops_per_step(cfg, batch, seq) + extra


def _full_grads(model) -> dict[str, torch.Tensor]:
    from torch.distributed.tensor import DTensor

    return {n: (p.grad.to_local() if isinstance(p.grad, DTensor)
                else p.grad).detach().clone()
            for n, p in model.named_parameters()}


def _moe_pass(model, tokens, impl: str = "fused") -> tuple[float, dict]:
    """One loss-and-gradient pass of ``moe_loss`` (no update)."""
    from nos_tpu_torch.models.moe import moe_loss
    from nos_tpu_torch.ops import attention as A

    for p in model.parameters():
        p.grad = None
    prev = A.set_backward_impl(impl)
    try:
        loss = moe_loss(model, tokens)
        loss.backward()
    finally:
        A.set_backward_impl(prev)
    return loss.item(), _full_grads(model)


# One MoE layer, index dispatch against the einsum reference on the same
# input and output cotangent: the same routing and roundings but for the
# order of fp32 sums (cuBLAS's bf16 products against fp32 einsums), so a
# few bf16 ulps of each output's largest |value|.
MOE_LAYER_TOL = 1e-2


def _moe_layer_check(moe, x: torch.Tensor, dy: torch.Tensor) -> float:
    """max over y, dx and the layer's parameter gradients of |index -
    einsum| / max |einsum| for one MoE layer on input x, cotangent dy."""
    from nos_tpu_torch.models.moe import MoEMLP, moe_mlp_reference

    outs = []
    for fn in (functools.partial(MoEMLP.forward, moe),
               functools.partial(moe_mlp_reference, moe)):
        moe.zero_grad(set_to_none=True)
        xx = x.clone().requires_grad_()
        y, aux = fn(xx)
        ((y.float() * dy.float()).sum() + aux).backward()
        outs.append([y.detach(), xx.grad] + [p.grad.clone()
                                            for p in moe.parameters()])
    return max(_rel_err(a, b) for a, b in zip(*outs))


def _moe_cut(loader) -> dict:
    """At MOE_CUT_LAYERS layers on MOE_CUT_ROWS x 2048 tokens, without a
    mesh, on one set of parameters: the flash model's loss against the
    einsum reference's, each layer's index dispatch against the reference
    on the layer's own input and cotangent from that pass, and flash
    against dense attention with the dense pass replaying the flash
    pass's expert choices.  (A bf16 rounding in an early layer can flip
    a near-tied choice in a later one, and a flipped token's output
    changes wholly: end-to-end gradients of two MoE models differ by
    routing, not by the numerics under test.)"""
    from nos_tpu_torch.entry import bench_moe_config
    from nos_tpu_torch.models.moe import (MoELlama, init_moe_params,
                                          moe_mlp_reference)

    cfg = bench_moe_config(MOE_CUT_LAYERS)
    params = init_moe_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    tokens = torch.from_numpy(loader.batch_at(0)[:MOE_CUT_ROWS]).cuda()

    def model(attn):
        m = MoELlama(dataclasses.replace(cfg, attn_impl=attn), "cuda")
        m.load_state_dict(params)
        return m

    # The flash pass, recording each layer's first (forward) routing,
    # input and output cotangent; backward's recompute is not recorded.
    flash, seen = model("flash"), [{} for _ in range(MOE_CUT_LAYERS)]
    for layer, rec in zip(flash.layers, seen):
        route, forward = layer.moe.route, layer.moe.forward

        def recording_route(x, route=route, rec=rec):
            r = route(x)
            rec.setdefault("routing", dataclasses.replace(
                r, probs=r.probs.detach(), gates=r.gates.detach()))
            return r

        def recording_forward(x, forward=forward, rec=rec):
            y, aux = forward(x)
            if "x" not in rec:
                rec["x"] = x.detach()
                y.register_hook(lambda g: rec.setdefault("dy", g))
            return y, aux

        layer.moe.route, layer.moe.forward = recording_route, recording_forward
    loss_f, g_f = _moe_pass(flash, tokens)
    del flash

    einsum = model("flash")
    for layer in einsum.layers:
        layer.moe.forward = functools.partial(moe_mlp_reference, layer.moe)
    loss_e = _moe_pass(einsum, tokens)[0]
    layer_errs = [_moe_layer_check(layer.moe, rec["x"], rec["dy"])
                  for layer, rec in zip(einsum.layers, seen)]
    del einsum

    dense = model("dense")
    for layer, rec in zip(dense.layers, seen):
        def replayed_route(x, moe=layer.moe, r=rec["routing"]):
            # the recorded choices, gated by this model's own router
            probs = torch.softmax(moe.router(x.reshape(-1, x.shape[-1])),
                                  dim=-1)
            vals = probs.gather(1, r.expert)
            return dataclasses.replace(r, probs=probs, gates=vals / torch.clamp(
                vals.sum(-1, keepdim=True), min=1e-9))

        layer.moe.route = replayed_route
    loss_d, g_d = _moe_pass(dense, tokens)
    del dense
    dense_err, dense_worst = _worst_grad_err(g_f, g_d)
    out = {"layers": MOE_CUT_LAYERS, "rows": MOE_CUT_ROWS,
           "loss_flash_index": loss_f, "loss_flash_einsum": loss_e,
           "loss_dense_replayed": loss_d,
           "layer_rel_index_vs_einsum": layer_errs,
           "grad_rel_flash_vs_dense": dense_err,
           "worst_param_flash_vs_dense": dense_worst,
           "loss_tol": CUT_LOSS_TOL, "layer_tol": MOE_LAYER_TOL,
           "grad_tol": CUT_GRAD_TOL}
    if not (abs(loss_f - loss_e) <= CUT_LOSS_TOL
            and max(layer_errs) <= MOE_LAYER_TOL):
        fail(f"{MOE_CUT_LAYERS}-layer MoE index dispatch vs einsum: {out}")
    if not (abs(loss_f - loss_d) <= CUT_LOSS_TOL
            and dense_err <= CUT_GRAD_TOL):
        fail(f"{MOE_CUT_LAYERS}-layer MoE flash vs dense: {out}")
    return out


def phase_moe() -> dict[str, int]:
    import torch.distributed as dist

    from nos_tpu_torch.entry import (TRAIN_BATCH, TRAIN_SEQ,
                                     bench_moe_trainer, moe_launches_per_step,
                                     train_loader)
    from nos_tpu_torch.models.moe import capacity
    from nos_tpu_torch.ops import attention as A
    from nos_tpu_torch.ops.roofline import peaks_for

    _release()
    if A.set_backward_impl("fused") != "fused":
        fail("the default flash backward is not the fused one")
    state, step = bench_moe_trainer("cuda")
    model, cfg = state.model, state.model.cfg
    if not (dist.get_world_size() == 1 and dist.get_backend() == "nccl"):
        fail("the MoE trainer did not run in a one-rank NCCL group")
    per_step = moe_launches_per_step(cfg)
    loader = train_loader()

    # Step 0's loss terms, and each layer's share of (token, choice)
    # pairs over capacity, from a forward without grad.
    drops: list[float] = []

    def record_drops(moe, args, _out):
        drops.append(1.0 - moe.route(args[0]).kept.float().mean().item())

    hooks = [layer.moe.register_forward_hook(record_drops)
             for layer in model.layers]
    batch0 = torch.from_numpy(loader.batch_at(0)).cuda()
    with torch.no_grad():
        xent0, aux0 = model.loss_terms(batch0, batch0)
    for h in hooks:
        h.remove()
    xent0, aux0, drops0 = xent0.item(), aux0.tolist(), list(drops)
    # The same random-weight argument as the train phase: the final norm
    # and the tied embedding are the dense model's.
    if not abs(xent0 - EXPECTED_LOSS0) <= LOSS0_TOL:
        fail(f"MoE step-0 xent {xent0}, expected {EXPECTED_LOSS0} +- "
             f"{LOSS0_TOL}")

    losses, step_launches = [], []
    torch.cuda.synchronize()
    _zero_launch_counts()
    for i in range(MOE_UNTIMED):
        before = _launch_counts()
        state, loss = step(state, loader.batch_at(i))
        losses.append(loss.item())
        step_launches.append({k: v - before[k]
                              for k, v in _launch_counts().items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(MOE_TIMED + 1)]
    timed = []
    t0 = time.perf_counter()
    marks[0].record()
    for j in range(MOE_TIMED):
        state, loss = step(state, loader.batch_at(MOE_UNTIMED + j))
        timed.append(loss)
        marks[j + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / MOE_TIMED * 1e3
    launches = _launch_counts()
    PATH_TILES["moe"] = _tile_counts()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    losses += [x.item() for x in timed]
    _check_launches("the moe run", launches, {
        k: (MOE_UNTIMED + MOE_TIMED) * v for k, v in per_step.items()})
    for i, got in enumerate(step_launches):
        _check_launches(f"moe step {i}", got, per_step)
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite MoE loss: {losses}")
    # Training must make progress over the timed steps (a sign error or a
    # dead gradient path would not): see MOE_UNTIMED.
    half = MOE_TIMED // 2
    early = statistics.mean(losses[MOE_UNTIMED:MOE_UNTIMED + half])
    late = statistics.mean(losses[MOE_UNTIMED + half:])
    if not late < early:
        fail(f"the MoE loss did not fall over the timed steps: mean "
             f"{early} then {late}; {losses}")
    # The loss terms and drop rates after training, on batch 0.
    drops.clear()
    hooks = [layer.moe.register_forward_hook(record_drops)
             for layer in model.layers]
    with torch.no_grad():
        xent_end, aux_end = model.loss_terms(batch0, batch0)
    for h in hooks:
        h.remove()
    # shard FSDP2's root again before the next backward (as the step does)
    model.reshard()
    end = {"xent": xent_end.item(), "aux_per_layer": aux_end.tolist(),
           "drop_rate_per_layer": list(drops)}

    # Two passes from one state: the index path adds no atomics, so under
    # the split backward the gradients repeat bitwise.
    batch = torch.from_numpy(loader.batch_at(0)).cuda()
    loss_a, g_a = _moe_pass(model, batch, "split")
    loss_b, g_b = _moe_pass(model, batch, "split")
    bitwise = loss_a == loss_b and all(torch.equal(g_a[n], g_b[n])
                                       for n in g_a)
    repeat_err, repeat_worst = _worst_grad_err(g_b, g_a)
    del g_a, g_b
    if not bitwise:
        fail(f"two split MoE passes from one state differ: losses {loss_a}"
             f", {loss_b}; gradients {repeat_err} at {repeat_worst}")
    param_count = sum(p.numel() for p in model.parameters())
    del state, step, model
    _release()
    cut = _moe_cut(loader)
    dist.destroy_process_group()
    _release()

    ms = statistics.median(step_ms)
    flops = _moe_flops_per_step(cfg, TRAIN_BATCH, TRAIN_SEQ)
    peak_flops = peaks_for(torch.cuda.get_device_name(0))[0]
    emit({"phase": "moe", "model": "MoE at BENCH_350M_TRAIN widths",
          "layers": cfg.num_layers, "experts": cfg.num_experts,
          "top_k": cfg.top_k, "capacity_factor": cfg.capacity_factor,
          "param_count": param_count, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ,
          "steps": {"untimed": MOE_UNTIMED, "timed": MOE_TIMED},
          "ms_per_step": ms, "stream_ms_per_step": step_ms,
          "host_ms_per_step": host_ms,
          "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
          "active_flops_per_step": flops, "peak_flops": peak_flops,
          "mfu": flops / (ms * 1e-3) / peak_flops,
          "peak_mem_bytes": peak, "losses": losses,
          "xent0": xent0, "expected_loss0": EXPECTED_LOSS0,
          "loss0_tol": LOSS0_TOL, "aux0_per_layer": aux0,
          "drop_rate_per_layer": drops0,
          "loss_mean_early_late": [early, late], "after_training": end,
          "capacity": capacity(cfg, TRAIN_BATCH * TRAIN_SEQ),
          "launches": launches, "tile_launches": PATH_TILES["moe"],
          "launches_per_step": per_step,
          "repeat_split": {"losses": [loss_a, loss_b], "bitwise": bitwise},
          "cut": cut})
    return launches



# The device phase: NVML's total memory of the card against CUDA's.
DEVICE_MEM_TOL = 1 << 20
ROOT = pathlib.Path(__file__).resolve().parent


def device_probe() -> dict:
    """The device phase's child, in a process with no CUDA context: NVML
    first (``discover(allow_cuda=False)``, the runtime's topology, MIG
    devices and, on a card in MIG mode, the profile table), then CUDA
    started and the device rung read."""
    from nos_tpu_torch.device import discovery, nvml

    env = discovery.discover(allow_cuda=False)
    out = {"env": dataclasses.asdict(env) | {"model": env.model.name},
           "cuda_initialized_after_env": torch.cuda.is_initialized()}
    runtime = nvml.NvmlGpuRuntime()
    try:
        out["topology"] = runtime.topology()
        out["nvml_gpus"] = nvml.read_gpus(runtime.nvml)
        out["mig_devices"] = runtime.list_devices().ids()
        out["mig_tables"] = {}
        for g in out["nvml_gpus"]:
            if g["mig"]:
                table = nvml.read_profile_table(
                    runtime.nvml, runtime.nvml.handle(g["index"]),
                    runtime.model)
                out["mig_tables"][g["uuid"]] = {
                    "observed": table, "mismatches":
                        nvml.profile_table_mismatches(runtime.model, table)}
    finally:
        runtime.close()
    out["cuda_initialized_after_runtime"] = torch.cuda.is_initialized()
    torch.cuda.init()
    dev = discovery.discover(allow_cuda=True)
    out["device"] = dataclasses.asdict(dev) | {"model": dev.model.name}
    out["sm_count"] = torch.cuda.get_device_properties(0).multi_processor_count
    return out


def _child_env(**grant: str) -> dict[str, str]:
    """The environment of a child process: this one's without any grant
    or CUDA visibility key, with ``grant`` added and the repo on the
    path."""
    import os

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("NOS_TPU_VISIBLE_CHIPS")
           and not k.startswith("NOS_TPU_TIMESHARE_GB")
           and k not in ("NOS_TPU_SLICE_IDS", "NOS_TPU_TORCH_MEM_FRACTION",
                         "CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER")}
    env["PYTHONPATH"] = str(ROOT)
    env.update(grant)
    return env


def phase_device() -> dict:
    """Discovery on the card: NVML without a CUDA context, agreeing with
    the CUDA rung; the MIG table checked where the card is in MIG mode.
    Changes no MIG mode and creates or destroys nothing."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import json, chip_smoke; "
         "print(json.dumps(chip_smoke.device_probe()))"],
        cwd=ROOT, env=_child_env(), capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0:
        fail(f"the device probe exited {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    env, dev = got["env"], got["device"]
    if env["source"] != "env":
        fail(f"discover(allow_cuda=False) came from {env['source']!r}, "
             f"not NVML ('env')")
    if env["model"] != "nvidia-h100-80gb-hbm3":
        fail(f"NVML discovered {env['model']!r} ({env['product_name']!r})")
    if got["cuda_initialized_after_env"] \
            or got["cuda_initialized_after_runtime"]:
        fail("NVML discovery started CUDA")
    if dev["source"] != "device":
        fail(f"discover() with CUDA up came from {dev['source']!r}")
    nvml_by_uuid = {u.lower(): (m, i) for i, (u, m) in enumerate(
        zip(env["uuids"], env["memory_bytes"]))}
    cuda_uuid = dev["uuids"][0].lower()
    if cuda_uuid not in nvml_by_uuid:
        fail(f"CUDA device 0 ({cuda_uuid}) is not among NVML's GPUs "
             f"{env['uuids']}")
    nvml_mem, index = nvml_by_uuid[cuda_uuid]
    nvml_gpu = got["nvml_gpus"][index]
    mem_diff = abs(dev["memory_bytes"][0] - nvml_mem)
    if dev["product_name"] != env["product_name"] \
            or mem_diff > DEVICE_MEM_TOL:
        fail(f"NVML read {env['product_name']!r} with {nvml_mem} B, CUDA "
             f"{dev['product_name']!r} with {dev['memory_bytes'][0]} B")
    mig = env["mig_modes"][index]
    mismatches = {u: t["mismatches"] for u, t in got["mig_tables"].items()}
    if mig and not got["mig_tables"]:
        fail("the card is in MIG mode but no profile table was read")
    if any(mismatches.values()):
        fail(f"NVML's MIG profiles disagree with topology/known.py: "
             f"{mismatches}")
    emit({"phase": "device", "seconds": time.perf_counter() - t0,
          "source_nvml": env["source"], "source_cuda": dev["source"],
          "model": env["model"], "product_name": env["product_name"],
          "gpus_nvml": env["num_local_gpus"], "gpus_cuda":
              dev["num_local_gpus"], "uuid": dev["uuids"][0],
          "memory_bytes_nvml": nvml_mem,
          "memory_total_nvml": nvml_gpu["memory_total"],
          "memory_reserved_nvml": nvml_gpu["memory_reserved"],
          "memory_bytes_cuda": dev["memory_bytes"][0],
          "memory_diff_bytes": mem_diff, "sm_count": got["sm_count"],
          "cuda_initialized_after_nvml": False,
          "mig": "enabled" if mig else "disabled",
          "mig_devices": got["mig_devices"],
          "mig_table": got["mig_tables"] if mig else "not checked: MIG "
                                                     "is disabled"})
    # "uuids": CUDA's devices in index order, which the partition phase
    # maps a GPU index of the node's config through
    return {"uuid": dev["uuids"][0], "uuids": dev["uuids"],
            "memory_bytes": dev["memory_bytes"][0], "model": env["model"]}


# The grant phase: three children of the training main on train_main's
# configuration, two steps each.  (a) a 24 GB timeshare grant of the
# card: a cap of 24 / 80 x 0.9 of its memory, above the run's peak;
# (b) 8 GB, a cap below it, which must fail the step with torch's OOM;
# (c) a well-formed UUID of no device here, which must stop the main
# with ConfinementError before any step.
GRANT_STEPS = 2
GRANT_GB = {"a": 24, "b": 8}
ABSENT_UUID = "GPU-deadbeef-0000-4000-8000-000000000000"
_STEP_LINE = re.compile(r"step (\d+)/\d+ loss (\S+) \(([\d.]+) tokens/s")
# the training main's log format: "%(asctime)s %(levelname)s %(name)s: ..."
_STEP_STAMP = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3}) \S+ \S+: "
                         r"step (\d+)/\d+ loss \S+ \(([\d.]+) tokens/s", re.M)
_PORT_FRAME = re.compile(r'File "[^"]*/(nos_tpu_torch/[^"]+)", line (\d+), '
                         r'in (\S+)')


def _start_grant_child(case: str, cfg_path: str, grant: dict,
                       no_nvcc: str) -> dict:
    """Start ``python -m nos_tpu_torch.cmd.train`` under ``grant`` with
    nvcc hidden; a thread gathers its stderr lines as they come."""
    import os

    env = _child_env(**grant)
    # the kernels are built: a child that starts nvcc finds none
    env["CUDA_HOME"] = no_nvcc
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not pathlib.Path(d, "nvcc").exists())
    proc = subprocess.Popen(
        [sys.executable, "-m", "nos_tpu_torch.cmd.train", "--config",
         cfg_path], cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    lines: list[str] = []

    def gather() -> None:
        for line in proc.stderr:
            lines.append(line)

    reader = threading.Thread(target=gather, daemon=True)
    reader.start()
    return {"case": case, "grant": grant, "proc": proc, "lines": lines,
            "reader": reader, "t0": time.perf_counter()}


def _finish_grant_child(child: dict, timeout: float = 600) -> dict:
    """Wait for a started child and read its log: steps, their host
    clock stamps, the main's grant reports (at confinement and at exit)
    and its last frame in the port; the wall from its start to its
    exit."""
    proc = child.pop("proc")
    try:
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    child.pop("reader").join()
    wall = time.perf_counter() - child.pop("t0")
    err = "".join(child.pop("lines"))
    steps = [(int(m.group(1)), float(m.group(2)), float(m.group(3)))
             for m in _STEP_LINE.finditer(err)]
    # (step, host wall-clock seconds of its log line, tokens/s)
    stamps = [(int(m.group(2)), datetime.datetime.strptime(
                   m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp(),
               float(m.group(3))) for m in _STEP_STAMP.finditer(err)]
    done = [ln for ln in err.splitlines() if "done: " in ln and " grant " in ln]
    report = (json.loads(done[-1].split(" grant ", 1)[1]) if done else None)
    confined = [ln for ln in err.splitlines() if "confined: grant " in ln]
    confined = (json.loads(confined[0].split(" grant ", 1)[1]) if confined
                else None)
    frames = _PORT_FRAME.findall(err)
    return child | {"rc": proc.returncode, "wall_s": wall, "steps": steps,
                    "stamps": stamps, "report": report, "confined": confined,
                    "last_port_frame": ":".join(frames[-1]) if frames
                    else None, "stderr": err}


def _run_grant_child(case: str, cfg_path: str, grant: dict,
                     no_nvcc: str) -> dict:
    return _finish_grant_child(_start_grant_child(case, cfg_path, grant,
                                                  no_nvcc))


def _grant_workdir(tmp: str) -> tuple[str, str]:
    """In ``tmp``: the children's training config (train_main's, GRANT_STEPS
    steps) and an empty CUDA_HOME that holds no nvcc."""
    from nos_tpu_torch.entry import TRAIN_BATCH, TRAIN_SEQ

    cfg_path = str(pathlib.Path(tmp) / "train.json")
    pathlib.Path(cfg_path).write_text(json.dumps({
        "model": "bench350m", "batch_size": TRAIN_BATCH,
        "seq_len": TRAIN_SEQ, "steps": GRANT_STEPS, "data_seed": 0,
        "log_every": 1}))
    no_nvcc = str(pathlib.Path(tmp) / "no-cuda-home")
    pathlib.Path(no_nvcc).mkdir()
    return cfg_path, no_nvcc


def _grant_cap(gb: int, total: int) -> tuple[float, int]:
    """The memory fraction and cap in bytes a ``gb`` GB timeshare grant
    installs on a card of ``total`` bytes (``device/workload_env.py``)."""
    from nos_tpu_torch.device.workload_env import CEILING, SAFETY
    from nos_tpu_torch.topology import H100_80GB

    fraction = round(min(gb / H100_80GB.memory_gb * SAFETY, CEILING), 3)
    return fraction, int(fraction * total)


def _check_granted_child(label: str, child: dict, uuid: str,
                         main_loss0: float, n_steps: int = GRANT_STEPS
                         ) -> dict:
    """A training-main child that must pass under its timeshare grant:
    exit 0, the grant verified on ``uuid`` at the child's fraction and
    cap, ``n_steps`` finite steps logged, 24 K1 + 24 K2 a step, the
    train_main phase's step-0 loss within MAIN_LOSS0_RTOL, and its peak
    under the cap.  Records the peaks and the loss's distance on
    ``child``; returns the main's report."""
    from nos_tpu_torch.models.llama import BENCH_350M_TRAIN

    layers = BENCH_350M_TRAIN.num_layers
    r = child["report"]
    if child["rc"] != 0 or r is None:
        fail(f"{label} exited {child['rc']}:\n{child['stderr'][-4000:]}")
    if not (r["verified"] and r["devices"] == [uuid]
            and r["fraction"] == child["fraction"]
            and r["cap_bytes"] == child["cap_bytes"]):
        fail(f"{label} verified {r}, expected {uuid} at fraction "
             f"{child['fraction']}")
    _check_launches(label, r["launches"], {
        "flash_fwd": n_steps * layers,
        "flash_bwd_fused": n_steps * layers})
    steps = child["steps"]
    if [s[0] for s in steps] != list(range(1, n_steps + 1)) \
            or not all(math.isfinite(s[1]) for s in steps):
        fail(f"{label} logged steps {steps}")
    loss0_rel = abs(steps[0][1] - main_loss0) / abs(main_loss0)
    if not loss0_rel <= MAIN_LOSS0_RTOL:
        fail(f"{label}'s step-0 loss {steps[0][1]} against the "
             f"train_main phase's {main_loss0}: {loss0_rel} relative (tol "
             f"{MAIN_LOSS0_RTOL})")
    child["loss0_rel_diff"] = loss0_rel
    child["peak_bytes"] = r["max_memory_allocated"]
    child["peak_reserved_bytes"] = r["max_memory_reserved"]
    if not (r["max_memory_allocated"] < child["cap_bytes"]
            and r["max_memory_reserved"] <= child["cap_bytes"]):
        fail(f"{label} peaked at {r['max_memory_allocated']} B allocated, "
             f"{r['max_memory_reserved']} B reserved, over its cap "
             f"{child['cap_bytes']} B")
    return r


def phase_grant(main_loss0: float, device: dict) -> dict:
    """The training main under three grants, each a fresh process that
    reuses the built kernels (nvcc hidden from it, the kernel directory
    unchanged): see GRANT_GB."""
    from nos_tpu_torch.entry import TRAIN_BATCH, TRAIN_SEQ
    from nos_tpu_torch.models.llama import BENCH_350M_TRAIN
    from nos_tpu_torch.ops import _build

    layers = BENCH_350M_TRAIN.num_layers
    uuid, total = device["uuid"], device["memory_bytes"]
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    children = {}
    with tempfile.TemporaryDirectory(prefix="nos-grant-") as tmp:
        cfg_path, no_nvcc = _grant_workdir(tmp)
        # the three at once: each cap binds its own process alone
        for case, gb in GRANT_GB.items():
            children[case] = _start_grant_child(
                case, cfg_path, {"NOS_TPU_VISIBLE_CHIPS": uuid,
                                 "NOS_TPU_TIMESHARE_GB": str(gb)}, no_nvcc)
        children["c"] = _start_grant_child(
            "c", cfg_path, {"NOS_TPU_VISIBLE_CHIPS": ABSENT_UUID}, no_nvcc)
        children = {case: _finish_grant_child(child)
                    for case, child in children.items()}
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"a grant child built kernels: {kernels_before} -> "
             f"{kernels_after}")
    for case, gb in GRANT_GB.items():
        children[case]["fraction"], children[case]["cap_bytes"] = \
            _grant_cap(gb, total)

    a = children["a"]
    r = _check_granted_child("grant (a)", a, uuid, main_loss0)

    b = children["b"]
    # torch names the cap ("... allowed;") when the fraction refused it
    if b["rc"] == 0 or "OutOfMemoryError" not in b["stderr"] \
            or " allowed;" not in b["stderr"]:
        fail(f"grant (b), a cap of {b['cap_bytes']} B below the run's peak, "
             f"exited {b['rc']} without the cap's OutOfMemoryError: the cap "
             f"did not bind\n{b['stderr'][-4000:]}")
    if b["report"] is not None:
        fail("grant (b) reached the end of the main")

    c = children["c"]
    if c["rc"] == 0 or "ConfinementError" not in c["stderr"] \
            or c["steps"]:
        fail(f"grant (c), a device not on the host, exited {c['rc']} "
             f"after steps {c['steps']}:\n{c['stderr'][-4000:]}")
    emit({"phase": "grant", "model": "BENCH_350M_TRAIN", "layers": layers,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": GRANT_STEPS,
          "card_memory_bytes": total, "main_loss0": main_loss0,
          "loss0_rel_diff": a["loss0_rel_diff"],
          "loss0_rtol": MAIN_LOSS0_RTOL, "launches": r["launches"],
          "children": [
              {k: v for k, v in ch.items() if k not in ("stderr", "stamps")}
              | {"oom_at_cap": " allowed;" in ch["stderr"]}
              for ch in children.values()]})
    return r["launches"]

# The partition phase.  (a) The MPS planner on testing/fleet.py's fleet
# (32 nodes x 8 H100 80GB, 200 pending pods, seed 0): PLAN_TIMED timed
# plans after one untimed, on fresh snapshots, on the card machine's
# host.  (b) The card's own node in the MPS loop (the partitioner
# controller, its chip agent and the scheduler, on time.monotonic with
# the batch windows below and the default plan deadline, 3 x the
# timeout): CARD_PODS pods of CARD_SHARE_GB, of which the card's config
# holds three; the pods bound and Running within CARD_BIND_LIMIT_S,
# polled every CARD_POLL_S; then shared by the children their grants
# stand for.
PLAN_TIMED = 5
CARD_PODS = 4
CARD_SHARE_GB = 24
CARD_NODE = "h100-node-0"
CARD_BATCH_IDLE_S = 0.2
CARD_BATCH_TIMEOUT_S = 2.0
CARD_BIND_LIMIT_S = 30.0
CARD_POLL_S = 0.01


def _fleet_plans() -> dict:
    """The fleet plan, once untimed and PLAN_TIMED times timed, each on
    a fresh snapshot; every run's summary must be the pinned one."""
    from nos_tpu_torch.obs import trace
    from nos_tpu_torch.partitioning.core import GeometryPlanner
    from nos_tpu_torch.partitioning.timeshare import (
        TimesharePartitionCalculator, TimeshareProfileCalculator,
        TimeshareSnapshotTaker)
    from nos_tpu_torch.scheduler.framework import Framework
    from nos_tpu_torch.testing import fleet
    from nos_tpu_torch.topology import H100_80GB

    spec = fleet.fleet_spec(0)
    bound = {b["name"] for n in spec["nodes"] for b in n["bound"]}
    planner = GeometryPlanner(Framework(), TimeshareProfileCalculator(),
                              TimesharePartitionCalculator())
    runs = []
    for _ in range(1 + PLAN_TIMED):
        snap = TimeshareSnapshotTaker().take_snapshot(
            fleet.build_cluster(spec))
        pending = fleet.build_pending(spec)
        before = {name: {u.index: (dict(u.used), u.geometry_names())
                         for u in node.units}
                  for name, node in snap.nodes().items()}
        tracer = trace.Tracer()
        prev = trace.set_tracer(tracer)
        try:
            t0 = time.perf_counter()
            planner.plan(snap, pending)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            trace.set_tracer(prev)
        (span,) = [sp for sp in tracer.ring.dump()
                   if sp["name"] == "planner.plan"]
        runs.append({"ms": ms, "counts": span["counts"], "before": before,
                     "summary": fleet.plan_summary(snap, pending, bound)})
    first = runs[0]
    if any(r["summary"] != first["summary"] or r["counts"] != first["counts"]
           for r in runs):
        fail("the fleet's plans differ between runs")
    digest = fleet.plan_digest(first["summary"])
    if digest != fleet.FLEET_DIGEST:
        fail(f"the fleet plan's digest {digest} is not the pinned "
             f"{fleet.FLEET_DIGEST} (the JAX package's plan on the CPU)")
    carved, shares = 0, {}
    for name, gpus in first["summary"]["geometries"].items():
        for index, geometry in gpus.items():
            used, geometry_before = first["before"][name][int(index)]
            gb = sum(int(p[:-2]) * q for p, q in geometry.items())
            if gb > H100_80GB.memory_gb:
                fail(f"{name} GPU {index} holds {gb} GB of shares: {geometry}")
            lost = {f"{g}gb": c for g, c in used.items()
                    if geometry.get(f"{g}gb", 0) < c}
            if lost:
                fail(f"{name} GPU {index}'s used shares {lost} are gone "
                     f"from {geometry}")
            carved += geometry != geometry_before
            for p, q in geometry.items():
                shares[p] = shares.get(p, 0) + q
    timed = [r["ms"] for r in runs[1:]]
    return {"nodes": len(spec["nodes"]), "gpus": sum(
                n["gpus"] for n in spec["nodes"]),
            "pending": len(spec["pending"]),
            "plan_ms_median": statistics.median(timed),
            "plan_ms_max": max(timed), "plan_ms_untimed": runs[0]["ms"],
            "plan_ms": timed,
            "forks": first["counts"].get("forks", 0),
            "commits": first["counts"].get("commits", 0),
            "reverts": first["counts"].get("reverts", 0),
            "filter_runs": first["counts"].get("filter_runs", 0),
            "pods_placed": sum(len(v) for v in
                               first["summary"]["placed"].values()),
            "gpus_carved": carved,
            "shares_by_size": dict(sorted(
                shares.items(), key=lambda kv: int(kv[0][:-2]))),
            "lacking_after": first["summary"]["lacking"], "digest": digest}


class _CardLoop:
    """The MPS loop on the card's node (the model and memory discovery
    found, one GPU), on an in-memory API server or the ``api`` given (a
    REST client): node and pod controllers feeding a ClusterState, the
    partitioner controller from its factory, the node's chip agent, and
    the scheduler from ``build_scheduler``.  ``step`` is one pass of the
    loop: a scheduler cycle, a controller poll, an agent tick (timed).
    ``clock`` is the controller's batch clock; ``wall`` the scheduler's,
    which stamps the pods' creation times too, so schedule latency is
    one time domain.  The loop's chip-second waste ledger (``ledger``,
    on ``clock``) is installed as the process's: the controller stamps
    its holds there and the scheduler books its waterfall."""

    def __init__(self, device: dict, clock=time.monotonic,
                 wall=time.time, api=None, watch=None,
                 **controller_kw) -> None:
        from nos_tpu_torch.cmd.assembly import build_scheduler
        from nos_tpu_torch.obs.ledger import ChipSecondLedger, set_ledger
        from nos_tpu_torch.controllers.chipagent import ChipAgent
        from nos_tpu_torch.controllers.node_controller import NodeController
        from nos_tpu_torch.controllers.pod_controller import PodController
        from nos_tpu_torch.kube.client import APIServer, KIND_NODE
        from nos_tpu_torch.partitioning.state import ClusterState
        from nos_tpu_torch.partitioning.timeshare import (
            new_timeshare_partitioner_controller)
        from nos_tpu_torch.testing.factory import make_gpu_node
        from nos_tpu_torch.topology import DEFAULT_REGISTRY

        self.ledger = ChipSecondLedger(clock=clock)
        set_ledger(self.ledger)
        self.model = DEFAULT_REGISTRY.get(device["model"])
        if self.model.memory_gb * 1e9 > device["memory_bytes"]:
            fail(f"the card has {device['memory_bytes']} B, less than its "
                 f"model's {self.model.memory_gb} GB")
        self.api = APIServer() if api is None else api
        # what records the loop's writes: the substrate's own watch, or
        # a REST stub's commit log (_StubTap)
        self.watch = self.api.watch if watch is None else watch
        state = ClusterState()
        NodeController(self.api, state).bind()
        PodController(self.api, state).bind()
        self.controller = new_timeshare_partitioner_controller(
            self.api, state, batch_timeout_s=CARD_BATCH_TIMEOUT_S,
            batch_idle_s=CARD_BATCH_IDLE_S, clock=clock, **controller_kw)
        self.controller.bind()
        self.api.create(KIND_NODE, make_gpu_node(CARD_NODE, model=self.model,
                                                 gpus=1))
        self.agent = ChipAgent(self.api, CARD_NODE)
        self.agent.start()
        self.wall = wall
        self.sched = build_scheduler(self.api, clock=wall)
        self.cycle_ms: list[float] = []
        self.cycles = 0
        self.tick_ms: list[float] = []
        self.step_ms: list[float] = []
        self.created: dict[str, float] = {}
        self.bound_ms: dict[str, float] = {}

    def create_pod(self, name: str, gb: int = CARD_SHARE_GB,
                   namespace: str = "default", gang: str = "",
                   annotations: dict | None = None) -> None:
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.kube.client import KIND_POD
        from nos_tpu_torch.testing.factory import make_timeshare_pod

        self.created[name] = time.perf_counter()
        self.api.create(KIND_POD, make_timeshare_pod(
            gb, name=name, namespace=namespace,
            creation_timestamp=self.wall(),
            labels={C.LABEL_POD_GROUP: gang} if gang else None,
            annotations=annotations))

    def create_pods(self) -> None:
        for i in range(CARD_PODS):
            self.create_pod(f"train-{i}")

    def bind(self) -> int:
        from nos_tpu_torch.kube.client import KIND_POD

        t0 = time.perf_counter()
        bound = self.sched.run_cycle()
        now = time.perf_counter()
        self.cycle_ms.append((now - t0) * 1e3)
        for pod in self.api.list(KIND_POD):
            name = pod.metadata.name
            if pod.spec.node_name and name not in self.bound_ms \
                    and name in self.created:
                self.bound_ms[name] = (now - self.created[name]) * 1e3
        return bound

    def process(self) -> bool:
        ran = self.controller.process_if_ready()
        self.cycles += ran
        return ran

    def tick(self) -> None:
        t0 = time.perf_counter()
        self.agent.tick()
        self.tick_ms.append((time.perf_counter() - t0) * 1e3)

    def step(self) -> None:
        t0 = time.perf_counter()
        self.bind()
        self.process()
        self.tick()
        self.step_ms.append((time.perf_counter() - t0) * 1e3)

    def run_until(self, done, what: str, poll_s: float = CARD_POLL_S,
                  advance=None, limit_s: float = CARD_BIND_LIMIT_S) -> float:
        """Step until ``done()``; fail after ``limit_s``.  Returns the
        seconds it took.  ``advance`` moves an injected clock before each
        step."""
        t0 = time.monotonic()
        while not done():
            if time.monotonic() - t0 > limit_s:
                fail(f"the MPS loop did not {what} within {limit_s} s")
            if advance is not None:
                advance()
            self.step()
            time.sleep(poll_s)
        return time.monotonic() - t0

    # -- reading ----------------------------------------------------------
    def node(self):
        from nos_tpu_torch.kube.client import KIND_NODE

        return self.api.get(KIND_NODE, CARD_NODE)

    def pods(self) -> dict:
        from nos_tpu_torch.kube.client import KIND_POD

        return {p.metadata.name: p for p in self.api.list(KIND_POD)}

    def configmap(self):
        from nos_tpu_torch.kube.client import KIND_CONFIGMAP
        from nos_tpu_torch.partitioning.timeshare import (
            DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE)

        return self.api.get(KIND_CONFIGMAP, DEVICE_PLUGIN_CM_NAME,
                            DEVICE_PLUGIN_CM_NAMESPACE)

    def running(self) -> list[str]:
        return sorted(n for n, p in self.pods().items()
                      if p.spec.node_name == CARD_NODE
                      and p.status.phase == "Running")

    def status(self, index: int, share: str, what: str) -> str | None:
        from nos_tpu_torch.api import constants as C

        return self.node().metadata.annotations.get(
            f"{C.ANNOT_STATUS_PREFIX}{index}-{share}-{what}")

    def written(self) -> tuple:
        """What a plan writes: the ConfigMap (data and version) and the
        node's plan label and spec plan id."""
        from nos_tpu_torch.api import constants as C

        cm, node = self.configmap(), self.node()
        return (dict(cm.data), cm.metadata.resource_version,
                node.metadata.labels.get(C.LABEL_DEVICE_PLUGIN_CONFIG),
                node.metadata.annotations.get(
                    C.spec_plan_annotation(C.MPS_KIND)))


def _plan_seconds(kind: str = "mps") -> tuple[int, float]:
    """The count and sum of nos_tpu_plan_seconds of a kind."""
    from nos_tpu_torch.exporter.metrics import REGISTRY

    got = REGISTRY.summary("nos_tpu_plan_seconds", {"kind": kind})
    return (0, 0.0) if got is None else got[:2]


def _plans_total(kind: str = "mps") -> float:
    from nos_tpu_torch.exporter.metrics import REGISTRY

    return REGISTRY.value("nos_tpu_plans_total", {"kind": kind}) or 0.0


def _card_loop(device: dict) -> tuple[_CardLoop, dict, list[dict]]:
    """Phase 9 (b) up to the children: four pending 24 GB pods through
    the MPS loop until three are bound and Running, the checks on what
    the controller, the plugin and the reporter wrote, one more
    (rescan) cycle that must write nothing, and each bound pod's grant
    derived from the node side.  Returns the loop, the phase's fields
    and the grants (the pod's name under "pod", its environment)."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.partitioning.timeshare import config_key

    share = f"{CARD_SHARE_GB}gb"
    loop = _CardLoop(device)
    plans0, (samples0, plan_s0) = _plans_total(), _plan_seconds()
    landed0, latency_s0 = _actuation_latency()
    loop.create_pods()
    bind_s = loop.run_until(lambda: len(loop.running()) == 3,
                            "bind three pods and run them")
    (samples1, plan_s1) = _plan_seconds()
    if loop.cycles != 1 or _plans_total() - plans0 != 1 \
            or samples1 - samples0 != 1:
        fail(f"{loop.cycles} plan cycles ran ({_plans_total() - plans0} "
             f"counted), not one")
    node = loop.node()
    annots = node.metadata.annotations
    spec = annots.get(C.spec_plan_annotation(C.MPS_KIND), "")
    cm = loop.configmap()
    if list(cm.data) != [config_key(CARD_NODE, spec)]:
        fail(f"the ConfigMap holds {list(cm.data)}, not one key for "
             f"{CARD_NODE} under its plan {spec!r}")
    config = json.loads(cm.data[config_key(CARD_NODE, spec)])
    resources = config["sharing"]["mps"]["resources"]
    res = f"{C.RESOURCE_TIMESHARE_PREFIX}{share}"
    if [(r["rename"], r["memoryGB"], r["replicas"], r["devices"])
            for r in resources] != [(res, CARD_SHARE_GB, 3, ["0"])]:
        fail(f"the config gives GPU 0 {resources}, not three "
             f"{CARD_SHARE_GB} GB replicas")
    advertised = {r: q for r, q in node.status.allocatable.items()
                  if r.startswith(C.RESOURCE_TIMESHARE_PREFIX)}
    if advertised != {res: 3.0}:
        fail(f"the plugin advertises {advertised}, not {res}: 3")
    status = annots.get(C.status_plan_annotation(C.MPS_KIND), "")
    if not spec or status != spec:
        fail(f"the handshake is open: status plan {status!r}, spec {spec!r}")
    if loop.status(0, share, "used") != "3":
        fail(f"the reporter shows GPU 0 {share}-used "
             f"{loop.status(0, share, 'used')!r}, not 3")
    pods = loop.pods()
    (left,) = [n for n in pods if n not in loop.running()]
    if pods[left].status.phase != "Pending" or pods[left].spec.node_name \
            or not pods[left].is_unschedulable():
        fail(f"{left} is {pods[left].status}, not pending and "
             f"Unschedulable")
    landed, latency_s = _actuation_latency()
    if landed - landed0 != 1:
        fail(f"{landed - landed0} nos_tpu_actuation_latency_seconds "
             f"samples, not one")
    actuation_ms = (latency_s - latency_s0) * 1e3

    # one rescan interval on: a cycle on the fourth pod that writes nothing
    written = loop.written()
    rescan_s = loop.run_until(lambda: loop.cycles == 2,
                              "run its rescan cycle")
    samples2, plan_s2 = _plan_seconds()
    if loop.written() != written:
        fail(f"the rescan cycle wrote: {written} -> {loop.written()}")
    from nos_tpu_torch.exporter.metrics import REGISTRY
    if REGISTRY.value("nos_tpu_plan_pending_pods",
                      {"kind": C.MPS_KIND}) != 1.0:
        fail("the rescan cycle did not plan for the fourth pod")

    # the waterfall: the card's node held as actuation from the plan to
    # its status catching up, and conserved
    waste = _check_conserves(loop.ledger.report(), "the MPS loop")
    actuation = waste["pools"].get("-", {}).get("chip_seconds", {}).get(
        "actuation", 0.0)
    if not actuation > 0.0:
        fail(f"the MPS loop's waterfall shows no actuation GPU-seconds: "
             f"{waste['pools']}")

    grants = _grants(loop, device, loop.running())
    fields = {
        "node": CARD_NODE, "model": loop.model.name, "pods": CARD_PODS,
        "share_gb": CARD_SHARE_GB, "batch_idle_s": CARD_BATCH_IDLE_S,
        "batch_timeout_s": CARD_BATCH_TIMEOUT_S,
        "running": loop.running(), "unschedulable": left,
        "config_keys": len(cm.data), "config": resources,
        "advertised": advertised, "plan_cycles": loop.cycles,
        "plan_cycle_ms": [(plan_s1 - plan_s0) * 1e3,
                          (plan_s2 - plan_s1) * 1e3],
        "actuation_latency_ms": actuation_ms, "bind_s": bind_s,
        "rescan_s": rescan_s, "waste": _waste_line(waste),
        "grants": [{"pod": g["pod"], "gpu": g["gpu"],
                    "gb": int(g["env"]["NOS_TPU_TIMESHARE_GB"])}
                   for g in grants]}
    return loop, fields, grants


def _check_conserves(report: dict, what: str) -> dict:
    """``report`` when every pool's categories sum to its capacity's
    integral within 1e-6 (the JAX package's ``conservation_ok``), else a
    failure naming ``what`` and the deltas."""
    from nos_tpu_torch.obs.ledger import check_conservation

    try:
        return check_conservation(report, what)
    except RuntimeError as e:
        fail(str(e))


def _waste_line(report: dict) -> dict:
    """A waste report for a phase's line: the fleet's GPU-seconds per
    category, its capacity's, and each pool's conservation delta."""
    return {"gpu_seconds": report["fleet"]["chip_seconds"],
            "capacity_gpu_seconds":
                report["fleet"]["capacity_chip_seconds"],
            "conservation_delta": {p: v["conservation_delta"]
                                   for p, v in report["pools"].items()}}


def _grants(loop: _CardLoop, device: dict, names: list[str]) -> list[dict]:
    """Each named bound pod's grant: a GPU of the applied config on which
    the reporter shows a used share of the pod's size (one pod per used
    share), mapped to the card's UUID through discovery, and the GB of
    its request.  The smoke stands in for the kubelet plugin's Allocate
    (``device/deviceplugin``, which needs grpcio, absent from the card's
    machine), which would hand the pod this grant."""
    from nos_tpu_torch.api import constants as C

    annots = loop.node().metadata.annotations
    gpus = loop.agent.plugin.gpu_config(annots[C.ANNOT_PLUGIN_APPLIED_CONFIG])
    return _grants_of(loop.node(), loop.pods(), gpus, device, names)


def _grants_of(node, pods: dict, gpus: dict, device: dict,
               names: list[str]) -> list[dict]:
    """``_grants`` from the objects: the node (its used-share status
    annotations), the pods by name and the applied config's GPUs."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.kube.resources import pod_request
    from nos_tpu_torch.topology.profile import extract_timeshare_requests

    def status(i: int, s: str) -> str | None:
        return node.metadata.annotations.get(
            f"{C.ANNOT_STATUS_PREFIX}{i}-{s}-used")

    used = {s: [i for i in sorted(gpus)
                for _ in range(int(status(i, s) or 0))]
            for t in gpus.values() for s in t}
    grants = []
    for name in names:
        (gb,) = extract_timeshare_requests(pod_request(pods[name]))
        if not used.get(f"{gb}gb"):
            fail(f"the reporter shows no used {gb}gb share for {name}")
        index = used[f"{gb}gb"].pop(0)
        grants.append({"pod": name, "gpu": index, "env": {
            "NOS_TPU_VISIBLE_CHIPS": device["uuids"][index],
            "NOS_TPU_TIMESHARE_GB": str(gb)}})
    return grants


def _actuation_latency(kind: str = "mps") -> tuple[int, float]:
    """The count and sum of nos_tpu_actuation_latency_seconds of a kind."""
    from nos_tpu_torch.exporter.metrics import REGISTRY

    got = REGISTRY.summary("nos_tpu_actuation_latency_seconds",
                           {"kind": kind, "pool": "-"})
    return (0, 0.0) if got is None else got[:2]


def _card_release(loop: _CardLoop) -> dict:
    """Phase 9 (b) after the children: their pods marked Succeeded (as
    the kubelet would report them), the reporter must free the three
    shares, and the scheduler must bind the fourth pod onto one with no new
    plan."""
    from nos_tpu_torch.kube.client import KIND_POD

    share = f"{CARD_SHARE_GB}gb"
    done = loop.running()
    for name in done:
        loop.api.patch(KIND_POD, name, "default", mutate=lambda p:
                       setattr(p.status, "phase", "Succeeded"))
    loop.tick()
    freed = (loop.status(0, share, "free"), loop.status(0, share, "used"))
    if freed != ("3", None):
        fail(f"after the children the reporter shows GPU 0 {share} "
             f"(free, used) {freed}, not 3 free")
    written, cycles, plans = loop.written(), loop.cycles, _plans_total()
    if loop.bind() != 1:
        fail("the scheduler did not bind the fourth pod onto a freed share")
    loop.process()
    loop.tick()
    (last,) = loop.running()
    if loop.written() != written or loop.cycles != cycles \
            or _plans_total() != plans:
        fail("binding the fourth pod took a new plan")
    if loop.status(0, share, "used") != "1":
        fail(f"the reporter shows GPU 0 {share}-used "
             f"{loop.status(0, share, 'used')!r} after the fourth pod")
    return {"succeeded": done, "rebound": last,
            "free_used_after_children": freed}


def _step_windows(children: list[dict]) -> tuple[list[list[float]], float]:
    """Each child's window on the host's wall clock, from the start of
    its first step to the log line of its last (the main logs a step
    after its loss has come back from the card), relative to the
    earliest start; and how long all the windows held at once.  The
    first step's start is its log line less the step's tokens over its
    logged tokens/s."""
    from nos_tpu_torch.entry import TRAIN_BATCH, TRAIN_SEQ

    spans = []
    for ch in children:
        (first, t_first, tokens_s), last = ch["stamps"][0], ch["stamps"][-1]
        if first != 1 or last[0] != GRANT_STEPS:
            fail(f"partition {ch['case']} logged step times {ch['stamps']}")
        spans.append((t_first - TRAIN_BATCH * TRAIN_SEQ / tokens_s, last[1]))
    origin = min(a for a, _ in spans)
    overlap = min(b for _, b in spans) - max(a for a, _ in spans)
    return [[a - origin, b - origin] for a, b in spans], overlap


def phase_partition(main_loss0: float, device: dict, smi: str) -> dict:
    """The MPS planner and its loop: (a) the fleet plan on the host, five
    timed runs against the pinned digest; (b) the card's node driven by
    the partitioner controller, its chip agent (timeshare plugin and
    reporter) and the scheduler (``_card_loop``), then one
    ``python -m nos_tpu_torch.cmd.train`` child per bound pod, all at
    once, each under the grant derived from the applied config and the
    pod's request, then the pods' release (``_card_release``).  The smoke
    stands in for the kubelet plugin's Allocate (``device/deviceplugin``,
    which needs grpcio, absent from the card's machine), which would hand
    each pod its grant."""
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    fleet_line = _fleet_plans()
    loop, card, grants = _card_loop(device)
    total = device["memory_bytes"]
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    parent_reserved = torch.cuda.memory_reserved()
    with tempfile.TemporaryDirectory(prefix="nos-partition-") as tmp:
        cfg_path, no_nvcc = _grant_workdir(tmp)
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(grants)) as pool:
            children = list(pool.map(
                lambda g: _run_grant_child(g["pod"], cfg_path, g["env"],
                                           no_nvcc), grants))
        concurrent_s = time.perf_counter() - t1
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"a partition child built kernels: {kernels_before} -> "
             f"{kernels_after}")
    for child in children:
        child["fraction"], child["cap_bytes"] = _grant_cap(
            int(child["grant"]["NOS_TPU_TIMESHARE_GB"]), total)
        _check_granted_child(f"partition {child['case']}", child,
                             child["grant"]["NOS_TPU_VISIBLE_CHIPS"],
                             main_loss0)
    windows, overlap_s = _step_windows(children)
    if not overlap_s > 0:
        fail(f"the children's steps did not overlap: windows {windows} s "
             f"from the first start")
    for child, window in zip(children, windows):
        child["step_window_s"] = window
    # implied by the caps each child was held to (3 x 24 / 80 x 0.9 of
    # the card): kept as the sum a reader of the line looks for
    reserved = sum(ch["peak_reserved_bytes"] for ch in children)
    if not reserved < total:
        fail(f"the three children reserved {reserved} B at their peaks, "
             f"not under the card's {total} B")
    card["release"] = _card_release(loop)
    card["tick_ms_median"] = statistics.median(loop.tick_ms)
    card["tick_ms_max"] = max(loop.tick_ms)
    card["ticks"] = len(loop.tick_ms)
    card["bound_ms"] = dict(sorted(loop.bound_ms.items()))
    emit({"phase": "partition", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0,
          "fleet": fleet_line, "card": card,
          "card_memory_bytes": total, "parent_reserved_bytes":
              parent_reserved, "main_loss0": main_loss0,
          "loss0_rtol": MAIN_LOSS0_RTOL, "concurrent_wall_s": concurrent_s,
          "steps_overlap_s": overlap_s,
          "peak_reserved_sum_bytes": reserved,
          "peak_allocated_sum_bytes": sum(ch["peak_bytes"]
                                          for ch in children),
          "children": [{k: v for k, v in ch.items()
                        if k not in ("stderr", "report", "stamps")}
                       | {"launches": ch["report"]["launches"]}
                       for ch in children]})
    return {ch["case"]: ch["report"]["launches"] for ch in children}


# The mig phase: host-only.  (a) the MIG fleet plan; (b) the MIG
# reporter over the card's NVML; (c) one H100 node through the MIG loop,
# actuated on the fake runtime.
MIG_PLANS = 5
MIG_NODE = "h100-mig-node-0"
MIG_PODS = ("3g.40gb", "2g.20gb", "1g.10gb", "1g.10gb", "1g.10gb")
MIG_RELEASED = "mig-2"       # a bound 1g.10gb pod, deleted in step 5
# What the MIG loop writes (_MigLoop._record), as its CPU test's run
# recorded it (tests/test_torch_sliceagent.py), on the fake runtime (c)
# and on NVML over the fake library (d) alike.  No write names a device
# id (the fake's ids and NVML's MIG UUIDs differ): a device appears only
# through its placement ("status-gpu-placements-0") and counts.
MIG_LOOP_WRITES = {
    "h100-mig-node-0": [
        [],
        ["spec-gpu-0-7g.80gb=1", "spec-partitioning-plan.mig=<plan 0>"],
        [
            "device-plugin-generation=1",
            "spec-gpu-0-7g.80gb=1",
            "spec-partitioning-plan.mig=<plan 0>",
            "mig-7g.80gb=1",
        ],
        [
            "device-plugin-generation=1",
            "spec-gpu-0-7g.80gb=1",
            "spec-partitioning-plan.mig=<plan 0>",
            "status-gpu-0-7g.80gb-free=1",
            "status-gpu-placements-0=f|7g.80gb|0|8",
            "status-partitioning-plan.mig=<plan 0>",
            "mig-7g.80gb=1",
        ],
        [
            "device-plugin-generation=1",
            "spec-gpu-0-1g.10gb=2",
            "spec-gpu-0-2g.20gb=1",
            "spec-gpu-0-3g.40gb=1",
            "spec-partitioning-plan.mig=<plan 1>",
            "status-gpu-0-7g.80gb-free=1",
            "status-gpu-placements-0=f|7g.80gb|0|8",
            "status-partitioning-plan.mig=<plan 0>",
            "mig-7g.80gb=1",
        ],
        [
            "device-plugin-generation=2",
            "spec-gpu-0-1g.10gb=2",
            "spec-gpu-0-2g.20gb=1",
            "spec-gpu-0-3g.40gb=1",
            "spec-partitioning-plan.mig=<plan 1>",
            "status-gpu-0-7g.80gb-free=1",
            "status-gpu-placements-0=f|7g.80gb|0|8",
            "status-partitioning-plan.mig=<plan 0>",
            "mig-1g.10gb=2",
            "mig-2g.20gb=1",
            "mig-3g.40gb=1",
        ],
        [
            "device-plugin-generation=2",
            "spec-gpu-0-1g.10gb=2",
            "spec-gpu-0-2g.20gb=1",
            "spec-gpu-0-3g.40gb=1",
            "spec-partitioning-plan.mig=<plan 1>",
            "status-gpu-0-1g.10gb-free=2",
            "status-gpu-0-2g.20gb-free=1",
            "status-gpu-0-3g.40gb-free=1",
            "status-gpu-placements-0=f|1g.10gb|2|1;f|1g.10gb|3|1;f|2g.20gb|0|2;f|3g.40gb|4|4",
            "status-partitioning-plan.mig=<plan 1>",
            "mig-1g.10gb=2",
            "mig-2g.20gb=1",
            "mig-3g.40gb=1",
        ],
        [
            "device-plugin-generation=2",
            "spec-gpu-0-1g.10gb=2",
            "spec-gpu-0-2g.20gb=1",
            "spec-gpu-0-3g.40gb=1",
            "spec-partitioning-plan.mig=<plan 1>",
            "status-gpu-0-1g.10gb-used=2",
            "status-gpu-0-2g.20gb-used=1",
            "status-gpu-0-3g.40gb-used=1",
            "status-gpu-placements-0=u|1g.10gb|2|1;u|1g.10gb|3|1;u|2g.20gb|0|2;u|3g.40gb|4|4",
            "status-partitioning-plan.mig=<plan 1>",
            "mig-1g.10gb=2",
            "mig-2g.20gb=1",
            "mig-3g.40gb=1",
        ],
    ],
    "mig-0": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-mig-node-0 Pending",
        "h100-mig-node-0 Running",
    ],
    "mig-1": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-mig-node-0 Pending",
        "h100-mig-node-0 Running",
    ],
    "mig-2": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-mig-node-0 Pending",
        "h100-mig-node-0 Running",
        "deleted",
    ],
    "mig-3": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-mig-node-0 Pending",
        "h100-mig-node-0 Running",
    ],
    "mig-4": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-mig-node-0 Pending",
        "h100-mig-node-0 Running",
    ],
}


def _mig_fleet_plans() -> dict:
    """``testing/fleet.py``'s MIG fleet planned MIG_PLANS times, each on
    a fresh snapshot and timed: every plan must equal the pinned one,
    give each GPU one of the H100's maximal geometries within its 7
    compute slices and 8 memory slots, and keep every used instance."""
    from nos_tpu_torch.obs import trace
    from nos_tpu_torch.partitioning.core import GeometryPlanner
    from nos_tpu_torch.partitioning.slicepart import (
        SlicePartitionCalculator, SliceProfileCalculator, SliceSnapshotTaker)
    from nos_tpu_torch.scheduler.framework import Framework
    from nos_tpu_torch.testing import fleet
    from nos_tpu_torch.topology import H100_80GB, enumerate_geometries

    spec = fleet.mig_fleet_spec(0)
    bound = {b["name"] for n in spec["nodes"] for b in n["bound"]}
    calculator = SliceProfileCalculator()
    planner = GeometryPlanner(Framework(), calculator,
                              SlicePartitionCalculator())
    runs = []
    for _ in range(MIG_PLANS):
        snap = SliceSnapshotTaker().take_snapshot(fleet.build_cluster(spec))
        pending = fleet.build_pending(spec)
        before = {name: {u.index: (dict(u.used), u.geometry_names())
                         for u in node.units}
                  for name, node in snap.nodes().items()}
        tracer = trace.Tracer()
        prev = trace.set_tracer(tracer)
        try:
            t0 = time.perf_counter()
            planner.plan(snap, pending)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            trace.set_tracer(prev)
        (span,) = [sp for sp in tracer.ring.dump()
                   if sp["name"] == "planner.plan"]
        runs.append({"ms": ms, "counts": span["counts"], "before": before,
                     "summary": fleet.plan_summary(snap, pending, bound,
                                                   calculator)})
    first = runs[0]
    if any(r["summary"] != first["summary"] or r["counts"] != first["counts"]
           for r in runs):
        fail("the MIG fleet's plans differ between runs")
    digest = fleet.plan_digest(first["summary"])
    if digest != fleet.MIG_FLEET_DIGEST:
        fail(f"the MIG fleet plan's digest {digest} is not the pinned "
             f"{fleet.MIG_FLEET_DIGEST} (the CPU tests' plan)")
    allowed = {tuple(sorted(g)) for g in enumerate_geometries(H100_80GB)}
    carved, instances = 0, {}
    for name, gpus in first["summary"]["geometries"].items():
        for index, geometry in gpus.items():
            used, geometry_before = first["before"][name][int(index)]
            rows = [(H100_80GB.profile(p), q) for p, q in geometry.items()]
            compute = sum(r.compute_slices * q for r, q in rows)
            memory = sum(r.memory_slices * q for r, q in rows)
            if tuple(sorted(geometry.items())) not in allowed \
                    or compute > H100_80GB.compute_slices \
                    or memory > H100_80GB.memory_slices:
                fail(f"{name} GPU {index} is carved {geometry}: not an "
                     f"H100 geometry ({compute} compute slices, {memory} "
                     f"memory slots)")
            lost = {p: c for p, c in used.items()
                    if geometry.get(p, 0) < c}
            if lost:
                fail(f"{name} GPU {index}'s used instances {lost} are gone "
                     f"from {geometry}")
            carved += geometry != geometry_before
            for p, q in geometry.items():
                instances[p] = instances.get(p, 0) + q
    timed = [r["ms"] for r in runs]
    return {"nodes": len(spec["nodes"]), "gpus": sum(
                n["gpus"] for n in spec["nodes"]),
            "pending": len(spec["pending"]),
            "plan_ms_median": statistics.median(timed),
            "plan_ms_max": max(timed), "plan_ms": timed,
            "forks": first["counts"].get("forks", 0),
            "commits": first["counts"].get("commits", 0),
            "reverts": first["counts"].get("reverts", 0),
            "filter_runs": first["counts"].get("filter_runs", 0),
            "pods_placed": sum(len(v) for v in
                               first["summary"]["placed"].values()),
            "gpus_carved": carved,
            "instances_by_profile": dict(sorted(instances.items())),
            "lacking_after": first["summary"]["lacking"], "digest": digest}


def _mig_reporter_on_card(device: dict) -> dict:
    """The MIG agent's reporter over ``NvmlGpuRuntime`` on the card, for
    the card's node (its model from discovery) on an in-memory API
    server, with a pod-resources view that holds no device.  Its status
    and placement annotations must be NVML's MIG devices and
    placements; with MIG off, none.  Only the reporter runs: nothing
    creates or deletes a MIG instance, and no startup cleanup runs."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.controllers.sliceagent import (
        SharedState, SliceReporter)
    from nos_tpu_torch.device.fake import FakePodResources
    from nos_tpu_torch.device.gpuclient import SliceDeviceClient
    from nos_tpu_torch.device.nvml import NvmlGpuRuntime
    from nos_tpu_torch.kube.client import APIServer, KIND_NODE
    from nos_tpu_torch.testing.factory import make_gpu_node
    from nos_tpu_torch.topology import DEFAULT_REGISTRY
    from nos_tpu_torch.topology.annotations import (
        encode_placement_records, parse_placement_annotations,
        parse_status_annotations)
    from nos_tpu_torch.topology.profile import profile_from_resource

    model = DEFAULT_REGISTRY.get(device["model"])
    runtime = NvmlGpuRuntime(model)
    try:
        _, modes = runtime.topology()
        devices = runtime.list_devices()
        placements = runtime.placements()
        api = APIServer()
        api.create(KIND_NODE, make_gpu_node(
            CARD_NODE, model=model, gpus=len(modes),
            partitioning=C.MIG_KIND))
        SliceReporter(api, CARD_NODE,
                      SliceDeviceClient(runtime, FakePodResources()),
                      SharedState()).reconcile()
    finally:
        runtime.close()
    annots = api.get(KIND_NODE, CARD_NODE).metadata.annotations
    want_counts: dict[tuple[int, str, str], int] = {}
    want_records: dict[int, list] = {}
    for d in devices:
        key = (d.unit_index, profile_from_resource(d.resource_name), "free")
        want_counts[key] = want_counts.get(key, 0) + 1
        want_records.setdefault(d.unit_index, []).append(
            ("f", placements[d.device_id]))
    got_counts = {(a.index, a.profile, a.status): a.quantity
                  for a in parse_status_annotations(annots)}
    got_records = {i: encode_placement_records(r) for i, r in
                   parse_placement_annotations(annots).items()}
    if got_counts != want_counts or got_records != {
            i: encode_placement_records(r) for i, r in want_records.items()}:
        fail(f"the MIG reporter wrote {got_counts} and {got_records}; NVML "
             f"lists {want_counts} and {want_records}")
    if not any(modes) and (got_counts or got_records):
        fail("MIG is off, yet the reporter wrote MIG status")
    return {"mig_modes": ["enabled" if m else "disabled" for m in modes],
            "mig_devices": len(devices),
            "annotations": dict(sorted(annots.items()))}


class _Recorder:
    """A watch callback keeping each object's distinct states, plan ids
    masked in the order they appear (``<plan N>``): a node as its
    "key=value" annotations (group prefix off, no heartbeat) and the
    family's resources in its allocatable; a pod as "<node> <phase>",
    with "Unschedulable" when marked, its capacity label when it has
    one, the recovery plane's ``migrate`` and ``displaced`` stamps (the
    cause alone) and the elastic gangs' ``dp-resize`` when it carries
    them; a quota as its status.used in GB; a PodGroup as "<phase>
    <scheduled>"; "deleted" at the end.  The MIG, quota, gang, recovery
    and elastic loops pin what it records."""

    def __init__(self, family: str) -> None:
        self.family = family
        self.plans: dict[str, str] = {}
        self.writes: dict[str, list] = {}

    def mask(self, value: str) -> str:
        for plan_id, token in self.plans.items():
            value = value.replace(plan_id, token)
        return value

    def __call__(self, event: str, obj) -> None:
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.topology.profile import (
            is_slice_resource, is_timeshare_resource)

        annots = obj.metadata.annotations
        for plan_id in (
                annots.get(C.spec_plan_annotation(self.family), ""),
                annots.get(C.status_plan_annotation(self.family), "")):
            if plan_id and plan_id not in self.plans:
                self.plans[plan_id] = f"<plan {len(self.plans)}>"
        ours = is_slice_resource if self.family == C.MIG_KIND \
            else is_timeshare_resource
        if event == "DELETED":
            view = "deleted"
        elif hasattr(obj.status, "allocatable"):
            view = [f"{k.split('/', 1)[1]}={self.mask(v)}"
                    for k, v in sorted(annots.items())
                    if k != C.heartbeat_annotation(self.family)] + [
                f"{r.split('/', 1)[1]}={q:g}"
                for r, q in sorted(obj.status.allocatable.items())
                if ours(r)]
        elif hasattr(obj.status, "used"):
            view = f"used={obj.status.used.get(C.RESOURCE_GPU_MEMORY, 0):g}"
        elif hasattr(obj.status, "scheduled"):
            view = f"{obj.status.phase} {obj.status.scheduled}"
        else:
            capacity = obj.metadata.labels.get(C.LABEL_CAPACITY)
            view = f"{obj.spec.node_name or '-'} {obj.status.phase}" + (
                " Unschedulable" if obj.is_unschedulable() else "") + (
                f" {capacity}" if capacity else "") + "".join(
                f" {k.split('/', 1)[1]}={annots[k].split('@')[0]}"
                for k in (C.ANNOT_MIGRATE, C.ANNOT_DISPLACED,
                          C.ANNOT_DP_RESIZE)
                if annots.get(k))
        seq = self.writes.setdefault(obj.metadata.name, [])
        if not seq or seq[-1] != view:
            seq.append(view)


class _Counted:
    """A GPU runtime whose ``create_slices`` and ``delete_slice`` calls
    are counted, as ``FakeGpuRuntime`` counts its own."""

    def __init__(self, runtime) -> None:
        self.runtime = runtime
        self.create_calls = self.delete_calls = 0

    def __getattr__(self, name: str):
        return getattr(self.runtime, name)

    def create_slices(self, unit_index: int, profiles: list[str]) -> list[str]:
        self.create_calls += 1
        return self.runtime.create_slices(unit_index, profiles)

    def delete_slice(self, device_id: str) -> None:
        self.delete_calls += 1
        self.runtime.delete_slice(device_id)


class _MigLoop:
    """One H100 node through the MIG loop on an in-memory API server:
    node controller with the virgin-node initializer, pod controller,
    the MIG partitioner controller from its factory, the node's MIG
    agent (``SliceAgent``: kubelet simulator, reporter, actuator, device
    plugin) over ``FakeGpuRuntime(H100_80GB, 1)`` or the ``runtime``
    given, and the scheduler from ``build_scheduler``.  A ``_Recorder``
    keeps every distinct state of the node and the pods:
    MIG_LOOP_WRITES pins them."""

    def __init__(self, batch_timeout_s: float, batch_idle_s: float,
                 clock=time.monotonic, runtime=None) -> None:
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.cmd.assembly import build_scheduler
        from nos_tpu_torch.controllers.node_controller import NodeController
        from nos_tpu_torch.controllers.pod_controller import PodController
        from nos_tpu_torch.controllers.sliceagent import SliceAgent
        from nos_tpu_torch.device.fake import FakeGpuRuntime, FakePodResources
        from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD
        from nos_tpu_torch.partitioning.slicepart import (
            new_slice_initializer, new_slice_partitioner_controller)
        from nos_tpu_torch.partitioning.state import ClusterState
        from nos_tpu_torch.testing.factory import make_gpu_node
        from nos_tpu_torch.topology import H100_80GB

        self.api = APIServer()
        self.recorder = _Recorder(C.MIG_KIND)
        self.writes = self.recorder.writes
        self.api.watch(KIND_NODE, self.recorder)
        self.api.watch(KIND_POD, self.recorder)
        state = ClusterState()
        NodeController(self.api, state, new_slice_initializer(self.api)).bind()
        PodController(self.api, state).bind()
        self.controller = new_slice_partitioner_controller(
            self.api, state, batch_timeout_s=batch_timeout_s,
            batch_idle_s=batch_idle_s, clock=clock)
        self.controller.bind()
        self.api.create(KIND_NODE, make_gpu_node(
            MIG_NODE, model=H100_80GB, gpus=1, partitioning="mig"))
        self.runtime = FakeGpuRuntime(H100_80GB, 1) if runtime is None \
            else _Counted(runtime)
        self.agent = SliceAgent(self.api, MIG_NODE, self.runtime,
                                FakePodResources())
        self.agent.start()
        self.sched = build_scheduler(self.api)
        self.cycles = 0
        self.tick_ms: list[float] = []
        self.created: dict[str, float] = {}
        self.bound_ms: dict[str, float] = {}

    def create_pods(self) -> None:
        from nos_tpu_torch.kube.client import KIND_POD
        from nos_tpu_torch.testing.factory import make_mig_pod

        for i, profile in enumerate(MIG_PODS):
            name = f"mig-{i}"
            self.created[name] = time.perf_counter()
            self.api.create(KIND_POD, make_mig_pod(profile, name=name))

    def step(self) -> None:
        from nos_tpu_torch.kube.client import KIND_POD

        self.sched.run_cycle()
        now = time.perf_counter()
        for pod in self.api.list(KIND_POD):
            name = pod.metadata.name
            if pod.spec.node_name and name not in self.bound_ms:
                self.bound_ms[name] = (now - self.created[name]) * 1e3
        self.cycles += self.controller.process_if_ready()
        t0 = time.perf_counter()
        self.agent.tick()
        self.tick_ms.append((time.perf_counter() - t0) * 1e3)

    def run_until(self, done, what: str, limit_s: float = CARD_BIND_LIMIT_S,
                  poll_s: float = CARD_POLL_S, advance=None) -> None:
        """Step until ``done()``; fail after ``limit_s`` seconds of
        steps.  ``advance`` moves an injected clock before each step."""
        t0 = time.monotonic()
        while not done():
            if time.monotonic() - t0 > limit_s:
                fail(f"the MIG loop did not {what} within {limit_s} s")
            if advance is not None:
                advance()
            self.step()
            time.sleep(poll_s)

    def node(self):
        from nos_tpu_torch.kube.client import KIND_NODE

        return self.api.get(KIND_NODE, MIG_NODE)

    def pods(self) -> dict:
        from nos_tpu_torch.kube.client import KIND_POD

        return {p.metadata.name: p for p in self.api.list(KIND_POD)}

    def running(self) -> list[str]:
        return sorted(n for n, p in self.pods().items()
                      if p.spec.node_name == MIG_NODE
                      and p.status.phase == "Running")

    def handshake_closed(self) -> bool:
        from nos_tpu_torch.api import constants as C

        annots = self.node().metadata.annotations
        spec = annots.get(C.spec_plan_annotation(C.MIG_KIND), "")
        return bool(spec) and annots.get(
            C.status_plan_annotation(C.MIG_KIND)) == spec


def _mig_loop(batch_timeout_s: float = CARD_BATCH_TIMEOUT_S,
              batch_idle_s: float = CARD_BATCH_IDLE_S,
              clock=time.monotonic, advance=None, poll_s: float = CARD_POLL_S,
              runtime=None) -> tuple[dict, dict]:
    """Phase 10 (c): the scenario through ``_MigLoop``.  (1) The virgin
    node is initialised to 7g.80gb and the agent carves it; (2) five
    pods (3g.40gb, 2g.20gb and three 1g.10gb) need one re-carve, which
    closes in one plan cycle with four bound and Running; (3) the fifth
    stays pending and Unschedulable; (4) one rescan interval later a
    cycle on it writes nothing; (5) a bound 1g.10gb pod is deleted and
    the fifth binds onto its instance with no new plan.  Returns the
    phase's fields and the loop's writes.  ``clock`` and ``advance`` let
    a test drive it on an injected clock; ``runtime`` replaces the fake
    runtime under the agent (part (d))."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.kube.client import KIND_POD

    loop = _MigLoop(batch_timeout_s, batch_idle_s, clock=clock,
                    runtime=runtime)
    run = functools.partial(loop.run_until, poll_s=poll_s, advance=advance)
    plans0 = _plans_total(C.MIG_KIND)
    plan0, landed0 = (_plan_seconds(C.MIG_KIND),
                      _actuation_latency(C.MIG_KIND))
    run(loop.handshake_closed, "carve the virgin node")
    if loop.runtime.create_calls != 1:
        fail(f"the virgin node took {loop.runtime.create_calls} creates")
    loop.create_pods()
    run(lambda: len(loop.running()) == 4, "bind four pods and run them")
    plan1 = _plan_seconds(C.MIG_KIND)
    if loop.cycles != 1 or _plans_total(C.MIG_KIND) - plans0 != 1:
        fail(f"{loop.cycles} MIG plan cycles ran, not one")
    if not loop.handshake_closed():
        fail("the MIG handshake is open after the plan cycle")
    pods = loop.pods()
    (left,) = [n for n in pods if n not in loop.running()]
    if pods[left].status.phase != "Pending" or pods[left].spec.node_name \
            or not pods[left].is_unschedulable():
        fail(f"{left} is {pods[left].status}, not pending and "
             f"Unschedulable")
    landed = _actuation_latency(C.MIG_KIND)
    if landed[0] - landed0[0] != 1:
        fail(f"{landed[0] - landed0[0]} MIG actuation latency samples, "
             f"not one")
    node_writes = len(loop.writes[MIG_NODE])
    run(lambda: loop.cycles == 2, "run its rescan cycle")
    plan2 = _plan_seconds(C.MIG_KIND)
    if len(loop.writes[MIG_NODE]) != node_writes:
        fail(f"the MIG rescan cycle wrote: {loop.writes[MIG_NODE][-1]}")
    loop.api.delete(KIND_POD, MIG_RELEASED, "default")
    plans = _plans_total(C.MIG_KIND)
    run(lambda: left in loop.running(), "bind the fifth pod")
    if loop.cycles != 2 or _plans_total(C.MIG_KIND) != plans \
            or len(loop.writes[MIG_NODE]) != node_writes:
        fail("binding the fifth pod took a new plan")
    fields = {
        "node": MIG_NODE,
        "runtime": type(getattr(loop.runtime, "runtime",
                                loop.runtime)).__name__,
        "pods": list(MIG_PODS), "batch_idle_s": batch_idle_s,
        "batch_timeout_s": batch_timeout_s, "running": loop.running(),
        "unschedulable_until_release": left, "released": MIG_RELEASED,
        "plan_cycles": loop.cycles,
        "plan_cycle_ms": [(plan1[1] - plan0[1]) * 1e3,
                          (plan2[1] - plan1[1]) * 1e3],
        "actuation_latency_ms": (landed[1] - landed0[1]) * 1e3,
        "tick_ms_median": statistics.median(loop.tick_ms),
        "tick_ms_max": max(loop.tick_ms), "ticks": len(loop.tick_ms),
        "bound_ms": dict(sorted(loop.bound_ms.items())),
        "create_calls": loop.runtime.create_calls,
        "delete_calls": loop.runtime.delete_calls,
        "geometry": {a: v for a, v in loop.node().metadata.annotations.items()
                     if a.startswith(C.ANNOT_SPEC_PREFIX)}}
    return fields, loop.writes


def _mig_loop_on_nvml() -> dict:
    """Part (d): the loop of (c) with the agent on ``NvmlGpuRuntime``
    over the fake NVML library, one H100 in MIG mode.  Its writes must
    equal MIG_LOOP_WRITES; the fake library's GPU instances at the end
    must be the placements the node reports."""
    from nos_tpu_torch.device import nvml
    from nos_tpu_torch.testing.nvml import FakeGpu, FakeNvmlLibrary
    from nos_tpu_torch.topology import H100_80GB

    lib = FakeNvmlLibrary([FakeGpu(mig=True)])
    runtime = nvml.NvmlGpuRuntime(H100_80GB, lib=lib)
    try:
        fields, writes = _mig_loop(runtime=runtime)
        placements = sorted((pl.profile, pl.start)
                            for pl in runtime.placements().values())
    finally:
        runtime.close()
    if writes != MIG_LOOP_WRITES:
        fail(f"the MIG loop on NVML over the fake library wrote "
             f"{json.dumps(writes)}")
    held = sorted((next(p.name for p in H100_80GB.mig_profiles
                        if p.nvml_id == gi.profile), gi.start)
                  for gi in lib.gpus[0].gis.values())
    if held != placements:
        fail(f"the fake NVML holds {held}, the runtime reads {placements}")
    return fields | {"nvml_writes": {c: lib.calls.count(c)
                                     for c in nvml.WRITE_CALLS},
                     "gpu_instances": held}


class _NoWrites:
    """The loaded NVML with every create and destroy call counted and
    refused (NVML_ERROR_NO_PERMISSION) before it reaches the driver."""

    def __init__(self, lib) -> None:
        self._lib = lib
        self.refused: list[str] = []
        self.reads = 0

    def __getattr__(self, name: str):
        from nos_tpu_torch.device import nvml

        fn = getattr(self._lib, name)
        if "Create" in name or "Destroy" in name:
            def refused(*args):
                self.refused.append(name)
                return nvml.NVML_ERROR_NO_PERMISSION
            return refused

        def read(*args):
            self.reads += 1
            return fn(*args)
        return read


def _mig_nvml_on_card(device: dict) -> dict:
    """Part (e): ``NvmlGpuRuntime`` on the card's NVML through
    ``_NoWrites``.  With MIG off on GPU 0: the MIG create is refused
    with ``MigModeDisabled`` and no create call, a block shard is taken,
    listed, named through ``gpu_uuids()`` and deleted, and
    ``delete_all_except`` deletes a second shard and nothing else.  In
    MIG mode the shard must be refused.  No create or destroy call may
    reach the proxy."""
    from nos_tpu_torch.device import nvml
    from nos_tpu_torch.topology import DEFAULT_REGISTRY
    from nos_tpu_torch.topology.errors import PlacementInfeasibleError
    from nos_tpu_torch.topology.profile import slice_resource_name

    try:
        lib = nvml.load_library()      # binds every call in SIGNATURES
    except nvml.NvmlUnavailable as e:
        fail(f"the card's NVML: {e}")
    proxy = _NoWrites(lib)
    runtime = nvml.NvmlGpuRuntime(DEFAULT_REGISTRY.get(device["model"]),
                                  lib=proxy)
    out: dict = {"symbols": list(nvml.LIFECYCLE_CALLS)}
    try:
        _, modes = runtime.topology()
        out["mig_modes"] = ["enabled" if m else "disabled" for m in modes]
        before = sorted(runtime.list_devices().ids())
        if modes[0]:
            try:
                runtime.create_slices(0, [BLOCK_PROFILE])
                fail("GPU 0 in MIG mode took a block shard")
            except PlacementInfeasibleError as e:
                out["shard_refused"] = str(e)
            out["skipped"] = ("MIG mode on: the create refusal and the "
                              "cleanup are not exercised")
        else:
            try:
                runtime.create_slices(0, ["1g.10gb"])
                fail("a MIG create on GPU 0 with MIG off was not refused")
            except nvml.MigModeDisabled as e:
                out["mig_refused"] = str(e)
            if proxy.refused:
                fail(f"the refused MIG create called {proxy.refused}")
            (shard,) = runtime.create_slices(0, [BLOCK_PROFILE])
            listed = [(d.resource_name, d.unit_index)
                      for d in runtime.list_devices() if d.device_id == shard]
            if listed != [(slice_resource_name(BLOCK_PROFILE), 0)]:
                fail(f"the block shard {shard} is listed as {listed}")
            if shard in runtime.placements():
                fail("the block shard has a MIG placement")
            uuids = runtime.gpu_uuids()
            if uuids[0].lower() != device["uuid"].lower():
                fail(f"gpu_uuids() names GPU 0 {uuids[0]}, not the card "
                     f"{device['uuid']}")
            runtime.delete_slice(shard)
            if shard in runtime.list_devices().ids():
                fail("the deleted block shard is still listed")
            second = runtime.create_slices(0, [BLOCK_PROFILE])
            if not any(modes):
                doomed = runtime.delete_all_except(set())
                if doomed != second:
                    fail(f"delete_all_except deleted {doomed}, not the "
                         f"shard {second}")
                out["cleanup_deleted"] = len(doomed)
            else:
                runtime.delete_slice(second[0])
            out["shard"] = {"profile": BLOCK_PROFILE, "gpu": 0,
                            "gpu_uuid": uuids[0]}
        after = sorted(runtime.list_devices().ids())
        if after != before:
            fail(f"the card's devices changed: {before} -> {after}")
    finally:
        runtime.close()
    if proxy.refused:
        fail(f"NvmlGpuRuntime called {proxy.refused} on the card")
    return out | {"create_destroy_calls": len(proxy.refused),
                  "nvml_reads": proxy.reads}


def _mig_header() -> dict:
    """Part (f): the ctypes structs and NVML constants against the
    toolkit's nvml.h (``nvml.header_layout``)."""
    from nos_tpu_torch.device import nvml

    t0 = time.perf_counter()
    try:
        text = nvml.header_layout()
    except RuntimeError as e:
        fail(str(e))
    bad = nvml.layout_mismatches(text)
    if bad:
        fail(f"the NVML bindings disagree with nvml.h: {bad}")
    return {"structs": sorted(nvml.STRUCTS),
            "constants": len(nvml.header_constants()),
            "seconds": time.perf_counter() - t0}


MIG_AGENT_LIMIT_S = 60.0     # the MIG agent main's start to /healthz


def _mig_agent_main(device: dict, modes: list[str]) -> dict:
    """Part (g): the MIG agent's main on NVML for the card's node on the
    in-memory API, as a process: /healthz 200, a startup cleanup that
    deletes nothing, exit 0 on SIGTERM.  Skipped where a GPU is in MIG
    mode: its startup cleanup would destroy instances it does not
    own."""
    import urllib.request

    if any(m != "disabled" for m in modes):
        return {"skipped": "MIG mode on", "mig_modes": modes}
    with tempfile.TemporaryDirectory(prefix="nos-migagent-") as tmp:
        addr = f"127.0.0.1:{_free_port()}"
        cfg = pathlib.Path(tmp) / "sliceagent.json"
        cfg.write_text(json.dumps({"health_probe_addr": addr,
                                   "model": device["model"]}))
        log_path = pathlib.Path(tmp) / "sliceagent.log"
        with open(log_path, "w") as log:
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "nos_tpu_torch.cmd.sliceagent",
                 "--device", "cuda", "--node", CARD_NODE, "--config",
                 str(cfg)], cwd=ROOT, env=_child_env(),
                stdout=subprocess.DEVNULL, stderr=log)
        try:
            healthy = None
            while healthy is None:
                if proc.poll() is not None:
                    fail(f"the MIG agent main exited {proc.returncode} at "
                         f"start:\n{log_path.read_text()[-4000:]}")
                if time.perf_counter() - t0 > MIG_AGENT_LIMIT_S:
                    fail(f"the MIG agent main gave no /healthz within "
                         f"{MIG_AGENT_LIMIT_S} s")
                try:
                    with urllib.request.urlopen(f"http://{addr}/healthz",
                                                timeout=5) as r:
                        if r.status == 200:
                            healthy = time.perf_counter() - t0
                except OSError:
                    time.sleep(0.05)
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=MAINS_EXIT_LIMIT_S)
            except subprocess.TimeoutExpired:
                fail(f"the MIG agent main did not exit within "
                     f"{MAINS_EXIT_LIMIT_S} s of SIGTERM")
            exit_s = time.perf_counter() - t1
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log = log_path.read_text()
    if rc != 0:
        fail(f"the MIG agent main exited {rc} on SIGTERM:\n{log[-4000:]}")
    cleanup = re.search(r"startup cleanup deleted (\d+) devices", log)
    if cleanup is None or cleanup.group(1) != "0":
        fail(f"the MIG agent main's startup cleanup: "
             f"{cleanup.group(0) if cleanup else 'not logged'}")
    return {"node": CARD_NODE, "healthz_s": healthy, "exit_s": exit_s,
            "rc": rc, "cleanup_deleted": 0}


def phase_mig(device: dict, smi: str) -> dict:
    """The MIG strategy and node side: (a) the MIG fleet plan, (b) the
    reporter over the card's NVML, (c) one node through the MIG loop on
    the fake runtime, whose writes must equal MIG_LOOP_WRITES (the CPU
    test's run), (d) the same loop on NVML over the fake library, (e)
    the NVML runtime on the card with no create or destroy reaching it,
    (f) the bindings against nvml.h, (g) the MIG agent's main on the
    card."""
    t0 = time.perf_counter()
    fleet_line = _mig_fleet_plans()
    reporter = _mig_reporter_on_card(device)
    loop, writes = _mig_loop()
    if writes != MIG_LOOP_WRITES:
        fail(f"the MIG loop's writes differ from the CPU test's: "
             f"{json.dumps(writes)}")
    t1 = time.perf_counter()
    nvml_loop = _mig_loop_on_nvml()
    card = _mig_nvml_on_card(device)
    header = _mig_header()
    agent = _mig_agent_main(device, card["mig_modes"])
    line = {"phase": "mig", "nvidia_smi": smi,
            "seconds": time.perf_counter() - t0,
            "seconds_d_to_g": time.perf_counter() - t1, "fleet": fleet_line,
            "reporter": reporter, "loop": loop, "nvml_loop": nvml_loop,
            "nvml_card": card, "nvml_header": header, "agent_main": agent}
    emit(line)
    return line


# The quota phase.  (a) Host only: testing/fleet.py's quota fleet (32
# nodes x 8 H100 80GB, four quotas, two waves of single pods), run
# QUOTA_FLEET_RUNS times to QUOTA_FLEET_DIGEST (the JAX package's run
# of the same fleet on the CPU, tests/test_torch_scheduler.py).  (b)
# The card's node in the MPS loop with the scheduler, both reconcilers
# and the quota webhooks: team-a borrows team-b's unused min with three
# pods, whose children train under their grants; team-b's pod then
# preempts QUOTA_VICTIM (JAX's choice for the same objects) and binds
# on its share with no new plan, and its child trains after the
# victim's is stopped.
QUOTA_FLEET_DIGEST = \
    "6306bdbc486e698a37e0cb74b6b5abdf498b959bd50a2d2c38a12dda3ffa23c1"
# fleet.waste_summary of its waste ledger's report, the JAX package's
# ledger on the same run (tests/test_torch_scheduler.py)
QUOTA_FLEET_WASTE_DIGEST = \
    "b7acc984dc355fcfb0ee6590f9bb632affa117d034dba4896d3000c10d096a7d"
QUOTA_FLEET_RUNS = 5
# (namespace, min GB, max GB; 0 = none), each quota in its namespace
QUOTA_CARD_QUOTAS = (("team-a", 40.0, 80.0), ("team-b", 40.0, 0.0))
QUOTA_TEAM_A = ("team-a-0", "team-a-1", "team-a-2")
QUOTA_PREEMPTOR = "team-b-0"
QUOTA_VICTIM = "team-a-2"
QUOTA_LABELS = {"team-a-0": "in-quota", "team-a-1": "over-quota",
                "team-a-2": "over-quota"}
# the evicted pod's child must exit by its signal within this
QUOTA_STOP_LIMIT_S = 30.0
# team-a's two survivors train this many steps, through the preemption,
# and must pass as grant (a) does; the victim is asked for more steps
# than it can reach before it is stopped.  Each must log a step before
# team-b's pod is created.
QUOTA_SURVIVOR_STEPS = 40
QUOTA_VICTIM_STEPS = 100_000
QUOTA_FIRST_STEP_LIMIT_S = 300.0
# What the card loop writes (_Recorder), as its CPU test's run recorded
# it (tests/test_torch_scheduler.py, held against the JAX package's
# loop on the same objects).
QUOTA_LOOP_WRITES = {
    "h100-node-0": [
        [],
        [
            "spec-partitioning-plan.mps=<plan 0>"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=3"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-24gb-free=3",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=3"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-24gb-used=3",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=3"
        ]
    ],
    "team-a": [
        "used=0",
        "used=24",
        "used=48",
        "used=72",
        "used=48"
    ],
    "team-b": [
        "used=0",
        "used=24"
    ],
    "team-a-0": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-node-0 Pending",
        "h100-node-0 Running",
        "h100-node-0 Running in-quota"
    ],
    "team-a-1": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-node-0 Pending",
        "h100-node-0 Running",
        "h100-node-0 Running over-quota"
    ],
    "team-a-2": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-node-0 Pending",
        "h100-node-0 Running",
        "h100-node-0 Running over-quota",
        "deleted"
    ],
    "team-b-0": [
        "- Pending",
        "h100-node-0 Pending",
        "h100-node-0 Running",
        "h100-node-0 Running in-quota"
    ]
}


def _quota_fleet_runs(runs: int = QUOTA_FLEET_RUNS) -> dict:
    """The quota fleet ``runs`` times, each from nothing: every run's
    summary must hash to QUOTA_FLEET_DIGEST and its waste waterfall
    (which conserves, or the run raises) to QUOTA_FLEET_WASTE_DIGEST,
    every victim must carry the over-quota label when chosen, no quota
    may hold more than its max, and each quota's status.used must be the
    GB its Running pods hold."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.testing import fleet

    spec = fleet.quota_fleet_spec(0)
    outs = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fleet.run_quota_fleet(spec)
        out["run_ms"] = (time.perf_counter() - t0) * 1e3
        outs.append(out)
    for out in outs:
        digest = fleet.plan_digest(out["summary"])
        if digest != QUOTA_FLEET_DIGEST:
            fail(f"the quota fleet's digest {digest} is not the pinned "
                 f"{QUOTA_FLEET_DIGEST} (the JAX package's run on the CPU)")
        _check_waste_digest(out["waste"], QUOTA_FLEET_WASTE_DIGEST,
                            "the quota fleet")
        if out["victims_in_quota"] or not out["victims_over_quota"]:
            fail(f"the quota fleet preempted {out['victims_in_quota']} "
                 f"pods not labelled over-quota")
        used = {q: v.get(C.RESOURCE_GPU_MEMORY, 0.0)
                for q, v in out["summary"]["used"].items()}
        if used != out["held_gb"] or any(
                out["held_gb"][q] > m for q, m in out["max_gb"].items()):
            fail(f"quota status.used {used}, held {out['held_gb']}, max "
                 f"{out['max_gb']}")
    cycle_ms = [ms for o in outs for ms in o["cycle_ms"]]
    reconcile_ms = [ms for o in outs for ms in o["reconcile_ms"]]
    first = outs[0]
    return {"nodes": len(spec["nodes"]), "gpus": sum(
                n["gpus"] for n in spec["nodes"]),
            "quotas": {q["name"]: [q["min"], q["max"]]
                       for q in spec["quotas"]},
            "pods": [len(w) for w in spec["waves"]],
            "cut": "bench_utilization.py's gang jobs (single pods only)",
            "runs": runs, "cycles_per_run": len(first["summary"]["cycles"]),
            "cycle_ms_median": statistics.median(cycle_ms),
            "cycle_ms_max": max(cycle_ms),
            "reconcile_ms_median": statistics.median(reconcile_ms),
            "reconcile_ms_max": max(reconcile_ms),
            "run_ms": [o["run_ms"] for o in outs],
            "binds": first["binds"], "preemptions": first["preemptions"],
            "victims_by_label": {"over-quota": first["victims_over_quota"],
                                 "other": first["victims_in_quota"]},
            "pending_left": len(first["summary"]["pending"]),
            "used_gb": first["held_gb"],
            "digest": fleet.plan_digest(first["summary"]),
            "waste": _waste_line(first["waste"])}


def _check_waste_digest(report: dict, want: str, what: str) -> None:
    """Fail unless ``report`` conserves GPU-seconds (within 1e-6) and its
    ``fleet.waste_summary`` hashes to ``want``."""
    from nos_tpu_torch.testing import fleet

    _check_conserves(report, what)
    digest = fleet.plan_digest(fleet.waste_summary(report))
    if digest != want:
        fail(f"{what}: the waste digest {digest} is not the pinned {want} "
             f"(the JAX package's ledger on the CPU)")


class _QuotaLoop(_CardLoop):
    """``_CardLoop`` with the quotas: the webhooks installed, both
    reconcilers bound to their watches as the operator binds them (with
    ``resync``, run once a loop pass after the scheduler's cycle
    instead, the operator's resync: over REST a watch's timing would
    decide which states they write), the ElasticQuotas ``quotas``
    (team-a's and team-b's), and a ``_Recorder`` of the node, the pods,
    the quotas and the PodGroups (QUOTA_LOOP_WRITES, GANG_LOOP_WRITES
    and ELASTIC_LOOP_WRITES pin it)."""

    def __init__(self, device: dict, clock=time.monotonic,
                 wall=time.time, quotas=QUOTA_CARD_QUOTAS, api=None,
                 watch=None, resync: bool = False,
                 **controller_kw) -> None:
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.api.elasticquota import (
            ElasticQuota, ElasticQuotaSpec, install_quota_webhooks)
        from nos_tpu_torch.controllers.elasticquota import (
            CompositeElasticQuotaReconciler, ElasticQuotaReconciler)
        from nos_tpu_torch.kube.client import (
            KIND_ELASTIC_QUOTA, KIND_NODE, KIND_POD, KIND_POD_GROUP)
        from nos_tpu_torch.kube.objects import ObjectMeta

        super().__init__(device, clock, wall, api, watch, **controller_kw)
        install_quota_webhooks(self.api)
        self.reconcilers = (ElasticQuotaReconciler(self.api),
                            CompositeElasticQuotaReconciler(self.api))
        self.resync = resync
        if not resync:
            for r in self.reconcilers:
                r.bind()
        self.recorder = _Recorder(C.MPS_KIND)
        self.writes = self.recorder.writes
        for kind in (KIND_NODE, KIND_POD, KIND_ELASTIC_QUOTA,
                     KIND_POD_GROUP):
            self.watch(kind, self.recorder)
        mem = C.RESOURCE_GPU_MEMORY
        for ns, lo, hi in quotas:
            self.api.create(KIND_ELASTIC_QUOTA, ElasticQuota(
                metadata=ObjectMeta(name=ns, namespace=ns),
                spec=ElasticQuotaSpec(min={mem: lo},
                                      max={mem: hi} if hi else {})))

    def bind(self) -> int:
        bound = super().bind()
        if self.resync:
            for r in self.reconcilers:
                r.reconcile_all()
        return bound

    def labels(self) -> dict:
        from nos_tpu_torch.api import constants as C

        return {n: p.metadata.labels.get(C.LABEL_CAPACITY)
                for n, p in self.pods().items()}


def _quota_loop(device: dict, clock=time.monotonic, wall=time.time,
                advance=None, poll_s: float = CARD_POLL_S
                ) -> tuple[_QuotaLoop, dict]:
    """Phase (b) up to the children: team-a's three pods through the
    loop until they are bound and Running in one plan cycle, and the
    reconciler's labels on them (one in-quota, two borrowing over-quota).
    ``clock``, ``wall`` and ``advance`` let a test drive it on an
    injected clock."""
    from nos_tpu_torch.kube.client import KIND_ELASTIC_QUOTA

    loop = _QuotaLoop(device, clock, wall)
    run = functools.partial(loop.run_until, poll_s=poll_s, advance=advance)
    plans0 = _plans_total()
    for name in QUOTA_TEAM_A:
        loop.create_pod(name, namespace="team-a")
    bind_s = run(lambda: loop.running() == list(QUOTA_TEAM_A),
                 "bind team-a's pods and run them")
    if loop.cycles != 1 or _plans_total() - plans0 != 1:
        fail(f"{loop.cycles} plan cycles ran for team-a, not one")
    labels = loop.labels()
    if labels != QUOTA_LABELS:
        fail(f"team-a's pods are labelled {labels}, not {QUOTA_LABELS}")
    used = loop.api.get(KIND_ELASTIC_QUOTA, "team-a",
                        "team-a").status.used
    return loop, {"bind_s": bind_s, "labels": labels, "team_a_used": used}


def _quota_preempt(loop: _QuotaLoop, advance=None,
                   poll_s: float = CARD_POLL_S) -> dict:
    """Phase (b)'s preemption: team-b's pod is created; the next
    scheduler cycle must evict QUOTA_VICTIM alone and bind team-b's pod
    on its share, with no new plan.  Returns the eviction's and the
    rebind's times on the host's performance counter."""
    from nos_tpu_torch.kube.client import KIND_POD

    seen: dict[str, float] = {}

    def watch(event: str, pod) -> None:
        if event == "DELETED":
            seen.setdefault(f"deleted {pod.metadata.name}",
                            time.perf_counter())
        elif pod.spec.node_name:
            seen.setdefault(f"bound {pod.metadata.name}",
                            time.perf_counter())

    unwatch = loop.api.watch(KIND_POD, watch)
    written, cycles, plans = loop.written(), loop.cycles, _plans_total()
    before = set(loop.pods())
    loop.create_pod(QUOTA_PREEMPTOR, namespace="team-b")
    if advance is not None:
        advance()
    loop.step()
    unwatch()
    gone = sorted(before - set(loop.pods()))
    if gone != [QUOTA_VICTIM]:
        fail(f"team-b's pod evicted {gone}, not {QUOTA_VICTIM} (the "
             f"JAX package's choice)")
    pod = loop.pods()[QUOTA_PREEMPTOR]
    if pod.spec.node_name != CARD_NODE:
        fail(f"team-b's pod is on {pod.spec.node_name!r} after the "
             f"preemption")
    loop.run_until(lambda: QUOTA_PREEMPTOR in loop.running(),
                   "run team-b's pod", poll_s=poll_s, advance=advance)
    if loop.written() != written or loop.cycles != cycles \
            or _plans_total() != plans:
        fail("binding team-b's pod took a new plan")
    share = f"{CARD_SHARE_GB}gb"
    if loop.status(0, share, "used") != "3":
        fail(f"the reporter shows GPU 0 {share}-used "
             f"{loop.status(0, share, 'used')!r} after the rebind")
    return {"evicted": gone, "evicted_at": seen[f"deleted {QUOTA_VICTIM}"],
            "rebound_at": seen[f"bound {QUOTA_PREEMPTOR}"],
            "labels_after": loop.labels()}


def _stop_children(children: list[dict]) -> list[float]:
    """The kubelet's part for evicted pods: SIGTERM every child at once;
    the seconds until each exited (polled every 10 ms).  Fails past
    QUOTA_STOP_LIMIT_S, killing them then, or when one exited by
    anything but the signal."""
    t0 = time.perf_counter()
    for child in children:
        child["proc"].send_signal(signal.SIGTERM)
    exited: dict[int, float] = {}
    while len(exited) < len(children):
        for i, child in enumerate(children):
            if i not in exited and child["proc"].poll() is not None:
                exited[i] = time.perf_counter() - t0
        if time.perf_counter() - t0 > QUOTA_STOP_LIMIT_S:
            for child in children:
                child["proc"].kill()
                child["proc"].wait()
            fail(f"{[c['case'] for c in children]}: a child did not stop "
                 f"within {QUOTA_STOP_LIMIT_S} s of SIGTERM")
        time.sleep(0.01)
    for child in children:
        if child["proc"].returncode != -signal.SIGTERM:
            fail(f"{child['case']}'s child exited "
                 f"{child['proc'].returncode}, not by SIGTERM")
    return [exited[i] for i in range(len(children))]


def _check_stopped_child(label: str, child: dict, uuid: str,
                         main_loss0: float) -> None:
    """A child stopped by SIGTERM mid-run: exited by the signal, its
    grant verified on ``uuid`` at the child's fraction and cap when it
    started (the main's confinement line), and finite steps from step 1
    at train_main's step-0 loss."""
    r = child["confined"]
    if child["rc"] != -signal.SIGTERM or r is None:
        fail(f"{label} exited {child['rc']}, confinement report {r}:\n"
             f"{child['stderr'][-4000:]}")
    if not (r["verified"] and r["devices"] == [uuid]
            and r["fraction"] == child["fraction"]
            and r["cap_bytes"] == child["cap_bytes"]):
        fail(f"{label} verified {r}, expected {uuid} at fraction "
             f"{child['fraction']}")
    steps = child["steps"]
    if not steps or steps[0][0] != 1 \
            or not all(math.isfinite(s[1]) for s in steps):
        fail(f"{label} logged steps {steps[:4]}:\n"
             f"{child['stderr'][-4000:]}")
    rel = abs(steps[0][1] - main_loss0) / abs(main_loss0)
    if not rel <= MAIN_LOSS0_RTOL:
        fail(f"{label}'s step-0 loss {steps[0][1]} against train_main's "
             f"{main_loss0}")
    child["loss0_rel_diff"] = rel


def phase_quota(main_loss0: float, device: dict, smi: str) -> dict:
    """Elastic quotas: (a) the quota fleet on the host; (b) the card's
    node: team-a borrows, its three children train under their grants,
    team-b's pod preempts the over-quota victim JAX chooses, the victim's
    child is stopped by SIGTERM, team-b's pod binds on its share with no
    new plan and its child trains GRANT_STEPS steps under its grant; the
    two survivors end their QUOTA_SURVIVOR_STEPS steps under theirs."""
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    fleet_line, _ = _host_result("quota", "_quota_fleet_runs")
    loop, card = _quota_loop(device)
    grants = _grants(loop, device, list(QUOTA_TEAM_A))
    total = device["memory_bytes"]
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    with tempfile.TemporaryDirectory(prefix="nos-quota-") as tmp:
        cfg_path, no_nvcc = _grant_workdir(tmp)
        cfgs = {}
        for case, n in (("survivor", QUOTA_SURVIVOR_STEPS),
                        ("victim", QUOTA_VICTIM_STEPS)):
            cfgs[case] = str(pathlib.Path(tmp) / f"{case}.json")
            pathlib.Path(cfgs[case]).write_text(json.dumps(
                json.loads(pathlib.Path(cfg_path).read_text())
                | {"steps": n}))
        team_a = {g["pod"]: _start_grant_child(
                      g["pod"], cfgs["victim" if g["pod"] == QUOTA_VICTIM
                                     else "survivor"], g["env"], no_nvcc)
                  for g in grants}
        try:
            t1 = time.monotonic()
            while not all(_STEP_LINE.search("".join(c["lines"]))
                          for c in team_a.values()):
                if time.monotonic() - t1 > QUOTA_FIRST_STEP_LIMIT_S or any(
                        c["proc"].poll() is not None
                        for c in team_a.values()):
                    fail("a team-a child exited or logged no step within "
                         f"{QUOTA_FIRST_STEP_LIMIT_S} s")
                time.sleep(0.1)
            preempt = _quota_preempt(loop)
            ended = [n for n, c in team_a.items()
                     if c["proc"].poll() is not None]
            if ended:
                fail(f"team-a children {ended} ended before the "
                     f"preemption")
            (stop_s,) = _stop_children([team_a[QUOTA_VICTIM]])
            stopped_at = time.perf_counter()
            victim = _finish_grant_child(team_a.pop(QUOTA_VICTIM))
            (grant_b,) = _grants(loop, device, [QUOTA_PREEMPTOR])
            child_b = _run_grant_child(QUOTA_PREEMPTOR, cfg_path,
                                       grant_b["env"], no_nvcc)
            survivors = [_finish_grant_child(c) for c in team_a.values()]
        finally:
            for c in team_a.values():
                if c.get("proc") is not None and c["proc"].poll() is None:
                    c["proc"].kill()
                    c["proc"].wait()
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"a quota child built kernels: {kernels_before} -> "
             f"{kernels_after}")
    for child in (*survivors, victim, child_b):
        child["fraction"], child["cap_bytes"] = _grant_cap(
            int(child["grant"]["NOS_TPU_TIMESHARE_GB"]), total)
    reports = [_check_granted_child(
                   f"quota {c['case']}", c,
                   c["grant"]["NOS_TPU_VISIBLE_CHIPS"], main_loss0,
                   QUOTA_SURVIVOR_STEPS) for c in survivors]
    _check_stopped_child(f"quota {QUOTA_VICTIM}", victim,
                         victim["grant"]["NOS_TPU_VISIBLE_CHIPS"],
                         main_loss0)
    report = _check_granted_child(f"quota {QUOTA_PREEMPTOR}", child_b,
                                  child_b["grant"]["NOS_TPU_VISIBLE_CHIPS"],
                                  main_loss0)
    if loop.writes != QUOTA_LOOP_WRITES:
        fail(f"the quota loop's writes differ from the CPU test's: "
             f"{json.dumps(loop.writes)}")
    card |= {
        "node": CARD_NODE, "quotas": [list(q) for q in QUOTA_CARD_QUOTAS],
        "share_gb": CARD_SHARE_GB, "evicted": preempt["evicted"],
        "labels_after": preempt["labels_after"],
        "evict_to_rebind_ms": (preempt["rebound_at"]
                               - preempt["evicted_at"]) * 1e3,
        "evict_to_child_stopped_ms": (stopped_at
                                      - preempt["evicted_at"]) * 1e3,
        "sigterm_to_exit_s": stop_s, "victim_rc": victim["rc"],
        "victim_steps": len(victim["steps"]),
        "cycle_ms_median": statistics.median(loop.cycle_ms),
        "cycle_ms_max": max(loop.cycle_ms), "cycles": len(loop.cycle_ms),
        "bind_ms": dict(sorted(loop.bound_ms.items()))}
    launches = {k: sum(r["launches"][k] for r in (*reports, report))
                for k in report["launches"]}
    emit({"phase": "quota", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0, "fleet": fleet_line,
          "card": card, "main_loss0": main_loss0,
          "loss0_rtol": MAIN_LOSS0_RTOL, "launches": launches,
          "children": [{k: v for k, v in ch.items()
                        if k not in ("stderr", "report", "confined",
                                     "stamps", "steps")}
                       | {"steps_logged": len(ch["steps"])}
                       | ({"launches": ch["report"]["launches"]}
                          if ch.get("report") else {})
                       for ch in (*survivors, victim, child_b)]})
    return launches


# The gang phase.  (a) testing/fleet.py's gang fleet (the quota fleet's
# 32 x 8 H100 80GB in NVLink domains nvl-0 (nodes 0-15), nvl-1 (16-27)
# and unlabelled (28-31), and a third wave of bench_utilization.py's
# gang jobs) run GANG_FLEET_RUNS times to GANG_FLEET_DIGEST (the JAX
# package's run on the CPU, tests/test_torch_gang.py).  (b) The card's
# node in the MPS loop with quotas: team-a's two-member gang GANG_A
# waits for its second member, then binds whole in one cycle and its
# two children train at once; team-b's gang GANG_B (within its min)
# evicts GANG_A whole, as the JAX package does on the same objects, and
# binds on a later cycle, and its two children train after GANG_A's are
# stopped.
GANG_FLEET_DIGEST = \
    "a30a101fd2f5bf0224e32466d1df92ecd506e0d1153f2999947b12d244b13d46"
# fleet.waste_summary of its waste ledger's report (the JAX package's,
# tests/test_torch_gang.py)
GANG_FLEET_WASTE_DIGEST = \
    "a7b35ac79215a5213b3d03395bf64695866211700b8dda230c6482f183e6e579"
GANG_FLEET_RUNS = 5
# (namespace, min GB, max GB; 0 = none), each quota in its namespace
GANG_CARD_QUOTAS = (("team-a", 24.0, 80.0), ("team-b", 48.0, 0.0))
# (namespace, PodGroup, members), each member one CARD_SHARE_GB share
GANG_A = ("team-a", "ga", ("ga-0", "ga-1"))
GANG_B = ("team-b", "gb", ("gb-0", "gb-1"))
GANG_WAITING = "pod group waiting for members (1/2)"
# scheduler cycles GANG_A's first member waits alone, inside the
# controller's batch window: the MPS planner takes each pending pod's
# lack alone (the reference's tracker), so a share carved for the first
# member would leave the pair lacking nothing while it cannot bind
# (ROADMAP, watch list)
GANG_WAIT_CYCLES = 3
# What the gang loop writes (_Recorder), as its CPU test's run recorded
# it (tests/test_torch_scheduler.py, held against the JAX package's
# loop on the same objects).
GANG_LOOP_WRITES = {
    "h100-node-0": [
        [],
        [
            "spec-partitioning-plan.mps=<plan 0>"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=2"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-24gb-free=2",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=2"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-24gb-used=2",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=2"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-24gb-free=2",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=2"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-24gb-used=2",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=2"
        ]
    ],
    "team-a": [
        "used=0",
        "used=24",
        "used=48",
        "used=24",
        "used=0"
    ],
    "team-b": [
        "used=0",
        "used=24",
        "used=48"
    ],
    "ga": [
        "Pending 0",
        "Scheduled 2",
        "Pending 0"
    ],
    "ga-0": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-node-0 Pending",
        "h100-node-0 Running",
        "h100-node-0 Running in-quota",
        "deleted"
    ],
    "ga-1": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-node-0 Pending",
        "h100-node-0 Running",
        "h100-node-0 Running over-quota",
        "h100-node-0 Running in-quota",
        "deleted"
    ],
    "gb": [
        "Pending 0",
        "Scheduled 2"
    ],
    "gb-0": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-node-0 Pending",
        "h100-node-0 Running",
        "h100-node-0 Running in-quota"
    ],
    "gb-1": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-node-0 Pending",
        "h100-node-0 Running",
        "h100-node-0 Running in-quota"
    ]
}


def _gang_fleet_runs(runs: int = GANG_FLEET_RUNS) -> dict:
    """The gang fleet ``runs`` times, each from nothing: every run's
    summary must hash to GANG_FLEET_DIGEST and its waste waterfall to
    GANG_FLEET_WASTE_DIGEST; at no cycle's end may a gang
    be bound in part or over two domains; the mesh gang must have been
    bound in nvl-0 alone (nvl-1 is smaller than its mesh), the waiting
    gang never; every victim must have been over quota, or of the
    preemptor's namespace with its quota over min, when chosen; no
    quota may hold more than its max, and each quota's status.used must
    be the GB its Running pods hold."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.testing import fleet

    spec = fleet.gang_fleet_spec(0)
    outs = []
    for _ in range(runs):
        t0 = time.perf_counter()
        out = fleet.run_quota_fleet(spec)
        out["run_ms"] = (time.perf_counter() - t0) * 1e3
        outs.append(out)
    for out in outs:
        digest = fleet.plan_digest(out["summary"])
        if digest != GANG_FLEET_DIGEST:
            fail(f"the gang fleet's digest {digest} is not the pinned "
                 f"{GANG_FLEET_DIGEST} (the JAX package's run on the CPU)")
        _check_waste_digest(out["waste"], GANG_FLEET_WASTE_DIGEST,
                            "the gang fleet")
        if out["partial"] or out["spanning"]:
            fail(f"gangs bound in part {out['partial']} or over two "
                 f"domains {out['spanning']} at a cycle's end")
        if out["domains"].get("train-a-mesh") != ["nvl-0"]:
            fail(f"the mesh gang was bound in "
                 f"{out['domains'].get('train-a-mesh')}, not nvl-0 alone")
        if "train-b-wait" in out["domains"]:
            fail("the gang waiting for a member was bound")
        if out["victims_other"]:
            fail(f"the gang fleet preempted {out['victims_other']} pods "
                 f"neither over quota nor of the preemptor's namespace "
                 f"over its min")
        used = {q: v.get(C.RESOURCE_GPU_MEMORY, 0.0)
                for q, v in out["summary"]["used"].items()}
        if used != out["held_gb"] or any(
                out["held_gb"][q] > m for q, m in out["max_gb"].items()):
            fail(f"quota status.used {used}, held {out['held_gb']}, max "
                 f"{out['max_gb']}")
    cycle_ms = [ms for o in outs for ms in o["cycle_ms"]]
    admitted_ms = [ms for o in outs for ms, ok in o["gang_ms"] if ok]
    rejected_ms = [ms for o in outs for ms, ok in o["gang_ms"] if not ok]
    first = outs[0]
    summary = first["summary"]
    return {"nodes": len(spec["nodes"]),
            "domains": {d: sum(n["domain"] == d for n in spec["nodes"])
                        for d in ("nvl-0", "nvl-1", "")},
            "pods": [len(w) for w in spec["waves"]],
            "gangs": len(spec["groups"]), "runs": runs,
            "cycles_per_run": len(summary["cycles"]),
            "cycle_ms_median": statistics.median(cycle_ms),
            "cycle_ms_max": max(cycle_ms),
            "gang_admitted_ms_median": statistics.median(admitted_ms),
            "gang_rejected_ms_median": statistics.median(rejected_ms),
            "run_ms": [o["run_ms"] for o in outs],
            "gangs_admitted": first["gangs_admitted"],
            "gangs_rejected": first["gangs_rejected"],
            "gang_preemptions": first["gang_preemptions"],
            "victims_by_label": {
                "over-quota": first["victims_over_quota"],
                "own-namespace-over-min": first["victims_same_ns_over_min"],
                "other": first["victims_other"]},
            "gang_victims": first["gang_victims"],
            "gang_domains": first["domains"],
            "groups": summary["groups"],
            "pending_left": len(summary["pending"]),
            "used_gb": first["held_gb"],
            "digest": fleet.plan_digest(summary),
            "waste": _waste_line(first["waste"])}


def _gang_bound_cycles(loop: _QuotaLoop) -> tuple[dict, Callable]:
    """A pod watch noting, per pod, the scheduler cycle that bound it
    (its index in ``loop.cycle_ms``) and its deletion, each with the
    host's performance counter; returns the notes and the unwatch."""
    from nos_tpu_torch.kube.client import KIND_POD

    seen: dict[str, tuple[int, float]] = {}

    def watch(event: str, pod) -> None:
        name = pod.metadata.name
        if event == "DELETED":
            seen.setdefault(f"deleted {name}",
                            (len(loop.cycle_ms), time.perf_counter()))
        elif pod.spec.node_name:
            seen.setdefault(f"bound {name}",
                            (len(loop.cycle_ms), time.perf_counter()))

    return seen, loop.api.watch(KIND_POD, watch)


def _gang_loop(device: dict, clock=time.monotonic, wall=time.time,
               advance=None, poll_s: float = CARD_POLL_S
               ) -> tuple[_QuotaLoop, dict]:
    """Phase (b) up to the children: GANG_A's PodGroup (min_member 2) and
    its first member through GANG_WAIT_CYCLES scheduler cycles, each
    leaving it unbound and marked GANG_WAITING; then the second member,
    through the loop until both are bound (in one scheduler cycle, after
    one plan) and Running.  ``clock``, ``wall`` and ``advance`` let a
    test drive it on an injected clock."""
    from nos_tpu_torch.kube.client import KIND_POD_GROUP
    from nos_tpu_torch.testing.factory import make_pod_group

    loop = _QuotaLoop(device, clock, wall, quotas=GANG_CARD_QUOTAS)
    run = functools.partial(loop.run_until, poll_s=poll_s, advance=advance)
    ns, group, (first, second) = GANG_A
    seen, unwatch = _gang_bound_cycles(loop)
    loop.api.create(KIND_POD_GROUP, make_pod_group(group, 2, namespace=ns))
    loop.create_pod(first, namespace=ns, gang=group)
    for _ in range(GANG_WAIT_CYCLES):
        if advance is not None:
            advance()
        if loop.bind():
            fail(f"a scheduler cycle bound {first} alone")
    pod = loop.pods()[first]
    conds = [c.message for c in pod.status.conditions]
    if pod.spec.node_name or conds != [GANG_WAITING]:
        fail(f"{first} alone is on {pod.spec.node_name!r} with "
             f"{conds}, not unbound and {GANG_WAITING!r}")
    plans0 = _plans_total()
    loop.create_pod(second, namespace=ns, gang=group)
    bind_s = run(lambda: loop.running() == [first, second],
                 f"bind {group} whole and run it")
    unwatch()
    if loop.cycles != 1 or _plans_total() - plans0 != 1:
        fail(f"{loop.cycles} plan cycles ran for {group}, not one")
    cycles = {seen[f"bound {n}"][0] for n in (first, second)}
    if len(cycles) != 1:
        fail(f"{group}'s members were bound in cycles {sorted(cycles)}, "
             f"not one")
    pg = loop.api.get(KIND_POD_GROUP, group, ns)
    if (pg.status.phase, pg.status.scheduled) != ("Scheduled", 2):
        fail(f"{group}'s PodGroup reads {pg.status}, not Scheduled 2")
    return loop, {"wait_cycles": GANG_WAIT_CYCLES, "bind_s": bind_s,
                  "bound_in_cycle": cycles.pop(),
                  "plan_cycles": loop.cycles, "labels": loop.labels()}


def _gang_preempt(loop: _QuotaLoop, advance=None,
                  poll_s: float = CARD_POLL_S) -> dict:
    """Phase (b)'s gang preemption: GANG_B's PodGroup and both members
    are created; the next scheduler cycle must evict GANG_A whole (the
    JAX package's choice) and bind none of GANG_B, whose PodGroup
    GANG_A's reset to Pending 0; GANG_B must then bind whole on a
    later cycle and run.  Returns the eviction's and the rebind's
    times on the host's performance counter."""
    from nos_tpu_torch.kube.client import KIND_POD_GROUP
    from nos_tpu_torch.testing.factory import make_pod_group

    a_ns, a_group, a_pods = GANG_A
    b_ns, b_group, b_pods = GANG_B
    seen, unwatch = _gang_bound_cycles(loop)
    before = set(loop.pods())
    loop.api.create(KIND_POD_GROUP, make_pod_group(b_group, 2,
                                                   namespace=b_ns))
    for name in b_pods:
        loop.create_pod(name, namespace=b_ns, gang=b_group)
    if advance is not None:
        advance()
    loop.step()
    gone = sorted(before - set(loop.pods()))
    if gone != sorted(a_pods):
        fail(f"{b_group} evicted {gone}, not {a_group} whole (the JAX "
             f"package's choice)")
    early = [n for n in b_pods if f"bound {n}" in seen]
    if early:
        fail(f"{early} of {b_group} bound in the cycle that evicted "
             f"{a_group}")
    pg = loop.api.get(KIND_POD_GROUP, a_group, a_ns)
    if (pg.status.phase, pg.status.scheduled) != ("Pending", 0):
        fail(f"{a_group}'s PodGroup reads {pg.status} after the eviction, "
             f"not Pending 0")
    loop.run_until(lambda: all(n in loop.running() for n in b_pods),
                   f"bind {b_group} and run it", poll_s=poll_s,
                   advance=advance)
    unwatch()
    evicted_at = max(seen[f"deleted {n}"][1] for n in a_pods)
    evict_cycle = max(seen[f"deleted {n}"][0] for n in a_pods)
    bound = [seen[f"bound {n}"] for n in b_pods]
    if len({c for c, _ in bound}) != 1 or bound[0][0] <= evict_cycle:
        fail(f"{b_group} bound in cycles {[c for c, _ in bound]}, not "
             f"whole on a cycle after {evict_cycle}")
    pg = loop.api.get(KIND_POD_GROUP, b_group, b_ns)
    if (pg.status.phase, pg.status.scheduled) != ("Scheduled", 2):
        fail(f"{b_group}'s PodGroup reads {pg.status}, not Scheduled 2")
    return {"evicted": gone, "evicted_at": evicted_at,
            "rebound_at": max(t for _, t in bound),
            "evict_cycle": evict_cycle, "rebind_cycle": bound[0][0],
            "labels_after": loop.labels()}


def phase_gang(main_loss0: float, device: dict, smi: str) -> dict:
    """Gangs: (a) the gang fleet on the host; (b) the card's node: GANG_A
    waits for its second member, binds whole in one cycle, and its two
    children train under their grants; GANG_B evicts it whole, both its
    children are stopped by SIGTERM, and GANG_B binds whole on a later
    cycle and its two children train GRANT_STEPS steps under theirs.
    Returns the launches of GANG_B's children, by kernel and by tile."""
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    fleet_line, _ = _host_result("gang", "_gang_fleet_runs")
    loop, card = _gang_loop(device)
    a_pods, b_pods = list(GANG_A[2]), list(GANG_B[2])
    grants = _grants(loop, device, a_pods)
    total = device["memory_bytes"]
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    with tempfile.TemporaryDirectory(prefix="nos-gang-") as tmp:
        cfg_path, no_nvcc = _grant_workdir(tmp)
        long_cfg = str(pathlib.Path(tmp) / "long.json")
        pathlib.Path(long_cfg).write_text(json.dumps(
            json.loads(pathlib.Path(cfg_path).read_text())
            | {"steps": QUOTA_VICTIM_STEPS}))
        team_a = {g["pod"]: _start_grant_child(g["pod"], long_cfg,
                                               g["env"], no_nvcc)
                  for g in grants}
        try:
            t1 = time.monotonic()
            while not all(_STEP_LINE.search("".join(c["lines"]))
                          for c in team_a.values()):
                if time.monotonic() - t1 > QUOTA_FIRST_STEP_LIMIT_S or any(
                        c["proc"].poll() is not None
                        for c in team_a.values()):
                    fail("a gang child exited or logged no step within "
                         f"{QUOTA_FIRST_STEP_LIMIT_S} s")
                time.sleep(0.1)
            preempt = _gang_preempt(loop)
            ended = [n for n, c in team_a.items()
                     if c["proc"].poll() is not None]
            if ended:
                fail(f"{GANG_A[1]}'s children {ended} ended before the "
                     f"eviction")
            stop_s = dict(zip(team_a, _stop_children(
                list(team_a.values()))))
            stopped_at = time.perf_counter()
            victims = [_finish_grant_child(team_a.pop(n)) for n in a_pods]
            grants_b = _grants(loop, device, b_pods)
            started = [_start_grant_child(g["pod"], cfg_path, g["env"],
                                          no_nvcc) for g in grants_b]
            children_b = [_finish_grant_child(c) for c in started]
        finally:
            for c in team_a.values():
                if c.get("proc") is not None and c["proc"].poll() is None:
                    c["proc"].kill()
                    c["proc"].wait()
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"a gang child built kernels: {kernels_before} -> "
             f"{kernels_after}")
    for child in (*victims, *children_b):
        child["fraction"], child["cap_bytes"] = _grant_cap(
            int(child["grant"]["NOS_TPU_TIMESHARE_GB"]), total)
    for victim in victims:
        _check_stopped_child(f"gang {victim['case']}", victim,
                             victim["grant"]["NOS_TPU_VISIBLE_CHIPS"],
                             main_loss0)
    reports = [_check_granted_child(f"gang {c['case']}", c,
                                    c["grant"]["NOS_TPU_VISIBLE_CHIPS"],
                                    main_loss0) for c in children_b]
    if loop.writes != GANG_LOOP_WRITES:
        fail(f"the gang loop's writes differ from the CPU test's: "
             f"{json.dumps(loop.writes)}")
    windows, overlap = _step_windows(children_b)
    card |= {
        "node": CARD_NODE, "quotas": [list(q) for q in GANG_CARD_QUOTAS],
        "share_gb": CARD_SHARE_GB, "gangs": [GANG_A[1], GANG_B[1]],
        "evicted": preempt["evicted"],
        "evict_cycle": preempt["evict_cycle"],
        "rebind_cycle": preempt["rebind_cycle"],
        "labels_after": preempt["labels_after"],
        "evict_to_rebind_ms": (preempt["rebound_at"]
                               - preempt["evicted_at"]) * 1e3,
        "evict_to_children_stopped_ms": (stopped_at
                                         - preempt["evicted_at"]) * 1e3,
        "sigterm_to_exit_s": stop_s,
        "victim_steps": {v["case"]: len(v["steps"]) for v in victims},
        "gb_step_windows_s": windows, "gb_overlap_s": overlap,
        "cycle_ms_median": statistics.median(loop.cycle_ms),
        "cycle_ms_max": max(loop.cycle_ms), "cycles": len(loop.cycle_ms),
        "bind_ms": dict(sorted(loop.bound_ms.items()))}
    launches = {k: sum(r["launches"].get(k, 0) for r in reports)
                for k in ("flash_fwd", "flash_bwd_fused", "flash_dq",
                          "flash_dkv")}
    tiles = {name: sum(r["tile_launches"].get(
                 f"{kernel}:{tile[0]}x{tile[1]}", 0) for r in reports)
             for name, (kernel, tile, _) in TILES.items()}
    emit({"phase": "gang", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0, "fleet": fleet_line,
          "card": card, "main_loss0": main_loss0,
          "loss0_rtol": MAIN_LOSS0_RTOL, "launches": launches,
          "tile_launches": tiles,
          "children": [{k: v for k, v in ch.items()
                        if k not in ("stderr", "report", "confined",
                                     "stamps", "steps")}
                       | {"steps_logged": len(ch["steps"])}
                       | ({"launches": ch["report"]["launches"]}
                          if ch.get("report") else {})
                       for ch in (*victims, *children_b)]})
    PATH_TILES["gang"] = tiles
    return launches


# The block phase, the gang phase's part (c): an NVLink block gang
# (ROADMAP item 7.2) over the card's node and three stub neighbours of
# one NVLink domain, every node a MIG node of one GPU whose agent runs
# on the fake runtime (the card is not in MIG mode; the fake
# records the block's shards).  Index 0 is the card's node; a long
# single holds index 1, so the window [0, 1] is the one to drain; the
# window [2, 3] holds a nearly done single on index 2.  The gang's two
# members ask for generic GPUs with a mesh, which the operator main's
# hook rewrites into one member of the block each.
BLOCK_DOMAIN = "nvl-block"
BLOCK_NODES = ("h100-block-0", "h100-block-1", "h100-block-2",
               "h100-block-3")
BLOCK_MESH = "2x1"
BLOCK_PROFILE = "2x1"
BLOCK_RESOURCE = "nos.nebuly.com/nvlink-block-2x1"
BLOCK_GANG = ("default", "blk", ("blk-0", "blk-1"))
# (pod, node index, job progress): the window's straggler, under the
# spare threshold, and the other window's nearly done single
BLOCK_STRAGGLER = ("straggler", 1, "0.1")
BLOCK_BUSY = ("busy", 2, "0.9")
# drain preemption on for the phase: two cycles under the lease, and the
# straggler's one GPU of the window's two is the final stretch
BLOCK_DRAIN_AFTER = 2
BLOCK_DRAIN_FRACTION = 0.5
BLOCK_BATCH_IDLE_S = 0.05
BLOCK_BATCH_TIMEOUT_S = 0.2
BLOCK_REPLAN_EPOCH_S = 0.05
BLOCK_LIMIT_S = 30.0
BLOCK_POLL_S = 0.01


class _BlockLoop:
    """The block phase's control plane on an in-memory API server: the
    operator main (quota webhooks and mesh normalization), the node and
    pod controllers, the MIG partitioner (the group pass in front), one
    MIG agent per node on the fake runtime, the card's with the card's
    UUID, and the scheduler with drain preemption on.  ``step`` is a
    scheduler cycle, a controller poll and every agent's tick.  ``clock``
    is the controller's and the scheduler's."""

    def __init__(self, device: dict, clock=time.monotonic) -> None:
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.api.config import OperatorConfig
        from nos_tpu_torch.cmd.assembly import build_scheduler
        from nos_tpu_torch.cmd.operator import build_operator_main
        from nos_tpu_torch.controllers.node_controller import NodeController
        from nos_tpu_torch.controllers.pod_controller import PodController
        from nos_tpu_torch.controllers.sliceagent.agent import SliceAgent
        from nos_tpu_torch.device.fake import (
            FakeGpuRuntime, FakePodResources,
        )
        from nos_tpu_torch.kube.client import APIServer, KIND_NODE, KIND_POD
        from nos_tpu_torch.obs.ledger import ChipSecondLedger, set_ledger
        from nos_tpu_torch.partitioning import slicepart as sp
        from nos_tpu_torch.partitioning.state import ClusterState
        from nos_tpu_torch.testing.factory import make_gpu_node
        from nos_tpu_torch.topology import DEFAULT_REGISTRY

        self.ledger = ChipSecondLedger(clock=clock)
        set_ledger(self.ledger)
        model = DEFAULT_REGISTRY.get(device["model"])
        self.api = APIServer()
        build_operator_main(self.api, OperatorConfig())
        state = ClusterState()
        NodeController(self.api, state,
                       sp.SliceNodeInitializer(self.api)).bind()
        PodController(self.api, state).bind()
        self.controller = sp.new_slice_partitioner_controller(
            self.api, state, batch_timeout_s=BLOCK_BATCH_TIMEOUT_S,
            batch_idle_s=BLOCK_BATCH_IDLE_S,
            replan_epoch_s=BLOCK_REPLAN_EPOCH_S, clock=clock)
        self.controller.bind()
        self.agents = {}
        for i, name in enumerate(BLOCK_NODES):
            self.api.create(KIND_NODE, make_gpu_node(
                name, model=model, gpus=1, partitioning=C.MIG_KIND,
                domain=BLOCK_DOMAIN, host_index=i))
            runtime = FakeGpuRuntime(model, 1, gpu_uuids=(
                [device["uuid"]] if i == 0 else None))
            agent = SliceAgent(self.api, name, runtime, FakePodResources())
            agent.start()
            self.agents[name] = agent
        self.sched = build_scheduler(
            self.api, clock=clock,
            drain_preempt_after_cycles=BLOCK_DRAIN_AFTER,
            drain_preempt_max_busy_fraction=BLOCK_DRAIN_FRACTION)
        self.cycle = 0
        self.cycle_ms: list[float] = []
        # per cycle: (cycle, the pods bound in it, the pods gone in it)
        self.events: list[tuple[int, list[str], list[str]]] = []
        self.leases: list[dict[str, str]] = []
        self._kind_pod = KIND_POD

    def pods(self) -> dict:
        return {p.metadata.name: p for p in self.api.list(self._kind_pod)}

    def lease(self) -> dict[str, str]:
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.kube.client import KIND_NODE

        return {n.metadata.name: n.metadata.annotations.get(
                    C.ANNOT_GANG_LEASE, "")
                for n in self.api.list(KIND_NODE)}

    def step(self) -> None:
        before = {n: p.spec.node_name for n, p in self.pods().items()}
        t0 = time.perf_counter()
        self.sched.run_cycle()
        self.cycle_ms.append((time.perf_counter() - t0) * 1e3)
        self.cycle += 1
        after = {n: p.spec.node_name for n, p in self.pods().items()}
        self.events.append((
            self.cycle,
            sorted(n for n, node in after.items()
                   if node and not before.get(n)),
            sorted(n for n in before if n not in after)))
        self.leases.append(self.lease())
        self.controller.process_if_ready()
        for agent in self.agents.values():
            agent.tick()

    def settle(self) -> None:
        """Controllers and agents only, until nothing moves: the
        virgin nodes initialized and carved."""
        for _ in range(4):
            self.controller.process_if_ready()
            for agent in self.agents.values():
                agent.tick()

    def run_until(self, done, what: str, advance=None,
                  poll_s: float = BLOCK_POLL_S) -> float:
        t0 = time.monotonic()
        while not done():
            if time.monotonic() - t0 > BLOCK_LIMIT_S:
                fail(f"the block loop did not {what} within "
                     f"{BLOCK_LIMIT_S} s")
            if advance is not None:
                advance()
            self.step()
            time.sleep(poll_s)
        return time.monotonic() - t0


def _block_loop(device: dict, clock=time.monotonic,
                advance=None) -> tuple[_BlockLoop, dict]:
    """The phase up to the child: the straggler and the busy single on
    their nodes, the gang normalized at create, the lease on the window
    [0, 1] from the first cycle, the straggler evicted by drain
    preemption after BLOCK_DRAIN_AFTER cycles under the lease, then one
    plan carving the block's shards and both members bound in one cycle
    and Running.  ``clock`` and ``advance`` let a test drive it on an
    injected clock."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.kube.client import KIND_POD, KIND_POD_GROUP
    from nos_tpu_torch.kube.resources import pod_request
    from nos_tpu_torch.testing.factory import make_pod, make_pod_group
    from nos_tpu_torch.topology.annotations import parse_spec_annotations

    loop = _BlockLoop(device, clock)
    loop.settle()
    for pod, index, progress in (BLOCK_STRAGGLER, BLOCK_BUSY):
        loop.api.create(KIND_POD, make_pod(
            name=pod, resources={"nvidia.com/mig-7g.80gb": 1, C.CPU: 1.0},
            node_name=BLOCK_NODES[index],
            annotations={C.ANNOT_JOB_PROGRESS: progress}))
    loop.settle()
    running = [n for n, p in loop.pods().items()
               if p.status.phase == "Running"]
    if sorted(running) != sorted((BLOCK_STRAGGLER[0], BLOCK_BUSY[0])):
        fail(f"the block fleet's singles run {running}, not the straggler "
             f"and the busy single")
    ns, group, members = BLOCK_GANG
    loop.api.create(KIND_POD_GROUP, make_pod_group(group, 2, namespace=ns))
    for name in members:
        loop.api.create(KIND_POD, make_pod(
            name=name, namespace=ns,
            resources={C.RESOURCE_GPU: 2, C.CPU: 1.0},
            labels={C.LABEL_POD_GROUP: group},
            annotations={C.ANNOT_MESH: BLOCK_MESH}))
    asked = {n: pod_request(loop.pods()[n]) for n in members}
    if any(r != {BLOCK_RESOURCE: 1.0, C.CPU: 1.0} for r in asked.values()):
        fail(f"the operator's mesh hook left the gang asking {asked}")
    t0 = time.perf_counter()
    loop.run_until(lambda: all(loop.pods().get(n) is not None
                               and loop.pods()[n].status.phase == "Running"
                               for n in members),
                   f"bind {group} whole and run it", advance=advance)
    bind_s = time.perf_counter() - t0
    window = {BLOCK_NODES[0]: f"{ns}/{group}",
              BLOCK_NODES[1]: f"{ns}/{group}",
              BLOCK_NODES[2]: "", BLOCK_NODES[3]: ""}
    if loop.leases[0] != window:
        fail(f"the first cycle's lease is {loop.leases[0]}, not {window}")
    gone = [(c, g) for c, _, g in loop.events if g]
    if gone != [(gone[0][0], [BLOCK_STRAGGLER[0]])] \
            or BLOCK_BUSY[0] not in loop.pods():
        fail(f"drain preemption evicted {gone}, not the straggler alone")
    evict_cycle = gone[0][0]
    # one cycle adopts the lease, BLOCK_DRAIN_AFTER more count it
    if evict_cycle != BLOCK_DRAIN_AFTER + 2:
        fail(f"the straggler was evicted in cycle {evict_cycle}, not "
             f"{BLOCK_DRAIN_AFTER + 2}")
    bound = [(c, b) for c, b, _ in loop.events if b]
    if len(bound) != 1 or bound[0][1] != sorted(members):
        fail(f"{group}'s members were bound in cycles {bound}, not both "
             f"in one")
    nodes = {n: loop.pods()[n].spec.node_name for n in members}
    if sorted(nodes.values()) != sorted(BLOCK_NODES[:2]):
        fail(f"{group} bound on {nodes}, not the leased window")
    shards = {}
    for name in BLOCK_NODES[:2]:
        node = loop.api.get("Node", name)
        shards[name] = {(a.index, a.profile): a.quantity for a in
                        parse_spec_annotations(node.metadata.annotations)}
        if shards[name] != {(0, BLOCK_PROFILE): 1} \
                or node.status.allocatable.get(BLOCK_RESOURCE) != 1.0:
            fail(f"{name} is no shard of the block: {shards[name]}, "
                 f"{node.status.allocatable}")
    # the next cycle finds the gang no longer waiting: the lease goes
    loop.step()
    if any(loop.lease().values()):
        fail(f"the lease outlived the gang's bind: {loop.lease()}")
    return loop, {
        "lease_first_cycle": {n: v for n, v in loop.leases[0].items()
                              if v},
        "evicted": BLOCK_STRAGGLER[0], "evict_cycle": evict_cycle,
        "drain_after_cycles": BLOCK_DRAIN_AFTER,
        "bind_cycle": bound[0][0], "bound": nodes, "shards": sorted(shards),
        "bind_s": bind_s, "cycles": loop.cycle,
        "cycle_ms_median": statistics.median(loop.cycle_ms),
        "cycle_ms_max": max(loop.cycle_ms)}


def _block_grant(loop: _BlockLoop, member: str) -> dict:
    """The card member's grant as the device plugin's Allocate would hand
    it (``device/deviceplugin.block_allocate_envs``): its shard's device
    and the node's GPUs whole, by GPU UUID.  The smoke stands in for the
    kubelet plugin, which needs grpcio."""
    from nos_tpu_torch.device.deviceplugin import block_allocate_envs

    node = loop.pods()[member].spec.node_name
    runtime = loop.agents[node].runtime
    ids = [d.device_id for d in runtime.list_devices()
           if d.resource_name == BLOCK_RESOURCE]
    envs = block_allocate_envs(BLOCK_RESOURCE, ids, runtime.gpu_uuids())
    key = "NOS_TPU_VISIBLE_CHIPS_nvlink_block_2x1"
    if len(ids) != 1 or key not in envs:
        fail(f"{member}'s grant on {node} is {envs}, naming no GPU")
    return envs


def phase_block(main_loss0: float, device: dict, smi: str) -> dict:
    """The gang phase's part (c), the NVLink block gang (see above): the
    control plane on the host, then the card member's training child,
    GRANT_STEPS steps of BENCH_350M_TRAIN under a grant naming the card
    whole, reusing the built kernels.  The stub member's bind is checked
    through the API alone.  Returns the child's launches."""
    from nos_tpu_torch.models.llama import BENCH_350M_TRAIN
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    loop, card = _block_loop(device)
    member = next(n for n in BLOCK_GANG[2]
                  if loop.pods()[n].spec.node_name == BLOCK_NODES[0])
    stub = next(n for n in BLOCK_GANG[2] if n != member)
    grant = _block_grant(loop, member)
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    with tempfile.TemporaryDirectory(prefix="nos-block-") as tmp:
        cfg_path, no_nvcc = _grant_workdir(tmp)
        child = _run_grant_child(member, cfg_path, grant, no_nvcc)
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"the block child built kernels: {kernels_before} -> "
             f"{kernels_after}")
    layers = BENCH_350M_TRAIN.num_layers
    r = child["report"]
    if child["rc"] != 0 or r is None:
        fail(f"block child exited {child['rc']}:\n"
             f"{child['stderr'][-4000:]}")
    if not (r["verified"] and r["devices"] == [device["uuid"]]
            and r["fraction"] is None and r["cap_bytes"] is None):
        fail(f"block child verified {r}, not the card {device['uuid']} "
             f"whole")
    _check_launches("block child", r["launches"], {
        "flash_fwd": GRANT_STEPS * layers,
        "flash_bwd_fused": GRANT_STEPS * layers})
    steps = child["steps"]
    if [s[0] for s in steps] != list(range(1, GRANT_STEPS + 1)) \
            or not all(math.isfinite(s[1]) for s in steps):
        fail(f"block child logged steps {steps}")
    loss0_rel = abs(steps[0][1] - main_loss0) / abs(main_loss0)
    if not loss0_rel <= MAIN_LOSS0_RTOL:
        fail(f"block child's step-0 loss {steps[0][1]} against "
             f"train_main's {main_loss0}: {loss0_rel} relative")
    launches = {k: r["launches"].get(k, 0)
                for k in ("flash_fwd", "flash_bwd_fused", "flash_dq",
                          "flash_dkv")}
    tiles = {name: r["tile_launches"].get(f"{kernel}:{tile[0]}x{tile[1]}",
                                          0)
             for name, (kernel, tile, _) in TILES.items()}
    stamps = [t for _, t, _ in child["stamps"]]
    emit({"phase": "block", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0, "card": card,
          "member": member, "stub_member": stub,
          "stub_checked": "through the API only (a stub node, no child)",
          "grant": grant, "grant_verified": r["devices"],
          "child_wall_s": child["wall_s"],
          "steps": [{"step": s, "loss": loss, "tokens_per_s": tps}
                    for s, loss, tps in steps],
          "step_gaps_s": [b - a for a, b in zip(stamps, stamps[1:])],
          "loss0_rel_diff": loss0_rel, "main_loss0": main_loss0,
          "launches": launches, "tile_launches": tiles})
    PATH_TILES["block"] = tiles
    return launches


# The recovery phase.  (a) partition (a)'s MPS fleet in the gang fleet's
# NVLink domains (three plan pools), planned by the parallel planner at
# each of PARALLEL_WORKERS workers and by the sequential planner, one
# untimed and PARALLEL_TIMED timed plans each on fresh snapshots.  (b)
# The recovery fleet (testing/fleet.py) once.  (c) The card's node in
# the MPS loop with heartbeat suspicion and drain-then-migrate on: a
# checkpointing job moved off the node its agent stopped reporting.
PARALLEL_FLEET_DIGEST = \
    "f2cabc689da1a5b2ad8ff93fbe7922d149d0bfc323a48707512e9029a06ffa13"
PARALLEL_WORKERS = (1, 2, 4)
PARALLEL_TIMED = 5
RECOVERY_FLEET_DIGEST = \
    "a5f8cd66f4650fa2e59599b0d51e9c5491998b9d83b0b306645a5249187bb021"
# fleet.waste_summary of the recovery run's waste ledger (the JAX
# package's ledger on the same run, tests/test_torch_recovery.py)
RECOVERY_FLEET_WASTE_DIGEST = \
    "cd71e87a5eeefa4613047d1db561af2b751250fa04ebe874f3afcf7c03b7c95e"
# two pods of which the card holds one: the job and a batch pod
RECOVERY_JOB, RECOVERY_BATCH, RECOVERY_GB = "rj", "bq", 48
# the detector's seconds: short, and longer than a pass of the loop (a
# scheduler cycle, a poll and an agent tick, every CARD_POLL_S).  The
# grace is longer than a step and a save of the job's child (0.36-0.44 s
# and 7-11 s on an NVIDIA H100 80GB HBM3 at 700.00 W, PERF.md §5), so
# the child leaves at its next checkpoint before the eviction
RECOVERY_SUSPECT_AFTER_S = 0.5
RECOVERY_GRACE_S = 30.0
# the job's steps, a checkpoint after each: two more than a grant child
RECOVERY_STEPS = GRANT_STEPS + 2
RECOVERY_CHECKPOINT_LIMIT_S = 300.0
RECOVERY_DRAINED = "node draining for migration"
_CKPT_LINE = re.compile(r"checkpoint: saved step (\d+)")
_RESUME_LINE = re.compile(r"resuming from checkpoint step (\d+)")
_EXACT_LOSS = re.compile(r"final loss exact (\S+)")
_MIGRATE_LINE = re.compile(r"migration requested \((\S+)\): exiting at "
                           r"checkpoint step (\d+)")
# What the recovery loop over the REST stub commits (_Recorder through
# _StubTap), as its CPU test's run recorded it
# (tests/test_torch_recovery.py, held against the JAX package's loop over
# its own REST client on the same stub).
RECOVERY_LOOP_WRITES = {
    "h100-node-0": [
        [],
        [
            "spec-partitioning-plan.mps=<plan 0>"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "gpu-48gb=1"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-48gb-free=1",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-48gb=1"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-48gb-used=1",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-48gb=1"
        ],
        [
            "defrag-drain=migrate:mps:node-suspect",
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-48gb-used=1",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-48gb=1"
        ],
        [
            "defrag-drain=migrate:mps:node-suspect",
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-48gb-free=1",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-48gb=1"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-48gb-free=1",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-48gb=1"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-48gb-used=1",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-48gb=1"
        ]
    ],
    "rj": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-node-0 Running Unschedulable",
        "h100-node-0 Running",
        "h100-node-0 Running migrate=node-suspect",
        "h100-node-0 Succeeded migrate=node-suspect",
        "deleted",
        "- Pending displaced=drain-migrate",
        "- Pending Unschedulable displaced=drain-migrate",
        "h100-node-0 Running Unschedulable displaced=drain-migrate",
        "h100-node-0 Running Unschedulable",
        "h100-node-0 Running"
    ],
    "bq": [
        "- Pending",
        "- Pending Unschedulable"
    ]
}


def _parallel_fleet_plans() -> dict:
    """Phase 13 (a): the fleet planned by the parallel planner at every
    worker count (each plan's desired state and journal the same, at
    PARALLEL_FLEET_DIGEST, the JAX package's) and by the sequential
    planner on the same fleet, host ms per plan each."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.obs import journal as J
    from nos_tpu_torch.partitioning.core import (
        GeometryPlanner, ParallelGeometryPlanner)
    from nos_tpu_torch.partitioning.timeshare import (
        TimesharePartitionCalculator, TimeshareProfileCalculator,
        TimeshareSnapshotTaker)
    from nos_tpu_torch.scheduler.framework import Framework
    from nos_tpu_torch.testing import fleet

    spec = fleet.domain_fleet_spec(0)

    def make() -> GeometryPlanner:
        return GeometryPlanner(Framework(), TimeshareProfileCalculator(),
                               TimesharePartitionCalculator())

    def plans(planner) -> tuple[list[float], list[dict]]:
        ms, summaries = [], []
        for _ in range(1 + PARALLEL_TIMED):
            snap = TimeshareSnapshotTaker().take_snapshot(
                fleet.build_cluster(spec))
            pending = fleet.build_pending(spec)
            journal = J.DecisionJournal(maxlen=1 << 16)
            prev = J.set_journal(journal)
            try:
                t0 = time.perf_counter()
                desired = planner.plan(snap, pending)
                ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                J.set_journal(prev)
            summaries.append(fleet.parallel_plan_summary(desired, [
                (r.category, r.subject, r.attrs) for r in journal.events()
                if r.category in (J.PLAN_NODE_COMMITTED,
                                  J.PLAN_NODE_REVERTED,
                                  J.PLAN_SHARD_MERGED)]))
        return ms, summaries

    out: dict = {"nodes": len(spec["nodes"]),
                 "pending": len(spec["pending"])}
    first = None
    for workers in PARALLEL_WORKERS:
        planner = ParallelGeometryPlanner(
            make, TimeshareProfileCalculator(), kind=C.MPS_KIND,
            max_workers=workers, min_shard_hosts=0)
        try:
            ms, summaries = plans(planner)
        finally:
            planner.close()
        first = first or summaries[0]
        if any(sm != first for sm in summaries):
            fail(f"the parallel plans at {workers} workers differ from "
                 f"the first's (desired state or journal)")
        merged = summaries[0]["journal"][-1]
        out[f"workers_{workers}"] = {
            "plan_ms_median": statistics.median(ms[1:]),
            "plan_ms_max": max(ms[1:]), "plan_ms_untimed": ms[0],
            "plan_ms": ms[1:],
            "shard_ms": {k: v * 1e3 for k, v in
                         planner.last_shard_seconds.items()}}
    digest = fleet.plan_digest(first)
    if digest != PARALLEL_FLEET_DIGEST:
        fail(f"the parallel fleet plan's digest {digest} is not the pinned "
             f"{PARALLEL_FLEET_DIGEST} (the JAX package's plan on the CPU)")
    ms, summaries = plans(make())
    out["sequential"] = {"plan_ms_median": statistics.median(ms[1:]),
                         "plan_ms_max": max(ms[1:]),
                         "plan_ms_untimed": ms[0], "plan_ms": ms[1:]}
    out.update({"pools": merged[2]["pools"], "shards": merged[2]["shards"],
                "nodes_carved": sum(r[0] == J.PLAN_NODE_COMMITTED
                                    for r in first["journal"]),
                "digest": digest})
    return out


def _recovery_fleet_run() -> dict:
    """Phase 13 (b): the recovery fleet once, to RECOVERY_FLEET_DIGEST
    (the JAX package's run) and its waste waterfall to
    RECOVERY_FLEET_WASTE_DIGEST, with no displaced job left unbound, the
    detector, the spares and the migration all exercised, and at most
    RECOVERY_LOST_HALVING of its no-recovery baseline's GPU-seconds lost
    (``run_recovery_fleet`` raises past it; both runs conserve).  The
    line carries the slowest poll: its ms, its trace time and the
    journal categories it wrote, which name its step."""
    from nos_tpu_torch.testing import fleet

    t0 = time.perf_counter()
    try:
        out = fleet.run_recovery_fleet(fleet.recovery_fleet_spec(0))
    except RuntimeError as e:
        fail(f"the recovery fleet: {e}")
    run_ms = (time.perf_counter() - t0) * 1e3
    digest = fleet.plan_digest(out["summary"])
    if digest != RECOVERY_FLEET_DIGEST:
        fail(f"the recovery fleet's digest {digest} is not the pinned "
             f"{RECOVERY_FLEET_DIGEST} (the JAX package's run on the CPU)")
    _check_waste_digest(out["waste"], RECOVERY_FLEET_WASTE_DIGEST,
                        "the recovery fleet")
    if out["lost_ratio"] is None \
            or out["lost_ratio"] > fleet.RECOVERY_LOST_HALVING:
        fail(f"the recovery fleet lost {out['lost_gpu_seconds']} "
             f"GPU-seconds against the baseline's "
             f"{out['baseline']['lost_gpu_seconds']}")
    if out["never_rebound"]:
        fail(f"{out['summary']['never_rebound']} displaced jobs were never "
             f"rebound")
    if not (out["suspicions"] and out["promotions"] and out["migrations"]
            and out["straggler_evictions"]):
        fail(f"the recovery fleet left a mechanism unexercised: {out}")
    return {k: v for k, v in out.items()
            if k not in ("summary", "poll_ms", "waste", "baseline")} | {
        "poll_ms_median": statistics.median(out["poll_ms"]),
        "poll_ms_max": max(out["poll_ms"]), "run_ms": run_ms,
        "completed": out["summary"]["completed"], "digest": digest,
        "waste": _waste_line(out["waste"]),
        "baseline": {k: v for k, v in out["baseline"].items()
                     if k != "waste"}
        | {"waste": _waste_line(out["baseline"]["waste"])}}


class _RecoveryLoop(_QuotaLoop):
    """``_QuotaLoop`` with no quota and the recovery plane on (heartbeat
    suspicion after RECOVERY_SUSPECT_AFTER_S, a migrate grace of
    RECOVERY_GRACE_S); while ``frozen`` the node's agent does not tick
    (its reporter, heartbeat and admission stop) and the scheduler and
    the controller go on."""

    def __init__(self, device: dict, clock=time.monotonic,
                 wall=time.time, api=None, watch=None) -> None:
        super().__init__(device, clock, wall, quotas=(), api=api,
                         watch=watch,
                         node_suspect_after_s=RECOVERY_SUSPECT_AFTER_S,
                         migrate_grace_s=RECOVERY_GRACE_S)
        self.frozen = False

    def tick(self) -> None:
        if not self.frozen:
            super().tick()


def _load_stub():
    """``tests/k8s_stub.py`` (a kube-apiserver-shaped HTTP stub, stdlib
    only), loaded by its path in the checkout."""
    return _load_path("k8s_stub", "tests", "k8s_stub.py")


class _StubTap:
    """The stub's commit log as a watch: every write the stub commits,
    delivered synchronously in commit order and decoded by ``decode``
    (the port's ``from_k8s`` unless another is given).  A REST client's
    watch delivers on a stream thread and a relist collapses the states
    it skipped, so the loop's recorder reads this instead.  A callback
    runs under the stub's lock and must not call the stub; what it
    raises is kept in ``errors``."""

    def __init__(self, stub, decode=None) -> None:
        from nos_tpu_torch.kube.k8s_codec import from_k8s

        self._state = stub.state
        self._decode = decode or from_k8s
        self.errors: list[BaseException] = []

    def watch(self, kind: str, fn) -> Callable[[], None]:
        import copy

        from nos_tpu_torch.kube.k8s_codec import KIND_REST

        plural, decode, errors = KIND_REST[kind][1], self._decode, \
            self.errors

        def deliver(event: str, raw: dict) -> None:
            try:
                fn(event, decode(kind, copy.deepcopy(raw)))
            except Exception as e:  # noqa: BLE001 — kept for the caller
                errors.append(e)

        class _Sink:
            """What the stub's notify puts events into."""

            def put(self, evt: dict) -> None:
                if "type" in evt:   # not a fault-injection marker
                    deliver(evt["type"], evt["object"])

        sink = _Sink()
        with self._state.lock:
            for raw in list(self._state.store.get(plural, {}).values()):
                deliver("ADDED", raw)
            self._state.watchers.setdefault(plural, []).append(sink)

        def unwatch() -> None:
            with self._state.lock:
                if sink in self._state.watchers.get(plural, []):
                    self._state.watchers[plural].remove(sink)

        return unwatch


def _recovery_start(device: dict, clock=time.monotonic, wall=time.time,
                    advance=None, poll_s: float = CARD_POLL_S, api=None,
                    watch=None) -> tuple[_RecoveryLoop, dict]:
    """Phase 13 (c) up to the job's child: RECOVERY_JOB through the loop
    until it is bound and Running, then RECOVERY_BATCH, which the card
    cannot hold beside it, until it is marked Unschedulable."""
    loop = _RecoveryLoop(device, clock, wall, api=api, watch=watch)
    loop.create_pod(RECOVERY_JOB, gb=RECOVERY_GB)
    bind_s = loop.run_until(lambda: loop.running() == [RECOVERY_JOB],
                            f"bind {RECOVERY_JOB} and run it",
                            poll_s=poll_s, advance=advance)
    loop.create_pod(RECOVERY_BATCH, gb=RECOVERY_GB)
    loop.run_until(lambda: loop.pods()[RECOVERY_BATCH].is_unschedulable(),
                   f"mark {RECOVERY_BATCH} Unschedulable", poll_s=poll_s,
                   advance=advance)
    return loop, {"bind_s": bind_s}


def _drain_migrations() -> float:
    """The recovery plane's evictions of the MPS family so far."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.exporter.metrics import REGISTRY

    return REGISTRY.value("nos_tpu_drain_migrations_total",
                          {"kind": C.MPS_KIND}) or 0.0


def _recovery_migrate(loop: _RecoveryLoop, landed, left, advance=None,
                      poll_s: float = CARD_POLL_S,
                      landed_limit_s: float = RECOVERY_CHECKPOINT_LIMIT_S
                      ) -> dict:
    """Phase 13 (c)'s migration: the loop runs until ``landed()`` (the
    job's child landed a checkpoint), then the agent freezes.  The
    detector must quarantine the node as suspect, the node must get the
    migrate drain and the job the ``migrate`` stamp and a JOB_DISPLACED
    record.  The loop runs on until ``left()`` (the child read the stamp
    at its next checkpoint and exited), which must come before the
    grace's eviction; the smoke then marks the job Succeeded (the
    kubelet's part), deletes it and recreates it with the ``displaced``
    stamp (a workload controller's), and the recovery plane must have
    evicted no one.  While the node is drained the scheduler must reject
    both pods (MigrationDrainGuard).  The agent resumes: the node must be
    released, its drain healed, and the job bound before the older batch
    pod, with no new plan written.  Returns the stages' times on the
    host's performance counter and the plan cycles that ran
    meanwhile."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.kube.client import KIND_NODE, KIND_POD
    from nos_tpu_torch.kube.objects import SUCCEEDED
    from nos_tpu_torch.obs import journal as J
    from nos_tpu_torch.partitioning.core import REASON_SUSPECT
    from nos_tpu_torch.utils.pod_util import displaced_value

    seen: dict[str, float] = {}
    # the batch pod is rejected every cycle while the job's child starts:
    # room for every record of the move
    journal = J.DecisionJournal(maxlen=1 << 20, clock=time.perf_counter)
    prev = J.set_journal(journal)

    def watch_pod(event: str, pod) -> None:
        if pod.metadata.name != RECOVERY_JOB:
            return
        now = time.perf_counter()
        if event == "DELETED":
            seen.setdefault("deleted", now)
        elif pod.metadata.annotations.get(C.ANNOT_MIGRATE):
            seen.setdefault("stamped", now)
        elif pod.spec.node_name and "deleted" in seen:
            seen.setdefault("rebound", now)

    def watch_node(event: str, node) -> None:
        drained = C.is_migration_drain(node.metadata.annotations)
        if drained:
            seen.setdefault("drained", time.perf_counter())
        elif "drained" in seen:
            seen.setdefault("released", time.perf_counter())

    unwatch = [loop.watch(KIND_POD, watch_pod),
               loop.watch(KIND_NODE, watch_node)]
    quarantine = loop.controller.quarantine
    step = functools.partial(loop.run_until, poll_s=poll_s, advance=advance)
    evictions0 = _drain_migrations()
    try:
        waited_s = step(landed, f"see {RECOVERY_JOB} land a checkpoint",
                        limit_s=landed_limit_s)
        written, cycles = loop.written(), loop.cycles
        loop.frozen = True
        seen["frozen"] = time.perf_counter()
        step(lambda: quarantine.reason(CARD_NODE) == REASON_SUSPECT,
             "suspect the node")
        annots = loop.node().metadata.annotations
        if annots.get(C.ANNOT_DEFRAG_DRAIN) != C.migration_drain_value(
                C.MPS_KIND, "node-suspect"):
            fail(f"the suspect node carries the drain "
                 f"{annots.get(C.ANNOT_DEFRAG_DRAIN)!r}")
        job = loop.pods()[RECOVERY_JOB]
        if job.metadata.annotations.get(C.ANNOT_MIGRATE) != "node-suspect":
            fail(f"{RECOVERY_JOB} carries {job.metadata.annotations}, not "
                 f"the migrate stamp")
        (suspected,) = journal.events(J.QUARANTINED)
        displaced = journal.events(J.JOB_DISPLACED)
        if [(r.subject, r.attrs["cause"], r.attrs["node"])
                for r in displaced] != [(f"default/{RECOVERY_JOB}",
                                         "node-suspect", CARD_NODE)]:
            fail(f"JOB_DISPLACED records {[r.to_dict() for r in displaced]}")
        step(lambda: left() or RECOVERY_JOB not in loop.pods(),
             f"see {RECOVERY_JOB}'s child leave at a checkpoint",
             limit_s=RECOVERY_GRACE_S)
        if RECOVERY_JOB not in loop.pods():
            fail(f"{RECOVERY_JOB} was evicted before its child left at a "
                 f"checkpoint")
        seen["left"] = time.perf_counter()
        loop.api.patch(KIND_POD, RECOVERY_JOB, "default", mutate=lambda p:
                       setattr(p.status, "phase", SUCCEEDED))
        loop.api.delete(KIND_POD, RECOVERY_JOB, "default")
        loop.create_pod(RECOVERY_JOB, gb=RECOVERY_GB, annotations={
            C.ANNOT_DISPLACED: displaced_value(C.DISPLACED_DRAIN_MIGRATE,
                                               loop.wall())})
        seq0 = max((r.seq for r in journal.events()), default=0)

        def verdicts() -> dict:
            return {r.subject: r.attrs.get("nodes", {}).get(CARD_NODE, "")
                    for r in journal.events(J.POD_REJECTED) if r.seq > seq0}

        step(lambda: len(verdicts()) == 2, "refuse both pods while drained")
        pods, got = loop.pods(), verdicts()
        for name in (RECOVERY_JOB, RECOVERY_BATCH):
            verdict = got.get(f"default/{name}", "")
            if pods[name].spec.node_name or RECOVERY_DRAINED not in verdict:
                fail(f"{name} on the drained node: bound to "
                     f"{pods[name].spec.node_name!r}, verdict {verdict!r}")
        loop.frozen = False
        seen["resumed"] = time.perf_counter()
        step(lambda: not quarantine.is_quarantined(CARD_NODE)
             and not C.is_migration_drain(loop.node().metadata.annotations),
             "release the node")
        step(lambda: bool(loop.pods()[RECOVERY_JOB].spec.node_name),
             f"bind {RECOVERY_JOB} again")
        if loop.pods()[RECOVERY_BATCH].spec.node_name:
            fail(f"{RECOVERY_BATCH} was bound beside the displaced "
                 f"{RECOVERY_JOB}")
        step(lambda: RECOVERY_JOB in loop.running(), f"run {RECOVERY_JOB}")
        if loop.pods()[RECOVERY_JOB].metadata.annotations.get(
                C.ANNOT_DISPLACED):
            fail(f"the bind left {RECOVERY_JOB}'s displaced stamp")
        if loop.written() != written:
            fail(f"moving the job wrote a new plan: {written} -> "
                 f"{loop.written()}")
        if _drain_migrations() != evictions0:
            fail(f"the recovery plane evicted "
                 f"{_drain_migrations() - evictions0} pod(s)")
    finally:
        for u in unwatch:
            u()
        J.set_journal(prev)
    return seen | {"landed_wait_s": waited_s, "suspected": suspected.ts,
                   "plan_cycles": loop.cycles - cycles,
                   "displaced_record": displaced[0].ts,
                   "released_records": [r.ts for r in journal.events(
                       J.QUARANTINE_RELEASED)]}


def _check_recovery_child(label: str, child: dict, uuid: str,
                          steps: list[int]) -> dict:
    """A recovery child that must end: exit 0, its grant verified on
    ``uuid`` at its fraction and cap, the ``steps`` logged with finite
    losses, 24 K1 + 24 K3 + 24 K4 a step and no K2 (the split backward),
    its peak under its cap.  Returns the launches by tile."""
    from nos_tpu_torch.models.llama import BENCH_350M_TRAIN

    layers = BENCH_350M_TRAIN.num_layers
    r = child["report"]
    if child["rc"] != 0 or r is None:
        fail(f"{label} exited {child['rc']}:\n{child['stderr'][-4000:]}")
    if not (r["verified"] and r["devices"] == [uuid]
            and r["fraction"] == child["fraction"]
            and r["cap_bytes"] == child["cap_bytes"]):
        fail(f"{label} verified {r}, expected {uuid} at fraction "
             f"{child['fraction']}")
    if [s[0] for s in child["steps"]] != steps \
            or not all(math.isfinite(s[1]) for s in child["steps"]):
        fail(f"{label} logged steps {child['steps']}, not {steps}")
    tiles = {name: r["tile_launches"].get(f"{kernel}:{tile[0]}x{tile[1]}", 0)
             for name, (kernel, tile, _) in TILES.items()}
    launches = {k: sum(n for name, n in tiles.items() if TILES[name][0] == k)
                for k in ("flash_fwd", "flash_bwd_fused", "flash_dq",
                          "flash_dkv")}
    _check_launches(label, launches, {
        "flash_fwd": len(steps) * layers, "flash_bwd_fused": 0,
        "flash_dq": len(steps) * layers, "flash_dkv": len(steps) * layers})
    if not (r["max_memory_allocated"] < child["cap_bytes"]
            and r["max_memory_reserved"] <= child["cap_bytes"]):
        fail(f"{label} peaked over its cap {child['cap_bytes']} B")
    child["launches"] = launches
    return tiles


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


_PROM_SAMPLE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$")


def _prometheus(text: str) -> dict[str, float]:
    """The unlabelled samples of a Prometheus text exposition; fails on a
    line that is neither a comment nor a sample, on a value that is not
    a number and on a sample whose metric has no TYPE line before it."""
    typed: set[str] = set()
    out: dict[str, float] = {}
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
            continue
        if line.startswith("#"):
            continue
        m = _PROM_SAMPLE.match(line)
        if m is None:
            fail(f"/metrics line {line!r} is not Prometheus text")
        name, labels, value = m.groups()
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and base not in typed:
            fail(f"/metrics sample {name} has no TYPE line")
        try:
            number = float(value)
        except ValueError:
            fail(f"/metrics sample {line!r} has no number")
        if labels is None:
            out[name] = number
    return out


def _scrape_child(addr: str, api) -> dict:
    """The job's child once it landed its first checkpoint: ``/healthz``
    200 ``ok``, ``/metrics`` Prometheus text with ``nos_tpu_train_step``
    >= 1, and its pod's ``job-progress`` 1 of RECOVERY_STEPS as
    ``%.4f`` (written right after the save, so polled for a moment)."""
    import urllib.request

    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.kube.client import KIND_POD

    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://{addr}/healthz", timeout=10) as r:
        health = (r.status, r.read().decode())
    if health != (200, "ok"):
        fail(f"{RECOVERY_JOB}'s child answered /healthz with {health}")
    with urllib.request.urlopen(f"http://{addr}/metrics", timeout=10) as r:
        code, text = r.status, r.read().decode()
    scrape_ms = (time.perf_counter() - t0) * 1e3
    samples = _prometheus(text)
    step = samples.get("nos_tpu_train_step")
    if code != 200 or step is None or step < 1:
        fail(f"{RECOVERY_JOB}'s child's /metrics ({code}) shows "
             f"nos_tpu_train_step {step}")
    want = f"{1 / RECOVERY_STEPS:.4f}"
    deadline = time.monotonic() + 30.0
    while True:
        progress = api.get(KIND_POD, RECOVERY_JOB, "default").metadata \
            .annotations.get(C.ANNOT_JOB_PROGRESS)
        if progress is not None or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    if progress != want:
        fail(f"{RECOVERY_JOB} carries job-progress {progress!r}, not "
             f"{want}")
    return {"healthz": health[1], "train_step": step,
            "metrics_lines": len(text.splitlines()), "scrape_ms": scrape_ms,
            "progress": progress}


def phase_recovery(main_loss0: float, device: dict, smi: str) -> dict:
    """Fleet planning by pool and node-loss recovery: (a) the pool-sharded
    fleet plan at 1, 2 and 4 workers beside the sequential plan; (b) the
    recovery fleet; (c) the card's node over the REST stub: RECOVERY_JOB
    trains under its grant as a deployed pod (the split backward, a
    checkpoint each step, its health server scraped once), the batch pod
    waits, the agent freezes once a checkpoint landed, the job is
    drained and stamped, its child leaves at its next checkpoint on the
    stamp, the job is recreated displaced, bound again ahead of the batch
    pod once the agent reports, and its new child resumes where the
    first left to end bitwise on a straight run's loss.  Returns the
    resumed child's launches, by kernel and by tile."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.kube.client import KIND_POD
    from nos_tpu_torch.kube.rest import KubeClient, KubeConfig

    t0 = time.perf_counter()
    parallel, _ = _host_result("parallel", "_parallel_fleet_plans")
    fleet_line, _ = _host_result("recovery", "_recovery_fleet_run")
    stub_mod = _load_stub()
    with stub_mod.StubApiServer() as stub, \
            tempfile.TemporaryDirectory(prefix="nos-recovery-") as tmp:
        client = KubeClient(KubeConfig(server=stub.url))
        tap = _StubTap(stub)
        progress: list[str] = []

        def watch_progress(event: str, pod) -> None:
            value = pod.metadata.annotations.get(C.ANNOT_JOB_PROGRESS)
            if pod.metadata.name == RECOVERY_JOB and value \
                    and (not progress or progress[-1] != value):
                progress.append(value)

        tap.watch(KIND_POD, watch_progress)
        loop = None
        try:
            loop, card = _recovery_start(device, api=client, watch=tap.watch)
            out = _recovery_card(loop, client, stub.url, tmp, device,
                                 main_loss0)
        finally:
            if loop is not None:
                loop.sched.close()
            client.close()
        if tap.errors:
            fail(f"the stub tap's callbacks raised: {tap.errors}")
    card |= out.pop("card") | {"progress_written": progress}
    if progress != [f"{s / RECOVERY_STEPS:.4f}"
                    for s in range(1, RECOVERY_STEPS + 1)]:
        fail(f"{RECOVERY_JOB}'s children wrote job-progress {progress}")
    if loop.writes != RECOVERY_LOOP_WRITES:
        fail(f"the recovery loop's writes differ from the CPU test's: "
             f"{json.dumps(loop.writes)}")
    launches = out["launches"]
    emit({"phase": "recovery", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0, "parallel": parallel,
          "fleet": fleet_line, "card": card, "main_loss0": main_loss0,
          "launches": launches, "tile_launches": out["tiles"],
          "children": out["children"]})
    PATH_TILES["recovery"] = out["tiles"]
    return launches


def _recovery_card(loop: _RecoveryLoop, client, url: str, tmp: str,
                   device: dict, main_loss0: float) -> dict:
    """Phase 13 (c) from the job's grant on: the children, the move and
    the checks on what each child did.  Returns the phase line's card
    fields, the children's fields, and the resumed child's launches by
    kernel and by tile."""
    from nos_tpu_torch.ops import _build

    split = {"NOS_TPU_FLASH_BWD": "split"}
    (grant,) = _grants(loop, device, [RECOVERY_JOB])
    total = device["memory_bytes"]
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    exited: dict[str, float] = {}
    scrape: dict = {}
    cfg_path, no_nvcc = _grant_workdir(tmp)
    base = json.loads(pathlib.Path(cfg_path).read_text())
    kubeconfig = pathlib.Path(tmp) / "kubeconfig.json"
    kubeconfig.write_text(json.dumps({
        "current-context": "stub",
        "contexts": [{"name": "stub", "context": {"cluster": "stub",
                                                  "user": "smoke"}}],
        "clusters": [{"name": "stub", "cluster": {"server": url}}],
        "users": [{"name": "smoke", "user": {}}]}))
    health = f"127.0.0.1:{_free_port()}"
    job_cfg = str(pathlib.Path(tmp) / "job.json")
    pathlib.Path(job_cfg).write_text(json.dumps(base | {
        "steps": RECOVERY_STEPS, "checkpoint_every": 1,
        "checkpoint_dir": str(pathlib.Path(tmp) / "ck"),
        "kubeconfig": str(kubeconfig), "health_probe_addr": health}))
    straight_cfg = str(pathlib.Path(tmp) / "straight.json")
    pathlib.Path(straight_cfg).write_text(json.dumps(
        base | {"steps": RECOVERY_STEPS}))
    pod_env = {"POD_NAME": RECOVERY_JOB, "POD_NAMESPACE": "default"}
    first = _start_grant_child(RECOVERY_JOB, job_cfg,
                               grant["env"] | split | pod_env, no_nvcc)
    straight = _start_grant_child("straight", straight_cfg,
                                  grant["env"] | split, no_nvcc)
    started = [first, straight]

    def wait_exit(proc) -> None:
        proc.wait()
        exited["first"] = time.perf_counter()

    threading.Thread(target=wait_exit, args=(first["proc"],),
                     daemon=True).start()
    try:
        def landed() -> bool:
            if "first" in exited:
                fail(f"{RECOVERY_JOB}'s child exited "
                     f"{first['proc'].returncode} before the move:\n"
                     f"{''.join(first['lines'])[-4000:]}")
            if not _CKPT_LINE.search("".join(first["lines"])):
                return False
            if not scrape:
                scrape.update(_scrape_child(health, client))
            return True

        moved = _recovery_migrate(loop, landed, lambda: "first" in exited)
        victim = _finish_grant_child(first, timeout=QUOTA_STOP_LIMIT_S)
        (grant2,) = _grants(loop, device, [RECOVERY_JOB])
        resumed = _start_grant_child(f"{RECOVERY_JOB}-resumed", job_cfg,
                                     grant2["env"] | split | pod_env,
                                     no_nvcc)
        started.append(resumed)
        resumed = _finish_grant_child(resumed)
        straight = _finish_grant_child(straight)
    finally:
        for c in started:
            if c.get("proc") is not None and c["proc"].poll() is None:
                c["proc"].kill()
                c["proc"].wait()
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"a recovery child built kernels: {kernels_before} -> "
             f"{kernels_after}")
    for child in (victim, resumed, straight):
        child["fraction"], child["cap_bytes"] = _grant_cap(RECOVERY_GB,
                                                           total)
    landed_steps = [int(m) for m in _CKPT_LINE.findall(victim["stderr"])]
    left = _MIGRATE_LINE.findall(victim["stderr"])
    if victim["rc"] != 0 or len(left) != 1 \
            or left[0] != ("node-suspect", str(max(landed_steps))):
        fail(f"{RECOVERY_JOB}'s child exited {victim['rc']} and logged "
             f"{left} with checkpoints {landed_steps}, not a clean exit at "
             f"its last checkpoint on the migrate stamp:\n"
             f"{victim['stderr'][-4000:]}")
    exit_step = max(landed_steps)
    _check_recovery_child(f"recovery {RECOVERY_JOB}", victim,
                          grant["env"]["NOS_TPU_VISIBLE_CHIPS"],
                          list(range(1, exit_step + 1)))
    starts = [int(m) for m in _RESUME_LINE.findall(resumed["stderr"])]
    if starts != [exit_step]:
        fail(f"the resumed child started at {starts}, the first one left "
             f"at checkpoint {exit_step}")
    start = starts[0]
    steps_lost = max(s[0] for s in victim["steps"]) - start
    tiles = _check_recovery_child(
        f"recovery {RECOVERY_JOB}-resumed", resumed,
        grant2["env"]["NOS_TPU_VISIBLE_CHIPS"],
        list(range(start + 1, RECOVERY_STEPS + 1)))
    _check_recovery_child("recovery straight", straight,
                          grant["env"]["NOS_TPU_VISIBLE_CHIPS"],
                          list(range(1, RECOVERY_STEPS + 1)))
    exact = [_EXACT_LOSS.findall(c["stderr"]) for c in (resumed, straight)]
    if not all(len(e) == 1 for e in exact) or exact[0] != exact[1]:
        fail(f"the resumed run ended on loss {exact[0]}, the straight run "
             f"on {exact[1]}: not bitwise equal")
    for label, child in (("first", victim), ("straight", straight)):
        rel = abs(child["steps"][0][1] - main_loss0) / abs(main_loss0)
        if not rel <= MAIN_LOSS0_RTOL:
            fail(f"the {label} child's step-0 loss {child['steps'][0][1]} "
                 f"against train_main's {main_loss0}")
        child["loss0_rel_diff"] = rel
    stamp_to_exit_s = exited["first"] - moved["stamped"]
    if not 0 < stamp_to_exit_s < RECOVERY_GRACE_S:
        fail(f"{RECOVERY_JOB}'s child left {stamp_to_exit_s} s after the "
             f"stamp, not within the {RECOVERY_GRACE_S} s grace")
    ms = lambda a, b: (moved[b] - moved[a]) * 1e3  # noqa: E731
    card = {
        "substrate": "rest (tests/k8s_stub.py)",
        "node": CARD_NODE, "pods": [RECOVERY_JOB, RECOVERY_BATCH],
        "gb": RECOVERY_GB, "suspect_after_s": RECOVERY_SUSPECT_AFTER_S,
        "migrate_grace_s": RECOVERY_GRACE_S, "steps": RECOVERY_STEPS,
        "checkpoint_landed_wait_s": moved["landed_wait_s"],
        "scrape": scrape,
        "freeze_to_suspect_ms": (moved["suspected"] - moved["frozen"]) * 1e3,
        "suspect_to_stamp_ms": (moved["stamped"] - moved["suspected"]) * 1e3,
        "stamp_to_exit_s": stamp_to_exit_s,
        "child_exit": {"rc": victim["rc"], "cause": left[0][0],
                       "at_step": exit_step},
        "exit_to_delete_ms": (moved["deleted"] - exited["first"]) * 1e3,
        "resume_to_release_ms": ms("resumed", "released"),
        "release_to_rebind_ms": ms("released", "rebound"),
        "plan_cycles_during_move": moved["plan_cycles"],
        "victim_steps": len(victim["steps"]),
        "victim_checkpoints": landed_steps, "start_step": start,
        "steps_lost": steps_lost,
        "resumed_wall_s": resumed["wall_s"],
        "straight_wall_s": straight["wall_s"],
        "final_loss_exact": exact[0][0],
        "loss0_rel_diff": straight["loss0_rel_diff"],
        "step_ms_median": statistics.median(loop.step_ms),
        "step_ms_max": max(loop.step_ms),
        "cycle_ms_median": statistics.median(loop.cycle_ms),
        "tick_ms_median": statistics.median(loop.tick_ms),
        "cycles": len(loop.cycle_ms), "passes": len(loop.step_ms)}
    if steps_lost != 0:
        fail(f"the move lost {steps_lost} step(s): the first child logged "
             f"{[s[0] for s in victim['steps']]}, the resumed one started "
             f"at {start}")
    children = [{k: v for k, v in ch.items()
                 if k not in ("stderr", "report", "confined", "stamps",
                              "steps")}
                | {"steps_logged": len(ch["steps"])}
                for ch in (victim, resumed, straight)]
    return {"card": card, "children": children, "tiles": tiles,
            "launches": resumed["launches"]}


# The mains phase.  The control plane as the deployment runs it: each
# main a process of its own (``python -m nos_tpu_torch.cmd.<main>
# --config``), all against the REST stub through one kubeconfig: two
# partitioner replicas under a lease, a scheduler, an operator and the
# card's chip agent; the smoke stands in for the kubelet (the stub's
# binding sets Running, the smoke marks Succeeded) and starts each
# bound pod's child under its grant.
MAINS = ("partitioner-0", "partitioner-1", "scheduler", "operator",
         "chipagent")
MAINS_PODS = (("team-a", "ma-0"), ("team-b", "mb-0"))
MAINS_THIRD = ("default", "mc-0")
MAINS_QUOTAS = QUOTA_CARD_QUOTAS
MAINS_LEASE = ("nos-tpu-partitioner-leader", "nos-tpu-system")
MAINS_REPORT_S = 0.1         # the chip agent's report interval
MAINS_START_LIMIT_S = 120.0  # a main's start to /healthz and /readyz
MAINS_LIMIT_S = 60.0         # each step the mains take on their own
MAINS_EXIT_LIMIT_S = 5.0     # SIGTERM to a main's exit
MAINS_RETRY_S = 2.0          # a standby's lease retry (LeaderElector's)
# the scheduler main's cycle (SchedulerConfig's default): the waste
# ledger books at cycle ends, so a waterfall read between two moments is
# exact up to one cycle at each edge, of at most the node's one GPU
MAINS_CYCLE_S = 0.05
MAINS_POOL = "-"             # the card's node has no NVLink domain label
_LABELLED = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)\{(.*)\} (\S+)$')

# What the mains leave in the stub, pinned by
# tests/test_torch_cmd.py::TestMainsAsProcesses (the same topology as
# processes on the CPU, no children; the JAX package's mains on the same
# story leave the same objects under its names): the node's annotations
# and plan label, the plugin ConfigMap's data, each pod's node and
# phase, each quota's status.used at its distinct values in commit
# order, and the lease's last holder and deadline.  Plan ids read
# plan-<n> in the order the stub first committed them, the heartbeat
# <beat>, the standby's identity "standby".
_MEM = "nos.nebuly.com/gpu-memory"
MAINS_LOOP_WRITES = {
    "node": {"annotations": {
        "nos.nebuly.com/agent-heartbeat.mps": "<beat>",
        "nos.nebuly.com/device-plugin-applied-config": "h100-node-0.plan-2",
        "nos.nebuly.com/device-plugin-generation": "2",
        "nos.nebuly.com/spec-partitioning-plan.mps": "plan-2",
        "nos.nebuly.com/status-gpu-0-24gb-free": "3",
        "nos.nebuly.com/status-partitioning-plan.mps": "plan-2"},
        "plan_label": "plan-2"},
    "configmap": {"h100-node-0.plan-2": json.dumps({
        "version": "v1", "sharing": {"mps": {
            "failRequestsGreaterThanOne": True, "resources": [{
                "name": "nvidia.com/gpu", "rename": "nvidia.com/gpu-24gb",
                "memoryGB": 24, "replicas": 3, "devices": ["0"]}]}}})},
    "pods": {"ma-0": ["h100-node-0", "Succeeded"],
             "mb-0": ["h100-node-0", "Succeeded"],
             "mc-0": ["h100-node-0", "Succeeded"]},
    "quotas": {ns: [{}, {_MEM: 0.0}, {_MEM: 24.0}, {_MEM: 0.0}]
               for ns in ("team-a", "team-b")},
    "lease": {"holder": "standby", "deadline": "0"},
}


class _Mains:
    """Phase 14's cluster: the stub with the card's node registered as
    the kubelet would (MPS, the model discovery found, one GPU), the
    quotas, a JSON kubeconfig, and the mains as processes (their logs
    under ``tmp``).  Every write the stub commits is recorded in commit
    order with the parent's clock (``_StubTap``)."""

    def __init__(self, stub, tmp: str, model: str, agent_model: str,
                 mains: tuple[str, ...] = MAINS,
                 quotas: tuple = MAINS_QUOTAS,
                 card_node: bool = True) -> None:
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.api.elasticquota import (
            ElasticQuota, ElasticQuotaSpec)
        from nos_tpu_torch.kube.client import (
            KIND_CONFIGMAP, KIND_ELASTIC_QUOTA, KIND_NODE, KIND_POD)
        from nos_tpu_torch.kube.objects import ObjectMeta
        from nos_tpu_torch.kube.rest import KubeClient, KubeConfig
        from nos_tpu_torch.testing.factory import make_gpu_node
        from nos_tpu_torch.topology import DEFAULT_REGISTRY

        self.tmp = pathlib.Path(tmp)
        self.agent_model = agent_model
        self.mains = mains
        self.client = KubeClient(KubeConfig(server=stub.url))
        self.tap = _StubTap(stub)
        self.log: list[tuple[float, str, str, object]] = []
        for kind in (KIND_NODE, KIND_POD, KIND_CONFIGMAP,
                     KIND_ELASTIC_QUOTA):
            self.tap.watch(kind, functools.partial(self._record, kind))
        self.kubeconfig = str(self.tmp / "kubeconfig.json")
        pathlib.Path(self.kubeconfig).write_text(json.dumps({
            "current-context": "stub",
            "contexts": [{"name": "stub", "context": {"cluster": "stub",
                                                      "user": "smoke"}}],
            "clusters": [{"name": "stub", "cluster": {"server": stub.url}}],
            "users": [{"name": "smoke", "user": {}}]}))
        if card_node:
            self.client.create(KIND_NODE, make_gpu_node(
                CARD_NODE, model=DEFAULT_REGISTRY.get(model), gpus=1))
        mem = C.RESOURCE_GPU_MEMORY
        for ns, lo, hi in quotas:
            self.client.create(KIND_ELASTIC_QUOTA, ElasticQuota(
                metadata=ObjectMeta(name=ns, namespace=ns),
                spec=ElasticQuotaSpec(min={mem: lo},
                                      max={mem: hi} if hi else {})))
        self.procs: dict[str, dict] = {}
        self.created: dict[str, float] = {}

    def _record(self, kind: str, event: str, obj) -> None:
        self.log.append((time.perf_counter(), kind, event, obj))

    # -- the processes ------------------------------------------------------
    def _config(self, name: str) -> tuple[str, dict, list[str]]:
        base = {"apiVersion": "nos.tpu/v1beta2",
                "kubeconfig": self.kubeconfig,
                "health_probe_addr": f"127.0.0.1:{_free_port()}"}
        if name.startswith("partitioner"):
            return "partitioner", base | {
                "kind": "mps", "leader_election": True,
                "batch_idle_s": CARD_BATCH_IDLE_S,
                "batch_timeout_s": CARD_BATCH_TIMEOUT_S}, []
        if name == "operator":
            return "operator", base | {"webhook_port": 0}, []
        if name == "chipagent":
            return "chipagent", base | {
                "model": self.agent_model, "heartbeat": True,
                "report_interval_s": MAINS_REPORT_S}, ["--node", CARD_NODE]
        return name, base, []

    def start(self, names: tuple[str, ...] | None = None) -> None:
        for name in self.mains if names is None else names:
            module, cfg, extra = self._config(name)
            path = self.tmp / f"{name}.json"
            path.write_text(json.dumps(cfg))
            log = open(self.tmp / f"{name}.log", "w")
            proc = subprocess.Popen(
                [sys.executable, "-m", f"nos_tpu_torch.cmd.{module}",
                 "--config", str(path), *extra], cwd=ROOT, env=_child_env(),
                stdout=subprocess.DEVNULL, stderr=log, text=True)
            log.close()
            self.procs[name] = {"proc": proc, "t0": time.perf_counter(),
                                "addr": cfg["health_probe_addr"]}

    def logs(self, name: str) -> str:
        return (self.tmp / f"{name}.log").read_text()

    def _get(self, name: str, path: str) -> tuple[int, str]:
        import urllib.error
        import urllib.request

        url = f"http://{self.procs[name]['addr']}{path}"
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def wait_healthy(self, names: tuple[str, ...] | None = None
                     ) -> dict[str, float]:
        """Each main's start to /healthz 200, s; then each main polled
        until /readyz answers 200 "ok", all within MAINS_START_LIMIT_S.
        A main is live before it is ready (``Main.start`` sets ready
        last, as the JAX package's does), so one read of /readyz right
        after /healthz may find it starting."""
        names = self.mains if names is None else names
        healthy: dict[str, float] = {}
        ready: set[str] = set()
        last: dict[str, tuple[int, str]] = {}
        t0 = time.monotonic()
        while len(ready) < len(names):
            for name in names:
                if name in ready:
                    continue
                p = self.procs[name]
                if p["proc"].poll() is not None:
                    fail(f"main {name} exited {p['proc'].returncode} at "
                         f"start:\n{self.logs(name)[-4000:]}")
                path = "/readyz" if name in healthy else "/healthz"
                try:
                    code, body = self._get(name, path)
                except OSError:
                    continue
                if path == "/healthz":
                    if code == 200:
                        healthy[name] = time.perf_counter() - p["t0"]
                elif (code, body) == (200, "ok"):
                    ready.add(name)
                else:
                    last[name] = (code, body)
            if time.monotonic() - t0 > MAINS_START_LIMIT_S:
                if len(healthy) < len(names):
                    fail(f"mains {sorted(set(names) - set(healthy))} gave "
                         f"no /healthz within {MAINS_START_LIMIT_S} s")
                answers = {n: last.get(n) for n in sorted(set(names) - ready)}
                fail(f"mains {sorted(answers)} gave no /readyz 200 'ok' "
                     f"within {MAINS_START_LIMIT_S} s; last answers "
                     f"{answers}")
            time.sleep(0.05)
        return healthy

    def metric(self, name: str, metric: str, **labels: str) -> float:
        """A labelled sample of a main's /metrics (0 when absent)."""
        code, text = self._get(name, "/metrics")
        if code != 200:
            fail(f"main {name}'s /metrics answered {code}")
        want = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        for line in text.splitlines():
            m = _LABELLED.match(line)
            if m and m.group(1) == metric and ",".join(
                    sorted(m.group(2).split(","))) == want:
                return float(m.group(3))
        return 0.0

    def identity(self, name: str) -> str | None:
        """The lease identity a partitioner logged on taking the lease."""
        m = re.search(r"leader election \S+: (\S+) (?:acquired|took over)",
                      self.logs(name))
        return m.group(1) if m else None

    def lease(self) -> tuple[str, str]:
        from nos_tpu_torch.kube.client import KIND_CONFIGMAP
        from nos_tpu_torch.kube.leaderelection import ANN_DEADLINE, ANN_HOLDER

        cm = self.client.try_get(KIND_CONFIGMAP, *MAINS_LEASE)
        if cm is None:
            return "", ""
        a = cm.metadata.annotations
        return a.get(ANN_HOLDER, ""), a.get(ANN_DEADLINE, "")

    def stop(self, name: str) -> dict:
        """SIGTERM a main; its exit code and seconds to exit."""
        p = self.procs[name]
        t0 = time.perf_counter()
        p["proc"].send_signal(signal.SIGTERM)
        try:
            rc = p["proc"].wait(timeout=MAINS_EXIT_LIMIT_S)
        except subprocess.TimeoutExpired:
            fail(f"main {name} did not exit within {MAINS_EXIT_LIMIT_S} s "
                 f"of SIGTERM:\n{self.logs(name)[-4000:]}")
        p["exited"] = time.perf_counter()
        out = {"rc": rc, "exit_s": p["exited"] - t0}
        if rc != 0:
            fail(f"main {name} exited {rc} on SIGTERM:\n"
                 f"{self.logs(name)[-4000:]}")
        return out

    def close(self) -> None:
        for p in self.procs.values():
            if p["proc"].poll() is None:
                p["proc"].kill()
                p["proc"].wait()
        self.client.close()

    # -- the cluster ----------------------------------------------------------
    def create_pod(self, namespace: str, name: str) -> None:
        from nos_tpu_torch.kube.client import KIND_POD
        from nos_tpu_torch.testing.factory import make_timeshare_pod

        self.created[name] = time.perf_counter()
        self.client.create(KIND_POD, make_timeshare_pod(
            CARD_SHARE_GB, name=name, namespace=namespace,
            creation_timestamp=time.time()))

    def pods(self) -> dict:
        from nos_tpu_torch.kube.client import KIND_POD

        return {p.metadata.name: p for p in self.client.list(KIND_POD)}

    def node(self):
        from nos_tpu_torch.kube.client import KIND_NODE

        return self.client.get(KIND_NODE, CARD_NODE)

    def mark(self, names, phase: str = "Succeeded") -> None:
        from nos_tpu_torch.kube.client import KIND_POD

        pods = self.pods()
        for name in names:
            self.client.patch(KIND_POD, name, pods[name].metadata.namespace,
                              mutate=lambda p: setattr(p.status, "phase",
                                                       phase))

    def until(self, done, what: str, limit_s: float = MAINS_LIMIT_S):
        t0 = time.monotonic()
        while not done():
            if time.monotonic() - t0 > limit_s:
                fail(f"the mains did not {what} within {limit_s} s")
            for name, p in self.procs.items():
                if "exited" not in p and p["proc"].poll() is not None:
                    fail(f"main {name} exited {p['proc'].returncode}:\n"
                         f"{self.logs(name)[-4000:]}")
            time.sleep(CARD_POLL_S)
        return time.monotonic() - t0

    def bound_at(self, name: str) -> float | None:
        """When the stub first committed ``name`` with a node."""
        for t, kind, _, obj in self.log:
            if kind == "Pod" and obj.metadata.name == name \
                    and obj.spec.node_name:
                return t
        return None

    def running(self, names) -> bool:
        pods = self.pods()
        return all(n in pods and pods[n].spec.node_name == CARD_NODE
                   and pods[n].status.phase == "Running" for n in names)

    def used(self) -> dict[str, list]:
        """Each quota's status.used at its distinct values, in commit
        order."""
        out: dict[str, list] = {}
        for _, kind, _, obj in self.log:
            if kind == "ElasticQuota":
                seq = out.setdefault(obj.metadata.namespace, [])
                value = dict(sorted(obj.status.used.items()))
                if not seq or seq[-1] != value:
                    seq.append(value)
        return out

    def lease_writes(self) -> list[tuple[float, str, str]]:
        from nos_tpu_torch.kube.leaderelection import ANN_DEADLINE, ANN_HOLDER

        return [(t, o.metadata.annotations.get(ANN_HOLDER, ""),
                 o.metadata.annotations.get(ANN_DEADLINE, ""))
                for t, kind, _, o in self.log
                if kind == "ConfigMap" and (o.metadata.name,
                                            o.metadata.namespace)
                == MAINS_LEASE]

    def plan_writes(self) -> list[tuple[float, str]]:
        """(commit time, spec plan id) of each new MPS plan on the node."""
        from nos_tpu_torch.api import constants as C

        out: list[tuple[float, str]] = []
        for t, kind, _, o in self.log:
            if kind == "Node":
                plan = o.metadata.annotations.get(
                    C.spec_plan_annotation(C.MPS_KIND), "")
                if plan and (not out or out[-1][1] != plan):
                    out.append((t, plan))
        return out


def _mains_grants(m: _Mains, device: dict, names: list[str]) -> list[dict]:
    """Each pod's grant from the stub's objects alone: the plugin config
    the node applied (its ConfigMap key, read by the timeshare plugin)
    and the reporter's used shares."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.device.timeshare_plugin import TimeshareDevicePlugin
    from nos_tpu_torch.partitioning.timeshare import (
        DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE)

    node = m.node()
    key = node.metadata.annotations.get(C.ANNOT_PLUGIN_APPLIED_CONFIG, "")
    gpus = TimeshareDevicePlugin(m.client, CARD_NODE, DEVICE_PLUGIN_CM_NAME,
                                 DEVICE_PLUGIN_CM_NAMESPACE).gpu_config(key)
    if gpus is None:
        fail(f"the node applied {key!r}, which the ConfigMap lacks")
    return _grants_of(node, m.pods(), gpus, device, names)


def _mains_start(m: _Mains) -> dict:
    """The mains up: each healthy and ready; exactly one partitioner holds
    the lease, and it alone runs the partitioner loop; the operator
    warned that quota admission is unenforced."""
    healthy = m.wait_healthy()
    holders = {}
    t0 = time.monotonic()
    while time.monotonic() - t0 < MAINS_LIMIT_S:
        holders = {n: m.identity(n) for n in MAINS[:2]}
        if any(holders.values()):
            break
        time.sleep(CARD_POLL_S)
    leaders = [n for n, ident in holders.items() if ident]
    if len(leaders) != 1:
        fail(f"partitioners that took the lease: {holders}")
    (leader,) = leaders
    (standby,) = [n for n in MAINS[:2] if n != leader]
    holder, deadline = m.lease()
    if holder != holders[leader] or not float(deadline) > time.time():
        fail(f"the lease reads {holder!r} until {deadline}, not "
             f"{leader}'s {holders[leader]!r}")
    m.until(lambda: m.metric(leader, "nos_tpu_runloop_tick_seconds_count",
                             loop="partitioner-mps") > 0,
            "run the leader's partitioner loop")
    standby_ticks = m.metric(standby, "nos_tpu_runloop_tick_seconds_count",
                             loop="partitioner-mps")
    if standby_ticks:
        fail(f"the standby {standby} ran the partitioner loop")
    if "quota admission is UNENFORCED" not in m.logs("operator"):
        fail("the operator did not warn that quota admission is "
             "unenforced with webhook_port 0")
    return {"start_to_healthz_s": healthy, "leader": leader,
            "standby": standby, "standby_ticks_at_start": standby_ticks}


def _mains_place(m: _Mains, leader: str) -> dict:
    """The two pods through the mains alone: one plan by the leader, the
    chip agent applies and reports, the scheduler binds both (the stub's
    binding: Running), the operator writes each quota's use."""
    from nos_tpu_torch.api import constants as C

    names = [n for _, n in MAINS_PODS]
    for ns, name in MAINS_PODS:
        m.create_pod(ns, name)
    bind_s = m.until(lambda: m.running(names), "bind both pods")
    plans = m.metric(leader, "nos_tpu_plans_total", kind=C.MPS_KIND)
    if plans != 1:
        fail(f"the leader counted {plans} plans for the two pods, not one")
    annots = m.node().metadata.annotations
    spec = annots.get(C.spec_plan_annotation(C.MPS_KIND), "")
    if not spec or annots.get(C.status_plan_annotation(C.MPS_KIND)) != spec:
        fail(f"the handshake is open on {CARD_NODE}: {annots}")
    want = {C.RESOURCE_GPU_MEMORY: float(CARD_SHARE_GB)}
    m.until(lambda: all(m.used().get(ns, [{}])[-1] == want
                        for ns, _ in MAINS_PODS),
            "write each quota's status.used")
    # the binding and the quotas can land before the agent's next report
    m.until(lambda: sum(int(v) for k, v in m.node().metadata.annotations
                        .items() if k.endswith("-used")) >= len(names),
            "report both pods' shares used")
    return {"bind_s": bind_s, "plans": plans,
            "create_to_bound_ms": {n: (m.bound_at(n) - m.created[n]) * 1e3
                                   for n in names}}


def _mains_snapshot(m: _Mains) -> dict:
    """The scheduler main's /snapshot: 200, the cluster's state, the
    metric series and the waste waterfall, which must conserve."""
    code, body = m._get("scheduler", "/snapshot")
    if code != 200:
        fail(f"the scheduler main's /snapshot answered {code}: {body[:500]}")
    payload = json.loads(body)
    if not {"state", "metrics", "waste"} <= set(payload):
        fail(f"the scheduler main's /snapshot carries {sorted(payload)}")
    _check_conserves(payload["waste"], "the scheduler main")
    return payload


def _mains_productive(before: dict, after: dict, gpus: int) -> dict:
    """The card node's waterfall between two /snapshot reads while both
    pods hold their shares: productive must be ``gpus`` x
    CARD_SHARE_GB / 80 of the GPU-seconds (48/80), within one scheduler
    cycle of the whole GPU at each edge (2 x MAINS_CYCLE_S GPU-s)."""
    a = before["waste"]["pools"].get(MAINS_POOL)
    b = after["waste"]["pools"].get(MAINS_POOL)
    if a is None or b is None or b["capacity_chips"] != 1.0:
        fail(f"the scheduler's waterfall has no one-GPU pool "
             f"{MAINS_POOL!r}: {after['waste']['pools']}")
    d_cap = b["capacity_chip_seconds"] - a["capacity_chip_seconds"]
    d_prod = b["chip_seconds"].get("productive", 0.0) \
        - a["chip_seconds"].get("productive", 0.0)
    share = gpus * CARD_SHARE_GB / 80.0
    tolerance = 2 * MAINS_CYCLE_S * b["capacity_chips"]
    if not d_cap > 0 or abs(d_prod - share * d_cap) > tolerance:
        fail(f"productive {d_prod} of {d_cap} GPU-s while both pods ran, "
             f"not {share} of it within {tolerance} GPU-s")
    return {"window_gpu_seconds": d_cap, "productive_gpu_seconds": d_prod,
            "productive_share": d_prod / d_cap, "want_share": share,
            "tolerance_gpu_seconds": tolerance}


def _mains_failover(m: _Mains, leader: str, standby: str,
                    before_third=None) -> dict:
    """SIGTERM to the leader: it exits 0 and releases the lease, the
    standby takes it within its retry, and a third pod, created after
    the handover (``before_third()`` runs just before), is planned by
    the new leader alone and bound."""
    from nos_tpu_torch.api import constants as C

    old = m.identity(leader)
    first_plans = m.plan_writes()
    if len(first_plans) != 1:
        fail(f"plans written before the failover: {first_plans}")
    t_term = time.perf_counter()
    leader_exit = m.stop(leader)
    m.until(lambda: m.identity(standby) is not None,
            "hand the lease to the standby", limit_s=3 * MAINS_RETRY_S + 10)
    new = m.identity(standby)
    writes = m.lease_writes()
    released = [t for t, h, d in writes if h == old and d == "0"]
    taken = [t for t, h, _ in writes if h == new]
    if not released or not taken or not released[0] < taken[0]:
        fail(f"the lease's writes {writes}: no release by {old} before "
             f"{new} took it")
    if any(h == old for t, h, _ in writes if t > released[0]):
        fail(f"{old} wrote the lease after releasing it: {writes}")
    handover_ms = (taken[0] - t_term) * 1e3
    if not handover_ms < (MAINS_RETRY_S + 1.0) * 1e3:
        fail(f"the standby took the lease {handover_ms} ms after SIGTERM, "
             f"over its {MAINS_RETRY_S} s retry and a step")
    ns, third = MAINS_THIRD
    if before_third is not None:
        before_third()
    m.create_pod(ns, third)
    m.until(lambda: m.running([third]), f"bind {third}")
    plans = m.plan_writes()
    if len(plans) != 2 or plans[1][1] == plans[0][1] \
            or not plans[1][0] > taken[0]:
        fail(f"the node's plans {plans}: not one new plan after the "
             f"handover at {taken[0]}")
    new_plans = m.metric(standby, "nos_tpu_plans_total", kind=C.MPS_KIND)
    if new_plans != 1:
        fail(f"the new leader counted {new_plans} plans, not one")
    return {"sigterm_to_new_holder_ms": handover_ms,
            "handover_to_third_bound_ms": (m.bound_at(third) - taken[0])
            * 1e3, "new_leader_plans": new_plans,
            "release_to_take_ms": (taken[0] - released[0]) * 1e3,
            "leader_exit": leader_exit}


def _mains_exporter(m: _Mains) -> dict:
    """The one-shot exporter on a dump of the stub and on the scheduler
    main's /snapshot: each exits 0 with the MPS node and its GPU, and the
    snapshot's payload carries the scheduler's conserved waterfall."""
    from nos_tpu_torch.kube.serialize import dump_state

    state = m.tmp / "state.json"
    state.write_text(json.dumps(dump_state(m.client)))
    runs, payloads = {}, {}
    for what, source in (("file", str(state)),
                         ("snapshot", f"http://{m.procs['scheduler']['addr']}")):
        out = m.tmp / f"payload-{what}.json"
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "nos_tpu_torch.cmd.metricsexporter",
             "--source", source, "--out", str(out)], cwd=ROOT,
            env=_child_env(), capture_output=True, text=True, timeout=120)
        runs[what] = {"rc": r.returncode, "s": time.perf_counter() - t0}
        if r.returncode != 0:
            fail(f"the exporter on the {what} exited {r.returncode}:\n"
                 f"{r.stderr[-4000:]}")
        payloads[what] = json.loads(out.read_text())
        cluster = payloads[what]["cluster"]
        if cluster["nodes_total"] != 1 or cluster["partitioning"] != {
                "mps": {"nodes": 1, "gpus": 1.0}}:
            fail(f"the exporter's payload from the {what} describes "
                 f"{cluster}")
    waste = payloads["snapshot"].get("waste")
    if waste is None or MAINS_POOL not in waste["pools"]:
        fail(f"the exporter's payload from the scheduler's /snapshot "
             f"carries no waste waterfall: {sorted(payloads['snapshot'])}")
    _check_conserves(waste, "the exporter's payload")
    return {"exit_codes": {k: v["rc"] for k, v in runs.items()},
            "seconds": {k: v["s"] for k, v in runs.items()},
            "payload_cluster": payloads["snapshot"]["cluster"],
            "payload_waste_pools": sorted(waste["pools"])}


def _mains_obs(m: _Mains) -> dict:
    """The scheduler main's observability after the pods' release: its
    /debug/slo answers 200 with a schedule-latency verdict for the pods'
    class, and ``python -m nos_tpu_torch.obs waste --url`` exits 0 and
    prints the conserved waterfall's categories."""
    cls = f"ts-{CARD_SHARE_GB}"

    def verdicts() -> list:
        code, body = m._get("scheduler", "/debug/slo")
        if code != 200:
            fail(f"the scheduler main's /debug/slo answered {code}: {body}")
        return [v for v in json.loads(body)["verdicts"]
                if v["objective"] == "schedule-latency"
                and v["class"] == cls]

    m.until(lambda: bool(verdicts()),
            f"judge the schedule latency of class {cls}")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "nos_tpu_torch.obs", "waste", "--url",
         f"http://{m.procs['scheduler']['addr']}"], cwd=ROOT,
        env=_child_env(), capture_output=True, text=True, timeout=120)
    cli_s = time.perf_counter() - t0
    if r.returncode != 0 or "(conservation: ok)" not in r.stdout \
            or "productive" not in r.stdout:
        fail(f"obs waste exited {r.returncode}:\n{r.stdout[-4000:]}\n"
             f"{r.stderr[-4000:]}")
    return {"slo_verdict": verdicts()[0], "obs_waste_rc": r.returncode,
            "obs_waste_s": cli_s,
            "obs_waste_categories": re.findall(
                r"^  ([a-z_]+) +[\d.]+ +[\d.]+%$", r.stdout, re.M)}


def _mains_shutdown(m: _Mains) -> dict:
    """SIGTERM to every main still up: each exits 0 within
    MAINS_EXIT_LIMIT_S, and no lease is left held."""
    out = {n: m.stop(n) for n in MAINS if "exited" not in m.procs[n]}
    holder, deadline = m.lease()
    if deadline != "0":
        fail(f"the lease is left held by {holder!r} until {deadline}")
    return out


def _mains_writes(m: _Mains, standby: str) -> dict:
    """The final objects, masked as MAINS_LOOP_WRITES pins them."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.kube.client import KIND_CONFIGMAP
    from nos_tpu_torch.partitioning.timeshare import (
        DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE)

    plans = [p for _, p in m.plan_writes()]

    def mask(s: str) -> str:
        for i, plan in enumerate(plans, 1):
            s = s.replace(plan, f"plan-{i}")
        return s

    node = m.node()
    beat = C.heartbeat_annotation(C.MPS_KIND)
    annots = {mask(k): "<beat>" if k == beat else mask(v)
              for k, v in sorted(node.metadata.annotations.items())}
    cm = m.client.get(KIND_CONFIGMAP, DEVICE_PLUGIN_CM_NAME,
                      DEVICE_PLUGIN_CM_NAMESPACE)
    holder, deadline = m.lease()
    return {
        "node": {"annotations": annots, "plan_label": mask(
            node.metadata.labels.get(C.LABEL_DEVICE_PLUGIN_CONFIG, ""))},
        "configmap": {mask(k): mask(v) for k, v in sorted(cm.data.items())},
        "pods": {n: [p.spec.node_name, p.status.phase]
                 for n, p in sorted(m.pods().items())},
        "quotas": m.used(),
        "lease": {"holder": "standby" if holder == m.identity(standby)
                  else holder, "deadline": deadline}}


def _mains_host(stub, tmp: str, device: dict, agent_model: str,
                children=None) -> tuple[dict, dict, dict]:
    """Phase 14 on the host: the mains started, the two pods placed, the
    leader failed over and the third pod placed, the pods released, the
    exporter, the shutdown.  ``children(m, grants)`` starts the bound
    pods' children after the placement, before the failover, and
    returns a function that waits for them once the third pod is placed
    and returns their fields.  Returns the phase's fields, the masked
    final objects and the children's fields."""
    from nos_tpu_torch.api import constants as C

    m = _Mains(stub, tmp, device["model"], agent_model)
    try:
        m.start()
        started = _mains_start(m)
        leader, standby = started["leader"], started["standby"]
        placed = _mains_place(m, leader)
        names = [n for _, n in MAINS_PODS]
        grants = _mains_grants(m, device, names)
        running = children(m, grants) if children is not None else None
        # the waterfall while both pods hold their shares: from here to
        # the third pod's creation
        reads = [_mains_snapshot(m)]
        failover = _mains_failover(
            m, leader, standby,
            before_third=lambda: reads.append(_mains_snapshot(m)))
        productive = _mains_productive(reads[0], reads[1], len(names))
        m.mark([MAINS_THIRD[1]])
        kids = running() if running is not None else {}
        m.mark(names)
        zero = {C.RESOURCE_GPU_MEMORY: 0.0}
        m.until(lambda: all(m.used()[ns][-1] == zero
                            for ns, _, _ in MAINS_QUOTAS),
                "write each quota's status.used back to 0")
        m.until(lambda: not any(k.endswith("-used")
                                for k in m.node().metadata.annotations),
                "report the released shares")
        exporter = _mains_exporter(m)
        observed = _mains_obs(m)
        waste = _mains_snapshot(m)["waste"]
        exits = _mains_shutdown(m)
        writes = _mains_writes(m, standby)
        if m.tap.errors:
            fail(f"the stub tap's callbacks raised: {m.tap.errors}")
    finally:
        m.close()
    exits[leader] = failover.pop("leader_exit")
    fields = {"mains": list(MAINS), "node": CARD_NODE,
              "share_gb": CARD_SHARE_GB,
              "quotas": [list(q) for q in MAINS_QUOTAS],
              "batch_idle_s": CARD_BATCH_IDLE_S,
              "batch_timeout_s": CARD_BATCH_TIMEOUT_S,
              "report_interval_s": MAINS_REPORT_S,
              **started, **placed, **failover,
              "grants": [{"pod": g["pod"], "gpu": g["gpu"],
                          "gb": int(g["env"]["NOS_TPU_TIMESHARE_GB"])}
                         for g in grants],
              "quota_used_seen": writes["quotas"], "exporter": exporter,
              "waste_while_both_ran": productive, **observed,
              "waste": _waste_line(waste), "main_exits": exits}
    return fields, writes, kids



def phase_mains(main_loss0: float, device: dict, smi: str) -> dict:
    """The mains as processes over the REST stub (``_mains_host``); the
    two bound pods' children (train_main's BENCH_350M_TRAIN at full
    width, GRANT_STEPS fused steps, a checkpoint at the end) start at
    once under the grants derived from the stub's objects, as deployed
    pods (``POD_NAME``, ``POD_NAMESPACE``, the kubeconfig), before the
    leader's SIGTERM; each must pass as grant (a)'s child and write
    ``job-progress`` 1.0000 to its pod.  Returns the children's
    launches, by kernel and by tile."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    total = device["memory_bytes"]
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    stub_mod = _load_stub()
    started: list[dict] = []
    with stub_mod.StubApiServer() as stub, \
            tempfile.TemporaryDirectory(prefix="nos-mains-") as tmp:
        cfg_path, no_nvcc = _grant_workdir(tmp)
        base = json.loads(pathlib.Path(cfg_path).read_text())
        namespaces = {name: ns for ns, name in MAINS_PODS}

        def children(m: _Mains, grants: list[dict]):
            for g in grants:
                pod = g["pod"]
                cfg = pathlib.Path(tmp) / f"{pod}.json"
                cfg.write_text(json.dumps(base | {
                    "kubeconfig": m.kubeconfig,
                    "checkpoint_dir": str(pathlib.Path(tmp) / f"ck-{pod}")}))
                started.append(_start_grant_child(
                    pod, str(cfg), g["env"] | {
                        "POD_NAME": pod, "POD_NAMESPACE": namespaces[pod]},
                    no_nvcc))

            def finish() -> dict:
                done = [_finish_grant_child(c) for c in started]
                pods = m.pods()
                progress = {c["case"]: pods[c["case"]].metadata.annotations
                            .get(C.ANNOT_JOB_PROGRESS) for c in done}
                return {"children": done, "progress": progress}

            return finish

        try:
            card, writes, kids = _mains_host(stub, tmp, device, "auto",
                                             children)
        finally:
            for c in started:
                if c.get("proc") is not None and c["proc"].poll() is None:
                    c["proc"].kill()
                    c["proc"].wait()
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"a mains child built kernels: {kernels_before} -> "
             f"{kernels_after}")
    done = kids["children"]
    for child in done:
        child["fraction"], child["cap_bytes"] = _grant_cap(
            int(child["grant"]["NOS_TPU_TIMESHARE_GB"]), total)
    reports = [_check_granted_child(f"mains {c['case']}", c,
                                    c["grant"]["NOS_TPU_VISIBLE_CHIPS"],
                                    main_loss0) for c in done]
    if kids["progress"] != {c["case"]: "1.0000" for c in done}:
        fail(f"the mains children wrote job-progress {kids['progress']}")
    if writes != MAINS_LOOP_WRITES:
        fail(f"the mains' final objects differ from the CPU test's: "
             f"{json.dumps(writes)}")
    windows, overlap = _step_windows(done)
    card |= {"progress": kids["progress"], "step_windows_s": windows,
             "overlap_s": overlap}
    launches = {k: sum(r["launches"].get(k, 0) for r in reports)
                for k in ("flash_fwd", "flash_bwd_fused", "flash_dq",
                          "flash_dkv")}
    tiles = {name: sum(r["tile_launches"].get(
                 f"{kernel}:{tile[0]}x{tile[1]}", 0) for r in reports)
             for name, (kernel, tile, _) in TILES.items()}
    emit({"phase": "mains", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0, "card": card,
          "main_loss0": main_loss0, "loss0_rtol": MAIN_LOSS0_RTOL,
          "launches": launches, "tile_launches": tiles,
          "children": [{k: v for k, v in ch.items()
                        if k not in ("stderr", "report", "confined",
                                     "stamps", "steps")}
                       | {"steps_logged": len(ch["steps"]),
                          "launches": ch["report"]["launches"]}
                       for ch in done]})
    PATH_TILES["mains"] = tiles
    return launches


# The elastic phase.  (a) The defrag fleet (testing/fleet.py:
# bench_defrag.py's trace on the MIG stand-in) on the host, defrag and
# grow on, the baseline with both off and propose-only.  (b) The card's
# node in the MPS loop over the REST stub with the quotas: an elastic
# gang grows into a free share and gives back one replica.
# fleet.plan_digest of the defrag fleet's summary and of its waste
# ledger's waterfall, defrag and grow on: the JAX package's run of the
# same trace (tests/test_torch_defrag.py)
DEFRAG_FLEET_DIGEST = \
    "db25ad0691996f3b3bf489c2bd532c8db3add9c8ad4169376729dfb28bd2a7d5"
DEFRAG_FLEET_WASTE_DIGEST = \
    "f153cdd24c9eff9aa665082abb54569959bd2f245f8b7624cc4fecb577f19ed0"
# whether the JAX package's runs of the trace halve frag_stranded against
# the baseline (bench_defrag.py's FRAG_HALVING_TARGET): the halving is
# held only if they do (tests/test_torch_defrag.py)
DEFRAG_FRAG_HALVING_MET = False
# the defrag-on run this many times; the baseline and propose-only once
ELASTIC_FLEET_RUNS = 2
ELASTIC_CARD_QUOTAS = GANG_CARD_QUOTAS
# (namespace, PodGroup, members), each member one CARD_SHARE_GB share,
# min and max replicas; a plain pod of the namespace beside it
ELASTIC_GANG = ("team-a", "eg", ("eg-0", "eg-1"))
ELASTIC_BOUNDS = (2, 3)
ELASTIC_SINGLE = "p0"
ELASTIC_GROWN = "eg-e2"
ELASTIC_PREEMPTOR = ("team-b", "tb-0")
# the member the shrink rung takes: the JAX package's choice on the CPU
# (tests/test_torch_elastic.py).  The stub stamps every object with one
# creation time, so the over-quota members tie and the walk takes the one
# the node listed first, an original member.
ELASTIC_VICTIM = "eg-1"
# the members' steps: a checkpoint each step, a restart at each resize
ELASTIC_STEPS = GRANT_STEPS + 4
_RESIZE_LINE = re.compile(r"dp resize requested \((\d+) -> (\d+) workers\): "
                          r"exiting at checkpoint step (\d+)")
# What the elastic loop writes (_Recorder over the stub's commit log), as
# its CPU test's run recorded it (tests/test_torch_elastic.py, held
# against the JAX package's loop on its own REST client).
ELASTIC_LOOP_WRITES = {
    "h100-node-0": [
        [],
        [
            "spec-partitioning-plan.mps=<plan 0>"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=3"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-24gb-free=3",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=3"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-24gb-used=3",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=3"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-24gb-free=1",
            "status-gpu-0-24gb-used=2",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=3"
        ],
        [
            "device-plugin-applied-config=h100-node-0.<plan 0>",
            "device-plugin-generation=1",
            "spec-partitioning-plan.mps=<plan 0>",
            "status-gpu-0-24gb-used=3",
            "status-partitioning-plan.mps=<plan 0>",
            "gpu-24gb=3"
        ]
    ],
    "team-a": [
        "used=0",
        "used=72",
        "used=48",
        "used=72",
        "used=48"
    ],
    "team-b": [
        "used=0",
        "used=24"
    ],
    "eg": [
        "Pending 0",
        "Scheduled 2",
        "Scheduled 3"
    ],
    "eg-0": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-node-0 Running Unschedulable",
        "h100-node-0 Running",
        "h100-node-0 Running in-quota",
        "h100-node-0 Running in-quota dp-resize=3",
        "h100-node-0 Running in-quota dp-resize=2"
    ],
    "eg-1": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-node-0 Running Unschedulable",
        "h100-node-0 Running",
        "h100-node-0 Running over-quota",
        "h100-node-0 Running over-quota dp-resize=3",
        "deleted"
    ],
    "p0": [
        "- Pending",
        "- Pending Unschedulable",
        "h100-node-0 Running Unschedulable",
        "h100-node-0 Running",
        "h100-node-0 Running over-quota",
        "h100-node-0 Succeeded over-quota"
    ],
    "eg-e2": [
        "- Pending in-quota",
        "h100-node-0 Running in-quota",
        "h100-node-0 Running over-quota",
        "h100-node-0 Running over-quota dp-resize=2"
    ],
    "tb-0": [
        "- Pending",
        "h100-node-0 Running",
        "h100-node-0 Running in-quota"
    ]
}


def _defrag_fleet_runs(runs: int = ELASTIC_FLEET_RUNS) -> dict:
    """The defrag fleet: ``fleet.run_defrag_fleet`` (defrag and grow on,
    the baseline, propose-only) once and the defrag-on run ``runs`` - 1
    times more.  Every defrag-on run must hash to DEFRAG_FLEET_DIGEST and
    its conserved waterfall to DEFRAG_FLEET_WASTE_DIGEST; every move must
    be of a movable pod: a job's, none past the spare progress, no
    elastic member (those shrink); the trace runs no serving pod and no
    rigid gang, whose shields the CPU stories hold; no job moved more than
    MAX_MIGRATIONS_PER_JOB times nor more than MAX_TOTAL_MIGRATIONS pods
    in all; the baseline and propose-only runs must decide alike, the
    defragmenter's own records aside; the utilisation floor must reach
    the bench's UTILIZATION_MIN_TARGET, and the frag halving is held
    when the JAX package's runs meet it (DEFRAG_FRAG_HALVING_MET)."""
    from nos_tpu_torch.testing import fleet

    spec = fleet.defrag_fleet_spec(0)
    t0 = time.perf_counter()
    first = fleet.run_defrag_fleet(spec)
    first["run_ms"] = (time.perf_counter() - t0) * 1e3
    outs = [first]
    for _ in range(runs - 1):
        t0 = time.perf_counter()
        out = fleet._defrag_run(spec)
        out["run_ms"] = (time.perf_counter() - t0) * 1e3
        outs.append(out)
    for out in outs:
        digest = fleet.plan_digest(out["summary"])
        if digest != DEFRAG_FLEET_DIGEST:
            fail(f"the defrag fleet's digest {digest} is not the pinned "
                 f"{DEFRAG_FLEET_DIGEST} (the JAX package's run on the CPU)")
        _check_waste_digest(out["waste"], DEFRAG_FLEET_WASTE_DIGEST,
                            "the defrag fleet")
        for name, progress, kind in out["evictions"]:
            if kind in ("", "elastic") or progress >= 0.75:
                fail(f"the defragmenter moved {name} ({kind or 'no job'}, "
                     f"progress {progress})")
        if out["migrations_by_job_max"] > fleet.MAX_MIGRATIONS_PER_JOB \
                or out["migrated_pods"] > fleet.MAX_TOTAL_MIGRATIONS:
            fail(f"the defrag fleet moved a job "
                 f"{out['migrations_by_job_max']} times, "
                 f"{out['migrated_pods']} pods in all")
    if not first["identical"]:
        fail("the defrag fleet's baseline and propose-only runs decided "
             "differently")
    frag = first["waste"]["fleet"]["chip_seconds"].get("frag_stranded", 0.0)
    base = first["baseline"]["waste"]["fleet"]["chip_seconds"].get(
        "frag_stranded", 0.0)
    if DEFRAG_FRAG_HALVING_MET and frag > fleet.FRAG_HALVING_TARGET * base:
        fail(f"frag_stranded {frag} GPU-s over "
             f"{fleet.FRAG_HALVING_TARGET} x the baseline's {base}")
    if first["utilization_min"] < fleet.UTILIZATION_MIN_TARGET:
        fail(f"the defrag fleet's utilisation floor "
             f"{first['utilization_min']} is under "
             f"{fleet.UTILIZATION_MIN_TARGET}")

    def stats(xs: list[float]) -> dict:
        return {"median": statistics.median(xs), "max": max(xs),
                "n": len(xs)}

    return {"nodes": len(spec["nodes"]), "runs": runs,
            "ticks_per_run": first["ticks"],
            "run_ms": [o["run_ms"] for o in outs],
            "defrag_step_ms": stats(
                [ms for o in outs for ms in o["defrag_ms"]]),
            "defrag_step_ms_propose_only": stats(
                first["propose_only"]["defrag_ms"]),
            "plan_cycle_ms_on": stats(
                [ms for o in outs for ms in o["plan_ms"]]),
            "plan_cycle_ms_off": stats(first["baseline"]["plan_ms"]),
            "scheduler_cycle_ms_on": stats(
                [ms for o in outs for ms in o["cycle_ms"]]),
            "scheduler_cycle_ms_off": stats(first["baseline"]["cycle_ms"]),
            "proposals": {"proposed": first["proposed"],
                          "applied": first["applied"],
                          "rejected": first["rejected"]},
            "propose_only": {k: first["propose_only"][k]
                             for k in ("proposed", "applied", "rejected")},
            "migrated_pods": first["migrated_pods"],
            "migrations_by_job_max": first["migrations_by_job_max"],
            "gpus_unlocked": first["gpus_unlocked"],
            "grows": first["grows"], "shrinks": first["shrinks"],
            "utilization_min": first["utilization_min"],
            "utilization_mean": first["utilization_mean"],
            "utilization_min_baseline":
                first["baseline"]["utilization_min"],
            "frag_stranded_gpu_s": frag,
            "frag_stranded_gpu_s_baseline": base,
            "frag_ratio": first["frag_ratio"],
            "frag_halving_held": DEFRAG_FRAG_HALVING_MET,
            "journal_identical": first["identical"],
            "decisions_compared": first["decisions"],
            "jobs_completed": first["jobs_completed"],
            "digest": fleet.plan_digest(first["summary"]),
            "waste": _waste_line(first["waste"])}


class _ElasticLoop(_QuotaLoop):
    """``_QuotaLoop`` at the gang phase's quotas with both reconcilers
    run once a loop pass (``resync``), on ``api`` (the REST stub's
    client) with ``watch`` feeding the recorder."""

    def __init__(self, device: dict, clock=time.monotonic,
                 wall=time.time, api=None, watch=None) -> None:
        super().__init__(device, clock, wall, quotas=ELASTIC_CARD_QUOTAS,
                         api=api, watch=watch, resync=True)

    def bind(self) -> int:
        """A pass's scheduler cycle; a pod its grow pass created gets its
        creation time here, at the end of the cycle that made it."""
        bound = super().bind()
        now = time.perf_counter()
        for name in self.pods():
            self.created.setdefault(name, now)
        return bound

    def create_member(self, name: str) -> None:
        from nos_tpu_torch.api import constants as C

        lo, hi = ELASTIC_BOUNDS
        ns, group, _ = ELASTIC_GANG
        self.create_pod(name, namespace=ns, gang=group, annotations={
            C.ANNOT_ELASTIC: C.ELASTIC_DP,
            C.ANNOT_MIN_REPLICAS: str(lo), C.ANNOT_MAX_REPLICAS: str(hi)})

    def stamps(self) -> dict:
        from nos_tpu_torch.api import constants as C

        return {n: p.metadata.annotations.get(C.ANNOT_DP_RESIZE)
                for n, p in self.pods().items()}

    def group(self) -> tuple[str, int]:
        from nos_tpu_torch.kube.client import KIND_POD_GROUP

        ns, group, _ = ELASTIC_GANG
        pg = self.api.get(KIND_POD_GROUP, group, ns)
        return pg.status.phase, pg.status.scheduled


def _elastic_events(loop: _ElasticLoop) -> tuple[dict, Callable]:
    """A pod watch on the loop's recorder feed noting, per pod, the
    scheduler cycle (its index in ``loop.cycle_ms``) and the host's
    performance counter of its bind, its deletion and each dp-resize
    stamp it gets; returns the notes and the unwatch."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.kube.client import KIND_POD

    seen: dict[str, tuple[int, float]] = {}

    def watch(event: str, pod) -> None:
        name = pod.metadata.name
        at = (len(loop.cycle_ms), time.perf_counter())
        if event == "DELETED":
            seen.setdefault(f"deleted {name}", at)
            return
        if pod.spec.node_name:
            seen.setdefault(f"bound {name}", at)
        stamp = pod.metadata.annotations.get(C.ANNOT_DP_RESIZE)
        if stamp:
            seen.setdefault(f"stamped {name} {stamp}", at)

    return seen, loop.watch(KIND_POD, watch)


def _elastic_start(device: dict, clock=time.monotonic, wall=time.time,
                   advance=None, poll_s: float = CARD_POLL_S, api=None,
                   watch=None) -> tuple[_ElasticLoop, dict]:
    """Phase (b) up to the children: team-a's elastic PodGroup (min 2,
    max 3 replicas) with its two members and a plain pod beside them,
    through the loop until the three are Running: one plan, the gang's
    members bound in one scheduler cycle, the PodGroup Scheduled 2."""
    from nos_tpu_torch.kube.client import KIND_POD_GROUP
    from nos_tpu_torch.testing.factory import make_pod_group

    loop = _ElasticLoop(device, clock, wall, api=api, watch=watch)
    ns, group, members = ELASTIC_GANG
    seen, unwatch = _elastic_events(loop)
    plans0 = _plans_total()
    loop.api.create(KIND_POD_GROUP, make_pod_group(group, ELASTIC_BOUNDS[0],
                                                   namespace=ns))
    for name in members:
        loop.create_member(name)
    loop.create_pod(ELASTIC_SINGLE, namespace=ns)
    want = sorted([*members, ELASTIC_SINGLE])
    bind_s = loop.run_until(lambda: loop.running() == want,
                            f"bind {group} and {ELASTIC_SINGLE} and run them",
                            poll_s=poll_s, advance=advance)
    unwatch()
    if loop.cycles != 1 or _plans_total() - plans0 != 1:
        fail(f"{loop.cycles} plan cycles ran for {want}, not one")
    cycles = {seen[f"bound {n}"][0] for n in members}
    if len(cycles) != 1:
        fail(f"{group}'s members were bound in cycles {sorted(cycles)}")
    if loop.group() != ("Scheduled", 2):
        fail(f"{group}'s PodGroup reads {loop.group()}, not Scheduled 2")
    return loop, {"bind_s": bind_s, "bound_in_cycle": cycles.pop(),
                  "plan_cycles": loop.cycles, "labels": loop.labels()}


def _elastic_grow(loop: _ElasticLoop, advance=None,
                  poll_s: float = CARD_POLL_S) -> dict:
    """Phase (b)'s grow: the plain pod has ended (the kubelet reports it
    Succeeded), its share left carved and free; a scheduler cycle's grow
    pass must create ELASTIC_GROWN (a GANG_RESIZED grow record naming
    it) and stamp dp-resize 3 on both members, and the clone must bind
    on the freed share with no new plan, the PodGroup Scheduled 3.
    Returns the release's, the stamps' and the bind's host times."""
    from nos_tpu_torch.kube.client import KIND_POD
    from nos_tpu_torch.obs import journal as J

    ns, group, members = ELASTIC_GANG
    seen, unwatch = _elastic_events(loop)
    plans0 = _plans_total()
    n0 = len(J.get_journal().events(J.GANG_RESIZED))
    loop.api.patch(KIND_POD, ELASTIC_SINGLE, ns,
                   mutate=lambda p: setattr(p.status, "phase", "Succeeded"))
    released = time.perf_counter()
    loop.run_until(lambda: ELASTIC_GROWN in loop.running(),
                   f"grow {group} into the freed share", poll_s=poll_s,
                   advance=advance)
    unwatch()
    grows = [r for r in J.get_journal().events(J.GANG_RESIZED)[n0:]]
    if [(r.subject, r.attrs.get("direction"), r.attrs.get("member"))
            for r in grows] != [(f"{ns}/{group}", "grow",
                                 f"{ns}/{ELASTIC_GROWN}")]:
        fail(f"the grow pass recorded {[r.attrs for r in grows]}, not one "
             f"grow of {group} by {ELASTIC_GROWN}")
    if _plans_total() != plans0:
        fail(f"a plan ran for {ELASTIC_GROWN}")
    stamps = loop.stamps()
    if [stamps[n] for n in members] != ["3", "3"] or stamps[ELASTIC_GROWN]:
        fail(f"the grow stamped {stamps}")
    if loop.group() != ("Scheduled", 3):
        fail(f"{group}'s PodGroup reads {loop.group()}, not Scheduled 3")
    stamped = max(seen[f"stamped {n} 3"][1] for n in members)
    bound = seen[f"bound {ELASTIC_GROWN}"]
    if bound[0] <= seen[f"stamped {members[0]} 3"][0]:
        fail(f"{ELASTIC_GROWN} bound in the cycle that grew it")
    return {"released": released, "stamped": stamped, "bound": bound[1],
            "grow_cycle": seen[f"stamped {members[0]} 3"][0],
            "bind_cycle": bound[0]}


def _elastic_shrink(loop: _ElasticLoop, advance=None,
                    poll_s: float = CARD_POLL_S) -> dict:
    """Phase (b)'s shrink: team-b's pod, within its min, arrives on a
    full card; a cycle must delete ELASTIC_VICTIM alone (the JAX
    package's choice), leave the PodGroup admitted and stamp dp-resize 2
    on the two survivors, and team-b's pod must bind on the freed share
    with no new plan.  Returns the survivors, the eviction's, the stamps'
    and the rebind's host times."""
    ns, group, members = ELASTIC_GANG
    b_ns, b_name = ELASTIC_PREEMPTOR
    seen, unwatch = _elastic_events(loop)
    plans0 = _plans_total()
    before = set(loop.pods())
    loop.create_pod(b_name, namespace=b_ns)
    loop.run_until(lambda: b_name in loop.running(),
                   f"bind {b_name} and run it", poll_s=poll_s,
                   advance=advance)
    unwatch()
    gone = sorted(before - set(loop.pods()))
    if gone != [ELASTIC_VICTIM]:
        fail(f"{b_name} evicted {gone}, not {ELASTIC_VICTIM} alone (the JAX "
             f"package's choice)")
    if _plans_total() != plans0:
        fail(f"a plan ran for {b_name}")
    survivors = [n for n in (*members, ELASTIC_GROWN) if n != ELASTIC_VICTIM]
    stamps = loop.stamps()
    if [stamps.get(n) for n in survivors] != ["2", "2"]:
        fail(f"the shrink stamped {stamps}")
    if loop.group()[0] != "Scheduled":
        fail(f"{group}'s PodGroup reads {loop.group()} after the shrink")
    return {"evicted": gone, "survivors": survivors,
            "evicted_at": seen[f"deleted {ELASTIC_VICTIM}"][1],
            "stamped": max(seen[f"stamped {n} 2"][1] for n in survivors),
            "rebound_at": seen[f"bound {b_name}"][1],
            "evict_cycle": seen[f"deleted {ELASTIC_VICTIM}"][0],
            "rebind_cycle": seen[f"bound {b_name}"][0],
            "group_after": list(loop.group()), "labels_after": loop.labels()}


def _elastic_child_check(label: str, child: dict, uuid: str,
                         start: int, resize: tuple[int, int] | None
                         ) -> dict:
    """A member's run that must end: exit 0, its grant verified, the
    steps from ``start`` + 1 logged, resumed at ``start`` when above 0,
    and (with ``resize`` (from, to)) left at its last landed checkpoint on
    the dp-resize stamp, else run to ELASTIC_STEPS.  Returns the step it
    left at and its launches by tile."""
    resumed = [int(m) for m in _RESUME_LINE.findall(child["stderr"])]
    if resumed != ([start] if start else []):
        fail(f"{label} resumed at {resumed}, not at {start}")
    left = _RESIZE_LINE.findall(child["stderr"])
    landed = [int(m) for m in _CKPT_LINE.findall(child["stderr"])]
    if resize is None:
        if left:
            fail(f"{label} left on a resize {left}")
        end = ELASTIC_STEPS
    else:
        if len(left) != 1 or (int(left[0][0]), int(left[0][1])) != resize \
                or not landed or int(left[0][2]) != max(landed):
            fail(f"{label} logged {left} with checkpoints {landed}, not a "
                 f"clean exit at its last checkpoint on the {resize} "
                 f"resize:\n{child['stderr'][-4000:]}")
        end = int(left[0][2])
    tiles = _check_recovery_child(label, child, uuid,
                                  list(range(start + 1, end + 1)))
    return {"left_at": end, "tiles": tiles}


def _elastic_stopped_check(label: str, child: dict, uuid: str,
                           start: int) -> None:
    """The shrink victim's run: stopped by SIGTERM, its grant verified on
    ``uuid`` at its fraction and cap when it started, finite steps from
    ``start`` + 1, resumed at ``start`` when above 0."""
    r = child["confined"]
    if child["rc"] != -signal.SIGTERM or r is None:
        fail(f"{label} exited {child['rc']}, confinement report {r}:\n"
             f"{child['stderr'][-4000:]}")
    if not (r["verified"] and r["devices"] == [uuid]
            and r["fraction"] == child["fraction"]
            and r["cap_bytes"] == child["cap_bytes"]):
        fail(f"{label} verified {r}, expected {uuid} at fraction "
             f"{child['fraction']}")
    resumed = [int(m) for m in _RESUME_LINE.findall(child["stderr"])]
    steps = child["steps"]
    if resumed != ([start] if start else []) or not steps \
            or steps[0][0] != start + 1 \
            or not all(math.isfinite(s[1]) for s in steps):
        fail(f"{label} resumed at {resumed} and logged {steps[:4]}, not "
             f"from step {start + 1}:\n{child['stderr'][-4000:]}")


def phase_elastic(main_loss0: float, device: dict, smi: str) -> dict:
    """Elastic gangs and the MIG defragmenter: (a) the defrag fleet on
    the host, beside a straight child of ELASTIC_STEPS split steps; (b)
    the card's node over the REST stub: an elastic gang grows into the
    share a finished pod left and gives back one replica to team-b, each
    member's child leaving at its checkpoint on a dp-resize stamp and
    restarted at the new replica count with no step lost, the survivors
    ending on the straight child's loss bitwise.  Returns the members'
    children's launches, by kernel and by tile."""
    from nos_tpu_torch.cmd.train import DP_REPLICAS_ENV
    from nos_tpu_torch.kube.rest import KubeClient, KubeConfig
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    split = {"NOS_TPU_FLASH_BWD": "split"}
    uuid, total = device["uuid"], device["memory_bytes"]
    ns, group, originals = ELASTIC_GANG
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    stub_mod = _load_stub()
    started: list[dict] = []
    # each member's runs, in order: [replicas, the child (started, then
    # finished)]; each run's exit time on the host's counter
    runs: dict[str, list[list]] = {}
    exited: dict[str, float] = {}
    waiters: list[threading.Thread] = []
    with stub_mod.StubApiServer() as stub, \
            tempfile.TemporaryDirectory(prefix="nos-elastic-") as tmp:
        cfg_path, no_nvcc = _grant_workdir(tmp)
        base = json.loads(pathlib.Path(cfg_path).read_text())
        straight_cfg = str(pathlib.Path(tmp) / "straight.json")
        pathlib.Path(straight_cfg).write_text(json.dumps(
            base | {"steps": ELASTIC_STEPS}))
        straight = _start_grant_child(
            "straight", straight_cfg,
            {"NOS_TPU_VISIBLE_CHIPS": uuid,
             "NOS_TPU_TIMESHARE_GB": str(CARD_SHARE_GB)} | split, no_nvcc)
        started.append(straight)
        fleet_line, _ = _host_result("defrag", "_defrag_fleet_runs")
        straight = _finish_grant_child(straight)
        kubeconfig = pathlib.Path(tmp) / "kubeconfig.json"
        kubeconfig.write_text(json.dumps({
            "current-context": "stub",
            "contexts": [{"name": "stub",
                          "context": {"cluster": "stub", "user": "smoke"}}],
            "clusters": [{"name": "stub",
                          "cluster": {"server": stub.url}}],
            "users": [{"name": "smoke", "user": {}}]}))
        job_cfg = {}
        for name in (*originals, ELASTIC_GROWN):
            job_cfg[name] = str(pathlib.Path(tmp) / f"{name}.json")
            pathlib.Path(job_cfg[name]).write_text(json.dumps(base | {
                "steps": ELASTIC_STEPS, "checkpoint_every": 1,
                "checkpoint_dir": str(pathlib.Path(tmp) / f"ck-{name}"),
                "kubeconfig": str(kubeconfig)}))

        def run(name: str, grant: dict, replicas: int) -> None:
            """Start the member's next run at ``replicas``."""
            seq = len(runs.setdefault(name, []))
            child = _start_grant_child(
                f"{name}-run{seq + 1}", job_cfg[name],
                grant | split | {"POD_NAME": name, "POD_NAMESPACE": ns,
                                 DP_REPLICAS_ENV: str(replicas)}, no_nvcc)
            started.append(child)
            runs[name].append([replicas, child])

            def note_exit(proc=child["proc"], case=child["case"]) -> None:
                proc.wait()
                exited[case] = time.perf_counter()

            waiters.append(threading.Thread(target=note_exit, daemon=True))
            waiters[-1].start()

        def finish(name: str) -> None:
            runs[name][-1][1] = _finish_grant_child(runs[name][-1][1])

        def current(name: str) -> dict:
            return runs[name][-1][1]

        client = KubeClient(KubeConfig(server=stub.url))
        tap = _StubTap(stub)
        loop = None
        try:
            loop, card = _elastic_start(device, api=client, watch=tap.watch)
            grants = {g["pod"]: g["env"] for g in _grants(
                loop, device, [*originals, ELASTIC_SINGLE])}
            for name in originals:
                run(name, grants[name], ELASTIC_BOUNDS[0])
            single = _start_grant_child(ELASTIC_SINGLE, cfg_path,
                                        grants[ELASTIC_SINGLE], no_nvcc)
            started.append(single)
            single = _finish_grant_child(single)
            grow = _elastic_grow(loop)
            (g,) = _grants(loop, device, [ELASTIC_GROWN])
            grants[ELASTIC_GROWN] = g["env"]
            run(ELASTIC_GROWN, grants[ELASTIC_GROWN], ELASTIC_BOUNDS[1])
            for name in originals:
                finish(name)
                run(name, grants[name], ELASTIC_BOUNDS[1])
            members = [*originals, ELASTIC_GROWN]
            t1 = time.monotonic()
            while not all(_STEP_LINE.search("".join(current(n)["lines"]))
                          for n in members):
                if time.monotonic() - t1 > QUOTA_FIRST_STEP_LIMIT_S or any(
                        current(n)["proc"].poll() is not None
                        for n in members):
                    fail("an elastic child exited or logged no step within "
                         f"{QUOTA_FIRST_STEP_LIMIT_S} s of its start")
                time.sleep(0.1)
            shrink = _elastic_shrink(loop)
            (stop_s,) = _stop_children([current(ELASTIC_VICTIM)])
            stopped_at = time.perf_counter()
            finish(ELASTIC_VICTIM)
            (b_grant,) = _grants(loop, device, [ELASTIC_PREEMPTOR[1]])
            team_b = _start_grant_child(ELASTIC_PREEMPTOR[1], cfg_path,
                                        b_grant["env"], no_nvcc)
            started.append(team_b)
            for name in shrink["survivors"]:
                finish(name)
                run(name, grants[name], ELASTIC_BOUNDS[0])
            for name in shrink["survivors"]:
                finish(name)
            team_b = _finish_grant_child(team_b)
            for w in waiters:
                w.join()
        finally:
            if loop is not None:
                loop.sched.close()
            client.close()
            for c in started:
                if c.get("proc") is not None and c["proc"].poll() is None:
                    c["proc"].kill()
                    c["proc"].wait()
        if tap.errors:
            fail(f"the stub tap's callbacks raised: {tap.errors}")
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"an elastic child built kernels: {kernels_before} -> "
             f"{kernels_after}")
    children = [straight, single, team_b,
                *[c for n in runs for _, c in runs[n]]]
    for child in children:
        child["fraction"], child["cap_bytes"] = _grant_cap(CARD_SHARE_GB,
                                                           total)
    _check_recovery_child("elastic straight", straight, uuid,
                          list(range(1, ELASTIC_STEPS + 1)))
    (want,) = _EXACT_LOSS.findall(straight["stderr"])
    rel = abs(straight["steps"][0][1] - main_loss0) / abs(main_loss0)
    if not rel <= MAIN_LOSS0_RTOL:
        fail(f"the straight child's step-0 loss {straight['steps'][0][1]} "
             f"against train_main's {main_loss0}")
    _check_granted_child(f"elastic {ELASTIC_SINGLE}", single, uuid,
                         main_loss0)
    _check_granted_child(f"elastic {ELASTIC_PREEMPTOR[1]}", team_b, uuid,
                         main_loss0)
    tiles: dict[str, int] = {name: 0 for name in TILES}
    members_line = {}
    for name, chain in runs.items():
        start, left, lost, stamp_to_exit = 0, [], [], []
        stamps = [grow["stamped"], shrink["stamped"]]
        for i, (replicas, child) in enumerate(chain):
            label = f"elastic {child['case']}"
            nxt = chain[i + 1][0] if i + 1 < len(chain) else None
            if name == ELASTIC_VICTIM and i == len(chain) - 1:
                _elastic_stopped_check(label, child, uuid, start)
                continue
            checked = _elastic_child_check(
                label, child, uuid, start,
                None if nxt is None else (replicas, nxt))
            for tile, k in checked["tiles"].items():
                tiles[tile] += k
            if nxt is not None:
                left.append(checked["left_at"])
                lost.append(max(s[0] for s in child["steps"])
                            - checked["left_at"])
                stamp = stamps[0] if (replicas, nxt) == tuple(
                    ELASTIC_BOUNDS) else stamps[1]
                stamp_to_exit.append(exited[child["case"]] - stamp)
            start = checked["left_at"]
        if lost != [0] * len(lost):
            fail(f"{name} lost {lost} steps at its restarts")
        entry = {"runs": [[r, c["case"]] for r, c in chain],
                 "left_at": left, "steps_lost": lost,
                 "stamp_to_exit_s": stamp_to_exit,
                 "walls_s": [c["wall_s"] for _, c in chain]}
        if name != ELASTIC_VICTIM:
            exact = _EXACT_LOSS.findall(chain[-1][1]["stderr"])
            if exact != [want]:
                fail(f"{name} ended on loss {exact}, the straight run on "
                     f"{want}: not bitwise equal")
            entry["final_loss_exact"] = exact[0]
        members_line[name] = entry
    if loop.writes != ELASTIC_LOOP_WRITES:
        fail(f"the elastic loop's writes differ from the CPU test's: "
             f"{json.dumps(loop.writes)}")
    launches = {k: sum(n for name, n in tiles.items() if TILES[name][0] == k)
                for k in ("flash_fwd", "flash_bwd_fused", "flash_dq",
                          "flash_dkv")}
    card |= {
        "substrate": "rest (tests/k8s_stub.py)", "node": CARD_NODE,
        "quotas": [list(q) for q in ELASTIC_CARD_QUOTAS],
        "share_gb": CARD_SHARE_GB, "bounds": list(ELASTIC_BOUNDS),
        "steps": ELASTIC_STEPS,
        "bind_ms": dict(sorted(loop.bound_ms.items())),
        "release_to_grown_bound_ms": (grow["bound"] - grow["released"])
        * 1e3,
        "grow_stamp_to_bound_ms": (grow["bound"] - grow["stamped"]) * 1e3,
        "grow_cycle": grow["grow_cycle"],
        "grown_bind_cycle": grow["bind_cycle"],
        "evicted": shrink["evicted"], "survivors": shrink["survivors"],
        "evict_cycle": shrink["evict_cycle"],
        "rebind_cycle": shrink["rebind_cycle"],
        "evict_to_rebind_ms": (shrink["rebound_at"] - shrink["evicted_at"])
        * 1e3,
        "evict_to_child_stopped_ms": (stopped_at - shrink["evicted_at"])
        * 1e3,
        "sigterm_to_exit_s": stop_s, "group_after": shrink["group_after"],
        "labels_after": shrink["labels_after"], "members": members_line,
        "straight_wall_s": straight["wall_s"], "final_loss_exact": want,
        "loss0_rel_diff": rel,
        "cycle_ms_median": statistics.median(loop.cycle_ms),
        "cycle_ms_max": max(loop.cycle_ms), "cycles": len(loop.cycle_ms),
        "step_ms_median": statistics.median(loop.step_ms),
        "passes": len(loop.step_ms)}
    emit({"phase": "elastic", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0, "fleet": fleet_line,
          "card": card, "main_loss0": main_loss0, "launches": launches,
          "tile_launches": tiles,
          "children": [{k: v for k, v in ch.items()
                        if k not in ("stderr", "report", "confined",
                                     "stamps", "steps")}
                       | {"steps_logged": len(ch["steps"])}
                       for ch in children]})
    PATH_TILES["elastic"] = tiles
    return launches


# The serving phase.  (a) The serving fleets (testing/fleet.py:
# bench_serving.py's run mapped onto H100 nodes, with the request router
# off and on) on the host.  (b) The card's node over the REST stub with
# the mains as processes and the replica autoscaler's main: the request
# router, a process of its own on a virtual clock, scales the serving
# replicas by their KV pressure, and each replica's child serves
# BENCH_350M through ``generate`` under its grant.
# fleet.plan_digest of each fleet's summary: the JAX package's runs of
# the mapped trace (tests/test_torch_serving.py, test_torch_requests.py)
SERVING_FLEET_DIGEST = \
    "193a87846c9a1b61e5348f6b31f53b98f401e47691168f6f00fa936fa1e9cf65"
REQUEST_FLEET_DIGEST = \
    "777d8d9b188c7f8fbd1f5cea72baf6f51387798d3795634f18554f9bb6f01f2f"
# the benches' invariants the JAX package's runs of the mapped trace
# meet (the CPU tests hold these to JAX's runs): the smoke holds every
# one met and reports the others
SERVING_FLEET_MET = {"no_serving_victim": True,
                     "replicas_track_within_one": True,
                     "serving_schedule_p99_under_100ms": True}
REQUEST_FLEET_MET = SERVING_FLEET_MET | {
    "request_p99_under_10s": True, "decode_occupancy_under_ceiling": True}
SERVING_FLEET_RUNS = 2
SERVING_ROUTER_WORKERS = (0, 4)


def serving_invariants(out: dict) -> dict[str, bool]:
    """bench_serving.py's and bench_requests.py's invariants on one
    serving fleet run, in virtual time: no serving pod a preemption
    victim; every service's replicas within one of clamp(ceil(load /
    target)) in SERVING_TRACK_WITHIN of the samples past the warm-up; the
    serving binds' schedule latency p99 under SERVING_P99_TARGET_S; with
    the router, every service's request p99 (phase total) under
    REQUEST_P99_TARGET_S and chat's mean decode occupancy under
    SERVING_OCC_CEILING in SERVING_OCC_WITHIN of the samples.  A figure
    with no sample misses its invariant."""
    from nos_tpu_torch.testing import fleet

    serving = out["serving"]
    met = {
        "no_serving_victim": serving["preempted"] == 0,
        "replicas_track_within_one": all(
            t["within_one"] is not None
            and t["within_one"] >= fleet.SERVING_TRACK_WITHIN
            for t in serving["tracking"].values()),
        "serving_schedule_p99_under_100ms": serving["p99_ms"] is not None
        and serving["p99_ms"] < fleet.SERVING_P99_TARGET_S * 1e3}
    if "requests" in out:
        rows = out["requests"]
        met["request_p99_under_10s"] = all(
            r["p99_s"] is not None and r["p99_s"] < fleet.REQUEST_P99_TARGET_S
            for r in rows.values())
        occ = rows["serve/chat"]["occupancy_under_ceiling"]
        met["decode_occupancy_under_ceiling"] = occ is not None \
            and occ >= fleet.SERVING_OCC_WITHIN
    return met


def _serving_fleet_runs(router: bool, runs: int = SERVING_FLEET_RUNS,
                        workers: tuple[int, ...] = SERVING_ROUTER_WORKERS
                        ) -> dict:
    """One serving fleet ``runs`` times on the port (``router``: at each
    of SERVING_ROUTER_WORKERS router workers, one run each): every run
    must hash to its pinned digest (the JAX package's run of the mapped
    trace), conserve its waste waterfall and meet every invariant the
    JAX run meets; with the router, the journals must be byte-identical
    across the worker counts.  The line: host ms per router tick (at each
    worker count), autoscaler reconcile and scheduler cycle (median,
    max); requests completed and shed, scale events by direction, the
    phases' p50 and p99 and the utilisation floor."""
    from nos_tpu_torch.testing import fleet

    want = REQUEST_FLEET_DIGEST if router else SERVING_FLEET_DIGEST
    met_want = REQUEST_FLEET_MET if router else SERVING_FLEET_MET
    name = "request" if router else "serving"
    spec = fleet.serving_fleet_spec(0, router=router)
    workers = workers[:runs] if router else (0,) * runs
    outs = []
    for w in workers:
        t0 = time.perf_counter()
        out = fleet.run_serving_fleet(spec, workers=w)
        out["run_ms"] = (time.perf_counter() - t0) * 1e3
        out["workers"] = w
        outs.append(out)
    for out in outs:
        digest = fleet.plan_digest(out["summary"])
        if digest != want:
            fail(f"the {name} fleet at {out['workers']} router workers "
                 f"hashes to {digest}, not the pinned {want} (the JAX "
                 f"package's run on the CPU)")
        met = serving_invariants(out)
        missed = [k for k, ok in met.items() if met_want.get(k) and not ok]
        if missed:
            fail(f"the {name} fleet missed {missed}, which the JAX "
                 f"package's run meets: {met}")
    if len({json.dumps(o["journal"]) for o in outs}) != 1:
        fail(f"the {name} fleet's journals differ across router workers "
             f"{[o['workers'] for o in outs]}")

    def stats(xs: list[float]) -> dict:
        return {"median": statistics.median(xs), "max": max(xs),
                "n": len(xs)} if xs else None

    first = outs[0]
    line = {"router": router, "runs": len(outs),
            "ticks_per_run": first["ticks"],
            "run_ms": [o["run_ms"] for o in outs],
            "autoscaler_reconcile_ms": stats(
                [ms for o in outs for ms in o["reconcile_ms"]]),
            "scheduler_cycle_ms": stats(
                [ms for o in outs for ms in o["cycle_ms"]]),
            "scale_events": first["scale_events"],
            "serving_binds": first["serving"]["binds"],
            "serving_schedule_p50_ms": first["serving"]["p50_ms"],
            "serving_schedule_p99_ms": first["serving"]["p99_ms"],
            "tracking": first["serving"]["tracking"],
            "preemptions": first["batch"]["preemptions"],
            "jobs_completed": first["batch"]["jobs_completed"],
            "utilization_pct": first["utilization_pct"],
            "utilization_min": first["utilization_min"],
            "invariants": serving_invariants(first),
            "invariants_held": sorted(k for k, v in met_want.items() if v),
            "journal_records": len(first["journal"]),
            "journal_digest": fleet.plan_digest(first["journal"]),
            "digest": fleet.plan_digest(first["summary"]),
            "waste": _waste_line(first["waste"])}
    if router:
        line["router_tick_ms"] = {str(o["workers"]): stats(o["router_ms"])
                                  for o in outs}
        line["journal_identical_across_workers"] = True
        line["requests"] = first["requests"]
    return line


def _serving_fleets() -> dict:
    """(a) whole: the router off, then on."""
    return {"serving": _serving_fleet_runs(router=False),
            "request": _serving_fleet_runs(router=True)}


# (b): the card's node over the REST stub.  The mains of phase 14 (one
# partitioner) and the replica autoscaler's main as processes; the
# request router a process of its own on a virtual clock the smoke
# advances one publish period at a time; the replicas' children serve
# BENCH_350M through ``generate`` under their grants.
SERVING_MAINS = ("partitioner-0", "scheduler", "operator", "chipagent")
SERVING_AUTOSCALER = "autoscaler"
# the mins sum to the card's 80 GB (the benches' rule: borrowing spends
# real headroom); serve's holds two replicas, filler's one of its two
# pods, so the second borrows and is reclaimable
SERVING_CARD_QUOTAS = (("serve", 48.0, 0.0), ("filler", 32.0, 0.0))
# two best-effort fillers beside the first replica: the one plan that
# carves the card for the three pending pods cuts three 24 GB shares,
# and the scale-up finds none free
SERVING_FILLERS = ("filler-0", "filler-1")
# the partitioner's batch window: the first replica and both fillers,
# created within a few ms, land in one plan
SERVING_BATCH_IDLE_S = 1.0
SERVING_SERVICE = {"name": "chat", "namespace": "serve",
                   "timeshare_gb": CARD_SHARE_GB, "min_replicas": 1,
                   "max_replicas": 2, "target_load_per_replica": 0.4,
                   "scale_up_cooldown_s": 0.5, "scale_down_cooldown_s": 3.0,
                   "down_hysteresis": 0.2}
# the autoscaler main's reconcile interval; the story holds the main's
# lists at the stub while the router publishes (``_ClientGate``, which
# tells its requests apart by this bearer token), so no reconcile reads a
# publish half written
SERVING_RECONCILE_S = 0.25
SERVING_AUTOSCALER_TOKEN = "serving-autoscaler"
SERVING_TICK_S = 0.05
SERVING_PUBLISH_TICKS = 5
# the burst's requests: the serve phase's prompt, 512 tokens out, each a
# session of its own.  Little's law on the cost model: the streams whose
# reserved KV is twice the autoscaler's target, their service time (the
# decode step at their resident KV), and the rate that keeps them in
# flight; at that occupancy the replica decodes near its bandwidth, so
# its queue fills slowly at that rate, and the burst offers
# SERVING_BURST_FACTOR times it for one service time
SERVING_PROMPT, SERVING_OUTPUT = 448, 512
SERVING_BURST_FACTOR = 2.0
SERVING_SESSION_IDLE_S = 1.0
SERVING_SEED = 0
SERVING_PERIODS_MAX = 200
SERVING_STEP_LIMIT_S = 30.0
SERVING_ROUTER_TIMEOUT_S = 60.0
# the JAX package's choices on the same story (tests/test_torch_cmd.py):
# the filler the scale-up evicts, the replica the scale-down deletes
SERVING_FILLER_VICTIM = "filler-1"
SERVING_VICTIM = "chat-r1"
# each replica child's batches: the serve phase's 8 x 448 prompts and
# SERVING_GENERATE_STEPS greedy steps a batch
SERVING_GENERATE_STEPS = 16
SERVING_FIRST_BATCH_LIMIT_S = 300.0
_BATCH_LINE = re.compile(r"^serve batch (\{.*\})$", re.M)
# What phase 16 (b)'s loop writes (``serving_writes``), pinned by
# tests/test_torch_cmd.py: the port's processes on the CPU and the JAX
# package's mains, autoscaler and router on its stand-in over the stub,
# names mapped, write the same.
SERVING_LOOP_WRITES = {
    "configmap": {"h100-node-0.plan-1": json.dumps({
        "version": "v1", "sharing": {"mps": {
            "failRequestsGreaterThanOne": True, "resources": [{
                "name": "nvidia.com/gpu", "rename": "nvidia.com/gpu-24gb",
                "memoryGB": 24, "replicas": 3, "devices": ["0"]}]}}})},
    "node": {"annotations": {
        "nos.nebuly.com/agent-heartbeat.mps": "<beat>",
        "nos.nebuly.com/device-plugin-applied-config": "h100-node-0.plan-1",
        "nos.nebuly.com/device-plugin-generation": "1",
        "nos.nebuly.com/spec-partitioning-plan.mps": "plan-1",
        "nos.nebuly.com/status-gpu-0-24gb-free": "1",
        "nos.nebuly.com/status-gpu-0-24gb-used": "2",
        "nos.nebuly.com/status-partitioning-plan.mps": "plan-1"},
        "plan_label": "plan-1"},
    'pods': {'chat-r0': {'deleted': False,
                         'node': ['', 'h100-node-0'],
                         'phase': ['Pending', 'Running'],
                         'load': ['0', '0.000', '0.021', '0.139', '0.259',
                                  '0.394', '0.490', '0.589', '0.619', '0.601',
                                  '0.573', '0.518', '0.488', '0.501', '0.479',
                                  '0.295', '0.205', '0.197', '0.000'],
                         'sessions': [None, '0', '11', '74', '152', '221',
                                      '292', '306', '241', '173', '91', '29',
                                      '32', '79', '108', '105', '78', '30',
                                      '14', '0'],
                         'capacity': [None, 'in-quota'],
                         'tier': ['serving'],
                         'service': ['chat']},
             'chat-r1': {'deleted': True,
                         'node': ['', 'h100-node-0'],
                         'phase': ['Pending', 'Running'],
                         'load': ['0', '0.000', '0.150', '0.257', '0.359',
                                  '0.473', '0.509', '0.535', '0.509', '0.456',
                                  '0.420', '0.327', '0.135'],
                         'sessions': [None, '1', '80', '137', '207', '268',
                                      '255', '228', '176', '99', '48', '18',
                                      '0'],
                         'capacity': [None, 'in-quota'],
                         'tier': ['serving'],
                         'service': ['chat']},
             'filler-0': {'deleted': False,
                          'node': ['', 'h100-node-0'],
                          'phase': ['Pending', 'Running'],
                          'load': [None],
                          'sessions': [None],
                          'capacity': [None, 'in-quota'],
                          'tier': ['best-effort'],
                          'service': [None]},
             'filler-1': {'deleted': True,
                          'node': ['', 'h100-node-0'],
                          'phase': ['Pending', 'Running'],
                          'load': [None],
                          'sessions': [None],
                          'capacity': [None, 'over-quota'],
                          'tier': ['best-effort'],
                          'service': [None]}},
    'quotas': {'filler': {'nos.nebuly.com/gpu-memory': 24.0},
               'serve': {'nos.nebuly.com/gpu-memory': 24.0}},
    'status': [{'serve/chat': {'desired': 1.0,
                               'load': 0,
                               'replicas': 0.0,
                               'scaled': 1.0}},
               {'serve/chat': {'desired': 1.0,
                               'load': 0.0,
                               'replicas': 1.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 1.0,
                               'load': 0.021,
                               'replicas': 1.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 1.0,
                               'load': 0.139,
                               'replicas': 1.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 1.0,
                               'load': 0.259,
                               'replicas': 1.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 1.0,
                               'load': 0.394,
                               'replicas': 1.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 0.49,
                               'replicas': 1.0,
                               'scaled': 1.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 0.49,
                               'replicas': 2.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 0.589,
                               'replicas': 2.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 0.769,
                               'replicas': 2.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 0.858,
                               'replicas': 2.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 0.932,
                               'replicas': 2.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 0.991,
                               'replicas': 2.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 0.997,
                               'replicas': 2.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 1.036,
                               'replicas': 2.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 0.988,
                               'replicas': 2.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 0.751,
                               'replicas': 2.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 0.625,
                               'replicas': 2.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 2.0,
                               'load': 0.524,
                               'replicas': 2.0,
                               'scaled': 0.0}},
               {'serve/chat': {'desired': 1.0,
                               'load': 0.135,
                               'replicas': 2.0,
                               'scaled': -1.0}},
               {'serve/chat': {'desired': 1.0,
                               'load': 0.0,
                               'replicas': 1.0,
                               'scaled': 0.0}}]}


def _bench350m_weights_gb() -> float:
    """BENCH_350M's parameters in bf16, GB (2**30 bytes), as the cost
    model counts weights."""
    from nos_tpu_torch.models.llama import BENCH_350M, Llama

    model = Llama(dataclasses.replace(BENCH_350M, param_dtype=torch.bfloat16),
                  device=torch.device("meta"))
    return sum(p.numel() for p in model.parameters()) * 2 / 2**30


def serving_router_service(card: str, weights_gb: float) -> dict:
    """The router's service (a RouterService mapping): chat aggregated,
    priced honestly: BENCH_350M's widths and bf16 weights, the card's
    name, a 24 GB MPS share."""
    from nos_tpu_torch.models.llama import BENCH_350M as B

    return {"name": "chat", "namespace": "serve",
            "model": {"name": "bench-350m", "num_layers": B.num_layers,
                      "num_heads": B.num_heads, "num_kv_heads": B.num_kv_heads,
                      "head_dim": B.head_dim,
                      "intermediate_size": B.intermediate_size,
                      "vocab_size": B.vocab_size, "weights_gb": weights_gb},
            "prefill": {"device_kind": card, "hbm_gb": float(CARD_SHARE_GB)},
            "session_idle_s": SERVING_SESSION_IDLE_S}


def serving_burst(costs) -> dict:
    """The burst from the cost model: the concurrent streams whose
    reserved KV (each reserves its prompt and output ahead) is twice the
    autoscaler's target of one replica's, their service time (the
    prompt's prefill and SERVING_OUTPUT decode steps at half their output
    resident: Little's law on ``decode_step_seconds``), the rate that
    keeps them in flight, and the burst: SERVING_BURST_FACTOR times that
    rate for one service time."""
    tokens = SERVING_PROMPT + SERVING_OUTPUT
    load = 2 * SERVING_SERVICE["target_load_per_replica"]
    streams = math.ceil(load * costs.kv_capacity_tokens() / tokens)
    resident = streams * (SERVING_PROMPT + SERVING_OUTPUT // 2)
    service_s = (costs.prefill_seconds(SERVING_PROMPT) + SERVING_OUTPUT
                 * costs.decode_step_seconds(resident))
    little = streams / service_s
    return {"streams": streams, "service_s": service_s,
            "little_rate": little, "rate": SERVING_BURST_FACTOR * little,
            "duration_s": service_s}


class _RouterDriver:
    """Phase 16 (b)'s request router on one package (``R`` its
    ``requests``, ``sim`` its ``sim``, ``api`` its client): the
    ServingRouter on a SimEngine's clock, ticked every SERVING_TICK_S of
    virtual time; ``advance`` runs exactly SERVING_PUBLISH_TICKS ticks
    (one publish), ``burst`` installs the seeded arrivals."""

    def __init__(self, R, sim, api, service: dict, workers: int = 0) -> None:
        self.R, self.sim, self.api = R, sim, api
        self.eng = sim.SimEngine()
        svc = R.RouterService.from_mapping(service)
        self.key = svc.key
        self.costs = svc.prefill_costs
        self.router = R.ServingRouter(
            api, [svc], clock=self.eng.now, workers=workers,
            publish_every_ticks=SERVING_PUBLISH_TICKS)
        self.ticks = 0
        self.rid = 0
        self.burst_end = None
        self.eng.tick_loop(SERVING_TICK_S, self._tick, until=1e9,
                           label="router-tick")

    def _tick(self) -> None:
        self.ticks += 1
        self.router.tick(SERVING_TICK_S)

    def _arrive(self, t: float) -> None:
        self.rid += 1
        self.router.submit(self.key, self.R.Request(
            "chat", f"chat-q{self.rid}", f"chat-s{self.rid}", SERVING_PROMPT,
            SERVING_OUTPUT, t))

    def burst(self) -> dict:
        plan = serving_burst(self.costs)
        start = self.eng.now()
        self.burst_end = start + plan["duration_s"]
        rate = plan["rate"]
        self.sim.ArrivalSource(
            SERVING_SEED, lambda t: rate, self._arrive, peak_rate=rate,
            until=self.burst_end, label="burst").install(self.eng)
        return plan | {"start": start, "end": self.burst_end}

    def advance(self) -> dict:
        target = self.ticks + SERVING_PUBLISH_TICKS
        while self.ticks < target:
            self.eng.step()
        return self.report()

    def report(self) -> dict:
        occ = self.router.kv_occupancies(self.key)
        state = self.router._states[self.key]
        replicas = {}
        for name in sorted(state.prefill.replicas):
            r = state.prefill.replicas[name]
            replicas[name] = {"occupancy": occ[name],
                              "in_flight": r.in_flight()}
        return {"t": self.eng.now(), "ticks": self.ticks,
                "replicas": replicas,
                "sessions": self.router.session_count(self.key),
                "stats": self.router.stats()[self.key],
                "burst_over": self.burst_end is not None
                and self.eng.now() >= self.burst_end}


def _router_child() -> None:
    """The router process: ``python -c "import chip_smoke;
    chip_smoke._router_child()" KUBECONFIG SERVICE_JSON``; one JSON line
    on stdout per command read from stdin (``burst``, ``advance``,
    ``quit``)."""
    from nos_tpu_torch import requests as R, sim
    from nos_tpu_torch.kube.rest import KubeClient

    api = KubeClient.from_kubeconfig(sys.argv[1])
    service = json.loads(pathlib.Path(sys.argv[2]).read_text())
    driver = _RouterDriver(R, sim, api, service)
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "quit":
            break
        out = driver.burst() if cmd == "burst" else driver.advance()
        print(json.dumps(out), flush=True)
    api.close()


def _serve_child() -> None:
    """A replica's child: the grant applied before CUDA starts and
    verified once it is up (the training main's sequence), BENCH_350M at
    full width with flash attention, then ``generate`` on the serve
    phase's 8 x 448 prompts, SERVING_GENERATE_STEPS steps a batch, until
    SIGTERM; after each batch a ``serve batch {json}`` line: its host
    clock window, ms per forward and the launches so far."""
    from nos_tpu_torch.cmd.train import grant_report
    from nos_tpu_torch.device import workload_env
    from nos_tpu_torch.entry import bench_model, serve_prompt
    from nos_tpu_torch.models.generate import generate

    logging.basicConfig(
        level=logging.INFO, stream=sys.stderr,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    log = logging.getLogger("serve-child")
    workload_env.apply()
    verified = workload_env.validate_confinement()
    log.info("confined: grant %s", json.dumps(grant_report(verified)))
    model = bench_model(device="cuda")
    prompt = serve_prompt("cuda")
    batch = 0
    while True:
        batch += 1
        t0 = time.time()
        out = generate(model, prompt, SERVING_GENERATE_STEPS)
        torch.cuda.synchronize()
        t1 = time.time()
        if not ((out >= 0) & (out < model.cfg.vocab_size)).all():
            log.error("tokens outside the vocabulary")
            sys.exit(1)
        report = grant_report(verified)
        print("serve batch " + json.dumps({
            "batch": batch, "t0": t0, "t1": t1,
            "ms_per_forward": (t1 - t0) * 1e3 / SERVING_GENERATE_STEPS,
            "launches": report["launches"],
            "tile_launches": report["tile_launches"],
            "max_memory_allocated": report["max_memory_allocated"]}),
            file=sys.stderr, flush=True)


def serving_record(kind: str, event: str, obj, C) -> tuple | None:
    """A stub commit as phase 16's recorder keeps it, under the names of
    the package whose constants ``C`` are: (kind, event, key, fields)."""
    meta = obj.metadata
    if kind == "Pod":
        a, lab = meta.annotations, meta.labels
        return ("Pod", event, meta.name, {
            "node": obj.spec.node_name, "phase": obj.status.phase,
            "load": a.get(C.ANNOT_SERVING_LOAD),
            "sessions": a.get(C.ANNOT_SERVING_SESSIONS),
            "capacity": lab.get(C.LABEL_CAPACITY),
            "tier": lab.get(C.LABEL_TIER),
            "service": lab.get(C.LABEL_SERVICE)})
    if kind == "ConfigMap":
        return ("ConfigMap", event, f"{meta.namespace}/{meta.name}",
                dict(obj.data))
    if kind == "ElasticQuota":
        return ("ElasticQuota", event, meta.namespace,
                dict(sorted(obj.status.used.items())))
    return ("Node", event, meta.name, {
        "annotations": dict(meta.annotations),
        "labels": dict(meta.labels)})


def serving_writes(records: list[tuple], plans: list[str], beat: str,
                   plugin_cm: str, status_cm: str) -> dict:
    """What phase 16 (b)'s loop wrote, from its recorder's commits in
    the port's names: the node's final annotations and plan label and the
    plugin ConfigMap's final data (plan ids read plan-<n> in order of
    appearance, the heartbeat <beat>); for each pod, each field's
    distinct values in commit order (its node, phase, load and session
    annotations, capacity, tier and service labels) and whether it was
    deleted; each quota's final status.used; the autoscaler's status
    ConfigMap's distinct data in commit order."""
    def mask(s: str) -> str:
        for i, plan in enumerate(plans, 1):
            s = s.replace(plan, f"plan-{i}")
        return s

    pods: dict[str, dict] = {}
    node: dict = {}
    cms: dict[str, dict] = {}
    status: list[dict] = []
    quotas: dict[str, dict] = {}
    for kind, event, key, fields in records:
        if kind == "Pod":
            row = pods.setdefault(key, {"deleted": False})
            if event == "DELETED":
                row["deleted"] = True
                continue
            for field, value in fields.items():
                seq = row.setdefault(field, [])
                if not seq or seq[-1] != value:
                    seq.append(value)
        elif kind == "Node":
            node = fields
        elif kind == "ConfigMap":
            if key == status_cm:
                data = {k: json.loads(v) for k, v in sorted(fields.items())}
                if not status or status[-1] != data:
                    status.append(data)
            else:
                cms[key] = fields
        elif kind == "ElasticQuota":
            quotas[key] = fields
    annots = {mask(k): "<beat>" if k == beat else mask(v)
              for k, v in sorted(node.get("annotations", {}).items())}
    return {"node": {"annotations": annots,
                     "plan_label": mask(node.get("labels", {}).get(
                         "nos.nebuly.com/device-plugin.config", ""))},
            "configmap": {mask(k): mask(v) if isinstance(v, str) else v
                          for k, v in sorted(cms.get(plugin_cm, {}).items())},
            "pods": dict(sorted(pods.items())),
            "quotas": dict(sorted(quotas.items())),
            "status": status}


class _ClientGate:
    """Holds one client's requests of one HTTP method at the REST stub,
    those bearing ``token`` (watches pass), while ``held``: a request
    already being served ends first, later ones wait, parked, until the
    hold ends.  It wraps the handler class of this one stub.  The serving
    story holds the autoscaler's lists while the router publishes (two
    patches a publish, one list a reconcile: no reconcile reads one stamp
    of the two), and its create of the first replica until the fillers
    exist (the three reach the partitioner within one batch window, so in
    one plan, however slow the host)."""

    def __init__(self, stub, token: str, method: str) -> None:
        self._cv = threading.Condition()
        self._closed = False
        self._serving = 0
        self.parked: list[str] = []
        header = f"Bearer {token}"
        base = stub.httpd.RequestHandlerClass
        serve = getattr(base, f"do_{method}")

        def handle(handler) -> None:
            if handler.headers.get("Authorization") != header \
                    or "watch=" in handler.path:
                serve(handler)
                return
            with self._cv:
                if self._closed:
                    self.parked.append(handler.path)
                    self._cv.notify_all()
                    while self._closed:
                        self._cv.wait()
                    self.parked.remove(handler.path)
                self._serving += 1
            try:
                serve(handler)
            finally:
                with self._cv:
                    self._serving -= 1
                    self._cv.notify_all()

        stub.httpd.RequestHandlerClass = type(
            "GatedHandler", (base,), {f"do_{method}": handle})

    @contextlib.contextmanager
    def held(self):
        with self._cv:
            self._closed = True
            while self._serving:
                self._cv.wait()
        try:
            yield
        finally:
            with self._cv:
                self._closed = False
                self._cv.notify_all()

    def wait_parked(self, part: str, limit_s: float) -> None:
        """Until a held request whose path holds ``part`` waits."""
        deadline = time.monotonic() + limit_s
        with self._cv:
            while not any(part in path for path in self.parked):
                left = deadline - time.monotonic()
                if left <= 0:
                    fail(f"no held request to {part} reached the stub "
                         f"within {limit_s} s")
                self._cv.wait(left)


def serving_story(cl) -> dict:
    """Phase 16 (b)'s story on a cluster ``cl`` (the port's processes on
    the card, or either package on the CPU: ``_ServingCluster``, the CPU
    tests' JAX cluster).  The mains up; the autoscaler's main creates
    chat's first replica, its create held at the stub (``cl.creates``, a
    ``_ClientGate``) until the smoke has created the two best-effort
    fillers: one plan, the three bound; the router's first publish; the
    burst, advanced one publish at a time, each publish made while the
    autoscaler's lists are held (``cl.lists``) and followed by a
    reconcile that read it and by the decision it took landing (a
    scale-up bound, a scale-down deleted);
    the drain until every stream ended and every session expired; a
    last publish.  ``cl``'s hooks start and stop the children.  Returns
    the story's fields (virtual times, published loads, the scale events
    in order) and ``cl``'s wall clock marks."""
    fields: dict = {"steps": []}
    cl.start_mains()
    # the three pods reach the partitioner within one batch window: the
    # first replica's create waits at the stub while the fillers are made
    with cl.creates.held():
        cl.start_autoscaler()
        cl.creates.wait_parked("/pods", SERVING_STEP_LIMIT_S)
        for name in SERVING_FILLERS:
            cl.create_filler(name)
    cl.until(lambda: "chat-r0" in cl.pods(), "create chat's first replica")
    first = ["chat-r0", *SERVING_FILLERS]
    cl.until(lambda: cl.running(first), "bind the replica and the fillers")
    cl.on_running(first)
    cl.start_router()
    events: list[list] = []
    live_before = ["chat-r0"]

    def step(cmd: str = "advance") -> dict:
        before = cl.stamps()
        # two stamps a publish: no list of the autoscaler is served while
        # the router publishes, so a reconcile reads both or neither
        with cl.lists.held():
            report = cl.router(cmd)
        if cl.stamps() != before:
            # a reconcile that read the stamps, and its decision landed
            cl.wait_reconcile(2)
            expected = _serving_expected(cl)
            cl.until(lambda: _serving_settled(cl, expected),
                     f"settle on {expected} replicas", SERVING_STEP_LIMIT_S)
        nonlocal live_before
        live = _serving_live(cl)
        gone = sorted(set(live_before) - set(live))
        new = sorted(set(live) - set(live_before))
        for name in gone:
            events.append(["down", name, report.get("t")])
            cl.on_deleted(name)
        fillers = [n for n in SERVING_FILLERS if n not in cl.pods()]
        for name in fillers:
            if not any(e[1] == name for e in events):
                events.append(["evicted", name, report.get("t")])
                cl.on_deleted(name)
        for name in new:
            events.append(["up", name, report.get("t")])
            cl.on_running([name])
        live_before = live
        fields["steps"].append({"t": report.get("t"), "stamps": cl.stamps(),
                                "sessions": report.get("sessions")})
        return report

    step()
    fields["burst"] = cl.router("burst")
    for _ in range(SERVING_PERIODS_MAX):
        report = step()
        done = report["burst_over"] and report["sessions"] == 0 and all(
            r["in_flight"] == 0 for r in report["replicas"].values())
        if done and any(e[0] == "down" for e in events):
            break
    else:
        fail(f"the serving story did not drain within "
             f"{SERVING_PERIODS_MAX} publishes: {events}")
    fields["final"] = step()
    cl.stop_router()
    fields["events"] = events
    fields["max_published_load"] = max(
        sum(float(v[0]) for v in s["stamps"].values() if v[0] is not None)
        for s in fields["steps"])
    return fields


def _serving_live(cl) -> list[str]:
    """chat's live replicas (Pending or Running), by name."""
    return sorted(n for n, p in cl.pods().items() if n.startswith("chat-")
                  and p["phase"] in ("Pending", "Running"))


def _serving_expected(cl) -> int:
    """The replicas the autoscaler must leave after reading the current
    stamps: its clamp of ceil(load / target), a scale-down only with the
    hysteresis' headroom (the cooldowns have passed by then)."""
    svc = SERVING_SERVICE
    live = _serving_live(cl)
    load = 0.0
    for name in live:
        value = cl.pods()[name]["load"]
        try:
            load += max(0.0, float(value)) if value else 0.0
        except ValueError:
            pass
    desired = min(svc["max_replicas"], max(
        svc["min_replicas"], math.ceil(load / svc["target_load_per_replica"])))
    if desired > len(live):
        return desired
    if desired < len(live) and load <= desired * svc[
            "target_load_per_replica"] * (1.0 - svc["down_hysteresis"]):
        return desired
    return len(live)


def _serving_settled(cl, expected: int) -> bool:
    pods = cl.pods()
    live = _serving_live(cl)
    return len(live) == expected and all(
        pods[n]["phase"] == "Running" and pods[n]["node"] for n in live)


class _ServingCluster(_Mains):
    """Phase 16 (b)'s cluster on the port: ``_Mains`` with SERVING_MAINS
    and the quotas SERVING_CARD_QUOTAS (the partitioner at
    SERVING_BATCH_IDLE_S), the autoscaler's main (SERVING_SERVICE,
    reconciling every SERVING_RECONCILE_S) started after them, and the
    router as a process (``_router_child``).  ``children`` (the card's)
    gets the hooks: ``on_running(cluster, names)`` and
    ``on_deleted(cluster, name)``; without it the story runs on the host
    alone."""

    def __init__(self, stub, tmp: str, model: str, agent_model: str,
                 card: str, children=None) -> None:
        # the tap replays the stub's objects as it is registered
        self.records: list[tuple[float, tuple]] = []
        super().__init__(stub, tmp, model, agent_model,
                         mains=SERVING_MAINS + (SERVING_AUTOSCALER,),
                         quotas=SERVING_CARD_QUOTAS)
        self.lists = _ClientGate(stub, SERVING_AUTOSCALER_TOKEN, "GET")
        self.creates = _ClientGate(stub, SERVING_AUTOSCALER_TOKEN, "POST")
        self.card = card
        self.children = children
        self.marks: dict[str, float] = {}
        self.router_proc = None
        self.router_log = []

    def _record(self, kind: str, event: str, obj) -> None:
        from nos_tpu_torch.api import constants as C

        super()._record(kind, event, obj)
        self.records.append((time.perf_counter(),
                             serving_record(kind, event, obj, C)))

    def _config(self, name: str) -> tuple[str, dict, list[str]]:
        module, cfg, extra = super()._config(name)
        if name.startswith("partitioner"):
            cfg["batch_idle_s"] = SERVING_BATCH_IDLE_S
        if name == SERVING_AUTOSCALER:
            cfg |= {"reconcile_interval_s": SERVING_RECONCILE_S,
                    "services": [SERVING_SERVICE], "slo_interval_s": 0.0,
                    "kubeconfig": self._autoscaler_kubeconfig()}
        return module, cfg, extra

    def _autoscaler_kubeconfig(self) -> str:
        """The stub's kubeconfig with SERVING_AUTOSCALER_TOKEN as the
        user's bearer token: the gates hold the requests that carry it."""
        path = self.tmp / "kubeconfig-autoscaler.json"
        config = json.loads(pathlib.Path(self.kubeconfig).read_text())
        config["users"] = [{"name": "smoke",
                            "user": {"token": SERVING_AUTOSCALER_TOKEN}}]
        path.write_text(json.dumps(config))
        return str(path)

    # -- the story's surface ----------------------------------------------
    def start_mains(self) -> None:
        self.start(SERVING_MAINS)
        self.marks["healthy_s"] = self.wait_healthy(SERVING_MAINS)

    def start_autoscaler(self) -> None:
        self.start((SERVING_AUTOSCALER,))
        self.marks["autoscaler_healthy_s"] = self.wait_healthy(
            (SERVING_AUTOSCALER,))[SERVING_AUTOSCALER]

    def create_filler(self, name: str) -> None:
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.kube.client import KIND_POD
        from nos_tpu_torch.testing.factory import make_timeshare_pod

        self.created[name] = time.perf_counter()
        self.client.create(KIND_POD, make_timeshare_pod(
            CARD_SHARE_GB, name=name, namespace="filler",
            labels={C.LABEL_TIER: C.TIER_BEST_EFFORT},
            creation_timestamp=time.time()))

    def pods(self) -> dict:
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.kube.client import KIND_POD

        return {p.metadata.name: serving_record("Pod", "", p, C)[3]
                for p in self.client.list(KIND_POD)}

    def raw_pods(self) -> dict:
        return super().pods()

    def running(self, names) -> bool:
        pods = self.pods()
        return all(n in pods and pods[n]["node"] == CARD_NODE
                   and pods[n]["phase"] == "Running" for n in names)

    def stamps(self) -> dict:
        return {n: [p["load"], p["sessions"]] for n, p in self.pods().items()
                if n.startswith("chat-") and p["phase"] == "Running"}

    def wait_reconcile(self, n: int) -> None:
        """Until the autoscaler's loop ended ``n`` more reconciles."""
        def count() -> float:
            return self.metric(SERVING_AUTOSCALER,
                               "nos_tpu_runloop_tick_seconds_count",
                               loop="autoscaler")

        want = count() + n
        self.until(lambda: count() >= want, f"reconcile {n} more times",
                   SERVING_STEP_LIMIT_S)

    def start_router(self) -> None:
        service = serving_router_service(self.card, _bench350m_weights_gb())
        path = self.tmp / "router-service.json"
        path.write_text(json.dumps(service))
        self.router_err = open(self.tmp / "router.log", "w")
        self.router_proc = subprocess.Popen(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke._router_child()",
             self.kubeconfig, str(path)], cwd=ROOT, env=_child_env(),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.router_err, text=True)

    def router(self, cmd: str) -> dict:
        proc = self.router_proc
        proc.stdin.write(cmd + "\n")
        proc.stdin.flush()
        result: list[str] = []
        reader = threading.Thread(
            target=lambda: result.append(proc.stdout.readline()),
            daemon=True)
        reader.start()
        reader.join(SERVING_ROUTER_TIMEOUT_S)
        if not result or not result[0]:
            fail(f"the router gave no answer to {cmd!r} (exit "
                 f"{proc.poll()}):\n"
                 f"{(self.tmp / 'router.log').read_text()[-4000:]}")
        out = json.loads(result[0])
        self.router_log.append((time.perf_counter(), cmd, out))
        return out

    def stop_router(self) -> None:
        proc = self.router_proc
        proc.stdin.write("quit\n")
        proc.stdin.flush()
        try:
            rc = proc.wait(timeout=MAINS_EXIT_LIMIT_S)
        except subprocess.TimeoutExpired:
            fail("the router did not exit on quit")
        self.router_err.close()
        if rc != 0:
            fail(f"the router exited {rc}:\n"
                 f"{(self.tmp / 'router.log').read_text()[-4000:]}")

    def on_running(self, names: list[str]) -> None:
        if self.children is not None:
            self.children.on_running(self, names)

    def on_deleted(self, name: str) -> None:
        if self.children is not None:
            self.children.on_deleted(self, name)

    def close(self) -> None:
        if self.router_proc is not None and self.router_proc.poll() is None:
            self.router_proc.kill()
            self.router_proc.wait()
        super().close()

    # -- what it wrote ----------------------------------------------------
    def committed_at(self, name: str, test) -> float | None:
        """When the stub first committed pod ``name`` with ``test(fields)``."""
        for t, (kind, event, key, fields) in self.records:
            if kind == "Pod" and key == name and event != "DELETED" \
                    and test(fields):
                return t
        return None

    def writes(self) -> dict:
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.partitioning.timeshare import (
            DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE)

        return serving_writes(
            [r for _, r in self.records], [p for _, p in self.plan_writes()],
            C.heartbeat_annotation(C.MPS_KIND),
            f"{DEVICE_PLUGIN_CM_NAMESPACE}/{DEVICE_PLUGIN_CM_NAME}",
            "nos-tpu-system/nos-tpu-autoscaler-status")


def _serving_host(stub, tmp: str, device: dict, card: str,
                  children=None, agent_model: str = "auto"
                  ) -> tuple[dict, dict]:
    """Phase 16 (b) on the host: the story (``serving_story``) on
    ``_ServingCluster``, then SIGTERM to every main (each exits 0) and
    the writes; ``children`` gets the hooks and its ``finish(cluster)``
    runs after the story, before the mains stop.  Returns the phase's
    fields and the writes."""
    cl = _ServingCluster(stub, tmp, device["model"], agent_model, card,
                         children)
    try:
        story = serving_story(cl)
        kids = children.finish(cl) if children is not None else {}
        exits = {n: cl.stop(n) for n in cl.mains}
        writes = cl.writes()
        if cl.tap.errors:
            fail(f"the stub tap's callbacks raised: {cl.tap.errors}")
        plans = len(cl.plan_writes())
        if plans != 1:
            fail(f"the serving story wrote {plans} plans, not one")

        def at(name, test):
            return cl.committed_at(name, test)

        bound = {n: at(n, lambda f: bool(f["node"]))
                 for n in ["chat-r0", "chat-r1", *SERVING_FILLERS]}
        created = {n: at(n, lambda f: True) for n in bound}
        ups = [e for e in story["events"] if e[0] == "up"]
        downs = [e for e in story["events"] if e[0] == "down"]
        evicted = [e for e in story["events"] if e[0] == "evicted"]
        crossed = next((t for t, cmd, out in cl.router_log
                        if cmd == "advance" and sum(
                            r["occupancy"] for r in out["replicas"].values())
                        > SERVING_SERVICE["target_load_per_replica"]), None)
        fields = {"node": CARD_NODE, "share_gb": CARD_SHARE_GB,
                  "quotas": [list(q) for q in SERVING_CARD_QUOTAS],
                  "service": SERVING_SERVICE,
                  "mains_start_to_healthz_s": cl.marks["healthy_s"],
                  "autoscaler_start_to_healthz_s":
                      cl.marks["autoscaler_healthy_s"],
                  "plans": plans,
                  "creation_to_bound_ms": {
                      n: (bound[n] - created[n]) * 1e3 for n in bound
                      if bound[n] is not None and created[n] is not None},
                  "load_stamp_to_scale_up_ms": (
                      (created["chat-r1"] - crossed) * 1e3
                      if crossed and created["chat-r1"] else None),
                  "load_stamp_to_bound_ms": (
                      (bound["chat-r1"] - crossed) * 1e3
                      if crossed and bound["chat-r1"] else None),
                  "events": story["events"], "scale_ups": len(ups),
                  "scale_downs": len(downs), "evicted": evicted,
                  "burst": story["burst"],
                  "max_published_load": story["max_published_load"],
                  "publishes": len(story["steps"]),
                  "router_stats": story["final"]["stats"],
                  "main_exits": exits, **kids}
        return fields, writes
    finally:
        cl.close()


def _serving_grants(cl: _ServingCluster, device: dict,
                    names: list[str]) -> list[dict]:
    """Each pod's grant from the stub's objects (``_mains_grants``)."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.device.timeshare_plugin import TimeshareDevicePlugin
    from nos_tpu_torch.partitioning.timeshare import (
        DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE)

    node = cl.node()
    key = node.metadata.annotations.get(C.ANNOT_PLUGIN_APPLIED_CONFIG, "")
    gpus = TimeshareDevicePlugin(cl.client, CARD_NODE, DEVICE_PLUGIN_CM_NAME,
                                 DEVICE_PLUGIN_CM_NAMESPACE).gpu_config(key)
    if gpus is None:
        fail(f"the node applied {key!r}, which the ConfigMap lacks")
    return _grants_of(node, cl.raw_pods(), gpus, device, names)


def _start_serve_child(case: str, grant: dict, no_nvcc: str) -> dict:
    """Start a replica's child (``_serve_child``) under ``grant`` with
    nvcc hidden; a thread gathers its stderr lines."""
    import os

    env = _child_env(**grant)
    env["CUDA_HOME"] = no_nvcc
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not pathlib.Path(d, "nvcc").exists())
    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke._serve_child()"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    lines: list[str] = []

    def gather() -> None:
        for line in proc.stderr:
            lines.append(line)

    reader = threading.Thread(target=gather, daemon=True)
    reader.start()
    return {"case": case, "grant": grant, "proc": proc, "lines": lines,
            "reader": reader, "t0": time.perf_counter()}


def _serve_batches(child: dict) -> list[dict]:
    return [json.loads(m.group(1))
            for m in _BATCH_LINE.finditer("".join(child["lines"]))]


class _ServingChildren:
    """The card's part of phase 16 (b), as the kubelet's: a replica's
    child (``_serve_child``) when it binds, waited for until its first
    batch served; a filler's training child under its grant (the one the
    scale-up evicts, SERVING_FILLER_VICTIM, asked for QUOTA_VICTIM_STEPS,
    the other for GRANT_STEPS); SIGTERM to a deleted pod's child, which
    must exit by it within QUOTA_STOP_LIMIT_S."""

    def __init__(self, device: dict, cfg_path: str, long_cfg: str,
                 no_nvcc: str) -> None:
        self.device = device
        self.cfg_path, self.long_cfg, self.no_nvcc = cfg_path, long_cfg, \
            no_nvcc
        self.children: dict[str, dict] = {}
        self.stopped: dict[str, float] = {}
        self.first_batch_s: dict[str, float] = {}

    def on_running(self, cl: _ServingCluster, names: list[str]) -> None:
        from nos_tpu_torch.api import constants as C

        key = f"{C.ANNOT_STATUS_PREFIX}0-{CARD_SHARE_GB}gb-used"
        want = sum(1 for p in cl.pods().values()
                   if p["node"] and p["phase"] == "Running")
        # the chip agent reports the bound pods' shares used before a
        # grant is derived from them (its report interval behind a bind)
        cl.until(lambda: int(cl.node().metadata.annotations.get(key, 0))
                 == want, f"report {want} used shares")
        grants = {g["pod"]: g for g in _serving_grants(cl, self.device,
                                                       names)}
        for name in names:
            env = grants[name]["env"]
            if name.startswith("chat-"):
                self.children[name] = _start_serve_child(name, env,
                                                         self.no_nvcc)
            else:
                cfg = self.long_cfg if name == SERVING_FILLER_VICTIM \
                    else self.cfg_path
                self.children[name] = _start_grant_child(name, cfg, env,
                                                         self.no_nvcc)
        for name in names:
            if name.startswith("chat-"):
                child = self.children[name]
                t0 = time.monotonic()
                while not _serve_batches(child):
                    if child["proc"].poll() is not None:
                        fail(f"{name}'s child exited "
                             f"{child['proc'].returncode}:\n"
                             f"{''.join(child['lines'])[-4000:]}")
                    if time.monotonic() - t0 > SERVING_FIRST_BATCH_LIMIT_S:
                        fail(f"{name}'s child served no batch within "
                             f"{SERVING_FIRST_BATCH_LIMIT_S} s")
                    time.sleep(0.05)
                self.first_batch_s[name] = time.perf_counter() \
                    - child["t0"]

    def on_deleted(self, cl: _ServingCluster, name: str) -> None:
        (self.stopped[name],) = _stop_children([self.children[name]])

    def finish(self, cl: _ServingCluster) -> dict:
        """SIGTERM to the replicas' children still serving; the surviving
        filler's child to its end.  Each child's fields."""
        live = [c for n, c in self.children.items()
                if n.startswith("chat-") and n not in self.stopped]
        for child, s in zip(live, _stop_children(live)):
            self.stopped[child["case"]] = s
        out = {}
        for name, child in self.children.items():
            if name.startswith("chat-"):
                child["proc"].wait()
                child["reader"].join()
                out[name] = {"rc": child["proc"].returncode,
                             "wall_s": time.perf_counter() - child["t0"],
                             "batches": _serve_batches(child),
                             "stderr": "".join(child["lines"]),
                             "grant": child["grant"]}
            else:
                out[name] = _finish_grant_child(child)
        return {"children": out, "sigterm_to_exit_s": dict(self.stopped),
                "first_batch_s": dict(self.first_batch_s)}


def _check_serve_child(name: str, child: dict, uuid: str,
                       layers: int) -> dict:
    """A replica's child: stopped by SIGTERM, its grant verified on
    ``uuid`` at its fraction when it started, at least one batch, each
    batch's K1 launches SERVING_GENERATE_STEPS x the layers and no other
    kernel's.  Its serving window, ms per forward and launches."""
    confined = [ln for ln in child["stderr"].splitlines()
                if "confined: grant " in ln]
    r = json.loads(confined[0].split(" grant ", 1)[1]) if confined else None
    if child["rc"] != -signal.SIGTERM or r is None or not r["verified"] \
            or r["devices"] != [uuid]:
        fail(f"{name}'s child exited {child['rc']}, confinement {r}:\n"
             f"{child['stderr'][-4000:]}")
    batches = child["batches"]
    if not batches:
        fail(f"{name}'s child served no batch")
    last = batches[-1]
    want = len(batches) * SERVING_GENERATE_STEPS * layers
    _check_launches(f"{name}'s child", last["launches"], {
        "flash_fwd": want, "flash_bwd_fused": 0})
    if sum(last["tile_launches"].values()) != want:
        fail(f"{name}'s child's launches by tile {last['tile_launches']} "
             f"do not add up to {want}")
    ms = [b["ms_per_forward"] for b in batches]
    return {"window": [batches[0]["t0"], last["t1"]], "batches": len(batches),
            "ms_per_forward_median": statistics.median(ms),
            "ms_per_forward_min": min(ms), "launches": last["launches"],
            "tile_launches": last["tile_launches"],
            "peak_bytes": last["max_memory_allocated"],
            "fraction": r["fraction"], "cap_bytes": r["cap_bytes"]}


def phase_serving(main_loss0: float, device: dict, smi: str) -> dict:
    """Phase 16: (a) the serving fleets twice each (``_serving_fleet_runs``:
    router off at 0 workers, router on at 0 and 4); (b) the card's node
    (``_serving_host`` with ``_ServingChildren``): the writes must equal
    SERVING_LOOP_WRITES, the scale-up must evict SERVING_FILLER_VICTIM
    alone and bind the second replica with no new plan, the scale-down
    delete SERVING_VICTIM alone, the replicas' serving windows overlap,
    every main and the router exit 0, the evicted filler's child exit by
    SIGTERM having verified its grant, the other filler's pass as grant
    (a)'s.  Returns the replicas' children's launches, by kernel."""
    from nos_tpu_torch.models.llama import BENCH_350M
    from nos_tpu_torch.ops import _build
    from nos_tpu_torch.requests import RouterService

    t0 = time.perf_counter()
    fleets, fleets_s = _host_result("serving", "_serving_fleets")
    card = torch.cuda.get_device_name(0)
    total = device["memory_bytes"]
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    stub_mod = _load_stub()
    with stub_mod.StubApiServer() as stub, \
            tempfile.TemporaryDirectory(prefix="nos-serving-") as tmp:
        cfg_path, no_nvcc = _grant_workdir(tmp)
        base = json.loads(pathlib.Path(cfg_path).read_text())
        long_cfg = str(pathlib.Path(tmp) / "long.json")
        pathlib.Path(long_cfg).write_text(json.dumps(
            base | {"steps": QUOTA_VICTIM_STEPS}))
        kids = _ServingChildren(device, cfg_path, long_cfg, no_nvcc)
        try:
            host, writes = _serving_host(stub, tmp, device, card, kids)
        finally:
            for child in kids.children.values():
                proc = child.get("proc")
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"a serving child built kernels: {kernels_before} -> "
             f"{kernels_after}")
    if writes != SERVING_LOOP_WRITES:
        fail(f"the serving loop's writes differ from the CPU test's: "
             f"{json.dumps(writes)}")
    events = host["events"]
    if [e[1] for e in events if e[0] == "evicted"] != [SERVING_FILLER_VICTIM] \
            or [e[1] for e in events if e[0] == "up"] != ["chat-r1"] \
            or [e[1] for e in events if e[0] == "down"] != [SERVING_VICTIM]:
        fail(f"the serving story's events {events}: the scale-up must "
             f"evict {SERVING_FILLER_VICTIM} and bind chat-r1, the "
             f"scale-down delete {SERVING_VICTIM}")
    if host["max_published_load"] < 2 * SERVING_SERVICE[
            "target_load_per_replica"]:
        fail(f"the burst's published load peaked at "
             f"{host['max_published_load']}, under twice the target")
    children = host.pop("children")
    uuid = device["uuid"]
    layers = BENCH_350M.num_layers
    replicas = {n: _check_serve_child(n, c, uuid, layers)
                for n, c in children.items() if n.startswith("chat-")}
    windows = [r["window"] for r in replicas.values()]
    overlap = min(w[1] for w in windows) - max(w[0] for w in windows)
    if len(windows) != 2 or overlap <= 0:
        fail(f"the replicas' serving windows {windows} do not overlap")
    for name, s in host["sigterm_to_exit_s"].items():
        if s > QUOTA_STOP_LIMIT_S:
            fail(f"{name}'s child took {s} s to exit on SIGTERM")
    fillers = {}
    for name in SERVING_FILLERS:
        child = children[name]
        child["fraction"], child["cap_bytes"] = _grant_cap(
            int(child["grant"]["NOS_TPU_TIMESHARE_GB"]), total)
        if name == SERVING_FILLER_VICTIM:
            _check_stopped_child(f"serving {name}", child, uuid, main_loss0)
        else:
            _check_granted_child(f"serving {name}", child, uuid, main_loss0)
        fillers[name] = {"rc": child["rc"], "wall_s": child["wall_s"],
                         "steps_logged": len(child["steps"]),
                         "launches": (child["report"] or {}).get("launches")}
    launches = {k: sum(r["launches"].get(k, 0) for r in replicas.values())
                for k in ("flash_fwd", "flash_bwd_fused", "flash_dq",
                          "flash_dkv")}
    tiles = {name: sum(r["tile_launches"].get(
                 f"{kernel}:{tile[0]}x{tile[1]}", 0)
                 for r in replicas.values())
             for name, (kernel, tile, _) in TILES.items()}
    costs = RouterService.from_mapping(serving_router_service(
        card, _bench350m_weights_gb())).prefill_costs
    burst = host["burst"]
    emit({"phase": "serving", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0, "fleets_seconds": fleets_s,
          "fleets": fleets, "card": host, "replicas": replicas,
          "serving_overlap_s": overlap, "fillers": fillers,
          "cost_model": {
              "device_kind": card, "hbm_gb": costs.hbm_gb,
              "mfu": costs.mfu, "hbm_efficiency": costs.hbm_efficiency,
              "prefill_seconds_448": costs.prefill_seconds(SERVING_PROMPT),
              "decode_step_seconds_empty": costs.decode_step_seconds(0),
              "decode_step_seconds_burst": costs.decode_step_seconds(
                  burst["streams"] * (SERVING_PROMPT
                                      + SERVING_OUTPUT // 2)),
              "note": "printed, not held: the model assumes mfu 0.4 and "
                      "a KV cache; generate recomputes the sequence"},
          "launches": launches, "tile_launches": tiles})
    PATH_TILES["serving"] = tiles
    return launches


# The capacity phase.  (a) testing/fleet.py's capacity fleets
# (bench_capacity.py's swing, storm and quiescent runs on H100 nodes) on
# the host.  (b) The card's node provisioned on demand: the provisioner
# main over the REST stub requests it from its stand-in cloud, the smoke
# joins it as its kubelet would, a pod trains on it, and it is released.
# fleet.plan_digest of each capacity fleet's summary: the JAX package's
# bench_capacity.py run of the same trace and seed
# (tests/test_torch_capacity.py)
CAPACITY_FLEET_DIGESTS = {
    "swing": "092842080c7c0f412004ad01a8d380f009ffe696e6d16ca9f23b9ba3c0966f12",
    "storm": "4dd2a77916ec039ebcc0ccc1071cd5e42bfe695f21d48723865237ef6da9efa6",
    "quiet": "6bf78ffae19b77e42d709910a9a9d26a6ab41a5adc2147e4092be7fbe7f69a18",
}
CAPACITY_FLEET_RUNS = 2
CAPACITY_POOL = "nvl-card"
CAPACITY_BASE_NODE = f"{CAPACITY_POOL}-h0"   # a stand-in, no agent
CAPACITY_NODE = f"{CAPACITY_POOL}-h1"        # the card's, provisioned
CAPACITY_FILLER = ("default", "cap-filler")  # holds the stand-in's GPU
CAPACITY_POD = ("default", "cap-0")
CAPACITY_SHARE_GB = 40
CAPACITY_MAINS = ("partitioner-0", "scheduler", "operator", "provisioner")
CAPACITY_AGENT = "chipagent"
# the provisioner main's knobs: a 0.5 s poll, a deficit of a quarter GPU
# sustained 1 s, 3 s of stand-in provisioning, release after 5 s idle;
# the deadline covers the chip agent main's start (8 to 11 s of import
# torch on the card's host) and a plan
CAPACITY_KNOBS = {"poll_interval_s": 0.5, "scale_up_deficit_chips": 0.25,
                  "scale_up_after_s": 1.0, "scale_up_cooldown_s": 1.0,
                  "provision_delay_s": 3.0, "scale_down_idle_s": 5.0,
                  "scale_down_cooldown_s": 0.0, "provision_deadline_s": 120.0,
                  "join_grace_s": 10.0, "slo_interval_s": 0.0}
CAPACITY_LIMIT_S = 60.0       # each step the mains take on their own
_POOL_LINE = re.compile(r"^pool (\S+): (\d+)/(\d+) hosts", re.M)


def _capacity_fleet_runs(runs: int = CAPACITY_FLEET_RUNS) -> dict:
    """Phase 17 (a): swing, storm and the quiescent armed run against the
    plane off, ``runs`` times each.  Every run must reach its digest (so
    repeated runs journal alike), conserve (``CapacityFleet.run``
    raises), and hold bench_capacity.py's gates; the armed quiescent
    journal must be the plane-off one byte for byte."""
    from nos_tpu_torch.testing import fleet

    out: dict = {}
    journals: dict[str, list] = {}
    for scenario, plane in (("swing", True), ("storm", True),
                            ("quiet", True), ("quiet", False)):
        key = scenario if plane else "quiet_off"
        secs, ms, digests = [], [], []
        for _ in range(runs):
            run = fleet.run_capacity_fleet(scenario, plane=plane)
            digests.append(fleet.plan_digest(run["summary"]))
            secs.append(run["seconds"])
            ms += run["reconcile_ms"]
            journals[key] = run["summary"]["journal"]
            result = run["summary"]["result"]
        if plane and set(digests) != {CAPACITY_FLEET_DIGESTS[scenario]}:
            fail(f"the {scenario} capacity fleet hashed to {digests}, not "
                 f"{CAPACITY_FLEET_DIGESTS[scenario]}")
        if len(set(digests)) != 1:
            fail(f"the {key} capacity fleet's runs differ: {digests}")
        out[key] = {"result": result, "seconds": secs,
                    "records": len(journals[key]),
                    "reconcile_ms_median": statistics.median(ms)
                    if ms else None,
                    "reconcile_ms_max": max(ms) if ms else None,
                    "reconciles": len(ms)}
    gates = fleet.capacity_gates(out["swing"]["result"],
                                 out["storm"]["result"])
    if gates:
        fail(f"the capacity fleets miss bench_capacity.py's gates: {gates}")
    if json.dumps(journals["quiet"]) != json.dumps(journals["quiet_off"]):
        fail("the armed quiescent capacity fleet journals otherwise than "
             "the plane off")
    if out["quiet"]["result"]["provision_landed"] or \
            out["quiet"]["result"]["scale_downs"]:
        fail(f"the armed plane acted on the quiet trace: "
             f"{out['quiet']['result']}")
    return out


class _CapacityCluster(_Mains):
    """Phase 17 (b)'s cluster: the stub with pool CAPACITY_POOL's index 0
    registered (a one-GPU H100 stand-in whose GPU the bound, Running 80 GB
    filler holds; no agent runs for it), the mains CAPACITY_MAINS as
    processes, the provisioner main at CAPACITY_KNOBS on its in-memory
    stand-in cloud, and the chip agent main started for CAPACITY_NODE
    when the smoke joins it."""

    def __init__(self, stub, tmp: str, model: str, agent_model: str
                 ) -> None:
        from nos_tpu_torch.kube.client import KIND_NODE, KIND_POD
        from nos_tpu_torch.testing.factory import (
            make_gpu_node, make_timeshare_pod)
        from nos_tpu_torch.topology import DEFAULT_REGISTRY

        super().__init__(stub, tmp, model, agent_model,
                         mains=CAPACITY_MAINS + (CAPACITY_AGENT,),
                         quotas=(), card_node=False)
        self.model = DEFAULT_REGISTRY.get(model)
        self.client.create(KIND_NODE, make_gpu_node(
            CAPACITY_BASE_NODE, model=self.model, gpus=1,
            status_geometry={0: {"used": {"80gb": 1}}},
            domain=CAPACITY_POOL, host_index=0))
        ns, name = CAPACITY_FILLER
        self.client.create(KIND_POD, make_timeshare_pod(
            80, name=name, namespace=ns, node_name=CAPACITY_BASE_NODE,
            phase="Running", creation_timestamp=time.time()))
        # the provisioner's journal stamps time.monotonic(); the tap and
        # the marks time.perf_counter()
        self.mono_to_perf = time.perf_counter() - time.monotonic()
        self.marks: dict[str, float] = {}

    def _config(self, name: str) -> tuple[str, dict, list[str]]:
        module, cfg, extra = super()._config(name)
        if name == "provisioner":
            cfg |= {"enabled": True, **CAPACITY_KNOBS}
        if name == CAPACITY_AGENT:
            extra = ["--node", CAPACITY_NODE]
        return module, cfg, extra

    # -- the provisioner main's surfaces ------------------------------------
    def flight(self) -> dict:
        code, body = self._get("provisioner", "/debug/flightrecorder")
        if code != 200:
            fail(f"the provisioner's /debug/flightrecorder answered {code}")
        payload = json.loads(body)
        if "capacity" not in payload:
            fail("the provisioner's flight snapshot has no capacity block")
        return payload

    def pool(self) -> tuple[int, int] | None:
        row = self.flight()["capacity"]["pools"].get(CAPACITY_POOL)
        return None if row is None else (row["active"],
                                         row["recorded_size"])

    def record(self, category: str) -> dict | None:
        for r in self.flight()["journal"]:
            if r["category"] == category:
                return r
        return None

    def at(self, record: dict) -> float:
        """A provisioner record's time on the smoke's perf_counter."""
        return record["ts"] + self.mono_to_perf

    def obs_capacity(self) -> dict:
        """``python -m nos_tpu_torch.obs capacity --url`` on the
        provisioner: exit 0; the pools' hosts as it renders them."""
        addr = self.procs["provisioner"]["addr"]
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "nos_tpu_torch.obs", "capacity", "--url",
             f"http://{addr}"], cwd=ROOT, env=_child_env(),
            capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            fail(f"obs capacity exited {r.returncode}:\n{r.stdout[-4000:]}"
                 f"\n{r.stderr[-4000:]}")
        return {"pools": {m.group(1): f"{m.group(2)}/{m.group(3)}"
                          for m in _POOL_LINE.finditer(r.stdout)},
                "breakers_open": "stockout breakers:" in r.stdout
                and ": open " in r.stdout,
                "s": time.perf_counter() - t0, "text": r.stdout}

    # -- the cluster ----------------------------------------------------------
    def create_pod(self) -> None:
        from nos_tpu_torch.kube.client import KIND_POD
        from nos_tpu_torch.testing.factory import make_timeshare_pod

        ns, name = CAPACITY_POD
        self.created[name] = time.perf_counter()
        self.client.create(KIND_POD, make_timeshare_pod(
            CAPACITY_SHARE_GB, name=name, namespace=ns,
            creation_timestamp=time.time()))

    def join(self, row: dict) -> None:
        """The new VM's kubelet: the Node with the create's labels (its
        pool, host index, class and GPUs, as ``CapacityProvisioner._create``
        labels it), then the chip agent main for it on the card."""
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.kube.client import KIND_NODE
        from nos_tpu_torch.testing.factory import make_gpu_node

        if row["machine_class"] != self.model.name:
            fail(f"the provisioner asked for {row['machine_class']}, not "
                 f"{self.model.name}")
        node = make_gpu_node(
            row["name"], model=self.model, gpus=1, domain=row["pool"],
            host_index=int(row["name"].rsplit("-h", 1)[1]),
            extra_labels={C.LABEL_ZONE: row["zone"]})
        self.marks["joined"] = time.perf_counter()
        self.client.create(KIND_NODE, node)
        self.start((CAPACITY_AGENT,))

    def node(self):
        from nos_tpu_torch.kube.client import KIND_NODE

        return self.client.get(KIND_NODE, CAPACITY_NODE)

    def running(self, names) -> bool:
        pods = self.pods()
        return all(n in pods and pods[n].spec.node_name == CAPACITY_NODE
                   and pods[n].status.phase == "Running" for n in names)

    def release_order(self) -> list[tuple[float, str]]:
        """(commit time, event) of the release as the stub committed it:
        the Node's deletion and the size record's writes."""
        out = []
        for t, kind, event, obj in self.log:
            if kind == "Node" and event == "DELETED" \
                    and obj.metadata.name == CAPACITY_NODE:
                out.append((t, "node-deleted"))
            if kind == "ConfigMap" \
                    and obj.metadata.name == "nos-tpu-capacity-inventory":
                out.append((t, f"size {obj.data.get('pools', '')}"))
        return out


def _capacity_host(stub, tmp: str, device: dict, agent_model: str,
                   children=None) -> dict:
    """Phase 17 (b) on the host: the mains up, the pool at 1/1; the
    pending 40 GB pod makes the deficit and the provisioner requests
    CAPACITY_NODE; once the stand-in cloud's operation is done the smoke
    joins it (the Node, the chip agent main), the agent's report lands
    it and the pod binds on it; ``children`` (the card's) gets
    ``on_running(cluster)``, which starts the pod's child, and
    ``finish(cluster)``, which waits for it; the pod completes and is
    deleted, the node is released (cloud, Node, size record) with
    SCALE_DOWN; SIGTERM to every main.  Returns the phase's fields."""
    from nos_tpu_torch.kube.client import KIND_POD
    from nos_tpu_torch.obs import journal as J

    cl = _CapacityCluster(stub, tmp, device["model"], agent_model)
    ns, pod = CAPACITY_POD
    try:
        cl.start(CAPACITY_MAINS)
        healthy = cl.wait_healthy(CAPACITY_MAINS)
        cl.until(lambda: cl.pool() == (1, 1), "publish the pool at 1/1",
                 CAPACITY_LIMIT_S)
        before = cl.obs_capacity()
        cl.create_pod()
        cl.until(lambda: cl.record(J.PROVISION_REQUESTED) is not None,
                 "request a node", CAPACITY_LIMIT_S)
        requested = cl.record(J.PROVISION_REQUESTED)
        if (requested["subject"], requested["attrs"]["pool"],
                requested["attrs"]["host_index"]) != (CAPACITY_NODE,
                                                      CAPACITY_POOL, 1):
            fail(f"the provisioner requested {requested}")

        def done_row() -> dict | None:
            return next((r for r in cl.flight()["capacity"]
                         ["pending_creates"] if r["name"] == CAPACITY_NODE
                         and r["status"] == "DONE"), None)

        cl.until(lambda: done_row() is not None,
                 "land the create in the stand-in cloud", CAPACITY_LIMIT_S)
        cl.join(done_row())
        cl.until(lambda: cl.record(J.PROVISION_LANDED) is not None,
                 "land the node on the agent's report", 2 * CAPACITY_LIMIT_S)
        landed = cl.record(J.PROVISION_LANDED)
        cl.until(lambda: cl.running([pod]), "bind the pod on the new node",
                 CAPACITY_LIMIT_S)
        cl.until(lambda: cl.pool() == (2, 2), "publish the pool at 2/2",
                 CAPACITY_LIMIT_S)
        during = cl.obs_capacity()
        sched_during = _mains_snapshot(cl)["waste"]
        if children is not None:
            children.on_running(cl)
            kids = children.finish(cl)
        else:
            kids = {}
        cl.mark([pod])
        cl.marks["deleted"] = time.perf_counter()
        cl.client.delete(KIND_POD, pod, ns)
        cl.until(lambda: cl.record(J.SCALE_DOWN) is not None,
                 "release the empty node", CAPACITY_LIMIT_S)
        scale_down = cl.record(J.SCALE_DOWN)
        cl.until(lambda: cl.pool() == (1, 1)
                 and not [n for n in cl.client.list("Node")
                          if n.metadata.name == CAPACITY_NODE],
                 "publish the pool at 1/1 again", CAPACITY_LIMIT_S)
        after = cl.obs_capacity()
        flight = cl.flight()
        metrics = {m: cl.metric("provisioner", m, pool=CAPACITY_POOL)
                   for m in ("nos_tpu_provision_requests_total",
                             "nos_tpu_provision_landed_total",
                             "nos_tpu_capacity_scale_downs_total")}
        sched_after = _mains_snapshot(cl)["waste"]
        exits = {n: cl.stop(n) for n in cl.mains}
        release = cl.release_order()
        if cl.tap.errors:
            fail(f"the stub tap's callbacks raised: {cl.tap.errors}")
        bound = cl.bound_at(pod)
    finally:
        cl.close()
    views = {"before": before["pools"], "during": during["pools"],
             "after": after["pools"]}
    if views != {"before": {CAPACITY_POOL: "1/1"},
                 "during": {CAPACITY_POOL: "2/2"},
                 "after": {CAPACITY_POOL: "1/1"}}:
        fail(f"obs capacity rendered the pool {views}, not 1/1, 2/2, 1/1")
    if any(v["breakers_open"] for v in (before, during, after)) or any(
            b["state"] != "closed"
            for b in flight["capacity"]["breakers"].values()):
        fail(f"a stockout breaker is not closed: "
             f"{flight['capacity']['breakers']}")
    if list(metrics.values()) != [1.0, 1.0, 1.0]:
        fail(f"the provisioner's /metrics show {metrics}, not one request, "
             f"one landing and one scale-down")
    if scale_down["subject"] != CAPACITY_NODE:
        fail(f"the provisioner released {scale_down}")
    events = [e for _, e in release]
    if events != ["size {\"nvl-card\": 1}", "size {\"nvl-card\": 2}",
                  "node-deleted", "size {\"nvl-card\": 1}"]:
        fail(f"the release's commits {events}: the Node must go before "
             f"the size record returns to 1")
    created = cl.created[pod]

    def provisioning(report: dict) -> float:
        return report["fleet"]["chip_seconds"].get("provisioning", 0.0)

    stamps = kids.get("child", {}).get("stamps") or []
    wall_of = time.time() - time.perf_counter()
    fields = {"pool": CAPACITY_POOL, "node": CAPACITY_NODE,
              "share_gb": CAPACITY_SHARE_GB, "knobs": CAPACITY_KNOBS,
              "mains_start_to_healthz_s": healthy,
              "pending_to_requested_ms":
                  (cl.at(requested) - created) * 1e3,
              "requested_to_landed_ms":
                  (cl.at(landed) - cl.at(requested)) * 1e3,
              "requested_to_joined_ms":
                  (cl.marks["joined"] - cl.at(requested)) * 1e3,
              "joined_to_landed_ms":
                  (cl.at(landed) - cl.marks["joined"]) * 1e3,
              "landed_to_bound_ms": (bound - cl.at(landed)) * 1e3
              if bound is not None else None,
              "bound_to_first_step_s": stamps[0][1] - (bound + wall_of)
              if stamps and bound is not None else None,
              "deleted_to_scale_down_ms":
                  (cl.at(scale_down) - cl.marks["deleted"]) * 1e3,
              "landed_latency_s": landed["attrs"]["latency_s"],
              "scale_down_idle_s": scale_down["attrs"]["idle_s"],
              "obs_capacity": views,
              "obs_capacity_s": [v["s"] for v in (before, during, after)],
              "metrics": metrics,
              "counters": flight["capacity"]["counters"],
              "provisioning_gpu_seconds": {
                  "scheduler_while_running": provisioning(sched_during),
                  "scheduler_at_end": provisioning(sched_after),
                  "provisioner": provisioning(flight["waste"])},
              "release_commits": events, "main_exits": exits, **kids}
    return fields


class _CapacityChild:
    """The card's part of phase 17 (b): the bound pod's training child
    under the grant derived from the stub's objects (the plugin config
    the new node applied, the reporter's used share), train_main's
    configuration for GRANT_STEPS steps, nvcc hidden."""

    def __init__(self, device: dict, cfg_path: str, no_nvcc: str) -> None:
        self.device, self.cfg_path, self.no_nvcc = device, cfg_path, no_nvcc
        self.child: dict | None = None

    def on_running(self, cl: _CapacityCluster) -> None:
        from nos_tpu_torch.api import constants as C
        from nos_tpu_torch.device.timeshare_plugin import (
            TimeshareDevicePlugin)
        from nos_tpu_torch.partitioning.timeshare import (
            DEVICE_PLUGIN_CM_NAME, DEVICE_PLUGIN_CM_NAMESPACE)

        key = f"{C.ANNOT_STATUS_PREFIX}0-{CAPACITY_SHARE_GB}gb-used"
        cl.until(lambda: cl.node().metadata.annotations.get(key) == "1",
                 "report the pod's share used")
        node = cl.node()
        applied = node.metadata.annotations.get(
            C.ANNOT_PLUGIN_APPLIED_CONFIG, "")
        gpus = TimeshareDevicePlugin(
            cl.client, CAPACITY_NODE, DEVICE_PLUGIN_CM_NAME,
            DEVICE_PLUGIN_CM_NAMESPACE).gpu_config(applied)
        if gpus is None:
            fail(f"the new node applied {applied!r}, which the ConfigMap "
                 f"lacks")
        (grant,) = _grants_of(node, cl.pods(), gpus, self.device,
                              [CAPACITY_POD[1]])
        self.child = _start_grant_child(CAPACITY_POD[1], self.cfg_path,
                                        grant["env"], self.no_nvcc)

    def finish(self, cl: _CapacityCluster) -> dict:
        return {"child": _finish_grant_child(self.child)}


def phase_capacity(main_loss0: float, device: dict, smi: str) -> dict:
    """Phase 17: (a) the capacity fleets on the host
    (``_capacity_fleet_runs``); (b) the card's node provisioned on
    demand (``_capacity_host`` with ``_CapacityChild``): requested,
    landed on the chip agent's report, the pod's child trains under its
    grant as grant (a)'s must (exit 0, train_main's step-0 loss, 24 K1 +
    24 K2 a step), then the node is released with SCALE_DOWN and ``obs
    capacity`` renders 1/1, 2/2, 1/1.  Returns the child's launches, by
    kernel."""
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    fleets, fleets_s = _host_result("capacity", "_capacity_fleet_runs")
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    stub_mod = _load_stub()
    with stub_mod.StubApiServer() as stub, \
            tempfile.TemporaryDirectory(prefix="nos-capacity-") as tmp:
        cfg_path, no_nvcc = _grant_workdir(tmp)
        kid = _CapacityChild(device, cfg_path, no_nvcc)
        try:
            card = _capacity_host(stub, tmp, device, "auto", kid)
        finally:
            proc = (kid.child or {}).get("proc")
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"the capacity child built kernels: {kernels_before} -> "
             f"{kernels_after}")
    child = card.pop("child")
    child["fraction"], child["cap_bytes"] = _grant_cap(
        int(child["grant"]["NOS_TPU_TIMESHARE_GB"]), device["memory_bytes"])
    report = _check_granted_child("capacity child", child,
                                  child["grant"]["NOS_TPU_VISIBLE_CHIPS"],
                                  main_loss0)
    launches = {k: report["launches"].get(k, 0)
                for k in ("flash_fwd", "flash_bwd_fused", "flash_dq",
                          "flash_dkv")}
    tiles = {name: report["tile_launches"].get(
                 f"{kernel}:{tile[0]}x{tile[1]}", 0)
             for name, (kernel, tile, _) in TILES.items()}
    emit({"phase": "capacity", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0, "fleets_seconds": fleets_s,
          "fleets": fleets, "card": card,
          "child": {"rc": child["rc"], "wall_s": child["wall_s"],
                    "steps": child["steps"],
                    "loss0_rel_diff": child["loss0_rel_diff"],
                    "peak_bytes": child["peak_bytes"],
                    "fraction": child["fraction"],
                    "cap_bytes": child["cap_bytes"],
                    "launches": report["launches"]},
          "main_loss0": main_loss0, "launches": launches,
          "tile_launches": tiles})
    PATH_TILES["capacity"] = tiles
    return launches


# The demo phase: ``demos/gpu-sharing-comparison/run.py``'s own functions
# at its full sizes.  Its seven clients are processes under 10 GB
# timeshare grants of the card; each builds BENCH_350M (flash, no remat,
# fp32 parameters from one seed) and serves 8 x 2048 forwards.  The
# clients' scalars are sums of 8 x 32000 last-position logits, so the
# serve phase's limit holds each of those logits against the dense
# forward's (a sum of 256,000 roundings is no single logit's error).


def _load_path(name: str, *parts: str):
    """The module at ``parts`` under the checkout, loaded by its path
    (scripts and demos are not packages)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT.joinpath(*parts))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _demo_module():
    return _load_path("gpu_sharing_demo", "demos", "gpu-sharing-comparison",
                      "run.py")


def _mfu_module():
    return _load_path("mfu_explore_torch", "scripts", "mfu_explore_torch.py")


def check_demo(demo, rows: list[dict], reports: list[dict],
               dense: torch.Tensor, noncausal: torch.Tensor,
               layers: int) -> dict:
    """Phase 21's checks on the demo's rows, its clients' reports and
    the last logits of the dense forward and of the dense model made
    non-causal: every row holds clients x 6 requests, every client
    launched K1 ``layers`` times a request (warm ones included) and no
    other kernel, every scalar and every client's last logits are
    bitwise equal, those logits are finite, of the request's shape and
    within LOGITS_TOL of ``dense``, ``noncausal`` is not (the limit sees
    a wrong attention), and no client's peak reached its cap.  Returns
    the clients' launches by tile, the scalar and the distances of the
    clients' and the non-causal logits from the dense ones."""
    for r in rows:
        if r["requests"] != r["clients"] * demo.REQUESTS_PER_CLIENT:
            fail(f"the demo's row {r} does not hold clients x "
                 f"{demo.REQUESTS_PER_CLIENT} requests")
    want_requests = [1 + (1 + demo.REQUESTS_PER_CLIENT) * sum(
        1 for n in demo.CLIENT_COUNTS if n > i) for i in range(len(reports))]
    tiles = {name: 0 for name in TILES}
    for i, (r, want) in enumerate(zip(reports, want_requests)):
        if r["requests"] != want or r["k1_launches"] != layers * want:
            fail(f"demo client {i} made {r['requests']} requests and "
                 f"{r['k1_launches']} K1 launches, expected {want} and "
                 f"{layers * want}")
        got = {name: r["tile_launches"].get(name, 0) for name in TILES}
        if sum(got.values()) != sum(r["tile_launches"].values()) \
                or sum(got.values()) != r["k1_launches"] or any(
                    n for name, n in got.items()
                    if TILES[name][0] != "flash_fwd"):
            fail(f"demo client {i} launched {r['tile_launches']}, not K1 "
                 f"alone")
        tiles = {name: tiles[name] + got[name] for name in TILES}
        if not r["peak_reserved_bytes"] < r["cap_bytes"]:
            fail(f"demo client {i} reserved {r['peak_reserved_bytes']} B, "
                 f"at its cap {r['cap_bytes']} B")
    scalars = {s for r in reports for s in r["scalars"]}
    if len(scalars) != 1 or not all(math.isfinite(s) for s in scalars):
        fail(f"the demo clients' scalars differ or are not finite: "
             f"{sorted(scalars)}")
    logits = [demo.logits_of(r) for r in reports]
    if not all(torch.equal(x, logits[0]) for x in logits):
        fail("the demo clients' last logits differ")
    if logits[0].shape != dense.shape or not torch.isfinite(logits[0]).all():
        fail(f"the demo's logits: shape {tuple(logits[0].shape)} against "
             f"{tuple(dense.shape)}, finite "
             f"{bool(torch.isfinite(logits[0]).all())}")
    diff = (logits[0] - dense).abs().max().item()
    if not diff <= LOGITS_TOL:
        fail(f"the demo's logits differ from the dense forward's by {diff} "
             f"(tol {LOGITS_TOL})")
    wrong_diff = (noncausal - dense).abs().max().item()
    if not wrong_diff > LOGITS_TOL:
        fail(f"a non-causal attention moves the demo's logits by only "
             f"{wrong_diff}, within the limit {LOGITS_TOL}: the check "
             f"cannot see it")
    (scalar,) = scalars
    return {"tiles": tiles, "scalar": scalar, "logits_diff": diff,
            "noncausal_diff": wrong_diff}


def phase_demo(device: dict, smi: str) -> dict[str, int]:
    """Phase 21: the GPU sharing demo's rows at 1, 2, 4 and 7 clients
    from one set of seven client processes under GRANT_GB grants of the
    card (``run_timeshare``), held by ``check_demo`` against the same
    forward with dense attention, computed here once.  Returns the
    clients' launches, by kernel."""
    from nos_tpu_torch.ops import _build

    demo = _demo_module()
    t0 = time.perf_counter()
    kernels_before = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    _release()
    rows, reports = demo.run_timeshare("cuda", device["uuid"])
    demo_s = time.perf_counter() - t0
    kernels_after = sorted(p.name for p in _build.KERNEL_DIR.iterdir())
    if kernels_after != kernels_before:
        fail(f"a demo client built kernels: {kernels_before} -> "
             f"{kernels_after}")
    _release()
    request = demo.build_model("cuda", demo.demo_config(attn_impl="dense"))
    dense = request.last.float().cpu()
    noncausal = _noncausal_logits(
        request.model, request.tokens)[:, -1, :].float().cpu()
    del request
    _release()
    layers = demo.demo_config().num_layers
    checked = check_demo(demo, rows, reports, dense, noncausal, layers)
    launches = {"flash_fwd": sum(r["k1_launches"] for r in reports),
                "flash_bwd_fused": 0, "flash_dq": 0, "flash_dkv": 0}
    summary = demo.summary(rows, smi)
    for r in rows:
        emit({"demo_row": r})
    emit({"demo_summary": summary})
    emit({"phase": "demo", "nvidia_smi": smi, "seconds":
          time.perf_counter() - t0, "demo_seconds": demo_s,
          "model": "BENCH_350M", "layers": layers, "batch": demo.BATCH,
          "seq": demo.SEQ, "grant": {"NOS_TPU_VISIBLE_CHIPS": device["uuid"],
                                     "NOS_TPU_TIMESHARE_GB": demo.GRANT_GB},
          "rows": rows, "degradation": summary["degradation"],
          "clients": [{k: r[k] for k in (
              "requests", "k1_launches", "peak_allocated_bytes",
              "peak_reserved_bytes", "cap_bytes")} for r in reports],
          "scalar": checked["scalar"], "scalar_dense": dense.sum().item(),
          "logits_max_abs_diff_vs_dense": checked["logits_diff"],
          "logits_max_abs_diff_noncausal": checked["noncausal_diff"],
          "logits_tol": LOGITS_TOL, "isolated": demo.run_isolated("cuda"),
          "launches": launches, "tile_launches": checked["tiles"]})
    PATH_TILES["demo"] = checked["tiles"]
    return launches


def check_mfu(rows: list[dict]) -> None:
    """Phase 22's checks on the sweep's rows: no ``error`` row, a first
    warm-up loss within LOSS0_TOL of EXPECTED_LOSS0 (the train and moe
    phases' check of the loss at initialisation), a finite loss, an MFU
    in (0, 1], and steps that launched K1 and the backward kernels the
    trainer routes to (K2, or K3 and K4)."""
    for r in rows:
        if "error" in r:
            fail(f"the MFU sweep's variant failed: {r}")
        per_step = r["launches_per_step"]
        if not (abs(r["loss0"] - EXPECTED_LOSS0) <= LOSS0_TOL
                and math.isfinite(r["loss"]) and 0 < r["mfu"] <= 1
                and per_step["flash_fwd"] > 0
                and (per_step["flash_bwd_fused"] > 0
                     or (per_step["flash_dq"] > 0
                         and per_step["flash_dkv"] > 0))):
            fail(f"the MFU sweep's row {r}")


def phase_mfu(smi: str) -> dict[str, int]:
    """Phase 22: ``scripts/mfu_explore_torch.py``'s quick variants in
    this process, the launch counts zeroed just before and read just
    after, the rows held by ``check_mfu``.  Returns the sweep's
    launches."""
    import contextlib

    from nos_tpu_torch.ops.roofline import peaks_for

    mfu = _mfu_module()
    t0 = time.perf_counter()
    _release()
    peak = peaks_for(torch.cuda.get_device_name(0))[0]
    _zero_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        rows = mfu.sweep(mfu.VARIANTS[:mfu.QUICK], peak, "cuda")
    launches = _launch_counts()
    PATH_TILES["mfu"] = _tile_counts()
    _release()
    check_mfu(rows)
    emit({"phase": "mfu", "nvidia_smi": smi,
          "seconds": time.perf_counter() - t0, "seq": mfu.SEQ,
          "warmup": mfu.WARMUP, "steps": mfu.STEPS, "repeats": mfu.REPEATS,
          "peak_flops": peak, "expected_loss0": EXPECTED_LOSS0,
          "loss0_tol": LOSS0_TOL, "rows": rows, "launches": launches,
          "tile_launches": PATH_TILES["mfu"]})
    return launches


# The sim phase.  (a) and (b): ``python -m nos_tpu_torch.sim`` as child
# processes (``WorstWeek.run`` resets the process's metrics registry,
# which the earlier phases' counters live in, and the child's one JSON
# line stays off this stdout).  Each report, less its wall time, must
# hash (fleet.plan_digest) to the JAX package's report of the same
# arguments on the CPU (tests/test_torch_sim.py), and exit as JAX's
# does: seed 1's smoke day has 2 breaches that no injected fault
# explains, so its gate fails in both packages.
SIM_RUNS = {
    "smoke": (["--smoke"], 0),
    "smoke_again": (["--smoke"], 0),
    "smoke_seed1": (["--smoke", "--seed", "1"], 1),
    "smoke_what_if": (["--smoke", "--what-if", "hosts=+120"], 0),
    "week": ([], 0),
}
SIM_DIGESTS = {
    "smoke": "711273235e1fbb70d81ff9bd0dbc91d6714efe1c0d80a06eb9ae564df87c9b07",
    "smoke_again":
        "711273235e1fbb70d81ff9bd0dbc91d6714efe1c0d80a06eb9ae564df87c9b07",
    "smoke_seed1":
        "c86b21c3defedeb5e42ed9301b85981863fcd4ad389051c90d970440aefea42d",
    "smoke_what_if":
        "0643b0e378fa219fcafe5b3730a0241b599de670249e5b1d5630ba3b55a79eb4",
    "week": "216bb211afae6d52ec126798c2b8a612cf71d01668fabcddb64b8a35653bfe7f",
}
SIM_TIMEOUT_S = 300
# (c): the scenario harness in process (it leaves the registry alone) on
# the JAX test's small story (tests/test_sim.py _small_scenario): two
# 8-GPU H100 MIG nodes of one pool and a quota, two pods of eight
# 7g.80gb each (a JAX 2x4 slice, its GB x 5), node pod-0-h1 killed at
# 4 s; event-styled and tick-styled.  fleet.plan_digest of its journal
# (under the plane's own journal) and pods: JAX's run, names mapped
SIM_HARNESS_DIGEST = \
    "3b5a39501a1765cdef3c4e6846024b037921acf9275093f8a427bba43fcd39d9"
SIM_HARNESS_HORIZON_S = 8.0
SIM_HARNESS_KILL_S = 4.0


def sim_report_digest(report: dict) -> str:
    """A worst-week report's digest, less its wall time."""
    from nos_tpu_torch.testing.fleet import plan_digest

    return plan_digest({k: v for k, v in report.items()
                        if k not in ("wall_s", "sim_speedup")})


def _sim_child(name: str) -> dict:
    argv, want_rc = SIM_RUNS[name]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nos_tpu_torch.sim", *argv], cwd=ROOT,
        env=_child_env(), capture_output=True, text=True,
        timeout=SIM_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if proc.returncode != want_rc:
        fail(f"sim {name} ({' '.join(argv) or 'the default week'}) exited "
             f"{proc.returncode}, JAX's exits {want_rc}:\n"
             f"{proc.stderr[-4000:]}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if len(lines) != 1:
        fail(f"sim {name} printed {len(lines)} lines on stdout, not one")
    report = json.loads(lines[0])
    digest = sim_report_digest(report)
    if digest != SIM_DIGESTS[name]:
        fail(f"sim {name}: report digest {digest}, JAX's "
             f"{SIM_DIGESTS[name]}")
    if not report["ledger"]["conservation_ok"]:
        fail(f"sim {name}: the ledger does not conserve")
    return {"rc": proc.returncode, "process_s": wall,
            "wall_s": report["wall_s"], "events": report["events"],
            "events_per_wall_s": report["events"] / report["wall_s"],
            "jobs": report["jobs"], "kills": report["kills"],
            "utilization": report["utilization"],
            "conservation_delta": report["ledger"]["conservation_delta"],
            "breaches": len(report["breaches"]),
            "unexplained_breaches": report["unexplained_breaches"],
            "hosts": report["hosts"], "pools": report["pools"],
            "what_if_delta": report.get("what_if", {}).get("delta")}


def _sim_harness(style: str) -> dict:
    """Phase 18 (c), one styling: ``event`` installs the plane's tick
    source and the kill as a PRIO_FAULT one-shot; ``tick`` hides the kill
    inside the tick body (the old idiom).  Returns the journal records
    (plan ids left out), the pods' (name, phase, node) and the host ms of
    each ``tick``."""
    from nos_tpu_torch.kube.client import KIND_POD
    from nos_tpu_torch.obs import scoped
    from nos_tpu_torch.sim import (
        PRIO_FAULT, PoolSpec, QuotaSpec, Scenario, SimEngine,
        assemble_control_plane, compose)
    from nos_tpu_torch.testing.factory import make_mig_pod

    eng = SimEngine()
    plane = assemble_control_plane(Scenario(
        name=style, horizon_s=SIM_HARNESS_HORIZON_S, tick_s=0.25, seed=3,
        pools=(PoolSpec("pod-0", hosts=2),),
        quotas=(QuotaSpec("work", min_gb=1280.0, max_gb=5120.0),)), eng)
    tick_ms: list[float] = []
    plane_tick = plane.tick

    def timed_tick() -> None:
        t0 = time.perf_counter()
        plane_tick()
        tick_ms.append((time.perf_counter() - t0) * 1e3)

    plane.tick = timed_tick
    with scoped(journal=plane.journal, ledger=plane.ledger):
        for i in range(2):
            plane.api.create(KIND_POD, make_mig_pod(
                "7g.80gb", 8, name=f"job-{i}", namespace="work"))
        if style == "event":
            compose(*plane.sources()).install(eng)
            eng.at(SIM_HARNESS_KILL_S, lambda: plane.kill_host("pod-0-h1"),
                   priority=PRIO_FAULT, label="node-kill")
        else:
            killed = [False]

            def tick_with_fault_check() -> None:
                if not killed[0] and eng.now() >= SIM_HARNESS_KILL_S:
                    killed[0] = True
                    plane.kill_host("pod-0-h1")
                timed_tick()

            eng.tick_loop(0.25, tick_with_fault_check,
                          until=SIM_HARNESS_HORIZON_S, label="ctl-tick")
        eng.run(until=SIM_HARNESS_HORIZON_S)
    journal = [[r.category, r.subject,
                sorted([k, str(v)] for k, v in r.attrs.items()
                       if k != "plan_id")]
               for r in plane.journal.events()]
    pods = sorted([p.metadata.name, p.status.phase, p.spec.node_name or ""]
                  for p in plane.api.list(KIND_POD))
    return {"journal": journal, "pods": pods, "tick_ms": tick_ms}


def sim_harness_digest(run: dict) -> str:
    from nos_tpu_torch.testing.fleet import plan_digest

    return plan_digest({"journal": run["journal"], "pods": run["pods"]})


def _sim_line(smi: str) -> dict:
    """Phase 18's line: the simulator on the card's host (no GPU is touched).
    (a) the smoke day twice, at seed 1 and with ``--what-if hosts=+120``,
    four children at once; (b) then the default week, 10,000 nodes x 8
    GPUs over 7 days; each a ``python -m nos_tpu_torch.sim`` child at
    JAX's digest and exit code.
    (c) the scenario harness event-styled and tick-styled in process:
    equal journals at JAX's digest, both pods Running.  There is no
    check of the kubelet device plugins here: they need grpcio, which
    the card's machine lacks."""
    t0 = time.perf_counter()
    # the smoke days at once, then the week alone
    smokes = [name for name in SIM_RUNS if name != "week"]
    with concurrent.futures.ThreadPoolExecutor(len(smokes)) as pool:
        runs = dict(zip(smokes, pool.map(_sim_child, smokes)))
    runs["week"] = _sim_child("week")
    harness = {style: _sim_harness(style) for style in ("event", "tick")}
    ev, tk = harness["event"], harness["tick"]
    if (ev["journal"], ev["pods"]) != (tk["journal"], tk["pods"]):
        fail("the harness's event- and tick-styled runs differ:\n"
             f"{ev['journal']}\n{tk['journal']}")
    digest = sim_harness_digest(ev)
    if digest != SIM_HARNESS_DIGEST:
        fail(f"the harness's journal digest {digest}, JAX's "
             f"{SIM_HARNESS_DIGEST}: {ev['journal']} {ev['pods']}")
    if [p[1] for p in ev["pods"]] != ["Running", "Running"]:
        fail(f"the harness's pods are not Running: {ev['pods']}")
    ticks = ev["tick_ms"] + tk["tick_ms"]
    return {"phase": "sim", "nvidia_smi": smi,
            "seconds": time.perf_counter() - t0, "runs": runs,
            "harness": {"journal_records": len(ev["journal"]),
                        "pods": ev["pods"], "digest": digest,
                        "ticks": len(ticks),
                        "tick_ms_median": statistics.median(ticks),
                        "tick_ms_max": max(ticks)},
            "kubelet_plugins": "not run: the card's machine has no grpcio"}


# -- phase 19: fleet (host only) ---------------------------------------------

# the digest of phase 19 (a)'s plan at full size (fleet.plan_digest of
# its desired state and journal), from the same plan on the CPU
FLEET_PLAN_DIGEST = \
    "2cd17e30ebda0677260d158c9fd2796785b03b86c62f5b1eac81dfae5f4efe09"
FLEET_PLAN_WORKERS = (1, 4)
FLEET_PLAN_TIMED = 3
FLEET_CYCLE_WARMUP = 5           # the first of them cold
FLEET_CYCLE_STEADY = 200
FLEET_HANDSHAKE_S = 30.0


def _scale_fleet_plans(domains: int | None = None,
                       hosts: int | None = None,
                       timed: int = FLEET_PLAN_TIMED,
                       ways: tuple[bool, ...] = (True, False)) -> dict:
    """Phase 19 (a): ``fleet.scale_plan_spec`` planned by the parallel
    planner at each of FLEET_PLAN_WORKERS, with the native fit screen and
    without it (``native_prescreen=False``): one untimed plan and
    ``timed`` timed each, host ms.  Every plan's desired state and
    journal must be the first's, and the screen must have failed classes
    where it ran (``prescreen_fails``, summed over the shards' spans).
    ``ways`` orders the runs with the screen (True) and without."""
    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.obs import journal as J
    from nos_tpu_torch.obs import trace
    from nos_tpu_torch.partitioning.core import (
        GeometryPlanner, ParallelGeometryPlanner)
    from nos_tpu_torch.partitioning.slicepart import (
        SlicePartitionCalculator, SliceProfileCalculator, SliceSnapshotTaker)
    from nos_tpu_torch.scheduler.framework import Framework
    from nos_tpu_torch.testing import fleet

    spec = fleet.scale_plan_spec(
        fleet.SCALE_DOMAINS if domains is None else domains,
        fleet.SCALE_HOSTS_PER_DOMAIN if hosts is None else hosts)
    state = fleet.build_cluster(spec)
    pending = fleet.build_pending(spec)
    out: dict = {"nodes": len(spec["nodes"]), "pending": len(pending)}
    first = None
    for native in ways:
        for workers in FLEET_PLAN_WORKERS:
            planner = ParallelGeometryPlanner(
                lambda: GeometryPlanner(
                    Framework(), SliceProfileCalculator(),
                    SlicePartitionCalculator(), native_prescreen=native),
                SliceProfileCalculator(), kind=C.MIG_KIND,
                max_workers=workers, min_shard_hosts=0)
            ms, fails = [], []
            try:
                for _ in range(1 + timed):
                    snap = SliceSnapshotTaker().take_snapshot(state)
                    journal = J.DecisionJournal(maxlen=1 << 16)
                    tracer = trace.Tracer()
                    prev_j = J.set_journal(journal)
                    prev_t = trace.set_tracer(tracer)
                    try:
                        t0 = time.perf_counter()
                        desired = planner.plan(snap, pending)
                        ms.append((time.perf_counter() - t0) * 1e3)
                    finally:
                        trace.set_tracer(prev_t)
                        J.set_journal(prev_j)
                    fails.append(sum(sp["counts"].get("prescreen_fails", 0)
                                     for sp in tracer.ring.dump()))
                    summary = fleet.parallel_plan_summary(desired, [
                        (r.category, r.subject, r.attrs)
                        for r in journal.events()
                        if r.category in (J.PLAN_NODE_COMMITTED,
                                          J.PLAN_NODE_REVERTED,
                                          J.PLAN_SHARD_MERGED)])
                    first = first or summary
                    if summary != first:
                        fail(f"the fleet's plan at {workers} workers, "
                             f"screen {'on' if native else 'off'}, differs "
                             f"from the first plan")
            finally:
                planner.close()
            if native and not min(fails) > 0:
                fail(f"the native screen failed no class at {workers} "
                     f"workers: prescreen_fails {fails}")
            if not native and any(fails):
                fail(f"the screen ran with native_prescreen=False: {fails}")
            out[f"{'on' if native else 'off'}_workers_{workers}"] = {
                "plan_ms_median": statistics.median(ms[1:]),
                "plan_ms_max": max(ms[1:]), "plan_ms_untimed": ms[0],
                "plan_ms": ms[1:], "prescreen_fails": fails[0]}
    out["digest"] = fleet.plan_digest(first)
    out["nodes_carved"] = sum(r[0] == J.PLAN_NODE_COMMITTED
                              for r in first["journal"])
    return out


def _fleet_cycle_run(native: bool, nodes: int, bound: int,
                     steady: int) -> dict:
    """One run of phase 19 (b): ``build_scheduler`` over
    ``fleet.scale_cycle_api``, a full collection (the fleet's build
    leaves garbage a later cycle would pay for), FLEET_CYCLE_WARMUP
    cycles (the first cold), ``steady`` timed cycles (the collector
    frozen, as bench_fleet.py does), then ``invalidate_all()`` and one
    backstop cycle.  Without ``native`` the scheduler's screen is dropped and its
    choose bound to the Python argmin, as a caller turns them off."""
    import gc

    from nos_tpu_torch.cmd.assembly import build_scheduler
    from nos_tpu_torch.kube.client import KIND_POD
    from nos_tpu_torch.obs import journal as J
    from nos_tpu_torch.obs import trace
    from nos_tpu_torch.testing import fleet

    api = fleet.scale_cycle_api(nodes, bound)
    sched = build_scheduler(api)
    if not native:
        sched._prescreen = None
        sched._native_choose = lambda pod, nis: None
    journal = J.DecisionJournal(maxlen=1 << 16)
    tracer = trace.Tracer()
    prev_j = J.set_journal(journal)
    prev_t = trace.set_tracer(tracer)

    def cycle() -> float:
        t0 = time.perf_counter()
        sched.run_cycle()
        return (time.perf_counter() - t0) * 1e3

    try:
        gc.collect()
        warm = [cycle() for _ in range(FLEET_CYCLE_WARMUP)]
        gc.collect()
        gc.freeze()
        try:
            times = [cycle() for _ in range(steady)]
        finally:
            gc.unfreeze()
        sched._cache.invalidate_all()
        backstop = cycle()
    finally:
        trace.set_tracer(prev_t)
        J.set_journal(prev_j)
        sched.close()
    fails = sum(sp["counts"].get("prescreen_fails", 0)
                for sp in tracer.ring.dump()
                if sp["name"] == "scheduler.run_cycle")
    pods = sorted((p.key, p.spec.node_name, p.status.phase)
                  for p in api.list(KIND_POD))
    times.sort()
    return {"cold_ms": warm[0], "warm_ms": warm[1:],
            "steady_p50_ms": statistics.median(times),
            "steady_p99_ms": times[min(len(times) - 1,
                                       int(0.99 * len(times)))],
            "steady_max_ms": times[-1], "backstop_ms": backstop,
            "prescreen_fails": fails,
            "pods": pods,
            "journal": [(r.category, r.subject, r.attrs)
                        for r in journal.events()]}


def _fleet_cycles(nodes: int | None = None, bound: int | None = None,
                  steady: int = FLEET_CYCLE_STEADY) -> dict:
    """Phase 19 (b): the scale tier's cycle with the native screen and
    choose and without them; the pods' bindings and the journal must be
    equal, and the screen must have failed the residents somewhere."""
    from nos_tpu_torch.testing import fleet

    nodes = fleet.SCALE_DOMAINS * fleet.SCALE_HOSTS_PER_DOMAIN \
        if nodes is None else nodes
    bound = fleet.SCALE_BOUND if bound is None else bound
    # one domain's worth first, both ways, untimed: the process's first
    # scheduler cycle pays first-use costs (imports inside functions,
    # first calls) that would land on whichever run went first
    for native in (True, False):
        _fleet_cycle_run(native, fleet.SCALE_HOSTS_PER_DOMAIN,
                         fleet.SCALE_HOSTS_PER_DOMAIN * 8, 1)
    runs = {"on": _fleet_cycle_run(True, nodes, bound, steady),
            "off": _fleet_cycle_run(False, nodes, bound, steady)}
    on, off = runs["on"], runs["off"]
    if on["pods"] != off["pods"]:
        fail("the scale fleet's bindings differ with the screen and without")
    if on["journal"] != off["journal"]:
        fail("the scale fleet's journal differs with the screen and without")
    if not on["journal"]:
        fail("the scale fleet journaled nothing")
    out: dict = {"nodes": nodes, "bound": bound,
                 "residents": sum(c for _, c in fleet.SCALE_RESIDENTS),
                 "journal_records": len(on["journal"])}
    for name, run in runs.items():
        out[name] = {k: v for k, v in run.items()
                     if k not in ("pods", "journal")}
    return out


def _fleet_line(smi: str) -> dict:
    """Phase 19's line: the native scheduling shim on the card's host (no
    GPU is touched): the library's build report (``native/gpu_shim.cc``,
    built in phase 2) and the GIL handshake from two threads, then (a) the
    1024-node plan and (b) the 1024-node scheduler cycle, each with the
    native paths and without them, to the same decisions."""
    from nos_tpu_torch.device import native
    from nos_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = native.build_report()      # built at first use
    handshake = native.gil_handshake(FLEET_HANDSHAKE_S)
    if handshake != [1, 1]:
        fail(f"the GIL handshake gave {handshake}: the binding holds the "
             f"GIL")
    plans = _scale_fleet_plans()
    if plans["digest"] != FLEET_PLAN_DIGEST:
        fail(f"the fleet plan's digest {plans['digest']} is not the pinned "
             f"{FLEET_PLAN_DIGEST}")
    cycles = _fleet_cycles()
    return {"phase": "fleet", "nvidia_smi": smi,
            "seconds": time.perf_counter() - t0,
            "shim": {"compiler": _build.host_compiler_version(),
                     "cached": report["cached"],
                     "build_s": report["seconds"],
                     "library": str(report["path"].relative_to(ROOT)),
                     "handshake": handshake},
            "plan": plans, "cycle": cycles}


# -- phase 20: determinism (host only) ---------------------------------------

DETERMINISM_CHILDREN = 4          # children at once (8 cores on the host)
DETERMINISM_MIN_RECORDS = 50


def _determinism_lint() -> dict:
    """Phase 20 (a): the port's analyzer over its own tree."""
    from nos_tpu_torch.analysis import default_rules, run

    t0 = time.perf_counter()
    report = run(default_rules(), [str(ROOT / "nos_tpu_torch")],
                 root=str(ROOT))
    seconds = time.perf_counter() - t0
    if report.violations:
        fail("noslint over nos_tpu_torch/:\n" + "\n".join(
            v.render() for v in report.violations))
    return {"files": report.files, "violations": 0,
            "suppressed": [v.render() for v in report.suppressed],
            "seconds": seconds}


def _determinism_matrix(cycles: int | None = None,
                        children: int = DETERMINISM_CHILDREN) -> dict:
    """Phase 20 (b): every cell of the harness's matrix in its own child,
    ``children`` at a time; the journals judged as ``run_matrix`` judges
    them."""
    from nos_tpu_torch.analysis import determinism as D

    cycles = D.DEFAULT_CYCLES if cycles is None else cycles
    cells = D.matrix_cells()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(children) as pool:
        results = list(pool.map(lambda c: D.run_cell(*c, cycles=cycles),
                                cells))
    seconds = time.perf_counter() - t0
    report = D.judge(results, verbose=False)
    if not report.ok:
        fail("the determinism matrix:\n" + "\n".join(report.failures))
    if report.records <= DETERMINISM_MIN_RECORDS:
        fail(f"the determinism journals hold {report.records} records, "
             f"not more than {DETERMINISM_MIN_RECORDS}")
    return {"cells": len(report.cells), "cycles": cycles,
            "children_at_once": children, "seconds": seconds,
            "records": report.records,
            "children": [{"cell": c.label, "wall_s": c.wall_s,
                          "trace_s": c.trace_s,
                          "records": len(c.output.splitlines())}
                         for c in report.cells]}


def _determinism_line(smi: str) -> dict:
    """Phase 20's line: noslint over the port's tree while the dual-run
    determinism matrix's children run (the lint holds one core, the
    children four of the host's eight; no GPU is touched)."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as background:
        pending = background.submit(_determinism_matrix)
        lint = _determinism_lint()
        matrix = pending.result()
    return {"phase": "determinism", "nvidia_smi": smi,
            "seconds": time.perf_counter() - t0, "lint": lint,
            "matrix": matrix}


# -- the deploy on-ramp (host only) ------------------------------------------

ONRAMP_RENDER_LIMIT_S = 120.0
_RENDERED = re.compile(r"^rendered (\d+) manifests from (\S+): (.*)$", re.M)
_VALIDATED = re.compile(
    r"^validated (\d+) ConfigMaps through the typed loaders; (\d+) CRDs "
    r"parsed$", re.M)


def _onramp_line(smi: str) -> dict:
    """The deploy on-ramp's line: ``hack/render-chart-torch.py`` as a
    process (its exit code, and its counts against the renderer's in this
    process); ``hack/kind/cluster-torch.yaml``'s two workers built with
    the model this host's discovery reads through NVML (no CUDA
    context); the example pods of ``deploy/config-torch/`` planned and
    bound over them by the port's partitioners and scheduler in memory
    (``testing/devcluster.py``).  No GPU is touched."""
    import yaml

    from nos_tpu_torch.api import constants as C
    from nos_tpu_torch.device import discovery
    from nos_tpu_torch.testing import devcluster, helm

    found = discovery.discover(allow_cuda=False)
    model = found.model.name

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="nos-onramp-") as out:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "hack/render-chart-torch.py"),
             "--out", out], cwd=out, env=_child_env(), capture_output=True,
            text=True, timeout=ONRAMP_RENDER_LIMIT_S)
        render_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"hack/render-chart-torch.py exited {proc.returncode}:\n"
                 f"{proc.stderr[-4000:]}")
        written = list(yaml.safe_load_all(
            pathlib.Path(out, "nos-tpu-torch.yaml").read_text()))
    rendered, validated = (_RENDERED.search(proc.stdout),
                           _VALIDATED.search(proc.stdout))
    if rendered is None or validated is None:
        fail(f"hack/render-chart-torch.py printed no summary:\n"
             f"{proc.stdout[-4000:]}")
    docs = helm.render_chart(ROOT / "deploy/helm/nos-tpu-torch")
    kinds: dict[str, int] = {}
    for doc in docs:
        kinds[doc["kind"]] = kinds.get(doc["kind"], 0) + 1
    printed = dict((k, int(n)) for k, _, n in (
        part.rpartition(" x") for part in rendered.group(3).split(", ")))
    crds = len(list((ROOT / "deploy/helm/nos-tpu-torch/crds").glob("*.yaml")))
    got = (int(rendered.group(1)), printed, int(validated.group(1)),
           int(validated.group(2)), written)
    want = (len(docs), kinds, helm.validate_configmaps(docs), crds, docs)
    if got != want:
        fail(f"hack/render-chart-torch.py's counts {got[:4]} are not the "
             f"renderer's {want[:4]}, or its manifests differ")
    nodes = devcluster.kind_nodes(model=model)
    kinds_of = {n.metadata.name: n.metadata.labels[C.LABEL_PARTITIONING]
                for n in nodes}
    if sorted(kinds_of.values()) != [C.MIG_KIND, C.MPS_KIND]:
        fail(f"the kind config's workers are {kinds_of}, not one MIG and "
             f"one MPS node")
    t1 = time.perf_counter()
    placed = devcluster.plan_and_bind(nodes, devcluster.example_pods())
    plan_bind_ms = (time.perf_counter() - t1) * 1e3
    by_kind = {v: k for k, v in kinds_of.items()}
    want_bound = {"train-example": by_kind[C.MIG_KIND],
                  "chat-replica-example": by_kind[C.MPS_KIND]}
    if placed["bound"] != want_bound:
        fail(f"the example pods were bound {placed['bound']} after "
             f"{placed['ticks']} ticks, not {want_bound}")
    return {"phase": "onramp", "nvidia_smi": smi,
            "seconds": time.perf_counter() - t0, "render_s": render_s,
            "manifests": len(docs), "kinds": kinds,
            "configmaps": want[2], "crds": crds, "model": model,
            "discovery": found.source,
            "nodes": kinds_of, "bound": placed["bound"],
            "ticks": placed["ticks"], "plan_bind_ms": plan_bind_ms,
            "geometry": placed["geometry"]}


# -- host work beside the card phases ----------------------------------------

# The host-only work, in the order the card phases read it: (a) of phases
# 11 to 17, then phases 18 to 20 and the on-ramp whole (HOST_LINES: each
# function takes the card's nvidia-smi line and returns its phase's
# line), as (key, function).  One background process runs it while this
# one drives the card phases.
HOST_JOBS = (("quota", "_quota_fleet_runs"), ("gang", "_gang_fleet_runs"),
             ("parallel", "_parallel_fleet_plans"),
             ("recovery", "_recovery_fleet_run"),
             ("defrag", "_defrag_fleet_runs"), ("serving", "_serving_fleets"),
             ("capacity", "_capacity_fleet_runs"), ("sim", "_sim_line"),
             ("fleet", "_fleet_line"), ("determinism", "_determinism_line"),
             ("onramp", "_onramp_line"))
HOST_LINES = ("sim", "fleet", "determinism", "onramp")
HOST_NICE = 10      # the card phases' processes go first on the host


def _host_worker(out_dir: str) -> None:
    """The background process: each job of ``out_dir``/jobs.json in turn,
    its result and seconds pickled to ``<key>.pkl``; a job that raises
    (a failed check among them) leaves ``<key>.err`` and ends the
    process.  It kills its own session, its children with it, once the
    smoke that started it is gone."""
    import os
    import pickle
    import traceback

    os.nice(HOST_NICE)
    parent = os.getppid()

    def orphaned() -> None:
        while os.getppid() == parent:
            time.sleep(1.0)
        os.killpg(0, signal.SIGKILL)

    threading.Thread(target=orphaned, daemon=True).start()
    out = pathlib.Path(out_dir)
    for key, fn, kwargs in json.loads((out / "jobs.json").read_text()):
        t0 = time.perf_counter()
        try:
            value = globals()[fn](**kwargs)
        except BaseException as e:
            (out / f"{key}.err").write_text(
                f"{e}\n{traceback.format_exc()}")
            raise
        part = out / f"{key}.part"
        part.write_bytes(pickle.dumps((value, time.perf_counter() - t0)))
        part.rename(out / f"{key}.pkl")


class _HostWork:
    """The background process of HOST_JOBS, in a session of its own so
    that ``close`` stops it and every process it started."""

    def __init__(self, jobs) -> None:
        self.dir = pathlib.Path(tempfile.mkdtemp(prefix="nos-host-"))
        (self.dir / "jobs.json").write_text(json.dumps(
            [list(job) for job in jobs]))
        self.keys = {key for key, _, _ in jobs}
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; "
             f"chip_smoke._host_worker({str(self.dir)!r})"],
            cwd=ROOT, env=_child_env(), stdout=sys.stderr,
            start_new_session=True)

    def result(self, key: str):
        """The job's (result, seconds), once the process has it."""
        import pickle

        self.keys.remove(key)
        done, err = self.dir / f"{key}.pkl", self.dir / f"{key}.err"
        while not done.exists():
            if err.exists():
                fail(f"the host work's {key}: {err.read_text()[-4000:]}")
            if self.proc.poll() is not None and not done.exists():
                fail(f"the host work's process exited {self.proc.returncode}"
                     f" before {key}")
            time.sleep(0.05)
        return pickle.loads(done.read_bytes())

    def close(self) -> None:
        import os
        import shutil

        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.proc.wait()
        shutil.rmtree(self.dir, ignore_errors=True)


_HOST: _HostWork | None = None


def _host_result(key: str, fn: str):
    """``fn()`` and its seconds: from the background process where main()
    queued the job, else computed here and now."""
    if _HOST is not None and key in _HOST.keys:
        return _HOST.result(key)
    t0 = time.perf_counter()
    value = globals()[fn]()
    return value, time.perf_counter() - t0


def main() -> int:
    global _HOST

    if len(sys.argv) > 1:
        fail("chip_smoke.py takes no arguments")
    if not torch.cuda.is_available():
        fail("no CUDA device: the smoke runs on the card only")
    smi = phase_env()
    device = phase_device()
    resources = phase_build()
    with tempfile.TemporaryDirectory(prefix="nos-no-cache-") as empty:
        _no_measured_cache(empty)
        entries = phase_kernels(resources)
        phase_autotune()
        # serve, train, train_main and moe see the committed PRETUNED only
        _no_measured_cache(empty)
        serve = phase_serve()
        train, loss0 = phase_train()
        train_main, main_loss0 = phase_train_main(loss0)
        moe = phase_moe()
        # from here on the host-only work runs beside the card phases
        _HOST = _HostWork([(key, fn, {"smi": smi} if key in HOST_LINES
                            else {}) for key, fn in HOST_JOBS])
        try:
            # the grant and partition children see the same PRETUNED-only
            # cache
            phase_grant(main_loss0, device)
            phase_partition(main_loss0, device, smi)
            phase_mig(device, smi)
            phase_quota(main_loss0, device, smi)
            gang = phase_gang(main_loss0, device, smi)
            block = phase_block(main_loss0, device, smi)
            recovery = phase_recovery(main_loss0, device, smi)
            mains = phase_mains(main_loss0, device, smi)
            elastic = phase_elastic(main_loss0, device, smi)
            serving = phase_serving(main_loss0, device, smi)
            capacity = phase_capacity(main_loss0, device, smi)
            for key in HOST_LINES:
                emit(_HOST.result(key)[0])
        finally:
            _HOST.close()
            _HOST = None
        demo = phase_demo(device, smi)
        mfu = phase_mfu(smi)
    paths = {"serve": serve, "train": train, "train_main": train_main,
             "moe": moe, "gang": gang, "block": block,
             "recovery": recovery, "mains": mains,
             "elastic": elastic, "serving": serving, "capacity": capacity,
             "demo": demo, "mfu": mfu}
    for entry in entries:
        name = entry["name"]
        kernel = TILES[name][0]
        entry["launches_by_path"] = {p: PATH_TILES[p][name] for p in paths}
        entry["launches"] = sum(entry["launches_by_path"].values())
        entry["launches_autotune"] = PATH_TILES["autotune"][name]
        # every kernel runs on the main path at one tile or another
        if not sum(paths[p][kernel] for p in paths) > 0:
            fail(f"{kernel} was not launched on the main path")
        if not (entry["launches"] > 0 or entry["launches_autotune"] > 0):
            fail(f"{name} was launched neither on the main path nor by "
                 f"the autotune phase")
    for p, counts in paths.items():
        by_tile = {k: sum(PATH_TILES[p][n] for n, (kk, _, _) in
                          TILES.items() if kk == k) for k in counts}
        if by_tile != counts:
            fail(f"the {p} phase's launches by tile {PATH_TILES[p]} do not "
                 f"add up to its launches {counts}")
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
