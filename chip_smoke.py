#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]

1. Prints the card's name and power limit as ``nvidia-smi`` gives them.
2. Builds the Hopper kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc``, one process per source, all started together (into
   ``build/repro_torch_kernels/``).
3. ``engine``: BlobShuffle's engine layer, the port's copy of the JAX
   package's ``core``, ``obs`` and ``cluster``, on the host (numpy and
   Python on a virtual clock; no tensor, no kernel), through
   ``repro_torch.launch.engine``. (a) The paper's deployment
   (``SimConfig()``: 12 nodes x 2 instances, 216 partitions, 3 AZs) by
   ``simulate_async`` with exactly-once commits and ingest batches of
   1,024, cut to 1% of the offered 3.16 GiB/s and of the batch size for
   10 virtual seconds (331,350 records of 1 KiB), the scale of the JAX
   package's measured lane. (b) The training input's faulty elastic
   engine (``FaultyStore`` over ``ExpressOneZoneStore``, 9 partitions
   over 3 instances, a cooperative ``ElasticCluster`` with AZ 1 out at
   0.30 s), fed 6,000 ShuffleBench records; it must rebalance. Each run
   must deliver every produced record exactly once, in its partition.
   Prints the summary (p50, p95, p99 and makespan in virtual seconds,
   throughput, cost per GiB), the store's (and in (b) the cluster's and
   faults') stats, the wall seconds on the host's clock and a
   ``stable_hash64`` digest of the delivered records (a report, not a
   gate; the JAX package's digest of the same run is in ``PERF.md``).
   Then ``gpipe``: ``repro_torch.distributed.gpipe_apply`` over the 4
   stages of ``StackedMesh(pod=4)`` (``GPIPE_MESH``), f32 stages
   ``tanh(x @ w + b)`` of width 2,048 on a batch of 8,192 in 8
   microbatches, against the sequential stack: y within ``GPIPE_TOL``
   (atol and rtol), the gradients of ``w`` and ``b`` within
   ``GPIPE_GRAD_TOL`` relative Frobenius; no kernel of the port
   launched. Prints the worst difference, the gradients' errors and both
   wall times (one card runs the stages in turn: a report, no speedup).
   The process-group pipeline differentiates too; it is held over gloo
   in the tests only, as NCCL refuses two ranks on one card. Then
   ``dryrun_plan``: the dry run's twin (``repro_torch.launch.dryrun``)
   plans every cell of ``all_cells()`` on both production meshes (data 16
   x model 16, pod 2 x data 16 x model 16), 31 a mesh, in this process on
   the host (no kernel, no module of JAX); ``dryrun.HBM_PER_CHIP`` must be
   the card's ``total_memory``. Prints each cell's argument GB a device
   (the sharding plan's bytes, not a measurement), the cells over the
   card and the seconds.
4. Blob data plane: holds each blob kernel against its plain PyTorch
   version on the card, bit for bit, over payload dtypes, overflow,
   empty bins, ragged tiles and two rows-per-block values; then runs the
   deployment round trip through ``repro_torch.shuffle.api``: one second
   of the paper's offered load, 3,240,000 records of 1 KiB (512 bf16)
   over 216 partitions (``SimConfig``: 12 nodes x 2 instances x
   partitions_factor 9). The plain round trip must return every record
   bit for bit, the codec round trip must equal its plain version bit for
   bit and lie within half a quantization step of each record. Then
   ``deployment_host_paths``: the same records and keys copied to the
   host through the host fast paths, ``blob_pack_fused_host`` and
   ``compress_pack_fused_host``, once into a fresh output and
   ``HOST_RUNS`` times into a reused arena, each output bit for bit the
   CUDA kernel's of this run and its (order, starts, counts) the card's;
   prints the cold and best reused seconds and GB/s of the logical input
   beside the kernels' times, the host's cores and torch's threads. Its
   tensors, on the card and on the host, are freed before the model
   loads.
5. Model kernels: flash attention against its plain version at head dims
   64, 80, 128 and 256, GQA, MQA, non-causal and ragged, in bf16 and f32
   (bf16 also at 16, 48 and 96, and 144, 176 and 192: the kinds of tail
   box at both kv tile sizes), each case through the kernel its dtype
   selects (its launch counter must say so), and in f32 at Zamba2's
   shared-block shape (timed as well, beside
   ``scaled_dot_product_attention`` in f32); each output within ``atol +
   rtol |want|`` and a bound on the relative Frobenius error
   (``FLASH_TOL``); each bf16 case also reports its gap to
   ``flash_ref_f32p`` (probabilities and V in f32, as the Pallas kernel
   keeps them), a report and no gate. At gemma-2b's shape (S 4,096, 8
   heads, 1 kv head, D 256, causal) and deepseek-v2-lite's (S 4,096, 16
   heads of D 192) the routed wgmma kernel and the ``mma.sync`` kernel,
   which no route takes, are each held against the plain version and
   timed on the same inputs, beside SDPA, the plain version and the
   bound. The SSD chunk against its plain version at N 64 and 128,
   two groups, chunks of 64 and 256, ragged lengths, mamba2-130m's 24
   heads and a bf16 shape off the tensor-core contract (1e-4 atol and
   rtol, all four outputs), each case through the kernel its dtype and
   shape select, and ``ssd_scan_op`` against ``ssd_chunked``; and in the
   bf16-intra mode (``intra_bf16``: the intra-chunk tensors rounded to
   bf16 as the JAX package's ``ssd_chunked(..., intra_bf16=True)`` does)
   a bf16 case on each kernel, an f32 one and P 128 on the tensor-core
   kernel (its scores per head), through the ``*_bf16i`` launchers,
   y_intra within ``INTRA_BF16_TOL`` (relative max) of
   ``ssd_chunk_ref(..., intra_bf16=True)`` and the other outputs within
   1e-4. Then phase ``flash_q_offset``: the flash kernels with a query
   offset (query row i at position i + q_offset under the causal mask),
   each edge case (``FLASH_OFFSET_EDGES``: suffixes, an offset off every
   kv tile, one past Skv, non-causal, the f32 kernel) through the kernel
   its dtype selects, within ``FLASH_TOL`` of ``flash_ref(...,
   q_offset=)``; then ``attention_op`` with qwen2-moe-a2.7b's and
   deepseek-v2-lite-16b's configs on the last 512 queries of 4 x 4,096
   (q_offset 3,584; D 128 and 192), one wgmma launch each, within
   ``FLASH_TOL`` of the plain version and of the same rows of the full
   causal call (bitwise equality reported), timed beside SDPA with
   ``causal_lower_right(512, 4096)``, the plain version and the bound;
   prints its own seconds.
6. Zamba2-2.7B at full width (54 layers, d 2560, parameters drawn on the
   card from the seed): ``make_prefill_step`` on 4 requests of 4,096
   tokens must launch the wgmma flash kernel 9 times (and no other flash
   kernel) and the tensor-core SSD chunk 54 times (and the CUDA-core one
   never), and give finite logits; the q, k, v of the first shared-block
   call and the SSD inputs of the first Mamba2 layer are captured and each
   kernel is held against its plain version on them (flash also reports
   its gap to ``flash_ref_f32p``); the CUDA-core SSD kernel is timed on
   the captured inputs, in bf16 and in f32. Then decode as
   ``repro_torch.launch.serve`` does it: 4 prompts of 16 tokens and 48
   new tokens through ``make_decode_step``; the decode logits over the
   prompt must match the prefill logits of the same prompt (f32: 5e-3;
   bf16: a tenth of the largest logit). Prints prefill and decode
   tokens/s and peak memory. Then phase ``zamba2_intra_bf16``: the same
   weights with ``ssm.intra_bf16`` (the dry run's ``--ssd-bf16``), one
   prefill on the same 4 x 4,096 tokens, which must launch the
   tensor-core bf16-intra launcher 54 times, the wgmma flash kernel 9
   times and no other kernel (the f32-intra launchers never); the first
   Mamba2 layer's captured per-chunk terms against ``ssd_chunk_ref(...,
   intra_bf16=True)`` (y_intra within ``INTRA_BF16_TOL``, the others
   within 1e-4); the logits' gap to the f32-intra prefill's, a report;
   decode as ``repro_torch.launch.serve`` does it (4 prompts of 16
   tokens, 8 new tokens) within a tenth of the largest logit of its
   prefill; both bf16-intra launchers timed on the captured inputs (the
   CUDA-core one in bf16 and f32).
7. The ``decoder`` configs at full width, each once the last phase's
   tensors are freed, parameters drawn on the card from the seed:
   qwen2-moe-a2.7b (24 layers, d 2048, 60 routed experts top-4 and 4
   shared, 14.3 G f32 parameters), deepseek-v2-lite-16b (27 layers of
   MLA, 16 heads of q/k 192 and v 128 over a 512 latent; a leading dense
   layer of d_ff 10,944, then 26 MoE layers of 64 routed experts top-6
   and 2 shared; 15.7 G) and gemma-2b (18 layers, 8 heads of 256 over
   one kv head, GeGLU of 16,384, scaled tied embeddings of 256,000;
   2.5 G). ``make_prefill_step`` on 4 requests of 4,096 tokens must
   launch the wgmma flash kernel once a layer and the blob pack and
   unpack kernels once a MoE layer (the layer's scatter and gather), and
   no other kernel (24/24/24, 27/26/26, 18/0/0), leave
   ``MIN_HEADROOM_GB`` of the card free, and give finite logits; each MoE
   layer's expert load and the units its capacity dropped are reported.
   On the first MoE layer's captured input the pack and unpack kernels
   must equal the index-based ``scatter_to_bins``/``gather_from_bins``
   bit for bit, and the layer the same layer through those helpers
   (``moe_layer_indexed``); flash is held against its plain version on
   the first attention call's q, k, v (D 128, 192 and 256). Decode as
   ``repro_torch.launch.serve`` does it (4 prompts of 16 tokens, 32 new
   tokens), timed; at a capacity factor of E (no unit can drop, and the
   loads show none did) its logits over the prompt must match prefill's
   within a tenth of the largest logit. Prints prefill and decode
   tokens/s, peak memory, the init time, a ``torch.profiler`` breakdown
   of one prefill, and for the MoE configs the time of one layer's bf16
   weight copies, and decode and prefill with the checks that sync the
   host (on the keys and on the pack's order) and without them, in turn.
   After deepseek-v2-lite's EP phase and gemma-2b's, the rest of the
   JAX package's configs (``NEW_SERVE_PHASES``), each the same way:
   granite-3-2b (40 layers, 32 heads of 64 over 8 kv heads, tied
   embeddings), starcoder2-3b (30 layers, 24 heads of 128 over 2, GELU
   and q/k/v biases), hubert-xlarge (phase ``hubert_xlarge_encode``: the
   encoder, 48 layers, 16 heads of 80, non-causal, on 4 x 4,096 bf16
   frames of the audio stub plus sinusoidal positions; its decode must be
   refused by name by ``lm.init_cache``, ``launch.serve.generate`` and
   the serve launcher), llava-next-34b (16 of its 60 layers, 56 heads of
   128 over 8; each request 2,880 bf16 patches of the vision stub before
   1,216 tokens; decode checked against the prefill of its text-only
   prompt, as decode takes no patches) and qwen2-72b (8 of its 80
   layers, 64 heads of 128 over 8, vocab 152,064). Each checks its
   parameter count against the (cut) config, one wgmma flash launch a
   layer (non-causal for hubert), the flash kernel against its plain
   version on the first layer's q, k, v, and reports the item order
   the launcher's rule picks.
8. deepseek-v2-lite-16b at full width once more, its MoE layers over the
   ranks of a stacked mesh (``EP_MESH``: pod 2 x model 16, the EP domain
   of the JAX package's multi-pod production mesh, the data axis cut
   from 16 to 1), phase ``deepseek_v2_lite_ep``. ``make_prefill_step``
   with the mesh on 4 requests of 4,096 tokens in the ``direct``,
   ``blob`` and ``blob`` with int8 modes (capacity factor 1.25): the
   wgmma flash kernel once a layer, and the pack and unpack kernels once
   a MoE layer each in direct, five and three times in blob
   (``EP_LAUNCHES``), and no other kernel; ``MIN_HEADROOM_GB`` free;
   finite logits; every MoE layer's ``dcn_bytes`` equal to
   ``EP_DCN_BYTES`` (counted from the buffer shapes; the stacked
   all-to-all is a copy on one card, not a network), its loads and drops
   reported; one blob prefill under ``torch.profiler``. On layer 1's
   captured input, each mode through the kernels must equal, bit for
   bit, the same layer through the index-based binning helpers rank by
   rank (``binning.IndexedBinning``), its loads the dense layer's; at a
   capacity factor of E the first ``EP_NO_DROP_TOKENS`` tokens drop no
   unit and flat and blob lie within ``EP_DENSE_TOL`` of the dense layer,
   blob with int8 within ``EP_INT8_TOL``; the routed part of the layer is timed in each
   mode and in the dense one. Decode in blob mode as
   ``repro_torch.launch.serve`` runs it (4 prompts of 16 tokens, 32 new
   tokens, each step's 4 tokens padded to the 32 ranks), timed, and
   within a tenth of the largest logit of prefill at a capacity factor
   of E.
9. ``kernel_grads``: each autograd Function's gradients on the card
   against torch autograd through its plain version, on the same seeded
   inputs, each case counting its launches: flash attention at B 1, S
   4,096, causal, bf16, at each serving head dim (``GRAD_FLASH_SHAPES``;
   dq, dk, dv within ``GRAD_FLASH_TOL`` relative Frobenius error; one
   wgmma launch, the backward plain torch); the SSD chunk at Zamba2's
   first Mamba2 layer (B 1, S 4,096, 80 heads of 64, N 64, chunks of
   256; within ``GRAD_SSD_TOL`` of the largest entry; one tensor-core
   launch), and ``ssd_scan_op``'s gradients against ``ssd_chunked``'s;
   pack and unpack at deepseek-v2-lite's MoE shape (98,304 units of
   2,048 bf16, 64 bins of 1,920, skewed keys): unpack's backward bit for
   bit, pack's bit for bit where ``order`` is a permutation and within
   one bf16 rounding of an f32 sum where each token's row repeats
   (top-6), each backward launching the other kernel once; and flash at
   q_offset 3,584 (the last 512 queries of 4,096, 16 heads of 128),
   within ``GRAD_FLASH_TOL``, one wgmma launch.
10. ``deepseek_v2_lite_train``: deepseek-v2-lite-16b at published widths
   with 3 of its 27 layers (``TRAIN_LAYERS``: the dense layer 0 and two
   MoE layers, 1.670 G f32 parameters drawn on the card), 4 x 4,096
   tokens in 2 microbatches, remat ``full``, bf16 compute, capacity
   factor 1.25. (a) 8 plain steps on one batch (dense dispatch): finite
   losses and gradient norms, the last loss below the first, 12 flash,
   12 pack and 12 unpack launches a step and no other kernel
   (``TRAIN_*_LAUNCHES``), ``MIN_HEADROOM_GB`` free; one step under
   ``torch.profiler``; the dry run's ``cell_state`` of (a)'s cell on a
   one-rank mesh must equal, group by group, the bytes of the tensors
   (a) holds: the ``LM``'s parameters, the AdamW state and the batch.
   (b) Each pod's gradients for its half of the batch (``EP_MESH``'s 2
   pods), synced by
   ``grad_sync.blob_allreduce_grads``: exact within ``SYNC_EXACT_TOL``
   of the plain mean, int8 within ``SYNC_INT8_TOL`` of the largest
   entry; the blobs and the bytes each pod sends. (c) BlobShuffle's
   training configuration, 3 steps: the ``blob_int8`` gradient sync with
   the shuffle ``blob`` made pod-local; as in the JAX package's train
   step, the pod region's loss gets no mesh, so every MoE call takes the
   dense dispatch (checked); twice the launches of (a), every MoE call's
   ``dcn_bytes`` 0. Then the kernels at one microbatch's shapes, with
   the plain flash backward's time and its share of a plain step; the
   pack and unpack rows give their launches a step counted in (a) and
   those at the timed shape (``launches_at_timed_shape``: the forward's
   and the recompute's, 8; unpack's 12 also count pack's backward, an
   unpack of the same shape; unpack's backward is a pack at another).
   (d) The ``auto`` step with expert parallelism, 3 steps: the shuffle
   ``blob`` at the config's capacity factor over ``EP_MESH``'s 32
   stacked ranks, the stacked twin of the step over a
   ``ProcessGroupMesh`` (NCCL refuses two ranks on one card, so no
   process group of more than one rank runs here): finite losses and
   gradient norms, every MoE call over the mesh with ``dcn_bytes`` above
   0, 12 flash, 52 pack and 36 unpack launches a step and no other
   kernel (``TRAIN_EP_*_LAUNCHES``), no module of JAX loaded. Its
   reference runs last, on the fresh parameters drawn again from the
   seed: the expert-parallel
   loss and gradients at a capacity factor of E (no unit dropped)
   against the dense dispatch's on the first ``TRAIN_EP_REF_TOKENS``
   tokens, within ``TRAIN_EP_LOSS_TOL`` and ``TRAIN_EP_GRAD_TOL``. Each
   blob call's drops, from the fresh and the trained parameters, are
   printed beside the largest expert load over the mean and the units
   over the last stage's capacity and over the dense layer's.
11. ``deepseek_v2_lite_shuffle_fed``: BlobShuffle as the training input.
   The same 3 layers trained for 12 steps by ``repro_torch.train_input``'s
   ``train_shuffle_fed``: each step's 4 x 4,096 tokens (4 records of
   16,388 bytes) go through the training benchmark's faulty elastic
   engine (``launch.engine.faulty_elastic_engine``: AZ 1 out at 0.30 s
   of the virtual clock, a step every 0.05 s) and ``ShuffleFedInput``
   onto the card; the test mesh (pod 2, data 2, model 2), the ``blob``
   shuffle at capacity factor 2.0 and the ``blob_int8`` sync as in the
   benchmark, (c)'s microbatches, remat and bf16, (a)'s optimizer.
   Steps 0-11 served once each, each batch ``reference_batch``'s bit
   for bit; a fresh pipeline's first batch valid against the input
   specs (``validate_device_batch`` equal to ``input_spec_report``) and
   ``lower_train_step`` run at its shape; overlap >= 0.5; finite losses,
   the last 3 below the first 3 on average; (c)'s launches a step and no
   other kernel; no module of JAX loaded. Prints the step seconds and
   tokens/s, the input's host wait, prefetch and overlap, the records
   delivered and replayed, the rows filtered, the rebalances, the losses
   and the peak memory; hands its losses, steps, peak and final
   parameters' digest to 13 through ``RESULTS``.
12. ``shuffle_fed_process_group``: the training input and the train step
   over a ``ProcessGroupMesh``, on one NCCL process group of one process
   (world 1, a file rendezvous in a temporary directory; the mesh is
   ``launch.mesh.process_group_test_mesh``'s, data 1). 11's model, seed,
   stream, engine and pipeline, the ``blob`` shuffle and the ``auto``
   sync (the blob sync needs pod > 1), ``PG_STEPS`` steps of
   ``train_shuffle_fed``; then the group is destroyed and the same loop
   runs over a ``StackedMesh`` of the same axes (so it reads no default
   group). Checks: the backend is ``nccl``; in both runs every batch is
   ``reference_batch``'s bits and its first batch's
   ``validate_device_batch`` report is ``input_spec_report``'s on that
   mesh; finite losses; the two runs' losses and final parameters the
   same bits, compared on the card (or else the largest relative loss
   gap within ``PG_LOSS_TOL``, printed); (c)'s flash, pack and unpack launches a
   step in both and no other kernel; the group destroyed; no module of
   JAX loaded. Prints each run's step seconds and peak memory and the
   phase's seconds.
13. ``deepseek_v2_lite_shuffle_resume``: the training benchmark's crash
   lane (``benchmarks/train_input.py``'s resume lane) at published
   widths. 11's model, seed, stream, train config, engine and pipeline,
   checkpointed by ``train_shuffle_fed`` into
   ``BlobCheckpointer(TieredCheckpointStore(FaultyStore(SimulatedS3)))``
   with synchronous uploads (the lane's store, in host memory): a run
   that crashes mid-step ``RESUME_CRASH_AT`` (8), then a ``resume=True``
   run from the same engine factory and checkpointer. The uninterrupted
   lane is 11's own 12-step run (its losses, peak and parameter digest
   handed over in ``RESULTS``). Cuts against the benchmark's ``--quick``
   (a manifest every 4, a crash at 6): a manifest every
   ``RESUME_CKPT_EVERY`` (6) and a crash at 8, so that the store holds
   manifests 0, 6 and 12 (60.1 GB of host memory, not 80.2 GB for 0, 4,
   8, 12), while the resumed run still re-trains two uncommitted steps
   and the crash still comes after the AZ outage. Checks: the crashed
   run trained 0..7, the resumed one starts at 6 with its offsets
   checked and trains 6..11; the committed prefix and the resumed steps
   are 0..11 once each; the spliced losses are 11's bit for bit, and the
   final parameters' sha256 11's; the manifests are exactly 0, 6 and 12,
   each of the manifest's bytes; manifest 6's offsets are what the
   resume replayed; each step call launches 11's kernels a step and no
   other; the card holds under 0.5 GB between the two runs; the peak is
   within ``RESTART_PEAK_MARGIN_GB`` of 11's; ``RESTART_HOST_SPARE_GB``
   of host memory free around every save and the restore, and the
   store's memory given back once it is deleted; no module of JAX
   loaded. Prints each save's host copy and upload s, the restore's and
   the fast-forward's s, both runs' step s, the store's retries and the
   host memory around each. Last, ``python -m
   repro_torch.launch.shuffle_train --steps 12 --crash-at 6`` and then
   ``--resume`` (SMOKE, on the card) as two processes under one
   temporary ``TMPDIR``: the first must print ``CRASHED``, the second
   ``OK ... start_step=4``.
14. ``deepseek_v2_lite_restart``: blob checkpoints and restart. The same
   3 layers, seed, batch and plain step as (a) of 10, 4 steps twice: once
   uninterrupted, and once driven by ``repro_torch.runtime``'s
   ``FaultTolerantTrainer`` (``ckpt_every`` 2, async uploads, one
   injected failure at step 3) over a ``TieredCheckpointStore`` on a
   ``FaultyStore(SimulatedS3)`` in host memory, as the JAX package's
   training benchmark checkpoints: manifests 0, 2 and 4 of the JAX
   package's layout (88 leaves, 20.04 GB each) and one restore, of step
   2, into the model's tensors in place. The host's available memory is
   read first; the phase fails unless three manifests fit with
   ``RESTART_HOST_SPARE_GB`` to spare, and that spare must hold before
   and after every save. The restarted run's losses and final parameters
   must equal the uninterrupted run's bit for bit, every step run (5 with
   the replayed one) must launch (a)'s kernels and no other, and the
   card's peak stay within ``RESTART_PEAK_MARGIN_GB`` of (a)'s. Prints
   the manifest's bytes, each save's seconds (its host copy and its
   commit), the restore's, the host headroom around each save, the
   store's retries and the peak; then deletes the store. Last, ``python
   -m repro_torch.launch.train --arch deepseek-v2-lite-16b --steps 4
   --ckpt-every 2 --ckpt-dir <tmp>`` (SMOKE, on the card) must commit
   manifests 0, 2 and 4.
15. ``deepseek_v2_lite_elastic``: the elastic restore. The same 3 layers'
   parameters (1,670,135,296 f32, drawn on the card from the seed) and
   two restore plans from ``repro_torch.runtime.elastic_restore_plan``
   over ``lm.param_defs`` and ``DEFAULT_RULES``: ``EP_MESH``'s (pod 2 x
   data 1 x model 16: dp_degree 2, 32 devices) and ``ELASTIC_MESH``'s
   (pod 1 x data 4 x model 4: 4, 16). The parameters are saved with
   synchronous uploads into a ``TieredCheckpointStore(SimulatedS3)`` in
   host memory (one params-only manifest, 4 bytes a parameter; the host
   must hold it with ``RESTART_HOST_SPARE_GB`` to spare), then restored
   with ``shardings=`` the second plan's into a model drawn from another
   seed: every parameter's sha256 must equal the saved one's, and one
   prefill of each model through ``make_prefill_step`` (4 x 4,096
   tokens) must give the same logits bit for bit, each launching the
   wgmma flash kernel (D 192) 3 times and the pack and unpack kernels
   twice, and no other kernel. Prints both plans' ``dp_degree``,
   ``devices`` and sharded leaves, the leaves whose spec differs between
   them, the save's host copy and upload s and the restore's s (host
   clock), the host memory around each, the peak device memory (of the
   path, and with the checks' temporaries over the two logits) and the
   launches; then deletes the store, whose host memory must come back.
16. Prints the script's seconds (``script``), then one ``kernels`` line:
   per kernel its launches on its main path (the round trip, or one
   prefill), its median time over repeated runs
   with CUDA events at that path's shapes, its bytes and operations and
   the bound they set (3.35 TB/s; 989 TFLOP/s bf16), the plain version's
   time, and one PyTorch call that computes the same function as
   yardstick (``library_ms``: ``torch.index_select`` for the pack and
   unpack kernels, ``scaled_dot_product_attention`` for flash; null for
   the codec kernels, which no one call computes, where the same row
   gather is timed as ``bytes_reference_ms``, and for the SSD chunk).
   The flash and SSD rows name the kernel that ran (``symbol``). The
   wgmma flash kernel has a row at each wide shape of phase 5 too
   (``flash_attention_wide``), whose path is one call of
   ``flash_attention_op`` at that shape (``path``; its launches are
   counted from 0 over that call alone), with the ``mma.sync`` kernel's
   time beside it (``mma_sync_ms``); and at each suffix of phase 5's
   ``flash_q_offset`` (``flash_attention_q_offset``), whose path is one
   ``attention_op`` call at q_offset 3,584, its launches counted from 0
   over that call. Each decoder prefill adds rows with
   its ``path`` (``qwen2_moe_prefill``, ``deepseek_v2_lite_prefill``,
   ``gemma_2b_prefill``): flash at the prefill's shape (D 128, 192, 256
   at B 4) and the pack and unpack kernels at the MoE layer's shape
   (65,536 units of 2,048 bf16 into 60 bins of 1,368; 98,304 into 64
   bins of 1,920), each with its launches in that prefill; so do the
   five later configs (``flash_attention_granite``, ``_starcoder2``,
   ``_hubert``, ``_llava``, ``_qwen2_72b``: D 64, 128, 80 non-causal,
   128, 128 at B 4, with ``causal`` and ``item_order``). The EP phase
   adds the pack and unpack rows at each mode's stage-1 shapes (32 ranks
   of 3,072 units of 2,048 bf16 into 64 lanes of 64, or 16 blobs of
   240), ``path`` ``deepseek_v2_lite_ep_<mode>_prefill``, with the
   kernel's launches in that prefill (``launches``, all shapes) and
   those at the timed shape (``launches_at_timed_shape``, one a MoE
   layer). The training rows (``path`` ``deepseek_v2_lite_train``: flash,
   pack and unpack at one microbatch's shapes, with their launches a
   step and, for pack and unpack, those at the timed shape) and the SSD
   chunk's (``path`` ``kernel_grads``) follow.
17. Ends with ``{"ok": true, "device": {...}}``.

Every check raises, so any failure exits non-zero. Without a CUDA device
the script exits non-zero before it prints any result.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

RECORDS = 3_240_000           # 3.16 GiB/s of 1 KiB records, for one second
WIDTH = 512                   # 1 KiB records as bf16 rows
PARTITIONS = 216              # 12 nodes x 2 instances x partitions_factor 9
CAPACITY_ROUND = 128

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # H100 SXM, f32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM, bf16 tensor cores, dense
TIMED_RUNS = 20

# Zamba2-2.7B serving: 4 requests of its 4,096-token context; decode as
# repro_torch.launch.serve runs it
ARCH = "zamba2-2.7b"
PREFILL_BATCH, PREFILL_LEN = 4, 4096
PROMPT_LEN, NEW_TOKENS = 16, 48
# flash kernel against its plain version: (atol, rtol, relative Frobenius
# error). bf16: the final rounding may differ by one bf16 step (rtol), and
# the probabilities are rounded to bf16 at another scale than the plain
# version's, which shows in the causal rows of few keys (atol); f32: the
# same math in another order.
FLASH_TOL = {torch.bfloat16: (8e-3, 1e-2, 5e-3), torch.float32: (2e-5, 1e-5, 1e-5)}
SSD_TOL = 1e-4                # atol and rtol, f32 outputs
# y_intra of the bf16-intra mode against its plain version: relative max,
# tests/test_torch_ssd_intra_bf16.py's KERNEL_TOL (a bf16 rounding of a
# score flips where the f32 sums of C.B^T differ by an ulp)
INTRA_BF16_TOL = 1e-3
INTRA_BF16_NEW_TOKENS = 8
GAP_TOL_F32 = 5e-3            # prefill vs decode logits, f32 compute
GAP_TOL_BF16 = 0.1            # ... bf16 compute, times the largest |logit|
# the decoder configs' serving (qwen2-moe-a2.7b, 57.3 GB of f32
# parameters and 5.0 GB of bf16 logits; deepseek-v2-lite-16b, 62.8 GB and
# 3.4 GB; gemma-2b, 10.0 GB and 8.4 GB): 4 requests of 4,096 tokens;
# decode as repro_torch.launch.serve runs it, 4 prompts of 16 tokens and
# 32 new tokens
DECODER_PREFILL_BATCH = 4
DECODER_NEW_TOKENS = 32
MIN_HEADROOM_GB = 4.0         # free device memory the prefill must leave
# the rest of the JAX package's configs, served the same way: (arch,
# phase, flash row, layers). llava-next-34b and qwen2-72b are cut in depth
# to fit the card with their f32 parameters (16 of 60 layers: 9.84 G,
# 39.4 GB; 8 of 80: 9.51 G, 38.1 GB; all their layers take 138 and 291
# GB). hubert-xlarge is an encoder (non-causal, no decode step) whose
# 4 x 4,096 bf16 frames are about 82 s of audio at 50 Hz each
NEW_SERVE_PHASES = [
    ("granite-3-2b", "granite_3_2b_serve", "flash_attention_granite", None),
    ("starcoder2-3b", "starcoder2_3b_serve", "flash_attention_starcoder2", None),
    ("hubert-xlarge", "hubert_xlarge_encode", "flash_attention_hubert", None),
    ("llava-next-34b", "llava_next_34b_serve", "flash_attention_llava", 16),
    ("qwen2-72b", "qwen2_72b_serve", "flash_attention_qwen2_72b", 8),
]
# deepseek-v2-lite-16b's expert-parallel serving: the EP domain of the JAX
# package's multi-pod production mesh (pod 2 x model 16), its data axis
# cut from 16 to 1 because one card holds the whole batch; 32 stacked
# ranks of 2 experts and 512 tokens each
EP_MESH = {"pod": 2, "data": 1, "model": 16}
EP_MODES = {"direct": ("direct", False), "blob": ("blob", False),
            "blob_int8": ("blob", True)}
# pack and unpack launches a MoE layer: flat scatters and gathers once;
# blob packs the payload and the metadata of stages 1 and 2 and the
# experts' payload, and gathers back through all three stages
EP_LAUNCHES = {"direct": (1, 1), "blob": (5, 3), "blob_int8": (5, 3)}
# dcn_bytes of each MoE layer of the 4 x 4,096 prefill: buffer sizes
# (flat (32, 128, 2048) bf16 sends; blob (2, 1632, 2048); int8 with an
# f32 scale a row), half of which cross the pods, summed over 32 ranks
EP_DCN_BYTES = {"direct": 268_435_456, "blob": 213_909_504, "blob_int8": 107_163_648}
# the no-drop check against the dense layer runs on the first tokens of
# layer 1's input: at a capacity factor of E (64) the flat send buffers
# alone take 1.6 MB a token (25.8 GB for all 16,384)
EP_NO_DROP_TOKENS = 512
EP_DENSE_TOL = 0.1            # bf16, as tests/test_torch_moe.py
# the int8 pod leg rounds each row to absmax / 127 steps before the
# experts: the limit of tests/test_torch_dispatch.py's int8 mode against
# the dense layer
EP_INT8_TOL = 5e-2
# gradients of the autograd Functions against autograd of their plain
# versions (kernel_grads): flash dq, dk, dv in bf16 by relative Frobenius
# error, at B 1, S 4,096 and each serving head dim (D, heads, kv heads);
# the SSD chunk's by the largest difference over the largest entry
GRAD_FLASH_SHAPES = [(80, 32, 32), (128, 16, 16), (192, 16, 16), (256, 8, 1)]
GRAD_FLASH_TOL = 1e-2
GRAD_SSD_TOL = 1e-4
# deepseek-v2-lite-16b trained at published widths with 3 of its 27
# layers (the dense layer 0 and two MoE layers: 1.670 G f32 parameters;
# the 27 layers' parameters, gradients and AdamW moments take 251 GB):
# 4 x 4,096 tokens in 2 microbatches, remat full, bf16 compute
TRAIN_LAYERS = 3
TRAIN_STEPS = 8
TRAIN_BLOB_STEPS = 3
TRAIN_MICROBATCHES = 2
# launches a step: flash once a layer in the forward and once in its
# recompute (the backward is plain torch); pack and unpack once a MoE
# layer in the forward, once in the recompute, and once as the other's
# backward
TRAIN_FLASH_LAUNCHES = TRAIN_LAYERS * TRAIN_MICROBATCHES * 2
TRAIN_PACK_LAUNCHES = (TRAIN_LAYERS - 1) * TRAIN_MICROBATCHES * 3
# the auto step's reference: its loss and gradients at a capacity factor
# of E against the dense dispatch's, on the first 2,048 tokens of the
# batch's first row (at E the stage-1 buffers take 0.8 MB a token). With
# nothing dropped each expert sees the same rows in both; the sums over
# units and ranks run in another order: the loss by its relative error,
# the gradients by the relative Frobenius error over all parameters
TRAIN_EP_REF_TOKENS = 2048
TRAIN_EP_LOSS_TOL = 1e-4
TRAIN_EP_GRAD_TOL = 1e-3
# the auto step with the blob shuffle over EP_MESH's stacked ranks, a MoE
# layer and microbatch: blob's packs and unpacks (EP_LAUNCHES) in the
# forward and again in the recompute, and the backward's: an unpack for
# each of the three payload packs, a pack for each of the three unpacks
# (the metadata packs carry no gradient)
TRAIN_EP_PACK_LAUNCHES = (TRAIN_LAYERS - 1) * TRAIN_MICROBATCHES * (
    2 * EP_LAUNCHES["blob"][0] + 3)
TRAIN_EP_UNPACK_LAUNCHES = (TRAIN_LAYERS - 1) * TRAIN_MICROBATCHES * (
    2 * EP_LAUNCHES["blob"][1] + 3)
# deepseek-v2-lite fed by BlobShuffle (phase deepseek_v2_lite_shuffle_fed):
# the training benchmark's --quick step count, engine, mesh, shuffle and
# sync (benchmarks/train_input.py); (c)'s microbatches, remat and bf16;
# (a)'s optimizer; its CI gate on the double buffer's overlap
SHUFFLE_FED_STEPS = 12
SHUFFLE_FED_CAPACITY = 2.0
SHUFFLE_FED_PIPELINE = {"step_interval_s": 0.05, "prefetch_steps": 2}
SHUFFLE_FED_OVERLAP = 0.5
# the shuffle-fed training over a process group (phase
# shuffle_fed_process_group): one NCCL process, the shuffle-fed phase's
# settings with the auto sync, this many steps; the loss gap allowed to
# its stacked twin where the bits differ
PG_STEPS = 4
PG_LOSS_TOL = 1e-3
# deepseek-v2-lite restarted from blob checkpoints (phase
# deepseek_v2_lite_restart): (a)'s step, 4 steps with a manifest every 2
# and one failure at step 3, so manifests 0, 2 and 4 and a restore of 2
RESTART_STEPS = 4
RESTART_CKPT_EVERY = 2
RESTART_FAIL_AT = {3: 1}
RESTART_HOST_SPARE_GB = 16.0    # host memory left free with every manifest held
RESTART_PEAK_MARGIN_GB = 1.0    # over (a)'s plain peak
RESTART_RELEASE_GB = 2.0        # host memory the deleted store may leave taken
RESTART_RELEASE_S = 60.0        # for at most this long
# the training benchmark's crash lane at published widths (phase
# deepseek_v2_lite_shuffle_resume): the shuffle-fed phase's run with a
# manifest every 6 steps and a crash mid-step 8, where the benchmark's
# --quick has 4 and 6: a manifest of the 3 layers is 20.04 GB, and the
# host holds manifests 0, 6 and 12 (60.1 GB), not 0, 4, 8 and 12
RESUME_CKPT_EVERY = 6
RESUME_CRASH_AT = 8
# deepseek-v2-lite restored onto another mesh (phase
# deepseek_v2_lite_elastic): the 3 layers' parameters saved under
# EP_MESH's plan (32 stacked ranks) and restored under this mesh's (16)
ELASTIC_MESH = {"pod": 1, "data": 4, "model": 4}
# GPipe on one card (phase gpipe): f32 stages tanh(x @ w + b) of width
# GPIPE_WIDTH over the stacked pod axis, against the sequential stack with
# tests/test_pipeline_parallel.py's bounds; gradients by relative Frobenius
GPIPE_MESH = {"pod": 4}
GPIPE_WIDTH = 2048
GPIPE_BATCH = 8192
GPIPE_MICRO = 8
GPIPE_TOL = 1e-5              # atol and rtol
GPIPE_GRAD_TOL = 1e-4
# the host fast paths' reused-arena calls (phase deployment_host_paths):
# best of this many, as the JAX package's benchmarks/micro.py times them
HOST_RUNS = 3
# what an earlier phase hands a later one
RESULTS = {}
# the gradient sync against the plain mean of two pods' gradients: exact
# by the largest difference over the largest entry, int8 by the bound of
# the JAX package's test_grad_sync_exact_and_compressed
SYNC_EXACT_TOL = 1e-6
SYNC_INT8_TOL = 0.02


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes as integers of its element size."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def max_abs_diff(a: torch.Tensor, b: torch.Tensor, rows: int = 1 << 18) -> float:
    """max |a - b| in f32, a chunk of rows at a time to bound memory."""
    a2, b2 = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    worst = 0.0
    for i in range(0, a2.shape[0], rows):
        d = (a2[i:i + rows].float() - b2[i:i + rows].float()).abs().max()
        worst = max(worst, float(d))
    return worst


def time_ms(fn, runs: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``runs`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def engine(seed: int, smi: str) -> None:
    """Phase ``engine`` (step 3 above): the two engine runs, each gated
    on exactly-once delivery inside ``repro_torch.launch.engine``; the
    kernels' launch counts, set to 0 before, must still be 0 after, and
    the phase must load no module of ``jax`` or of the JAX package."""
    from repro_torch.launch import engine as engine_launch

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    before = set(_foreign_modules())
    clocks = {"nvidia_smi": smi, "clocks": {
        "wall_s": "the host's clock",
        "summary": "p50_s, p95_s, p99_s and makespan_s in virtual seconds, "
                   "outputs of the engine's model, not the card's times"}}
    paper = engine_launch.paper_run(seed)
    check(paper["records_delivered_once"] == paper["records_produced"] > 0,
          f"the paper run delivers every record once: {paper['records_produced']}")
    emit({"phase": "engine_paper", **clocks,
          "cut": f"offered load and batch size x {engine_launch.PAPER_SCALE} "
                 f"(3.16 GiB/s -> 32.4 MiB/s), 10 virtual seconds of the 540 s window "
                 f"(simulate_async's clamp): the scale of the JAX package's measured lane",
          **paper, "ok": True})
    elastic = engine_launch.faulty_elastic_run(seed)
    check(elastic["records_delivered_once"] == elastic["records_produced"] > 0,
          "the faulty elastic run delivers every record once")
    check(elastic["rebalances"] >= 1, "the AZ outage rebalances the cluster")
    emit({"phase": "engine_faulty_elastic", **clocks, **elastic, "ok": True})
    launched = {k.symbol: k.launches for k in kernels}
    check(not any(launched.values()), f"the engine launches no kernel: {launched}")
    foreign = sorted(set(_foreign_modules()) - before)
    check(not foreign, f"the engine loads no module of jax or the JAX package: {foreign[:5]}")


def all_kernels() -> tuple:
    """Every kernel of the port, each with its launch count."""
    from repro_torch.kernels.blob_codec import kernel as codec_kernel
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    return (pack_kernel.PACK, unpack_kernel.UNPACK, codec_kernel.COMPRESS_PACK,
            codec_kernel.UNPACK_DECOMPRESS, *flash_kernel.KERNELS, *ssd_kernel.KERNELS)


def gpipe(seed: int, smi: str) -> None:
    """Phase ``gpipe`` (step 3 above): ``gpipe_apply`` over
    ``GPIPE_MESH``'s stages on the card against the sequential stack, its
    output within ``GPIPE_TOL`` and the gradients of ``w`` and ``b``
    within ``GPIPE_GRAD_TOL``; plain torch, so no kernel of the port may
    launch. On one card the stages run in turn: the wall times are a
    report, not a speedup."""
    from repro_torch.distributed import gpipe_apply
    from repro_torch.launch.mesh import stacked_mesh

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    S, d, B = GPIPE_MESH["pod"], GPIPE_WIDTH, GPIPE_BATCH
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = {"w": torch.randn((S, d, d), generator=gen, device="cuda") / d ** 0.5,
              "b": torch.randn((S, d), generator=gen, device="cuda") * 0.1}
    x = torch.randn((B, d), generator=gen, device="cuda")
    g = torch.randn((B, d), generator=gen, device="cuda")
    mesh = stacked_mesh(**GPIPE_MESH)

    def stage_fn(p, xm):
        return torch.tanh(xm @ p["w"] + p["b"])

    def sequential(p, xx):
        for s in range(S):
            xx = stage_fn({k: v[s] for k, v in p.items()}, xx)
        return xx

    def pipelined(p, xx):
        return gpipe_apply(stage_fn, p, xx, mesh=mesh, n_micro=GPIPE_MICRO)

    def run(fn):
        """y, the gradients of w and b, forward s, backward s."""
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn(p, x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (y * g).sum().backward()
        torch.cuda.synchronize()
        return y.detach(), p["w"].grad, p["b"].grad, t1 - t0, time.perf_counter() - t1

    torch.cuda.reset_peak_memory_stats()
    times = {"gpipe": [], "sequential": []}
    for fn in (pipelined, sequential):
        run(fn)                              # warm-up: cuBLAS handles and plans
    res = {}
    for name, fn in [("gpipe", pipelined), ("sequential", sequential),
                     ("sequential", sequential), ("gpipe", pipelined)]:
        y, gw, gb, fwd_s, bwd_s = run(fn)
        res[name] = (y, gw, gb)
        times[name].append({"forward_s": fwd_s, "backward_s": bwd_s})
    got, want = res["gpipe"], res["sequential"]
    worst = max_abs_diff(got[0], want[0])
    check(torch.allclose(got[0], want[0], atol=GPIPE_TOL, rtol=GPIPE_TOL),
          f"gpipe's y within {GPIPE_TOL} of the sequential stack (worst {worst})")
    grads = {"w": rel_fro(got[1], want[1]), "b": rel_fro(got[2], want[2])}
    check(all(e <= GPIPE_GRAD_TOL for e in grads.values()),
          f"gpipe's gradients within {GPIPE_GRAD_TOL} relative Frobenius: {grads}")
    launched = {k.symbol: k.launches for k in kernels}
    check(not any(launched.values()), f"gpipe launches no kernel of the port: {launched}")
    emit({"phase": "gpipe", "nvidia_smi": smi, "mesh": GPIPE_MESH, "width": d, "batch": B,
          "n_micro": GPIPE_MICRO, "dtype": "float32",
          "stage_fn": "tanh(x @ w + b), w ~ N(0, 1/d), b ~ N(0, 0.01)",
          "y_max_abs_diff": worst, "y_tol": GPIPE_TOL, "grad_rel_fro": grads,
          "grad_tol": GPIPE_GRAD_TOL, "seconds": times,
          "clock": "the host's, synchronised; one card runs the stages in turn, so "
                   "no speedup is expected",
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "ok": True})


def dryrun_plan(smi: str) -> None:
    """Phase ``dryrun_plan`` (step 3 above): ``repro_torch.launch.dryrun``'s
    ``run_cell`` over every cell of ``all_cells()`` on both production
    meshes, in this process, on the host: 31 cells a mesh, each cell's
    groups summing to its argument bytes, ``HBM_PER_CHIP`` the card's
    ``total_memory``; no kernel launched, no module of JAX loaded. Prints
    each cell's per-device argument GB and the cells over the card."""
    from repro_torch.configs import all_cells
    from repro_torch.launch import dryrun

    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    before = set(_foreign_modules())
    total = torch.cuda.get_device_properties(0).total_memory
    check(dryrun.HBM_PER_CHIP == total,
          f"dryrun.HBM_PER_CHIP {dryrun.HBM_PER_CHIP} is the card's total_memory {total}")
    t0 = time.perf_counter()
    plans = {kind: [dryrun.run_cell(arch, shp, kind) for arch, shp in all_cells()]
             for kind in ("single", "multi")}
    seconds = time.perf_counter() - t0
    args_gb, over = {}, []
    for kind, cells in plans.items():
        check(len(cells) == 31, f"31 cells on the {kind} mesh: {len(cells)}")
        for res in cells:
            mem = res["memory"]
            check(mem["argument_bytes"] == sum(mem[f"{g}_bytes"] for g in
                                               ("params", "opt", "cache", "batch")) > 0,
                  f"{kind} {res['arch']} {res['shape']}: the groups sum to the argument bytes")
            key = f"{kind}/{res['arch']}/{res['shape']}"
            args_gb[key] = mem["argument_bytes"] / 1e9
            if mem["argument_bytes"] > total:
                over.append(key)
    launched = {k.symbol: k.launches for k in kernels}
    check(not any(launched.values()), f"the plan launches no kernel: {launched}")
    foreign = sorted(set(_foreign_modules()) - before)
    check(not foreign, f"the plan loads no module of jax or the JAX package: {foreign[:5]}")
    emit({"phase": "dryrun_plan", "nvidia_smi": smi, "total_memory": total,
          "cells": {kind: len(cells) for kind, cells in plans.items()}, "seconds": seconds,
          "clock": "the host's", "argument_gb_per_device": args_gb,
          "over_the_card": over,
          "what": "the sharding plan's bytes per device, not a device measurement",
          "ok": True})


def _foreign_modules() -> list:
    """The loaded modules of ``jax``, ``jaxlib`` and the JAX package."""
    return [n for n, m in sys.modules.items()
            if m is not None and n.split(".")[0] in ("jax", "jaxlib", "repro")]


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_rows(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    if dtype in (torch.int32, torch.int8):
        hi = 100 if dtype == torch.int8 else 1 << 30
        return torch.randint(-hi, hi, shape, generator=gen, device="cuda", dtype=dtype)
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    if shape[0] > 8:
        x[0] = 0.0                       # all-zero row: scale 1.0
        x[1, 1:] = 0.0                   # one live element
        x[2] *= 1e30                     # huge
        x[3] *= 1e-40                    # subnormal
    return x.to(dtype)


# (dtype, rows T, width d, bins, capacity, key range): float32/bf16/int32/
# int8 payloads with 16-byte accesses; 7- and 6-byte rows for the narrow
# paths; an overflowing capacity; a capacity of 37 that neither
# rows-per-block value divides, with keys in half the bins (empty bins).
PACK_CASES = [
    (torch.float32, 5000, 96, 12, 512, 12),
    (torch.bfloat16, 5000, 96, 12, 512, 12),
    (torch.int32, 5000, 96, 12, 512, 12),
    (torch.int8, 5000, 96, 12, 512, 12),
    (torch.int8, 5000, 7, 12, 512, 12),
    (torch.bfloat16, 5000, 3, 12, 512, 12),
    (torch.float32, 5000, 96, 12, 100, 12),
    (torch.bfloat16, 999, 20, 24, 37, 12),
]
CODEC_CASES = [
    (torch.float32, 5000, 96, 12, 512, 12),
    (torch.bfloat16, 5000, 96, 12, 512, 12),
    (torch.bfloat16, 5000, 20, 12, 512, 12),
    (torch.float32, 5000, 7, 12, 512, 12),
    (torch.bfloat16, 5000, 96, 12, 100, 12),
    (torch.float32, 999, 20, 24, 37, 12),
]


def kernel_phases(seed: int, rows_per_block) -> None:
    from repro_torch.kernels.blob_codec.kernel import (
        compress_pack_fused_cuda, unpack_decompress_fused_cuda)
    from repro_torch.kernels.blob_codec.ref import (compress_pack_ref,
                                                    unpack_decompress_ref)
    from repro_torch.kernels.blob_pack.kernel import blob_pack_fused_cuda
    from repro_torch.kernels.blob_pack.ref import blob_pack_ref
    from repro_torch.kernels.blob_unpack.kernel import blob_unpack_fused_cuda
    from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
    from repro_torch.shuffle.binning import bin_pack, sorted_order

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def layout_inputs(T, bins, cap, key_range):
        keys = torch.randint(0, key_range, (T,), generator=gen, device="cuda",
                             dtype=torch.int32)
        order, starts, counts = sorted_order(keys, bins)
        pack = bin_pack(keys, bins, cap)
        # random slots, some out of range on both sides: the clip is checked
        R = bins * cap
        slot = torch.randint(-5, R + 5, (T,), generator=gen, device="cuda",
                             dtype=torch.int32)
        valid = torch.rand((T,), generator=gen, device="cuda") < 0.8
        return (order, starts, counts), [(pack.slot, pack.valid), (slot, valid)]

    n = {"pack": 0, "unpack": 0, "compress_pack": 0, "unpack_decompress": 0}
    for dtype, T, d, bins, cap, key_range in PACK_CASES:
        x = random_rows(gen, (T, d), dtype)
        (order, starts, counts), slots = layout_inputs(T, bins, cap, key_range)
        want = blob_pack_ref(x, order, starts, counts, capacity=cap)
        for rpb in rows_per_block:
            got = blob_pack_fused_cuda(x, order, starts, counts, capacity=cap,
                                       rows_per_block=rpb)
            check(same_bits(got, want), f"pack {dtype} T={T} d={d} cap={cap} rpb={rpb}")
            n["pack"] += 1
            for slot, valid in slots:
                got_u = blob_unpack_fused_cuda(got, slot, valid, rows_per_block=rpb)
                check(same_bits(got_u, blob_unpack_ref(want, slot, valid)),
                      f"unpack {dtype} d={d} cap={cap} rpb={rpb}")
                n["unpack"] += 1
    for dtype, T, d, bins, cap, key_range in CODEC_CASES:
        x = random_rows(gen, (T, d), dtype)
        (order, starts, counts), slots = layout_inputs(T, bins, cap, key_range)
        q_want, s_want = compress_pack_ref(x, order, starts, counts, capacity=cap)
        for rpb in rows_per_block:
            q, s = compress_pack_fused_cuda(x, order, starts, counts, capacity=cap,
                                            rows_per_block=rpb)
            check(same_bits(q, q_want) and same_bits(s, s_want),
                  f"compress_pack {dtype} d={d} cap={cap} rpb={rpb}")
            n["compress_pack"] += 1
            for slot, valid in slots:
                got = unpack_decompress_fused_cuda(q, s, slot, valid, rows_per_block=rpb)
                want = unpack_decompress_ref(q, s, slot, valid)
                check(same_bits(got, want), f"unpack_decompress d={d} cap={cap} rpb={rpb}")
                n["unpack_decompress"] += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_checks", "tolerance": "bitwise",
          "rows_per_block": list(rows_per_block), "cases": n, "ok": True})


def deployment(seed: int) -> list:
    """The round trip at the paper's deployment size; returns its rows of
    the kernels line. Its tensors are freed when it returns."""
    from repro_torch.kernels.blob_codec import kernel as codec_kernel
    from repro_torch.kernels.blob_codec.ref import (compress_pack_ref,
                                                    unpack_decompress_ref)
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_pack.ref import blob_pack_ref
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
    from repro_torch.shuffle import api
    from repro_torch.shuffle.binning import bin_pack, dropped_units

    T, d, P = RECORDS, WIDTH, PARTITIONS
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((T, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    keys_np = np.random.default_rng(seed).integers(0, P, T, dtype=np.int32)
    keys = torch.from_numpy(keys_np).cuda()
    cap = int(-(-np.bincount(keys_np, minlength=P).max() // CAPACITY_ROUND)
              * CAPACITY_ROUND)

    kernels = {
        "pack": pack_kernel.PACK,
        "unpack": unpack_kernel.UNPACK,
        "compress_pack": codec_kernel.COMPRESS_PACK,
        "unpack_decompress": codec_kernel.UNPACK_DECOMPRESS,
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    buf, (order, starts, counts) = api.blob_pack_fused(x, keys, num_bins=P, capacity=cap)
    back = api.unpack_from_keys(buf, keys, num_bins=P, capacity=cap)
    (q, scales), _ = api.compress_pack_fused(x, keys, num_bins=P, capacity=cap)
    deq = api.unpack_decompress_fused(q, scales, keys, num_bins=P, capacity=cap)
    torch.cuda.synchronize()
    round_trip_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    check(all(n >= 1 for n in launches.values()), f"every kernel launched: {launches}")

    pack = bin_pack(keys, P, cap)
    slot, valid = pack.slot, pack.valid
    dropped = int(dropped_units(pack, cap))
    check(dropped == 0, f"no record dropped (dropped {dropped})")
    check(same_bits(back, x), "unpack_from_keys(blob_pack_fused(x)) == x bit for bit")

    # each kernel against its plain version at the main path's shapes
    err = {}
    want = blob_pack_ref(x, order, starts, counts, capacity=cap)
    check(same_bits(buf, want), "pack == blob_pack_ref")
    err["pack"] = max_abs_diff(buf, want)
    del want
    want = blob_unpack_ref(buf, slot, valid)
    check(same_bits(back, want), "unpack == blob_unpack_ref")
    err["unpack"] = max_abs_diff(back, want)
    del want
    q_want, s_want = compress_pack_ref(x, order, starts, counts, capacity=cap)
    check(same_bits(q, q_want) and same_bits(scales, s_want),
          "compress_pack == compress_pack_ref")
    err["compress_pack"] = max(max_abs_diff(q, q_want),
                               max_abs_diff(scales[..., None], s_want[..., None]))
    del q_want, s_want
    want = unpack_decompress_ref(q, scales, slot, valid)
    check(same_bits(deq, want), "unpack_decompress == unpack_decompress_ref")
    err["unpack_decompress"] = max_abs_diff(deq, want)
    del want

    # the codec round trip lies within half a step (plus f32 rounding of
    # the divide and the multiply, < 2**-16 of a step) of every record
    row_scale = scales.reshape(-1)[slot.long()]
    worst_steps = 0.0
    for i in range(0, T, 1 << 18):
        e = (deq[i:i + (1 << 18)] - x[i:i + (1 << 18)].float()).abs()
        e = e / row_scale[i:i + (1 << 18), None]
        worst_steps = max(worst_steps, float(e.max()))
    check(worst_steps <= 0.5 + 2.0 ** -16,
          f"codec error within scale/2 (worst {worst_steps} steps)")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "deployment_round_trip", "records": T, "width": d, "dtype": "bfloat16",
          "record_bytes": d * 2, "partitions": P, "capacity": cap, "dropped": dropped,
          "round_trip_bit_exact": True, "codec_bitwise_vs_plain": True,
          "codec_worst_error_in_steps": worst_steps, "launches": launches,
          "round_trip_s": round_trip_s, "peak_memory_gb": peak_gb, "ok": True})

    # timing, at the main path's shapes, launching into its outputs
    live = int(torch.clamp(counts, max=cap).sum())
    n_valid = int(valid.sum())
    row_bytes = d * x.element_size()
    pos = starts[:, None] + torch.arange(cap, device="cuda", dtype=torch.int32)
    tok = order[torch.clamp(pos, 0, T - 1)].reshape(-1)
    flat_buf, flat_q = buf.reshape(-1, d), q.reshape(-1, d)
    rows_ops = live * d * 6          # abs, max, divide, round, two clamps
    # library: one PyTorch call that computes the same function, the blob
    # kernels' row gathers; no one call quantizes or dequantizes, so the
    # codec rows time the same gather only as a byte-movement reference
    work = {
        "pack": dict(
            kernel=lambda: pack_kernel.launch(buf, x, order, starts, counts),
            plain=lambda: blob_pack_ref(x, order, starts, counts, capacity=cap),
            library=lambda: torch.index_select(x, 0, tok),
            bytes=live * row_bytes + buf.numel() * 2 + 4 * (T + 2 * P), ops=0,
            replaces="src/repro/kernels/blob_pack/kernel.py:95"),
        "unpack": dict(
            kernel=lambda: unpack_kernel.launch(back, buf, slot, valid),
            plain=lambda: blob_unpack_ref(buf, slot, valid),
            library=lambda: torch.index_select(flat_buf, 0, slot),
            bytes=n_valid * row_bytes + T * row_bytes + 5 * T, ops=0,
            replaces="src/repro/kernels/blob_unpack/kernel.py:79"),
        "compress_pack": dict(
            kernel=lambda: codec_kernel.launch_compress_pack(q, scales, x, order, starts,
                                                             counts),
            plain=lambda: compress_pack_ref(x, order, starts, counts, capacity=cap),
            bytes_ref=lambda: torch.index_select(x, 0, tok),
            bytes=live * row_bytes + q.numel() + 4 * scales.numel() + 4 * (T + 2 * P),
            ops=rows_ops, replaces="src/repro/kernels/blob_codec/kernel.py:57"),
        "unpack_decompress": dict(
            kernel=lambda: codec_kernel.launch_unpack_decompress(deq, q, scales, slot,
                                                                 valid),
            plain=lambda: unpack_decompress_ref(q, scales, slot, valid),
            bytes_ref=lambda: torch.index_select(flat_q, 0, slot),
            bytes=n_valid * (d + 4) + 5 * T + 4 * T * d, ops=n_valid * d,
            replaces="src/repro/kernels/blob_codec/kernel.py:107"),
    }
    rows = []
    for name, w in work.items():
        ms = time_ms(w["kernel"], TIMED_RUNS)
        plain_ms = time_ms(w["plain"], 10, warmup=1)
        byte_ms = w["bytes"] / HBM_BYTES_PER_S * 1e3
        op_ms = w["ops"] / F32_OPS_PER_S * 1e3
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/blob_kernels.cu",
            "replaces": w["replaces"], "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": None, "library_call": None,
            "bytes": w["bytes"], "ops": w["ops"],
            "gb_s": w["bytes"] / ms / 1e6,
        }
        if "library" in w:
            row["library_ms"] = time_ms(w["library"], 10)
            row["library_call"] = "torch.index_select"
        else:
            row["bytes_reference_ms"] = time_ms(w["bytes_ref"], 10)
            row["bytes_reference_call"] = "torch.index_select of the same rows"
        rows.append(row)
    # the timed launches rewrote the outputs; they must still be right
    torch.cuda.synchronize()
    check(same_bits(back, x), "outputs unchanged by the timed launches")
    deployment_host_paths(x, keys, buf, (order, starts, counts), (q, scales), cap,
                          {r["name"]: r for r in rows})
    return rows


def deployment_host_paths(x, keys, buf, triple, codes, cap: int, kernel_rows: dict) -> None:
    """Phase ``deployment_host_paths`` (step 4 above): the Batcher's host
    fast paths on the deployment's records, copied to the host, against
    the CUDA kernels' outputs of the same run, bit for bit. Each path runs
    once into a fresh output (``cold_s``), then ``HOST_RUNS`` times into
    that output as a reused arena, first filled with 0xff bytes so that
    every byte must be written again (``reused_s``, the best). Its host
    tensors are freed when it returns."""
    from repro_torch.kernels.blob_codec import compress_pack_fused_host
    from repro_torch.kernels.blob_pack.ops import blob_pack_fused_host

    host_gb = [host_available_gb()]
    x_h, keys_h = x.cpu(), keys.cpu()
    triple_h = tuple(t.cpu() for t in triple)
    logical = x_h.numel() * x_h.element_size()

    def call(name, fn, want, out):
        """One call into ``out``, checked; returns its outputs and seconds."""
        t0 = time.perf_counter()
        got, got_triple = fn(x_h, keys_h, num_bins=PARTITIONS, capacity=cap, out=out)
        seconds = time.perf_counter() - t0
        host_gb.append(host_available_gb())
        got = got if isinstance(got, tuple) else (got,)
        check(all(same_bits(a, b) for a, b in zip(got, want)),
              f"{name} == the CUDA kernel's output bit for bit")
        check(all(torch.equal(a, b) for a, b in zip(got_triple, triple_h)),
              f"{name}'s (order, starts, counts) == the card's")
        return got, seconds

    line = {}
    for name, fn, kernel, device_out in [
            ("blob_pack_fused_host", blob_pack_fused_host, "pack", (buf,)),
            ("compress_pack_fused_host", compress_pack_fused_host, "compress_pack", codes)]:
        want = tuple(t.cpu() for t in device_out)
        arena, cold_s = call(name, fn, want, None)
        runs = []
        for _ in range(HOST_RUNS):
            for t in arena:
                t.view(torch.uint8).fill_(0xFF)
            got, seconds = call(name, fn, want, arena if len(arena) > 1 else arena[0])
            check(all(a is b for a, b in zip(got, arena)), f"{name} returns its arena")
            runs.append(seconds)
        line[name] = {"cold_s": cold_s, "reused_s": min(runs), "reused_runs_s": runs,
                      "cold_gb_s": logical / cold_s / 1e9,
                      "reused_gb_s": logical / min(runs) / 1e9,
                      "kernel": kernel, "kernel_ms": kernel_rows[kernel]["ms"],
                      "kernel_plain_ms": kernel_rows[kernel]["plain_ms"]}
        del want, arena, got
    emit({"phase": "deployment_host_paths", "records": x_h.shape[0], "width": x_h.shape[1],
          "dtype": "bfloat16", "partitions": PARTITIONS, "capacity": cap,
          "logical_input_bytes": logical, "bitwise_vs_cuda_kernels": True,
          "cpu_count": os.cpu_count(), "torch_threads": torch.get_num_threads(),
          "host_available_gb": {"start": host_gb[0], "least_after_a_call": min(host_gb)},
          "clock": "the host's; kernel_ms the kernels' CUDA-event medians of this run",
          **line, "ok": True})


# (B, S, H, KVH, D, causal, dtype): head dims 64, 80 (Zamba2), 128 and 256
# (gemma-2b's MQA), GQA, MQA, non-causal and a ragged length of 200, in bf16
# and f32; in bf16 also 16, 48 and 96, the wgmma kernel's three kinds of
# tail box with kv tiles of 128 rows, and 144, 176 and 192 (deepseek-v2-lite)
# with kv tiles of 96; the last is Zamba2's shared-block shape in f32 at
# batch 1
BF16, F32 = torch.bfloat16, torch.float32
FLASH_CASES = [
    (2, 256, 8, 8, 64, True, BF16),
    (2, 256, 8, 8, 80, True, BF16),
    (1, 256, 8, 2, 80, True, BF16),
    (1, 256, 8, 1, 128, True, BF16),
    (1, 200, 8, 8, 80, True, BF16),
    (2, 256, 8, 8, 80, False, BF16),
    (1, 384, 8, 1, 256, True, BF16),
    (1, 200, 8, 2, 128, False, BF16),
    (2, 136, 4, 1, 16, True, BF16),
    (2, 200, 8, 2, 48, True, BF16),
    (2, 300, 4, 4, 96, False, BF16),
    (2, 200, 8, 2, 144, True, BF16),
    (2, 300, 4, 4, 176, False, BF16),
    (1, 333, 16, 16, 192, True, BF16),
    (2, 256, 8, 8, 80, True, F32),
    (1, 256, 8, 2, 64, True, F32),
    (1, 200, 8, 1, 128, False, F32),
    (1, 384, 8, 1, 256, True, F32),
    (1, 4096, 32, 32, 80, True, F32),
]
# (b, S, H, P, G, N, chunk, dtype, intra_bf16): Zamba2's N 64 and
# mamba2-130m's 128, two groups, chunks of 64 and 256, ragged lengths;
# mamba2-130m's width (24 heads of 64, N 128, one group); a bf16 N of 40,
# off the tensor-core kernel's contract, which takes the CUDA-core kernel;
# the last four in the bf16-intra mode, one on each kernel in bf16, one in
# f32, and P 128 on the tensor-core kernel, whose block there has no room
# for the shared score tiles (each head computes its own)
SSD_CASES = [
    (2, 512, 8, 64, 1, 64, 256, torch.bfloat16, False),
    (2, 512, 8, 64, 2, 128, 256, torch.bfloat16, False),
    (1, 300, 8, 64, 2, 64, 64, torch.float32, False),
    (2, 1000, 4, 64, 1, 128, 256, torch.float32, False),
    (2, 1024, 24, 64, 1, 128, 256, torch.bfloat16, False),
    (1, 600, 8, 64, 1, 40, 256, torch.bfloat16, False),
    (2, 512, 8, 64, 2, 128, 256, torch.bfloat16, True),
    (1, 600, 8, 64, 1, 40, 256, torch.bfloat16, True),
    (1, 300, 8, 64, 2, 64, 64, torch.float32, True),
    (1, 512, 8, 128, 1, 64, 256, torch.bfloat16, True),
]
# bf16 flash above head dim 128, at the shapes of the configs that will take
# it, timed: (name, B, S, H, KVH, D), causal
FLASH_WIDE_TIMED = [
    ("gemma-2b", 1, 4096, 8, 1, 256),
    ("deepseek-v2-lite", 1, 4096, 16, 16, 192),
]


def ssd_inputs(gen, b, S, H, P, G, N, dtype):
    """x, dt, A, B, C as a Mamba2 layer makes them: dt a softplus, A = -1
    (A_log initialised to 0), B and C at N**-0.25 so C.B^T has unit
    scale."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(b, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(randn(b, S, H) - 1.0)
    A = -torch.ones(H, device="cuda")
    B = (randn(b, S, G, N) * N ** -0.25).to(dtype)
    C = (randn(b, S, G, N) * N ** -0.25).to(dtype)
    return x, dt, A, B, C


def ssd_worst(got, want):
    """Raise unless every output is within SSD_TOL (atol and rtol);
    return the largest absolute difference and the largest ratio of a
    difference to its tolerance."""
    worst, ratio = 0.0, 0.0
    for g, w in zip(got, want):
        check(g.dtype == torch.float32 and g.shape == w.shape, "ssd output shape")
        check(bool(torch.isfinite(g).all()), "ssd outputs finite")
        torch.testing.assert_close(g, w, atol=SSD_TOL, rtol=SSD_TOL)
        d = (g - w).abs()
        worst = max(worst, float(d.max()))
        ratio = max(ratio, float((d / (SSD_TOL + SSD_TOL * w.abs())).max()))
    return worst, ratio


def rel_max(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference over the largest entry, in f32."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def ssd_worst_bf16i(got, want):
    """``ssd_worst`` for the bf16-intra mode: y_intra within
    ``INTRA_BF16_TOL`` relative max, the other outputs within SSD_TOL;
    returns the largest absolute difference, the largest ratio to SSD_TOL
    of the other outputs, and y_intra's relative max."""
    check(got[0].dtype == torch.float32 and got[0].shape == want[0].shape, "y_intra shape")
    check(bool(torch.isfinite(got[0]).all()), "y_intra finite")
    y_rel = rel_max(got[0], want[0])
    check(y_rel <= INTRA_BF16_TOL, f"bf16-intra y_intra within {INTRA_BF16_TOL}: {y_rel}")
    err, ratio = ssd_worst(got[1:], want[1:])
    return max(err, float((got[0] - want[0]).abs().max())), ratio, y_rel


def flash_compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Hold a flash output against its plain version by ``FLASH_TOL`` of
    their dtype; returns the errors, with ``ok``."""
    atol, rtol, rel_fro_tol = FLASH_TOL[want.dtype]
    g, w = got.float(), want.float()
    d = (g - w).abs()
    out = {"max_abs_err": float(d.max()),
           "tol_ratio": float((d / (atol + rtol * w.abs())).max()),
           "rel_fro": float(d.norm() / w.norm())}
    out["ok"] = (got.dtype == want.dtype and got.shape == want.shape
                 and out["tol_ratio"] <= 1.0 and out["rel_fro"] <= rel_fro_tol)
    return out


def f32p_gap(got: torch.Tensor, want: torch.Tensor) -> dict:
    """A flash output's gap to ``flash_ref_f32p``: a report, no gate."""
    d = got.float() - want.float()
    return {"max_abs": float(d.abs().max()), "rel_fro": float(d.norm() / want.float().norm())}


def flash_flops(B, Sq, Skv, H, D, causal: bool = True, q_offset: int = 0) -> float:
    """The two products' operations, counting only unmasked keys (all of
    them without the causal mask; under it, row i sees
    min(i + 1 + q_offset, Skv))."""
    keys = sum(min(i + 1 + q_offset, Skv) for i in range(Sq)) if causal else Sq * Skv
    return 4.0 * B * H * D * keys


def flash_item_order(B, Skv, KVH, D, causal: bool, Sq=None, q_offset: int = 0) -> dict:
    """The item order the wgmma kernel's launcher picks by its rule
    (``launch_wgmma`` in flash_attention.cu): balanced where the K and V
    the items read (under the causal mask min(q_offset + Sq // 2, Skv) of
    Skv keys, half of them at Sq = Skv and no offset) fit in L2,
    head-major where they do not."""
    kv_bytes = 2 * B * KVH * Skv * D * 2
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    Sq = Skv if Sq is None else Sq
    keys = min(q_offset + Sq // 2, Skv) if causal else Skv
    read = kv_bytes // Skv * keys
    return {"item_order": "balanced" if read <= l2 else "head-major",
            "kv_bytes_read": read, "l2_bytes": l2}


def prefill_batch(cfg, gen: torch.Generator, B: int, S: int) -> dict:
    """B requests of S positions drawn from ``gen``: tokens; for the audio
    frontend bf16 frames (standard normal); for the vision frontend bf16
    patches before S - P tokens."""
    mm = cfg.multimodal
    if mm is not None and mm.kind == "audio":
        return {"frames": torch.randn((B, S, cfg.d_model), generator=gen, device="cuda",
                                      dtype=torch.float32).to(torch.bfloat16)}
    P = mm.num_patches if mm is not None else 0
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S - P), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    if P:
        batch["patches"] = torch.randn((B, P, cfg.d_model), generator=gen, device="cuda",
                                       dtype=torch.float32).to(torch.bfloat16)
    return batch


def refusal(fn, exc_type) -> str:
    """The message of the ``exc_type`` that ``fn()`` must raise (a refusal
    the phase expects); any other outcome fails the check."""
    try:
        fn()
    except exc_type as e:
        return str(e)
    raise RuntimeError(f"check failed: {fn} did not raise {exc_type.__name__}")


def bound(flops: float, nbytes: float):
    op_ms = flops / BF16_OPS_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), "bytes" if byte_ms >= op_ms else "operations"


def launches_of(kernels, fn):
    """Run ``fn``; return its result and each kernel's launches in it."""
    before = {k.symbol: k.launches for k in kernels}
    out = fn()
    return out, {k.symbol: k.launches - before[k.symbol] for k in kernels}


def model_kernel_phases(seed: int) -> list:
    """The model kernels against their plain versions; returns the rows of
    the kernels line for the flash kernel at the wide shapes."""
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, route
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_ref, flash_ref_f32p
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ops import ssd_chunked, ssd_scan_op
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref

    gen = torch.Generator(device="cuda").manual_seed(seed)
    flash = []
    for B, S, H, KVH, D, causal, dtype in FLASH_CASES:
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, S, KVH, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, S, KVH, D), generator=gen, device="cuda").to(dtype)
        kern = route(dtype, D)
        got, ran = launches_of(flash_kernel.KERNELS,
                               lambda: flash_attention_cuda(q, k, v, causal=causal))
        check(ran == {kn.symbol: int(kn is kern) for kn in flash_kernel.KERNELS},
              f"flash case {(B, S, H, KVH, D, causal, dtype)} ran {kern.symbol} only: {ran}")
        want = flash_ref(q, k, v, causal=causal)
        flash.append({"case": [B, S, H, KVH, D, causal, str(dtype)[6:]],
                      "kernel": kern.symbol, **flash_compare(got, want)})
        if dtype == BF16:
            flash[-1]["f32p_gap"] = f32p_gap(got, flash_ref_f32p(q, k, v, causal=causal))
    # the last case, Zamba2's shared-block shape in f32, timed; SDPA in f32
    # computes the same function
    f32_ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal=causal), 5)
    f32_plain_ms = time_ms(lambda: flash_ref(q, k, v, causal=causal), 3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    f32_library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal), 5)
    f32_flops = flash_flops(B, S, S, H, D)
    flash_f32 = {"case": flash[-1]["case"], "kernel": route(F32, D).symbol, "ms": f32_ms,
                 "plain_ms": f32_plain_ms, "library_ms": f32_library_ms,
                 "library_call": "torch.nn.functional.scaled_dot_product_attention",
                 "ops": f32_flops, "bound_ms": f32_flops / F32_OPS_PER_S * 1e3,
                 "bound_by": "operations (f32)"}
    del q, k, v, qt, kt, vt, got, want
    # bf16 above D 128, at the shapes of the configs that will take it: the
    # routed wgmma kernel and the mma.sync kernel on the same inputs, beside
    # SDPA, the plain version and the bound
    mma = flash_kernel.FLASH_MMA
    flash_wide, wide_rows = [], []
    for name, B, S, H, KVH, D in FLASH_WIDE_TIMED:
        q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(BF16)
        k = torch.randn((B, S, KVH, D), generator=gen, device="cuda").to(BF16)
        v = torch.randn((B, S, KVH, D), generator=gen, device="cuda").to(BF16)
        kern = route(BF16, D)
        # this shape's path: the public op, once, its launches counted from 0
        for kn in flash_kernel.KERNELS:
            kn.launches = 0
        got = flash_attention_op(q, k, v, causal=True)
        ran = {kn.symbol: kn.launches for kn in flash_kernel.KERNELS}
        check(ran == {kn.symbol: int(kn is kern) for kn in flash_kernel.KERNELS},
              f"flash at {name}'s shape ran {kern.symbol} only: {ran}")
        got_mma = torch.empty_like(q)
        flash_kernel.launch(got_mma, q, k, v, causal=True, kernel=mma)
        want = flash_ref(q, k, v, causal=True)
        want_f32p = flash_ref_f32p(q, k, v, causal=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        flops = flash_flops(B, S, S, H, D)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bound_ms, bound_by = bound(flops, nbytes)
        case = {"config": name, "case": [B, S, H, KVH, D, True, "bfloat16"],
                "kernel": kern.symbol, **flash_compare(got, want),
                "f32p_gap": f32p_gap(got, want_f32p),
                "mma_sync": {"kernel": mma.symbol, **flash_compare(got_mma, want),
                             "f32p_gap": f32p_gap(got_mma, want_f32p)},
                "bound_ms": bound_ms, "bound_by": bound_by, "ops": flops, "bytes": nbytes}
        del want, want_f32p
        case.update(
            ms=time_ms(lambda: flash_kernel.launch(got, q, k, v, causal=True), TIMED_RUNS),
            mma_sync_ms=time_ms(lambda: flash_kernel.launch(got_mma, q, k, v, causal=True,
                                                            kernel=mma), TIMED_RUNS),
            plain_ms=time_ms(lambda: flash_ref(q, k, v, causal=True), 3, warmup=1),
            library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), TIMED_RUNS),
            library_call="torch.nn.functional.scaled_dot_product_attention")
        # the timed launches rewrote both outputs; they must still be right
        want = flash_ref(q, k, v, causal=True)
        case["ok"] = (case["ok"] and case["mma_sync"]["ok"]
                      and flash_compare(got, want)["ok"] and flash_compare(got_mma, want)["ok"])
        flash_wide.append(case)
        wide_rows.append({
            "name": "flash_attention_wide", "config": name, "route": "cuda",
            "symbol": kern.symbol, "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
            "path": f"flash_attention_op at {name}'s shape", "launches": ran[kern.symbol],
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": case["library_ms"], "library_call": case["library_call"],
            "mma_sync_symbol": mma.symbol, "mma_sync_ms": case["mma_sync_ms"],
            "bytes": nbytes, "ops": flops, "tflop_s": flops / case["ms"] / 1e9})
        del q, k, v, qt, kt, vt, got, got_mma, want
    flash_ok = all(c["ok"] for c in flash + flash_wide)
    if not flash_ok:
        emit({"phase": "model_kernel_checks", "flash": flash, "flash_wide_timed": flash_wide,
              "ok": False})
    check(flash_ok, "flash kernel within FLASH_TOL of its plain version in every case")
    ssd_err = 0.0
    ssd = []
    for b, S, H, P, G, N, chunk, dtype, intra_bf16 in SSD_CASES:
        x, dt, A, Bm, Cm = ssd_inputs(gen, b, S, H, P, G, N, dtype)
        nc = S // chunk    # the whole chunks of a ragged length
        chunk_args = tuple(t[:, :nc * chunk].reshape(b, nc, chunk, *t.shape[2:]).contiguous()
                           for t in (x, dt, Bm, Cm))
        chunk_args = chunk_args[:2] + (A,) + chunk_args[2:]
        kern = ssd_kernel.route(dtype, chunk, P, N, intra_bf16)
        case = [b, S, H, P, G, N, chunk, str(dtype)[6:], intra_bf16]
        got, ran = launches_of(ssd_kernel.KERNELS, lambda: ssd_kernel.ssd_chunk_cuda(
            *chunk_args, intra_bf16=intra_bf16))
        check(ran == {k.symbol: int(k is kern) for k in ssd_kernel.KERNELS},
              f"SSD case {case} ran {kern.symbol} only: {ran}")
        want = ssd_chunk_ref(*chunk_args, intra_bf16=intra_bf16)
        row = {"case": case, "kernel": kern.symbol}
        if intra_bf16:
            err, ratio, row["y_intra_rel_max"] = ssd_worst_bf16i(got, want)
        else:
            err, ratio = ssd_worst(got, want)
        row.update(max_abs_err=err, tol_ratio=ratio)
        ssd.append(row)
        ssd_err = max(ssd_err, err)
        del got, want
        y, st = ssd_scan_op(x, dt, A, Bm, Cm, chunk=chunk,      # ragged S: padded
                            intra_bf16=intra_bf16)
        y_want, st_want = ssd_chunked(x, dt, A, Bm, Cm, chunk=chunk, intra_bf16=intra_bf16)
        if dtype == torch.float32 and intra_bf16:
            row["op_y_rel_max"] = rel_max(y, y_want)
            check(row["op_y_rel_max"] <= INTRA_BF16_TOL,
                  f"bf16-intra ssd_scan_op y within {INTRA_BF16_TOL}: {row['op_y_rel_max']}")
        outs = (st,) if dtype == torch.bfloat16 or intra_bf16 else (y, st)  # bf16 y, or held above
        wants = (st_want,) if dtype == torch.bfloat16 or intra_bf16 else (y_want, st_want)
        ssd_err = max(ssd_err, ssd_worst(outs, wants)[0])
    torch.cuda.synchronize()
    emit({"phase": "model_kernel_checks", "flash_cases": len(FLASH_CASES),
          "flash_tolerance": {str(k)[6:]: v for k, v in FLASH_TOL.items()},
          "flash": flash, "flash_f32_zamba2_shape": flash_f32, "flash_wide_timed": flash_wide,
          "ssd_cases": len(SSD_CASES), "ssd_tolerance": SSD_TOL,
          "ssd_intra_bf16_y_tolerance": INTRA_BF16_TOL, "ssd": ssd,
          "ssd_max_abs_err": ssd_err, "ok": True})
    return wide_rows


# the flash kernels with a query offset (query row i at position
# i + q_offset under the causal mask), against the plain version:
# (B, Sq, Skv, H, KVH, D, causal, q_offset, dtype). The suffix Sq of Skv
# (offset Skv - Sq), an offset of one, an offset off every kv tile, one
# past Skv (every key visible), non-causal, and the f32 kernel
FLASH_OFFSET_EDGES = [
    (2, 200, 256, 8, 2, 80, True, 56, BF16),
    (1, 128, 384, 8, 1, 256, True, 1, BF16),
    (2, 256, 256, 8, 8, 64, True, 95, BF16),
    (1, 136, 200, 4, 1, 144, True, 300, BF16),
    (1, 200, 200, 8, 2, 128, False, 17, BF16),
    (1, 200, 256, 8, 2, 80, True, 56, F32),
]
# the last FLASH_SUFFIX queries of a 4,096-token prefill at the attention
# shapes of two configs, B 4, bf16: (config, H, KVH, D); deepseek-v2-lite's
# MLA takes q/k head dim 192 with V padded to it
FLASH_SUFFIX = 512
FLASH_SUFFIX_CONFIGS = [("qwen2-moe-a2.7b", 16, 16, 128), ("deepseek-v2-lite-16b", 16, 16, 192)]


def flash_q_offset(seed: int) -> list:
    """The flash branch with a query offset: each edge case's kernel
    against the plain version; then at full width, through
    ``attention_op`` with each config, the last ``FLASH_SUFFIX`` queries
    of a 4,096-token prefill at ``q_offset`` 3,584, its launches counted
    from 0 over that call, held against the plain version and against the
    same rows of the full causal call, and timed beside SDPA with a
    lower-right causal mask (the same function; the port never calls
    it). Returns the kernels rows of the two suffixes."""
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ref import flash_ref
    from repro_torch.models.attention import attention_op

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    edges = []
    for B, Sq, Skv, H, KVH, D, causal, q_offset, dtype in FLASH_OFFSET_EDGES:
        q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Skv, KVH, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, Skv, KVH, D), generator=gen, device="cuda").to(dtype)
        kern = flash_kernel.route(dtype, D)
        case = [B, Sq, Skv, H, KVH, D, causal, q_offset, str(dtype)[6:]]
        got, ran = launches_of(flash_kernel.KERNELS, lambda: flash_kernel.flash_attention_cuda(
            q, k, v, causal=causal, q_offset=q_offset))
        check(ran == {kn.symbol: int(kn is kern) for kn in flash_kernel.KERNELS},
              f"flash offset case {case} ran {kern.symbol} only: {ran}")
        cmp = flash_compare(got, flash_ref(q, k, v, causal=causal, q_offset=q_offset))
        check(cmp["ok"], f"flash offset case {case} within FLASH_TOL: {cmp}")
        edges.append({"case": case, "kernel": kern.symbol, **cmp})
    del q, k, v, got

    S, q_offset = PREFILL_LEN, PREFILL_LEN - FLASH_SUFFIX
    kern = flash_kernel.FLASH_WGMMA
    suffixes, rows = [], []
    for name, H, KVH, D in FLASH_SUFFIX_CONFIGS:
        cfg = get_config(name)
        B = DECODER_PREFILL_BATCH
        q_full = torch.randn((B, S, H, D), generator=gen, device="cuda").to(BF16)
        k = torch.randn((B, S, KVH, D), generator=gen, device="cuda").to(BF16)
        v = torch.randn((B, S, KVH, D), generator=gen, device="cuda").to(BF16)
        q = q_full[:, q_offset:].contiguous()
        # this path: attention_op once, its launches counted from 0
        for kn in flash_kernel.KERNELS:
            kn.launches = 0
        got = attention_op(cfg, q, k, v, causal=True, q_offset=q_offset)
        torch.cuda.synchronize()
        ran = {kn.symbol: kn.launches for kn in flash_kernel.KERNELS}
        check(ran == {kn.symbol: int(kn is kern) for kn in flash_kernel.KERNELS},
              f"attention_op at {name}'s suffix ran {kern.symbol} once: {ran}")
        plain = flash_compare(got, flash_ref(q, k, v, causal=True, q_offset=q_offset))
        full_rows = flash_kernel.flash_attention_cuda(q_full, k, v, causal=True)[:, q_offset:]
        vs_full = flash_compare(got, full_rows)
        check(plain["ok"] and vs_full["ok"],
              f"{name}'s suffix within FLASH_TOL of the plain version and of the full "
              f"causal call's rows: {plain}, {vs_full}")
        flops = flash_flops(B, FLASH_SUFFIX, S, H, D, q_offset=q_offset)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bound_ms, bound_by = bound(flops, nbytes)
        out = torch.empty_like(q)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = causal_lower_right(FLASH_SUFFIX, S)
        case = {"config": name, "case": [B, FLASH_SUFFIX, S, H, KVH, D, True, q_offset,
                                         "bfloat16"],
                "kernel": kern.symbol, "launches": ran, **plain, "vs_full_rows": vs_full,
                "full_rows_bitwise": same_bits(got, full_rows.contiguous()),
                **flash_item_order(B, S, KVH, D, True, FLASH_SUFFIX, q_offset),
                "ops": flops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
                "ms": time_ms(lambda: flash_kernel.launch(out, q, k, v, causal=True,
                                                          q_offset=q_offset), TIMED_RUNS),
                "plain_ms": time_ms(lambda: flash_ref(q, k, v, causal=True, q_offset=q_offset),
                                    3, warmup=1),
                "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask), TIMED_RUNS),
                "library_call": "torch.nn.functional.scaled_dot_product_attention with "
                                f"causal_lower_right({FLASH_SUFFIX}, {S})"}
        # the timed launches rewrote out; it must be right too
        check(flash_compare(out, got)["ok"], f"{name}'s timed suffix output")
        suffixes.append(case)
        rows.append({
            "name": "flash_attention_q_offset", "config": name, "route": "cuda",
            "symbol": kern.symbol, "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
            "path": f"attention_op at {name}'s shape, the last {FLASH_SUFFIX} queries at "
                    f"q_offset {q_offset}", "launches": ran[kern.symbol],
            "max_abs_err": plain["max_abs_err"], "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": case["library_ms"],
            "library_call": case["library_call"], "bytes": nbytes, "ops": flops,
            "tflop_s": flops / case["ms"] / 1e9})
        del q_full, q, k, v, qt, kt, vt, got, full_rows, out
    torch.cuda.synchronize()
    emit({"phase": "flash_q_offset", "tolerance": {str(k)[6:]: v for k, v in FLASH_TOL.items()},
          "edges": edges, "suffixes": suffixes, "seconds": time.perf_counter() - t0,
          "ok": True})
    return rows


def profile_prefill(prefill, params, tokens, phase="zamba2_prefill_profile",
                    top_n=15) -> dict:
    """One more prefill under ``torch.profiler``: the device time by
    kernel, and the share of the wall time the device was idle."""
    return profile_call(lambda: prefill(params, {"tokens": tokens}), phase, top_n)


def profile_call(fn, phase: str, top_n: int = 15) -> dict:
    """``fn()`` under ``torch.profiler``: the device time by kernel, and
    the share of the wall time the device was idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top_n]
    return {"phase": phase, "wall_s": wall_s, "device_busy_s": busy_s,
            "device_idle_share": 1.0 - busy_s / wall_s, "kernel_names": len(kernels),
            "top": [{"name": e.key[:90], "calls": e.count,
                     "ms": e.self_device_time_total / 1e3} for e in top]}


def zamba2(seed: int) -> list:
    """Zamba2-2.7B prefill and decode at full width; returns the rows of
    the kernels line for flash attention and the SSD chunk."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.blob_codec import kernel as codec_kernel
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_ref, flash_ref_f32p
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    from repro_torch.serving import ServeConfig, make_prefill_step

    cfg = get_config(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(lm.LM(cfg, device="cuda"), gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           generator=gen, device="cuda", dtype=torch.int32)
    prefill = make_prefill_step(cfg, ServeConfig())
    kernels = {k.symbol: k for k in (
        pack_kernel.PACK, unpack_kernel.UNPACK, codec_kernel.COMPRESS_PACK,
        codec_kernel.UNPACK_DECOMPRESS, *flash_kernel.KERNELS, *ssd_kernel.KERNELS)}
    # Zamba2's attention (bf16, head dim 80) must take the wgmma kernel, its
    # SSD chunk (bf16, Q 256, P 64, N 64) the tensor-core kernel
    flash = flash_kernel.FLASH_WGMMA
    ssd = ssd_kernel.SSD_CHUNK_TC

    # the main path, once, counting launches and capturing the first
    # flash and SSD-chunk inputs
    captured = {}

    def capturing(name, fn):
        def wrapper(*args, **kwargs):
            captured.setdefault(name, args)
            return fn(*args, **kwargs)
        return wrapper

    originals = (flash_ops.flash_attention_cuda, ssd_ops.ssd_chunk_cuda)
    flash_ops.flash_attention_cuda = capturing("flash", originals[0])
    ssd_ops.ssd_chunk_cuda = capturing("ssd", originals[1])
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
    finally:
        flash_ops.flash_attention_cuda, ssd_ops.ssd_chunk_cuda = originals
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_inv = cfg.num_layers // cfg.hybrid.shared_block_every
    check(launches[flash.symbol] == n_inv,
          f"{flash.symbol} launched {n_inv} times in one prefill: {launches}")
    check(launches[ssd.symbol] == cfg.num_layers,
          f"{ssd.symbol} launched {cfg.num_layers} times in one prefill: {launches}")
    check(all(n == 0 for s, n in launches.items() if s not in (flash.symbol, ssd.symbol)),
          f"no other kernel in the prefill: {launches}")
    check(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_LEN, cfg.vocab_size),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits finite")
    logit_max = float(logits.float().abs().max())
    del logits
    prefill_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        del out
    prefill_s = min(prefill_s)
    profile = profile_prefill(prefill, params, tokens)

    # each kernel against its plain version on the captured inputs
    q, k, v = captured["flash"]
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    flash_out = flash_kernel.flash_attention_cuda(q, k, v, causal=True)

    def flash_plain():  # one batch row at a time bounds the S x S scores
        return torch.cat([flash_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True)
                          for i in range(B)])

    flash_cmp = flash_compare(flash_out, flash_plain())
    check(flash_cmp["ok"], f"flash at the captured shape: {flash_cmp}")
    flash_err = flash_cmp["max_abs_err"]
    flash_gap = f32p_gap(flash_out, torch.cat([
        flash_ref_f32p(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True) for i in range(B)]))
    ssd_args = captured["ssd"]
    ssd_want = ssd_chunk_ref(*ssd_args)
    ssd_out = ssd_kernel.ssd_chunk_cuda(*ssd_args)
    ssd_err, ssd_ratio = ssd_worst(ssd_out, ssd_want)
    torch.cuda.synchronize()

    # decode as repro_torch.launch.serve does it, against prefill of the
    # same prompts, in the compute dtype and in f32
    prompts = tokens[:, :PROMPT_LEN].contiguous()
    want = prefill(params, {"tokens": prompts}).float()
    dec = generate(cfg, params, prompts, NEW_TOKENS)
    check(bool(torch.isfinite(dec["logits"]).all()), "decode logits finite")
    gap = float((dec["logits"][:, :PROMPT_LEN].float() - want).abs().max())
    want_max = float(want.abs().max())
    check(gap <= GAP_TOL_BF16 * want_max,
          f"bf16 prefill vs decode logits: gap {gap}, largest logit {want_max}")
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    want32 = make_prefill_step(cfg32, ServeConfig())(params, {"tokens": prompts})
    dec32 = generate(cfg32, params, prompts, 1)
    gap32 = float((dec32["logits"] - want32).abs().max())
    check(gap32 <= GAP_TOL_F32, f"f32 prefill vs decode logits: gap {gap32}")
    steps = dec["logits"].shape[1]
    emit({"phase": "zamba2_serve", "arch": ARCH, "params": n_params,
          "param_init_s": init_s, "prefill_batch": PREFILL_BATCH,
          "prefill_len": PREFILL_LEN, "launches": launches,
          "prefill_first_s": first_s, "prefill_s": prefill_s,
          "prefill_tokens_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
          "prefill_peak_memory_gb": peak_gb, "prefill_logit_max_abs": logit_max,
          "flash_captured": flash_cmp, "flash_captured_f32p_gap": flash_gap,
          "ssd_captured_max_abs_err": ssd_err, "ssd_captured_tol_ratio": ssd_ratio,
          "decode_batch": PREFILL_BATCH, "prompt_len": PROMPT_LEN,
          "new_tokens": NEW_TOKENS, "decode_steps": steps, "decode_s": dec["seconds"],
          "decode_tokens_per_s": PREFILL_BATCH * steps / dec["seconds"],
          "decode_ms_per_step": dec["seconds"] / steps * 1e3,
          "prefill_decode_gap_bf16": gap, "prefill_logit_max_abs_bf16": want_max,
          "gap_tol_bf16": GAP_TOL_BF16 * want_max,
          "prefill_decode_gap_f32": gap32, "gap_tol_f32": GAP_TOL_F32, "ok": True})
    emit(profile)
    del dec, dec32, want, want32

    # timing at the captured shapes
    flash_ops_n = flash_flops(B, Sq, Skv, H, D)
    flash_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b, nc, Q, Hs, P = ssd_args[0].shape
    N = ssd_args[3].shape[4]
    ssd_flops = b * nc * Hs * (2.0 * (N + P) * Q * (Q + 1) / 2 + 2.0 * P * N * Q)
    ssd_bytes = (sum(t.numel() * t.element_size() for t in ssd_args)
                 + sum(t.numel() * 4 for t in ssd_out))

    # the CUDA-core SSD kernel, the route of f32 and of bf16 shapes off the
    # tensor-core contract, on the captured inputs in bf16 and in f32
    core = ssd_kernel.SSD_CHUNK
    core_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        args = tuple(t.to(dtype) if t.dtype == torch.bfloat16 else t for t in ssd_args)
        outs = tuple(torch.empty_like(t) for t in ssd_out)
        ssd_kernel.launch(outs, *args, kernel=core)
        err, ratio = ssd_worst(outs, ssd_want if dtype == torch.bfloat16
                               else ssd_chunk_ref(*args))
        nbytes = (sum(t.numel() * t.element_size() for t in args)
                  + sum(t.numel() * 4 for t in outs))
        core_rows.append({
            "name": "ssd_chunk", "symbol": core.symbol, "dtype": str(dtype)[6:],
            "max_abs_err": err, "tol_ratio": ratio,
            "ms": time_ms(lambda: ssd_kernel.launch(outs, *args, kernel=core), TIMED_RUNS),
            "ops": ssd_flops, "bytes": nbytes,
            "f32_ops_bound_ms": ssd_flops / F32_OPS_PER_S * 1e3,
            "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3})
        del args, outs
    emit({"phase": "ssd_chunk_cuda_core", "shape": list(ssd_args[0].shape),
          "N": ssd_args[3].shape[4], "rows": core_rows})
    del ssd_want
    rows = []
    for name, kern, run, plain, library, flops, nbytes, err, src, replaces, lib in (
            ("flash_attention", flash,
             lambda: flash_kernel.launch(flash_out, q, k, v, causal=True), flash_plain,
             lambda: torch.nn.functional.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True),
             flash_ops_n, flash_bytes, flash_err, "flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:68",
             "torch.nn.functional.scaled_dot_product_attention"),
            ("ssd_chunk", ssd, lambda: ssd_kernel.launch(ssd_out, *ssd_args),
             lambda: ssd_chunk_ref(*ssd_args), None, ssd_flops, ssd_bytes, ssd_err,
             "ssd_chunk.cu", "src/repro/kernels/ssd_scan/kernel.py:50", None)):
        bound_ms, bound_by = bound(flops, nbytes)
        ms = time_ms(run, TIMED_RUNS)
        rows.append({
            "name": name, "route": "cuda", "symbol": kern.symbol,
            "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
            "launches": launches[kern.symbol], "max_abs_err": err, "ms": ms,
            "plain_ms": time_ms(plain, 5, warmup=1), "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None if library is None else time_ms(library, TIMED_RUNS),
            "library_call": lib, "bytes": nbytes, "ops": flops,
            "f32_ops_bound_ms": flops / F32_OPS_PER_S * 1e3,
            "tflop_s": flops / ms / 1e9, "gb_s": nbytes / ms / 1e6,
        })
    # the timed launches rewrote the outputs; they must still be right
    torch.cuda.synchronize()
    check(flash_compare(flash_out, flash_plain())["ok"],
          "flash output unchanged by the timed launches")
    ssd_worst(ssd_out, ssd_chunk_ref(*ssd_args))
    del flash_out, ssd_out, q, k, v, qt, kt, vt, ssd_args
    rows.append(zamba2_intra_bf16(cfg, params, tokens, prefill, kernels))
    return rows


def zamba2_intra_bf16(cfg, params, tokens, prefill, kernels: dict) -> dict:
    """Phase ``zamba2_intra_bf16`` (step 6 above): the ``zamba2`` phase's
    weights and tokens with ``ssm.intra_bf16``; returns the kernels line's
    row of the tensor-core bf16-intra launcher."""
    import dataclasses

    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
    from repro_torch.launch.serve import generate
    from repro_torch.serving import ServeConfig, make_prefill_step

    t_phase = time.perf_counter()
    cfg_i = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, intra_bf16=True))
    prefill_i = make_prefill_step(cfg_i, ServeConfig())
    tc, core = ssd_kernel.SSD_CHUNK_TC_BF16I, ssd_kernel.SSD_CHUNK_BF16I
    flash = flash_kernel.FLASH_WGMMA

    # the main path, once, counting launches and capturing the first
    # SSD-chunk inputs
    captured = []
    original = ssd_ops.ssd_chunk_cuda

    def capturing(*args, **kwargs):
        if not captured:
            captured.append((args, kwargs))
        return original(*args, **kwargs)

    ssd_ops.ssd_chunk_cuda = capturing
    try:
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        logits = prefill_i(params, {"tokens": tokens})
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
    finally:
        ssd_ops.ssd_chunk_cuda = original
    n_inv = cfg.num_layers // cfg.hybrid.shared_block_every
    expected = {name: 0 for name in launches}
    expected.update({tc.symbol: cfg.num_layers, flash.symbol: n_inv})
    check(launches == expected, f"the bf16-intra prefill launches {tc.symbol} "
          f"{cfg.num_layers} times, {flash.symbol} {n_inv} times, nothing else: {launches}")
    check(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_LEN, cfg.vocab_size),
          f"bf16-intra logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "bf16-intra prefill logits finite")
    prefill_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = prefill_i(params, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        del out
    # the f32-intra prefill of the same weights and tokens: the mode's effect
    logits_f32i = prefill(params, {"tokens": tokens}).float()
    logits = logits.float()
    gap = {"max_abs": float((logits - logits_f32i).abs().max()),
           "rel_fro": rel_fro(logits, logits_f32i),
           "f32_intra_logit_max_abs": float(logits_f32i.abs().max())}
    del logits, logits_f32i

    # the captured per-chunk terms against the plain version
    args, kwargs = captured[0]
    check(kwargs.get("intra_bf16") is True, f"the prefill asked for the bf16-intra mode: {kwargs}")
    want = ssd_chunk_ref(*args, intra_bf16=True)
    outs = ssd_kernel.ssd_chunk_cuda(*args, intra_bf16=True)
    err, ratio, y_rel = ssd_worst_bf16i(outs, want)
    y_mode_gap = rel_max(ssd_chunk_ref(*args)[0], want[0])

    # decode as repro_torch.launch.serve does it, against prefill of the
    # same prompts
    prompts = tokens[:, :PROMPT_LEN].contiguous()
    want_p = prefill_i(params, {"tokens": prompts}).float()
    dec = generate(cfg_i, params, prompts, INTRA_BF16_NEW_TOKENS)
    check(bool(torch.isfinite(dec["logits"]).all()), "bf16-intra decode logits finite")
    dec_gap = float((dec["logits"][:, :PROMPT_LEN].float() - want_p).abs().max())
    want_max = float(want_p.abs().max())
    check(dec_gap <= GAP_TOL_BF16 * want_max,
          f"bf16-intra prefill vs decode logits: gap {dec_gap}, largest logit {want_max}")
    steps = dec["logits"].shape[1]
    del dec, want_p

    # timing at the captured shape: the bytes and operations of the f32
    # row (the same function of the same inputs, rounded elsewhere)
    b, nc, Q, H, P = args[0].shape
    N = args[3].shape[4]
    flops = b * nc * H * (2.0 * (N + P) * Q * (Q + 1) / 2 + 2.0 * P * N * Q)
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + sum(t.numel() * 4 for t in outs))
    bound_ms, bound_by = bound(flops, nbytes)
    ms = time_ms(lambda: ssd_kernel.launch(outs, *args, kernel=tc), TIMED_RUNS)
    plain_ms = time_ms(lambda: ssd_chunk_ref(*args, intra_bf16=True), 5, warmup=1)
    f32_intra_ms = time_ms(lambda: ssd_kernel.launch(outs, *args, kernel=ssd_kernel.SSD_CHUNK_TC),
                           TIMED_RUNS)
    ssd_kernel.launch(outs, *args, kernel=tc)
    torch.cuda.synchronize()
    ssd_worst_bf16i(outs, want)      # the timed launches rewrote the outputs
    # the CUDA-core bf16-intra launcher on the captured inputs, in bf16 and f32
    core_rows = []
    for dtype in (torch.bfloat16, torch.float32):
        cargs = tuple(t.to(dtype) if t.dtype == torch.bfloat16 else t for t in args)
        couts = tuple(torch.empty_like(t) for t in outs)
        ssd_kernel.launch(couts, *cargs, kernel=core)
        cwant = want if dtype == torch.bfloat16 else ssd_chunk_ref(*cargs, intra_bf16=True)
        cerr, cratio, cy_rel = ssd_worst_bf16i(couts, cwant)
        cbytes = (sum(t.numel() * t.element_size() for t in cargs)
                  + sum(t.numel() * 4 for t in couts))
        core_rows.append({
            "symbol": core.symbol, "dtype": str(dtype)[6:], "max_abs_err": cerr,
            "tol_ratio": cratio, "y_intra_rel_max": cy_rel,
            "ms": time_ms(lambda: ssd_kernel.launch(couts, *cargs, kernel=core), TIMED_RUNS),
            "plain_ms": time_ms(lambda: ssd_chunk_ref(*cargs, intra_bf16=True), 3, warmup=1),
            "bytes": cbytes, "bytes_bound_ms": cbytes / HBM_BYTES_PER_S * 1e3,
            "f32_ops_bound_ms": flops / F32_OPS_PER_S * 1e3})
        del cargs, couts, cwant
    torch.cuda.synchronize()
    emit({"phase": "zamba2_intra_bf16", "arch": ARCH, "ssm": dataclasses.asdict(cfg_i.ssm),
          "prefill_batch": PREFILL_BATCH, "prefill_len": PREFILL_LEN, "launches": launches,
          "prefill_first_s": first_s, "prefill_s": min(prefill_s),
          "prefill_tokens_per_s": PREFILL_BATCH * PREFILL_LEN / min(prefill_s),
          "logits_gap_to_f32_intra": gap, "ssd_captured_max_abs_err": err,
          "ssd_captured_tol_ratio": ratio, "ssd_captured_y_intra_rel_max": y_rel,
          "y_intra_tolerance": INTRA_BF16_TOL,
          "y_intra_gap_to_f32_intra_plain": y_mode_gap, "decode_steps": steps,
          "new_tokens": INTRA_BF16_NEW_TOKENS, "prefill_decode_gap_bf16": dec_gap,
          "gap_tol_bf16": GAP_TOL_BF16 * want_max, "ssd_chunk_fwd_tc_ms_same_inputs": f32_intra_ms,
          "cuda_core": core_rows, "seconds": time.perf_counter() - t_phase, "ok": True})
    return {"name": "ssd_chunk_intra_bf16", "route": "cuda", "symbol": tc.symbol,
            "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:50",
            "mode_of": "src/repro/models/ssm.py:89",
            "path": "Zamba2-2.7B prefill with ssm.intra_bf16", "launches": launches[tc.symbol],
            "max_abs_err": err, "y_intra_rel_max": y_rel, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "library_call": None,
            "bytes": nbytes, "ops": flops, "f32_ops_bound_ms": flops / F32_OPS_PER_S * 1e3,
            "tflop_s": flops / ms / 1e9, "gb_s": nbytes / ms / 1e6}


def moe_layer_indexed(cfg, p, x):
    """``moe_apply``'s dense path as the JAX package writes it, with the
    index-based ``binning.scatter_to_bins``/``gather_from_bins`` where the
    port calls the pack and unpack ops: the plain version of the layer."""
    from repro_torch.models import moe as MOE
    from repro_torch.shuffle import api, binning, dispatch

    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    T, E = xt.shape[0], m.num_experts
    sel_w, sel_idx, probs = api._route(xt, p.router, m.top_k, True)
    U = T * m.top_k
    cap = dispatch._cap(U / E, m.capacity_factor)
    unit_tok = torch.arange(T, dtype=torch.int32, device=x.device).repeat_interleave(m.top_k)
    pack = binning.bin_pack(sel_idx.reshape(-1), E, cap)
    ebuf = binning.scatter_to_bins(xt[unit_tok], pack, E, cap)
    eout = api._expert_ffn(p.we_gate, p.we_up, p.we_down, cfg.compute_dtype)(ebuf)
    y_units = binning.gather_from_bins(eout, pack)
    y = torch.einsum("tk,tkd->td", sel_w, y_units.reshape(T, m.top_k, d).float())
    y = y.to(xt.dtype).reshape(B, S, d) + MOE.shared_apply(cfg, p, x)
    return y.to(x.dtype), api._aux_loss(probs, pack.counts, U, E) * m.aux_loss_coef, pack.counts


def decoder_serve(seed: int, arch: str, phase: str, flash_row: str,
                  layers: int | None = None) -> list:
    """``arch`` (a ``decoder`` or ``encoder`` config) prefill and decode at
    full width, with ``layers`` of its layers where given (a cut of
    depth); returns the rows of the kernels line for flash attention and,
    with a MoE layer, the layer's pack and unpack. An encoder's decode
    must be refused by name."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import _checks
    from repro_torch.kernels.blob_codec import kernel as codec_kernel
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_pack.ops import blob_pack
    from repro_torch.kernels.blob_pack.ref import blob_pack_ref
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.kernels.blob_unpack.ops import blob_unpack
    from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import flash_ref, flash_ref_f32p
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.serve import generate
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_module
    from repro_torch.models.common import init_params
    from repro_torch.serving import ServeConfig, make_prefill_step
    from repro_torch.shuffle import api, binning, dispatch

    # the earlier phases' tensors must be gone: the f32 parameters of the
    # MoE configs alone take 57.3 and 62.8 GB of the card's 80
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    check(held_gb < 0.5, f"device memory free before {arch}: {held_gb} GB held")
    cfg = get_config(arch)
    published_layers = cfg.num_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    base = phase.rsplit("_", 1)[0]           # qwen2_moe_serve -> qwen2_moe
    m = cfg.moe
    d = cfg.d_model
    n_moe = cfg.num_layers - m.first_dense_layers if m is not None else 0
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(lm.LM(cfg, device="cuda"), gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == cfg.param_count(), f"{n_params} parameters")
    B, S = DECODER_PREFILL_BATCH, PREFILL_LEN
    batch = prefill_batch(cfg, gen, B, S)
    prefill = make_prefill_step(cfg, ServeConfig())
    kernels = {kn.symbol: kn for kn in (
        pack_kernel.PACK, unpack_kernel.UNPACK, codec_kernel.COMPRESS_PACK,
        codec_kernel.UNPACK_DECOMPRESS, *flash_kernel.KERNELS, *ssd_kernel.KERNELS)}
    flash = flash_kernel.FLASH_WGMMA
    # attention in every layer; the scatter and gather in every MoE layer
    per_layer = {flash.symbol: cfg.num_layers}
    if m is not None:
        E, k = m.num_experts, m.top_k
        per_layer.update({pack_kernel.PACK.symbol: n_moe, unpack_kernel.UNPACK.symbol: n_moe})

    # every MoE call's token count and expert load; the first call's
    # parameters and input, and the first flash call's q, k, v
    captured, loads = {}, []
    originals = (flash_ops.flash_attention_cuda, moe_module.moe_apply)

    def flash_capturing(*args, **kwargs):
        captured.setdefault("flash", (args, kwargs))
        return originals[0](*args, **kwargs)

    def moe_recording(cfg_, p, x, **kwargs):
        captured.setdefault("moe", (p, x))
        out = originals[1](cfg_, p, x, **kwargs)
        loads.append((cfg_.moe.capacity_factor, x.shape[0] * x.shape[1],
                      out[2]["expert_load"]))
        return out

    def drops(records):
        """Units over capacity in each recorded MoE call, from its loads."""
        return [int(torch.clamp(load - dispatch._cap(T * k / E, cf), min=0).sum())
                for cf, T, load in records]

    flash_ops.flash_attention_cuda, moe_module.moe_apply = flash_capturing, moe_recording
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for kn in kernels.values():
            kn.launches = 0
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = {name: kn.launches for name, kn in kernels.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        prefill_loads = loads[:]
    finally:
        flash_ops.flash_attention_cuda, moe_module.moe_apply = originals
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    check(launches == {s: per_layer.get(s, 0) for s in kernels},
          f"one prefill: {per_layer} launches and no other kernel: {launches}")
    check(total_gb - peak_gb >= MIN_HEADROOM_GB,
          f"prefill peak {peak_gb} GB leaves {MIN_HEADROOM_GB} GB of {total_gb}")
    check(tuple(logits.shape) == (B, S, cfg.vocab_size), f"logits shape {tuple(logits.shape)}")
    check(all(bool(torch.isfinite(logits[i]).all()) for i in range(B)), "prefill logits finite")
    logit_max = max(float(logits[i].abs().max()) for i in range(B))
    del logits
    prefill_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        del out
    prefill_s = min(prefill_s)
    profile = profile_call(lambda: prefill(params, batch), f"{base}_prefill_profile", 25)
    result = {"phase": phase, "arch": arch, "params": n_params, "param_init_s": init_s,
              "layers": cfg.num_layers, "published_layers": published_layers,
              "cut": (None if layers is None else
                      f"{cfg.num_layers} of {published_layers} layers"),
              "inputs": {k: list(v.shape) for k, v in batch.items()},
              "prefill_batch": B, "prefill_len": S, "launches": launches,
              "prefill_first_s": first_s, "prefill_s": prefill_s,
              "prefill_tokens_per_s": B * S / prefill_s, "prefill_peak_memory_gb": peak_gb,
              "device_memory_gb": total_gb, "prefill_logit_max_abs": logit_max}

    if m is not None:
        # each MoE layer's load and drops at the published capacity
        cap = dispatch._cap(B * S * k / E, m.capacity_factor)
        layer_load = [ld.tolist() for _, _, ld in prefill_loads]
        check(len(layer_load) == n_moe and all(sum(ld) == B * S * k for ld in layer_load),
              "every MoE layer routes every unit")
        # the first MoE layer: the pack and unpack ops (the kernels)
        # against the index-based binning helpers, and the layer against
        # its plain version, bit for bit
        p, z = captured["moe"]
        xt = z.reshape(-1, d)
        T = xt.shape[0]
        U = T * k
        _, sel_idx, _ = api._route(xt, p.router, k, True)
        keys = sel_idx.reshape(-1)
        unit_tok = torch.arange(T, dtype=torch.int32, device="cuda").repeat_interleave(k)
        order, starts, counts = binning.sorted_order(keys, E)
        pack = binning.pack_sorted(keys, order, starts, counts, cap)
        tok_order = unit_tok[order]
        ebuf = blob_pack(xt, tok_order, starts, counts, capacity=cap)
        ebuf_want = binning.scatter_to_bins(xt[unit_tok], pack, E, cap)
        check(same_bits(ebuf, ebuf_want), "MoE scatter: pack kernel == scatter_to_bins")
        pack_err = max_abs_diff(ebuf, ebuf_want)
        del ebuf_want
        eout = api._expert_ffn(p.we_gate, p.we_up, p.we_down, cfg.compute_dtype)(ebuf)
        y_units = blob_unpack(eout, pack.slot, pack.valid)
        y_units_want = binning.gather_from_bins(eout, pack)
        check(same_bits(y_units, y_units_want), "MoE gather: unpack kernel == gather_from_bins")
        unpack_err = max_abs_diff(y_units, y_units_want)
        del y_units_want
        got = moe_module.moe_apply(cfg, p, z, shuffle=ServeConfig().shuffle)
        want = moe_layer_indexed(cfg, p, z)
        check(same_bits(got[0], want[0]) and same_bits(got[1], want[1])
              and same_bits(got[2]["expert_load"], want[2]),
              "MoE layer through the kernels == the layer through the binning helpers")
        del got, want
        result.update(capacity=cap, units_per_layer=B * S * k,
                      first_moe_layer=cfg.num_layers - n_moe, expert_load_per_layer=layer_load,
                      dropped_per_layer=drops(prefill_loads), moe_scatter_gather_bitwise=True,
                      moe_layer_bitwise_vs_plain=True)

    # flash on the first attention call's q, k, v
    (q, kk, v), flash_kwargs = captured["flash"]
    causal = cfg.causal
    check(flash_kwargs == {"causal": causal, "scale": None, "q_offset": 0},
          f"the layers call flash causal={causal} at the default scale and no query "
          f"offset: {flash_kwargs}")
    flash_out = flash_kernel.flash_attention_cuda(q, kk, v, causal=causal)

    def flash_plain():  # one batch row at a time bounds the S x S scores
        return torch.cat([flash_ref(q[i:i + 1], kk[i:i + 1], v[i:i + 1], causal=causal)
                          for i in range(q.shape[0])])

    flash_cmp = flash_compare(flash_out, flash_plain())
    check(flash_cmp["ok"], f"flash at the captured shape: {flash_cmp}")
    flash_gap = f32p_gap(flash_out, torch.cat([
        flash_ref_f32p(q[i:i + 1], kk[i:i + 1], v[i:i + 1], causal=causal)
        for i in range(q.shape[0])]))
    flash_order = flash_item_order(q.shape[0], kk.shape[1], kk.shape[2], q.shape[3], causal)
    result.update(flash_shape=list(q.shape), flash_kv_heads=kk.shape[2],
                  flash_causal=causal, flash_captured=flash_cmp,
                  flash_captured_f32p_gap=flash_gap,
                  **{f"flash_{key}": val for key, val in flash_order.items()})

    if not cfg.has_decode:
        # an encoder: the model, the serving loop and the launcher refuse
        # its decode by name, as the JAX package's do
        no_prompts = torch.zeros((B, PROMPT_LEN), dtype=torch.int32, device="cuda")
        refused = [refusal(lambda: lm.init_cache(cfg, B, 8, "cuda"), ValueError),
                   refusal(lambda: generate(cfg, params, no_prompts, DECODER_NEW_TOKENS),
                           ValueError),
                   refusal(lambda: serve_main(["--arch", arch, "--full"]), SystemExit)]
        check(all("no decode step" in r and arch in r for r in refused),
              f"{arch}'s decode refused by name: {refused}")
        result.update(decode_refused=refused)
    else:
        # decode as repro_torch.launch.serve does it, timed at the published
        # config, where a decode step never drops a unit (a step's k units of
        # a token go to k experts, at most B a bin of 8 or more). Against
        # prefill of the same prompts with a MoE layer's capacity factor at
        # E, where no unit can drop in either (the published factor drops
        # others in a prefill of B * 16 tokens than in a decode step). A
        # vision model decodes tokens only: its prompt is text, and the
        # prefill of the same prompt after no patches is its reference
        prompts = batch["tokens"][:, :PROMPT_LEN].contiguous()
        gap_batch = {"tokens": prompts}
        if "patches" in batch:
            gap_batch["patches"] = batch["patches"][:, :0]
        cfg_gap = cfg if m is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(m, capacity_factor=float(E)))
        moe_module.moe_apply = moe_recording
        try:
            loads.clear()
            dec = generate(cfg, params, prompts, DECODER_NEW_TOKENS)
            decode_drops = sum(drops(loads)) if m is not None else 0
            loads.clear()
            want = make_prefill_step(cfg_gap, ServeConfig())(params, gap_batch).float()
            dec_gap = generate(cfg_gap, params, prompts, 1)
            gap_drops = sum(drops(loads)) if m is not None else 0
        finally:
            moe_module.moe_apply = originals[1]
        check(bool(torch.isfinite(dec["logits"]).all()), "decode logits finite")
        check(decode_drops == 0, f"decode steps drop no unit ({decode_drops})")
        check(gap_drops == 0, f"no unit dropped in the prefill/decode check ({gap_drops})")
        gap = float((dec_gap["logits"].float() - want).abs().max())
        want_max = float(want.abs().max())
        check(gap <= GAP_TOL_BF16 * want_max,
              f"bf16 prefill vs decode logits: gap {gap}, largest logit {want_max}")
        steps, decode_s = dec["logits"].shape[1], dec["seconds"]
        del dec, dec_gap, want
        result.update(decode_batch=B, prompt_len=PROMPT_LEN, new_tokens=DECODER_NEW_TOKENS,
                      decode_steps=steps, decode_s=decode_s,
                      decode_tokens_per_s=B * steps / decode_s,
                      decode_ms_per_step=decode_s / steps * 1e3, decode_dropped=decode_drops,
                      prefill_decode_gap_bf16=gap, prefill_logit_max_abs_bf16=want_max,
                      gap_tol_bf16=GAP_TOL_BF16 * want_max,
                      gap_capacity_factor=None if m is None else float(E),
                      gap_prompt="text, no patches" if "patches" in batch else "tokens")

        if m is not None:
            # the host syncs of the checks on the keys and on the pack's order
            # (two per MoE layer): the same decode and prefill with them and
            # without, in turn (the checks stay in the port; this only
            # measures them)
            def decode_ms_per_step():
                return generate(cfg, params, prompts[:, :4], 12)["seconds"] / 15 * 1e3

            def prefill_seconds():
                t0 = time.perf_counter()
                prefill(params, batch)
                torch.cuda.synchronize()
                return time.perf_counter() - t0

            def unchecked(fn):
                binning.check_keys = pack_kernel.check_pack = lambda *a, **kw: None
                try:
                    return fn()
                finally:
                    binning.check_keys = _checks.check_keys
                    pack_kernel.check_pack = _checks.check_pack

            sync_cost = {"decode_ms_per_step": [], "decode_ms_per_step_unchecked": [],
                         "prefill_s": [], "prefill_s_unchecked": []}
            for _ in range(2):
                sync_cost["decode_ms_per_step"].append(decode_ms_per_step())
                sync_cost["decode_ms_per_step_unchecked"].append(unchecked(decode_ms_per_step))
                sync_cost["prefill_s"].append(prefill_seconds())
                sync_cost["prefill_s_unchecked"].append(unchecked(prefill_seconds))
            # the per-call bf16 copies of one MoE layer's f32 expert and shared
            # weights
            copies = [p.we_gate, p.we_up, p.we_down, p.shared.w_gate, p.shared.w_up,
                      p.shared.w_down]
            result.update(check_sync_cost=sync_cost, expert_weight_copy_ms_per_layer=time_ms(
                lambda: [w.to(cfg.compute_dtype) for w in copies], 5))

    emit({**result, "ok": True})
    emit(profile)

    # timing at the prefill's shapes, launching into the outputs above
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
    work = [(flash_row, flash, lambda: flash_kernel.launch(flash_out, q, kk, v, causal=causal),
             flash_plain,
             lambda: torch.nn.functional.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal, enable_gqa=True),
             flash_flops(q.shape[0], q.shape[1], kk.shape[1], q.shape[2], q.shape[3], causal),
             2 * (2 * q.numel() + kk.numel() + v.numel()), flash_cmp["max_abs_err"],
             "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:68",
             "torch.nn.functional.scaled_dot_product_attention")]
    if m is not None:
        row_bytes = d * xt.element_size()
        live = int(torch.clamp(counts, max=cap).sum())
        n_valid = int(pack.valid.sum())
        pos = starts[:, None] + torch.arange(cap, device="cuda", dtype=torch.int32)
        tok = tok_order[torch.clamp(pos, 0, U - 1)].reshape(-1)
        flat_eout = eout.reshape(-1, d)
        work += [
            ("moe_pack", pack_kernel.PACK,
             lambda: pack_kernel.launch(ebuf, xt, tok_order, starts, counts),
             lambda: blob_pack_ref(xt, tok_order, starts, counts, capacity=cap),
             lambda: torch.index_select(xt, 0, tok), 0,
             live * row_bytes + ebuf.numel() * ebuf.element_size() + 4 * (U + 2 * E),
             pack_err, "blob_kernels.cu", "src/repro/kernels/blob_pack/kernel.py:95",
             "torch.index_select"),
            ("moe_unpack", unpack_kernel.UNPACK,
             lambda: unpack_kernel.launch(y_units, eout, pack.slot, pack.valid),
             lambda: blob_unpack_ref(eout, pack.slot, pack.valid),
             lambda: torch.index_select(flat_eout, 0, pack.slot), 0,
             n_valid * row_bytes + U * row_bytes + 5 * U, unpack_err, "blob_kernels.cu",
             "src/repro/kernels/blob_unpack/kernel.py:79", "torch.index_select")]
    rows = []
    for name, kern, run, plain, library, flops, nbytes, err, src, replaces, lib in work:
        bound_ms, bound_by = bound(flops, nbytes)
        ms = time_ms(run, TIMED_RUNS)
        rows.append({
            "name": name, "route": "cuda", "symbol": kern.symbol, "config": arch,
            "path": f"{base}_prefill", "layers": cfg.num_layers,
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": launches[kern.symbol], "max_abs_err": err,
            "ms": ms, "plain_ms": time_ms(plain, 5, warmup=1), "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": time_ms(library, TIMED_RUNS),
            "library_call": lib, "bytes": nbytes, "ops": flops,
            "tflop_s": flops / ms / 1e9, "gb_s": nbytes / ms / 1e6})
    rows[0].update(causal=causal, **flash_order)
    # the timed launches rewrote the outputs; they must still be right
    torch.cuda.synchronize()
    check(flash_compare(flash_out, flash_plain())["ok"],
          "flash output unchanged by the timed launches")
    if m is not None:
        check(same_bits(ebuf, binning.scatter_to_bins(xt[unit_tok], pack, E, cap))
              and same_bits(y_units, binning.gather_from_bins(eout, pack)),
              "pack and unpack outputs unchanged by the timed launches")
    return rows


def deepseek_v2_lite_ep(seed: int) -> list:
    """deepseek-v2-lite-16b at full width with its MoE layers over the
    ranks of a stacked mesh (``EP_MESH``), in the direct, blob and blob
    with int8 modes; returns the rows of the kernels line for the pack
    and unpack kernels at each mode's stage-1 shapes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.blob_codec import kernel as codec_kernel
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_pack.ref import blob_pack_ref
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.mesh import stacked_mesh
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_module
    from repro_torch.models.common import init_params
    from repro_torch.serving import ServeConfig, make_prefill_step
    from repro_torch.shuffle import api, binning, dispatch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    check(held_gb < 0.5, f"device memory free before the EP phase: {held_gb} GB held")
    arch = "deepseek-v2-lite-16b"
    cfg = get_config(arch)
    m = cfg.moe
    d, E, k = cfg.d_model, m.num_experts, m.top_k
    n_moe = cfg.num_layers - m.first_dense_layers
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(lm.LM(cfg, device="cuda"), gen)
    B, S = DECODER_PREFILL_BATCH, PREFILL_LEN
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda",
                           dtype=torch.int32)
    mesh = stacked_mesh(**EP_MESH)
    R = mesh.size
    kernels = {kn.symbol: kn for kn in (
        pack_kernel.PACK, unpack_kernel.UNPACK, codec_kernel.COMPRESS_PACK,
        codec_kernel.UNPACK_DECOMPRESS, *flash_kernel.KERNELS, *ssd_kernel.KERNELS)}

    def shuffle(name, **kw):
        mode, compress = EP_MODES[name]
        return api.ShuffleConfig(mode=mode, compress_dcn=compress, **kw)

    # every MoE call's diagnostics; the first call's parameters and input
    captured, diags = {}, []
    original = moe_module.moe_apply

    def moe_recording(cfg_, p, x, **kwargs):
        captured.setdefault("moe", (p, x))
        out = original(cfg_, p, x, **kwargs)
        diags.append(out[2])
        return out

    # the (kind, shape, dtype) of every pack and unpack over the stacked
    # ranks, so that each kernels row can say how many of its launches
    # ran at the shape it times
    by_shape = {}
    stacked_binning = dispatch.StackedBinning

    class ShapeRecording(stacked_binning):
        def scatter(self, rows, unit_row=None, bins=None):
            out = super().scatter(rows, unit_row, bins)
            key = ("pack", tuple(out.shape), str(out.dtype))
            by_shape[key] = by_shape.get(key, 0) + 1
            return out

        def gather(self, buf):
            key = ("unpack", tuple(buf.shape), str(buf.dtype))
            by_shape[key] = by_shape.get(key, 0) + 1
            return super().gather(buf)

    def per_layer(records):
        return {"expert_load": [r["expert_load"].tolist() for r in records],
                "dropped": [int(r["dropped"]) for r in records],
                "dcn_bytes": [float(r["dcn_bytes"]) for r in records]}

    result = {"phase": "deepseek_v2_lite_ep", "arch": arch, "mesh": EP_MESH, "ranks": R,
              "prefill_batch": B, "prefill_len": S, "capacity_factor": 1.25,
              "exchange": "stacked ranks: each all-to-all is a copy on one card, "
                          "not a network; dcn_bytes is counted, not measured",
              "modes": {}}
    shape_launches = {}
    for name, (pack_n, unpack_n) in EP_LAUNCHES.items():
        prefill = make_prefill_step(cfg, ServeConfig(shuffle=shuffle(name)), mesh)
        moe_module.moe_apply = moe_recording
        dispatch.StackedBinning = ShapeRecording
        try:
            diags.clear()
            by_shape.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for kn in kernels.values():
                kn.launches = 0
            t0 = time.perf_counter()
            logits = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            launches = {n: kn.launches for n, kn in kernels.items()}
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            layers = per_layer(diags)
        finally:
            moe_module.moe_apply = original
            dispatch.StackedBinning = stacked_binning
        shape_launches[name] = dict(by_shape)
        check(sum(n for (kind, *_), n in by_shape.items() if kind == "pack")
              == launches[pack_kernel.PACK.symbol]
              and sum(n for (kind, *_), n in by_shape.items() if kind == "unpack")
              == launches[unpack_kernel.UNPACK.symbol],
              f"{name}: every pack and unpack launch went through the stacked binning")
        want = {flash_kernel.FLASH_WGMMA.symbol: cfg.num_layers,
                pack_kernel.PACK.symbol: pack_n * n_moe,
                unpack_kernel.UNPACK.symbol: unpack_n * n_moe}
        check(launches == {s_: want.get(s_, 0) for s_ in kernels},
              f"{name} prefill: {want} launches and no other kernel: {launches}")
        total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
        check(total_gb - peak_gb >= MIN_HEADROOM_GB,
              f"{name} prefill peak {peak_gb} GB leaves {MIN_HEADROOM_GB} GB of {total_gb}")
        check(tuple(logits.shape) == (B, S, cfg.vocab_size), f"logits {tuple(logits.shape)}")
        check(all(bool(torch.isfinite(logits[i]).all()) for i in range(B)),
              f"{name} prefill logits finite")
        check(len(layers["dcn_bytes"]) == n_moe
              and all(sum(ld) == B * S * k for ld in layers["expert_load"]),
              f"{name}: every MoE layer routes every unit")
        check(all(b == EP_DCN_BYTES[name] for b in layers["dcn_bytes"]),
              f"{name} dcn_bytes a layer {set(layers['dcn_bytes'])} == {EP_DCN_BYTES[name]}")
        del logits
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del out
        result["modes"][name] = {
            "launches": launches,
            "launches_by_shape": {f"{kind} {list(shape)} {dtype}": n
                                  for (kind, shape, dtype), n in by_shape.items()},
            "prefill_first_s": first_s, "prefill_s": min(times),
            "prefill_tokens_per_s": B * S / min(times), "prefill_peak_memory_gb": peak_gb,
            "dropped_per_layer": layers["dropped"], "dcn_bytes_per_layer": layers["dcn_bytes"],
            "expert_load_per_layer": layers["expert_load"]}
    profile = profile_prefill(
        make_prefill_step(cfg, ServeConfig(shuffle=shuffle("blob")), mesh), params, tokens,
        "deepseek_v2_lite_ep_blob_prefill_profile", 25)

    # layer 1 (the first MoE layer) on its captured input: through the
    # kernels against the same layer through the index-based helpers,
    # bit for bit, each mode's loads against the dense layer's, and the
    # time of its routed part
    p, z = captured["moe"]
    xt = z.reshape(-1, d)
    dense_load = moe_module.moe_apply(cfg, p, z, shuffle=api.ShuffleConfig())[2]["expert_load"]
    weights = (p.router, p.we_gate, p.we_up, p.we_down)
    layer = {"dense_routed_ms": time_ms(lambda: api.dense_moe_ffn(
        xt, *weights, top_k=k, capacity_factor=m.capacity_factor,
        compute_dtype=cfg.compute_dtype), 5)}
    for name in EP_MODES:
        got = moe_module.moe_apply(cfg, p, z, shuffle=shuffle(name), mesh=mesh)
        dispatch.StackedBinning = binning.IndexedBinning
        try:
            want = moe_module.moe_apply(cfg, p, z, shuffle=shuffle(name), mesh=mesh)
        finally:
            dispatch.StackedBinning = stacked_binning
        check(same_bits(got[0], want[0]) and same_bits(got[1], want[1])
              and all(torch.equal(got[2][n], want[2][n]) for n in got[2]),
              f"{name} layer 1 through the kernels == through the binning helpers")
        check(torch.equal(got[2]["expert_load"], dense_load),
              f"{name} layer 1's loads == the dense layer's")
        del got, want
        layer[f"{name}_routed_ms"] = time_ms(lambda: api.ep_moe_ffn(
            xt, *weights, top_k=k, cfg=shuffle(name), mesh=mesh,
            compute_dtype=cfg.compute_dtype), 5)
    # at a capacity factor of E no unit drops in any mode, on the first
    # EP_NO_DROP_TOKENS tokens (the buffers grow with the factor): flat
    # and blob against the dense layer. The expert GEMM sees (E_loc,
    # ep * cap, d) a rank (stacked: (E, ep * cap, d)) where the dense
    # layer sees (E, cap, d), so the bf16 products round in other places
    zn = xt[:EP_NO_DROP_TOKENS].reshape(1, EP_NO_DROP_TOKENS, d)
    cfg_nd = dataclasses.replace(cfg, moe=dataclasses.replace(m, capacity_factor=float(E)))
    y_dense, _, dg_dense = moe_module.moe_apply(cfg_nd, p, zn, shuffle=api.ShuffleConfig())
    no_drop = {}
    for name in EP_MODES:
        y, _, dg = moe_module.moe_apply(cfg, p, zn, shuffle=shuffle(
            name, capacity_factor=float(E)), mesh=mesh)
        err = max_abs_diff(y, y_dense)
        check(int(dg["dropped"]) == 0 and torch.equal(dg["expert_load"],
                                                      dg_dense["expert_load"]),
              f"{name} drops no unit at a capacity factor of E")
        tol = EP_INT8_TOL if name == "blob_int8" else EP_DENSE_TOL
        check(err <= tol, f"{name} vs the dense layer: {err} > {tol}")
        no_drop[name] = err
    result.update(layer_1=layer, no_drop_tokens=EP_NO_DROP_TOKENS,
                  no_drop_max_abs_err_vs_dense=no_drop, no_drop_tolerance=EP_DENSE_TOL,
                  no_drop_tolerance_int8=EP_INT8_TOL,
                  layer_bitwise_vs_index_based=True, loads_equal_dense=True)

    # decode as repro_torch.launch.serve runs it, in blob mode (4 tokens a
    # step, padded to the 32 ranks); against prefill of the same prompts
    # at a capacity factor of E, where no unit drops in either
    prompts = tokens[:, :PROMPT_LEN].contiguous()
    blob = ServeConfig(shuffle=shuffle("blob"))
    blob_gap = ServeConfig(shuffle=shuffle("blob", capacity_factor=float(E)))
    moe_module.moe_apply = moe_recording
    try:
        diags.clear()
        dec = generate(cfg, params, prompts, DECODER_NEW_TOKENS, scfg=blob, mesh=mesh)
        decode_drops = sum(int(r["dropped"]) for r in diags)
        diags.clear()
        want = make_prefill_step(cfg, blob_gap, mesh)(params, {"tokens": prompts}).float()
        dec_gap = generate(cfg, params, prompts, 1, scfg=blob_gap, mesh=mesh)
        gap_drops = sum(int(r["dropped"]) for r in diags)
    finally:
        moe_module.moe_apply = original
    check(bool(torch.isfinite(dec["logits"]).all()), "EP decode logits finite")
    check(gap_drops == 0, f"no unit dropped in the prefill/decode check ({gap_drops})")
    gap = float((dec_gap["logits"].float() - want).abs().max())
    want_max = float(want.abs().max())
    check(gap <= GAP_TOL_BF16 * want_max,
          f"EP bf16 prefill vs decode logits: gap {gap}, largest logit {want_max}")
    steps, decode_s = dec["logits"].shape[1], dec["seconds"]
    del dec, dec_gap, want
    result.update(decode_mode="blob", decode_batch=B, prompt_len=PROMPT_LEN,
                  new_tokens=DECODER_NEW_TOKENS, decode_steps=steps, decode_s=decode_s,
                  decode_ms_per_step=decode_s / steps * 1e3,
                  decode_tokens_per_s=B * steps / decode_s, decode_dropped=decode_drops,
                  prefill_decode_gap_bf16=gap, gap_tol_bf16=GAP_TOL_BF16 * want_max,
                  gap_capacity_factor=float(E))
    emit({**result, "ok": True})
    emit(profile)

    # the pack and unpack kernels at each mode's stage-1 shapes: flat
    # scatters each rank's units into E lanes of its capacity, blob into
    # M blobs; one launch over all ranks
    sel_idx = api._route(xt, p.router, k, True)[1].view(R, -1)
    T_loc, U = xt.shape[0] // R, sel_idx.shape[1]
    unit_tok = torch.arange(T_loc, dtype=torch.int32, device="cuda").repeat_interleave(k)
    src_rows = (torch.arange(R, dtype=torch.int32, device="cuda")[:, None] * T_loc
                + unit_tok[None, :]).reshape(-1)
    M_ = EP_MESH["model"]
    rows = []
    for name in EP_MODES:
        if name == "direct":
            keys, nb, cap = sel_idx, E, dispatch._cap(U / E, 1.25)
        else:
            E_loc = E // R
            keys, nb, cap = (sel_idx // E_loc) % M_, M_, dispatch._cap(U / M_, 1.25)
        bins = dispatch.StackedBinning(keys, nb, cap)
        src = src_rows[bins.order]
        indexed = binning.IndexedBinning(keys, nb, cap)
        buf = bins.scatter(xt.view(R, T_loc, d), unit_tok)
        want = indexed.scatter(xt.view(R, T_loc, d), unit_tok)
        check(same_bits(buf, want), f"{name} stage-1 pack == scatter_to_bins")
        pack_err = max_abs_diff(buf, want)
        del want
        flat_buf = buf.view(R * nb, cap, d)
        y_units = bins.gather(buf)
        y_want = indexed.gather(buf)
        check(same_bits(y_units, y_want), f"{name} stage-1 unpack == gather_from_bins")
        unpack_err = max_abs_diff(y_units, y_want)
        del y_want
        y_flat = y_units.view(R * U, d)
        starts, counts, slot, valid = (bins.starts, bins.counts.reshape(-1),
                                       bins.pack.slot, bins.pack.valid)
        row_bytes = d * xt.element_size()
        live = int(torch.clamp(counts, max=cap).sum())
        n_valid = int(valid.sum())
        pos = starts[:, None] + torch.arange(cap, device="cuda", dtype=torch.int32)
        tok = src[torch.clamp(pos, 0, R * U - 1)].reshape(-1)
        launches = result["modes"][name]["launches"]
        path = f"deepseek_v2_lite_ep_{name}_prefill"
        shape = {"ranks": R, "units_per_rank": U, "bins_per_rank": nb, "capacity": cap,
                 "width": d, "dtype": "bfloat16"}
        for kname, kern, run, plain, library, nbytes, err, replaces in (
                ("moe_pack", pack_kernel.PACK,
                 lambda: pack_kernel.launch(flat_buf, xt, src, starts, counts),
                 lambda: blob_pack_ref(xt, src, starts, counts, capacity=cap),
                 lambda: torch.index_select(xt, 0, tok),
                 live * row_bytes + buf.numel() * buf.element_size() + 4 * (R * U + 2 * R * nb),
                 pack_err, "src/repro/kernels/blob_pack/kernel.py:95"),
                ("moe_unpack", unpack_kernel.UNPACK,
                 lambda: unpack_kernel.launch(y_flat, flat_buf, slot, valid),
                 lambda: blob_unpack_ref(flat_buf, slot, valid),
                 lambda: torch.index_select(flat_buf.view(-1, d), 0, slot),
                 n_valid * row_bytes + R * U * row_bytes + 5 * R * U,
                 unpack_err, "src/repro/kernels/blob_unpack/kernel.py:79")):
            bound_ms, bound_by = bound(0, nbytes)
            ms = time_ms(run, TIMED_RUNS)
            rows.append({
                "name": kname, "route": "cuda", "symbol": kern.symbol, "config": arch,
                "path": path, "timed_at": "stage 1" if name != "direct" else "send",
                "shape": shape, "source": "src/repro_torch/kernels/csrc/blob_kernels.cu",
                "replaces": replaces, "launches": launches[kern.symbol],
                "launches_at_timed_shape": shape_launches[name].get(
                    (kname.split("_")[1], tuple(buf.shape), str(buf.dtype)), 0),
                "max_abs_err": err,
                "ms": ms, "plain_ms": time_ms(plain, 5, warmup=1), "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": time_ms(library, TIMED_RUNS),
                "library_call": "torch.index_select", "bytes": nbytes, "ops": 0,
                "gb_s": nbytes / ms / 1e6})
            check(rows[-1]["launches_at_timed_shape"] == n_moe,
                  f"{name} {kname}: one launch a MoE layer at the timed shape "
                  f"{tuple(buf.shape)}: {shape_launches[name]}")
        torch.cuda.synchronize()
        check(same_bits(buf, indexed.scatter(xt.view(R, T_loc, d), unit_tok))
              and same_bits(y_units, indexed.gather(buf)),
              f"{name} pack and unpack outputs unchanged by the timed launches")
        del buf, y_units, flat_buf, y_flat, indexed
    return rows



def rel_fro(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def kernel_grads(seed: int) -> list:
    """Each autograd Function's gradients on the card against torch
    autograd through its plain version, on the same seeded inputs, with
    the launches of each case; returns the kernels row of the SSD chunk
    (whose training path is the Function at Zamba2's shape)."""
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_pack.ops import blob_pack
    from repro_torch.kernels.blob_pack.ref import blob_pack_ref
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.kernels.blob_unpack.ops import blob_unpack
    from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    from repro_torch.kernels.flash_attention.ref import flash_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ops import SSDChunk, ssd_chunked, ssd_scan_op
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
    from repro_torch.shuffle.binning import bin_pack, sorted_order

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    check(held_gb < 0.5, f"device memory free before kernel_grads: {held_gb} GB held")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kernels = (pack_kernel.PACK, unpack_kernel.UNPACK, *flash_kernel.KERNELS,
               *ssd_kernel.KERNELS)
    result = {"phase": "kernel_grads", "flash": {}, "tolerance": {
        "flash_rel_fro_bf16": GRAD_FLASH_TOL, "ssd_rel_max": GRAD_SSD_TOL,
        "ssd_op_rel_fro_bf16": GRAD_FLASH_TOL}}

    def grads(fn, leaves, dout):
        """(outputs, gradients, each kernel's launches in forward and backward)."""
        def run():
            out = fn(*leaves)
            return out, torch.autograd.grad(out, leaves, dout)
        (out, g), launches = launches_of(kernels, run)
        return out, g, {k: n for k, n in launches.items() if n}

    # flash at B 1, S 4,096, causal, each serving head dim: bf16 q, k, v
    for D, H, KVH in GRAD_FLASH_SHAPES:
        q, k, v, dout = (torch.randn((1, PREFILL_LEN, h, D), generator=gen, device="cuda")
                         .to(torch.bfloat16) for h in (H, KVH, KVH, H))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        _, got, launches = grads(lambda a, b, c: flash_attention_op(a, b, c, causal=True),
                                 leaves, dout)
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(flash_ref(*ref, causal=True), ref, dout)
        errs = {n: rel_fro(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        check(all(e <= GRAD_FLASH_TOL for e in errs.values()),
              f"flash D {D} gradients within {GRAD_FLASH_TOL}: {errs}")
        check(launches == {flash_kernel.FLASH_WGMMA.symbol: 1},
              f"flash D {D}: the forward's one wgmma launch, a plain backward: {launches}")
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_attention_op(*leaves, causal=True)
        bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True), 3,
                         warmup=1)
        result["flash"][f"D{D}"] = {"heads": H, "kv_heads": KVH, "rel_fro": errs,
                                    "launches": launches, "backward_ms": bwd_ms}
        del q, k, v, dout, leaves, ref, got, want, out

    # flash with a query offset: the last FLASH_SUFFIX queries of S 4,096
    # at D 128, 16 heads and kv heads, the plain backward with the offset
    B, H, KVH, D, off = 1, 16, 16, 128, PREFILL_LEN - FLASH_SUFFIX
    q, dout = (torch.randn((B, FLASH_SUFFIX, H, D), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, PREFILL_LEN, KVH, D), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    _, got, launches = grads(
        lambda a, b, c: flash_attention_op(a, b, c, causal=True, q_offset=off), leaves, dout)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash_ref(*ref, causal=True, q_offset=off), ref, dout)
    errs = {n: rel_fro(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    check(all(e <= GRAD_FLASH_TOL for e in errs.values()),
          f"flash q_offset {off} gradients within {GRAD_FLASH_TOL}: {errs}")
    check(launches == {flash_kernel.FLASH_WGMMA.symbol: 1},
          f"flash q_offset {off}: the forward's one wgmma launch, a plain backward: {launches}")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = flash_attention_op(*leaves, causal=True, q_offset=off)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True), 3,
                     warmup=1)
    result["flash"][f"D{D}_q_offset_{off}"] = {
        "shape": [B, FLASH_SUFFIX, PREFILL_LEN, H, KVH, D], "q_offset": off, "rel_fro": errs,
        "launches": launches, "backward_ms": bwd_ms}
    del q, k, v, dout, leaves, ref, got, want, out

    # the SSD chunk at Zamba2's first Mamba2 layer (B 1, S 4,096, 80 heads
    # of 64, N 64, chunks of 256), bf16 as the layer feeds it
    H, P_, N, Q = 80, 64, 64, 256
    x, dt, A, Bm, Cm = ssd_inputs(gen, 1, PREFILL_LEN, H, P_, 1, N, torch.bfloat16)
    nc = PREFILL_LEN // Q
    chunked = (x.reshape(1, nc, Q, H, P_), dt.reshape(1, nc, Q, H), A,
               Bm.reshape(1, nc, Q, 1, N), Cm.reshape(1, nc, Q, 1, N))
    douts = [torch.randn(o.shape, generator=gen, device="cuda")
             for o in ssd_chunk_ref(*chunked)]
    leaves = [t.clone().requires_grad_() for t in chunked]
    outs, got, launches = grads(SSDChunk.apply, leaves, douts)
    ref = [t.clone().requires_grad_() for t in chunked]
    want = torch.autograd.grad(ssd_chunk_ref(*ref), ref, douts)
    chunk_errs = {n: rel_max(g, w) for n, g, w in zip(("x", "dt", "A", "B", "C"), got, want)}
    check(all(e <= GRAD_SSD_TOL for e in chunk_errs.values()),
          f"SSD chunk gradients within {GRAD_SSD_TOL}: {chunk_errs}")
    check(launches == {ssd_kernel.SSD_CHUNK_TC.symbol: 1},
          f"SSD chunk: the forward's one tensor-core launch, a plain backward: {launches}")
    ssd_launches = launches[ssd_kernel.SSD_CHUNK_TC.symbol]
    # the whole op (kernel forward, recurrence) against the plain chunked scan
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y, st = ssd_scan_op(*leaves, chunk=Q)
    dy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    got = torch.autograd.grad((y.float() * dy.float()).sum() + st.sum(), leaves)
    ref = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm)]
    y2, st2 = ssd_chunked(*ref, chunk=Q)
    want = torch.autograd.grad((y2.float() * dy.float()).sum() + st2.sum(), ref)
    op_errs = {n: rel_fro(g, w) for n, g, w in zip(("x", "dt", "A", "B", "C"), got, want)}
    check(all(e <= GRAD_FLASH_TOL for e in op_errs.values()),
          f"ssd_scan_op gradients against ssd_chunked: {op_errs}")
    leaves = [t.detach().requires_grad_() for t in chunked]
    outs = SSDChunk.apply(*leaves)
    ssd_bwd_ms = time_ms(lambda: torch.autograd.grad(outs, leaves, douts, retain_graph=True),
                         5, warmup=1)
    bufs = tuple(torch.empty_like(o) for o in outs)
    ssd_ms = time_ms(lambda: ssd_kernel.launch(bufs, *chunked), TIMED_RUNS)
    ssd_plain_ms = time_ms(lambda: ssd_chunk_ref(*chunked), 5, warmup=1)
    # as the zamba2 phase counts them: the causal half of the two Q x Q
    # products, and the state product
    ssd_flops = nc * H * (2.0 * (N + P_) * Q * (Q + 1) / 2 + 2.0 * P_ * N * Q)
    ssd_bytes = sum(t.numel() * t.element_size() for t in (*chunked, *bufs))
    ssd_bound, ssd_by = bound(ssd_flops, ssd_bytes)
    result["ssd_chunk"] = {"shape": [1, PREFILL_LEN, H, P_, 1, N, Q], "chunk_rel_max": chunk_errs,
                           "op_rel_fro": op_errs, "launches": launches,
                           "backward_ms": ssd_bwd_ms}
    ssd_row = {"name": "ssd_chunk_grads", "route": "cuda",
               "symbol": ssd_kernel.SSD_CHUNK_TC.symbol, "config": "zamba2-2.7b",
               "path": "kernel_grads", "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
               "replaces": "src/repro/kernels/ssd_scan/kernel.py:50",
               "launches": ssd_launches, "max_abs_err": max(chunk_errs.values()),
               "ms": ssd_ms, "plain_ms": ssd_plain_ms, "bound_ms": ssd_bound,
               "bound_by": ssd_by, "library_ms": None, "backward_ms": ssd_bwd_ms,
               "flops": ssd_flops, "bytes": ssd_bytes}
    del x, dt, A, Bm, Cm, chunked, douts, leaves, outs, bufs, got, want, ref, y, y2

    # pack and unpack at deepseek-v2-lite's MoE shape: 16,384 tokens,
    # top-6, 98,304 units of 2,048 bf16 into 64 bins of 1,920; skewed keys
    # so that some bins overflow
    T, k, E, d = DECODER_PREFILL_BATCH * PREFILL_LEN, 6, 64, 2048
    cap = 1920
    p = torch.linspace(1.5, 0.5, E, device="cuda")
    keys = torch.multinomial(p / p.sum(), T * k, replacement=True,
                             generator=gen).to(torch.int32)
    order, starts, counts = sorted_order(keys, E)
    unit_tok = torch.arange(T, dtype=torch.int32, device="cuda").repeat_interleave(k)
    g_units = torch.randn((T * k, d), generator=gen, device="cuda").to(torch.bfloat16)
    dbuf = torch.randn((E, cap, d), generator=gen, device="cuda").to(torch.bfloat16)
    pack_result = {"units": T * k, "bins": E, "capacity": cap, "width": d,
                   "dropped": int(torch.clamp(counts - cap, min=0).sum())}
    # unpack's backward (a pack), bit for bit
    pk = bin_pack(keys, E, cap)
    buf = torch.randn((E, cap, d), generator=gen, device="cuda").to(torch.bfloat16)
    leaf = buf.clone().requires_grad_()
    _, (got,), launches = grads(lambda b: blob_unpack(b, pk.slot, pk.valid), [leaf], g_units)
    ref = buf.clone().requires_grad_()
    want, = torch.autograd.grad(blob_unpack_ref(ref, pk.slot, pk.valid), ref, g_units)
    check(same_bits(got, want), "unpack's backward == autograd of blob_unpack_ref")
    check(launches == {pack_kernel.PACK.symbol: 1, unpack_kernel.UNPACK.symbol: 1},
          f"unpack forward and its backward's one pack: {launches}")
    pack_result["unpack_backward_launches"] = launches
    # pack's backward (an unpack) where order is a permutation, bit for bit
    x = torch.randn((T * k, d), generator=gen, device="cuda").to(torch.bfloat16)
    leaf = x.clone().requires_grad_()
    _, (got,), launches = grads(lambda a: blob_pack(a, order, starts, counts, capacity=cap),
                                [leaf], dbuf)
    ref = x.clone().requires_grad_()
    want, = torch.autograd.grad(blob_pack_ref(ref, order, starts, counts, capacity=cap), ref,
                                dbuf)
    check(same_bits(got, want), "pack's backward (a permutation) == autograd of blob_pack_ref")
    check(launches == {pack_kernel.PACK.symbol: 1, unpack_kernel.UNPACK.symbol: 1},
          f"pack forward and its backward's one unpack: {launches}")
    pack_result["pack_backward_launches"] = launches
    # the MoE scatter: each token's row read top_k times; the sum within
    # one bf16 rounding of an f32 sum of the same units
    tok = unit_tok[order]
    xt = torch.randn((T, d), generator=gen, device="cuda").to(torch.bfloat16)
    leaf = xt.clone().requires_grad_()
    _, (got,), _ = grads(lambda a: blob_pack(a, tok, starts, counts, capacity=cap), [leaf], dbuf)
    ref = xt.float().requires_grad_()
    want, = torch.autograd.grad(blob_pack_ref(ref, tok, starts, counts, capacity=cap), ref,
                                dbuf.float())
    step = torch.finfo(torch.bfloat16).eps * want.abs()       # one bf16 step at |want|
    over = float(((got.float() - want).abs() - step).max())
    check(over <= 0.0, f"pack's backward with repeated rows within bf16 rounding: {over}")
    pack_result["repeated_rows_max_abs_err"] = float((got.float() - want).abs().max())
    result["pack_unpack"] = pack_result
    emit({**result, "ok": True})
    del keys, order, starts, counts, unit_tok, g_units, dbuf, pk, buf, leaf, ref, x, xt, got, want
    return [ssd_row]


def deepseek_v2_lite_train(seed: int, smi: str) -> list:
    """deepseek-v2-lite-16b at published widths with 3 of its 27 layers
    trained on the card: (a) the plain step, (b) the blob gradient sync
    against the plain mean of two pods' gradients, (c) BlobShuffle's
    training configuration, (d) the ``auto`` step with its MoE layers
    dispatched over ``EP_MESH``'s stacked ranks: the stacked twin of the
    step over a ``ProcessGroupMesh``, which one card cannot run (NCCL
    refuses two ranks on one device); returns the kernels rows of the
    training path."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_pack.ref import blob_pack_ref
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.kernels.blob_unpack.ref import blob_unpack_ref
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ref import flash_ref
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh, stacked_mesh
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_module
    from repro_torch.models.common import ShapeConfig, init_params
    from repro_torch.models.flash import flash_bwd
    from repro_torch.shuffle import api, dispatch
    from repro_torch.shuffle import grad_sync as GS
    from repro_torch.shuffle.binning import bin_pack, sorted_order
    from repro_torch.training import (OptConfig, TrainConfig, adamw_init,
                                      make_loss_fn, make_train_step)
    from repro_torch.training.train_step import _grads, _split_micro
    from repro_torch.utils import tree_size_bytes

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    check(held_gb < 0.5, f"device memory free before training: {held_gb} GB held")
    arch = "deepseek-v2-lite-16b"
    cfg = dataclasses.replace(get_config(arch), num_layers=TRAIN_LAYERS)
    m = cfg.moe
    n_moe = cfg.num_layers - m.first_dense_layers
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(lm.LM(cfg, device="cuda"), gen)
    fresh_router = params.blocks[1].ffn.router.detach().clone()
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == cfg.param_count(), f"{n_params} parameters")
    B, S = DECODER_PREFILL_BATCH, PREFILL_LEN
    rows = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device="cuda",
                         dtype=torch.int32)
    batch = {"tokens": rows[:, :-1].contiguous(), "labels": rows[:, 1:].contiguous()}
    kernels = {kn.symbol: kn for kn in (pack_kernel.PACK, unpack_kernel.UNPACK,
                                        *flash_kernel.KERNELS, *ssd_kernel.KERNELS)}
    flash = flash_kernel.FLASH_WGMMA
    opt_cfg = OptConfig(learning_rate=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    dense = api.ShuffleConfig(mode="dense", capacity_factor=m.capacity_factor)
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    result = {"phase": "deepseek_v2_lite_train", "arch": arch, "layers": cfg.num_layers,
              "published_layers": get_config(arch).num_layers, "params": n_params,
              "batch": B, "seq": S, "microbatches": TRAIN_MICROBATCHES, "remat": "full",
              "compute_dtype": "bfloat16", "capacity_factor": m.capacity_factor,
              "opt": dataclasses.asdict(opt_cfg)}

    def run_steps(step, opt, n, per_step):
        """n steps on the fixed batch: losses, grad norms, step seconds,
        the launches a step (counted over all n), the peak memory."""
        losses, norms, secs = [], [], []
        for kn in kernels.values():
            kn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        nonlocal params
        for _ in range(n):
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        launches = {s_: kn.launches for s_, kn in kernels.items()}
        want = {s_: n * c for s_, c in per_step.items()}
        check(launches == {s_: want.get(s_, 0) for s_ in kernels},
              f"{n} steps: {per_step} launches a step and no other kernel: {launches}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(total_gb - peak >= MIN_HEADROOM_GB,
              f"training peak {peak} GB leaves {MIN_HEADROOM_GB} GB of {total_gb}")
        check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
              f"losses {losses} and gradient norms {norms} finite")
        return opt, metrics, {"losses": losses, "grad_norms": norms, "step_s": secs,
                              "median_step_s": statistics.median(secs[1:] or secs),
                              "tokens_per_s": B * S / statistics.median(secs[1:] or secs),
                              "peak_memory_gb": peak,
                              "launches_per_step": {s_: c // n for s_, c in launches.items() if c}}

    diags, meshes = [], []
    original = moe_module.moe_apply

    def moe_recording(cfg_, p, x, **kwargs):
        # at entry: the recompute stops inside the layer once it has what
        # the backward needs, so only the forward returns
        meshes.append(kwargs.get("mesh"))
        out = original(cfg_, p, x, **kwargs)
        diags.append(out[2])
        return out

    @contextlib.contextmanager
    def recording():
        diags.clear()
        meshes.clear()
        moe_module.moe_apply = moe_recording
        try:
            yield
        finally:
            moe_module.moe_apply = original

    mesh = stacked_mesh(**EP_MESH)
    E, R = m.num_experts, mesh.size
    ep_blob = api.ShuffleConfig(mode="blob", capacity_factor=m.capacity_factor)

    def drop_causes(dg, units: int) -> dict:
        """A blob call's drops beside its loads: the largest expert's load
        over the mean, and the units over the capacity of each expert in
        the dispatch's last stage (pooled over the ranks, so its slack is
        the factor's over sqrt(32)) and over the dense layer's."""
        load = dg["expert_load"].double()
        cap_e = dispatch._cap(units / R / (E // R),
                              dispatch.pooled_capacity_factor(m.capacity_factor, R))
        cap_d = dispatch._cap(units / E, m.capacity_factor)
        return {"dropped": int(dg["dropped"]), "units": units,
                "max_load_over_mean": float(load.max()) * E / units,
                "expert_capacity": cap_e,
                "over_expert_capacity": int((load - cap_e).clamp(min=0).sum()),
                "dense_capacity": cap_d,
                "over_dense_capacity": int((load - cap_d).clamp(min=0).sum())}

    # (a) the plain step: dense dispatch, no mesh
    per_step = {flash.symbol: TRAIN_FLASH_LAUNCHES, pack_kernel.PACK.symbol: TRAIN_PACK_LAUNCHES,
                unpack_kernel.UNPACK.symbol: TRAIN_PACK_LAUNCHES}
    step = make_train_step(cfg, TrainConfig(opt=opt_cfg, microbatches=TRAIN_MICROBATCHES,
                                            remat="full", shuffle=dense))
    # the shape of every pack and unpack launch, so that their rows can
    # say how many launches ran at the shape they time
    by_shape = {}
    real_launch = {"pack": pack_kernel.launch, "unpack": unpack_kernel.launch}

    def shape_recording(kind):
        def launch(out, src, idx, *args, **kwargs):
            if kind == "pack" or idx.shape[0]:     # an empty unpack launches nothing
                key = (kind, tuple(src.shape), tuple(idx.shape), tuple(out.shape))
                by_shape[key] = by_shape.get(key, 0) + 1
            return real_launch[kind](out, src, idx, *args, **kwargs)
        return launch

    pack_kernel.launch, unpack_kernel.launch = shape_recording("pack"), shape_recording("unpack")
    try:
        opt, _, plain = run_steps(step, adamw_init(params), TRAIN_STEPS, per_step)
    finally:
        pack_kernel.launch, unpack_kernel.launch = real_launch["pack"], real_launch["unpack"]
    for kind, kern in (("pack", pack_kernel.PACK), ("unpack", unpack_kernel.UNPACK)):
        check(sum(n for key, n in by_shape.items() if key[0] == kind)
              == TRAIN_STEPS * plain["launches_per_step"][kern.symbol],
              f"every {kind} launch of the plain steps recorded by shape: {by_shape}")
    plain["launches_by_shape_per_step"] = {
        f"{kind} in {list(a)} index {list(b)} out {list(c)}": n // TRAIN_STEPS
        for (kind, a, b, c), n in by_shape.items()}
    check(plain["losses"][-1] < plain["losses"][0],
          f"loss {plain['losses'][-1]} after {TRAIN_STEPS} steps below {plain['losses'][0]}")
    profile = profile_call(lambda: step(params, opt, batch), "deepseek_v2_lite_train_profile",
                           25)
    result["plain"] = plain
    RESULTS["deepseek_v2_lite_train"] = plain
    # the dry run's plan of (a)'s cell on one rank against the tensors (a)
    # holds on the card, group by group (read, nothing allocated)
    plan = dryrun.cell_state(cfg, ShapeConfig("deepseek_v2_lite_train", S, B, "train"),
                             Mesh(("data", "model"), (1, 1)))
    held = {"params": tree_size_bytes(dict(params.named_parameters())),
            "opt": tree_size_bytes(opt), "batch": tree_size_bytes(batch)}
    check(plan == held, f"the dry run's plan of (a) is the bytes (a) holds: {plan}, {held}")
    result["dryrun_cross_check"] = {"plan_bytes": plan, "held_bytes": held}
    del opt

    # (b) the gradient sync at full width: each pod's gradients for its
    # half of the batch (dense dispatch), exact and int8 against the plain
    # mean of the two
    loss_fn = make_loss_fn(cfg, TrainConfig(remat="full", shuffle=dense))
    stacked = None
    for p_idx, half in enumerate(_split_micro(batch, EP_MESH["pod"])):
        grads, _ = _grads(loss_fn, params, half, TRAIN_MICROBATCHES)
        if stacked is None:
            stacked = {n: g.new_empty((EP_MESH["pod"], *g.shape)) for n, g in grads.items()}
        for n, g in grads.items():
            stacked[n][p_idx] = g
        del grads
    exchange = GS.pod_exchange(mesh)
    sync = {"pods": EP_MESH["pod"], "blob_bytes": TrainConfig().grad_sync_blob_bytes}
    for name, compress in (("exact", False), ("int8", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synced, _, nbytes = GS.blob_allreduce_grads(
            stacked, exchange=exchange, blob_bytes=sync["blob_bytes"], compress=compress)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        worst, largest = 0.0, 0.0
        for n, g in stacked.items():
            mean = (g[0] + g[1]) / 2
            check(torch.equal(synced[n][0], synced[n][1]), f"{name}: both pods hold {n}")
            worst = max(worst, float((synced[n][0] - mean).abs().max()))
            largest = max(largest, float(mean.abs().max()))
            if not compress:
                err = rel_max(synced[n][0], mean)
                check(err <= SYNC_EXACT_TOL, f"exact sync of {n}: {err}")
        if compress:
            check(worst / largest <= SYNC_INT8_TOL,
                  f"int8 sync within {SYNC_INT8_TOL} of the largest entry: {worst / largest}")
        sync[name] = {"pod_bytes": nbytes, "max_abs_err": worst, "largest": largest,
                      "rel_to_largest": worst / largest, "seconds": secs}
        del synced
    n_total = sum(g[0].numel() for g in stacked.values())
    sync["n_blobs"] = min(max(-(-n_total // (sync["blob_bytes"] // 4)), 1), GS.MAX_BLOBS)
    sync["elements"] = n_total
    result["grad_sync"] = sync
    del stacked

    # (c) BlobShuffle's training configuration: the int8 gradient sync,
    # the shuffle blob made pod-local; as in the JAX package, the pod
    # region's loss gets no mesh, so its MoE layers take the dense dispatch
    pods = EP_MESH["pod"]
    per_step = {flash.symbol: pods * TRAIN_FLASH_LAUNCHES,
                pack_kernel.PACK.symbol: pods * TRAIN_PACK_LAUNCHES,
                unpack_kernel.UNPACK.symbol: pods * TRAIN_PACK_LAUNCHES}
    step = make_train_step(cfg, TrainConfig(
        opt=opt_cfg, microbatches=TRAIN_MICROBATCHES, remat="full",
        shuffle=ep_blob, grad_sync="blob_int8"), mesh=mesh)
    with recording():
        opt, metrics, blob = run_steps(step, adamw_init(params), TRAIN_BLOB_STEPS, per_step)
    # every MoE call (forward and recompute, per pod and microbatch)
    dcn = sorted({float(dg["dcn_bytes"]) for dg in diags})
    blob.update(grad_sync_pod_bytes=float(metrics["grad_sync_bytes"]),
                moe_calls=len(meshes), moe_dcn_bytes=dcn, moe_dispatch="dense")
    check(len(meshes) == TRAIN_BLOB_STEPS * pods * TRAIN_MICROBATCHES * 2 * n_moe
          and all(ms is None for ms in meshes),
          f"every MoE call of the pod region without a mesh: {len(meshes)} calls")
    check(dcn == [0.0], f"pod-local MoE layers send nothing across pods: {dcn}")
    result["blob_int8"] = blob
    del opt

    # (d) the auto step with expert parallelism: the loss gets the mesh,
    # so every MoE call dispatches over the 32 stacked ranks, and the
    # backward runs through the stacked exchange (the twin of the
    # process-group step, whose processes run one rank each)
    per_step = {flash.symbol: TRAIN_FLASH_LAUNCHES,
                pack_kernel.PACK.symbol: TRAIN_EP_PACK_LAUNCHES,
                unpack_kernel.UNPACK.symbol: TRAIN_EP_UNPACK_LAUNCHES}
    step = make_train_step(cfg, TrainConfig(
        opt=opt_cfg, microbatches=TRAIN_MICROBATCHES, remat="full", shuffle=ep_blob,
        grad_sync="auto"), mesh=mesh)
    with recording():
        opt, metrics, auto_ep = run_steps(step, adamw_init(params), TRAIN_BLOB_STEPS, per_step)
    dcn = sorted({float(dg["dcn_bytes"]) for dg in diags})
    units = B * S // TRAIN_MICROBATCHES * m.top_k
    auto_ep.update(mesh=EP_MESH, moe_dispatch="blob", moe_calls=len(meshes),
                   moe_forward_calls=len(diags), moe_dcn_bytes=dcn,
                   dropped_per_call=[int(dg["dropped"]) for dg in diags], units_per_call=units,
                   drops_trained=[drop_causes(dg, units) for dg in diags],
                   aux_loss=float(metrics["aux_loss"]), nvidia_smi=smi,
                   why_stacked="NCCL refuses two ranks on one device, so one card runs "
                               "no process group of more than one rank")
    check(len(meshes) == TRAIN_BLOB_STEPS * TRAIN_MICROBATCHES * 2 * n_moe
          and all(ms is mesh for ms in meshes),
          f"every MoE call of the auto step over the mesh: {len(meshes)} calls")
    check(bool(dcn) and min(dcn) > 0, f"every MoE call sends across pods: {dcn}")
    foreign = _foreign_modules()
    check(not foreign, f"no module of JAX loaded: {foreign[:5]}")
    result["auto_ep"] = auto_ep
    del opt

    # the kernels at the training shape: one microbatch of 2 x 4,096 tokens
    mb = B // TRAIN_MICROBATCHES
    Hh, Dq = cfg.num_heads, cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
    q, kk, v, dout = (torch.randn((mb, S, Hh, Dq), generator=gen, device="cuda")
                      .to(torch.bfloat16) for _ in range(4))
    out = flash_kernel.flash_attention_cuda(q, kk, v, causal=True)
    flash_ms = time_ms(lambda: flash_kernel.launch(out, q, kk, v, causal=True), TIMED_RUNS)
    flash_bwd_ms = time_ms(lambda: flash_bwd(q, kk, v, out, dout, causal=True), 5, warmup=1)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), kk.transpose(1, 2), v.transpose(1, 2), is_causal=True)
    want = flash_ref(q, kk, v, causal=True)
    cmp = flash_compare(out, want)
    check(cmp["ok"], f"flash at the training shape: {cmp}")
    flops = flash_flops(mb, S, S, Hh, Dq)
    fb, fby = bound(flops, 4 * q.numel() * q.element_size())
    step_ms = plain["median_step_s"] * 1e3
    result["flash_backward"] = {"ms": flash_bwd_ms, "calls_per_step": TRAIN_FLASH_LAUNCHES // 2,
                                "share_of_plain_step": flash_bwd_ms * TRAIN_FLASH_LAUNCHES / 2
                                / step_ms}
    train_rows = [{
        "name": "flash_attention_train", "route": "cuda", "symbol": flash.symbol,
        "config": f"{arch} ({TRAIN_LAYERS} layers)", "path": "deepseek_v2_lite_train",
        "shape": [mb, S, Hh, Hh, Dq], "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:68",
        "launches": plain["launches_per_step"][flash.symbol],
        "launches_auto_ep": auto_ep["launches_per_step"][flash.symbol],
        "max_abs_err": cmp["max_abs_err"], "ms": flash_ms,
        "plain_ms": time_ms(lambda: flash_ref(q, kk, v, causal=True), 3, warmup=1),
        "bound_ms": fb, "bound_by": fby, "library_ms": time_ms(sdpa, TIMED_RUNS),
        "library_call": "scaled_dot_product_attention", "backward_ms": flash_bwd_ms,
        "backward": "plain torch (models/flash.py)", "flops": flops}]
    del q, kk, v, dout, out, want
    # pack and unpack at one microbatch's MoE shape: 8,192 tokens, top-6
    Tm, k, E, d = mb * S, m.top_k, m.num_experts, cfg.d_model
    cap = dispatch._cap(Tm * k / E, m.capacity_factor)
    x = torch.randn((Tm, d), generator=gen, device="cuda").to(torch.bfloat16)
    sel = api._route(x, params.blocks[0].ffn.router.detach(), k, True)[1].reshape(-1)
    order, starts, counts = sorted_order(sel, E)
    pk = bin_pack(sel, E, cap)
    tok = torch.arange(Tm, dtype=torch.int32, device="cuda").repeat_interleave(k)[order]
    buf = pack_kernel.blob_pack_fused_cuda(x, tok, starts, counts, capacity=cap)
    check(same_bits(buf, blob_pack_ref(x, tok, starts, counts, capacity=cap)),
          "pack at the training shape == blob_pack_ref")
    y = unpack_kernel.blob_unpack_fused_cuda(buf, pk.slot, pk.valid)
    check(same_bits(y, blob_unpack_ref(buf, pk.slot, pk.valid)),
          "unpack at the training shape == blob_unpack_ref")
    live = int(torch.clamp(counts, max=cap).sum())
    n_valid = int(pk.valid.sum())
    row_bytes = d * x.element_size()
    pos = starts[:, None] + torch.arange(cap, device="cuda", dtype=torch.int32)
    flat_tok = tok[torch.clamp(pos, 0, tok.shape[0] - 1)].reshape(-1)
    shape = {"units": Tm * k, "bins": E, "capacity": cap, "width": d, "dtype": "bfloat16"}
    # launches a step at the timed shape: the forward's and the
    # recompute's; for unpack also pack's backward, which reads the same
    # bins back into the Tm * k sorted positions (unpack's backward, a
    # pack of Tm * k + 1 rows by E * cap slots, is at another shape)
    timed_keys = {"moe_pack_train": (("pack", (Tm, d), (Tm * k,), (E, cap, d)), 2),
                  "moe_unpack_train": (("unpack", (E, cap, d), (Tm * k,), (Tm * k, d)), 3)}
    for name, kern, run, plain_fn, library, nbytes, replaces in (
            ("moe_pack_train", pack_kernel.PACK,
             lambda: pack_kernel.launch(buf, x, tok, starts, counts),
             lambda: blob_pack_ref(x, tok, starts, counts, capacity=cap),
             lambda: torch.index_select(x, 0, flat_tok),
             live * row_bytes + buf.numel() * buf.element_size() + 4 * (Tm * k + 2 * E),
             "src/repro/kernels/blob_pack/kernel.py:95"),
            ("moe_unpack_train", unpack_kernel.UNPACK,
             lambda: unpack_kernel.launch(y, buf, pk.slot, pk.valid),
             lambda: blob_unpack_ref(buf, pk.slot, pk.valid),
             lambda: torch.index_select(buf.view(-1, d), 0, pk.slot),
             n_valid * row_bytes + Tm * k * row_bytes + 5 * Tm * k,
             "src/repro/kernels/blob_unpack/kernel.py:79")):
        bound_ms, bound_by = bound(0, nbytes)
        train_rows.append({
            "name": name, "route": "cuda", "symbol": kern.symbol,
            "config": f"{arch} ({TRAIN_LAYERS} layers)", "path": "deepseek_v2_lite_train",
            "shape": shape, "source": "src/repro_torch/kernels/csrc/blob_kernels.cu",
            "replaces": replaces, "launches": plain["launches_per_step"][kern.symbol],
            "launches_at_timed_shape": by_shape.get(timed_keys[name][0], 0) // TRAIN_STEPS,
            "max_abs_err": 0.0,
            "ms": time_ms(run, TIMED_RUNS), "plain_ms": time_ms(plain_fn, 5, warmup=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(library, TIMED_RUNS), "library_call": "torch.index_select",
            "bytes": nbytes})
        train_rows[-1]["launches_auto_ep"] = auto_ep["launches_per_step"][kern.symbol]
        check(train_rows[-1]["launches_at_timed_shape"]
              == timed_keys[name][1] * n_moe * TRAIN_MICROBATCHES,
              f"{name}: {timed_keys[name][1]} launches a MoE layer and microbatch at the "
              f"timed shape {timed_keys[name][0]}: {plain['launches_by_shape_per_step']}")
    result["flash_backward"]["share_note"] = (
        "the plain backward's time at the training shape, times its calls a "
        "step, over the median plain step")
    # (d)'s references, on the fresh parameters drawn again from the seed
    # (the trained ones go): the drops of one microbatch's forward through
    # the blob dispatch at the config's capacity, and the loss and
    # gradients of the expert-parallel loss at a capacity factor of E,
    # where no unit drops, against the dense dispatch's (nothing drops
    # there at E either) on the first TRAIN_EP_REF_TOKENS tokens (the
    # buffers grow with the factor)
    del x, buf, y
    params = init_params(lm.LM(cfg, device="cuda"),
                         torch.Generator(device="cuda").manual_seed(seed))
    check(torch.equal(params.blocks[1].ffn.router, fresh_router),
          "the parameters drawn again are the fresh ones")
    torch.cuda.empty_cache()
    mb0 = _split_micro(batch, TRAIN_MICROBATCHES)[0]
    with torch.no_grad(), recording():
        make_loss_fn(cfg, TrainConfig(remat="full", shuffle=ep_blob), mesh=mesh)(params, mb0)
    fresh_drops = [drop_causes(dg, mb0["tokens"].numel() * m.top_k) for dg in diags]
    cfg_e = dataclasses.replace(cfg, moe=dataclasses.replace(m, capacity_factor=float(E)))
    ref_batch = {n: t[:1, :TRAIN_EP_REF_TOKENS].contiguous() for n, t in batch.items()}
    torch.cuda.reset_peak_memory_stats()
    ref = {}
    for name, shuf, on in (("dense", api.ShuffleConfig(mode="dense"), None),
                           ("blob", api.ShuffleConfig(mode="blob", capacity_factor=float(E)),
                            mesh)):
        loss_fn = make_loss_fn(cfg_e, TrainConfig(remat="full", shuffle=shuf), mesh=on)
        with recording():
            grads, ref_m = _grads(loss_fn, params, ref_batch, 1)
        ref[name] = (grads, {k: float(v) for k, v in ref_m.items()},
                     [int(dg["dropped"]) for dg in diags])
        del grads
    (gd, dense_m, _), (gb, blob_m, dropped_e) = ref["dense"], ref["blob"]
    sq = {n: (float(((gb[n] - g) ** 2).sum()), float((g ** 2).sum()), float((gb[n] ** 2).sum()))
          for n, g in gd.items()}
    rel = {n: (a / b) ** 0.5 for n, (a, b, _) in sq.items() if b > 0}
    ep_ref = {"tokens": TRAIN_EP_REF_TOKENS, "capacity_factor": float(E),
              "dropped_per_call": dropped_e, "loss": blob_m["loss"], "dense_loss": dense_m["loss"],
              "aux_loss": blob_m["aux_loss"], "dense_aux_loss": dense_m["aux_loss"],
              "loss_rel_err": abs(blob_m["loss"] - dense_m["loss"]) / abs(dense_m["loss"]),
              "grad_norm": sum(c for _, _, c in sq.values()) ** 0.5,
              "dense_grad_norm": sum(b for _, b, _ in sq.values()) ** 0.5,
              "grad_rel_err": (sum(a for a, _, _ in sq.values())
                               / sum(b for _, b, _ in sq.values())) ** 0.5,
              "worst_param": max(rel, key=rel.get), "worst_param_rel_err": max(rel.values()),
              "loss_tolerance": TRAIN_EP_LOSS_TOL, "grad_tolerance": TRAIN_EP_GRAD_TOL,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del ref, gd, gb
    check(len(dropped_e) == n_moe and not any(dropped_e),
          f"the blob dispatch at a capacity factor of E drops nothing: {dropped_e}")
    check(ep_ref["loss_rel_err"] <= TRAIN_EP_LOSS_TOL,
          f"the EP loss {blob_m['loss']} vs the dense dispatch's {dense_m['loss']}")
    check(ep_ref["grad_rel_err"] <= TRAIN_EP_GRAD_TOL,
          f"the EP gradients vs the dense dispatch's: {ep_ref['grad_rel_err']} rel. Frobenius "
          f"(worst {ep_ref['worst_param']}: {ep_ref['worst_param_rel_err']})")
    auto_ep.update(drops_fresh=fresh_drops, reference=ep_ref)
    emit({**result, "ok": True})
    emit(profile)
    del params, batch, rows
    return train_rows


def shuffle_fed_settings(seed: int):
    """The shuffle-fed phase's model config (deepseek-v2-lite with
    ``TRAIN_LAYERS`` layers), token stream, test mesh and train config,
    and the kernels' launches a step, which the resume phase shares:
    ``(cfg, stream, mesh, tcfg, kernels, per_step)``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.blob_codec import kernel as codec_kernel
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.shuffle.api import ShuffleConfig
    from repro_torch.train_input import TokenStreamConfig
    from repro_torch.training import OptConfig, TrainConfig

    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"), num_layers=TRAIN_LAYERS)
    stream = TokenStreamConfig(vocab_size=cfg.vocab_size, batch=DECODER_PREFILL_BATCH,
                               seq_len=PREFILL_LEN, seed=seed)
    mesh = make_test_mesh(devices=8)
    opt_cfg = OptConfig(learning_rate=1e-3, warmup_steps=2, total_steps=SHUFFLE_FED_STEPS)
    tcfg = TrainConfig(opt=opt_cfg, microbatches=TRAIN_MICROBATCHES, remat="full",
                       shuffle=ShuffleConfig(mode="blob", capacity_factor=SHUFFLE_FED_CAPACITY),
                       grad_sync="blob_int8")
    kernels = {kn.symbol: kn for kn in (pack_kernel.PACK, unpack_kernel.UNPACK,
                                        codec_kernel.COMPRESS_PACK,
                                        codec_kernel.UNPACK_DECOMPRESS,
                                        *flash_kernel.KERNELS, *ssd_kernel.KERNELS)}
    pods = mesh.shape["pod"]
    per_step = {flash_kernel.FLASH_WGMMA.symbol: pods * TRAIN_FLASH_LAUNCHES,
                pack_kernel.PACK.symbol: pods * TRAIN_PACK_LAUNCHES,
                unpack_kernel.UNPACK.symbol: pods * TRAIN_PACK_LAUNCHES}
    return cfg, stream, mesh, tcfg, kernels, per_step


def deepseek_v2_lite_shuffle_fed(seed: int, smi: str) -> None:
    """Phase ``deepseek_v2_lite_shuffle_fed``: deepseek-v2-lite at published
    widths with ``TRAIN_LAYERS`` of its layers, trained on the card for
    ``SHUFFLE_FED_STEPS`` steps by ``repro_torch.train_input``'s
    ``train_shuffle_fed``, each step's 4 x 4,096 tokens shuffled through
    the training benchmark's faulty elastic engine (AZ 1 out at 0.30 s of
    the virtual clock, a step every 0.05 s) and put on the card by
    ``ShuffleFedInput`` over the test mesh (pod 2, data 2, model 2); the
    ``blob_int8`` step of (c). Checks: the trainer served steps 0..11
    once each, every batch ``reference_batch``'s bit for bit (on the
    host); the first batch of a fresh pipeline validates against the
    input specs and its report is ``input_spec_report``'s;
    ``lower_train_step`` runs at that shape; the double buffer's overlap
    at least ``SHUFFLE_FED_OVERLAP``; finite losses, the mean of the last
    3 below that of the first 3; (c)'s flash, pack and unpack launches a
    step and no other kernel; no module of ``jax`` or of the JAX package
    loaded. Hands its losses, steps, peak and final parameters' digest
    to the resume phase through ``RESULTS``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.engine import faulty_elastic_engine
    from repro_torch.train_input import (ShuffleFedInput, input_spec_report,
                                         lower_train_step, reference_batch,
                                         train_shuffle_fed, validate_device_batch)
    from repro_torch.training import make_train_step

    before = set(_foreign_modules())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    check(held_gb < 0.5, f"device memory free before the shuffle-fed run: {held_gb} GB held")
    arch = "deepseek-v2-lite-16b"
    cfg, stream, mesh, tcfg, kernels, per_step = shuffle_fed_settings(seed)
    B, S, steps = stream.batch, stream.seq_len, SHUFFLE_FED_STEPS
    opt_cfg = tcfg.opt
    clusters = []

    def engine_factory():
        eng, cluster, _ = faulty_elastic_engine()
        clusters.append(cluster)
        return eng

    # the dryrun gate: a fresh pipeline's first batch, and the step at its shape
    probe = ShuffleFedInput(engine_factory(), stream, steps=1, mesh=mesh, model_cfg=cfg,
                            **SHUFFLE_FED_PIPELINE)
    probe.submit()
    _, first, _ = probe.next_batch()
    report = validate_device_batch(first, cfg, probe.shape, mesh)
    check(report == input_spec_report(cfg, probe.shape, mesh),
          f"the device batch's report is input_spec_report's: {report}")
    t0 = time.perf_counter()
    head = lower_train_step(cfg, tcfg, mesh, probe.shape)
    torch.cuda.synchronize()
    lower_s = time.perf_counter() - t0
    del first, probe
    clusters.clear()
    torch.cuda.empty_cache()

    step = make_train_step(cfg, tcfg, mesh=mesh)
    served, secs, model = [], [], []

    def recording_step(params, opt, batch):
        # the batch as the trainer got it, the step's device time, the model
        served.append(batch)
        t1 = time.perf_counter()
        out = step(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        model[:] = out[:1]
        return out

    for kn in kernels.values():
        kn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_shuffle_fed(cfg, tcfg, mesh, stream, steps=steps, engine_factory=engine_factory,
                            step_fn=recording_step, init_seed=seed,
                            pipeline_kwargs=SHUFFLE_FED_PIPELINE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {s_: kn.launches for s_, kn in kernels.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    st = res.input_stats
    check(not res.crashed and res.steps == list(range(steps)) and len(served) == steps
          and st["requests"] == steps,
          f"steps 0..{steps - 1} served once each: {res.steps}, {st['requests']} requests")
    for s_, batch in enumerate(served):
        want = reference_batch(stream, s_)
        check(sorted(batch) == sorted(want) and all(
            batch[k].dtype == torch.int32 and batch[k].is_cuda
            and np.array_equal(batch[k].cpu().numpy(), want[k]) for k in want),
            f"step {s_}'s batch on the card is reference_batch's bit for bit")
    check(launches == {s_: steps * per_step.get(s_, 0) for s_ in kernels},
          f"{steps} steps: {per_step} launches a step and no other kernel: {launches}")
    losses = res.losses
    check(all(np.isfinite(losses)), f"finite losses {losses}")
    check(float(np.mean(losses[-3:])) < float(np.mean(losses[:3])),
          f"the mean loss of the last 3 steps below the first 3's: {losses}")
    check(st["overlap_fraction"] >= SHUFFLE_FED_OVERLAP,
          f"overlap {st['overlap_fraction']} >= {SHUFFLE_FED_OVERLAP}")
    (cluster,) = clusters
    rebalances = len([e for e in cluster.rebalancer.events if not e.superseded])
    check(rebalances >= 1, "the AZ outage rebalances the cluster")
    foreign = sorted(set(_foreign_modules()) - before)
    check(not foreign, f"the phase loads no module of jax or the JAX package: {foreign[:5]}")
    RESULTS["deepseek_v2_lite_shuffle_fed"] = {
        "losses": losses, "steps": res.steps, "peak_memory_gb": peak,
        "params_digest": params_digest(model.pop())}
    median_s = statistics.median(secs[1:])
    emit({"phase": "deepseek_v2_lite_shuffle_fed", "nvidia_smi": smi, "arch": arch,
          "layers": cfg.num_layers, "published_layers": get_config(arch).num_layers,
          "batch": B, "seq": S, "steps": steps, "record_bytes": stream.record_value_bytes,
          "mesh": mesh.shape, "microbatches": TRAIN_MICROBATCHES, "remat": "full",
          "compute_dtype": "bfloat16", "shuffle": "blob", "grad_sync": "blob_int8",
          "capacity_factor": SHUFFLE_FED_CAPACITY, "opt": dataclasses.asdict(opt_cfg),
          "engine": "faulty_elastic_engine (FaultyStore 2% over ExpressOneZoneStore, "
                    "9 partitions, 3 instances, AZ 1 out at 0.30 s)",
          "pipeline": SHUFFLE_FED_PIPELINE,
          "clocks": "step_s, step_time_s, host_*_s, wall_s: the host's clock, each step "
                    "synchronised; the engine runs on a virtual clock",
          "losses": losses, "step_s": secs, "median_step_s": median_s,
          "tokens_per_s": B * S / median_s, "step_time_s": st["step_time_s"],
          "mean_step_s": st["step_time_s"] / steps,
          "host_wait_s": st["host_wait_s"], "host_prefetch_s": st["host_prefetch_s"],
          "overlap_fraction": st["overlap_fraction"],
          "records_delivered": st["records_delivered"],
          "bytes_delivered": st["bytes_delivered"],
          "records_replayed": st["records_replayed"],
          "duplicate_rows_filtered": st["duplicate_rows_filtered"],
          "rebalances": rebalances, "peak_memory_gb": peak, "wall_s": wall,
          "launches_per_step": {s_: c // steps for s_, c in launches.items() if c},
          "input_specs": report, "lower_train_step": head, "lower_train_step_s": lower_s,
          "ok": True})


def shuffle_fed_process_group(seed: int, smi: str) -> None:
    """Phase ``shuffle_fed_process_group`` (step 12 above): the shuffle-fed
    phase's model, stream, engine and pipeline with the ``auto`` sync,
    ``PG_STEPS`` steps of ``train_shuffle_fed`` over
    ``process_group_test_mesh()`` on one NCCL process, then over a
    ``StackedMesh`` of the same axes once the group is destroyed: the
    same batches, losses, parameters and launches."""
    import dataclasses
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.launch.engine import faulty_elastic_engine
    from repro_torch.launch.mesh import process_group_test_mesh, stacked_mesh
    from repro_torch.models.common import ShapeConfig
    from repro_torch.train_input import (input_spec_report, reference_batch,
                                         train_shuffle_fed, validate_device_batch)
    from repro_torch.training import make_train_step

    t_phase = time.perf_counter()
    before = set(_foreign_modules())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    check(held_gb < 0.5, f"device memory free before the process-group run: {held_gb} GB held")
    arch = "deepseek-v2-lite-16b"
    cfg, stream, _, tcfg, kernels, _ = shuffle_fed_settings(seed)
    tcfg = dataclasses.replace(tcfg, grad_sync="auto",
                               opt=dataclasses.replace(tcfg.opt, total_steps=PG_STEPS))
    shape = ShapeConfig("shuffle_fed", stream.seq_len, stream.batch, "train")
    # the auto step on a mesh with no expert axis: (c)'s dense dispatch
    per_step = {flash_kernel.FLASH_WGMMA.symbol: TRAIN_FLASH_LAUNCHES,
                pack_kernel.PACK.symbol: TRAIN_PACK_LAUNCHES,
                unpack_kernel.UNPACK.symbol: TRAIN_PACK_LAUNCHES}

    def run(mesh):
        """(the run's readings, its final model)"""
        step = make_train_step(cfg, tcfg, mesh=mesh)
        served, secs, model, reports = [], [], [], []

        def recording_step(params, opt, batch):
            if not reports:
                reports.append(validate_device_batch(batch, cfg, shape, mesh))
            served.append(batch)
            t1 = time.perf_counter()
            out = step(params, opt, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t1)
            model[:] = out[:1]
            return out

        for kn in kernels.values():
            kn.launches = 0
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = train_shuffle_fed(cfg, tcfg, mesh, stream, steps=PG_STEPS,
                                engine_factory=lambda: faulty_elastic_engine()[0],
                                step_fn=recording_step, init_seed=seed,
                                pipeline_kwargs=SHUFFLE_FED_PIPELINE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {s_: kn.launches for s_, kn in kernels.items()}
        kind = type(mesh).__name__
        check(not res.crashed and res.steps == list(range(PG_STEPS)) and len(served) == PG_STEPS,
              f"{kind}: steps 0..{PG_STEPS - 1} served once each: {res.steps}")
        for s_, batch in enumerate(served):
            want = reference_batch(stream, s_)
            check(sorted(batch) == sorted(want) and all(
                batch[k].dtype == torch.int32 and batch[k].is_cuda
                and np.array_equal(batch[k].cpu().numpy(), want[k]) for k in want),
                f"{kind}: step {s_}'s batch on the card is reference_batch's bit for bit")
        check(reports[0] == input_spec_report(cfg, shape, mesh),
              f"{kind}: the device batch's report is input_spec_report's: {reports[0]}")
        check(all(np.isfinite(res.losses)), f"{kind}: finite losses {res.losses}")
        check(launches == {s_: PG_STEPS * per_step.get(s_, 0) for s_ in kernels},
              f"{kind}: {per_step} launches a step and no other kernel: {launches}")
        # the run's own peak, over what an earlier run's model holds
        return {"losses": res.losses, "step_s": secs, "median_step_s": statistics.median(secs[1:]),
                "peak_memory_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
                "wall_s": wall,
                "launches_per_step": {s_: c // PG_STEPS for s_, c in launches.items() if c},
                "input_specs": reports[0]}, model.pop()

    folder = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{folder}/rendezvous", rank=0,
                            world_size=1)
    try:
        backend = dist.get_backend()
        mesh = process_group_test_mesh()
        pg, pg_model = run(mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(folder)
    check(backend == "nccl", f"the process group's backend is nccl, not {backend}")
    check(not dist.is_initialized(), "the process group destroyed")
    torch.cuda.empty_cache()
    stacked, stacked_model = run(stacked_mesh(**mesh.shape))
    check(not dist.is_initialized(), "the stacked run made no process group")
    # the final parameters compared on the card, bit for bit
    differ = [n for (n, a), (_, b) in zip(pg_model.named_parameters(),
                                          stacked_model.named_parameters())
              if not same_bits(a.detach(), b.detach())]
    del pg_model, stacked_model
    same = np.array(pg["losses"]).tobytes() == np.array(stacked["losses"]).tobytes() and not differ
    gap = max(abs(a - b) / abs(b) for a, b in zip(pg["losses"], stacked["losses"]))
    check(same or gap <= PG_LOSS_TOL,
          f"the process-group run's losses within {PG_LOSS_TOL} of the stacked run's: {gap}")
    check(pg["launches_per_step"] == stacked["launches_per_step"],
          f"the same launches a step: {pg['launches_per_step']}, {stacked['launches_per_step']}")
    foreign = sorted(set(_foreign_modules()) - before)
    check(not foreign, f"the phase loads no module of jax or the JAX package: {foreign[:5]}")
    emit({"phase": "shuffle_fed_process_group", "nvidia_smi": smi, "backend": backend,
          "world_size": 1, "mesh": mesh.shape, "arch": arch, "layers": cfg.num_layers,
          "published_layers": get_config(arch).num_layers, "batch": stream.batch,
          "seq": stream.seq_len, "steps": PG_STEPS, "microbatches": TRAIN_MICROBATCHES,
          "remat": "full", "compute_dtype": "bfloat16", "shuffle": "blob", "grad_sync": "auto",
          "clocks": "step_s, wall_s, seconds: the host's clock, each step synchronised",
          "same_bits": same, "params_differing": differ, "max_rel_loss_gap": gap,
          "peak_memory": "each run's peak over what was allocated before it (the process-group "
                         "run's model, held for the comparison)",
          "process_group": pg,
          "stacked": stacked, "seconds": time.perf_counter() - t_phase, "ok": True})


def host_available_gb() -> float:
    """The host's available memory (``MemAvailable``), in GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def host_released(start_gb: float):
    """Wait, up to ``RESTART_RELEASE_S``, for a deleted store's host memory
    to come back within ``RESTART_RELEASE_GB`` of ``start_gb`` (the host's
    allocator may hand freed memory back to the system late); fails if it
    does not. Returns (GB available, seconds waited)."""
    t1 = time.perf_counter()
    while True:
        end_gb = host_available_gb()
        release_s = time.perf_counter() - t1
        if end_gb >= start_gb - RESTART_RELEASE_GB or release_s > RESTART_RELEASE_S:
            break
        time.sleep(0.5)
    check(end_gb >= start_gb - RESTART_RELEASE_GB,
          f"the store deleted: {end_gb} GB available against {start_gb} at the start, "
          f"{release_s:.1f} s after")
    return end_gb, release_s


def host_headroom(n_manifests: int, manifest_bytes: int) -> float:
    """The host's available GB; fails unless the host holds
    ``n_manifests`` checkpoint manifests of ``manifest_bytes`` each with
    ``RESTART_HOST_SPARE_GB`` to spare."""
    need_gb = n_manifests * manifest_bytes / 1e9 + RESTART_HOST_SPARE_GB
    start_gb = host_available_gb()
    check(start_gb >= need_gb,
          f"the host has {start_gb:.1f} GB available; {n_manifests} manifests of "
          f"{manifest_bytes / 1e9:.2f} GB with {RESTART_HOST_SPARE_GB} GB to spare need "
          f"{need_gb:.1f} GB")
    return start_gb


def manifest_sizes(manifests) -> list:
    """Each manifest's bytes, summed over its leaves."""
    return [sum(int(np.prod(e["shape"], dtype=np.int64)) * np.dtype(e["dtype"]).itemsize
                for e in m["leaves"]) for m in manifests]


def timed_restore(real_restore, restores: list):
    """``real_restore`` wrapped to append its step, seconds and the host's
    available GB before and after to ``restores``."""
    def restore(step_, like, **kw):
        avail = host_available_gb()
        t1 = time.perf_counter()
        out = real_restore(step_, like, **kw)
        torch.cuda.synchronize()
        restores.append({"step": step_, "s": time.perf_counter() - t1,
                         "host_available_gb_before": avail,
                         "host_available_gb_after": host_available_gb()})
        return out
    return restore


def host_low_checked(saves: list, restores: list) -> float:
    """The least host GB available read around the saves and restores;
    fails if it is below ``RESTART_HOST_SPARE_GB``."""
    low = min(v for r in saves + restores for k, v in r.items() if k.startswith("host_avail"))
    check(low >= RESTART_HOST_SPARE_GB,
          f"{RESTART_HOST_SPARE_GB} GB of host memory free around every save and the "
          f"restore: {low}")
    return low


def store_readout(store):
    """A tiered store's retries and the GB its remote tier holds."""
    return store.retries, sum(len(o.data) for o in store.store.inner.objects.values()) / 1e9


def params_digest(model) -> dict:
    """sha256 of each parameter's bytes, a parameter at a time on the host."""
    return {name: hashlib.sha256(p.detach().cpu().numpy().tobytes()).hexdigest()
            for name, p in model.named_parameters()}


def deepseek_v2_lite_shuffle_resume(seed: int, smi: str) -> None:
    """Phase ``deepseek_v2_lite_shuffle_resume`` (step 13 above): the
    training benchmark's crash lane at published widths. The shuffle-fed
    phase's run, checkpointed into the lane's store with synchronous
    uploads, crashes mid-step ``RESUME_CRASH_AT`` and resumes; the
    uninterrupted lane is the shuffle-fed phase's own run (``RESULTS``).
    Then the shuffle-fed launcher's crash and resume as two processes."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import BlobCheckpointer, TieredCheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.core.stores import FaultyStore, SimulatedS3
    from repro_torch.launch.engine import faulty_elastic_engine
    from repro_torch.train_input import ShuffleFedInput, train_shuffle_fed
    from repro_torch.training import make_train_step

    fed = RESULTS["deepseek_v2_lite_shuffle_fed"]
    before_modules = set(_foreign_modules())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    check(held_gb < 0.5, f"device memory free before the resume phase: {held_gb} GB held")
    arch = "deepseek-v2-lite-16b"
    cfg, stream, mesh, tcfg, kernels, per_step = shuffle_fed_settings(seed)
    steps, every, crash_at = SHUFFLE_FED_STEPS, RESUME_CKPT_EVERY, RESUME_CRASH_AT
    resume_at = crash_at // every * every
    committed = sorted({0, *range(every, steps + 1, every)})
    n_params = cfg.param_count()
    manifest_bytes = 3 * 4 * n_params + 4   # params, m and v in f32, the int32 count
    start_gb = host_headroom(len(committed), manifest_bytes)

    # the crash lane's store (benchmarks/train_input.py), synchronous uploads
    store = TieredCheckpointStore(FaultyStore(SimulatedS3(seed=31), seed=33,
                                              transient_p=0.05))
    ckpt = BlobCheckpointer(store, async_upload=False)
    saves, restores, forwards, first_put = [], [], [], []
    real = {"save": ckpt.save, "restore": ckpt.restore, "put": store.put,
            "fast_forward": ShuffleFedInput.fast_forward}

    def marking_put(blob_id, data):
        # a synchronous save copies every leaf to the host, then uploads:
        # its first upload is the end of the host copy and the host's low
        if not first_put:
            first_put.extend([time.perf_counter(), host_available_gb()])
        real["put"](blob_id, data)

    def timed_save(step_, tree, **kw):
        avail = host_available_gb()
        first_put.clear()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        real["save"](step_, tree, **kw)
        t2 = time.perf_counter()
        saves.append({"step": step_, "host_copy_s": first_put[0] - t1,
                      "upload_s": t2 - first_put[0], "s": t2 - t1,
                      "host_available_gb_before": avail,
                      "host_available_gb_copied": first_put[1],
                      "host_available_gb_after": host_available_gb()})

    def timed_fast_forward(pipeline, resume_step, expected_offsets=None):
        t1 = time.perf_counter()
        real["fast_forward"](pipeline, resume_step, expected_offsets)
        forwards.append({"step": resume_step, "s": time.perf_counter() - t1,
                         "offsets": {str(k): v for k, v in pipeline.offsets().items()}})

    step = make_train_step(cfg, tcfg, mesh=mesh)
    secs, model = [], []

    def counting_step(params, opt, batch):
        t1 = time.perf_counter()
        out = step(params, opt, batch)
        torch.cuda.synchronize()
        secs[-1].append(time.perf_counter() - t1)
        model[:] = out[:1]
        return out

    def run(**kw):
        secs.append([])
        t0 = time.perf_counter()
        res = train_shuffle_fed(cfg, tcfg, mesh, stream, steps=steps,
                                engine_factory=lambda: faulty_elastic_engine()[0], ckpt=ckpt,
                                ckpt_every=every, step_fn=counting_step, init_seed=seed,
                                pipeline_kwargs=SHUFFLE_FED_PIPELINE, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    ckpt.save, ckpt.restore = timed_save, timed_restore(real["restore"], restores)
    store.put = marking_put
    ShuffleFedInput.fast_forward = timed_fast_forward
    for kn in kernels.values():
        kn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        broken, broken_s = run(crash_at_step=crash_at)
        model.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        between_gb = torch.cuda.memory_allocated() / 1e9
        check(between_gb < 0.5, f"the crashed run's state is gone from the card: "
                                f"{between_gb} GB held")
        resumed, resumed_s = run(resume=True)
    finally:
        ShuffleFedInput.fast_forward = real["fast_forward"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {s_: kn.launches for s_, kn in kernels.items()}
    n_calls = sum(len(x) for x in secs)

    check(broken.crashed and broken.steps == list(range(crash_at)),
          f"the crashed run trained 0..{crash_at - 1}: {broken.steps}")
    check(not resumed.crashed and resumed.start_step == resume_at and resumed.offsets_checked
          and resumed.steps == list(range(resume_at, steps)),
          f"the resumed run starts at {resume_at}, its offsets checked, and trains "
          f"{resume_at}..{steps - 1}: {resumed.start_step}, {resumed.offsets_checked}, "
          f"{resumed.steps}")
    timeline = broken.steps[:resume_at] + resumed.steps
    check(timeline == list(range(steps)) == fed["steps"],
          f"the committed prefix and the resumed steps are 0..{steps - 1} once each "
          f"(0 skipped, 0 duplicated): {timeline}")
    spliced = broken.losses[:resume_at] + resumed.losses
    check(spliced == fed["losses"],
          f"the spliced losses {spliced} are the shuffle-fed run's {fed['losses']} "
          f"bit for bit")
    final_digest = params_digest(model.pop())
    differ = sorted(n for n in fed["params_digest"] if final_digest[n] != fed["params_digest"][n])
    check(not differ, f"the final parameters are the shuffle-fed run's bit for bit: "
                      f"{len(differ)} differ, {differ[:5]}")
    names = store.manifests()
    check(names == [f"step{s_:08d}.json" for s_ in committed],
          f"manifests {committed} committed: {names}")
    manifests = [store.get_manifest(name) for name in names]
    sizes = manifest_sizes(manifests)
    check(sizes == [manifest_bytes] * len(names),
          f"each manifest {manifest_bytes} bytes: {sizes}")
    check([m["extra"]["next_step"] for m in manifests] == committed,
          f"each manifest's next step is its own: {[m['extra'] for m in manifests]}")
    replayed = manifests[committed.index(resume_at)]["extra"]["offsets"]
    check([f["step"] for f in forwards] == [resume_at] and forwards[0]["offsets"] == replayed,
          f"manifest {resume_at}'s offsets {replayed} are what the resume replayed: {forwards}")
    check([r["step"] for r in restores] == [resume_at], f"one restore, of {resume_at}: {restores}")
    check(n_calls == crash_at + steps - resume_at,
          f"{crash_at} steps crashed and {steps - resume_at} resumed: {n_calls} step calls")
    check(launches == {s_: n_calls * per_step.get(s_, 0) for s_ in kernels},
          f"{n_calls} step calls: {per_step} a step and no other kernel: {launches}")
    check(peak <= fed["peak_memory_gb"] + RESTART_PEAK_MARGIN_GB,
          f"peak {peak} GB within {RESTART_PEAK_MARGIN_GB} GB of the shuffle-fed run's "
          f"{fed['peak_memory_gb']}")
    low_gb = host_low_checked(saves, restores)
    retries, store_gb = store_readout(store)
    stats = {name: {k: r.input_stats[k] for k in ("records_delivered", "records_replayed",
                                                   "duplicate_rows_filtered", "skipped_rows",
                                                   "requests", "overlap_fraction")}
             for name, r in (("crashed", broken), ("resumed", resumed))}
    crashed_losses, resumed_losses = broken.losses, resumed.losses
    del ckpt, real, store, broken, resumed, manifests
    gc.collect()
    torch.cuda.empty_cache()
    end_gb, release_s = host_released(start_gb)

    # the launcher on the card: SMOKE, a crash and a resume in two processes
    launcher = []
    with tempfile.TemporaryDirectory() as tmp:
        for args, want in ((["--crash-at", "6"], "CRASHED"),
                           (["--resume"], "OK mode=blob grad_sync=auto start_step=4 ")):
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.shuffle_train", "--steps", "12",
                 *args], cwd=ROOT, capture_output=True, text=True, timeout=300,
                env={**os.environ, "PYTHONPATH": str(ROOT / "src"), "TMPDIR": tmp})
            seconds = time.perf_counter() - t0
            check(out.returncode == 0, f"the shuffle-fed launcher {args}: rc "
                                       f"{out.returncode}: {out.stderr[-2000:]}")
            last = out.stdout.strip().splitlines()[-1]
            check(last.startswith(want), f"the shuffle-fed launcher {args} prints {want!r}: "
                                         f"{last!r}")
            launcher.append({"args": args, "seconds": seconds, "last_line": last})
    foreign = sorted(set(_foreign_modules()) - before_modules)
    check(not foreign, f"the phase loads no module of jax or the JAX package: {foreign[:5]}")
    emit({"phase": "deepseek_v2_lite_shuffle_resume", "nvidia_smi": smi, "arch": arch,
          "layers": cfg.num_layers, "published_layers": get_config(arch).num_layers,
          "params": n_params, "batch": stream.batch, "seq": stream.seq_len, "steps": steps,
          "mesh": mesh.shape, "microbatches": TRAIN_MICROBATCHES, "remat": "full",
          "compute_dtype": "bfloat16", "shuffle": "blob", "grad_sync": "blob_int8",
          "capacity_factor": SHUFFLE_FED_CAPACITY, "opt": dataclasses.asdict(tcfg.opt),
          "engine": "faulty_elastic_engine (FaultyStore 2% over ExpressOneZoneStore, "
                    "9 partitions, 3 instances, AZ 1 out at 0.30 s)",
          "pipeline": SHUFFLE_FED_PIPELINE,
          "store": "TieredCheckpointStore(FaultyStore(SimulatedS3(seed=31), seed=33, "
                   "transient_p=0.05)) in host memory, synchronous uploads",
          "ckpt_every": every, "crash_at_step": crash_at,
          "cuts": {"ckpt_every": "6, the benchmark's --quick 4",
                   "crash_at_step": "8, the benchmark's --quick 6",
                   "why": "a manifest is 20.04 GB: the host holds 0, 6 and 12 (60.1 GB), "
                          "not 0, 4, 8 and 12 (80.2 GB)"},
          "uninterrupted": "the deepseek_v2_lite_shuffle_fed phase's run",
          "clocks": "every *_s: the host's clock, synchronised; a save's host_copy_s runs "
                    "to its first upload (host_available_gb_copied read there), upload_s "
                    "from there to its manifest; store_release_s the wait for the deleted "
                    "store's memory",
          "resume_step": resume_at, "timeline": timeline, "losses": spliced,
          "crashed_losses": crashed_losses, "resumed_losses": resumed_losses,
          "manifests": names, "manifest_bytes": manifest_bytes, "store_gb": store_gb,
          "replayed_offsets": forwards[0]["offsets"], "saves": saves, "restores": restores,
          "fast_forward_s": forwards[0]["s"], "retries": retries,
          "crashed_run_s": broken_s, "resumed_run_s": resumed_s,
          "crashed_step_s": secs[0], "resumed_step_s": secs[1],
          "input": stats, "step_calls": n_calls,
          "launches_per_step": {s_: c // n_calls for s_, c in launches.items() if c},
          "device_gb_between_runs": between_gb,
          "peak_memory_gb": peak, "shuffle_fed_peak_gb": fed["peak_memory_gb"],
          "host_available_gb": {"start": start_gb, "min": low_gb, "end": end_gb},
          "store_release_s": release_s, "host_spare_gb": RESTART_HOST_SPARE_GB,
          "launcher": launcher, "ok": True})


def deepseek_v2_lite_restart(seed: int, smi: str) -> None:
    """Phase ``deepseek_v2_lite_restart`` (step 14 above): (a)'s plain
    step restarted from blob checkpoints by ``FaultTolerantTrainer``,
    bit for bit against the uninterrupted run; then the train launcher's
    ``--ckpt-dir`` on the card."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import TieredCheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.core.stores import FaultyStore, SimulatedS3
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    from repro_torch.runtime import FaultTolerantTrainer
    from repro_torch.shuffle import api
    from repro_torch.training import OptConfig, TrainConfig, adamw_init, make_train_step

    before_modules = set(_foreign_modules())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    check(held_gb < 0.5, f"device memory free before the restart phase: {held_gb} GB held")
    arch = "deepseek-v2-lite-16b"
    cfg = dataclasses.replace(get_config(arch), num_layers=TRAIN_LAYERS)
    n_params = cfg.param_count()
    manifest_bytes = 3 * 4 * n_params + 4   # params, m and v in f32, the int32 count
    start_gb = host_headroom(3, manifest_bytes)
    B, S = DECODER_PREFILL_BATCH, PREFILL_LEN
    opt_cfg = OptConfig(learning_rate=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
    step = make_train_step(cfg, TrainConfig(
        opt=opt_cfg, microbatches=TRAIN_MICROBATCHES, remat="full",
        shuffle=api.ShuffleConfig(mode="dense", capacity_factor=cfg.moe.capacity_factor)))
    kernels = {kn.symbol: kn for kn in (pack_kernel.PACK, unpack_kernel.UNPACK,
                                        *flash_kernel.KERNELS, *ssd_kernel.KERNELS)}
    per_step = {flash_kernel.FLASH_WGMMA.symbol: TRAIN_FLASH_LAUNCHES,
                pack_kernel.PACK.symbol: TRAIN_PACK_LAUNCHES,
                unpack_kernel.UNPACK.symbol: TRAIN_PACK_LAUNCHES}

    def fresh():
        """(a)'s parameters and batch: the same seed, the same draws."""
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = init_params(lm.LM(cfg, device="cuda"), gen)
        rows = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen, device="cuda",
                             dtype=torch.int32)
        return params, {"tokens": rows[:, :-1].contiguous(),
                        "labels": rows[:, 1:].contiguous()}

    runs = []

    def counting_step(params, opt, batch):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = step(params, opt, batch)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t1)
        return out

    def launches():
        return {s_: kn.launches for s_, kn in kernels.items()}

    # the uninterrupted run
    params, batch = fresh()
    opt = adamw_init(params)
    for kn in kernels.values():
        kn.launches = 0
    t0 = time.perf_counter()
    plain_losses = []
    for _ in range(RESTART_STEPS):
        params, opt, metrics = counting_step(params, opt, batch)
        plain_losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_step_s = list(runs)
    got = launches()
    check(got == {s_: len(runs) * per_step.get(s_, 0) for s_ in kernels},
          f"{len(runs)} uninterrupted steps: {per_step} a step and no other kernel: {got}")
    plain_digest = params_digest(params)
    del params, opt, metrics, batch
    gc.collect()
    torch.cuda.empty_cache()

    # the same steps through FaultTolerantTrainer, failing at step 3
    store = TieredCheckpointStore(FaultyStore(SimulatedS3(seed=31), seed=33,
                                              transient_p=0.05))
    params, batch = fresh()
    trainer = FaultTolerantTrainer(store, counting_step, lambda i: batch,
                                   ckpt_every=RESTART_CKPT_EVERY)
    ckpt = trainer.ckpt
    saves, restores = [], []
    real = {"save": ckpt.save, "restore": ckpt.restore, "wait": ckpt.wait}

    def timed_save(step_, tree, **kw):
        timed_wait()      # the last upload commits before the host is read
        avail = host_available_gb()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        real["save"](step_, tree, **kw)
        saves.append({"step": step_, "host_copy_s": time.perf_counter() - t1,
                      "host_available_gb_before": avail,
                      "host_available_gb_after": host_available_gb()})

    def timed_wait():
        # only a wait with an upload in flight: the save it commits
        in_flight = ckpt._thread is not None
        t1 = time.perf_counter()
        real["wait"]()
        if in_flight:
            saves[-1].update(commit_wait_s=time.perf_counter() - t1,
                             host_available_gb_committed=host_available_gb())

    ckpt.save, ckpt.wait = timed_save, timed_wait
    ckpt.restore = timed_restore(real["restore"], restores)
    runs.clear()
    for kn in kernels.values():
        kn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt, losses = trainer.run(params, adamw_init(params), steps=RESTART_STEPS,
                                      fail_at=RESTART_FAIL_AT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = launches()
    n_runs = len(runs)
    check(n_runs == RESTART_STEPS + 1,
          f"{RESTART_STEPS} steps and the replayed step 2: {n_runs} step calls")
    check(got == {s_: n_runs * per_step.get(s_, 0) for s_ in kernels},
          f"{n_runs} steps through the trainer: {per_step} a step and no other kernel: {got}")
    names = store.manifests()
    check(names == [f"step{s_:08d}.json" for s_ in (0, 2, 4)],
          f"manifests 0, 2 and 4 committed: {names}")
    sizes = manifest_sizes(store.get_manifest(name) for name in names)
    check(sizes == [manifest_bytes] * 3, f"each manifest {manifest_bytes} bytes: {sizes}")
    check([r["step"] for r in restores] == [2], f"one restore, of step 2: {restores}")
    check(losses == plain_losses,
          f"the restarted run's losses {losses} are the uninterrupted run's "
          f"{plain_losses} bit for bit")
    final_digest = params_digest(params)
    differ = sorted(n for n in plain_digest if final_digest[n] != plain_digest[n])
    check(not differ, f"the final parameters are the uninterrupted run's bit for bit: "
                      f"{len(differ)} differ, {differ[:5]}")
    train_peak = RESULTS["deepseek_v2_lite_train"]["peak_memory_gb"]
    check(peak <= train_peak + RESTART_PEAK_MARGIN_GB,
          f"peak {peak} GB within {RESTART_PEAK_MARGIN_GB} GB of (a)'s {train_peak}")
    low_gb = host_low_checked(saves, restores)
    retries, store_gb = store_readout(store)
    del trainer, ckpt, real, store, params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    end_gb, release_s = host_released(start_gb)

    # the launcher on the card: SMOKE, its checkpoints into a temporary directory
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
             "--steps", str(RESTART_STEPS), "--ckpt-every", str(RESTART_CKPT_EVERY),
             "--ckpt-dir", tmp], cwd=ROOT, capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        launcher_s = time.perf_counter() - t0
        check(out.returncode == 0, f"the train launcher: rc {out.returncode}: "
                                   f"{out.stderr[-2000:]}")
        committed = sorted(os.listdir(os.path.join(tmp, "manifests")))
    check(committed == [f"step{s_:08d}.json" for s_ in (0, 2, 4)],
          f"the launcher commits manifests 0, 2 and 4: {committed}")
    foreign = sorted(set(_foreign_modules()) - before_modules)
    check(not foreign, f"the phase loads no module of jax or the JAX package: {foreign[:5]}")
    emit({"phase": "deepseek_v2_lite_restart", "nvidia_smi": smi, "arch": arch,
          "layers": cfg.num_layers, "published_layers": get_config(arch).num_layers,
          "params": n_params, "batch": B, "seq": S, "microbatches": TRAIN_MICROBATCHES,
          "remat": "full", "compute_dtype": "bfloat16", "opt": dataclasses.asdict(opt_cfg),
          "steps": RESTART_STEPS, "ckpt_every": RESTART_CKPT_EVERY,
          "fail_at": {str(k): v for k, v in RESTART_FAIL_AT.items()},
          "store": "TieredCheckpointStore(FaultyStore(SimulatedS3(seed=31), seed=33, "
                   "transient_p=0.05)) in host memory, async uploads",
          "clocks": "every *_s: the host's clock, synchronised; host_copy_s is save's "
                    "blocking part (the device-to-host copy), commit_wait_s the wait for "
                    "its upload to commit (step 2's upload runs during step 2: "
                    "trainer_step_s), store_release_s the wait for the deleted store's "
                    "memory to come back",
          "manifests": names, "manifest_bytes": manifest_bytes, "store_gb": store_gb,
          "saves": saves, "restores": restores, "retries": retries,
          "host_available_gb": {"start": start_gb, "min": low_gb, "end": end_gb},
          "store_release_s": release_s,
          "host_spare_gb": RESTART_HOST_SPARE_GB,
          "losses": losses, "uninterrupted_losses": plain_losses,
          "losses_equal_train_phase": plain_losses
          == RESULTS["deepseek_v2_lite_train"]["losses"][:RESTART_STEPS],
          "uninterrupted_s": plain_s, "uninterrupted_step_s": plain_step_s,
          "trainer_wall_s": wall, "trainer_step_s": list(runs), "step_calls": n_runs,
          "launches_per_step": {s_: c // n_runs for s_, c in got.items() if c},
          "peak_memory_gb": peak, "train_plain_peak_gb": train_peak,
          "launcher": {"manifests": committed, "seconds": launcher_s,
                       "last_line": out.stdout.strip().splitlines()[-1]},
          "ok": True})


def deepseek_v2_lite_elastic(seed: int, smi: str) -> None:
    """Phase ``deepseek_v2_lite_elastic`` (step 15 above): the parameters
    of (a)'s 3 layers saved under ``EP_MESH``'s restore plan and restored
    under ``ELASTIC_MESH``'s into a model drawn from another seed, bit for
    bit, and a prefill of each model bit for bit the same."""
    import dataclasses
    import weakref

    from repro_torch.checkpoint import BlobCheckpointer, TieredCheckpointStore
    from repro_torch.configs import get_config
    from repro_torch.core.stores import SimulatedS3
    from repro_torch.distributed import DEFAULT_RULES
    from repro_torch.interop import params_tree
    from repro_torch.kernels.blob_codec import kernel as codec_kernel
    from repro_torch.kernels.blob_pack import kernel as pack_kernel
    from repro_torch.kernels.blob_unpack import kernel as unpack_kernel
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.launch.mesh import stacked_mesh
    from repro_torch.models import lm
    from repro_torch.models.common import init_params
    from repro_torch.runtime import elastic_restore_plan
    from repro_torch.serving import ServeConfig, make_prefill_step

    before_modules = set(_foreign_modules())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 1e9
    check(held_gb < 0.5, f"device memory free before the elastic phase: {held_gb} GB held")
    arch = "deepseek-v2-lite-16b"
    cfg = dataclasses.replace(get_config(arch), num_layers=TRAIN_LAYERS)
    n_params = cfg.param_count()
    # one params-only manifest: every parameter of deepseek-v2-lite is f32
    manifest_bytes = 4 * n_params   # the params alone, in f32
    start_gb = host_headroom(1, manifest_bytes)

    defs = lm.param_defs(cfg)
    meshes = {"ep": stacked_mesh(**EP_MESH), "elastic": stacked_mesh(**ELASTIC_MESH)}
    plans = {k: elastic_restore_plan(defs, DEFAULT_RULES, m) for k, m in meshes.items()}

    def specs(tree, prefix=""):
        if isinstance(tree, dict):
            return {p: v for k, sub in tree.items() for p, v in specs(sub, f"{prefix}/{k}").items()}
        return {prefix: tree.spec}

    plan_specs = {k: specs(plan["shardings"]) for k, plan in plans.items()}
    check(sorted(plan_specs["ep"]) == sorted(plan_specs["elastic"]),
          "both plans cover the same leaves")
    sharded = {k: sum(any(part is not None for part in sp) for sp in v.values())
               for k, v in plan_specs.items()}
    differ = {p: [str(plan_specs["ep"][p]), str(plan_specs["elastic"][p])]
              for p in sorted(plan_specs["ep"]) if plan_specs["ep"][p] != plan_specs["elastic"][p]}
    check((plans["ep"]["dp_degree"], plans["ep"]["devices"]) == (2, 32)
          and (plans["elastic"]["dp_degree"], plans["elastic"]["devices"]) == (4, 16),
          f"the plans' dp_degree and devices: {[(p['dp_degree'], p['devices']) for p in plans.values()]}")
    check(bool(differ), "the two meshes' plans differ on some leaf")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def draw(seed_):
        gen = torch.Generator(device="cuda").manual_seed(seed_)
        return init_params(lm.LM(cfg, device="cuda"), gen)

    saved = draw(seed)
    check(sum(p.numel() for p in saved.parameters()) == n_params, f"{n_params} parameters")
    saved_digest = params_digest(saved)
    restored = draw(seed + 1)
    drawn_differ = sum(d != saved_digest[n] for n, d in params_digest(restored).items())

    store = TieredCheckpointStore(SimulatedS3(seed=41))
    ckpt = BlobCheckpointer(store, async_upload=False)
    first_put, saves, restores = [], [], []
    real_put = store.put

    def marking_put(blob_id, data):
        # a synchronous save copies every leaf to the host, then uploads
        if not first_put:
            first_put.extend([time.perf_counter(), host_available_gb()])
        real_put(blob_id, data)

    store.put = marking_put
    avail = host_available_gb()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ckpt.save(1, params_tree(saved))
    t2 = time.perf_counter()
    saves.append({"host_copy_s": first_put[0] - t1, "upload_s": t2 - first_put[0],
                  "s": t2 - t1, "host_available_gb_before": avail,
                  "host_available_gb_copied": first_put[1],
                  "host_available_gb_after": host_available_gb()})
    sizes = manifest_sizes([ckpt.manifest(1)])
    check(sizes == [manifest_bytes], f"the manifest holds {manifest_bytes} bytes: {sizes}")
    like = params_tree(restored)
    out = timed_restore(ckpt.restore, restores)(1, like,
                                                shardings=plans["elastic"]["shardings"])
    check(out.keys() == like.keys(), "restore returns like's structure")
    restored_digest = params_digest(restored)
    wrong = sorted(n for n in saved_digest if restored_digest[n] != saved_digest[n])
    check(not wrong, f"every restored parameter's sha256 is the saved one's: "
                     f"{len(wrong)} differ, {wrong[:5]}")
    low_gb = host_low_checked(saves, restores)
    store_gb = sum(len(o.data) for o in store.store.objects.values()) / 1e9
    store_alive = weakref.ref(store.store)
    del ckpt, store, real_put, marking_put, out, like
    gc.collect()
    check(store_alive() is None, "nothing holds the deleted store")

    # one prefill of each model: the restored one's logits are the saved one's
    kernels = (pack_kernel.PACK, unpack_kernel.UNPACK, codec_kernel.COMPRESS_PACK,
               codec_kernel.UNPACK_DECOMPRESS, *flash_kernel.KERNELS, *ssd_kernel.KERNELS)
    per_prefill = {kn.symbol: 0 for kn in kernels}
    per_prefill.update({flash_kernel.FLASH_WGMMA.symbol: cfg.num_layers,
                        pack_kernel.PACK.symbol: cfg.num_layers - cfg.moe.first_dense_layers,
                        unpack_kernel.UNPACK.symbol: cfg.num_layers - cfg.moe.first_dense_layers})
    B, S = DECODER_PREFILL_BATCH, PREFILL_LEN
    batch = prefill_batch(cfg, torch.Generator(device="cuda").manual_seed(seed + 2), B, S)
    prefill = make_prefill_step(cfg, ServeConfig())
    logits, launches, prefill_s = {}, {}, {}
    for name, model in (("saved", saved), ("restored", restored)):
        torch.cuda.synchronize()
        for kn in kernels:
            kn.launches = 0
        t1 = time.perf_counter()
        logits[name] = prefill(model, batch)
        torch.cuda.synchronize()
        prefill_s[name] = time.perf_counter() - t1
        launches[name] = {kn.symbol: kn.launches for kn in kernels}
        check(launches[name] == per_prefill,
              f"the {name} model's prefill launches {per_prefill}: {launches[name]}")
    # the path's peak (draws, save, restore, both prefills), before the
    # checks' temporaries over the two logits
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(bool(torch.isfinite(logits["saved"]).all()), "finite logits")
    check(same_bits(logits["restored"], logits["saved"]),
          "the restored model's prefill logits are the saved model's bit for bit")
    logits_shape = list(logits["saved"].shape)
    checks_peak = torch.cuda.max_memory_allocated() / 1e9
    del saved, restored, logits, batch
    gc.collect()
    torch.cuda.empty_cache()
    end_gb, release_s = host_released(start_gb)
    foreign = sorted(set(_foreign_modules()) - before_modules)
    check(not foreign, f"the phase loads no module of jax or the JAX package: {foreign[:5]}")
    emit({"phase": "deepseek_v2_lite_elastic", "nvidia_smi": smi, "arch": arch,
          "layers": cfg.num_layers, "published_layers": get_config(arch).num_layers,
          "params": n_params, "manifest_bytes": manifest_bytes, "store_gb": store_gb,
          "store": "TieredCheckpointStore(SimulatedS3(seed=41)) in host memory, "
                   "synchronous uploads",
          "plans": {k: {"mesh": meshes[k].shape, "dp_degree": plan["dp_degree"],
                        "devices": plan["devices"], "leaves": len(plan_specs[k]),
                        "sharded_leaves": sharded[k]} for k, plan in plans.items()},
          "leaves_whose_spec_differs": differ,
          "params_differing_before_restore": drawn_differ,
          "params_equal_after_restore": len(saved_digest) - len(wrong),
          "clocks": "every *_s: the host's clock, synchronised; host_copy_s is the save's "
                    "device-to-host copy, upload_s its upload into the store",
          "save": saves[0], "restore": restores[0],
          "host_available_gb": {"start": start_gb, "min": low_gb, "end": end_gb},
          "store_release_s": release_s, "host_spare_gb": RESTART_HOST_SPARE_GB,
          "prefill": {"batch": B, "seq": S, "logits_shape": logits_shape,
                      "logits_bit_equal": True, "seconds": prefill_s,
                      "launches": {k: {s_: c for s_, c in v.items() if c}
                                   for k, v in launches.items()}},
          "peak_memory_gb": peak, "peak_with_checks_gb": checks_peak, "ok": True})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.blob_pack.kernel import ROWS_PER_BLOCK

    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind, "count": count,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libraries = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "flags": list(_build.NVCC_FLAGS),
          "libraries": [str(p.relative_to(ROOT)) for p in libraries.values()]})

    engine(args.seed, smi)
    gpipe(args.seed, smi)
    dryrun_plan(smi)
    kernel_phases(args.seed, (ROWS_PER_BLOCK, 128))
    rows = deployment(args.seed)
    torch.cuda.empty_cache()     # the deployment's tensors went with it
    wide_rows = model_kernel_phases(args.seed)
    offset_rows = flash_q_offset(args.seed)
    rows += zamba2(args.seed) + wide_rows + offset_rows
    # each phase frees its tensors when it returns
    rows += decoder_serve(args.seed, "qwen2-moe-a2.7b", "qwen2_moe_serve",
                          "flash_attention_moe")
    rows += decoder_serve(args.seed, "deepseek-v2-lite-16b", "deepseek_v2_lite_serve",
                          "flash_attention_mla")
    rows += deepseek_v2_lite_ep(args.seed)
    rows += decoder_serve(args.seed, "gemma-2b", "gemma_2b_serve", "flash_attention_gemma")
    for arch, phase, row, layers in NEW_SERVE_PHASES:
        rows += decoder_serve(args.seed, arch, phase, row, layers)
    rows += kernel_grads(args.seed)
    rows += deepseek_v2_lite_train(args.seed, smi)
    deepseek_v2_lite_shuffle_fed(args.seed, smi)
    shuffle_fed_process_group(args.seed, smi)
    deepseek_v2_lite_shuffle_resume(args.seed, smi)
    deepseek_v2_lite_restart(args.seed, smi)
    deepseek_v2_lite_elastic(args.seed, smi)
    emit({"phase": "script", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    torch.cuda.synchronize()
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
