"""Drive the PyTorch/CUDA port (fast3dhpe_tpu_torch) on one GPU, and with
--slice10 and --slice12 across four.

    python3 chip_smoke.py             # everything below but 15, 18, one card
    python3 chip_smoke.py --kernels   # steps 1, 2 and the kernel timings
    python3 chip_smoke.py --slice6    # steps 1-3, 5, 8a and 11
    python3 chip_smoke.py --slice7    # steps 1-3 and 12
    python3 chip_smoke.py --slice8    # steps 1-3 and 13
    python3 chip_smoke.py --slice9    # steps 1-3 and 14
    python3 chip_smoke.py --slice10   # steps 1-3 and 15, four cards
    python3 chip_smoke.py --slice11   # steps 1-3 and 16
    python3 chip_smoke.py --phase17   # steps 1, 2 and 17
    python3 chip_smoke.py --slice12   # steps 1, 2, the kernel timings, 18
                                      # and 19, four cards
    python3 chip_smoke.py --train-bn  # steps 1 and 20

1. Prints the card's name and power limit, builds the kernels
   (csrc/softargmax.cu, csrc/fused_bottleneck.cu and csrc/batchnorm.cu,
   one nvcc each, in parallel), timing the build.
2. Kernel phase (every run; --train-bn runs the train BN check alone): the
   train BN kernels as in step 20's check; holds each kernel (K1
   soft-argmax forward, K2 its backward, K3 fused bottleneck) against its
   plain PyTorch version on the card, at the shapes the main paths give it and
   at batch 32 pairs; K1 and K2 also at batch 1 pair, on a ragged plane,
   with one chunk's logits 120 above the rest, and (K1) at J = 2, and
   shows that their wrappers refuse strided or misaligned logits; K3 also
   at batch 1 pair, at layer1.1, on a plane that is not a multiple of its
   tile, and at P = 128 with a downsample, so that every variant of its
   launch plan runs (8x16 and 8x8 tiles, P = 64 and 128, with and without
   a downsample); each K3 launch's plan is held against the kernel's own,
   and its SASS must hold wgmma (HGMMA) and TMA loads (UTMALDG) and no
   mma.sync (HMMA) or cp.async (LDGSTS). K1 and K2
   also at a 1-pair heatmap's rows under M = 2 and M = 4 ((2, 32, 64, 19),
   (2, 16, 64, 19)) and at the whole 192 px heatmap ((2, 48, 48, 19),
   (8, 48, 48, 19)), K3 on every haloed tile phase 13 gives it (layer1.0
   at 33, 17 and 18 rows x 64, layer2.x at 17, 9 and 10 x 32; layer1.0
   and layer1.1 at 13 and 14 rows x 48 and the whole 48 x 48 plane);
   for phase 15 also K1 on (8, 16, 64, 19) (4 pairs at M = 4) and K1 and
   K2 on a data-parallel rank's 16 and 8 pairs ((32, 64, 64, 19),
   (16, 64, 64, 19)). Phase 16 launches K1 and K2 inside CUDA graphs at
   the training path's 32 pairs only ((64, 64, 64, 19), fp32 and bf16),
   which the 64-image cases check (s16_shapes_checked); phases 17 and 18
   inside graphs that also hold NCCL's kernels, at a rank's 32, 16 and 8
   pairs ((64|32|16, 64, 64, 19); s18_shapes_checked).
3. Serving path: three requests of four uint8 stereo pairs through
   `CDRNetInferencer.predict_batch` at the width of configs/mads_3d.yaml
   (CDRNet-101, 256 px, 19 joints), bf16 with fused_inference=True, from
   seeded random weights. Checks shapes, finite values, that each request
   launched K1 once, K2 never and K3 once per fused block, and one request
   against the same module on the CPU.
4. Times each kernel beside its bound, its plain version and its library
   comparison: `device_ms`, the kernel's own duration under torch.profiler
   with L2 cold (a 128 MiB read between launches; `ms` in the kernels
   line) and warm, and `call_ms`, CUDA events around one wrapper call
   (host plus device). K1 at 2 and 64 images bf16 and 64 fp32, K2 at 64
   images fp32 and bf16, K3 at 64 images and at batch 1 pair, each
   summed to one forward, and at layer1.1, which the gate leaves
   unfused, with its TFLOP/s, share of the bound and weight bytes read
   from L2 a launch (it
   fails if a K3 call is not faster than the unfused cuDNN block's at the
   main path's shapes),
   predict_batch at batch 1-64 with its geometry graphed and eager (their
   answers bit-equal), the geometry's graph counts and its eager share,
   and splits a
   request's device time by kernel group (torch.profiler).
5. Training path: four CDR train steps (two warmup, two with the 3D loss)
   of CDRNet-101 at full width, fp32, on a synthetic batch of 32 pairs with
   4 padded rows. Checks finite metrics, the loss arithmetic, that the
   parameters and BN statistics moved, that three BN sites updated their
   running statistics from the valid rows with the biased variance, and
   that each step launched K1 and K2 once, K3 never and the train BN
   kernels 3 times a BN layer each way (112 layers) with no relayout of
   dy. Times the step and splits one step's device time by kernel group,
   the train BN kernels one group.
6. Input pipeline: builds a DeviceFrameCache of 1024 seeded 768x1024
   uint8 frames (2.4 GB) on the card, and one at half the budget that
   must keep an even partial prefix; checks the pipeline's output there
   (occluded pixels gray 128, the rest the eval output, target weights
   recomputed from the keep-masks, Cutout's gate share and holes over 512
   samples, Hide-and-Seek's 6 of 16 cells, an eval batch against the
   CPU); trains CDRNet-101 through make_train_epoch_cdr from the cache
   with CUTOUT (a warmup and a use_3d epoch of 3 steps: one K1 and one K2
   launch a step, no K3, finite sums, the loss arithmetic, the parameters
   moved); times the pipeline alone and a pipeline-fed step beside the
   precomputed-batch step.
7. Raw-frame serving: three requests of four raw pairs from the cache
   through predict_batch(..., trans=...) (1 K1 + 0 K2 + 4 K3 launches a
   request), one against the CPU, and raw against pre-warped requests
   timed at batch 1 and 32.
8. Host data, from JPEGs on disk in a temporary directory:
   a. writes a MADS tree at MADS's frame size (768x1024; train 2 movements
      x 45 frames, valid 1 x 40, a NaN joint every 7th frame) and an MPII
      tree with data/synthetic.py; names the JPEG decoder in use, times
      its decode rate over the 260 MADS frames with 1 and 4 threads, and
      holds one decoded frame of each view against its rendered source;
   b. trains CDRNet-101 (configs/mads_3d.yaml, fp32, CUTOUT) through
      load_data -> Stereo3DLoader.stacked_epoch -> make_train_epoch_cdr
      with the tree whole on the card (a warmup and a use_3d epoch of 3
      steps): shapes, row_valid, cache rows against the decoded frames,
      the loss arithmetic, one K1 and one K2 launch a step, no K3;
   c. then with half the tree on the card (partial cache): two epochs of
      Stereo3DLoader iteration through make_train_step_cdr, fixed lanes,
      every record once an epoch, stacked_epoch refused; the step beside
      b's, with the upload lane's bytes and host decode ms a step;
   d. PoseResNet-101 from Mono2DLoader: two MPII steps from host batches
      padded to multiples of 128 and warped on the card, and a stacked
      MADS_2d epoch from the cache (finite losses, no kernel launched);
   e. evaluate_movement of valid/HipHop by the serving phase's bf16
      inferencer with the movement whole on the card, half on it, a
      batch-aligned part on it, and streamed: one K1 and four K3 launches
      a batch, MPJPE2D within 1e-3 relative in all four and MPJPE3D in the
      three whose batches hold the same frames, frames/s of each; the
      same frames' predictions at other rows of a batch; one batch's
      first rows against the CPU.
9. Card vs CPU: one train step with and one without the 3D loss at 2
   pairs (one padded), full width, from the same weights and batch on the
   card and on the CPU: losses, grad_norm, every gradient and the BN
   statistics, beside how far rounding-sized noise moves them on the CPU.
10. The CLI apps at full width, on the trees of step 8 (an app is
    called through its `main(argv)`, with the kernels' counts set to 0
    just before and read just after):
   a. `train` (configs/mads_2d.yaml: PoseResNet-101, fp32), 2 epochs of
      loader iteration: finite history, latest.pth loads strict, no kernel
      launched;
   b. `train_cdr` (configs/mads_3d.yaml: CDRNet-101, fp32, CUTOUT) from
      a's latest.pth, 3 epochs with WARMUP 1 and the LR / 10 from epoch 4,
      stacked from the card: before the first step the encoder is a's bit
      for bit and the rest a fresh seeded init; latest.pth, latest.opt.pt
      and best.pth (of the last epoch, the only one after the warmup);
      one K1 a train step and an eval batch, one K2 a train step, no K3;
   c. the same command without --overwrite raises FileExistsError and
      leaves the files byte for byte;
   d. the optimizer state a resume loads equals the saved one; then
      `python -m fast3dhpe_tpu_torch.apps.train_cdr --resume` as a
      subprocess with EPOCH 4: exit 0, one epoch, Adam's step and the
      train step continue from the saved step at LR / 10, best.pth
      rewritten only if MPJPE3D improved;
   e. `inference --bf16 --fused_inference --movement all`: one K1 and four
      K3 a batch, no K2; the printed MPJPEs against evaluate_movement on
      the same weights; with --save_frames 3 its GIF and test.jpg decode,
      or, where matplotlib is missing, render_frames raises an ImportError
      that names it and the cv2 2D overlays are drawn, written and
      decoded instead (a line says so);
   f. `baseline` on a's weights: finite MPJPE, no kernel; one batch
      against the CPU (pred_2d equal but at near-ties of a heatmap's
      maximum, pred_3d within 1e-3 where pred_2d agrees);
   g. dlt_triangulate by jacobi, svd and sii and triangulate_closed_form
      on 32 x 19 systems, against the CPU: launches, device and host ms;
   h. prints each epoch's wall time, checkpoint bytes and save ms
      (synchronous and asynchronous), the resume load ms and the apps'
      frames/s beside the card's name and power limit.
11. Slice 6, CDRNet-101 at 256 px on the serving phase's weights (a
    train step's calibrated head for b-e), each path with the kernels'
    counts set to 0 just before and read just after:
   a. int8 serving: CDRNetInferencer(int8=True) calibrates a pack on 8
      batches of 16 seeded pairs and writes it; 3 requests of 32 pairs
      (1 K1, 0 K2, 0 K3 each); 2 pairs of one against the CPU's int8 path
      on the same pack: every int8 code before cf_out bit-equal, cf_out's
      (after the bf16 trunk) flipped in at most CF_FLIPS by one code, the
      decoder on the CPU's cf_out codes bit-equal, heatmaps, pred_2d and
      pred_3d within the serving phase's bounds; the request against the
      bf16 fused one (heatmap correlation > 0.99, max error < 0.12 of the
      max); both timed (wall, device busy by kernel group, peak memory);
   b. `inference --bf16 --fused_inference`, `inference --int8 --int8_pack`
      (calibrating on the tree, writing the pack) and the same from the
      pack with no fp checkpoint, on valid/HipHop: MPJPEs side by side,
      the pack's run equal to the calibrating one, launches;
   c. exports fp32 and int8 at batch 32 (torch.export), saves them, loads
      each in a new process that imports only fast3dhpe_tpu_torch.export,
      and holds its call against predict_batch on the same frames (rtol
      1e-4, atol 1e-3): one K1 launch inside each loaded call; a float
      frame raises TypeError and a wrong batch ValueError; export seconds,
      artifact bytes;
   d. bf16 training: the train-mode BN layer on a bf16 input against the
      CPU; the step at 32 pairs (4 padded, converging_rig) against the
      card's fp32 step from the same weights (losses, encoder.bn1's
      output; see BF16_LOSS_TOL), and at 2 pairs against the CPU's bf16
      step; its time, device busy, peak memory, 1 K1 + 1 K2 a step and
      K2's dtype; one `train_cdr --bf16` epoch on the tree;
   e. remat: fp32 steps with remat None and "convs" against the plain
      step (cuDNN deterministic): loss, gradients and BN statistics equal;
      peak memory and step ms of all three at 32 and 96 pairs.
12. Slice 7, data parallelism of the CDRNet-101 train step (256 px, 19
    joints, fp32, TF32 off), the kernels' counts set to 0 just before each
    path and read just after:
   a. NCCL at world size 1 in this process (MASTER_ADDR/MASTER_PORT set,
      init_distributed, make_mesh): the step at 32 pairs (4 padded,
      converging_rig) through replicate(mesh, model) against the plain
      step from the same weights, with cuDNN deterministic: loss, every
      gradient, the parameters after the Adam update and every BN running
      statistic equal bit for bit (the all-reduces over one rank are
      identities); the collectives a step by kind (the row counts, a
      forward and a backward one a BN, the gradient, the metrics), 1 K1
      + 1 K2 + 0 K3; then the two steps in turns (ms), a step's peak
      memory above what was allocated, and one step of each under
      torch.profiler (device busy, the NCCL kernels' time);
   b. two gloo ranks sharing cuda:0: this script starts itself twice
      (init_distributed(backend="gloo", device="cuda:0"), loop_cdr.run
      with make_mesh()), at 16 pairs a rank, against loop_cdr.run in this
      process at 32, 2 epochs (WARMUP 1) on a MADS tree of 32 pairs a
      split (768x1024 JPEGs), augmentation off, so that an epoch is one
      step and the global batches hold the same pairs. Each rank runs
      the loop three times: one epoch to warm up; then as users run it,
      into one weights root that the ranks share, without overwrite (the
      CLI's default): the ranks' histories equal but the throughput, and
      within tests/test_distributed_real.py's tolerances of the
      1-process run (S7_*); one checkpoint set; per rank 2 K1 + 1 K2 an
      epoch (a train step and an eval batch); the train step's ms. Then
      one epoch into a root of each rank's own, every all_reduce timed
      between two synchronisations: the gloo ms a step, the gradient's
      and the BN's apart, the step's ms under that timing, and rank 1's
      root empty.
      Beside them, two NCCL ranks on the one card, a probe of the
      machine whose failure is printed and is no failure of the phase.
13. Slice 8, spatial partitioning: CDRNet-101 at 256 px (phase 3's
    weights) split over the image height by gloo ranks sharing cuda:0
    (`--s8-child`), against one unsplit forward in this process:
   a. M = 2 (world 2): fp32 (TF32 off) and bf16 fused_inference at 1 and
      4 pairs; the int8 forward at 2 pairs from a pack that this process
      calibrates (8 batches of 16 seeded pairs, as phase 11) and saves
      with save_pack; make_eval_step_cdr on 4 pairs (one padded). Model
      ranks' pred_2d and pred_3d bit-equal; fp32 keypoints within
      S8_FP32_KP_PX, heatmap rows within S8_FP32_HM of max|heatmap| and
      pred_3d within EXPORT_ATOL of the DLT of the rank's own pred_2d
      (s8_check; against the unsplit pred_3d reported); bf16 within
      S8_BF16_*; int8's encoder codes bit-equal, cf_out's codes bit-equal
      to the unsplit CanonicalFusion on each rank's rows and within one
      code of the unsplit forward's, the split decoder on the unsplit
      cf_out codes bit-equal, keypoints and heatmaps within phase 11's
      card-vs-CPU bounds; the eval metrics those of the unsplit step.
      Every K1 input and K3 tile of the phase is one that step 2 checks
      (s8_shapes_checked). Each forward: 38 halo exchanges and one
      keypoint combine, K1 once a rank, K3 once a block that the global
      gate fuses (on a haloed tile); the unsplit forwards none.
   b. M = 4 (world 4): fp32 and bf16 at 1 pair, with interior ranks.
   Each rank's forward at 1 pair timed (wall ms), and in a run of its
   own every all_reduce timed between synchronisations (the halos' ms a
   forward), beside the unsplit forward's wall ms.
   c. In b's ranks, CDRNet-101 at 192 px over M = 4 (48 rows a rank),
      whose split gathers before layer4.0 (parallel/spatial.py
      gather_point): fp32, bf16 fused and int8 (a's pack) at 1 pair
      against the unsplit forwards at 192 px, fp32 and bf16 within a's
      bounds on the whole heatmaps, int8's codes before the gather
      bit-equal row by row; each forward 32 halos, one gather and no
      keypoint combine, K1 once and (bf16) K3 three times (layer1.0-1.2,
      on 13- and 14-row tiles); wall ms at 1 pair each way.
14. Slice 9, the loops on a (data, model) mesh: this script starts itself
    twice (`--s9-child`, gloo on cuda:0, cuDNN deterministic, TF32 off)
    to run loop_cdr.run for CDRNet-101 at 256 px on a 1 x 2 mesh
    (make_mesh(model_parallel=2): one data shard, two model ranks that
    train the whole images) on phase 12's tree, whole in the device frame
    cache, 32 pairs a step, 3 epochs (WARMUP 1) with checkpoints into one
    shared weights root; then loop_cdr.run in this process at M = 1 on
    the same tree. The model ranks' histories, final weights and best.pth
    (against rank 1's best snapshot) bit-equal; the ranks within phase
    12's bounds of the one process; 2 K1 + 1 K2 an epoch a rank; no halo,
    gather or keypoint exchange; best.pth, latest.pth and latest.opt.pt
    written once; the epochs' seconds and peak memory a rank beside the
    one process's.
15. Slice 10, the process group across cards (`--slice10` only: it
    needs four cards and exits non-zero, naming them, on a host with
    fewer; it prints all four `nvidia-smi` lines). The script starts
    itself as ranks (`--s10-child`), one NCCL rank a card, rank r on
    cuda:r, with a collective timeout of S10_COLL_TIMEOUT: first a world
    of 4, then a world of 2 on cards 0-1; every rank waits until this
    process has run the references on cuda:0 and written `go`, and at
    the first rank that fails, or at S10_LAUNCH_TIMEOUT, this process
    kills them all. The spatial exchanges take the neighbour form
    (parallel/mesh.py: NCCL's point-to-point halos, all_gather for the
    gather and the keypoints):
   a. CDRNet-101 at 256 px (phase 3's weights) split over M = 4 (cards
      0-3) and M = 2 (cards 0-1): fp32 (TF32 off) and bf16 fused at 1 and
      4 pairs, int8 from a pack calibrated here at 1 and 4 pairs, the
      eval step on 4 pairs (one padded), and at M = 4 the 192 px
      forwards, which gather before layer4.0; each held against an
      unsplit forward of the same weights on cuda:0 under phase 13's
      limits (s8_check, s8_check_int8, s8_check_eval,
      s8_check_gathered): 38 halos + 1 keypoint combine a forward at 256
      px, 32 halos + 1 gather at 192 px, on every rank. Every halo of
      every checked forward sends exactly its edge rows' bytes (the last
      `top` rows down, the first `bottom` rows up; at an interior rank
      top + bottom rows, 1/M of the slot form's M slots), printed a
      forward in both forms. A rank's 1-pair forward timed (wall ms,
      host clock between synchronisations), profiled (device busy
      outside NCCL, the NCCL kernels' device ms, which hold the wait for
      the peers), again in the slot form over the same cards, and the
      forward's halos alone in both forms, beside the unsplit forward.
   b. Data parallelism over NCCL at world 4 and 2 (8 and 16 pairs a
      rank of a 32-pair global batch): one CDR train step from the same
      start weights against the same step of the whole batch on cuda:0
      (loss within S7_WARMUP_RTOL, grad_norm and the BN statistics within
      S7_2D_RTOL; 224 BN, 1 gradient, 1 row-count and 1 metrics
      all_reduce; 1 K1 + 1 K2), its warm step ms, the NCCL kernels'
      device ms and the peak memory a rank beside one card's; then
      loop_cdr.run (phase 12's 32-pair tree, 2 epochs, into one shared
      weights root) within S7_* of one process, the histories equal on
      every rank, one checkpoint set. Then `python -m
      torch.distributed.run --standalone --nproc_per_node 4 -m
      fast3dhpe_tpu_torch.apps.train_cdr` (torchrun) for one epoch, each
      rank importing an audit hook (S10_AUDIT): exit 0, one checkpoint
      set, every write under the weights root rank 0's.
   c. A 2 x 2 (data, model) mesh over the four cards: split serving,
      each data group its own pair (fp32, bf16, int8 at 1 pair) against
      the unsplit forward as in a; and loop_cdr.run as phase 14 runs it
      (whole images, the model replicated over the model axis): the two
      model ranks of each data index bit-equal (their final weights'
      digest), the history against world 2's (reported) and within S7_*
      of one process.
   Every K1, K2 and K3 shape of the phase is one that step 2 checks
   (s10_shapes_checked).
16. Slice 11, one-dispatch training: CDRNet-101 at 256 px (configs/
    mads_3d.yaml: 19 joints, CUTOUT, 32 pairs a step) on phase 12's
    tree, whole in the device frame cache, cuDNN deterministic, TF32
    off; each train and eval step of a stacked epoch replays a CUDA graph
    of the whole step (train/graphs.py):
   a. the occlusion masks of 6 replays of the train pipeline bit-equal to
      step_generator's; one fp32 train epoch of 6 stacked steps (use_3d,
      the last 4 rows of each padded) graphed against the same epoch run
      eagerly from the same weights with the same capturable Adam: the
      per-step metrics, the weights, the BN statistics and Adam's state
      bit-equal (or, d, within phase 12's S7_* bounds, the gaps printed),
      1 K1 + 1 K2 a step and 3 train BN launches a BN layer each way (no
      relayout of dy) counted through the replays; then one bf16 epoch
      held the same way. Each way: a warm epoch's wall ms a step, the
      device-busy ms a step and the idle share (torch.profiler), host
      launches a step (the CUDA calls that put work on the device),
      capture seconds, reserved memory and peak;
   b. make_segment_cdr over E_full = 4 epochs (3 valid, 1 padding) of 2
      steps, WARMUP 1, the LR / 10 from epoch 3, against the same 3
      epochs on the epoch path with the best chosen on the host: the
      per-epoch metrics, `improved`, the best error, the best state and
      the final state bit-equal, the padding epoch's metrics 0 and the LR
      read back from the optimizer the schedule's;
   c. loop_cdr.run by segments (checkpoint_every 2, 3 epochs) against
      segments=False: histories bit-equal, latest.pth written only on the
      grid (after epochs 2 and 3) and best.pth only there; the occlusion
      epoch seeds seed * 10007 + epoch, after --resume too (the epoch
      path's restart at the loader's 0); 2 K1 + 1 K2 an epoch; loop2d.run
      for PoseResNet-101 (configs/mads_2d.yaml) by segments against
      segments=False, 2 epochs, bit-equal;
   and prints measure_scan_floor (a replayed trivial graph) beside the
   host's time a trivial eager launch.
17. Slice 12 on one card, the stacked epochs and segments under a mesh
    (phase 12's tree whole in the device cache, cuDNN deterministic, TF32
    off):
   a. NCCL at world size 1 in this process: phase 16 a's fp32 epoch (6
      steps of 32 pairs, CUTOUT, use_3d) under make_mesh(), each step a
      replay of a graph that holds its collectives, against the same
      epoch eager under the mesh and the graphed epoch without a mesh:
      per-step metrics, weights, BN statistics and Adam's state bit-equal;
      the collectives a step by kind (rows, a forward and a backward one
      a BN, gradient, metrics) counted through the replays, one capture
      check, fewer than 10 host launches a step, a's kernel launches;
      each way's wall, busy,
      NCCL ms, idle share, host launches, capture s and memory; a step
      whose capture fails raises GraphCaptureError naming the rank;
   b. two gloo ranks sharing cuda:0 (`--s17-child`), loop_cdr.run at 16
      pairs a rank with each rank's shard whole in its cache, augmentation
      off, 2 epochs: by segments (logged, the steps eager as gloo decides)
      against the same ranks' per-batch path (bit-equal, or within S7_*)
      and against one process at 32 pairs by segments (S7_*); the ranks'
      histories equal, rank 0's checkpoints only, 2 K1 + 1 K2 an epoch.
18. Slice 12 across cards (`--slice12` only; four cards, or it exits
    non-zero naming the host's): one NCCL rank a card (`--s10-child`
    launches), world 4 and then world 2 on cards 0-1, 32 pairs global;
    this process builds the global stacked epoch (6 steps, 4 rows of each
    padded) and runs one card's references on cuda:0 first:
   a. every rank's shard_stacked block of that epoch, the frames whole on
      its card: the CUTOUT epoch graphed against eager (bit-equal, or
      within S7_* with the gaps printed), the collectives a step by kind
      through the replays, fewer than 10 host launches a step, 16 a's
      kernel launches; then a
      graphed epoch without occlusion or the 3D loss against one card's
      on the whole batch (step 0 within S7_WARMUP_RTOL / S7_2D_RTOL, the
      later losses within S7_POST_RTOL); beside one card's graphed step,
      each rank's graphed and eager: wall, busy, NCCL ms, idle share, host
      launches, capture s, reserved and peak memory;
   b. a segment of E_full 4 (3 valid) of 2 steps on each rank's own
      loaders against its 3 epochs, bit for bit (s16_segment);
   c. loop_cdr.run (CUTOUT, 2 epochs) by segments, by stacked epochs and
      batch by batch into shared weights roots: histories equal on every
      rank, segments bit-equal to stacked epochs and to the per-batch
      path (or within S7_*), the segment path logged with its graphs, one
      checkpoint set a root, 2 K1 + 1 K2 an epoch a rank;
   d. at world 4, loop_cdr.run by segments on a 2 x 2 mesh: the model
      ranks' final weights bit-equal, histories equal;
   e. torchrun's train_cdr over 4 ranks for one epoch by segments (the
      S10_AUDIT hook: one checkpoint set, every write rank 0's; the
      logged path).
19. Prints a {"kernels": [...]} line and, last, {"ok": true, ...} (the
    default run and --slice12).
20. Train-mode BatchNorm (`--train-bn`; csrc/batchnorm.cu, which step 1
    builds too; the check runs in every run): the kernels against the
    plain version
    (ops/batchnorm.py) at CDRNet-101's stem, layer3, layer4 and
    CanonicalFusion shapes at 32 pairs, C = 19 and 300, and the V2V's
    first and deepest levels, fp32 and bf16, with padded rows, without a
    mask and (stem, V2V) with every row filler; each twice, bit-equal.
    Times the stem, layer3, fusion and V2V shapes in fp32 (check_train_bn,
    time_train_bn: device ms by kernel L2 cold and warm, the 8- and
    5-pass bounds, the plain version, F.batch_norm as the yardstick), and
    profiles one main-path CDRNet-101 train step at 32 pairs
    (train_bn_step): 3 launches a layer each way, no relayout of dy, no
    other BatchNorm kernel, the train_bn_ kernels' device ms beside all
    kernels'. Prints {"train_bn": ...}.

It needs one CUDA device, and four for --slice10 and --slice12. Without
one, or when any phase fails, it exits non-zero and prints no result.
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, fp32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

SEED = 0
REQUESTS, PAIRS = 3, 4            # the serving path: 3 requests of 4 pairs
TIMING_PAIRS = 32                 # kernel timings at batch 32 pairs
TRAIN_PAIRS, TRAIN_PAD = 32, 4    # the training path: TRAIN.BATCH_SIZE pairs
TRAIN_MODES = (False, False, True, True)   # use_3d of the checked steps
TIMED_STEPS = 4                   # further use_3d steps, timed only


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def call_ms(fn, iters=20, warmup=3):
    """Median time of one fn() call in ms, by CUDA events recorded around
    it: host plus device. The host's share of the call (checks, allocation,
    the launch itself) lies between the two events, so for a kernel shorter
    than its launch this measures the host."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


L2_FLUSH_BYTES = 128 * 2 ** 20     # read between launches: > the 50 MB L2
PROFILE_TRIES = 3


def device_ms(fn, kernel, cold, iters=30, warmup=3):
    """Median device duration in ms of the CUDA kernels whose name contains
    `kernel`, one a call of fn(), under torch.profiler (CUPTI). cold: a
    128 MiB buffer is read before each call, so the kernel finds its
    inputs in HBM and not in the 50 MB L2, and the L2 holds no dirty lines
    whose write-back would bill the kernel (the number held against the
    HBM bound); warm: the calls run back to back. The profile sometimes
    holds fewer kernel records than calls (25 of 30 in one H100 run), so
    the median is taken over those it holds. Once it held 3 of 30, so a
    profile that holds fewer than half the calls is taken again, up to
    PROFILE_TRIES times in all, and then it fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = (torch.zeros(L2_FLUSH_BYTES // 4, device="cuda") if cold
             else None)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush.sum()
                fn()
            torch.cuda.synchronize()
        times = [(e.time_range.end - e.time_range.start) / 1e3
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        if len(times) < iters:
            print(f"# device_ms: {len(times)} records of *{kernel}* for "
                  f"{iters} calls (profile {attempt + 1})")
        if 2 * len(times) >= iters:
            return statistics.median(times)
    raise RuntimeError(f"chip_smoke: {PROFILE_TRIES} profiles each held "
                       f"fewer than half the {iters} kernels named "
                       f"*{kernel}* (the last {len(times)})")


def kernel_times(fn, kernel):
    """device_ms L2 cold and warm, and call_ms, of one kernel's wrapper."""
    return {"device_ms_cold": device_ms(fn, kernel, cold=True),
            "device_ms_warm": device_ms(fn, kernel, cold=False),
            "call_ms": call_ms(fn)}


def host_ms(fn, iters=10, warmup=2):
    """Median wall time of fn() plus a synchronize, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes, flops, peak_flops):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def rig(batch):
    """bench.py's stereo rig: f = 1100 px, principal point (128, 128),
    cameras at x = +-400 mm, 3000 mm from the origin."""
    K = np.array([[1100.0, 0.0, 128.0], [0.0, 1100.0, 128.0],
                  [0.0, 0.0, 1.0]])
    Ps = [K @ np.hstack([np.eye(3), np.array([[dx], [0.0], [3000.0]])])
          for dx in (-400.0, 400.0)]
    return np.broadcast_to(np.stack(Ps), (batch, 2, 3, 4)).astype(np.float32)


def stereo_request(rng, pairs, size=256):
    return (rng.randint(0, 256, (pairs, size, size, 3), dtype=np.uint8),
            rng.randint(0, 256, (pairs, size, size, 3), dtype=np.uint8),
            rig(pairs))


# ----------------------------------------------------------------- kernels

# K1 and K2 are checked at a request's and a train step's images, at
# batch 1 pair and on a ragged plane: (name, (N, H, W, J))
SOFTARGMAX_SHAPES = (("2 images", (2, 64, 64, 19)),
                     ("8 images", (2 * PAIRS, 64, 64, 19)),
                     ("64 images", (2 * TIMING_PAIRS, 64, 64, 19)),
                     ("ragged", (2, 36, 44, 17)),
                     # phase 13's heatmaps split over M = 2 and M = 4,
                     # K1 on a model rank's rows: 1 pair at M = 2 and 4,
                     # 4 pairs (bf16, fp32 and the eval step) and 2
                     # (int8) at M = 2 (run_slice8 checks the list)
                     ("rows of M=2", (2, 32, 64, 19)),
                     ("rows of M=2, 4 pairs", (8, 32, 64, 19)),
                     ("rows of M=2, 2 pairs", (4, 32, 64, 19)),
                     ("rows of M=4", (2, 16, 64, 19)),
                     # phase 15 a: 4 pairs (fp32, bf16, int8, the eval
                     # step) at M = 4 too; b: a data-parallel rank's whole
                     # heatmaps at 16 and 8 pairs (world 2 and 4)
                     ("rows of M=4, 4 pairs", (8, 16, 64, 19)),
                     ("16 pairs", (32, 64, 64, 19)),
                     ("8 pairs", (16, 64, 64, 19)),
                     # phase 13 c: at 192 px over M = 4 the forward gathers
                     # before layer4.0, so K1 takes the whole 48 x 48
                     # heatmap of 1 pair (and of 4 pairs, checked beside)
                     ("192 px, 1 pair", (2, 48, 48, 19)),
                     ("192 px, 4 pairs", (8, 48, 48, 19)))
# row 0, columns 0-31 of the logits (in K1's first chunk of an image) lie
# 120 above the rest, so that e^{m_c - M} of every other chunk, and of the
# first chunk's other runs, underflows to 0 in fp32 where K1 combines them
UNDERFLOW = ("chunk 120 above", (2, 64, 64, 19))


def _nhwc_logits(gen, dev, shape, dt, underflow=False):
    """Random logits in the decoder's layout: (N, J, H, W) channels_last
    viewed as (N, H, W, J)."""
    n, hh, ww, j = shape
    h = torch.randn((n, j, hh, ww), generator=gen) * 3
    if underflow:
        h[:, :, 0, :32] += 120.0
    h = h.to(dt).to(dev).contiguous(memory_format=torch.channels_last)
    return h.permute(0, 2, 3, 1)


def _softargmax_cases(gen, dev):
    for name, shape in SOFTARGMAX_SHAPES + (UNDERFLOW,):
        for dt in (torch.float32, torch.bfloat16):
            yield (f"{name} {str(dt).replace('torch.', '')}",
                   _nhwc_logits(gen, dev, shape, dt, name == UNDERFLOW[0]))


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def check_softargmax(dev, gen):
    """K1 against its plain version on the decoder's layout, fp32 and bf16,
    at SOFTARGMAX_SHAPES and the UNDERFLOW case; its statistics against
    their definition; peak recovery at J = 2; the wrappers' refusals; the
    shared-memory formula of ops/softargmax.py against the kernel's."""
    from fast3dhpe_tpu_torch.ops._build import load_library
    from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax
    from fast3dhpe_tpu_torch.ops.softargmax import (fwd_smem_bytes,
                                                    soft_argmax_bwd_fused,
                                                    soft_argmax_fused,
                                                    soft_argmax_fwd_fused)
    kernel_smem = load_library("softargmax").softargmax_fwd_smem_bytes
    kernel_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    kernel_smem.restype = ctypes.c_int
    for j in (1, 2, 17, 19, 64):
        for elt in (2, 4):
            require(kernel_smem(j, elt) == fwd_smem_bytes(j, elt),
                    f"K1 shared memory at J={j}, {elt}-byte logits: the "
                    f"kernel says {kernel_smem(j, elt)}, ops/softargmax.py "
                    f"{fwd_smem_bytes(j, elt)}")
    # tests/test_pallas_kernels.py:28 holds the Pallas kernel to 1e-3 px of
    # its jnp version; fp32 sums in another order stay well inside that
    tol_px = 1e-3
    err = 0.0
    for what, hm in _softargmax_cases(gen, dev):
        got, stats = soft_argmax_fwd_fused(hm)
        ref = soft_argmax(hm)
        flat = hm.float().flatten(1, 2)
        m = flat.amax(dim=1)
        s = (flat - m[:, None]).exp().sum(dim=1)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        e_s = ((stats[..., 1] * s - 1).abs().max().item())
        require(got.shape == ref.shape and e <= tol_px,
                f"K1 {what} differs from its plain version by {e} px "
                f"(tolerance {tol_px} px)")
        # m is the exact max; 1/S within fp32 sums' rounding; (cx, cy) the
        # output itself
        require(torch.equal(stats[..., 0], m)
                and torch.equal(stats[..., 2:], got) and e_s <= 1e-5,
                f"K1 {what} statistics: m exact "
                f"{torch.equal(stats[..., 0], m)}, (cx, cy) = output "
                f"{torch.equal(stats[..., 2:], got)}, |S/S_plain - 1| {e_s}")
        print(f"# K1 {what}: max |kernel - plain| {e:.3g} px, "
              f"|S/S_plain - 1| {e_s:.3g}")
        err = max(err, e)
    # peak recovery (tests/test_pallas_kernels.py:52-58)
    peak = torch.zeros((1, 32, 32, 2), device=dev)
    peak[0, 7, 21, 0] = 40.0
    peak[0, 30, 3, 1] = 40.0
    kp = soft_argmax_fused(peak).cpu()
    require(torch.allclose(kp, torch.tensor([[[21.0, 7.0], [3.0, 30.0]]]),
                           atol=tol_px), f"soft-argmax peak recovery: {kp}")
    # on CUDA the wrappers take only a contiguous (N, H, W, J) tensor at a
    # 16-byte aligned address, and launch nothing otherwise
    before = (soft_argmax_fused.launches, soft_argmax_bwd_fused.launches)
    strided = torch.randn((2, 19, 64, 64), device=dev).permute(0, 2, 3, 1)
    buf = torch.randn(2 * 64 * 64 * 19 + 1, device=dev)
    shifted = buf[1:].view(2, 64, 64, 19)
    g = torch.zeros((2, 19, 2), device=dev)
    for what, bad in (("(N, J, H, W) memory viewed as NHWC", strided),
                      ("a storage offset of 4 bytes", shifted)):
        require(_raises(lambda: soft_argmax_fused(bad))
                and _raises(lambda: soft_argmax_bwd_fused(bad, g)),
                f"the K1/K2 wrappers took {what}")
    require((soft_argmax_fused.launches,
             soft_argmax_bwd_fused.launches) == before,
            "a refused call launched a kernel")
    print(f"# K1 soft-argmax: max |kernel - plain| = {err:.3g} px "
          f"(tolerance {tol_px} px); peak recovered; strided and "
          f"misaligned logits refused")
    return err


# K2 against its plain version, relative to max|plain|. fp32: both compute
# in fp32 from the same logits and differ only in the order of the H*W-term
# sums for S, cx and cy (~1e-6 relative), which multiplies p * g: 1e-5 (the
# first H100 runs measured 1.8e-6). bf16: both round an fp32 value once;
# where those values straddle a rounding boundary the results differ by one
# bf16 ulp (<= 2^-7 of a value, so of max|plain|). Such elements are rare
# (under 1e-3 of them), which the mean bound of 2^-17 holds (measured
# 1e-10).
K2_FP32_MAX = 1e-5
K2_BF16_MAX, K2_BF16_MEAN = 2.0 ** -7, 2.0 ** -17


def _k2_bounds(got, ref, dt, what):
    scale = ref.abs().max().item()
    d = (got.float() - ref.float()).abs()
    dmax, dmean = d.max().item() / scale, d.mean().item() / scale
    if dt == torch.float32:
        ok = dmax <= K2_FP32_MAX
        bound = f"max {K2_FP32_MAX}"
    else:
        ok = dmax <= K2_BF16_MAX and dmean <= K2_BF16_MEAN
        bound = f"max {K2_BF16_MAX} / mean {K2_BF16_MEAN}"
    require(ok, f"{what} differs from its plain version: max {dmax:.3g}, "
                f"mean {dmean:.3g} of max|plain| (bound {bound})")
    return d.max().item(), dmax, dmean


def check_softargmax_bwd(dev, gen):
    """K2 against soft_argmax_bwd at SOFTARGMAX_SHAPES and the UNDERFLOW
    case, fp32 and bf16, three ways: standalone from K1's statistics,
    standalone without them (the wrapper runs K1 first), and the gradient
    of soft_argmax_fused by autograd (statistics saved by the Function)
    against autograd through the plain forward. Not at the J = 2 peak:
    there p*(x - cx) is rounding noise of cx, and so is max|plain|."""
    from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax, soft_argmax_bwd
    from fast3dhpe_tpu_torch.ops.softargmax import (soft_argmax_bwd_fused,
                                                    soft_argmax_fused,
                                                    soft_argmax_fwd_fused)
    err = 0.0
    for what, hm in _softargmax_cases(gen, dev):
        dt = hm.dtype
        g = torch.randn((hm.shape[0], hm.shape[3], 2), generator=gen).to(dev)
        ref = soft_argmax_bwd(hm, g)
        _, stats = soft_argmax_fwd_fused(hm)
        got = soft_argmax_bwd_fused(hm, g, stats)
        alone = soft_argmax_bwd_fused(hm, g)
        torch.cuda.synchronize()
        require(got.dtype == dt and got.stride() == hm.stride(),
                f"K2 output {got.dtype} {got.stride()}, logits {dt} "
                f"{hm.stride()}")
        require(torch.equal(alone, got),
                f"K2 {what}: the call without statistics differs from the "
                f"one with K1's")
        e, dmax, dmean = _k2_bounds(got, ref, dt, f"K2 {what}")
        a = hm.detach().clone().requires_grad_(True)
        (soft_argmax_fused(a) * g).sum().backward()
        b = hm.detach().clone().requires_grad_(True)
        (soft_argmax(b) * g).sum().backward()
        torch.cuda.synchronize()
        _, gmax, gmean = _k2_bounds(a.grad, b.grad, dt,
                                    f"autograd through K2 ({what})")
        print(f"# K2 {what}: kernel vs plain max {dmax:.3g} / mean "
              f"{dmean:.3g} of max|plain|; autograd max {gmax:.3g} / "
              f"mean {gmean:.3g}")
        err = max(err, e)
    return err


def bottleneck_case(gen, dev, n, cin, planes, downsample, hw):
    """Random bf16 block inputs with b1 > 0, so that a halo taken from
    relu(b1) instead of 0 shows at the image border. hw: H (square) or
    (H, W)."""
    cout = 4 * planes
    h, w = (hw, hw) if isinstance(hw, int) else hw

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    def pos(c, lo, hi):
        return torch.rand(c, generator=gen) * (hi - lo) + lo

    x = rnd(n, cin, h, w)
    args = [rnd(cin, planes, scale=cin ** -0.5), pos(planes, 0.5, 1.5),
            pos(planes, 0.5, 1.5),
            rnd(3, 3, planes, planes, scale=(9 * planes) ** -0.5),
            pos(planes, 0.5, 1.5), rnd(planes, scale=0.1),
            rnd(planes, cout, scale=planes ** -0.5), pos(cout, 0.5, 1.5),
            rnd(cout, scale=0.1)]
    if downsample:
        args += [rnd(cin, cout, scale=cin ** -0.5), pos(cout, 0.5, 1.5),
                 rnd(cout, scale=0.1)]
    else:
        args += [None, None, None]
    x = x.to(dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    dev_args = [None if a is None else
                a.to(dev, torch.bfloat16 if a.dim() > 1 else torch.float32)
                .contiguous() for a in args]
    return x, dev_args


BLOCK_SHAPES = {  # name -> (Cin, P, downsample, H) on the main path at 256 px
    "layer1.0": (64, 64, True, 64),
    "layer2.x": (512, 128, False, 32),
}
# measured beside them, off the main path: layer1.1, which the gate leaves
# unfused at 256 px (exactly 13 MiB by the JAX VMEM estimate), and a plane
# that is not a multiple of the 8x16 tile in either direction
LAYER11 = (256, 64, False, 64)
RAGGED = (64, 64, True, (36, 44))
# phase 13's haloed tiles: a model rank's rows and one row of each
# neighbour's (one at the global edge), at M = 2 and M = 4, checked at 1 and
# 4 pairs (S8_PAIRS: the bf16 forwards that fuse); at 192 px over M = 4
# layer1.0-1.2 fuse on 12-row blocks (13 and 14 rows with the halo), and
# the unsplit reference on the whole 48 x 48 plane
HALOED = {"layer1.0": (64, 64, True, ((33, 64), (17, 64), (18, 64),
                                      (13, 48), (14, 48), (48, 48))),
          "layer1.1": (256, 64, False, ((13, 48), (14, 48), (48, 48))),
          "layer2.x": (512, 128, False, ((17, 32), (9, 32), (10, 32)))}


# K3 with P = 128 and a downsample: no stride-1 encoder block has one, but
# check_launch takes it, so both tiles run it in step 2
P128_DOWN = (256, 128, True, 32)
# the variants of K3's launch: (tile, P, downsample)
K3_VARIANTS = {(tile, planes, ds) for tile in ("8x16", "8x8")
               for planes in (64, 128) for ds in (False, True)}


def check_k3_sass():
    """The built K3 library holds wgmma (HGMMA) and TMA loads and stores
    (UTMALDG, UTMASTG), and no mma.sync (HMMA) or cp.async (LDGSTS): the
    kernel that runs is the Hopper design. cuobjdump comes from nvcc's own
    directory; a missing tool fails."""
    from fast3dhpe_tpu_torch.ops._build import _nvcc, library_path
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass",
                           str(library_path("fused_bottleneck"))],
                          capture_output=True, text=True, check=True).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "UTMASTG",
                                            "HMMA", "LDGSTS")}
    print(f"# K3 SASS: {counts}")
    require(counts["HGMMA"] and counts["UTMALDG"] and counts["UTMASTG"],
            f"K3's SASS lacks wgmma or TMA: {counts}")
    require(not counts["HMMA"] and not counts["LDGSTS"],
            f"K3's SASS still holds mma.sync or cp.async: {counts}")
    return counts


def check_bottleneck(dev, gen):
    """K3 against its plain version (same rounding points) at the two block
    shapes that fuse at 256 px, at 2, 8 and 64 images; at layer1.1; on a
    ragged plane; at P = 128 with a downsample at 2 and 64 images; on
    phase 13's haloed tiles (HALOED) at 2 and 8 images, through the entry
    the model serves and the timing runs (weights packed once); fails
    unless the cases ran every variant of the launch plan. Also holds
    ops/bottleneck.py's shared-memory formula and launch plan against the
    kernel's own, and reads the kernel's SASS (check_k3_sass)."""
    from fast3dhpe_tpu_torch.ops._build import load_library
    from fast3dhpe_tpu_torch.ops.bottleneck import (bottleneck_plain,
                                                    fused_bottleneck_packed,
                                                    launch_plan,
                                                    pack_weights, smem_bytes)
    lib = load_library("fused_bottleneck")
    kernel_smem = lib.fused_bottleneck_smem_bytes
    kernel_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    kernel_smem.restype = ctypes.c_int
    kernel_plan = lib.fused_bottleneck_plan
    kernel_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    kernel_plan.restype = ctypes.c_int
    check_k3_sass()
    for planes in (64, 128, 256):
        for ds in (False, True):
            got = kernel_smem(planes, int(ds))
            require(got == smem_bytes(planes, ds),
                    f"K3 shared memory at P={planes}, downsample={ds}: the "
                    f"kernel says {got}, ops/bottleneck.py "
                    f"{smem_bytes(planes, ds)}")
    # both sum in fp32 in different orders, so a value next to a bf16
    # rounding boundary can round to the other neighbour in h1, h2, h3 or
    # the output: a few elements differ by a few bf16 ulps (2^-7 relative),
    # the mean barely moves. A wrong halo moves every border pixel by
    # ~relu(b1)-sized terms and fails the mean bound.
    max_rel, mean_rel = 2.0 ** -5, 2.0 ** -11
    cases = [(name, n, shape) for name, shape in BLOCK_SHAPES.items()
             for n in (2, 2 * PAIRS, 2 * TIMING_PAIRS)]
    cases += [("layer1.1", 2 * PAIRS, LAYER11), ("ragged 36x44", 2, RAGGED)]
    cases += [("P 128 downsample", n, P128_DOWN)
              for n in (2, 2 * TIMING_PAIRS)]
    cases += [(f"{name} haloed {h}x{w}", 2 * pairs, (cin, planes, ds, (h, w)))
              for name, (cin, planes, ds, hws) in HALOED.items()
              for h, w in hws for pairs in S8_PAIRS]
    err = 0.0
    variants = set()
    for name, n, (cin, planes, ds, hw) in cases:
        x, args = bottleneck_case(gen, dev, n, cin, planes, ds, hw)
        h, w = x.shape[2:]
        plan = launch_plan(n, h, w)
        got_plan = (ctypes.c_int * 5)()
        kernel_plan(n, h, w, got_plan)
        require(tuple(got_plan) == (plan.ctas, plan.cluster, plan.items,
                                    *plan.tile),
                f"K3 {name} (n={n}): the kernel's launch {tuple(got_plan)}, "
                f"ops/bottleneck.py launch_plan {plan}")
        variants.add((plan.variant, planes, ds))
        got = fused_bottleneck_packed(x, pack_weights(*args)).float()
        ref = bottleneck_plain(x, *args).float()
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        d = (got - ref).abs()
        border = torch.cat([d[:, :, 0].flatten(), d[:, :, -1].flatten(),
                            d[:, :, :, 0].flatten(), d[:, :, :, -1].flatten()])
        print(f"# K3 {name} n={n} ({plan.variant}, {plan.ctas} CTAs): "
              f"max|d| {d.max().item():.4g}, "
              f"mean|d| {d.mean().item():.3g}, border mean "
              f"{border.mean().item():.3g}, max|ref| {scale:.4g}")
        require(d.max().item() <= max_rel * scale
                and d.mean().item() <= mean_rel * scale
                and border.mean().item() <= mean_rel * scale,
                f"fused bottleneck {name} (n={n}) differs from its plain "
                f"version beyond max {max_rel} / mean {mean_rel} of "
                f"max|ref|")
        err = max(err, d.max().item())
    require(variants == K3_VARIANTS,
            f"K3's checks ran the variants {sorted(variants)}, not every "
            f"one of {sorted(K3_VARIANTS)}")
    print(f"# K3 fused bottleneck: max |kernel - plain| = {err:.4g}")
    return err


# -------------------------------------------------------------------- path

def seeded_inferencer(cfg, device, state_dict=None):
    from fast3dhpe_tpu_torch.apps.inference import CDRNetInferencer
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.models.layers import init_weights
    if state_dict is None:
        model = CDRNet.from_config(cfg)
        init_weights(model, torch.Generator().manual_seed(SEED))
        state_dict = model.state_dict()
    return CDRNetInferencer(cfg, dtype=torch.bfloat16, fused_inference=True,
                            state_dict=state_dict, device=device)


def normalized(img_l, img_r, device):
    from fast3dhpe_tpu_torch.ops.warp import normalize_imagenet
    return torch.stack([normalize_imagenet(torch.as_tensor(i).to(device))
                        for i in (img_l, img_r)], dim=1)


def _launch_counters(bn: bool):
    """The kernel wrappers of the counters that a CUDA graph's replay
    carries (fast3dhpe_tpu_torch/cuda_graphs.py), by name: the train BN
    kernels' (bn) or the others'."""
    from fast3dhpe_tpu_torch import cuda_graphs
    from fast3dhpe_tpu_torch.ops import batchnorm  # noqa: F401 (registers)
    return {k: c for k, c in cuda_graphs.CARRIED.items()
            if not isinstance(c, Counter) and k.startswith("train_bn") == bn}


def kernel_counters():
    return _launch_counters(bn=False)


def bn_counts():
    """The train BN kernels' launches forward and backward, and the
    backward's copies of a dy that arrived in another layout than x's
    (ops/batchnorm.py), so far."""
    from fast3dhpe_tpu_torch.ops import batchnorm as bn
    return {**{k: c.launches for k, c in _launch_counters(bn=True).items()},
            "train_bn_relayouts": bn.train_bn_backward.relayouts}


def bn_since(before):
    now = bn_counts()
    return {k: now[k] - before[k] for k in now}


def train_bn_layers(model):
    """The model's BatchNorm layers (BatchNorm3d included): in train mode
    each takes the train BN kernels once a forward and once a backward."""
    from fast3dhpe_tpu_torch.models.layers import BatchNorm2d
    return sum(isinstance(m, BatchNorm2d) for m in model.modules())


def require_bn_counts(got, steps, layers, what):
    """got (bn_since over `steps` train steps) holds 3 launches a BN layer
    each way a step, and no relayout of dy."""
    want = {"train_bn_forward": 3 * layers * steps,
            "train_bn_backward": 3 * layers * steps,
            "train_bn_relayouts": 0}
    got = {k: got[k] for k in want}
    require(got == want, f"{what}: {steps} train steps of {layers} BN layers "
                         f"gave {got}, not {want}")


def serve_counted(inf, requests, n_fused, what):
    """predict_batch(*request) for each request, with the kernels' launch
    counts set to 0 just before and read just after: each request must
    launch K1 once, K2 never and K3 once per fused block; outputs of the
    request's shapes, finite."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    outs = [inf.predict_batch(*req) for req in requests]
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    n = len(requests)
    print(f"# {what}: {n} requests x {len(requests[0][0])} pairs, launches "
          f"{launches}")
    require(launches == {"soft_argmax": n, "soft_argmax_bwd": 0,
                         "fused_bottleneck": n * n_fused},
            f"{what}: {n} requests launched K1/K2/K3 {launches}, not "
            f"{n}/0/{n * n_fused}")
    for req, (kp, p3d) in zip(requests, outs):
        pairs = len(req[0])
        require(kp.shape == (pairs, 2, 19, 2) and p3d.shape == (pairs, 19, 3),
                f"{what}: output shapes {tuple(kp.shape)}, "
                f"{tuple(p3d.shape)}")
        require(bool(torch.isfinite(kp).all() and torch.isfinite(p3d).all()),
                f"{what}: non-finite output")
    return outs, launches


def run_path(cfg, dev):
    t0 = time.perf_counter()
    inf = seeded_inferencer(cfg, "cuda")
    model = inf.model
    fused = model.encoder.fused_blocks(tuple(cfg.MODEL.IMAGE_SIZE),
                                       torch.bfloat16)
    require(fused == ["layer1.0", "layer2.1", "layer2.2", "layer2.3"],
            f"unexpected fused blocks {fused}")
    rng = np.random.RandomState(SEED)
    requests = [stereo_request(rng, PAIRS) for _ in range(REQUESTS)]

    # The N(0, 0.001) head decodes every view to the heatmap centre, where
    # the stereo rays are parallel and triangulation degenerates. Scale it
    # so the logits have unit spread on the first request: the views then
    # decode apart and the soft-argmax stays smooth.
    with torch.inference_mode():
        _, _, hm = model(normalized(*requests[0][:2], dev),
                         torch.as_tensor(requests[0][2], device=dev),
                         return_heatmaps=True)
        head = model.decoder.final_layer.weight
        head.mul_(1.0 / hm.float().std().item())
    print(f"# path: CDRNet-{cfg.MODEL.NUM_LAYERS} built and calibrated in "
          f"{time.perf_counter() - t0:.1f} s; fused blocks {fused}")

    outs, launches = serve_counted(inf, requests, len(fused), "path")

    # one request against the same module on the CPU
    t0 = time.perf_counter()
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    cpu_inf = seeded_inferencer(cfg, "cpu", state_dict=sd)
    img_l, img_r, proj = requests[0]
    check_vs_cpu(model, cpu_inf.model, normalized(img_l, img_r, dev),
                 normalized(img_l, img_r, "cpu"), proj, outs[0][0],
                 "path vs CPU", t0)
    return inf, launches, cpu_inf


def check_vs_cpu(model, cpu_model, imgs, cpu_imgs, proj, served_kp, what,
                 t0):
    """One request's heatmaps, pred_2d and pred_3d on the card against the
    same module on the CPU, from the same normalised images; served_kp is
    what predict_batch returned for them."""
    from fast3dhpe_tpu_torch.geometry.triangulation import dlt_triangulate
    dev = imgs.device
    pairs = proj.shape[0]
    with torch.inference_mode():
        gkp, gp3d, ghm = model(imgs, torch.as_tensor(proj, device=dev),
                               return_heatmaps=True)
        ckp, cp3d, chm = cpu_model(cpu_imgs, torch.as_tensor(proj).cpu(),
                                   return_heatmaps=True)
        # the GPU's geometry against the CPU's on the GPU's own keypoints
        proj_j = torch.as_tensor(proj).cpu()[:, None].expand(
            pairs, 19, 2, 3, 4)
        ref3 = dlt_triangulate(proj_j, gkp.cpu().transpose(1, 2))
    torch.testing.assert_close(gkp, served_kp, rtol=0, atol=0)
    ghm, chm = ghm.float().cpu(), chm.float()
    hm_scale = chm.abs().max().item()
    hm_max = (ghm - chm).abs().max().item() / hm_scale
    hm_mean = (ghm - chm).abs().mean().item() / hm_scale
    kp_err = (gkp.cpu() - ckp).abs().max().item()
    p3_rel = ((gp3d.cpu() - ref3).norm(dim=-1)
              / ref3.norm(dim=-1)).max().item()
    p3_cpu_rel = ((gp3d.cpu() - cp3d).norm(dim=-1)
                  / cp3d.norm(dim=-1)).median().item()
    print(f"# {what} ({time.perf_counter() - t0:.1f} s): heatmaps max "
          f"{hm_max:.3g} / mean {hm_mean:.3g} of max|cpu| {hm_scale:.3g}; "
          f"pred_2d max {kp_err:.3g} px; pred_3d vs CPU DLT of the GPU's "
          f"pred_2d {p3_rel:.3g} relative; pred_3d vs the CPU run, median "
          f"{p3_cpu_rel:.3g} relative; pred_2d spread "
          f"{gkp.std().item():.3g} px")
    # bf16 bounds of tests/test_pallas_kernels.py:116-119: cuDNN and
    # oneDNN round bf16 convolutions differently
    require(hm_max < 0.05 and hm_mean < 0.005,
            f"{what}: heatmaps differ from the CPU run: max {hm_max}, mean "
            f"{hm_mean}")
    # with unit-spread logits those heatmap errors move a centre of mass by
    # a fraction of a heatmap pixel (4 image pixels)
    require(kp_err < 2.0,
            f"{what}: pred_2d differs from the CPU run by {kp_err} px")
    # fp32 Jacobi SVD on either device, same keypoints
    require(p3_rel < 1e-3,
            f"{what}: pred_3d differs from the CPU DLT by {p3_rel}")
    return {"hm_max": hm_max, "hm_mean": hm_mean, "kp_px": kp_err,
            "p3_rel": p3_rel}


# ---------------------------------------------------------------- training

def converging_rig(batch, size=256, height=None):
    """bench.py's intrinsics and camera centres (x = -+400 mm, 3000 mm from
    the origin), each camera turned toward the origin. bench.py's own rig
    keeps the axes parallel, and at 3 m each camera sees only
    128 * 3000 / 1100 = 349 mm either side of its axis, which lies 400 mm
    off the origin: no pose near the origin projects into both views.
    size: the image width; height: its height if it is not square (f then
    scales with the shorter side, the principal point is the centre)."""
    height = size if height is None else height
    f = 1100.0 * min(size, height) / 256
    K = np.array([[f, 0.0, size / 2], [0.0, f, height / 2],
                  [0.0, 0.0, 1.0]])
    Ps = []
    for cx in (-400.0, 400.0):
        centre = np.array([cx, 0.0, -3000.0])
        z = -centre / np.linalg.norm(centre)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        Ps.append(K @ np.hstack([R, -R @ centre[:, None]]))
    return np.broadcast_to(np.stack(Ps), (batch, 2, 3, 4)).astype(np.float32)


def train_batch(rng, pairs, pad, size=256):
    """Normalised random images, 3D poses within +-250 mm of the origin,
    their exact projections as target_2d, target weights 1, and the last
    `pad` rows marked padded (a final batch)."""
    proj = converging_rig(pairs, size)
    p3 = rng.uniform(-250, 250, (pairs, 19, 3)).astype(np.float32)
    hom = np.concatenate([p3, np.ones((pairs, 19, 1), np.float32)], -1)
    uvw = np.einsum("bvij,bkj->bvki", proj, hom)
    t2d = (uvw[..., :2] / uvw[..., 2:]).astype(np.float32)
    require(t2d.min() > 0 and t2d.max() < size,
            "a target joint projects outside the image")
    row_valid = np.ones(pairs, np.float32)
    row_valid[pairs - pad:] = 0.0
    return {"image": rng.randn(pairs, 2, size, size, 3).astype(np.float32),
            "proj": proj, "target_3d": p3, "target_2d": t2d,
            "target_weight": np.ones((pairs, 19), np.float32),
            "row_valid": row_valid}


def on_device(batch, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def calibrate_train_head(model, batch):
    """Scale the N(0, 0.001) heatmap head so that the train-mode logits
    have unit spread on this batch, as the serving phase does in eval mode:
    the views then decode apart and the DLT is well conditioned. The BN
    running statistics are left as they were."""
    saved = {k: v.clone() for k, v in model.named_buffers()}
    model.train()
    with torch.no_grad():
        _, _, hm = model(batch["image"], batch["proj"], return_heatmaps=True,
                         row_valid=batch["row_valid"])
        model.decoder.final_layer.weight.mul_(1.0 / hm.float().std().item())
        for k, v in model.named_buffers():
            v.copy_(saved[k])


# BN sites whose first update the training phase recomputes, and whether
# their rows are the view-stacked (B*V) batch. encoder.bn1 has 917k valid
# values a channel, so its mean shows which rows were taken; the CF sites
# have 56 x 64 and 28 x 64, where an unbiased variance is 2.8e-4 and
# 5.6e-4 larger than the biased one.
BN_SITES = {"encoder.bn1": True, "CF.conv_layer1.1": True,
            "CF.out_layer.0.1": False}
BN_MEAN_TOL, BN_VAR_TOL = 1e-5, 1e-4     # of the batch std and variance


class BNUpdateCheck:
    """Holds the first running-statistic update of the BN_SITES against an
    independent computation: torch.var_mean in fp64 (two-pass, biased)
    over the rows that this script marks valid (np.repeat per view for the
    stacked sites). The port's batch statistics are read back from the
    update, (new - (1 - m) * old) / m."""

    def __init__(self, model, row_valid):
        self.mods = dict(model.named_modules())
        self.valid, self.old, self.inputs, self.handles = {}, {}, {}, []
        for name, stacked in BN_SITES.items():
            m = self.mods[name]
            rv = np.repeat(row_valid, 2) if stacked else row_valid
            self.valid[name] = torch.as_tensor(rv > 0)
            self.old[name] = (m.running_mean.double().clone(),
                              m.running_var.double().clone())
            self.handles.append(m.register_forward_pre_hook(self._hook(name)))

    def _hook(self, name):
        def hook(mod, args):
            self.inputs.setdefault(name, args[0].detach())
        return hook

    def check(self):
        for h in self.handles:
            h.remove()
        worst = 0.0
        for name in BN_SITES:
            m, x = self.mods[name], self.inputs[name]
            var, mean = torch.var_mean(
                x[self.valid[name].to(x.device)].double(), dim=(0, 2, 3),
                correction=0)
            mom = m.momentum
            old_mean, old_var = self.old[name]
            got_mean = (m.running_mean.double() - (1 - mom) * old_mean) / mom
            got_var = (m.running_var.double() - (1 - mom) * old_var) / mom
            e_mean = ((got_mean - mean).abs() / var.sqrt()).max().item()
            e_var = ((got_var - var) / var).abs().max().item()
            print(f"# train BN {name}: batch mean within {e_mean:.3g} std, "
                  f"variance within {e_var:.3g} of fp64 over the valid rows")
            require(e_mean <= BN_MEAN_TOL and e_var <= BN_VAR_TOL,
                    f"BN {name} updated its running statistics from other "
                    f"statistics than the biased ones of the valid rows: "
                    f"mean {e_mean:.3g} std (bound {BN_MEAN_TOL}), variance "
                    f"{e_var:.3g} (bound {BN_VAR_TOL})")
            worst = max(worst, e_var)
        return worst


def seeded_train_model(cfg):
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.models.layers import init_weights
    model = CDRNet.from_config(cfg)
    init_weights(model, torch.Generator().manual_seed(SEED))
    return model


def train_step_fn(cfg, mesh=None):
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.train.steps import make_train_step_cdr
    return make_train_step_cdr(
        make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT),
        loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
        num_joints=cfg.MODEL.NUM_JOINTS, mesh=mesh)


def run_train(cfg, dev):
    """The training path: CDRNet-101 at full width, fp32, the config's
    Adam, loss and 3D weight, TRAIN_PAIRS pairs with TRAIN_PAD padded."""
    from fast3dhpe_tpu_torch.ops.bottleneck import fused_bottleneck
    from fast3dhpe_tpu_torch.ops.softargmax import (soft_argmax_bwd_fused,
                                                    soft_argmax_fused)
    from fast3dhpe_tpu_torch.train.state import TrainState

    t0 = time.perf_counter()
    batch = train_batch(np.random.RandomState(SEED + 2), TRAIN_PAIRS,
                        TRAIN_PAD, cfg.MODEL.IMAGE_SIZE[0])
    db = on_device(batch, dev)
    model = seeded_train_model(cfg).to(dev)
    calibrate_train_head(model, db)
    start_sd = {k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}
    state = TrainState.create(model, cfg, steps_per_epoch=1)
    step = train_step_fn(cfg)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if "running" in n}
    bn_check = BNUpdateCheck(model, batch["row_valid"])
    torch.cuda.synchronize()
    print(f"# train: CDRNet-{cfg.MODEL.NUM_LAYERS} fp32 built and "
          f"calibrated in {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    counters = (soft_argmax_fused, soft_argmax_bwd_fused, fused_bottleneck)
    for c in counters:
        c.launches = 0
    bn_layers = train_bn_layers(model)
    require(bn_layers == BN_LAYERS_CDRNET,
            f"CDRNet-101 has {bn_layers} BN layers, not {BN_LAYERS_CDRNET}")
    bn_start = bn_counts()
    times, per_step, metrics = [], [], []
    for i, use_3d in enumerate(TRAIN_MODES):
        before = [c.launches for c in counters]
        bn_before = bn_counts()
        t = time.perf_counter()
        m = step(state, db, use_3d)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        bn_step = bn_since(bn_before)
        per_step.append(tuple(c.launches - b for c, b in zip(counters, before))
                        + (bn_step["train_bn_forward"],
                           bn_step["train_bn_backward"]))
        metrics.append({k: v.item() for k, v in m.items()})
        print(f"# train step {i} use_3d={use_3d}: {times[-1]:.1f} ms, "
              f"launches K1/K2/K3/BN fwd/BN bwd {per_step[-1]}, "
              + ", ".join(f"{k} {v:.6g}" for k, v in metrics[-1].items()))
        if i == 0:
            bn_err = bn_check.check()
    launches = {"soft_argmax": soft_argmax_fused.launches,
                "soft_argmax_bwd": soft_argmax_bwd_fused.launches,
                "fused_bottleneck": fused_bottleneck.launches,
                **bn_since(bn_start)}
    require_bn_counts(launches, len(TRAIN_MODES), bn_layers, "train steps")

    bn3 = 3 * bn_layers
    for i, (use_3d, m, n) in enumerate(zip(TRAIN_MODES, metrics, per_step)):
        require(n == (1, 1, 0, bn3, bn3),
                f"train step {i} launched K1/K2/K3/BN fwd/BN bwd {n} times, "
                f"not (1, 1, 0, {bn3}, {bn3})")
        require(all(np.isfinite(v) for v in m.values()),
                f"train step {i}: non-finite metrics {m}")
        if use_3d:
            want = m["loss_2d"] + cfg.TRAIN.LOSS_3D_WEIGHT * m["loss_3d"]
            require(abs(m["loss"] - want) <= 1e-6 * abs(want),
                    f"train step {i}: loss {m['loss']} is not loss_2d + "
                    f"{cfg.TRAIN.LOSS_3D_WEIGHT} loss_3d = {want}")
        else:
            require(m["loss"] == m["loss_2d"],
                    f"warmup step {i}: loss {m['loss']} != loss_2d "
                    f"{m['loss_2d']}")
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), params0[n])]
    still += [n for n, b in model.named_buffers()
              if n in stats0 and torch.equal(b, stats0[n])]
    require(not still, f"unchanged after {len(TRAIN_MODES)} steps: {still}")

    for _ in range(TIMED_STEPS):
        t = time.perf_counter()
        step(state, db, True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"# train step at {TRAIN_PAIRS} pairs: median {step_ms:.1f} ms "
          f"over steps 2-{len(times)} ({TRAIN_PAIRS / step_ms * 1e3:.1f} "
          f"pairs/s); steps {[round(t, 1) for t in times]} ms; peak device "
          f"memory {peak:.2f} GiB")
    return {"state": state, "step": step, "batch": db, "start_sd": start_sd,
            "launches": launches, "bn_err": bn_err,
            "summary": {"pairs": TRAIN_PAIRS, "step_ms": step_ms,
                        "pairs_per_s": TRAIN_PAIRS / step_ms * 1e3,
                        "step_times_ms": times, "peak_gib": peak,
                        "metrics": metrics}}


# Card vs CPU: one train step with and one without the 3D loss, at 2 pairs
# (one padded), full width, from the same weights and batch. The losses are
# fp32 sums in another order: CPU_LOSS_TOL relative. grad_norm, the
# gradients and the BN running statistics pass through ReLUs, whose units
# within rounding of zero switch between devices, and, with the 3D loss,
# through the Jacobi-SVD DLT, whose backward at untrained weights amplifies
# rounding a millionfold (grad_norm ~1e6). So each is held to CPU_NOISE_X
# times the change that rounding-sized noise makes on the CPU itself (its
# images x (1 + 1e-7)), and never looser than that noise allows: at least
# CPU_FLOOR.
CPU_LOSS_TOL, CPU_NOISE_X, CPU_FLOOR = 1e-4, 3.0, 1e-3


def _step_errors(a, b):
    """How far run a is from run b: losses (relative), grad_norm
    (relative), the gradients (of their norm), the BN running statistics
    (per buffer, of its range; the worst buffers named)."""
    (am, ag, ast), (bm, bg, bst) = a, b
    num = sum(float(((ag[n] - bg[n]) ** 2).sum()) for n in bg)
    stats = sorted(((float((ast[n] - bst[n]).abs().max())
                     / float(bst[n].abs().max()), n) for n in bst),
                   reverse=True)
    return {"loss": max(abs(am[k] - bm[k]) / abs(bm[k])
                        for k in ("loss", "loss_2d", "loss_3d")),
            "grad_norm": abs(am["grad_norm"] - bm["grad_norm"])
            / bm["grad_norm"],
            "grads": (num / sum(float((bg[n] ** 2).sum()) for n in bg))
            ** 0.5,
            "bn_stats": stats[0][0],
            "bn_worst": [f"{n} {e:.3g}" for e, n in stats[:3]]}


def train_vs_cpu(cfg, start_sd, dev):
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.train.state import TrainState

    t0 = time.perf_counter()
    batch = train_batch(np.random.RandomState(SEED + 3), 2, 1,
                        cfg.MODEL.IMAGE_SIZE[0])
    step = train_step_fn(cfg)

    def one_step(device, use_3d, images_scale=1.0):
        model = CDRNet.from_config(cfg)
        model.load_state_dict(start_sd, strict=True)
        model.to(device)
        # lr 0: the gradients are compared, the parameters stay put
        state = TrainState(model, torch.optim.SGD(model.parameters(),
                                                  lr=0.0))
        b = dict(batch, image=batch["image"] * np.float32(images_scale))
        m = step(state, on_device(b, device), use_3d)
        return ({k: v.item() for k, v in m.items()},
                {n: p.grad.detach().cpu() for n, p in
                 model.named_parameters()},
                {n: t.detach().cpu() for n, t in model.named_buffers()
                 if "running" in n})

    out = {}
    for use_3d in (True, False):
        cpu = one_step("cpu", use_3d)
        err = _step_errors(one_step(dev, use_3d), cpu)
        noise = _step_errors(one_step("cpu", use_3d, 1.0 + 1e-7), cpu)
        label = "use_3d" if use_3d else "warmup"
        print(f"# train card vs CPU, {label} step: "
              + ", ".join(f"{k} {err[k]:.3g} (CPU noise {noise[k]:.3g})"
                          for k in ("loss", "grad_norm", "grads",
                                    "bn_stats"))
              + f"; worst BN buffers {err['bn_worst']}")
        require(err["loss"] <= CPU_LOSS_TOL,
                f"{label} losses differ from the CPU's by {err['loss']:.3g} "
                f"(bound {CPU_LOSS_TOL})")
        for k in ("grad_norm", "grads", "bn_stats"):
            bound = max(CPU_FLOOR, CPU_NOISE_X * noise[k])
            require(err[k] <= bound,
                    f"{label} {k} differs from the CPU's by {err[k]:.3g}, "
                    f"beyond {CPU_NOISE_X} x the CPU's own noise "
                    f"{noise[k]:.3g} (bound {bound:.3g})")
        out[label] = {"card_vs_cpu": err, "cpu_noise": noise}
    print(f"# train card vs CPU: {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------- input pipeline

RAW_H, RAW_W = 768, 1024          # MADS frames (fast3dhpe_tpu/ops/warp.py)
CACHE_PAIRS = 512                 # 1024 frames, 2.4 GB resident
EPOCH_BATCHES = 3                 # S: an epoch of 3 batches of TRAIN_PAIRS
OCCL_BATCHES = 16                 # 512 samples for the Cutout statistics
OCCL_PROB = 0.3                   # device_pipeline.py's gate
CUTOUT_HOLES, CUTOUT_LEN = 6, 40  # ops/occlusion.py's defaults
HNS_HIDDEN, HNS_CELLS = 6, 4      # int(0.4 * 16) of a 4 x 4 grid
# the CPU tests' warp bound (tests/test_torch_pipeline_ops.py: 1e-3
# intensity levels) over the smallest ImageNet std, in normalised units
IMAGE_TOL = 1e-3 / 255.0 / 0.224
META_TOL = 1e-4                   # proj, targets, weights: of max|cpu|


def frame_paths(pairs):
    return [f"pair{i:04d}_{v}" for i in range(pairs) for v in "lr"]


def decode_frames(paths):
    """The cache's decode_batch: a seeded uint8 768x1024x3 frame a path."""
    return [np.random.default_rng([SEED, int(p[4:8]), int(p.endswith("r"))])
            .integers(0, 256, (RAW_H, RAW_W, 3), dtype=np.uint8)
            for p in paths]


def build_cache(dev):
    """The frame cache of CACHE_PAIRS stereo pairs on the card, through
    DeviceFrameCache.build in chunks of 64 with a budget that fits, and a
    second build at half that budget (plus one frame) with allow_partial
    and pair_stride=2, which must keep an even prefix."""
    from fast3dhpe_tpu_torch.data.device_cache import DeviceFrameCache
    paths = frame_paths(CACHE_PAIRS)
    frame = RAW_H * RAW_W * 3
    budget = len(paths) * frame
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = DeviceFrameCache.build(paths, decode_frames, budget,
                                   chunk_frames=64, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(cache is not None and not cache.partial
            and tuple(cache.frames.shape) == (len(paths), RAW_H, RAW_W, 3)
            and cache.frames.is_cuda,
            f"the full cache build gave {cache and cache.frames.shape}")
    for p in (paths[0], paths[64], paths[-1]):      # first, second chunk
        row = int(cache.rows([p])[0])
        require(torch.equal(cache.frames[row].cpu(),
                            torch.from_numpy(decode_frames([p])[0])),
                f"cache row {row} is not the frame of {p}")
    t0 = time.perf_counter()
    half = DeviceFrameCache.build(paths, decode_frames, budget // 2 + frame,
                                  chunk_frames=64, allow_partial=True,
                                  pair_stride=2, device=dev)
    torch.cuda.synchronize()
    half_s = time.perf_counter() - t0
    rows = half.frames.shape[0]
    require(half.partial and rows == len(paths) // 2
            and half.has(paths[rows - 1]) and not half.has(paths[rows]),
            f"the half-budget build kept {rows} rows, partial {half.partial}")
    del half
    torch.cuda.empty_cache()
    print(f"# cache: {len(paths)} frames of {RAW_H}x{RAW_W} uint8, "
          f"{cache.nbytes / 1e9:.3f} GB resident, built in {build_s:.1f} s "
          f"(decode + copy, chunks of 64); half budget: partial, {rows} "
          f"rows, {half_s:.1f} s")
    return cache, {"frames": len(paths), "nbytes": cache.nbytes,
                   "build_s": build_s, "partial_rows": rows,
                   "partial_build_s": half_s}


def raw_rig(batch):
    """converging_rig for the raw frame as (B, 2, 4, 4)."""
    P = np.zeros((batch, 2, 4, 4), np.float32)
    P[:, :, :3] = converging_rig(batch, RAW_W, RAW_H)
    P[:, :, 3, 3] = 1.0
    return P


def stacked_meta(cache, cfg, rng, batches, pad):
    """`batches` stacked batches of TRAIN_PAIRS cached pairs, as
    Stereo3DLoader.stacked_epoch stacks them: a shuffle of the pairs, the
    last `pad` rows padded (repeating the last pair); each row's train-time
    scale and rotation drawn as data/loader.py:154-159 draws them, its
    affine from get_affine_transform (centre = frame centre, origin_size =
    min(H, W)); the raw rig; poses within +-250 mm; 5% of joints
    invisible."""
    from fast3dhpe_tpu_torch.geometry.affine import get_affine_transform
    n = batches * TRAIN_PAIRS
    order = rng.permutation(CACHE_PAIRS)[:n - pad]
    order = np.concatenate([order, np.repeat(order[-1:], pad)])
    sf, rf = cfg.DATASET.SCALE_FACTOR, cfg.DATASET.ROT_FACTOR
    trans = []
    for _ in range(n):
        s = np.clip(rng.randn() * sf + 1, 1 - sf, 1 + sf)
        r = (np.clip(rng.randn() * rf, -rf * 2, rf * 2)
             if rng.random_sample() <= 0.6 else 0.0)
        trans.append(get_affine_transform((RAW_W / 2, RAW_H / 2), s, r,
                                          min(RAW_H, RAW_W),
                                          cfg.MODEL.IMAGE_SIZE))
    P = raw_rig(n)
    row_valid = np.ones(n, np.float32)
    row_valid[n - pad:] = 0.0
    paths = frame_paths(CACHE_PAIRS)
    xs = {"idx_l": cache.rows([paths[2 * i] for i in order]),
          "idx_r": cache.rows([paths[2 * i + 1] for i in order]),
          "trans": np.stack(trans).astype(np.float32),
          "P_l": P[:, 0], "P_r": P[:, 1],
          "pose_3d": rng.uniform(-250, 250, (n, 19, 3)).astype(np.float32),
          "joints_vis": (rng.rand(n, 19) > 0.05).astype(np.float32),
          "row_valid": row_valid}
    return {k: v.reshape((batches, TRAIN_PAIRS) + v.shape[1:])
            for k, v in xs.items()}


def pipeline_batch(frames, xs, i, cfg, gen=None, occlusion=None,
                   train=False, return_masks=False):
    """Batch i of the stacked metadata xs through the cached stereo
    pipeline, on the frames' device."""
    from fast3dhpe_tpu_torch.data.device_pipeline import (
        preprocess_stereo_batch_cached)
    return preprocess_stereo_batch_cached(
        gen, frames, xs["idx_l"][i], xs["idx_r"][i], xs["trans"][i],
        xs["P_l"][i], xs["P_r"][i], xs["pose_3d"][i], xs["joints_vis"][i],
        image_size=tuple(cfg.MODEL.IMAGE_SIZE), occlusion=occlusion,
        train=train, return_masks=return_masks)


def on_card(xs, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in xs.items()}


def expected_weight(t2d, vis, keep):
    """target_weight recomputed on the host: joints_vis x both views'
    boundary checks x the keep-mask at each joint's truncated pixel, with
    the -1 of an out-of-image joint wrapping to the last pixel. t2d: the
    eval-mode (unchecked) (B, 2, J, 2); keep: (B, 2, H, W)."""
    H, W = keep.shape[-2:]
    inside = ((t2d[..., 0] >= 0) & (t2d[..., 0] < W) & (t2d[..., 1] >= 0)
              & (t2d[..., 1] < H))
    want = vis * inside[:, 0] * inside[:, 1]
    rows = np.arange(len(vis))[:, None]
    for v in (0, 1):
        xy = np.where(inside[:, v, :, None], t2d[:, v], -1.0).astype(
            np.int32)
        want = want * keep[rows, v, xy[..., 1], xy[..., 0]]
    return want


def cutout_holes_needed(hidden):
    """The fewest CUTOUT_LEN-square holes that could make up a hidden mask
    (H, W): a connected union of n such squares has a bounding box of at
    most n * CUTOUT_LEN on each side and at most n * CUTOUT_LEN^2 pixels."""
    from scipy import ndimage
    labels, n = ndimage.label(hidden)
    need = 0
    for sl, k in zip(ndimage.find_objects(labels), range(1, n + 1)):
        h, w = sl[0].stop - sl[0].start, sl[1].stop - sl[1].start
        area = int((labels[sl] == k).sum())
        need += max(-(-h // CUTOUT_LEN), -(-w // CUTOUT_LEN),
                    -(-area // CUTOUT_LEN ** 2))
    return need


def check_pipeline(cache, cfg, dev):
    """The pipeline's output on the card: the keep-mask invariants, the
    target weights recomputed from the masks, the occlusion statistics of
    Cutout (OCCL_BATCHES x 32 samples) and Hide-and-Seek (one batch), and
    one eval batch against the same function on the CPU."""
    from fast3dhpe_tpu_torch.data.device_pipeline import (
        preprocess_stereo_batch)
    from fast3dhpe_tpu_torch.ops.warp import normalize_imagenet
    t0 = time.perf_counter()
    rng = np.random.RandomState(SEED + 5)
    xs = stacked_meta(cache, cfg, rng, OCCL_BATCHES, 0)
    dxs = on_card(xs, dev)
    out = {}

    # keep-mask invariants and target weights, batch 0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    occ = pipeline_batch(cache.frames, dxs, 0, cfg, gen, "CUTOUT", True, True)
    ev = pipeline_batch(cache.frames, dxs, 0, cfg)
    keep = occ["keep_mask"]
    gray = normalize_imagenet(torch.full((3,), 128.0, device=dev))
    hidden = int((~keep).sum())
    require(hidden > 0, "Cutout hid nothing in a batch of 32")
    require(torch.equal(occ["image"][~keep], gray.expand(hidden, 3)),
            "an occluded pixel is not normalize_imagenet(128)")
    require(torch.equal(occ["image"][keep], ev["image"][keep]),
            "a kept pixel differs from the eval-mode output")
    want = expected_weight(ev["target_2d"].cpu().numpy(),
                           xs["joints_vis"][0], keep.cpu().numpy())
    got = occ["target_weight"].cpu().numpy()
    require(np.array_equal(got, want),
            f"target_weight differs from joints_vis x boundary x keep in "
            f"{int((got != want).sum())} joints")
    print(f"# pipeline masks: {hidden} occluded pixels are gray 128, the "
          f"rest equal the eval output; target_weight = vis x boundary x "
          f"keep ({int(want.sum())} of {want.size} joints weighted)")

    # Cutout statistics: one gate a sample for both views, the gated
    # share, and at most 6 holes of at most 40 x 40 an image
    gated, holes = [], []
    for i in range(OCCL_BATCHES):
        gen = torch.Generator(device=dev).manual_seed(SEED * 1000 + i)
        k = pipeline_batch(cache.frames, dxs, i, cfg, gen, "CUTOUT", True,
                           True)["keep_mask"].cpu().numpy()
        g = (~k).any(axis=(2, 3))                          # (B, 2)
        require(np.array_equal(g[:, 0], g[:, 1]),
                f"batch {i}: a sample was occluded in one view only")
        gated.append(g[:, 0])
        holes += [cutout_holes_needed(~k[b, v]) for b in np.flatnonzero(
            g[:, 0]) for v in (0, 1)]
    gated = np.concatenate(gated)
    share, n = float(gated.mean()), len(gated)
    sigma = (OCCL_PROB * (1 - OCCL_PROB) / n) ** 0.5
    require(abs(share - OCCL_PROB) <= 4 * sigma,
            f"Cutout gated {share:.4f} of {n} samples, not within 4 sigma "
            f"({4 * sigma:.4f}) of {OCCL_PROB}")
    require(max(holes) <= CUTOUT_HOLES,
            f"a gated image needs {max(holes)} holes of {CUTOUT_LEN} px")
    out["cutout"] = {"samples": n, "gated_share": share,
                     "four_sigma": 4 * sigma, "max_holes": max(holes)}

    # Hide-and-Seek: exactly 6 of the 16 64x64 cells of a gated image
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k = pipeline_batch(cache.frames, dxs, 0, cfg, gen, "HNS", True,
                       True)["keep_mask"].cpu().numpy()
    H = k.shape[-1] // HNS_CELLS
    cells = (~k).reshape(TRAIN_PAIRS, 2, HNS_CELLS, H, HNS_CELLS, H)
    whole = cells.all(axis=(3, 5))
    require(np.array_equal(whole, cells.any(axis=(3, 5))),
            "Hide-and-Seek hid part of a cell")
    count = whole.sum(axis=(2, 3))                         # (B, 2)
    g = count > 0
    require(np.array_equal(g[:, 0], g[:, 1]) and g.any()
            and (count[g] == HNS_HIDDEN).all(),
            f"Hide-and-Seek hid {sorted(set(count[g].tolist()))} cells")
    out["hns"] = {"gated": int(g[:, 0].sum()), "cells_hidden": HNS_HIDDEN}
    print(f"# pipeline occlusion: Cutout gated {share:.4f} of {n} samples "
          f"(0.3 +- {4 * sigma:.4f}), one gate for both views, at most "
          f"{max(holes)} holes of 40 px an image; Hide-and-Seek hid exactly "
          f"6 of 16 cells in each of {int(g[:, 0].sum())} gated samples")

    # one eval batch on the card against the same function on the CPU
    rows_l = torch.as_tensor(xs["idx_l"][0], device=dev).long()
    rows_r = torch.as_tensor(xs["idx_r"][0], device=dev).long()
    cpu = preprocess_stereo_batch(
        None, cache.frames.index_select(0, rows_l).cpu(),
        cache.frames.index_select(0, rows_r).cpu(), xs["trans"][0],
        xs["P_l"][0], xs["P_r"][0], xs["pose_3d"][0], xs["joints_vis"][0],
        image_size=tuple(cfg.MODEL.IMAGE_SIZE))
    err = {"image": (ev["image"].cpu() - cpu["image"]).abs().max().item()}
    for key in ("proj", "target_2d", "target_weight", "target_3d"):
        err[key] = ((ev[key].cpu() - cpu[key]).abs().max()
                    / cpu[key].abs().max()).item()
    require(err["image"] <= IMAGE_TOL,
            f"pipeline image differs from the CPU's by {err['image']:.3g} "
            f"(bound {IMAGE_TOL:.3g})")
    require(all(err[k] <= META_TOL for k in err if k != "image"),
            f"pipeline proj/targets/weights differ from the CPU's: {err}")
    out["vs_cpu"] = err
    print(f"# pipeline vs CPU (eval batch of {TRAIN_PAIRS} pairs): image "
          f"max {err['image']:.3g} (bound {IMAGE_TOL:.3g}), "
          + ", ".join(f"{k} {err[k]:.3g}" for k in err if k != "image")
          + f" of max|cpu| (bound {META_TOL}); "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def profile_calls(fn, calls=5):
    """Device time and the number of device activities (kernels, copies,
    fills) of one fn() call, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
    busy = sum((e.time_range.end - e.time_range.start) / 1e3 for e in ks)
    require(busy > 0, "the profiler recorded no device time")
    return {"device_ms": busy / calls, "launches": len(ks) / calls}


def run_pipeline_train(cfg, dev, cache, precomputed_step_ms):
    """make_train_epoch_cdr from the cache at full width: one warmup and one
    use_3d epoch of EPOCH_BATCHES batches of TRAIN_PAIRS pairs (the last
    TRAIN_PAD rows padded), the config's occlusion (CUTOUT), fp32. Then the
    pipeline alone and a pipeline-fed step are timed."""
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.train.state import TrainState
    from fast3dhpe_tpu_torch.train.steps import make_train_epoch_cdr
    t0 = time.perf_counter()
    xs = stacked_meta(cache, cfg, np.random.RandomState(SEED + 6),
                      EPOCH_BATCHES, TRAIN_PAD)
    dxs = on_card(xs, dev)
    model = seeded_train_model(cfg).to(dev)
    first = pipeline_batch(cache.frames, dxs, 0, cfg, train=True)
    first["row_valid"] = dxs["row_valid"][0]
    calibrate_train_head(model, first)
    state = TrainState.create(model, cfg, steps_per_epoch=EPOCH_BATCHES)
    occlusion = cfg.DATASET.OCCLUSION
    epoch = make_train_epoch_cdr(
        make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT),
        cfg.MODEL.IMAGE_SIZE, occlusion=occlusion,
        loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
        num_joints=cfg.MODEL.NUM_JOINTS)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    counters = kernel_counters()
    launches = {k: 0 for k in counters}
    epochs = []
    for seed, use_3d in ((0, False), (1, True)):
        for c in counters.values():
            c.launches = 0
        t = time.perf_counter()
        m = epoch(state, cache.frames, dxs, seed, use_3d)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        n = {k: c.launches for k, c in counters.items()}
        m = {k: v.item() for k, v in m.items()}
        print(f"# pipeline epoch seed {seed} use_3d={use_3d} "
              f"({EPOCH_BATCHES} steps, {occlusion}): {wall:.1f} ms, "
              f"launches {n}, summed "
              + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
        require(n == {"soft_argmax": EPOCH_BATCHES,
                      "soft_argmax_bwd": EPOCH_BATCHES,
                      "fused_bottleneck": 0},
                f"an epoch of {EPOCH_BATCHES} steps launched {n}, not one "
                f"K1 and one K2 a step and no K3")
        require(all(np.isfinite(v) for v in m.values()),
                f"non-finite epoch metrics {m}")
        if use_3d:
            want = m["loss_2d"] + cfg.TRAIN.LOSS_3D_WEIGHT * m["loss_3d"]
            require(abs(m["loss"] - want) <= 1e-6 * abs(want),
                    f"summed loss {m['loss']} is not loss_2d + "
                    f"{cfg.TRAIN.LOSS_3D_WEIGHT} loss_3d = {want}")
        else:
            require(m["loss"] == m["loss_2d"],
                    f"warmup epoch: loss {m['loss']} != loss_2d "
                    f"{m['loss_2d']}")
        for k in launches:
            launches[k] += n[k]
        epochs.append({"use_3d": use_3d, "wall_ms": wall, "metrics": m,
                       "launches": n})
    still = [n for n, p in model.named_parameters()
             if torch.equal(p.detach(), params0[n])]
    require(not still, f"unchanged after two pipeline epochs: {still}")

    # the pipeline alone, a batch of TRAIN_PAIRS pairs with Cutout
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def pipeline():
        return pipeline_batch(cache.frames, dxs, 0, cfg, gen, occlusion,
                              True)

    timing = {"call_ms": call_ms(pipeline), "host_ms": host_ms(pipeline)}
    timing.update(profile_calls(pipeline))
    walls = []
    for seed in range(2, 4):                       # pipeline-fed steps
        t = time.perf_counter()
        epoch(state, cache.frames, dxs, seed, True)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3 / EPOCH_BATCHES)
    timing["fed_step_ms"] = statistics.median(walls)
    timing["precomputed_step_ms"] = precomputed_step_ms
    share = timing["device_ms"] / precomputed_step_ms
    print(f"# pipeline alone ({TRAIN_PAIRS} pairs, train, {occlusion}): "
          f"device {timing['device_ms']:.3f} ms in "
          f"{timing['launches']:.0f} launches (profiler), events "
          f"{timing['call_ms']:.3f} ms, host {timing['host_ms']:.3f} ms; "
          f"{100 * share:.2f}% of a precomputed step")
    print(f"# pipeline-fed step {timing['fed_step_ms']:.1f} ms (epochs of "
          f"{EPOCH_BATCHES}, {walls}) vs precomputed-batch step "
          f"{precomputed_step_ms:.1f} ms; phase {time.perf_counter() - t0:.1f}"
          f" s")
    return {"launches": launches, "epochs": epochs, "timing": timing}


def raw_request(cache, first, pairs, cfg, dev):
    """`pairs` raw 768x1024 stereo pairs from the cache (already on the
    card), the eval-mode centre crop's affine and the cropped views'
    projections, as predict_batch(img_l, img_r, proj, trans) takes them."""
    from fast3dhpe_tpu_torch.geometry.affine import get_affine_transform
    paths = frame_paths(CACHE_PAIRS)
    trans = get_affine_transform((RAW_W / 2, RAW_H / 2), 1.0, 0.0,
                                 min(RAW_H, RAW_W), cfg.MODEL.IMAGE_SIZE)
    T = np.eye(4)
    T[:2, :3] = trans
    proj = (T @ raw_rig(1)[0].astype(np.float64))[:, :3].astype(np.float32)
    sel = range(first, first + pairs)
    rows = [torch.as_tensor(cache.rows([paths[2 * i + v] for i in sel]),
                            device=dev).long() for v in (0, 1)]
    return (cache.frames.index_select(0, rows[0]),
            cache.frames.index_select(0, rows[1]),
            torch.as_tensor(np.broadcast_to(proj, (pairs, 2, 3, 4)).copy(),
                            device=dev),
            torch.as_tensor(np.broadcast_to(trans.astype(np.float32),
                                            (pairs, 2, 3)).copy(),
                            device=dev))


def run_raw_serving(inf, cpu_model, cache, cfg, dev):
    """predict_batch(..., trans=...) on raw frames: REQUESTS requests of
    PAIRS pairs, counted; one against the CPU; then raw and pre-warped
    requests timed at batch 1 and 32 pairs."""
    from fast3dhpe_tpu_torch.ops.warp import affine_warp
    t0 = time.perf_counter()
    size = tuple(cfg.MODEL.IMAGE_SIZE)
    requests = [raw_request(cache, k * PAIRS, PAIRS, cfg, dev)
                for k in range(REQUESTS)]
    fused = inf.model.encoder.fused_blocks(size, torch.bfloat16)
    outs, launches = serve_counted(inf, requests, len(fused), "raw serving")
    img_l, img_r, proj, trans = requests[0]
    vs_cpu = check_vs_cpu(
        inf.model, cpu_model,
        normalized(affine_warp(img_l, trans, size),
                   affine_warp(img_r, trans, size), dev),
        normalized(affine_warp(img_l.cpu(), trans.cpu(), size),
                   affine_warp(img_r.cpu(), trans.cpu(), size), "cpu"),
        proj.cpu().numpy(), outs[0][0], "raw serving vs CPU", t0)
    times = {}
    rng = np.random.RandomState(SEED + 7)
    for pairs in (1, TIMING_PAIRS):
        raw = raw_request(cache, 0, pairs, cfg, dev)
        pre_l, pre_r, _ = stereo_request(rng, pairs, size[0])
        pre = (torch.as_tensor(pre_l, device=dev),
               torch.as_tensor(pre_r, device=dev), raw[2])
        row = {"raw_ms": host_ms(lambda: inf.predict_batch(*raw)),
               "prewarped_ms": host_ms(lambda: inf.predict_batch(*pre))}
        if pairs == TIMING_PAIRS:
            for k, args in (("raw", raw), ("prewarped", pre)):
                p = profile_calls(lambda: inf.predict_batch(*args), calls=3)
                row[f"{k}_device_ms"] = p["device_ms"]
                row[f"{k}_launches"] = p["launches"]
        times[pairs] = row
        print(f"# raw serving batch {pairs}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in row.items()))
    return {"launches": launches, "vs_cpu": vs_cpu, "times": times}


# --------------------------------------------------------------- host data

TREE_MOVEMENTS, TREE_TRAIN_FRAMES = ("HipHop", "Jazz"), 45   # 90 pairs
TREE_VALID_FRAMES = 40            # valid/HipHop: 2 batches, 24 rows padded
NAN_JOINT_EVERY = 7               # one NaN joint every 7th frame
DECODE_THREADS = (1, 4)
# A decoded frame against the frame the tree rendered: JPEG at quality 95
# with 4:2:0 chroma (cv2's and PIL's default) leaves at most 32-34 levels
# at the dots' coloured edges and 0.017-0.019 levels on average on these
# frames (cv2 and PIL alike); a frame of another pose or with swapped
# channels breaks one of the two bounds.
JPEG_MAX_TOL, JPEG_MEAN_TOL = 48, 0.05
EVAL_MOVEMENT = "HipHop"
EVAL_CPU_PAIRS = 4                # rows of one eval batch also run on the CPU
EVAL_REL_TOL = 1e-3               # the cache modes' MPJPEs agree
# evaluate_movement's cache budgets, in frames of the 80 (40 pairs) of
# valid/HipHop: whole, half (20 pairs: an index batch of 20, then 20
# streamed), 64 (32 pairs: the full cache's first batch, then its second
# streamed, so every batch holds the frames it holds with the whole
# movement resident) and none
EVAL_MODES = (("full cache", 80), ("partial cache", 40),
              ("partial cache, batch-aligned", 64), ("streamed", 0))


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reset_counts():
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    return counters


def read_counts(counters):
    sync()
    return {k: c.launches for k, c in counters.items()}


def require_counts(got, steps, k1, k2, k3, what):
    want = {"soft_argmax": k1 * steps, "soft_argmax_bwd": k2 * steps,
            "fused_bottleneck": k3 * steps}
    got = {k: got[k] for k in want}
    require(got == want, f"{what}: {steps} steps or batches launched "
                         f"K1/K2/K3 {got}, not {want}")


def write_trees(root):
    """The MADS tree at MADS's frame size (train: 2 movements x 45 frames;
    valid: 1 x 40; a NaN joint every 7th frame) and the default MPII tree
    (frames of mixed sizes), written by the port's data/synthetic.py. Then
    the decode route, its rate over the MADS frames with 1 and 4 threads,
    and one decoded frame of each view against the rendered source."""
    import glob
    import os
    from concurrent.futures import ThreadPoolExecutor
    from fast3dhpe_tpu_torch.data import native_jpeg, synthetic
    from fast3dhpe_tpu_torch.data.loader import _BatchDecoder
    t0 = time.perf_counter()
    mads, mpii = os.path.join(root, "mads"), os.path.join(root, "mpii")
    synthetic.make_synthetic_mads(
        mads, n_frames=TREE_TRAIN_FRAMES, movements=TREE_MOVEMENTS,
        img_w=RAW_W, img_h=RAW_H, splits=("train",),
        nan_joint_every=NAN_JOINT_EVERY)
    synthetic.make_synthetic_mads(
        mads, n_frames=TREE_VALID_FRAMES, movements=(EVAL_MOVEMENT,),
        img_w=RAW_W, img_h=RAW_H, splits=("valid",),
        nan_joint_every=NAN_JOINT_EVERY)
    synthetic.make_synthetic_mpii(mpii)
    write_s = time.perf_counter() - t0
    paths = sorted(glob.glob(os.path.join(mads, "**", "*.jpg"),
                             recursive=True))
    want = 2 * (len(TREE_MOVEMENTS) * TREE_TRAIN_FRAMES + TREE_VALID_FRAMES)
    require(len(paths) == want, f"the MADS tree holds {len(paths)} JPEGs, "
                                f"not {want}")
    rates = {}
    for threads in DECODE_THREADS:
        with ThreadPoolExecutor(threads) as pool:
            dec = _BatchDecoder(pool)
            t = time.perf_counter()
            if dec.route == "native":
                frames = native_jpeg.decode_batch(paths, RAW_H, RAW_W,
                                                  n_threads=threads)
            else:
                frames = dec(paths)
            rates[threads] = len(paths) / (time.perf_counter() - t)
        route = dec.name
    require(all(f.shape == (RAW_H, RAW_W, 3) for f in frames),
            "a decoded frame is not 768x1024x3")
    calibs = synthetic.synthetic_rig(RAW_W, RAW_H)
    err = {}
    for cam, view in (("cam_left", "left"), ("cam_right", "right")):
        src = synthetic._render_frame(synthetic._project(
            synthetic.synthetic_pose(0.0), calibs[cam]), RAW_W, RAW_H)
        path = os.path.join(mads, "train", TREE_MOVEMENTS[0], "Take_1",
                            view, "0000.jpg")
        got = frames[paths.index(path)].astype(np.int16)
        d = np.abs(got - src)
        err[view] = {"max": int(d.max()), "mean": float(d.mean())}
        require(d.max() <= JPEG_MAX_TOL and d.mean() <= JPEG_MEAN_TOL,
                f"decoded {path} differs from its rendered frame: {err[view]}"
                f" (bounds {JPEG_MAX_TOL} max, {JPEG_MEAN_TOL} mean)")
    print(f"# trees: {len(paths)} MADS JPEGs of {RAW_H}x{RAW_W} and an MPII "
          f"tree written in {write_s:.1f} s; decoder {route!r} (native: "
          f"{native_jpeg.build_error() or 'built'}); decode "
          + ", ".join(f"{rates[k]:.1f} frames/s with {k} thread"
                      f"{'s' if k > 1 else ''}" for k in DECODE_THREADS)
          + f"; frame 0 vs its render {err} (bounds {JPEG_MAX_TOL} max, "
          f"{JPEG_MEAN_TOL} mean)")
    return mads, mpii, {"write_s": write_s, "decoder": route,
                        "native_build": native_jpeg.build_error() or "built",
                        "decode_fps": rates, "jpeg_vs_render": err}


def tree_cfg(path, root, budget):
    """configs/<path> with DATASET.ROOT at the tree and a device-cache
    budget."""
    from fast3dhpe_tpu_torch.config import load_config
    cfg = load_config(path)
    cfg.DATASET.ROOT = root
    cfg.DATASET.DEVICE_CACHE_BYTES = budget
    return cfg


def _epoch_metrics(m, cfg, use_3d, what):
    m = {k: float(v) for k, v in m.items()}
    require(all(np.isfinite(v) for v in m.values()),
            f"{what}: non-finite metrics {m}")
    if use_3d:
        want = m["loss_2d"] + cfg.TRAIN.LOSS_3D_WEIGHT * m["loss_3d"]
        require(abs(m["loss"] - want) <= 1e-6 * abs(want),
                f"{what}: loss {m['loss']} is not loss_2d + "
                f"{cfg.TRAIN.LOSS_3D_WEIGHT} loss_3d = {want}")
    else:
        require(m["loss"] == m["loss_2d"],
                f"{what}: warmup loss {m['loss']} != loss_2d {m['loss_2d']}")
    return m


def run_loader_train(mads, dev):
    """CDRNet-101 trained from the JPEG tree: load_data -> Stereo3DLoader.
    stacked_epoch -> make_train_epoch_cdr with the whole tree on the card
    (a warmup and a use_3d epoch), then per-batch iteration through the
    upload lane with half the tree on the card (two use_3d epochs)."""
    from fast3dhpe_tpu_torch.data import Stereo3DLoader, load_data
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.train.state import TrainState
    from fast3dhpe_tpu_torch.train.steps import make_train_epoch_cdr
    t0 = time.perf_counter()
    n_pairs = len(TREE_MOVEMENTS) * TREE_TRAIN_FRAMES
    tree_bytes = 2 * n_pairs * RAW_H * RAW_W * 3
    cfg = tree_cfg("configs/mads_3d.yaml", mads, tree_bytes)
    B = cfg.TRAIN.BATCH_SIZE
    steps = -(-n_pairs // B)
    loader, valid = load_data(cfg, seed=SEED, device=dev)
    valid.close()
    t = time.perf_counter()
    cache, xs, e = loader.stacked_epoch()
    sync()
    build_s = time.perf_counter() - t
    require(not cache.partial and cache.frames.device.type == dev.type
            and tuple(cache.frames.shape) == (2 * n_pairs, RAW_H, RAW_W, 3),
            f"the full cache holds {tuple(cache.frames.shape)}")
    shapes = {"idx_l": (steps, B), "idx_r": (steps, B),
              "trans": (steps, B, 2, 3), "P_l": (steps, B, 4, 4),
              "P_r": (steps, B, 4, 4), "pose_3d": (steps, B, 19, 3),
              "joints_vis": (steps, B, 19), "row_valid": (steps, B)}
    require({k: v.shape for k, v in xs.items()} == shapes,
            f"stacked_epoch shapes {({k: v.shape for k, v in xs.items()})}")
    require(xs["row_valid"].sum() == n_pairs
            and xs["row_valid"][-1].sum() == n_pairs - (steps - 1) * B,
            f"row_valid sums to {xs['row_valid'].sum(1)}")
    recs = loader.records
    for rec in (recs[0], recs[n_pairs // 2], recs[-1]):
        for key in ("image_left", "image_right"):
            row = int(cache.rows([rec[key]])[0])
            require(torch.equal(cache.frames[row].cpu(), torch.from_numpy(
                loader._decode_paths([rec[key]])[0])),
                f"cache row {row} is not the decoded {rec[key]}")
    model = seeded_train_model(cfg).to(dev)
    dxs = on_card(xs, dev)
    first = pipeline_batch(cache.frames, dxs, 0, cfg, train=True)
    first["row_valid"] = dxs["row_valid"][0]
    calibrate_train_head(model, first)
    state = TrainState.create(model, cfg, steps_per_epoch=steps)
    epoch = make_train_epoch_cdr(
        make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT),
        cfg.MODEL.IMAGE_SIZE, occlusion=cfg.DATASET.OCCLUSION,
        loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
        num_joints=cfg.MODEL.NUM_JOINTS)
    full = {"cache_build_s": build_s, "decoder": loader.decoder_name,
            "epochs": []}
    launches = {k: 0 for k in kernel_counters()}
    for use_3d in (False, True):
        if use_3d:
            cache, xs, e = loader.stacked_epoch()
        counters = reset_counts()
        t = time.perf_counter()
        m = epoch(state, cache.frames, xs, SEED * 10007 + e, use_3d)
        sync()
        wall = (time.perf_counter() - t) * 1e3
        n = read_counts(counters)
        require_counts(n, steps, 1, 1, 0, f"full-cache epoch {e}")
        m = _epoch_metrics(m, cfg, use_3d, f"full-cache epoch {e}")
        full["epochs"].append({"use_3d": use_3d, "wall_ms": wall,
                               "step_ms": wall / steps, "metrics": m})
        launches = {k: launches[k] + n[k] for k in n}
        print(f"# loader training, full cache, epoch {e} use_3d={use_3d}: "
              f"{steps} steps, {wall / steps:.1f} ms a step, launches {n}, "
              f"summed " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))
    full["launches"] = launches
    loader.close()
    del loader, cache, xs, dxs, first
    torch.cuda.empty_cache()

    # half the tree on the card: partial cache and the upload lane
    cfg.DATASET.DEVICE_CACHE_BYTES = tree_bytes // 2
    loader = Stereo3DLoader(cfg, cfg.DATASET.TRAIN_SET, seed=SEED,
                            device_cache_bytes=tree_bytes // 2, device=dev)
    t = time.perf_counter()
    cache = loader.ensure_device_cache()
    sync()
    require(cache is not None and cache.partial
            and cache.frames.shape[0] == n_pairs,
            f"the half-budget cache holds {cache and cache.frames.shape} "
            f"(partial {cache and cache.partial})")
    try:
        loader.stacked_epoch()
        refused = "nothing"
    except RuntimeError as err:
        refused = str(err)
    require("FULL device cache" in refused,
            f"stacked_epoch on a partial cache raised {refused}")
    partial = {"cache_build_s": time.perf_counter() - t,
               "resident_frames": int(cache.frames.shape[0]), "epochs": []}
    step = train_step_fn(cfg)
    everyone = sorted(r["image_left"] for r in loader.records)
    launches = {k: 0 for k in launches}
    for _ in range(2):
        counters = reset_counts()
        times, rv = [], 0.0
        t = time.perf_counter()
        for batch in loader:
            m = step(state, batch, True)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
            rv += float(batch["row_valid"].sum())
            t = time.perf_counter()
        n = read_counts(counters)
        require_counts(n, steps, 1, 1, 0, "partial-cache epoch")
        log = loader.batch_log
        lanes = {(b["rows"], b["uploaded"]) for b in log}
        require(len(log) == steps and len(lanes) == 1,
                f"partial-cache lanes (cached rows, uploaded frames) a batch "
                f"{[(b['rows'], b['uploaded']) for b in log]}")
        seen = sorted(p for b in log for p in b["valid"])
        require(seen == everyone and rv == n_pairs,
                f"a partial-cache epoch covered {len(seen)} records "
                f"({len(set(seen))} distinct), row_valid {rv}, not each of "
                f"the {n_pairs} once")
        m = _epoch_metrics({k: v.item() for k, v in m.items()}, cfg, True,
                           "partial-cache step")
        rec = {"lanes": {"cached_rows": log[0]["rows"],
                         "uploaded_frames": log[0]["uploaded"]},
               "step_ms": times, "upload_mb": [b["upload_bytes"] / 1e6
                                               for b in log],
               "decode_ms": [b["decode_ms"] for b in log],
               "last_metrics": m}
        partial["epochs"].append(rec)
        launches = {k: launches[k] + n[k] for k in n}
        print(f"# loader training, partial cache ({cache.frames.shape[0]} of "
              f"{2 * n_pairs} frames resident): lanes {rec['lanes']}, steps "
              f"{[round(x, 1) for x in times]} ms, upload "
              f"{[round(x, 1) for x in rec['upload_mb']]} MB and host decode "
              f"{[round(x, 1) for x in rec['decode_ms']]} ms a step, "
              f"launches {n}")
    partial["launches"] = launches
    partial["step_ms"] = statistics.median(partial["epochs"][-1]["step_ms"])
    loader.close()
    print(f"# loader training: full-cache step "
          f"{full['epochs'][-1]['step_ms']:.1f} ms vs partial-cache step "
          f"{partial['step_ms']:.1f} ms (upload "
          f"{statistics.median(partial['epochs'][-1]['upload_mb']):.1f} MB, "
          f"host decode "
          f"{statistics.median(partial['epochs'][-1]['decode_ms']):.1f} ms a "
          f"step, in the prefetch thread); phase "
          f"{time.perf_counter() - t0:.1f} s")
    return {"full": full, "partial": partial}


def seeded_pose_resnet(cfg, dev):
    from fast3dhpe_tpu_torch.models.layers import init_weights
    from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
    model = PoseResNet.from_config(cfg)
    init_weights(model, torch.Generator().manual_seed(SEED))
    return model.to(dev)


def run_loader_2d(mads, mpii, dev):
    """PoseResNet-101 from the trees: Mono2DLoader on MPII (host batches
    zero-padded to multiples of 128, warped on the card; two epochs of one
    step) and on MADS_2d (one stacked epoch from the full cache)."""
    from fast3dhpe_tpu_torch.data import Mono2DLoader
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.train.state import TrainState
    from fast3dhpe_tpu_torch.train.steps import (make_train_epoch_2d,
                                                 make_train_step_2d)
    t0 = time.perf_counter()
    out = {}
    cfg = tree_cfg("configs/mpii.yaml", mpii, 1 << 30)
    loader = Mono2DLoader(cfg, cfg.DATASET.TRAIN_SET, seed=SEED,
                          device_cache_bytes=cfg.DATASET.DEVICE_CACHE_BYTES,
                          device=dev)
    state = TrainState.create(seeded_pose_resnet(cfg, dev), cfg,
                              steps_per_epoch=len(loader))
    loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT, layout="NHWC")
    step = make_train_step_2d(loss)
    counters = reset_counts()
    mets, shapes = [], set()
    for _ in range(2):
        for batch in loader:
            mets.append({k: v.item() for k, v in step(state, batch).items()})
        shapes |= {b["frame_shape"] for b in loader.batch_log}
    n = read_counts(counters)
    require(not loader.device_cached, "MPII's mixed sizes built a cache")
    require(all(s[0] % 128 == 0 and s[1] % 128 == 0 for s in shapes),
            f"MPII host batches of {shapes}, not multiples of 128")
    require(len(mets) == 2 * len(loader) and all(np.isfinite(v) for m in mets
                                   for v in m.values()),
            f"MPII steps: {mets}")
    require_counts(n, len(mets), 0, 0, 0, "MPII steps")
    out["mpii"] = {"steps": mets, "padded_shapes": sorted(shapes),
                   "launches": n, "decoder": loader.decoder_name}
    loader.close()
    print(f"# 2D MPII: {len(mets)} PoseResNet-101 steps from host batches "
          f"padded to {sorted(shapes)}, launches {n}, "
          + "; ".join(", ".join(f"{k} {v:.4g}" for k, v in m.items())
                      for m in mets))
    del state, step
    torch.cuda.empty_cache()

    cfg = tree_cfg("configs/mads_2d.yaml", mads, 1 << 30)
    loader = Mono2DLoader(cfg, cfg.DATASET.TRAIN_SET, seed=SEED,
                          device_cache_bytes=cfg.DATASET.DEVICE_CACHE_BYTES,
                          device=dev)
    cache, xs, _ = loader.stacked_epoch()
    steps = xs["idx"].shape[0]
    state = TrainState.create(seeded_pose_resnet(cfg, dev), cfg,
                              steps_per_epoch=steps)
    epoch = make_train_epoch_2d(
        make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT, layout="NHWC"),
        cfg.MODEL.IMAGE_SIZE, cfg.MODEL.EXTRA.HEATMAP_SIZE,
        cfg.MODEL.EXTRA.SIGMA)
    counters = reset_counts()
    t = time.perf_counter()
    m = {k: float(v) for k, v in epoch(state, cache.frames, xs).items()}
    sync()
    wall = (time.perf_counter() - t) * 1e3
    n = read_counts(counters)
    require(all(np.isfinite(v) for v in m.values()), f"MADS_2d epoch {m}")
    require(xs["row_valid"].sum() == len(loader.records),
            f"MADS_2d row_valid sums to {xs['row_valid'].sum()}")
    require_counts(n, steps, 0, 0, 0, "MADS_2d epoch")
    out["mads_2d"] = {"steps": steps, "step_ms": wall / steps, "metrics": m,
                      "launches": n}
    loader.close()
    print(f"# 2D MADS_2d: a stacked epoch of {steps} PoseResNet-101 steps "
          f"from the full cache, {wall / steps:.1f} ms a step, launches {n}, "
          f"summed " + ", ".join(f"{k} {v:.4g}" for k, v in m.items())
          + f"; phase {time.perf_counter() - t0:.1f} s")
    out["launches"] = {k: out["mpii"]["launches"][k] + n[k] for k in n}
    return out


def moved_rows(inf, batch, lo, size):
    """Frames lo..B-1 of a streamed batch, run in their rows and again in
    other batches of B: the same batch; the half cache's second batch
    (those frames at rows 0.., every other row a copy of the last); the
    batch rolled so that they take rows 0.. beside the same other frames;
    and their own rows with every other row a copy of the last. For each,
    how far their heatmaps (of max|heatmap|), pred_2d (px) and pred_3d
    (relative) move, with the fused blocks (K3) and with cuDNN alone."""
    from fast3dhpe_tpu_torch.models.resnet import Bottleneck
    from fast3dhpe_tpu_torch.ops.warp import affine_warp
    B = len(batch["proj"])
    k = B - lo
    layouts = {  # name -> (the batch's frame at each row, rows of lo..B-1)
        "the same batch": (list(range(B)), list(range(lo, B))),
        "other rows and neighbours": (list(range(lo, B)) + [B - 1] * lo,
                                      list(range(k))),
        "other rows, same neighbours": (list(range(lo, B)) + list(range(lo)),
                                        list(range(k))),
        "same rows, other neighbours": ([B - 1] * lo + list(range(lo, B)),
                                        list(range(lo, B)))}
    blocks = [m for m in inf.model.modules() if isinstance(m, Bottleneck)]
    fused = [b.fused_inference for b in blocks]

    def run(order):
        idx = torch.as_tensor(order, device=batch["img_l"].device)
        trans = torch.as_tensor(batch["trans"][order], device=idx.device)
        imgs = normalized(affine_warp(batch["img_l"][idx], trans, size),
                          affine_warp(batch["img_r"][idx], trans, size),
                          idx.device)
        with torch.inference_mode():
            kp, p3, hm = inf.model(imgs, torch.as_tensor(
                batch["proj"][order], device=idx.device),
                return_heatmaps=True)
        return hm.float(), kp, p3

    out = {name: {} for name in layouts}
    try:
        for mode, on in (("fused", fused), ("cudnn", [False] * len(blocks))):
            for b, f in zip(blocks, on):
                b.fused_inference = f
            hm0, kp0, p30 = (o[lo:] for o in run(list(range(B))))
            for name, (order, rows) in layouts.items():
                hm, kp, p3 = (o[rows] for o in run(order))
                out[name][mode] = {
                    "hm": float((hm - hm0).abs().max() / hm0.abs().max()),
                    "kp_px": float((kp - kp0).abs().max()),
                    "p3_rel": float(((p3 - p30).norm(dim=-1)
                                     / p30.norm(dim=-1)).max())}
    finally:
        for b, f in zip(blocks, fused):
            b.fused_inference = f
    return out


def run_movement_eval(inf, cpu_inf, mads, cfg, dev):
    """evaluate_movement over valid/HipHop with the movement whole on the
    card, half of it, a batch-aligned part, and streamed: one K1 and four
    K3 launches a batch; MPJPE2D the same in every mode, MPJPE3D where the
    batches hold the same frames (the DLT of untrained keypoints turns the
    bf16 forward's dependence on a batch's other rows into a visible 3D
    difference; measured below on the same frames at other rows of a
    batch); frames/s of a call with the movement already held (the first
    call builds the cache). One batch's errors against the CPU."""
    import os
    from fast3dhpe_tpu_torch.apps.eval_loop import ground_truth
    from fast3dhpe_tpu_torch.data import LoadMADSData
    from fast3dhpe_tpu_torch.ops.warp import affine_warp
    t0 = time.perf_counter()
    data = os.path.join(mads, cfg.DATASET.TEST_SET)
    size = tuple(cfg.MODEL.IMAGE_SIZE)
    B = cfg.TEST.BATCH_SIZE
    batches = -(-TREE_VALID_FRAMES // B)
    modes, launches = {}, {}
    for mode, frames in EVAL_MODES:
        cache_bytes = frames * RAW_H * RAW_W * 3
        stream = LoadMADSData(data, size, EVAL_MOVEMENT, device=dev)
        counters = reset_counts()
        t = time.perf_counter()
        e2, e3 = inf.evaluate_movement(stream, B, cache_bytes)
        first_s = time.perf_counter() - t
        n = read_counts(counters)
        require_counts(n, batches, 1, 0, 4, f"evaluate_movement, {mode}")
        cache = stream.build_device_cache(cache_bytes) if cache_bytes else None
        require((cache is None) == (cache_bytes == 0)
                and (cache is None or cache.partial
                     == mode.startswith("partial")),
                f"{mode}: the stream's cache is {cache}")
        t = time.perf_counter()
        again = inf.evaluate_movement(stream, B, cache_bytes)
        second_s = time.perf_counter() - t
        modes[mode] = {"mpjpe_2d": e2, "mpjpe_3d": e3,
                       "again": dict(zip(("mpjpe_2d", "mpjpe_3d"), again)),
                       "first_call_s": first_s,
                       "frames_per_s": TREE_VALID_FRAMES / second_s,
                       "decoder": stream.decoder_name}
        launches[mode] = n
        print(f"# movement eval, {mode}: MPJPE2D {e2:.6g} px, MPJPE3D "
              f"{e3:.6g} mm; {TREE_VALID_FRAMES} frames in {second_s:.3f} s "
              f"({TREE_VALID_FRAMES / second_s:.1f} frames/s; first call, "
              f"which builds the cache, {first_s:.3f} s); launches {n}")
    ref = modes["full cache"]
    for mode, r in modes.items():
        for k in ("mpjpe_2d", "mpjpe_3d"):
            if k == "mpjpe_3d" and mode == "partial cache":
                continue        # other batches: reported, held in 2D
            for got in (r[k], r["again"][k]):
                require(np.isfinite(got) and abs(got - ref[k])
                        <= EVAL_REL_TOL * abs(ref[k]),
                        f"{mode} {k} {got} differs from the full cache's "
                        f"{ref[k]} beyond {EVAL_REL_TOL} relative")

    half = modes["partial cache"]
    rel3 = abs(half["mpjpe_3d"] - ref["mpjpe_3d"]) / abs(ref["mpjpe_3d"])
    stream = LoadMADSData(data, size, EVAL_MOVEMENT, device=dev)
    batch = next(iter(stream.batches(B, device_warp=True)))
    moved = moved_rows(inf, batch, TREE_VALID_FRAMES // 2, size)
    print(f"# movement eval: MPJPE3D of the half cache differs by {rel3:.3g} "
          f"relative from the whole cache's. Frames "
          f"{TREE_VALID_FRAMES // 2}-{B - 1} of the whole cache's first "
          f"batch run in other batches of {B} (heatmaps max of max|hm|, "
          f"pred_2d px, pred_3d max relative; fused / cuDNN only): "
          + "; ".join(f"{k} " + " / ".join(
              f"{v[m]['hm']:.3g}, {v[m]['kp_px']:.3g}, {v[m]['p3_rel']:.3g}"
              for m in ("fused", "cudnn")) for k, v in moved.items()))
    modes["partial cache"]["mpjpe_3d_rel_to_full"] = rel3
    modes["partial cache"]["rows_moved"] = moved

    # one streamed batch's first rows on the card and on the CPU
    k = EVAL_CPU_PAIRS
    img_l, img_r = batch["img_l"][:k], batch["img_r"][:k]
    trans, proj = batch["trans"][:k], batch["proj"][:k]
    pose, vis = ground_truth(batch["pose_3d"][:k])
    with torch.inference_mode():
        kp, p3 = inf.predict_batch(img_l, img_r, proj, trans=trans)
        e2, e3 = inf.predict_eval(img_l, img_r, trans, proj, pose, vis)
        c2, c3 = cpu_inf.predict_eval(img_l.cpu(), img_r.cpu(), trans, proj,
                                      pose, vis)
        r2, r3 = cpu_inf.eval_errors(kp.cpu(), p3.cpu(), proj, pose, vis)
    vs_cpu = check_vs_cpu(
        inf.model, cpu_inf.model,
        normalized(affine_warp(img_l, trans, size),
                   affine_warp(img_r, trans, size), dev),
        normalized(affine_warp(img_l.cpu(), trans, size),
                   affine_warp(img_r.cpu(), trans, size), "cpu"),
        proj, kp, "movement eval vs CPU", t0)
    metric = max(float(((a.cpu() - b).abs() / b.abs()).max())
                 for a, b in ((e2, r2), (e3, r3)))
    vs_cpu.update(metric_rel=metric,
                  e2_px=float((e2.cpu() - c2).abs().max()),
                  e3_rel=float(((e3.cpu() - c3).abs() / c3.abs()).median()))
    print(f"# movement eval vs CPU ({k} pairs): the card's errors vs the "
          f"CPU's metric on the card's predictions {metric:.3g} relative; vs "
          f"the CPU run: MPJPE2D max {vs_cpu['e2_px']:.3g} px, MPJPE3D "
          f"median {vs_cpu['e3_rel']:.3g} relative; phase "
          f"{time.perf_counter() - t0:.1f} s")
    require(metric <= 1e-5, f"the card's per-sample errors differ from the "
                            f"CPU's metric of its predictions by {metric}")
    # the errors of pred_2d within 2 px (check_vs_cpu) move by as much
    require(vs_cpu["e2_px"] < 2.0,
            f"MPJPE2D differs from the CPU run by {vs_cpu['e2_px']} px")
    return {"modes": modes, "launches": launches, "vs_cpu": vs_cpu}


# -------------------------------------------------------------------- apps

APPS_EPOCHS_2D = 2                # `train`: PoseResNet-101, WARMUP 0
APPS_EPOCHS_CDR, APPS_WARMUP = 3, 1   # `train_cdr`: best.pth after epoch 3
APPS_LR_STEP = 3                  # LR / 10 from epoch 4: the resumed epoch
NEAR_TIE = 1e-3                   # of a heatmap's range: an argmax near-tie
GEOMETRY_TOL = 1e-3               # of max|CPU|: a DLT on the card vs the CPU


class EpochTimes:
    """A logging handler that keeps the seconds of each 'epoch ...' line
    the training loops log (its last argument)."""

    def __init__(self):
        import logging
        self.handler = logging.Handler()
        self.handler.emit = self._emit
        self.seconds = []
        self.logger = logging.getLogger("fast3dhpe_tpu_torch")

    def _emit(self, rec):
        if str(rec.msg).startswith("epoch "):
            self.seconds.append(float(rec.args[-1]))

    def __enter__(self):
        from fast3dhpe_tpu_torch.utils.logging import setup_logger
        setup_logger().addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def app_config(src, path, root, **sections):
    """configs/<src> with DATASET.ROOT at the tree and the given keys of
    each section replaced, written to path for an app's --config_path."""
    import yaml
    with open(src) as f:
        d = yaml.safe_load(f)
    d["DATASET"]["ROOT"] = root
    for name, keys in sections.items():
        d[name].update(keys)
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def digests(d):
    import hashlib
    import os
    return {n: hashlib.sha256(open(os.path.join(d, n), "rb").read())
            .hexdigest() for n in sorted(os.listdir(d))}


def counted(fn, *args):
    """fn(*args) with the kernels' counts set to 0 just before and read
    just after; (result, launches, wall s)."""
    counters = reset_counts()
    t = time.perf_counter()
    out = fn(*args)
    sync()
    return out, read_counts(counters), time.perf_counter() - t


def _finite_history(h, what):
    bad = {k: v for k, v in h.items() if not np.isfinite(v).all()}
    require(not bad, f"{what}: non-finite history {bad}")


def run_train_apps(mads, work, dev):
    """a-d: `train` (PoseResNet-101, loader iteration), `train_cdr`
    (CDRNet-101 from a's encoder, stacked epochs from the card), the
    overwrite guard, and `train_cdr --resume` as a subprocess."""
    import logging
    import os
    import re
    from fast3dhpe_tpu_torch.apps import train, train_cdr
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.models.poseresnet import PoseResNet
    from fast3dhpe_tpu_torch.train import checkpoint, loop2d, loop_cdr
    from fast3dhpe_tpu_torch.train.state import TrainState
    weights = os.path.join(work, "weights")
    n_pairs = len(TREE_MOVEMENTS) * TREE_TRAIN_FRAMES
    out = {}

    # a. 2D training, from JPEGs through the loader's iteration
    cfg2 = app_config("configs/mads_2d.yaml", os.path.join(work, "2d.yaml"),
                      mads, MODEL={"PRETRAINED": ""},
                      TRAIN={"EPOCH": APPS_EPOCHS_2D, "WARMUP": 0})
    with EpochTimes() as et:
        h2, n, wall = counted(train.main, [
            "--config_path", cfg2, "--overwrite", "--weights_root", weights,
            "--device", dev.type])
    require_counts(n, 1, 0, 0, 0, "the train app")
    _finite_history(h2, "the train app")
    require(len(h2["val_acc"]) == APPS_EPOCHS_2D, f"train app history {h2}")
    dir2 = os.path.join(weights, load_config(cfg2).MODEL.NAME)
    a_latest = os.path.join(dir2, "latest.pth")
    a_sd = checkpoint.load_variables(a_latest)
    PoseResNet.from_config(load_config(cfg2)).load_state_dict(a_sd,
                                                              strict=True)
    out["train"] = {"epoch_s": et.seconds, "wall_s": wall, "launches": n,
                    "history": h2}
    print(f"# apps a, train (PoseResNet-101, {APPS_EPOCHS_2D} epochs of "
          f"loader iteration): epochs {[round(s, 2) for s in et.seconds]} s, "
          f"wall {wall:.1f} s, launches {n}, val acc {h2['val_acc']}")

    # b. CDR training from a's encoder, stacked epochs from the card
    tree_bytes = 2 * n_pairs * RAW_H * RAW_W * 3
    cdr = dict(MODEL={"PRETRAINED": a_latest},
               DATASET={"DEVICE_CACHE_BYTES": tree_bytes},
               TRAIN={"EPOCH": APPS_EPOCHS_CDR, "WARMUP": APPS_WARMUP,
                      "LR_STEP": [APPS_LR_STEP]})
    cfg3 = app_config("configs/mads_3d.yaml", os.path.join(work, "3d.yaml"),
                      mads, **cdr)
    argv3 = ["--config_path", cfg3, "--weights_root", weights, "--device",
             dev.type]
    cfg = load_config(cfg3)
    start, load_pretrained = {}, loop_cdr._load_pretrained

    def spy(model, config, logger):
        load_pretrained(model, config, logger)
        start.update({k: v.detach().clone()
                      for k, v in model.state_dict().items()})

    loop_cdr._load_pretrained = spy
    try:
        with EpochTimes() as et:
            h3, n, wall = counted(train_cdr.main, argv3 + ["--overwrite"])
    finally:
        loop_cdr._load_pretrained = load_pretrained
    fresh = loop_cdr._init_model(cfg, SEED).state_dict()
    wrong = [k for k, v in start.items()
             if not torch.equal(v, a_sd[k] if k.startswith("encoder.")
                                else fresh[k])]
    require(not wrong and len(start) == len(fresh),
            f"before the first step, {len(wrong)} tensors were neither a's "
            f"encoder nor a fresh seeded init: {wrong[:5]}")
    steps = -(-n_pairs // cfg.TRAIN.BATCH_SIZE)
    evals = -(-TREE_VALID_FRAMES // cfg.TEST.BATCH_SIZE)
    want = {"soft_argmax": APPS_EPOCHS_CDR * (steps + evals),
            "soft_argmax_bwd": APPS_EPOCHS_CDR * steps,
            "fused_bottleneck": 0}
    require(n == want, f"the train_cdr app launched {n}, not {want}")
    _finite_history(h3, "the train_cdr app")
    dir3 = os.path.join(weights, cfg.MODEL.NAME)
    files = digests(dir3)
    require(set(files) == {"best.pth", "latest.pth", checkpoint.OPT_FILE},
            f"the train_cdr app wrote {sorted(files)}")
    best = checkpoint.load_variables(os.path.join(dir3, "best.pth"))
    # best only after the warmup (`epoch > WARMUP`): the last epoch here
    require(checkpoint.weights_step(best) == APPS_EPOCHS_CDR * steps,
            f"best.pth is of step {checkpoint.weights_step(best)}")
    saved = torch.load(os.path.join(dir3, checkpoint.OPT_FILE),
                       weights_only=True)
    out["train_cdr"] = {"epoch_s": et.seconds, "wall_s": wall,
                        "launches": n, "history": h3}
    print(f"# apps b, train_cdr (CDRNet-101 from a's encoder, "
          f"{APPS_EPOCHS_CDR} epochs, WARMUP {APPS_WARMUP}, stacked from the "
          f"card): epochs {[round(s, 2) for s in et.seconds]} s, wall "
          f"{wall:.1f} s, launches {n}, val MPJPE3D {h3['val_mpjpe_3d']}, "
          f"best.pth of step {checkpoint.weights_step(best)}; the merged "
          f"encoder is a's, the rest a fresh seeded init")

    # c. the overwrite guard
    try:
        train_cdr.main(argv3)
        refused = None
    except FileExistsError as err:
        refused = str(err)
    require(refused and "--overwrite" in refused,
            f"train_cdr without --overwrite raised {refused}")
    require(digests(dir3) == files, "the refused run changed the files")

    # d. resume, as a subprocess through the module's entry point
    cfg4 = app_config("configs/mads_3d.yaml", os.path.join(work, "4d.yaml"),
                      mads, **dict(cdr, TRAIN=dict(cdr["TRAIN"],
                                                   EPOCH=APPS_EPOCHS_CDR + 1)))
    model = CDRNet.from_config(cfg).to(dev)
    state = TrainState.create(model, cfg, steps)
    t = time.perf_counter()
    step, best_metric = loop2d._restore_state(dir3, state,
                                              logging.getLogger("chip"))
    sync()
    resume_ms = (time.perf_counter() - t) * 1e3
    loaded = state.optimizer_state_dict()
    same = all(torch.equal(v.cpu(), saved["optimizer"]["state"][i][k])
               for i, s in loaded["state"].items() for k, v in s.items())
    require(same and step == saved["step"] == APPS_EPOCHS_CDR * steps
            and loaded["param_groups"] == saved["optimizer"]["param_groups"],
            "the optimizer state a resume loads differs from the saved one")
    times = checkpoint_times(state, work)
    del model, state, loaded
    torch.cuda.empty_cache()
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fast3dhpe_tpu_torch.apps.train_cdr",
         "--config_path", cfg4, "--resume", "--weights_root", weights,
         "--device", dev.type], capture_output=True, text=True, timeout=900)
    sub_s = time.perf_counter() - t
    require(proc.returncode == 0,
            f"train_cdr --resume exited {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    epochs = re.findall(r"epoch (\d+)/(\d+)", proc.stderr)
    after = torch.load(os.path.join(dir3, checkpoint.OPT_FILE),
                       weights_only=True)
    adam = {float(s["step"]) for s in after["optimizer"]["state"].values()}
    lr = cfg.TRAIN.LR * cfg.TRAIN.LR_FACTOR
    require(epochs == [(str(APPS_EPOCHS_CDR + 1), str(APPS_EPOCHS_CDR + 1))]
            and f"Resumed from step {step}" in proc.stderr
            and after["step"] == step + steps
            and adam == {float(step + steps)}
            and after["optimizer"]["param_groups"][0]["lr"] == lr,
            f"the resumed run logged epochs {epochs}, reached step "
            f"{after['step']}, Adam steps {adam}, lr "
            f"{after['optimizer']['param_groups'][0]['lr']} (want one epoch "
            f"from step {step}, Adam {step + steps}, lr {lr})")
    improved = after["best_metric"] < best_metric
    now = digests(dir3)
    require((now["best.pth"] != files["best.pth"]) == improved,
            f"best.pth {'unchanged' if improved else 'changed'} while "
            f"MPJPE3D went {best_metric} -> {after['best_metric']}")
    out["resume"] = {"subprocess_s": sub_s, "load_ms": resume_ms,
                     "best_metric": [best_metric, after["best_metric"]]}
    print(f"# apps c, the overwrite guard refused and left the files as they "
          f"were; d, train_cdr --resume (subprocess, {sub_s:.1f} s): one "
          f"epoch from step {step} to {after['step']} at lr {lr:g}, Adam's "
          f"step {adam}, best.pth {'rewritten' if improved else 'kept'} "
          f"(MPJPE3D {best_metric:.6g} -> {after['best_metric']:.6g}); the "
          f"resume load {resume_ms:.1f} ms")
    out["checkpoint"] = times
    return out, cfg2, cfg3, weights


def checkpoint_times(state, work):
    """Save ms and bytes of latest.pth + latest.opt.pt, synchronous and
    asynchronous (the time save() takes to return, and to the end of the
    write), twice each."""
    import os
    from fast3dhpe_tpu_torch.train import checkpoint, loop2d
    out = {"sync_ms": [], "async_return_ms": [], "async_total_ms": []}
    for i in range(2):
        for mode in ("sync", "async"):
            d = os.path.join(work, f"ckpt_{mode}_{i}")
            os.makedirs(d)
            writer = checkpoint.make_checkpoint_writer(mode == "async")
            sync()
            t = time.perf_counter()
            loop2d._save_latest(writer, d, state, 0.0)
            returned = (time.perf_counter() - t) * 1e3
            writer.close()
            total = (time.perf_counter() - t) * 1e3
            if mode == "sync":
                out["sync_ms"].append(total)
            else:
                out["async_return_ms"].append(returned)
                out["async_total_ms"].append(total)
            out["bytes"] = {n: os.path.getsize(os.path.join(d, n))
                            for n in sorted(os.listdir(d))}
    return out


def run_serve_apps(mads, work, cfg2, cfg3, weights, dev):
    """e-f: `inference --bf16 --fused_inference --movement all` and
    `baseline` on the trained weights, each against the library call it
    wraps and the CPU."""
    import contextlib
    import importlib.util
    import io
    import os
    import cv2
    from PIL import Image
    from fast3dhpe_tpu_torch.apps import baseline, inference
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.data import LoadMADSData
    from fast3dhpe_tpu_torch.geometry.camera import project_points_np
    from fast3dhpe_tpu_torch.utils.visualize import plot_pose_2d, save_gif
    valid = os.path.join(mads, "valid")
    cfg = load_config(cfg3)
    size = tuple(cfg.MODEL.IMAGE_SIZE)
    B = cfg.TEST.BATCH_SIZE
    batches = -(-TREE_VALID_FRAMES // B)
    budget = 2048 << 20
    drawn = importlib.util.find_spec("matplotlib") is not None
    out = {"matplotlib": drawn}

    # e. the inference app
    argv = ["--config_path", cfg3, "--weights_root", weights, "--bf16",
            "--fused_inference", "--movement", "all", "--data_path", valid,
            "--batch_size", str(B), "--device", dev.type]
    if drawn:
        argv += ["--save_frames", "3"]
    here, printed = os.getcwd(), io.StringIO()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(printed):
            res, n, wall = counted(inference.main, argv)
    finally:
        os.chdir(here)
    require_counts(n, batches, 1, 0, 4, "the inference app")
    e2, e3 = res[EVAL_MOVEMENT]
    text = printed.getvalue()
    require(f"[{EVAL_MOVEMENT}] MPJPE2D:  {e2}" in text
            and f"[{EVAL_MOVEMENT}] MPJPE3D:  {e3}" in text
            and list(res) == [EVAL_MOVEMENT],
            f"the inference app printed {text!r} for {res}")
    inf = inference.CDRNetInferencer(cfg, weights_root=weights,
                                     dtype=torch.bfloat16,
                                     fused_inference=True, device=dev)
    stream = LoadMADSData(valid, size, EVAL_MOVEMENT, device=dev)
    r2, r3 = inf.evaluate_movement(stream, B, budget)
    t = time.perf_counter()
    inf.evaluate_movement(stream, B, budget)
    eval_s = time.perf_counter() - t
    for got, ref, k in ((e2, r2, "MPJPE2D"), (e3, r3, "MPJPE3D")):
        require(np.isfinite(got) and abs(got - ref) <= EVAL_REL_TOL
                * abs(ref), f"the inference app's {k} {got} differs from "
                            f"evaluate_movement's {ref}")
    if drawn:
        with Image.open(os.path.join(work, f"{EVAL_MOVEMENT}.gif")) as im:
            require(im.n_frames == 3, f"the GIF holds {im.n_frames} frames")
        require(cv2.imread(os.path.join(work, "test.jpg")) is not None,
                "test.jpg does not decode")
        note = "the GIF and test.jpg written by the app decode"
    else:
        try:
            inf.render_frames(stream, 1, os.path.join(work, "x.jpg"))
            missing = None
        except ImportError as err:
            missing = str(err)
        require(missing and "matplotlib" in missing,
                f"render_frames without matplotlib raised {missing}")
        print(f"# apps e: the 3D plot was not drawn: matplotlib is not "
              f"installed on this host ({missing}); the cv2 2D overlays are")
        batch = next(iter(stream.batches(B)))
        kp, _ = inf.predict_batch(batch["img_l"], batch["img_r"],
                                  batch["proj"])
        kp = kp.float().cpu().numpy()
        poses = np.nan_to_num(batch["pose_3d"]).astype(np.float32)
        gts = [project_points_np(poses, batch["proj"][:, v])
               for v in range(2)]
        raw = [np.concatenate([batch["img_l"][i].cpu().numpy(),
                               batch["img_r"][i].cpu().numpy()], axis=1)
               for i in range(3)]
        frames = [cv2.cvtColor(plot_pose_2d(
            (gts[0][i], gts[1][i]), (kp[i, 0], kp[i, 1]),
            (batch["img_l"][i].cpu().numpy(),
             batch["img_r"][i].cpu().numpy())), cv2.COLOR_BGR2RGB)
            for i in range(3)]
        require(all(f.shape == (size[1], 2 * size[0], 3) and
                    (cv2.cvtColor(f, cv2.COLOR_RGB2BGR) != r).any()
                    for f, r in zip(frames, raw)),
                "the 2D overlays drew nothing")
        save_gif(frames, os.path.join(work, f"{EVAL_MOVEMENT}_2d.gif"))
        cv2.imwrite(os.path.join(work, "test.jpg"),
                    cv2.cvtColor(frames[-1], cv2.COLOR_RGB2BGR))
        with Image.open(os.path.join(work,
                                     f"{EVAL_MOVEMENT}_2d.gif")) as im:
            require(im.n_frames == 3, f"the GIF holds {im.n_frames} frames")
        require(cv2.imread(os.path.join(work, "test.jpg")) is not None,
                "test.jpg does not decode")
        note = "a GIF and test.jpg of the 2D overlays decode"
    del inf
    torch.cuda.empty_cache()
    out["inference"] = {"mpjpe": [e2, e3], "evaluate_movement": [r2, r3],
                        "launches": n, "app_wall_s": wall,
                        "app_frames_per_s": TREE_VALID_FRAMES / wall,
                        "eval_frames_per_s": TREE_VALID_FRAMES / eval_s}
    print(f"# apps e, inference --bf16 --fused_inference --movement all: "
          f"MPJPE2D {e2:.6g} px, MPJPE3D {e3:.6g} mm (evaluate_movement "
          f"{r2:.6g}, {r3:.6g}), launches {n}; app {wall:.2f} s "
          f"({TREE_VALID_FRAMES / wall:.1f} frames/s), evaluate_movement "
          f"{TREE_VALID_FRAMES / eval_s:.1f} frames/s; {note}")

    # f. the baseline app, and one batch against the CPU
    bl_argv = ["--config_path", cfg2, "--weights_root", weights,
               "--data_path", valid, "--batch_size", str(B), "--device",
               dev.type]
    with contextlib.redirect_stdout(io.StringIO()):
        (b2, b3), n, wall = counted(baseline.main, bl_argv)
    require_counts(n, 1, 0, 0, 0, "the baseline app")
    require(np.isfinite([b2, b3]).all(), f"baseline MPJPE {b2}, {b3}")
    cfg_2d = load_config(cfg2)
    est = baseline.BaselineEstimator(cfg_2d, weights_root=weights,
                                     device=dev)
    stream = LoadMADSData(valid, size, EVAL_MOVEMENT, device=dev)
    est.evaluate_movement(stream, B, budget)
    t = time.perf_counter()
    est.evaluate_movement(stream, B, budget)
    bl_eval_s = time.perf_counter() - t
    cpu = baseline.BaselineEstimator(cfg_2d, weights_root=weights,
                                     device="cpu")
    batch = next(iter(LoadMADSData(valid, size, EVAL_MOVEMENT,
                                   device="cpu").batches(B)))
    kp, p3 = (x.cpu() for x in est.predict_batch(
        batch["img_l"], batch["img_r"], batch["proj"]))
    ckp, cp3 = cpu.predict_batch(batch["img_l"], batch["img_r"],
                                 batch["proj"])
    with torch.inference_mode():
        from fast3dhpe_tpu_torch.ops.warp import normalize_imagenet
        hm = cpu.model(torch.cat([normalize_imagenet(batch["img_l"]),
                                  normalize_imagenet(batch["img_r"])]))
    views = torch.cat([kp[:, 0], kp[:, 1]]), torch.cat([ckp[:, 0],
                                                        ckp[:, 1]])
    differ = (views[0] != views[1]).any(-1).nonzero().tolist()
    scale = size[0] / cfg_2d.MODEL.EXTRA.HEATMAP_SIZE[0]
    for img, j in differ:
        h = hm[img, :, :, j]
        x, y = (views[0][img, j] / scale).long().tolist()
        gap, span = float(h.max() - h[y, x]), float(h.max() - h.min())
        # hard_argmax zeroes a joint whose maximum is <= 0
        require(gap <= NEAR_TIE * span or abs(float(h.max())) <= NEAR_TIE
                * span,
                f"baseline pred_2d of image {img} joint {j} differs from the "
                f"CPU's by more than a near-tie of its heatmap ({gap})")
    same = (kp == ckp).all(-1).all(1)                  # (B, J)
    floor = cp3.abs().amax(-1) > 1e8                   # |w| at its 1e-9 floor
    rel = ((p3 - cp3).norm(dim=-1) / cp3.norm(dim=-1))
    rel_abs = ((p3.abs() - cp3.abs()).norm(dim=-1) / cp3.norm(dim=-1))
    require(bool(same.any()), "no joint's pred_2d agrees with the CPU's")
    worst = float(torch.where(floor, rel_abs, rel)[same].max())
    require(worst <= 1e-3, f"baseline pred_3d differs from the CPU's by "
                           f"{worst} relative where pred_2d agrees")
    out["baseline"] = {"mpjpe": [b2, b3], "launches": n, "app_wall_s": wall,
                       "app_frames_per_s": TREE_VALID_FRAMES / wall,
                       "eval_frames_per_s": TREE_VALID_FRAMES / bl_eval_s,
                       "pred_2d_near_ties": len(differ),
                       "pred_3d_rel": worst,
                       "joints_at_w_floor": int(floor.sum())}
    print(f"# apps f, baseline: MPJPE2D {b2:.6g} px, MPJPE3D {b3:.6g} mm, "
          f"launches {n}; app {wall:.2f} s ({TREE_VALID_FRAMES / wall:.1f} "
          f"frames/s), evaluate_movement "
          f"{TREE_VALID_FRAMES / bl_eval_s:.1f} frames/s; one batch vs the "
          f"CPU: pred_2d differs at {len(differ)} near-ties, pred_3d within "
          f"{worst:.3g} relative ({int(floor.sum())} joints at the floor of "
          f"w compared in magnitude)")
    return out


def run_geometry(dev):
    """g. dlt_triangulate by jacobi, svd and sii and
    triangulate_closed_form on 32 x 19 systems of converging_rig with 1 px
    of noise, on the card against the CPU: launches and device ms a call
    (torch.profiler) and host ms a call."""
    from fast3dhpe_tpu_torch.geometry.triangulation import (
        dlt_triangulate, triangulate_closed_form)
    rng = np.random.RandomState(SEED + 7)
    P = converging_rig(TIMING_PAIRS)
    X = rng.uniform(-250, 250, (TIMING_PAIRS, 19, 3))
    hom = np.concatenate([X, np.ones((TIMING_PAIRS, 19, 1))], -1)
    uvw = np.einsum("bvij,bkj->bkvi", P.astype(np.float64), hom)
    pts = (uvw[..., :2] / uvw[..., 2:]
           + rng.randn(TIMING_PAIRS, 19, 2, 2)).astype(np.float32)
    proj = np.ascontiguousarray(np.broadcast_to(
        P[:, None], (TIMING_PAIRS, 19, 2, 3, 4)))
    flat = pts.reshape(-1, 2, 2)
    calls = {f"dlt {m}": (lambda d, m=m: dlt_triangulate(
        torch.as_tensor(proj, device=d), torch.as_tensor(pts, device=d),
        method=m)) for m in ("jacobi", "svd", "sii")}
    calls["closed form"] = lambda d: triangulate_closed_form(
        torch.as_tensor(P[0, 0], device=d), torch.as_tensor(P[0, 1],
                                                            device=d),
        torch.as_tensor(flat[:, 0], device=d),
        torch.as_tensor(flat[:, 1], device=d))
    out = {}
    for name, fn in calls.items():
        got, ref = fn(dev).cpu(), fn("cpu")
        err = float((got - ref).abs().max() / ref.abs().max())
        require(torch.isfinite(got).all() and err <= GEOMETRY_TOL,
                f"{name} on the card differs from the CPU by {err} of its "
                f"largest coordinate")
        prof = profile_calls(lambda: fn(dev))
        out[name] = {"max_err": err, "host_ms": host_ms(lambda: fn(dev)),
                     **prof}
    print("# apps g, geometry at 32 x 19 systems (launches, device ms, host "
          "ms a call; error vs the CPU): " + "; ".join(
              f"{k} {v['launches']:.0f}, {v['device_ms']:.3f}, "
              f"{v['host_ms']:.2f} ms, {v['max_err']:.2g}"
              for k, v in out.items()))
    return out


def run_apps(mads, dev, smi):
    """Phase 11: the CLI apps at full width on the JPEG trees, a-h."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        out, cfg2, cfg3, weights = run_train_apps(mads, work, dev)
        torch.cuda.empty_cache()
        out.update(run_serve_apps(mads, work, cfg2, cfg3, weights, dev))
    torch.cuda.empty_cache()
    out["geometry"] = run_geometry(dev)
    c = out["checkpoint"]
    print(f"# apps h ({smi}): epoch wall s: train {out['train']['epoch_s']}, "
          f"train_cdr {out['train_cdr']['epoch_s']}; checkpoint "
          f"{c['bytes']} bytes, sync save {[round(x, 1) for x in c['sync_ms']]}"
          f" ms, async save returns in "
          f"{[round(x, 1) for x in c['async_return_ms']]} ms and ends in "
          f"{[round(x, 1) for x in c['async_total_ms']]} ms; resume load "
          f"{out['resume']['load_ms']:.1f} ms; inference app "
          f"{out['inference']['app_frames_per_s']:.1f} frames/s "
          f"(evaluate_movement {out['inference']['eval_frames_per_s']:.1f}),"
          f" baseline app {out['baseline']['app_frames_per_s']:.1f} frames/s "
          f"(evaluate_movement {out['baseline']['eval_frames_per_s']:.1f}); "
          f"phase {time.perf_counter() - t0:.1f} s")
    return out


# ----------------------------------------------------------------- slice 6

S6_PAIRS = 32                     # int8 requests, exports, the bf16 step
S6_CALIB = 8                      # calibration batches of 16 pairs
S6_CPU_PAIRS = 2                  # rows of an int8 request also on the CPU
S6_REMAT_PAIRS = (32, 96)
# cf_out's int8 codes follow the bf16 trunk, which cuDNN and oneDNN round
# apart: at most CF_FLIPS of them may differ from the CPU's, by one code;
# every code before it is bit-equal (exact int32 accumulators, the same
# fp32 epilogue and division)
CF_FLIPS = 1e-3
# int8 against the bf16 request, as tests/test_quantized.py:129-139
INT8_CORR, INT8_MAX_ERR = 0.99, 0.12
EXPORT_RTOL, EXPORT_ATOL = 1e-4, 1e-3     # as tests/test_export.py
RIG_DISTANCE_MM = 3000.0                  # converging_rig's cameras
# bf16 training. At random init the train-mode forward of CDRNet-101 in
# bf16 leaves its fp32 twin far behind: the heatmaps differ by up to 0.9
# of their largest value and the gradients by more than their norm (the
# rounding compounds through 104 train-mode BNs; measured on the CPU at 2
# and 32 pairs), so neither is held against fp32. What is held: the
# losses (BF16_LOSS_TOL relative), the first BN site's output (the bf16
# bounds of tests/test_pallas_kernels.py:116-119), and against the CPU's
# bf16 step the gradient and BN statistics within BF16_NOISE_X times the
# CPU's own bf16-vs-fp32 difference (the rule of
# tests/test_torch_bf16_train.py), loose at this depth; the train-mode BN
# layer itself on a bf16 input against the CPU within one bf16 rounding.
BF16_LOSS_TOL, BF16_NOISE_X, BF16_ULP = 2e-2, 2.0, 2.0 ** -7
HM_MAX_TOL, HM_MEAN_TOL = 0.05, 0.005     # tests/test_pallas_kernels.py


def check_apis():
    """The APIs this slice needs from the card's torch, named if absent."""
    missing = [name for name, ok in (
        ("torch.library.custom_op", hasattr(torch.library, "custom_op")),
        ("torch.library.register_autograd",
         hasattr(torch.library, "register_autograd")),
        ("torch.export.export", hasattr(torch, "export")
         and hasattr(torch.export, "export")),
        ("torch._int_mm", hasattr(torch, "_int_mm")),
        ("torch.cuda.CUDAGraph.register_generator_state",
         hasattr(torch.cuda.CUDAGraph, "register_generator_state")),
        ("torch.cuda.graph_pool_handle",
         hasattr(torch.cuda, "graph_pool_handle"))) if not ok]
    try:
        import torch.export.passes as passes
        if not hasattr(passes, "move_to_device_pass"):
            missing.append("torch.export.passes.move_to_device_pass")
    except ImportError:
        missing.append("torch.export.passes")
    require(not missing, f"torch {torch.__version__} lacks {missing}")
    a = torch.ones((32, 32), dtype=torch.int8, device="cuda")
    try:
        got = torch._int_mm(a, a)
    except RuntimeError as err:
        raise RuntimeError(f"chip_smoke: torch._int_mm on CUDA failed: "
                           f"{err}") from err
    require(bool((got == 32).all()), "torch._int_mm on CUDA: wrong sums")


class CalibFrames:
    """A stream of seeded random uint8 pairs of bench.py's rig, as
    CDRNetInferencer(int8=True) draws calibration batches from one."""

    def __init__(self, seed, n):
        self.seed, self.n = seed, n

    def batches(self, batch_size):
        rng = np.random.RandomState(self.seed)
        for _ in range(self.n):
            img_l, img_r, proj = stereo_request(rng, batch_size)
            yield {"img_l": img_l, "img_r": img_r, "proj": proj}


def requant_codes(fn):
    """fn() with every int8 requant of ops/quant.py recorded (on the
    CPU), in call order."""
    from fast3dhpe_tpu_torch.ops import quant as Q
    seen, orig = [], Q.requant

    def recorded(y, s):
        out = orig(y, s)
        seen.append(out.cpu())
        return out

    Q.requant = recorded
    try:
        out = fn()
    finally:
        Q.requant = orig
    return out, seen


def device_groups(fn, calls=3):
    """Device ms a call by kernel group (torch.profiler), and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    groups = {"K1 soft-argmax": 0.0, "K3 fused bottleneck": 0.0,
              "GEMM and convolution (cuBLAS, cuDNN)": 0.0,
              "other (im2col copies, elementwise, geometry)": 0.0}
    launches = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        launches += e.count
        ms = e.self_device_time_total / 1e3 / calls
        if "softargmax_fwd" in e.key:
            g = "K1 soft-argmax"
        elif "bottleneck_kernel" in e.key:
            g = "K3 fused bottleneck"
        elif any(s in e.key.lower() for s in CONV_KERNELS + ("imma", "i8")):
            g = "GEMM and convolution (cuBLAS, cuDNN)"
        else:
            g = "other (im2col copies, elementwise, geometry)"
        groups[g] += ms
    busy = sum(groups.values())
    require(busy > 0, "the profiler recorded no device time")
    return {"device_ms": busy, "launches": launches / calls,
            "groups": groups}


def run_int8(inf, cfg, dev, work):
    """a. int8 serving: calibrate a pack on S6_CALIB batches, serve 3
    requests of S6_PAIRS pairs (1 K1, no K2, no K3 each), one request's
    first rows against the CPU's int8 path on the same pack, the request
    against the bf16 fused one, and both timed."""
    import os
    from fast3dhpe_tpu_torch.apps.inference import CDRNetInferencer
    from fast3dhpe_tpu_torch.geometry.triangulation import dlt_triangulate
    from fast3dhpe_tpu_torch.models import quantized as qz
    sd = {k: v.detach() for k, v in inf.model.state_dict().items()}
    pack_path = os.path.join(work, "cdrnet101_int8.npz")
    t = time.perf_counter()
    inf8 = CDRNetInferencer(cfg, state_dict=sd, device=dev, int8=True,
                            calib_stream=CalibFrames(SEED + 11, S6_CALIB),
                            calib_batches=S6_CALIB, int8_pack=pack_path)
    sync()
    calib_s = time.perf_counter() - t
    rng = np.random.RandomState(SEED + 12)
    requests = [stereo_request(rng, S6_PAIRS) for _ in range(REQUESTS)]
    counters = reset_counts()
    outs = [inf8.predict_batch(*r) for r in requests]
    n = read_counts(counters)
    require_counts(n, REQUESTS, 1, 0, 0, "int8 serving")
    for kp, p3 in outs:
        require(kp.shape == (S6_PAIRS, 2, 19, 2)
                and p3.shape == (S6_PAIRS, 19, 3)
                and bool(torch.isfinite(kp).all() and torch.isfinite(p3)
                         .all()), "int8 serving: bad outputs")

    # the first rows of request 0 on the card and on the CPU, same pack
    cpu8 = CDRNetInferencer(cfg, device="cpu", int8=True,
                            int8_pack=pack_path)
    il, ir, pj = (a[:S6_CPU_PAIRS] for a in requests[0])
    with torch.inference_mode():
        (gkp, gp3, ghm), gcodes = requant_codes(lambda: inf8.model(
            normalized(il, ir, dev), torch.as_tensor(pj, device=dev),
            return_heatmaps=True))
        (ckp, cp3, chm), ccodes = requant_codes(lambda: cpu8.model(
            normalized(il, ir, "cpu"), torch.as_tensor(pj),
            return_heatmaps=True))
        cf = len(ccodes) - 4              # cf_out, then the three deconvs
        rt = inf8.model.rt
        dec = qz._decoder_walk(qz._Int8Ctx(rt), (ccodes[cf].to(dev),
                                                 rt.scale("cf_out")))
        proj_j = torch.as_tensor(pj)[:, None].expand(S6_CPU_PAIRS, 19, 2,
                                                     3, 4)
        ref3 = dlt_triangulate(proj_j, gkp.cpu().transpose(1, 2))
    require(len(gcodes) == len(ccodes), "int8: requant points differ")
    enc_flips = sum(int((g != c).sum()) for g, c in zip(gcodes[:cf],
                                                        ccodes[:cf]))
    flips = [int((g != c).sum()) for g, c in zip(gcodes, ccodes)]
    cf_d = (gcodes[cf].int() - ccodes[cf].int()).abs()
    dec_exact = torch.equal(dec.cpu().reshape(chm.shape), chm)
    hm_scale = float(chm.abs().max())
    hm_err = float((ghm.cpu() - chm).abs().max()) / hm_scale
    kp_err = float((gkp.cpu() - ckp).abs().max())
    p3_rel = float(((gp3.cpu() - ref3).norm(dim=-1)
                    / ref3.norm(dim=-1)).max())
    vs_cpu = {"requant_points": len(ccodes), "encoder_flips": enc_flips,
              "flips_by_point": flips, "cf_out_codes": cf_d.numel(),
              "cf_out_flips": int((cf_d > 0).sum()),
              "cf_out_max_code_diff": int(cf_d.max()),
              "decoder_on_cpu_codes_exact": dec_exact,
              "hm_max": hm_err, "kp_px": kp_err, "p3_rel": p3_rel}
    print(f"# slice 6 a, int8 vs the CPU's int8 on the same pack "
          f"({S6_CPU_PAIRS} pairs): {len(ccodes)} requant points, encoder "
          f"flips {enc_flips}, cf_out {vs_cpu['cf_out_flips']} of "
          f"{cf_d.numel()} (max {vs_cpu['cf_out_max_code_diff']} code), "
          f"flips by point after it {flips[cf:]}; decoder on the CPU's "
          f"cf_out codes exact: {dec_exact}; heatmaps {hm_err:.3g} of max, "
          f"pred_2d {kp_err:.3g} px, pred_3d vs the CPU DLT of the card's "
          f"pred_2d {p3_rel:.3g}")
    require(enc_flips == 0, f"int8: {enc_flips} int8 codes before cf_out "
                            f"differ from the CPU's (exact arithmetic)")
    require(int((cf_d > 0).sum()) <= CF_FLIPS * cf_d.numel()
            and int(cf_d.max()) <= 1,
            f"int8: cf_out flips {vs_cpu['cf_out_flips']} (bound "
            f"{CF_FLIPS} of {cf_d.numel()}, one code each)")
    require(dec_exact, "int8: the decoder on the CPU's cf_out codes is not "
                       "bit-equal to the CPU's")
    require(hm_err < HM_MAX_TOL and kp_err < 2.0 and p3_rel < 1e-3,
            f"int8 vs CPU: heatmaps {hm_err}, pred_2d {kp_err} px, pred_3d "
            f"{p3_rel}")

    # against the bf16 fused request on the same frames
    il, ir, pj = requests[0]
    with torch.inference_mode():
        imgs = normalized(il, ir, dev)
        pjt = torch.as_tensor(pj, device=dev)
        _, _, h16 = inf.model(imgs, pjt, return_heatmaps=True)
        _, _, h8 = inf8.model(imgs, pjt, return_heatmaps=True)
    a, b = h16.float().cpu().numpy().ravel(), h8.cpu().numpy().ravel()
    corr = float(np.corrcoef(a, b)[0, 1])
    max_err = float(np.abs(a - b).max() / np.abs(a).max())
    print(f"# slice 6 a, int8 vs the bf16 fused request ({S6_PAIRS} "
          f"pairs): heatmap correlation {corr:.6f} (bound > {INT8_CORR}), "
          f"max error {max_err:.4f} of max (bound < {INT8_MAX_ERR})")
    require(corr > INT8_CORR and max_err < INT8_MAX_ERR,
            f"int8 vs bf16: correlation {corr}, max error {max_err}")

    # timing at S6_PAIRS pairs, inputs on the card
    args = [torch.as_tensor(x, device=dev) for x in requests[1]]
    times = {}
    for name, fn in (("int8", lambda: inf8.predict_batch(*args)),
                     ("bf16 fused", lambda: inf.predict_batch(*args))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fn()
        sync()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = device_groups(fn)
        times[name] = dict(prof, wall_ms=host_ms(fn), peak_gib=peak)
        print(f"# slice 6 a, {name} request at {S6_PAIRS} pairs: wall "
              f"{times[name]['wall_ms']:.2f} ms, device busy "
              f"{prof['device_ms']:.3f} ms in {prof['launches']:.0f} "
              f"launches, peak {peak:.2f} GiB; "
              + ", ".join(f"{k} {v:.3f}" for k, v in prof["groups"].items()))
    return inf8, sd, requests, {
        "launches": n, "calib_s": calib_s, "vs_cpu": vs_cpu,
        "vs_bf16": {"corr": corr, "max_err": max_err}, "times": times,
        "pack_bytes": os.path.getsize(pack_path)}


def run_int8_apps(sd, cfg, mads, work, dev):
    """b. `inference --int8 --int8_pack` on the tree (calibrating and
    writing the pack, then loading it with no fp checkpoint), beside
    `inference --bf16 --fused_inference` on the same weights."""
    import contextlib
    import io
    import os
    from fast3dhpe_tpu_torch.apps import inference
    weights = os.path.join(work, "s6_weights")
    os.makedirs(os.path.join(weights, cfg.MODEL.NAME))
    torch.save({k: v.cpu() for k, v in sd.items()},
               os.path.join(weights, cfg.MODEL.NAME, "best.pth"))
    cfg_path = app_config("configs/mads_3d.yaml",
                          os.path.join(work, "s6.yaml"), mads,
                          MODEL={"PRETRAINED": ""})
    B = cfg.TEST.BATCH_SIZE
    batches = -(-TREE_VALID_FRAMES // B)
    argv = ["--config_path", cfg_path, "--movement", "all", "--data_path",
            os.path.join(mads, "valid"), "--batch_size", str(B), "--device",
            dev.type]
    pack = os.path.join(work, "app_int8.npz")
    runs = {}
    for name, extra in (
            ("bf16 fused", ["--weights_root", weights, "--bf16",
                            "--fused_inference"]),
            ("int8, calibrating", ["--weights_root", weights, "--int8",
                                   "--int8_pack", pack]),
            ("int8, from the pack", ["--weights_root",
                                     os.path.join(work, "no_weights"),
                                     "--int8", "--int8_pack", pack])):
        with contextlib.redirect_stdout(io.StringIO()):
            res, n, wall = counted(inference.main, argv + extra)
        e2, e3 = res[EVAL_MOVEMENT]
        require(np.isfinite([e2, e3]).all(), f"{name} app: MPJPE {e2}, {e3}")
        require_counts(n, batches, 1, 0, 4 if name == "bf16 fused" else 0,
                       f"the {name} inference app")
        runs[name] = {"mpjpe": [e2, e3], "launches": n, "wall_s": wall}
    i8, i8b = runs["int8, calibrating"], runs["int8, from the pack"]
    ratio = (i8["mpjpe"][0] + 1e-6) / (runs["bf16 fused"]["mpjpe"][0] + 1e-6)
    print("# slice 6 b, inference apps on valid/HipHop: " + "; ".join(
        f"{k} MPJPE2D {v['mpjpe'][0]:.6g} px, MPJPE3D {v['mpjpe'][1]:.6g} "
        f"mm, {v['wall_s']:.1f} s" for k, v in runs.items())
        + f"; int8/bf16 MPJPE2D {ratio:.4f}")
    require(np.allclose(i8b["mpjpe"], i8["mpjpe"], rtol=1e-6),
            "the int8 app from its pack differs from the calibrating run")
    require(0.3 < ratio < 3.0, f"int8 app MPJPE2D / bf16 {ratio}")
    return dict(runs, pack_bytes=os.path.getsize(pack))


EXPORT_CHILD = r"""
import json, sys, time
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False       # as the parent's fp32 run
torch.backends.cuda.matmul.allow_tf32 = False
from fast3dhpe_tpu_torch.export import load_serving
d = np.load(sys.argv[1])
out = {}
for kind, path in json.loads(sys.argv[2]).items():
    t = time.perf_counter()
    serve = load_serving(path, "cuda")
    load_s = time.perf_counter() - t
    ops = [sys.modules[m] for m in ("fast3dhpe_tpu_torch.ops.softargmax",
                                    "fast3dhpe_tpu_torch.ops.bottleneck")]
    counters = {"soft_argmax": ops[0].soft_argmax_fused,
                "soft_argmax_bwd": ops[0].soft_argmax_bwd_fused,
                "fused_bottleneck": ops[1].fused_bottleneck}
    for c in counters.values():
        c.launches = 0
    kp, p3 = serve(d["img_l"], d["img_r"], d["proj"])
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    np.save(sys.argv[3] + kind + "_kp.npy", kp.cpu().numpy())
    np.save(sys.argv[3] + kind + "_p3.npy", p3.cpu().numpy())
    raised = []
    for bad in ((d["img_l"].astype(np.float32), d["img_r"], d["proj"]),
                (d["img_l"][:1], d["img_r"][:1], d["proj"][:1])):
        try:
            serve(*bad)
            raised.append(None)
        except (TypeError, ValueError) as err:
            raised.append(type(err).__name__)
    out[kind] = {"load_s": load_s, "launches": launches, "raised": raised}
out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "fast3dhpe_tpu"))
print(json.dumps(out))
"""


def start_export(sd, pack, request, cfg, dev, work):
    """c. export fp32 and int8 at S6_PAIRS and save them; then start a new
    process that imports only fast3dhpe_tpu_torch.export, loads each and
    serves `request` (it runs while phase b's apps run; finish_export
    waits for it)."""
    import json
    import os
    from fast3dhpe_tpu_torch import export as E
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    size = tuple(cfg.MODEL.IMAGE_SIZE)
    paths = {"fp32": os.path.join(work, "cdrnet101.pt2"),
             "int8": os.path.join(work, "cdrnet101_int8.pt2")}
    info = {}
    for kind in ("fp32", "int8"):
        t = time.perf_counter()
        if kind == "fp32":
            ep = E.export_cdrnet(CDRNet.from_config(cfg), sd, S6_PAIRS, size,
                                 device=dev)
        else:
            ep = E.export_cdrnet_int8(pack, S6_PAIRS, size,
                                      dlt_method=cfg.MODEL.EXTRA.DLT_METHOD,
                                      device=dev)
        export_s = time.perf_counter() - t
        info[kind] = {"export_s": export_s,
                      "bytes": E.save_exported(ep, paths[kind]),
                      "graph_nodes": len(ep.graph.nodes)}
        del ep
    torch.cuda.empty_cache()
    frames = os.path.join(work, "frames.npz")
    np.savez(frames, **dict(zip(("img_l", "img_r", "proj"), request)))
    prefix = os.path.join(work, "served_")
    # run from the checkout's root, which `-c` puts on the child's path
    child = subprocess.Popen(
        [sys.executable, "-c", EXPORT_CHILD, frames, json.dumps(paths),
         prefix], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return child, prefix, info, time.perf_counter()


def finish_export(started, inf8, request, sd, cfg, dev):
    """c, continued: wait for the child and hold what it served: pred_2d
    against predict_batch on the same frames (EXPORT_RTOL, EXPORT_ATOL),
    and pred_3d against the port's DLT on the card of the served pred_2d,
    within EXPORT_ATOL of the scene's scale (the larger of the points'
    extent and converging_rig's 3 m camera distance), or CPU_NOISE_X times
    the DLT's own change under pred_2d x (1 +- 1e-7) if that is larger, as
    train_vs_cpu holds the DLT's gradient (two near-equal smallest singular
    values make the DLT's solution sensitive to rounding). pred_3d against
    predict_batch's is reported, not held: the fp32 Jacobi DLT of an
    untrained net's keypoints turns the two runs' 4.6e-5 px of fp32 noise
    in pred_2d into 2.6-6 mm (converging_rig) or 1.2e-3 of the largest
    coordinate at the w floor (bench.py's rig), in one run each."""
    import json
    from fast3dhpe_tpu_torch.apps.inference import CDRNetInferencer
    from fast3dhpe_tpu_torch.geometry.triangulation import dlt_triangulate
    child, prefix, info, t0 = started
    try:
        stdout, stderr = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    child_s = time.perf_counter() - t0
    require(child.returncode == 0, f"the export child failed:\n"
                                   f"{stderr[-4000:]}")
    loaded = json.loads(stdout.strip().splitlines()[-1])
    require(loaded["modules"] == [], f"the child loaded {loaded['modules']}")
    il, ir, pj = request
    fp32 = CDRNetInferencer(cfg, state_dict=sd, device=dev)
    refs = {"fp32": fp32.predict_batch(il, ir, pj),
            "int8": inf8.predict_batch(il, ir, pj)}
    del fp32
    for kind in ("fp32", "int8"):
        kp = np.load(prefix + kind + "_kp.npy")
        p3 = np.load(prefix + kind + "_p3.npy")
        rkp, rp3 = (x.cpu().numpy() for x in refs[kind])
        with torch.inference_mode():
            proj_j = torch.as_tensor(pj, device=dev)[:, None].expand(
                S6_PAIRS, kp.shape[2], 2, 3, 4)
            kp_t = torch.as_tensor(kp, device=dev).transpose(1, 2)
            dlt, up, down = (dlt_triangulate(proj_j, kp_t * f).cpu().numpy()
                             for f in (1.0, 1.0 + 1e-7, 1.0 - 1e-7))
        kp_err = float(np.abs(kp - rkp).max())
        scale = max(float(np.abs(dlt).max()), RIG_DISTANCE_MM)
        p3_err = float(np.abs(p3 - dlt).max()) / scale
        noise = max(float(np.abs(d - dlt).max()) for d in (up, down)) / scale
        p3_vs_eager = float(np.abs(p3 - rp3).max()) / scale
        row = dict(info[kind], **loaded[kind], kp_err=kp_err, p3_err=p3_err,
                   dlt_noise=noise, p3_vs_predict_batch=p3_vs_eager)
        info[kind] = row
        print(f"# slice 6 c, export {kind} at {S6_PAIRS} pairs: traced in "
              f"{row['export_s']:.1f} s, {row['graph_nodes']} graph nodes, "
              f"{row['bytes']} bytes; a new process (export only) loads it "
              f"in {row['load_s']:.1f} s (beside phase b), launches "
              f"{row['launches']}; pred_2d vs predict_batch {kp_err:.3g} px;"
              f" pred_3d vs the DLT of its pred_2d {p3_err:.3g} (the DLT's"
              f" own change under pred_2d x (1 +- 1e-7): {noise:.3g}), vs "
              f"predict_batch {p3_vs_eager:.3g} of the scene's scale; a "
              f"float frame and a wrong batch raise {row['raised']}")
        require(np.allclose(kp, rkp, rtol=EXPORT_RTOL, atol=EXPORT_ATOL)
                and p3_err <= max(EXPORT_ATOL, CPU_NOISE_X * noise),
                f"export {kind}: pred_2d {kp_err}, pred_3d {p3_err} (DLT "
                f"noise {noise})")
        require(row["launches"] == {"soft_argmax": 1, "soft_argmax_bwd": 0,
                                    "fused_bottleneck": 0},
                f"export {kind}: the loaded call launched {row['launches']}")
        require(row["raised"] == ["TypeError", "ValueError"],
                f"export {kind}: bad inputs raised {row['raised']}")
    info["child_s"] = child_s
    return info


def _grads_and_stats(model):
    return ({n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()},
            {n: b.detach().cpu() for n, b in model.named_buffers()
             if "running" in n})


def _global_rel(got, ref):
    num = sum(float(((got[n] - ref[n]) ** 2).sum()) for n in ref)
    den = sum(float((ref[n] ** 2).sum()) for n in ref)
    return (num / den) ** 0.5


def s6_model(cfg, start_sd, dtype, dev, remat=False, policy=None):
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    model = CDRNet(num_joints=cfg.MODEL.NUM_JOINTS,
                   num_layers=cfg.MODEL.NUM_LAYERS,
                   dlt_method=cfg.MODEL.EXTRA.DLT_METHOD, dtype=dtype,
                   remat=remat, remat_policy=policy)
    model.load_state_dict(start_sd, strict=True)
    return model.to(dev)


def sgd0_step(cfg, start_sd, dtype, dev, batch, use_3d, bn1=None, **remat):
    """One train step at lr 0 from start_sd: (metrics, grads, BN stats)
    on the CPU, and encoder.bn1's output when bn1 is a list."""
    from fast3dhpe_tpu_torch.train.state import TrainState
    model = s6_model(cfg, start_sd, dtype, dev, **remat)
    if bn1 is not None:
        model.encoder.bn1.register_forward_hook(
            lambda m, a, out: bn1.append(out.detach().float().cpu()))
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=0.0))
    m = train_step_fn(cfg)(state, on_device(batch, dev), use_3d)
    return ({k: v.item() for k, v in m.items()},) + _grads_and_stats(model)


def check_bf16_bn(dev):
    """The train-mode BN layer on one bf16 input (layer1's shape at 32
    pairs), card against CPU: y and dx within one bf16 rounding of their
    largest value, the running statistics 1e-5, the parameters'
    gradients 1e-4."""
    from fast3dhpe_tpu_torch.models.layers import BatchNorm2d, bn_row_mask
    gen = torch.Generator().manual_seed(SEED + 21)
    x = (torch.randn((2 * S6_PAIRS, 64, 64, 64), generator=gen) * 2 + 0.5
         ).bfloat16().contiguous(memory_format=torch.channels_last)
    cot = torch.randn(x.shape, generator=gen).bfloat16()
    rv = torch.ones(2 * S6_PAIRS)
    rv[-8:] = 0
    res = {}
    for d in ("cpu", dev):
        bn = BatchNorm2d(64).train().to(d)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 64))
            bn.bias.copy_(torch.linspace(-1, 1, 64))
        xd = x.to(d).detach().clone().requires_grad_(True)
        y = bn(xd, bn_row_mask(rv.to(d)))
        (y.float() * cot.to(d).float()).sum().backward()
        res[str(d)] = [t.detach().float().cpu() for t in (
            y, xd.grad, bn.running_mean, bn.running_var, bn.weight.grad,
            bn.bias.grad)]
    errs = [float((g - c).abs().max() / c.abs().max())
            for g, c in zip(res[str(dev)], res["cpu"])]
    print(f"# slice 6 d, bf16 train BN card vs CPU: y {errs[0]:.3g}, dx "
          f"{errs[1]:.3g} (bound {BF16_ULP:.3g}), running mean / var "
          f"{errs[2]:.3g} / {errs[3]:.3g} (1e-5), dweight / dbias "
          f"{errs[4]:.3g} / {errs[5]:.3g} (1e-4)")
    require(errs[0] <= BF16_ULP and errs[1] <= BF16_ULP
            and max(errs[2:4]) <= 1e-5 and max(errs[4:]) <= 1e-4,
            f"bf16 train BN card vs CPU: {errs}")
    return errs


def check_bf16_train(cfg, start_sd, dev):
    """d. bf16 training, checked: the BN layer against the CPU; the step
    at S6_PAIRS pairs (TRAIN_PAD padded) against the card's fp32 step, and
    at 2 pairs against the CPU's bf16 step. Nothing here is timed, so it
    runs while c's new process loads its artifacts."""
    out = {"bn_vs_cpu": check_bf16_bn(dev)}
    batch = train_batch(np.random.RandomState(SEED + 2), S6_PAIRS, TRAIN_PAD,
                        cfg.MODEL.IMAGE_SIZE[0])
    runs, bn1 = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        bn1[dt] = []
        runs[dt] = sgd0_step(cfg, start_sd, dt, dev, batch, True, bn1[dt])
    (m32, g32, s32), (m16, g16, s16) = runs[torch.float32], \
        runs[torch.bfloat16]
    a, b = bn1[torch.float32][0], bn1[torch.bfloat16][0]
    bn1_max = float((a - b).abs().max() / a.abs().max())
    bn1_mean = float((a - b).abs().mean() / a.abs().max())
    loss_rel = max(abs(m16[k] - m32[k]) / abs(m32[k])
                   for k in ("loss", "loss_2d", "loss_3d"))
    vs32 = {"loss": loss_rel, "bn1_max": bn1_max, "bn1_mean": bn1_mean,
            "grads": _global_rel(g16, g32), "bn_stats": _global_rel(s16, s32)}
    print(f"# slice 6 d, bf16 step vs fp32 at {S6_PAIRS} pairs: losses "
          f"{loss_rel:.3g} (bound {BF16_LOSS_TOL}), encoder.bn1 max "
          f"{bn1_max:.3g} / mean {bn1_mean:.3g} of max (bounds "
          f"{HM_MAX_TOL} / {HM_MEAN_TOL}); gradients {vs32['grads']:.3g} and "
          f"BN statistics {vs32['bn_stats']:.3g} of their norms (not held)")
    require(loss_rel <= BF16_LOSS_TOL and bn1_max < HM_MAX_TOL
            and bn1_mean < HM_MEAN_TOL, f"bf16 vs fp32 step: {vs32}")
    out["vs_fp32"] = vs32

    # 2 pairs, card against the CPU, warmup (see BF16_NOISE_X)
    b2 = train_batch(np.random.RandomState(SEED + 3), 2, 1,
                     cfg.MODEL.IMAGE_SIZE[0])
    card, cpu16, cpu32 = (sgd0_step(cfg, start_sd, dt, d, b2, False)
                          for dt, d in ((torch.bfloat16, dev),
                                        (torch.bfloat16, "cpu"),
                                        (torch.float32, "cpu")))
    vs_cpu = {"loss": max(abs(card[0][k] - cpu16[0][k]) / abs(cpu16[0][k])
                          for k in ("loss", "loss_2d")),
              "grads": _global_rel(card[1], cpu16[1]),
              "grads_cpu_noise": _global_rel(cpu16[1], cpu32[1]),
              "bn_stats": _global_rel(card[2], cpu16[2]),
              "bn_stats_cpu_noise": _global_rel(cpu16[2], cpu32[2])}
    print(f"# slice 6 d, bf16 step card vs CPU at 2 pairs (warmup): losses "
          f"{vs_cpu['loss']:.3g}, gradients {vs_cpu['grads']:.3g} (CPU bf16 "
          f"vs fp32 {vs_cpu['grads_cpu_noise']:.3g}), BN statistics "
          f"{vs_cpu['bn_stats']:.3g} (CPU {vs_cpu['bn_stats_cpu_noise']:.3g})")
    require(vs_cpu["loss"] <= 1e-2
            and vs_cpu["grads"] <= BF16_NOISE_X * vs_cpu["grads_cpu_noise"]
            and vs_cpu["bn_stats"] <= BF16_NOISE_X
            * vs_cpu["bn_stats_cpu_noise"], f"bf16 card vs CPU: {vs_cpu}")
    out["vs_cpu"] = vs_cpu
    return out


def time_bf16_train(cfg, start_sd, dev, mads, work):
    """d, timed: the bf16 step at S6_PAIRS pairs with the config's Adam,
    its time, device busy, peak memory, launches and K2's dtype; one
    `train_cdr --bf16` epoch on the tree."""
    import os
    from fast3dhpe_tpu_torch.apps import train_cdr
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.ops import softargmax as sa
    from fast3dhpe_tpu_torch.train.state import TrainState
    out = {}
    batch = train_batch(np.random.RandomState(SEED + 2), S6_PAIRS, TRAIN_PAD,
                        cfg.MODEL.IMAGE_SIZE[0])
    db = on_device(batch, dev)
    torch.cuda.empty_cache()
    model = s6_model(cfg, start_sd, torch.bfloat16, dev)
    state = TrainState.create(model, cfg, steps_per_epoch=1)
    step = train_step_fn(cfg)
    k2_dtypes, bwd = [], sa._bwd_cuda

    def recorded(heatmaps, *args):
        k2_dtypes.append(str(heatmaps.dtype).replace("torch.", ""))
        return bwd(heatmaps, *args)

    torch.cuda.reset_peak_memory_stats()
    counters = reset_counts()
    sa._bwd_cuda = recorded
    try:
        step(state, db, True)
    finally:
        sa._bwd_cuda = bwd
    n = read_counts(counters)
    require_counts(n, 1, 1, 1, 0, "the bf16 train step")
    require(k2_dtypes == ["bfloat16"], f"K2 ran on {k2_dtypes}")
    times = []
    for _ in range(TIMED_STEPS):
        t = time.perf_counter()
        step(state, db, True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_calls(lambda: step(state, db, True), calls=2)
    out["step"] = {"step_ms": statistics.median(times), "times_ms": times,
                   "peak_gib": peak, "launches": n, "k2_dtype": k2_dtypes,
                   "device_ms": prof["device_ms"],
                   "device_activities": prof["launches"]}
    print(f"# slice 6 d, bf16 train step at {S6_PAIRS} pairs: median "
          f"{out['step']['step_ms']:.1f} ms ({times}), device busy "
          f"{prof['device_ms']:.1f} ms in {prof['launches']:.0f} launches, "
          f"peak {peak:.2f} GiB, launches {n}, K2 on {k2_dtypes}")
    del model, state
    torch.cuda.empty_cache()

    # one `train_cdr --bf16` epoch on the tree, stacked from the card
    n_pairs = len(TREE_MOVEMENTS) * TREE_TRAIN_FRAMES
    cfg_path = app_config(
        "configs/mads_3d.yaml", os.path.join(work, "bf16.yaml"), mads,
        MODEL={"PRETRAINED": "", "NAME": "cdrnet_bf16"},
        DATASET={"DEVICE_CACHE_BYTES": 2 * n_pairs * RAW_H * RAW_W * 3},
        TRAIN={"EPOCH": 1, "WARMUP": 0})
    with EpochTimes() as et:
        h, n, wall = counted(train_cdr.main, [
            "--config_path", cfg_path, "--overwrite", "--bf16", "--device",
            dev.type, "--weights_root", os.path.join(work, "s6_bf16")])
    app_cfg = load_config(cfg_path)
    steps = -(-n_pairs // app_cfg.TRAIN.BATCH_SIZE)
    evals = -(-TREE_VALID_FRAMES // app_cfg.TEST.BATCH_SIZE)
    want = {"soft_argmax": steps + evals, "soft_argmax_bwd": steps,
            "fused_bottleneck": 0}
    require(n == want, f"train_cdr --bf16 launched {n}, not {want}")
    _finite_history(h, "train_cdr --bf16")
    out["app"] = {"epoch_s": et.seconds, "wall_s": wall, "launches": n,
                  "history": h}
    print(f"# slice 6 d, train_cdr --bf16, one epoch: {et.seconds} s "
          f"(wall {wall:.1f} s), launches {n}, history {h}")
    return out


def run_remat(cfg, start_sd, dev):
    """e. remat: fp32 steps with remat None and "convs" against the plain
    step (cuDNN deterministic): loss, gradients and BN statistics equal;
    then peak memory and step ms at S6_REMAT_PAIRS."""
    from fast3dhpe_tpu_torch.train.state import TrainState
    variants = {"plain": {}, "remat": {"remat": True},
                "remat convs": {"remat": True, "policy": "convs"}}
    batch = train_batch(np.random.RandomState(SEED + 2), S6_PAIRS, TRAIN_PAD,
                        cfg.MODEL.IMAGE_SIZE[0])
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    launches = {}
    try:
        runs = {}
        for name, kw in variants.items():
            counters = reset_counts()
            runs[name] = sgd0_step(cfg, start_sd, torch.float32, dev, batch,
                                   False, **kw)
            launches[name] = read_counts(counters)
            require_counts(launches[name], 1, 1, 1, 0, f"the {name} step")
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    m0, g0, s0 = runs["plain"]
    eq = {}
    for name in ("remat", "remat convs"):
        m, g, s = runs[name]
        eq[name] = {
            "loss_rel": abs(m["loss"] - m0["loss"]) / abs(m0["loss"]),
            "grads_rel": _global_rel(g, g0),
            "bn_rel": max(float((s[k] - s0[k]).abs().max()
                              / s0[k].abs().max().clamp_min(1e-30))
                          for k in s0),
            "bit_equal": all(torch.equal(g[k], g0[k]) for k in g0)
            and all(torch.equal(s[k], s0[k]) for k in s0)}
        require(eq[name]["loss_rel"] <= 1e-6 and eq[name]["grads_rel"] <= 1e-5
                and eq[name]["bn_rel"] <= 1e-6,
                f"{name} step differs from the plain one: {eq[name]}")
    print(f"# slice 6 e, remat vs plain step at {S6_PAIRS} pairs (fp32, "
          f"cuDNN deterministic): {eq}")
    db = on_device(batch, dev)
    step = train_step_fn(cfg)
    mem = {}
    for pairs in S6_REMAT_PAIRS:
        b = {k: v[:pairs] for k, v in db.items()} if pairs <= S6_PAIRS \
            else on_device(train_batch(np.random.RandomState(SEED + 4),
                                       pairs, TRAIN_PAD,
                                       cfg.MODEL.IMAGE_SIZE[0]), dev)
        for name, kw in variants.items():
            model = s6_model(cfg, start_sd, torch.float32, dev, **kw)
            state = TrainState.create(model, cfg, steps_per_epoch=1)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            step(state, b, True)
            times = []
            for _ in range(2):
                t = time.perf_counter()
                step(state, b, True)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            mem[f"{name}, {pairs} pairs"] = {
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "step_ms": statistics.median(times)}
            del model, state
    torch.cuda.empty_cache()
    print("# slice 6 e, fp32 train step peak memory and ms: " + "; ".join(
        f"{k} {v['peak_gib']:.2f} GiB {v['step_ms']:.1f} ms"
        for k, v in mem.items()))
    return {"vs_plain": eq, "launches": launches["remat convs"],
            "memory": mem}


def run_slice6(inf, cfg, start_sd, mads, dev, smi):
    """Phase 11: int8 serving, the int8 apps, the export, bf16 training
    and remat of CDRNet-101 at 256 px (a-e)."""
    t0 = time.perf_counter()
    out, parts = {}, {}

    def part(name, fn, *args):
        t = time.perf_counter()
        res = fn(*args)
        parts[name] = time.perf_counter() - t
        return res

    with tempfile.TemporaryDirectory() as work:
        inf8, sd, requests, out["int8"] = part("a int8", run_int8, inf, cfg,
                                               dev, work)
        request = requests[2][:2] + (converging_rig(S6_PAIRS),)
        started = part("c export", start_export, sd, inf8.pack, request,
                       cfg, dev, work)
        try:
            out["int8_apps"] = part("b apps", run_int8_apps, sd, cfg, mads,
                                    work, dev)
            bf16 = part("d bf16 checks", check_bf16_train, cfg, start_sd,
                        dev)
        except BaseException:
            started[0].kill()
            started[0].wait()
            raise
        out["export"] = part("c loaded", finish_export, started, inf8,
                             request, sd, cfg, dev)
        del inf8
        torch.cuda.empty_cache()
        bf16.update(part("d bf16 timed", time_bf16_train, cfg, start_sd,
                         dev, mads, work))
        out["bf16"] = bf16
    torch.cuda.empty_cache()
    out["remat"] = part("e remat", run_remat, cfg, start_sd, dev)
    out["launches"] = {
        "int8 serving": out["int8"]["launches"],
        **{f"{k} app": v["launches"] for k, v in out["int8_apps"].items()
           if isinstance(v, dict)},
        **{f"export {k}, loaded": out["export"][k]["launches"]
           for k in ("fp32", "int8")},
        "bf16 train step": out["bf16"]["step"]["launches"],
        "train_cdr --bf16 app": out["bf16"]["app"]["launches"],
        "remat convs step": out["remat"]["launches"]}
    out["seconds"] = parts
    print(f"# slice 6 ({smi}): {time.perf_counter() - t0:.1f} s; "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return out


# ----------------------------------------------------------------- slice 7

S7_TIMED = 4                      # a: timed steps of each, in turns
S7_FRAMES = 16                    # b: 2 movements x 16 frames a split,
S7_MOVEMENTS = ("HipHop", "Jazz")  # 32 pairs: one step an epoch either way
S7_EPOCHS = 2
S7_TIMED_EPOCHS = 1               # b: the run with every all_reduce timed
S7_CHILD_TIMEOUT = 600            # s: a gloo rank's whole run
S7_PROBE_TIMEOUT = 60             # s: the NCCL two-ranks-on-one-card probe
# b against the 1-process run: tests/test_distributed_real.py's tolerances
S7_WARMUP_RTOL, S7_POST_RTOL, S7_2D_RTOL = 1e-4, 5e-2, 1e-2
S7_GRAD_MIN_NUMEL = 1 << 20       # b: an all_reduce this large is the
S7_SCALAR_MAX_NUMEL = 4           # gradient's; this small the counts' or
                                  # the metrics'; between, a BN's


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank, world, port):
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank)}


def _s7_record(model, metrics):
    return ({k: v.item() for k, v in metrics.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()},
            {n: b.detach().clone() for n, b in model.named_buffers()
             if "running" in n})


def _nccl_ms(step, state, batch):
    """Device ms of one step under torch.profiler: all of it, the NCCL
    kernels', and the number of NCCL kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, True)
        torch.cuda.synchronize()
    busy = nccl = 0.0
    n_nccl = 0
    for e in prof.key_averages():
        # not the "nccl:*" annotations of the NCCL kernels' spans
        if e.device_type == DeviceType.CUDA and not e.key.startswith(
                "nccl:"):
            busy += e.self_device_time_total / 1e3
            if "nccl" in e.key.lower():
                nccl += e.self_device_time_total / 1e3
                n_nccl += e.count
    require(busy > 0, "the profiler recorded no device time")
    return busy, nccl, n_nccl


def run_dp_world1(cfg, dev):
    """a. NCCL at world size 1 in this process: the global-batch train step
    through replicate against the plain step from the same weights, bit
    for bit with cuDNN deterministic; collectives a step by kind, the NCCL
    kernels' device time, step ms in turns with the plain step's, peak
    memory, K1 and K2 launches."""
    import os
    import torch.distributed as dist
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed, make_mesh,
                                              replicate, shard_batch)
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    from fast3dhpe_tpu_torch.train.state import TrainState
    env = rank_env(0, 1, free_port())
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        require(init_distributed(), "init_distributed made no group")
        mesh = make_mesh()
        require(dist.get_backend() == "nccl" and mesh.size == 1
                and mesh.device == torch.device("cuda", 0),
                f"world size 1: backend {dist.get_backend()}, mesh {mesh}")
        init_s = time.perf_counter() - t0
        batch = shard_batch(mesh, train_batch(
            np.random.RandomState(SEED + 2), TRAIN_PAIRS, TRAIN_PAD,
            cfg.MODEL.IMAGE_SIZE[0]))
        model = seeded_train_model(cfg).to(dev)
        calibrate_train_head(model, batch)
        start_sd = {k: v.detach().clone()
                    for k, v in model.state_dict().items()}
        n_bn = sum(1 for k in start_sd if k.endswith("running_mean"))
        del model
        steps = {"plain": train_step_fn(cfg), "synced":
                 train_step_fn(cfg, mesh)}

        def build(name):
            m = CDRNet.from_config(cfg)
            m.load_state_dict(start_sd, strict=True)
            m.to(dev)
            if name == "synced":
                replicate(mesh, m)
            return m, TrainState.create(m, cfg, steps_per_epoch=1)

        flags = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        runs, launches, counts = {}, {}, {}
        try:
            for name in ("plain", "synced"):
                m, state = build(name)
                COUNTS.clear()
                counters = reset_counts()
                metrics = steps[name](state, batch, True)
                launches[name] = read_counts(counters)
                counts[name] = dict(COUNTS)
                runs[name] = _s7_record(m, metrics)
                del m, state
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = flags
        (pm, pg, pp, ps), (sm, sg, sp, ss) = runs["plain"], runs["synced"]
        differ = [k for k in pm if pm[k] != sm[k]]
        for what, a, b in (("grad", pg, sg), ("param", pp, sp),
                           ("stat", ps, ss)):
            differ += [f"{what} {n}" for n in a if not torch.equal(a[n], b[n])]
        require(not differ, f"the NCCL world-1 step differs from the plain "
                            f"step in {len(differ)}: {differ[:5]}")
        require_counts(launches["synced"], 1, 1, 1, 0, "the NCCL world-1 step")
        want = {"rows": 1, "bn forward": n_bn, "bn backward": n_bn,
                "gradients": 1, "metrics": 1}
        require(counts["synced"] == want and not counts["plain"],
                f"collectives a step {counts}, not {want}")
        del runs

        # in turns: plain, synced, plain, synced, ...; the first of each
        # warms up
        built = {name: build(name) for name in steps}
        times = {name: [] for name in steps}
        extra = {name: 0.0 for name in steps}
        for i in range(1 + S7_TIMED):
            for name, step in steps.items():
                st = built[name][1]
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                step(st, batch, True)
                torch.cuda.synchronize()
                if i:
                    times[name].append((time.perf_counter() - t) * 1e3)
                extra[name] = max(extra[name], (
                    torch.cuda.max_memory_allocated() - before) / 2 ** 30)
        prof = {name: _nccl_ms(steps[name], built[name][1], batch)
                for name in steps}
        step_ms = {k: statistics.median(v) for k, v in times.items()}
        out = {"init_s": init_s, "collectives": counts["synced"],
               "launches": launches["synced"], "step_ms": step_ms,
               "step_times_ms": times,
               "synced_over_plain": step_ms["synced"] / step_ms["plain"],
               "step_peak_gib": extra,
               "device_ms": {k: v[0] for k, v in prof.items()},
               "nccl_device_ms": prof["synced"][1],
               "nccl_kernels": prof["synced"][2], "bit_equal": True}
        print(f"# slice 7 a, NCCL world 1 ({TRAIN_PAIRS} pairs, "
              f"{TRAIN_PAD} padded): bit-equal to the plain step (loss, "
              f"{len(pg)} gradients and parameters, {len(ps)} BN "
              f"statistics); collectives a step {counts['synced']}; step "
              f"{step_ms['synced']:.1f} ms against the plain "
              f"{step_ms['plain']:.1f} ms ({out['synced_over_plain']:.4f}x;"
              f" {[round(t, 1) for t in times['synced']]} / "
              f"{[round(t, 1) for t in times['plain']]}); device busy "
              f"{prof['synced'][0]:.1f} / {prof['plain'][0]:.1f} ms, NCCL "
              f"kernels {prof['synced'][1]:.3f} ms in {prof['synced'][2]}; "
              f"a step's peak above "
              f"what was allocated {extra['synced']:.2f} / "
              f"{extra['plain']:.2f} GiB; launches {launches['synced']}")
        return out
    finally:
        destroy_distributed()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_child(rank, world, port, cfg_path, shared, own, out):
    """One gloo rank of b, on cuda:0 beside the other: loop_cdr.run through
    make_mesh three times, into `own` but the second. One epoch to warm
    up, so that the two runs after it are timed warm. Then as users run
    it, into the `shared` weights root without overwrite (its launches
    and collectives are counted). Then one epoch with every all_reduce
    timed (synchronised on both sides: gloo stages CUDA tensors through
    the host, so each one waits for the device anyway)."""
    import os
    import torch.distributed as dist
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed, make_mesh)
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    from fast3dhpe_tpu_torch.train import loop_cdr
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(rank_env(rank, world, port))
    require(init_distributed(backend="gloo", device="cuda:0"),
            "init_distributed made no group")
    calls = []
    orig = dist.all_reduce

    def timed(tensor, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = orig(tensor, *args, **kw)
        torch.cuda.synchronize()
        calls.append((tensor.numel(), (time.perf_counter() - t) * 1e3))
        return r

    try:
        mesh = make_mesh()
        loop_cdr.run(load_config(cfg_path), mesh=mesh, overwrite=True,
                     seed=SEED, weights_root=own, max_epochs=1)
        COUNTS.clear()
        counters = reset_counts()
        with EpochTimes() as et:
            hist = loop_cdr.run(load_config(cfg_path), mesh=mesh,
                                seed=SEED, weights_root=shared)
        launches = read_counts(counters)
        counts = dict(COUNTS)
        dist.all_reduce = timed
        timed_hist = loop_cdr.run(load_config(cfg_path), mesh=mesh,
                                  overwrite=True, seed=SEED,
                                  weights_root=own,
                                  max_epochs=S7_TIMED_EPOCHS)
    finally:
        dist.all_reduce = orig
        destroy_distributed()
    with open(out, "w") as f:
        json.dump({"history": hist, "launches": launches,
                   "counts": counts, "calls": calls,
                   "epoch_s": et.seconds, "timed_history": timed_hist}, f)


def nccl_probe_child(rank, port):
    """One of two NCCL ranks on cuda:0: one all_reduce."""
    import os
    import torch.distributed as dist
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed)
    os.environ.update(rank_env(rank, 2, port))
    init_distributed(device="cuda:0")
    try:
        t = torch.ones(1, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        print(f"NCCL probe rank {rank}: all_reduce gave {t.item()}")
    finally:
        destroy_distributed()


def _spawn_self(*args, env=None):
    import os
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, **(env or {})))


def _finish(procs, timeout):
    """(returncode or None when killed at the timeout, output) each."""
    deadline = time.perf_counter() + timeout
    out = []
    for p in procs:
        try:
            log = p.communicate(timeout=max(deadline - time.perf_counter(),
                                            1))[0]
            out.append((p.returncode, log))
        except subprocess.TimeoutExpired:
            p.kill()
            out.append((None, p.communicate()[0]))
    return out


def s7_tree(work):
    """Phase 12's MADS tree in `work`: S7_FRAMES frames of each of
    S7_MOVEMENTS a split, 768x1024 JPEGs."""
    import os
    from fast3dhpe_tpu_torch.data import synthetic
    mads = os.path.join(work, "s7_mads")
    synthetic.make_synthetic_mads(mads, n_frames=S7_FRAMES,
                                  movements=S7_MOVEMENTS, img_w=RAW_W,
                                  img_h=RAW_H)
    return mads


def s7_cfg(work, mads, pairs, name, epochs=S7_EPOCHS, cache_bytes=0):
    """configs/mads_3d.yaml on the tree at `pairs` a batch, augmentation
    off, WARMUP 1, written to <work>/<name>.yaml."""
    import os
    return app_config(
        "configs/mads_3d.yaml", os.path.join(work, f"{name}.yaml"), mads,
        MODEL={"PRETRAINED": "", "NAME": name},
        DATASET={"FLIP": False, "ROT_FACTOR": 0, "SCALE_FACTOR": 0,
                 "OCCLUSION": "None", "DEVICE_CACHE_BYTES": cache_bytes},
        TRAIN={"BATCH_SIZE": pairs, "EPOCH": epochs, "WARMUP": 1},
        TEST={"BATCH_SIZE": pairs})


def run_dp_gloo(dev, work):
    """b. Two gloo ranks sharing cuda:0, each `loop_cdr.run(cfg,
    mesh=make_mesh())` at 16 pairs, against one process at 32, on a MADS
    tree of 32 pairs a split (one step an epoch), augmentation off; the
    NCCL two-ranks probe beside them."""
    import os
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.train import loop_cdr
    t0 = time.perf_counter()
    mads = s7_tree(work)
    n_pairs = len(S7_MOVEMENTS) * S7_FRAMES
    rank_cfg, one_cfg = (s7_cfg(work, mads, n_pairs // 2, "dist"),
                         s7_cfg(work, mads, n_pairs, "single"))
    tree_s = time.perf_counter() - t0
    probe_port, port = free_port(), free_port()
    probe = [_spawn_self("--nccl-probe", r, probe_port,
                         env={"NCCL_DEBUG": "WARN"}) for r in range(2)]
    shared = os.path.join(work, "w_shared")
    roots = [os.path.join(work, f"w_rank{r}") for r in range(2)]
    outs = [os.path.join(work, f"rank{r}.json") for r in range(2)]
    t = time.perf_counter()
    ranks = [_spawn_self("--dp-child", r, 2, port, rank_cfg, shared,
                         roots[r], outs[r]) for r in range(2)]
    probed = _finish(probe, S7_PROBE_TIMEOUT)
    done = _finish(ranks, S7_CHILD_TIMEOUT)
    ranks_s = time.perf_counter() - t
    for r, (rc, log) in enumerate(done):
        require(rc == 0, f"gloo rank {r} exited {rc}:\n{log[-3000:]}")
    said = [[ln for ln in log.splitlines()
             if "Duplicate" in ln or "Error" in ln or "probe" in ln][-2:]
            or log.strip().splitlines()[-2:] for _, log in probed]
    nccl_probe = {"returncodes": [rc for rc, _ in probed], "said": said}
    print(f"# slice 7 b, NCCL with two ranks on cuda:0 (a probe of the "
          f"machine, not a path of the port): exit codes "
          f"{nccl_probe['returncodes']} (None: killed after "
          f"{S7_PROBE_TIMEOUT} s); it said {said}")
    got = []
    for out in outs:
        with open(out) as f:
            got.append(json.load(f))
    h0, h1 = got[0]["history"], got[1]["history"]
    for k in h0:
        if not k.endswith("_per_sec"):
            require(h0[k] == h1[k], f"the ranks' {k} differ: {h0[k]} / "
                                    f"{h1[k]}")
    counters = reset_counts()
    t = time.perf_counter()
    ref = loop_cdr.run(load_config(one_cfg), overwrite=True, seed=SEED,
                       weights_root=os.path.join(work, "w_single"),
                       device=dev.type)
    one_launches = read_counts(counters)
    one_s = time.perf_counter() - t
    require(h0["train_loss"][0] > 1e-5 and h0["grad_norm"][0] > 1e-5,
            f"vacuous training: {h0}")

    errs, decades = _vs_one_process(h0, ref, "gloo ranks")
    print(f"# slice 7 b, 2 gloo ranks x {n_pairs // 2} pairs against 1 "
          f"process x {n_pairs}: relative {errs}, decades {decades}; "
          f"rank 0 {h0}; 1 process {ref}")
    name = load_config(rank_cfg).MODEL.NAME
    files = sorted(os.listdir(os.path.join(shared, name)))
    files0 = sorted(os.listdir(os.path.join(roots[0], name)))
    left1 = [os.path.join(d, f) for d, _, fs in os.walk(roots[1])
             for f in fs] if os.path.exists(roots[1]) else []
    require(os.listdir(shared) == [name]
            and files == files0 == ["latest.opt.pt", "latest.pth"]
            and not left1, f"checkpoints: shared root {files}, rank 0's "
                           f"own {files0}, rank 1's own {left1}")
    launches = [g["launches"] for g in got]
    steps = S7_EPOCHS       # one train step and one eval batch an epoch
    for r, n in enumerate(launches):
        require(n == {"soft_argmax": 2 * steps, "soft_argmax_bwd": steps,
                      "fused_bottleneck": 0},
                f"gloo rank {r}: launches {n} over {steps} train steps and "
                f"{steps} eval batches")
    # the history's throughput counts the global batch's pairs
    step_ms = [[n_pairs / pps * 1e3
                for pps in g["history"]["train_pairs_per_sec"]] for g in got]
    timed_step_ms = [[n_pairs / pps * 1e3 for pps in
                      g["timed_history"]["train_pairs_per_sec"]]
                     for g in got]
    parts = []
    for g in got:
        grad = [ms for n, ms in g["calls"] if n >= S7_GRAD_MIN_NUMEL]
        bn = [ms for n, ms in g["calls"]
              if S7_SCALAR_MAX_NUMEL < n < S7_GRAD_MIN_NUMEL]
        small = [ms for n, ms in g["calls"] if n <= S7_SCALAR_MAX_NUMEL]
        parts.append({"gradient_ms_a_step": sum(grad) / S7_TIMED_EPOCHS,
                      "bn_ms_a_step": sum(bn) / S7_TIMED_EPOCHS,
                      "counts_and_metrics_ms": sum(small),
                      "calls": {"gradient": len(grad), "bn": len(bn),
                                "counts_and_metrics": len(small)},
                      "gradient_numel": max(n for n, _ in g["calls"])})
    out = {"tree_s": tree_s, "ranks_s": ranks_s, "one_process_s": one_s,
           "vs_one_process": errs, "decades": decades,
           "step_ms_by_rank": step_ms,
           "timed_step_ms_by_rank": timed_step_ms, "allreduce": parts,
           "collectives_by_rank": [g["counts"] for g in got],
           "epoch_s_by_rank": [g["epoch_s"] for g in got],
           "launches_by_rank": launches, "one_process_launches": one_launches,
           "one_process_step_ms": [n_pairs / pps * 1e3 for pps in
                                   ref["train_pairs_per_sec"]],
           "nccl_probe": nccl_probe}
    print(f"# slice 7 b: ranks' train step {step_ms} ms by epoch (1 process"
          f" {out['one_process_step_ms']}); with every all_reduce timed "
          f"{timed_step_ms} ms; gloo all_reduce a step "
          + "; ".join(f"rank {r}: gradient {p['gradient_ms_a_step']:.1f} ms "
                      f"({p['gradient_numel']} fp32), BN "
                      f"{p['bn_ms_a_step']:.1f} ms ({p['calls']['bn']} calls "
                      f"in {S7_TIMED_EPOCHS} step)" for r, p in
                      enumerate(parts))
          + f"; launches {launches}; ranks' wall {ranks_s:.1f} s, 1 process "
          f"{one_s:.1f} s")
    return out


def run_slice7(cfg, dev, smi):
    """Phase 12: data parallelism (a, b)."""
    t0 = time.perf_counter()
    out = {"a_nccl_world1": run_dp_world1(cfg, dev)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        out["b_gloo_two_ranks"] = run_dp_gloo(dev, work)
    out["launches"] = {
        "NCCL world 1 step": out["a_nccl_world1"]["launches"],
        **{f"gloo rank {r}, {S7_EPOCHS} epochs": n for r, n in enumerate(
            out["b_gloo_two_ranks"]["launches_by_rank"])},
        "1 process, the same epochs":
            out["b_gloo_two_ranks"]["one_process_launches"]}
    out["seconds"] = time.perf_counter() - t0
    print(f"# slice 7 ({smi}): {out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------- slice 8

S8_PAIRS = (1, 4)                 # the checked fp32 and bf16 forwards
S8_INT8_PAIRS = 2
S8_INT8_M = 2                     # the int8 forward and eval step: M = 2
S8_EVAL_PAIRS = 4                 # the eval step's batch
S8_CALIB_PAIRS = 16               # the pack: S6_CALIB batches of 16 pairs
S8_HALOS = 38                     # a CDRNet-101 forward's halo exchanges:
#                                   the stem, the max-pool, 33 3x3 convs
#                                   (one a block, fused or not), 3 deconvs
S8_FP32_KP_PX, S8_FP32_HM = 1e-3, 1e-4   # px; of max|heatmap|
# bf16: the split runs cuDNN and K3 on planes of other heights, whose
# rounding moves a heatmap as a frame's row in its batch does: PR 6
# measured 8.9e-3 of max|heatmap| and 0.048 px for that (ROADMAP C);
# the bounds take a little over twice the heatmaps' and ten times the
# keypoints'
S8_BF16_HM, S8_BF16_KP_PX = 2e-2, 0.5
S8_EVAL_RTOL, S8_EVAL_3D_RTOL = 1e-4, 1e-2
# c: 192 px over M = 4: 48 rows a rank, which the encoder splits through
# layer3 (12, 6, 3 rows) and gathers before layer4.0, whose stride-2 window
# finds 3 rows a rank (parallel/spatial.py gather_point)
S8_GATHER_SIZE, S8_GATHER_M, S8_GATHER_PAIRS = 192, 4, 1
S8_GATHER_AT = "layer4.0"
S8_GATHER_HALOS = 32              # the stem, the max-pool, layers 1-3's 30
S8_GATHER_K3 = 3                  # layer1.0-1.2 fuse at 48 x 48
S8_TIMED = 10                     # timed forwards at 1 pair, each way
S8_HALO_TIMED = 3                 # forwards with every all_reduce timed
S8_CHILD_TIMEOUT = 300            # s: a gloo rank's whole run


def s8_model(spec, dev, kind):
    """The phase's CDRNet of `kind` ("fp32", "bf16": fused_inference) on
    `dev`, eval mode, from the saved weights."""
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    model = CDRNet(num_joints=spec["joints"], num_layers=spec["layers"],
                   fused_inference=kind == "bf16", dtype=dtype)
    model.load_state_dict(torch.load(spec["weights"], weights_only=True),
                          strict=True)
    return model.to(dev).eval()


def s8_forward(model, imgs, projs):
    """One counted forward: (pred_2d, pred_3d, heatmaps) on the CPU, the
    kernels' launches and the collectives by kind."""
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    COUNTS.clear()
    counters = reset_counts()
    with torch.inference_mode():
        kp, p3, hm = model(imgs, projs, return_heatmaps=True)
    launches = read_counts(counters)
    return {"kp": kp.cpu(), "p3": p3.cpu(), "hm": hm.float().cpu(),
            "launches": launches, "counts": dict(COUNTS)}


def s8_repeated(model, imgs, projs):
    """s8_forward, whether a second forward on the same inputs gives the
    same pred_2d and heatmaps bit for bit, and its pred_3d."""
    out = s8_forward(model, imgs, projs)
    again = s8_forward(model, imgs, projs)
    out["repeat_equal"] = (torch.equal(again["kp"], out["kp"])
                           and torch.equal(again["hm"], out["hm"]))
    out["p3_again"] = again["p3"]
    return out


def s8_int8_forward(model, imgs, projs, keep_codes=False):
    """The int8 forward with the encoder's last codes (and their scale)
    and cf_out's recorded, and with keep_codes every requant's codes."""
    from fast3dhpe_tpu_torch.ops import quant as Q
    codes, scales, orig = [], [], Q.requant

    def recorded(y, s):
        out = orig(y, s)
        codes.append(out)
        scales.append(s)
        return out

    Q.requant = recorded
    try:
        out = s8_forward(model, imgs, projs)
    finally:
        Q.requant = orig
    cf = len(codes) - 4               # cf_out, then the three deconvs
    out.update(n_codes=len(codes), enc_last=codes[cf - 1].cpu(),
               enc_scale=scales[cf - 1].cpu(), cf_out=codes[cf].cpu())
    if keep_codes:
        out["codes"] = [c.cpu() for c in codes]
    return out


def s8_cf_rows(model8, enc_last, scale, projs, m):
    """The unsplit int8 executor's CanonicalFusion and cf_out requant
    (cdrnet_int8_apply's steps, no mesh) on each model rank's rows of the
    encoder's last codes: the plane height a rank of M = m runs the trunk
    at. CanonicalFusion is per pixel, so these are a split rank's cf_out
    codes if its encoder codes are the unsplit rows."""
    from fast3dhpe_tpu_torch.geometry.triangulation import pinv_projection
    from fast3dhpe_tpu_torch.models import quantized as qz
    ctx = qz._Int8Ctx(model8.rt)
    projs = projs.float()
    h = enc_last.shape[1] // m
    rows = []
    with torch.inference_mode():
        for j in range(m):
            z = ctx.dequant((enc_last[:, j * h:(j + 1) * h].contiguous(),
                             scale))
            fused = qz._cf_apply(model8.rt.cf, z.permute(0, 3, 1, 2), projs,
                                 pinv_projection(projs))
            rows.append(ctx.requantize_external(
                "cf_out", fused.permute(0, 2, 3, 1))[0].cpu())
    return rows


def s8_eval(model, batch, dev, mesh=None):
    """make_eval_step_cdr on the batch (this rank's rows of it on a
    spatial mesh): its metrics, launches and collectives."""
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    from fast3dhpe_tpu_torch.train.state import TrainState
    from fast3dhpe_tpu_torch.train.steps import make_eval_step_cdr
    step = make_eval_step_cdr(make_loss("JointsMSESmooth", True), mesh=mesh)
    COUNTS.clear()
    counters = reset_counts()
    m = step(TrainState(model, None), batch, True)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "launches": read_counts(counters), "counts": dict(COUNTS)}


def s8_wall_ms(fn, iters=S8_TIMED):
    """Median wall ms of fn() between synchronisations, after two warm
    calls."""
    for _ in range(2):
        fn()
    sync()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def s8_child(rank, world, port, work):
    """One gloo rank of phase 13 on the card beside the others: the mesh
    of `world` model ranks (M = world, D = 1), the fp32, bf16 fused and
    int8 forwards and the eval step on this rank's rows (with spec
    "gather", c's fp32, bf16 and int8 forwards at 192 px too), then, once
    the parent is idle, the bf16 and fp32 forwards timed, and the halo
    all_reduces timed in a run of their own."""
    import os
    import torch.distributed as dist
    from fast3dhpe_tpu_torch.models import quantized as qz
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed, make_mesh,
                                              replicate, shard_batch_spatial)
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    os.environ.update(rank_env(rank, world, port))
    require(init_distributed(backend="gloo", device=spec["device"]),
            "init_distributed made no group")
    out = {}
    try:
        mesh = make_mesh(model_parallel=world)
        dev = mesh.device
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        models = {kind: replicate(mesh, s8_model(spec, dev, kind))
                  for kind in spec["kinds"]}
        for kind, model in models.items():
            for pairs in spec["pairs"][kind]:
                b = shard_batch_spatial(mesh, {"image": inp["imgs"][:pairs],
                                               "proj": inp["projs"][:pairs]})
                out[f"{kind} {pairs}"] = s8_forward(model, b["image"],
                                                    b["proj"])
        if spec["int8"]:
            model8 = replicate(mesh, qz.cdrnet_int8(
                qz.load_pack(spec["pack"]), device=dev))
            b = shard_batch_spatial(mesh, {
                "image": inp["imgs"][:S8_INT8_PAIRS],
                "proj": inp["projs"][:S8_INT8_PAIRS]})
            out["int8"] = s8_int8_forward(model8, b["image"], b["proj"])
            out["eval"] = s8_eval(models["fp32"], shard_batch_spatial(
                mesh, inp["eval"]), dev, mesh)
        gsize = spec["gather"]        # c's image size, 0 for none
        if gsize:
            b192 = shard_batch_spatial(mesh, {"image": inp["imgs192"],
                                              "proj": inp["projs192"]})
            for kind, model in models.items():
                out[f"{kind} {gsize}"] = s8_repeated(model, b192["image"],
                                                     b192["proj"])
            model8 = replicate(mesh, qz.cdrnet_int8(
                qz.load_pack(spec["pack"]), device=dev))
            out[f"int8 {gsize}"] = s8_int8_forward(
                model8, b192["image"], b192["proj"], keep_codes=True)
            del model8
        deadline = time.perf_counter() + S8_CHILD_TIMEOUT
        while (not os.path.exists(os.path.join(work, "go"))
               and time.perf_counter() < deadline):
            time.sleep(0.05)
        require(os.path.exists(os.path.join(work, "go")),
                f"rank {rank}: the parent wrote no `go` in "
                f"{S8_CHILD_TIMEOUT} s, so its forwards would share the card")
        dist.barrier()
        if spec["int8"]:
            # the split int8 decoder on the unsplit forward's cf_out codes
            # (which the parent wrote before `go`): this rank's rows
            codes = torch.load(os.path.join(work, "cf_out.pt"))
            h = codes.shape[1] // world
            with torch.inference_mode():
                hm = qz._decoder_walk(qz._Int8Ctx(model8.rt, mesh), (
                    codes[:, mesh.model_rank * h:(mesh.model_rank + 1) * h]
                    .to(dev),
                    model8.rt.scale("cf_out")))
            out["int8"]["decoder_on_unsplit_codes"] = hm.cpu()
            del model8
        b = shard_batch_spatial(mesh, {"image": inp["imgs"][:1],
                                       "proj": inp["projs"][:1]})
        times = {}
        for kind, model in models.items():
            with torch.inference_mode():
                times[f"{kind} wall_ms"] = s8_wall_ms(
                    lambda: model(b["image"], b["proj"]))
                if gsize:
                    times[f"{kind} {gsize} wall_ms"] = s8_wall_ms(
                        lambda: model(b192["image"], b192["proj"]))
        calls, orig = [], dist.all_reduce

        def timed(tensor, *args, **kw):
            sync()
            t = time.perf_counter()
            r = orig(tensor, *args, **kw)
            sync()
            calls.append((tensor.numel() * tensor.element_size(),
                          (time.perf_counter() - t) * 1e3))
            return r

        dist.all_reduce = timed
        try:
            for kind, model in models.items():
                per = []
                for _ in range(S8_HALO_TIMED):
                    calls.clear()
                    COUNTS.clear()
                    t = time.perf_counter()
                    with torch.inference_mode():
                        model(b["image"], b["proj"])
                    sync()
                    per.append({"wall_ms": (time.perf_counter() - t) * 1e3,
                                "halo_ms": sum(ms for _, ms in calls[:-1]),
                                "keypoints_ms": calls[-1][1],
                                "calls": len(calls),
                                "bytes": [n for n, _ in calls]})
                require(all(p["calls"] == spec["halos"] + 1 for p in per),
                        f"{kind}: timed forwards made "
                        f"{[p['calls'] for p in per]} all_reduces")
                times[f"{kind} timed"] = per
        finally:
            dist.all_reduce = orig
        out["times"] = times
    finally:
        destroy_distributed()
    torch.save(out, os.path.join(work, f"out_{world}_{rank}.pt"))


def s8_references(spec, inp, dev):
    """The unsplit forwards, int8 forward and eval step in this process,
    their collectives (none: no mesh) and launches."""
    from fast3dhpe_tpu_torch.models import quantized as qz
    ref = {}
    models = {kind: s8_model(spec, dev, kind) for kind in ("fp32", "bf16")}
    for kind, model in models.items():
        for pairs in S8_PAIRS:
            ref[f"{kind} {pairs}"] = s8_forward(
                model, inp["imgs"][:pairs].to(dev),
                inp["projs"][:pairs].to(dev))
    model8 = qz.cdrnet_int8(qz.load_pack(spec["pack"]), device=dev)
    projs8 = inp["projs"][:S8_INT8_PAIRS].to(dev)
    ref["int8"] = s8_int8_forward(model8, inp["imgs"][:S8_INT8_PAIRS].to(dev),
                                  projs8)
    ref["int8"]["cf_out_rows"] = s8_cf_rows(
        model8, ref["int8"]["enc_last"].to(dev),
        ref["int8"]["enc_scale"].to(dev),
        projs8, S8_INT8_M)
    ref["eval"] = s8_eval(models["fp32"], on_device(inp["eval"], dev), dev)
    x192, p192 = inp["imgs192"].to(dev), inp["projs192"].to(dev)
    for kind, model in models.items():
        ref[f"{kind} {S8_GATHER_SIZE}"] = s8_repeated(model, x192, p192)
    ref[f"int8 {S8_GATHER_SIZE}"] = s8_int8_forward(model8, x192, p192,
                                                    keep_codes=True)
    return ref, models


def s8_finish(procs, timeout, what):
    done = _finish(procs, timeout)
    for r, (code, log) in enumerate(done):
        for line in log.splitlines():
            if line.startswith("#"):
                print(f"# {what} rank {r}: {line[1:].strip()}")
        require(code == 0, f"{what}: rank {r} exited {code}:\n{log[-3000:]}")


def s8_dlt(kp, projs, dev):
    """The DLT of (B, V, J, 2) keypoints on the card, on the CPU."""
    from fast3dhpe_tpu_torch.geometry.triangulation import dlt_triangulate
    b, v, j, _ = kp.shape
    with torch.inference_mode():
        proj_j = projs.to(dev).float()[:, None].expand(b, j, v, 3, 4)
        return dlt_triangulate(proj_j, kp.to(dev).transpose(1, 2)).cpu()


def s8_dlt_noise(kp, projs, dev):
    """The DLT's own change under pred_2d x (1 +- 1e-7), on the card, and
    the scene's scale (the larger of the points' extent and
    RIG_DISTANCE_MM): phase 11's measure of how far rounding in pred_2d
    moves an untrained net's pred_3d (finish_export)."""
    dlt, up, down = (s8_dlt(kp * f, projs, dev)
                     for f in (1.0, 1.0 + 1e-7, 1.0 - 1e-7))
    scale = max(float(dlt.abs().max()), RIG_DISTANCE_MM)
    return max(float((d - dlt).abs().max()) for d in (up, down)) / scale, scale


def s8_check(outs, ref, m, what, kinds, projs, dev, exchanges=None):
    """The model ranks against each other (bit-equal keypoints and 3D
    points where split; where the forward gathers, each rank runs the rest
    itself, and their keypoints within the bound below) and against the
    unsplit forward: fp32 keypoints within S8_FP32_KP_PX, heatmap rows
    within S8_FP32_HM of max|heatmap|; bf16 within S8_BF16_*; each rank's
    pred_3d within EXPORT_ATOL of the scene's scale from the DLT of its own
    pred_2d on the card, and against the unsplit pred_3d reported only
    (the DLT of an untrained net's keypoints amplifies their rounding by
    an amount that changes from call to call); `exchanges` a forward
    (default S8_HALOS halos and one keypoint combine; where the forward
    gathers, its heatmaps are whole, each held against the whole unsplit
    one); K1 once a forward a rank, K3 once a block the unsplit forward
    fuses."""
    exchanges = exchanges or {"halo": S8_HALOS, "keypoints": 1}
    gathered = "gather" in exchanges
    errs = {}
    for key in kinds:
        got, want = [o[key] for o in outs], ref[key]
        fp32 = key.startswith("fp32")
        hm_tol, kp_tol = ((S8_FP32_HM, S8_FP32_KP_PX) if fp32
                          else (S8_BF16_HM, S8_BF16_KP_PX))
        ranks_equal = all(torch.equal(g["kp"], got[0]["kp"])
                          and torch.equal(g["p3"], got[0]["p3"])
                          for g in got[1:])
        ranks_gap = max(float((g["kp"] - got[0]["kp"]).abs().max())
                        for g in got)
        # split, the ranks combine one set of statistics; gathered, each
        # rank runs the rest of the network on its own, and cuDNN's
        # kernels need not round alike in two processes
        require(ranks_equal or (gathered and ranks_gap <= kp_tol),
                f"{what} {key}: model ranks' pred_2d / pred_3d differ from "
                f"rank 0's by up to {ranks_gap} px")
        h = want["hm"].shape[2] // m
        scale = float(want["hm"].abs().max())
        hm_err = max(float((g["hm"] - (
            want["hm"] if "gather" in exchanges
            else want["hm"][:, :, j * h:(j + 1) * h])).abs().max())
            for j, g in enumerate(got))
        hm_err /= scale
        kp_err = float((got[0]["kp"] - want["kp"]).abs().max())
        p3_rel = float(((got[0]["p3"] - want["p3"]).norm(dim=-1)
                        / want["p3"].norm(dim=-1)).max())
        noise, scale3 = s8_dlt_noise(want["kp"], projs[:want["kp"].shape[0]],
                                     dev)
        p3_err = float((got[0]["p3"] - want["p3"]).abs().max()) / scale3
        # pred_3d is the DLT of pred_2d: held to the DLT of the rank's own
        # pred_2d, with pred_2d held against the unsplit forward's above.
        # Against the unsplit pred_3d it is reported only: on the card an
        # fp32 forward does not repeat its rounding (a second unsplit call
        # moves pred_3d too, s8_repeated), and the DLT of an untrained
        # net's keypoints amplifies a 4.6e-5 px move of pred_2d to 1e-3 of
        # the scene's scale in one call and far less in another
        again = (float((want["p3_again"] - want["p3"]).abs().max()) / scale3
                 if gathered else None)
        self_err = max(float((g["p3"] - s8_dlt(
            g["kp"], projs[:want["kp"].shape[0]], dev)).abs().max())
            for g in got) / scale3
        print(f"# slice 8 {what} {key}: heatmaps {hm_err:.3g} of max "
              f"(bound {hm_tol}), pred_2d {kp_err:.3g} px (bound {kp_tol}), "
              f"pred_3d against the DLT of the rank's own pred_2d "
              f"{self_err:.3g} of the scene's scale (bound {EXPORT_ATOL}); "
              f"against the unsplit forward's {p3_err:.3g} of the scene's "
              f"scale (the DLT's own change under pred_2d x (1 +- 1e-7) "
              f"{noise:.3g}), {p3_rel:.3g} relative a point; model ranks "
              f"bit-equal {ranks_equal} (pred_2d up to {ranks_gap:.3g} px "
              f"apart)"
              + (f"; a second forward bit-equal to the first, by rank "
                 f"{[g['repeat_equal'] for g in got]}, unsplit "
                 f"{want['repeat_equal']} (its pred_3d moved {again:.3g} "
                 f"of the scene's scale)" if gathered else "")
              + f"; launches {[g['launches'] for g in got]}; exchanges "
              f"{got[0]['counts']}")
        require(hm_err <= hm_tol and kp_err <= kp_tol
                and self_err <= EXPORT_ATOL,
                f"{what} {key}: heatmaps {hm_err} of max, pred_2d {kp_err} "
                f"px against the unsplit forward, pred_3d {self_err} of the "
                f"scene's scale from the DLT of its own pred_2d")
        for j, g in enumerate(got):
            require(g["counts"] == exchanges,
                    f"{what} {key} rank {j}: exchanges {g['counts']}, "
                    f"predicted {exchanges}")
            require_counts(g["launches"], 1, 1, 0,
                           want["launches"]["fused_bottleneck"],
                           f"{what} {key} rank {j}")
        errs[key] = {"hm": hm_err, "kp_px": kp_err, "p3_rel": p3_rel,
                     "p3_of_scale": p3_err, "dlt_noise": noise,
                     "ranks_bit_equal": ranks_equal,
                     "ranks_kp_gap_px": ranks_gap,
                     "unsplit_repeat_p3_of_scale": again,
                     "p3_vs_own_dlt": self_err}
    return errs


def s8_check_int8(outs, ref, m, pairs=S8_INT8_PAIRS):
    """Int8 split over M = 2 against the unsplit int8 forward on the same
    pack: the encoder's last codes bit-equal row by row (exact int32
    arithmetic, halo rows delivered bit for bit); each rank's cf_out codes
    bit-equal to the unsplit executor's CanonicalFusion run on that rank's
    rows of the encoder's codes (s8_cf_rows: the same plane height, no
    mesh), and within one code of the unsplit forward's (the bf16 trunk
    run at the whole height); the split decoder on the unsplit cf_out codes
    bit-equal to the unsplit heatmaps (the transposed convolutions'
    halos); pred_2d bit-equal across the model ranks; heatmaps and pred_2d
    within phase 11's card-vs-CPU bounds (run_int8)."""
    want = ref["int8"]
    h = want["enc_last"].shape[1] // m
    enc_equal = all(torch.equal(o["int8"]["enc_last"],
                                want["enc_last"][:, j * h:(j + 1) * h])
                    for j, o in enumerate(outs))
    cf_rows_equal = all(torch.equal(o["int8"]["cf_out"],
                                    want["cf_out_rows"][j])
                        for j, o in enumerate(outs))
    hc = want["cf_out"].shape[1] // m
    diffs = [(o["int8"]["cf_out"].int()
              - want["cf_out"][:, j * hc:(j + 1) * hc].int()).abs()
             for j, o in enumerate(outs)]
    flips = sum(int(d.gt(0).sum()) for d in diffs)
    max_flip = max(int(d.max()) for d in diffs)
    hh = want["hm"].shape[2] // m
    dec_equal = all(torch.equal(
        o["int8"]["decoder_on_unsplit_codes"].reshape(
            want["hm"][:, :, :hh].shape),
        want["hm"][:, :, j * hh:(j + 1) * hh]) for j, o in enumerate(outs))
    hm_err = max(float((o["int8"]["hm"] - want["hm"][:, :, j * hh:(j + 1)
                                                      * hh]).abs().max())
                 for j, o in enumerate(outs)) / float(want["hm"].abs().max())
    kp_err = float((outs[0]["int8"]["kp"] - want["kp"]).abs().max())
    same = all(torch.equal(o["int8"]["kp"], outs[0]["int8"]["kp"])
               for o in outs)
    print(f"# slice 8 int8 at M={m}, {pairs} pairs: encoder's last "
          f"codes bit-equal {enc_equal}; cf_out bit-equal to the unsplit "
          f"CanonicalFusion on the ranks' rows {cf_rows_equal}; against the "
          f"unsplit forward's cf_out {flips} of {want['cf_out'].numel()} "
          f"codes differ, by at most {max_flip}; the split decoder on the "
          f"unsplit cf_out codes bit-equal {dec_equal}; heatmaps "
          f"{hm_err:.3g} of max, pred_2d {kp_err:.3g} px; model ranks equal "
          f"{same}; launches {[o['int8']['launches'] for o in outs]}; "
          f"exchanges {outs[0]['int8']['counts']}")
    require(enc_equal and cf_rows_equal and dec_equal and same,
            "int8 split: the encoder's codes, cf_out against the unsplit "
            "CanonicalFusion on the same rows, the decoder on the same "
            "codes or the model ranks' pred_2d differ")
    require(max_flip <= 1, f"int8 split: cf_out codes differ from the "
                           f"unsplit forward's by up to {max_flip}")
    require(hm_err < HM_MAX_TOL and kp_err < 2.0,
            f"int8 split: heatmaps {hm_err}, pred_2d {kp_err} px")
    for j, o in enumerate(outs):
        require(o["int8"]["counts"] == {"halo": S8_HALOS, "keypoints": 1},
                f"int8 rank {j}: exchanges {o['int8']['counts']}")
        require_counts(o["int8"]["launches"], 1, 1, 0, 0, f"int8 rank {j}")
    return {"encoder_codes_equal": enc_equal,
            "cf_out_equal_on_rows": cf_rows_equal,
            "decoder_on_same_codes_equal": dec_equal, "cf_out_flips": flips,
            "cf_out_max_flip": max_flip,
            "cf_out_codes": want["cf_out"].numel(), "hm": hm_err,
            "kp_px": kp_err}


def s8_check_int8_gathered(outs, ref, m, n_split):
    """c's int8 forward at 192 px over M = m against the unsplit int8
    forward on the same pack: the n_split codes before the gather (the
    input, the stem and 3 a block of layers 1-3) bit-equal row by row;
    after it (layer4, cf_out, the decoder) each rank's whole codes
    against the unsplit ones, reported; pred_2d bit-equal across the
    model ranks and, with the heatmaps, within phase 11's card-vs-CPU
    bounds; S8_GATHER_HALOS halos and one gather, K1 once, no K3."""
    key = f"int8 {S8_GATHER_SIZE}"
    want = ref[key]
    split_equal, after_equal = True, True
    for j, o in enumerate(outs):
        got = o[key]["codes"]
        require(len(got) == len(want["codes"]),
                f"{key} rank {j}: {len(got)} requants, unsplit "
                f"{len(want['codes'])}")
        for i, (a, b) in enumerate(zip(got, want["codes"])):
            if i < n_split:
                h = b.shape[1] // m
                split_equal &= (a.shape[1] == h
                                and torch.equal(a, b[:, j * h:(j + 1) * h]))
            else:
                after_equal &= torch.equal(a, b)
    hm_err = max(float((o[key]["hm"] - want["hm"]).abs().max())
                 for o in outs) / float(want["hm"].abs().max())
    kp_err = float((outs[0][key]["kp"] - want["kp"]).abs().max())
    same = all(torch.equal(o[key]["kp"], outs[0][key]["kp"]) for o in outs)
    print(f"# slice 8 c {key} at M={m}: the {n_split} codes before the "
          f"gather bit-equal row by row {split_equal}; the codes after it "
          f"(whole) bit-equal {after_equal}; heatmaps {hm_err:.3g} of max, "
          f"pred_2d {kp_err:.3g} px; model ranks equal {same}; launches "
          f"{[o[key]['launches'] for o in outs]}; exchanges "
          f"{outs[0][key]['counts']}")
    require(split_equal and same, f"{key}: the codes before the gather or "
                                  f"the model ranks' pred_2d differ")
    require(hm_err < HM_MAX_TOL and kp_err < 2.0,
            f"{key}: heatmaps {hm_err}, pred_2d {kp_err} px")
    for j, o in enumerate(outs):
        require(o[key]["counts"] == {"halo": S8_GATHER_HALOS, "gather": 1},
                f"{key} rank {j}: exchanges {o[key]['counts']}")
        require_counts(o[key]["launches"], 1, 1, 0, 0, f"{key} rank {j}")
    return {"codes_before_gather": n_split,
            "codes_before_gather_equal": split_equal,
            "codes_after_gather_equal": after_equal, "hm": hm_err,
            "kp_px": kp_err}


def s8_check_eval(outs, ref):
    """The split eval step's metrics against the unsplit step's: n exact,
    the loss and MPJPE2D within S8_EVAL_RTOL, MPJPE3D within
    S8_EVAL_3D_RTOL; the same on every rank."""
    want = ref["eval"]["metrics"]
    got = outs[0]["eval"]["metrics"]
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
           for k in want}
    print(f"# slice 8 eval step: split {got}, unsplit {want}; exchanges "
          f"{outs[0]['eval']['counts']}")
    require(all(o["eval"]["metrics"] == got for o in outs),
            "eval step: the ranks' metrics differ")
    require(got["n"] == want["n"]
            and all(rel[k] <= S8_EVAL_RTOL for k in ("loss", "mpjpe_2d",
                                                      "e2_sum"))
            and all(rel[k] <= S8_EVAL_3D_RTOL for k in ("mpjpe_3d",
                                                         "e3_sum")),
            f"eval step: split against unsplit, relative {rel}")
    for j, o in enumerate(outs):
        require(o["eval"]["counts"] == {"rows": 1, "halo": S8_HALOS,
                                        "keypoints": 1, "metrics": 1},
                f"eval rank {j}: exchanges {o['eval']['counts']}")
    return rel


def s8_times(outs, one, m):
    """Each rank's wall ms at 1 pair beside the unsplit forward's, and the
    halo all_reduces' ms of a forward (from the timed run)."""
    t = {}
    for kind in one:
        per_rank = []
        for o in outs:
            runs = o["times"][f"{kind} timed"]
            per_rank.append({
                "wall_ms": o["times"][f"{kind} wall_ms"],
                "timed_wall_ms": statistics.median(r["wall_ms"]
                                                   for r in runs),
                "halo_ms": statistics.median(r["halo_ms"] for r in runs),
                "keypoints_ms": statistics.median(r["keypoints_ms"]
                                                  for r in runs),
                "halo_bytes": sum(runs[0]["bytes"][:-1])})
        t[kind] = {"unsplit_wall_ms": one[kind], "ranks": per_rank}
        print(f"# slice 8 M={m} {kind} at 1 pair: unsplit "
              f"{one[kind]:.1f} ms; ranks' wall "
              + ", ".join(f"{p['wall_ms']:.1f}" for p in per_rank)
              + " ms; in the timed run wall "
              + ", ".join(f"{p['timed_wall_ms']:.1f}" for p in per_rank)
              + f" ms, of which the {S8_HALOS} halo all_reduces "
              + ", ".join(f"{p['halo_ms']:.1f}" for p in per_rank)
              + f" ms ({per_rank[0]['halo_bytes']} bytes a rank's buffer "
              f"over a forward) and the keypoint combine "
              + ", ".join(f"{p['keypoints_ms']:.2f}" for p in per_rank)
              + " ms")
    return t


def s8_shapes_checked(size, joints):
    """Every K1 input and K3 tile that phase 13 gives the kernels is one
    that step 2 holds against its plain version: K1 at SOFTARGMAX_SHAPES,
    K3 at HALOED for every pair count in S8_PAIRS; at 192 px over M = 4
    (c) the whole heatmap to K1 after the gather, and layer1.0-1.2's
    haloed tiles and whole plane to K3."""
    k1 = {shape for _, shape in SOFTARGMAX_SHAPES}
    hm = S8_GATHER_SIZE // 4
    shape = (2 * S8_GATHER_PAIRS, hm, hm, joints)
    require(shape in k1, f"phase 13 c gives K1 {shape}, which step 2 does "
                         f"not check")
    rows = hm // S8_GATHER_M
    tiles = {(rows + 1, hm), (rows + 2, hm), (hm, hm)}
    for name in ("layer1.0", "layer1.1"):
        require(tiles <= set(HALOED[name][3]),
                f"phase 13 c gives K3 {name} tiles {tiles}, which step 2 "
                f"does not check")
    hm = size // 4
    for m, pairs in ((S8_INT8_M, S8_PAIRS + (S8_INT8_PAIRS, S8_EVAL_PAIRS)),
                     (4, (1,))):
        for p in pairs:
            shape = (2 * p, hm // m, hm, joints)
            require(shape in k1, f"phase 13 gives K1 {shape}, which step 2 "
                                 f"does not check")
        for name, rows in (("layer1.0", size // 4), ("layer2.x", size // 8)):
            # a rank's rows and one row of each neighbour's
            tiles = {(rows // m + 1, rows)} | ({(rows // m + 2, rows)}
                                               if m > 2 else set())
            require(tiles <= set(HALOED[name][3]),
                    f"phase 13 gives K3 {name} tiles {tiles} at M={m}, "
                    f"which step 2 does not check")


def run_slice8(inf, cfg, dev, smi):
    """Phase 13: CDRNet-101 at 256 px split over the image height, by
    gloo ranks sharing the card (a: M = 2; b: M = 4) against one unsplit
    process; c: at 192 px over M = 4, which gathers before layer4.0."""
    import os
    import tempfile
    from fast3dhpe_tpu_torch.models import quantized as qz
    from fast3dhpe_tpu_torch.models.resnet import RESNET_SPEC, encoder_ops
    from fast3dhpe_tpu_torch.parallel.spatial import gather_point
    t0 = time.perf_counter()
    size = cfg.MODEL.IMAGE_SIZE[1]
    s8_shapes_checked(size, cfg.MODEL.NUM_JOINTS)
    ops = encoder_ops(cfg.MODEL.NUM_LAYERS)
    g = gather_point(S8_GATHER_SIZE, S8_GATHER_M, ops)
    require(all(gather_point(size, m, ops) is None for m in (2, 4))
            and g is not None and ops[g][0] == S8_GATHER_AT,
            f"gather points: {size} px at M = 2, 4 "
            f"{[gather_point(size, m, ops) for m in (2, 4)]}, "
            f"{S8_GATHER_SIZE} px at M = {S8_GATHER_M} before "
            f"{None if g is None else ops[g][0]}")
    # the input's and the stem's codes, then three a bottleneck (two a
    # basic block) before it
    n_split = 2 + (3 if RESNET_SPEC[cfg.MODEL.NUM_LAYERS][0] == "bottleneck"
                   else 2) * (g - 2)
    out = {}
    with tempfile.TemporaryDirectory() as work:
        sd = {k: v.detach().float().cpu()
              for k, v in inf.model.state_dict().items()}
        weights = os.path.join(work, "weights.pt")
        torch.save(sd, weights)
        rng = np.random.RandomState(SEED + 13)
        img_l, img_r, proj = stereo_request(rng, max(S8_PAIRS), size)
        eval_batch = train_batch(rng, S8_EVAL_PAIRS, 1, size)
        l192, r192, p192 = stereo_request(rng, S8_GATHER_PAIRS,
                                          S8_GATHER_SIZE)
        inp = {"imgs": normalized(img_l, img_r, "cpu"),
               "projs": torch.as_tensor(proj), "eval": {
                   k: torch.as_tensor(v) for k, v in eval_batch.items()},
               "imgs192": normalized(l192, r192, "cpu"),
               "projs192": torch.as_tensor(p192)}
        torch.save(inp, os.path.join(work, "inputs.pt"))
        t = time.perf_counter()
        calib = []
        crng = np.random.RandomState(SEED + 11)
        for _ in range(S6_CALIB):
            cl, cr, cp = stereo_request(crng, S8_CALIB_PAIRS, size)
            calib.append((normalized(cl, cr, dev),
                          torch.as_tensor(cp, device=dev)))
        pack = qz.quantize_cdrnet({k: v.to(dev) for k, v in sd.items()},
                                  calib)
        del calib
        pack_path = os.path.join(work, "pack.npz")
        qz.save_pack(pack_path, pack)
        calib_s = time.perf_counter() - t
        spec = {"device": str(dev) if dev.type == "cpu" else "cuda:0",
                "halos": S8_HALOS, "joints": cfg.MODEL.NUM_JOINTS,
                "layers": cfg.MODEL.NUM_LAYERS, "weights": weights,
                "pack": pack_path}
        runs, ref, models = {}, None, None
        for world, kinds, pairs, int8 in (
                (S8_INT8_M, ("fp32", "bf16"), S8_PAIRS, True),
                (4, ("fp32", "bf16"), (1,), False)):
            with open(os.path.join(work, "spec.json"), "w") as f:
                json.dump(dict(spec, kinds=kinds, int8=int8, pairs={
                    k: pairs for k in kinds},
                    gather=S8_GATHER_SIZE if world == S8_GATHER_M else 0), f)
            go = os.path.join(work, "go")
            if os.path.exists(go):
                os.remove(go)
            tw = time.perf_counter()
            port = free_port()
            procs = [_spawn_self("--s8-child", r, world, port, work)
                     for r in range(world)]
            if ref is None:
                # while the ranks start; they time only after `go`
                ref, models = s8_references(spec, inp, dev)
                require(all(r["counts"] == {} for r in ref.values()),
                        "an unsplit forward or eval step made a "
                        "collective")
                torch.save(ref["int8"]["cf_out"],
                           os.path.join(work, "cf_out.pt"))
            open(go, "w").close()
            s8_finish(procs, S8_CHILD_TIMEOUT, f"M={world}")
            runs[world] = (kinds, pairs, int8, time.perf_counter() - tw, [
                torch.load(os.path.join(work, f"out_{world}_{r}.pt"),
                           weights_only=False) for r in range(world)])
        # the unsplit forward at 1 pair, timed alone on the card
        x1, p1 = inp["imgs"][:1].to(dev), inp["projs"][:1].to(dev)
        x192 = inp["imgs192"].to(dev)
        p192 = inp["projs192"].to(dev)
        with torch.inference_mode():
            one = {kind: s8_wall_ms(lambda: model(x1, p1))
                   for kind, model in models.items()}
            one192 = {kind: s8_wall_ms(lambda: model(x192, p192))
                      for kind, model in models.items()}
        del models
        for world, (kinds, pairs, int8, secs, outs) in runs.items():
            keys = [f"{k} {p}" for k in kinds for p in pairs]
            extra = ["int8", "eval"] if int8 else []
            if world == S8_GATHER_M:
                extra += [f"{k} {S8_GATHER_SIZE}"
                          for k in kinds + ("int8",)]
                out["gathered"] = s8_check_gathered(
                    outs, ref, world, kinds, inp["projs192"], dev, n_split,
                    one192)
            res = {"seconds": secs,
                   "vs_unsplit": s8_check(outs, ref, world, f"M={world}",
                                          keys, inp["projs"], dev),
                   "times": s8_times(outs, one, world),
                   "launches": [
                       {k: sum(o[key]["launches"][k] for key in keys + extra)
                        for k in ("soft_argmax", "soft_argmax_bwd",
                                  "fused_bottleneck")} for o in outs]}
            if int8:
                res["int8"] = s8_check_int8(outs, ref, world)
                res["eval"] = s8_check_eval(outs, ref)
            out[f"M={world}"] = res
    torch.cuda.empty_cache()
    out["unsplit_launches"] = {
        k: sum(r["launches"][k] for r in ref.values())
        for k in ("soft_argmax", "soft_argmax_bwd", "fused_bottleneck")}
    out["calib_s"] = calib_s
    out["seconds"] = time.perf_counter() - t0
    print(f"# slice 8 ({smi}): {out['seconds']:.1f} s")
    return out



def s8_check_gathered(outs, ref, m, kinds, projs, dev, n_split, one):
    """c: the fp32 and bf16 forwards at 192 px over M = m against the
    unsplit ones, with phase 13's bounds on the whole heatmaps the
    gathered forward returns, S8_GATHER_HALOS halos, one gather and no
    keypoint combine, K1 once and K3 S8_GATHER_K3 times (bf16) a rank's
    forward; the int8 forward (s8_check_int8_gathered); each rank's wall
    ms at 1 pair beside the unsplit forward's."""
    keys = [f"{k} {S8_GATHER_SIZE}" for k in kinds]
    require(ref[f"bf16 {S8_GATHER_SIZE}"]["launches"]["fused_bottleneck"]
            == S8_GATHER_K3,
            f"the unsplit bf16 forward at {S8_GATHER_SIZE} px launched K3 "
            f"{ref[f'bf16 {S8_GATHER_SIZE}']['launches']}, predicted "
            f"{S8_GATHER_K3} (layer1.0-1.2)")
    res = {"vs_unsplit": s8_check(
        outs, ref, m, f"c, {S8_GATHER_SIZE} px, M={m}", keys, projs, dev,
        exchanges={"halo": S8_GATHER_HALOS, "gather": 1}),
        "int8": s8_check_int8_gathered(outs, ref, m, n_split),
        "times": {kind: {
            "unsplit_wall_ms": one[kind],
            "ranks_wall_ms": [o["times"][f"{kind} {S8_GATHER_SIZE} wall_ms"]
                              for o in outs]} for kind in kinds}}
    for kind, t in res["times"].items():
        print(f"# slice 8 c {kind} at {S8_GATHER_SIZE} px, 1 pair, M={m}: "
              f"unsplit {t['unsplit_wall_ms']:.1f} ms; ranks' wall "
              + ", ".join(f"{ms:.1f}" for ms in t["ranks_wall_ms"]) + " ms")
    return res


# ------------------------------------------------------------- slice 9

S9_M = 2                          # the mesh: D = 1 x M = 2 gloo ranks
S9_EPOCHS = 3                     # WARMUP 1: a 2D epoch, two with the 3D
#                                   loss, best.pth after the third
S9_CACHE_BYTES = 1 << 30          # the tree whole on the card: one data
#                                   shard, so the cache is on
S9_CHILD_TIMEOUT = 600            # s: a gloo rank's whole run


def s9_child(rank, world, port, cfg_path, root, out, device):
    """One gloo rank of phase 14 on cuda:0 beside the other:
    loop_cdr.run on a (1, world) mesh (make_mesh(model_parallel=world)),
    cuDNN deterministic and TF32 off, into the shared weights root
    without overwrite. Saves its history, its last best snapshot and
    final weights (on the CPU), launches, collectives, epoch seconds and
    peak memory."""
    import os
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed, make_mesh)
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    from fast3dhpe_tpu_torch.train import loop_cdr
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(rank_env(rank, world, port))
    require(init_distributed(backend="gloo", device=device),
            "init_distributed made no group")
    cuda = device.startswith("cuda")
    models, best = [], []
    init, snapshot = loop_cdr._init_model, loop_cdr._best_snapshot

    def init_model(config, seed):
        models.append(init(config, seed))
        return models[-1]

    def best_snapshot(state):
        best.append(snapshot(state))
        return best[-1]

    loop_cdr._init_model, loop_cdr._best_snapshot = init_model, best_snapshot
    try:
        mesh = make_mesh(model_parallel=world)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        COUNTS.clear()
        counters = reset_counts()
        with EpochTimes() as et:
            hist = loop_cdr.run(load_config(cfg_path), mesh=mesh, seed=SEED,
                                weights_root=root)
        launches = read_counts(counters)
        counts = dict(COUNTS)
    finally:
        destroy_distributed()
    torch.save({"history": hist, "launches": launches, "counts": counts,
                "epoch_s": et.seconds,
                "peak_bytes": torch.cuda.max_memory_allocated() if cuda
                else 0,
                "mesh": (mesh.rank, mesh.size, mesh.model_rank,
                         mesh.model_size),
                "spatial": models[0].spatial,
                "best": {k: v.cpu() for k, v in best[-1].items()},
                "final": {k: v.detach().cpu()
                          for k, v in models[0].state_dict().items()}}, out)


def _max_gap(a, b):
    """The largest |a - b| over the tensors of two state dicts."""
    return max(float((a[k].float() - b[k].float()).abs().max())
               for k in a if a[k].numel())


def run_slice9(dev, smi):
    """Phase 14: loop_cdr.run for CDRNet-101 at 256 px on a 1 x 2 mesh
    (D = 1 data shard, M = 2 model ranks: two gloo ranks sharing cuda:0,
    each training the whole images) against loop_cdr.run in this process
    at M = 1, on phase 12's tree, whole in the device frame cache."""
    import os
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.train import loop_cdr
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        mads = s7_tree(work)
        n_pairs = len(S7_MOVEMENTS) * S7_FRAMES
        rank_cfg, one_cfg = (
            s7_cfg(work, mads, n_pairs, name, S9_EPOCHS, S9_CACHE_BYTES)
            for name in ("mesh", "single"))
        tree_s = time.perf_counter() - t0
        shared = os.path.join(work, "w_shared")
        outs = [os.path.join(work, f"s9_rank{r}.pt") for r in range(S9_M)]
        port = free_port()
        t = time.perf_counter()
        device = "cuda:0" if dev.type == "cuda" else "cpu"
        done = _finish([_spawn_self("--s9-child", r, S9_M, port, rank_cfg,
                                    shared, outs[r], device)
                        for r in range(S9_M)], S9_CHILD_TIMEOUT)
        ranks_s = time.perf_counter() - t
        for r, (rc, log) in enumerate(done):
            require(rc == 0, f"phase 14 rank {r} exited {rc}:\n{log[-3000:]}")
        got = [torch.load(o, weights_only=False) for o in outs]
        best_file = torch.load(os.path.join(shared, "mesh", "best.pth"),
                               weights_only=True)
        files = sorted(os.listdir(os.path.join(shared, "mesh")))
        # one process at M = 1, after the ranks, on the card alone
        det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        torch.cuda.reset_peak_memory_stats()
        counters = reset_counts()
        t = time.perf_counter()
        try:
            with EpochTimes() as et:
                ref = loop_cdr.run(load_config(one_cfg), overwrite=True,
                                   seed=SEED, scan_epochs=False,
                                   weights_root=os.path.join(work, "w_one"),
                                   device=dev.type)
        finally:
            torch.backends.cudnn.deterministic = det
        one_s = time.perf_counter() - t
        one_launches = read_counts(counters)
        one_peak = torch.cuda.max_memory_allocated()
    h0, h1 = got[0]["history"], got[1]["history"]
    keys = [k for k in h0 if not k.endswith("_per_sec")]
    hist_gap = max(float(np.max(np.abs(np.asarray(h0[k]) - np.asarray(h1[k]))
                                / np.maximum(np.abs(np.asarray(h1[k])),
                                             1e-30))) for k in keys)
    hist_equal = all(h0[k] == h1[k] for k in keys)
    best_equal = all(torch.equal(got[1]["best"][k], best_file[k])
                     and torch.equal(got[0]["best"][k], best_file[k])
                     for k in best_file)
    final_equal = all(torch.equal(got[0]["final"][k], got[1]["final"][k])
                      for k in got[0]["final"])
    gaps = {"history_rel": hist_gap,
            "best": _max_gap(got[1]["best"], best_file),
            "final": _max_gap(got[0]["final"], got[1]["final"])}
    same_as_one = all(h0[k] == ref[k] for k in keys)
    print(f"# slice 9, 1 x {S9_M} mesh ({smi}): the model ranks' histories "
          f"bit-equal {hist_equal}, best.pth and rank 1's best snapshot "
          f"bit-equal {best_equal}, final weights bit-equal {final_equal} "
          f"(gaps {gaps}); the history bit-equal to one process at M = 1 "
          f"{same_as_one}; rank 0 {h0}; 1 process {ref}")
    require(hist_equal and best_equal and final_equal,
            f"phase 14: the model ranks differ (histories {hist_equal}, "
            f"best {best_equal}, final {final_equal}; gaps {gaps})")
    require(h0["train_loss"][0] > 1e-5 and h0["grad_norm"][0] > 1e-5,
            f"vacuous training: {h0}")

    errs, decades = _vs_one_process(h0, ref, f"1 x {S9_M} mesh")
    print(f"# slice 9 against 1 process: relative {errs}, decades {decades}")
    for r, g in enumerate(got):
        require(g["mesh"] == (0, 1, r, S9_M) and g["spatial"] is None,
                f"phase 14 rank {r}: mesh {g['mesh']}, spatial "
                f"{g['spatial']}")
        # an epoch: one train step (K1 + K2) and one eval batch (K1)
        require_counts(g["launches"], S9_EPOCHS, 2, 1, 0,
                       f"phase 14 rank {r}")
        require(not {"halo", "gather", "keypoints"} & set(g["counts"])
                and g["counts"]["barrier"] == 1,
                f"phase 14 rank {r}: collectives {g['counts']}")
    require_counts(one_launches, S9_EPOCHS, 2, 1, 0, "phase 14, 1 process")
    require(files == ["best.pth", "latest.opt.pt", "latest.pth"],
            f"phase 14 checkpoints: {files}")
    out = {"tree_s": tree_s, "ranks_s": ranks_s, "one_process_s": one_s,
           "history_bit_equal": hist_equal, "best_bit_equal": best_equal,
           "final_bit_equal": final_equal, "gaps": gaps,
           "history_equal_to_one_process": same_as_one,
           "vs_one_process": errs, "decades": decades,
           "epoch_s_by_rank": [g["epoch_s"] for g in got],
           "one_process_epoch_s": et.seconds,
           "peak_gib_by_rank": [g["peak_bytes"] / 2 ** 30 for g in got],
           "one_process_peak_gib": one_peak / 2 ** 30,
           "collectives_by_rank": [g["counts"] for g in got],
           "launches_by_rank": [g["launches"] for g in got],
           "one_process_launches": one_launches}
    out["seconds"] = time.perf_counter() - t0
    print(f"# slice 9 ({smi}): epochs "
          + "; ".join(f"rank {r} " + ", ".join(f"{x:.2f}" for x in e)
                      for r, e in enumerate(out["epoch_s_by_rank"]))
          + " s, 1 process " + ", ".join(f"{x:.2f}" for x in et.seconds)
          + " s; peak " + ", ".join(f"{x:.2f}" for x in
                                    out["peak_gib_by_rank"])
          + f" GiB a rank, 1 process {out['one_process_peak_gib']:.2f} GiB;"
          f" ranks' wall {ranks_s:.1f} s, 1 process {one_s:.1f} s; phase "
          f"{out['seconds']:.1f} s")
    return out


# ------------------------------------------------------------ slice 10

S10_CARDS = 4                     # one NCCL rank a card: M = 4 and world 4
S10_MS = (2, 4)                   # a: M = 2 on cards 0-1, M = 4 on 0-3
S10_WORLDS = (4, 2)               # b: the data-parallel world sizes, in
#                                   the order of the launches
S10_PAIRS = (1, 4)                # a: fp32, bf16 and int8 forwards checked
S10_COLL_TIMEOUT = 180            # s: init_distributed(timeout=), a
#                                   collective's longest wait
S10_LAUNCH_TIMEOUT = 420          # s: a launch's whole run; the parent
#                                   kills every rank at it, or at a failure
S10_TIMED = 10                    # a: timed 1-pair forwards, each way
S10_PROFILED = 3                  # a: 1-pair forwards under torch.profiler
S10_STEP_TIMED = 4                # b: timed steps after the checked one
S10_STEP_PAIRS, S10_STEP_PAD = TRAIN_PAIRS, TRAIN_PAD   # b: the global batch
# NCCL's kernels by what they carry (torch.profiler's names of the
# kernels, NCCL 2.28): the halos' point-to-point, the all_gathers of the
# gather and the keypoint statistics, the all_reduces of the slot form and
# the reductions
NCCL_KINDS = (("halo sendrecv", "SendRecv"), ("all_gather", "AllGather"),
              ("all_reduce", "AllReduce"), ("broadcast", "Broadcast"))

# the file that the CLI's ranks import first (PYTHONPATH): it logs every
# write, rename and removal under the weights root into one file a rank,
# then hands over to any sitecustomize further on the path
S10_AUDIT = r'''
import importlib.machinery, importlib.util, os, sys
_root = os.environ["S10_AUDIT_ROOT"]
_log = os.path.join(os.environ["S10_AUDIT_DIR"],
                    "rank" + os.environ.get("RANK", "x") + ".txt")


def _hook(event, args):
    if event == "open":
        path, mode = args[0], args[1]
        writes = isinstance(mode, str) and any(c in mode for c in "wax+")
    elif event in ("os.rename", "os.remove", "os.mkdir", "shutil.rmtree"):
        path, writes = args[1] if event == "os.rename" else args[0], True
    else:
        return
    if writes and isinstance(path, (str, bytes, os.PathLike)) and \
            os.fsdecode(path).startswith(_root):
        with open(_log, "a") as f:
            f.write(event + " " + os.fsdecode(path) + "\n")


sys.addaudithook(_hook)
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path
                      if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
'''


_HALO_LOG = []


def s10_halo_log():
    """Wrap halo_rows (parallel/spatial.py's, which every layer's window
    reaches, and the copy that models/resnet.py imports for K3's tiles),
    once a process, so that each call with a halo logs the bytes this rank
    sent (COUNTS_BYTES), the edge rows' bytes it should send (its last
    `top` rows where a rank lies below, its first `bottom` rows where one
    lies above), both edges' rows (top + bottom) and the slot form's bytes
    at the same point (M slots of int32 words). Returns the log, which
    s10_logged clears."""
    from fast3dhpe_tpu_torch.models import resnet
    from fast3dhpe_tpu_torch.parallel import spatial
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS_BYTES
    orig = spatial.halo_rows
    if getattr(orig, "s10_logged", False):
        return _HALO_LOG

    def logged(x, dim, top, bottom, mesh, pad_value):
        before = COUNTS_BYTES["halo"]
        y = orig(x, dim, top, bottom, mesh, pad_value)
        if top or bottom:
            row = x.numel() // x.shape[dim] * x.element_size()
            j, m = mesh.model_rank, mesh.model_size
            edges = (top + bottom) * row
            _HALO_LOG.append({
                "shape": tuple(x.shape), "dtype": str(x.dtype)[6:],
                "dim": dim, "top": top, "bottom": bottom,
                "sent": COUNTS_BYTES["halo"] - before,
                "edge_rows": ((top if j < m - 1 else 0)
                              + (bottom if j > 0 else 0)) * row,
                "both_edges": edges, "slots": m * (-(-edges // 4) * 4)})
        return y

    logged.s10_logged = True
    spatial.halo_rows = resnet.halo_rows = logged
    return _HALO_LOG


def s10_halo_inputs(log, dev):
    """Seeded random tensors of the logged halos' shapes and dtypes, in
    the activations' memory layout, each with its log entry."""
    gen = torch.Generator().manual_seed(SEED)
    xs = []
    for h in log:
        x = torch.randn(h["shape"], generator=gen).to(
            getattr(torch, h["dtype"])).to(dev)
        if len(h["shape"]) == 4 and h["dim"] == 2:
            x = x.contiguous(memory_format=torch.channels_last)
        xs.append((x, h))
    return xs


def s10_logged(log, fn, *args, **kw):
    """fn(*args) (a counted forward of phase 13) with its halos' log."""
    log.clear()
    out = fn(*args, **kw)
    out["halos"] = list(log)
    return out


def s10_profile(fn, n=S10_PROFILED):
    """fn() n times under torch.profiler: a call's device busy ms (the
    sum of its kernels' durations), the part outside NCCL's kernels
    (compute_ms), and its NCCL kernels' device ms by NCCL_KINDS (and
    their count). NCCL runs on streams of its own, beside the compute,
    and a kernel of a send or a receive lasts until its peer has posted
    the other side: its duration holds the wait for the slowest peer as
    well as the transfer, and busy_ms can exceed the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy, ms, count = 0.0, {k: 0.0 for k, _ in NCCL_KINDS}, {}
    names = {}
    for e in prof.key_averages():
        # "nccl:*" ranges annotate each NCCL kernel's span on the device
        # timeline; counting them would count every NCCL kernel twice
        if e.device_type != DeviceType.CUDA or e.key.startswith("nccl:"):
            continue
        busy += e.self_device_time_total / 1e3
        if "nccl" in e.key.lower():
            kind = next((k for k, s in NCCL_KINDS if s in e.key), "other")
            ms[kind] = ms.get(kind, 0.0) + e.self_device_time_total / 1e3
            count[kind] = count.get(kind, 0) + e.count
            names[e.key[:60]] = e.count
    require(busy > 0, "the profiler recorded no device time")
    return {"busy_ms": busy / n,
            "compute_ms": (busy - sum(ms.values())) / n,
            "nccl_ms": {k: v / n for k, v in ms.items()},
            "nccl_kernels": {k: v / n for k, v in count.items()},
            "nccl_names": names}


def s10_set_exchange(model, form):
    """The spatial mesh on every module of `model` that holds one, with
    its exchange set to `form` (the same groups)."""
    import dataclasses
    for mod in model.modules():
        mesh = getattr(mod, "spatial", None)
        if mesh is not None:
            mod.spatial = dataclasses.replace(mesh, exchange=form)


def _infer(model, b):
    with torch.inference_mode():
        return model(b["image"], b["proj"])


class _Deterministic:
    """cuDNN deterministic for the block, as phases 12 a and 14 run their
    steps and loops."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.saved


def s10_serve(job, spec, inp, work):
    """a / c: the fp32, bf16 and int8 forwards at job["pairs"] pairs on
    this rank's rows of its data group's pairs (data index g serves pairs
    [g*p, (g+1)*p)), each with its halos' log; the split int8 decoder on
    the unsplit cf_out codes; with job["eval"] the eval step, with
    job["gather"] the forwards at 192 px (c of phase 13), with
    job["timed"] the 1-pair forwards timed on the host clock, profiled
    (device busy, NCCL kernels), and again in the slot form over the same
    group."""
    import dataclasses
    import os
    from fast3dhpe_tpu_torch.models import quantized as qz
    from fast3dhpe_tpu_torch.parallel import (make_mesh, replicate,
                                              shard_batch_spatial)
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS, COUNTS_BYTES
    from fast3dhpe_tpu_torch.parallel.spatial import halo_rows
    mesh = make_mesh(model_parallel=job["m"], exchange=spec["exchange"])
    dev, g, j, m = mesh.device, mesh.rank, mesh.model_rank, mesh.model_size
    log = s10_halo_log()
    out = {"mesh": (mesh.rank, mesh.size, j, m, mesh.exchange,
                    str(mesh.device))}

    def rows(p, first=None):
        first = g * p if first is None else first
        return shard_batch_spatial(mesh, {
            "image": inp["imgs"][first:first + p],
            "proj": inp["projs"][first:first + p]})

    models = {kind: replicate(mesh, s8_model(spec, dev, kind))
              for kind in ("fp32", "bf16")}
    for kind, model in models.items():
        for p in job["pairs"]:
            b = rows(p)
            out[f"{kind} {p}"] = s10_logged(log, s8_forward, model,
                                            b["image"], b["proj"])
    model8 = replicate(mesh, qz.cdrnet_int8(qz.load_pack(spec["pack"]),
                                            device=dev))
    for p in job["pairs"]:
        b = rows(p)
        o = s10_logged(log, s8_int8_forward, model8, b["image"], b["proj"])
        codes = torch.load(os.path.join(work, f"cf_out_{g * p}_{p}.pt"))
        h = codes.shape[1] // m
        with torch.inference_mode():
            hm = qz._decoder_walk(qz._Int8Ctx(model8.rt, mesh), (
                codes[:, j * h:(j + 1) * h].to(dev),
                model8.rt.scale("cf_out")))
        o["decoder_on_unsplit_codes"] = hm.cpu()
        out[f"int8 {p}"] = o
    if job["eval"]:
        out["eval"] = s8_eval(models["fp32"], shard_batch_spatial(
            mesh, inp["eval"]), dev, mesh)
    gsize = job["gather"]
    if gsize:
        b192 = shard_batch_spatial(mesh, {"image": inp["imgs192"],
                                          "proj": inp["projs192"]})
        for kind, model in models.items():
            out[f"{kind} {gsize}"] = s10_logged(
                log, s8_repeated, model, b192["image"], b192["proj"])
        out[f"int8 {gsize}"] = s10_logged(
            log, s8_int8_forward, model8, b192["image"], b192["proj"],
            keep_codes=True)
    del model8
    if not job["timed"]:
        return out
    b = rows(1, 0)
    times = {}
    for kind, model in models.items():
        def fwd(model=model, b=b):
            return _infer(model, b)

        times[f"{kind} wall_ms"] = s8_wall_ms(fwd, S10_TIMED)
        times[f"{kind} profile"] = s10_profile(fwd)
        if gsize:
            times[f"{kind} {gsize} wall_ms"] = s8_wall_ms(
                lambda model=model: _infer(model, b192), S10_TIMED)
        kp = fwd()[0]
        # the forward's halos alone (its shapes, random rows), both forms
        for form in ("neighbours", "slots"):
            def halos(fm=dataclasses.replace(mesh, exchange=form),
                      xs=s10_halo_inputs(out[f"{kind} 1"]["halos"], dev)):
                with torch.inference_mode():
                    for x, h in xs:
                        halo_rows(x, h["dim"], h["top"], h["bottom"], fm, 0)

            times[f"{kind} halos {form} wall_ms"] = s8_wall_ms(halos,
                                                               S10_TIMED)
            times[f"{kind} halos {form} profile"] = s10_profile(halos)
        s10_set_exchange(model, "slots")
        try:
            COUNTS.clear()
            COUNTS_BYTES.clear()
            slot_kp = fwd()[0]
            times[f"{kind} slots bytes"] = dict(COUNTS_BYTES)
            times[f"{kind} slots counts"] = dict(COUNTS)
            times[f"{kind} slots kp gap"] = float(
                (slot_kp - kp).abs().max())
            times[f"{kind} slots wall_ms"] = s8_wall_ms(fwd, S10_TIMED)
            times[f"{kind} slots profile"] = s10_profile(fwd)
        finally:
            s10_set_exchange(model, mesh.exchange)
    out["times"] = times
    return out


def s10_step(job, spec, inp, work):
    """b: one CDR train step (use_3d False) of the global batch of
    S10_STEP_PAIRS pairs, this rank's share of its rows, from the parent's
    start weights through replicate on a data-parallel mesh of the world
    (cuDNN deterministic): its metrics, the BN statistics it updates, its
    collectives and launches; then S10_STEP_TIMED warm steps timed with
    the peak memory above what was allocated, and one profiled (device
    busy, NCCL kernels)."""
    import os
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.parallel import make_mesh, replicate, shard_batch
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    from fast3dhpe_tpu_torch.train.state import TrainState
    cfg = load_config(spec["cfg"])
    mesh = make_mesh()
    per = S10_STEP_PAIRS // mesh.size
    batch = torch.load(os.path.join(work, "train_batch.pt"),
                       weights_only=False)
    b = shard_batch(mesh, {k: v[mesh.rank * per:(mesh.rank + 1) * per]
                           for k, v in batch.items()})
    model = CDRNet.from_config(cfg)
    model.load_state_dict(torch.load(os.path.join(work, "start.pt"),
                                     weights_only=True), strict=True)
    replicate(mesh, model.to(mesh.device))
    state = TrainState.create(model, cfg, steps_per_epoch=1)
    step = train_step_fn(cfg, mesh)
    with _Deterministic():
        COUNTS.clear()
        counters = reset_counts()
        metrics = step(state, b, False)
        launches = read_counts(counters)
        counts = dict(COUNTS)
        out = {"metrics": {k: v.item() for k, v in metrics.items()},
               "stats": {n: v.detach().cpu().clone()
                         for n, v in model.named_buffers()
                         if "running" in n},
               "launches": launches, "counts": counts, "pairs": per}
        out.update(s10_timed_steps(step, state, b))
    return out


def s10_timed_steps(step, state, b):
    """S10_STEP_TIMED warm steps on the host clock between
    synchronisations (ms each), their peak memory above what was
    allocated (GiB), and one step under torch.profiler."""
    times, peak = [], 0.0
    for i in range(1 + S10_STEP_TIMED):
        sync()
        before = torch.cuda.memory_allocated() if torch.cuda.is_available() \
            else 0
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        step(state, b, False)
        sync()
        if i:
            times.append((time.perf_counter() - t) * 1e3)
        if torch.cuda.is_available():
            peak = max(peak, (torch.cuda.max_memory_allocated() - before)
                       / 2 ** 30)
    return {"step_ms": times, "peak_gib": peak,
            "profile": s10_profile(lambda: step(state, b, False), 1)}


def s10_loop(job, spec, inp, work):
    """b / c: loop_cdr.run on the job's (D, M) mesh (M = job["m"]) into
    the shared weights root without overwrite, cuDNN deterministic, with
    the job's keywords (job["kw"]: the path flags): the history, the
    logged path, launches, collectives, epoch seconds, peak memory and a
    digest of the final weights."""
    import hashlib
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.parallel import make_mesh
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    from fast3dhpe_tpu_torch.train import loop_cdr
    mesh = make_mesh(model_parallel=job["m"], exchange=spec["exchange"])
    models, init = [], loop_cdr._init_model

    def init_model(config, seed):
        models.append(init(config, seed))
        return models[-1]

    loop_cdr._init_model = init_model
    try:
        with _Deterministic():
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            COUNTS.clear()
            counters = reset_counts()
            with EpochTimes() as et, PathLog() as pl:
                hist = loop_cdr.run(load_config(job["cfg"]), mesh=mesh,
                                    seed=SEED, weights_root=job["root"],
                                    **job.get("kw", {}))
            launches = read_counts(counters)
    finally:
        loop_cdr._init_model = init
    digest = hashlib.sha256()
    for v in models[-1].state_dict().values():
        digest.update(v.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return {"history": hist, "launches": launches, "counts": dict(COUNTS),
            "epoch_s": et.seconds, "digest": digest.hexdigest(),
            "path": pl.lines,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30
            if torch.cuda.is_available() else 0.0,
            "mesh": (mesh.rank, mesh.size, mesh.model_rank, mesh.model_size),
            "spatial": models[-1].spatial is not None}


S10_JOBS = {"serve": s10_serve, "step": s10_step, "loop": s10_loop}


def s10_child(rank, world, port, work, launch):
    """One rank of a phase-15 launch: init_distributed with the launch's
    backend on this rank's device (NCCL on cuda:rank on the card) and a
    collective timeout of S10_COLL_TIMEOUT; once the parent writes `go`,
    the launch's jobs in order, all on one process group (every rank calls
    make_mesh, so every dist.new_group, in the same order)."""
    import os
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(work, f"spec_{launch}.json")) as f:
        spec = json.load(f)
    os.environ.update(rank_env(rank, world, port))
    t = time.perf_counter()
    require(init_distributed(backend=spec["backend"], device=spec["device"],
                             timeout=S10_COLL_TIMEOUT),
            "init_distributed made no group")
    out = {"init_s": time.perf_counter() - t}
    try:
        inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
        go = os.path.join(work, "go")
        deadline = time.perf_counter() + S10_LAUNCH_TIMEOUT
        while not os.path.exists(go) and time.perf_counter() < deadline:
            time.sleep(0.05)
        require(os.path.exists(go), f"rank {rank}: no `go` from the parent")
        for job in spec["jobs"]:
            t = time.perf_counter()
            out[job["name"]] = S10_JOBS[job["kind"]](job, spec, inp, work)
            print(f"# {job['name']}: {time.perf_counter() - t:.1f} s",
                  flush=True)
    finally:
        destroy_distributed()
    torch.save(out, os.path.join(work, f"out_{launch}_{rank}.pt"))


def s10_launch(work, launch, world, spec):
    """Start the launch's `world` ranks (this script with `--s10-child`),
    their output in <work>/<launch>_rank<r>.log."""
    import os
    with open(os.path.join(work, f"spec_{launch}.json"), "w") as f:
        json.dump(spec, f)
    port = free_port()
    procs = []
    for r in range(world):
        log = open(os.path.join(work, f"{launch}_rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--s10-child",
             str(r), str(world), str(port), work, launch],
            stdout=log, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, NCCL_DEBUG="WARN")), log))
    return procs


def s10_finish(procs, what, timeout=S10_LAUNCH_TIMEOUT):
    """Wait for every rank; at the first that fails, or at the timeout,
    kill them all. Prints the ranks' '#' lines; fails naming the rank."""
    deadline = time.perf_counter() + timeout
    bad = None
    while any(p.poll() is None for p, _ in procs):
        bad = next((r for r, (p, _) in enumerate(procs)
                    if p.poll() not in (None, 0)), None)
        if bad is not None or time.perf_counter() > deadline:
            break
        time.sleep(0.2)
    for p, log in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()
    logs = []
    for r, (p, log) in enumerate(procs):
        with open(log.name) as f:
            logs.append(f.read())
        for line in logs[-1].splitlines():
            if line.startswith("#"):
                print(f"# {what} rank {r}: {line[1:].strip()}")
    failed = sorted((r for r, (p, _) in enumerate(procs) if p.returncode),
                    key=lambda r: procs[r][0].returncode < 0)
    for r in failed[:1]:
        code = procs[r][0].returncode
        require(False, f"{what}: rank {r} exited {code}"
                + (" (killed: another rank failed or the launch timed out)"
                   if code < 0 else "") + f":\n{logs[r][-3000:]}")


def s10_shapes_checked(size, joints):
    """Every K1 and K2 input and K3 tile of phase 15 is one that step 2
    holds against its plain version: phase 13's (s8_shapes_checked: 1
    pair at M = 2 and 4, the 192 px gather); K1 on a rank's heatmap rows
    at M = 2 and 4 for every pair count of a (S10_PAIRS and the eval
    step's S8_EVAL_PAIRS; c serves 1 pair a data group); K1 and K2 on a
    data-parallel rank's whole heatmaps (S10_STEP_PAIRS over 1, 2 and 4
    ranks: the step, the loops' batches and the CLI's); K3 on the haloed
    tiles at S10_PAIRS, which step 2 checks at S8_PAIRS."""
    s8_shapes_checked(size, joints)
    k1 = {shape for _, shape in SOFTARGMAX_SHAPES}
    hm = size // 4
    for m in S10_MS:
        for p in S10_PAIRS + (S8_EVAL_PAIRS,):
            shape = (2 * p, hm // m, hm, joints)
            require(shape in k1, f"phase 15 gives K1 {shape}, which step 2 "
                                 f"does not check")
    for w in (1,) + S10_WORLDS:
        shape = (2 * S10_STEP_PAIRS // w, hm, hm, joints)
        require(shape in k1, f"phase 15 gives K1 and K2 {shape}, which step "
                             f"2 does not check")
    require(set(S10_PAIRS) <= set(S8_PAIRS),
            f"phase 15 runs K3's haloed tiles at {S10_PAIRS} pairs, step 2 "
            f"checks them at {S8_PAIRS}")


def s10_references(spec, inp, dev, firsts):
    """The unsplit forwards in this process: fp32 and bf16 at S10_PAIRS
    pairs from pair 0 and at 1 pair from each first in `firsts` (c's data
    groups, keyed "<kind> 1@<first>"), int8 likewise with each rank's
    CanonicalFusion rows at M = 2 and 4 (s8_cf_rows) and its cf_out codes
    saved for the ranks, the eval step, and the 192 px forwards; with the
    models."""
    import os
    from fast3dhpe_tpu_torch.models import quantized as qz
    ref = {}
    models = {kind: s8_model(spec, dev, kind) for kind in ("fp32", "bf16")}
    model8 = qz.cdrnet_int8(qz.load_pack(spec["pack"]), device=dev)
    cases = [(0, p, f"{p}") for p in S10_PAIRS]
    cases += [(f, 1, f"1@{f}") for f in firsts]
    for first, p, tag in cases:
        x = inp["imgs"][first:first + p].to(dev)
        pr = inp["projs"][first:first + p].to(dev)
        for kind, model in models.items():
            ref[f"{kind} {tag}"] = s8_forward(model, x, pr)
        r8 = s8_int8_forward(model8, x, pr)
        r8["cf_out_rows"] = {m: s8_cf_rows(
            model8, r8["enc_last"].to(dev), r8["enc_scale"].to(dev), pr, m)
            for m in S10_MS}
        torch.save(r8["cf_out"], os.path.join(spec["work"],
                                               f"cf_out_{first}_{p}.pt"))
        ref[f"int8 {tag}"] = r8
    ref["eval"] = s8_eval(models["fp32"], on_device(inp["eval"], dev), dev)
    x192, p192 = inp["imgs192"].to(dev), inp["projs192"].to(dev)
    for kind, model in models.items():
        ref[f"{kind} {S8_GATHER_SIZE}"] = s8_repeated(model, x192, p192)
    ref[f"int8 {S8_GATHER_SIZE}"] = s8_int8_forward(model8, x192, p192,
                                                    keep_codes=True)
    return ref, models


def s10_check_int8(outs, ref, m, key, pairs):
    """s8_check_int8 on the forward `key` against ref[key], with the
    unsplit CanonicalFusion on each rank's rows at this M."""
    want = dict(ref[key], cf_out_rows=ref[key]["cf_out_rows"][m])
    return s8_check_int8([dict(o, int8=o[key]) for o in outs],
                         {"int8": want}, m, pairs)


def s10_check_bytes(outs, m, keys, what):
    """Each halo of each checked forward sent exactly the edge rows'
    bytes (s10_halo_log): at an interior rank both edges, (top + bottom)
    rows, which is 1/M of the slot form's M slots at the same point; one
    logged call a counted halo. Returns a 1-pair fp32 forward's bytes by
    rank in each form."""
    for key in keys:
        for j, o in enumerate(outs):
            log, n = o[key]["halos"], o[key]["counts"].get("halo", 0)
            # s8_repeated's two forwards, each counted alike
            n *= 2 if "repeat_equal" in o[key] else 1
            require(len(log) == n, f"{what} {key} rank {j}: {len(log)} "
                                   f"halos logged, {n} counted")
            bad = [h for h in log if h["sent"] != h["edge_rows"]]
            require(not bad, f"{what} {key} rank {j}: {len(bad)} halos sent "
                             f"other bytes than their edge rows: {bad[:3]}")
            if 0 < j < m - 1:
                bad = [h for h in log if h["sent"] != h["both_edges"]
                       or h["slots"] != m * h["sent"]]
                require(not bad, f"{what} {key} interior rank {j}: halos "
                                 f"not (top + bottom) rows, 1/M of the "
                                 f"slots: {bad[:3]}")
    got = {"neighbours": [sum(h["sent"] for h in o["fp32 1"]["halos"])
                          for o in outs],
           "slots": [sum(h["slots"] for h in o["fp32 1"]["halos"])
                     for o in outs],
           "both_edges": [sum(h["both_edges"] for h in o["fp32 1"]["halos"])
                          for o in outs]}
    print(f"# slice 10 {what}: every halo of {len(keys)} forwards a rank "
          f"sent exactly its edge rows; a 1-pair fp32 forward's "
          f"{len(outs[0]['fp32 1']['halos'])} halos send "
          f"{got['neighbours']} bytes from model ranks 0-{m - 1} "
          f"(both edges' rows {got['both_edges'][0]}), against "
          f"{got['slots'][0]} bytes a rank in the slot form")
    return got


def s10_times(outs, one, m, what):
    """Each rank's 1-pair forward in both forms beside the unsplit one:
    wall ms (host clock, synchronised), device busy and the NCCL kernels'
    device ms a forward (torch.profiler); the slot form's measured halo
    bytes against s10_halo_log's sum."""
    t = {}
    for kind in ("fp32", "bf16"):
        ranks = []
        for o in outs:
            tm = o["times"]
            p, ps = tm[f"{kind} profile"], tm[f"{kind} slots profile"]
            slots = sum(h["slots"] for h in o[f"{kind} 1"]["halos"])
            ranks.append({
                "wall_ms": tm[f"{kind} wall_ms"], "busy_ms": p["busy_ms"],
                "compute_ms": p["compute_ms"],
                "halo_nccl_ms": p["nccl_ms"]["halo sendrecv"],
                "all_gather_nccl_ms": p["nccl_ms"]["all_gather"],
                "nccl_kernels": p["nccl_kernels"],
                "nccl_names": p["nccl_names"],
                "slots_wall_ms": tm[f"{kind} slots wall_ms"],
                "slots_busy_ms": ps["busy_ms"],
                "slots_nccl_ms": ps["nccl_ms"]["all_reduce"],
                "slots_counts": tm[f"{kind} slots counts"],
                "slots_kp_gap_px": tm[f"{kind} slots kp gap"],
                "halo_bytes": sum(h["sent"] for h in o[f"{kind} 1"]["halos"]),
                "slot_bytes": slots,
                "slot_bytes_measured": tm[f"{kind} slots bytes"].get("halo"),
                "halos_alone": {form: {
                    "wall_ms": tm[f"{kind} halos {form} wall_ms"],
                    "nccl_ms": tm[f"{kind} halos {form} profile"]["nccl_ms"],
                    "nccl_kernels": tm[f"{kind} halos {form} profile"][
                        "nccl_kernels"]}
                    for form in ("neighbours", "slots")}})
            require(ranks[-1]["slot_bytes_measured"] == slots,
                    f"{what} {kind}: the slot form sent "
                    f"{ranks[-1]['slot_bytes_measured']} halo bytes, the "
                    f"log predicts {slots}")
        t[kind] = {"unsplit": one[kind], "ranks": ranks}

        def by_rank(get, digits=2):
            return ", ".join(f"{get(r):.{digits}f}" for r in ranks)

        def alone(form, get, digits=2):
            return by_rank(lambda r: get(r["halos_alone"][form]), digits)

        nb_wall = alone("neighbours", lambda a: a["wall_ms"])
        nb_nccl = alone("neighbours",
                        lambda a: a["nccl_ms"]["halo sendrecv"], 3)
        sl_wall = alone("slots", lambda a: a["wall_ms"])
        sl_nccl = alone("slots", lambda a: a["nccl_ms"]["all_reduce"], 3)
        print(f"# slice 10 {what} {kind} at 1 pair: unsplit "
              f"{one[kind]['wall_ms']:.2f} ms wall, "
              f"{one[kind]['busy_ms']:.2f} ms busy; ranks' wall "
              f"{by_rank(lambda r: r['wall_ms'])} ms, busy outside NCCL "
              f"{by_rank(lambda r: r['compute_ms'])} ms; the halos' NCCL "
              f"send/recv kernels (the wait for the peers included) "
              f"{by_rank(lambda r: r['halo_nccl_ms'], 3)} ms and the "
              f"keypoints' all_gather "
              f"{by_rank(lambda r: r['all_gather_nccl_ms'], 3)} ms; halo "
              f"bytes {[r['halo_bytes'] for r in ranks]}; the slot form on "
              f"the same cards: wall {by_rank(lambda r: r['slots_wall_ms'])}"
              f" ms, its all_reduce kernels "
              f"{by_rank(lambda r: r['slots_nccl_ms'], 3)} ms, "
              f"{ranks[0]['slot_bytes']} bytes a rank, pred_2d "
              f"{max(r['slots_kp_gap_px'] for r in ranks):.3g} px from the "
              f"neighbour form's; the forward's halos alone: neighbours "
              f"wall {nb_wall} ms, send/recv kernels {nb_nccl} ms; slots "
              f"wall {sl_wall} ms, all_reduce kernels {sl_nccl} ms")
    return t


def _vs_one_process(h, ref, what):
    """A mesh run's history against one process on the global batch:
    tests/test_distributed_real.py's tolerances (S7_*) on the losses and
    MPJPE2D, the 3D figures finite, positive and within one decade.
    Returns (relative errors, decades)."""

    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                            / np.abs(np.asarray(b))))

    errs = {"train_loss warmup": rel(h["train_loss"][:1],
                                     ref["train_loss"][:1]),
            "train_loss after": rel(h["train_loss"][1:],
                                    ref["train_loss"][1:]),
            "val_mpjpe_2d": rel(h["val_mpjpe_2d"], ref["val_mpjpe_2d"]),
            "val_loss warmup": rel(h["val_loss"][:1], ref["val_loss"][:1])}
    decades = {k: float(np.max(np.abs(np.log10(np.asarray(h[k], float))
                                      - np.log10(np.asarray(ref[k], float)))))
               for k in ("val_mpjpe_3d", "val_loss")}
    for k, bound in (("train_loss warmup", S7_WARMUP_RTOL),
                     ("train_loss after", S7_POST_RTOL),
                     ("val_mpjpe_2d", S7_2D_RTOL),
                     ("val_loss warmup", S7_2D_RTOL)):
        require(errs[k] <= bound, f"{what} vs 1 process: {k} {errs[k]:.3g} "
                                  f"(bound {bound})")
    for k, d in decades.items():
        require(np.isfinite(h[k]).all() and min(h[k]) > 0 and d < 1.0,
                f"{what} vs 1 process: {k} {h[k]} / {ref[k]}")
    return errs, decades


def s10_one_card(cfg, start_sd, batch, dev):
    """b's reference: the same step of the whole global batch in this
    process on one card (cuDNN deterministic), from the same weights: its
    metrics, BN statistics, launches, and the warm steps timed, peak
    memory and the profile, as the ranks measure theirs."""
    from fast3dhpe_tpu_torch.models.cdrnet import CDRNet
    from fast3dhpe_tpu_torch.train.state import TrainState
    model = CDRNet.from_config(cfg)
    model.load_state_dict(start_sd, strict=True)
    model.to(dev)
    state = TrainState.create(model, cfg, steps_per_epoch=1)
    step = train_step_fn(cfg)
    b = on_device(batch, dev)
    with _Deterministic():
        counters = reset_counts()
        metrics = step(state, b, False)
        out = {"metrics": {k: v.item() for k, v in metrics.items()},
               "stats": {n: v.detach().cpu().clone()
                         for n, v in model.named_buffers()
                         if "running" in n},
               "launches": read_counts(counters),
               "pairs": S10_STEP_PAIRS}
        out.update(s10_timed_steps(step, state, b))
    return out


def s10_check_steps(outs, one, world, n_bn):
    """b: the ranks' step against the one-card step: the ranks' metrics
    equal to each other; loss and loss_2d within S7_WARMUP_RTOL, grad_norm
    and the BN running statistics (relative, over all of them) within
    S7_2D_RTOL (NCCL's ring sums the BN statistics' partial sums in
    another order, and E[x^2] - E[x]^2 over ~1e6 values a channel turns
    that into ~1e-4: 1.18e-4 at world 4 in the first 4-card run); the
    collectives a step by kind and 1 K1 + 1 K2 + 0 K3 a rank. Prints the
    warm steps' ms, the NCCL kernels' device ms and the peak memory a
    rank beside one card's."""
    want = {"rows": 1, "bn forward": n_bn, "bn backward": n_bn,
            "gradients": 1, "metrics": 1}
    m0 = outs[0]["metrics"]
    require(all(o["metrics"] == m0 for o in outs),
            f"world {world}: the ranks' step metrics differ: "
            f"{[o['metrics'] for o in outs]}")
    rel = {k: abs(m0[k] - one["metrics"][k]) / max(abs(one["metrics"][k]),
                                                    1e-30)
           for k in m0}
    rel["bn statistics"] = _global_rel(outs[0]["stats"], one["stats"])
    print(f"# slice 10 b, world {world} over NCCL, {outs[0]['pairs']} pairs "
          f"a rank: step metrics {m0} against one card's {one['metrics']}, "
          f"relative {rel}; collectives {outs[0]['counts']}; launches "
          f"{[o['launches'] for o in outs]}")
    print(f"# slice 10 b, world {world}: warm step "
          + "; ".join(f"rank {r} " + ", ".join(f"{x:.1f}" for x in
                                               o["step_ms"])
                      for r, o in enumerate(outs))
          + " ms against one card's " + ", ".join(f"{x:.1f}" for x in
                                                  one["step_ms"])
          + " ms; NCCL kernels " + ", ".join(
              f"{o['profile']['nccl_ms']['all_reduce']:.2f}" for o in outs)
          + f" ms a step (device busy "
          + ", ".join(f"{o['profile']['busy_ms']:.1f}" for o in outs)
          + f", one card's {one['profile']['busy_ms']:.1f} ms); peak above "
          f"what was allocated "
          + ", ".join(f"{o['peak_gib']:.2f}" for o in outs)
          + f" GiB, one card's {one['peak_gib']:.2f} GiB")
    for k, bound in (("loss", S7_WARMUP_RTOL), ("loss_2d", S7_WARMUP_RTOL),
                     ("grad_norm", S7_2D_RTOL),
                     ("bn statistics", S7_2D_RTOL)):
        require(rel[k] <= bound, f"world {world} step vs one card: {k} "
                                 f"{rel[k]:.3g} (bound {bound})")
    for r, o in enumerate(outs):
        require(o["counts"] == want, f"world {world} rank {r}: collectives "
                                     f"{o['counts']}, not {want}")
        require_counts(o["launches"], 1, 1, 1, 0, f"world {world} rank {r}")
    return {"vs_one_card": rel,
            "step_ms_by_rank": [o["step_ms"] for o in outs],
            "peak_gib_by_rank": [o["peak_gib"] for o in outs],
            "profile_by_rank": [o["profile"] for o in outs],
            "collectives": outs[0]["counts"]}


def s10_check_loops(outs, ref, what, name, shared, epochs):
    """b / c: every rank's loop history equal (but the throughput), within
    S7_* of the one process; the one checkpoint set in the shared root;
    per rank 2 K1 + 1 K2 an epoch (a train step and an eval batch)."""
    import os
    h0 = outs[0]["history"]
    for r, o in enumerate(outs):
        for k in h0:
            if not k.endswith("_per_sec"):
                require(o["history"][k] == h0[k],
                        f"{what}: rank {r}'s {k} {o['history'][k]} differs "
                        f"from rank 0's {h0[k]}")
        require_counts(o["launches"], epochs, 2, 1, 0, f"{what} rank {r}")
    require(h0["train_loss"][0] > 1e-5 and h0["grad_norm"][0] > 1e-5,
            f"{what}: vacuous training: {h0}")
    errs, decades = _vs_one_process(h0, ref, what)
    files = sorted(os.listdir(os.path.join(shared, name)))
    require(os.listdir(shared) == [name]
            and files == ["latest.opt.pt", "latest.pth"],
            f"{what}: the shared root holds {os.listdir(shared)}, {files}")
    print(f"# slice 10 {what}: histories equal on every rank, against one "
          f"process relative {errs}, decades {decades}; epochs "
          + "; ".join(f"rank {r} " + ", ".join(f"{x:.2f}" for x in
                                               o["epoch_s"])
                      for r, o in enumerate(outs))
          + " s; peak " + ", ".join(f"{o['peak_gib']:.2f}" for o in outs)
          + f" GiB; collectives rank 0 {outs[0]['counts']}; checkpoints "
          f"{files}")
    return {"vs_one_process": errs, "decades": decades,
            "epoch_s_by_rank": [o["epoch_s"] for o in outs],
            "peak_gib_by_rank": [o["peak_gib"] for o in outs],
            "collectives_by_rank": [o["counts"] for o in outs],
            "launches_by_rank": [o["launches"] for o in outs],
            "history": h0}


def s10_cli(work, mads, world, device, cfg=None, name="cli"):
    """b: `torchrun --nproc_per_node <world> -m
    fast3dhpe_tpu_torch.apps.train_cdr` (python -m torch.distributed.run)
    for one epoch on the tree (cfg, by default phase 12's augmentation-off
    config without a device cache; MODEL.NAME `name`), each rank importing
    S10_AUDIT first, which logs the rank's writes under the weights root:
    exit 0, one checkpoint set, every write rank 0's; the path the loop
    logged."""
    import os
    root = os.path.join(work, f"w_{name}")
    audit, site = (os.path.join(work, f"{name}_{d}")
                   for d in ("audit", "site"))
    os.makedirs(audit)
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(S10_AUDIT)
    import fast3dhpe_tpu_torch
    if cfg is None:
        cfg = s7_cfg(work, mads, S10_STEP_PAIRS // world, name, epochs=1)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(
        fast3dhpe_tpu_torch.__file__)))
    env = dict(os.environ, S10_AUDIT_ROOT=root + os.sep,
               S10_AUDIT_DIR=audit, NCCL_DEBUG="WARN", PYTHONPATH=os.pathsep
               .join([site, repo] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p]))
    t = time.perf_counter()
    try:
        done = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(world), "-m",
             "fast3dhpe_tpu_torch.apps.train_cdr", "--config_path", cfg,
             "--weights_root", root, "--device", device],
            capture_output=True, text=True, env=env, cwd=repo,
            timeout=S10_LAUNCH_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        require(False, f"torchrun train_cdr: no exit in "
                       f"{S10_LAUNCH_TIMEOUT} s:\n{str(e.stdout)[-3000:]}")
    secs = time.perf_counter() - t
    require(done.returncode == 0, f"torchrun train_cdr exited "
                                  f"{done.returncode}:\n"
                                  f"{(done.stdout + done.stderr)[-3000:]}")
    writes = {}
    for r in range(world):
        path = os.path.join(audit, f"rank{r}.txt")
        writes[r] = open(path).read().split("\n")[:-1] \
            if os.path.exists(path) else []
    from fast3dhpe_tpu_torch.config import load_config
    files = sorted(os.listdir(os.path.join(root,
                                           load_config(cfg).MODEL.NAME)))
    renamed = sorted(os.path.basename(w.split(" ", 1)[1]) for w in writes[0]
                     if w.startswith("os.rename"))
    print(f"# slice 10 b, torchrun --nproc_per_node {world} -m "
          f"fast3dhpe_tpu_torch.apps.train_cdr, 1 epoch: exit 0 in "
          f"{secs:.1f} s; {files} in the weights root; writes under it by "
          f"rank {({r: len(w) for r, w in writes.items()})}, rank 0's "
          f"{writes[0]}")
    require(files == ["latest.opt.pt", "latest.pth"]
            and renamed == files
            and not any(writes[r] for r in range(1, world)),
            f"torchrun train_cdr: files {files}; rank 0 moved {renamed} into "
            f"place; writes by the other ranks "
            f"{ {r: writes[r] for r in range(1, world)} }")
    return {"seconds": secs, "files": files,
            "writes_by_rank": {r: len(w) for r, w in writes.items()},
            "path": s17_plan_line(done.stdout + done.stderr)}


def run_slice10(inf, cfg, dev, smi):
    """Phase 15: the process group across cards. Two launches of ranks,
    one NCCL rank a card (rank r on cuda:r): world 4 (a at M = 4 with c's
    gather at 192 px; c's split serving on a 2 x 2 mesh; b's step and
    loop at world 4; c's loop on 2 x 2), then world 2 (a at M = 2; b's
    step and loop at world 2); then torchrun's train_cdr over 4 ranks.
    The references run in this process on cuda:0 while the first launch's
    ranks start, and the ranks begin only at `go`."""
    import os
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.models import quantized as qz
    from fast3dhpe_tpu_torch.models.resnet import RESNET_SPEC, encoder_ops
    from fast3dhpe_tpu_torch.parallel.spatial import gather_point
    from fast3dhpe_tpu_torch.train import loop_cdr
    t0 = time.perf_counter()
    cpu = dev.type == "cpu"     # a rehearsal: gloo ranks on the CPU
    size = cfg.MODEL.IMAGE_SIZE[1]
    s10_shapes_checked(size, cfg.MODEL.NUM_JOINTS)
    ops = encoder_ops(cfg.MODEL.NUM_LAYERS)
    g = gather_point(S8_GATHER_SIZE, S8_GATHER_M, ops)
    require(g is not None and ops[g][0] == S8_GATHER_AT,
            f"{S8_GATHER_SIZE} px at M = {S8_GATHER_M} gathers before "
            f"{None if g is None else ops[g][0]}")
    n_split = 2 + (3 if RESNET_SPEC[cfg.MODEL.NUM_LAYERS][0] == "bottleneck"
                   else 2) * (g - 2)
    out = {}
    with tempfile.TemporaryDirectory() as work:
        t = time.perf_counter()
        sd = {k: v.detach().float().cpu()
              for k, v in inf.model.state_dict().items()}
        weights = os.path.join(work, "weights.pt")
        torch.save(sd, weights)
        rng = np.random.RandomState(SEED + 15)
        img_l, img_r, proj = stereo_request(rng, max(S10_PAIRS), size)
        eval_batch = train_batch(rng, S8_EVAL_PAIRS, 1, size)
        l192, r192, p192 = stereo_request(rng, S8_GATHER_PAIRS,
                                          S8_GATHER_SIZE)
        inp = {"imgs": normalized(img_l, img_r, "cpu"),
               "projs": torch.as_tensor(proj), "eval": {
                   k: torch.as_tensor(v) for k, v in eval_batch.items()},
               "imgs192": normalized(l192, r192, "cpu"),
               "projs192": torch.as_tensor(p192)}
        torch.save(inp, os.path.join(work, "inputs.pt"))
        calib = []
        crng = np.random.RandomState(SEED + 11)
        for _ in range(S6_CALIB):
            cl, cr, cp = stereo_request(crng, S8_CALIB_PAIRS, size)
            calib.append((normalized(cl, cr, dev),
                          torch.as_tensor(cp, device=dev)))
        pack = qz.quantize_cdrnet({k: v.to(dev) for k, v in sd.items()},
                                  calib)
        del calib
        pack_path = os.path.join(work, "pack.npz")
        qz.save_pack(pack_path, pack)
        mads = s7_tree(work)
        n_pairs = len(S7_MOVEMENTS) * S7_FRAMES
        cfgs = {w: s7_cfg(work, mads, n_pairs // w, f"dp{w}")
                for w in S10_WORLDS}
        mesh_cfg = s7_cfg(work, mads, n_pairs // 2, "mesh2x2")
        one_cfg = s7_cfg(work, mads, n_pairs, "single")
        step_cfg = s7_cfg(work, mads, S10_STEP_PAIRS, "step")
        batch = train_batch(np.random.RandomState(SEED + 2), S10_STEP_PAIRS,
                            S10_STEP_PAD, size)
        torch.save(batch, os.path.join(work, "train_batch.pt"))
        scfg = load_config(step_cfg)
        model = seeded_train_model(scfg).to(dev)
        calibrate_train_head(model, on_device(batch, dev))
        start_sd = {k: v.detach().cpu().clone()
                    for k, v in model.state_dict().items()}
        n_bn = sum(1 for k in start_sd if k.endswith("running_mean"))
        del model
        torch.save(start_sd, os.path.join(work, "start.pt"))
        setup_s = time.perf_counter() - t
        spec = {"backend": "gloo" if cpu else "nccl",
                "device": "cpu" if cpu else "cuda",
                "exchange": "neighbours" if cpu else None,
                "joints": cfg.MODEL.NUM_JOINTS,
                "layers": cfg.MODEL.NUM_LAYERS, "weights": weights,
                "pack": pack_path, "work": work, "cfg": step_cfg}
        roots = {k: os.path.join(work, f"w_{k}")
                 for k in ("dp4", "dp2", "mesh2x2")}
        serve_a = {"kind": "serve", "pairs": list(S10_PAIRS), "eval": True,
                   "timed": True}
        jobs = {
            "w4": [dict(serve_a, name="a M=4", m=4, gather=S8_GATHER_SIZE),
                   {"name": "c serve 2x2", "kind": "serve", "m": 2,
                    "pairs": [1], "eval": False, "gather": 0,
                    "timed": False},
                   {"name": "b step", "kind": "step"},
                   {"name": "b loop", "kind": "loop", "m": 1,
                    "cfg": cfgs[4], "root": roots["dp4"]},
                   {"name": "c loop 2x2", "kind": "loop", "m": 2,
                    "cfg": mesh_cfg, "root": roots["mesh2x2"]}],
            "w2": [dict(serve_a, name="a M=2", m=2, gather=0),
                   {"name": "b step", "kind": "step"},
                   {"name": "b loop", "kind": "loop", "m": 1,
                    "cfg": cfgs[2], "root": roots["dp2"]}]}
        t = time.perf_counter()
        procs = s10_launch(work, "w4", 4, dict(spec, jobs=jobs["w4"]))
        try:
            tr = time.perf_counter()
            ref, models = s10_references(spec, inp, dev, (1,))
            one_step = s10_one_card(scfg, start_sd, batch, dev)
            torch.cuda.empty_cache()
            with _Deterministic():
                if not cpu:
                    torch.cuda.reset_peak_memory_stats()
                with EpochTimes() as et:
                    one_loop = loop_cdr.run(
                        load_config(one_cfg), overwrite=True, seed=SEED,
                        scan_epochs=False, device=dev.type,
                        weights_root=os.path.join(work, "w_one"))
            one_loop_s = et.seconds
            one_loop_peak = 0.0 if cpu else \
                torch.cuda.max_memory_allocated() / 2 ** 30
            refs_s = time.perf_counter() - tr
        except BaseException:
            for p, _ in procs:
                p.kill()
            raise
        open(os.path.join(work, "go"), "w").close()
        s10_finish(procs, "phase 15 world 4")
        w4_s = time.perf_counter() - t
        outs4 = [torch.load(os.path.join(work, f"out_w4_{r}.pt"),
                            weights_only=False) for r in range(4)]
        # the unsplit forward at 1 pair, alone on the card
        one, one192 = {}, {}
        b1 = {"image": inp["imgs"][:1].to(dev),
              "proj": inp["projs"][:1].to(dev)}
        b192 = {"image": inp["imgs192"].to(dev),
                "proj": inp["projs192"].to(dev)}
        for kind, model in models.items():
            one[kind] = {"wall_ms": s8_wall_ms(lambda: _infer(model, b1),
                                               S10_TIMED),
                         "busy_ms": s10_profile(lambda: _infer(model, b1))[
                             "busy_ms"]}
            one192[kind] = s8_wall_ms(lambda: _infer(model, b192), S10_TIMED)
        del models
        torch.cuda.empty_cache()
        t = time.perf_counter()
        s10_finish(s10_launch(work, "w2", 2, dict(spec, jobs=jobs["w2"])),
                   "phase 15 world 2")
        w2_s = time.perf_counter() - t
        outs2 = [torch.load(os.path.join(work, f"out_w2_{r}.pt"),
                            weights_only=False) for r in range(2)]
        cli = s10_cli(work, mads, 4, dev.type)

        # a: split serving across cards
        for m, outs in ((4, [o["a M=4"] for o in outs4]),
                        (2, [o["a M=2"] for o in outs2])):
            what = f"a M={m}"
            for r, o in enumerate(outs):
                require(o["mesh"][:5] == (0, 1, r, m, "neighbours")
                        and (cpu or o["mesh"][5] == f"cuda:{r}"),
                        f"{what} rank {r}: mesh {o['mesh']}")
            keys = [f"{k} {p}" for k in ("fp32", "bf16") for p in S10_PAIRS]
            res = {"vs_unsplit": s8_check(outs, ref, m, f"slice 10 {what}",
                                          keys, inp["projs"], dev),
                   "int8": {p: s10_check_int8(outs, ref, m, f"int8 {p}", p)
                            for p in S10_PAIRS},
                   "eval": s8_check_eval(outs, ref)}
            logged = keys + [f"int8 {p}" for p in S10_PAIRS]
            if m == S8_GATHER_M:
                res["gathered"] = s8_check_gathered(
                    outs, ref, m, ("fp32", "bf16"), inp["projs192"], dev,
                    n_split, one192)
                logged += [f"{k} {S8_GATHER_SIZE}"
                           for k in ("fp32", "bf16", "int8")]
            res["bytes"] = s10_check_bytes(outs, m, logged, what)
            res["times"] = s10_times(outs, one, m, what)
            res["launches"] = [{k: sum(o[key]["launches"][k] for key in logged)
                                for k in ("soft_argmax", "soft_argmax_bwd",
                                          "fused_bottleneck")} for o in outs]
            out[what] = res

        # c: split serving on the 2 x 2 mesh, each data group its own pair
        outs = [o["c serve 2x2"] for o in outs4]
        res = {}
        for grp in (0, 1):
            group = outs[2 * grp:2 * grp + 2]
            for j, o in enumerate(group):
                require(o["mesh"][:5] == (grp, 2, j, 2, "neighbours"),
                        f"c data group {grp} rank {j}: mesh {o['mesh']}")
            tag = "1" if grp == 0 else f"1@{grp}"
            gref = {f"{k} 1": ref[f"{k} {tag}"] for k in ("fp32", "bf16",
                                                          "int8")}
            res[f"group {grp}"] = {
                "vs_unsplit": s8_check(group, gref, 2,
                                       f"slice 10 c data group {grp}",
                                       ["fp32 1", "bf16 1"],
                                       inp["projs"][grp:grp + 1], dev),
                "int8": s10_check_int8(group, gref, 2, "int8 1", 1),
                "bytes": s10_check_bytes(group, 2, ["fp32 1", "bf16 1",
                                                    "int8 1"],
                                         f"c data group {grp}")}
        out["c serve 2x2"] = res

        # b: data parallelism across cards, against one card
        out["b one card"] = {k: one_step[k] for k in
                             ("metrics", "launches", "step_ms", "peak_gib",
                              "profile")}
        out["b one process loop"] = {"history": one_loop,
                                     "epoch_s": one_loop_s,
                                     "peak_gib": one_loop_peak}
        for w, outs in ((4, outs4), (2, outs2)):
            out[f"b world {w}"] = {
                "step": s10_check_steps([o["b step"] for o in outs],
                                        one_step, w, n_bn),
                "loop": s10_check_loops([o["b loop"] for o in outs],
                                        one_loop, f"b loop world {w}",
                                        f"dp{w}", roots[f"dp{w}"],
                                        S7_EPOCHS)}
        out["b cli"] = cli
        # c: the loop on the 2 x 2 mesh
        loops = [o["c loop 2x2"] for o in outs4]
        for r, o in enumerate(loops):
            require(o["mesh"] == (r // 2, 2, r % 2, 2) and not o["spatial"]
                    and not {"halo", "gather", "keypoints"} & set(o["counts"]),
                    f"c loop rank {r}: mesh {o['mesh']}, spatial "
                    f"{o['spatial']}, collectives {o['counts']}")
        same = [loops[2 * d]["digest"] == loops[2 * d + 1]["digest"]
                for d in (0, 1)]
        as_world2 = all(loops[0]["history"][k] == outs2[0]["b loop"][
            "history"][k] for k in loops[0]["history"]
            if not k.endswith("_per_sec"))
        print(f"# slice 10 c loop on 2 x 2: the model ranks' final weights "
              f"bit-equal by data group {same}; the history bit-equal to "
              f"world 2's (D = 2, M = 1) {as_world2}")
        require(all(same), f"c loop 2 x 2: the model ranks' final weights "
                           f"differ (by data group {same})")
        out["c loop 2x2"] = dict(
            s10_check_loops(loops, one_loop, "c loop 2x2", "mesh2x2",
                            roots["mesh2x2"], S7_EPOCHS),
            model_ranks_bit_equal=same, history_equal_to_world2=as_world2)
        out["init_s"] = {"w4": [o["init_s"] for o in outs4],
                         "w2": [o["init_s"] for o in outs2]}
        out["seconds"] = {"setup": setup_s, "references": refs_s,
                          "world 4": w4_s, "world 2": w2_s,
                          "cli": cli["seconds"]}
    out["seconds"]["phase"] = time.perf_counter() - t0
    print(f"# slice 10 ({smi}): {out['seconds']}")
    return out


# ----------------------------------------------------------------- slice 11

S16_BATCH, S16_PAD = 32, 4        # a, b: 32 pairs a step, the last 4 padded
S16_STEPS = 6                     # a: an epoch of 6 stacked steps
S16_SEG_E, S16_SEG_VALID = 4, 3   # b: E_full 4, 3 valid epochs + 1 padding
S16_SEG_STEPS = 2                 # b: steps an epoch
S16_LR_STEP = 2                   # b: the LR / 10 from epoch 3 (update 4)
S16_LOOP_EPOCHS, S16_LOOP_EVERY = 3, 2   # c: the loops' run and grid
S16_2D_EPOCHS = 2
S16_HOST_LAUNCHES = 2000          # trivial launches timed for the host's
                                  # cost of one
# CPU-side CUDA calls of torch.profiler that put work on the device
S16_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                    "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                    "cudaMemcpyAsync", "cudaMemsetAsync")


def s16_cfg(work, mads, name, src="configs/mads_3d.yaml", epochs=3, **train):
    """src on phase 12's tree, the tree whole in the device cache, 32 pairs
    a batch, MODEL.NAME name, WARMUP 1."""
    import os
    return app_config(
        src, os.path.join(work, f"{name}.yaml"), mads,
        MODEL={"PRETRAINED": "", "NAME": name},
        DATASET={"DEVICE_CACHE_BYTES": S9_CACHE_BYTES},
        TRAIN=dict({"BATCH_SIZE": S16_BATCH, "EPOCH": epochs, "WARMUP": 1},
                   **train),
        TEST={"BATCH_SIZE": S16_BATCH})


def s16_stacked(loader, steps, pad):
    """`steps` stacked epochs of the loader (one batch each on phase 12's
    tree) as one epoch of `steps` steps, the last `pad` rows of each step
    marked padded."""
    xs = [loader.stacked_epoch()[1] for _ in range(steps)]
    xs = {k: np.concatenate([np.asarray(x[k]) for x in xs]) for k in xs[0]}
    xs["row_valid"] = xs["row_valid"].copy()
    xs["row_valid"][:, -pad:] = 0.0
    return xs


def s16_state(cfg, dev, dtype, steps_per_epoch, mesh=None):
    """The seeded CDRNet's TrainState on dev; under a mesh replicated
    (rank 0's weights, the data group on every BN)."""
    from fast3dhpe_tpu_torch.parallel import replicate
    from fast3dhpe_tpu_torch.train.state import TrainState
    model = seeded_train_model(cfg).to(dev)
    model.dtype = dtype
    if mesh is not None:
        replicate(mesh, model, spatial=False)
    return TrainState.create(model, cfg, steps_per_epoch)


def s16_snapshot(state):
    """The weights, BN statistics and Adam's state, cloned."""
    out = {f"w.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            out[f"adam.{i}.{k}"] = v.detach().clone()
    return out


def s16_gaps(a, b):
    """{name: max |a - b|} of the tensors that are not bit-equal."""
    return {k: float((a[k].double() - b[k].double()).abs().max())
            for k in a if not torch.equal(a[k], b[k])}


def s16_recorder(graphs):
    rec = []
    graphs.on_step = lambda m: rec.append({k: v.detach().clone()
                                           for k, v in m.items()})
    return rec


def s16_profile(fn, steps):
    """One fn() (`steps` steps) under torch.profiler: device busy ms (the
    union of the kernels' spans, so that NCCL's stream beside the compute
    counts once), the NCCL kernels' summed ms (which hold the wait for the
    peers), kernels and host launches (the CUDA calls that put work on the
    device) a step; busy None where the profile holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.events()
    ks = [e for e in ev if e.device_type == DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)
          and not e.name.startswith("nccl:")]
    busy, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in ks):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    nccl = sum(e.time_range.end - e.time_range.start for e in ks
               if "nccl" in e.name.lower())
    calls = Counter(e.name for e in ev if e.device_type == DeviceType.CPU
                    and e.name in S16_LAUNCH_CALLS)
    return {"busy_ms": busy / 1e3 / steps if busy > 0 else None,
            "nccl_ms": nccl / 1e3 / steps,
            "kernels": len(ks) / steps,
            "host_launches": sum(calls.values()) / steps,
            "calls": {k: v / steps for k, v in sorted(calls.items())}}


def s16_wall_ms(fn, steps):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / steps


def s16_masks(frames, xs, cfg, dev):
    """The occlusion masks of a graph's replays against step_generator's:
    graphs.py's StepGraphs on the train pipeline alone (CUTOUT, the
    epoch's rows), its per-step keep-masks against the eager pipeline's
    with step_generator(dev, SEED, i). Returns the masks' hidden share."""
    from fast3dhpe_tpu_torch.data.device_pipeline import (
        preprocess_stereo_batch_cached)
    from fast3dhpe_tpu_torch.train.graphs import StepGraphs
    from fast3dhpe_tpu_torch.train.steps import step_generator, step_seed
    size = tuple(cfg.MODEL.IMAGE_SIZE)
    xd = {k: torch.as_tensor(v).to(dev) for k, v in xs.items()}

    def batch(x, gen):
        return preprocess_stereo_batch_cached(
            gen, frames, x["idx_l"], x["idx_r"], x["trans"], x["P_l"],
            x["P_r"], x["pose_3d"], x["joints_vis"], image_size=size,
            occlusion=cfg.DATASET.OCCLUSION, train=True, return_masks=True)

    graphs = StepGraphs()
    rec = s16_recorder(graphs)
    graphs.epoch(("masks",), frames, xd,
                 lambda x, gen, update: {"keep": batch(x, gen)["keep_mask"]
                                         .float()},
                 seeds=[step_seed(SEED, i) for i in range(len(xs["idx_l"]))])
    require(len(graphs._graphs) == (dev.type == "cuda"),
            "phase 16 a: the mask pipeline was not captured")
    hidden = []
    for i, got in enumerate(rec):
        want = batch({k: v[i] for k, v in xd.items()},
                     step_generator(dev, SEED, i))["keep_mask"].float()
        require(torch.equal(got["keep"], want),
                f"phase 16 a: step {i}'s occlusion masks differ from "
                f"step_generator's ({int((got['keep'] != want).sum())} "
                f"pixels)")
        hidden.append(float(1 - want.mean()))
    return hidden


def s16_epoch_run(cfg, frames, xs, dev, dtype, loss, kw, graphed,
                  timed=True, what="phase 16 a", use_3d=True):
    """One train epoch (use_3d) of the rows of xs, graphed or eager, from
    the seeded weights (replicated under kw["mesh"]): its sums, per-step
    metrics, final state, launches, collectives by kind (mesh.COUNTS),
    capture seconds and memory; with `timed`, one more epoch timed (wall
    ms a step) and one profiled (s16_profile), and the idle share."""
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    from fast3dhpe_tpu_torch.train import steps
    n = len(xs["idx_l"])
    state = s16_state(cfg, dev, dtype, n, kw.get("mesh"))
    epoch = steps.make_train_epoch_cdr(
        loss, cfg.MODEL.IMAGE_SIZE, occlusion=cfg.DATASET.OCCLUSION,
        graphed=graphed, **kw)
    rec = s16_recorder(epoch.graphs)
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    COUNTS.clear()
    bn_layers = train_bn_layers(state.model)
    counters = reset_counts()
    bn_before = bn_counts()
    sums = epoch(state, frames, xs, SEED, use_3d)
    launches = {**read_counts(counters), **bn_since(bn_before)}
    run = {"sums": {k: v.clone() for k, v in sums.items()},
           "steps": rec[:], "snap": s16_snapshot(state),
           "launches": launches, "collectives": dict(COUNTS),
           "capture_s": epoch.graphs.capture_s,
           "graphed_by_backend": epoch.graphs.graphed,
           "variants": len(epoch.graphs._graphs),
           "reserved_gib": (torch.cuda.memory_reserved() - reserved)
           / 2 ** 30,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    epoch.graphs.on_step = None
    if timed:
        run["wall_ms"] = s16_wall_ms(
            lambda: epoch(state, frames, xs, SEED + 1, use_3d), n)
        run.update(s16_profile(
            lambda: epoch(state, frames, xs, SEED + 2, use_3d), n))
        run["idle"] = (None if run["busy_ms"] is None
                       else 1 - run["busy_ms"] / run["wall_ms"])
    require(len(rec) == n and all(
        np.isfinite(float(v)) for m in rec for v in m.values()),
        f"{what}: non-finite metrics {rec}")
    way = f"{what}, {'graphed' if graphed else 'eager'}"
    require_counts(launches, n, 1, 1, 0, way)
    require_bn_counts(launches, n, bn_layers, way)
    del state, epoch
    torch.cuda.empty_cache()
    return run


def s16_epoch_pair(cfg, frames, xs, dev, dtype, loss, kw,
                   what="phase 16 a"):
    """a. One train epoch (use_3d) of S16_STEPS steps, eager and graphed,
    from the same seeded weights with the same (capturable) optimizer:
    per-step metrics, weights, BN statistics and Adam's state bit-equal,
    1 K1 + 1 K2 a step; then each way one timed epoch and one profiled."""
    runs = {w: s16_epoch_run(cfg, frames, xs, dev, dtype, loss, kw,
                             w == "graphed", what=what)
            for w in ("eager", "graphed")}
    e, g = runs["eager"], runs["graphed"]
    require(g["variants"] == (dev.type == "cuda") and e["variants"] == 0,
            f"{what}: {g['variants']} graphed variants, {e['variants']} "
            f"eager")
    step_gaps = [s16_gaps(a, b) for a, b in zip(e["steps"], g["steps"])]
    state_gaps = s16_gaps(e["snap"], g["snap"])
    sum_gaps = s16_gaps(e["sums"], g["sums"])
    bit_equal = not any(step_gaps) and not state_gaps and not sum_gaps
    return runs, bit_equal, {"steps": step_gaps, "sums": sum_gaps,
                             "state": dict(list(state_gaps.items())[:8]),
                             "state_differing": len(state_gaps)}


def s16_bounds(gaps, e, g, what):
    """d. Where graphed and eager are not bit-equal: the metrics within
    phase 12's S7_* bounds (relative), the state's largest gap printed."""
    for i, (a, b) in enumerate(zip(e["steps"], g["steps"])):
        for k in a:
            rel = float((a[k] - b[k]).abs() / b[k].abs().clamp_min(1e-30))
            bound = S7_WARMUP_RTOL if k in ("loss", "loss_2d") else S7_2D_RTOL
            require(rel <= bound, f"{what}: step {i} {k} {rel:.3g} from "
                                  f"eager (bound {bound})")
    print(f"# phase 16 {what}: NOT bit-equal, within S7_* bounds; gaps "
          f"{gaps}")


def s16_segment(cfg, tl, vl, dev, loss, kw, pad=S16_PAD,
                what="phase 16 b"):
    """b. make_segment_cdr over E_full = S16_SEG_E epochs, S16_SEG_VALID
    valid and the rest padding, WARMUP 1 and the LR / 10 from epoch
    S16_LR_STEP + 1, against the same epochs on the epoch path with the
    best chosen on the host: bit-equal. Under kw["mesh"] the loaders are
    the rank's and every step the global batch's."""
    from fast3dhpe_tpu_torch.train import loop2d, steps
    mesh = kw.get("mesh")
    cfg.TRAIN.LR_STEP = [S16_LR_STEP]
    warmup = cfg.TRAIN.WARMUP
    tframes = tl.ensure_device_cache().frames
    vframes = vl.ensure_device_cache().frames
    epochs = [s16_stacked(tl, S16_SEG_STEPS, pad)
              for _ in range(S16_SEG_VALID)]
    seq, epoch_valid, _ = loop2d._stack_segment(epochs, S16_SEG_E)
    vxs = vl.stacked_epoch()[1]
    size = cfg.MODEL.IMAGE_SIZE
    occl = cfg.DATASET.OCCLUSION

    n = len(epochs[0]["idx_l"])             # steps an epoch
    seg_state = s16_state(cfg, dev, torch.float32, n, mesh)
    segment = steps.make_segment_cdr(loss, size, occlusion=occl,
                                     warmup=warmup, seed=SEED, **kw)
    best = loop2d._best_snapshot(seg_state)
    counters = reset_counts()
    t = time.perf_counter()
    _, _, best_err, ms = segment(seg_state, best, torch.tensor(
        float("inf"), device=dev), tframes, vframes, seq, vxs, 0,
        epoch_valid)
    seg_launches = read_counts(counters)
    seg_s = time.perf_counter() - t
    lr_got = seg_state.optimizer.param_groups[0]["lr"]
    lr_want = seg_state.schedule(seg_state.step - 1)

    ep_state = s16_state(cfg, dev, torch.float32, n, mesh)
    train = steps.make_train_epoch_cdr(loss, size, occlusion=occl, **kw)
    evaluate = steps.make_eval_epoch_cdr(loss, size, **kw)
    rows, berr, best_ep = [], float("inf"), None
    for e in range(S16_SEG_VALID):
        use_3d = e >= warmup
        tsum = train(ep_state, tframes, epochs[e], SEED * 10007 + e, use_3d)
        esum = evaluate(ep_state, vframes, vxs, use_3d)
        e3 = float(esum["e3_sum"] / esum["n"].clamp_min(1.0))
        improved = e > warmup and e3 < berr
        if improved:
            berr = e3
            best_ep = {k: v.clone()
                       for k, v in ep_state.model.state_dict().items()}
        rows.append({"train": {k: v.clone() for k, v in tsum.items()},
                     "eval": {k: v.clone() for k, v in esum.items()},
                     "improved": improved})
    metric_gaps = []
    for e in range(S16_SEG_E):
        for part in ("train", "eval"):
            for k, v in ms[part].items():
                want = (rows[e][part][k] if e < S16_SEG_VALID
                        else torch.zeros_like(v[e]))
                if not torch.equal(v[e], want):
                    metric_gaps.append((e, part, k, float(v[e]),
                                        float(want)))
    improved = [bool(x) for x in ms["improved"].tolist()]
    want_improved = [r["improved"] for r in rows] + [False] * (
        S16_SEG_E - S16_SEG_VALID)
    best_gaps = (s16_gaps({k: best[k] for k in best_ep}, best_ep)
                 if best_ep is not None else {"no best": 1.0})
    final_gaps = s16_gaps(s16_snapshot(seg_state), s16_snapshot(ep_state))
    out = {"segment_s": seg_s, "launches": seg_launches,
           "improved": improved, "best_err": float(best_err),
           "best_err_epochs": berr, "lr_after": float(lr_got),
           "lr_schedule": lr_want, "steps": seg_state.step,
           "metric_gaps": metric_gaps[:6], "best_gaps": len(best_gaps),
           "final_gaps": len(final_gaps)}
    print(f"# {what}, segment E_full {S16_SEG_E} ({S16_SEG_VALID} valid) "
          f"against {S16_SEG_VALID} epochs: {out}")
    require(improved == want_improved and float(best_err) == berr,
            f"{what}: improved {improved} / {want_improved}, best "
            f"{float(best_err)} / {berr}")
    require(not metric_gaps and not best_gaps and not final_gaps,
            f"{what}: the segment differs from the epochs: metrics "
            f"{metric_gaps[:6]}, best {list(best_gaps.items())[:4]}, final "
            f"{list(final_gaps.items())[:4]}")
    require(seg_state.step == S16_SEG_VALID * n
            and lr_want == cfg.TRAIN.LR * cfg.TRAIN.LR_FACTOR
            and float(lr_got) == (float(torch.tensor(lr_want,
                                                     dtype=lr_got.dtype))
                                  if torch.is_tensor(lr_got) else lr_want),
            f"{what}: after the segment step {seg_state.step}, LR "
            f"{float(lr_got)} (schedule {lr_want})")
    # a train step K1 + K2, an eval batch K1, S16_SEG_VALID epochs
    n_eval = len(vxs["idx_l"])
    require_counts(seg_launches, 1, S16_SEG_VALID * (n + n_eval),
                   S16_SEG_VALID * n, 0, what)
    return out


def s16_loops(work, mads, dev):
    """c. loop_cdr.run by segments (segments=None, checkpoint_every
    S16_LOOP_EVERY) against segments=False, bit-equal; saves only on the
    grid; a resumed run's occlusion keys; loop2d.run both ways."""
    import os
    import shutil
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.train import checkpoint, loop2d, loop_cdr, steps
    cfg3 = s16_cfg(work, mads, "s16loop", epochs=S16_LOOP_EPOCHS)
    saves, seeds = [], []
    save_file, step_seed = checkpoint.save_file, steps.step_seed

    def spy_save(path, obj):
        step = (obj["step"] if path.endswith(".opt.pt")
                else checkpoint.weights_step(obj))
        saves.append((os.path.basename(path), step))
        save_file(path, obj)

    def spy_seed(epoch_seed, step):
        if step == 0:
            seeds.append(epoch_seed)
        return step_seed(epoch_seed, step)

    def run(name, **kw):
        del saves[:], seeds[:]
        counters = reset_counts()
        h = loop_cdr.run(load_config(cfg3), seed=SEED, device=dev.type,
                         checkpoint_every=S16_LOOP_EVERY,
                         weights_root=os.path.join(work, name),
                         **dict({"overwrite": True}, **kw))
        return h, list(saves), list(seeds), read_counts(counters)

    checkpoint.save_file, steps.step_seed = spy_save, spy_seed
    try:
        h_seg, saves_seg, seeds_seg, n_seg = run("w_seg")
        h_ep, _, seeds_ep, n_ep = run("w_ep", segments=False)
        run("w_res", max_epochs=S16_LOOP_EPOCHS - 1)
        shutil.copytree(os.path.join(work, "w_res"),
                        os.path.join(work, "w_res_ep"))
        _, _, seeds_res, _ = run("w_res", resume=True, overwrite=False)
        _, _, seeds_res_ep, _ = run("w_res_ep", resume=True, overwrite=False,
                                    segments=False)
    finally:
        checkpoint.save_file, steps.step_seed = save_file, step_seed
    keys = [k for k in h_seg if not k.endswith("_per_sec")]
    equal = all(h_seg[k] == h_ep[k] for k in keys)
    latest = [s for n, s in saves_seg if n == "latest.pth"]
    S = latest[-1] // S16_LOOP_EPOCHS       # steps an epoch (1 on the card)
    best = [s for n, s in saves_seg if n == "best.pth"]
    grid = [e * S for e in range(1, S16_LOOP_EPOCHS + 1)
            if e % S16_LOOP_EVERY == 0 or e == S16_LOOP_EPOCHS]
    want_seeds = [SEED * 10007 + e for e in range(S16_LOOP_EPOCHS)]
    print(f"# phase 16 c, loop_cdr.run by segments against segments=False: "
          f"history bit-equal {equal}; saves {saves_seg} (grid {grid}); "
          f"epoch seeds {seeds_seg}, epoch path {seeds_ep}, resumed by "
          f"segments {seeds_res}, by epochs {seeds_res_ep}; {h_seg}")
    require(equal, f"phase 16 c: segments {h_seg} / epochs {h_ep}")
    require(np.isfinite([h_seg[k] for k in keys]).all(),
            f"phase 16 c: {h_seg}")
    require(latest == grid and all(s in grid for s in best) and best,
            f"phase 16 c: latest written at steps {latest}, best at {best} "
            f"(grid {grid})")
    require(seeds_seg == seeds_ep == want_seeds
            and seeds_res == [SEED * 10007 + S16_LOOP_EPOCHS - 1]
            and seeds_res_ep == [SEED * 10007],
            f"phase 16 c: occlusion epoch seeds {seeds_seg}, {seeds_ep}; "
            f"resumed {seeds_res} (segments), {seeds_res_ep} (epochs)")
    for n, what in ((n_seg, "segments"), (n_ep, "epochs")):
        # an epoch: a train step (K1 + K2) and an eval batch (K1)
        require_counts(n, S16_LOOP_EPOCHS, 2, 1, 0, f"phase 16 c, {what}")

    cfg2 = s16_cfg(work, mads, "s16loop2d", src="configs/mads_2d.yaml",
                   epochs=S16_2D_EPOCHS)
    h2 = {}
    counters = reset_counts()
    for segments in (None, False):
        h2[segments] = loop2d.run(
            load_config(cfg2), seed=SEED, device=dev.type, overwrite=True,
            segments=segments, weights_root=os.path.join(
                work, f"w2d_{segments}"))
    n2d = read_counts(counters)
    keys2 = [k for k in h2[None] if not k.endswith("_per_sec")]
    equal2 = all(h2[None][k] == h2[False][k] for k in keys2)
    print(f"# phase 16 c, loop2d.run (PoseResNet-101) by segments against "
          f"segments=False: history bit-equal {equal2}; {h2[None]}")
    require(equal2, f"phase 16 c: 2D segments {h2[None]} / epochs "
                    f"{h2[False]}")
    require_counts(n2d, 1, 0, 0, 0, "phase 16 c, 2D loops")
    return {"history_bit_equal": equal, "saves": saves_seg, "grid": grid,
            "seeds": seeds_seg, "seeds_resumed": seeds_res,
            "seeds_resumed_epochs": seeds_res_ep, "launches": n_seg,
            "launches_epochs": n_ep, "history": h_seg,
            "history_2d_bit_equal": equal2, "launches_2d": n2d}


def s16_host_launch_us(dev):
    """Host time of one trivial eager launch, us (no synchronisation
    between the launches)."""
    x = torch.zeros(8, device=dev)
    x.add_(1.0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(S16_HOST_LAUNCHES):
        x.add_(1.0)
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host / S16_HOST_LAUNCHES * 1e6


def s16_shapes_checked(size, joints):
    """Every K1 and K2 input of phase 16 is one that step 2 checks: the
    train step's and the eval batch's whole heatmaps at 32 pairs."""
    k1 = {shape for _, shape in SOFTARGMAX_SHAPES}
    shape = (2 * S16_BATCH, size // 4, size // 4, joints)
    require(shape in k1, f"phase 16 gives K1 and K2 {shape}, which step 2 "
                         f"does not check")


def run_slice11(dev, smi):
    """Phase 16: the stacked train epoch with each step replayed from a
    CUDA graph against the same epoch run eagerly (a), a segment against
    its epochs (b) and the loops by segments (c), CDRNet-101 at 256 px on
    phase 12's tree, with cuDNN deterministic (TF32 is off)."""
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.data.loader import load_data
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.utils.profiling import measure_scan_floor
    t0 = time.perf_counter()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {"part_s": {}}
    try:
        with tempfile.TemporaryDirectory() as work:
            mads = s7_tree(work)
            cfg = load_config(s16_cfg(work, mads, "s16"))
            s16_shapes_checked(cfg.MODEL.IMAGE_SIZE[0], cfg.MODEL.NUM_JOINTS)
            require(cfg.DATASET.OCCLUSION == "CUTOUT",
                    f"phase 16: OCCLUSION {cfg.DATASET.OCCLUSION}")
            tl, vl = load_data(cfg, seed=SEED, device=dev)
            try:
                cache = tl.ensure_device_cache()
                require(cache is not None and not cache.partial,
                        "phase 16: the tree is not whole on the card")
                loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
                kw = dict(loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
                          num_joints=cfg.MODEL.NUM_JOINTS)
                xs = s16_stacked(tl, S16_STEPS, S16_PAD)
                out["part_s"]["set-up"] = time.perf_counter() - t0
                out["mask_hidden_share"] = s16_masks(cache.frames, xs, cfg,
                                                     dev)
                for name, dt in (("fp32", torch.float32),
                                 ("bf16", torch.bfloat16)):
                    runs, equal, gaps = s16_epoch_pair(
                        cfg, cache.frames, xs, dev, dt, loss, kw)
                    if not equal:
                        s16_bounds(gaps, runs["eager"], runs["graphed"],
                                   f"a {name}")
                    out[name] = {
                        "bit_equal": equal, "gaps": gaps,
                        **{w: {k: v for k, v in r.items()
                               if k not in ("sums", "steps", "snap")}
                           for w, r in runs.items()}}
                    e, g = runs["eager"], runs["graphed"]
                    print(f"# phase 16 a, {name} epoch of {S16_STEPS} steps "
                          f"({smi}): graphed bit-equal to eager {equal}; "
                          f"wall {e['wall_ms']:.1f} eager / "
                          f"{g['wall_ms']:.1f} graphed ms a step, busy "
                          f"{e['busy_ms']} / {g['busy_ms']} ms, idle "
                          f"{e['idle']} / {g['idle']}, host launches "
                          f"{e['host_launches']:.1f} / "
                          f"{g['host_launches']:.1f} a step ({g['calls']}), "
                          f"kernel launches {e['launches']} / "
                          f"{g['launches']}, capture "
                          f"{g['capture_s']:.2f} s, reserved "
                          f"{e['reserved_gib']:.2f} / {g['reserved_gib']:.2f}"
                          f" GiB, peak {e['peak_gib']:.2f} / "
                          f"{g['peak_gib']:.2f} GiB")
                out["part_s"]["a"] = (time.perf_counter() - t0
                                      - out["part_s"]["set-up"])
                t = time.perf_counter()
                out["segment"] = s16_segment(cfg, tl, vl, dev, loss, kw)
                out["part_s"]["b"] = time.perf_counter() - t
            finally:
                tl.close()
                vl.close()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            out["loops"] = s16_loops(work, mads, dev)
            out["part_s"]["c"] = time.perf_counter() - t
    finally:
        torch.backends.cudnn.deterministic = det
    out["scan_floor_us"] = {"graph": measure_scan_floor(50, dev) * 1e6,
                            "cpu": measure_scan_floor(50, "cpu") * 1e6}
    out["host_launch_us"] = s16_host_launch_us(dev)
    out["launches"] = {
        "a fp32": out["fp32"]["graphed"]["launches"],
        "a bf16": out["bf16"]["graphed"]["launches"],
        "b": out["segment"]["launches"], "c": out["loops"]["launches"],
        "c epochs": out["loops"]["launches_epochs"],
        "c 2D": out["loops"]["launches_2d"]}
    out["seconds"] = time.perf_counter() - t0
    print(f"# slice 11 ({smi}): replay floor {out['scan_floor_us']} us an "
          f"iteration, host {out['host_launch_us']:.2f} us a launch; phase "
          f"{out['seconds']:.1f} s ({out['part_s']})")
    return out


# ----------------------------------------------------------------- slice 12

S17_CHILD_TIMEOUT = 600           # s: a gloo rank's whole run in b


def s17_plan_line(log):
    """The loop's 'Training path: ...' line from a log's text."""
    return next((ln.split("Training path: ", 1)[1] for ln in
                 log.splitlines() if "Training path: " in ln), None)


class PathLog:
    """A logging handler that keeps the paths that the training loops log
    ('Training path: <path>')."""

    def __init__(self):
        import logging
        self.handler = logging.Handler()
        self.handler.emit = self._emit
        self.lines = []
        self.logger = logging.getLogger("fast3dhpe_tpu_torch")

    def _emit(self, rec):
        if str(rec.msg).startswith("Training path: "):
            self.lines.append(rec.getMessage().split(": ", 1)[1])

    def __enter__(self):
        from fast3dhpe_tpu_torch.utils.logging import setup_logger
        setup_logger()      # its level, before a handler makes it skip
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def s17_capture_refused(mesh, dev):
    """A step whose capture fails on this rank (and runs an all_reduce of
    the mesh first, as every step does): GraphCaptureError naming the
    failing rank(s), raised after the ranks have agreed on it."""
    from fast3dhpe_tpu_torch.parallel.mesh import all_reduce
    from fast3dhpe_tpu_torch.train.graphs import GraphCaptureError, StepGraphs
    import torch.distributed as dist
    fail_on = {dist.get_world_size() - 1}

    def fn(x, gen, update):
        y = all_reduce(mesh.group, [x["v"] * 2.0], "metrics")[0]
        if dev.type == "cuda" and dist.get_rank() in fail_on and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a step that cannot be captured")
        return {"y": y.sum()}

    graphs = StepGraphs(mesh=mesh)
    try:
        graphs.epoch(("refused",), mesh, {"v": torch.ones(3, 4, device=dev)},
                     fn)
    except GraphCaptureError as e:
        return str(e)
    return None


def s17_world1(work, mads, dev, smi):
    """a. NCCL at world size 1 in this process: the stacked fp32 epoch of
    phase 16 a (6 steps of 32 pairs, CUTOUT, use_3d) under make_mesh(),
    graphed, against the same epoch eager under the mesh and against the
    graphed epoch without a mesh: bit for bit; the collectives a replay
    by kind, host launches a step, times; a capture that fails raises
    GraphCaptureError naming the rank."""
    import os
    import torch.distributed as dist
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.data.loader import load_data
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed, make_mesh)
    env = rank_env(0, 1, free_port())
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        require(init_distributed(), "init_distributed made no group")
        mesh = make_mesh()
        require(dist.get_backend() == "nccl" and mesh.size == 1,
                f"phase 17 a: backend {dist.get_backend()}, mesh {mesh}")
        cfg = load_config(s16_cfg(work, mads, "s17"))
        tl, vl = load_data(cfg, mesh=mesh, seed=SEED)
        try:
            cache = tl.ensure_device_cache()
            require(cache is not None and not cache.partial,
                    "phase 17 a: the tree is not whole on the card")
            xs = s16_stacked(tl, S16_STEPS, S16_PAD)
        finally:
            tl.close()
            vl.close()
        loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
        kw = dict(loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
                  num_joints=cfg.MODEL.NUM_JOINTS)
        with _Deterministic():
            runs, equal, gaps = s16_epoch_pair(
                cfg, cache.frames, xs, dev, torch.float32, loss,
                dict(kw, mesh=mesh), what="phase 17 a")
            plain = s16_epoch_run(cfg, cache.frames, xs, dev, torch.float32,
                                  loss, kw, True, what="phase 17 a, no mesh")
        refused = s17_capture_refused(mesh, dev)
    finally:
        destroy_distributed()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    e, g = runs["eager"], runs["graphed"]
    vs_plain = {"steps": [s16_gaps(a, b) for a, b in
                          zip(g["steps"], plain["steps"])],
                "state": len(s16_gaps(g["snap"], plain["snap"])),
                "sums": s16_gaps(g["sums"], plain["sums"])}
    plain_equal = not any(vs_plain["steps"]) and not vs_plain["state"] \
        and not vs_plain["sums"]
    n = len(xs["idx_l"])
    per_replay = {k: v / n for k, v in g["collectives"].items()
                  if k != "capture"}
    out = {"bit_equal_eager": equal, "gaps_eager": gaps,
           "bit_equal_no_mesh": plain_equal, "gaps_no_mesh": vs_plain,
           "collectives_a_step": per_replay,
           "capture_checks": g["collectives"].get("capture", 0),
           "refused": refused,
           **{w: {k: v for k, v in r.items()
                  if k not in ("sums", "steps", "snap")}
              for w, r in (("graphed", g), ("eager", e),
                           ("graphed_no_mesh", plain))}}
    print(f"# phase 17 a, NCCL world 1, stacked fp32 epoch of {n} steps of "
          f"{S16_BATCH} pairs (CUTOUT) under make_mesh() ({smi}): graphed "
          f"bit-equal to eager under the mesh {equal}, to the graphed epoch "
          f"without a mesh {plain_equal}; collectives a step {per_replay} "
          f"(capture checks {out['capture_checks']}); wall "
          f"{g['wall_ms']:.1f} graphed / {e['wall_ms']:.1f} eager / "
          f"{plain['wall_ms']:.1f} no mesh ms a step, busy {g['busy_ms']} / "
          f"{e['busy_ms']} / {plain['busy_ms']} ms, NCCL {g['nccl_ms']:.2f} /"
          f" {e['nccl_ms']:.2f} ms, idle {g['idle']} / {e['idle']} / "
          f"{plain['idle']}, host launches {g['host_launches']:.1f} / "
          f"{e['host_launches']:.1f} / {plain['host_launches']:.1f} a step, "
          f"capture {g['capture_s']:.2f} s, reserved {g['reserved_gib']:.2f}"
          f" / {e['reserved_gib']:.2f} GiB, peak {g['peak_gib']:.2f} / "
          f"{e['peak_gib']:.2f} GiB; a failed capture: {refused}")
    if not equal:
        s16_bounds(gaps, e, g, "a (17) graphed vs eager under the mesh")
    require(plain_equal, f"phase 17 a: the graphed epoch under the world-1 "
                         f"mesh differs from the one without: {vs_plain}")
    n_bn = sum(1 for k in g["snap"] if k.endswith("running_mean"))
    want = {"rows": 1, "bn forward": n_bn, "bn backward": n_bn,
            "gradients": 1, "metrics": 1}
    require(per_replay == want and out["capture_checks"] == 1,
            f"phase 17 a: collectives a step {g['collectives']}, not {want} "
            f"and one capture check")
    require(g["graphed_by_backend"] and not e["graphed_by_backend"]
            and g["variants"] == 1,
            f"phase 17 a: graphed {g['graphed_by_backend']}, variants "
            f"{g['variants']}")
    require(g["host_launches"] < 10,
            f"phase 17 a: {g['host_launches']} host launches a step")
    require(refused is not None and "rank(s) [0]" in refused,
            f"phase 17 a: a capture that fails raised {refused!r}")
    return out


def s17_child(rank, world, port, cfg_path, roots, out):
    """One gloo rank of b, on cuda:0 beside the other: loop_cdr.run through
    make_mesh() by segments (the default: both caches hold the rank's
    shard), then with scan_epochs=False (--per_batch), each into a root of
    its own; the histories, the logged path, launches, collectives and
    epoch seconds."""
    import os
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.parallel import (destroy_distributed,
                                              init_distributed, make_mesh)
    from fast3dhpe_tpu_torch.parallel.mesh import COUNTS
    from fast3dhpe_tpu_torch.train import loop_cdr
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ.update(rank_env(rank, world, port))
    require(init_distributed(backend="gloo", device="cuda:0"),
            "init_distributed made no group")
    res = {}
    try:
        mesh = make_mesh()
        for (path, kw), root in zip((("segments", {}),
                                     ("per_batch", {"scan_epochs": False})),
                                    roots.split(os.pathsep)):
            COUNTS.clear()
            counters = reset_counts()
            with _Deterministic(), EpochTimes() as et, PathLog() as pl:
                hist = loop_cdr.run(load_config(cfg_path), mesh=mesh,
                                    overwrite=True, seed=SEED,
                                    weights_root=root, **kw)
            res[path] = {"history": hist, "launches": read_counts(counters),
                         "counts": dict(COUNTS), "epoch_s": et.seconds,
                         "path": pl.lines}
    finally:
        destroy_distributed()
    with open(out, "w") as f:
        json.dump(res, f)


def s17_gloo(work, mads, dev):
    """b. Two gloo ranks sharing cuda:0, loop_cdr.run at 16 pairs a rank by
    segments (their steps eager, as gloo decides) against the same ranks'
    per-batch path and one process at 32 pairs by segments (graphed), on
    phase 12's tree whole in each rank's cache, augmentation off."""
    import os
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.train import loop_cdr
    n_pairs = len(S7_MOVEMENTS) * S7_FRAMES
    rank_cfg = s7_cfg(work, mads, n_pairs // 2, "s17dp",
                      cache_bytes=S9_CACHE_BYTES)
    one_cfg = s7_cfg(work, mads, n_pairs, "s17one",
                     cache_bytes=S9_CACHE_BYTES)
    roots = [[os.path.join(work, f"w17_{p}_{r}") for p in ("seg", "pb")]
             for r in range(2)]
    outs = [os.path.join(work, f"s17_rank{r}.json") for r in range(2)]
    t = time.perf_counter()
    port = free_port()
    done = _finish([_spawn_self("--s17-child", r, 2, port, rank_cfg,
                                os.pathsep.join(roots[r]), outs[r])
                    for r in range(2)], S17_CHILD_TIMEOUT)
    ranks_s = time.perf_counter() - t
    for r, (rc, log) in enumerate(done):
        require(rc == 0, f"phase 17 b: gloo rank {r} exited {rc}:\n"
                         f"{log[-3000:]}")
    got = []
    for out in outs:
        with open(out) as f:
            got.append(json.load(f))
    counters = reset_counts()
    t = time.perf_counter()
    with _Deterministic(), PathLog() as pl:
        ref = loop_cdr.run(load_config(one_cfg), overwrite=True, seed=SEED,
                           weights_root=os.path.join(work, "w17_one"),
                           device=dev.type)
    one_launches = read_counts(counters)
    one_s = time.perf_counter() - t
    keys = [k for k in ref if not k.endswith("_per_sec")]
    for path in ("segments", "per_batch"):
        for k in keys:
            require(got[0][path]["history"][k] == got[1][path]["history"][k],
                    f"phase 17 b: the ranks' {path} {k} differ")
    seg, pb = got[0]["segments"], got[0]["per_batch"]
    bit_equal = all(seg["history"][k] == pb["history"][k] for k in keys)
    gaps = {k: float(np.max(np.abs(np.asarray(seg["history"][k])
                                   - np.asarray(pb["history"][k]))
                            / np.abs(np.asarray(pb["history"][k]))))
            for k in keys if seg["history"][k] != pb["history"][k]}
    errs, decades = _vs_one_process(seg["history"], ref,
                                    "phase 17 b segments")
    name = load_config(rank_cfg).MODEL.NAME
    written = {r: {p: sorted(os.listdir(os.path.join(root, name)))
                   if os.path.isdir(os.path.join(root, name)) else []
                   for p, root in zip(("segments", "per_batch"), roots[r])}
               for r in range(2)}
    out = {"ranks_s": ranks_s, "one_process_s": one_s,
           "path_logged": [g["segments"]["path"] for g in got],
           "one_process_path": pl.lines,
           "segments_bit_equal_per_batch": bit_equal, "gaps": gaps,
           "vs_one_process": errs, "decades": decades,
           "epoch_s_by_rank": {p: [g[p]["epoch_s"] for g in got]
                               for p in ("segments", "per_batch")},
           "collectives_rank0": {p: got[0][p]["counts"]
                                 for p in ("segments", "per_batch")},
           "launches_by_rank": [g["segments"]["launches"] for g in got],
           "per_batch_launches_by_rank": [g["per_batch"]["launches"]
                                          for g in got],
           "one_process_launches": one_launches, "written": written,
           "history": seg["history"]}
    print(f"# phase 17 b, 2 gloo ranks x {n_pairs // 2} pairs by segments: "
          f"logged {out['path_logged'][0]}; bit-equal to their per-batch "
          f"path {bit_equal} (gaps {gaps}); against 1 process x {n_pairs} "
          f"by segments ({pl.lines}): relative {errs}, decades {decades}; "
          f"epochs {out['epoch_s_by_rank']} s; collectives rank 0 "
          f"{out['collectives_rank0']}; written {written}")
    require(all(p == ["segments under a 2 x 1 mesh (gloo: the steps run "
                      "eagerly); eval stacked"] for p in out["path_logged"])
            and pl.lines == ["segments; eval stacked"],
            f"phase 17 b: the ranks logged {out['path_logged']}, one "
            f"process {pl.lines}")
    if not bit_equal:
        # where the two paths round apart: within S7_*
        _vs_one_process(seg["history"], pb["history"],
                        "phase 17 b segments vs per-batch")
    files = {"latest.opt.pt", "latest.pth"}
    require(all(files <= set(w) for w in written[0].values())
            and not any(written[1].values()),
            f"phase 17 b: checkpoints {written}")
    for r in range(2):
        for launches in (out["launches_by_rank"][r],
                         out["per_batch_launches_by_rank"][r]):
            # an epoch: one train step (K1 + K2) and one eval batch (K1)
            require_counts(launches, S7_EPOCHS, 2, 1, 0,
                           f"phase 17 b rank {r}")
    require_counts(one_launches, S7_EPOCHS, 2, 1, 0, "phase 17 b, 1 process")
    return out


def run_slice12_card(dev, smi):
    """Phase 17: the stacked epochs under a mesh on one card (a: NCCL at
    world 1, graphed; b: two gloo ranks sharing the card, eager)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        mads = s7_tree(work)
        out = {"a": s17_world1(work, mads, dev, smi)}
        torch.cuda.empty_cache()
        out["b"] = s17_gloo(work, mads, dev)
    out["launches"] = {
        "a graphed": out["a"]["graphed"]["launches"],
        "a eager": out["a"]["eager"]["launches"],
        "a no mesh": out["a"]["graphed_no_mesh"]["launches"],
        **{f"b gloo rank {r}, segments": n for r, n in
           enumerate(out["b"]["launches_by_rank"])},
        **{f"b gloo rank {r}, per batch": n for r, n in
           enumerate(out["b"]["per_batch_launches_by_rank"])},
        "b 1 process": out["b"]["one_process_launches"]}
    out["seconds"] = time.perf_counter() - t0
    print(f"# slice 12, one card ({smi}): phase 17 {out['seconds']:.1f} s")
    return out

S18_WORLDS = (4, 2)               # one NCCL rank a card: world 4, then 2
S18_LOOP_PATHS = (("segments", {}), ("epochs", {"segments": False}),
                  ("per_batch", {"scan_epochs": False}))


def s18_cfg(work, mads, pairs, name, epochs=S7_EPOCHS):
    """configs/mads_3d.yaml (CUTOUT) on phase 12's tree, whole in each
    rank's device cache, `pairs` a rank a batch, WARMUP 1."""
    import os
    return app_config(
        "configs/mads_3d.yaml", os.path.join(work, f"{name}.yaml"), mads,
        MODEL={"PRETRAINED": "", "NAME": name},
        DATASET={"DEVICE_CACHE_BYTES": S9_CACHE_BYTES},
        TRAIN={"BATCH_SIZE": pairs, "EPOCH": epochs, "WARMUP": 1},
        TEST={"BATCH_SIZE": pairs})


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu(v) for v in tree]
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


def _strip(run):
    return {k: v for k, v in run.items() if k not in ("sums", "steps",
                                                      "snap")}


def s18_epoch(job, spec, inp, work):
    """a: the global stacked epoch of this process's parent (6 steps of
    32 pairs), this rank's shard_stacked block, with the tree's frames
    whole on the rank's card: the CUTOUT epoch graphed and eager
    (s16_epoch_pair: per-step metrics, weights, BN statistics and Adam's
    state, with each way's times and profile), then one graphed epoch
    without occlusion and without the 3D loss, which the parent holds
    against one card's on the whole batch."""
    from concurrent.futures import ThreadPoolExecutor
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.data.device_cache import DeviceFrameCache
    from fast3dhpe_tpu_torch.data.loader import _BatchDecoder
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.parallel import make_mesh, shard_stacked
    mesh = make_mesh()
    cfg = load_config(spec["epoch_cfg"])
    with ThreadPoolExecutor(4) as pool:
        cache = DeviceFrameCache.build(inp["paths"], _BatchDecoder(pool),
                                       S9_CACHE_BYTES, mesh=mesh)
    xs = shard_stacked(mesh, inp["xs"])
    loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
    kw = dict(loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
              num_joints=cfg.MODEL.NUM_JOINTS, mesh=mesh)
    what = f"phase 18 a, world {mesh.size}"
    with _Deterministic():
        runs, equal, gaps = s16_epoch_pair(cfg, cache.frames, xs,
                                           mesh.device, torch.float32, loss,
                                           kw, what=what)
        cfg.DATASET.OCCLUSION = "None"
        off = s16_epoch_run(cfg, cache.frames, xs, mesh.device,
                            torch.float32, loss, kw, True, timed=False,
                            what=what + ", no occlusion", use_3d=False)
    return {"bit_equal": equal, "gaps": gaps,
            "graphed": _strip(runs["graphed"]),
            "eager": _strip(runs["eager"]),
            "graphed_steps": _cpu(runs["graphed"]["steps"]),
            "eager_steps": _cpu(runs["eager"]["steps"]),
            "off_steps": _cpu(off["steps"]), "pairs": len(xs["idx_l"][0])}


def s18_segment(job, spec, inp, work):
    """a: s16_segment on this rank's own loaders (its record shard, whole
    in its cache): a segment of E_full 4 (3 valid) against its 3 epochs,
    bit for bit, every step the global batch's."""
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.data.loader import load_data
    from fast3dhpe_tpu_torch.models.losses import make_loss
    from fast3dhpe_tpu_torch.parallel import make_mesh
    mesh = make_mesh()
    cfg = load_config(job["cfg"])
    loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
    kw = dict(loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
              num_joints=cfg.MODEL.NUM_JOINTS, mesh=mesh)
    tl, vl = load_data(cfg, mesh=mesh, seed=SEED)
    try:
        with _Deterministic():
            return s16_segment(cfg, tl, vl, mesh.device, loss, kw,
                               pad=max(1, S16_PAD // mesh.size),
                               what=f"phase 18 b, world {mesh.size}")
    finally:
        tl.close()
        vl.close()


S10_JOBS.update({"s18 epoch": s18_epoch, "s18 segment": s18_segment})


def s18_shapes_checked(size, joints):
    """Every K1 and K2 input of phase 18 is one that step 2 checks: a
    rank's whole heatmaps at 32 / w pairs (w = 1, 2, 4; the 2 x 2 mesh's
    data ranks hold 16), train steps and eval batches alike."""
    k1 = {shape for _, shape in SOFTARGMAX_SHAPES}
    for w in (1,) + S18_WORLDS:
        shape = (2 * S16_BATCH // w, size // 4, size // 4, joints)
        require(shape in k1, f"phase 18 gives K1 and K2 {shape}, which "
                             f"step 2 does not check")


def s18_timing_line(world, one, outs):
    """One card's graphed step beside the ranks' graphed and eager steps:
    wall ms, device busy ms, NCCL ms, idle share, host launches, capture
    s, reserved and peak GiB."""
    def row(r):
        return (f"wall {r['wall_ms']:.1f} ms, busy {r['busy_ms']} ms, NCCL "
                f"{r['nccl_ms']:.2f} ms, idle {r['idle']}, host launches "
                f"{r['host_launches']:.1f}, capture {r['capture_s']:.2f} s, "
                f"reserved {r['reserved_gib']:.2f} GiB, peak "
                f"{r['peak_gib']:.2f} GiB")
    lines = [f"# phase 18, world {world} ({S16_BATCH // world} pairs a rank "
             f"of {S16_BATCH}): one card graphed: {row(one)}"]
    for r, o in enumerate(outs):
        lines.append(f"#   rank {r} graphed: {row(o['graphed'])}")
        lines.append(f"#   rank {r} eager:   {row(o['eager'])}")
    print("\n".join(lines))


def s18_check_epochs(world, outs, one_off, n_bn):
    """a: every rank's per-step metrics equal (the global batch's); graphed
    against eager bit-equal (or within S7_*, the gaps printed); the
    collectives a step by kind and one capture check, counted through the
    replays; fewer than 10 host launches a step; 1 K1 + 1 K2 a step; the
    epoch without occlusion against one card's: step 0 (the same weights)
    loss within S7_WARMUP_RTOL and grad_norm within S7_2D_RTOL, the later
    steps' losses within S7_POST_RTOL."""
    what = f"phase 18 a, world {world}"
    for r, o in enumerate(outs[1:], 1):
        for key in ("graphed_steps", "off_steps"):
            for i, (a, b) in enumerate(zip(o[key], outs[0][key])):
                require(all(torch.equal(a[k], b[k]) for k in a),
                        f"{what}: rank {r}'s {key} step {i} differs from "
                        f"rank 0's")
    o = outs[0]
    if not o["bit_equal"]:
        s16_bounds(o["gaps"], {"steps": o["eager_steps"]},
                   {"steps": o["graphed_steps"]}, f"18 a, world {world}")
    want = {"rows": 1, "bn forward": n_bn, "bn backward": n_bn,
            "gradients": 1, "metrics": 1}
    n = len(o["graphed_steps"])
    for r, x in enumerate(outs):
        g = x["graphed"]
        per = {k: v / n for k, v in g["collectives"].items()
               if k != "capture"}
        require(per == want and g["collectives"].get("capture") == 1,
                f"{what} rank {r}: collectives {g['collectives']}")
        require(g["graphed_by_backend"] and g["variants"] == 1
                and g["host_launches"] < 10,
                f"{what} rank {r}: graphed {g['graphed_by_backend']}, "
                f"variants {g['variants']}, host launches "
                f"{g['host_launches']}")
    rel = []
    for i, (a, b) in enumerate(zip(o["off_steps"], one_off)):
        rel.append({k: float((a[k].cpu() - b[k].cpu()).abs()
                             / b[k].cpu().abs().clamp_min(1e-30))
                    for k in ("loss", "loss_2d", "grad_norm")})
    print(f"# {what}: graphed bit-equal to eager {o['bit_equal']} (gaps "
          f"{o['gaps'] if not o['bit_equal'] else {}}); collectives a step "
          f"{want}; without occlusion against one card, relative by step "
          f"{rel}")
    require(rel[0]["loss"] <= S7_WARMUP_RTOL
            and rel[0]["grad_norm"] <= S7_2D_RTOL
            and all(x["loss"] <= S7_POST_RTOL for x in rel),
            f"{what}: against one card {rel}")
    return {"bit_equal": o["bit_equal"], "gaps": o["gaps"],
            "vs_one_card": rel,
            "graphed_by_rank": [x["graphed"] for x in outs],
            "eager_by_rank": [x["eager"] for x in outs]}


def s18_check_loops(world, outs, roots, name):
    """c: by segments, stacked epochs and batch by batch: every rank's
    history equal; segments bit-equal to stacked epochs and to the
    per-batch path (or within S7_* of it, the gaps printed); the segment
    path logged with its graphs; one checkpoint set in each shared root;
    2 K1 + 1 K2 an epoch a rank."""
    import os
    what = f"phase 18 c, world {world}"
    hists = {}
    for path, _ in S18_LOOP_PATHS:
        runs = [o[f"loop {path}"] for o in outs]
        h0 = runs[0]["history"]
        keys = [k for k in h0 if not k.endswith("_per_sec")]
        for r, x in enumerate(runs):
            require(all(x["history"][k] == h0[k] for k in keys),
                    f"{what} {path}: rank {r}'s history differs")
            require_counts(x["launches"], S7_EPOCHS, 2, 1, 0,
                           f"{what} {path} rank {r}")
        files = sorted(os.listdir(os.path.join(roots[path], name)))
        require(os.listdir(roots[path]) == [name]
                and {"latest.opt.pt", "latest.pth"} <= set(files),
                f"{what} {path}: the shared root holds {files}")
        hists[path] = h0
    logged = [o["loop segments"]["path"] for o in outs]
    want_path = (f"segments under a {world} x 1 mesh (nccl: each step "
                 f"replays a CUDA graph with its collectives); eval stacked")
    require(all(p == [want_path] for p in logged),
            f"{what}: the ranks logged {logged}")
    seg = hists["segments"]
    keys = [k for k in seg if not k.endswith("_per_sec")]
    eq_ep = all(seg[k] == hists["epochs"][k] for k in keys)
    eq_pb = all(seg[k] == hists["per_batch"][k] for k in keys)
    require(eq_ep, f"{what}: segments {seg} / stacked epochs "
                   f"{hists['epochs']}")
    errs = None
    if not eq_pb:
        errs, _ = _vs_one_process(seg, hists["per_batch"],
                                  f"{what} segments vs per-batch")
    print(f"# {what}: loop_cdr.run by segments bit-equal to stacked epochs "
          f"{eq_ep}, to the per-batch path {eq_pb} ({errs}); logged "
          f"{logged[0]}; epochs "
          + "; ".join(f"{p} " + ", ".join(f"{s:.2f}" for s in
                                          outs[0][f'loop {p}']['epoch_s'])
                      for p, _ in S18_LOOP_PATHS) + " s (rank 0)")
    return {"segments_equal_epochs": eq_ep, "segments_equal_per_batch": eq_pb,
            "vs_per_batch": errs, "history": seg,
            "epoch_s": {p: [o[f"loop {p}"]["epoch_s"] for o in outs]
                        for p, _ in S18_LOOP_PATHS},
            "collectives_rank0": {p: outs[0][f"loop {p}"]["counts"]
                                  for p, _ in S18_LOOP_PATHS},
            "launches_by_rank": {p: [o[f"loop {p}"]["launches"] for o in outs]
                                 for p, _ in S18_LOOP_PATHS}}


def run_slice12(dev, smi):
    """Phase 18: the stacked epochs, segments and loops under NCCL across
    cards, one rank a card: world 4, then world 2 on cards 0-1, then
    torchrun's train_cdr over 4 ranks by segments. This process builds
    the global stacked epoch and runs one card's references on cuda:0
    while the first launch's ranks start; the ranks begin at `go`."""
    import os
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.data.loader import load_data
    from fast3dhpe_tpu_torch.models.losses import make_loss
    t0 = time.perf_counter()
    out = {"seconds": {}}
    with tempfile.TemporaryDirectory() as work:
        mads = s7_tree(work)
        epoch_cfg = s16_cfg(work, mads, "s18")
        cfg = load_config(epoch_cfg)
        s18_shapes_checked(cfg.MODEL.IMAGE_SIZE[0], cfg.MODEL.NUM_JOINTS)
        tl, vl = load_data(cfg, seed=SEED, device=dev)
        try:
            cache = tl.ensure_device_cache()
            require(cache is not None and not cache.partial,
                    "phase 18: the tree is not whole on the card")
            xs = s16_stacked(tl, S16_STEPS, S16_PAD)
            paths = sorted(cache._row_of, key=cache._row_of.get)
        finally:
            tl.close()
            vl.close()
        torch.save({"xs": xs, "paths": paths},
                   os.path.join(work, "inputs.pt"))
        jobs, roots = {}, {}
        for w in S18_WORLDS:
            pairs = S16_BATCH // w
            jobs[w] = [{"name": "epoch", "kind": "s18 epoch"},
                       {"name": "segment", "kind": "s18 segment",
                        "cfg": s18_cfg(work, mads, pairs, f"seg{w}")}]
            for path, kw in S18_LOOP_PATHS:
                roots[w, path] = os.path.join(work, f"w18_{w}_{path}")
                jobs[w].append({"name": f"loop {path}", "kind": "loop",
                                "m": 1, "kw": kw, "root": roots[w, path],
                                "cfg": s18_cfg(work, mads, pairs,
                                               f"loop{w}")})
        roots["2x2"] = os.path.join(work, "w18_2x2")
        jobs[4].append({"name": "loop 2x2", "kind": "loop", "m": 2,
                        "root": roots["2x2"],
                        "cfg": s18_cfg(work, mads, S16_BATCH // 2,
                                       "loop2x2")})
        cpu = dev.type == "cpu"     # a rehearsal: gloo ranks on the CPU
        spec = {"backend": "gloo" if cpu else "nccl",
                "device": "cpu" if cpu else "cuda", "exchange": None,
                "epoch_cfg": epoch_cfg}
        procs = s10_launch(work, "s18w4", 4, dict(spec, jobs=jobs[4]))
        try:
            t = time.perf_counter()
            loss = make_loss(cfg.LOSS.TYPE, cfg.LOSS.USE_TARGET_WEIGHT)
            kw = dict(loss_3d_weight=cfg.TRAIN.LOSS_3D_WEIGHT,
                      num_joints=cfg.MODEL.NUM_JOINTS)
            with _Deterministic():
                one = s16_epoch_run(cfg, cache.frames, xs, dev,
                                    torch.float32, loss, kw, True,
                                    what="phase 18, one card")
                cfg.DATASET.OCCLUSION = "None"
                one_off = s16_epoch_run(cfg, cache.frames, xs, dev,
                                        torch.float32, loss, kw, True,
                                        timed=False, use_3d=False,
                                        what="phase 18, one card")["steps"]
            del cache
            torch.cuda.empty_cache()
            out["seconds"]["one card"] = time.perf_counter() - t
        except BaseException:
            for p, _ in procs:
                p.kill()
            raise
        open(os.path.join(work, "go"), "w").close()
        outs = {}
        for w in S18_WORLDS:
            t = time.perf_counter()
            if w != 4:      # `go` stands: these ranks start at once
                procs = s10_launch(work, f"s18w{w}", w,
                                   dict(spec, jobs=jobs[w]))
            s10_finish(procs, f"phase 18 world {w}")
            outs[w] = [torch.load(os.path.join(work, f"out_s18w{w}_{r}.pt"),
                                  weights_only=False) for r in range(w)]
            out["seconds"][f"world {w}"] = time.perf_counter() - t
        t = time.perf_counter()
        cli_cfg = s18_cfg(work, mads, S16_BATCH // 4, "cli12", epochs=1)
        cli = s10_cli(work, mads, 4, dev.type, cfg=cli_cfg, name="cli12")
        out["seconds"]["cli"] = time.perf_counter() - t
        n_bn = sum(1 for k in one["snap"] if k.endswith("running_mean"))
        out["one card"] = _strip(one)
        for w in S18_WORLDS:
            ranks = outs[w]
            s18_timing_line(w, one, [o["epoch"] for o in ranks])
            out[f"world {w}"] = {
                "epoch": s18_check_epochs(w, [o["epoch"] for o in ranks],
                                          one_off, n_bn),
                "segment": [o["segment"] for o in ranks],
                "loops": s18_check_loops(
                    w, ranks, {p: roots[w, p] for p, _ in S18_LOOP_PATHS},
                    f"loop{w}"),
                "init_s": [o["init_s"] for o in ranks]}
        loops = [o["loop 2x2"] for o in outs[4]]
        h0 = loops[0]["history"]
        same = [loops[2 * d]["digest"] == loops[2 * d + 1]["digest"]
                for d in (0, 1)]
        want_path = ("segments under a 2 x 2 mesh (nccl: each step replays "
                     "a CUDA graph with its collectives); eval stacked")
        for r, o in enumerate(loops):
            require(o["mesh"] == (r // 2, 2, r % 2, 2) and not o["spatial"]
                    and all(o["history"][k] == h0[k] for k in h0
                            if not k.endswith("_per_sec"))
                    and o["path"] == [want_path],
                    f"phase 18 d, 2 x 2 rank {r}: mesh {o['mesh']}, path "
                    f"{o['path']}, history {o['history']} / {h0}")
            require_counts(o["launches"], S7_EPOCHS, 2, 1, 0,
                           f"phase 18 d, 2 x 2 rank {r}")
        require(all(same), f"phase 18 d: the model ranks' final weights "
                           f"differ (by data group {same})")
        print(f"# phase 18 d, loop_cdr.run on a 2 x 2 mesh by segments: the "
              f"model ranks' final weights bit-equal by data group {same}; "
              f"logged {loops[0]['path']}; history {h0}")
        out["2x2"] = {"model_ranks_bit_equal": same, "history": h0,
                      "path": loops[0]["path"],
                      "launches_by_rank": [o["launches"] for o in loops]}
        want_cli = ("segments under a 4 x 1 mesh (nccl: each step replays a "
                    "CUDA graph with its collectives); eval stacked")
        print(f"# phase 18 e, torchrun train_cdr over 4 ranks: logged "
              f"{cli['path']}")
        require(cli["path"] == want_cli,
                f"phase 18 e: torchrun's train_cdr logged {cli['path']}")
        out["cli"] = cli
    out["launches"] = {
        "one card": one["launches"],
        **{f"world {w} rank {r}, {job}": o[job]["launches"]
           for w in S18_WORLDS for r, o in enumerate(outs[w])
           for job in ("segment",) + tuple(f"loop {p}" for p, _ in
                                           S18_LOOP_PATHS)},
        **{f"world {w} rank {r}, epoch {way}":
           o["epoch"][way]["launches"] for w in S18_WORLDS
           for r, o in enumerate(outs[w]) for way in ("graphed", "eager")},
        **{f"2 x 2 rank {r}": n
           for r, n in enumerate(out["2x2"]["launches_by_rank"])}}
    out["seconds"]["phase"] = time.perf_counter() - t0
    print(f"# slice 12 across cards ({smi}): {out['seconds']}")
    return out

# ------------------------------------------------------------------ timing

def _decoder_logits(gen, dev, n, dt):
    """Random logits in the decoder's layout: (n, 19, 64, 64) channels_last
    viewed as (n, 64, 64, 19)."""
    h = (torch.randn((n, 19, 64, 64), generator=gen) * 3).to(dt)
    return h.to(dev).contiguous(memory_format=torch.channels_last).permute(
        0, 2, 3, 1)


def _show_times(what, t):
    print(f"# {what}: device {t['device_ms_cold']:.4f} ms L2 cold, "
          f"{t['device_ms_warm']:.4f} ms L2 warm "
          f"({100 * t['share_of_bound']:.1f}% of the bound cold); call "
          f"{t['call_ms']:.4f} ms (host + device); plain "
          f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}, {t['mbytes']:.2f} MB)")


def _timed_row(times, plain, nbytes, flops):
    bound, by = bound_ms(nbytes, flops, FP32_FLOPS)
    return dict(times, ms=times["device_ms_cold"], plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None,
                mbytes=nbytes / 1e6,
                share_of_bound=bound / times["device_ms_cold"])


# (images, dtype) at which K1 and K2 are timed; the first is the row's
K1_TIMED = ((2 * TIMING_PAIRS, torch.bfloat16), (2, torch.bfloat16),
            (2 * TIMING_PAIRS, torch.float32))
K2_TIMED = ((2 * TIMING_PAIRS, torch.float32),
            (2 * TIMING_PAIRS, torch.bfloat16))


def time_softargmax(dev, gen):
    """K1 at a batch-32 request (64 images, bf16), at batch 1 pair (2
    images) and at a train step's fp32 (64 images). Bound: read the logits
    once, write (x, y) and the statistics once; ~6 fp32 operations a
    logit."""
    from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax
    from fast3dhpe_tpu_torch.ops.softargmax import soft_argmax_fused
    rows = []
    for n, dt in K1_TIMED:
        hm = _decoder_logits(gen, dev, n, dt)
        t = kernel_times(lambda: soft_argmax_fused(hm), "softargmax_fwd")
        nbytes = hm.numel() * hm.element_size() + n * 19 * 6 * 4
        row = _timed_row(t, call_ms(lambda: soft_argmax(hm)), nbytes,
                         6 * hm.numel())
        row["shape"] = f"({n}, 64, 64, 19) {str(dt).replace('torch.', '')}"
        _show_times(f"K1 {row['shape']}", row)
        rows.append(row)
    return dict(rows[0], variants=rows[1:])


def time_softargmax_bwd(dev, gen):
    """K2 at 64 images of 64x64x19 in the decoder's layout, fp32 (the
    training path's type) and bf16. Bound: read the logits, g and the
    statistics once, write dh once; ~12 fp32 operations a logit."""
    from fast3dhpe_tpu_torch.ops.heatmap import soft_argmax_bwd
    from fast3dhpe_tpu_torch.ops.softargmax import (soft_argmax_bwd_fused,
                                                    soft_argmax_fwd_fused)
    rows = []
    for n, dt in K2_TIMED:
        hm = _decoder_logits(gen, dev, n, dt)
        g = torch.randn((n, 19, 2), generator=gen).to(dev)
        _, stats = soft_argmax_fwd_fused(hm)
        t = kernel_times(lambda: soft_argmax_bwd_fused(hm, g, stats),
                         "softargmax_bwd")
        nbytes = 2 * hm.numel() * hm.element_size() + n * 19 * 6 * 4
        row = _timed_row(t, call_ms(lambda: soft_argmax_bwd(hm, g)), nbytes,
                         12 * hm.numel())
        row["shape"] = f"({n}, 64, 64, 19) {str(dt).replace('torch.', '')}"
        _show_times(f"K2 {row['shape']}", row)
        rows.append(row)
    return dict(rows[0], variants=rows[1:])


def _time_block(dev, gen, n, cin, planes, ds, hw, plain=False):
    """K3 at one shape with its weights packed once (as the model runs
    it), beside the unfused block on cuDNN: the port's Bottleneck module,
    bf16, BN in eval mode. Bound: x and the weights read once, the output
    written once; the block's FLOPs at the bf16 tensor-core peak."""
    from fast3dhpe_tpu_torch.models.resnet import Bottleneck
    from fast3dhpe_tpu_torch.ops.bottleneck import (bottleneck_plain,
                                                    fused_bottleneck_packed,
                                                    pack_weights)
    x, args = bottleneck_case(gen, dev, n, cin, planes, ds, hw)
    packed = pack_weights(*args)
    cout = 4 * planes
    t = kernel_times(lambda: fused_bottleneck_packed(x, packed),
                     "bottleneck_kernel")
    ms = t["device_ms_cold"]
    blk = Bottleneck(cin, planes, 1, ds).to(dev).eval()
    with torch.inference_mode():
        lib = call_ms(lambda: blk(x))
    flops = 2 * n * hw * hw * planes * (
        cin + 9 * planes + cout + (cin * cout // planes if ds else 0))
    wbytes = 2 * (cin * planes + 9 * planes * planes + planes * cout
                  + (cin * cout if ds else 0))
    nbytes = 2 * n * hw * hw * (cin + cout) + wbytes
    bound, by = bound_ms(nbytes, flops, BF16_FLOPS)
    out = dict(t, n=n, ms=ms, bound_ms=bound, bound_by=by, library_ms=lib,
               gflop=flops / 1e9, mbytes=nbytes / 1e6,
               tflops=flops / ms / 1e9, share_of_bound=bound / ms)
    if plain:
        out["plain_ms"] = call_ms(lambda: bottleneck_plain(x, *args), iters=5)
    return out


_K3_SUMS = ("ms", "device_ms_cold", "device_ms_warm", "call_ms", "bound_ms",
            "library_ms")


def k3_launch_model(n, cin, planes, ds, hw):
    """K3's launch plan at a block's shape, and the weight bytes (MB) the
    launch asks of the L2 as the plan counts them: one stream of the
    block's weights for each work item (a pair of tiles, one a CTA of a
    cluster, which share it by TMA multicast). A model of the traffic,
    not a measurement."""
    from fast3dhpe_tpu_torch.ops.bottleneck import launch_plan
    plan = launch_plan(n, hw, hw)
    wbytes = 2 * (cin * planes + 9 * planes * planes + 4 * planes * planes
                  + (4 * cin * planes if ds else 0))
    return plan, plan.items * wbytes / 1e6


def time_bottleneck(dev, gen):
    """K3 at the forward's launches (layer1.0 + 3 x layer2.x) at 64 images
    and at batch 1 pair (2 images), each batch summed to one forward, and
    at layer1.1, which the gate leaves unfused. Returns the 64-image
    forward (the kernels line's numbers) with its parts, the 2-image
    forward under "batch_1_pair", and layer1.1 under "measured_only"."""
    per_forward = {"layer1.0": 1, "layer2.x": 3}

    def show(name, t, shape):
        plan, l2_mb = k3_launch_model(t["n"], *shape)
        print(f"# K3 {name} at {t['n']} images ({plan.variant}, {plan.ctas} "
              f"CTAs): device {t['ms']:.4f} ms L2 cold, "
              f"{t['device_ms_warm']:.4f} ms warm ({t['tflops']:.1f} "
              f"TFLOP/s, {100 * t['share_of_bound']:.1f}% of the bound cold);"
              f" call {t['call_ms']:.4f} ms, unfused cuDNN block call "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}; {t['gflop']:.2f} GFLOP, "
              f"{t['mbytes']:.1f} MB); weights from L2 {l2_mb:.1f} MB a "
              f"launch (modelled from the launch plan, not measured)"
              + (f", plain {t['plain_ms']:.4f} ms" if "plain_ms" in t
                 else ""))

    forwards = {}
    for n in (2 * TIMING_PAIRS, 2):
        total = dict.fromkeys(_K3_SUMS + ("plain_ms",), 0.0)
        parts, bytes_t, ops_t = [], 0.0, 0.0
        for name, (cin, planes, ds, hw) in BLOCK_SHAPES.items():
            t = _time_block(dev, gen, n, cin, planes, ds, hw, plain=n > 2)
            show(name, t, (cin, planes, ds, hw))
            if n > 2:
                # like for like: both by CUDA events around one call
                require(t["call_ms"] < t["library_ms"],
                        f"K3 {name} at {n} images takes {t['call_ms']:.4f} "
                        f"ms a call, the unfused cuDNN block "
                        f"{t['library_ms']:.4f} ms")
            k = per_forward[name]
            bytes_t += k * t["mbytes"] * 1e6 / HBM_BPS * 1e3
            ops_t += k * t["gflop"] * 1e9 / BF16_FLOPS * 1e3
            for key in total:
                total[key] += k * t.get(key, 0.0)
            parts.append(dict(block=name, per_forward=k, **t))
        total["bound_by"] = "bytes" if bytes_t >= ops_t else "operations"
        total["share_of_bound"] = total["bound_ms"] / total["ms"]
        total["parts"] = parts
        print(f"# K3 one forward at {n} images: device {total['ms']:.4f} ms "
              f"cold, {total['device_ms_warm']:.4f} warm, call "
              f"{total['call_ms']:.4f}, bound {total['bound_ms']:.4f} "
              f"({100 * total['share_of_bound']:.1f}%), unfused cuDNN "
              f"blocks {total['library_ms']:.4f} ms")
        forwards[n] = total
    total = forwards[2 * TIMING_PAIRS]
    total["batch_1_pair"] = {k: v for k, v in forwards[2].items()
                             if k != "plain_ms"}
    t = _time_block(dev, gen, 2 * TIMING_PAIRS, *LAYER11)
    show("layer1.1 (unfused by the gate)", t, LAYER11)
    total["measured_only"] = {"layer1.1": t}
    return total


# ----------------------------------------------------------------- train BN

# (what, shape, channels_last): the CDRNet-101 step's largest BN input at
# 32 pairs (the stem; layer1's 256 x 64 x 64 is as large), its most
# frequent (layer3, 24 of 112 layers), its smallest (CanonicalFusion's 400
# channels at 8 x 8, one row a pair) and the V2V's first level (contiguous
# NCDHW)
BN_TIMED = (("stem", (64, 64, 128, 128), True),
            ("layer3", (64, 1024, 16, 16), True),
            ("fusion", (32, 400, 8, 8), True),
            ("v2v", (10, 32, 64, 64, 64), False))
# checked beside them: layer4 (4,096 rows x 2,048 channels), C not a
# multiple of the vector width, the V2V's deepest level
BN_CHECKED = BN_TIMED + (("layer4", (64, 2048, 8, 8), True),
                         ("C 19", (6, 19, 12, 12), True),
                         ("C 300", (6, 300, 6, 6), True),
                         ("v2v deepest", (10, 128, 2, 2, 2), False))
# a CDRNet-101 step in train mode: 112 BN layers, three launches each way
BN_LAYERS_CDRNET = 112


def _bn_inputs(gen, shape, channels_last, dtype, dev, mask_kind):
    from fast3dhpe_tpu_torch.models.layers import bn_row_mask
    x = (torch.randn(shape, generator=gen) * 1.5 + 0.3).to(dtype).to(dev)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last
                         if len(shape) == 4 else torch.channels_last_3d)
    c, n = shape[1], shape[0]
    w = (1.0 + 0.2 * torch.randn(c, generator=gen)).to(dev)
    b = (0.1 * torch.randn(c, generator=gen)).to(dev)
    dy = torch.empty_like(x).copy_(
        torch.randn(shape, generator=gen).to(dtype))
    valid = torch.ones(n)
    if mask_kind == "filler":
        valid.zero_()
    elif mask_kind == "zero_rows":
        valid[1::3] = 0.0
    mask = None if mask_kind is None else bn_row_mask(valid).to(dev)
    return x, w, b, dy, mask


def _bn_both(fwd, bwd, x, w, b, dy, mask):
    y, mean, var, saved, count = fwd(x, w, b, mask, 1e-5, None)
    dx, dw, db = bwd(dy, x, w, mask, saved, count, None)
    return y, mean, var, dx, dw, db


def check_train_bn(dev, gen):
    """The kernels against the plain version on the card, relative to the
    plain output's largest magnitude: fp32 within 1e-4 (the sums over up
    to 1 M rows run in another order), bf16 y and dx within 2 bf16 ulps
    (2^-7: a value on either side of a rounding step), the fp32 statistics
    and parameter gradients within 1e-4 in both; each case run twice,
    bit-equal; 3 launches each way."""
    from fast3dhpe_tpu_torch.ops import batchnorm as bn
    errs = {}
    for what, shape, cl in BN_CHECKED:
        for dt in (torch.float32, torch.bfloat16):
            for mask_kind in ("zero_rows", None, "filler"):
                if mask_kind == "filler" and what not in ("stem", "v2v"):
                    continue
                key = f"{what} {str(dt)[6:]} mask {mask_kind}"
                ins = _bn_inputs(gen, shape, cl, dt, dev, mask_kind)
                before = (bn.train_bn_forward.launches,
                          bn.train_bn_backward.launches)
                got = _bn_both(bn.train_bn_forward, bn.train_bn_backward,
                               *ins)
                again = _bn_both(bn.train_bn_forward, bn.train_bn_backward,
                                 *ins)
                ref = _bn_both(bn.plain_forward, bn.plain_backward, *ins)
                torch.cuda.synchronize()
                require((bn.train_bn_forward.launches - before[0],
                         bn.train_bn_backward.launches - before[1]) ==
                        (6, 6), f"train BN {key}: 3 launches each way")
                row = {}
                for name, g, a, r in zip(("y", "mean", "var", "dx",
                                          "dweight", "dbias"), got, again,
                                         ref):
                    require(torch.equal(g, a),
                            f"train BN {key}: {name} not deterministic")
                    require(g.dtype == r.dtype and g.shape == r.shape and
                            g.stride() == r.stride(),
                            f"train BN {key}: {name} dtype/shape/strides")
                    scale = float(r.float().abs().max().clamp_min(1e-6))
                    err = float((g.float() - r.float()).abs().max()) / scale
                    tol = (1e-4 if dt == torch.float32 or g.dim() == 1
                           else 2 ** -7)
                    require(err <= tol, f"train BN {key}: {name} {err:.3g} "
                            f"of max|plain| > {tol:.3g}")
                    row[name] = err
                errs[key] = row
                del ins, got, again, ref
    for d, worst in bn_worst(errs).items():
        print(f"# train BN check {d}: worst " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()) + " of max|plain|")
    return errs


def bn_worst(errs):
    """check_train_bn's worst error of each output, by dtype."""
    out = {}
    for d in ("float32", "bfloat16"):
        rows = [r for k, r in errs.items() if f" {d} " in k]
        out[d] = {"cases": len(rows),
                  **{k: max(r[k] for r in rows) for k in rows[0]}}
    return out


def _bn_kernel_ms(fn, cold, iters=20):
    """Median device ms of each train_bn_* kernel a call of fn() launches,
    by name, under torch.profiler (L2 cold: a 128 MiB read before each
    call; warm: back to back). A name launched twice a call (the finish,
    forward and backward) counts each launch."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = (torch.zeros(L2_FLUSH_BYTES // 4, device="cuda") if cold
             else None)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.sum()
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        m = re.search(r"(train_bn_\w+)<", e.name)
        if e.device_type == DeviceType.CUDA and m:
            by_name.setdefault(m.group(1), []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    require(by_name, "train BN timing: the profile holds no train_bn_ "
                     "kernel")
    return {k: statistics.median(v) * round(len(v) / iters)
            for k, v in by_name.items()}


def time_train_bn(dev, gen):
    """Each BN_TIMED shape, fp32 (the training cells' type), channels_last
    or NCDHW as the networks hold it: the kernels' device ms forward (stats,
    finish, norm) and backward (grad_reduce, finish, grad), L2 cold and
    warm, beside the 8-pass bound (the fused design's floor: x read twice
    and y written forward, dy and x read twice and dx written backward),
    the 5-pass bound (each input read once, each output written once), the
    wrappers' call ms, the plain version's call ms, and
    F.batch_norm(training=True) forward and backward as the library's
    yardstick (the port never calls it)."""
    import torch.nn.functional as F
    from fast3dhpe_tpu_torch.ops import batchnorm as bn
    rows = []
    for what, shape, cl in BN_TIMED:
        x, w, b, dy, mask = _bn_inputs(gen, shape, cl, torch.float32, dev,
                                       "zero_rows")
        y, mean, var, saved, count = bn.train_bn_forward(x, w, b, mask,
                                                         1e-5, None)

        def fwd():
            return bn.train_bn_forward(x, w, b, mask, 1e-5, None)

        def bwd():
            return bn.train_bn_backward(dy, x, w, mask, saved, count, None)

        def plain_fwd():
            return bn.plain_forward(x, w, b, mask, 1e-5, None)

        p_saved, p_count = plain_fwd()[3:]

        def plain_bwd():
            return bn.plain_backward(dy, x, w, mask, p_saved, p_count, None)

        xl = x.detach().requires_grad_(True)
        wl, bl = w.clone().requires_grad_(True), b.clone().requires_grad_(
            True)

        def lib_fwd():
            return F.batch_norm(xl, None, None, wl, bl, True, 0.0, 1e-5)

        def lib_both():
            xl.grad = wl.grad = bl.grad = None
            lib_fwd().backward(dy)

        nbytes = x.numel() * x.element_size()
        row = {"shape": f"{shape} fp32 "
                        f"{'channels_last' if cl else 'contiguous'}",
               "mbytes": nbytes / 1e6,
               "bound8_ms": (3 + 5) * nbytes / HBM_BPS * 1e3,
               "bound5_ms": (2 + 3) * nbytes / HBM_BPS * 1e3}
        for way, fn in (("fwd", fwd), ("bwd", bwd)):
            cold, warm = _bn_kernel_ms(fn, True), _bn_kernel_ms(fn, False)
            row[way] = {"device_ms_cold": sum(cold.values()),
                        "device_ms_warm": sum(warm.values()),
                        "kernels_cold": cold, "call_ms": call_ms(fn)}
        row["device_ms_cold"] = (row["fwd"]["device_ms_cold"]
                                 + row["bwd"]["device_ms_cold"])
        row["device_ms_warm"] = (row["fwd"]["device_ms_warm"]
                                 + row["bwd"]["device_ms_warm"])
        row["share_of_bound8"] = row["bound8_ms"] / row["device_ms_cold"]
        row["share_of_bound5"] = row["bound5_ms"] / row["device_ms_cold"]
        row["plain_ms"] = {"fwd": call_ms(plain_fwd),
                           "bwd": call_ms(plain_bwd)}
        row["library_ms"] = {"fwd": call_ms(lib_fwd),
                             "fwd_bwd": call_ms(lib_both)}
        print(f"# train BN {what} {row['shape']} ({row['mbytes']:.1f} MB): "
              f"device fwd {row['fwd']['device_ms_cold']:.4f} / "
              f"{row['fwd']['device_ms_warm']:.4f} ms, bwd "
              f"{row['bwd']['device_ms_cold']:.4f} / "
              f"{row['bwd']['device_ms_warm']:.4f} ms (L2 cold / warm), "
              f"{100 * row['share_of_bound8']:.1f}% of the 8-pass bound "
              f"{row['bound8_ms']:.4f} ms cold, "
              f"{100 * row['share_of_bound5']:.1f}% of the 5-pass "
              f"{row['bound5_ms']:.4f}; call fwd {row['fwd']['call_ms']:.4f}"
              f" bwd {row['bwd']['call_ms']:.4f}; plain fwd "
              f"{row['plain_ms']['fwd']:.4f} bwd {row['plain_ms']['bwd']:.4f}"
              f"; F.batch_norm fwd {row['library_ms']['fwd']:.4f} fwd+bwd "
              f"{row['library_ms']['fwd_bwd']:.4f}; by kernel (cold) "
              + ", ".join(f"{k} {v:.4f}" for k, v in
                          {**{f'fwd {k}': v for k, v in
                              row['fwd']['kernels_cold'].items()},
                           **{f'bwd {k}': v for k, v in
                              row['bwd']['kernels_cold'].items()}}.items()))
        rows.append(row)
        del x, dy, y, saved, xl
        torch.cuda.empty_cache()
    return rows


def train_bn_step(cfg, dev):
    """One main-path CDRNet-101 train step (train_step_fn, use_3d, fp32,
    32 pairs, 4 padded) after a warm one, under torch.profiler: every BN
    layer takes the kernels, 3 launches each way (BN_LAYERS_CDRNET layers)
    and no relayout of dy, and the profile holds train_bn_* kernels and
    no other BatchNorm kernel; their summed device ms beside all the
    kernels'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fast3dhpe_tpu_torch.train.state import TrainState
    batch = on_device(train_batch(np.random.RandomState(SEED + 2),
                                  TRAIN_PAIRS, TRAIN_PAD,
                                  cfg.MODEL.IMAGE_SIZE[0]), dev)
    model = seeded_train_model(cfg).to(dev)
    calibrate_train_head(model, batch)
    state = TrainState.create(model, cfg, steps_per_epoch=1)
    train_step = train_step_fn(cfg)

    def step():
        train_step(state, batch, True)

    step()
    torch.cuda.synchronize()
    before = bn_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    counts = bn_since(before)
    require_bn_counts(counts, 1, BN_LAYERS_CDRNET, "train BN step")
    launches = (counts["train_bn_forward"], counts["train_bn_backward"])
    spans = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = [n for n, _ in spans]
    ours = sum("train_bn_" in n for n in names)
    bn_ms = sum(ms for n, ms in spans if "train_bn_" in n)
    device_ms = sum(ms for _, ms in spans)
    other_bn = sorted({n for n in names if ("batch_norm" in n or "bn_" in n)
                       and "train_bn_" not in n})
    require(ours == 6 * BN_LAYERS_CDRNET,
            f"train BN step: {ours} train_bn_ kernels in the profile")
    require(not other_bn, f"train BN step: other BN kernels {other_bn}")
    print(f"# train BN step: {launches[0]} + {launches[1]} launches, "
          f"{ours} train_bn_ kernels in the profile ({bn_ms:.2f} ms of "
          f"{device_ms:.2f} ms of kernel time), no other BN kernel")
    return {"launches": launches, "kernels": ours, "bn_ms": bn_ms,
            "device_ms": device_ms}


def time_serving(inf, dev):
    """predict_batch's wall at 1-64 pairs, its geometry graphed (the
    default: geometry/graphed.py) and eager (engagement patched off), the
    two answers bit for bit, the geometry's counts over the graphed calls,
    and the eager geometry alone."""
    from fast3dhpe_tpu_torch.geometry import graphed
    from fast3dhpe_tpu_torch.geometry.triangulation import (dlt_triangulate,
                                                            pinv_projection)
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.RandomState(SEED + 1)
    serving = {}
    for pairs in (1, 16, 32, 64):
        img_l, img_r, proj = stereo_request(rng, pairs)
        args = (torch.as_tensor(img_l, device=dev),
                torch.as_tensor(img_r, device=dev),
                torch.as_tensor(proj, device=dev))
        iters = 20 if pairs == 1 else 10
        before = dict(graphed.COUNTS)
        ms = host_ms(lambda: inf.predict_batch(*args), iters=iters)
        counts = {k: graphed.COUNTS[k] - before.get(k, 0)
                  for k in ("eager", "captures", "replays")}
        # host_ms's two warm-up calls run the geometry eagerly and capture
        # it (for a new batch size); every timed call replays both graphs
        require(counts["replays"] >= 2 * iters,
                f"predict_batch at {pairs} pairs: geometry counts {counts}")
        got = inf.predict_batch(*args)
        engages = graphed.engages
        graphed.engages = lambda capturable, tensors: False
        try:
            eager_ms = host_ms(lambda: inf.predict_batch(*args), iters=iters)
            want = inf.predict_batch(*args)
        finally:
            graphed.engages = engages
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"predict_batch at {pairs} pairs: the graphed geometry's "
                f"answer differs from the eager one")
        proj_t = args[2]
        kp = torch.rand((pairs, 19, 2, 2), device=dev) * 256

        def geometry():
            pinv_projection(proj_t)
            dlt_triangulate(proj_t[:, None].expand(pairs, 19, 2, 3, 4), kp)

        geo = host_ms(geometry, iters=10)
        serving[pairs] = {"ms": ms, "pairs_per_s": pairs / ms * 1e3,
                          "eager_geometry_ms": eager_ms,
                          "geometry_counts": counts, "geometry_ms": geo}
        print(f"# predict_batch batch {pairs}: {ms:.3f} ms, "
              f"{pairs / ms * 1e3:.1f} pairs/s, geometry graphed "
              f"({counts}); {eager_ms:.3f} ms with the geometry eager; pinv "
              f"+ Jacobi DLT alone eagerly {geo:.3f} ms "
              f"({100 * geo / eager_ms:.0f}% of that)")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"# peak device memory while serving {peak:.2f} GiB")
    return serving


CONV_KERNELS = ("xmma", "cutlass", "nvjet", "cudnn", "gemm", "conv")
KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel's name)
    ("K3 fused bottleneck", ("bottleneck_kernel",)),
    ("K1 soft-argmax", ("softargmax_fwd",)),
    ("cuDNN/cuBLAS conv and matmul", CONV_KERNELS),
    ("batch norm", ("batch_norm",)),
)


def profile_serving(inf, dev, pairs, wall_ms, calls=3):
    """Device time of predict_batch by kernel group (torch.profiler), and
    the device's idle share against the unprofiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    img_l, img_r, proj = stereo_request(np.random.RandomState(SEED), pairs)
    args = [torch.as_tensor(a, device=dev) for a in (img_l, img_r, proj)]
    inf.predict_batch(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            inf.predict_batch(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other (elementwise, copies, reductions)"] = 0.0
    launches = 0
    for e in kernels:
        ms = e.self_device_time_total / 1e3 / calls
        launches += e.count
        key = next((name for name, subs in KERNEL_GROUPS
                    if any(s in e.key for s in subs)),
                   "other (elementwise, copies, reductions)")
        groups[key] += ms
    busy = sum(groups.values())
    require(busy > 0, "the profiler recorded no device time")
    for name in ("K3 fused bottleneck", "K1 soft-argmax"):
        require(groups[name] > 0, f"no kernel of the group {name} in the "
                                  f"profile of predict_batch")
    print(f"# profile predict_batch batch {pairs}: device busy {busy:.3f} ms "
          f"of {wall_ms:.3f} ms wall (idle {100 * (1 - busy / wall_ms):.0f}%)"
          f", {launches // calls} kernel launches a call")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"#   {name}: {ms:.3f} ms ({100 * ms / busy:.0f}%)")
    return {"busy_ms": busy, "wall_ms": wall_ms,
            "launches": launches // calls, "groups": groups}


TRAIN_GROUPS = (  # (group, substrings of the CUDA kernel's name)
    ("K1 soft-argmax", ("softargmax_fwd",)),
    ("K2 soft-argmax backward", ("softargmax_bwd",)),
    ("cuDNN/cuBLAS conv and matmul", CONV_KERNELS),
    ("train BN kernels", ("train_bn_",)),
)
# CPU ranges whose kernels are train-mode BN: the forward, wrapped in a
# record_function range while profiling, and the backward node
BN_RANGES = ("train_bn", "MaskedBatchNormBackward")


def profile_train(train, wall_ms):
    """Device time of one use_3d train step by kernel group, and the
    device's idle share against the unprofiled median step. The train BN
    kernels are a group by name; the other kernels of train-mode BN (the
    running statistics' update) are told apart by the CPU range that
    launched them: each kernel is linked to the CPU op that launched it,
    and that op to the BN forward or backward range around it on the same
    thread."""
    import bisect
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from fast3dhpe_tpu_torch.models.layers import BatchNorm2d

    def traced(self, *args, **kwargs):
        with record_function("train_bn"):
            return bn_forward(self, *args, **kwargs)

    flops = []              # forward FLOPs of each convolution, from shapes

    def count(mod, args, out):
        if isinstance(mod, torch.nn.ConvTranspose2d):
            x = args[0]             # every input pixel meets every tap
            flops.append(2 * x.numel() * mod.out_channels
                         * mod.weight[0, 0].numel())
        else:
            flops.append(2 * out.numel() * mod.weight[0].numel())

    hooks = [m.register_forward_hook(count)
             for m in train["state"].model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    bn_forward = BatchNorm2d.forward
    BatchNorm2d.forward = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            train["step"](train["state"], train["batch"], True)
            torch.cuda.synchronize()
    finally:
        BatchNorm2d.forward = bn_forward
        for h in hooks:
            h.remove()
    # the backward takes the weight gradient and, for every convolution but
    # the first (whose input is the images), the input gradient
    conv_flop = 3 * sum(flops) - flops[0]

    def group(name):
        return next((g for g, subs in TRAIN_GROUPS
                     if any(s in name for s in subs)), None)

    events = prof.events()
    groups = {g: 0.0 for g, _ in TRAIN_GROUPS}
    rest, launches = 0.0, 0
    for e in events:
        # a record_function range also shows on the device's timeline
        if (e.device_type == DeviceType.CUDA and e.name not in BN_RANGES
                and not getattr(e, "is_user_annotation", False)):
            ms = (e.time_range.end - e.time_range.start) / 1e3
            launches += 1
            g = group(e.name)
            if g is None:
                rest += ms
            else:
                groups[g] += ms
    ranges = {}
    for e in events:
        if e.device_type == DeviceType.CPU and any(r in e.name
                                                   for r in BN_RANGES):
            ranges.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end))
    for thread, spans in ranges.items():     # the union of nested ranges
        merged = []
        for a, b in sorted(spans):
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        ranges[thread] = merged
    bn = linked = 0.0
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        spans = ranges.get(e.thread, [])
        i = bisect.bisect_right(spans, (e.time_range.start, float("inf")))
        in_bn = i > 0 and spans[i - 1][1] >= e.time_range.end
        for k in e.kernels:
            linked += k.duration / 1e3
            if in_bn and group(k.name) is None:
                bn += k.duration / 1e3
    groups["train-mode BN, other kernels (running statistics)"] = bn
    groups["other (elementwise, copies, reductions, geometry)"] = rest - bn
    busy = sum(groups.values())
    require(busy > 0, "the profiler recorded no device time")
    for name in ("K1 soft-argmax", "K2 soft-argmax backward",
                 "train BN kernels"):
        require(groups[name] > 0, f"no kernel of the group {name} in the "
                                  f"profile of a train step")
    print(f"# profile train step ({TRAIN_PAIRS} pairs, use_3d): device busy "
          f"{busy:.3f} ms of {wall_ms:.3f} ms wall (idle "
          f"{100 * (1 - busy / wall_ms):.0f}%), {launches} kernel launches; "
          f"{100 * linked / busy:.0f}% of device time linked to a CPU op")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"#   {name}: {ms:.3f} ms ({100 * ms / busy:.0f}%)")
    conv_ms = groups["cuDNN/cuBLAS conv and matmul"]
    print(f"# train step convolutions: {conv_flop / 1e12:.3f} TFLOP forward "
          f"and backward, {conv_flop / conv_ms / 1e9:.1f} TFLOP/s in the "
          f"cuDNN/cuBLAS group (fp32 peak {FP32_FLOPS / 1e12:.0f})")
    return {"busy_ms": busy, "wall_ms": wall_ms, "launches": launches,
            "linked_ms": linked, "groups": groups,
            "conv_tflop": conv_flop / 1e12}


def kernel_lines(errs, times, paths):
    """The {"kernels": [...]} entries of K1, K2 and K3: each kernel's
    error against its plain version (step 2), its timings (step 4) and its
    launches by path, {path: {counter: launches}}, summed."""
    meta = (("soft_argmax_fwd", "fast3dhpe_tpu_torch/csrc/softargmax.cu",
             "fast3dhpe_tpu/ops/pallas_softargmax.py:64", "soft_argmax", {}),
            ("soft_argmax_bwd", "fast3dhpe_tpu_torch/csrc/softargmax.cu",
             "fast3dhpe_tpu/ops/pallas_softargmax.py:79", "soft_argmax_bwd",
             {}),
            ("fused_bottleneck",
             "fast3dhpe_tpu_torch/csrc/fused_bottleneck.cu",
             "fast3dhpe_tpu/ops/pallas_bottleneck.py:191",
             "fused_bottleneck",
             {"shape": f"one forward's launches at {2 * TIMING_PAIRS} "
                       f"images: layer1.0 + 3 x layer2.x"}))
    out = []
    for (name, source, replaces, key, extra), err, t in zip(meta, errs,
                                                            times):
        by_path = {p: n[key] for p, n in paths.items()}
        out.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces, max_abs_err=err, **extra,
                        launches=sum(by_path.values()),
                        launches_by_path=by_path, **t))
    return out


def main():
    args = sys.argv[1:]
    # the processes that slice 7 starts (not in the usage text)
    if args[:1] == ["--dp-child"]:
        rank, world, port, cfg_path, shared, own, out = args[1:]
        return dp_child(int(rank), int(world), int(port), cfg_path, shared,
                        own, out)
    if args[:1] == ["--nccl-probe"]:
        return nccl_probe_child(int(args[1]), int(args[2]))
    if args[:1] == ["--s8-child"]:
        rank, world, port, work = args[1:]
        return s8_child(int(rank), int(world), int(port), work)
    if args[:1] == ["--s9-child"]:
        rank, world, port, cfg_path, root, out, device = args[1:]
        return s9_child(int(rank), int(world), int(port), cfg_path, root,
                        out, device)
    if args[:1] == ["--s10-child"]:
        rank, world, port, work, launch = args[1:]
        return s10_child(int(rank), int(world), int(port), work, launch)
    if args[:1] == ["--s17-child"]:
        rank, world, port, cfg_path, roots, out = args[1:]
        return s17_child(int(rank), int(world), int(port), cfg_path, roots,
                         out)
    if args not in ([], ["--kernels"], ["--slice6"], ["--slice7"],
                    ["--slice8"], ["--slice9"], ["--slice10"],
                    ["--slice11"], ["--slice12"], ["--phase17"],
                    ["--train-bn"]):
        sys.exit("usage: python3 chip_smoke.py [--kernels | --slice6 | "
                 "--slice7 | --slice8 | --slice9 | --slice10 | --slice11 | "
                 "--slice12 | --phase17 | --train-bn]")
    kernels_only = args == ["--kernels"]
    many = args in (["--slice10"], ["--slice12"])
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs a CUDA device")
    if many and torch.cuda.device_count() < S10_CARDS:
        sys.exit(f"chip_smoke {args[0]}: it needs {S10_CARDS} CUDA devices, "
                 f"one NCCL rank a card (NCCL refuses two ranks on one "
                 f"card); this host has {torch.cuda.device_count()}: "
                 + "; ".join(torch.cuda.get_device_name(i) for i in
                             range(torch.cuda.device_count())))
    check_apis()
    from fast3dhpe_tpu_torch.config import load_config
    from fast3dhpe_tpu_torch.ops._build import build

    t_start = time.perf_counter()
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    smi = cards[0]
    if many:
        smi = "; ".join(cards)
    print("\n".join(cards if many else cards[:1]))
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    # fp32 references and the fp32 train step run in full fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    logs = build(["fused_bottleneck", "softargmax", "batchnorm"])
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"# nvcc {name}: {line.strip()}")
    print(f"# build: nvcc {time.perf_counter() - t0:.1f} s")

    phases = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t
        return out

    gen = torch.Generator().manual_seed(SEED)
    bn_errs = phase("train BN check", check_train_bn, dev, gen)
    if args == ["--train-bn"]:
        bn_times = phase("train BN timing", time_train_bn, dev, gen)
        bn_step = phase("train BN step", train_bn_step,
                        load_config("configs/mads_3d.yaml"), dev)
        print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
        print(json.dumps({"train_bn": {"errors": bn_errs, "step": bn_step,
                                       "times": bn_times, "card": smi}}))
        return
    err_k1 = phase("K1 check", check_softargmax, dev, gen)
    err_k2 = phase("K2 check", check_softargmax_bwd, dev, gen)
    err_k3 = phase("K3 check", check_bottleneck, dev, gen)

    if kernels_only:
        times = {"K1": phase("K1 timing", time_softargmax, dev, gen),
                 "K2": phase("K2 timing", time_softargmax_bwd, dev, gen),
                 "K3": phase("K3 timing", time_bottleneck, dev, gen)}
        print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
        print(json.dumps({"kernel_times": times,
                          "train_bn_worst": bn_worst(bn_errs)}))
        return
    if args == ["--slice12"]:
        k1 = phase("K1 timing", time_softargmax, dev, gen)
        k2 = phase("K2 timing", time_softargmax_bwd, dev, gen)
        k3 = phase("K3 timing", time_bottleneck, dev, gen)
        s12 = phase("slice 12 across cards", run_slice12, dev, smi)
        print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
        print(f"# total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"slice12": s12}))
        print(json.dumps({"kernels": kernel_lines(
            (err_k1, err_k2, err_k3), (k1, k2, k3),
            {f"slice 12, {k}": n for k, n in s12["launches"].items()})}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if args == ["--phase17"]:
        s12 = phase("slice 12, one card", run_slice12_card, dev, smi)
        print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
        print(f"# total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"slice12": s12}))
        return

    cfg = load_config("configs/mads_3d.yaml")
    inf, serve_launches, cpu_inf = phase("serving path", run_path, cfg, dev)
    if args == ["--slice6"]:
        start_sd = phase("training path", run_train, cfg, dev)["start_sd"]
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            mads, _, _ = phase("trees", write_trees, tmp)
            s6 = phase("slice 6", run_slice6, inf, cfg, start_sd, mads, dev,
                       smi)
        print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
        print(json.dumps({"slice6": s6}))
        return
    if args == ["--slice7"]:
        s7 = phase("slice 7", run_slice7, cfg, dev, smi)
        print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
        print(json.dumps({"slice7": s7}))
        return
    if args == ["--slice8"]:
        s8 = phase("slice 8", run_slice8, inf, cfg, dev, smi)
        print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
        print(json.dumps({"slice8": s8}))
        return
    if args == ["--slice9"]:
        del inf, cpu_inf
        torch.cuda.empty_cache()
        s9 = phase("slice 9", run_slice9, dev, smi)
        print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
        print(json.dumps({"slice9": s9}))
        return
    if args == ["--slice11"]:
        del inf, cpu_inf
        torch.cuda.empty_cache()
        s11 = phase("slice 11", run_slice11, dev, smi)
        print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
        print(f"# total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"slice11": s11}))
        return
    if args == ["--slice10"]:
        del cpu_inf
        torch.cuda.empty_cache()
        s10 = phase("slice 10", run_slice10, inf, cfg, dev, smi)
        print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in phases.items()))
        print(f"# total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"slice10": s10}))
        return
    k1 = phase("K1 timing", time_softargmax, dev, gen)
    k2 = phase("K2 timing", time_softargmax_bwd, dev, gen)
    k3 = phase("K3 timing", time_bottleneck, dev, gen)
    serving = phase("serving timing", time_serving, inf, dev)
    prof = phase("serving profile", profile_serving, inf, dev, TIMING_PAIRS,
                 serving[TIMING_PAIRS]["ms"])

    train = phase("training path", run_train, cfg, dev)
    train_launches, train_summary = train["launches"], train["summary"]
    train_prof = phase("train profile", profile_train, train,
                       train["summary"]["step_ms"])
    start_sd = train["start_sd"]
    del train
    torch.cuda.empty_cache()

    cache, cache_info = phase("frame cache", build_cache, dev)
    pipe_checks = phase("pipeline checks", check_pipeline, cache, cfg, dev)
    pipe = phase("pipeline training", run_pipeline_train, cfg, dev, cache,
                 train_summary["step_ms"])
    raw = phase("raw serving", run_raw_serving, inf, cpu_inf.model, cache,
                cfg, dev)
    del cache
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        mads, mpii, trees = phase("trees", write_trees, tmp)
        loader_train = phase("loader training", run_loader_train, mads, dev)
        torch.cuda.empty_cache()
        loader_2d = phase("2D loaders", run_loader_2d, mads, mpii, dev)
        torch.cuda.empty_cache()
        movement = phase("movement eval", run_movement_eval, inf, cpu_inf,
                         mads, cfg, dev)
        torch.cuda.empty_cache()
        apps = phase("apps", run_apps, mads, dev, smi)
        torch.cuda.empty_cache()
        s6 = phase("slice 6", run_slice6, inf, cfg, start_sd, mads, dev, smi)
    s8 = phase("slice 8", run_slice8, inf, cfg, dev, smi)
    del inf, cpu_inf
    torch.cuda.empty_cache()
    vs_cpu = phase("train card vs CPU", train_vs_cpu, cfg, start_sd, dev)
    torch.cuda.empty_cache()
    s7 = phase("slice 7", run_slice7, cfg, dev, smi)
    torch.cuda.empty_cache()
    s9 = phase("slice 9", run_slice9, dev, smi)
    torch.cuda.empty_cache()
    s11 = phase("slice 11", run_slice11, dev, smi)
    torch.cuda.empty_cache()
    s12 = phase("slice 12, one card", run_slice12_card, dev, smi)

    def launch_counts(key):
        by_path = {"serving": serve_launches[key],
                   "training": train_launches[key],
                   "pipeline training": pipe["launches"][key],
                   "raw serving": raw["launches"][key],
                   "loader training, full cache":
                       loader_train["full"]["launches"][key],
                   "loader training, partial cache":
                       loader_train["partial"]["launches"][key],
                   "2D loaders": loader_2d["launches"][key]}
        by_path.update({f"movement eval, {mode}": n[key]
                        for mode, n in movement["launches"].items()})
        by_path.update({f"{app} app": apps[app]["launches"][key]
                        for app in ("train", "train_cdr", "inference",
                                    "baseline")})
        by_path.update({f"slice 6, {k}": n[key]
                        for k, n in s6["launches"].items()})
        by_path.update({f"slice 7, {k}": n[key]
                        for k, n in s7["launches"].items()})
        by_path["slice 8, unsplit"] = s8["unsplit_launches"][key]
        by_path.update({f"slice 8, {w} rank {r}": n[key]
                        for w in ("M=2", "M=4")
                        for r, n in enumerate(s8[w]["launches"])})
        by_path.update({f"slice 9, 1 x {S9_M} rank {r}": n[key]
                        for r, n in enumerate(s9["launches_by_rank"])})
        by_path["slice 9, 1 process"] = s9["one_process_launches"][key]
        by_path.update({f"slice 11, {k}": n[key]
                        for k, n in s11["launches"].items()})
        return by_path

    paths = {}
    for key in ("soft_argmax", "soft_argmax_bwd", "fused_bottleneck"):
        for path, n in launch_counts(key).items():
            paths.setdefault(path, {})[key] = n
    paths.update({f"slice 12, {k}": n for k, n in s12["launches"].items()})
    kernels = kernel_lines((err_k1, err_k2, err_k3), (k1, k2, k3), paths)
    print(json.dumps({"serving": {str(k): v for k, v in serving.items()},
                      "profile": prof}))
    print(json.dumps({"train": train_summary, "train_profile": train_prof,
                      "train_vs_cpu": vs_cpu,
                      "train_bn_worst": bn_worst(bn_errs)}))
    print(json.dumps({"cache": cache_info, "pipeline_checks": pipe_checks,
                      "pipeline_training": pipe,
                      "raw_serving": {k: v for k, v in raw.items()
                                      if k != "launches"}}))
    print(json.dumps({"host_data": {
        "trees": trees, "loader_training": loader_train,
        "loaders_2d": loader_2d, "movement_eval": movement}}))
    print(json.dumps({"apps": apps}))
    print(json.dumps({"slice6": s6}))
    print(json.dumps({"slice7": s7}))
    print(json.dumps({"slice8": s8}))
    print(json.dumps({"slice9": s9}))
    print(json.dumps({"slice11": s11}))
    print(json.dumps({"slice12": s12}))
    print("# phases (s): " + ", ".join(f"{k} {v:.1f}"
                                       for k, v in phases.items()))
    print(f"# total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
