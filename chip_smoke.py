#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py        # from the repository root; needs one card
    python3 chip_smoke.py retinanet nms   # only the phases whose names start
                                 # so; prints no result line and exits 3
    python3 chip_smoke.py rcnn   # the Faster R-CNN phases
    python3 chip_smoke.py reppoints   # the RepPoints and DCN phases
    python3 chip_smoke.py ddp    # the data-parallel phase
    python3 chip_smoke.py proposal syncbn   # the proposal networks and SyncBN
    python3 chip_smoke.py fcosv3 # FCOSV3 and the masks data path
    python3 chip_smoke.py rotated_retinanet rotated_rcnn   # the rotated boxes
    python3 chip_smoke.py cornernet   # CornerNet and the corner-pool kernel
    python3 chip_smoke.py serving int8 tta   # the serving path
    python3 chip_smoke.py pvt vt_fpn   # the PVT, PVTv2 and VT-FPN trunks
    python3 chip_smoke.py full_size tools   # FCOS against JAX at full size; the tools
    python3 chip_smoke.py convergence   # FCOS R-50-FPN trained by convergence_run
    python3 chip_smoke.py profiles   # the staged profile tools

Builds the port's CUDA kernels from ``slenderobjdet_torch/ops/csrc`` (at
first use, into ``build/torch_kernels/``), then, each phase failing the run
if it fails:

1. NMS kernel vs its plain version at N=5000, max_out 100, thr 0.6,
   integer-pixel boxes, on a sparse and a dense set (B=8 and 32), a set of
   tied scores, a ragged one (B=3, N=4321, 30% valid) and without classes:
   indices and validity must be identical. The kernel alone and the whole
   call are timed on the sparse and dense sets, with the block-wide rounds
   an image took.
2. Fused stem kernels vs ``reference_stem`` at (8, 800, 1344, 3): max abs
   error / max abs value <= 1e-4 in fp32 (CUDA cores), <= 3e-2 in bf16
   (tensor cores); the bf16 kernel again at B=32, at the ragged (2, 36, 52,
   3) and at 16 channels (which the plan sends to the CUDA cores); the
   tensor-core kernel timed in turns with the CUDA-core one and the bf16
   cuDNN stem at B=8 and 32; its SASS must hold tensor-core instructions.
   The same checks at the data loader's two padded shapes, (B, 896, 1408, 3)
   and (B, 1408, 896, 3): B=2 in both types, and in bf16 the test loader's
   B=8 and the trainer's B=16, each also timed.
3. Fused bottleneck kernels vs ``reference_bottleneck`` at the five
   distinct stride-1 block shapes of R-50 at 800x1344, B=8, same
   tolerances; then each shape's time at B=8 and B=32 (the whole
   ``fused_bottleneck`` call, weight re-layout included) beside the plain
   version and the bf16 cuDNN block, with TFLOP/s; and a ``cuobjdump
   -sass`` check that the model's wgmma kernels hold HGMMA and bulk copies.
   The five shapes that follow from the loader's 896x1408 and 1408x896 are
   checked at B=2 in both types and, in bf16, at the test loader's B=8 and
   the trainer's B=16 (the kernel tiles the flattened B*H*W pixels), and
   timed there beside the cuDNN block.
4. The predict path: ``build_model`` on configs/fcos/fcos_R_50_FPN_1x.yaml
   with FUSED_STEM and FUSED_BLOCKS on, bf16, seeded random weights,
   answering 3 requests of 8 uint8 800x1344 images. Launch counts are reset
   just before and read just after; its three kernels must have run. The
   outputs are checked for shape and finiteness and against the same
   weights with the flags off (the cuDNN path).
5. Timings with CUDA events after warm-up: each kernel against its plain
   version at the main-path shapes, and predict img/s at B=8 and B=32 with
   the fused flags on and off.
6. The probe tools: every variant of the fused-kernel probe against its
   plain version at res2_1, res4_1 and res5_1 (B=8; ``full`` bit-exact with
   ``fused_bottleneck``, the others within 3e-2), the DMA-streams tokens
   (relative 1e-5) and the copies (bit-exact at th 1, 7, 32, 200), the DMA
   probe timed beside a plain full read of its input and the copy beside
   ``x * 0.5`` at th 4, 32, 200 for B=8 and 32; then the three tools'
   ``main`` at B=8 with the launch counts reset before and read after.
7. The train step at full width (800x1344, bf16, FUSED_STEM/FUSED_BLOCKS
   on): one step's gradients of a res3, res4, res5 and head weight from the
   fused bf16 model must be non-zero and no further from an fp32 model's
   than 1.5 x the unfused bf16 model's (B=2); 11 steps on one batch of
   SOLVER.IMS_PER_BATCH (16) images with WARMUP_ITERS 0 must launch both
   fused kernels, keep every loss finite and end below step 0's total;
   train img/s with the flags on and off and the peak device memory.
8. The normal entry point: ``train_net_torch.main`` on
   configs/fcos/fcos_R_50_FPN_1x.yaml, nothing cut, on a synthetic dataset
   of 32 inlined 800x1333 and 1333x800 images (3-20 integer-pixel boxes
   each, from a numpy seed; only the COCO json the evaluator reads is
   written, to a temporary directory; the test set is the same images four
   times over, 128, so that 11 test batches are timed), 8 iterations with a
   checkpoint every 4, the fused flags on, bf16. Batches must be (16, 896, 1408, 3) or (16,
   1408, 896, 3) uint8 with 100 padded gt; every step must launch 1 stem
   and 13 bottleneck kernels and every test batch 1 NMS; the logged losses
   must be finite and the outputs (metrics.json, config.yaml, both
   checkpoints, last_checkpoint) exist. A second ``main`` with ``--resume``
   must start at iteration 8 with exactly the saved state and take 20 more
   steps, none of which saves, whose first loss, on the first run's first
   batch, is at most 1.02 x that run's step-0 loss; a third with ``--eval-only`` must return every
   name of ``STATS_NAMES`` and the AR matrix keys. ``COCOEvaluator`` is also
   fed jittered ground truth and must report an AP above 50; the line says
   whether the C matcher or the numpy path ran. Prints train img/s through
   the trainer, over the 6 steps around a save and over 18 steps without
   one, beside the bare step's, the share of a step spent waiting
   for the loader, eval img/s and the peak memory.

9. RetinaNet R-50-FPN (configs/retina/retinanet_R_50_FPN_1x.yaml, nothing
   cut, FUSED_STEM and FUSED_BLOCKS on, bf16, seeded weights, FrozenBN away
   from identity) at the loader's 896x1408, the second family's main path:
   its head's logits and deltas no further from an fp32 model's than 1.5 x
   the unfused bf16 model's; the classifier's bias moved so that the
   coarsest level's 99.5th percentile score sits on SCORE_THRESH_TEST; the
   NMS kernel against ``batched_nms`` on the model's own candidates (B=8,
   N=5000, thr 0.5, the mask the threshold gives): identical, and timed
   beside its bound; 3 requests of 8 images, each launching exactly 1 stem,
   13 bottleneck wrappers and 1 NMS, outputs of the right shapes, finite,
   holding valid detections, and matched by the same weights with the
   flags off (``comparable_retinanet``, ``match_detections``: >= 0.99 of
   the slots paired by class within a score of 2e-2); device time of
   backbone, head and postprocess; predict img/s at B=8 and 32, flags on
   and off.
10. The RetinaNet train step at full width: 11 steps on one batch of 16
   images at 896x1408 with 100 padded gt, WARMUP_ITERS 0 and BASE_LR 2e-4
   (the YAML's 0.01 without warm-up gives NaN by step 2 on random weights),
   flags on: both fused kernels launch, every loss is finite, the last
   total is below step 0's; train img/s and peak memory with the flags on
   and off.
11. ``train_net_torch.main`` on the RetinaNet YAML over the synthetic
   dataset: 4 iterations with a checkpoint every 2 and the evaluation, every
   step launching 1 stem and 13 bottleneck kernels on (16, 896, 1408, 3) or
   (16, 1408, 896, 3) batches with 100 padded gt and every test batch 1
   NMS; ``--resume`` to iteration 8 from exactly the saved state;
   ``--eval-only`` with every name of ``STATS_NAMES``; eval img/s.
12. Faster R-CNN R-50-FPN (configs/faster/faster_rcnn_R_50_FPN_1x.yaml,
   nothing cut, bf16, flags on and off, seeded weights shaped by
   ``randomize_rcnn``) at 896x1408: RPN outputs and ROI features against
   fp32; the NMS kernel against ``batched_nms`` on the model's own
   candidates, identical, at the RPN's predict shape (B=8, 4,924 -> 1,000),
   its train shape (B=16, 8,924 -> 1,000; rows of one level) and the box
   head's (B=8, 1,000 in 80 classes -> 100), each timed with its rounds and
   bound; 3 requests of 8 images with exactly 1 stem, 13 bottleneck and 2
   NMS launches each; fused against unfused detections on shared proposals
   (``comparable_rcnn``, ``match_on_shared_proposals``: >= 0.99 of the
   slots matched or swapped at the cut with their unfused candidate); device
   ms of each part; predict img/s at B=8 and 32.
13. The Faster R-CNN train step: 11 steps at B=16 with 100 padded gt,
   BASE_LR RCNN_TRAIN_LR, each launching exactly 1 stem, 13 bottleneck and
   1 NMS (flags off: the NMS), finite losses ending below step 0's, img/s
   and peak memory flags on and off; the pooler's forward and backward ms.
14. ``train_net_torch.main`` on the Faster R-CNN YAML (``family_trainer``):
   every step 1 stem, 13 bottleneck and 1 NMS, every test batch 2 NMS;
   ``--resume`` bit-equal; ``--eval-only``.
15. RepPointsDetector R-50-FPN
   (configs/rep-points/rep_points_detector_R_50_FPN_1x.yaml, nothing cut,
   bf16, flags on and off, seeded weights, FrozenBN away from identity) at
   896x1408: head logits and init and refine offsets against fp32; the NMS
   kernel against ``batched_nms`` on the model's own 5,000 candidates (B=8,
   thr 0.5), identical, timed with its rounds and bound; 3 requests of 8
   images with exactly 1 stem, 13 bottleneck and 1 NMS launch each; fused
   against unfused detections by (class, box) on fixed point sets
   (``comparable_reppoints``, ``match_on_shared_proposals``: >= 0.99 of the
   slots matched or swapped at the other's cut, the count stated); device
   ms of backbone + FPN, towers, offsets_init, the deform sampling, the
   deform matmuls, the 1x1 outputs and the postprocess; the deform op alone
   at the P3 gather (B=8, 112x176, K 9, 2C 512): bf16 forward and backward
   within 3e-2 of fp32, ``F.grid_sample`` of the same samples within 1e-4
   in fp32 and timed, ``DFConv2d`` at zero offsets within 1e-4 of the cuDNN
   conv (v1) and half of it (v2) in fp32, with a random ``offset_conv``
   within 3e-2 in bf16; predict img/s at B=8 and 32.
16. The RepPoints train step: 11 steps at B=16 with 100 padded gt, BASE_LR
   REPPOINTS_TRAIN_LR and the classifier shaped, each fused step launching
   exactly 1 stem and 13 bottleneck kernels, finite losses ending below
   step 0's, the EMA loss normaliser moved off 20; img/s and peak memory.
17. ``train_net_torch.main`` on the RepPoints YAML (``family_trainer``):
   the normaliser in the checkpoint, ``--resume`` bit-equal, evaluation.
18. The six other point-set and DCN names (REPPOINTS_VARIANTS) built at
   full width: one predict and one train step at B=2, exact launch counts
   (3 bottleneck wrappers with res3-res5 deformable), finite outputs.
19-23. The ablation chassis (``ablation_*`` phases; see ``phase_ablation``).
24. Data parallel (``ddp``), through ``slenderobjdet_torch.parallel.launch``:
   ``train_net_torch.main`` on the FCOS YAML (DDP_ITERS iterations, flags
   on, bf16, the synthetic set, threshold 0) in a spawned process under
   NCCL at world size 1 must end bit-equal to the same run here without a
   group, each step launching 1 stem and 13 bottleneck kernels and each
   test batch 1 NMS; then two gloo ranks sharing the card: one fp32 step
   (flags off) of 8 + 8 rows, with 1 valid box an image in one half and 30
   in the other, within DDP_FP32_RTOL of the single process's B=16 step,
   bit-equal across the ranks and reporting the joined batch's positives, DDP_BF16_STEPS bf16 steps with
   finite losses, 1 + 13 launches a step on each rank and parameters
   bit-equal across the ranks, a gloo all-reduce of the fp32 gradients'
   size timed alone, and ``--eval-only`` of the NCCL run's checkpoint:
   rank 0's AP within DDP_AP_TOL of the one-process evaluation's and every
   one of its detections identical to that run's, rank 1 ``{}``, 1 + 13 + 1 launches a test
   batch on each rank. Prints step times, the all-reduce's share and the
   peak memory a rank ("two ranks sharing one card": not a scaling figure).

25-28. The proposal networks (``proposal_*`` phases), the flagship yaml with
   ``MODEL.META_ARCHITECTURE ProposalNetwork``, ``MODEL.RPN.IN_FEATURES``
   P3-P7 and each of the three generators (``RepPointsGenerator``, its head's
   trainable BatchNorms shared by five levels; ``PointsProposalGenerator``;
   ``ProposalNetworkWithMasks``): ``proposal_build`` at full width, seeded,
   with parameter counts; ``proposal``: head outputs in bf16 against fp32,
   the NMS kernel against ``batched_nms`` on each generator's own 3,385
   candidates an image (B=8, class-agnostic, its thr, 100 slots), exactly
   1 stem + 13 bottleneck + 1 NMS a predict call at B=8 and 32, device ms of
   trunk, head and postprocess, predict img/s; ``proposal_train``: 11 RPG
   steps at B=16 with 100 padded gt (loss falling, running statistics
   moving), one step of each other generator, and a SyncBN trunk's step and
   predict with 0 stem and 0 bottleneck launches; ``proposal_trainer``:
   ``main`` (train, ``--resume`` bit-equal with the BatchNorm statistics,
   ``--eval-only``), then ``TEST.PRECISE_BN`` through the trainer's ``test``
   and the next checkpoint.
29. SyncBN (``syncbn``): the RPG with a SyncBN trunk under NCCL at world
   size 1 bit-equal to no group; two gloo ranks sharing the card, 8 rows
   each of a joined 16, one fp32 step against the single process's
   (DDP_FP32_RTOL / DDP_UPDATE_RTOL plus SYNCBN_NOISE_FACTOR x each tensor's
   own difference under a reordering of the joined batch), bit-equal across
   the ranks; the
   all-reduces' ms and share of a step.
30. FCOSV3 and the masks data path (``fcosv3``,
   configs/fcos/fcosv3_R_50_FPN_1x.yaml, NEED_MASKS): the C border renderer
   must have built (``structures/native.py``) and agree with numpy on 16
   images of 800x1333 / 1333x800 with 8-30 polygon instances each (host ms
   an image for the centre map and ProposalNetworkWithMasks' three maps,
   both renderers); the train step at B=16, 896x1408, 100 padded gt and a
   rendered centre map, flags on and off: 0 < num_pos <= FCOS's on the batch,
   the loss falls over 11 steps, each fused step 1 stem + 13 bottleneck
   launches, img/s and peak memory beside FCOS's on the same batch, the
   centre map's host-to-device copy; predict at B=8 with 1 + 13 + 1
   launches and the NMS kernel identical to ``batched_nms`` on the model's
   own candidates; ``main`` (``family_trainer`` on synthetic dicts with
   polygons: train, ``--resume`` bit-equal, evaluate) and 10 iterations of
   ``main`` on the FCOS and the FCOSV3 yaml for img/s and the loader-wait
   share; one ProposalNetworkWithMasks step at B=16 on mapper-made maps
   (peak memory); a sizes pack written by ``tools/coco_to_pack --sizes`` and
   read back through the mapper within the JAX test's tolerances.

31. The rotated boxes (``rotated_*`` phases; ``ops/csrc/rotated.cu``):
   RotatedRetinaNet (configs/rotated/rotated_retinanet_R_50_FPN_1x.yaml,
   27 anchors a cell, 708,939 at 896x1408) and the rotated Faster R-CNN
   (configs/rotated/faster_rcnn_rotated_R_50_FPN_1x.yaml: RRPN over 945,252
   anchors, RROIHeads), nothing cut, bf16, flags on and off, seeded. Each:
   head outputs against fp32; the corner kernel bit for bit against
   ``rotated_to_corners``; the ``rotated_iou`` kernel at its train shapes
   (100 padded gt x all anchors; the ROI sampling's 100 x 1,100) bit for
   bit against the plain IoU (``torch.equal``); the ``rotated_nms``
   kernels on the model's own offset candidates (RotatedRetinaNet B=8
   5,000 -> 100 at both buckets; the RRPN's B=8 5,000 and B=16 10,000 ->
   1,000; the box head's B=8 1,000 -> 100) identical to the plain loop;
   the kernels alone (queued) and the wrapper calls timed, the NMS's by
   kernel from the profiler, the bounds reckoned here from the inputs
   (``iou_bound``; for NMS the pairs greedy NMS needs, ``greedy_pairs``);
   3 predict calls of B=8 at 896x1408 and 3 at 1408x896 with exact
   launches (1 + 13 + 1 rotated NMS; R-CNN 2),
   outputs (B, 100, 5) finite, fused against unfused detections class by
   class (``comparable_retinanet``; R-CNN on shared proposals); 11 + 4
   train steps at B=16 with 100 padded rotated gt, flags on and off, every
   step's launches exact (16 rotated IoU an image batch; R-CNN 32 and 1
   rotated NMS), the loss falling, img/s and peak memory; and
   ``train_net_torch.main`` on an rcoco dataset of 32 synthetic images
   whose quadrilateral polygons give the rboxes (``rbox_from_polygon``,
   without cv2): train, ``--resume`` bit-equal, evaluation and
   ``--eval-only`` by the rotated evaluator (SCORE_THRESH_TEST 0; the
   R-CNN's -1, its random softmax being 0 for every class).

32. CornerNet (``cornernet*`` phases; configs/corner/corner_net_hourglass.yaml:
   Hourglass-104, 2 stacks, trainable BN, FrozenBN heads, nothing cut,
   bf16, seeded, ``shape_cornernet``): the corner-pool kernel
   (``ops/csrc/corner_pool.cu``) at the heads' shapes, (8, 128, H/4, W/4)
   for both buckets, bf16 and fp32, both corners: forward bit for bit
   against the ``torch.cummax`` composition, backward against its fp32
   autograd (fp32 within 1e-4; bf16 within one bf16 rounding of every
   value), both timed beside their bounds, the wrapper calls beside their
   kernels alone; the NMS kernel on the model's
   own 400 pair candidates an image; 3 predict calls of B=8 a bucket with
   exactly 2 corner pools and 1 NMS each, equal bit for bit to the same
   weights on the plain corner pool; predict ms and img/s and the device
   ms of trunk, heads, corner pools and postprocess. ``cornernet_train``:
   one step's gradients (kernel bf16 within 1.5 x the plain-pool bf16
   model's distance from fp32); at B=2 in fp32, ``TPU.REMAT_BACKBONE`` on
   against off from the same weights (loss and running statistics bit
   for bit, gradients within 5e-4 / 1e-4); then the step without remat at
   the largest of B = 8, 4, 2 that fits (11 steps) and with remat at the
   largest of B = 16, 8, 4, 2 (4 steps), the loss falling and 4 + 4
   corner pools read in every step, the warm-up's included; img/s and
   peak memory; the first step's 8 corner-pool wrapper calls must copy no
   input (channels last, g in the inputs' dtype: ``pool_inputs_recorded``).
   ``cornernet_trainer``:
   ``train_net_torch.main`` with remat at that batch: train, ``--resume``
   bit-equal (BN statistics and ADAM moments), evaluate, ``--eval-only``.

33. Serving (``serving``; ``slenderobjdet_torch/serving.py``): the export
   tool's path (``tools/export_serving.py``) on the flagship, bf16, flags
   on, seeded weights made comparable (``one_detection_per_class``), at B=8,
   896x1408: ``torch.export`` of predict with the kernels as registered
   operators, reloaded, outputs bit-equal to the live model's and the same
   launches (1 NMS, 1 stem, 13 bottleneck wrappers); export seconds, the
   artifact's and the live model's predict ms (CUDA events, in turns); the
   host cost of an operator call against a direct call of its wrapper, and
   the live predict through the operators against the kernels called
   directly (as before the operators), ten turns each; the
   weight-only int8 artifact (``--quantize``) held to the live float model
   class by class within the tool's ``--verify`` tolerances; a CornerNet
   artifact at B=2 (reload bit-equal, 2 corner pools and 1 NMS launched)
   and the rotated IoU and NMS operators in a program of their own.
34. Int8 predict (``int8``; ``ops/quant.py``): FCOS predict under
   ``TPU.INT8_PREDICT``, dynamic and static (the 58 scales of
   configs/int8_scales/fcos_R_50_bench.json), against bf16 at B=8 and 32,
   896x1408, flags on and off: the convs taken over, img/s, and the
   scores' largest difference from bf16 on detections matched by class.
35. Test-time augmentation (``tta``; ``engine/tta.py``):
   ``train_net_torch.main --eval-only`` with ``TEST.AUG.ENABLED``
   (MIN_SIZES 640 and 800, FLIP) on 8 synthetic images: four views an image
   with 1 + 13 + 1 launches each, a finite AP, ms an image.

36. PVT, PVTv2 and VT-FPN (``pvt``, ``pvt_train``, ``pvt_trainer``,
   ``vt_fpn``), RetinaNet R-50's yaml with the backbone overridden, bf16,
   seeded weights, full widths: ``pvt`` builds PVT-Small and PVTv2 (B2's
   depths) and, at both buckets, B = 8: head outputs against an fp32 copy
   (<= HEAD_TOL), the NMS kernel on the model's own 5,000 candidates
   against ``batched_nms`` (exactly), then ``comparable_retinanet`` and 2
   requests each launching exactly 1 NMS (no stem, no bottleneck),
   detections matched against the fp32 copy (>= MATCH_MIN of the slots);
   predict ms, img/s and peak memory; device ms of trunk, FPN, head and
   postprocess and the SR attention calls' share of the trunk.
   ``pvt_train``: PVT-Small's step at the largest of PVT_BATCHES that fits,
   PVT_STEPS steps launching nothing, the loss falling, img/s, peak memory
   and the saved attention scores reckoned beside it. ``pvt_trainer``:
   ``train_net_torch.main`` at that batch (4 steps, 8 test batches of 1 NMS,
   ``--resume`` bit-equal, ``--eval-only``). ``vt_fpn``: R-50 VT-FPN with
   the fused flags on and off: heads against fp32, exactly 1 stem + 13
   bottleneck + 1 NMS a predict call with them on, >= MATCH_MIN of the slots
   matched on against off, predict ms in turns, 4 steps at B = 16 with 1 +
   13 launches each.

37. FCOS R-50-FPN against the JAX package at the loader's full size
   (``full_size``; ``slenderobjdet_torch/tools/full_size_check.py``): the
   weights rebuilt in numpy from ``tests/data/fcos_r50_full_size.npz``'s
   manifest (its checksum), both buckets at B = 1: in fp32 with TF32 off and
   the fused kernels on, the head sample and the 100 detections against the
   committed JAX outputs under the CPU test's rule; in bf16 the head within
   HEAD_TOL and at least FULL_SIZE_BF16_SHARE of JAX's slots paired; exactly
   1 stem + 13 bottleneck + 1 NMS a call.
38. The tools (``tools``), in this process on 16 synthetic PNG images at
   800x1333 / 1333x800: ``inference_obj365`` (FCOS, B = 8, 1 + 13 + 1 a
   batch), ``eval_and_save_proposals`` (Faster R-CNN, 1 + 13 + 2 a batch of
   4), ``vis_feat_adaption`` (RepPoints, 1 + 13 an image),
   ``mask_to_rbox``, ``generate_border_maps``, ``visualize_json_results``:
   launch counts exact, output files checked, img/s through each model tool;
   then ``data_time`` on 64 generated PNG images, from files and from a
   RecordPack, and its stage budget (PNG decode, torch resize: no cv2),
   img/s and the decoder printed; ``compare_matchers`` (Faster R-CNN's RPN
   anchors and both matchers on the card); the readers ``result_statistic``,
   ``ar_result``, ``coco_class_info``, ``data_statistic`` and ``regression``
   over ``inference_obj365``'s results; ``watch_evaluate --once`` (its
   subprocess's pkl equal to ``result_statistic``'s); ``run_experiments
   --dry-run``'s command lines; neither cv2 nor jax imported.
39. FCOS R-50-FPN trained by ``convergence_run`` (``convergence``): full
   width, bf16, FUSED_STEM and FUSED_BLOCKS on, CONVERGENCE_STEPS steps of
   B = 8 at 256 x 256 on its generated batches. The stem and the five
   bottleneck shapes at that size are first held against their plain
   versions (bf16 tolerance). The run must launch exactly 1 stem + 13
   bottleneck kernels a step and 1 + 13 + 1 NMS a held-out predict call (4
   calls), keep its logged losses finite and end below
   CONVERGENCE_LOSS_FACTOR of its first; prints the first and last loss,
   the held-out precision and recall at IoU 0.5 and the seconds.
40. The staged profile tools (``profiles``), in a child process: the
   ports of ``tools/predict_profile.py``, ``postprocess_probe.py``,
   ``profile_backbone.py`` and ``rcnn_profile.py`` (each with and without
   ``--fused`` / ``--all-level-pool``), ``reppoints_profile.py --full`` and
   ``corner_profile.py --stages``, at B = 8
   (CornerNet B = 4 at 512 x 768) and 2 reps. Each must print the JAX
   script's labels in its order after the card line, give finite positive
   times, and launch exactly the kernels of PROFILE_LAUNCHES a call in each
   stage: the NMS kernel where a stage runs predict's NMS (Faster R-CNN's
   full predict twice), 3 / 3 / 5 / 2 / 13 bottleneck kernels in res2-res5
   and the trunk with ``--fused``, and 2 corner-pool kernels a CornerNet
   heads call; neither cv2 nor jax imported. Each tool's table is logged.

Every kernel's time stands beside its bound, the least time the card could
take: the larger of its bytes (inputs read once, outputs written once) over
3.35 TB/s and its operations over the peak rate of their type (989 TFLOP/s
bf16 tensor cores, 67 TFLOP/s fp32), the H100 SXM's published figures.

Prints the card's ``nvidia-smi`` name and power limit, a JSON line of the
kernels, and as the last line ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, without a CUDA device or on any failure.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
import traceback

import numpy as np
import torch

from slenderobjdet_torch.tools.card import card_line, cuda_ms

FP32_TOL = 1e-4      # max|diff| / max|ref|, fp32 kernel vs fp32 plain
BF16_TOL = 3e-2      # the same ratio, bf16 kernel vs bf16 plain
HEAD_FACTOR = 1.5    # head outputs: fused error vs fp32 <= 1.5 x unfused's
HEAD_TOL = 0.15      # and <= this ratio (bf16 rounds ~60 layers deep)
SCORE_TOL = 2e-2     # fused vs unfused: scores of matched detections
MATCH_MIN = 0.99     # fused vs unfused: share of detection slots matched

PREDICT_KERNELS = ("nms", "fused_stem", "fused_bottleneck")
RESUME_FACTOR = 1.02  # trainer: resumed loss on batch 0 <= this x step 0's loss
PROBE_KERNELS = ("fused_kernel_probe", "dma_streams_probe", "bw_probe")
GRAD_FACTOR = 1.5    # train: fused gradient error vs fp32 <= 1.5 x unfused's
TRAIN_STEPS = 10     # train: steps after step 0 on one batch
DMA_RTOL = 1e-5      # DMA probe tokens: fp32 sums of the same bf16 values

# NVIDIA's published peaks of the H100 SXM (data sheet, dense, 700 W)
PEAK_BYTES_S = 3.35e12       # device memory
PEAK_BF16_FLOPS = 989e12     # tensor cores, bf16
PEAK_FP32_FLOPS = 67e12      # CUDA cores, fp32
NMS_OPS_PER_PAIR = 17        # one round, one candidate: IoU (16) + the argmax compare

# R-50 stride-1 bottleneck shapes at 800x1344: name, H, W, Cin, Cm, Cout,
# projection shortcut, and how many of the 13 fused blocks have this shape.
BLOCKS = [
    ("res2_0", 200, 336, 64, 64, 256, True, 1),
    ("res2_1", 200, 336, 256, 64, 256, False, 2),
    ("res3_1", 100, 168, 512, 128, 512, False, 3),
    ("res4_1", 50, 84, 1024, 256, 1024, False, 5),
    ("res5_1", 25, 42, 2048, 512, 2048, False, 2),
]


# The data loader pads every image to one of two buckets: for MIN_SIZE 800 and
# MAX_SIZE 1333, 896 x 1408 (landscape) and 1408 x 896 (portrait).
LOADER_SHAPES = ((896, 1408), (1408, 896))
LOADER_IMAGE_HW = (800, 1333)      # the synthetic images: no resize happens
LOADER_BATCHES = (8, 16)           # the test loader's batch and the trainer's


def loader_blocks(h, w):
    """BLOCKS at an (h, w) input: res2 at 1/4, res3 1/8, res4 1/16, res5 1/32."""
    return [(name, h // 4 // d, w // 4 // d, cin, cm, cout, proj, count)
            for (name, _, _, cin, cm, cout, proj, count), d in zip(BLOCKS, (1, 1, 2, 4, 8))]


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_once(fn):
    """``fn()`` and the device ms of that one call (CUDA events, no warm-up):
    a plain version run once for the comparison is timed by the same call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound_ms(n_bytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES_S * 1e3, flops / peak_flops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def set_bound(entry, n_bytes, flops, peak_flops=PEAK_BF16_FLOPS):
    entry["bound_ms"], entry["bound_by"] = bound_ms(n_bytes, flops, peak_flops)


def log_bounds(kernels):
    for k in kernels.values():
        if "ms" in k and "bound_ms" in k:
            lib = k.get("library_ms")
            log(f"bound {k['name']}: kernel {k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
                f"({k['bound_by']}), {k['bound_ms'] / k['ms']:.3f} of bound; same-function "
                f"PyTorch call " + ("none" if lib is None else f"{lib:.4f} ms"))


# NMS candidate sets: span of the corners, box sides, classes, score steps
# (0: continuous scores), share of valid candidates
NMS_SETS = {
    "sparse": (1200, 8, 300, 80, 0, 0.9),
    "dense": (200, 20, 60, 4, 0, 0.9),
    "ties": (200, 20, 60, 4, 16, 0.9),
    "ragged": (1200, 8, 300, 80, 0, 0.3),
    "crowded": (24, 30, 40, 2, 0, 0.9),     # the survivors run out before 100
}


def nms_inputs(rs, name, B, N, dev):
    """Integer-pixel boxes, scores, classes and a validity mask on the card."""
    span, lo, hi, ncls, steps, share = NMS_SETS[name]
    xy = rs.randint(0, span, (B, N, 2))
    wh = rs.randint(lo, hi, (B, N, 2))
    boxes = torch.tensor(np.concatenate([xy, xy + wh], 2), dtype=torch.float32, device=dev)
    sc = rs.rand(B, N)
    scores = torch.tensor(np.floor(sc * (steps + 1)) / steps if steps else sc,
                          dtype=torch.float32, device=dev)
    classes = torch.tensor(rs.randint(0, ncls, (B, N)), device=dev)
    valid = torch.tensor(rs.rand(B, N) < share, device=dev)
    return boxes, scores, classes, valid


def phase_nms(kernels, dev):
    from slenderobjdet_torch.ops.nms import (batched_nms, cuda_batched_nms, cuda_nms,
                                             launch_nms, nms_select)

    rs = np.random.RandomState(0)
    worst = 0

    def check(label, args, got, want):
        nonlocal worst
        torch.cuda.synchronize()
        worst = max(worst, int((got[0].long() - want[0].long()).abs().max()))
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"NMS kernel != plain ({label}): "
                                 f"{int((got[0] != want[0]).sum())} indices differ")
        rounds = torch.zeros(args[0].shape[0], dtype=torch.int32, device=dev)
        launch_nms(*args, 0.6, 100, rounds=rounds)
        kept, rounds = got[1].sum(1).tolist(), rounds.tolist()
        log(f"nms {label}: kernel == plain at B={args[0].shape[0]} N={args[0].shape[1]}, "
            f"kept an image {min(kept)}-{max(kept)} (sum {sum(kept)}), block-wide rounds "
            f"an image {min(rounds)}-{max(rounds)} (mean {np.mean(rounds):.2f})")
        return sum(kept)

    sets = {}
    for name, B, N in (("sparse", 8, 5000), ("dense", 8, 5000), ("ties", 8, 5000),
                       ("ragged", 3, 4321), ("crowded", 8, 5000), ("sparse", 32, 5000),
                       ("dense", 32, 5000)):
        args = nms_inputs(rs, name, B, N, dev)
        kept = check(f"{name} B={B}", args, cuda_batched_nms(*args[:3], 0.6, 100, args[3]),
                     batched_nms(*args[:3], 0.6, 100, args[3]))
        sets[name, B] = (args, kept)
    boxes, scores, _, valid = sets["dense", 8][0]
    check("dense B=8 without classes", (boxes, scores, None, valid),
          cuda_nms(boxes, scores, 0.6, 100, valid), nms_select(boxes, scores, 0.6, 100, valid))

    # the kernel alone and the whole call (inputs prepared; device time of 50
    # launches enqueued behind a held stream, since the kernel is shorter
    # than the host's enqueue), and one call as a caller waits for it (host
    # clock, synchronised)
    for (name, B), (args, kept) in sets.items():
        if name not in ("sparse", "dense"):
            continue
        ms = cuda_ms(lambda: launch_nms(*args, 0.6, 100), 50, queued=True)
        call_ms = cuda_ms(lambda: cuda_batched_nms(*args[:3], 0.6, 100, args[3]), 50,
                          queued=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            cuda_batched_nms(*args[:3], 0.6, 100, args[3])
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 50 * 1e3
        plain_ms = cuda_ms(lambda: batched_nms(*args[:3], 0.6, 100, args[3]), 3)
        # the reference's work: each kept box scans its image's N candidates once
        out = (torch.empty(B, 100, dtype=torch.int32), torch.empty(B, 100, dtype=torch.bool))
        b_ms, b_by = bound_ms(nbytes(*args, *out), kept * args[0].shape[1] * NMS_OPS_PER_PAIR,
                              PEAK_FP32_FLOPS)
        log(f"time nms {name} B={B} N=5000: kernel alone {ms:.4f} ms, cuda_batched_nms call "
            f"{call_ms:.4f} ms (one synchronised call {wall_ms:.4f} ms on the host clock), "
            f"plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.4f} of bound")
        if (name, B) == ("dense", 8):
            kernels["nms"].update(max_abs_err=float(worst), ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by, library_ms=None)


def stem_inputs(batch, h, w, cs, dev, seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = (torch.randn(batch, h, w, 3, generator=g) * 50).to(dev)
    wt = (torch.randn(7, 7, 3, cs, generator=g) / 147 ** 0.5).to(dev)
    scale = (torch.rand(cs, generator=g) * 0.5 + 0.75).to(dev)
    bias = (torch.randn(cs, generator=g) * 0.1).to(dev)
    return x, wt, scale, bias


def phase_stem(kernels, dev):
    from slenderobjdet_torch.ops.fused_stem import (fused_stem, launch_stem,
                                                    reference_stem, stem_plan)

    def check(label, x, w, scale, bias, dt, tol, route):
        b, h, wd, _ = x.shape
        cs = w.shape[-1]
        xd = x.to(dt)
        plan = stem_plan(dt, b, h, wd, cs)
        if plan["route"] != route:
            raise AssertionError(f"stem {label}: plan {plan}, expected {route}")
        got = fused_stem(xd, w, scale, bias)
        want = reference_stem(xd, w, scale, bias)
        torch.cuda.synchronize()
        if got.shape != (b, h // 4, wd // 4, cs) or got.dtype != dt:
            raise AssertionError(f"stem output {tuple(got.shape)} {got.dtype}")
        err = ratio(got, want)
        abs_err = float((got.double() - want.double()).abs().max())
        log(f"stem {label} {dt} ({route}): err ratio {err:.3e} (tol {tol}), "
            f"max abs err {abs_err:.4e}")
        if not err <= tol:
            raise AssertionError(f"stem {label} {dt} err {err} > {tol}")
        return abs_err

    x, w, scale, bias = stem_inputs(8, 800, 1344, 64, dev)
    check("B=8 800x1344", x, w, scale, bias, torch.float32, FP32_TOL, "cuda_cores")
    kernels["fused_stem"]["max_abs_err"] = check(
        "B=8 800x1344", x, w, scale, bias, torch.bfloat16, BF16_TOL, "mma")
    check("ragged (2, 36, 52)", *stem_inputs(2, 36, 52, 64, dev, seed=11),
          torch.bfloat16, BF16_TOL, "mma")
    check("ragged (2, 36, 52)", *stem_inputs(2, 36, 52, 64, dev, seed=11),
          torch.float32, FP32_TOL, "cuda_cores")
    check("16 channels (2, 36, 52)", *stem_inputs(2, 36, 52, 16, dev, seed=12),
          torch.bfloat16, BF16_TOL, "cuda_cores")
    x32 = stem_inputs(32, 800, 1344, 64, dev, seed=13)[0].to(torch.bfloat16)
    check("B=32 800x1344", x32, w, scale, bias, torch.bfloat16, BF16_TOL, "mma")
    # the loader's two buckets, at the test loader's batch (8) and the
    # trainer's (16); B=2 also in fp32
    for k, (h, wd) in enumerate(LOADER_SHAPES):
        xl = stem_inputs(2, h, wd, 64, dev, seed=14 + k)[0]
        check(f"B=2 {h}x{wd}", xl, w, scale, bias, torch.float32, FP32_TOL, "cuda_cores")
        check(f"B=2 {h}x{wd}", xl, w, scale, bias, torch.bfloat16, BF16_TOL, "mma")
        for batch in LOADER_BATCHES:
            xl = stem_inputs(batch, h, wd, 64, dev, seed=20 + 2 * batch + k)[0]
            check(f"B={batch} {h}x{wd}", xl, w, scale, bias, torch.bfloat16, BF16_TOL, "mma")
    del xl

    # the tensor-core kernel in turns with the CUDA-core one and with the
    # flags-off model path (bf16 cuDNN conv, FrozenBN, relu, maxpool)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last).to(torch.bfloat16)
    sc, bc = (t.to(torch.bfloat16).view(1, -1, 1, 1) for t in (scale, bias))

    def unfused(xc):
        y = torch.nn.functional.conv2d(xc, wc, stride=2, padding=3)
        return torch.nn.functional.max_pool2d(torch.relu(y * sc + bc), 3, 2, 1)

    timed = [x.to(torch.bfloat16), x32] + [
        stem_inputs(batch, h, wd, 64, dev, seed=16)[0].to(torch.bfloat16)
        for h, wd in LOADER_SHAPES for batch in LOADER_BATCHES]
    for xb in timed:
        batch, hh, ww = xb.shape[:3]
        xc = xb.permute(0, 3, 1, 2)
        turns = {"mma": [], "cuda_cores": [], "cudnn": []}
        for route in ("mma", "cuda_cores", "cudnn", "cudnn", "cuda_cores", "mma"):
            fn = (lambda: unfused(xc)) if route == "cudnn" else (
                lambda: launch_stem(xb, w, scale, bias, route=route))
            turns[route].append(cuda_ms(fn, 10))
        ms, old_ms, cudnn_ms = (float(np.mean(turns[r])) for r in ("mma", "cuda_cores", "cudnn"))
        flops = 2 * 147 * 64 * batch * (hh // 2) * (ww // 2)
        out = torch.empty(batch, hh // 4, ww // 4, 64, dtype=torch.bfloat16, device="meta")
        b_ms, b_by = bound_ms(nbytes(xb, out) + 176 * 64 * 2 + 64 * 4, flops)
        log(f"time stem B={batch} {hh}x{ww} bf16: tensor-core kernel {ms:.4f} ms "
            f"({turns['mma']}), CUDA-core kernel {old_ms:.4f} ms, unfused bf16 cuDNN "
            f"path {cudnn_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), "
            f"{b_ms / ms:.3f} of bound, {flops / ms / 1e9:.1f} TFLOP/s")
        if batch == 8:
            plain_ms = cuda_ms(lambda: reference_stem(xb, w, scale, bias), 10)
            log(f"time stem B=8 {hh}x{ww} plain (fp32 conv) {plain_ms:.4f} ms")
            if (hh, ww) == (800, 1344):
                kernels["fused_stem"].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                             bound_by=b_by, library_ms=cudnn_ms)
            else:
                kernels["fused_stem"][f"at_{hh}x{ww}"] = {
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": cudnn_ms}
            if not ms < old_ms:
                raise AssertionError(f"stem: tensor cores {ms} ms, CUDA cores {old_ms} ms")


def block_gflop(batch, h, w, cin, cm, cout, proj):
    """The block's multiply-adds x 2, in GFLOP."""
    macs = cin * cm + 9 * cm * cm + cm * cout + (cin * cout if proj else 0)
    return 2 * batch * h * w * macs / 1e9


def phase_bottleneck(kernels, dev):
    from slenderobjdet_torch.models.backbones.resnet import BottleneckBlock
    from slenderobjdet_torch.ops.fused_bottleneck import (bottleneck_plan,
                                                          fused_bottleneck,
                                                          reference_bottleneck)

    g = torch.Generator(device="cpu").manual_seed(2)
    gd = torch.Generator(device=dev).manual_seed(2)
    totals = {8: [0.0, 0.0, 0.0], 32: [0.0, 0.0, 0.0]}
    worst_abs = 0.0
    bounds = {"bytes": 0.0, "operations": 0.0}   # the 13 blocks' bounds, by side

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)

    def block_weights(cin, cm, cout, proj):
        w1, b1 = rnd(cin, cm, s=cin ** -0.5), rnd(cm, s=0.1)
        w2, b2 = rnd(3, 3, cm, cm, s=(9 * cm) ** -0.5), rnd(cm, s=0.1)
        w3, b3 = rnd(cm, cout, s=cm ** -0.5), rnd(cout, s=0.1)
        wsc, bsc = (rnd(cin, cout, s=cin ** -0.5), rnd(cout, s=0.1)) if proj else (None, None)
        return (w1, b1, w2, b2, w3, b3, wsc, bsc)

    def check(label, x, args, dtypes=(torch.float32, torch.bfloat16)):
        """The kernel against the plain version in each of ``dtypes``; the
        bf16 max abs error."""
        nonlocal worst_abs
        for dt in dtypes:
            tol = FP32_TOL if dt == torch.float32 else BF16_TOL
            xd = x.to(dt)
            got = fused_bottleneck(xd, *args)
            want = reference_bottleneck(xd, *args)
            torch.cuda.synchronize()
            if got.shape != (*x.shape[:3], args[4].shape[1]) or got.dtype != dt:
                raise AssertionError(f"{label} output {tuple(got.shape)} {got.dtype}")
            err = ratio(got, want)
            abs_err = float((got.double() - want.double()).abs().max())
            log(f"bottleneck {label} {dt}: err ratio {err:.3e} (tol {tol}), "
                f"max abs err {abs_err:.4e}")
            if not err <= tol:
                raise AssertionError(f"bottleneck {label} {dt} err {err} > {tol}")
            if dt == torch.bfloat16:
                worst_abs = max(worst_abs, abs_err)
            del got, want

    def moved_bytes(xb, cin, cout, args):
        """x in, the output out, bf16 weights and fp32 biases once."""
        return nbytes(xb) * (cin + cout) // cin + sum(
            t.numel() * (2 if t.dim() > 1 else 4) for t in args if t is not None)

    for name, h, wd, cin, cm, cout, proj, count in BLOCKS:
        args = block_weights(cin, cm, cout, proj)
        x = torch.relu(rnd(8, h, wd, cin))
        check(name, x, args)
        del x
        block = BottleneckBlock(cin, cout, cm).to(dev, memory_format=torch.channels_last)
        for batch in (8, 32):
            xb = torch.relu(torch.randn(batch, h, wd, cin, generator=gd, device=dev)
                            ).to(torch.bfloat16)
            route = bottleneck_plan(torch.bfloat16, batch, h, wd, cin, cm, cout)["route"]
            ms = cuda_ms(lambda: fused_bottleneck(xb, *args), 5)
            plain_ms = cuda_ms(lambda: reference_bottleneck(xb, *args), 3 if batch == 8 else 2)
            xc = xb.permute(0, 3, 1, 2)
            with torch.no_grad():
                cudnn_ms = cuda_ms(lambda: block(xc), 5)
            gf = block_gflop(batch, h, wd, cin, cm, cout, proj)
            if batch == 8:
                b_ms, b_by = bound_ms(moved_bytes(xb, cin, cout, args), gf * 1e9)
                bounds[b_by] += count * b_ms
            log(f"time bottleneck {name} B={batch} {h}x{wd} bf16 ({route}): kernel "
                f"{ms:.4f} ms ({gf / ms:.1f} TFLOP/s), plain (fp32 convs) "
                f"{plain_ms:.4f} ms, bf16 cuDNN block {cudnn_ms:.4f} ms "
                f"({gf / cudnn_ms:.1f} TFLOP/s)")
            for k, v in enumerate((ms, plain_ms, cudnn_ms)):
                totals[batch][k] += count * v
            del xb, xc
            torch.cuda.empty_cache()
        del block
    for batch, (ms, plain_ms, cudnn_ms) in totals.items():
        log(f"time bottleneck, all 13 fused blocks of R-50 at B={batch}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 cuDNN blocks {cudnn_ms:.4f} ms")
    kernels["fused_bottleneck"].update(
        max_abs_err=worst_abs, ms=totals[8][0], plain_ms=totals[8][1],
        bound_ms=sum(bounds.values()), bound_by=max(bounds, key=bounds.get),
        library_ms=totals[8][2])
    log(f"bound bottleneck, 13 blocks at B=8: {bounds} ms by side (res2 and res3 "
        f"are bound by bytes, res4 and res5 by operations)")

    # the shapes that follow from the data loader's two buckets, in both
    # orientations: checked at B=2 (a ragged last tile at res5) in fp32 and
    # bf16, and at the test loader's and the trainer's batch in bf16 (the
    # kernel tiles the flattened B*H*W pixels, so the batch is part of the
    # shape); timed at both batches in turns with the bf16 cuDNN block
    for ih, iw in LOADER_SHAPES:
        big = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "ms_b16": 0.0,
               "library_ms_b16": 0.0}
        big_bounds = {"bytes": 0.0, "operations": 0.0}
        for name, h, wd, cin, cm, cout, proj, count in loader_blocks(ih, iw):
            args = block_weights(cin, cm, cout, proj)
            check(f"{name} {h}x{wd} (input {ih}x{iw}, B=2)", torch.relu(rnd(2, h, wd, cin)), args)
            block = BottleneckBlock(cin, cout, cm).to(dev, memory_format=torch.channels_last)
            for batch in LOADER_BATCHES:
                xb = torch.relu(torch.randn(batch, h, wd, cin, generator=gd, device=dev))
                check(f"{name} {h}x{wd} (input {ih}x{iw}, B={batch})", xb, args,
                      dtypes=(torch.bfloat16,))
                xb = xb.to(torch.bfloat16)
                xc = xb.permute(0, 3, 1, 2)
                turns = {"kernel": [], "cudnn": []}
                with torch.no_grad():
                    for which in ("kernel", "cudnn", "cudnn", "kernel"):
                        fn = (lambda: fused_bottleneck(xb, *args)) if which == "kernel" \
                            else (lambda: block(xc))
                        turns[which].append(cuda_ms(fn, 10))
                ms, cudnn_ms = (float(np.mean(turns[k])) for k in ("kernel", "cudnn"))
                gf = block_gflop(batch, h, wd, cin, cm, cout, proj)
                b_ms, b_by = bound_ms(moved_bytes(xb, cin, cout, args), gf * 1e9)
                line = (f"time bottleneck {name} B={batch} {h}x{wd} bf16 (input {ih}x{iw}): "
                        f"kernel {ms:.4f} ms ({gf / ms:.1f} TFLOP/s), bf16 cuDNN block "
                        f"{cudnn_ms:.4f} ms ({ms / cudnn_ms:.3f} x); bound {b_ms:.4f} ms ({b_by})")
                if batch == 8:
                    plain_ms = cuda_ms(lambda: reference_bottleneck(xb, *args), 2)
                    line += f"; plain (fp32 convs) {plain_ms:.4f} ms"
                    big_bounds[b_by] += count * b_ms
                    for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", cudnn_ms)):
                        big[key] += count * v
                else:
                    big["ms_b16"] += count * ms
                    big["library_ms_b16"] += count * cudnn_ms
                log(line)
                del xb, xc
                torch.cuda.empty_cache()
            del block
        big.update(bound_ms=sum(big_bounds.values()),
                   bound_by=max(big_bounds, key=big_bounds.get))
        kernels["fused_bottleneck"][f"at_{ih}x{iw}"] = big
        log(f"time bottleneck, all 13 fused blocks of R-50 at B=8, input {ih}x{iw}: kernel "
            f"{big['ms']:.4f} ms, plain {big['plain_ms']:.4f} ms, bf16 cuDNN blocks "
            f"{big['library_ms']:.4f} ms; bound {big['bound_ms']:.4f} ms ({big_bounds} by "
            f"side); at B=16: kernel {big['ms_b16']:.4f} ms, bf16 cuDNN blocks "
            f"{big['library_ms_b16']:.4f} ms")
    sass_check()


def sass_check():
    """The model's bf16 wgmma kernel holds HGMMA and the bf16 stem kernel
    HMMA (cuobjdump -sass of the built library, next to nvcc); the wgmma
    kernel's bisection variants are listed too."""
    import re
    import subprocess
    from pathlib import Path

    from slenderobjdet_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "HMMA": 0, "BAR.SYNC": 0, "UBLKCP": 0, "SYNCS": 0}
        elif fn is not None:
            for op in counts[fn]:
                counts[fn][op] += op in line
    model = {}
    for fn, c in counts.items():
        m = re.search(r"conv_wgmma_kernelILi(\d+)ELi(\d)E", fn)
        if m:
            log(f"sass conv_wgmma_kernel<BN={m.group(1)}, mode={m.group(2)}>: {c}")
            if m.group(2) == "0":
                model[m.group(1)] = c
    if sorted(model) != ["128", "256", "64"] or not all(
            c["HGMMA"] > 0 and c["UBLKCP"] > 0 for c in model.values()):
        raise AssertionError(f"the model's wgmma kernels lack HGMMA or bulk copies: {model}")
    stem = [c for fn, c in counts.items() if "stem_mma_kernel" in fn]
    log(f"sass stem_mma_kernel: {stem}")
    if len(stem) != 1 or not (stem[0]["HMMA"] > 0 or stem[0]["HGMMA"] > 0) \
            or stem[0]["UBLKCP"] != 1:
        raise AssertionError(f"the bf16 stem kernel lacks tensor-core instructions "
                             f"or its one weight bulk copy: {stem}")


FCOS_YAML = "configs/fcos/fcos_R_50_FPN_1x.yaml"
RETINANET_YAML = "configs/retina/retinanet_R_50_FPN_1x.yaml"


def flagship_cfg(fused: bool, dtype: str = "bfloat16", yaml: str = FCOS_YAML):
    from pathlib import Path

    from slenderobjdet_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parent / yaml))
    cfg.MODEL.RESNETS.FUSED_STEM = fused
    cfg.MODEL.RESNETS.FUSED_BLOCKS = fused
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.freeze()
    return cfg


def requests(n: int, batch: int, seed: int, hw=(800, 1344)):
    rs = np.random.RandomState(seed)
    return [{
        "image": rs.randint(0, 256, (batch, *hw, 3)).astype(np.uint8),
        "scale": np.ones((batch,), np.float32),
        "orig_size": np.tile(np.array([hw], np.float32), (batch, 1)),
    } for _ in range(n)]


def randomize_frozen_bn(model, gen):
    """FrozenBN buffers away from identity, so that the fused seams' folding
    matters."""
    from slenderobjdet_torch.models.layers import FrozenBatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm):
                n = m.scale.numel()
                m.scale.copy_(torch.rand(n, generator=gen) * 0.5 + 0.75)
                m.bias.copy_(torch.randn(n, generator=gen) * 0.05)


def build_models(dev, yaml: str = FCOS_YAML, cls_bias: float = 0.0):
    """The fused bf16 model with seeded weights, and the same weights unfused
    in bf16 (the cuDNN path) and unfused in fp32 (the reference for both).

    FrozenBN buffers are drawn away from identity, and the classifier's bias
    is ``cls_bias`` so that scores pass the test threshold (the focal prior
    keeps every score of a random model under it)."""
    from slenderobjdet_torch.models import build_model

    gen = torch.Generator().manual_seed(0)
    model = build_model(flagship_cfg(True, yaml=yaml), device=dev, generator=gen)
    randomize_frozen_bn(model, gen)
    with torch.no_grad():
        classifier(model).bias.fill_(cls_bias)
    plain = build_model(flagship_cfg(False, yaml=yaml), device=dev)
    plain.load_state_dict(model.state_dict())
    ref32 = build_model(flagship_cfg(False, "float32", yaml=yaml), device=dev)
    ref32.load_state_dict(model.state_dict())
    return model, plain, ref32


def classifier(model):
    """The head's last classification conv: FCOS's (and FCOSAnchor's),
    RetinaNet's, the point-set head's or the ablation head's."""
    head = model.head
    for name in ("cls_logits", "cls_score", "logits_out", "cls_out"):
        if hasattr(head, name):
            return getattr(head, name)
    raise AttributeError(f"{type(head).__name__} has no classifier")


def one_detection_per_class(gen, *models):
    """Make the detections of two roundings of one network comparable.

    Random weights give nearly tied scores, whose order two bf16 programs
    need not share, so detections are compared class by class, and this
    makes every class keep exactly one detection in both:
    - the bbox_pred bias is 12, which saturates the head's exp clamp
      (ltrb = e^9 everywhere): all boxes of a class overlap with IoU > 0.6,
      so NMS keeps one per class;
    - the cls_logits filters are one shared random filter plus a per-class
      one a tenth its size: each location ranks all 80 classes together, so
      every level's top-1000 candidates hold every class (with independent
      filters, classes whose best pair sits near a level's 1000th place
      appear in one program and not in the other)."""
    w = models[0].head.cls_logits.weight
    shared = torch.randn(w.shape[1:], generator=gen) * 0.01
    per_class = torch.randn(w.shape, generator=gen) * 0.001
    with torch.no_grad():
        for m in models:
            m.head.bbox_pred.bias.fill_(12.0)
            m.head.cls_logits.weight.copy_(shared + per_class)


def check_outputs(out, batch: int):
    shapes = {"boxes": (batch, 100, 4), "scores": (batch, 100),
              "classes": (batch, 100), "valid": (batch, 100)}
    if sorted(out) != sorted(shapes):
        raise AssertionError(f"predict returned {sorted(out)}")
    for k, s in shapes.items():
        if tuple(out[k].shape) != s:
            raise AssertionError(f"{k} shape {tuple(out[k].shape)} != {s}")
    for k in ("boxes", "scores"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"non-finite {k}")


def per_class(out, b):
    v = out["valid"][b].cpu().numpy()
    cls = out["classes"][b].cpu().numpy()[v]
    sc = out["scores"][b].float().cpu().numpy()[v]
    bx = out["boxes"][b].float().cpu().numpy()[v]
    return {int(c): (float(s), x) for c, s, x in zip(cls, sc, bx)}


def check_heads(label, parts, req, dev, model, plain, ref32):
    """Head outputs: the fused model may be no further from the fp32 model
    than the unfused bf16 model is, by more than HEAD_FACTOR."""
    with torch.inference_mode():
        images = torch.as_tensor(req["image"], device=dev)
        heads = [m(images) for m in (model, plain, ref32)]
    for part, f_l, p_l, r_l in zip(parts, *heads):
        if not r_l:       # a part this head does not have (the ablation's centerness)
            continue
        e_f = max(ratio(f, r) for f, r in zip(f_l, r_l))
        e_p = max(ratio(p, r) for p, r in zip(p_l, r_l))
        log(f"head {label} {part} vs fp32: fused bf16 err ratio {e_f:.3e}, unfused "
            f"bf16 {e_p:.3e} (fused <= {HEAD_FACTOR} x unfused and <= {HEAD_TOL})")
        if not (e_f <= HEAD_FACTOR * e_p and e_f <= HEAD_TOL):
            raise AssertionError(f"head {label} {part}: fused err {e_f}, unfused {e_p}")


def phase_main_path(kernels, dev, model, plain, ref32):
    from slenderobjdet_torch.ops import _build

    reqs = requests(3, 8, seed=3)
    check_heads("fcos", ("logits", "reg", "ctr"), reqs[0], dev, model, plain, ref32)
    one_detection_per_class(torch.Generator().manual_seed(5), model, plain)

    _build.reset_launch_counts()
    outs = [model.predict(r) for r in reqs]
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    log(f"main path launches over 3 requests of B=8: {counts}")
    for name in PREDICT_KERNELS:
        kernels[name]["launches"] = counts[name]
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    for out in outs:
        check_outputs(out, 8)
    n_valid = sum(int(o["valid"].sum()) for o in outs)
    log(f"main path: {n_valid} valid detections over 24 images")
    if n_valid <= 0:
        raise AssertionError("no valid detections")

    # A slot matches when the other path kept the same class with a score
    # within SCORE_TOL (and the same box, which the saturated regression
    # makes the whole image).
    matched = total = 0
    diffs = []
    for r, out in zip(reqs, outs):
        ref = plain.predict(r)
        check_outputs(ref, 8)
        if not torch.equal(out["valid"].sum(1), ref["valid"].sum(1)):
            raise AssertionError("valid counts differ between fused and unfused")
        for b in range(8):
            f, p = per_class(out, b), per_class(ref, b)
            total += len(f)
            for c, (s, x) in f.items():
                if c in p and np.allclose(x, p[c][1], atol=1e-3):
                    diffs.append(abs(s - p[c][0]))
                    matched += diffs[-1] <= SCORE_TOL
    share = matched / max(total, 1)
    log(f"fused vs unfused detections: {matched}/{total} slots matched by class "
        f"with score diff <= {SCORE_TOL}; score diff median "
        f"{np.median(diffs):.3e}, max {np.max(diffs):.3e}")
    if share < MATCH_MIN:
        raise AssertionError(f"fused vs unfused: {share:.4f} of slots matched")


def phase_throughput(model, plain, family="FCOS", hw=(800, 1344)):
    """predict img/s at B=8 (two turns each, 2 warm-up calls, 5 timed) and
    B=32 (one turn each, 1 warm-up, 2 timed), the fused and the unfused
    model in turns; returns {(batch, "fused" or "unfused"): the last turn's
    img/s}."""
    rates = {}
    turns = (("fused", model), ("unfused", plain))
    for batch, iters, warm, order in ((8, 5, 2, turns + turns), (32, 2, 1, turns)):
        req = requests(1, batch, seed=4, hw=hw)[0]
        for label, m in order:
            for _ in range(warm):
                m.predict(req)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                m.predict(req)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / iters
            rates[batch, label] = batch / dt
            log(f"time predict {family} B={batch} {hw[0]}x{hw[1]} {label}: "
                f"{dt * 1e3:.3f} ms/batch, {batch / dt:.2f} img/s")
    return rates


def phase_probes(kernels, dev):
    """Each probe kernel against its plain version, then the probe tools'
    entry points with the launch counts reset before and read after."""
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.ops.bw_probe import bw_copy, reference_copy
    from slenderobjdet_torch.ops.dma_streams_probe import (dma_streams,
                                                           reference_dma_streams)
    from slenderobjdet_torch.ops.fused_bottleneck import (PROBE_MODES,
                                                          fused_bottleneck,
                                                          probe_variant,
                                                          reference_probe_variant)
    from slenderobjdet_torch.tools import bw_probe, dma_streams_probe, fused_kernel_probe

    worst = 0.0
    ms = plain_ms = probe_bound = 0.0
    for name in ("res2_1", "res4_1", "res5_1"):
        h, w, cin, cm, cout = fused_kernel_probe.BLOCKS[name]
        x, weights = fused_kernel_probe.block_inputs(8, h, w, cin, cm, cout, dev, seed=5)
        # what each variant must do: conv1 and conv3 always, conv2 in full or
        # on one tap, or only the copy (dmaonly) or the write (nodma)
        px, wbytes = 8 * h * w, nbytes(*weights)
        macs = {"full": 2 * cin * cm + 9 * cm * cm, "norolls": 2 * cin * cm + 9 * cm * cm,
                "notap": 2 * cin * cm + cm * cm, "noconv2": 2 * cin * cm,
                "dmaonly": 0, "nodma": 0}
        moved = {m: 2 * nbytes(x) + wbytes for m in PROBE_MODES}
        moved.update(dmaonly=2 * nbytes(x), nodma=nbytes(x))
        main = fused_bottleneck(x, *weights)
        for mode in PROBE_MODES:
            got = probe_variant(mode, x, *weights)
            want = reference_probe_variant(mode, x, *weights)
            torch.cuda.synchronize()
            err = ratio(got, want)
            worst = max(worst, float((got.double() - want.double()).abs().max()))
            exact = torch.equal(got, main) if mode == "full" else None
            log(f"probe {name} {mode}: err ratio {err:.3e} (tol {BF16_TOL})"
                + ("" if exact is None else f", == fused_bottleneck: {exact}"))
            if not err <= BF16_TOL or exact is False:
                raise AssertionError(f"probe {name} {mode}: err {err}, exact {exact}")
            if name == "res2_1":
                ms += cuda_ms(lambda: probe_variant(mode, x, *weights), 5)
                plain_ms += cuda_ms(lambda: reference_probe_variant(mode, x, *weights), 3)
                probe_bound += bound_ms(moved[mode], 2 * px * macs[mode])[0]
            del got, want
        del x, weights, main
        torch.cuda.empty_cache()
    log(f"time fused-kernel probe, the six variants at res2_1 B=8: kernels "
        f"{ms:.4f} ms, plain versions {plain_ms:.4f} ms")
    # at res2_1 every variant is bound by its bytes; no one PyTorch call
    # computes the six variants (the tool's cudnn mode is `full` alone)
    kernels["fused_kernel_probe"].update(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                         bound_ms=probe_bound, bound_by="bytes",
                                         library_ms=None)

    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(8, 200, 336, 256, generator=g, device=dev).to(torch.bfloat16)
    worst = 0.0
    for th, n in ((40, 1), (40, 2), (40, 4), (40, 8), (8, 3), (33, 5)):
        got, want = dma_streams(x, th, n), reference_dma_streams(x, th)
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-12)).max())
        worst = max(worst, float((got - want).abs().max()))
        log(f"dma streams th={th} N={n}: {tuple(got.shape)} tokens, max rel err {rel:.3e}")
        if not rel <= DMA_RTOL:
            raise AssertionError(f"dma streams th={th} N={n}: rel err {rel}")
    kernels["dma_streams_probe"].update(
        max_abs_err=worst, ms=cuda_ms(lambda: dma_streams(x, 40, 1), 10),
        plain_ms=cuda_ms(lambda: reference_dma_streams(x, 40), 10), library_ms=None)
    set_bound(kernels["dma_streams_probe"], nbytes(x, dma_streams(x, 40, 1)), 0)
    # the kernel reads every byte of x; reference_dma_streams only the
    # tokens' elements, so a plain full read is the like-for-like time
    full_read_ms = cuda_ms(lambda: torch.sum(x, dtype=torch.float32), 10)
    gb = x.numel() * x.element_size() / 1e9
    log(f"time dma streams B=8 th=40 N=1: kernel {kernels['dma_streams_probe']['ms']:.4f} ms "
        f"({gb / kernels['dma_streams_probe']['ms'] * 1e3:.0f} GB/s), "
        f"reference_dma_streams {kernels['dma_streams_probe']['plain_ms']:.4f} ms, "
        f"plain full read (torch.sum) {full_read_ms:.4f} ms ({gb / full_read_ms * 1e3:.0f} GB/s)")
    for mode in ("blocked", "chunked"):
        for th in (1, 7, 32, 200):
            if not torch.equal(bw_copy(x, th, mode), reference_copy(x)):
                raise AssertionError(f"bw copy {mode} th={th} != x * 0.5")
    log("bw copy blocked/chunked at th 1, 7, 32, 200: bit-exact with x * 0.5")
    # the copy beside x * 0.5, in turns, at the tool's th values
    for batch in (8, 32):
        xb = x if batch == 8 else torch.randn(
            32, 200, 336, 256, generator=g, device=dev).to(torch.bfloat16)
        gb = 2 * nbytes(xb) / 1e9
        torch_ms = []
        for th in (4, 32, 200):
            t = {}
            for mode in ("torch", "blocked", "chunked", "chunked", "blocked", "torch"):
                fn = (lambda: reference_copy(xb)) if mode == "torch" else \
                    (lambda: bw_copy(xb, th, mode))
                t.setdefault(mode, []).append(cuda_ms(fn, 10))
            t = {k: float(np.mean(v)) for k, v in t.items()}
            torch_ms.append(t["torch"])
            log(f"time bw copy B={batch} th={th}: blocked {t['blocked']:.4f} ms "
                f"({gb / t['blocked'] * 1e3:.0f} GB/s, {t['blocked'] / t['torch']:.3f} x "
                f"torch), chunked {t['chunked']:.4f} ms ({gb / t['chunked'] * 1e3:.0f} GB/s), "
                f"x * 0.5 {t['torch']:.4f} ms ({gb / t['torch'] * 1e3:.0f} GB/s)")
            if batch == 8 and th == 32:
                kernels["bw_probe"].update(max_abs_err=0.0, ms=t["blocked"],
                                           plain_ms=t["torch"], library_ms=t["torch"])
                set_bound(kernels["bw_probe"], 2 * nbytes(xb), 0)
        del xb
    del x
    torch.cuda.empty_cache()

    _build.reset_launch_counts()
    fused_kernel_probe.main(["--batch", "8", "--iters", "3"])
    dma_streams_probe.main(["--batch", "8"])
    bw_probe.main(["--batch", "8"])
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    log(f"probe tools launches at B=8: {counts}")
    for name in PROBE_KERNELS:
        kernels[name]["launches"] = counts[name]
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by its probe tool")


def train_cfg(fused: bool, dtype: str = "bfloat16", yaml: str = FCOS_YAML):
    cfg = flagship_cfg(fused, dtype, yaml)
    cfg.defrost()
    cfg.SOLVER.WARMUP_ITERS = 0      # a test setting: full LR from step 0
    cfg.freeze()
    return cfg


def train_batch(batch: int, seed: int, gt_pad: int = 100, hw=(800, 1344)):
    """uint8 images of ``hw`` and gt_pad integer-pixel boxes per image, of
    which 5-30 are valid."""
    rs = np.random.RandomState(seed)
    h, w = hw
    x1 = rs.randint(0, w - 16, (batch, gt_pad))
    y1 = rs.randint(0, h - 16, (batch, gt_pad))
    x2 = np.minimum(x1 + rs.randint(16, 400, (batch, gt_pad)), w)
    y2 = np.minimum(y1 + rs.randint(16, 400, (batch, gt_pad)), h)
    n_valid = rs.randint(5, 31, batch)
    return {
        "image": rs.randint(0, 256, (batch, h, w, 3)).astype(np.uint8),
        "gt_boxes": np.stack([x1, y1, x2, y2], -1).astype(np.float32),
        "gt_classes": rs.randint(0, 80, (batch, gt_pad)).astype(np.int32),
        "gt_valid": np.arange(gt_pad)[None, :] < n_valid[:, None],
    }


def phase_train(dev, bare):
    """The FCOS train step at full width, entered as a trainer does:
    build_model, build_optimizer, make_train_step, step(batch). Leaves each
    model's last img/s in ``bare``."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.solver import build_optimizer

    gen = torch.Generator().manual_seed(7)
    weights = None
    models = {}
    for key, fused, dtype in (("fused", True, "bfloat16"), ("unfused", False, "bfloat16"),
                              ("fp32", False, "float32")):
        m = build_model(train_cfg(fused, dtype), device=dev, generator=gen)
        if weights is None:
            randomize_frozen_bn(m, gen)
            weights = {k: v.clone() for k, v in m.state_dict().items()}
        else:
            m.load_state_dict(weights)
        models[key] = m

    # (b) one step's gradients, three models from the same weights
    names = ["backbone.bottom_up.res3_1.conv2.weight", "backbone.bottom_up.res4_1.conv2.weight",
             "backbone.bottom_up.res5_1.conv2.weight", "head.cls_tower0.weight"]
    small = train_batch(2, seed=8)
    grads = {}
    for key, m in models.items():
        build_optimizer(train_cfg(key == "fused"), m)     # applies FREEZE_AT
        _build.reset_launch_counts()
        total, _ = m.loss(small)
        total.backward()
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        if key == "fused" and not (counts["fused_stem"] > 0 and counts["fused_bottleneck"] > 0):
            raise AssertionError(f"fused train forward launched {counts}")
        params = dict(m.named_parameters())
        grads[key] = {n: params[n].grad.detach().float().clone() for n in names}
        log(f"train grads {key}: total loss {float(total.detach()):.5f}")
        m.zero_grad(set_to_none=True)
    for n in names:
        gf, gu, g32 = grads["fused"][n], grads["unfused"][n], grads["fp32"][n]
        e_f, e_u = ratio(gf, g32), ratio(gu, g32)
        log(f"grad {n}: max|g| fused {float(gf.abs().max()):.3e}, err ratio vs fp32 "
            f"fused {e_f:.3e}, unfused bf16 {e_u:.3e} (fused <= {GRAD_FACTOR} x unfused)")
        if not (float(gf.abs().max()) > 0 and e_f <= GRAD_FACTOR * e_u):
            raise AssertionError(f"grad {n}: fused err {e_f}, unfused {e_u}")
    del models["fp32"], grads
    torch.cuda.empty_cache()

    # (a), (c), (d): steps on one batch of IMS_PER_BATCH images, the two
    # models in turns; each one's first turn is the TRAIN_STEPS + 1 steps
    # whose loss must fall
    batch_size = train_cfg(True).SOLVER.IMS_PER_BATCH
    batch = train_batch(batch_size, seed=9)
    steps = {}
    for key in ("fused", "unfused"):
        cfg = train_cfg(key == "fused")
        steps[key] = make_train_step(models[key], build_optimizer(cfg, models[key]), cfg)
    train_turns("FCOS", steps, batch, ("cls_loss", "reg_loss", "centerness_loss", "num_pos"),
                bare)


def train_turns(family, steps, batch, part_keys, rates, launches=None):
    """``steps["fused"]`` and ``steps["unfused"]`` (train steps of two models
    from the same weights) on one batch, in turns: each one's first turn is
    the TRAIN_STEPS + 1 steps whose loss must fall and stay finite, its second
    4 more. The fused steps must launch both fused kernels; ``launches``, if
    given, is {key: the kernels a step of that model launches, exactly}.
    Leaves each model's last img/s in ``rates`` and returns {key: peak
    GiB}."""
    from slenderobjdet_torch.ops import _build

    batch_size = batch["image"].shape[0]
    peaks = {}
    for turn, key in enumerate(("fused", "unfused", "fused", "unfused")):
        first = turn < 2
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        totals, times, parts = [], [], []
        for i in range(TRAIN_STEPS + 1 if first else 4):
            t0 = time.perf_counter()
            metrics = steps[key](batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics = {k: float(v) for k, v in metrics.items()}
            if not all(np.isfinite(v) for v in metrics.values()):
                raise AssertionError(f"train {family} {key} step {i}: non-finite {metrics}")
            totals.append(metrics["total_loss"])
            parts.append(" ".join(f"{k} {metrics[k]:.3f}" for k in part_keys))
        counts = _build.launch_counts()
        peaks[key] = torch.cuda.max_memory_allocated() / 2 ** 30
        steady = times[2:] if first else times
        h, w = batch["image"].shape[1:3]
        log(f"train {family} {key} B={batch_size} {h}x{w}: totals "
            f"{[round(t, 4) for t in totals]}; "
            f"{np.mean(steady) * 1e3:.1f} ms/step, {batch_size / np.mean(steady):.2f} "
            f"img/s, peak {peaks[key]:.2f} GiB; launches {counts}")
        log(f"train {family} {key}: first step {parts[0]}; last step {parts[-1]}")
        rates[key] = batch_size / float(np.mean(steady))
        if key == "fused" and not (counts["fused_stem"] > 0 and counts["fused_bottleneck"] > 0):
            raise AssertionError(f"fused train steps launched {counts}")
        if launches is not None:
            want = {k: v * len(times) for k, v in launches[key].items()}
            if {k: v for k, v in counts.items() if v} != want:
                raise AssertionError(f"train {family} {key}: {len(times)} steps launched "
                                     f"{counts}, expected {want}")
        if first and not totals[-1] < totals[0]:
            raise AssertionError(f"train {family} {key}: total {totals[-1]} after "
                                 f"{TRAIN_STEPS} steps is not below step 0's {totals[0]}")
    return peaks


def box_polygon(rs, x1, y1, x2, y2):
    """A quadrilateral inside the box touching its four sides, at points
    drawn from ``rs``: [x, y1], [x2, y], then the same points mirrored
    through the box's centre."""
    cx = x1 + rs.randint(1, max(int(x2 - x1), 2))
    cy = y1 + rs.randint(1, max(int(y2 - y1), 2))
    return [float(v) for v in (cx, y1, x2, cy, x2 - (cx - x1), y2, x1, y2 - (cy - y1))]


def synthetic_dataset(name, tmpdir, n_images=32, seed=10, repeat=1, polygons=False):
    """Register ``name`` in the port's catalogs: dataset dicts that inline
    their images (LOADER_IMAGE_HW and its transpose in turns, so that the
    loader resizes nothing and needs no image decoder) with 3-20
    integer-pixel boxes each, and the COCO json the evaluator reads, written
    under ``tmpdir``. ``repeat`` lists the ``n_images`` again under new ids
    (the arrays are shared). ``polygons`` gives every box a ``box_polygon``
    segmentation, drawn from a generator of its own (the boxes stay those
    of ``seed``). Returns the json's dict."""
    import os

    from slenderobjdet_torch.data import DatasetCatalog, MetadataCatalog

    rs = np.random.RandomState(seed)
    prs = np.random.RandomState(seed + 1000)
    dicts, images, annotations = [], [], []
    for i in range(n_images * repeat):
        if i >= n_images:       # the same image and boxes under a new id
            first = dicts[i % n_images]
            dicts.append({**first, "image_id": i + 1})
            images.append({**images[i % n_images], "id": i + 1,
                           "file_name": f"{i + 1:06d}.png"})
            annotations += [{**a, "id": len(annotations) + j + 1, "image_id": i + 1}
                            for j, a in enumerate(
                                [a for a in annotations if a["image_id"] == first["image_id"]])]
            continue
        h, w = LOADER_IMAGE_HW if i % 2 == 0 else LOADER_IMAGE_HW[::-1]
        n = rs.randint(3, 21)
        x1, y1 = rs.randint(0, w - 16, n), rs.randint(0, h - 16, n)
        x2 = np.minimum(x1 + rs.randint(16, 400, n), w)
        y2 = np.minimum(y1 + rs.randint(16, 400, n), h)
        classes = rs.randint(0, 80, n)
        dicts.append({
            "image": rs.randint(0, 256, (h, w, 3), dtype=np.uint8), "image_id": i + 1,
            "height": h, "width": w,
            "annotations": [{"bbox": [float(a), float(b), float(c), float(d)],
                             "category_id": int(k), "iscrowd": 0}
                            for a, b, c, d, k in zip(x1, y1, x2, y2, classes)]})
        if polygons:
            for a in dicts[-1]["annotations"]:
                a["segmentation"] = [box_polygon(prs, *a["bbox"])]
        images.append({"id": i + 1, "file_name": f"{i + 1:06d}.png", "height": h, "width": w})
        annotations += [{"id": len(annotations) + j + 1, "image_id": i + 1,
                         "category_id": int(k) + 1, "iscrowd": 0,
                         "bbox": [float(a), float(b), float(c - a), float(d - b)],
                         "area": float((c - a) * (d - b))}
                        for j, (a, b, c, d, k) in enumerate(zip(x1, y1, x2, y2, classes))]
    gt = {"images": images, "annotations": annotations,
          "categories": [{"id": k + 1, "name": f"class{k}", "supercategory": "object"}
                         for k in range(80)]}
    json_file = os.path.join(tmpdir, f"{name}.json")
    with open(json_file, "w") as f:
        json.dump(gt, f)
    DatasetCatalog.remove(name)
    DatasetCatalog.register(name, lambda: dicts)
    MetadataCatalog.get(name).set(
        json_file=json_file, evaluator_type="coco",
        thing_dataset_id_to_contiguous_id={k + 1: k for k in range(80)})
    return gt


def states_equal(a, b) -> bool:
    """Nested dicts and lists of tensors and plain values, bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            states_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(states_equal(x, y) for x, y in zip(a, b))
    return a == b


def trainer_args(name, out, *flags, max_iter=8, checkpoint_period=4, yaml=FCOS_YAML,
                 overrides=None):
    """The config of ``yaml``, nothing cut, with the synthetic dataset (its
    test set is ``name + "_test"``), 8 iterations, a checkpoint every 4, and
    phase_train's fused bf16 model; ``overrides`` come last."""
    from pathlib import Path

    import train_net_torch

    opts = {"DATASETS.TRAIN": (name,), "DATASETS.TEST": (name + "_test",),
            "INPUT.MIN_SIZE_TRAIN": (800,), "SOLVER.MAX_ITER": max_iter,
            "SOLVER.CHECKPOINT_PERIOD": checkpoint_period, "SEED": 0, "OUTPUT_DIR": out,
            "MODEL.RESNETS.FUSED_STEM": True, "MODEL.RESNETS.FUSED_BLOCKS": True,
            "TPU.COMPUTE_DTYPE": "bfloat16", **(overrides or {})}
    config = Path(__file__).resolve().parent / yaml
    return train_net_torch.default_argument_parser().parse_args(
        ["--config-file", str(config), *flags] + [str(x) for kv in opts.items() for x in kv])


class TrainerWatch:
    """What ``watched_trainer`` records: a record a train step (``steps``),
    the seconds each batch was waited for (``waits``), the state just after
    every ``resume_or_load(resume=True)`` (``resumed_states``); ``sync_at[0]``
    is the step count before which the card is waited for."""

    def __init__(self):
        self.steps, self.waits, self.resumed_states, self.sync_at = [], [], [], [2]
        self.real_call = None

    def clear(self):
        del self.steps[:], self.waits[:], self.resumed_states[:]


@contextlib.contextmanager
def watched_trainer():
    """Patch the trainer so that every ``train_net_torch.main`` inside records
    into a ``TrainerWatch``; everything is put back on the way out."""
    import copy

    from slenderobjdet_torch.engine import trainer as trainer_mod
    from slenderobjdet_torch.engine.train_loop import TrainStep
    from slenderobjdet_torch.ops import _build

    watch = TrainerWatch()
    steps, waits, resumed_states, sync_at = (watch.steps, watch.waits, watch.resumed_states,
                                             watch.sync_at)
    real_call, real_loader = TrainStep.__call__, trainer_mod.build_detection_train_loader
    real_resume = trainer_mod.BaseTrainer.resume_or_load
    watch.real_call = real_call

    def watched_call(self, batch):
        """One train step, its batch's shapes, its launches and its clock;
        the card is waited for once before step ``sync_at`` (a run's third)
        and once after the last step, so that the steps between are timed
        as the trainer runs them."""
        if self.count == sync_at[0]:
            torch.cuda.synchronize()
        before = _build.launch_counts()
        rec = {"step": self.count, "t0": time.perf_counter(),
               "image": (tuple(batch["image"].shape), str(batch["image"].dtype)),
               "gt": tuple(batch["gt_boxes"].shape)}
        out = real_call(self, batch)
        after = _build.launch_counts()
        rec["launches"] = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        rec["loss"] = out["total_loss"]
        if self.count == self.cfg.SOLVER.MAX_ITER:
            torch.cuda.synchronize()
        rec["t1"] = time.perf_counter()
        steps.append(rec)
        return out

    def timed_loader(cfg, seed=0):
        stream = iter(real_loader(cfg, seed=seed))

        def batches():
            while True:
                t = time.perf_counter()
                batch = next(stream)
                waits.append(time.perf_counter() - t)
                yield batch
        return batches()

    def watched_resume(self, resume=False):
        real_resume(self, resume=resume)
        if resume:      # a copy: the steps that follow update the tensors in place
            resumed_states.append((self.start_iter, self.train_step.count,
                                   copy.deepcopy(self.state())))

    TrainStep.__call__ = watched_call
    trainer_mod.build_detection_train_loader = timed_loader
    trainer_mod.BaseTrainer.resume_or_load = watched_resume
    try:
        yield watch
    finally:
        TrainStep.__call__ = real_call
        trainer_mod.build_detection_train_loader = real_loader
        trainer_mod.BaseTrainer.resume_or_load = real_resume


def phase_trainer(kernels, dev, smi, bare):
    """Train, checkpoint, resume and evaluate through ``train_net_torch.main``."""
    import os
    import tempfile

    import train_net_torch
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.engine.train_loop import TrainStep
    from slenderobjdet_torch.evaluation import COCOEvaluator, native
    from slenderobjdet_torch.evaluation.coco_evaluation import STATS_NAMES
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.solver import build_optimizer

    name = "chip_smoke_synthetic"
    with watched_trainer() as watch:
        steps, waits, resumed_states, sync_at = (watch.steps, watch.waits,
                                                 watch.resumed_states, watch.sync_at)
        real_call = watch.real_call
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
            gt = synthetic_dataset(name, tmp)
            n_test = len(synthetic_dataset(name + "_test", tmp, repeat=4)["images"])
            out = os.path.join(tmp, "output")
            n_test_batches = n_test // 8

            # ---- train 8 iterations, checkpoints at 4 and 8, then evaluate
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            results = train_net_torch.main(trainer_args(name, out))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _build.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"trainer launches, 8 steps and {n_test_batches} test batches: {counts}")
            for k in PREDICT_KERNELS:     # train steps launch two, test batches all three
                kernels[k].setdefault("launches_by_path", {}).update(
                    predict=kernels[k].get("launches"), trainer=counts[k])
                if counts[k] <= 0:
                    raise AssertionError(f"kernel {k} was not launched through the trainer")
            if counts["nms"] != n_test_batches:
                raise AssertionError(f"{counts['nms']} NMS launches for "
                                     f"{n_test_batches} test batches")
            if [r["step"] for r in steps] != list(range(8)):
                raise AssertionError(f"steps taken: {[r['step'] for r in steps]}")
            shapes = set()
            for r in steps:
                shapes.add(r["image"][0])
                if r["image"] not in [((16, *hw, 3), "uint8") for hw in LOADER_SHAPES] \
                        or r["gt"] != (16, 100, 4):
                    raise AssertionError(f"step {r['step']}: batch {r['image']}, gt {r['gt']}")
                if r["launches"] != {"fused_stem": 1, "fused_bottleneck": 13}:
                    raise AssertionError(f"step {r['step']} launched {r['launches']}")
            losses = [float(r["loss"]) for r in steps]
            log(f"trainer batches {sorted(shapes)}, 100 padded gt; every step launched 1 stem "
                f"and 13 bottleneck kernels; total losses {[round(v, 4) for v in losses]}")
            if not all(np.isfinite(v) for v in losses):
                raise AssertionError(f"non-finite loss in {losses}")
            with open(os.path.join(out, "metrics.json")) as f:
                logged = [json.loads(line) for line in f]
            if [r["iteration"] for r in logged] != [0] or not all(
                    np.isfinite(v) for r in logged for v in r.values()):
                raise AssertionError(f"metrics.json: {logged}")
            for fname in ("config.yaml", "model_0000004.pth", "model_0000008.pth",
                          "last_checkpoint"):
                if not os.path.exists(os.path.join(out, fname)):
                    raise AssertionError(f"the trainer did not write {fname}")
            steady = steps[-1]["t1"] - steps[2]["t0"]
            wait = sum(waits[2:8])
            log(f"time trainer ({smi}): steps 2-7 of train_net_torch.main {steady / 6 * 1e3:.1f} "
                f"ms/step, {16 * 6 / steady:.2f} img/s at B=16, 896x1408 and 1408x896 "
                f"(the background save at iteration 4 included); waiting for the loader "
                f"{wait / 6 * 1e3:.2f} ms/step, {wait / steady:.4f} of a step (data_time of the "
                f"first, cold iteration {logged[0]['data_time'] * 1e3:.1f} ms); peak memory "
                f"{peak:.2f} GiB; whole main (build, 8 steps, 2 saves, evaluation) {wall:.1f} s")
            gaps = [(steps[i + 1]["t0"] - steps[i]["t0"]) * 1e3 for i in range(2, 7)]
            log("trainer, host clock from one step's entry to the next, ms (the host runs up "
                "to a step ahead of the card; the save at iteration 4 starts after step 3): "
                + ", ".join(f"{r['step']} {'x'.join(map(str, r['image'][0][1:3]))} {g:.1f}"
                            for r, g in zip(steps[2:7], gaps)))
            steps_2_7 = [r["image"][0][1:3] for r in steps[2:8]]
            timing = results[name + "_test"]["_timing"]
            log(f"time trainer eval ({smi}): {timing['images']} timed images of {n_test}, "
                f"{timing['s_per_img'] * 1e3:.2f} ms/img, "
                f"{1 / timing['s_per_img'] if timing['s_per_img'] else float('nan'):.2f} img/s "
                f"(B=8, both orientations, fetch to the host included, first 5 batches "
                f"not timed)")

            # ---- resume: the state just after resume_or_load is the saved one
            saved = torch.load(os.path.join(out, "model_0000008.pth"), map_location="cpu",
                               weights_only=True)
            first_loss = losses[0]
            del steps[:], waits[:], resumed_states[:]
            sync_at[0] = 10
            train_net_torch.main(trainer_args(name, out, "--resume", max_iter=28,
                                              checkpoint_period=1000))
            start_iter, count, state = resumed_states[0]
            if (start_iter, count) != (8, 8) or not states_equal(state, saved):
                raise AssertionError(f"resume: start_iter {start_iter}, count {count}, state "
                                     f"== saved: {states_equal(state, saved)}")
            resumed = [float(r["loss"]) for r in steps]
            log(f"trainer --resume: starts at iteration 8 with the saved state bit for bit "
                f"({len(saved['model'])} model tensors, {len(saved['optimizer']['state'])} "
                f"momentum buffers); losses of steps 8-27 {[round(v, 4) for v in resumed]} "
                f"(step 8 sees the first run's first batch: {first_loss:.4f} there)")
            if [r["step"] for r in steps] != list(range(8, 28)) \
                    or not all(np.isfinite(resumed)) \
                    or not resumed[0] <= RESUME_FACTOR * first_loss:
                raise AssertionError(f"resumed steps {[r['step'] for r in steps]}, losses "
                                     f"{resumed}, first run's step 0 {first_loss}")
            for r in steps:
                if r["launches"] != {"fused_stem": 1, "fused_bottleneck": 13}:
                    raise AssertionError(f"step {r['step']} launched {r['launches']}")
            quiet = steps[-1]["t1"] - steps[2]["t0"]     # steps 10-27: none of them saves
            quiet_wait = sum(waits[2:20])
            steps_10_27 = [r["image"][0][1:3] for r in steps[2:]]
            log(f"time trainer without a save ({smi}): steps 10-27 of the resumed "
                f"train_net_torch.main {quiet / 18 * 1e3:.1f} ms/step, {16 * 18 / quiet:.2f} "
                f"img/s at B=16 ({sum(hw == LOADER_SHAPES[0] for hw in steps_10_27)} landscape "
                f"and {sum(hw == LOADER_SHAPES[1] for hw in steps_10_27)} portrait batches); "
                f"waiting for the loader {quiet_wait / 18 * 1e3:.2f} ms/step, "
                f"{quiet_wait / quiet:.4f} of a step")

            # ---- evaluate only
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            results = train_net_torch.main(trainer_args(name, out, "--resume", "--eval-only",
                                                        max_iter=28))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _build.launch_counts()
            res = results[name + "_test"]
            missing = [k for k in STATS_NAMES if k not in res["bbox"]]
            ar_keys = ("AR@100", "mAR@100", "AR-small@100", "AR- 0  - 1/5@100", "AR-5/1 - INF@100")
            if missing or not all(k in res["ar"] for k in ar_keys):
                raise AssertionError(f"--eval-only: bbox lacks {missing}; ar {sorted(res['ar'])}")
            want = {"nms": n_test_batches, "fused_stem": n_test_batches,
                    "fused_bottleneck": 13 * n_test_batches}
            if {k: counts[k] for k in want} != want:
                raise AssertionError(f"--eval-only launched {counts}, expected {want}")
            log(f"trainer --eval-only: bbox has all {len(STATS_NAMES)} names, ar has "
                f"{len(res['ar'])} keys; launches {want}; whole main {wall:.1f} s, "
                f"{n_test / wall:.2f} img/s with the model build and the load")

            # ---- the bare step at the loader's two shapes, for what the trainer costs
            TrainStep.__call__ = real_call
            cfg = train_net_torch.setup(trainer_args(name, out))
            model = build_model(cfg, generator=torch.Generator().manual_seed(0))
            step = make_train_step(model, build_optimizer(cfg, model), cfg)
            bare_ms = {}
            for k, hw in enumerate(LOADER_SHAPES):
                batch = train_batch(16, seed=12 + k, hw=hw)
                times = []
                for _ in range(6):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(batch)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                bare_ms[hw] = float(np.mean(times[2:])) * 1e3
            del model, step
            torch.cuda.empty_cache()
            same_mix = float(np.mean([bare_ms[hw] for hw in steps_2_7]))
            quiet_mix = float(np.mean([bare_ms[hw] for hw in steps_10_27]))
            log(f"time bare step ({smi}), make_train_step on one batch, B=16, flags on: "
                + ", ".join(f"{h}x{w} {ms:.1f} ms/step ({16 / ms * 1e3:.2f} img/s)"
                            for (h, w), ms in bare_ms.items())
                + f"; the trainer's steps 2-7 (one of them saves) at the bare step's pace "
                f"{same_mix:.1f} ms/step ({16 / same_mix * 1e3:.2f} img/s), through the trainer "
                f"{steady / 6 * 1e3:.1f} ({16 * 6 / steady:.2f} img/s): "
                f"{steady / 6 * 1e3 / same_mix:.3f} x; its steps 10-27 (no save) at the bare "
                f"step's pace {quiet_mix:.1f} ms/step, through the trainer "
                f"{quiet / 18 * 1e3:.1f} ({16 * 18 / quiet:.2f} img/s): "
                f"{quiet / 18 * 1e3 / quiet_mix:.3f} x; the train "
                f"phase's bare step at 800x1344 {bare.get('fused', float('nan')):.2f} img/s")

            # ---- the evaluator on detections that are right: jittered gt
            rs = np.random.RandomState(11)
            evaluator = COCOEvaluator(name)
            by_image = {}
            for a in gt["annotations"]:
                by_image.setdefault(a["image_id"], []).append(a)
            for image_id, anns in by_image.items():
                boxes = np.array([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                                   a["bbox"][1] + a["bbox"][3]] for a in anns], np.float32)
                boxes += rs.randn(*boxes.shape).astype(np.float32)
                evaluator.process({"image_id": [image_id]}, {
                    "boxes": boxes[None], "scores": rs.rand(1, len(anns)).astype(np.float32),
                    "classes": np.array([[a["category_id"] - 1 for a in anns]]),
                    "valid": np.ones((1, len(anns)), bool)})
            res = evaluator.evaluate()
            log(f"evaluator on jittered ground truth ({native.backend()} matcher): AP "
                f"{res['bbox']['AP']:.2f}, AP50 {res['bbox']['AP50']:.2f}, AR@100 "
                f"{res['ar']['AR@100']:.2f}")
            if not (np.isfinite(res["bbox"]["AP"]) and res["bbox"]["AP"] > 50
                    and res["bbox"]["AP50"] > 90):
                raise AssertionError(f"evaluator: {res['bbox']}")


# ------------------------------------------------------------- RetinaNet
RETINANET_HW = LOADER_SHAPES[0]          # the loader's landscape bucket, 896 x 1408
RETINANET_CLS_BIAS = float(np.log(0.05 / 0.95))   # the logit of SCORE_THRESH_TEST
RETINANET_TRAIN_LR = 2e-4   # the YAML's 0.01 without warm-up gives NaN by step 2


def comparable_retinanet(gen, *models):
    """Make the detections of two roundings of one RetinaNet comparable, as
    ``one_detection_per_class`` does for FCOS. Random weights give nearly
    tied scores, whose order two bf16 programs need not share, and RetinaNet
    cannot be brought to one detection a class (boxes of different anchor
    shapes or levels overlap by less than 0.5 however they are scaled), so
    the NMS is given nothing to decide instead:
    - the bbox_pred filters are 0 and its bias is (0, 0, -12, -12) (and an
      angle delta 0 for the rotated head): every box is its anchor shrunk
      to a point at its centre, an exact function of the anchor, and boxes
      of different cells never overlap;
    - the cls_score bias is -30 for every anchor shape but one, so a cell
      holds one candidate a class and no two boxes of a class overlap: the
      detections are the 100 best scores;
    - the filters are one shared random filter plus a per-channel one a
      fiftieth its size, and class c's bias is -0.25 c, a step far above
      both that and the bf16 noise: near-tied cells may swap places, with near-equal scores,
      but which classes fill the 100 slots is fixed up to the one pair at
      the cut.
    The NMS kernel's suppression is held against the plain version on the
    model's natural candidates before this."""
    head = models[0].head
    w = head.cls_score.weight
    shared = torch.randn(w.shape[1:], generator=gen) * 0.01
    per_channel = torch.randn(w.shape, generator=gen) * 0.0002
    class_bias = torch.full((head.num_anchors, head.num_classes), -30.0)
    class_bias[head.num_anchors // 2] = -0.25 * torch.arange(head.num_classes)
    with torch.no_grad():
        for m in models:
            m.head.bbox_pred.weight.zero_()
            m.head.bbox_pred.bias.copy_(torch.tensor(
                [0.0, 0.0, -12.0, -12.0] + [0.0] * (head.box_dim - 4)).repeat(head.num_anchors))
            m.head.cls_score.weight.copy_(shared + per_channel)
            m.head.cls_score.bias.copy_(class_bias.flatten())


def match_detections(out, ref, batch):
    """(matched, same_box, total, score diffs) over ``batch`` images. Each
    class's detections are paired rank by rank in score; a slot of ``out`` is
    matched when its partner in ``ref`` exists and scores within SCORE_TOL
    (near-tied candidates may swap, and then their scores are near-equal
    too). ``same_box`` counts the slots whose (class, box to 0.01 px) is in
    ``ref`` as well, as multisets."""
    from collections import Counter

    matched = same_box = total = 0
    diffs = []
    for b in range(batch):
        by_class, box_sets = [], []
        for o in (out, ref):
            v = o["valid"][b].cpu().numpy()
            cls = o["classes"][b].cpu().numpy()[v].tolist()
            sc = o["scores"][b].float().cpu().numpy()[v].tolist()
            bx = np.round(o["boxes"][b].float().cpu().numpy()[v], 2)
            scores = {}
            for c, s in zip(cls, sc):
                scores.setdefault(c, []).append(s)
            by_class.append({c: sorted(v, reverse=True) for c, v in scores.items()})
            box_sets.append(Counter((c, tuple(x)) for c, x in zip(cls, bx.tolist())))
        total += sum(len(v) for v in by_class[0].values())
        same_box += sum((box_sets[0] & box_sets[1]).values())
        for c, scores in by_class[0].items():
            for s, r in zip(scores, by_class[1].get(c, [])):
                diffs.append(abs(s - r))
                matched += diffs[-1] <= SCORE_TOL
    return matched, same_box, total, diffs


def phase_retinanet(kernels, dev, smi, models):
    """RetinaNet R-50-FPN's predict path at 896 x 1408: head outputs against
    fp32, the NMS kernel on RetinaNet's own candidates, 3 requests of 8
    images with the launch counts, fused against unfused detections, the
    share of a call spent in each part, and predict img/s."""
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.ops.nms import batched_nms, cuda_batched_nms, launch_nms

    model, plain, ref32 = models
    reqs = requests(3, 8, seed=13, hw=RETINANET_HW)
    check_heads("retinanet", ("logits", "deltas"), reqs[0], dev, model, plain, ref32)

    # ---- move the classifier's bias so that the coarsest level's 99.5th
    # percentile score sits on SCORE_THRESH_TEST: part of its top 1000 then
    # falls under the threshold and the NMS gets a mask that is not all true
    with torch.inference_mode():
        top = model(torch.as_tensor(reqs[0]["image"], device=dev))[0][-1].flatten()
        shift = RETINANET_CLS_BIAS - float(torch.kthvalue(top, int(0.995 * top.numel())).values)
        for m in models:
            classifier(m).bias.add_(shift)
    del top

    # ---- the NMS kernel on this model's candidates: 5 levels x 1000, thr 0.5,
    # the validity mask the score threshold gives
    with torch.inference_mode():
        images = torch.as_tensor(reqs[0]["image"], device=dev)
        boxes, scores, classes, valid, _ = model.candidates(*model(images), RETINANET_HW)
    del images
    thr, max_out = model.nms_thresh, model.max_dets
    if tuple(boxes.shape) != (8, 5000, 4) or (thr, max_out) != (0.5, 100):
        raise AssertionError(f"RetinaNet candidates {tuple(boxes.shape)}, thr {thr}, "
                             f"max_out {max_out}")
    share = float(valid.float().mean())
    got = cuda_batched_nms(boxes, scores, classes, thr, max_out, valid=valid)
    want = batched_nms(boxes, scores, classes, thr, max_out, valid=valid)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"NMS kernel != plain on RetinaNet's candidates: "
                             f"{int((got[0] != want[0]).sum())} indices differ")
    rounds = torch.zeros(8, dtype=torch.int32, device=dev)
    launch_nms(boxes, scores, classes, valid, thr, max_out, rounds=rounds)
    kept = got[1].sum(1).tolist()
    ms = cuda_ms(lambda: launch_nms(boxes, scores, classes, valid, thr, max_out), 50, queued=True)
    call_ms = cuda_ms(lambda: cuda_batched_nms(boxes, scores, classes, thr, max_out, valid=valid),
                      50, queued=True)
    plain_ms = cuda_ms(lambda: batched_nms(boxes, scores, classes, thr, max_out, valid=valid), 3)
    out = (torch.empty(8, 100, dtype=torch.int32), torch.empty(8, 100, dtype=torch.bool))
    b_ms, b_by = bound_ms(nbytes(boxes, scores, classes, valid, *out),
                          sum(kept) * boxes.shape[1] * NMS_OPS_PER_PAIR, PEAK_FP32_FLOPS)
    log(f"nms retinanet ({smi}): kernel == plain at B=8 N=5000 thr 0.5, {share:.3f} of the "
        f"candidates valid, kept an image {min(kept)}-{max(kept)} (sum {sum(kept)}), block-wide "
        f"rounds an image {rounds.tolist()}; kernel alone {ms:.4f} ms, cuda_batched_nms call "
        f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), "
        f"{b_ms / ms:.4f} of bound")
    kernels["nms"]["at_retinanet_B8_N5000_thr0.5"] = {
        "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "max_abs_err": 0.0, "valid_share": share, "kept": sum(kept)}
    del boxes, scores, classes, valid, got, want

    # ---- 3 requests of 8 images through predict, launches counted
    comparable_retinanet(torch.Generator().manual_seed(15), model, plain)
    per_call = []
    outs = []
    for r in reqs:
        _build.reset_launch_counts()
        outs.append(model.predict(r))
        torch.cuda.synchronize()
        per_call.append({k: v for k, v in _build.launch_counts().items() if v})
    log(f"retinanet predict launches a call of B=8 at {RETINANET_HW[0]}x{RETINANET_HW[1]}: "
        f"{per_call}")
    want_counts = {"nms": 1, "fused_stem": 1, "fused_bottleneck": 13}
    if any(c != want_counts for c in per_call):
        raise AssertionError(f"RetinaNet predict launched {per_call}, expected {want_counts}")
    for k in PREDICT_KERNELS:
        kernels[k].setdefault("launches_by_path", {})["retinanet_predict"] = sum(
            c[k] for c in per_call)
    for out in outs:
        check_outputs(out, 8)
    n_valid = sum(int(o["valid"].sum()) for o in outs)
    log(f"retinanet predict: {n_valid} valid detections over 24 images")
    if n_valid <= 0:
        raise AssertionError("no valid detections")

    matched = same_box = total = 0
    diffs = []
    for r, out in zip(reqs, outs):
        ref = plain.predict(r)
        check_outputs(ref, 8)
        if not torch.equal(out["valid"].sum(1), ref["valid"].sum(1)):
            raise AssertionError("valid counts differ between fused and unfused")
        m, sb, t, d = match_detections(out, ref, 8)
        matched, same_box, total, diffs = matched + m, same_box + sb, total + t, diffs + d
    share = matched / max(total, 1)
    log(f"retinanet fused vs unfused detections: {matched}/{total} slots matched by class "
        f"with score diff <= {SCORE_TOL} ({same_box} of them with the same box); score diff "
        f"median {np.median(diffs):.3e}, max {np.max(diffs):.3e}")
    if share < MATCH_MIN:
        raise AssertionError(f"retinanet fused vs unfused: {share:.4f} of slots matched")
    del outs

    # ---- where a predict call goes: backbone + FPN, head, candidates + NMS
    with torch.inference_mode():
        images = torch.as_tensor(reqs[0]["image"], device=dev)
        x = ((images.float() - model.pixel_mean) / model.pixel_std).to(model.dtype)
        x = x.permute(0, 3, 1, 2)
        feats = model.backbone(x)
        feats_l = [feats[f] for f in model.in_features]
        logits_l, regs_l = model.head(feats_l)
        scale = torch.ones(8, device=dev)
        orig = torch.tensor([RETINANET_HW] * 8, dtype=torch.float32, device=dev)
        parts = {
            "backbone": cuda_ms(lambda: model.backbone(x), 5),
            "head": cuda_ms(lambda: model.head(feats_l), 5),
            "postprocess": cuda_ms(lambda: model.postprocess(logits_l, regs_l, RETINANET_HW,
                                                             scale, orig), 5),
        }
        whole = cuda_ms(lambda: model.predict(reqs[0]), 5)
    log(f"time retinanet predict parts ({smi}), B=8 {RETINANET_HW[0]}x{RETINANET_HW[1]} fused, "
        f"device ms: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; whole predict {whole:.3f}; head share of the three parts "
        f"{parts['head'] / sum(parts.values()):.4f}")
    del x, feats, feats_l, logits_l, regs_l, images
    torch.cuda.empty_cache()
    phase_throughput(model, plain, family="RetinaNet", hw=RETINANET_HW)


def phase_retinanet_train(dev, smi):
    """The RetinaNet train step at full width, entered as a trainer does: 11
    steps on one batch of 16 images at 896 x 1408 with 100 padded gt, then 4
    more a model for the rate, flags on and off in turns; WARMUP_ITERS 0 and
    BASE_LR RETINANET_TRAIN_LR."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.solver import build_optimizer

    gen = torch.Generator().manual_seed(17)
    steps, weights = {}, None
    for key in ("fused", "unfused"):
        cfg = train_cfg(key == "fused", yaml=RETINANET_YAML)
        cfg.defrost()
        # a test setting, as WARMUP_ITERS 0 is: random weights under frozen
        # norms drawn away from identity start at a total loss near 13
        cfg.SOLVER.BASE_LR = RETINANET_TRAIN_LR
        cfg.freeze()
        m = build_model(cfg, device=dev, generator=gen)
        if weights is None:
            randomize_frozen_bn(m, gen)
            weights = {k: v.clone() for k, v in m.state_dict().items()}
        else:
            m.load_state_dict(weights)
        steps[key] = make_train_step(m, build_optimizer(cfg, m), cfg)
    batch_size = train_cfg(True, yaml=RETINANET_YAML).SOLVER.IMS_PER_BATCH
    batch = train_batch(batch_size, seed=18, hw=RETINANET_HW)
    rates = {}
    peaks = train_turns("RetinaNet", steps, batch, ("loss_cls", "loss_box_reg", "num_pos"), rates)
    log(f"time retinanet train ({smi}): B={batch_size} {RETINANET_HW[0]}x{RETINANET_HW[1]}, "
        f"100 padded gt: fused {rates['fused']:.2f} img/s, peak {peaks['fused']:.2f} GiB; "
        f"unfused {rates['unfused']:.2f} img/s, peak {peaks['unfused']:.2f} GiB")


def phase_retinanet_trainer(kernels, dev, smi):
    """``train_net_torch.main`` on the RetinaNet YAML (``family_trainer``)."""
    family_trainer(kernels, smi, "retinanet", RETINANET_YAML, 19,
                   {"fused_stem": 1, "fused_bottleneck": 13}, predict_nms=1)


def family_trainer(kernels, smi, family, yaml, seed, step_launches, predict_nms,
                   loss_key="loss_box_reg", overrides=None, polygons=False, rotated=False,
                   batch=16, test_launches=None):
    """``train_net_torch.main`` on ``yaml`` over the synthetic dataset: 4
    iterations with a checkpoint at 2 and the evaluation, then ``--resume``
    to 8 from exactly the saved state, then ``--eval-only``. Every step must
    take ``batch`` images and launch ``step_launches``, and every test batch
    ``test_launches`` (by default 1 stem, 13 bottleneck and ``predict_nms``
    NMS kernels); ``metrics.json`` must log ``loss_key``. A
    model's running statistic (RepPoints' ``loss_normalizer``) rides in the
    checkpoint and must have moved off its initial value. ``polygons``: the
    synthetic annotations carry segmentations (``synthetic_dataset``).
    ``rotated``: the dataset is an rcoco one (``rotated_synthetic_dataset``),
    evaluated by the rotated evaluator (the bbox stats, no AR matrix and no
    results file), and the NMS kernel counted is the rotated one."""
    import os
    import tempfile

    import train_net_torch
    from slenderobjdet_torch.evaluation.coco_evaluation import STATS_NAMES
    from slenderobjdet_torch.ops import _build

    name = f"chip_smoke_{family}"
    with watched_trainer() as watch, \
            tempfile.TemporaryDirectory(prefix=f"chip_smoke_{family}_") as tmp:
        def make(dataset, repeat=1):
            if rotated:
                return rotated_synthetic_dataset(dataset, tmp, seed=seed, repeat=repeat)
            return synthetic_dataset(dataset, tmp, seed=seed, repeat=repeat, polygons=polygons)

        make(name)
        n_test = len(make(name + "_test", repeat=2)["images"])
        nms_key = "rotated_nms" if rotated else "nms"
        if test_launches is None:
            test_launches = {"fused_stem": 1, "fused_bottleneck": 13, nms_key: predict_nms}
        n_test_batches = n_test // 8
        out = os.path.join(tmp, "output")

        def args(*flags, **kw):
            return trainer_args(name, out, *flags, yaml=yaml, overrides=overrides, **kw)

        def check_steps(first, last):
            if [r["step"] for r in watch.steps] != list(range(first, last)):
                raise AssertionError(f"steps taken: {[r['step'] for r in watch.steps]}")
            for r in watch.steps:
                if r["image"] not in [((batch, *hw, 3), "uint8") for hw in LOADER_SHAPES] \
                        or r["gt"] != (batch, 100, 4):
                    raise AssertionError(f"step {r['step']}: batch {r['image']}, gt {r['gt']}")
                if r["launches"] != step_launches:
                    raise AssertionError(f"step {r['step']} launched {r['launches']}")
            losses = [float(r["loss"]) for r in watch.steps]
            if not all(np.isfinite(v) for v in losses):
                raise AssertionError(f"non-finite loss in {losses}")
            return losses

        # ---- train 4 iterations, checkpoints at 2 and 4, then evaluate
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        results = train_net_torch.main(args(max_iter=4, checkpoint_period=2))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses = check_steps(0, 4)
        want = {k: 4 * v for k, v in step_launches.items()}
        for k, v in test_launches.items():
            want[k] = want.get(k, 0) + v * n_test_batches
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"{family} trainer launched {counts}, expected {want}")
        for k in want:
            kernels[k].setdefault("launches_by_path", {})[f"{family}_trainer"] = counts[k]
        for fname in ("config.yaml", "metrics.json", "model_0000002.pth", "model_0000004.pth",
                      "last_checkpoint") + (() if rotated else ("coco_instances_results.json",)):
            if not os.path.exists(os.path.join(out, fname)):
                raise AssertionError(f"the trainer did not write {fname}")
        with open(os.path.join(out, "metrics.json")) as f:
            logged = [json.loads(line) for line in f]
        if [r["iteration"] for r in logged] != [0] or not all(
                np.isfinite(v) for r in logged for v in r.values()) \
                or loss_key not in logged[0]:
            raise AssertionError(f"metrics.json: {logged}")
        timing = results[name + "_test"]["_timing"]
        log(f"{family} trainer: 4 steps and {n_test_batches} test batches launched {counts}; "
            f"every step {step_launches}, every test batch {test_launches}; total "
            f"losses {[round(v, 4) for v in losses]}; peak memory {peak:.2f} GiB; whole main "
            f"(build, 4 steps, 2 saves, evaluation) {wall:.1f} s")
        log(f"time {family} trainer eval ({smi}): {timing['images']} timed images of {n_test}, "
            f"{timing['s_per_img'] * 1e3:.2f} ms/img, "
            f"{1 / timing['s_per_img'] if timing['s_per_img'] else float('nan'):.2f} img/s "
            f"(B=8, both orientations, fetch to the host included, first 5 batches not timed)")

        # ---- resume: the state just after resume_or_load is the saved one
        saved = torch.load(os.path.join(out, "model_0000004.pth"), map_location="cpu",
                           weights_only=True)
        if "loss_normalizer" in saved["model"]:
            from slenderobjdet_torch.models.meta_arch.reppoints import RepPointsDetector

            normalizer = float(saved["model"]["loss_normalizer"])
            log(f"{family} trainer: the checkpoint holds loss_normalizer {normalizer!r}")
            if normalizer == RepPointsDetector.loss_normalizer_init:
                raise AssertionError("the saved loss_normalizer never moved")
        watch.clear()
        watch.sync_at[0] = 6
        train_net_torch.main(args("--resume", max_iter=8, checkpoint_period=1000))
        start_iter, count, state = watch.resumed_states[0]
        if (start_iter, count) != (4, 4) or not states_equal(state, saved):
            raise AssertionError(f"resume: start_iter {start_iter}, count {count}, state "
                                 f"== saved: {states_equal(state, saved)}")
        resumed = check_steps(4, 8)
        span = watch.steps[-1]["t1"] - watch.steps[2]["t0"]
        log(f"{family} trainer --resume: starts at iteration 4 with the saved state bit for "
            f"bit ({len(saved['model'])} model tensors, {len(saved['optimizer']['state'])} "
            f"momentum buffers); losses of steps 4-7 {[round(v, 4) for v in resumed]}; steps "
            f"6-7 through the trainer {span / 2 * 1e3:.1f} ms/step, {batch * 2 / span:.2f} img/s")

        # ---- evaluate only
        _build.reset_launch_counts()
        results = train_net_torch.main(args("--resume", "--eval-only", max_iter=8))
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        res = results[name + "_test"]
        missing = [k for k in STATS_NAMES if k not in res["bbox"]]
        if missing or not (rotated or "AR@100" in res["ar"]):
            raise AssertionError(f"--eval-only: bbox lacks {missing}; ar {sorted(res.get('ar', {}))}")
        want = {k: v * n_test_batches for k, v in test_launches.items()}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"--eval-only launched {counts}, expected {want}")
        timing = res["_timing"]
        log(f"{family} trainer --eval-only ({smi}): bbox has all {len(STATS_NAMES)} names "
            f"(AP {res['bbox']['AP']:.4f}), ar has {len(res.get('ar', {}))} keys; launches {want}; "
            f"{1 / timing['s_per_img'] if timing['s_per_img'] else float('nan'):.2f} img/s over "
            f"{timing['images']} timed images")


# ------------------------------------------------------------ Faster R-CNN
RCNN_YAML = "configs/faster/faster_rcnn_R_50_FPN_1x.yaml"
RCNN_HW = LOADER_SHAPES[0]          # the loader's landscape bucket, 896 x 1408
# a test setting, as WARMUP_ITERS 0 is: the random trunk's features are in
# the hundreds, the box head's softmax loss starts above 100, and 2e-4
# without warm-up diverges by step 5 (R-50 at 256x384 on the CPU)
RCNN_TRAIN_LR = 2e-5
RCNN_CLS_STEP = 0.25     # the comparison's class bias step
RCNN_STEP_LAUNCHES = {"fused_stem": 1, "fused_bottleneck": 13, "nms": 1}
RCNN_PREDICT_LAUNCHES = {"fused_stem": 1, "fused_bottleneck": 13, "nms": 2}


def randomize_rcnn(model, gen):
    """FrozenBN buffers away from identity, and the RPN's delta filters a
    hundredth of their draw: the random trunk's features are large enough
    that the drawn deltas throw most boxes off the image, where clipping
    leaves them empty (invalid for the NMS); so scaled, the candidates are
    their anchors moved a little, as a trained RPN's are."""
    randomize_frozen_bn(model, gen)
    with torch.no_grad():
        model.rpn_head.anchor_deltas.weight.mul_(0.01)


def build_rcnn_models(dev):
    """Faster R-CNN R-50-FPN fused in bf16, and the same weights unfused in
    bf16 and in fp32 (``randomize_rcnn``)."""
    from slenderobjdet_torch.models import build_model

    gen = torch.Generator().manual_seed(20)
    model = build_model(flagship_cfg(True, yaml=RCNN_YAML), device=dev, generator=gen)
    randomize_rcnn(model, gen)
    models = [model]
    for dtype in ("bfloat16", "float32"):
        m = build_model(flagship_cfg(False, dtype, yaml=RCNN_YAML), device=dev)
        m.load_state_dict(model.state_dict())
        models.append(m)
    return models


def nms_check(kernels, smi, family, key, boxes, scores, valid, thr, max_out, counts=None,
              classes=None):
    """The NMS kernel on a model's own candidates against the plain
    ``batched_nms``: the RPN's level-aware route (``counts``: one launch over
    rows of (image, level), then the merge of the rows' kept lists) or a
    class-aware call (``classes``: Faster R-CNN's box head, RepPoints) or,
    with neither, a class-agnostic one (the proposal networks; the plain
    ``batched_nms`` with one class). Identical, or it fails; then
    the kernel alone, the whole call and the plain version are timed, beside
    the bound: the bytes of the inputs and outputs, and the reference's work,
    each kept box against every candidate it could suppress (its row's, or
    its image's) at NMS_OPS_PER_PAIR operations in fp32."""
    from slenderobjdet_torch.ops.nms import (batched_nms, cuda_batched_nms, cuda_nms,
                                             launch_nms, level_batched_nms, level_rows)

    B, N = scores.shape
    if counts is not None:
        idxs = torch.cat([torch.full((c,), i, device=boxes.device)
                          for i, c in enumerate(counts)]).expand(B, -1)
        rb, rs, rv, offset, _ = level_rows(boxes, scores, counts, valid)
        row_n = torch.tensor(counts, device=boxes.device).repeat(B)

        def call():
            return level_batched_nms(boxes, scores, counts, thr, max_out, valid=valid)

        def kernel(rounds=None):
            return launch_nms(rb, rs, None, rv, thr, max_out, rounds=rounds, row_offset=offset)
    elif classes is not None:
        idxs = classes
        row_n = torch.full((B,), N, device=boxes.device)

        def call():
            return cuda_batched_nms(boxes, scores, classes, thr, max_out, valid=valid)

        def kernel(rounds=None):
            return launch_nms(boxes, scores, classes, valid, thr, max_out, rounds=rounds)
    else:                       # class-agnostic: the proposal networks
        idxs = torch.zeros((B, N), dtype=torch.int32, device=boxes.device)
        row_n = torch.full((B,), N, device=boxes.device)

        def call():
            return cuda_nms(boxes, scores, thr, max_out, valid=valid)

        def kernel(rounds=None):
            return launch_nms(boxes, scores, None, valid, thr, max_out, rounds=rounds)

    got = call()
    want, plain_ms = timed_once(lambda: batched_nms(boxes, scores, idxs, thr, max_out,
                                                    valid=valid))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"NMS kernel != plain on {family}'s {key} candidates: "
                             f"{int((got[0] != want[0]).sum())} indices differ")
    rounds = torch.zeros(row_n.numel(), dtype=torch.int32, device=boxes.device)
    row_kept = kernel(rounds)[1].sum(1)
    work = int((row_kept * row_n).sum())
    kept = got[1].sum(1).tolist()
    ms = cuda_ms(kernel, 20, queued=True)
    call_ms = cuda_ms(call, 20, queued=True)
    out = (torch.empty(B, max_out, dtype=torch.int32), torch.empty(B, max_out, dtype=torch.bool))
    b_ms, b_by = bound_ms(nbytes(boxes, scores, valid, classes, *out),
                          work * NMS_OPS_PER_PAIR, PEAK_FP32_FLOPS)
    per_image = rounds.view(B, -1)
    share = float(valid.float().mean()) if valid is not None else 1.0
    log(f"nms {family} {key} ({smi}): kernel == plain at B={B} N={N} thr {thr} max_out {max_out} "
        f"({'levels ' + str(list(counts)) if counts else 'classes' if classes is not None else 'class-agnostic'}), "
        f"{share:.3f} valid, kept an "
        f"image {min(kept)}-{max(kept)}; block-wide rounds a row {int(rounds.min())}-"
        f"{int(rounds.max())} (an image: the largest row {per_image.max(1).values.tolist()}, "
        f"sum of its rows {per_image.sum(1).tolist()}); kernel alone {ms:.4f} ms, whole call "
        f"{call_ms:.4f} ms, plain {plain_ms:.2f} ms; bound {b_ms:.4f} ms ({b_by}), "
        f"{b_ms / ms:.4f} of bound")
    kernels["nms"][f"at_{family}_{key}"] = {
        "batch": B, "candidates": N, "max_out": max_out, "thr": thr, "ms": ms,
        "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "max_abs_err": 0.0, "valid_share": share, "kept": sum(kept),
        "rounds_max": int(rounds.max()), "rounds_mean": float(rounds.float().mean())}


def shape_rcnn_classifier(models, feats, props, prop_valid):
    """Make the box head's scores those of a classifier that has learnt a
    little: its filters scaled so that the foreground logits spread by 1 on
    these proposals (drawn, they spread by tens on the random trunk's
    features and every top pair scores 1), class c's bias -RCNN_CLS_STEP *
    c, and the background's bisected so that about half of the top 1000
    (proposal, class) pairs pass the score threshold: the NMS then sees a
    mask that is neither empty nor full."""
    model = models[0]
    layer = model.roi_box.outputs.cls_score
    with torch.no_grad():
        layer.bias.zero_()
        logits = model.roi_box(model.roi_heads.pool(feats, props))[0][..., :-1]
        layer.weight.div_(float(logits[prop_valid].float().std()))
        fg = -RCNN_CLS_STEP * torch.arange(layer.bias.numel() - 1, dtype=torch.float32,
                                           device=layer.bias.device)
        lo, hi = -10.0, 30.0
        for _ in range(24):
            mid = (lo + hi) / 2
            layer.bias.copy_(torch.cat([fg, fg.new_tensor([mid])]))
            share = float(model.roi_heads.candidates(model.roi_box, feats, props,
                                                     prop_valid)[3].float().mean())
            lo, hi = (mid, hi) if share > 0.5 else (lo, mid)
        for m in models[1:]:
            m.roi_box.outputs.cls_score.weight.copy_(layer.weight)
            m.roi_box.outputs.cls_score.bias.copy_(layer.bias)


def comparable_rcnn(*models):
    """Make the detections of two roundings of one Faster R-CNN comparable
    on shared proposals: the bbox_pred filters are 0 and its bias is (0, 0,
    -60, -60) a class (dw / 5 = -12 under BBOX_REG_WEIGHTS (10, 10, 5, 5)),
    so every detection is its proposal shrunk to a point at its centre, the
    same bits in both models, and boxes of different proposals never
    overlap: the class-aware NMS has nothing to decide, and a detection is
    known by (class, box)."""
    with torch.no_grad():
        for m in models:
            pred = m.roi_box.outputs.bbox_pred
            pred.weight.zero_()
            pred.bias.copy_(torch.tensor([0.0, 0.0, -60.0, -60.0]).repeat(pred.bias.numel() // 4))


def match_on_shared_proposals(out, ref, ref_cands, batch, thresh):
    """(matched, swapped, total, score diffs, cut gaps) over ``batch`` images
    of two detection sets from the same proposals (``comparable_rcnn``), a
    detection known by (class, box). A valid slot of ``out`` is matched when
    ``ref`` kept the same detection with a score within SCORE_TOL; it is
    swapped when ``ref`` did not keep it but holds it among the NMS's input
    (``ref_cands``: boxes, scores, classes of its top 1000 pairs) with a
    score within SCORE_TOL, at or below ``ref``'s cut (its lowest kept score
    where its slots are full, else ``thresh``): a near-tie at the top-100 cut
    or at the threshold, the one decision the shaping leaves. ``cut gaps``
    are the swapped slots' distances from that cut."""
    matched = swapped = total = 0
    diffs, gaps = [], []
    for b in range(batch):
        kept = []
        for o in (out, ref):
            v = o["valid"][b].cpu().numpy()
            cls = o["classes"][b].cpu().numpy()[v].tolist()
            sc = o["scores"][b].float().cpu().numpy()[v].tolist()
            bx = o["boxes"][b].float().cpu().numpy()[v].tolist()
            kept.append({(c, tuple(x)): s for c, x, s in zip(cls, bx, sc)})
        mine, theirs = kept
        cands = {(c, tuple(x)): s for x, s, c in zip(
            ref_cands[0][b].float().cpu().numpy().tolist(),
            ref_cands[1][b].float().cpu().numpy().tolist(), ref_cands[2][b].tolist())}
        cut = min(theirs.values()) if len(theirs) == out["valid"].shape[1] else thresh
        for k, s in mine.items():
            total += 1
            if k in theirs:
                diffs.append(abs(s - theirs[k]))
                matched += diffs[-1] <= SCORE_TOL
            elif k in cands and abs(s - cands[k]) <= SCORE_TOL and cands[k] <= cut:
                swapped += 1
                gaps.append(s - cut)
    return matched, swapped, total, diffs, gaps


def check_rcnn_outputs(out, batch, proposals):
    shapes = {"boxes": (batch, 100, 4), "scores": (batch, 100), "classes": (batch, 100),
              "valid": (batch, 100), "proposals": (batch, proposals, 4),
              "proposal_scores": (batch, proposals), "proposal_valid": (batch, proposals)}
    if sorted(out) != sorted(shapes):
        raise AssertionError(f"predict returned {sorted(out)}")
    for k, s in shapes.items():
        if tuple(out[k].shape) != s:
            raise AssertionError(f"{k} shape {tuple(out[k].shape)} != {s}")
    for k in ("boxes", "scores", "proposals", "proposal_scores"):
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"non-finite {k}")


def phase_rcnn(kernels, dev, smi, models):
    """Faster R-CNN R-50-FPN's predict path at 896 x 1408: RPN outputs and
    ROI features against fp32; the NMS kernel on the model's own candidates
    at the RPN's predict shape (B = 8, 4,924 -> 1,000), its training shape
    (B = 16, 8,924 -> 1,000) and the box head's (B = 8, 1,000 in 80 classes
    -> 100); 3 requests of 8 images with the launch counts; fused against
    unfused detections on shared proposals; device ms of each part; predict
    img/s."""
    from slenderobjdet_torch.ops import _build

    model, plain, ref32 = models
    reqs = requests(3, 8, seed=21, hw=RCNN_HW)
    check_heads("rcnn", ("rpn logits", "rpn deltas", "roi features"), reqs[0], dev, model,
                plain, ref32)
    models.pop()
    del ref32
    torch.cuda.empty_cache()
    rpn, roi = model.rpn, model.roi_heads
    anchors, counts = model.rpn_anchors(RCNN_HW)

    def rpn_outputs(images):
        logits_l, deltas_l, feats = model(torch.as_tensor(images, device=dev))
        sizes = torch.tensor([RCNN_HW] * images.shape[0], device=dev)
        return torch.cat(logits_l, 1), torch.cat(deltas_l, 1), feats, sizes

    # ---- the NMS kernel on the RPN's candidates: predict, then train
    with torch.inference_mode():
        for key, images, train in (
                ("rpn_predict_B8", reqs[0]["image"], False),
                ("rpn_train_B16", train_batch(16, seed=22, hw=RCNN_HW)["image"], True)):
            logits, deltas, _, sizes = rpn_outputs(images)
            boxes, scores, wh_ok, _, ks = rpn.candidates(anchors, counts, logits, deltas,
                                                         sizes, train=train)
            want_n = sum(min(rpn.pre_nms_topk[train], c) for c in counts)   # 4,924 / 8,924
            if boxes.shape[1] != want_n or rpn.post_nms_topk[train] != 1000:
                raise AssertionError(f"RPN {key}: {boxes.shape[1]} candidates, levels {ks}")
            nms_check(kernels, smi, "rcnn", key, boxes, scores, wh_ok, rpn.nms_thresh,
                           rpn.post_nms_topk[train], counts=ks)
            del logits, deltas, boxes, scores, wh_ok
        torch.cuda.empty_cache()

        # ---- the box head's candidates, its classifier shaped so that part
        # of them pass the score threshold
        logits, deltas, feats, sizes = rpn_outputs(reqs[0]["image"])
        props, _, prop_valid = rpn.proposals(anchors, counts, logits, deltas, sizes, train=False)
        shape_rcnn_classifier(models, feats, props, prop_valid)
        boxes, scores, classes, valid, _ = roi.candidates(model.roi_box, feats, props, prop_valid)
        nms_check(kernels, smi, "rcnn", "box_head_B8", boxes, scores, valid, roi.nms_thresh,
                       roi.max_dets, classes=classes)
        del logits, deltas, feats, props, boxes, scores, classes, valid

    # ---- 3 requests of 8 images through predict, launches counted
    comparable_rcnn(model, plain)
    per_call, outs = [], []
    for r in reqs:
        _build.reset_launch_counts()
        outs.append(model.predict(r))
        torch.cuda.synchronize()
        per_call.append({k: v for k, v in _build.launch_counts().items() if v})
    log(f"rcnn predict launches a call of B=8 at {RCNN_HW[0]}x{RCNN_HW[1]}: {per_call}")
    if any(c != RCNN_PREDICT_LAUNCHES for c in per_call):
        raise AssertionError(f"Faster R-CNN predict launched {per_call}, expected "
                             f"{RCNN_PREDICT_LAUNCHES}")
    for k in PREDICT_KERNELS:
        kernels[k].setdefault("launches_by_path", {})["rcnn_predict"] = sum(
            c[k] for c in per_call)
    for out in outs:
        check_rcnn_outputs(out, 8, rpn.post_nms_topk[False])
    n_valid = sum(int(o["valid"].sum()) for o in outs)
    n_props = sum(int(o["proposal_valid"].sum()) for o in outs)
    log(f"rcnn predict: {n_valid} valid detections and {n_props} valid proposals over 24 images")
    if n_valid <= 0 or n_props <= 0:
        raise AssertionError("no valid detections or proposals")

    # ---- fused against unfused: the ROI stage on the fused model's
    # proposals (the RPN's top-k and NMS cut over near-tied random
    # objectness, which two bf16 programs need not share), and, reported
    # only, how many proposals the two whole predict calls share
    matched = swapped = total = same_props = 0
    diffs, gaps = [], []
    for r, out in zip(reqs, outs):
        with torch.inference_mode():
            _, _, feats = plain(torch.as_tensor(r["image"], device=dev))
            ref = roi.inference(plain.roi_box, feats, out["proposals"], out["proposal_valid"],
                                torch.as_tensor(r["scale"], device=dev),
                                torch.as_tensor(r["orig_size"], device=dev))
            ref_cands = roi.candidates(plain.roi_box, feats, out["proposals"],
                                       out["proposal_valid"])
            whole = plain.predict(r)
        del feats
        m, e, t, d, g = match_on_shared_proposals(out, ref, ref_cands, 8, roi.score_thresh)
        matched, swapped, total = matched + m, swapped + e, total + t
        diffs, gaps = diffs + d, gaps + g
        for b in range(8):       # within half a pixel in every coordinate
            mine = out["proposals"][b][out["proposal_valid"][b]]
            theirs = whole["proposals"][b][whole["proposal_valid"][b]]
            if len(mine) and len(theirs):
                gap = (mine[:, None] - theirs[None]).abs().amax(-1).amin(1)
                same_props += int((gap <= 0.5).sum())
    share = (matched + swapped) / max(total, 1)
    log(f"rcnn fused vs unfused on shared proposals: {matched}/{total} slots matched by "
        f"(class, box) with score diff <= {SCORE_TOL}, {swapped} more swapped at the "
        f"other's cut (its candidate there within {SCORE_TOL}; above the cut by at most "
        f"{max(gaps, default=0.0):.3e}): {share:.4f}; score diff median "
        f"{np.median(diffs):.3e}, max {np.max(diffs):.3e}; the two whole predict calls "
        f"share {same_props}/{n_props} valid proposals within 0.5 px (reported only)")
    if share < MATCH_MIN:
        raise AssertionError(f"rcnn fused vs unfused: {share:.4f} of slots matched")
    del outs

    # ---- where a predict call goes
    with torch.inference_mode():
        images = torch.as_tensor(reqs[0]["image"], device=dev)
        x = ((images.float() - model.pixel_mean) / model.pixel_std).to(model.dtype)
        x = x.permute(0, 3, 1, 2)
        feats = model.backbone(x)
        rpn_feats = [feats[f] for f in model.rpn_in_features]
        roi_feats = [feats[f] for f in model.roi_in_features]
        logits_l, deltas_l = model.rpn_head(rpn_feats)
        logits, deltas = torch.cat(logits_l, 1), torch.cat(deltas_l, 1)
        sizes = torch.tensor([RCNN_HW] * 8, device=dev)
        props, _, prop_valid = rpn.proposals(anchors, counts, logits, deltas, sizes, train=False)
        pooled = roi.pool(roi_feats, props)
        scale = torch.ones(8, device=dev)
        orig = torch.tensor([RCNN_HW] * 8, dtype=torch.float32, device=dev)
        parts = {
            "backbone + FPN": cuda_ms(lambda: model.backbone(x), 5),
            "RPN head": cuda_ms(lambda: model.rpn_head(rpn_feats), 5),
            "RPN proposals": cuda_ms(lambda: rpn.proposals(anchors, counts, logits, deltas,
                                                           sizes, train=False), 5),
            "pooler": cuda_ms(lambda: roi.pool(roi_feats, props), 5),
            "box head": cuda_ms(lambda: model.roi_box(pooled), 5),
            "ROI inference": cuda_ms(lambda: roi.inference(model.roi_box, roi_feats, props,
                                                           prop_valid, scale, orig), 5),
        }
        whole = cuda_ms(lambda: model.predict(reqs[0]), 5)
    post = parts["ROI inference"] - parts["pooler"] - parts["box head"]
    log(f"time rcnn predict parts ({smi}), B=8 {RCNN_HW[0]}x{RCNN_HW[1]} fused, device ms: "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f" (of which the box postprocess {post:.3f}); whole predict {whole:.3f}")
    kernels["nms"].setdefault("rcnn_predict_parts_ms", {}).update(parts, whole=whole)
    del x, feats, rpn_feats, roi_feats, logits_l, deltas_l, logits, deltas, props, pooled, images
    torch.cuda.empty_cache()
    phase_throughput(model, plain, family="Faster R-CNN", hw=RCNN_HW)


def phase_rcnn_train(kernels, dev, smi):
    """The Faster R-CNN train step at full width, entered as a trainer does:
    11 steps on one batch of 16 images at 896 x 1408 with 100 padded gt,
    then 4 more a model, flags on and off in turns, each step launching
    exactly 1 stem, 13 bottleneck and 1 NMS (flags off: the NMS); WARMUP_ITERS
    0 and BASE_LR RCNN_TRAIN_LR. Then the pooler alone at the step's shape
    (16 x 512 RoIs): forward, and forward with the feature gradient."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.solver import build_optimizer

    gen = torch.Generator().manual_seed(23)
    steps, weights = {}, None
    for key in ("fused", "unfused"):
        cfg = train_cfg(key == "fused", yaml=RCNN_YAML)
        cfg.defrost()
        cfg.SOLVER.BASE_LR = RCNN_TRAIN_LR
        cfg.freeze()
        m = build_model(cfg, device=dev, generator=gen)
        if weights is None:
            randomize_rcnn(m, gen)
            weights = {k: v.clone() for k, v in m.state_dict().items()}
        else:
            m.load_state_dict(weights)
        steps[key] = make_train_step(m, build_optimizer(cfg, m), cfg)
    del weights
    batch_size = train_cfg(True, yaml=RCNN_YAML).SOLVER.IMS_PER_BATCH
    batch = train_batch(batch_size, seed=24, hw=RCNN_HW)
    rates = {}
    peaks = train_turns("Faster R-CNN", steps, batch,
                        ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "num_fg"),
                        rates, launches={"fused": RCNN_STEP_LAUNCHES, "unfused": {"nms": 1}})
    for k in PREDICT_KERNELS:
        kernels[k].setdefault("launches_by_path", {})["rcnn_train_step"] = \
            RCNN_STEP_LAUNCHES[k]
    log(f"time rcnn train ({smi}): B={batch_size} {RCNN_HW[0]}x{RCNN_HW[1]}, 100 padded gt: "
        f"fused {rates['fused']:.2f} img/s, peak {peaks['fused']:.2f} GiB; unfused "
        f"{rates['unfused']:.2f} img/s, peak {peaks['unfused']:.2f} GiB")

    # ---- the pooler alone at the train step's shape
    model = steps["fused"].model
    del steps
    torch.cuda.empty_cache()
    roi = model.roi_heads
    with torch.no_grad():
        logits_l, deltas_l, feats = model(torch.as_tensor(batch["image"], device=dev))
        anchors, counts = model.rpn_anchors(RCNN_HW)
        sizes = torch.tensor([RCNN_HW] * batch_size, device=dev)
        props = model.rpn.proposals(anchors, counts, torch.cat(logits_l, 1),
                                    torch.cat(deltas_l, 1), sizes, train=True)[0]
    rois = props[:, :roi.batch_size_per_image].contiguous()
    feats = [f.detach().requires_grad_() for f in feats]
    grad = torch.randn(batch_size, rois.shape[1], roi.pooler_resolution,
                       roi.pooler_resolution, feats[0].shape[1], device=dev)

    def forward_backward():
        torch.autograd.grad(roi.pool(feats, rois), feats, grad_outputs=grad)

    fwd = cuda_ms(lambda: roi.pool(feats, rois), 5)
    both = cuda_ms(forward_backward, 5)
    log(f"time rcnn pooler ({smi}): {batch_size} x {rois.shape[1]} RoIs over "
        f"{[tuple(f.shape[2:]) for f in feats]}, bf16 features: forward {fwd:.3f} ms, forward "
        f"+ feature gradient {both:.3f} ms (backward {both - fwd:.3f}, index_add_ into fp32)")
    kernels["nms"].setdefault("rcnn_train_pooler_ms", {}).update(forward=fwd, backward=both - fwd)


def phase_rcnn_trainer(kernels, dev, smi):
    """``train_net_torch.main`` on the Faster R-CNN YAML (``family_trainer``):
    1 NMS a step (the RPN's), 2 a test batch."""
    family_trainer(kernels, smi, "rcnn", RCNN_YAML, 25, RCNN_STEP_LAUNCHES, predict_nms=2)



# ------------------------------------------------------------- RepPoints
REPPOINTS_YAML = "configs/rep-points/rep_points_detector_R_50_FPN_1x.yaml"
REPPOINTS_HW = LOADER_SHAPES[0]       # the loader's landscape bucket, 896 x 1408
# a test setting, as WARMUP_ITERS 0 is: the focal loss sums over 420,112
# points x 80 classes a batch of 16 at 896 x 1408, so its gradient is ~60 x
# that of the 2 x 320 x 512 batch on which the CPU found the loss falling
# over 10 steps from 4e-5 to 3e-4 (diverging at 1e-3) with the shaped
# classifier; 2e-6 is the middle of that range scaled down
REPPOINTS_TRAIN_LR = 2e-6
REPPOINTS_STEP_LAUNCHES = {"fused_stem": 1, "fused_bottleneck": 13}
REPPOINTS_PREDICT_LAUNCHES = {"fused_stem": 1, "fused_bottleneck": 13, "nms": 1}
DEFORM_P3 = (8, 112, 176, 9, 512)      # B, H, W, K, 2C: the head's shared gather at P3
# (label, yaml, overrides, fused bottleneck wrappers a call): the DCN options
# and the point-set names beside RepPointsDetector
REPPOINTS_VARIANTS = (
    ("RepPointsCenterness", "configs/rep-points/rep_points_centerness_R_50_FPN_1x.yaml", {}, 13),
    ("RepPointsV2", "configs/rep-points/reppointsv2_R_50_FPN_1x.yaml", {}, 13),
    ("FCOSRepPoints", REPPOINTS_YAML, {"MODEL.META_ARCHITECTURE": "FCOSRepPoints"}, 13),
    ("ReppointsRetinaNet", "configs/group_exp_for_backbone/rep-points/base.yaml", {}, 13),
    ("DeformableConvRetinaNet", "configs/retina/retinanet_dc_R_50_FPN_1x.yaml", {}, 13),
    ("FCOS USE_DCN_IN_TOWER v2", "configs/fcos/fcos_R_50_FPN_2x_dcnv2.yaml", {}, 13),
    # STRIDE_IN_1X1: every res3-res5 block's conv2 has stride 1 and deforms
    ("RetinaNet DEFORM_ON_PER_STAGE [F, T, T, T]", RETINANET_YAML,
     {"MODEL.RESNETS.DEFORM_ON_PER_STAGE": [False, True, True, True]}, 3),
)


def comparable_reppoints(gen, feats_of, *models):
    """Make the detections of two roundings of one RepPoints comparable, as
    ``comparable_retinanet`` does for RetinaNet: the NMS is given nothing to
    decide, and a detection is known by (class, box).
    - ``offsets_init_out`` and ``offsets_refine_out`` have zero filters and a
      bias of the kernel grid x 0.3 + 0.35 (and 0): every point set, so every
      box, is the same bits in both models and an exact function of its
      point; the boxes (0.6 point strides wide) of two points never overlap
      by IoU 0.5 and stay inside the image; the deform convs sample at those
      fixed fractional offsets;
    - ``logits_out``'s filters are one shared random filter, scaled so that
      the logits of ``feats_of``'s images spread by 0.3, plus a per-class
      one a fiftieth its size, and class c's bias is -3 - 0.25 c: which
      classes fill the 100 slots is fixed up to near-ties at the cut, and
      the two roundings' scores differ by a few 1e-3 (by 6e-3 in the median
      and up to 3e-2 at a spread of 1)."""
    from slenderobjdet_torch.ops.deform_conv import kernel_base_offsets

    head = models[0].head
    grid = torch.from_numpy(kernel_base_offsets(3)[:, ::-1].copy()).flatten()   # (x, y) pairs
    w = head.logits_out.weight
    shared = torch.randn(w.shape[1:], generator=gen)
    per_class = torch.randn(w.shape, generator=gen) / 50
    with torch.no_grad():
        for m in models:
            for conv, bias in ((m.head.offsets_init_out, grid * 0.3 + 0.35),
                               (m.head.offsets_refine_out, torch.zeros_like(grid))):
                conv.weight.zero_()
                conv.bias.copy_(bias)
            m.head.logits_out.weight.copy_(shared + per_class)
            m.head.logits_out.bias.zero_()
        logits = torch.cat([lg.flatten() for lg in models[0](feats_of)[0]])
        for m in models:
            m.head.logits_out.weight.mul_(0.3 / float(logits.float().std()))
            m.head.logits_out.bias.copy_(-3.0 - 0.25 * torch.arange(w.shape[0]))


def build_reppoints_models(dev):
    """RepPointsDetector R-50-FPN fused in bf16, and the same weights unfused
    in bf16 and in fp32 (``build_models``), the classifier's bias at the
    logit of SCORE_THRESH_TEST."""
    return build_models(dev, REPPOINTS_YAML, RETINANET_CLS_BIAS)


def deform_op_check(smi, dev):
    """The deformable conv alone at the head's P3 gather (DEFORM_P3): bf16
    forward and backward against the same op in fp32 on the card; the
    sampling, its backward and a deform matmul timed beside their bounds and
    beside ``F.grid_sample`` (the same bilinear, zero-padded sampling in one
    PyTorch call); ``DFConv2d`` at zero offsets against the cuDNN 3x3 conv
    (v1) and half of it (v2) in fp32, and with a random ``offset_conv`` in
    bf16 against fp32."""
    import torch.nn.functional as F

    from slenderobjdet_torch.models.layers import DFConv2d
    from slenderobjdet_torch.ops import deform_conv as dc

    B, H, W, K, C2 = DEFORM_P3
    gen = torch.Generator(device=dev).manual_seed(31)
    feat32 = torch.randn(B, H, W, C2, device=dev, generator=gen)
    # the head's points: the kernel grid plus 1.5 px of spread, fractional,
    # some outside the map
    off = (torch.as_tensor(dc.kernel_base_offsets(3), device=dev)
           + torch.randn(B, H, W, K, 2, device=dev, generator=gen) * 1.5)
    ys = torch.arange(H, device=dev)[None, :, None, None] + off[..., 0]
    xs = torch.arange(W, device=dev)[None, None, :, None] + off[..., 1]
    outside = float(((ys <= -1) | (ys >= H) | (xs <= -1) | (xs >= W)).float().mean())
    grad = torch.randn(B, H, W, K, C2, device=dev, generator=gen)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        f = feat32.to(dt).detach().requires_grad_(True)
        o = off.clone().requires_grad_(True)
        out = dc.deform_sample_batched(f, o)
        out.backward(grad.to(dt))
        res[dt] = (out.detach().float(), f.grad.float(), o.grad.float())
        del f, o, out
    errs = {name: ratio(a, b) for name, a, b in zip(
        ("samples", "feature grad", "offset grad"), res[torch.bfloat16], res[torch.float32])}
    del res
    log(f"deform op bf16 vs fp32 at B={B} {H}x{W} K={K} 2C={C2}, {outside:.3f} of the samples "
        f"fully outside: err ratio " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (<= {BF16_TOL}; the feature grad sums in fp32, the JAX scatter in bf16)")
    if any(v > BF16_TOL for v in errs.values()):
        raise AssertionError(f"deform op bf16 vs fp32: {errs}")

    # ---- the same sampling by F.grid_sample (NCHW, the (x, y) grid
    # normalised with align_corners, zero padding) must agree with it in
    # fp32; in bf16 its grid is bf16 too (0.3 px apart at W = 176), so it is
    # only timed there
    grid = torch.stack([xs / (W - 1) * 2 - 1, ys / (H - 1) * 2 - 1], -1).reshape(B, H, W * K, 2)

    def grid_sample(f):
        nchw = f.permute(0, 3, 1, 2)
        return F.grid_sample(nchw, grid.to(f.dtype), mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    with torch.no_grad():
        lib_err = ratio(grid_sample(feat32).permute(0, 2, 3, 1).reshape(B, H, W, K, C2),
                        dc.deform_sample_batched(feat32, off))
    if lib_err > FP32_TOL:
        raise AssertionError(f"deform sampling vs F.grid_sample in fp32: {lib_err}")

    # ---- times: the sampling (forward, backward), a deform matmul, and
    # F.grid_sample
    feat = feat32.to(torch.bfloat16)
    del feat32
    samples = dc.deform_sample_batched(feat, off)
    fwd_ms = cuda_ms(lambda: dc.deform_sample_batched(feat, off), 5)
    lib_ms = cuda_ms(lambda: grid_sample(feat), 5)
    f = feat.detach().requires_grad_(True)
    o = off.detach().requires_grad_(True)
    g = grad.to(torch.bfloat16)
    del grad

    def forward_backward():
        torch.autograd.grad(dc.deform_sample_batched(f, o), (f, o), grad_outputs=g)

    both_ms = cuda_ms(forward_backward, 3)
    weight = torch.randn(K, C2 // 2, C2 // 2, device=dev) * 0.01
    half = samples[..., :C2 // 2]
    mm_ms = cuda_ms(lambda: dc.deform_apply(half, weight), 5)
    n_samples = B * H * W * K
    s_bound, s_by = bound_ms(nbytes(feat, off, samples), n_samples * C2 * 8, PEAK_FP32_FLOPS)
    b_bound, b_by = bound_ms(nbytes(feat, off, g) + nbytes(feat, off),
                             n_samples * C2 * 16, PEAK_FP32_FLOPS)
    mm_flops = 2 * B * H * W * K * (C2 // 2) ** 2
    m_bound, m_by = bound_ms(nbytes(half, weight) + B * H * W * (C2 // 2) * 2, mm_flops)
    log(f"time deform op ({smi}), bf16 at B={B} {H}x{W} K={K} 2C={C2}: sampling forward "
        f"{fwd_ms:.3f} ms (bound {s_bound:.3f} ms by {s_by}, {s_bound / fwd_ms:.3f} of it; "
        f"F.grid_sample of the same samples {lib_ms:.3f} ms, agreeing in fp32 to "
        f"{lib_err:.2e}); "
        f"forward + backward {both_ms:.3f} ms (bound {b_bound:.3f} ms by {b_by}); one deform "
        f"matmul (B*H*W, {K * C2 // 2}) @ ({K * C2 // 2}, {C2 // 2}) with its slice copy "
        f"{mm_ms:.3f} ms ({mm_flops / mm_ms / 1e9:.1f} TFLOP/s; bound {m_bound:.3f} ms by "
        f"{m_by})")
    del samples, half, f, o, g, grid, feat, off, ys, xs
    torch.cuda.empty_cache()

    # ---- DFConv2d: zero offsets against cuDNN (fp32), random offsets bf16
    # against fp32
    x = torch.randn(B, C2 // 2, H, W, device=dev, generator=gen).contiguous(
        memory_format=torch.channels_last)
    for modulated in (False, True):
        layer = DFConv2d(C2 // 2, C2 // 2, modulated=modulated).to(dev)
        with torch.no_grad():
            layer.weight.normal_(0.0, 0.01, generator=gen)
            layer.bias.normal_(0.0, 0.1, generator=gen)
            got = layer(x)
            w = layer.weight.permute(2, 1, 0).reshape(C2 // 2, C2 // 2, 3, 3)
            want = F.conv2d(x, w, layer.bias, padding=1)
            if modulated:
                want = F.conv2d(x, w, padding=1) * 0.5 + layer.bias.view(1, -1, 1, 1)
            err0 = ratio(got, want)
            del got, want
            layer.offset_conv.weight.normal_(0.0, 0.005, generator=gen)
            layer.offset_conv.bias.normal_(0.0, 1.5, generator=gen)
            ref = layer(x)
            got = layer(x.to(torch.bfloat16)).float()
            err = ratio(got, ref)
            del got, ref
        log(f"DFConv2d {'v2' if modulated else 'v1'} at B={B} {H}x{W} C={C2 // 2}: zero "
            f"offsets vs the cuDNN 3x3 conv{' x 0.5' if modulated else ''} in fp32 err ratio "
            f"{err0:.3e} (<= {FP32_TOL}); random offset_conv, bf16 vs fp32 {err:.3e} "
            f"(<= {BF16_TOL})")
        if err0 > FP32_TOL or err > BF16_TOL:
            raise AssertionError(f"DFConv2d modulated={modulated}: {err0}, {err}")
    del x
    torch.cuda.empty_cache()


def phase_reppoints(kernels, dev, smi, models):
    """RepPointsDetector R-50-FPN's predict path at 896 x 1408: head outputs
    against fp32; the NMS kernel on the model's own 5,000 candidates an
    image; 3 requests of 8 images with the launch counts; fused against
    unfused detections; device ms of each part; the deform op alone; predict
    img/s at B=8 and 32."""
    from slenderobjdet_torch.ops import _build

    model, plain, ref32 = models
    head = model.head
    reqs = requests(3, 8, seed=26, hw=REPPOINTS_HW)
    check_heads("reppoints", ("logits", "init offsets", "refine offsets"), reqs[0], dev,
                model, plain, ref32)
    models.pop()
    del ref32
    torch.cuda.empty_cache()

    # ---- the classifier's bias moved so that the coarsest level's 99.5th
    # percentile score sits on SCORE_THRESH_TEST (as for RetinaNet)
    with torch.inference_mode():
        images = torch.as_tensor(reqs[0]["image"], device=dev)
        logits_l, init_l, refine_l = model(images)
        frac = (init_l[0] % 1).float()
        frac = float(((frac > 0.01) & (frac < 0.99)).float().mean())
        top = logits_l[-1].flatten().float()
        shift = RETINANET_CLS_BIAS - float(torch.kthvalue(top, int(0.995 * top.numel())).values)
        for m in models:
            classifier(m).bias.add_(shift)
        logits_l = model(images)[0]
        boxes, scores, classes, valid = model.candidates(logits_l, refine_l, REPPOINTS_HW)
    log(f"reppoints: {frac:.3f} of P3's init offsets are fractional (the deform convs "
        f"sample between pixels)")
    want_n = sum(min(model.topk_candidates, lg.shape[1] * lg.shape[2]) for lg in logits_l)
    if boxes.shape[1] != want_n or (model.nms_thresh, model.max_dets) != (0.5, 100):
        raise AssertionError(f"RepPoints candidates {tuple(boxes.shape)}, not {want_n}")
    nms_check(kernels, smi, "reppoints", f"B8_N{want_n}", boxes, scores, valid, model.nms_thresh,
              model.max_dets, classes=classes)
    del images, logits_l, init_l, refine_l, boxes, scores, classes, valid, top

    # ---- 3 requests of 8 images through predict, launches counted
    comparable_reppoints(torch.Generator().manual_seed(27),
                         torch.as_tensor(reqs[0]["image"], device=dev), model, plain)
    per_call, outs = [], []
    for r in reqs:
        _build.reset_launch_counts()
        outs.append(model.predict(r))
        torch.cuda.synchronize()
        per_call.append({k: v for k, v in _build.launch_counts().items() if v})
    log(f"reppoints predict launches a call of B=8 at {REPPOINTS_HW[0]}x{REPPOINTS_HW[1]}: "
        f"{per_call}")
    if any(c != REPPOINTS_PREDICT_LAUNCHES for c in per_call):
        raise AssertionError(f"RepPoints predict launched {per_call}, expected "
                             f"{REPPOINTS_PREDICT_LAUNCHES}")
    for k in PREDICT_KERNELS:
        kernels[k].setdefault("launches_by_path", {})["reppoints_predict"] = sum(
            c[k] for c in per_call)
    for out in outs:
        check_outputs(out, 8)
    n_valid = sum(int(o["valid"].sum()) for o in outs)
    log(f"reppoints predict: {n_valid} valid detections over 24 images")
    if n_valid <= 0:
        raise AssertionError("no valid detections")

    # ---- fused against unfused: a detection is known by (class, box); a
    # slot the other did not keep is excused only as a near-tie at its cut
    matched = swapped = total = 0
    diffs, gaps = [], []
    for r, out in zip(reqs, outs):
        with torch.inference_mode():
            ref = plain.predict(r)
            outputs = plain(torch.as_tensor(r["image"], device=dev))
            ref_cands = plain.candidates(plain.score_logits(outputs), outputs[2], REPPOINTS_HW)
        check_outputs(ref, 8)
        m, e, t, d, g = match_on_shared_proposals(out, ref, ref_cands, 8, model.score_thresh)
        matched, swapped, total = matched + m, swapped + e, total + t
        diffs, gaps = diffs + d, gaps + g
        del outputs, ref_cands
    share = (matched + swapped) / max(total, 1)
    log(f"reppoints fused vs unfused: {matched}/{total} slots matched by (class, box) with "
        f"score diff <= {SCORE_TOL}, {swapped} more swapped at the other's cut (its "
        f"candidate there within {SCORE_TOL}; above the cut by at most "
        f"{max(gaps, default=0.0):.3e}): {share:.4f}; score diff median "
        f"{np.median(diffs):.3e}, max {np.max(diffs):.3e}")
    if share < MATCH_MIN:
        raise AssertionError(f"reppoints fused vs unfused: {share:.4f} of slots matched")
    del outs
    torch.cuda.empty_cache()

    # ---- where a predict call goes
    with torch.inference_mode():
        images = torch.as_tensor(reqs[0]["image"], device=dev)
        x = ((images.float() - model.pixel_mean) / model.pixel_std).to(model.dtype)
        x = x.permute(0, 3, 1, 2)
        feats = model.features(images)
        towers = [head.towers(f) for f in feats]
        offs = [head.init_offsets(rf) for _, rf in towers]
        samples = [head.sample(cf, rf, o) for (cf, rf), o in zip(towers, offs)]
        convs = [head.deform_convs(s) for s in samples]
        logits_l, refine_l = zip(*[head.outputs(dc, dr, o) for (dc, dr), o in zip(convs, offs)])
        logits_l = [lg.flatten(1, 2) for lg in logits_l]
        refine_l = [rf.flatten(1, 2) for rf in refine_l]
        scale = torch.ones(8, device=dev)
        orig = torch.tensor([REPPOINTS_HW] * 8, dtype=torch.float32, device=dev)
        parts = {
            "backbone + FPN": cuda_ms(lambda: model.backbone(x), 5),
            "towers": cuda_ms(lambda: [head.towers(f) for f in feats], 5),
            "offsets_init": cuda_ms(lambda: [head.init_offsets(rf) for _, rf in towers], 5),
            "deform sampling": cuda_ms(lambda: [head.sample(cf, rf, o) for (cf, rf), o
                                                in zip(towers, offs)], 5),
            "deform matmuls": cuda_ms(lambda: [head.deform_convs(s) for s in samples], 5),
            "1x1 outputs": cuda_ms(lambda: [head.outputs(dc, dr, o) for (dc, dr), o
                                            in zip(convs, offs)], 5),
            "postprocess": cuda_ms(lambda: model.postprocess(logits_l, refine_l, REPPOINTS_HW,
                                                             scale, orig), 5),
        }
        whole = cuda_ms(lambda: model.predict(reqs[0]), 5)
    gathered = sum(s.numel() * s.element_size() for s in samples)
    log(f"time reppoints predict parts ({smi}), B=8 {REPPOINTS_HW[0]}x{REPPOINTS_HW[1]} fused, "
        f"device ms: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; whole predict {whole:.3f}; the shared gathers write {gathered / 1e9:.3f} GB "
        f"of samples")
    kernels["nms"].setdefault("reppoints_predict_parts_ms", {}).update(parts, whole=whole)
    del x, feats, towers, offs, samples, convs, logits_l, refine_l, images
    torch.cuda.empty_cache()
    deform_op_check(smi, dev)
    phase_throughput(model, plain, family="RepPoints", hw=REPPOINTS_HW)


def shape_reppoints_classifier(model, images):
    """Scale ``logits_out``'s filters so that the logits spread by 1 on
    ``images`` (about 0.05 as drawn), the bias left at the focal prior: a
    classifier that has learnt a little, as ``shape_rcnn_classifier`` makes
    Faster R-CNN's."""
    with torch.no_grad():
        layer = model.head.logits_out
        bias = layer.bias.clone()
        layer.bias.zero_()
        logits = torch.cat([lg.flatten() for lg in model(images)[0]])
        layer.weight.div_(float(logits.float().std()))
        layer.bias.copy_(bias)


def phase_reppoints_train(kernels, dev, smi):
    """The RepPoints train step at full width: 11 steps on one batch of 16
    images at 896 x 1408 with 100 padded gt, then 4 more a model, flags on
    and off in turns, each fused step launching exactly 1 stem and 13
    bottleneck kernels; WARMUP_ITERS 0, BASE_LR REPPOINTS_TRAIN_LR and the
    classifier shaped (``shape_reppoints_classifier``). The EMA loss
    normaliser must move off its initial 20."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.solver import build_optimizer

    gen = torch.Generator().manual_seed(28)
    batch_size = train_cfg(True, yaml=REPPOINTS_YAML).SOLVER.IMS_PER_BATCH
    batch = train_batch(batch_size, seed=29, hw=REPPOINTS_HW)
    steps, weights = {}, None
    for key in ("fused", "unfused"):
        cfg = train_cfg(key == "fused", yaml=REPPOINTS_YAML)
        cfg.defrost()
        cfg.SOLVER.BASE_LR = REPPOINTS_TRAIN_LR
        cfg.freeze()
        m = build_model(cfg, device=dev, generator=gen)
        if weights is None:
            randomize_frozen_bn(m, gen)
            shape_reppoints_classifier(m, torch.as_tensor(batch["image"][:2], device=dev))
            weights = {k: v.clone() for k, v in m.state_dict().items()}
        else:
            m.load_state_dict(weights)
        steps[key] = make_train_step(m, build_optimizer(cfg, m), cfg)
    del weights
    rates = {}
    peaks = train_turns("RepPoints", steps, batch,
                        ("loss_cls", "loss_localization_init", "loss_localization_refine",
                         "num_pos", "loss_normalizer"),
                        rates, launches={"fused": REPPOINTS_STEP_LAUNCHES, "unfused": {}})
    for k in ("fused_stem", "fused_bottleneck"):
        kernels[k].setdefault("launches_by_path", {})["reppoints_train_step"] = \
            REPPOINTS_STEP_LAUNCHES[k]
    normalizers = {k: float(s.model.loss_normalizer) for k, s in steps.items()}
    log(f"time reppoints train ({smi}): B={batch_size} {REPPOINTS_HW[0]}x{REPPOINTS_HW[1]}, "
        f"100 padded gt: fused {rates['fused']:.2f} img/s, peak {peaks['fused']:.2f} GiB; "
        f"unfused {rates['unfused']:.2f} img/s, peak {peaks['unfused']:.2f} GiB; "
        f"loss_normalizer after 15 steps {normalizers}")
    if any(v == steps["fused"].model.loss_normalizer_init for v in normalizers.values()):
        raise AssertionError(f"the EMA loss normaliser never moved: {normalizers}")


def phase_reppoints_trainer(kernels, dev, smi):
    """``train_net_torch.main`` on the RepPoints YAML (``family_trainer``):
    train with a save, ``--resume`` bit-equal (the loss normaliser
    included), evaluate; 1 NMS a test batch."""
    family_trainer(kernels, smi, "reppoints", REPPOINTS_YAML, 30, REPPOINTS_STEP_LAUNCHES,
                   predict_nms=1, loss_key="loss_localization_refine")


def phase_reppoints_variants(kernels, dev, smi):
    """Each of REPPOINTS_VARIANTS built at full width (bf16, the fused flags
    on, seeded weights): one predict of B=2 at 896 x 1408 with finite outputs
    and exactly 1 stem, the listed bottleneck wrappers and 1 NMS launch; one
    train step of B=2 with 100 padded gt, exactly 1 stem and the listed
    bottleneck launches, and a finite loss."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.solver import build_optimizer

    req = requests(1, 2, seed=32, hw=REPPOINTS_HW)[0]
    batch = train_batch(2, seed=33, hw=REPPOINTS_HW)
    for i, (label, yaml, overrides, blocks) in enumerate(REPPOINTS_VARIANTS):
        cfg = train_cfg(True, yaml=yaml)
        cfg.defrost()
        cfg.merge_from_list([x for kv in overrides.items() for x in kv])
        cfg.SOLVER.BASE_LR = REPPOINTS_TRAIN_LR
        cfg.freeze()
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(40 + i))
        _build.reset_launch_counts()
        out = model.predict(req)
        torch.cuda.synchronize()
        predicted = {k: v for k, v in _build.launch_counts().items() if v}
        check_outputs(out, 2)
        step = make_train_step(model, build_optimizer(cfg, model), cfg)
        _build.reset_launch_counts()
        metrics = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
        stepped = {k: v for k, v in _build.launch_counts().items() if v}
        want_step = {"fused_stem": 1, "fused_bottleneck": blocks}
        log(f"reppoints variant {label} ({type(model).__name__}, {yaml}): predict B=2 launched "
            f"{predicted}, {int(out['valid'].sum())} valid; train step B=2 launched {stepped}, "
            f"total loss {metrics['total_loss']:.4f}; {time.perf_counter() - t0:.1f} s")
        if predicted != {**want_step, "nms": 1} or stepped != want_step:
            raise AssertionError(f"{label}: predict launched {predicted}, step {stepped}, "
                                 f"expected {blocks} bottleneck wrappers")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{label}: non-finite train metrics {metrics}")
        del model, step, out
        torch.cuda.empty_cache()


# --------------------------------------------------------- the ablation chassis
ABLATION_DIR = "configs/ablation_studies"
ABLATION_HW = LOADER_SHAPES[0]       # the loader's landscape bucket, 896 x 1408
# (label, yaml): the repo's three ablation configs, one head each
ABLATION_YAMLS = (("anchor_empty", f"{ABLATION_DIR}/anchor_empty.yaml"),
                  ("lrtb_unsup", f"{ABLATION_DIR}/lrtb_unsup.yaml"),
                  ("pointset_sup", f"{ABLATION_DIR}/pointset_sup.yaml"))
ABLATION_ADAPTIONS = ("Empty", "Unsupervised Offset", "Split Unsup Offset", "Supervised Offset")
ABLATION_YAML_OF = {"LRTBHead": "lrtb_unsup", "LRTBTopkHead": "lrtb_unsup",
                    "PointSetHead": "pointset_sup", "AnchorHead": "anchor_empty"}
FCOS_TOPK_YAML = "configs/fcos/fcos_topk_R_50_FPN_1x.yaml"
FCOS_ANCHOR_YAML = "configs/fcos_anchor/fcos_anchor_R_50_FPN_1x.yaml"
ABLATION_STEP_LAUNCHES = {"fused_stem": 1, "fused_bottleneck": 13}
ABLATION_PREDICT_LAUNCHES = {"fused_stem": 1, "fused_bottleneck": 13, "nms": 1}
# the RepPoints phases' setting: the same focal loss over 420,112 points x 80
# classes and smooth-L1 over point-set boxes, the classifier shaped
ABLATION_TRAIN_LR = REPPOINTS_TRAIN_LR
DEFORM_P3_FP32 = (8, 112, 176, 9, 256)   # B, H, W, K, C: one adapted conv's gather at P3


def ablation_cells():
    """(label, yaml, overrides) of the 12 head x adaption cells,
    LRTBTopkHead, FCOSTopK and FCOSAnchor."""
    yamls = dict(ABLATION_YAMLS)
    cells = [(f"{head} x {adaption}", yamls[ABLATION_YAML_OF[head]],
              {"MODEL.META_ARCH.NAME": head, "MODEL.META_ARCH.FEAT_ADAPTION": adaption})
             for head in ("LRTBHead", "PointSetHead", "AnchorHead")
             for adaption in ABLATION_ADAPTIONS]
    cells.append(("LRTBTopkHead x Empty", yamls["lrtb_unsup"],
                  {"MODEL.META_ARCH.NAME": "LRTBTopkHead", "MODEL.META_ARCH.FEAT_ADAPTION": "Empty"}))
    return cells + [("FCOSTopK", FCOS_TOPK_YAML, {}), ("FCOSAnchor", FCOS_ANCHOR_YAML, {})]


def ablation_cfg(yaml, overrides, fused=True, dtype="bfloat16", lr=None):
    cfg = train_cfg(fused, dtype, yaml=yaml)
    cfg.defrost()
    cfg.merge_from_list([x for kv in overrides.items() for x in kv])
    if lr is not None:
        cfg.SOLVER.BASE_LR = lr
    cfg.freeze()
    return cfg


def phase_ablation_build(dev, smi, built):
    """Each cell of ``ablation_cells`` built on the card at full width (R-50,
    256-wide heads, 80 classes, bf16, the fused flags on) from a seeded
    generator; the parameter counts are printed. The models are left in
    ``built`` for ``ablation_grid``."""
    from slenderobjdet_torch.models import build_model

    for i, (label, yaml, overrides) in enumerate(ablation_cells()):
        t0 = time.perf_counter()
        model = build_model(ablation_cfg(yaml, overrides, lr=ABLATION_TRAIN_LR), device=dev,
                            generator=torch.Generator().manual_seed(60 + i))
        n = sum(p.numel() for p in model.parameters())
        if any(p.device.type != "cuda" for p in model.parameters()):
            raise AssertionError(f"{label}: a parameter is not on the card")
        log(f"ablation build {label} ({type(model).__name__}, {yaml}): {n:,} parameters, "
            f"{time.perf_counter() - t0:.1f} s")
        built[label] = model


def comparable_ablation(gen, images, *models):
    """Make the detections of two roundings of one ablation detector
    comparable, as ``comparable_reppoints`` does: every box is the same bits
    in both and an exact function of its location, and the NMS is given
    nothing to decide.
    - ``loc_init_out`` and ``loc_refine_out`` have zero filters; LRTB's
      biases are 1 with each level's scales at log(0.3 stride) (ltrb of 0.3
      stride); PointSet's init bias is the kernel grid x 0.3 + 0.35 (the
      refine adds 0); AnchorHead's refine bias is (0, 0, -12, -12) an anchor
      (the anchor shrunk to a point at its centre) and every anchor shape but
      one gets a class bias of -30, so a cell holds one candidate a class;
    - ``cls_out``'s filters are one shared random filter, scaled so that the
      logits of ``images`` spread by 0.3, plus a per-class one a fiftieth its
      size, and class c's bias is -3 - 0.25 c."""
    import math

    from slenderobjdet_torch.ops.deform_conv import kernel_base_offsets

    head, name = models[0].head, models[0].head_name
    A, C = head.num_anchors, head.num_classes
    w = head.cls_out.weight
    shared = torch.randn(w.shape[1:], generator=gen)
    per_class = torch.randn(w.shape, generator=gen) / 50
    class_bias = torch.full((A, C), -30.0)
    class_bias[A // 2] = -3.0 - 0.25 * torch.arange(C)
    with torch.no_grad():
        for m in models:
            h = m.head
            h.loc_init_out.weight.zero_()
            h.loc_refine_out.weight.zero_()
            if name.startswith("LRTB"):
                h.loc_init_out.bias.fill_(1.0)
                h.loc_refine_out.bias.fill_(1.0)
                for i, stride in enumerate(m.strides):
                    getattr(h, f"scale_init{i}").scale.fill_(math.log(0.3 * stride))
                    getattr(h, f"scale_refine{i}").scale.fill_(math.log(0.3 * stride))
            elif name == "PointSetHead":
                grid = torch.from_numpy(kernel_base_offsets(3)[:, ::-1].copy()).flatten()
                h.loc_init_out.bias.copy_(grid * 0.3 + 0.35)
                h.loc_refine_out.bias.zero_()
            else:
                h.loc_init_out.bias.zero_()
                h.loc_refine_out.bias.copy_(torch.tensor([0.0, 0.0, -12.0, -12.0]).repeat(A))
            h.cls_out.weight.copy_(shared + per_class)
            h.cls_out.bias.zero_()
        logits = torch.cat([lg.flatten() for lg in models[0](images)[0]])
        for m in models:
            m.head.cls_out.weight.mul_(0.3 / float(logits.float().std()))
            m.head.cls_out.bias.copy_(class_bias.flatten())


def ablation_parts(model, images, hw):
    """Device ms of each part of a predict call: trunk (normalise, backbone,
    FPN), towers, init branch and offsets, deform sampling, the adapted
    convs' matmuls (``Empty``: the plain 3x3 convs), 1x1 outputs, and the
    postprocess; and the bytes the sampling writes."""
    from slenderobjdet_torch.models.meta_arch.ablation import MetaDeformConv

    head = model.head
    deform = isinstance(head.cls_conv, MetaDeformConv)
    with torch.inference_mode():
        feats = model.features(images)
        towers = [head.towers(f) for f in feats]
        inits = [head.init_loc(lf, i) for i, (_, lf) in enumerate(towers)]
        offs = [head.offsets(lf, li, i) for i, ((_, lf), li) in enumerate(zip(towers, inits))]

        def sample_all():
            return [(head.cls_conv.sample(cf, o[0]), head.loc_refine_conv.sample(lf, o[1]))
                    for (cf, lf), o in zip(towers, offs)]

        samples = sample_all() if deform else None

        def adapt_all():
            if not deform:
                return [head.adapt(cf, lf, o) for (cf, lf), o in zip(towers, offs)]
            return [(head.cls_conv.apply_samples(sc, cf.dtype),
                     head.loc_refine_conv.apply_samples(sl, lf.dtype))
                    for (sc, sl), (cf, lf) in zip(samples, towers)]

        adapted = adapt_all()
        outs = [head.outputs(cf, lf, li, i) for i, ((cf, lf), li) in enumerate(zip(adapted, inits))]
        flat = ([lg.flatten(1, 3).reshape(lg.shape[0], -1, head.num_classes) for lg, _, _ in outs],
                [c.flatten(1) for _, c, _ in outs if c is not None],
                [li.reshape(li.shape[0], -1, head.loc_dim) for li in inits],
                [rf.reshape(rf.shape[0], -1, head.loc_dim) for _, _, rf in outs])
        B = images.shape[0]
        scale = torch.ones(B, device=images.device)
        orig = torch.tensor([hw] * B, dtype=torch.float32, device=images.device)
        x = ((images.float() - model.pixel_mean) / model.pixel_std).to(model.dtype)
        x = x.permute(0, 3, 1, 2)
        parts = {
            "trunk": cuda_ms(lambda: model.backbone(x), 5),
            "towers": cuda_ms(lambda: [head.towers(f) for f in feats], 5),
            "init + offsets": cuda_ms(lambda: [head.offsets(lf, head.init_loc(lf, i), i)
                                               for i, (_, lf) in enumerate(towers)], 5),
            "deform sampling": cuda_ms(sample_all, 3) if deform else 0.0,
            "deform matmuls" if deform else "adapted 3x3 convs": cuda_ms(adapt_all, 5),
            "1x1 outputs": cuda_ms(lambda: [head.outputs(cf, lf, li, i) for i, ((cf, lf), li)
                                            in enumerate(zip(adapted, inits))], 5),
            "postprocess": cuda_ms(lambda: model.postprocess(flat, hw, scale, orig), 5),
        }
        gathered = 0 if not deform else sum(t.numel() * t.element_size()
                                            for pair in samples for t in pair)
    return parts, gathered


def deform_fp32_check(smi, dev):
    """The adapted conv's deform op alone at P3 (DEFORM_P3_FP32), in fp32 as
    the ablation head runs it: the sampling against ``F.grid_sample`` of the
    same samples (within FP32_TOL), then the sampling forward, forward +
    backward, the matmul and ``F.grid_sample`` timed beside their bounds."""
    import torch.nn.functional as F

    from slenderobjdet_torch.ops import deform_conv as dc

    B, H, W, K, C = DEFORM_P3_FP32
    gen = torch.Generator(device=dev).manual_seed(34)
    feat = torch.randn(B, H, W, C, device=dev, generator=gen)
    off = (torch.as_tensor(dc.kernel_base_offsets(3), device=dev)
           + torch.randn(B, H, W, K, 2, device=dev, generator=gen) * 1.5)
    ys = torch.arange(H, device=dev)[None, :, None, None] + off[..., 0]
    xs = torch.arange(W, device=dev)[None, None, :, None] + off[..., 1]
    grid = torch.stack([xs / (W - 1) * 2 - 1, ys / (H - 1) * 2 - 1], -1).reshape(B, H, W * K, 2)
    del ys, xs

    def grid_sample():
        return F.grid_sample(feat.permute(0, 3, 1, 2), grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    with torch.no_grad():
        samples = dc.deform_sample_batched(feat, off)
        lib_err = ratio(grid_sample().permute(0, 2, 3, 1).reshape(B, H, W, K, C), samples)
    if lib_err > FP32_TOL:
        raise AssertionError(f"fp32 deform sampling vs F.grid_sample: {lib_err}")
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: dc.deform_sample_batched(feat, off), 3)
        lib_ms = cuda_ms(grid_sample, 3)
        weight = torch.randn(K, C, C, device=dev, generator=gen) * 0.01
        mm_ms = cuda_ms(lambda: dc.deform_apply(samples, weight), 3)
    f = feat.detach().requires_grad_(True)
    o = off.detach().requires_grad_(True)
    g = torch.randn_like(samples)

    def forward_backward():
        torch.autograd.grad(dc.deform_sample_batched(f, o), (f, o), grad_outputs=g)

    both_ms = cuda_ms(forward_backward, 2)
    n = B * H * W * K
    s_bound, s_by = bound_ms(nbytes(feat, off, samples), n * C * 8, PEAK_FP32_FLOPS)
    b_bound, b_by = bound_ms(2 * nbytes(feat, off) + nbytes(feat, off, g), n * C * 16,
                             PEAK_FP32_FLOPS)
    mm_flops = 2 * B * H * W * K * C * C
    m_bound, m_by = bound_ms(nbytes(samples, weight) + B * H * W * C * 4, mm_flops,
                             PEAK_FP32_FLOPS)
    log(f"time deform op fp32 ({smi}), one adapted conv at P3, B={B} {H}x{W} K={K} C={C}: "
        f"sampling forward {fwd_ms:.3f} ms (bound {s_bound:.3f} ms by {s_by}, "
        f"{s_bound / fwd_ms:.3f} of it; writes {nbytes(samples) / 1e9:.3f} GB); F.grid_sample "
        f"of the same samples {lib_ms:.3f} ms (agreeing to {lib_err:.2e}); forward + backward "
        f"{both_ms:.3f} ms (bound {b_bound:.3f} ms by {b_by}); the matmul (B*H*W, {K * C}) @ "
        f"({K * C}, {C}) in fp32 {mm_ms:.3f} ms ({mm_flops / mm_ms / 1e9:.1f} TFLOP/s; bound "
        f"{m_bound:.3f} ms by {m_by})")
    del feat, off, grid, samples, f, o, g, weight
    torch.cuda.empty_cache()


def phase_ablation(kernels, dev, smi):
    """The ablation chassis's predict path at 896 x 1408 on the repo's three
    yamls (ABLATION_YAMLS), each fused and unfused in bf16 and in fp32 from
    the same seeded weights: head outputs against fp32; the NMS kernel against
    ``batched_nms`` on the head's own candidates (the classifier's bias moved
    so that the coarsest level's 99.5th percentile score sits on the
    threshold), identical; 3 requests of 8 images with exactly 1 stem, 13
    bottleneck and 1 NMS launch each; fused against unfused detections by
    (class, box) on fixed boxes (``comparable_ablation``,
    ``match_on_shared_proposals``); device ms of each part; predict img/s at
    B=8 and 32. Then the fp32 deform op alone (``deform_fp32_check``)."""
    from slenderobjdet_torch.ops import _build

    for i, (label, yaml) in enumerate(ABLATION_YAMLS):
        model, plain, ref32 = build_models(dev, yaml, RETINANET_CLS_BIAS)
        reqs = requests(3, 8, seed=35 + i, hw=ABLATION_HW)
        parts = ("logits", "centerness", "init loc", "refine loc")
        check_heads(f"ablation {label}", parts, reqs[0], dev, model, plain, ref32)
        del ref32
        torch.cuda.empty_cache()

        with torch.inference_mode():
            images = torch.as_tensor(reqs[0]["image"], device=dev)
            top = model(images)[0][-1].flatten().float()
            shift = RETINANET_CLS_BIAS - float(torch.kthvalue(top, int(0.995 * top.numel())).values)
            for m in (model, plain):
                m.head.cls_out.bias.add_(shift)
            outputs = model(images)
            boxes, scores, classes, valid = model.candidates(outputs, ABLATION_HW)
        want_n = sum(min(model.topk_candidates, lg.shape[1] * lg.shape[2]) for lg in outputs[0])
        if boxes.shape[1] != want_n:
            raise AssertionError(f"ablation {label}: {boxes.shape[1]} candidates, not {want_n}")
        nms_check(kernels, smi, f"ablation_{label}", f"B8_N{want_n}", boxes, scores, valid,
                  model.nms_thresh, model.max_dets, classes=classes)
        del outputs, boxes, scores, classes, valid, top

        comparable_ablation(torch.Generator().manual_seed(36 + i), images, model, plain)
        per_call, outs = [], []
        for r in reqs + requests(1, 32, seed=38 + i, hw=ABLATION_HW):
            _build.reset_launch_counts()
            outs.append(model.predict(r))
            torch.cuda.synchronize()
            per_call.append({k: v for k, v in _build.launch_counts().items() if v})
        log(f"ablation {label} predict launches a call (3 of B=8, 1 of B=32) at "
            f"{ABLATION_HW[0]}x{ABLATION_HW[1]}: {per_call}")
        if any(c != ABLATION_PREDICT_LAUNCHES for c in per_call):
            raise AssertionError(f"ablation {label} predict launched {per_call}, expected "
                                 f"{ABLATION_PREDICT_LAUNCHES}")
        for k in PREDICT_KERNELS:
            kernels[k].setdefault("launches_by_path", {})[f"ablation_{label}_predict"] = sum(
                c[k] for c in per_call)
        for out, b in zip(outs, (8, 8, 8, 32)):
            check_outputs(out, b)
        outs = outs[:3]
        n_valid = sum(int(o["valid"].sum()) for o in outs)
        if n_valid <= 0:
            raise AssertionError(f"ablation {label}: no valid detections")

        matched = swapped = total = 0
        diffs, gaps = [], []
        for r, out in zip(reqs, outs):
            with torch.inference_mode():
                ref = plain.predict(r)
                ref_cands = plain.candidates(plain(torch.as_tensor(r["image"], device=dev)),
                                             ABLATION_HW)
            check_outputs(ref, 8)
            m_, e, t, d, g = match_on_shared_proposals(out, ref, ref_cands, 8,
                                                       model.score_thresh)
            matched, swapped, total = matched + m_, swapped + e, total + t
            diffs, gaps = diffs + d, gaps + g
            del ref_cands
        share = (matched + swapped) / max(total, 1)
        log(f"ablation {label} fused vs unfused: {n_valid} valid; {matched}/{total} slots "
            f"matched by (class, box) with score diff <= {SCORE_TOL}, {swapped} more swapped "
            f"at the other's cut (above it by at most {max(gaps, default=0.0):.3e}): "
            f"{share:.4f}; score diff median {np.median(diffs):.3e}, max {np.max(diffs):.3e}")
        if share < MATCH_MIN:
            raise AssertionError(f"ablation {label} fused vs unfused: {share:.4f} matched")
        del outs
        torch.cuda.empty_cache()

        parts, gathered = ablation_parts(model, images, ABLATION_HW)
        whole = cuda_ms(lambda: model.predict(reqs[0]), 3)
        log(f"time ablation {label} predict parts ({smi}), B=8 {ABLATION_HW[0]}x"
            f"{ABLATION_HW[1]} fused, device ms: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                                               parts.items())
            + f"; whole predict {whole:.3f}; the fp32 gathers write {gathered / 1e9:.3f} GB")
        kernels["nms"].setdefault(f"ablation_{label}_predict_parts_ms", {}).update(
            parts, whole=whole)
        del images
        torch.cuda.empty_cache()
        phase_throughput(model, plain, family=f"ablation {label}", hw=ABLATION_HW)
        del model, plain
        torch.cuda.empty_cache()
    deform_fp32_check(smi, dev)


def shape_ablation_classifier(model, images):
    """``shape_reppoints_classifier`` for the ablation head's ``cls_out``."""
    with torch.no_grad():
        layer = model.head.cls_out
        bias = layer.bias.clone()
        layer.bias.zero_()
        logits = torch.cat([lg.flatten() for lg in model(images)[0]])
        layer.weight.div_(float(logits.float().std()))
        layer.bias.copy_(bias)


def phase_ablation_train(kernels, dev, smi):
    """``pointset_sup`` (PointSetHead x Supervised Offset) trained at full
    width: 11 steps on one batch of 16 images at 896 x 1408 with 100 padded
    gt, then 4 more a model, flags on and off in turns, each fused step
    launching exactly 1 stem and 13 bottleneck kernels; WARMUP_ITERS 0,
    BASE_LR ABLATION_TRAIN_LR and the classifier shaped; finite losses
    ending below step 0's; img/s and peak memory."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.solver import build_optimizer

    yaml = dict(ABLATION_YAMLS)["pointset_sup"]
    gen = torch.Generator().manual_seed(39)
    batch_size = train_cfg(True, yaml=yaml).SOLVER.IMS_PER_BATCH
    batch = train_batch(batch_size, seed=40, hw=ABLATION_HW)
    steps, weights = {}, None
    for key in ("fused", "unfused"):
        cfg = ablation_cfg(yaml, {}, fused=key == "fused", lr=ABLATION_TRAIN_LR)
        m = build_model(cfg, device=dev, generator=gen)
        if weights is None:
            randomize_frozen_bn(m, gen)
            shape_ablation_classifier(m, torch.as_tensor(batch["image"][:2], device=dev))
            weights = {k: v.clone() for k, v in m.state_dict().items()}
        else:
            m.load_state_dict(weights)
        steps[key] = make_train_step(m, build_optimizer(cfg, m), cfg)
    del weights
    rates = {}
    peaks = train_turns("ablation pointset_sup", steps, batch,
                        ("loss_cls", "loss_loc_init", "loss_loc_refine", "num_pos"), rates,
                        launches={"fused": ABLATION_STEP_LAUNCHES, "unfused": {}})
    for k in ("fused_stem", "fused_bottleneck"):
        kernels[k].setdefault("launches_by_path", {})["ablation_train_step"] = \
            ABLATION_STEP_LAUNCHES[k]
    log(f"time ablation pointset_sup train ({smi}): B={batch_size} {ABLATION_HW[0]}x"
        f"{ABLATION_HW[1]}, 100 padded gt: fused {rates['fused']:.2f} img/s, peak "
        f"{peaks['fused']:.2f} GiB; unfused {rates['unfused']:.2f} img/s, peak "
        f"{peaks['unfused']:.2f} GiB")


def phase_ablation_trainer(kernels, dev, smi):
    """``train_net_torch.main`` on ``pointset_sup.yaml`` (``family_trainer``):
    train with a save, ``--resume`` bit-equal, evaluate; 1 NMS a test
    batch."""
    family_trainer(kernels, smi, "ablation", dict(ABLATION_YAMLS)["pointset_sup"], 41,
                   ABLATION_STEP_LAUNCHES, predict_nms=1, loss_key="loss_loc_refine")


def phase_ablation_grid(kernels, dev, smi, built):
    """Every model ``ablation_build`` left that ``ablation`` did not drive
    (the other 9 grid cells, LRTBTopkHead, FCOSTopK, FCOSAnchor): one
    predict of B=2 at 896 x 1408 with finite outputs and exactly 1 stem, 13
    bottleneck and 1 NMS launch; one train step of B=2 with 100 padded gt,
    exactly 1 stem and 13 bottleneck launches, and finite losses."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.solver import build_optimizer

    driven = {"AnchorHead x Empty", "LRTBHead x Unsupervised Offset",
              "PointSetHead x Supervised Offset"}
    req = requests(1, 2, seed=42, hw=ABLATION_HW)[0]
    batch = train_batch(2, seed=43, hw=ABLATION_HW)
    cfgs = {label: ablation_cfg(yaml, over, lr=ABLATION_TRAIN_LR)
            for label, yaml, over in ablation_cells()}
    labels = [label for label in cfgs if label not in driven]
    if sorted(built) != sorted(cfgs):
        raise AssertionError(f"ablation_build left {sorted(built)}")
    for label in labels:
        t0 = time.perf_counter()
        model = built.pop(label)
        _build.reset_launch_counts()
        out = model.predict(req)
        torch.cuda.synchronize()
        predicted = {k: v for k, v in _build.launch_counts().items() if v}
        check_outputs(out, 2)
        step = make_train_step(model, build_optimizer(cfgs[label], model), cfgs[label])
        _build.reset_launch_counts()
        metrics = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
        stepped = {k: v for k, v in _build.launch_counts().items() if v}
        log(f"ablation grid {label}: predict B=2 launched {predicted}, "
            f"{int(out['valid'].sum())} valid; train step B=2 launched {stepped}, losses "
            + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
            + f"; {time.perf_counter() - t0:.1f} s")
        if predicted != ABLATION_PREDICT_LAUNCHES or stepped != ABLATION_STEP_LAUNCHES:
            raise AssertionError(f"{label}: predict launched {predicted}, step {stepped}")
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{label}: non-finite train metrics {metrics}")
        for k in PREDICT_KERNELS:
            by_path = kernels[k].setdefault("launches_by_path", {})
            by_path["ablation_grid"] = by_path.get("ablation_grid", 0) + predicted.get(k, 0) \
                + stepped.get(k, 0)
        del model, step, out
        torch.cuda.empty_cache()
    built.clear()


# ---------------------------------------------------------- data parallel
DDP_ITERS = 4               # the NCCL run's iterations (one save, at the last)
DDP_FP32_RTOL = 1e-4        # two ranks' fp32 step vs the joined batch's, of a value
DDP_UPDATE_RTOL = 1e-3      # and of the update (a GN-fed bias sits near 0)
DDP_BF16_STEPS = 5
DDP_AP_TOL = 0.1            # 2-rank evaluation's bbox AP vs the 1-process one
DDP_TIMEOUT_S = 300         # each collective of a spawned group
DDP_JOIN_S = 900            # each spawn, whole


def ddp_setup(name, tmp):
    """What every process of the ddp phase needs first: TF32 off, cuDNN's
    deterministic algorithms (so that two runs of one step agree bit for
    bit), and the synthetic datasets registered (a spawned process starts
    with empty catalogs). Returns the number of test images."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    synthetic_dataset(name, tmp)
    return len(synthetic_dataset(name + "_test", tmp)["images"])


def ddp_trainer_args(name, out, *flags):
    args = trainer_args(name, out, *flags, max_iter=DDP_ITERS, checkpoint_period=DDP_ITERS)
    # random weights score every location under 0.05: no threshold, so that
    # the evaluations have 100 detections an image to compare
    args.opts += ["MODEL.FCOS.INFERENCE_TH", "0.0"]
    return args


def ddp_main(args, name, tmp):
    """``train_net_torch.main`` in this process, watched: its steps'
    launches, losses and clock, its launch counts, peak memory and results
    (host values only, so that a spawned rank can return them)."""
    import train_net_torch
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.parallel import process_count

    ddp_setup(name, tmp)
    with watched_trainer() as watch:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        results = train_net_torch.main(args)
        torch.cuda.synchronize()
        steps = [{"step": r["step"], "launches": r["launches"], "loss": float(r["loss"]),
                  "image": r["image"], "t0": r["t0"], "t1": r["t1"]} for r in watch.steps]
    import torch.distributed as dist

    return {"steps": steps, "counts": _build.launch_counts(), "results": results,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "world": process_count(),
            "backend": dist.get_backend() if dist.is_initialized() else None}


def ddp_joined_batch():
    """The fp32 step's joined batch of 16 at the loader's first shape: one
    valid box in each image of the first half, 30 in each of the second, so
    that the two ranks' positives differ many times over and a rank that
    divided by its own half's count would miss the joined step by far."""
    batch = train_batch(16, seed=31, hw=LOADER_SHAPES[0])
    gt_pad = batch["gt_valid"].shape[1]
    batch["gt_valid"] = np.arange(gt_pad)[None, :] < np.repeat([1, 30], 8)[:, None]
    return batch


def ddp_gloo_rank(ref_path, eval_args, name, tmp):
    """One of two gloo ranks on the one card: (1) one fp32 step, flags off,
    on this rank's 8 rows of the joined 16, held against the single
    process's step (``ref_path``); (2) DDP_BF16_STEPS bf16 steps, flags on,
    their launches, losses and clock; (3) a 129 MB fp32 all-reduce, timed;
    (4) ``--eval-only`` of the NCCL run's checkpoint."""
    import torch.distributed as dist

    import train_net_torch
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.parallel import process_index, state_digest
    from slenderobjdet_torch.solver import build_optimizer

    ddp_setup(name, tmp)
    rank = process_index()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": rank, "backend": dist.get_backend(), "device": str(dev)}

    # (1) fp32, flags off: the joined batch's step
    cfg = train_cfg(False, "float32")
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = make_train_step(model, build_optimizer(cfg, model), cfg)
    metrics = step({k: v[8 * rank: 8 * rank + 8] for k, v in ddp_joined_batch().items()})
    out["fp32_num_pos"] = float(metrics["num_pos"])
    want = torch.load(ref_path, map_location=dev, weights_only=True)
    worst, worst_plain = (0.0, ""), (0.0, "")
    for n, p in model.named_parameters():
        w = want[n].double()
        diff = float((p.detach().double() - w).abs().max())
        allowed = (DDP_FP32_RTOL * float(w.abs().max())
                   + DDP_UPDATE_RTOL * float((w - init[n].double()).abs().max()))
        if diff > 0:
            worst = max(worst, (diff / allowed if allowed > 0 else float("inf"), n))
        worst_plain = max(worst_plain, (diff / (float(w.abs().max()) + 1e-30), n))
    out["fp32_excess"], out["fp32_plain_ratio"] = worst, worst_plain
    out["fp32_digest"] = state_digest(model)
    del model, step, want, init
    torch.cuda.empty_cache()

    # (2) bf16, flags on: DDP_BF16_STEPS steps of 8 rows a rank
    cfg = train_cfg(True)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, build_optimizer(cfg, model), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(DDP_BF16_STEPS):
        batch = train_batch(16, seed=40 + i, hw=LOADER_SHAPES[i % 2])
        batch = {k: v[8 * rank: 8 * rank + 8] for k, v in batch.items()}
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = step(batch)
        loss = float(metrics["total_loss"])      # waits for the card
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
                      "launches": {k: v for k, v in _build.launch_counts().items() if v}})
    out["bf16_steps"] = steps
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["bf16_digest"] = state_digest(model)
    n_grad = sum(p.numel() for p in model.parameters() if p.requires_grad)
    del model, step
    torch.cuda.empty_cache()

    # (3) the gradients' all-reduce alone, as DDP's buckets add up to it
    grads = torch.ones(n_grad, dtype=torch.float32, device=dev)
    for _ in range(2):
        dist.all_reduce(grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        dist.all_reduce(grads)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    out["allreduce_mb"] = grads.numel() * 4 / 1e6
    del grads

    # (4) --eval-only of the NCCL run's checkpoint on both ranks
    _build.reset_launch_counts()
    out["eval"] = train_net_torch.main(eval_args)
    torch.cuda.synchronize()
    out["eval_counts"] = _build.launch_counts()
    return out


def phase_ddp(kernels, dev, smi):
    """Data-parallel training through ``parallel.launch`` on the one card:
    NCCL at world size 1 against the same run without a group, two gloo
    ranks sharing the card against the single process's step on the joined
    batch, and evaluation on two ranks."""
    import datetime
    import os
    import tempfile

    import train_net_torch
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.parallel import launch
    from slenderobjdet_torch.solver import build_optimizer

    name = "chip_smoke_ddp"
    group_timeout = datetime.timedelta(seconds=DDP_TIMEOUT_S)
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_") as tmp:
            n_test = ddp_setup(name, tmp)
            n_test_batches = n_test // 8
            plain_out, nccl_out = os.path.join(tmp, "no_group"), os.path.join(tmp, "nccl")

            # ---- the same 4 iterations without a group, then NCCL at world size 1
            t0 = time.perf_counter()
            plain = ddp_main(ddp_trainer_args(name, plain_out), name, tmp)
            plain_wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            nccl, = launch(ddp_main, 1, args=(ddp_trainer_args(name, nccl_out), name, tmp),
                           force_group=True, timeout=group_timeout, join_timeout=DDP_JOIN_S)
            nccl_wall = time.perf_counter() - t0
            if (nccl["world"], nccl["backend"]) != (1, "nccl"):
                raise AssertionError(f"the forced group: {nccl['world']} {nccl['backend']}")
            for run, label in ((plain, "no group"), (nccl, "NCCL world size 1")):
                if [r["step"] for r in run["steps"]] != list(range(DDP_ITERS)):
                    raise AssertionError(f"{label}: steps {[r['step'] for r in run['steps']]}")
                for r in run["steps"]:
                    if r["launches"] != {"fused_stem": 1, "fused_bottleneck": 13} \
                            or not np.isfinite(r["loss"]):
                        raise AssertionError(f"{label} step {r['step']}: {r}")
                want = {"nms": n_test_batches, "fused_stem": DDP_ITERS + n_test_batches,
                        "fused_bottleneck": 13 * (DDP_ITERS + n_test_batches)}
                if {k: run["counts"][k] for k in want} != want:
                    raise AssertionError(f"{label} launched {run['counts']}, expected {want}")
            for k in PREDICT_KERNELS:
                kernels[k].setdefault("launches_by_path", {})["ddp_nccl"] = nccl["counts"][k]
            ckpt = f"model_{DDP_ITERS:07d}.pth"
            a = torch.load(os.path.join(plain_out, ckpt), map_location="cpu", weights_only=True)
            b = torch.load(os.path.join(nccl_out, ckpt), map_location="cpu", weights_only=True)
            largest = max((float((a["model"][k].double() - b["model"][k].double()).abs().max()), k)
                          for k in a["model"])
            log(f"ddp NCCL world size 1: state after {DDP_ITERS} iterations "
                f"{'bit-equal' if states_equal(a, b) else 'NOT bit-equal'} to the run without a "
                f"group (largest model difference {largest[0]:.3e} at {largest[1]}); every step "
                f"1 stem + 13 bottleneck, {n_test_batches} test batches 1 NMS each; losses "
                f"{[round(r['loss'], 4) for r in nccl['steps']]}")
            if not states_equal(a, b):
                raise AssertionError(f"NCCL world size 1 differs: {largest}")
            del a, b

            def step_ms(run):      # steps 2..: watched_trainer synchronises before step 2
                s = run["steps"]
                return (s[-1]["t1"] - s[2]["t0"]) / (len(s) - 2) * 1e3
            plain_ms, nccl_ms = step_ms(plain), step_ms(nccl)
            log(f"time ddp ({smi}): train_net_torch.main steps 2-{DDP_ITERS - 1}, B=16, bf16, "
                f"flags on: no group {plain_ms:.1f} ms/step, NCCL world size 1 "
                f"{nccl_ms:.1f} ms/step ({nccl_ms / plain_ms:.3f} x); peak memory "
                f"{plain['peak_gib']:.2f} / {nccl['peak_gib']:.2f} GiB; whole main "
                f"{plain_wall:.1f} s in this process, {nccl_wall:.1f} s spawned")

            one_bbox = plain["results"][name + "_test"]["bbox"]
            with open(os.path.join(plain_out, "coco_instances_results.json")) as f:
                one_dets = json.load(f)

            # ---- the single process's fp32 step on the joined batch of 16
            cfg = train_cfg(False, "float32")
            model = build_model(cfg, generator=torch.Generator().manual_seed(0))
            step = make_train_step(model, build_optimizer(cfg, model), cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fp32_num_pos = float(step(ddp_joined_batch())["num_pos"])
            torch.cuda.synchronize()
            fp32_ms = (time.perf_counter() - t0) * 1e3
            ref_path = os.path.join(tmp, "fp32_joined_step.pt")
            torch.save({k: v.detach().cpu() for k, v in model.named_parameters()}, ref_path)
            del model, step
            torch.cuda.empty_cache()

            # ---- two gloo ranks on the one card: the step, 5 bf16 steps, evaluation
            eval_args = ddp_trainer_args(name, nccl_out, "--resume", "--eval-only")
            t0 = time.perf_counter()
            ranks = launch(ddp_gloo_rank, 2, args=(ref_path, eval_args, name, tmp),
                           backend="gloo", timeout=group_timeout, join_timeout=DDP_JOIN_S)
            gloo_wall = time.perf_counter() - t0
            r0, r1 = ranks
            if [r["backend"] for r in ranks] != ["gloo", "gloo"]:
                raise AssertionError(f"backends {[r['backend'] for r in ranks]}")
            log(f"ddp two gloo ranks on {r0['device']} and {r1['device']}: fp32 flags off, one "
                f"step of 8 + 8 rows (1 and 30 valid boxes an image) against the single "
                f"process's B=16 step (its {fp32_ms:.1f} ms, the first); positives of the "
                f"joined batch {fp32_num_pos:.0f}, as the ranks report them "
                f"{r0['fp32_num_pos']:.0f} / {r1['fp32_num_pos']:.0f}; worst over tensors of |diff| / ({DDP_FP32_RTOL} x max|value| "
                f"+ {DDP_UPDATE_RTOL} x max|update|) {r0['fp32_excess'][0]:.3f} at "
                f"{r0['fp32_excess'][1]}, plain max|diff| / max|value| "
                f"{r0['fp32_plain_ratio'][0]:.3e} at {r0['fp32_plain_ratio'][1]}; ranks "
                f"{'bit-equal' if r0['fp32_digest'] == r1['fp32_digest'] else 'DIFFER'}")
            if not (r0["fp32_digest"] == r1["fp32_digest"] and r0["fp32_excess"][0] <= 1
                    and r0["fp32_num_pos"] == r1["fp32_num_pos"] == fp32_num_pos):
                raise AssertionError(f"fp32 two-rank step: {r0['fp32_excess']}, positives "
                                     f"{r0['fp32_num_pos']} / {r1['fp32_num_pos']} against "
                                     f"{fp32_num_pos}")
            for r in ranks:
                for i, s in enumerate(r["bf16_steps"]):
                    if s["launches"] != {"fused_stem": 1, "fused_bottleneck": 13} \
                            or not np.isfinite(s["loss"]):
                        raise AssertionError(f"rank {r['rank']} bf16 step {i}: {s}")
            if r0["bf16_digest"] != r1["bf16_digest"]:
                raise AssertionError("bf16 parameters differ across the ranks")
            for k in PREDICT_KERNELS:
                kernels[k]["launches_by_path"]["ddp_gloo_rank0"] = (
                    sum(s["launches"].get(k, 0) for s in r0["bf16_steps"])
                    + r0["eval_counts"][k])
            rank_ms = [float(np.mean([s["ms"] for s in r["bf16_steps"][2:]])) for r in ranks]
            share = [r["allreduce_ms"] / ms for r, ms in zip(ranks, rank_ms)]
            log(f"time ddp two ranks sharing one card ({smi}; not a scaling figure): bf16, "
                f"flags on, 8 rows a rank, global B=16, steps 2-{DDP_BF16_STEPS - 1}: rank 0 "
                f"{rank_ms[0]:.1f} ms/step, rank 1 {rank_ms[1]:.1f}; one process at B=16 "
                f"{plain_ms:.1f}; every step 1 stem + 13 bottleneck on each rank; losses rank 0 "
                f"{[round(s['loss'], 4) for s in r0['bf16_steps']]}, parameters bit-equal "
                f"across the ranks; gloo all-reduce of the {r0['allreduce_mb']:.1f} MB of fp32 "
                f"gradients alone {r0['allreduce_ms']:.1f} / {r1['allreduce_ms']:.1f} ms "
                f"({share[0]:.3f} / {share[1]:.3f} of a rank's step); peak memory a rank "
                f"{r0['peak_gib']:.2f} / {r1['peak_gib']:.2f} GiB; the spawn {gloo_wall:.1f} s")

            # ---- evaluation on the two ranks
            if r1["eval"] != {}:
                raise AssertionError(f"rank 1 returned {r1['eval']}")
            res = r0["eval"][name + "_test"]
            with open(os.path.join(nccl_out, "coco_instances_results.json")) as f:
                two_dets = json.load(f)
            n_same = len({json.dumps(d, sort_keys=True) for d in one_dets}
                         & {json.dumps(d, sort_keys=True) for d in two_dets})
            for r in ranks:
                want = {"nms": n_test_batches // 2, "fused_stem": n_test_batches // 2,
                        "fused_bottleneck": 13 * n_test_batches // 2}
                if {k: r["eval_counts"][k] for k in want} != want:
                    raise AssertionError(f"rank {r['rank']} evaluation launched "
                                         f"{r['eval_counts']}, expected {want}")
            log(f"ddp evaluation on two ranks of the NCCL run's checkpoint: rank 0 bbox AP "
                f"{res['bbox']['AP']:.4f} against one process's {one_bbox['AP']:.4f}; "
                f"{len(two_dets)} detections against {len(one_dets)}, {n_same} identical; rank 1 "
                f"returned {{}}; each rank's {n_test_batches // 2} test batches launched 1 stem, "
                f"13 bottleneck and 1 NMS each; eval img/s rank 0 "
                f"{1 / res['_timing']['s_per_img'] if res['_timing']['s_per_img'] else 0:.2f}")
            if not (abs(res["bbox"]["AP"] - one_bbox["AP"]) <= DDP_AP_TOL
                    and n_same == len(two_dets) == len(one_dets) == 100 * n_test):
                raise AssertionError(f"two-rank evaluation: AP {res['bbox']['AP']} vs "
                                     f"{one_bbox['AP']}, {len(two_dets)} vs {len(one_dets)}, "
                                     f"{n_same} identical")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


# ------------------------------------------------------ the proposal networks
PROPOSAL_HW = LOADER_SHAPES[0]       # the loader's landscape bucket, 896 x 1408
PROPOSAL_GENERATORS = ("RepPointsGenerator", "PointsProposalGenerator",
                       "ProposalNetworkWithMasks")
# per level min(1000, H*W) at 896 x 1408: 1000 + 1000 + 1000 + 308 + 77
PROPOSAL_CANDIDATES = 3385
PROPOSAL_PREDICT_LAUNCHES = {"fused_stem": 1, "fused_bottleneck": 13, "nms": 1}
PROPOSAL_STEP_LAUNCHES = {"fused_stem": 1, "fused_bottleneck": 13}
PROPOSAL_TRAIN_LR = 1e-3    # a test setting, WARMUP_ITERS 0: the loss falls over 11 steps
PROPOSAL_P3_SPREAD = 1.5    # PPG: the std of raw offset x stride at P3, drawn
SYNCBN_FP32_RTOL = DDP_FP32_RTOL      # two ranks' fp32 step vs the joined batch's
SYNCBN_UPDATE_RTOL = DDP_UPDATE_RTOL
# the two-rank fp32 step trains the head, the FPN and the stem's norm: the
# trunk's BatchNorms still normalise by the joined batch and update their
# running statistics, but a trained BatchNorm trunk's float32 gradients are
# ill-conditioned on random weights (the CPU port's float32 and float64
# gradients of res5 differ by up to 9%; with it trained, res5_2.norm3.bias
# missed this criterion 47.9-fold on an NVIDIA H100 80GB HBM3 at 700 W)
SYNCBN_FREEZE_AT = 5
# and even so a BatchNorm's bias gradient (a residual of terms that the next
# BatchNorm's mean removes) moved 2.5-4.4% of its update between the halves
# and the joined batch on that card: each tensor is also allowed
# SYNCBN_NOISE_FACTOR x its own difference between the joined batch's step
# and the same step on the batch's rows reordered (halves swapped), which
# measures that tensor's float32 conditioning in this run
SYNCBN_NOISE_FACTOR = 4.0
# a bias a BatchNorm follows: its gradient is 0 up to rounding
SYNCBN_EXACT_ZERO = tuple(f"head.{t}_conv{i}.bias" for t in ("objectness", "deltas")
                          for i in range(3))


def proposal_overrides(generator, norm=None):
    """The flagship yaml's overrides for a proposal network: any generator
    other than the two point-based ones builds ProposalNetworkWithMasks."""
    over = {"MODEL.META_ARCHITECTURE": "ProposalNetwork",
            "MODEL.PROPOSAL_GENERATOR.NAME": ("RPN" if generator == "ProposalNetworkWithMasks"
                                              else generator),
            "MODEL.RPN.IN_FEATURES": ["p3", "p4", "p5", "p6", "p7"]}
    if norm is not None:
        over["MODEL.RESNETS.NORM"] = norm
    return over


def proposal_cfg(generator, fused=True, dtype="bfloat16", norm=None, lr=None,
                 freeze_at=None):
    cfg = train_cfg(fused, dtype)
    cfg.defrost()
    if freeze_at is not None:
        cfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
    for k, v in proposal_overrides(generator, norm).items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, v)
    if lr is not None:
        cfg.SOLVER.BASE_LR = lr
    cfg.freeze()
    return cfg


def shape_ppg_offsets(model, images):
    """Draw the PPG's zero-initialised offsets conv so that raw x stride
    spreads by PROPOSAL_P3_SPREAD at P3: its boxes then span pixels (drawn
    at 0 every box is a point, and MIN_SIZE 0 scores every one 0)."""
    with torch.no_grad():
        w = model.head.offsets.weight
        w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(34)).to(w.device))
        raw = model(images)[1][0].float()
        stride = PROPOSAL_HW[1] / raw.shape[2]
        w.mul_(PROPOSAL_P3_SPREAD / stride / float(raw.std()))


def build_proposal_models(dev, smi, built):
    """Each generator at full width (R-50 FrozenBN, FPN 256, P3-P7), bf16 with
    the fused flags, seeded, FrozenBN drawn away from identity, and the same
    weights unfused in bf16 and in fp32; into ``built``."""
    from slenderobjdet_torch.models import build_model

    images = torch.as_tensor(requests(1, 2, seed=35, hw=PROPOSAL_HW)[0]["image"], device=dev)
    for i, generator in enumerate(PROPOSAL_GENERATORS):
        gen = torch.Generator().manual_seed(50 + i)
        t0 = time.perf_counter()
        model = build_model(proposal_cfg(generator), device=dev, generator=gen)
        randomize_frozen_bn(model, gen)
        if generator == "PointsProposalGenerator":
            shape_ppg_offsets(model, images)
        models = [model]
        for dtype in ("bfloat16", "float32"):
            m = build_model(proposal_cfg(generator, False, dtype), device=dev)
            m.load_state_dict(model.state_dict())
            models.append(m)
        n = sum(p.numel() for p in model.parameters())
        n_head = sum(p.numel() for p in model.head.parameters())
        bns = sum(1 for m in model.modules() if type(m).__name__ == "BatchNorm")
        log(f"proposal build {generator} ({type(model).__name__}; {smi}): {n} parameters, "
            f"{n_head} in the head, {bns} trainable BatchNorms; strides {model.strides}; "
            f"three copies in {time.perf_counter() - t0:.1f} s")
        built[generator] = models


def proposal_parts(model, images, image_hw):
    """Device ms of a predict call's trunk + FPN, head and postprocess."""
    x = ((images.float() - model.pixel_mean) / model.pixel_std).to(model.dtype)
    x = x.permute(0, 3, 1, 2)
    feats = model.features(images)
    outputs = model.head(feats)
    scale = torch.ones(images.shape[0], device=images.device)
    orig = torch.tensor([image_hw] * images.shape[0], dtype=torch.float32,
                        device=images.device)
    return {"trunk + FPN": cuda_ms(lambda: model.backbone(x), 5),
            "head": cuda_ms(lambda: model.head(feats), 5),
            "postprocess": cuda_ms(lambda: model.postprocess(*outputs, image_hw, scale, orig),
                                   5)}


def phase_proposal(kernels, dev, smi, built):
    """Each generator at 896 x 1408: head outputs in bf16 against fp32; the
    NMS kernel against ``batched_nms`` on its own 3,385 candidates an image
    (B=8, thr and slots of the model); at B=8 and 32 exactly 1 stem + 13
    bottleneck + 1 NMS launch a predict call; device ms of the parts and
    predict img/s."""
    from slenderobjdet_torch.ops import _build

    parts_of = {"RepPointsGenerator": ("logits", "deltas"),
                "PointsProposalGenerator": ("logits", "raw offsets"),
                "ProposalNetworkWithMasks": ("logits", "ltrb")}
    for generator, (model, plain, ref32) in built.items():
        label = {"RepPointsGenerator": "rpg", "PointsProposalGenerator": "ppg",
                 "ProposalNetworkWithMasks": "pnwm"}[generator]
        reqs = requests(1, 8, seed=36, hw=PROPOSAL_HW) + requests(1, 32, seed=37,
                                                                   hw=PROPOSAL_HW)
        check_heads(label, parts_of[generator], reqs[0], dev, model, plain, ref32)
        with torch.inference_mode():
            images = torch.as_tensor(reqs[0]["image"], device=dev)
            boxes, scores = model.candidates(*model(images), PROPOSAL_HW)
        if boxes.shape[1] != PROPOSAL_CANDIDATES:
            raise AssertionError(f"{generator}: {boxes.shape[1]} candidates an image")
        nms_check(kernels, smi, f"proposal_{label}", f"B8_N{PROPOSAL_CANDIDATES}", boxes,
                  scores, None, model.nms_thresh, model.max_dets)
        per_call, rates = [], {}
        for r in reqs:
            b = r["image"].shape[0]
            _build.reset_launch_counts()
            out = model.predict(r)
            torch.cuda.synchronize()
            per_call.append({k: v for k, v in _build.launch_counts().items() if v})
            shapes = {k: tuple(v.shape) for k, v in out.items()}
            if shapes["boxes"] != (b, 100, 4) or not bool(torch.isfinite(out["boxes"]).all()) \
                    or bool(out["classes"].any()) or not torch.equal(out["proposals"],
                                                                    out["boxes"]):
                raise AssertionError(f"{generator} predict B={b}: {shapes}")
            ms = cuda_ms(lambda r=r: model.predict(r), 3)
            rates[b] = b / ms * 1e3
        if any(c != PROPOSAL_PREDICT_LAUNCHES for c in per_call):
            raise AssertionError(f"{generator} predict launched {per_call}")
        for k in PREDICT_KERNELS:
            kernels[k].setdefault("launches_by_path", {})[f"proposal_{label}_predict"] = sum(
                c[k] for c in per_call)
        with torch.inference_mode():
            parts = proposal_parts(model, images, PROPOSAL_HW)
        kernels["nms"].setdefault("proposal_predict_parts_ms", {})[label] = parts
        log(f"time proposal {generator} predict ({smi}), {PROPOSAL_HW[0]}x{PROPOSAL_HW[1]} "
            f"fused bf16: launches a call at B=8 and 32 {per_call}; B=8 device ms "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            + f"; predict {rates[8]:.2f} img/s at B=8, {rates[32]:.2f} at B=32 "
            f"(whole call, the uint8 upload included)")
        del images, boxes, scores, out
        torch.cuda.empty_cache()


def proposal_steps(model, cfg, batch, steps, label, smi):
    """``steps`` train steps on one batch: totals, launches a step, img/s of
    the steps after the second, peak memory."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.solver import build_optimizer

    step = make_train_step(model, build_optimizer(cfg, model), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals, launches, times = [], [], []
    for i in range(steps):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append({k: v for k, v in _build.launch_counts().items() if v})
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"{label} step {i}: non-finite {metrics}")
        totals.append(metrics["total_loss"])
    b = batch["image"].shape[0]
    rate = b / float(np.mean(times[2:] or times))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train {label} ({smi}) B={b} {PROPOSAL_HW[0]}x{PROPOSAL_HW[1]}: totals "
        f"{[round(t, 4) for t in totals]}; last step {metrics}; launches a step "
        f"{launches[-1]}; {rate:.2f} img/s, peak {peak:.2f} GiB")
    return totals, launches, rate, peak


def phase_proposal_train(kernels, dev, smi):
    """RepPointsGenerator: 11 steps on one batch of 16 with 100 padded gt
    (WARMUP_ITERS 0, BASE_LR PROPOSAL_TRAIN_LR), 1 stem + 13 bottleneck a
    step, finite losses ending below step 0's, the head's running statistics
    moved; one step of each other generator (B=8); one step and one predict
    with MODEL.RESNETS.NORM SyncBN (no group): 0 stem and 0 bottleneck
    launches, 1 NMS a predict."""
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.ops import _build

    batch = train_batch(16, seed=38, hw=PROPOSAL_HW)
    cfg = proposal_cfg("RepPointsGenerator", lr=PROPOSAL_TRAIN_LR)
    gen = torch.Generator().manual_seed(39)
    model = build_model(cfg, device=dev, generator=gen)
    randomize_frozen_bn(model, gen)
    before = model.head.objectness_norm0.running_var.clone()
    totals, launches, rate, peak = proposal_steps(model, cfg, batch, TRAIN_STEPS + 1,
                                                  "proposal RepPointsGenerator", smi)
    moved = float((model.head.objectness_norm0.running_var - before).abs().max())
    if any(c != PROPOSAL_STEP_LAUNCHES for c in launches) or not totals[-1] < totals[0] \
            or not moved > 0:
        raise AssertionError(f"RPG train: launches {launches}, totals {totals}, running "
                             f"var moved {moved}")
    for k in ("fused_stem", "fused_bottleneck"):
        kernels[k].setdefault("launches_by_path", {})["proposal_rpg_train_step"] = \
            PROPOSAL_STEP_LAUNCHES[k]
    del model
    torch.cuda.empty_cache()

    half = {k: v[:8] for k, v in batch.items()}
    for generator in PROPOSAL_GENERATORS[1:]:
        cfg = proposal_cfg(generator, lr=PROPOSAL_TRAIN_LR)
        model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(40))
        _, launches, _, _ = proposal_steps(model, cfg, half, 1, f"proposal {generator}", smi)
        if launches[0] != PROPOSAL_STEP_LAUNCHES:
            raise AssertionError(f"{generator} step launched {launches}")
        del model
        torch.cuda.empty_cache()

    cfg = proposal_cfg("RepPointsGenerator", norm="SyncBN", lr=PROPOSAL_TRAIN_LR)
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(41))
    bns = sum(1 for m in model.modules() if type(m).__name__ == "BatchNorm")
    _, launches, rate, peak = proposal_steps(model, cfg, half, 3,
                                             "proposal RepPointsGenerator SyncBN trunk", smi)
    _build.reset_launch_counts()
    out = model.predict(requests(1, 8, seed=42, hw=PROPOSAL_HW)[0])
    torch.cuda.synchronize()
    predicted = {k: v for k, v in _build.launch_counts().items() if v}
    log(f"proposal SyncBN trunk ({bns} trainable BatchNorms, no group): a step launched "
        f"{launches[-1] or 'no kernel'} (the fused seams need FrozenBN, as in the JAX "
        f"package), a predict of B=8 {predicted}; {rate:.2f} img/s at B=8, peak "
        f"{peak:.2f} GiB")
    if any(c for c in launches) or predicted != {"nms": 1} \
            or not bool(torch.isfinite(out["boxes"]).all()):
        raise AssertionError(f"SyncBN trunk: steps launched {launches}, predict {predicted}")


def phase_proposal_trainer(kernels, dev, smi):
    """``train_net_torch.main`` on the RepPointsGenerator (``family_trainer``:
    train with saves, ``--resume`` bit-equal with the BatchNorm running
    statistics, ``--eval-only`` with 1 NMS a test batch); then
    ``TEST.PRECISE_BN`` (NUM_ITER 2) through the trainer's ``test``: the
    statistics move, and the next checkpoint carries them bit for bit."""
    import os
    import tempfile

    import train_net_torch
    from slenderobjdet_torch.engine.trainer import BaseTrainer
    from slenderobjdet_torch.ops import _build

    overrides = {**proposal_overrides("RepPointsGenerator"), "SOLVER.BASE_LR": PROPOSAL_TRAIN_LR}
    family_trainer(kernels, smi, "proposal_rpg", FCOS_YAML, 43, PROPOSAL_STEP_LAUNCHES,
                   predict_nms=1, loss_key="localization_loss", overrides=overrides)

    name = "chip_smoke_precise_bn"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_precise_bn_") as tmp:
        synthetic_dataset(name, tmp, seed=44)
        out = os.path.join(tmp, "output")
        cfg = train_net_torch.setup(trainer_args(name, out, overrides={
            **overrides, "DATASETS.TEST": "()", "TEST.PRECISE_BN.ENABLED": True,
            "TEST.PRECISE_BN.NUM_ITER": 2}))
        trainer = BaseTrainer(cfg)
        before = {k: v.clone() for k, v in trainer.model.named_buffers() if "running_" in k}
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.test()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in _build.launch_counts().items() if v}
        after = dict(trainer.model.named_buffers())
        moved = sum(not torch.equal(v, after[k]) for k, v in before.items())
        trainer.checkpointer.save("model_precise_bn", trainer.state())
        saved = torch.load(os.path.join(out, "model_precise_bn.pth"), map_location="cpu",
                           weights_only=True)["model"]
        carried = all(torch.equal(saved[k], after[k].cpu()) for k in before)
        finite = all(bool(torch.isfinite(after[k]).all()) for k in before)
        log(f"proposal trainer TEST.PRECISE_BN ({smi}): 2 batches of 16 at "
            f"{cfg.INPUT.MIN_SIZE_TRAIN} recomputed {moved} of {len(before)} running "
            f"statistics in {wall:.2f} s, launching {counts}; the next checkpoint carries them "
            f"{'bit for bit' if carried else 'NOT'}")
        if not (moved == len(before) and carried and finite
                and counts == {"fused_stem": 2, "fused_bottleneck": 26}):
            raise AssertionError(f"precise BN: moved {moved}/{len(before)}, carried {carried}, "
                                 f"finite {finite}, launches {counts}")


def syncbn_rank(ref_path, noise_path, nccl_steps, digest_only):
    """In a spawned process: with ``digest_only``, ``nccl_steps`` bf16 steps
    of the RPG with a SyncBN trunk on the first 8 rows of the joined batch
    and the state's digest (NCCL at world size 1 against the same steps
    without a group); else one of two gloo ranks: one fp32 step on its 8 rows
    of the joined 16 held against the single process's step at ``ref_path``,
    then one instrumented step timing the all-reduces."""
    import torch.distributed as dist

    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.parallel import process_index, state_digest
    from slenderobjdet_torch.solver import build_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    rank = process_index()
    dtype = "bfloat16" if digest_only else "float32"
    cfg = proposal_cfg("RepPointsGenerator", fused=digest_only, dtype=dtype, norm="SyncBN",
                       lr=PROPOSAL_TRAIN_LR, freeze_at=None if digest_only else SYNCBN_FREEZE_AT)
    model = build_model(cfg, generator=torch.Generator().manual_seed(45))
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = make_train_step(model, build_optimizer(cfg, model), cfg)
    joined = ddp_joined_batch()
    if digest_only:
        for _ in range(nccl_steps):
            step({k: v[:8] for k, v in joined.items()})
        torch.cuda.synchronize()
        return {"digest": state_digest(model),
                "backend": dist.get_backend() if dist.is_initialized() else None}
    rows = {k: v[8 * rank: 8 * rank + 8] for k, v in joined.items()}
    metrics = step(rows)
    out = {"num_pos": float(metrics["num_pos"]), "loss": float(metrics["total_loss"]),
           "backend": dist.get_backend()}
    want = torch.load(ref_path, map_location="cpu", weights_only=True)
    noise = torch.load(noise_path, map_location="cpu", weights_only=True)
    excess = []
    for n, p in model.named_parameters():
        w = want[n].double()
        diff = float((p.detach().cpu().double() - w).abs().max())
        if n in SYNCBN_EXACT_ZERO:
            excess.append((diff / 1e-9, n))
            continue
        allowed = (SYNCBN_FP32_RTOL * float(w.abs().max()) + SYNCBN_UPDATE_RTOL
                   * float((w - init[n].cpu().double()).abs().max())
                   + SYNCBN_NOISE_FACTOR * float((noise[n].double() - w).abs().max()))
        if diff > 0:
            excess.append((diff / allowed if allowed > 0 else float("inf"), n))
    worst = max(excess, default=(0.0, ""))
    out["excess"] = worst
    out["worst5"] = sorted(excess, reverse=True)[:5]
    stats = [(n, b) for n, b in model.named_buffers() if "running_" in n]
    out["stats_ratio"] = max(float((b.cpu().double() - want[n].double()).abs().max())
                             / (float(want[n].double().abs().max()) + 1e-30) for n, b in stats)
    out["digest"] = state_digest(model)
    # a second step, timed, then a third with every dist.all_reduce timed (the
    # BatchNorms' forward and backward reductions and the loss's counts; DDP's
    # own gradient buckets do not go through it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(rows)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    real, spent = dist.all_reduce, [0.0, 0]

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = real(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        spent[1] += 1
        return r

    dist.all_reduce = timed
    try:
        step(rows)
    finally:
        dist.all_reduce = real
    out["allreduce_ms"], out["allreduce_calls"] = spent[0] * 1e3, spent[1]
    return out


def phase_syncbn(kernels, dev, smi):
    """SyncBN through ``parallel.launch``: the RPG with a SyncBN trunk under
    NCCL at world size 1 bit-equal to no group (3 bf16 steps); two gloo ranks
    sharing the card, 8 rows each of a joined 16, one fp32 step against the
    single process's step (the ddp phase's criterion plus SYNCBN_NOISE_FACTOR x each
    tensor's difference under a reordering of the joined batch; the trunk's
    convolutions frozen: SYNCBN_FREEZE_AT), parameters and running
    statistics bit-equal across the ranks; the all-reduces' ms and share."""
    import datetime
    import os
    import tempfile

    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.parallel import launch, state_digest
    from slenderobjdet_torch.solver import build_optimizer

    timeout = datetime.timedelta(seconds=DDP_TIMEOUT_S)
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        plain = syncbn_rank(None, None, 3, True)
        nccl, = launch(syncbn_rank, 1, args=(None, None, 3, True), force_group=True,
                       timeout=timeout, join_timeout=DDP_JOIN_S)
        log(f"syncbn NCCL world size 1 ({nccl['backend']}): 3 bf16 steps of the RPG with a "
            f"SyncBN trunk {'bit-equal' if nccl['digest'] == plain['digest'] else 'DIFFER'} "
            f"to the same steps without a group")
        if nccl["backend"] != "nccl" or nccl["digest"] != plain["digest"]:
            raise AssertionError(f"NCCL world size 1: {nccl}, no group {plain}")

        cfg = proposal_cfg("RepPointsGenerator", fused=False, dtype="float32", norm="SyncBN",
                           lr=PROPOSAL_TRAIN_LR, freeze_at=SYNCBN_FREEZE_AT)
        joined = ddp_joined_batch()
        swapped = {k: np.concatenate([v[8:], v[:8]]) for k, v in joined.items()}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_syncbn_") as tmp:
            paths = []
            for label, batch in (("single", joined), ("swapped", swapped)):
                model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(45))
                step = make_train_step(model, build_optimizer(cfg, model), cfg)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(batch)
                torch.cuda.synchronize()
                if label == "single":
                    metrics, single_ms = m, (time.perf_counter() - t0) * 1e3
                paths.append(os.path.join(tmp, f"{label}.pt"))
                torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                           paths[-1])
                del model, step, m
                torch.cuda.empty_cache()
            a, b = (torch.load(path, weights_only=True) for path in paths)
            init = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(45))
            self_noise = max((float((b[n].double() - a[n].double()).abs().max())
                              / (SYNCBN_FP32_RTOL * float(a[n].double().abs().max())
                                 + SYNCBN_UPDATE_RTOL * float((a[n].double() - p.detach()
                                                               .double()).abs().max())
                                 + 1e-30), n)
                             for n, p in init.named_parameters() if p.requires_grad
                             and n not in SYNCBN_EXACT_ZERO)
            del a, b, init
            t0 = time.perf_counter()
            ranks = launch(syncbn_rank, 2, args=(*paths, 0, False), backend="gloo",
                           timeout=timeout, join_timeout=DDP_JOIN_S)
            wall = time.perf_counter() - t0
        r0, r1 = ranks
        share = [r["allreduce_ms"] / r["step_ms"] for r in ranks]
        log(f"syncbn two gloo ranks on one card ({smi}): fp32, one step of 8 + 8 rows (1 and "
            f"30 valid boxes an image) against the single process's B=16 step "
            f"(its {single_ms:.1f} ms, the first): positives {r0['num_pos']:.0f} / "
            f"{r1['num_pos']:.0f} against {float(metrics['num_pos']):.0f}; mean loss "
            f"{(r0['loss'] + r1['loss']) / 2:.6f} against {float(metrics['total_loss']):.6f}; "
            f"worst |diff| / ({SYNCBN_FP32_RTOL} x max|value| + {SYNCBN_UPDATE_RTOL} x "
            f"max|update| + {SYNCBN_NOISE_FACTOR} x the joined step's own reordering "
            f"difference) {r0['excess'][0]:.3f} at {r0['excess'][1]} (the five worst "
            f"{[(round(e, 3), n) for e, n in r0['worst5']]}; FREEZE_AT {SYNCBN_FREEZE_AT}; the "
            f"reordered joined step alone misses the ddp phase's criterion "
            f"{self_noise[0]:.3f}-fold at "
            f"{self_noise[1]}); "
            f"running statistics "
            f"within {r0['stats_ratio']:.3e} of the largest; ranks "
            f"{'bit-equal' if r0['digest'] == r1['digest'] else 'DIFFER'}; the spawn {wall:.1f} s")
        log(f"time syncbn two ranks sharing one card ({smi}; not a scaling figure): a step "
            f"{r0['step_ms']:.1f} / {r1['step_ms']:.1f} ms; {r0['allreduce_calls']} "
            f"all-reduces a step (BatchNorm forward and backward, counts) "
            f"{r0['allreduce_ms']:.1f} / {r1['allreduce_ms']:.1f} ms timed one by one, "
            f"{share[0]:.3f} / {share[1]:.3f} of a step")
        if not (r0["digest"] == r1["digest"] and r0["excess"][0] <= 1
                and r0["num_pos"] == r1["num_pos"] == float(metrics["num_pos"])
                and abs((r0["loss"] + r1["loss"]) / 2 - float(metrics["total_loss"]))
                <= 1e-4 * abs(float(metrics["total_loss"]))
                and r0["stats_ratio"] <= 1e-4):
            raise AssertionError(f"syncbn two ranks: {r0}, {r1}")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


# ------------------------------------------------------------------ FCOSV3
FCOSV3_YAML = "configs/fcos/fcosv3_R_50_FPN_1x.yaml"
FCOSV3_HW = LOADER_SHAPES[0]         # the loader's landscape bucket, 896 x 1408
FCOSV3_STEP_LAUNCHES = {"fused_stem": 1, "fused_bottleneck": 13}
FCOSV3_PREDICT_LAUNCHES = {"fused_stem": 1, "fused_bottleneck": 13, "nms": 1}
FCOSV3_WAIT_ITERS = 6               # main's iterations for the loader-wait share
FCOSV3_RENDER_IMAGES = 8            # images whose maps are rendered by both renderers
MAP_ATOL = 1e-5      # C renderer vs numpy: border and center maps (tests/test_border_native.py)
SIZE_ATOL = 1e-3     # and the size map


def render_polygons(rs, h, w):
    """8-30 instances in an h x w image: rotated rectangles and 6-16-vertex
    ellipses, a third of them of aspect ratio 8 or more, vertices to 0.1 px;
    some run off the image."""
    polys = []
    for _ in range(rs.randint(8, 31)):
        length = rs.randint(40, 500)
        width = max(3.0, length / rs.choice([1.5, 3.0, 8.0, 12.0, 20.0]))
        if rs.rand() < 0.3:
            ang = np.sort(rs.rand(rs.randint(6, 17)) * 2 * np.pi)
            pts = np.stack([np.cos(ang) * length / 2, np.sin(ang) * width / 2], 1)
        else:
            pts = np.array([[-length, -width], [length, -width], [length, width],
                            [-length, width]]) / 2
        a = rs.rand() * np.pi
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        centre = np.array([rs.randint(0, w), rs.randint(0, h)], np.float64)
        polys.append([np.round(pts @ rot.T + centre, 1).reshape(-1)])
    return polys


def check_native_maps(label, nat, ref, sigma_steps):
    """The C renderer's maps against numpy's: MAP_ATOL, SIZE_ATOL for the
    size map, and for a gaussian centre map the step at the hull boundary
    (a pixel on it gets exp(-1 / (2 sigma^2)) from one renderer and 0 from
    the other, as in the JAX package). Returns the count of step pixels."""
    steps = 0
    for i, (n, r) in enumerate(zip(nat, ref)):
        tol = SIZE_ATOL if r.ndim == 3 else MAP_ATOL
        far = np.abs(n - r) > tol
        if i in sigma_steps and far.any():
            pair = np.sort(np.stack([n[far], r[far]]), axis=0)
            if not (np.all(pair[0] == 0) and np.all(pair[1] == sigma_steps[i])):
                raise AssertionError(f"{label} map {i}: C vs numpy beyond the boundary step")
            steps += int(far.sum())
        elif far.any():
            raise AssertionError(f"{label} map {i}: C vs numpy max diff "
                                 f"{float(np.abs(n - r).max())}")
    return steps


def phase_fcosv3_render(smi, report):
    """The host renderer: FCOSV3_RENDER_IMAGES images in both buckets'
    resized sizes (800 x 1333 and 1333 x 800), 8-30 instances each; the C
    renderer must have built (``native.available()``) and agree with numpy;
    host ms an image for the centre map alone and PNWM's three maps."""
    from slenderobjdet_torch.structures import borders, native

    if not native.available():
        raise AssertionError("the C border renderer did not build or load "
                             f"({native.library_path()})")
    rs = np.random.RandomState(50)
    ms = {("c", "center"): [], ("numpy", "center"): [], ("c", "masks"): [],
          ("numpy", "masks"): []}
    steps = n_inst = 0
    for i in range(FCOSV3_RENDER_IMAGES):
        hw = LOADER_IMAGE_HW if i % 2 == 0 else LOADER_IMAGE_HW[::-1]
        polys = render_polygons(rs, *hw)
        n_inst += len(polys)
        masks = borders.BorderMasks(polys)
        out = {}
        try:
            for renderer in ("c", "numpy"):
                borders.USE_NATIVE = renderer == "c"
                t0 = time.perf_counter()
                center = masks.center_masks(hw, "gaussian", 0.5)
                t1 = time.perf_counter()
                maps = masks.masks(hw)
                t2 = time.perf_counter()
                ms[renderer, "center"].append((t1 - t0) * 1e3)
                ms[renderer, "masks"].append((t2 - t1) * 1e3)
                out[renderer] = [center, *maps]
        finally:
            borders.USE_NATIVE = True
        steps += check_native_maps(f"image {i}", out["c"], out["numpy"],
                                   {0: np.float32(np.exp(-2.0))})
        if not out["c"][0].max() > 0.9:
            raise AssertionError(f"image {i}: an empty centre map")
    mean = {k: float(np.mean(v)) for k, v in ms.items()}
    report.update({f"render_{r}_{m}_ms": v for (r, m), v in mean.items()})
    log(f"time render ({smi}, host): {FCOSV3_RENDER_IMAGES} images of 800x1333 / 1333x800, "
        f"{n_inst} instances (8-30 an image), C renderer ({native.backend()}, "
        f"{native.library_path().parent.name}): centre map {mean['c', 'center']:.1f} ms/img, "
        f"PNWM's three maps {mean['c', 'masks']:.1f} ms/img; numpy: centre "
        f"{mean['numpy', 'center']:.1f}, three maps {mean['numpy', 'masks']:.1f} ms/img; "
        f"C == numpy within {MAP_ATOL} / {SIZE_ATOL} but {steps} boundary pixels")


def fcosv3_batch(batch, seed, hw=FCOSV3_HW):
    """``train_batch`` with the loader's centre map: each valid box's
    ``box_polygon`` rendered (gaussian, sigma 0.5) by the C renderer."""
    from slenderobjdet_torch.structures.borders import BorderMasks

    out = train_batch(batch, seed, hw=hw)
    rs = np.random.RandomState(seed + 1)
    out["center_mask"] = np.stack([
        BorderMasks([[np.array(box_polygon(rs, *b))] for b in boxes[valid]])
        .center_masks(hw, "gaussian", 0.5)
        for boxes, valid in zip(out["gt_boxes"], out["gt_valid"])])
    return out


def phase_fcosv3_train(kernels, dev, smi, report):
    """FCOSV3 at B=16, 896 x 1408, 100 padded gt and the centre map, flags on
    and off from the same weights: the gate keeps 0 < num_pos <= FCOS's on
    the batch; TRAIN_STEPS + 1 steps whose loss falls, each fused step 1 stem
    and 13 bottleneck launches, the unfused none; img/s and peak memory
    beside FCOS's on the same batch; the centre map's host-to-device copy."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.models.meta_arch.fcos import FCOSV3
    from slenderobjdet_torch.solver import build_optimizer

    batch = fcosv3_batch(16, seed=51)
    gen = torch.Generator().manual_seed(52)
    models, weights = {}, None
    for key in ("fused", "unfused"):
        m = build_model(train_cfg(key == "fused", yaml=FCOSV3_YAML), device=dev, generator=gen)
        if weights is None:
            randomize_frozen_bn(m, gen)
            weights = {k: v.clone() for k, v in m.state_dict().items()}
        else:
            m.load_state_dict(weights)
        if type(m) is not FCOSV3:
            raise AssertionError(f"{FCOSV3_YAML} built {type(m).__name__}")
        models[key] = m
    with torch.no_grad():
        gated = float(models["fused"].loss(batch)[1]["num_pos"])
        plain = float(models["fused"].loss(
            {k: v for k, v in batch.items() if k != "center_mask"})[1]["num_pos"])
    log(f"fcosv3 gate on B=16 {FCOSV3_HW[0]}x{FCOSV3_HW[1]}: num_pos {gated:.0f} with the "
        f"centre map, {plain:.0f} as FCOS ({1 - gated / plain:.3f} of the positives at or "
        f"below 0.2)")
    if not 0 < gated <= plain:
        raise AssertionError(f"fcosv3 num_pos {gated}, FCOS's {plain}")
    steps = {k: make_train_step(m, build_optimizer(train_cfg(k == "fused", yaml=FCOSV3_YAML), m),
                                train_cfg(k == "fused", yaml=FCOSV3_YAML))
             for k, m in models.items()}
    rates = {}
    peaks = train_turns("FCOSV3", steps, batch, ("cls_loss", "reg_loss", "centerness_loss",
                                                 "num_pos"), rates,
                        launches={"fused": FCOSV3_STEP_LAUNCHES, "unfused": {}})
    for k in ("fused_stem", "fused_bottleneck"):
        kernels[k].setdefault("launches_by_path", {})["fcosv3_train_step"] = \
            FCOSV3_STEP_LAUNCHES[k]
    del steps
    # FCOS on the same batch, the same weights: 2 steps to warm, 4 timed
    fcos_rates = {}
    for key, m in models.items():
        cfg = train_cfg(key == "fused")
        m.mask_center_sampling = False          # the FCOS loss on this batch
        step = make_train_step(m, build_optimizer(cfg, m), cfg)
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        fcos_rates[key] = 16 / float(np.mean(times[2:]))
        m.mask_center_sampling = True
    # the centre map's copy to the card, as the loss makes it each step
    copy = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.as_tensor(batch["center_mask"], dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        copy.append((time.perf_counter() - t0) * 1e3)
    copy_ms = float(np.mean(copy[1:]))
    mb = batch["center_mask"].nbytes / 1e6
    report.update(fcosv3_img_s=rates, fcos_same_batch_img_s=fcos_rates,
                  fcosv3_peak_gib=peaks, center_mask_copy_ms=copy_ms)
    log(f"time fcosv3 train ({smi}): B=16 {FCOSV3_HW[0]}x{FCOSV3_HW[1]}, 100 padded gt: "
        f"FCOSV3 fused {rates['fused']:.2f} img/s (peak {peaks['fused']:.2f} GiB), unfused "
        f"{rates['unfused']:.2f} img/s (peak {peaks['unfused']:.2f} GiB); FCOS on the same "
        f"batch fused {fcos_rates['fused']:.2f}, unfused {fcos_rates['unfused']:.2f} img/s; "
        f"the centre map's host-to-device copy {mb:.1f} MB (pageable) {copy_ms:.2f} ms a step")
    return models["fused"]


def phase_fcosv3_predict(kernels, dev, smi, model):
    """FCOSV3 predicts as FCOS does: the NMS kernel against ``batched_nms``
    on the model's own candidates (B=8 at 896 x 1408, the classifier's bias
    moved so that the coarsest level's 99.5th percentile score sits on the
    threshold), then one predict call with 1 stem, 13 bottleneck and 1 NMS
    launch and outputs of the right shapes."""
    from slenderobjdet_torch.ops import _build

    req = requests(1, 8, seed=53, hw=FCOSV3_HW)[0]
    with torch.inference_mode():
        images = torch.as_tensor(req["image"], device=dev)
        top = model(images)[0][-1].float().flatten()
        thresh = float(np.log(model.pre_nms_thresh / (1 - model.pre_nms_thresh)))
        classifier(model).bias.add_(thresh - float(
            torch.kthvalue(top.cpu(), int(0.995 * top.numel())).values))
        boxes, scores, classes, valid, _ = model.candidates(*model(images), FCOSV3_HW)
    nms_check(kernels, smi, "fcosv3", f"B8_N{boxes.shape[1]}", boxes, scores, valid,
              model.nms_thresh, model.max_dets, classes=classes)
    del images, boxes, scores, classes, valid
    _build.reset_launch_counts()
    out = model.predict(req)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    check_outputs(out, 8)
    if counts != FCOSV3_PREDICT_LAUNCHES:
        raise AssertionError(f"fcosv3 predict launched {counts}")
    for k in PREDICT_KERNELS:
        kernels[k].setdefault("launches_by_path", {})["fcosv3_predict"] = counts[k]
    log(f"fcosv3 predict B=8 {FCOSV3_HW[0]}x{FCOSV3_HW[1]}: launches {counts}, "
        f"{int(out['valid'].sum())} valid detections (FCOS's predict path; not timed again)")


def phase_fcosv3_trainer(kernels, dev, smi, report):
    """``train_net_torch.main`` on the FCOSV3 yaml over the synthetic dataset
    with polygons (``family_trainer``: train, ``--resume`` bit-equal,
    evaluate); then FCOSV3_WAIT_ITERS iterations of ``main`` each on the FCOS
    and the FCOSV3 yaml without evaluation, on the same images: img/s from
    step 2 on and the share of those steps spent waiting for the loader
    (FCOSV3's renders the centre map, FCOS's does not)."""
    import os
    import tempfile

    import train_net_torch

    family_trainer(kernels, smi, "fcosv3", FCOSV3_YAML, 54, FCOSV3_STEP_LAUNCHES,
                   predict_nms=1, loss_key="centerness_loss", polygons=True)
    name = "chip_smoke_fcosv3_wait"
    with watched_trainer() as watch, \
            tempfile.TemporaryDirectory(prefix="chip_smoke_fcosv3_wait_") as tmp:
        synthetic_dataset(name, tmp, seed=55, polygons=True)
        for family, yaml in (("FCOS", FCOS_YAML), ("FCOSV3", FCOSV3_YAML)):
            watch.clear()
            watch.sync_at[0] = 2
            n = FCOSV3_WAIT_ITERS
            train_net_torch.main(trainer_args(name, os.path.join(tmp, family), max_iter=n,
                                              checkpoint_period=1000, yaml=yaml,
                                              overrides={"DATASETS.TEST": "()"}))
            if [r["launches"] for r in watch.steps] != [FCOSV3_STEP_LAUNCHES] * n:
                raise AssertionError(f"{family} main launched "
                                     f"{[r['launches'] for r in watch.steps]}")
            span = watch.steps[-1]["t1"] - watch.steps[2]["t0"]
            wait = sum(watch.waits[3:n])
            report[f"{family}_main"] = {"img_s": 16 * (n - 2) / span, "wait_share": wait / span,
                                        "wait_ms": wait / (n - 3) * 1e3}
        log(f"time fcosv3 trainer ({smi}): steps 2-{FCOSV3_WAIT_ITERS - 1} of "
            f"train_net_torch.main, B=16, flags on: "
            + "; ".join(f"{f} {v['img_s']:.2f} img/s, waiting for the loader "
                        f"{v['wait_ms']:.2f} ms/step, {v['wait_share']:.4f} of a step"
                        for f, v in ((f, report[f"{f}_main"]) for f in ("FCOS", "FCOSV3"))))


def phase_fcosv3_pnwm(kernels, dev, smi, report):
    """One ProposalNetworkWithMasks step at B=16 on maps the mapper made
    (NEED_MASKS: ``center_mask``, ``border_mask``, ``size_map``) from 16
    inlined 800 x 1333 images with polygons: 1 stem + 13 bottleneck
    launches, finite losses, the mapper's host ms an image, peak memory and
    the three maps' copy to the card."""
    from slenderobjdet_torch.data.build import _stack_batch
    from slenderobjdet_torch.data.mapper import DatasetMapper
    from slenderobjdet_torch.models import build_model

    cfg = proposal_cfg("ProposalNetworkWithMasks", lr=PROPOSAL_TRAIN_LR)
    cfg.defrost()
    cfg.MODEL.META_ARCHITECTURE = "ProposalNetworkWithMasks"
    cfg.NEED_MASKS = True
    cfg.freeze()
    rs = np.random.RandomState(56)
    mapper = DatasetMapper(cfg, is_train=True)
    t0 = time.perf_counter()
    examples = []
    for i in range(16):
        h, w = LOADER_IMAGE_HW
        annos = []
        for poly in render_polygons(rs, h, w)[:20]:
            xy = poly[0].reshape(-1, 2)
            annos.append({"bbox": [*xy.min(0).tolist(), *xy.max(0).tolist()],
                          "category_id": 0, "iscrowd": 0,
                          "segmentation": [poly[0].tolist()]})
        examples.append(mapper({"image": rs.randint(0, 256, (h, w, 3), dtype=np.uint8),
                                "image_id": i, "annotations": annos},
                               rng=np.random.default_rng((56, i))))
    map_ms = (time.perf_counter() - t0) / 16 * 1e3
    batch = {k: v for k, v in _stack_batch(examples).items() if k != "image_id"}
    shapes = {k: batch[k].shape for k in ("image", "center_mask", "border_mask", "size_map")}
    if shapes != {"image": (16, *FCOSV3_HW, 3), "center_mask": (16, *FCOSV3_HW),
                  "border_mask": (16, *FCOSV3_HW), "size_map": (16, *FCOSV3_HW, 2)}:
        raise AssertionError(f"PNWM mapper batch {shapes}")
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(57))
    totals, launches, rate, peak = proposal_steps(model, cfg, batch, 3,
                                                  "fcosv3 ProposalNetworkWithMasks", smi)
    if any(c != FCOSV3_STEP_LAUNCHES for c in launches):
        raise AssertionError(f"PNWM steps launched {launches}")
    for k in ("fused_stem", "fused_bottleneck"):
        kernels[k].setdefault("launches_by_path", {})["fcosv3_pnwm_step"] = \
            FCOSV3_STEP_LAUNCHES[k]
    copy = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in ("center_mask", "border_mask", "size_map"):
            torch.as_tensor(batch[k], dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        copy.append((time.perf_counter() - t0) * 1e3)
    mb = sum(batch[k].nbytes for k in ("center_mask", "border_mask", "size_map")) / 1e6
    report.update(pnwm_peak_gib=peak, pnwm_img_s=rate, pnwm_map_ms=map_ms,
                  pnwm_maps_copy_ms=float(np.mean(copy[1:])))
    log(f"fcosv3 PNWM on mapper maps ({smi}): the mapper {map_ms:.1f} ms/img on the host "
        f"(C renderer, 800x1333, up to 20 instances); B=16 step {rate:.2f} img/s, peak "
        f"{peak:.2f} GiB; the three maps' copy {mb:.1f} MB {np.mean(copy[1:]):.2f} ms a step; "
        f"centre map max {float(batch['center_mask'].max()):.3f}, size map max "
        f"{float(batch['size_map'].max()):.1f} px")


def phase_fcosv3_pack(kernels, dev, smi):
    """A sizes pack written by ``python -m slenderobjdet_torch.tools.
    coco_to_pack --sizes`` (4 images of 800 x 1333, their files stand-in
    bytes: the tool packs them undecoded), read back through the mapper
    (USE_NORI, NORI_PATH, NEED_MASKS, ProposalNetworkWithMasks, test mode)
    with the images inlined: the maps equal the mapper's own rendering within
    MAP_ATOL and SIZE_ATOL (``tests/test_recordpack.py``'s tolerances)."""
    import os
    import tempfile

    from slenderobjdet_torch.data.mapper import DatasetMapper
    from slenderobjdet_torch.tools import coco_to_pack

    split = "chip_smoke_pack"
    rs = np.random.RandomState(58)
    h, w = LOADER_IMAGE_HW
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pack_") as tmp:
        images, annotations, dicts = [], [], []
        for i in range(4):
            fname = f"{i:06d}.png"
            with open(os.path.join(tmp, fname), "wb") as f:
                f.write(rs.bytes(64))
            images.append({"id": i + 1, "file_name": fname, "height": h, "width": w})
            annos = []
            for poly in render_polygons(rs, h, w)[:12]:
                xy = np.clip(poly[0].reshape(-1, 2), 0, [w, h])
                x1, y1 = xy.min(0)
                x2, y2 = xy.max(0)
                if x2 - x1 < 2 or y2 - y1 < 2:
                    continue
                annos.append({"id": len(annotations) + len(annos) + 1, "image_id": i + 1,
                              "category_id": 1, "iscrowd": 0, "area": float((x2 - x1) * (y2 - y1)),
                              "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                              "segmentation": [xy.reshape(-1).tolist()]})
            annotations += annos
            dicts.append({"image": rs.randint(0, 256, (h, w, 3), dtype=np.uint8),
                          "file_name": os.path.join("/nowhere", fname), "image_id": i + 1,
                          "height": h, "width": w,
                          "annotations": [{"bbox": [a["bbox"][0], a["bbox"][1],
                                                    a["bbox"][0] + a["bbox"][2],
                                                    a["bbox"][1] + a["bbox"][3]],
                                           "category_id": 0, "iscrowd": 0,
                                           "segmentation": a["segmentation"]} for a in annos]})
        with open(os.path.join(tmp, "gt.json"), "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": [{"id": 1, "name": "thing"}]}, f)
        t0 = time.perf_counter()
        coco_to_pack.main(["--gt-json", os.path.join(tmp, "gt.json"), "--image-root", tmp,
                           "--out", os.path.join(tmp, f"{split}.pack"), "--sizes"])
        pack_s = time.perf_counter() - t0
        cfg = proposal_cfg("ProposalNetworkWithMasks")
        cfg.defrost()
        cfg.MODEL.META_ARCHITECTURE = "ProposalNetworkWithMasks"
        cfg.NEED_MASKS = True
        cfg.DATASETS.TEST = (split,)
        cfg.freeze()
        inline = DatasetMapper(cfg, is_train=False)
        cfg.defrost()
        cfg.USE_NORI = True
        cfg.NORI_PATH = tmp
        cfg.freeze()
        packed = DatasetMapper(cfg, is_train=False)
        if packed.sizes_pack is None or len(packed.sizes_pack) != 4:
            raise AssertionError("the sizes pack was not opened")
        worst = {}
        for d in dicts:
            a, b = inline(d), packed(d)
            for k, tol in (("center_mask", MAP_ATOL), ("border_mask", MAP_ATOL),
                           ("size_map", SIZE_ATOL)):
                err = float(np.abs(a[k] - b[k]).max())
                worst[k] = max(worst.get(k, 0.0), err)
                if err > tol or not b[k].max() > 0.5:
                    raise AssertionError(f"sizes pack {k}: max diff {err}, max {b[k].max()}")
    log(f"fcosv3 sizes pack: coco_to_pack --sizes wrote 4 images' maps in {pack_s:.2f} s; "
        f"read back through the mapper with inlined images, max diff against its own "
        f"rendering {worst}")


def phase_fcosv3(kernels, dev, smi):
    """FCOSV3 and the masks data path (``fcosv3``): the host renderer, the
    train step, predict, ``main``, ProposalNetworkWithMasks on mapper maps
    and the sizes pack; every sub-phase must pass."""
    report = {}
    phase_fcosv3_render(smi, report)
    model = phase_fcosv3_train(kernels, dev, smi, report)
    torch.cuda.empty_cache()
    phase_fcosv3_predict(kernels, dev, smi, model)
    del model
    torch.cuda.empty_cache()
    phase_fcosv3_trainer(kernels, dev, smi, report)
    torch.cuda.empty_cache()
    phase_fcosv3_pnwm(kernels, dev, smi, report)
    torch.cuda.empty_cache()
    phase_fcosv3_pack(kernels, dev, smi)
    log(f"fcosv3 report ({smi}): {json.dumps(report, default=float)}")


# ----------------------------------------------------------- rotated boxes
ROTATED_RETINANET_YAML = "configs/rotated/rotated_retinanet_R_50_FPN_1x.yaml"
ROTATED_RCNN_YAML = "configs/rotated/faster_rcnn_rotated_R_50_FPN_1x.yaml"
ROTATED_HW = LOADER_SHAPES              # both buckets, 896 x 1408 and 1408 x 896
ROTATED_ANGLES = np.array([-45, -30, -15, 0, 15, 30, 45, 60, 90], np.float32)
# The operations a pair needs, for the bounds (``iou_bound``): the
# extent test (4 gaps, 3 maxima, the margin's maximum and product, the
# comparison) and, for a pair not apart, a clip: four half-planes of a
# 6-vertex ring with 2 crossings (2 + 5 x 6 + 8 x 2 = 48 each), an 8-vertex
# shoelace (4 x 8 + 2) and the IoU (2 adds, a maximum, a division, a
# comparison).
ROTATED_EXTENT_OPS = 10
ROTATED_CLIP_OPS = 4 * 48 + 34 + 5
ROTATED_RETINANET_PREDICT = {"fused_stem": 1, "fused_bottleneck": 13, "rotated_nms": 1}
ROTATED_RETINANET_STEP = {"fused_stem": 1, "fused_bottleneck": 13, "rotated_iou": 16}
ROTATED_RCNN_PREDICT = {"fused_stem": 1, "fused_bottleneck": 13, "rotated_nms": 2}
ROTATED_RCNN_STEP = {"fused_stem": 1, "fused_bottleneck": 13, "rotated_iou": 32,
                     "rotated_nms": 1}
ROTATED_KERNELS = ("rotated_iou", "rotated_nms")
# a test setting, as WARMUP_ITERS 0 is: RetinaNet's 2e-4 gives NaN by step 5
# here, where 27 anchors a cell put ~14,000 positives in a batch
ROTATED_RETINANET_TRAIN_LR = 2e-5


def rotated_train_batch(batch: int, seed: int, hw):
    """``train_batch`` with each gt box turned into an XYWHA box of the same
    centre and sides at an angle from ROTATED_ANGLES (``gt_rboxes``; the
    padded rows stay 0)."""
    out = train_batch(batch, seed=seed, hw=hw)
    rs = np.random.RandomState(seed + 1)
    b = out["gt_boxes"]
    rboxes = np.stack([(b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2,
                       b[..., 2] - b[..., 0], b[..., 3] - b[..., 1],
                       rs.choice(ROTATED_ANGLES, b.shape[:2])], -1).astype(np.float32)
    out["gt_rboxes"] = np.where(out["gt_valid"][..., None], rboxes, 0.0).astype(np.float32)
    return out


def rotated_synthetic_dataset(name, tmpdir, seed=10, repeat=1):
    """``synthetic_dataset`` with polygons, made an rcoco dataset: every
    annotation's rbox is ``rbox_from_polygon`` of its segmentation (the
    rcoco loader's rule, without cv2), in the dataset dicts and in the json
    the rotated evaluator reads (whose ratios come from the polygons)."""
    from slenderobjdet_torch.data import DatasetCatalog, MetadataCatalog
    from slenderobjdet_torch.structures.masks import rbox_from_polygon

    gt = synthetic_dataset(name, tmpdir, seed=seed, repeat=repeat, polygons=True)
    by_image = {}
    for a in gt["annotations"]:
        by_image.setdefault(a["image_id"], []).append(a)
    for d in DatasetCatalog.get(name):
        for a, j in zip(d["annotations"], by_image.get(d["image_id"], [])):
            if "rbox" not in a:
                a["rbox"] = rbox_from_polygon(a["segmentation"])
            j["segmentation"], j["rbox"] = a["segmentation"], a["rbox"]
    meta = MetadataCatalog.get(name)
    with open(meta.json_file, "w") as f:
        json.dump(gt, f)
    meta.set(evaluator_type="rcoco")
    return gt


def check_corners(boxes, what):
    """The corner kernel bit for bit against ``rotated_to_corners``."""
    from slenderobjdet_torch.ops.rotated import _corners_and_areas, rotated_to_corners

    boxes = boxes.float()
    got = _corners_and_areas(boxes)
    want = (rotated_to_corners(boxes).reshape(*boxes.shape[:-1], 8), boxes[..., 2] * boxes[..., 3])
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        bad = int((got[0] != want[0]).sum())
        raise AssertionError(f"rotated corners {what}: {bad} coordinates differ from "
                             f"rotated_to_corners")


def iou_bound(n_bytes, rows, cols):
    """(ms, by, operations, pairs, pairs clipped): the bound of the IoU of
    ``rows`` (R, 5) x ``cols`` (C, 5): ROTATED_EXTENT_OPS a pair plus
    ROTATED_CLIP_OPS a pair whose extents are not apart (``extents_apart``)
    and whose row is not a point (``is_point``)."""
    from slenderobjdet_torch.ops.rotated import extents_apart, is_point, rotated_to_corners

    c2 = rotated_to_corners(cols.float())[None]
    near = 0
    for r0 in range(0, rows.shape[0], 10):
        c1 = rotated_to_corners(rows[r0:r0 + 10].float())[:, None]
        near += int((~extents_apart(c1, c2) & ~is_point(c1)).sum())
    pairs = rows.shape[0] * cols.shape[0]
    ops = pairs * ROTATED_EXTENT_OPS + near * ROTATED_CLIP_OPS
    return (*bound_ms(n_bytes, ops, PEAK_FP32_FLOPS), ops, pairs, near)


def greedy_pairs(boxes, scores, valid, thr, got):
    """(pairs, pairs clipped) that greedy NMS needs on these inputs: each
    candidate against the kept boxes before it in sorted order, up to and
    including the first that suppresses it, the candidates taken up to the
    last kept box once ``max_out`` are kept, else up to the last
    selectable one; clipped, those not ``extents_apart`` whose kept box is
    not ``is_point``. The suppressions come from the plain IoU (the kept
    box's polygon clipped by the candidate's box), and the candidates that
    no kept box suppresses must be the kept ones, or it fails."""
    from slenderobjdet_torch.ops import rotated as rot

    B, N = scores.shape
    max_out = got[0].shape[1]
    scores = scores.float()
    selectable = valid & (scores > rot.NEG_INF / 2)
    live = torch.where(selectable, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(live, dim=1, descending=True, stable=True).indices
    pairs = near = 0
    for b in range(B):
        m = int(selectable[b].sum())
        kept = got[0][b][got[1][b]].long()
        if kept.numel() == 0:
            if m:
                raise AssertionError(f"greedy_pairs image {b}: {m} selectable, none kept")
            continue
        pos = torch.empty(N, dtype=torch.long, device=scores.device)
        pos[order[b]] = torch.arange(N, device=scores.device)
        p = pos[kept]
        end = int(p[-1]) + 1 if kept.numel() == max_out else m
        cand = order[b][:end]
        c = rot.rotated_to_corners(boxes[b].float())
        a = boxes[b, :, 2].float() * boxes[b, :, 3].float()
        cc, ac = c[cand][None], a[cand][None]
        later = p[:, None] < torch.arange(end, device=p.device)[None]
        supp, skip, rows = [], [], max(1, rot.PLAIN_CHUNK // end)
        for r0 in range(0, kept.numel(), rows):
            k = kept[r0:r0 + rows]
            ck = c[k][:, None]
            inter = rot._pair_intersection_area(ck, cc)
            iou = inter / torch.clamp(a[k][:, None] + ac - inter, min=1e-12)
            supp.append(iou > thr)
            skip.append(rot.extents_apart(ck, cc) | rot.is_point(ck))
        supp = torch.cat(supp) & later
        first = torch.where(supp.any(0), supp.to(torch.int8).argmax(0),
                            torch.full((end,), kept.numel(), device=p.device))
        tested = later & (torch.arange(kept.numel(), device=p.device)[:, None] <= first[None])
        unsuppressed = (first == kept.numel()).nonzero()[:, 0]
        if not torch.equal(unsuppressed, p.sort().values):
            raise AssertionError(f"greedy_pairs image {b}: the candidates no kept box "
                                 f"suppresses are not the kept ones")
        pairs += int(tested.sum())
        near += int((tested & ~torch.cat(skip)).sum())
    return pairs, near


def nms_kernel_ms(fn, iters=5):
    """Device ms a call of the NMS's three kernels from the profiler's
    CUDA times, or None where it shows none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for part in ("sort", "bits", "walk"):
            if f"rotated_nms_{part}_kernel" in e.key:
                out[part] = out.get(part, 0.0) + e.device_time_total / 1e3 / iters
    return out or None


def rotated_iou_check(kernels, smi, family, gt, anchors, key):
    """The IoU kernel at a main-path shape (one image's 100 padded gt
    against all its anchors) against the plain version on the same input,
    bit for bit, and the corner kernel against ``rotated_to_corners``; then
    the kernel alone (queued, on prepared corners) and the wrapper call
    timed, and the plain version; the bound from the inputs
    (``iou_bound``)."""
    from slenderobjdet_torch.ops import rotated as rot

    check_corners(gt, f"{family} {key} gt")
    check_corners(anchors, f"{family} {key} anchors")
    got = rot.launch_rotated_iou(gt, anchors)
    want, plain_ms = timed_once(lambda: rot.plain_pairwise_rotated_iou(gt, anchors))
    if not torch.equal(got, want):
        raise AssertionError(f"rotated_iou {family} {key}: kernel != plain at "
                             f"{int((got != want).sum())} pairs, max |diff| "
                             f"{float((got - want).abs().max()):.3e}")
    overlap = int((want > 0).sum())
    del want
    prepared = (*rot._corners_and_areas(gt), *rot._corners_and_areas(anchors), got)
    kernel_ms = cuda_ms(lambda: rot.iou_from_corners(*prepared), 20, queued=True)
    call_ms = cuda_ms(lambda: rot.launch_rotated_iou(gt, anchors), 20)
    b_ms, b_by, ops, pairs, near = iou_bound(nbytes(gt, anchors, got), gt, anchors)
    log(f"rotated_iou {family} {key}: {tuple(gt.shape)} x {tuple(anchors.shape)}, kernel == "
        f"plain, {overlap} pairs overlap, {near} of {pairs} pairs clipped; corners == "
        f"rotated_to_corners")
    log(f"time rotated_iou {family} {key} ({smi}): kernel {kernel_ms:.4f} ms, call "
        f"{call_ms:.4f} ms, plain {plain_ms:.2f} ms; bound {b_ms:.4f} ms ({b_by}; {ops:.4e} "
        f"operations needed), {b_ms / kernel_ms:.4f} of bound")
    entry = {"ms": kernel_ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": None, "max_abs_err": 0.0, "pairs": pairs,
             "pairs_clipped": near, "ops_needed": ops}
    kernels["rotated_iou"][f"at_{family}_{key}"] = entry
    return entry


def rotated_nms_check(kernels, smi, family, key, boxes, scores, valid, thr, max_out):
    """The NMS kernels on a model's own (offset) candidates against the
    plain greedy loop: identical keep lists, or it fails; then the kernels
    alone (queued, on prepared inputs), each kernel's share (profiler) and
    the wrapper call timed, and the plain loop; the bound from the inputs:
    the (kept box, candidate) pairs greedy NMS needs (``greedy_pairs``)."""
    from slenderobjdet_torch.ops import rotated as rot

    check_corners(boxes, f"{family} {key}")
    got = rot.launch_rotated_nms(boxes, scores, thr, max_out, valid=valid)
    want, plain_ms = timed_once(lambda: rot.plain_rotated_nms(boxes, scores, thr, max_out,
                                                              valid=valid))
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"rotated_nms kernel != plain on {family}'s {key} candidates: "
                             f"{int((got[0] != want[0]).sum())} indices differ")
    kept = got[1].sum(1).tolist()
    B, N = scores.shape
    inputs = rot.nms_kernel_inputs(boxes, scores, max_out, valid)
    kernel = lambda: rot.nms_from_inputs(inputs, thr)
    kernel_ms = cuda_ms(kernel, 5, queued=True)
    call_ms = cuda_ms(lambda: rot.launch_rotated_nms(boxes, scores, thr, max_out,
                                                     valid=valid), 5)
    parts = nms_kernel_ms(kernel)
    pairs, near = greedy_pairs(boxes, scores, valid, thr, got)
    ops = pairs * ROTATED_EXTENT_OPS + near * ROTATED_CLIP_OPS
    b_ms, b_by = bound_ms(nbytes(boxes, scores, valid, *got), ops, PEAK_FP32_FLOPS)
    log(f"rotated_nms {family} {key} ({smi}): kernel == plain at B={B} N={N} thr {thr} "
        f"max_out {max_out}, {float(valid.float().mean()):.3e} valid, kept an image "
        f"{min(kept)}-{max(kept)}; (kept, candidate) pairs greedy NMS needs {pairs}, "
        f"{near} clipped")
    log(f"time rotated_nms {family} {key} ({smi}): kernel {kernel_ms:.4f} ms, call "
        f"{call_ms:.4f} ms, plain {plain_ms:.2f} ms; by kernel (profiler) "
        + (", ".join(f"{k} {v:.4f}" for k, v in parts.items()) if parts else "not measured")
        + f"; bound {b_ms:.4f} ms ({b_by}; {ops:.4e} operations needed), "
        f"{b_ms / kernel_ms:.4f} of bound")
    entry = {"batch": B, "candidates": N, "max_out": max_out, "thr": thr, "ms": kernel_ms,
             "call_ms": call_ms, "parts_ms": parts, "plain_ms": plain_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": None, "max_abs_err": 0.0, "kept": sum(kept),
             "pairs": pairs, "pairs_clipped": near, "ops_needed": ops,
             "scratch_bytes": inputs["scratch"].numel()}
    kernels["rotated_nms"][f"at_{family}_{key}"] = entry
    return entry


def check_rotated_outputs(out, batch, proposals=None):
    shapes = {"boxes": (batch, 100, 5), "scores": (batch, 100), "classes": (batch, 100),
              "valid": (batch, 100)}
    if proposals:
        shapes.update({"proposals": (batch, proposals, 5), "proposal_scores": (batch, proposals),
                       "proposal_valid": (batch, proposals)})
    if sorted(out) != sorted(shapes):
        raise AssertionError(f"predict returned {sorted(out)}")
    for k, s in shapes.items():
        if tuple(out[k].shape) != s:
            raise AssertionError(f"{k} shape {tuple(out[k].shape)} != {s}")
        if out[k].is_floating_point() and not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"non-finite {k}")


def rotated_predict_calls(kernels, smi, family, model, plain, reqs, want_counts, proposals=None):
    """``predict`` on each request with the launch counts reset before and
    read after each call; outputs checked; returns the outputs."""
    from slenderobjdet_torch.ops import _build

    per_call, outs = [], []
    for r in reqs:
        _build.reset_launch_counts()
        outs.append(model.predict(r))
        torch.cuda.synchronize()
        per_call.append({k: v for k, v in _build.launch_counts().items() if v})
    log(f"{family} predict launches a call of B={reqs[0]['image'].shape[0]} at "
        f"{[r['image'].shape[1:3] for r in reqs]}: {per_call}")
    if any(c != want_counts for c in per_call):
        raise AssertionError(f"{family} predict launched {per_call}, expected {want_counts}")
    kernels["rotated_nms"].setdefault("launches_by_path", {})[f"{family}_predict"] = sum(
        c["rotated_nms"] for c in per_call)
    kernels["rotated_nms"]["launches"] += sum(c["rotated_nms"] for c in per_call)
    for out in outs:
        check_rotated_outputs(out, reqs[0]["image"].shape[0], proposals)
    counts = [o["valid"].sum(1).tolist() for o in outs]
    log(f"{family} predict: keep_valid counts an image {counts}")
    if sum(map(sum, counts)) <= 0:
        raise AssertionError(f"{family}: no valid detections")
    ms = cuda_ms(lambda: model.predict(reqs[0]), 3)
    log(f"time {family} predict ({smi}): B=8 {reqs[0]['image'].shape[1:3]} fused "
        f"{ms:.2f} ms, {8e3 / ms:.2f} img/s")
    return outs


def phase_rotated_retinanet(kernels, dev, smi):
    """RotatedRetinaNet R-50-FPN (the rotated yaml, nothing cut, bf16, flags
    on and off, seeded, FrozenBN away from identity) at both loader buckets:
    head outputs against fp32; the IoU kernel at the train step's shape (100
    padded gt x 708,939 anchors) and the NMS kernel on the model's own 5,000
    class-offset candidates (B=8, 100 slots), each against its plain
    version; 3 predict calls of B=8 a bucket with exactly 1 stem, 13
    bottleneck and 1 rotated NMS launch each; fused against unfused
    detections class by class (``comparable_retinanet``, ``match_detections``)."""
    from slenderobjdet_torch.ops.rotated import offset_boxes

    models = list(build_models(dev, ROTATED_RETINANET_YAML, RETINANET_CLS_BIAS))
    model, plain, ref32 = models
    reqs = {hw: requests(3, 8, seed=31 + i, hw=hw) for i, hw in enumerate(ROTATED_HW)}
    check_heads("rotated_retinanet", ("logits", "deltas"), reqs[ROTATED_HW[0]][0], dev,
                model, plain, ref32)
    del ref32, models[2]
    torch.cuda.empty_cache()
    hw = ROTATED_HW[0]
    with torch.inference_mode():
        top = model(torch.as_tensor(reqs[hw][0]["image"], device=dev))[0][-1].flatten()
        shift = RETINANET_CLS_BIAS - float(torch.kthvalue(top, int(0.995 * top.numel())).values)
        for m in (model, plain):
            classifier(m).bias.add_(shift)
        del top
        for i, h in enumerate(ROTATED_HW):
            images = torch.as_tensor(reqs[h][0]["image"], device=dev)
            boxes, scores, classes, valid = model.candidates(*model(images), h)
            if tuple(boxes.shape) != (8, 5000, 5):
                raise AssertionError(f"rotated RetinaNet candidates {tuple(boxes.shape)}")
            e = rotated_nms_check(kernels, smi, "rotated_retinanet", f"predict_B8_{h[0]}x{h[1]}",
                                  offset_boxes(boxes, classes), scores, valid,
                                  model.nms_thresh, model.max_dets)
            if i == 0:
                kernels["rotated_nms"].update(
                    {k: e[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "max_abs_err")})
            del images, boxes, scores, classes, valid
        anchors, _ = model.anchors(hw)
        if anchors.shape[0] != 708939:
            raise AssertionError(f"{anchors.shape[0]} rotated anchors at {hw}")
        gt = torch.as_tensor(rotated_train_batch(1, 33, hw)["gt_rboxes"][0], device=dev)
        e = rotated_iou_check(kernels, smi, "rotated_retinanet", gt, anchors,
                              "train_100x708939")
        kernels["rotated_iou"].update({k: e[k] for k in ("ms", "plain_ms", "bound_ms",
                                                         "bound_by", "library_ms",
                                                         "max_abs_err")})
    torch.cuda.empty_cache()
    comparable_retinanet(torch.Generator().manual_seed(34), model, plain)
    matched = same_box = total = 0
    diffs = []
    for h in ROTATED_HW:
        outs = rotated_predict_calls(kernels, smi, f"rotated_retinanet_{h[0]}x{h[1]}", model,
                                     plain, reqs[h], ROTATED_RETINANET_PREDICT)
        for r, out in zip(reqs[h], outs):
            ref = plain.predict(r)
            check_rotated_outputs(ref, 8)
            m, sb, t, d = match_detections(out, ref, 8)
            matched, same_box, total, diffs = matched + m, same_box + sb, total + t, diffs + d
    share = matched / max(total, 1)
    log(f"rotated_retinanet fused vs unfused detections: {matched}/{total} slots matched by "
        f"class with score diff <= {SCORE_TOL} ({same_box} with the same box); score diff "
        f"median {np.median(diffs):.3e}, max {np.max(diffs):.3e}")
    if share < MATCH_MIN:
        raise AssertionError(f"rotated_retinanet fused vs unfused: {share:.4f} matched")


def rotated_train_steps(kernels, dev, smi, family, yaml, lr, seed, step_launches,
                        unfused_launches, part_keys, randomize):
    """The train step at full width entered as a trainer does: 11 steps on
    one batch of 16 images at 896 x 1408 with 100 padded rotated gt, then 4
    more a model, flags on and off in turns, each step launching exactly
    ``step_launches`` (flags off: ``unfused_launches``); WARMUP_ITERS 0."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.solver import build_optimizer

    gen = torch.Generator().manual_seed(seed)
    steps, weights = {}, None
    for key in ("fused", "unfused"):
        cfg = train_cfg(key == "fused", yaml=yaml)
        cfg.defrost()
        cfg.SOLVER.BASE_LR = lr
        cfg.freeze()
        m = build_model(cfg, device=dev, generator=gen)
        if weights is None:
            randomize(m, gen)
            weights = {k: v.clone() for k, v in m.state_dict().items()}
        else:
            m.load_state_dict(weights)
        steps[key] = make_train_step(m, build_optimizer(cfg, m), cfg)
    del weights
    batch = rotated_train_batch(16, seed + 1, ROTATED_HW[0])
    rates = {}
    peaks = train_turns(family, steps, batch, part_keys, rates,
                        launches={"fused": step_launches, "unfused": unfused_launches})
    steps_a_model = TRAIN_STEPS + 1 + 4
    for k in ROTATED_KERNELS:
        if k in step_launches:
            kernels[k].setdefault("launches_by_path", {})[f"{family}_train_step"] = \
                step_launches[k]
            # train_turns held every step of both models to its exact counts
            kernels[k]["launches"] += steps_a_model * (step_launches[k]
                                                      + unfused_launches.get(k, 0))
    h, w = ROTATED_HW[0]
    log(f"time {family} train ({smi}): B=16 {h}x{w}, 100 padded gt: fused "
        f"{rates['fused']:.2f} img/s, peak {peaks['fused']:.2f} GiB; unfused "
        f"{rates['unfused']:.2f} img/s, peak {peaks['unfused']:.2f} GiB")


def phase_rotated_retinanet_train(kernels, dev, smi):
    """The RotatedRetinaNet train step: 1 stem, 13 bottleneck and 16 rotated
    IoU launches (one an image) a fused step, BASE_LR ROTATED_RETINANET_TRAIN_LR."""
    rotated_train_steps(kernels, dev, smi, "rotated_retinanet", ROTATED_RETINANET_YAML,
                        ROTATED_RETINANET_TRAIN_LR, 35, ROTATED_RETINANET_STEP, {"rotated_iou": 16},
                        ("loss_cls", "loss_box_reg", "num_pos"), randomize_frozen_bn)


def phase_rotated_retinanet_trainer(kernels, dev, smi):
    """``train_net_torch.main`` on the rotated RetinaNet YAML over an rcoco
    dataset (``family_trainer``; SCORE_THRESH_TEST 0 so that the random
    model's detections reach the rotated evaluator)."""
    family_trainer(kernels, smi, "rotated_retinanet", ROTATED_RETINANET_YAML, 36,
                   ROTATED_RETINANET_STEP, predict_nms=1, rotated=True,
                   overrides={"MODEL.RETINANET.SCORE_THRESH_TEST": 0.0})


def build_rotated_rcnn_models(dev):
    """The rotated Faster R-CNN fused in bf16 and the same weights unfused
    in bf16 and in fp32 (``randomize_rcnn``)."""
    from slenderobjdet_torch.models import build_model

    gen = torch.Generator().manual_seed(37)
    model = build_model(flagship_cfg(True, yaml=ROTATED_RCNN_YAML), device=dev, generator=gen)
    randomize_rcnn(model, gen)
    models = [model]
    for dtype in ("bfloat16", "float32"):
        m = build_model(flagship_cfg(False, dtype, yaml=ROTATED_RCNN_YAML), device=dev)
        m.load_state_dict(model.state_dict())
        models.append(m)
    return models


def comparable_rotated_rcnn(*models):
    """``comparable_rcnn`` for 5-delta boxes: the bbox_pred filters 0 and
    its bias (0, 0, -60, -60, 0) a class, so every detection is its
    proposal shrunk to a point at its centre."""
    with torch.no_grad():
        for m in models:
            pred = m.roi_box.outputs.bbox_pred
            pred.weight.zero_()
            pred.bias.copy_(torch.tensor([0.0, 0.0, -60.0, -60.0, 0.0]).repeat(
                pred.bias.numel() // 5))


def phase_rotated_rcnn(kernels, dev, smi):
    """The rotated Faster R-CNN R-50-FPN (RRPN + RROIHeads, nothing cut, bf16,
    flags on and off) at both buckets: RPN outputs and ROI features against
    fp32; the IoU kernel at the RRPN's train shape (100 x 945,252) and the
    ROI sampling's (100 x 1,100); the NMS kernel on the RRPN's own level-
    offset candidates at predict (B=8, 5,000 -> 1,000) and train (B=16,
    10,000 -> 1,000) and on the box head's class-offset candidates (B=8,
    1,000 -> 100); 3 predict calls of B=8 a bucket with exactly 1 stem, 13
    bottleneck and 2 rotated NMS launches; fused against unfused detections
    on shared proposals."""
    from slenderobjdet_torch.ops.rotated import offset_boxes

    models = build_rotated_rcnn_models(dev)
    model, plain, ref32 = models
    reqs = {hw: requests(3, 8, seed=38 + i, hw=hw) for i, hw in enumerate(ROTATED_HW)}
    check_heads("rotated_rcnn", ("rpn logits", "rpn deltas", "roi features"),
                reqs[ROTATED_HW[0]][0], dev, model, plain, ref32)
    models.pop()
    del ref32
    torch.cuda.empty_cache()
    rpn, roi = model.rpn, model.roi_heads
    hw = ROTATED_HW[0]
    anchors, counts = model.rpn_anchors(hw)
    if anchors.shape[0] != 945252:
        raise AssertionError(f"{anchors.shape[0]} RRPN anchors at {hw}")

    def rpn_outputs(images):
        logits_l, deltas_l, feats = model(torch.as_tensor(images, device=dev))
        sizes = torch.tensor([hw] * images.shape[0], device=dev)
        return torch.cat(logits_l, 1), torch.cat(deltas_l, 1), feats, sizes

    with torch.inference_mode():
        for key, images, train in (
                ("rrpn_predict_B8", reqs[hw][0]["image"], False),
                ("rrpn_train_B16", rotated_train_batch(16, 40, hw)["image"], True)):
            logits, deltas, _, sizes = rpn_outputs(images)
            boxes, scores, ok, _, levels = rpn.candidates(anchors, counts, logits, deltas,
                                                          sizes, train)
            rotated_nms_check(kernels, smi, "rotated_rcnn", key, offset_boxes(boxes, levels),
                              scores, ok, rpn.nms_thresh, rpn.post_nms_topk[train])
            del logits, deltas, boxes, scores, ok, levels
        torch.cuda.empty_cache()
        gt = torch.as_tensor(rotated_train_batch(1, 41, hw)["gt_rboxes"][0], device=dev)
        rotated_iou_check(kernels, smi, "rotated_rcnn", gt, anchors, "rrpn_train_100x945252")
        logits, deltas, feats, sizes = rpn_outputs(reqs[hw][0]["image"])
        props, _, prop_valid = rpn.proposals(anchors, counts, logits, deltas, sizes, train=False)
        rotated_iou_check(kernels, smi, "rotated_rcnn", gt, torch.cat([props[0], gt]),
                          "roi_sampling_100x1100")
        shape_rcnn_classifier(models, feats, props, prop_valid)
        boxes, scores, classes, valid, _ = roi.candidates(model.roi_box, feats, props, prop_valid)
        rotated_nms_check(kernels, smi, "rotated_rcnn", "box_head_B8",
                          offset_boxes(boxes, classes), scores, valid, roi.nms_thresh,
                          roi.max_dets)
        del logits, deltas, feats, props, boxes, scores, classes, valid
    torch.cuda.empty_cache()

    comparable_rotated_rcnn(model, plain)
    matched = swapped = total = 0
    for h in ROTATED_HW:
        outs = rotated_predict_calls(kernels, smi, f"rotated_rcnn_{h[0]}x{h[1]}", model, plain,
                                     reqs[h], ROTATED_RCNN_PREDICT,
                                     proposals=rpn.post_nms_topk[False])
        for r, out in zip(reqs[h], outs):
            with torch.inference_mode():
                _, _, feats = plain(torch.as_tensor(r["image"], device=dev))
                scale = torch.as_tensor(r["scale"], device=dev)
                ref = roi.inference(plain.roi_box, feats, out["proposals"],
                                    out["proposal_valid"], scale,
                                    torch.as_tensor(r["orig_size"], device=dev))
                ref_cands = roi.candidates(plain.roi_box, feats, out["proposals"],
                                           out["proposal_valid"])
            m, e, t, _, _ = match_on_shared_proposals(out, ref, ref_cands, 8, roi.score_thresh)
            matched, swapped, total = matched + m, swapped + e, total + t
            del feats
    share = (matched + swapped) / max(total, 1)
    log(f"rotated_rcnn fused vs unfused on shared proposals: {matched}/{total} slots matched "
        f"by (class, box), {swapped} swapped at the cut: {share:.4f}")
    if share < MATCH_MIN:
        raise AssertionError(f"rotated_rcnn fused vs unfused: {share:.4f} of slots matched")


def phase_rotated_rcnn_train(kernels, dev, smi):
    """The rotated Faster R-CNN train step: 1 stem, 13 bottleneck, 32 rotated
    IoU (16 RRPN matches, 16 proposal samplings) and 1 rotated NMS launch a
    fused step, BASE_LR RCNN_TRAIN_LR."""
    rotated_train_steps(kernels, dev, smi, "rotated_rcnn", ROTATED_RCNN_YAML, RCNN_TRAIN_LR, 42,
                        ROTATED_RCNN_STEP, {"rotated_iou": 32, "rotated_nms": 1},
                        ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "num_fg"),
                        randomize_rcnn)


def phase_rotated_rcnn_trainer(kernels, dev, smi):
    """``train_net_torch.main`` on the rotated Faster R-CNN YAML over an
    rcoco dataset. SCORE_THRESH_TEST -1 makes every one of the top 1000
    (proposal, class) pairs a candidate: the random box head's logits are
    so far apart that in fp32 the background's softmax is 1 and every
    class's 0, which no threshold of 0 or above passes."""
    family_trainer(kernels, smi, "rotated_rcnn", ROTATED_RCNN_YAML, 43, ROTATED_RCNN_STEP,
                   predict_nms=2, rotated=True,
                   overrides={"MODEL.ROI_HEADS.SCORE_THRESH_TEST": -1.0})


# ------------------------------------------------------------ CornerNet
CORNER_YAML = "configs/corner/corner_net_hourglass.yaml"
CORNER_HW = LOADER_SHAPES           # both buckets, 896 x 1408 and 1408 x 896
CORNER_PREDICT = {"corner_pool": 2, "nms": 1}   # the last stack's TL and BR heads, one NMS
CORNER_STEP = {"corner_pool": 8}    # four heads: 4 forward and 4 backward wrapper calls
CORNER_TAG_STD = 0.3                # the tags' spread at the top corners (shape_cornernet)
CORNER_HEAT_STD = 0.5               # the raised classes' heat logit spread over an image
CORNER_HEAT_CLASSES = 4             # the classes whose heat is raised
CORNER_HEAT_RAISE = 1.0             # by this much above the prior, on average
CORNER_BATCHES = (8, 4, 2)          # the step without remat: the largest that fits
CORNER_REMAT_BATCHES = (16, 8, 4, 2)   # with TPU.REMAT_BACKBONE
CORNER_OPS_FWD = 3                  # fp32 operations an output element: two maxima, one add
CORNER_OPS_BWD = 4                  # an input element: two comparisons, two adds


def corner_cfg(dtype="bfloat16", remat=False, batch=None):
    """The CornerNet yaml, nothing cut, WARMUP_ITERS 0 (full LR from step 0,
    a test setting), ``TPU.REMAT_BACKBONE`` as given."""
    cfg = flagship_cfg(False, dtype, CORNER_YAML)
    cfg.defrost()
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.TPU.REMAT_BACKBONE = remat
    if batch is not None:
        cfg.SOLVER.IMS_PER_BATCH = batch
    cfg.freeze()
    return cfg


@contextlib.contextmanager
def plain_corner_pool():
    """CornerNet's heads on the plain ``torch.cummax`` compositions (the
    kernel's oracle) instead of the kernel, for a comparison."""
    from slenderobjdet_torch.models.meta_arch import corner_net
    from slenderobjdet_torch.ops import corner_pool

    saved = corner_net.tl_pool, corner_net.br_pool
    corner_net.tl_pool, corner_net.br_pool = corner_pool.plain_tl_pool, corner_pool.plain_br_pool
    try:
        yield
    finally:
        corner_net.tl_pool, corner_net.br_pool = saved


def top_corners(logit, k=100):
    """The (y, x) of each image's ``k`` highest 3 x 3 peaks of ``logit``
    (B, H, W): (B, k) each."""
    b, h, w = logit.shape
    pooled = torch.nn.functional.max_pool2d(logit[:, None], 3, stride=1, padding=1)[:, 0]
    peaks = torch.where(logit == pooled, logit, float("-inf")).reshape(b, h * w)
    loc = torch.topk(peaks, k, dim=1).indices
    return loc // w, loc % w


def shape_cornernet(model, images):
    """Seeded random weights made to give detections, as trained ones do,
    whatever the seed. A random head puts each side's top corners in a class
    of its own, often at the image's border, with tags far apart, so no TL x
    BR pair forms; so, from the heads' outputs on ``images``, after the
    BatchNorm running statistics are recomputed over them
    (``precise_bn_stats``; the drawn ones leave the trunk's activations
    unnormalised through its ~100 layers): the first CORNER_HEAT_CLASSES
    classes share class 0's heat filter, scaled to a spread of
    CORNER_HEAT_STD about a logit CORNER_HEAT_RAISE above the prior's, with
    the sign on each side (of the four pairs) that puts the most BR corners
    below and right of the TL ones; the other classes sit at the prior; the
    tags are centred on 0 at each side's top corners with a spread of
    CORNER_TAG_STD there, so that some pairs' tags lie within 0.5 of each
    other and some do not."""
    from slenderobjdet_torch.models.layers import precise_bn_stats, prior_bias
    from slenderobjdet_torch.models.meta_arch.corner_net import HEAT_PRIOR

    precise_bn_stats(model, [images])
    n, prior = CORNER_HEAT_CLASSES, prior_bias(HEAT_PRIOR)
    with torch.no_grad():
        outs = model(torch.as_tensor(images, device=model.pixel_mean.device))
        for i, sides in enumerate(outs):
            heads = [getattr(model, f"{side}_head{i}") for side in ("tl", "br")]
            maps, scales = [], []
            for head, (heat, _, _) in zip(heads, sides):
                y = heat[..., 0].float() - head.heat_out.bias[0].float()
                scales.append(CORNER_HEAT_STD / y.std())
                maps.append(y * scales[-1])

            def below_right(signs):
                (ty, tx), (by, bx) = (top_corners(s * m) for s, m in zip(signs, maps))
                return float(((by[:, None, :] > ty[:, :, None])
                              & (bx[:, None, :] > tx[:, :, None])).float().mean())

            signs = max(((1, 1), (1, -1), (-1, 1), (-1, -1)), key=below_right)
            for head, (_, tag, _), sign, m, c in zip(heads, sides, signs, maps, scales):
                out = head.heat_out
                out.weight[:n] = out.weight[0] * (sign * c)
                out.weight[n:] = 0
                out.bias[:n] = prior + CORNER_HEAT_RAISE - float((sign * m).mean())
                out.bias[n:] = prior
                ys, xs = top_corners(sign * m)
                t = torch.gather(tag.float().flatten(1), 1, ys * tag.shape[2] + xs)
                out, scale = head.tag_out, CORNER_TAG_STD / t.std()
                out.bias.copy_((out.bias.float() - t.mean()) * scale)
                out.weight.mul_(scale)


def corner_pool_check(kernels, smi, dev):
    """The corner-pool kernel at the heads' shapes, (8, 128, H / 4, W / 4)
    for both buckets, bf16 and fp32, both corners, on ReLU outputs (the
    heads pool ReLU outputs: ties at zero): the forward bit for bit against
    the plain ``torch.cummax`` composition; the backward against the plain
    version's autograd in fp32 on the same values (with the same support;
    fp32 within FP32_TOL of the largest, bf16 within one bf16 rounding of
    each value, and the plain bf16 autograd's own error stated); then the
    wrapper calls (forward and backward) and their kernels alone
    (``forward_into`` / ``backward_into``, queued, on prepared tensors and
    scratch), the plain forward and the plain forward + backward timed,
    each beside its bound (bytes: a, b and out; a, b, g, g_a and g_b)."""
    from slenderobjdet_torch.ops import corner_pool as cp

    gen = torch.Generator(device=dev).manual_seed(53)
    for h, w in CORNER_HW:
        shape = (8, 128, h // 4, w // 4)
        for dtype in (torch.bfloat16, torch.float32):
            def draw():
                return torch.relu(torch.randn(shape, device=dev, generator=gen)).to(
                    dtype).contiguous(memory_format=torch.channels_last)

            a, b = draw(), draw()
            g = torch.randn(shape, device=dev, generator=gen).to(dtype).contiguous(
                memory_format=torch.channels_last)
            for corner in ("tl", "br"):
                plain = getattr(cp, f"plain_{corner}_pool")
                got = cp.launch_corner_pool(a, b, corner)
                if not torch.equal(got, plain(a, b)):
                    raise AssertionError(f"corner_pool {corner} {dtype} {h}x{w}: forward differs")
                grads = cp.launch_corner_pool_backward(a, b, g, corner)

                def plain_grads(cast):
                    ta = a.to(cast, copy=True).requires_grad_()
                    tb = b.to(cast, copy=True).requires_grad_()
                    (plain(ta, tb) * g.to(cast)).sum().backward()
                    return ta.grad.float(), tb.grad.float()

                err = plain_err = 0.0
                for k, r, p in zip(grads, plain_grads(torch.float32), plain_grads(dtype)):
                    if not torch.equal(k != 0, r != 0):
                        raise AssertionError(f"corner_pool {corner} {dtype}: gradient support")
                    diff = (k.float() - r).abs()
                    err = max(err, float(diff.max() / r.abs().max()))
                    plain_err = max(plain_err, float((p - r).abs().max() / r.abs().max()))
                    if dtype == torch.bfloat16 and not bool(
                            (diff <= 2 ** -8 * r.abs() + 1e-6 * r.abs().max()).all()):
                        raise AssertionError(f"corner_pool {corner} bf16: a gradient is more "
                                             f"than one bf16 rounding from fp32")
                if dtype == torch.float32 and err > FP32_TOL:
                    raise AssertionError(f"corner_pool {corner} fp32 gradient err {err}")
                ms = cuda_ms(lambda: cp.launch_corner_pool(a, b, corner), 10)
                bwd_ms = cuda_ms(lambda: cp.launch_corner_pool_backward(a, b, g, corner), 10)
                scratch = cp.forward_scratch(a)
                kernel_ms = cuda_ms(lambda: cp.forward_into(a, b, got, scratch, corner), 10,
                                    queued=True)
                kernel_bwd_ms = cuda_ms(lambda: cp.backward_into(a, b, g, *grads, corner), 10,
                                        queued=True)
                plain_ms = cuda_ms(lambda: plain(a, b), 3)

                def plain_step():
                    ta, tb = a.detach().requires_grad_(), b.detach().requires_grad_()
                    (plain(ta, tb) * g).sum().backward()

                plain_both_ms = cuda_ms(plain_step, 3)
                n, size = a.numel(), a.element_size()
                b_ms, b_by = bound_ms(3 * n * size, CORNER_OPS_FWD * n, PEAK_FP32_FLOPS)
                bb_ms, bb_by = bound_ms(5 * n * size, CORNER_OPS_BWD * n, PEAK_FP32_FLOPS)
                key = f"{corner}_{str(dtype).split('.')[-1]}_{h}x{w}"
                log(f"corner_pool {key} ({smi}): forward == plain bit for bit; gradient err vs "
                    f"fp32 plain {err:.3e} (plain {str(dtype).split('.')[-1]} autograd "
                    f"{plain_err:.3e}), same support; wrapper call forward {ms:.4f} ms "
                    f"(kernel alone {kernel_ms:.4f}; bound {b_ms:.4f}, {b_by}, "
                    f"{b_ms / ms:.3f} of it), backward {bwd_ms:.4f} ms (kernel alone "
                    f"{kernel_bwd_ms:.4f}; bound {bb_ms:.4f}, {bb_ms / bwd_ms:.3f}); plain "
                    f"(torch.cummax composition) forward {plain_ms:.4f} ms, forward + "
                    f"backward {plain_both_ms:.4f} ms")
                entry = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": None, "max_abs_err": 0.0, "grad_err": err,
                         "plain_grad_err": plain_err, "backward_ms": bwd_ms,
                         "kernel_ms": kernel_ms, "kernel_backward_ms": kernel_bwd_ms,
                         "backward_bound_ms": bb_ms, "plain_forward_backward_ms": plain_both_ms}
                kernels["corner_pool"][f"at_{key}"] = entry
                if key == f"tl_bfloat16_{CORNER_HW[0][0]}x{CORNER_HW[0][1]}":
                    kernels["corner_pool"].update({k: entry[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")})
                del got, grads, scratch
            del a, b, g
            torch.cuda.empty_cache()


def phase_cornernet(kernels, dev, smi):
    """CornerNet Hourglass-104 (the corner yaml, nothing cut, bf16, seeded,
    ``shape_cornernet``): the corner-pool kernel at the heads' shapes
    (``corner_pool_check``); the NMS kernel against ``batched_nms`` on the
    model's own 400 pair candidates an image (B=8, 80 classes, thr 0.5, 100
    slots); 3 predict calls of B=8 a bucket, each launching exactly 2 corner
    pools and 1 NMS, outputs (8, 100, ...) finite, with valid detections,
    and equal to the same weights' predict on the plain corner pool; predict
    ms and img/s at B=8, and the device ms of trunk, heads, the corner pools
    and the postprocess."""
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.ops.corner_pool import br_pool, tl_pool

    corner_pool_check(kernels, smi, dev)
    model = build_model(corner_cfg(), device=dev, generator=torch.Generator().manual_seed(54))
    reqs = {hw: requests(3, 8, seed=55 + i, hw=hw) for i, hw in enumerate(CORNER_HW)}
    shape_cornernet(model, reqs[CORNER_HW[0]][0]["image"])
    last = len(model.in_features) - 1
    with torch.inference_mode():
        images = torch.as_tensor(reqs[CORNER_HW[0]][0]["image"], device=dev)
        (tl, br), = model(images, stacks=[last])
        boxes, scores, classes, valid = model.candidates(tl, br)
        if tuple(boxes.shape) != (8, 400, 4):
            raise AssertionError(f"CornerNet candidates {tuple(boxes.shape)}")
        nms_check(kernels, smi, "cornernet", "predict_B8", boxes, scores, valid, 0.5,
                  model.max_dets, classes=classes)

    per_call, n_valid = [], []
    for hw in CORNER_HW:
        for r in reqs[hw]:
            _build.reset_launch_counts()
            out = model.predict(r)
            torch.cuda.synchronize()
            per_call.append({k: v for k, v in _build.launch_counts().items() if v})
            with plain_corner_pool():
                ref = model.predict(r)
            check_outputs(out, 8)
            if not all(torch.equal(out[k], ref[k]) for k in out):
                raise AssertionError(f"cornernet predict at {hw}: the kernel's detections "
                                     f"differ from the plain corner pool's")
            n_valid.append(out["valid"].sum(1).tolist())
    log(f"cornernet predict launches a call of B=8 at {list(CORNER_HW)} x 3: {per_call}; "
        f"valid detections an image {n_valid}; every output equal to the plain corner "
        f"pool's, bit for bit")
    if any(c != CORNER_PREDICT for c in per_call):
        raise AssertionError(f"cornernet predict launched {per_call}, expected {CORNER_PREDICT}")
    if sum(map(sum, n_valid)) <= 0:
        raise AssertionError("cornernet: no valid detections")
    for k in CORNER_PREDICT:
        kernels[k].setdefault("launches_by_path", {})["cornernet_predict"] = sum(
            c[k] for c in per_call)
    kernels["corner_pool"]["launches"] += sum(c["corner_pool"] for c in per_call)

    req = reqs[CORNER_HW[0]][0]
    ms = cuda_ms(lambda: model.predict(req), 3)
    with plain_corner_pool():
        plain_ms = cuda_ms(lambda: model.predict(req), 3)
    with torch.inference_mode():
        x = ((images.float() - model.pixel_mean) / model.pixel_std).to(model.dtype)
        x = x.permute(0, 3, 1, 2)
        trunk_ms = cuda_ms(lambda: model.backbone(x), 3)
        f = model.backbone(x)[model.in_features[last]]
        heads = (getattr(model, f"tl_head{last}"), getattr(model, f"br_head{last}"))
        heads_ms = cuda_ms(lambda: [h(f) for h in heads], 3)
        pools = [(h.pool_conv1(f), h.pool_conv2(f)) for h in heads]
        pool_ms = cuda_ms(lambda: (tl_pool(*pools[0]), br_pool(*pools[1])), 10)
        scale = torch.as_tensor(req["scale"], device=dev)
        orig = torch.as_tensor(req["orig_size"], device=dev)
        post_ms = cuda_ms(lambda: model.detections(tl, br, scale, orig), 3)
    h, w = CORNER_HW[0]
    log(f"time cornernet predict ({smi}): B=8 {h}x{w}: {ms:.2f} ms, {8e3 / ms:.2f} img/s "
        f"(on the plain corner pool {plain_ms:.2f} ms, {8e3 / plain_ms:.2f} img/s); device ms "
        f"of the parts: trunk {trunk_ms:.2f}, the last stack's two heads {heads_ms:.2f} (of "
        f"which the two corner pools {pool_ms:.3f}), postprocess {post_ms:.2f}")
    kernels["corner_pool"]["predict"] = {"ms": ms, "plain_pool_ms": plain_ms, "trunk_ms": trunk_ms,
                                         "heads_ms": heads_ms, "pools_ms": pool_ms,
                                         "postprocess_ms": post_ms}


def corner_step_launches(label, step, batch):
    """One train step with the launch counts set to 0 just before it and
    read just after; returns (metrics, corner-pool launches). The step must
    launch exactly CORNER_STEP."""
    from slenderobjdet_torch.ops import _build

    _build.reset_launch_counts()
    metrics = step(batch)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    if counts != CORNER_STEP:
        raise AssertionError(f"cornernet {label} step launched {counts}, expected {CORNER_STEP}")
    return metrics, counts["corner_pool"]


def corner_steps(label, step, batch, steps, smi):
    """``steps`` train steps on one batch, each launching exactly
    CORNER_STEP, the first one's corner-pool wrapper calls copying no input
    (``pool_inputs_recorded``); returns (losses, ms a step after the first
    two, peak GiB, the corner-pool launches read)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals, times, launched, copying = [], [], 0, []
    for i in range(steps):
        t0 = time.perf_counter()
        with pool_inputs_recorded(copying) if i == 0 else contextlib.nullcontext():
            metrics, n = corner_step_launches(f"{label} {i}", step, batch)
        times.append(time.perf_counter() - t0)
        if i == 0 and (len(copying) != CORNER_STEP["corner_pool"] or any(copying)):
            raise AssertionError(f"cornernet {label}: pool calls copying an input "
                                 f"{copying}")
        launched += n
        metrics = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"cornernet {label} step {i}: non-finite {metrics}")
        totals.append(metrics["total_loss"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = float(np.mean(times[2:] if len(times) > 2 else times[1:])) * 1e3
    n = batch["image"].shape[0]
    log(f"train cornernet {label} ({smi}): B={n} {batch['image'].shape[1:3]}: totals "
        f"{[round(t, 3) for t in totals]}; {ms:.1f} ms/step, {n * 1e3 / ms:.2f} img/s, peak "
        f"{peak:.2f} GiB; every step {CORNER_STEP}, step 0's pool calls copy no input; "
        f"last step loss_heat "
        f"{metrics['loss_heat']:.3f} loss_pull {metrics['loss_pull']:.4f} loss_push "
        f"{metrics['loss_push']:.4f} loss_offset {metrics['loss_offset']:.4f}")
    return totals, ms, peak, launched


@contextlib.contextmanager
def pool_inputs_recorded(seen):
    """Appends, for each corner-pool wrapper call made inside, whether the
    wrapper copies an input: only a tensor that is not channels-last
    contiguous (``_checked``'s ``.contiguous``) or a gradient in another
    dtype than the inputs' (``g.to``) is copied."""
    from slenderobjdet_torch.ops import corner_pool as cp

    saved = cp.launch_corner_pool, cp.launch_corner_pool_backward

    def copies(*tensors):
        return not all(t.is_contiguous(memory_format=torch.channels_last) for t in tensors)

    def forward(a, b, corner):
        seen.append(copies(a, b))
        return saved[0](a, b, corner)

    def backward(a, b, g, corner):
        seen.append(copies(a, b, g) or g.dtype != a.dtype)
        return saved[1](a, b, g, corner)

    cp.launch_corner_pool, cp.launch_corner_pool_backward = forward, backward
    try:
        yield
    finally:
        cp.launch_corner_pool, cp.launch_corner_pool_backward = saved


def largest_step(label, cfg_of, sizes, seed):
    """The model, its train step and a batch at the largest of ``sizes``
    whose step fits on the card (an out-of-memory step is dropped and the
    next size tried; the first step is the one timed as warm-up), and the
    corner-pool launches read over every step taken here, those of an
    attempt that ran out of memory included."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.solver import build_optimizer

    launched = 0
    for n in sizes:
        cfg = cfg_of(n)
        model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
        step = make_train_step(model, build_optimizer(cfg, model), cfg)
        batch = train_batch(n, seed + 1, hw=CORNER_HW[0])
        try:
            _, warm = corner_step_launches(f"{label} warm-up", step, batch)
            return model, step, batch, launched + warm
        except torch.cuda.OutOfMemoryError:
            launched += _build.launch_counts()["corner_pool"]
            log(f"cornernet step at B={n}: out of device memory; trying the next size")
        del model, step, batch
        torch.cuda.empty_cache()
    raise AssertionError(f"no CornerNet step of {sizes} fits")


def phase_cornernet_train(kernels, dev, smi, report):
    """The CornerNet train step at full width (896 x 1408, 100 padded gt,
    bf16, the yaml's ADAM at 2.5e-4 with WARMUP_ITERS 0). At B=2 from one
    set of weights: the gradients of a trunk, two head and a heat-output
    weight from the kernel model no further from an fp32 model's than
    GRAD_FACTOR x the same weights' bf16 model on the plain corner pool; and
    the fp32 loss and backward (called after ``loss`` returned, as
    ``TrainStep`` does) with ``TPU.REMAT_BACKBONE`` against without it, on
    cuDNN's deterministic algorithms: the same loss and running statistics
    bit for bit, every gradient within 5e-4 / 1e-4 (rtol / atol, the CPU
    test's). Then, without remat, the largest of CORNER_BATCHES that fits:
    TRAIN_STEPS + 1 steps; with remat, the largest of CORNER_REMAT_BATCHES:
    4 steps; each step launching exactly 4 + 4 corner-pool wrappers, the
    loss falling in both; img/s and peak memory of both, left in
    ``report``."""
    from slenderobjdet_torch.models import build_model

    names = ["backbone.hg0.HourglassBlock_0.HourglassBlock_0.Residual_0.ConvBNRelu_0.conv.weight",
             "tl_head1.pool_conv1.conv.weight", "br_head0.pool_conv2.conv.weight",
             "tl_head1.heat_out.weight"]
    small = train_batch(2, 57, hw=CORNER_HW[0])
    weights, grads, fp32 = None, {}, {}
    deterministic = torch.backends.cudnn.deterministic
    for key, dtype, remat in (("kernel", "bfloat16", False), ("plain", "bfloat16", False),
                              ("fp32", "float32", False), ("fp32_remat", "float32", True)):
        m = build_model(corner_cfg(dtype, remat=remat),
                        generator=torch.Generator().manual_seed(56))
        if weights is None:
            weights = {k: v.clone() for k, v in m.state_dict().items()}
        m.load_state_dict(weights)
        torch.backends.cudnn.deterministic = dtype == "float32"
        try:
            with contextlib.ExitStack() as stack:
                if key == "plain":
                    stack.enter_context(plain_corner_pool())
                total, _ = m.loss(small)
                total.backward()              # after loss returned, as TrainStep does
        finally:
            torch.backends.cudnn.deterministic = deterministic
        params = dict(m.named_parameters())
        grads[key] = {n: params[n].grad.detach().float().clone() for n in names}
        if dtype == "float32":
            fp32[key] = {"total": total.detach().clone(),
                         "grads": {n: p.grad.detach().clone() for n, p in params.items()
                                   if p.grad is not None},
                         "buffers": {n: b.detach().clone() for n, b in m.named_buffers()}}
        log(f"train cornernet grads {key}: total loss {float(total.detach()):.4f}")
        del m, params, total
        torch.cuda.empty_cache()
    del weights
    for n in names:
        gk, gp, g32 = grads["kernel"][n], grads["plain"][n], grads["fp32"][n]
        e_k, e_p = ratio(gk, g32), ratio(gp, g32)
        log(f"grad {n}: max|g| {float(gk.abs().max()):.3e}, err ratio vs fp32: kernel bf16 "
            f"{e_k:.3e}, plain corner pool bf16 {e_p:.3e} (kernel <= {GRAD_FACTOR} x plain)")
        if not (float(gk.abs().max()) > 0 and e_k <= GRAD_FACTOR * e_p):
            raise AssertionError(f"grad {n}: kernel err {e_k}, plain {e_p}")
    del grads
    off, on = fp32["fp32"], fp32["fp32_remat"]
    if not torch.equal(off["total"], on["total"]):
        raise AssertionError(f"cornernet remat: loss {float(on['total'])} against "
                             f"{float(off['total'])} without it")
    if sorted(off["grads"]) != sorted(on["grads"]) or sorted(off["buffers"]) != sorted(
            on["buffers"]):
        raise AssertionError("cornernet remat: other gradients or buffers than without it")
    worst, worst_name = 0.0, None
    for n, g in off["grads"].items():
        excess = float(((on["grads"][n] - g).abs() - 5e-4 * g.abs()).max())
        if excess > worst or worst_name is None:
            worst, worst_name = excess, n
    stats_equal = all(torch.equal(on["buffers"][n], b) for n, b in off["buffers"].items())
    running = [n for n in off["buffers"] if n.endswith("running_var")]
    moved = sum(not torch.equal(off["buffers"][n], torch.ones_like(off["buffers"][n]))
                for n in running)
    grad_ratio = max(ratio(on["grads"][n], g) for n, g in off["grads"].items())
    log(f"train cornernet remat (fp32, B=2, cuDNN deterministic): loss equal bit for bit "
        f"({float(off['total']):.4f}); {len(off['grads'])} gradients, the largest "
        f"|diff| - 5e-4 |g| {worst:.3e} ({worst_name}; atol 1e-4), largest max|diff| / "
        f"max|g| {grad_ratio:.3e}; running statistics equal bit for bit: {stats_equal}, "
        f"{moved} of {len(running)} running variances moved from 1")
    if worst > 1e-4 or not stats_equal or moved != len(running):
        raise AssertionError(f"cornernet remat: gradient excess {worst} at {worst_name}, "
                             f"statistics equal {stats_equal}, moved {moved}/{len(running)}")
    del fp32, off, on
    torch.cuda.empty_cache()

    for remat, sizes, steps in ((False, CORNER_BATCHES, TRAIN_STEPS + 1),
                                (True, CORNER_REMAT_BATCHES, 4)):
        label = "with remat" if remat else "without remat"
        model, step, batch, warm = largest_step(
            label, lambda n, r=remat: corner_cfg(remat=r, batch=n), sizes, 58)
        totals, ms, peak, launched = corner_steps(label, step, batch, steps, smi)
        if not totals[-1] < totals[0]:
            raise AssertionError(f"cornernet {label}: total {totals[-1]} after {steps - 1} "
                                 f"steps is not below step 0's {totals[0]}")
        n = batch["image"].shape[0]
        report["remat" if remat else "plain"] = {"batch": n, "ms": ms, "img_s": n * 1e3 / ms,
                                                 "peak_gib": peak}
        kernels["corner_pool"]["launches"] += warm + launched
        del model, step, batch
        torch.cuda.empty_cache()
    kernels["corner_pool"].setdefault("launches_by_path", {})["cornernet_train_step"] = \
        CORNER_STEP["corner_pool"]
    kernels["corner_pool"]["train"] = dict(report)
    log(f"time cornernet train ({smi}): without remat B={report['plain']['batch']} "
        f"{report['plain']['img_s']:.2f} img/s, peak {report['plain']['peak_gib']:.2f} GiB; "
        f"TPU.REMAT_BACKBONE B={report['remat']['batch']} {report['remat']['img_s']:.2f} "
        f"img/s, peak {report['remat']['peak_gib']:.2f} GiB")


def phase_cornernet_trainer(kernels, dev, smi, report):
    """``train_net_torch.main`` on the corner yaml over the synthetic
    dataset (``family_trainer``) with ``TPU.REMAT_BACKBONE`` on and
    SOLVER.IMS_PER_BATCH the largest the remat step reached (``report``,
    from ``phase_cornernet_train``; the largest size tried without it): 4 steps with a
    save at 2 and 4 and the evaluation, each step launching 4 + 4 corner
    pools and each test batch 2 and 1 NMS; ``--resume`` to 8 bit-equal, the
    BatchNorm statistics and ADAM's moments included; ``--eval-only``."""
    n = report.get("remat", {}).get("batch", CORNER_REMAT_BATCHES[0])
    family_trainer(kernels, smi, "cornernet", CORNER_YAML, 59, CORNER_STEP, predict_nms=1,
                   loss_key="loss_heat", batch=n, test_launches=CORNER_PREDICT,
                   overrides={"SOLVER.IMS_PER_BATCH": n, "TPU.REMAT_BACKBONE": True})


# ------------------------------------------------- PVT, PVTv2 and VT-FPN
PVT_HW = LOADER_SHAPES                 # both buckets, 896 x 1408 and 1408 x 896
PVT_NAMES = {"pvt": "build_retinanet_pvt_fpn_backbone",
             "pvtv2": "build_retinanet_pvtv2_fpn_backbone"}
PVT_OVERRIDES = {"MODEL.PVT.DEPTH": "small", "MODEL.FPN.IN_FEATURES": ["pvt2", "pvt3", "pvt4"]}
VT_FPN_NAME = "build_retinanet_resnet_vt_fpn_backbone_use_p5"
PVT_PREDICT = {"nms": 1}               # no stem and no bottleneck on a PVT trunk
VT_FPN_PREDICT = {"nms": 1, "fused_stem": 1, "fused_bottleneck": 13}
VT_FPN_STEP = {"fused_stem": 1, "fused_bottleneck": 13}
PVT_BATCHES = (16, 8)                  # the step: the largest that fits
PVT_STEPS = 8                          # on one batch; the loss must fall
PVT_SCORE_BYTES = 6                    # a saved score: the fp32 softmax and its bf16 copy


def pvt_cfg(family, fused=False, dtype="bfloat16", batch=None, lr=None):
    """The RetinaNet R-50 yaml with ``family``'s backbone: "pvt" (PVT-Small),
    "pvtv2" (PVTv2-B2's depths) or "vt_fpn" (R-50 VT-FPN, FrozenBN, the
    fused flags ``fused``); ``batch`` sets SOLVER.IMS_PER_BATCH and ``lr``
    BASE_LR with WARMUP_ITERS 0 (a test setting)."""
    cfg = flagship_cfg(fused, dtype, RETINANET_YAML)
    cfg.defrost()
    if family == "vt_fpn":
        opts = {"MODEL.BACKBONE.NAME": VT_FPN_NAME}
    else:
        opts = {"MODEL.BACKBONE.NAME": PVT_NAMES[family], **PVT_OVERRIDES}
    if batch is not None:
        opts["SOLVER.IMS_PER_BATCH"] = batch
    if lr is not None:
        opts.update({"SOLVER.BASE_LR": lr, "SOLVER.WARMUP_ITERS": 0})
    cfg.merge_from_list([x for kv in opts.items() for x in kv])
    cfg.freeze()
    return cfg


def sr_attention_calls(model, x):
    """Every SRAttention module of the trunk with the arguments one trunk
    call gave it, recorded by forward pre-hooks."""
    from slenderobjdet_torch.models.backbones.pvt import SRAttention

    calls = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: calls.append((mod, args)))
             for m in model.backbone.bottom_up.modules() if isinstance(m, SRAttention)]
    try:
        with torch.inference_mode():
            model.backbone.bottom_up(x)
    finally:
        for h in hooks:
            h.remove()
    return calls


def attention_scores(model, hw, batch):
    """The scores (query x key pairs, every head) of one trunk call at
    ``hw``: the elements each SRAttention's softmax holds."""
    trunk = model.backbone.bottom_up
    total = 0
    for i, depth in enumerate(trunk.depths):
        s = i + 1
        grid = [n // 2 ** (s + 1) for n in hw]
        for j in range(depth):
            attn = getattr(trunk, f"stage{s}_block{j}").attn
            keys = (grid[0] // attn.sr_ratio) * (grid[1] // attn.sr_ratio)
            total += batch * attn.num_heads * grid[0] * grid[1] * keys
    return total


def predict_launches(label, model, reqs, want):
    """Each request through ``model.predict`` with the launch counts set to 0
    just before it and read just after; each must be ``want``. Returns the
    outputs and the launches summed over the requests."""
    from slenderobjdet_torch.ops import _build

    outs, per_call = [], []
    for r in reqs:
        _build.reset_launch_counts()
        outs.append(model.predict(r))
        torch.cuda.synchronize()
        per_call.append({k: v for k, v in _build.launch_counts().items() if v})
    if any(c != want for c in per_call):
        raise AssertionError(f"{label} predict launched {per_call}, expected {want}")
    for out in outs:
        check_outputs(out, reqs[0]["image"].shape[0])
    if sum(int(o["valid"].sum()) for o in outs) <= 0:
        raise AssertionError(f"{label}: no valid detections")
    return outs, {k: v * len(reqs) for k, v in want.items()}


def matched_share(label, ref, reqs, outs):
    """``match_detections`` of ``outs`` against ``ref``'s predict of the same
    requests; fails under MATCH_MIN."""
    matched = same_box = total = 0
    diffs = []
    for r, out in zip(reqs, outs):
        other = ref.predict(r)
        m, sb, t, d = match_detections(out, other, r["image"].shape[0])
        matched, same_box, total, diffs = matched + m, same_box + sb, total + t, diffs + d
    share = matched / max(total, 1)
    log(f"{label}: {matched}/{total} slots matched by class with score diff <= {SCORE_TOL} "
        f"({same_box} with the same box); score diff median {np.median(diffs):.3e}, max "
        f"{np.max(diffs):.3e}")
    if share < MATCH_MIN:
        raise AssertionError(f"{label}: {share:.4f} of slots matched")


def predict_ms(model, req, iters=5):
    """Host ms of ``model.predict(req)`` to a synchronise, after 2 warm-up
    calls, and the peak device memory over the timed calls (the weights of
    every model on the card included)."""
    for _ in range(2):
        model.predict(req)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.predict(req)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3, torch.cuda.max_memory_allocated() / 2 ** 30


def phase_pvt(kernels, dev, smi):
    """RetinaNet on PVT-Small and on PVTv2 (B2's depths) at full width, bf16,
    seeded weights, predict at B = 8 on both buckets: head outputs against an
    fp32 copy on both buckets; the classifier's bias moved so that the coarsest level's 99.5th
    percentile score sits on SCORE_THRESH_TEST, then the NMS kernel against
    ``batched_nms`` on the model's own 5,000 candidates (exactly); then
    ``comparable_retinanet`` and 2 requests a bucket, each launching exactly
    1 NMS (no stem, no bottleneck), matched against the fp32 copy by
    ``match_detections``; predict ms, img/s and peak memory a bucket; device
    ms of trunk, FPN, head and postprocess and the SR attention's share of the
    trunk."""
    from slenderobjdet_torch.models import build_model

    for family in PVT_NAMES:
        gen = torch.Generator().manual_seed(60)
        model = build_model(pvt_cfg(family), device=dev, generator=gen)
        ref32 = build_model(pvt_cfg(family, dtype="float32"), device=dev)
        ref32.load_state_dict(model.state_dict())
        n_params = sum(p.numel() for p in model.parameters())
        bucket_reqs = [requests(2, 8, seed=61 + b, hw=hw) for b, hw in enumerate(PVT_HW)]
        for hw, reqs in zip(PVT_HW, bucket_reqs):      # the drawn weights
            with torch.inference_mode():
                images = torch.as_tensor(reqs[0]["image"], device=dev)
                heads = [m(images) for m in (model, ref32)]
            for part, got, want in zip(("logits", "deltas"), *heads):
                err = max(ratio(g, w) for g, w in zip(got, want))
                log(f"head {family} {hw[0]}x{hw[1]} {part}: bf16 vs fp32 err ratio {err:.3e} "
                    f"(<= {HEAD_TOL})")
                if err > HEAD_TOL:
                    raise AssertionError(f"head {family} {hw} {part}: bf16 err {err}")
            del heads, images
        for b, (hw, reqs) in enumerate(zip(PVT_HW, bucket_reqs)):
            label = f"{family} {hw[0]}x{hw[1]}"
            images = torch.as_tensor(reqs[0]["image"], device=dev)
            if b == 0:
                with torch.inference_mode():
                    top = model(images)[0][-1].flatten()
                    shift = RETINANET_CLS_BIAS - float(torch.kthvalue(
                        top.float(), int(0.995 * top.numel())).values)
                    for m in (model, ref32):
                        classifier(m).bias.add_(shift)
                    boxes, scores, classes, valid, _ = model.candidates(*model(images), hw)
                if tuple(boxes.shape) != (len(boxes), 5000, 4):
                    raise AssertionError(f"{label} candidates {tuple(boxes.shape)}")
                nms_check(kernels, smi, family, "predict_B8", boxes, scores, valid,
                          model.nms_thresh, model.max_dets, classes=classes)
                del top, boxes, scores, classes, valid
                comparable_retinanet(torch.Generator().manual_seed(62), model, ref32)
            del images
            outs, launched = predict_launches(label, model, reqs, PVT_PREDICT)
            by_path = kernels["nms"].setdefault("launches_by_path", {})
            by_path[f"{family}_predict"] = by_path.get(f"{family}_predict", 0) + launched["nms"]
            matched_share(f"{label} bf16 vs fp32 detections", ref32, reqs, outs)
            del outs
            ms, peak = predict_ms(model, reqs[0])
            log(f"time {family} predict ({smi}): B=8 {hw[0]}x{hw[1]} {ms:.3f} ms/batch, "
                f"{8e3 / ms:.2f} img/s, peak {peak:.2f} GiB; {n_params} parameters")
            if b == 0:
                with torch.inference_mode():
                    images = torch.as_tensor(reqs[0]["image"], device=dev)
                    x = ((images.float() - model.pixel_mean) / model.pixel_std).to(model.dtype)
                    x = x.permute(0, 3, 1, 2)
                    feats = model.backbone(x)
                    feats_l = [feats[f] for f in model.in_features]
                    logits_l, regs_l = model.head(feats_l)
                    scale = torch.ones(len(images), device=dev)
                    orig = torch.tensor([hw] * len(images), dtype=torch.float32, device=dev)
                    trunk = cuda_ms(lambda: model.backbone.bottom_up(x), 5)
                    parts = {
                        "trunk": trunk,
                        "fpn": cuda_ms(lambda: model.backbone(x), 5) - trunk,
                        "head": cuda_ms(lambda: model.head(feats_l), 5),
                        "postprocess": cuda_ms(lambda: model.postprocess(
                            logits_l, regs_l, hw, scale, orig), 5),
                    }
                calls = sr_attention_calls(model, x)
                with torch.inference_mode():
                    attn = sum(cuda_ms(lambda m=m, a=a: m(*a), 3, warmup=1) for m, a in calls)
                n_scores = attention_scores(model, hw, len(images))
                log(f"time {family} predict parts ({smi}), B=8 {hw[0]}x{hw[1]}, device ms: "
                    + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
                    + f"; the {len(calls)} SR attention calls alone {attn:.3f} ms, "
                    f"{attn / trunk:.4f} of the trunk; {n_scores / 1e6:.1f} M scores a call")
                del x, feats, feats_l, logits_l, regs_l, images, calls
            torch.cuda.empty_cache()
        del model, ref32
        torch.cuda.empty_cache()


def phase_pvt_train(kernels, dev, smi, report):
    """The PVT-Small train step at the largest of PVT_BATCHES that fits
    (896 x 1408, 100 padded gt, bf16, BASE_LR RETINANET_TRAIN_LR without
    warm-up): PVT_STEPS steps on one batch, none launching a kernel, the
    loss finite and falling; img/s, peak memory, and the bytes the saved
    attention scores take (PVT_SCORE_BYTES a score) beside that peak. Leaves
    the batch in ``report``."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.solver import build_optimizer

    hw = PVT_HW[0]
    for n in PVT_BATCHES:
        cfg = pvt_cfg("pvt", batch=n, lr=RETINANET_TRAIN_LR)
        model = build_model(cfg, generator=torch.Generator().manual_seed(63))
        step = make_train_step(model, build_optimizer(cfg, model), cfg)
        batch = train_batch(n, 64, hw=hw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        totals, times = [], []
        try:
            for i in range(PVT_STEPS):
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                metrics = step(batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                counts = {k: v for k, v in _build.launch_counts().items() if v}
                if counts:
                    raise AssertionError(f"pvt step {i} launched {counts}")
                totals.append(float(metrics["total_loss"]))
        except torch.cuda.OutOfMemoryError:
            log(f"pvt step at B={n}: out of device memory; trying the next size")
            del model, step, batch
            torch.cuda.empty_cache()
            continue
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not (all(np.isfinite(totals)) and totals[-1] < totals[0]):
            raise AssertionError(f"pvt step at B={n}: totals {totals}")
        ms = float(np.mean(times[2:])) * 1e3
        scores_gib = attention_scores(model, hw, n) * PVT_SCORE_BYTES / 2 ** 30
        log(f"time pvt train ({smi}): B={n} {hw[0]}x{hw[1]}, 100 padded gt: totals "
            f"{[round(t, 4) for t in totals]}; {ms:.1f} ms/step, {n * 1e3 / ms:.2f} img/s, "
            f"peak {peak:.2f} GiB, of which the saved attention scores reckon "
            f"{scores_gib:.2f} GiB ({scores_gib / peak:.3f}); no kernel launched")
        report.update(batch=n, ms=ms, peak_gib=peak, scores_gib=scores_gib)
        return
    raise AssertionError(f"no PVT step of {PVT_BATCHES} fits")


def phase_pvt_trainer(kernels, dev, smi, report):
    """``train_net_torch.main`` with the PVT-Small overrides over the
    synthetic dataset (``family_trainer``) at the batch ``phase_pvt_train``
    reached: 4 steps launching nothing, 8 test batches of 1 NMS each, a
    save, ``--resume`` bit-equal, evaluation, ``--eval-only``."""
    n = report.get("batch", PVT_BATCHES[-1])
    family_trainer(kernels, smi, "pvt", RETINANET_YAML, 65, {}, predict_nms=1, batch=n,
                   test_launches=PVT_PREDICT,
                   overrides={"MODEL.BACKBONE.NAME": PVT_NAMES["pvt"], **PVT_OVERRIDES,
                              "SOLVER.IMS_PER_BATCH": n})


def shape_vt_fpn(model, images):
    """Scale the tokenizers' 1x1 scores, and the projectors' query and key
    (weights and biases), so that every softmax of the VT-FPN sees scores of
    unit spread on ``images``. The random R-50's laterals, which no norm
    scales, are hundreds wide: drawn, those softmaxes are one-hot, and
    rounding a score to bf16 moves a token or a pixel's weight wholesale (on
    the CPU at 256 x 384, B = 2: the projector's output 0.16 of its largest
    value from fp32 in bf16, the laterals 0.012)."""
    seen = {}

    def record(name):
        def hook(mod, args, out):
            seen[name] = (args, out)
        return hook

    for kind in ("tokenizer", "projector"):
        mods = {n: m for n, m in model.backbone.named_children() if n.startswith(kind)}
        hooks = [(m.attn if kind == "tokenizer" else m).register_forward_hook(record(n))
                 for n, m in mods.items()]
        try:
            with torch.no_grad():
                model(images)
        finally:
            for h in hooks:
                h.remove()
        with torch.no_grad():
            for n, m in mods.items():
                args, out = seen.pop(n)
                if kind == "tokenizer":
                    layers, f = (m.attn,), 1 / float(out.float().std())
                else:
                    x, tokens = args
                    q = m.q(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, x.shape[1])).float()
                    scores = q @ m.k(tokens).float().transpose(1, 2) * x.shape[1] ** -0.5
                    layers, f = (m.q, m.k), float(scores.std()) ** -0.5
                for layer in layers:
                    layer.weight.mul_(f)
                    layer.bias.mul_(f)


def phase_vt_fpn(kernels, dev, smi):
    """RetinaNet R-50 VT-FPN at full width, bf16, seeded weights (FrozenBN
    away from identity, ``shape_vt_fpn``), the fused flags on and off: head outputs against
    fp32 (``check_heads``); after ``comparable_retinanet`` 2 requests of 8
    at 896 x 1408, each launching exactly 1 stem, 13 bottleneck and 1 NMS
    with the flags on (1 NMS with them off), >= MATCH_MIN of the slots
    matched between on and off; predict ms on and off in turns; then, from
    weights drawn anew, 4 train steps at B = 16 with the flags on and
    BASE_LR RETINANET_TRAIN_LR without warm-up, each launching 1 stem and 13
    bottleneck wrappers, the loss finite and falling; img/s and peak
    memory."""
    from slenderobjdet_torch.engine import make_train_step
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.solver import build_optimizer

    hw = PVT_HW[0]
    gen = torch.Generator().manual_seed(66)
    model = build_model(pvt_cfg("vt_fpn", fused=True), device=dev, generator=gen)
    randomize_frozen_bn(model, gen)
    reqs = requests(2, 8, seed=67, hw=hw)
    shape_vt_fpn(model, torch.as_tensor(reqs[0]["image"], device=dev))
    plain = build_model(pvt_cfg("vt_fpn"), device=dev)
    plain.load_state_dict(model.state_dict())
    ref32 = build_model(pvt_cfg("vt_fpn", dtype="float32"), device=dev)
    ref32.load_state_dict(model.state_dict())
    check_heads("vt_fpn", ("logits", "deltas"), reqs[0], dev, model, plain, ref32)
    del ref32
    torch.cuda.empty_cache()
    comparable_retinanet(torch.Generator().manual_seed(68), model, plain)
    outs, launched = predict_launches("vt_fpn flags on", model, reqs, VT_FPN_PREDICT)
    predict_launches("vt_fpn flags off", plain, reqs[:1], PVT_PREDICT)
    for k, v in launched.items():
        kernels[k].setdefault("launches_by_path", {})["vt_fpn_predict"] = v
    matched_share("vt_fpn flags on vs off detections", plain, reqs, outs)
    del outs
    times = {"on": [], "off": []}
    for key, m in (("on", model), ("off", plain), ("off", plain), ("on", model)):
        times[key].append(predict_ms(m, reqs[0])[0])
    log(f"time vt_fpn predict ({smi}): B=8 {hw[0]}x{hw[1]}, flags on "
        f"{', '.join(f'{t:.3f}' for t in times['on'])} ms/batch, off "
        f"{', '.join(f'{t:.3f}' for t in times['off'])} (in turns on, off, off, on)")
    del model, plain
    torch.cuda.empty_cache()

    cfg = pvt_cfg("vt_fpn", fused=True, lr=RETINANET_TRAIN_LR)
    gen = torch.Generator().manual_seed(70)
    model = build_model(cfg, device=dev, generator=gen)
    randomize_frozen_bn(model, gen)
    shape_vt_fpn(model, torch.as_tensor(reqs[0]["image"], device=dev))
    step = make_train_step(model, build_optimizer(cfg, model), cfg)
    batch = train_batch(cfg.SOLVER.IMS_PER_BATCH, 69, hw=hw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals, times = [], []
    for i in range(4):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {k: v for k, v in _build.launch_counts().items() if v}
        if counts != VT_FPN_STEP:
            raise AssertionError(f"vt_fpn step {i} launched {counts}, expected {VT_FPN_STEP}")
        totals.append(float(metrics["total_loss"]))
    if not (all(np.isfinite(totals)) and totals[-1] < totals[0]):
        raise AssertionError(f"vt_fpn steps: totals {totals}")
    for k, v in VT_FPN_STEP.items():
        kernels[k].setdefault("launches_by_path", {})["vt_fpn_train_step"] = v
    n = batch["image"].shape[0]
    ms = float(np.mean(times[2:])) * 1e3
    log(f"time vt_fpn train ({smi}): B={n} {hw[0]}x{hw[1]}, flags on: totals "
        f"{[round(t, 4) for t in totals]}; {ms:.1f} ms/step, {n * 1e3 / ms:.2f} img/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; every step {VT_FPN_STEP}")


# ------------------------------------------------- serving, int8 and TTA
SERVING_HW = LOADER_SHAPES[0]       # the loader's landscape bucket, 896 x 1408
SERVING_BATCH = 8
SERVING_SMALL_BATCH = 2             # the CornerNet artifact
SERVING_PREDICT = {"nms": 1, "fused_stem": 1, "fused_bottleneck": 13}
SERVING_DISPATCH_CALLS = 200        # calls a dispatch-cost timing averages
SERVING_AB_TURNS = 10               # live predict, operators and direct calls in turns
INT8_SCALES = "configs/int8_scales/fcos_R_50_bench.json"
INT8_BATCHES = (8, 32)
TTA_MIN_SIZES = (640, 800)
TTA_IMAGES = 8


def serving_args(out, *flags):
    """The export tool's arguments for the flagship at B = 8 on the loader's
    landscape bucket, bf16, the fused flags on."""
    from slenderobjdet_torch.tools import export_serving

    return export_serving.parse_args(
        ["--config", FCOS_YAML, "--output", out, "--batch", str(SERVING_BATCH),
         "--device", "cuda", *flags, "TPU.TEST_PAD_SHAPE", str(SERVING_HW),
         "MODEL.RESNETS.FUSED_STEM", "True", "MODEL.RESNETS.FUSED_BLOCKS", "True",
         "TPU.COMPUTE_DTYPE", "bfloat16"])


def launches_of(fn, *args):
    """The launch counts of one ``fn(*args)``, counted from 0."""
    from slenderobjdet_torch.ops import _build

    _build.reset_launch_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {k: v for k, v in _build.launch_counts().items() if v}


def outputs_equal(a, b) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]) for k in a)


def match_by_class(out, ref, batch):
    """Detections of ``out`` against ``ref`` class by class (one detection a
    class, ``one_detection_per_class``): the classes kept by one and not the
    other, and the largest score and box differences of the others."""
    missing, score, box = 0, 0.0, 0.0
    for b in range(batch):
        f, p = per_class(out, b), per_class(ref, b)
        missing += len(set(f) ^ set(p))
        for c in set(f) & set(p):
            score = max(score, abs(f[c][0] - p[c][0]))
            box = max(box, float(np.abs(f[c][1] - p[c][1]).max()))
    return missing, score, box


def export_and_reload(model, path, batch, hw, req):
    """Export ``model.predict`` at (batch, hw), reload it, and hold the
    artifact's outputs and launches to the live model's on ``req``; returns
    the export seconds and the reloaded predict."""
    from slenderobjdet_torch import serving

    t0 = time.perf_counter()
    serving.export_detector(model, path, batch_size=batch, image_hw=hw)
    export_s = time.perf_counter() - t0
    predict_fn = serving.load_detector(path)
    live, live_counts = launches_of(model.predict, req)
    got, got_counts = launches_of(predict_fn, req)
    if got_counts != live_counts:
        raise AssertionError(f"artifact launched {got_counts}, the live model {live_counts}")
    if not outputs_equal(got, live):
        raise AssertionError(f"artifact outputs differ from the live model's: "
                             f"{[k for k in live if not torch.equal(got[k], live[k])]}")
    return export_s, predict_fn, live_counts


@contextlib.contextmanager
def kernels_called_directly():
    """The flagship's three kernels called through their launch functions,
    not the registered operators: the live path as it was before them."""
    from slenderobjdet_torch.models.backbones import resnet
    from slenderobjdet_torch.models.meta_arch import fcos
    from slenderobjdet_torch.ops import fused_bottleneck as fb
    from slenderobjdet_torch.ops import fused_stem as fs
    from slenderobjdet_torch.ops import nms as nms_mod

    saved = resnet.fused_bottleneck, resnet.fused_stem, fcos.cuda_batched_nms
    resnet.fused_bottleneck = fb._launch
    resnet.fused_stem = fs.launch_stem
    fcos.cuda_batched_nms = lambda boxes, scores, classes, thr, max_out, valid=None: \
        nms_mod.launch_nms(boxes, scores, classes, valid, thr, max_out)
    try:
        yield
    finally:
        resnet.fused_bottleneck, resnet.fused_stem, fcos.cuda_batched_nms = saved


def dispatch_cost_us(smi, dev):
    """Host microseconds an operator call adds to a direct call of its
    wrapper, on the predict path's small inputs (NMS at N = 5,000 and the
    res5_1 block at B = 8): the host clock over ``SERVING_DISPATCH_CALLS``
    calls each way, three turns each, the fastest turn of each."""
    from slenderobjdet_torch.ops import fused_bottleneck as fb
    from slenderobjdet_torch.ops import nms as nms_mod

    rs = np.random.RandomState(7)
    boxes, scores, classes, valid = nms_inputs(rs, "sparse", 8, 5000, dev)
    x = torch.randn(8, 28, 44, 2048, device=dev).to(torch.bfloat16)
    g = torch.Generator().manual_seed(3)
    w = [torch.randn(s, generator=g).to(dev) * 0.02 for s in
         ((2048, 512), (512,), (3, 3, 512, 512), (512,), (512, 2048), (2048,))]
    pairs = {
        "nms": (lambda: nms_mod.nms_op(boxes, scores, classes, valid, None, 0.6, 100),
                lambda: nms_mod.launch_nms(boxes, scores, classes, valid, 0.6, 100)),
        "fused_bottleneck": (
            lambda: torch.ops.slenderobjdet.fused_bottleneck(x, *w, None, None),
            lambda: fb._launch(x, *w, None, None)),
    }
    cost = {}
    for name, (op, direct) in pairs.items():
        times = {"op": [], "direct": []}
        for label, fn in (("op", op), ("direct", direct)) * 3:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SERVING_DISPATCH_CALLS):
                fn()
            host = (time.perf_counter() - t0) / SERVING_DISPATCH_CALLS
            torch.cuda.synchronize()
            times[label].append(host * 1e6)
        cost[name] = min(times["op"]) - min(times["direct"])
        log(f"dispatch {name}: host us a call, operator {min(times['op']):.1f}, direct "
            f"wrapper {min(times['direct']):.1f}, cost {cost[name]:.1f} us ({smi})")
    return cost


def phase_serving(kernels, dev, smi):
    """The export tool's path at B = 8, 896 x 1408: an artifact of FCOS
    predict bit-equal to the live model, the same launches, timed beside
    it; the operators' dispatch cost, alone and in the live predict; the
    weight-only int8 artifact within the tool's tolerances; a
    CornerNet artifact at B = 2, and the rotated IoU and NMS operators in a
    program of their own."""
    import os
    import tempfile

    from slenderobjdet_torch import serving
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.ops.rotated import pairwise_rotated_iou, rotated_nms
    from slenderobjdet_torch.tools import export_serving

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    args = serving_args(f"{tmp}/fcos")
    cfg, model = export_serving.build(args)
    gen = torch.Generator().manual_seed(21)
    randomize_frozen_bn(model, gen)
    with torch.no_grad():
        classifier(model).bias.fill_(0.0)
    one_detection_per_class(gen, model)
    req = requests(1, SERVING_BATCH, seed=22, hw=SERVING_HW)[0]

    export_s, predict_fn, counts = export_and_reload(model, args.output, SERVING_BATCH,
                                                     SERVING_HW, req)
    if counts != SERVING_PREDICT:
        raise AssertionError(f"live predict launched {counts}, expected {SERVING_PREDICT}")
    out = predict_fn(req)
    check_outputs(out, SERVING_BATCH)
    n_valid = int(out["valid"].sum())
    if n_valid <= 0:
        raise AssertionError("the artifact kept no detection")
    sizes = {f: os.path.getsize(f"{args.output}/{f}") for f in serving.ARTIFACT_FILES}
    if sorted(os.listdir(args.output)) != sorted(serving.ARTIFACT_FILES):
        raise AssertionError(f"artifact files {sorted(os.listdir(args.output))}")
    log(f"serving FCOS B={SERVING_BATCH} {SERVING_HW[0]}x{SERVING_HW[1]}: export "
        f"{export_s:.2f} s, reload bit-equal to the live model, {n_valid} valid, "
        f"launches {counts} both; files {sizes} bytes")
    rates = {}
    for label, fn in (("live", model.predict), ("artifact", predict_fn),
                      ("artifact", predict_fn), ("live", model.predict)):
        rates.setdefault(label, []).append(cuda_ms(lambda: fn(req), iters=5, warmup=2))
    log(f"time serving predict B={SERVING_BATCH} {SERVING_HW[0]}x{SERVING_HW[1]} (CUDA "
        f"events, 2 warm-up, 5 calls, two turns each): live "
        f"{' / '.join(f'{t:.3f}' for t in rates['live'])} ms, artifact "
        f"{' / '.join(f'{t:.3f}' for t in rates['artifact'])} ms ({smi})")
    cost = dispatch_cost_us(smi, dev)
    per_call = (cost["nms"] * SERVING_PREDICT["nms"]
                + cost["fused_bottleneck"] * (SERVING_PREDICT["fused_bottleneck"]
                                              + SERVING_PREDICT["fused_stem"])) / 1e3
    log(f"dispatch cost of the registered operators a B={SERVING_BATCH} FCOS predict call "
        f"(1 NMS, 1 stem and 13 blocks, the block's cost for the stem's): {per_call:.4f} ms "
        f"beside {min(rates['live']):.3f} ms a call ({smi})")
    turns = {}
    for label in ("operators", "direct") * SERVING_AB_TURNS:
        with contextlib.nullcontext() if label == "operators" else kernels_called_directly():
            turns.setdefault(label, []).append(cuda_ms(lambda: model.predict(req), iters=5,
                                                       warmup=1))
    q = {k: np.percentile(v, (25, 50, 75)) for k, v in turns.items()}
    log(f"time serving live predict B={SERVING_BATCH}, {SERVING_AB_TURNS} turns each of 5 "
        f"calls: through the operators median {q['operators'][1]:.3f} ms (quartiles "
        f"{q['operators'][0]:.3f}-{q['operators'][2]:.3f}), the kernels called directly, as "
        f"before the operators, median {q['direct'][1]:.3f} ({q['direct'][0]:.3f}-"
        f"{q['direct'][2]:.3f}): {q['operators'][1] - q['direct'][1]:+.3f} ms; turns "
        f"{[round(t, 3) for t in turns['operators']]} / "
        f"{[round(t, 3) for t in turns['direct']]} ({smi})")

    qargs = serving_args(f"{tmp}/fcos_q", "--quantize")
    t0 = time.perf_counter()
    serving.export_detector(model, qargs.output, SERVING_BATCH, SERVING_HW, quantize=True)
    q_export_s = time.perf_counter() - t0
    q_fn = serving.load_detector(qargs.output)
    q_out, q_counts = launches_of(q_fn, req)
    if q_counts != SERVING_PREDICT:
        raise AssertionError(f"the int8-weight artifact launched {q_counts}")
    check_outputs(q_out, SERVING_BATCH)
    missing, worst, box = match_by_class(q_out, out, SERVING_BATCH)
    if missing or worst > 0.05 or box > 2.0:
        raise AssertionError(f"--quantize against fp: {missing} classes kept by one only, "
                             f"score difference {worst}, box {box}")
    q_sizes = {f: os.path.getsize(f"{qargs.output}/{f}") for f in serving.ARTIFACT_FILES}
    log(f"serving --quantize: export {q_export_s:.2f} s, files {q_sizes} bytes, "
        f"detections class by class against the live fp model within the tool's "
        f"tolerances (score 0.05, box 2.0): largest differences score {worst:.3e}, "
        f"box {box:.3e}")
    del model, predict_fn, q_fn
    torch.cuda.empty_cache()

    corner = build_model(corner_cfg(), device=dev, generator=torch.Generator().manual_seed(23))
    creq = requests(1, SERVING_SMALL_BATCH, seed=24, hw=SERVING_HW)[0]
    shape_cornernet(corner, creq["image"])
    secs, _, cnt = export_and_reload(corner, f"{tmp}/corner", SERVING_SMALL_BATCH,
                                     SERVING_HW, creq)
    del corner
    torch.cuda.empty_cache()
    log(f"serving CornerNet B={SERVING_SMALL_BATCH}: export {secs:.2f} s, reload bit-equal, "
        f"launches {cnt} both")
    if cnt != CORNER_PREDICT:
        raise AssertionError(f"the CornerNet artifact launched {cnt}")

    class Rotated(torch.nn.Module):
        """The rotated IoU of the box heads' sampling and the rotated NMS
        of RotatedRetinaNet's predict."""

        def forward(self, gt, boxes, scores):
            keep_idx, keep_valid = rotated_nms(boxes, scores, 0.5, 100)
            return pairwise_rotated_iou(gt, boxes[0]), keep_idx, keep_valid

    rs = np.random.RandomState(26)

    def rboxes(n):
        return torch.as_tensor(np.concatenate(
            [rs.uniform(0, 800, (n, 2)), rs.uniform(8, 200, (n, 2)),
             rs.choice(ROTATED_ANGLES, (n, 1))], 1), dtype=torch.float32, device=dev)

    args = (rboxes(100), rboxes(1100)[None], torch.rand(1, 1100, device=dev))
    torch.export.save(torch.export.export(Rotated(), args, strict=False), f"{tmp}/rotated.pt2")
    rotated_fn = torch.export.load(f"{tmp}/rotated.pt2").module()
    got, cnt = launches_of(rotated_fn, *args)
    want = Rotated()(*args)
    if cnt != {"rotated_iou": 1, "rotated_nms": 1} or not all(
            torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"the rotated program launched {cnt} or differs")
    log("serving rotated_iou and rotated_nms operators: a program of 100 x 1,100 pairs and "
        "NMS of 1,100 boxes, reloaded, bit-equal, 1 launch each")


def count_int8_sites(model, req):
    """The convs ``int8_predict_scope`` takes over in one predict call."""
    from slenderobjdet_torch.ops import quant

    taken = []
    real = quant.intercept

    def counting(mod, x):
        out = real(mod, x)
        if out is not None:
            taken.append(quant.module_path(mod))
        return out

    quant.intercept = counting
    try:
        model.predict(req)
    finally:
        quant.intercept = real
    return taken


def phase_int8(kernels, dev, smi):
    """FCOS predict under ``TPU.INT8_PREDICT``, dynamic and static (the JAX
    package's 58 calibrated scales), at B = 8 and 32 on the loader's
    landscape bucket, against bf16, the fused flags on and off: the convs
    taken over, img/s, and the scores' largest difference from bf16 on
    detections matched class by class."""
    from slenderobjdet_torch.models import build_model
    from slenderobjdet_torch.ops import quant

    scales = quant.load_json_scales(INT8_SCALES)
    gen = torch.Generator().manual_seed(27)
    fused = build_model(flagship_cfg(True), device=dev, generator=gen)
    randomize_frozen_bn(fused, gen)
    with torch.no_grad():
        classifier(fused).bias.fill_(0.0)
    one_detection_per_class(gen, fused)
    plain = build_model(flagship_cfg(False), device=dev)
    plain.load_state_dict(fused.state_dict())
    modes = {"bf16": (False, None), "int8 dynamic": (True, None),
             "int8 static": (True, scales)}
    for batch in INT8_BATCHES:
        req = requests(1, batch, seed=28, hw=SERVING_HW)[0]
        for flags, model in (("on", fused), ("off", plain)):
            outs, ms = {}, {}
            for mode, (on, sc) in list(modes.items()) + list(modes.items())[::-1]:
                model.int8_predict = on
                with quant.static_scales_scope(sc):
                    if mode not in outs:
                        outs[mode] = model.predict(req)
                        sites = count_int8_sites(model, req) if on else []
                        if on and batch == INT8_BATCHES[0]:
                            log(f"int8 {mode} flags {flags}: {len(sites)} conv calls at "
                                f"{len(set(sites))} sites taken over"
                                + (f", {len(set(sites) & set(scales))} sites with static "
                                   f"scales" if sc else ""))
                        if on and not sites:
                            raise AssertionError(f"int8 {mode} took over no conv")
                    ms.setdefault(mode, []).append(
                        cuda_ms(lambda: model.predict(req), iters=3, warmup=1))
            model.int8_predict = False
            for mode, out in outs.items():
                check_outputs(out, batch)
            base = outs["bf16"]
            for mode in ("int8 dynamic", "int8 static"):
                missing, worst, _ = match_by_class(outs[mode], base, batch)
                best = min(ms[mode])
                log(f"time int8 predict B={batch} {SERVING_HW[0]}x{SERVING_HW[1]} flags "
                    f"{flags} {mode}: {best:.3f} ms, {batch * 1e3 / best:.2f} img/s against bf16 "
                    f"{min(ms['bf16']):.3f} ms, {batch * 1e3 / min(ms['bf16']):.2f} img/s "
                    f"({min(ms['bf16']) / best:.3f} x); scores' largest difference from bf16 "
                    f"on matched detections {worst:.3e}, {missing} classes kept by one "
                    f"only ({smi})")
    del fused, plain


def phase_tta(kernels, dev, smi):
    """``train_net_torch.main --eval-only`` with ``TEST.AUG.ENABLED``
    (MIN_SIZES 640 and 800, FLIP, the yaml's MAX_SIZE) on a synthetic set:
    the evaluator's AP finite, ms an image."""
    import tempfile

    import train_net_torch

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tta_")
    name = "chip_smoke_tta"
    synthetic_dataset(name + "_test", tmp, n_images=TTA_IMAGES, seed=29)
    args = trainer_args(name, f"{tmp}/out", "--eval-only", overrides={
        "TEST.AUG.ENABLED": True, "TEST.AUG.MIN_SIZES": TTA_MIN_SIZES,
        "TEST.AUG.FLIP": True, "MODEL.FCOS.INFERENCE_TH": 0.0})
    from slenderobjdet_torch.engine import trainer as trainer_mod
    from slenderobjdet_torch.ops import _build

    real = trainer_mod.tta_predict
    secs = []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)        # fetches the detections: the card is done
        secs.append(time.perf_counter() - t0)
        return out

    trainer_mod.tta_predict = timed
    _build.reset_launch_counts()
    try:
        results = train_net_torch.main(args)
    finally:
        trainer_mod.tta_predict = real
    counts = _build.launch_counts()
    ap = results[name + "_test"]["bbox"]["AP"]
    views = TTA_IMAGES * len(TTA_MIN_SIZES) * 2
    if not np.isfinite(ap):
        raise AssertionError(f"TTA evaluation AP {ap}")
    want = {"nms": views, "fused_stem": views, "fused_bottleneck": 13 * views}
    if {k: counts[k] for k in want} != want or len(secs) != TTA_IMAGES:
        raise AssertionError(f"TTA launched {counts} over {len(secs)} images; expected {want}")
    log(f"tta: main --eval-only over {TTA_IMAGES} images x {views // TTA_IMAGES} views "
        f"(MIN_SIZES {TTA_MIN_SIZES}, FLIP, MAX_SIZE 4000: buckets 640 / 896 x 4096): "
        f"bbox AP {ap:.4f}; tta_predict {np.mean(secs[1:]) * 1e3:.1f} ms an image after the "
        f"first ({secs[0] * 1e3:.1f} ms), launches {want} ({smi})")


# ---------------------------------------------------------------- full size
FULL_SIZE_PREDICT = {"fused_stem": 1, "fused_bottleneck": 13, "nms": 1}
FULL_SIZE_BF16_BOX_ATOL = 2.0     # px, and the score step below: a bf16 detection's partner
FULL_SIZE_BF16_SCORE_ATOL = 2e-2
FULL_SIZE_BF16_SHARE = 0.75       # of JAX's 100 slots; 0.920 measured at both buckets (H100 80GB, 700 W)


def phase_full_size(kernels, dev, smi):
    """FCOS R-50-FPN at the loader's full size against the JAX package's
    committed outputs (``slenderobjdet_torch/tools/full_size_check.py``):
    the weights rebuilt from the file's manifest (checksum), both buckets at
    B = 1 in fp32 (TF32 off, the fused kernels on) under the CPU test's rule,
    exactly 1 stem + 13 bottleneck + 1 NMS a call; then in bf16: the head
    against JAX's fp32 within HEAD_TOL (the other phases' bf16 bound) and at
    least FULL_SIZE_BF16_SHARE of JAX's slots paired by a bf16 detection at
    FULL_SIZE_BF16_{BOX,SCORE}_ATOL (the scores of 100 random-weight
    detections crowd into 0.07, so bf16 reorders the cut)."""
    from slenderobjdet_torch.checkpoint.bridge import variables_checksum
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.tools import full_size_check as F

    ref = F.load_reference()
    variables = F.reference_variables(ref)
    if variables_checksum(variables) != str(ref["checksum"]):
        raise AssertionError("full_size: the numpy re-draw differs from the file's checksum")
    for dtype in ("float32", "bfloat16"):
        model = F.build_reference_model(ref, variables, device="cuda", dtype=dtype)
        for bucket in F.BUCKETS:
            batch = F.bucket_batch(ref, bucket)
            F.run_bucket(model, batch)                      # warm-up
            _build.reset_launch_counts()
            t = time.perf_counter()
            res = F.run_bucket(model, batch)
            ms = (time.perf_counter() - t) * 1e3
            counts = {k: v for k, v in _build.launch_counts().items() if v}
            if counts != FULL_SIZE_PREDICT:
                raise AssertionError(f"full_size {dtype} {bucket}: launched {counts}")
            errs = F.head_errors(res["heads"], ref, bucket)
            worst = max(errs, key=errs.get)
            want = F.reference_dets(ref, bucket)
            if dtype == "float32":
                m = F.match_detections(res["dets"], want)
                log(f"full_size fp32 {bucket}: head max rel {errs[worst]:.3e} ({worst}; tol "
                    f"{F.HEAD_RTOL}), detections {m}, predict call {ms:.1f} ms, "
                    f"launches {counts} [{smi}]")
                if errs[worst] > F.HEAD_RTOL or not m["ok"]:
                    raise AssertionError(f"full_size fp32 {bucket} differs from JAX")
            else:
                share = F.matched_share(res["dets"], want, FULL_SIZE_BF16_BOX_ATOL,
                                        FULL_SIZE_BF16_SCORE_ATOL)
                log(f"full_size bf16 {bucket}: head max rel {errs[worst]:.3e} ({worst}; tol "
                    f"{HEAD_TOL}), {share:.3f} of JAX's slots paired within "
                    f"{FULL_SIZE_BF16_BOX_ATOL} px / {FULL_SIZE_BF16_SCORE_ATOL} (at least "
                    f"{FULL_SIZE_BF16_SHARE}), predict call {ms:.1f} ms [{smi}]")
                if errs[worst] > HEAD_TOL or share < FULL_SIZE_BF16_SHARE:
                    raise AssertionError(f"full_size bf16 {bucket}: head {errs[worst]:.3e}, "
                                         f"share {share:.3f}")
        del model
        torch.cuda.empty_cache()


# -------------------------------------------------------------- convergence
CONVERGENCE_STEPS = 500
CONVERGENCE_BATCH = 8
CONVERGENCE_HW = (256, 256)
CONVERGENCE_LOSS_FACTOR = 0.75    # last logged loss <= this x the first (centerness BCE stays)
CONVERGENCE_STEP = {"fused_stem": 1, "fused_bottleneck": 13}
CONVERGENCE_PREDICT = {"fused_stem": 1, "fused_bottleneck": 13, "nms": 1}


def convergence_kernel_checks(dev, batch, hw):
    """The stem and the five bottleneck shapes at ``hw`` and ``batch`` in bf16
    against their plain versions (BF16_TOL): shapes no other phase gives
    them (res5 is 8 x 8 at 256 x 256)."""
    from slenderobjdet_torch.ops.fused_bottleneck import (bottleneck_plan, fused_bottleneck,
                                                          reference_bottleneck)
    from slenderobjdet_torch.ops.fused_stem import fused_stem, reference_stem, stem_plan

    h, w = hw
    x, wt, scale, bias = stem_inputs(batch, h, w, 64, dev, seed=40)
    xb = x.to(torch.bfloat16)
    err = ratio(fused_stem(xb, wt, scale, bias), reference_stem(xb, wt, scale, bias))
    route = stem_plan(torch.bfloat16, batch, h, w, 64)["route"]
    log(f"convergence stem B={batch} {h}x{w} bf16 ({route}): err ratio {err:.3e} "
        f"(tol {BF16_TOL})")
    if not (route == "mma" and err <= BF16_TOL):
        raise AssertionError(f"convergence stem: {route}, err {err}")
    g = torch.Generator(device="cpu").manual_seed(41)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=g) * s).to(dev)

    for name, bh, bw, cin, cm, cout, proj, _ in loader_blocks(h, w):
        args = (rnd(cin, cm, s=cin ** -0.5), rnd(cm, s=0.1),
                rnd(3, 3, cm, cm, s=(9 * cm) ** -0.5), rnd(cm, s=0.1),
                rnd(cm, cout, s=cm ** -0.5), rnd(cout, s=0.1),
                *((rnd(cin, cout, s=cin ** -0.5), rnd(cout, s=0.1)) if proj else (None, None)))
        xb = torch.relu(rnd(batch, bh, bw, cin)).to(torch.bfloat16)
        plan = bottleneck_plan(torch.bfloat16, batch, bh, bw, cin, cm, cout)
        err = ratio(fused_bottleneck(xb, *args), reference_bottleneck(xb, *args))
        log(f"convergence bottleneck {name} B={batch} {bh}x{bw} bf16 ({plan['route']}, "
            f"{plan.get('m_tiles')} pixel tiles): err ratio {err:.3e} (tol {BF16_TOL})")
        if not (plan["route"] == "wgmma" and err <= BF16_TOL):
            raise AssertionError(f"convergence bottleneck {name}: {plan['route']}, err {err}")


def phase_convergence(kernels, dev, smi):
    """``convergence_run.main`` on FCOS R-50-FPN as a user runs it, with the
    launch counts read around its training and around its held-out predict
    calls."""
    from slenderobjdet_torch.ops import _build
    from slenderobjdet_torch.tools import convergence_run

    convergence_kernel_checks(dev, CONVERGENCE_BATCH, CONVERGENCE_HW)
    counts = {}
    held_out = convergence_run.held_out

    def counted_held_out(*args):
        torch.cuda.synchronize()
        counts["train"] = {k: v for k, v in _build.launch_counts().items() if v}
        _build.reset_launch_counts()
        out = held_out(*args)
        torch.cuda.synchronize()
        counts["predict"] = {k: v for k, v in _build.launch_counts().items() if v}
        return out

    argv = ["--config-file", FCOS_YAML, "--steps", str(CONVERGENCE_STEPS),
            "--batch", str(CONVERGENCE_BATCH), "--hw", *map(str, CONVERGENCE_HW),
            "MODEL.RESNETS.FUSED_STEM", "True", "MODEL.RESNETS.FUSED_BLOCKS", "True",
            "TPU.COMPUTE_DTYPE", "bfloat16"]
    convergence_run.held_out = counted_held_out
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t = time.perf_counter()
        res = convergence_run.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    finally:
        convergence_run.held_out = held_out
    want = {"train": {k: v * CONVERGENCE_STEPS for k, v in CONVERGENCE_STEP.items()},
            "predict": {k: v * convergence_run.HELD_OUT_BATCHES
                        for k, v in CONVERGENCE_PREDICT.items()}}
    losses = [loss for _, loss in res["log"]]
    log(f"convergence FCOS R-50-FPN bf16 fused, B={CONVERGENCE_BATCH} "
        f"{CONVERGENCE_HW[0]}x{CONVERGENCE_HW[1]}, {CONVERGENCE_STEPS} steps: first_loss "
        f"{res['first_loss']:.4f}, last_loss {res['last_loss']:.4f} "
        f"({res['last_loss'] / res['first_loss']:.3f} of the first; at most "
        f"{CONVERGENCE_LOSS_FACTOR}), precision@0.5 {res['precision@0.5']}, recall@0.5 "
        f"{res['recall@0.5']}, {seconds:.1f} s (model build included), launches {counts} "
        f"[{smi}]")
    if counts != want:
        raise AssertionError(f"convergence: launched {counts}, expected {want}")
    if not all(np.isfinite(losses)) or not res["last_loss"] <= \
            CONVERGENCE_LOSS_FACTOR * res["first_loss"]:
        raise AssertionError(f"convergence: logged losses {res['log']}")


# -------------------------------------------------------------------- tools
TOOLS_IMAGES = 16
TOOLS_BATCH = 8                     # inference_obj365's --batch-size
TOOLS_HW = ((800, 1333), (1333, 800))
TOOLS_FUSED = ["MODEL.RESNETS.FUSED_STEM", "True", "MODEL.RESNETS.FUSED_BLOCKS", "True"]
TOOLS_OBJ365 = {"fused_stem": 1, "fused_bottleneck": 13, "nms": 1}     # a batch
TOOLS_PROPOSALS = {"fused_stem": 1, "fused_bottleneck": 13, "nms": 2}  # a batch
TOOLS_ADAPTION = {"fused_stem": 1, "fused_bottleneck": 13}             # an image


def png_dataset(tmp, n=TOOLS_IMAGES, seed=30, num_classes=80):
    """A COCO json of ``n`` PNG images (written by ``utils/png.py``) at the
    loader's two orientations, 3-8 integer-pixel boxes each with a polygon
    segmentation; returns (json path, image root)."""
    import os

    from slenderobjdet_torch.utils import png

    rs = np.random.RandomState(seed)
    root = os.path.join(tmp, "images")
    os.makedirs(root)
    images, anns = [], []
    for i in range(1, n + 1):
        h, w = TOOLS_HW[i % 2]
        img = rs.randint(0, 60, (h, w, 3)).astype(np.uint8)
        for _ in range(rs.randint(3, 9)):
            bw, bh = int(rs.randint(16, 300)), int(rs.randint(16, 300))
            x, y = int(rs.randint(0, w - bw)), int(rs.randint(0, h - bh))
            img[y:y + bh, x:x + bw] = rs.randint(120, 255, 3)
            anns.append({"id": len(anns) + 1, "image_id": i, "iscrowd": 0,
                         "category_id": int(rs.randint(1, num_classes + 1)),
                         "bbox": [float(x), float(y), float(bw), float(bh)],
                         "area": float(bw * bh),
                         "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]})
        name = f"{i:06d}.png"
        with open(os.path.join(root, name), "wb") as f:
            f.write(png.encode(img, level=1))
        images.append({"id": i, "file_name": name, "height": h, "width": w})
    path = os.path.join(tmp, "instances.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": c, "name": f"class{c}"} for c in range(1, num_classes + 1)]}, f)
    return path, root


def tool_run(label, fn, argv, per_unit, units):
    """``fn(argv)`` with the launch counts set to 0 just before and read just
    after; they must be ``per_unit`` times ``units``. Returns the result and
    the seconds it took."""
    from slenderobjdet_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t = time.perf_counter()
    out = fn(argv)
    torch.cuda.synchronize()
    s = time.perf_counter() - t
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    want = {k: v * units for k, v in per_unit.items()}
    if counts != want:
        raise AssertionError(f"tools {label}: launched {counts}, expected {want}")
    return out, s


TOOLS_TIMEOUT_S = 300


def phase_tools(kernels, dev, smi):
    """``tools_child`` in a fresh process (the kernels already built), so
    that its ``sys.modules`` shows what the tools import: earlier phases may
    import cv2 where it is installed (the loader resizes TTA's views with
    it)."""
    import os
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.tools_child()"],
                       cwd=here, timeout=TOOLS_TIMEOUT_S)
    if r.returncode:
        raise AssertionError(f"tools: the child process exited {r.returncode}")


def tools_child():
    """The port's tools on a synthetic PNG dataset at the loader's shapes, in
    this process: ``inference_obj365`` (FCOS
    R-50-FPN, 16 images at B = 8, run twice: 2 x (1 + 13 + 1) launches each,
    chunks, results, metrics), ``eval_and_save_proposals`` (Faster R-CNN R-50-FPN, B = 4: 4 x
    (1 + 13 + 2), the pkl's schema), ``vis_feat_adaption`` (RepPoints
    R-50-FPN, 2 images of 1 + 13), ``mask_to_rbox``, ``generate_border_maps``
    and ``visualize_json_results``; every PNG decodes at its shape; then
    ``root_tools``; and neither cv2 nor jax is in ``sys.modules``."""
    import os
    import pickle
    import tempfile

    smi = card_line()
    importers = ImportWitness(("cv2", "jax"))
    sys.meta_path.insert(0, importers)

    from slenderobjdet_torch.data import DatasetCatalog
    from slenderobjdet_torch.data.datasets import register_coco_instances
    from slenderobjdet_torch.tools import (eval_and_save_proposals, generate_border_maps,
                                           inference_obj365, mask_to_rbox, vis_feat_adaption,
                                           visualize_json_results)
    from slenderobjdet_torch.utils import png

    name = "chip_smoke_tools"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        t = time.perf_counter()
        path, root = png_dataset(tmp)
        log(f"tools: {TOOLS_IMAGES} PNG images written in {time.perf_counter() - t:.1f} s")
        for run in ("warm-up", "timed"):      # the first pays this process's CUDA set-up
            out = os.path.join(tmp, f"obj365_{run}")
            results, s = tool_run("inference_obj365", inference_obj365.main, [
                "--config-file", FCOS_YAML, "--gt-json", path, "--image-root", root,
                "--out-dir", out, "--batch-size", str(TOOLS_BATCH), "--chunk", "8",
                *TOOLS_FUSED, "MODEL.FCOS.PRIOR_PROB", "0.5"],
                TOOLS_OBJ365, TOOLS_IMAGES // TOOLS_BATCH)
        files = sorted(os.listdir(out))
        for f in ("results_chunk_0000.json", "results_chunk_0001.json",
                  "coco_instances_results.json", "obj365_metrics.json"):
            if f not in files:
                raise AssertionError(f"tools inference_obj365: no {f} in {files}")
        with open(os.path.join(out, "coco_instances_results.json")) as f:
            n_dets = len(json.load(f))
        if "bbox" not in results or not n_dets:
            raise AssertionError(f"tools inference_obj365: {n_dets} results, {list(results)}")
        log(f"tools inference_obj365: {TOOLS_IMAGES / s:.2f} img/s through the tool "
            f"(model build and PNG decode included, {s:.1f} s), {n_dets} results, "
            f"bbox AP {results['bbox'].get('AP', float('nan')):.3f} [{smi}]")

        if name in DatasetCatalog:
            DatasetCatalog.remove(name)
        register_coco_instances(name, path, root)
        pkl = os.path.join(tmp, "box_proposals.pkl")
        data, s = tool_run("eval_and_save_proposals", eval_and_save_proposals.main, [
            "--config-file", RCNN_YAML, "--out", pkl, "--max-images", str(TOOLS_IMAGES),
            *TOOLS_FUSED, "DATASETS.TEST", f"('{name}',)"],
            TOOLS_PROPOSALS, TOOLS_IMAGES // eval_and_save_proposals.BATCH)
        with open(pkl, "rb") as f:
            saved = pickle.load(f)
        if sorted(saved) != ["anchors", "bbox_mode", "boxes", "ids", "objectness_logits"] \
                or sorted(saved["ids"]) != list(range(1, TOOLS_IMAGES + 1)) \
                or any(b.shape[1] != 4 or len(b) != len(g) or not len(b)
                       for b, g in zip(saved["boxes"], saved["objectness_logits"])):
            raise AssertionError("tools eval_and_save_proposals: the pkl's schema")
        log(f"tools eval_and_save_proposals: {TOOLS_IMAGES / s:.2f} img/s through the tool "
            f"(model build and PNG decode included, {s:.1f} s), "
            f"{np.mean([len(b) for b in saved['boxes']]):.0f} proposals an image [{smi}]")

        views, s = tool_run("vis_feat_adaption", vis_feat_adaption.main, [
            "--config-file", REPPOINTS_YAML, "--gt-json", path, "--image-root", root,
            "--out-dir", os.path.join(tmp, "adapt"), "--num-images", "2", *TOOLS_FUSED],
            TOOLS_ADAPTION, 2)
        for v in views:
            if png.imread(v).shape[2] != 3 or png.imread(v).shape[:2] not in LOADER_SHAPES:
                raise AssertionError(f"tools vis_feat_adaption: {v}")

        rjson = os.path.join(tmp, "rcoco.json")
        mask_to_rbox.main(["--gt-json", path, "--out", rjson])
        with open(rjson) as f:
            anns = json.load(f)["annotations"]
        if not anns or any(len(a["rbox"]) != 5 for a in anns):
            raise AssertionError("tools mask_to_rbox: rboxes")
        maps = os.path.join(tmp, "maps")
        done = generate_border_maps.main(["--gt-json", path, "--out-dir", maps])
        for f in sorted(os.listdir(maps)):
            with np.load(os.path.join(maps, f)) as z:
                if sorted(z.files) != ["border", "center", "sizes"]:
                    raise AssertionError(f"tools generate_border_maps: {f} holds {z.files}")
        panels = visualize_json_results.main([
            "--result", os.path.join(out, "coco_instances_results.json"), "--gt-json", path,
            "--image-root", root, "--output", os.path.join(tmp, "vis"),
            "--conf-threshold", "0.0", "--max-images", "4"])
        for p in panels:
            if png.imread(p).shape[1] not in (2 * 1333, 2 * 800):
                raise AssertionError(f"tools visualize_json_results: {p}")
        log(f"tools: {len(views)} adaption views, {len(anns)} rboxes, {done} map files, "
            f"{len(panels)} result panels")
        root_tools(tmp, path, os.path.join(out, "coco_instances_results.json"), name, smi)
    import importlib.util

    loaded = [m for m in ("cv2", "jax") if m in sys.modules]
    log("tools: installed on this machine: "
        f"{[m for m in ('cv2', 'jax') if importlib.util.find_spec(m)]}; imported: {loaded}")
    if loaded:
        for name in loaded:
            log(f"tools: {name} first imported from\n{importers.stacks.get(name)}")
        raise AssertionError(f"tools: the process imported {loaded}")


class ImportWitness:
    """A ``sys.meta_path`` finder that finds nothing: it keeps the stack of
    the first import of each of ``names``, so that a failed import check
    says who imported the module."""

    def __init__(self, names):
        self.names, self.stacks = names, {}

    def find_spec(self, name, path=None, target=None):
        if name in self.names and name not in self.stacks:
            self.stacks[name] = "".join(traceback.format_stack()[:-1])
        return None


DATA_TIME_IMAGES = 64
DATA_TIME_ARGS = ["--config-file", FCOS_YAML, "--iters", "8", "--decoder", "png"]


def root_tools(tmp, gt_json, results_json, dataset, smi):
    """The root tools of ``tools_child``'s second half: ``data_time`` (PNG
    files and a PNG RecordPack, and the stage budget), ``compare_matchers``
    on the card, the five readers over ``results_json``, ``watch_evaluate
    --once`` and ``run_experiments --dry-run``."""
    import os
    import pickle
    import shutil

    from slenderobjdet_torch.config import get_cfg
    from slenderobjdet_torch.tools import (ar_result, coco_class_info, compare_matchers,
                                           data_statistic, data_time, regression,
                                           result_statistic, run_experiments, watch_evaluate)

    for extra in ([], ["--pack"]):
        r = data_time.main(DATA_TIME_ARGS + ["--synthetic", str(DATA_TIME_IMAGES), *extra])
        source = "a RecordPack" if extra else "files"
        if r["decoder"] != "png" or r["shapes"]["image"][1:] not in \
                [(*hw, 3) for hw in LOADER_SHAPES]:
            raise AssertionError(f"tools data_time: {r['decoder']}, {r['shapes']}")
        log(f"tools data_time: {r['img_s']:.1f} img/s from {source} ({r['images']} images "
            f"of 480x640 in {r['batches']} batches of {r['shapes']['image']}), decoder "
            f"{data_time.DECODER_NAMES[r['decoder']]}, host {os.cpu_count()} cores [{smi}]")
    rows = data_time.main(DATA_TIME_ARGS + ["--stage-budget"])["rows"]
    if [n for n, _ in rows][0] != "png decode":
        raise AssertionError(f"tools data_time --stage-budget: {rows}")

    cfg = get_cfg()
    cfg.merge_from_file(RCNN_YAML)
    cfg.DATASETS.TEST = (dataset,)
    cfg_file = os.path.join(tmp, "rcnn_matchers.yaml")
    with open(cfg_file, "w") as f:
        f.write(cfg.dump())
    m = compare_matchers.main(["--config-file", cfg_file, "--num-images", "8"])
    if m["images"] != 8 or not (np.mean(m["topk"]) > 0 and np.mean(m["iou"]) > 0):
        raise AssertionError(f"tools compare_matchers: {m}")

    pkl = os.path.join(tmp, "restat.pkl")
    metrics = result_statistic.main(["--prediction", results_json, "--gt-json", gt_json,
                                     "--out", pkl])
    ar = ar_result.main(["--results", results_json, "--gt-json", gt_json])
    classes = coco_class_info.main(["--gt-json", gt_json])
    buckets = data_statistic.main(["--gt-json", gt_json])
    metrics_json = os.path.join(tmp, "evaluate_metrics.json")
    with open(metrics_json, "w") as f:
        json.dump(metrics, f, default=float)
    reg = regression.main(["--metrics", metrics_json, "--coco-json", gt_json])
    if not (np.isfinite(metrics["bbox"]["AP"]) and np.isfinite(ar["ar"]) and classes
            and sum(buckets.values()) and len(reg["x"]) >= 2):
        raise AssertionError("tools readers")

    watch = os.path.join(tmp, "watch")
    os.makedirs(watch)
    watched = os.path.join(watch, "coco_instances_results.json")
    shutil.copy(results_json, watched)
    done = watch_evaluate.main(["--watch-dir", watch, "--gt-json", gt_json, "--once"])
    with open(os.path.join(watch, "coco_instances_results.pkl"), "rb") as f:
        again = pickle.load(f)
    if done != [(watched, 0)] or not os.path.exists(watched + ".evaluated") \
            or json.dumps(again, default=float) != json.dumps(metrics, default=float):
        raise AssertionError(f"tools watch_evaluate: {done}")

    runs = run_experiments.main(["--model", "fcos", "--dry-run", "--opts",
                                 "SOLVER.MAX_ITER", "20"])
    for depth, cmd in zip((50, 101, 152), runs["commands"]):
        if cmd[1:4] != ["train_net_torch.py", "--resume", "--config-file"] or \
                cmd[4] != f"configs/group_exp_for_backbone/fcos/r-{depth}.yaml" or \
                not cmd[6].endswith(f"_fcos_R_{depth}_FPN_1x") or \
                cmd[-2:] != ["SOLVER.MAX_ITER", "20"]:
            raise AssertionError(f"tools run_experiments: {cmd}")
    log(f"tools readers: bbox AP {metrics['bbox']['AP']:.3f}, AR@100 {ar['ar'] * 100:.2f}, "
        f"{len(classes)} classes, buckets {buckets}, regression over {len(reg['x'])} "
        f"categories; compare_matchers iou {np.mean(m['iou']):.2f} / topk "
        f"{np.mean(m['topk']):.2f} positives a gt; watch_evaluate {done}; "
        f"run_experiments {len(runs['commands'])} commands")


# ----------------------------------------------------------------- profiles
PROFILES_TIMEOUT_S = 400
PROFILE_ARGS = ["--batch", "8", "--reps", "2"]
_NMS = {"nms": 1}
_BLOCKS = {"res2": 3, "res3": 3, "res4": 5, "res5": 2, "full-resnet50": 13,
           "backbone+FPN(graph)": 13, "fwd(backbone+head)": 13, "predict(full)": 13}
_CORNER = {"corner_pool": 2}
_BACKBONE_LABELS = ["B=8 800x1344", "stage", "GFLOP/img", "TFLOPS", "stem(norm+7x7+pool)",
                    "res2", "res3", "res4", "res5", "full-resnet50", "backbone+FPN(graph)",
                    "fwd(backbone+head)", "predict(full)"]
_RCNN_LABELS = ["B=8 800x1344:", "backbone+RPN fwd", "+RPN proposals", "+ROIAlign pool",
                "+box head", "full predict", "ms/img final NMS", "total"]
_RCNN_LAUNCHES = {"+RPN proposals": _NMS, "+ROIAlign pool": _NMS, "+box head": _NMS,
                  "full predict": {"nms": 2}}
# (tool, argv, the JAX script's labels in the order it prints them, the
# kernel launches a call of each stage; a stage not named launches none)
PROFILES = [
    ("predict_profile", PROFILE_ARGS, ["fwd ", "fwd+cand ", "full "], {"full": _NMS}),
    ("postprocess_probe", ["--batch", "8"],
     ["cand 100x168 (L= 16800)", "cand  50x 84 (L=  4200)", "cand  25x 42 (L=  1050)",
      "cand  13x 21 (L=   273)", "cand   7x 11 (L=    77)", "cand total",
      "nms  (B,5000)x100"], {"nms": _NMS}),
    ("profile_backbone", PROFILE_ARGS, _BACKBONE_LABELS, {"predict(full)": _NMS}),
    ("profile_backbone", [*PROFILE_ARGS, "--fused"], _BACKBONE_LABELS,
     {**{k: {"fused_bottleneck": v} for k, v in _BLOCKS.items()},
      "predict(full)": {"fused_bottleneck": 13, "nms": 1}}),
    ("rcnn_profile", PROFILE_ARGS, _RCNN_LABELS, _RCNN_LAUNCHES),
    ("rcnn_profile", [*PROFILE_ARGS, "--all-level-pool"], _RCNN_LABELS, _RCNN_LAUNCHES),
    ("reppoints_profile", [*PROFILE_ARGS, "--full"],
     ["B=8 800x1344:", "backbone+FPN", "full head forward", "ms/img head", "full predict",
      "ms/img post", "P3 2C gather alone"], {"full predict": _NMS}),
    ("corner_profile", ["--reps", "2", "--stages"],
     ["decode stages (vs fwd", "NOTE", "+corner topk", "+pairing", "+NMS", "B=4 512x768:",
      "hourglass backbone", "+pools/heads", "full predict", "ms/img decode", "total"],
     {"+pools/heads": _CORNER, "full predict": {**_CORNER, **_NMS}, "decode topk": _CORNER,
      "decode pair": _CORNER, "decode nms": {**_CORNER, **_NMS}}),
]


def labels_in_order(text, labels):
    """The first of ``labels`` not found in ``text`` after the one before
    it, or None."""
    at = 0
    for label in labels:
        at = text.find(label, at)
        if at < 0:
            return label
        at += len(label)
    return None


def phase_profiles(kernels, dev, smi):
    """``profiles_child`` in a fresh process, so that its ``sys.modules``
    shows what the profile tools import."""
    import os
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", "import chip_smoke; chip_smoke.profiles_child()"],
                       cwd=here, timeout=PROFILES_TIMEOUT_S)
    if r.returncode:
        raise AssertionError(f"profiles: the child process exited {r.returncode}")


def profiles_child():
    """Each of PROFILES through its ``main`` on the card: its printed table
    logged and checked for the JAX script's labels, its stage times finite
    and positive, each stage's kernel launches a call as listed; then
    neither cv2 nor jax is in ``sys.modules``."""
    import importlib
    import io

    smi = card_line()
    importers = ImportWitness(("cv2", "jax"))
    sys.meta_path.insert(0, importers)
    failed = []
    for name, argv, labels, launches in PROFILES:
        tool = importlib.import_module(f"slenderobjdet_torch.tools.{name}")
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            res = tool.main(list(argv))
        s = time.perf_counter() - t
        text = out.getvalue()
        label = " ".join([name, *argv])
        log(f"profiles {label} ({s:.1f} s with the model build):\n{text.rstrip()}")
        missing = labels_in_order(text, labels)
        bad_ms = {k: v for k, v in res["ms"].items() if not (np.isfinite(v) and v > 0)}
        want = {stage: launches.get(stage, {}) for stage in {*res["launches"], *launches}}
        if not text.startswith(smi) or missing is not None or bad_ms \
                or res["launches"] != want:
            log(f"profiles {label}: FAILED: card line {text.startswith(smi)}, label "
                f"{missing!r} missing, times {bad_ms}, launches {res['launches']}, "
                f"expected {want}")
            failed.append(label)
        torch.cuda.empty_cache()
    loaded = [m for m in ("cv2", "jax") if m in sys.modules]
    for name in loaded:
        log(f"profiles: {name} first imported from\n{importers.stacks.get(name)}")
    if failed or loaded:
        raise AssertionError(f"profiles: failed {failed}, imported {loaded}")
    log(f"profiles: {len(PROFILES)} runs ok, neither cv2 nor jax imported [{smi}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "a CUDA device", file=sys.stderr)
        return 2
    smi = card_line()
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from slenderobjdet_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"from {_build.library_path()}")

    src = "slenderobjdet_torch/ops/csrc"
    kernels = {
        "nms": {"name": "nms", "route": "cuda", "source": f"{src}/nms.cu",
                "replaces": "slenderobjdet_tpu/ops/pallas_nms.py:29"},
        "fused_stem": {"name": "fused_stem", "route": "cuda",
                       "source": f"{src}/fused_stem.cu",
                       "replaces": "slenderobjdet_tpu/ops/fused_stem.py:111"},
        "fused_bottleneck": {"name": "fused_bottleneck", "route": "cuda",
                             "source": f"{src}/fused_bottleneck.cu",
                             "replaces": "slenderobjdet_tpu/ops/fused_bottleneck.py:55"},
        "fused_kernel_probe": {"name": "fused_kernel_probe", "route": "cuda",
                               "source": f"{src}/fused_bottleneck.cu",
                               "replaces": "tools/fused_kernel_probe.py:38"},
        "dma_streams_probe": {"name": "dma_streams_probe", "route": "cuda",
                              "source": f"{src}/dma_streams_probe.cu",
                              "replaces": "tools/dma_streams_probe.py:28"},
        "bw_probe": {"name": "bw_probe", "route": "cuda", "source": f"{src}/bw_probe.cu",
                     "replaces": "tools/pallas_bw_probe.py:37"},
        # no Pallas kernel: these replace the JAX package's XLA compositions
        "rotated_iou": {"name": "rotated_iou", "route": "cuda", "source": f"{src}/rotated.cu",
                        "replaces": "slenderobjdet_tpu/ops/rotated.py:114", "launches": 0},
        "rotated_nms": {"name": "rotated_nms", "route": "cuda", "source": f"{src}/rotated.cu",
                        "replaces": "slenderobjdet_tpu/ops/rotated.py:128", "launches": 0},
        "corner_pool": {"name": "corner_pool", "route": "cuda",
                        "source": f"{src}/corner_pool.cu",
                        "replaces": "slenderobjdet_tpu/ops/corner_pool.py:47", "launches": 0},
    }
    failed = []
    only = tuple(sys.argv[1:])      # name prefixes: a partial run, for development

    def run(name, fn, *args):
        if only and not name.startswith(only):
            return False
        t = time.perf_counter()
        try:
            fn(*args)
            log(f"phase {name}: ok ({time.perf_counter() - t:.1f} s)")
            return True
        except Exception:  # every phase runs; any failure fails the run
            traceback.print_exc()
            log(f"phase {name}: FAILED")
            failed.append(name)
            return False

    run("nms", phase_nms, kernels, dev)
    run("stem", phase_stem, kernels, dev)
    run("bottleneck", phase_bottleneck, kernels, dev)
    torch.cuda.empty_cache()
    models = []
    if run("build", lambda: models.extend(build_models(dev))):
        run("main_path", phase_main_path, kernels, dev, *models)
        del models[2]
        torch.cuda.empty_cache()
        run("throughput", phase_throughput, *models)
    models.clear()
    torch.cuda.empty_cache()
    run("probes", phase_probes, kernels, dev)
    torch.cuda.empty_cache()
    bare = {}
    run("train", phase_train, dev, bare)
    torch.cuda.empty_cache()
    run("trainer", phase_trainer, kernels, dev, smi, bare)
    torch.cuda.empty_cache()
    run("serving", phase_serving, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("int8", phase_int8, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("tta", phase_tta, kernels, dev, smi)
    torch.cuda.empty_cache()
    if run("retinanet_build", lambda: models.extend(
            build_models(dev, RETINANET_YAML, RETINANET_CLS_BIAS))):
        run("retinanet", phase_retinanet, kernels, dev, smi, models)
    models.clear()
    torch.cuda.empty_cache()
    run("retinanet_train", phase_retinanet_train, dev, smi)
    torch.cuda.empty_cache()
    run("retinanet_trainer", phase_retinanet_trainer, kernels, dev, smi)
    torch.cuda.empty_cache()
    if run("rcnn_build", lambda: models.extend(build_rcnn_models(dev))):
        run("rcnn", phase_rcnn, kernels, dev, smi, models)
    models.clear()
    torch.cuda.empty_cache()
    run("rcnn_train", phase_rcnn_train, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("rcnn_trainer", phase_rcnn_trainer, kernels, dev, smi)
    torch.cuda.empty_cache()
    if run("reppoints_build", lambda: models.extend(build_reppoints_models(dev))):
        run("reppoints", phase_reppoints, kernels, dev, smi, models)
    models.clear()
    torch.cuda.empty_cache()
    run("reppoints_train", phase_reppoints_train, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("reppoints_trainer", phase_reppoints_trainer, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("reppoints_variants", phase_reppoints_variants, kernels, dev, smi)
    torch.cuda.empty_cache()
    built = {}
    run("ablation_build", phase_ablation_build, dev, smi, built)
    run("ablation", phase_ablation, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("ablation_train", phase_ablation_train, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("ablation_trainer", phase_ablation_trainer, kernels, dev, smi)
    torch.cuda.empty_cache()
    if built:
        run("ablation_grid", phase_ablation_grid, kernels, dev, smi, built)
    built.clear()
    torch.cuda.empty_cache()
    run("ddp", phase_ddp, kernels, dev, smi)
    torch.cuda.empty_cache()
    if run("proposal_build", build_proposal_models, dev, smi, built):
        run("proposal", phase_proposal, kernels, dev, smi, built)
    built.clear()
    torch.cuda.empty_cache()
    run("proposal_train", phase_proposal_train, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("proposal_trainer", phase_proposal_trainer, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("syncbn", phase_syncbn, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("fcosv3", phase_fcosv3, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("rotated_retinanet", phase_rotated_retinanet, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("rotated_retinanet_train", phase_rotated_retinanet_train, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("rotated_retinanet_trainer", phase_rotated_retinanet_trainer, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("rotated_rcnn", phase_rotated_rcnn, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("rotated_rcnn_train", phase_rotated_rcnn_train, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("rotated_rcnn_trainer", phase_rotated_rcnn_trainer, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("cornernet", phase_cornernet, kernels, dev, smi)
    torch.cuda.empty_cache()
    corner = {}
    run("cornernet_train", phase_cornernet_train, kernels, dev, smi, corner)
    torch.cuda.empty_cache()
    run("cornernet_trainer", phase_cornernet_trainer, kernels, dev, smi, corner)
    torch.cuda.empty_cache()
    run("pvt", phase_pvt, kernels, dev, smi)
    torch.cuda.empty_cache()
    pvt = {}
    run("pvt_train", phase_pvt_train, kernels, dev, smi, pvt)
    torch.cuda.empty_cache()
    run("pvt_trainer", phase_pvt_trainer, kernels, dev, smi, pvt)
    torch.cuda.empty_cache()
    run("vt_fpn", phase_vt_fpn, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("full_size", phase_full_size, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("tools", phase_tools, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("convergence", phase_convergence, kernels, dev, smi)
    torch.cuda.empty_cache()
    run("profiles", phase_profiles, kernels, dev, smi)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    if only:
        log(f"partial run of the phases named {only}*: no result line")
        print(smi)
        return 3
    log_bounds(kernels)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
