#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (cerberusnet_torch) on one GPU and checks it.

    python3 chip_smoke.py

Phases, each printing one JSON line (``at_s``: its seconds since the script
started); any failed check exits non-zero:
  env      the card (nvidia-smi name and power limit), torch and CUDA
  build    nvcc builds every kernel of the path from cerberusnet_torch/csrc;
           each kernel's registers, spills and stack from ptxas, and for the
           tensor-core level kernels their tiles, the halo recompute those
           imply, shared memory per block and the blocks the card keeps on
           an SM
  kernels  each correlation kernel, forward and backward, against its plain
           PyTorch version on the card, at the five pyramid-level shapes of
           a 512x1024 frame (the forwards at batch 1, as served, and at
           batch 2, as trained; the backwards at batch 2), in bfloat16 and
           float32, plus one dilation-2 case; and at the DCV heads' level-3
           shape (B, 64, 128, 64) with d = D = 4, the 2-D kernels at
           dilations 1, 2, 4, 8 and the 1-D ones at 1, 2, 3, at the same
           batches; all six also at odd shapes (B, 3, 37, 20) and
           (B, 3, 37, 21) at dilations 1 and 3, the backwards also at 25,
           and the forwards at level 6's width, (B, 64, 256, 196), the 2-D
           one at dilations 14 and 25 and the 1-D one at 15 and 25, where a
           block stages only a group of the residue classes, and all six at
           the five level shapes of fit's 128x256 frame (forwards at batch 1
           and 4, backwards at 4; level 6 is (B, 2, 4, C), narrower than a
           tile and shorter than the 2-D window), and in bf16 at the
           evaluation slice's shapes: all six at the levels of 384x768,
           batch 2 (FlyingThings3D), the forwards at the levels of TTA's
           384x768, 512x1024 and 640x1280 frames, batch 1, and of the 3 x 3
           tiles of 512x1024 in one batch of 9, and all six on the bands of
           train_spatial: CerberusNet's five levels and CerberusDCV's level
           3 on the 256-row band of 2 ranks (the 2-D kernels on f1 and f2
           haloed by their reach), the 2-D kernels also on the 8-row band
           of 384x1248's level 3 on 4 ranks, at the DCV dilations, and all
           six on rank 0's 22-row band of 368x768's level 3 (part (d)), and
           the forwards at the stream's fast model's five level shapes
           (batch 1); each check names the design that ran, as the library
           counted its launches ("tc": every bf16 correlation kernel on the
           tensor cores; "cuda_cores": float32), and fails on any other;
           and the fused encoder-level kernels: K9
           (encoder_level_fwd) at the three level shapes of pallas_levels=3
           at batch 3 (served) and 6 (trained) and four odd shapes (output
           extents no multiple of a tile, at levels 1-3's widths and one
           width the tensor cores do not take), K10 (encoder_level_bwd) at
           the level shapes at batch 6 and the odd shapes, in bfloat16 and
           float32, against the plain level (cuDNN; K10 against it in
           float64, within limits that allow for LeakyReLU mask flips),
           K10's dk and db bit-identical over two runs, K9's weights as the
           library packs them on the device bit-equal to pack_b's (which
           packs K10's); CUDA-event times of
           kernel and plain version in turns beside the kernel's bound
  serve    the default-width CerberusNet through cerberusnet_torch.entry,
           bf16 at 512x1024, answering 3 seeded requests: output shapes,
           types and finiteness, the pyramids, and 5 + 5 kernel launches per
           request; then the same weights and inputs with the plain
           correlations in bf16 and in float32 (the yardstick), and the
           eager forward's CUDA-event time; then (serve_arithmetic) the
           same model with naive estimators (fused=False) against the
           served reference default (fused=True): float32 heads within
           1e-3 relative L2, the naive bf16 kernel path by the plain bf16
           rule against float32, its 5 + 5 kernel launches a request, the
           two forms' ms a frame in turns and their device launches a
           forward (torch.profiler)
  stream   cerberusnet_torch.examples.video_stream for each of its models
           (cerberus, dcv, fast: CerberusNet at encoder (16, 24, 32, 48,
           64, 96)), bf16 at 512x1024, 32 frames, 8 latency samples: the
           copy stream's uploads, p50/p99 latency, streamed and
           compute-bound fps; 5 + 5 (cerberus, fast) or 4 + 3 (dcv) kernel
           launches a forward; frames 0, 16 and 31's streamed outputs
           against the forward of the same frames already on the device
           (bit-equality expected, held within 1e-3 relative L2), and, the
           control, against the next frame's, which must miss; every
           correlation call of one more forward against its plain version;
           then RAFTFlowNet at default widths, 256x512, from one state at
           1, 2, 4 and 8 iterations (examples/raft_anytime_inference.py):
           count k's level field bit-equal to the 8-count run's k-th
           iterate
  bench    the headline of python -m cerberusnet_torch.bench (CerberusNet
           through entry(), bf16, 512x1024, batch 1, three heads reduced;
           two-point slopes of back-to-back calls between CUDA events,
           n1 = 2, n2 = 12, 3 rounds): 5 + 5 kernel launches a call, fps
           with its band, FLOPs per frame (FlopCounterMode, the cerberus::
           operators by their formulas) equal to the same count with the
           plain operators, the MFU against the bf16 peak; its control,
           empty launches timed the same way, must raise
           FloorLimitedTiming; its ms per frame within 0.5-2x of serve's
           timing (CUDA events around one eager forward) of the same
           model and frames, in turns with the bench's rounds (3 turns of
           10 forwards and two rounds)
  train    5 steps of configs/cerberus_synthetic.json through
           cerberusnet_torch.entry.train_entry (bf16, batch 2, 512x1024,
           constant learning rate): finite losses, 5 launches of each of
           the six kernels per step, every weight moved; then one step's
           gradients from the same weights and batch with the plain
           correlations in bf16 and in float32 (the yardstick), per module
           and per correlation input, and the same with each backward
           kernel, and then all four, returning zeros, which that
           comparison must catch; ms per train step with the kernels and
           with the plain correlations, in turns, and the peak device
           memory
  serve_dcv  the default-width CerberusDCV through
           cerberusnet_torch.entry.entry(variant="cerberus_dcv"), as serve:
           4 + 3 kernel launches per request (the 2-D op at dilations
           1, 2, 4, 8 and the 1-D op at 1, 2, 3, at level 3), one-level
           pyramids
  train_dcv  5 steps of configs/cerberus_dcv.json (uncertainty weighting)
           as train: 4 launches of each 2-D kernel and 3 of each 1-D kernel
           per step, every weight and the three log-variances moved, the
           gradients of the seven correlation calls' inputs against the
           yardstick, and one control with all four backward kernels zeroed
  serve_pallas_levels  CerberusNet with its first three encoder levels
           fused (entry(pallas_levels=3)), as serve: 3 K9 and 5 + 5
           correlation launches per request, no K10; timed in turns against
           the default pallas_levels=0 path
  train_pallas_levels  5 steps of configs/cerberus_synthetic.json with
           pallas_levels=3, pallas_grad="pallas", as train: 3 K9 and 3 K10
           launches per step, the nine fused conv blocks', the 2-D
           correlation inputs' and levels 2 and 3's input gradients against
           the yardstick, and the same fused path in float32 against the
           float32 plain path, the 1-D correlation inputs too, each the
           median over the 5 batches;
           beside them, unheld, the fused path with K9's plain version
           rounded where K9 rounds; a control with K10 zeroed, one step
           with pallas_grad="xla" (K9, no K10); timed in turns against
           pallas_levels=0
  fit      Trainer.fit of configs/cerberus_evidence.json at its widths
           (128x256, batch 4, bf16, EMA 0.995) cut to 16 samples and 2
           epochs, evaluating, drawing its panel and checkpointing each
           epoch: 2 history rows with finite losses and the five held-out
           metrics, 8 steps, 5 launches of each correlation kernel a step
           and of each forward an evaluation batch, every bf16 call on the
           tensor cores; evaluate() changes no master; its metrics against
           the same EMA weights with the plain correlations; a resumed
           trainer's step, masters, EMA and optimizer state bit-equal, its
           next two steps' losses within 1e-3 of the first trainer's; one
           step's EMA by its rule; the panel's PNG decoded to its shape;
           then one more train step and one evaluation batch with every
           correlation call's output held to its plain version on the same
           tensors. A fit_times line gives ms per fit step, the loader's
           seconds per batch, evaluation seconds per batch and the
           checkpoint's bytes and save seconds beside the card's name and
           power limit
  serve_raft  the default-width CerberusRAFT through
           cerberusnet_torch.entry.entry(variant="cerberus_raft") (bf16,
           512x1024, level 3, 12 iterations, batch 1), 3 seeded requests:
           shapes, types and finiteness of every output, the one-level
           pyramids and the iterates (12, 1, 64, 128, 2) and (12, 1, 64,
           128, 1), and no hand-kernel launch (the family has none); the
           onehot and gather lookups on the same float32 weights within
           1e-4 relative L2 on each output (bf16 reported); the card
           against the CPU in float32 at 128x256 within 1e-4; eager ms per
           frame of both lookups in turns, here and at the deploy point
           (level 4, 6 iterations), and the peak memory of a request
  train_raft  5 steps of configs/cerberus_raft.json through train_entry
           (bf16 over float32 masters, batch 2, 512x1024, constant learning
           rate): finite losses with flow and disp from the sequence loss,
           no hand-kernel launch, every master moved but the upsampling
           masks' heads' biases (no loss reaches them: their gradients are
           checked to be zero); one step's gradients per module (the
           names' first three parts) against the float32 step's within
           0.1 relative L2 (RAFT_BF16_GRAD_RTOL),
           and one float32 step at 128x256 against the CPU's within 1e-3;
           ms per step of both lookups in turns and the peak memory; ms
           and device launches a step with the GRU's gates rounding as
           flax's (the model's) and as torch.sigmoid/torch.tanh, in turns
  fit_raft  Trainer.fit of configs/raft_evidence.json at its widths
           (128x256, batch 4, 8 iterations, EMA) cut as fit cuts its
           config: 2 history rows with finite losses and the five held-out
           metrics, no hand-kernel launch, evaluate() changing no master, a
           resumed trainer bit-equal and its next two steps' losses within
           1e-3, the EMA rule, the panel decoded; ms per fit step
  data     writes a KITTI-2015 fixture (375x1242, 16 samples, sparse 16-bit
           flow and disparity) and a Cityscapes one (1024x2048, 8 train and
           2 val samples, labelIds and the 16-bit disparity) with the
           port's writers from a seed, reads them back through the port's
           datasets (every PNG through the native decoder, else it fails;
           ms per sample decoded), holds preprocess (resizing to 384x1280
           and 512x1024) on the card to the CPU's (images within 1e-5, the
           ground truth equal) and the augmentation with the same draws
           (seg_aspp_cityscapes's set, and each zoom of a scales set): the
           crops and flips equal, resampled or jittered uint8 images within
           one level
  train_flow_kitti, train_stereo_kitti  configs/flow_kitti.json and
           stereo_kitti.json on the KITTI fixture as train runs
           CerberusNet's: FlowNet (StereoNet) at default widths, bf16,
           batch 2, 5 launches of each of K1-K3 (K4-K6) a step, the
           gradients and correlation taps against the float32 yardstick,
           zeroed controls, ms per step; at 384x1280, after showing that
           the configured 384x1248 raises (the reference's warp refuses it
           too)
  train_seg_aspp  Trainer.fit of configs/seg_aspp_cityscapes.json on the
           Cityscapes fixture, 3 epochs (batch 8, 384x768 crops with flips
           and jitter resized to 512x1024, bf16, EMA, evaluation on val,
           TensorBoard on): no hand-kernel launch, finite history, the
           event file's records and tags read back; ms per step, the
           loader's wait and the peak memory; the ASPP SegNet on the card
           against the CPU in float32 at 128x256 within 1e-4
  fit_dcv_kitti  Trainer.fit of configs/dcv_flow_kitti.json as it stands
           (384x1248, batch 4, its 4 decode threads) over the 16 KITTI
           samples, 2 epochs: 4 launches of each of K1-K3 a step, all on
           the tensor cores, every correlation call of one more step held
           to its plain version (fit's rule); ms per step beside the
           prefetching loader's next() wait
  serve_flow, serve_stereo, serve_seg_aspp  entry(variant="flow" |
           "stereo" | "seg", seg_head="aspp"), bf16, 512x1024, 3 requests:
           5 K1 (K4) launches a request, none for SegNet, the kernels
           against the plain correlations by serve's rule, ms per frame in
           turns, peak memory
  flow_data  writes Sintel (436x1024, 2 scenes of 4 frames, invalid
           masks), FlyingChairs (384x512 .ppm, 8 ids, a split file flagging
           2 val) and FlyingThings3D (540x960, one sequence of 11 frames,
           .pfm flow and disparity with inf, NaN, >= 1000 and non-positive
           values) from a seed, reads each training split back through the
           port's datasets and holds every sample to the values the writer
           keeps (the bad ground truth masked and zeroed); ms per sample
  train_flyingthings3d  configs/cerberus_synthetic.json on the
           FlyingThings3D fixture at 384x768 with loss.photometric_weight
           and smoothness_weight 0.1, as train runs it: 5 launches of each
           of the six kernels a step, every master the losses reach moved
           (the segmentation head's gradients zero: the set has no labels),
           the gradients and correlation taps against the float32
           yardstick, a zeroed control, one more step's correlation calls
           held to their plain versions, ms per step
  train_losses  rmi_loss, photometric_loss and smoothness_loss on the card
           against the CPU in float32 at 512x1024, batch 2, 19 classes
           (values within 1e-4, gradients within 1e-3 relative L2), ms of
           each forward and backward; 2 bf16 steps of CerberusNet with
           the three weights set (the seven loss components finite, 5
           launches of each kernel a step, every master moved) and ms per
           step beside steps without them
  eval_tta  Trainer.evaluate_tta of CerberusNet (bf16, 512x1024, batch 1,
           2 synthetic samples) at scales 0.75, 1, 1.25 with flip: 30
           launches of each forward kernel a frame, 19 per-class IoUs; one
           frame's TTA with the kernels against the plain correlations in
           bf16 and float32 by serve's rule, its 60 correlation calls held
           to their plain versions; ms per TTA frame in turns with the
           plain path beside one forward; at 384x1280 the 0.75 scale raises
           the reference's ValueError
  tiled    CerberusNet over a 1024x2048 frame in 3 x 3 tiles of 512x1024
           (overlap 0.25), one tile at a time and all 9 in one batch: 45
           and 5 launches of each forward kernel, every correlation call
           held to its plain version, the two blends within the plain bf16
           blend's distance from float32 of each other (serve's rule), ms
           per frame and peak memory of each
  predict  Trainer.predict_to_dir of configs/dcv_flow_kitti.json on the
           KITTI fixture (4 dilated K1 launches a batch, the flow files at
           the native 375x1242) and of configs/seg_cityscapes.json on the
           Cityscapes fixture (labelIds at 1024x2048): every file decoded
           and held to the same prediction made on the CPU in float32 with
           the plain path (flow: within 1.5 x the card's plain bf16 path's
           distance + 1e-3 + one code; labelIds differing on at most 1e-3
           of the pixels); Trainer.predict_images of CerberusNet on three
           PNGs (the npz, the benchmark PNGs and the panel)
  cli      python -m cerberusnet_torch.cli --device cuda in five processes
           at once, started at nice 19 right after data and running beside
           the phases up to cli:
           --import-torch of a TorchCerberus checkpoint (tiny widths) with
           --infer on three PNGs (the printed files, the npz against this
           process's forward of the same weights within 1e-3),
           --profile (the trace holds the correlation kernels), and
           --export-dir alone, with --quant int8 and with --export-stacked
           (model.pt2 and manifest.json written, the inputs' shapes; the
           float artifact called here against a trainer's forward of the
           same config within 1e-5)
  export   CerberusNet (default widths, bf16, 512x1024, batch 1) through
           torch.export (cerberusnet_torch.export), saved and loaded back:
           one call of the loaded program launches K1 and K4 5 times each
           and its graph holds as many operators; its heads against the
           eager forward (bit-equal reported, within 1e-2 held) and by the
           plain bf16 rule against the float32 plain path; the same
           artifact in a fresh process that imports only torch and the
           operators (ops/library.py), beside the other exports; the
           stacked artifact (one (3, 512, 1024, 3) input) against the
           separate-frame one; the
           pallas_levels=3 artifact (3 K9 launches a call) and
           CerberusDCV's (4 K7 and 3 K8); each manifest's signature;
           export and load seconds, ms per frame loaded against eager
  quant_int8  the same CerberusNet calibrated on 2 batches, quantized from
           its float32 weights with strip: the int8 heads against
           simulate=True within 1e-2 (a control with one conv's scale_w
           doubled must break it), against float32 beside the reference's
           limits, 5 + 5 correlation launches a frame, the im2col bytes of
           each int8 conv, ms per frame and peak memory against bf16 in
           turns, and the int8 artifact against quantized_apply
  train_qat  5 steps of configs/cerberus_synthetic.json with train.qat as
           train runs its steps (launches, masters moved, gradients and
           correlation taps against the float32 yardstick with the same
           ranges, zeroed controls), ms per step beside the float step;
           then Trainer.export(quant="int8") (qat.finalize) against
           quantized_apply
  debug_nans  train.debug_nans: a step on a batch with one NaN pixel
           raises FloatingPointError naming an operator and moves no
           master, the clean step runs, an inf pixel through the stem
           block does not raise; ms per step with the mode and without
  train_dp  CerberusNet's step through data parallelism
           (cerberusnet_torch/parallel/mesh.py; default widths, bf16 over
           float32 masters, 512x1024, configs/cerberus_synthetic.json):
           (a) one NCCL rank (this process in a one-rank group) against one
           process at batch 2, both under deterministic algorithms, each
           loss component and module gradient within 1e-6 relative; (b)
           two gloo ranks sharing the card at a global batch of 4 against
           one process at 4: the loss components within 1e-3, every
           module's gradient by train's rule against the float32 plain
           path, the float32 DP path's within 1e-4 of it and its masters
           after one AdamW step within 1e-4 of the single process's (the
           ranks' bit-equal), each rank's own gradient before the
           all-reduce failing train's rule (the control), every K1-K6 call
           of a rank held to its plain version, 5 launches of each a rank,
           the all-reduce's bytes and ms; (c) the same with two NCCL ranks
           on two cards where there are two (else a line says why not);
           (d) configs/cerberus_dp_v4_8.json through the CLI raising the
           card-count ValueError on one card, then through the launcher on
           2 gloo ranks sharing the card, cut (global batch 4, 8 samples, 1
           epoch): one checkpoint and one train_log.csv row, rank 0's, the
           ranks' masters equal, ms per step (gloo stages through the
           host: not a multi-card time); ``--only train_dp_cards`` runs
           (c) and its references alone, for a machine with several cards;
           (a) to (d) in spawned ranks (parallel.launch); (b) and (d) in
           one spawn of two ranks with train_spatial's (a) and (d), which
           starts before the references are computed and waits for its
           jobs; (a) beside train_spatial's (c) after it
  train_spatial  image rows split over ranks (train.num_spatial_devices,
           cerberusnet_torch/parallel/halo.py), batch 2, each rank against
           one process on the card: (a) 2 gloo ranks sharing the card, 256
           rows of 512x1024 each, train CerberusNet
           (configs/cerberus_synthetic.json), CerberusDCV
           (configs/cerberus_dcv.json) and CerberusRAFT
           (configs/cerberus_raft.json, level 3, 12 iterations) in turn:
           one float32 step's correlation taps (RAFT: its volume's f1 and
           the gathered f2) against one process's band within 3e-3, its
           all-reduced gradients against one process's, each module (the
           names' first three parts) within 1e-4 (DCV, RAFT) or 1e-3,
           and the masters after it within 1e-5, controls whose taps and gradients must miss (the
           halos' gradient all-reduces zeroed, K3 zeroed, RAFT's gather
           reduce dropped), two bf16 steps by train's rule against the
           float32 plain path, every K1-K8 call held to its plain version,
           the launches a step, halo exchanges and bytes, a rank's peak and
           ms per step beside one process's; (b) the same on NCCL ranks a
           card each where there are two cards (``--only
           train_spatial_cards`` runs it alone); (c) 4 gloo ranks on
           unequal bands (128/128/64/64 rows) of DCVFlowNet at
           configs/dcv_flow_kitti.json's 384x1248, synthetic data: taps,
           gradients and masters of one float32 step as in (a), the
           halos' send-back control; (d) as (a) for CerberusDCV and
           CerberusRAFT at 368x768 (RAFT's Sintel crop, an H that is no
           multiple of 64: bands of 176/192 rows, level 4 split 11/12), the
           send-back control (DCV) and the gather-reduce control (RAFT);
           (a) and (d) in one spawn with train_dp's (b) and (d); on the
           ranks of (a) and (d) and of (c), bf16 band resizes between the
           frames' level extents (every x2 in the resize and phase forms,
           every x4, the off-grid ratios) bit-equal to the whole frame's
           resize cut to the band
  runner   the C++ runner of the exported program: cerberus_runner and
           libcerberus_ops built with g++ (their seconds; ldd shows no
           libpython); the export phase's four artifacts and quant_int8's
           int8 one (exported here when they did not run) compiled with
           AOTInductor (deterministic mode) in two processes at nice 19,
           the float ones one after the other and int8's alone (package
           seconds each),
           loaded into this process (a call launches what
           the export phase's does on the Python counters) and run by the
           runner on seeded inputs (--inputs, --dump-outputs): the launches
           on the operator library's own counters whole calls of the same,
           the outputs held bit-equal to the Python-loaded package's;
           each artifact's outputs by the plain bf16 rule against the
           float32 eager forward (CerberusNet's for pallas_levels); ms per
           frame of the runner, the Python-loaded package and eager in
           turns; --serve (3 INFER and 1 PNGS requests to one process, each
           bit-equal to the Python path, wall ms each, QUIT exits 0);
           --pngs on seeded 512x1024 PNGs, separate and stacked, bit-equal
           to data/io decode, preprocess_image and the package in Python,
           and stacked against separate within 1e-2 (two packages compiled
           apart; bit equality reported); refusals: the CerberusNet
           package without the operator library (naming the operator) and
           a CPU export with --device cuda; the int8 package against
           quantized_apply of the same int8 model (bit equality and
           distances reported: AOTInductor's fused bf16 arithmetic moves
           values by an ulp and the int8 quantization turns some into whole
           steps) and held by the int8 rule: its distance from the float32
           eager forward within 1.5x quantized_apply's + 1e-3; one --serve
           request to it, its ms per frame through the runner and in
           Python in turns with the bf16 package
Then a {"kernels": [...]} summary line (each correlation kernel's numbers
on the train path, where all six run, with the serve and fit paths'
beside them, the data slice's paths (train_flow_kitti,
train_stereo_kitti, fit_dcv_kitti, serve_flow, serve_stereo) and the
evaluation slice's (train_flyingthings3d, train_losses, eval_tta,
tiled_sequential, tiled, predict, predict_images) and the deployment
slice's (a call of each loaded artifact: export_cerberus, export_stacked,
export_pallas_levels; quant_int8's forward; train_qat) and the C++
runner's (a call of each package: runner_cerberus, runner_stacked,
runner_pallas_levels, runner_int8, the launches from the operator
library's counters) and the bench's (bench: every call of its headline's
run)
and train_dp's (the ranks of its part (b), their launches summed) and
train_spatial's (CerberusNet's bands in its part (a))
where the kernel runs, and the DCV paths' under "dcv" (export_cerberus_dcv,
runner_cerberus_dcv, train_spatial, CerberusDCV's bands, and
train_spatial_offgrid, its bands of part (d), among them);
K9's and K10's on train_pallas_levels, K9's serve, export_pallas_levels
and runner_pallas_levels numbers beside them, each with its time over the
cuDNN level's
(vs_plain) per level, and K10's weight-gradient partial bytes per step as
its wrapper counted them in train_pallas_levels), a {"phase":
"card_memory"} line (the card's memory in use by every process on it, the
most after each phase line and in each 10 s, and the least free), a
{"phase": "done"} line with the script's seconds, the card's nvidia-smi line and, last,
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. ``--only a,b,...`` runs env, build and the named phases alone
(the data slice's run after data, and the evaluation slice's after
flow_data where they need its fixtures), with no summary and no result
line. The order: env, build; serve, stream, then bench (timed beside
serve's timing of the same forward, in turns), before any compile shares
the host; export, whose artifacts start the runner's AOTInductor compiles and
g++ builds, which run beside every later phase; kernels; the other
deployment phases but the runner (quant_int8,
whose artifact starts its compile, train_qat, debug_nans); train, the DCV
and pallas_levels phases, fit, then train_dp and train_spatial, whose
pair of ranks runs its jobs beside the RAFT phases, the data slice's and
the evaluation slice's (cli the last of them) in this process; and the
runner last, which waits for the compiles. Each process's allocator holds
a capped share of the card (``MAIN_MEMORY_SHARE``, ``PAIR_MEMORY_SHARE``,
``SIDE_MEMORY_SHARE``), so that none takes the memory the others need.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

HW = (512, 1024)
ENCODER_CHANNELS = (16, 32, 64, 96, 128, 196)
LEVELS = (6, 5, 4, 3, 2)
FLOW_MAX_DISP = 4
MAX_DISP_FULL = 96
# the DCV heads: one level, d = D = 4, the dilations of CerberusDCV
DCV_LEVEL = 3
DCV_MAX_DISP = 4
DCV_FLOW_DILATIONS = (1, 2, 4, 8)
DCV_DISP_DILATIONS = (1, 2, 3)
# the kernels phase's paths on a spatial rank's band (train_spatial)
SPATIAL_PATHS = ("spatial", "spatial_dcv", "spatial_dcv_unequal",
                 "spatial_dcv_offgrid")
# The odd shapes of the correlation kernels, (H, W, C) at batch 1 and 2: a
# row no multiple of a tile, fewer rows than the 2-D window's height, and
# 40-byte pixel rows (8-byte aligned, no multiple of 16) or 42-byte ones
# (odd C, which the tensor-core kernels stage by 2-byte loads); also at
# dilation 3, and the backwards at dilation 25, where a block computes 16
# of the 25 residue classes of columns and stages only theirs.
ODD_CORR_SHAPES = ((3, 37, 20), (3, 37, 21))
ODD_CORR_DILATIONS = {"corr2d_fwd": (1, 3), "corr1d_fwd": (1, 3),
                      "corr2d_bwd_f1": (1, 3, 25),
                      "corr2d_bwd_f2": (1, 3, 25),
                      "corr1d_bwd_f1": (1, 3, 25),
                      "corr1d_bwd_f2": (1, 3, 25)}
# The forwards at level 6's width, (H, W, C) at batch 1 and 2, d = D = 4,
# at dilations where the runs of every residue class of columns would
# exceed a block's shared memory (the 2-D op above 13, the 1-D op above
# 14): a block computes a group of the classes and stages only theirs.
WIDE_CORR_SHAPE = (64, 256, 196)
WIDE_CORR_DILATIONS = {"corr2d_fwd": (14, 25), "corr1d_fwd": (15, 25)}
# The fit phase's frame and batch (configs/cerberus_evidence.json, which
# phase_fit checks): its five levels run from (B, 32, 64, 32) down to
# (B, 2, 4, 196); the forwards also at batch 1 (the panel).
FIT_HW = (128, 256)
FIT_BATCH = 4
# the hand kernels' sources (cerberusnet_torch/csrc/<name>.cu)
SOURCES = ("correlation", "encoder_level")
N_REQUESTS = 3
TRAIN_STEPS = 5
TRAIN_BATCH = 2
FORWARDS = ("corr2d_fwd", "corr1d_fwd")
# The evaluation slice's shapes: FlyingThings3D's frames (540x960) trained
# at 384x768; TTA's frames of a 512x1024 request at Trainer.evaluate_tta's
# scales 0.75, 1, 1.25; a 1024x2048 frame in 3 x 3 tiles of 512x1024
THINGS_HW = (384, 768)
TTA_FRAMES_HW = ((384, 768), (512, 1024), (640, 1280))
TILE_FRAME, TILE_HW = (1024, 2048), (512, 1024)
TILE_OVERLAP, N_TILES = 0.25, 9
TIMED_RUNS = 30
# the plain versions' timed runs in the kernels phase (cut from 20, then
# from 10 when train_spatial came, for the script's time limit)
PLAIN_RUNS = 5
# f32: only the summation order differs. bf16: both sides sum in f32 and
# round once, so they differ by at most one bf16 ulp (inputs unit-normal).
TOLERANCES = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (2.0**-7, 1e-3)}


# the script's start: each phase line carries its seconds since then
STARTED = time.perf_counter()


def emit(obj):
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - STARTED}
        CARD_MEMORY["after"] = obj["phase"]
    print(json.dumps(obj), flush=True)


# The card's memory in use, by every process on it (this one, the ranks,
# the background compiles and CLI processes), sampled by a thread every
# CARD_MEMORY_EVERY_S: the most in use after each phase line (the phase
# whose line came last) and in each 10 s, and the least free at any
# sample
CARD_MEMORY = {"after": "start", "used_gib": {}, "least_free_gib": None,
               "least_free_after": None, "samples": 0, "by_10_s": []}
CARD_MEMORY_EVERY_S = 0.5


def watch_card_memory(stop):
    """Samples the card's free and total memory into CARD_MEMORY until
    ``stop`` (a threading.Event) is set."""
    while not stop.wait(CARD_MEMORY_EVERY_S):
        free, total = torch.cuda.mem_get_info(0)
        used, after = (total - free) / 2**30, CARD_MEMORY["after"]
        by_phase = CARD_MEMORY["used_gib"]
        by_phase[after] = max(by_phase.get(after, 0.0), used)
        least = CARD_MEMORY["least_free_gib"]
        if least is None or free / 2**30 < least:
            CARD_MEMORY.update(least_free_gib=free / 2**30,
                               least_free_after=after)
        CARD_MEMORY["samples"] += 1
        # the most in use in each 10 s since the script's start
        tens = CARD_MEMORY["by_10_s"]
        i = int((time.perf_counter() - STARTED) // 10)
        tens.extend([0.0] * (i + 1 - len(tens)))
        tens[i] = max(tens[i], round(used, 2))


def fail(phase, msg):
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


def sleep_cycles_per_ms():
    """Calibrates torch.cuda._sleep, a spin kernel, in cycles per ms."""
    rate = 0.0
    for _ in range(2):  # the first call warms up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        rate = 10_000_000 / start.elapsed_time(end)
    return rate


def cuda_times(fn, runs=TIMED_RUNS, warmup=5, spin_rate=None):
    """Per-run CUDA-event times in ms after warmup: median, min, max.

    Without ``spin_rate`` the events bracket one eager call as a caller
    sees it, host gaps included. With it, a spin kernel twice as long as
    the host's enqueue of ``fn`` runs first, so the events bracket the
    device work of ``fn`` alone, back to back; that holds while ``fn``
    launches fewer kernels than the launch queue holds (about a thousand),
    so it is used for single ops, not for the whole forward."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 0
    if spin_rate:
        t0 = time.perf_counter()
        fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        cycles = int(spin_rate * (2 * enqueue_ms + 0.05))
    pairs = []
    for _ in range(runs):
        if cycles:
            torch.cuda._sleep(cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in pairs]
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms),
            "runs": runs}


def level_max_disp(level):
    return max(MAX_DISP_FULL // 2**level, 4)


def phase_env():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "env", "ok": True, "nvidia_smi": card, "device": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return card, name


def kernel_name(mangled):
    """"tc_bwd_kernel<32,64,8,16,1>", "level_fwd_kernel<float>" from a
    mangled kernel name."""
    # a mangled name is <length><name>: try each length a digit run ends in
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):
            n = int(m.group()[i:])
            name = mangled[m.end():m.end() + n]
            if name.endswith("_kernel") and name.isidentifier():
                rest = mangled[m.end() + n:]
                tpl = rest[1:rest.find("Ev")] if rest.startswith("I") else ""
                ints = re.findall(r"Li(\d+)E", tpl)
                args = (",".join(ints) if ints else "bf16"
                        if "bfloat16" in tpl else "float"
                        if tpl.startswith("f") else "")
                return f"{name}<{args}>" if args else name
    return mangled


def ptxas_report(log):
    """{kernel: {"registers", "spill_stores", "spill_loads", "stack"}} from
    nvcc's -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def phase_build():
    from cerberusnet_torch.ops import build
    from cerberusnet_torch.ops.cuda import encoder_level as cl

    t0 = time.perf_counter()
    # one nvcc for each source, all started together
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        nvcc_seconds = dict(zip(SOURCES, pool.map(build.build, SOURCES)))
    for name in SOURCES:
        build.load(name)
    lib = cl._library()
    # the tensor-core level kernels: tiles and halo factors (the table's),
    # dynamic shared memory per block and the blocks an SM keeps (the
    # card's); the reverse sweep's schedule assumes the table's blocks
    tc_levels, errors = {}, []
    for (c, f), (_, _, per_sm) in cl.TC_LEVELS.items():
        resident = {k: lib.encoder_level_tc_blocks_per_sm(c, f, bwd)
                    for k, bwd in (("fwd", 0), ("bwd", 1))}
        if resident["bwd"] < per_sm:
            errors.append(f"({c}, {f}): {resident['bwd']} reverse-sweep "
                          f"blocks fit an SM, the schedule takes {per_sm}")
        tc_levels[f"{c},{f}"] = {
            **halo_factors(c, f), "bwd_blocks_per_sm": per_sm,
            "weight_grads_in_registers": (c, f) in cl.TC_KEPT,
            "shared_bytes": {"fwd": lib.encoder_level_tc_smem(c, f, 0),
                             "bwd": lib.encoder_level_tc_smem(c, f, 1)},
            "resident_blocks_per_sm": resident}
    emit({"phase": "build", "ok": not errors, "nvcc": build.find_nvcc(),
          "seconds": time.perf_counter() - t0, "nvcc_seconds": nvcc_seconds,
          "libraries": [build.library_path(n).name for n in SOURCES],
          "ptxas": {n: ptxas_report(build.build_log(n)) for n in SOURCES},
          "tc_levels": tc_levels, "errors": errors})
    if errors:
        sys.exit(1)


def phase_kernels(peaks, spin_rate):
    from cerberusnet_torch.ops import correlation as corr
    from cerberusnet_torch.ops.cuda import correlation as cc
    from cerberusnet_torch.utils.flops import corr1d_flops, corr2d_flops

    def nk2d(d):
        return (2 * d + 1) ** 2

    def nk1d(d):
        return d + 1

    def flow_disp(level):
        return FLOW_MAX_DISP

    def level_shape(batch, level, hw=HW):
        return (batch, hw[0] >> level, hw[1] >> level,
                ENCODER_CHANNELS[level - 1])

    # name: (wrapper, plain version, max_disp of a level, cost-volume
    # channels, FLOPs, batches, is a backward, the dilations of the DCV
    # head that calls it). A forward takes (f1, f2) and writes the cost
    # volume; a backward takes (g, f), g the cost volume's gradient, and
    # writes one feature map's gradient. Both read and write the same
    # tensors' worth of bytes, and a backward does the forward's in-frame
    # multiply-adds. The forwards run at batch 1 when served and at the
    # train batch in a train step; the backwards only in a train step.
    both = (1, TRAIN_BATCH)
    train = (TRAIN_BATCH,)
    flow_dils, disp_dils = DCV_FLOW_DILATIONS, DCV_DISP_DILATIONS
    kernels = {
        "corr2d_fwd": (cc.corr2d_fwd, corr._correlation2d_plain, flow_disp,
                       nk2d, corr2d_flops, both, False, flow_dils),
        "corr1d_fwd": (cc.corr1d_fwd, corr._correlation1d_plain,
                       level_max_disp, nk1d, corr1d_flops, both, False,
                       disp_dils),
        "corr2d_bwd_f1": (cc.corr2d_bwd_f1, corr._correlation2d_bwd_f1_plain,
                          flow_disp, nk2d, corr2d_flops, train, True,
                          flow_dils),
        "corr2d_bwd_f2": (cc.corr2d_bwd_f2, corr._correlation2d_bwd_f2_plain,
                          flow_disp, nk2d, corr2d_flops, train, True,
                          flow_dils),
        "corr1d_bwd_f1": (cc.corr1d_bwd_f1, corr._correlation1d_bwd_f1_plain,
                          level_max_disp, nk1d, corr1d_flops, train, True,
                          disp_dils),
        "corr1d_bwd_f2": (cc.corr1d_bwd_f2, corr._correlation1d_bwd_f2_plain,
                          level_max_disp, nk1d, corr1d_flops, train, True,
                          disp_dils),
    }
    # the least time for the work: bf16 products at the tensor cores' bf16
    # peak, float32 at the CUDA cores' (as the level checks count them)
    peak_bw = peaks["bytes"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    odd_gen = torch.Generator(device="cuda").manual_seed(1)
    wide_gen = torch.Generator(device="cuda").manual_seed(2)
    fit_gen = torch.Generator(device="cuda").manual_seed(3)
    kitti_gen = torch.Generator(device="cuda").manual_seed(4)
    eval_gen = torch.Generator(device="cuda").manual_seed(5)
    sp_gen = torch.Generator(device="cuda").manual_seed(6)
    offgrid_gen = torch.Generator(device="cuda").manual_seed(7)
    stream_gen = torch.Generator(device="cuda").manual_seed(8)
    checks = []
    dtypes = (torch.bfloat16, torch.float32)
    for name, (kernel, plain, disp_of, nk_of, flops_of, batches,
               backward, dcv_dilations) in kernels.items():
        # (path, batch, level, dtype, dilation, max_disp, shape):
        # CerberusNet's levels, one dilation-2 case, the DCV head's calls,
        # the odd shapes, for the forwards the wide ones (level 0), and
        # the levels of fit's frame
        cases = [("cerberus", batch, level, dt, 1, disp_of(level),
                  level_shape(batch, level))
                 for batch in batches for level in LEVELS for dt in dtypes]
        cases.append(("extra", TRAIN_BATCH, 2, torch.bfloat16, 2, disp_of(2),
                      level_shape(TRAIN_BATCH, 2)))
        cases += [("dcv", batch, DCV_LEVEL, dt, dil, DCV_MAX_DISP,
                   level_shape(batch, DCV_LEVEL))
                  for batch in batches for dil in dcv_dilations
                  for dt in dtypes]
        cases += [("odd", batch, 0, dt, dil, 4, (batch, *odd))
                  for batch in both for odd in ODD_CORR_SHAPES
                  for dil in ODD_CORR_DILATIONS[name] for dt in dtypes]
        cases += [("wide", batch, 0, dt, dil, 4, (batch, *WIDE_CORR_SHAPE))
                  for batch in both
                  for dil in WIDE_CORR_DILATIONS.get(name, ())
                  for dt in dtypes]
        cases += [("fit", batch, level, dt, 1, disp_of(level),
                   level_shape(batch, level, FIT_HW))
                  for batch in ((FIT_BATCH,) if backward else (1, FIT_BATCH))
                  for level in LEVELS for dt in dtypes]
        # the KITTI paths: FlowNet's and StereoNet's levels at 384x1280,
        # batch 2; DCVFlowNet's level 3 of 384x1248 at batch 4
        cases += [("kitti", TRAIN_BATCH, level, dt, 1, disp_of(level),
                   level_shape(TRAIN_BATCH, level, KITTI_HW))
                  for level in LEVELS for dt in dtypes]
        if name.startswith("corr2d"):
            cases += [("dcv_kitti", DCV_KITTI_BATCH, DCV_LEVEL, dt, dil,
                       DCV_MAX_DISP, level_shape(DCV_KITTI_BATCH, DCV_LEVEL,
                                                 DCV_KITTI_HW))
                      for dil in flow_dils for dt in dtypes]
        # the evaluation slice's paths, in bf16 as they run: FlyingThings3D
        # steps at 384x768, batch 2 (all six); the forwards at TTA's three
        # frames of a 512x1024 request, batch 1, and at the 3x3 tiles of a
        # 1024x2048 frame in one batch
        cases += [("things", TRAIN_BATCH, level, torch.bfloat16, 1,
                   disp_of(level), level_shape(TRAIN_BATCH, level, THINGS_HW))
                  for level in LEVELS]
        # the spatial axis's bands (train_spatial: SP_RANKS bands of the
        # train path's frame), bf16 as they run: the 2-D kernels on the
        # band with max_disp rows of halo each side, the 1-D on the band
        cases += [("spatial", TRAIN_BATCH, level, torch.bfloat16, 1,
                   disp_of(level), sp_band_shape(name, level))
                  for level in LEVELS]
        # the DCV decoders' calls on a band, bf16 as they run: level 3 of
        # 512x1024 on SP_RANKS ranks (train_spatial (a)), and the 2-D ones
        # also on the 8-row band of 384x1248's level 3 on SP_UNEQUAL_RANKS
        # ranks (part (c)), the 2-D kernels haloed by their reach
        lv3 = (HW[0] >> DCV_LEVEL, HW[1] >> DCV_LEVEL)
        cases += [("spatial_dcv", TRAIN_BATCH, DCV_LEVEL, torch.bfloat16,
                   dil, DCV_MAX_DISP,
                   sp_dcv_band_shape(name, dil, lv3[0] // SP_RANKS, lv3[1]))
                  for dil in dcv_dilations]
        if name.startswith("corr2d"):
            cases += [("spatial_dcv_unequal", TRAIN_BATCH, DCV_LEVEL,
                       torch.bfloat16, dil, DCV_MAX_DISP,
                       sp_dcv_band_shape(name, dil, 8,
                                         DCV_KITTI_HW[1] >> DCV_LEVEL))
                      for dil in dcv_dilations]
        # and part (d)'s: rank 0's band of level 3 of 368x768 (22 of its
        # 46 rows), every DCV kernel
        cases += [("spatial_dcv_offgrid", TRAIN_BATCH, DCV_LEVEL,
                   torch.bfloat16, dil, DCV_MAX_DISP,
                   sp_dcv_band_shape(name, dil, SP_OFFGRID_DCV_ROWS,
                                     SP_OFFGRID_HW[1] >> DCV_LEVEL))
                  for dil in dcv_dilations]
        if not backward:
            cases += [("tta", 1, level, torch.bfloat16, 1, disp_of(level),
                       level_shape(1, level, hw))
                      for hw in TTA_FRAMES_HW for level in LEVELS]
            # the stream's fast model: its narrower encoder's levels, as
            # served (its cerberus and dcv models run serve's shapes)
            cases += [("fast", 1, level, torch.bfloat16, 1, disp_of(level),
                       (1, HW[0] >> level, HW[1] >> level,
                        STREAM_FAST_ENCODER[level - 1]))
                      for level in LEVELS]
            cases += [("tiles", N_TILES, level, torch.bfloat16, 1,
                       disp_of(level), level_shape(N_TILES, level, TILE_HW))
                      for level in LEVELS]
        for path, batch, level, dt, dil, d, shape in cases:
            nk = nk_of(d)
            # bf16 kernels must run on the tensor cores, float32 on the
            # CUDA cores; the library counts which design it launched
            want_design = "tc" if dt == torch.bfloat16 else "cuda_cores"
            a_shape = (*shape[:3], nk) if backward else shape
            # the odd, wide and fit shapes draw from their own generators,
            # so every other check keeps the inputs it had before they were
            # added
            g_ = {"odd": odd_gen, "wide": wide_gen, "fit": fit_gen,
                  "kitti": kitti_gen, "dcv_kitti": kitti_gen,
                  "things": eval_gen, "tta": eval_gen,
                  "tiles": eval_gen, "spatial_dcv": sp_gen,
                  "spatial_dcv_unequal": sp_gen,
                  "spatial_dcv_offgrid": offgrid_gen,
                  "fast": stream_gen}.get(path, gen)
            a = torch.randn(a_shape, generator=g_, device="cuda").to(dt)
            f = torch.randn(shape, generator=g_, device="cuda").to(dt)
            cc.reset_design_launches()
            got = kernel(a, f, d, dil)
            design = cc.launched_design()
            torch.cuda.synchronize()
            want = plain(a, f, d, dil)
            rtol, atol = TOLERANCES[dt]
            diff = (got.float() - want.float()).abs()
            ok = bool((diff <= atol + rtol * want.float().abs()).all())
            ok = ok and design == want_design

            def run_kernel():
                kernel(a, f, d, dil)

            def run_plain():
                plain(a, f, d, dil)

            k_t = cuda_times(run_kernel, spin_rate=spin_rate)
            k_eager = cuda_times(run_kernel)
            p_t = cuda_times(run_plain, runs=PLAIN_RUNS, warmup=2,
                             spin_rate=spin_rate)
            p_eager = cuda_times(run_plain, runs=PLAIN_RUNS, warmup=2)
            b, h, w, c = shape
            # a band's 2-D call runs on f1 zero-padded and f2 haloed by the
            # reach, and writes every padded row: the work the band needs is
            # f1 and the output at its own rows, f2 with its halo
            reach = (d * dil if path in SPATIAL_PATHS
                     and name.startswith("corr2d") else 0)
            peak_flops = peaks["bf16" if dt == torch.bfloat16 else "f32"]
            bounds = []
            for hb in dict.fromkeys((h, h - 2 * reach)):
                nbytes = ((b * hb * w * c + b * h * w * c + b * hb * w * nk)
                          * f.element_size())
                flops = flops_of(b, hb, w, c, d, dil)
                bounds.append({
                    "bytes": nbytes, "flops": flops,
                    "bound_ms": max(nbytes / peak_bw,
                                    flops / peak_flops) * 1e3,
                    "bound_by": "bytes" if nbytes / peak_bw
                    >= flops / peak_flops else "operations"})
            padded = {f"padded_{k}": v for k, v in bounds[0].items()
                      } if reach else {}
            checks.append({
                "kernel": name, "path": path, "batch": batch, "level": level,
                "shape": list(shape),
                "max_disp": d, "dilation": dil, "dtype": str(dt)[6:],
                "design": design,
                "ok": ok, "max_abs_err": diff.max().item(),
                "rtol": rtol, "atol": atol, "ms": k_t["median"],
                "ms_min": k_t["min"], "ms_max": k_t["max"],
                "plain_ms": p_t["median"], "plain_ms_min": p_t["min"],
                "plain_ms_max": p_t["max"], "eager_ms": k_eager["median"],
                "eager_ms_min": k_eager["min"], "eager_ms_max": k_eager["max"],
                "plain_eager_ms": p_eager["median"], **bounds[-1], **padded,
            })
    checks += level_checks(peaks, spin_rate, gen)
    ok = all(c["ok"] for c in checks)
    emit({"phase": "kernels", "ok": ok, "runs": TIMED_RUNS,
          "timing": "ms: device time of one call (a spin kernel hides the "
                    "host's enqueue); eager_ms: one call as a caller sees it",
          "peak_bytes_per_s": peak_bw, "peak_f32_flops_per_s": peaks["f32"],
          "peak_bf16_flops_per_s": peaks["bf16"], "checks": checks})
    if not ok:
        sys.exit(1)
    return checks


# The fused encoder levels at 512x1024 with pallas_levels=3: (level, H, W,
# C, F) of each level's input; a request runs them at batch 3 (the three
# frames in one batch), a train step at batch 6.
ENCODER_LEVELS = ((1, 512, 1024, 3, 16), (2, 256, 512, 16, 32),
                  (3, 128, 256, 32, 64))
PALLAS_LEVELS = len(ENCODER_LEVELS)
SERVE_FRAMES = 3
TRAIN_FRAMES = 3 * TRAIN_BATCH
LEVEL_RUNS = 10
# K9 against its plain version: bf16, the kernel's rel L2 distance to the
# float32 plain level on the same (bf16) inputs within 1.5x the plain bf16
# level's distance + 1e-3 (the bf16 plain rule); float32 within 1e-5
# (measured <= 1.6e-6 on an H100, summation order only). K10 in bf16 at
# the level shapes and the odd shapes past level 1 by the bf16 plain rule
# too. K10 in float32, and in bf16 at the two level-1 odd shapes
# (level_witness.BF16_SHAPES, where it failed that rule on other inputs),
# against the float64 plain level (the witness): each gradient's rel L2
# distance to it within the limit of
# cerberusnet_torch.level_witness.k10_limits: the plain
# level's own distance in the type (float32: with float64's masks, its
# rounding) times 1.5, plus what LeakyReLU mask flips alone can move that
# gradient in the type (every pre-activation within the type's rounding
# of 0 flipped), plus 1e-6 (float32) or 1e-3 (bf16). A mask flips where two
# correct computations round a pre-activation to either side of 0, and
# moves that pixel's gradient by 0.9 of it; float32's fixed 2e-3 against
# the float32 plain level failed on other inputs for that reason (C5).
LEVEL_F32_FWD_RTOL = 1e-5
LEVEL_GRADS = ("dx", "dk1", "db1", "dk2", "db2", "dk3", "db3")
# train_pallas_levels in float32: every module's, fused block's, level
# input's and correlation input's gradient of the fused path within this
# rel L2 of the plain path's, the median over the batches. Measured on an
# H100: most single batches read 1e-6 to 1e-3 (K10's mask flips, as in the
# level checks, reach the level inputs), a few up to 2.4e-3; medians
# <= 7.6e-4.
FUSED_F32_RTOL = 3e-3


def level_fwd_rounded_once(x, k1, b1, k2, b2, k3, b3):
    """K9's plain version with K9's rounding: each convolution of the level
    on cuDNN in float32 from working-type operands, its bias and LeakyReLU
    in float32, then rounded once to the working type, as K9 rounds y1, y2
    and y3. (The plain level rounds each convolution's output and then the
    LeakyReLU's.) A stand-in for the wrapper ``level_fwd``."""
    from cerberusnet_torch.ops import encoder_level as elv

    y = x.permute(0, 3, 1, 2)
    for stride, k, b in ((2, k1, b1), (1, k2, b2), (1, k3, b3)):
        y = elv._conv_block(y.float(), k.float(), b.float(), stride)
        y = y.to(x.dtype)
    return y.permute(0, 2, 3, 1).contiguous()


# Odd shapes, (label, H, W, C, F) at batch 1: output extents that are no
# multiple of any tile or of 64 rows, so every border case runs. The first
# is level 1's input cut short with F = 8, which no tensor-core kernel takes
# (the CUDA cores run it in bf16 too); the others run the tensor-core tiles
# at each level's widths.
ODD_LEVELS = ((0, 72, 16, 3, 8), (0, 72, 16, 3, 16), (0, 70, 100, 16, 32),
              (0, 74, 92, 32, 64))


def halo_factors(c, f):
    """The tensor-core tiles of (c, f) and the pixels a tile computes of y1
    and y2 over the pixels it owns, for a tile inside the image: the
    forward's and the reverse sweep's (arithmetic on the tiles)."""
    from cerberusnet_torch.ops.cuda import encoder_level as cl

    (fh, fw), (bh, bw), _ = cl.TC_LEVELS[(c, f)]
    return {"fwd_tile": [fh, fw], "bwd_tile": [bh, bw],
            "fwd_y1": (fh + 4) * (fw + 4) / (fh * fw),
            "fwd_y2": (fh + 2) * (fw + 2) / (fh * fw),
            "bwd_y1": (bh + 5) * (bw + 5) / (bh * bw),
            "bwd_y2": (bh + 3) * (bw + 3) / (bh * bw)}


def level_checks(peaks, spin_rate, gen):
    """K9 (encoder_level_fwd) at the three level shapes at batch 3 (served)
    and 6 (trained), and the odd shapes, and K10 (encoder_level_bwd) at the
    level shapes at batch 6 and the odd shapes, in bf16 and float32, against
    encoder_level_plain (K9) and the float64 encoder_level_bwd_plain (K10,
    the witness; see LEVEL_F32_FWD_RTOL), with CUDA-event times (kernel and
    plain level in turns) and bounds; K10 runs twice and must give
    bit-identical dk and db, and reports the partial bytes its wrapper
    counted in the first run; at the tensor-core widths the forward's
    weights as the library packs them on the device must equal pack_b's
    bit for bit."""
    from cerberusnet_torch import level_witness as lw
    from cerberusnet_torch.ops import encoder_level as elv
    from cerberusnet_torch.utils.flops import level_bwd_flops, level_flops
    from cerberusnet_torch.ops.cuda import encoder_level as cl

    cases = [("fwd", batch, lv) for batch in (SERVE_FRAMES, TRAIN_FRAMES)
             for lv in ENCODER_LEVELS]
    cases += [("bwd", TRAIN_FRAMES, lv) for lv in ENCODER_LEVELS]
    cases += [(kind, 1, odd) for odd in ODD_LEVELS for kind in ("fwd", "bwd")]
    checks = []
    for kind, b, (level, h, w, c, f) in cases:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn((b, h, w, c), generator=gen, device="cuda")
            params = []
            for cin in (c, f, f):
                params.append(torch.randn((3, 3, cin, f), generator=gen,
                                          device="cuda") / (9 * cin) ** 0.5)
                params.append(0.1 * torch.randn((f,), generator=gen,
                                                device="cuda"))
            x, params = x.to(dt), [p.to(dt) for p in params]
            y3 = cl.level_fwd(x, *params)
            g = torch.randn(y3.shape, generator=gen, device="cuda").to(dt)
            x32, p32 = x.float(), [p.float() for p in params]
            if kind == "fwd":
                def run_kernel():
                    return cl.level_fwd(x, *params)

                def run_plain():
                    return elv.encoder_level_plain(x, *params)

                def run_ref():
                    return elv.encoder_level_plain(x32, *p32)
            else:
                def run_kernel():
                    return cl.level_bwd(x, y3, g, *params)

                def run_plain():
                    return elv.encoder_level_bwd_plain(x, y3, g, *params)

                def run_ref():
                    return elv.encoder_level_bwd_plain(x32, None, g.float(),
                                                       *p32)
            outs = {"fwd": ("y3",), "bwd": LEVEL_GRADS}[kind]
            counted = cl.encoder_level_bwd_partial_bytes
            got = run_kernel()
            counted = cl.encoder_level_bwd_partial_bytes - counted
            got, plain, ref = (
                [v] if kind == "fwd" else list(v)
                for v in (got, run_plain(), run_ref()))
            torch.cuda.synchronize()
            dist, limits, witness = {}, {}, {}
            if kind == "fwd":
                for name, k_, p_, r_ in zip(outs, got, plain, ref):
                    dist[name] = rel_l2(k_, r_.float())
                    limits[name] = (LEVEL_F32_FWD_RTOL if dt == torch.float32
                                    else 1.5 * rel_l2(p_, r_.float()) + 1e-3)
            else:
                ref64 = lw.witness(x, g, params)
                to_f64 = lw.distances(got, ref64)
                to_f32 = {n: rel_l2(k_, r_.float())
                          for n, k_, r_ in zip(outs, got, ref)}
                if dt == torch.float32 or (b, h, w, c, f) in lw.BF16_SHAPES:
                    rule = "witness"
                    limits, parts = lw.k10_limits(x, g, params, ref64)
                    dist = to_f64
                else:  # the bf16 plain rule, against the float32 plain level
                    rule, parts, dist = "bf16_plain", None, to_f32
                    limits = {n: 1.5 * rel_l2(p_, r_.float()) + 1e-3
                              for n, p_, r_ in zip(outs, plain, ref)}
                witness = {"limit_rule": rule, "rel_l2_to_f64": {
                    "kernel": to_f64, "plain_f32": lw.distances(ref, ref64),
                    **({"plain_bf16": lw.distances(plain, ref64)}
                       if dt == torch.bfloat16 else {})},
                    "limit_parts": parts,
                    "kernel_rel_l2_to_f32_plain": to_f32}
                del ref64
            ok = all(dist[n] <= limits[n] for n in outs)
            tc = cl.uses_tensor_cores(dt, c, f)
            # the forward's weights as the library packs them on the device,
            # bit-equal to pack_b's, which packs the reverse sweep's
            packed_equal = None
            if kind == "fwd" and tc:
                want = cl.tc_operands(params[0], params[2], params[4])
                packed_equal = torch.equal(
                    cl.tc_fwd_device_operands(params[0], params[2],
                                              params[4]),
                    torch.cat([want[n].flatten() for n in ("k1", "k2",
                                                           "k3")]))
                ok = ok and packed_equal
                del want
            # dk, db of a second run: the same bits, whatever order the
            # blocks ran in
            same = None
            if kind == "bwd":
                again = run_kernel()
                same = all(torch.equal(a, b_) for a, b_ in
                           zip(got[1:], again[1:]))
                ok = ok and same
                del again
            max_abs = max((k_.float() - p_.float()).abs().max().item()
                          for k_, p_ in zip(got, plain))
            # in turns on one card: kernel, plain, plain, kernel
            times = {"kernel": [], "plain": []}
            for which in ("kernel", "plain", "plain", "kernel"):
                fn = run_kernel if which == "kernel" else run_plain
                times[which].append(cuda_times(fn, runs=LEVEL_RUNS,
                                               spin_rate=spin_rate))
            k_t, p_t = ({"median": statistics.median(
                            [t["median"] for t in parts]),
                         "min": min(t["min"] for t in parts),
                         "max": max(t["max"] for t in parts)}
                        for parts in (times["kernel"], times["plain"]))
            fwd_flops = level_flops(b, h, w, c, f)[0]
            esize = x.element_size()
            acts = b * (h * w * c + (h // 2) * (w // 2) * f)
            if kind == "fwd":
                nbytes, flops = acts * esize, fwd_flops
            else:
                # x, y3, g in, dx out; recompute of y1, y2, three input
                # gradients and three weight gradients
                nbytes = 2 * acts * esize
                flops = level_bwd_flops(b, h, w, c, f)
            peak = peaks["bf16" if dt == torch.bfloat16 else "f32"]
            t_bytes, t_ops = nbytes / peaks["bytes"], flops / peak
            del x, params, y3, g, got, plain, ref
            checks.append({
                "kernel": f"encoder_level_{kind}", "path": "levels",
                "batch": b, "level": level, "shape": [b, h, w, c, f],
                "dtype": str(dt)[6:],
                "design": "tensor cores" if tc else "cuda cores",
                "ok": ok, "max_abs_err": max_abs,
                **({"rel_l2_to_f32_plain": dist} if kind == "fwd" else {}),
                **({"packed_bit_equal": packed_equal}
                   if packed_equal is not None else {}),
                "limits": limits, **witness,
                "ms": k_t["median"], "ms_min": k_t["min"],
                "ms_max": k_t["max"], "plain_ms": p_t["median"],
                "plain_ms_min": p_t["min"], "plain_ms_max": p_t["max"],
                "vs_plain": k_t["median"] / p_t["median"],
                "bytes": nbytes, "flops": flops,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                **({"bit_identical": same, "partial_bytes": counted}
                   if kind == "bwd" else {}),
            })
    return checks


def rel_l2(a, ref):
    return ((a.float() - ref).norm() / ref.norm().clamp_min(1e-12)).item()


def launch_counts():
    """{kernel name: launches so far} over every hand kernel."""
    from cerberusnet_torch.ops.cuda import correlation as cc
    from cerberusnet_torch.ops.cuda import encoder_level as cl

    return {**cc.launches(), **cl.launches()}


def reset_launch_counts():
    from cerberusnet_torch.ops.cuda import correlation as cc
    from cerberusnet_torch.ops.cuda import encoder_level as cl

    cc.reset_launches()
    cl.reset_launches()


def launch_rise(fn):
    """(fn's result, {kernel: launches fn made})."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in launch_counts().items()}


# phase: (entry variant, pyramid levels, kernel launches per request, the
# entry's keywords, the path timed beside it: (name, entry keywords))
SERVE = {
    "serve": ("cerberus", LEVELS,
              {"corr2d_fwd": len(LEVELS), "corr1d_fwd": len(LEVELS)}, {},
              ("plain", {"corr_impl": "plain"})),
    "serve_dcv": ("cerberus_dcv", (DCV_LEVEL,),
                  {"corr2d_fwd": len(DCV_FLOW_DILATIONS),
                   "corr1d_fwd": len(DCV_DISP_DILATIONS)}, {},
                  ("plain", {"corr_impl": "plain"})),
    "serve_pallas_levels": (
        "cerberus", LEVELS,
        {"corr2d_fwd": len(LEVELS), "corr1d_fwd": len(LEVELS),
         "encoder_level_fwd": PALLAS_LEVELS},
        {"pallas_levels": PALLAS_LEVELS}, ("pallas_levels_0", {})),
}


# {serve phase: the kernel path's median eager ms per frame}
SERVE_MS = {}
# serve_arithmetic: the fused estimators' float32 heads against the naive
# ones', relative L2 (the two differ by the sums' order alone)
ARITHMETIC_F32_RTOL = 1e-3


def device_launches(fn):
    """The kernels one call of ``fn`` launches on the card (copies and
    fills included), as torch.profiler lists them."""
    from torch.profiler import ProfilerActivity, profile

    from cerberusnet_torch.trace_forward import kernel_table

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(n for n, _ in kernel_table(prof.events()).values())


def serve_arithmetic(requests, fused, fused_f32, limits, fwd_launches):
    """CerberusNet's naive estimators (fused=False) beside the served
    reference default (fused=True), on the same weights and requests."""
    from cerberusnet_torch.entry import entry

    naive, _ = entry(model_kw={"fused": False})
    naive_f32, _ = entry(dtype=torch.float32, corr_impl="plain",
                         model_kw={"fused": False})
    errors = []
    forms = {"fused": fused.model, "naive": naive.model}
    for form, model in forms.items():
        flags = {m.fused for m in model.modules() if hasattr(m, "fused")}
        if flags != {form == "fused"}:
            errors.append(f"the {form} model's estimators: fused {flags}")
    want_rise = {k: fwd_launches.get(k, 0) for k in launch_counts()}
    f32_heads, naive_heads = [], []
    for i, req in enumerate(requests):
        out, rise = launch_rise(lambda: naive(*req))
        if rise != want_rise:
            errors.append(f"naive request {i}: kernel launches rose by "
                          f"{rise}")
        ref, ref_naive = fused_f32(*req), naive_f32(*req)
        for key in ("seg_logits", "flow", "disp"):
            d32 = rel_l2(ref_naive[key], ref[key])
            f32_heads.append({"request": i, "head": key,
                              "naive_vs_fused_f32": d32})
            if not d32 <= ARITHMETIC_F32_RTOL:
                errors.append(f"request {i}: float32 {key} naive against "
                              f"fused {d32} > {ARITHMETIC_F32_RTOL}")
            d = rel_l2(out[key], ref[key])
            limit = limits[i, key]
            naive_heads.append({"request": i, "head": key,
                                "naive_bf16_vs_f32": d, "limit": limit})
            if not d <= limit:
                errors.append(f"request {i}: naive bf16 {key} rel L2 {d} > "
                              f"{limit}")
    req = requests[0]
    with torch.no_grad():
        times = turns({"fused": lambda: fused(*req),
                       "naive": lambda: naive(*req)}, lambda f: f(),
                      runs=20, warmup=3)
        launches = {form: device_launches(lambda f=f: f(*req))
                    for form, f in (("fused", fused), ("naive", naive))}
    return {"f32_naive_vs_fused": f32_heads,
            "f32_bound": ARITHMETIC_F32_RTOL,
            "naive_bf16_vs_f32": naive_heads, "ms_per_frame": times,
            "device_launches_per_forward": launches}, errors


def phase_serve(phase):
    from cerberusnet_torch.entry import entry, make_frames

    variant, levels, fwd_launches, kwargs, (base_name, base_kw) = SERVE[phase]
    torch.cuda.reset_peak_memory_stats()
    forward, _ = entry(variant=variant, **kwargs)
    plain_bf16, _ = entry(variant=variant, corr_impl="plain")
    plain_f32, _ = entry(variant=variant, dtype=torch.float32,
                         corr_impl="plain")
    baseline, _ = entry(variant=variant, **base_kw)
    requests = [make_frames(seed, HW) for seed in range(1, N_REQUESTS + 1)]

    errors = []
    want_rise = {k: fwd_launches.get(k, 0) for k in launch_counts()}
    reset_launch_counts()
    answers = []
    for i, req in enumerate(requests):
        out, rise = launch_rise(lambda: forward(*req))
        if rise != want_rise:
            errors.append(f"request {i}: kernel launches rose by {rise}")
        answers.append(out)
    launches = launch_counts()

    h, w = HW
    want = {"seg_logits": (1, h, w, 19), "flow": (1, h, w, 2),
            "disp": (1, h, w, 1)}
    for i, out in enumerate(answers):
        for key, shape in want.items():
            v = out[key]
            if tuple(v.shape) != shape or v.dtype != torch.float32:
                errors.append(f"request {i}: {key} {tuple(v.shape)} {v.dtype}")
            elif not bool(torch.isfinite(v).all()):
                errors.append(f"request {i}: {key} not finite")
            elif v.abs().max().item() <= 0:
                errors.append(f"request {i}: {key} all zero")
        for key, ch in (("flow_pyramid", 2), ("disp_pyramid", 1)):
            got = {l: tuple(v.shape) for l, v in out[key].items()}
            need = {l: (1, h >> l, w >> l, ch) for l in levels}
            if got != need:
                errors.append(f"request {i}: {key} {got}")
            elif not all(bool(torch.isfinite(v).all())
                         for v in out[key].values()):
                errors.append(f"request {i}: {key} not finite")

    distances, limits = [], {}
    for i, req in enumerate(requests):
        ref = plain_f32(*req)
        base = plain_bf16(*req)
        for key in want:
            d_kernel = rel_l2(answers[i][key], ref[key])
            d_plain = rel_l2(base[key], ref[key])
            limit = limits[i, key] = 1.5 * d_plain + 1e-3
            distances.append({"request": i, "head": key,
                              "kernel_bf16_vs_f32": d_kernel,
                              "plain_bf16_vs_f32": d_plain, "limit": limit})
            if not d_kernel <= limit:
                errors.append(f"request {i}: {key} rel L2 {d_kernel} > {limit}")

    # eager forward time, this path and the baseline in turns on one card
    req = requests[0]
    paths = {"kernel": forward, base_name: baseline}
    times = {base_name: [], "kernel": []}
    for which in (base_name, "kernel", "kernel", base_name):
        times[which].append(
            cuda_times(lambda: paths[which](*req), runs=20, warmup=3))
    fwd = {}
    for which, parts in times.items():
        med = statistics.median([p["median"] for p in parts])
        fwd[which] = {
            "ms_per_frame": med, "frames_per_s": 1e3 / med,
            "ms_min": min(p["min"] for p in parts),
            "ms_max": max(p["max"] for p in parts),
            "block_medians": [p["median"] for p in parts],
            "runs": sum(p["runs"] for p in parts)}
    peak_mem = torch.cuda.max_memory_allocated() / 2**30
    SERVE_MS[phase] = fwd["kernel"]["ms_per_frame"]
    ok = not errors
    emit({"phase": phase, "ok": ok, "variant": variant, "hw": list(HW),
          "dtype": "bfloat16", "requests": N_REQUESTS, "launches": launches,
          "launches_per_request": {k: v / N_REQUESTS
                                   for k, v in launches.items()},
          "distances": distances, "forward": fwd,
          "max_memory_allocated_gib": peak_mem, "errors": errors})
    if not ok:
        sys.exit(1)
    if phase == "serve":
        arith, arith_errors = serve_arithmetic(requests, forward, plain_f32,
                                               limits, fwd_launches)
        emit({"phase": "serve_arithmetic", "ok": not arith_errors,
              "variant": variant, "hw": list(HW), "dtype": "bfloat16",
              **arith, "timing": "CUDA events around one forward, the two "
              "forms in turns", "errors": arith_errors})
        if arith_errors:
            sys.exit(1)
    return launches


# stream: cerberusnet_torch.examples.video_stream's three models at
# 512x1024, their correlation launches a forward; the frames streamed, the
# latency samples among them and the frames whose streamed outputs are
# held to the same model's forward on device-resident frames
STREAM_LAUNCHES = {
    "cerberus": {"corr2d_fwd": len(LEVELS), "corr1d_fwd": len(LEVELS)},
    "dcv": {"corr2d_fwd": len(DCV_FLOW_DILATIONS),
            "corr1d_fwd": len(DCV_DISP_DILATIONS)},
    "fast": {"corr2d_fwd": len(LEVELS), "corr1d_fwd": len(LEVELS)},
}
STREAM_FAST_ENCODER = (16, 24, 32, 48, 64, 96)
STREAM_FRAMES = 32
STREAM_LATENCY = 8
STREAM_KEEP = (0, STREAM_FRAMES // 2, STREAM_FRAMES - 1)
# a streamed head against the device-resident forward's, relative L2
# (bit-equality expected; the floor of the plain bf16 rule)
STREAM_RTOL = 1e-3
# RAFT anytime: RAFTFlowNet at its default widths, one state, these counts
RAFT_ANYTIME_HW = (256, 512)
RAFT_ANYTIME_ITERS = (1, 2, 4, 8)


def stream_model(vs, name, errors):
    """One model's streamed run: (launches over it, the per-model line)."""
    import numpy as np

    model = vs.load_model(name, "cuda")
    record = {}
    reset_launch_counts()
    stats = vs.stream(name, STREAM_FRAMES, HW, STREAM_LATENCY, verbose=False,
                      device="cuda", model=model, keep=STREAM_KEEP,
                      record=record)
    torch.cuda.synchronize()
    launches = launch_counts()
    n = record["forwards"]
    want = {k: STREAM_LAUNCHES[name].get(k, 0) * n for k in launches}
    if launches != want:
        errors.append(f"{name}: launches {launches} over {n} forwards, "
                      f"expected {want}")
    # each kept frame's streamed outputs against the forward of the same
    # frame already on the device, and (the control) of the next frame
    frames = list(vs.synthetic_stream(STREAM_FRAMES, HW))
    infer = vs.make_infer(model)
    other = {t: t + 1 if t + 1 < STREAM_FRAMES else t - 1
             for t in STREAM_KEEP}
    resident = {t: infer(torch.from_numpy(np.stack(frames[t])).cuda())[0]
                for t in {*STREAM_KEEP, *other.values()}}
    equal, controls = {}, {}
    for t in STREAM_KEEP:
        got = record["outputs"][t]
        equal[t] = {}
        for key in ("seg_logits", "flow", "disp"):
            d = rel_l2(got[key], resident[t][key].float())
            equal[t][key] = {"bit_equal": bool(torch.equal(
                got[key], resident[t][key])), "rel_l2": d}
            if not d <= STREAM_RTOL:
                errors.append(f"{name} frame {t}: {key} {d} from the "
                              f"resident forward")
        miss = max(rel_l2(got[k], resident[other[t]][k].float())
                   for k in ("seg_logits", "flow", "disp"))
        controls[t] = {"against_frame": other[t], "max_rel_l2": miss}
        if not miss > STREAM_RTOL:
            errors.append(f"{name} frame {t}: frame {other[t]}'s outputs "
                          f"pass the check ({miss}): a stale frame would "
                          f"not show")
    # every correlation call of one more forward against its plain version
    # on the same tensors (launches outside the counted run)
    calls = []
    real = checked_corr_calls(calls)
    try:
        infer(torch.from_numpy(np.stack(frames[0])).cuda())
        torch.cuda.synchronize()
    finally:
        restore_corr(real)
    checked = calls_summary(calls)
    if checked["calls"] != STREAM_LAUNCHES[name]:
        errors.append(f"{name}: checked calls {checked['calls']}")
    errors += [f"{name}: {e}" for e in checked["errors"]]
    up = record["upload_ms"]
    line = {"phase": "stream", "model": name, **stats,
            "frames": STREAM_FRAMES, "latency_samples": STREAM_LATENCY,
            "forwards": n, "launches": launches,
            "launches_per_forward": {k: v / n for k, v in launches.items()},
            "upload_ms_per_frame": statistics.median(up),
            "upload_ms_max": max(up), "uploads": len(up),
            "stage_ms_per_frame": statistics.median(record["stage_ms"]),
            "stage_ms_max": max(record["stage_ms"]),
            "stage_wait_ms_per_frame": statistics.median(record["wait_ms"]),
            "loop_ms": record["loop_ms"],
            "upload_bytes_per_frame": 3 * HW[0] * HW[1] * 3,
            "streamed_vs_compute_bound": (stats["throughput_fps"]
                                          / stats["compute_bound_fps"]),
            "kept": equal, "controls": controls,
            "calls": {k: v for k, v in checked.items() if k != "rows"}}
    del model, record, resident
    torch.cuda.empty_cache()
    return launches, line


def raft_anytime(errors):
    """RAFTFlowNet at its default widths, bf16, from one state at each
    count of RAFT_ANYTIME_ITERS through the example's ``anytime``: count
    k's level field against the longest run's k-th iterate."""
    import dataclasses

    from cerberusnet_torch.entry import make_frames
    from cerberusnet_torch.examples import raft_anytime_inference as ra
    from cerberusnet_torch.train.config import ModelConfig
    from cerberusnet_torch.train.trainer import build_model
    from cerberusnet_torch.weights import init_params

    cfg = dataclasses.replace(ra.config(), model=ModelConfig(
        variant="raft", dtype="bfloat16"))
    model, _ = build_model(cfg.model, None, torch.bfloat16)
    init_params(model, torch.Generator().manual_seed(0))
    left, _, temporal = make_frames(1, RAFT_ANYTIME_HW)
    t0 = time.perf_counter()
    outs = ra.anytime(cfg, model.state_dict(), (left, temporal),
                      RAFT_ANYTIME_ITERS, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    level, last = cfg.model.raft_level, max(RAFT_ANYTIME_ITERS)
    ties = {}
    for k, out in outs.items():
        field = out["flow_pyramid"][level]
        it = outs[last]["flow_iterates"][k - 1]
        ties[k] = {"bit_equal": bool(torch.equal(field, it)),
                   "max_abs_diff": (field - it).abs().max().item(),
                   "iterates": out["flow_iterates"].shape[0],
                   "flow_finite": bool(torch.isfinite(out["flow"]).all())}
        if not (ties[k]["bit_equal"] and ties[k]["iterates"] == k
                and ties[k]["flow_finite"]):
            errors.append(f"RAFT anytime iters {k}: {ties[k]}")
    return {"hw": list(RAFT_ANYTIME_HW), "level": level, "dtype": "bfloat16",
            "iters": list(RAFT_ANYTIME_ITERS), "ties": ties,
            "seconds": seconds}


def phase_stream(card):
    """The JAX package's streaming serving loop ported
    (cerberusnet_torch.examples.video_stream) for each of its models, and
    RAFT anytime inference. Returns {"stream_<model>": launches}."""
    from cerberusnet_torch.examples import video_stream as vs

    t0 = time.perf_counter()
    errors = []
    if tuple(vs.FAST["encoder_channels"]) != STREAM_FAST_ENCODER:
        errors.append(f"fast's encoder {vs.FAST['encoder_channels']} is not "
                      f"the kernels phase's {STREAM_FAST_ENCODER}")
    runs = {}
    for name in STREAM_LAUNCHES:
        runs[f"stream_{name}"], line = stream_model(vs, name, errors)
        emit({**line, "card": card})
    anytime = raft_anytime(errors)
    emit({"phase": "stream", "ok": not errors, "hw": list(HW),
          "dtype": "bfloat16", "raft_anytime": anytime,
          "seconds": time.perf_counter() - t0, "card": card,
          "errors": errors})
    if errors:
        sys.exit(1)
    return runs


# bench: the headline's timed calls beside n1 = 2 (the bench's default),
# and the band its ms per frame must keep from serve's timing (CUDA events
# around one eager forward) of the same model and frames, taken in turns
# with the headline's own rounds: before each of its BENCH_TURNS rounds,
# a serve block of BENCH_SERVE_RUNS forwards
BENCH_ITERS = 10
BENCH_SERVE_RATIO = (0.5, 2.0)
BENCH_TURNS = 5
BENCH_SERVE_RUNS = 10


def empty_launches(n):
    """``build`` of n empty kernel launches: the timing control."""
    def run():
        for _ in range(n):
            torch.cuda._sleep(0)
    return run


def phase_bench(card, peaks):
    """The headline of cerberusnet_torch.bench: its launches, fps, FLOPs
    and MFU; the FLOP count against the plain operators'; the timing's
    control; its ms per frame against serve's timing of the same
    forward, in turns."""
    from cerberusnet_torch import bench
    from cerberusnet_torch.utils import benchutil, flops

    errors = []
    t0 = time.perf_counter()
    row = bench.full3head()
    serve_blocks = []

    def serve_block():  # serve's timing of the same forward and frames
        serve_blocks.append(cuda_times(lambda: row.fn(*row.args),
                                       runs=BENCH_SERVE_RUNS,
                                       warmup=2)["median"])

    reset_launch_counts()
    # the headline's rounds in turns with serve's blocks, so that a host
    # slowing for seconds slows both sides of the check
    st = bench.measure(row, BENCH_ITERS, "cuda", rounds=BENCH_TURNS,
                       peaks=peaks, between=serve_block)
    torch.cuda.synchronize()
    launches = launch_counts()
    if st["launches_per_call"] != EXPORT_LAUNCHES["cerberus"]:
        errors.append(f"headline launches a call {st['launches_per_call']}")
    # one forward's count with the kernels (the bench's) and with the plain
    # operators: the formulas, not the implementations, count
    kernel_flops = st["flops"] * row.frames
    with flops.plain_operators():
        plain_flops, plain_rise = launch_rise(
            lambda: flops.count(lambda: row.fn(*row.args), "cuda"))
    if kernel_flops != plain_flops:
        errors.append(f"FLOPs with the kernels {kernel_flops}, with the "
                      f"plain operators {plain_flops}")
    if any(plain_rise.values()):
        errors.append(f"the plain operators launched {plain_rise}")
    # the control: empty launches cannot be told from the floor
    floor = benchutil.roundtrip_floor()
    try:
        slopes = benchutil.time_fn_two_point_rounds(
            None, (), iters=(2, 2 + BENCH_ITERS), build=empty_launches,
            floor=floor)
        control = {"raised": False, "slopes_ms": [x * 1e3 for x in slopes]}
        errors.append(f"empty launches timed at {slopes} s a call, floor "
                      f"{floor}: FloorLimitedTiming expected")
    except benchutil.FloorLimitedTiming as e:
        control = {"raised": True, "best_ms": e.best * 1e3,
                   "floor_ms": e.floor * 1e3, "iters": e.iters}
    # the headline's ms a frame, as the bench reports it, against serve's
    ms = 1e3 / st["fps"]
    serve_ms = statistics.median(serve_blocks) / row.frames
    ratio = ms / serve_ms
    lo, hi = BENCH_SERVE_RATIO
    if not lo <= ratio <= hi:
        errors.append(f"headline {ms} ms a frame, {ratio} x serve's "
                      f"{serve_ms} in turns")
    del row
    ok = not errors
    emit({"phase": "bench", "ok": ok, "metric": bench.HEADLINE,
          "fps": st["fps"], "fps_band": st["fps_band"],
          "rounds": st["rounds"], "iters": BENCH_ITERS, "ms_per_frame": ms,
          "in_turns": {"serve_ms_per_frame": serve_ms,
                       "serve_block_medians": serve_blocks,
                       "serve_runs": BENCH_SERVE_RUNS, "turns": BENCH_TURNS},
          "vs_serve": ratio, "vs_serve_band": list(BENCH_SERVE_RATIO),
          "serve_phase_ms_per_frame": SERVE_MS.get("serve"),
          "flops_per_frame": st["flops"], "plain_operators_flops":
          plain_flops, "mfu": st["mfu"], "peak_bf16_flops_per_s":
          peaks["bf16"], "launches_per_call": st["launches_per_call"],
          "launches": launches, "floor_ms": floor * 1e3, "control": control,
          "seconds": time.perf_counter() - t0, "card": card,
          "errors": errors})
    if not ok:
        sys.exit(1)
    return launches


BACKWARDS = ("corr2d_bwd_f1", "corr2d_bwd_f2", "corr1d_bwd_f1",
             "corr1d_bwd_f2")
FUSED = {"pallas_levels": PALLAS_LEVELS, "pallas_grad": "pallas"}
# phase: (config, the model's correlation calls per step (2-D, 1-D), the
# zeroed-backward controls, the model's overrides, the encoder levels whose
# input gradient is tapped, the path timed beside it, the data overrides:
# "root" names a fixture of phase_data, and the config's own size, which
# the model cannot take, is first shown to raise)
KITTI_DATA = {"root": "kitti", "hw": [384, 1280]}
TRAIN = {
    "train": ("configs/cerberus_synthetic.json", (len(LEVELS), len(LEVELS)),
              [(k,) for k in BACKWARDS] + [BACKWARDS], {}, (), "plain", {}),
    "train_dcv": ("configs/cerberus_dcv.json",
                  (len(DCV_FLOW_DILATIONS), len(DCV_DISP_DILATIONS)),
                  [BACKWARDS], {}, (), "plain", {}),
    "train_pallas_levels": (
        "configs/cerberus_synthetic.json", (len(LEVELS), len(LEVELS)),
        [("encoder_level_bwd",)], FUSED, (2, 3), "pallas_levels_0", {}),
    "train_flow_kitti": ("configs/flow_kitti.json", (len(LEVELS), 0),
                         [(k,) for k in BACKWARDS[:2]] + [BACKWARDS[:2]],
                         {}, (), "plain", KITTI_DATA),
    "train_stereo_kitti": ("configs/stereo_kitti.json", (0, len(LEVELS)),
                           [(k,) for k in BACKWARDS[2:]] + [BACKWARDS[2:]],
                           {}, (), "plain", KITTI_DATA),
    "train_flyingthings3d": (
        "configs/cerberus_synthetic.json", (len(LEVELS), len(LEVELS)),
        [BACKWARDS], {}, (), "plain",
        {"dataset": "flyingthings3d", "root": "flyingthings3d",
         "hw": list(THINGS_HW)}),
    "train_qat": ("configs/cerberus_synthetic.json",
                  (len(LEVELS), len(LEVELS)),
                  [(k,) for k in BACKWARDS] + [BACKWARDS], {}, (), "float",
                  {}),
}
# the phases whose config's own size the model cannot take
CONFIG_HW_RAISES = ("train_flow_kitti", "train_stereo_kitti")
# phase: the loss and train overrides of every trainer it builds but the
# timed baseline, the prefix of the masters no loss reaches (their
# gradients must be zero, and they are not held to move), whether one more
# step holds every correlation call to its plain version (fit's rule), and
# whether the weights are then exported as int8 (qat_int8_export)
TRAIN_EXTRA = {
    "train_flyingthings3d": {
        "loss": {"photometric_weight": 0.1, "smoothness_weight": 0.1},
        # FlyingThings3D has no segmentation labels
        "unreached": "segmentation.", "checked_calls": True},
    # QAT: the plain paths of the comparison take the kernel path's
    # ranges, so all three run one fake-quantized function; the baseline
    # timed beside it is the float step
    "train_qat": {"train": {"qat": True}, "export_int8": True},
}


def zeroed_backward(name):
    """(module, attribute, a stand-in returning zeros) for a backward
    kernel's wrapper."""
    from cerberusnet_torch.ops.cuda import correlation as cc
    from cerberusnet_torch.ops.cuda import encoder_level as cl

    if name != "encoder_level_bwd":
        return cc, name, lambda g, f, d, dil: torch.zeros_like(f)

    def level_bwd(x, y3, g, *params, need_dx=True):
        zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in params]
        return (torch.zeros_like(x) if need_dx else None, *zeros)
    return cl, "level_bwd", level_bwd


def level_taps(encoder, levels, taps):
    """Sets identity views with hooks on the input of each encoder level in
    ``levels`` (1-based), so ``taps["encoder level N dx"]`` reads the
    gradient that level alone hands its input (NCHW): through the fused
    level's ``encoder_level`` call, or the plain level's first block.
    Returns a function that removes them."""
    from cerberusnet_torch.models import encoder as enc_mod

    def hooked(x, key, to_nchw):
        v = x.view_as(x)
        v.register_hook(lambda g: taps.__setitem__(
            key, (g.permute(0, 3, 1, 2) if to_nchw else g).float()))
        return v

    saved = enc_mod.encoder_level
    calls = []

    def fused(x, *args, **kw):
        calls.append(None)
        if len(calls) in levels:
            x = hooked(x, f"encoder level {len(calls)} dx", True)
        return saved(x, *args, **kw)

    enc_mod.encoder_level = fused
    handles = [encoder.blocks[3 * (lv - 1)].register_forward_pre_hook(
        lambda mod, args, key=f"encoder level {lv} dx": (
            hooked(args[0], key, False),))
        for lv in levels if lv > encoder.fused_levels]

    def remove():
        enc_mod.encoder_level = saved
        for h in handles:
            h.remove()
    return remove


def grads_and_taps(trainer, batch, levels=()):
    """One step's gradients (``trainer.loss_and_grads``) and the gradient
    each correlation call hands each of its inputs, as {"corr2d level 6
    df1": tensor, ...} (CerberusNet's decoders, by level) or {"corr2d
    dilation 8 df1": tensor, ...} (the DCV decoders, by dilation), and the
    gradient each encoder level in ``levels`` hands its input ({"encoder
    level 2 dx": ...}). A RAFT flow decoder's two feature maps at its
    level, as its all-pairs volume reads them ({"raft flow df1": ..., "raft
    flow df2": ...}, NHWC): on a spatial mesh f2's gradient is the sum of
    every peer's volume's share, which the gather sends back. An input goes
    through an identity view whose hook
    reads its gradient, so the hook sees that call's share alone: within a
    module's whole gradient a correlation's share is too small to show."""
    from cerberusnet_torch.models.dcv_flow import (
        DCVFlowDecoder,
        DCVStereoDecoder,
    )
    from cerberusnet_torch.models.disparity import DisparityDecoder
    from cerberusnet_torch.models.flow import FlowDecoder
    from cerberusnet_torch.models.raft import RAFTFlowDecoder

    taps = {}

    def tapped(kind, correlate):
        def call(self, arg, f1, f2):
            views = []
            for which, f in (("df1", f1), ("df2", f2)):
                v = f.view_as(f)
                key = f"{kind} {arg} {which}"
                v.register_hook(
                    lambda g, key=key: taps.__setitem__(key, g.float()))
                views.append(v)
            return correlate(self, arg, *views)
        return call

    kinds = {FlowDecoder: "corr2d level", DisparityDecoder: "corr1d level",
             DCVFlowDecoder: "corr2d dilation",
             DCVStereoDecoder: "corr1d dilation"}
    saved = {cls: cls.correlate for cls in kinds}
    for cls, kind in kinds.items():
        cls.correlate = tapped(kind, saved[cls])
    volume = RAFTFlowDecoder.volume

    def raft_volume(self, f1, f2):
        views = []
        for which, f in (("df1", f1), ("df2", f2)):
            v = f.view_as(f)
            v.register_hook(lambda g, key=f"raft flow {which}": (
                taps.__setitem__(key, g.permute(0, 2, 3, 1).float())))
            views.append(v)
        return volume(self, *views)

    RAFTFlowDecoder.volume = raft_volume
    untap = level_taps(trainer.model.encoder, levels, taps)
    try:
        _, grads = trainer.loss_and_grads(batch)
    finally:
        untap()
        RAFTFlowDecoder.volume = volume
        for cls, fn in saved.items():
            cls.correlate = fn
    return grads, taps


def module_rel_l2(grads, ref, parts=1):
    """Relative L2 distance of each module's gradients (all its parameters
    as one vector) to the reference's, a module the first ``parts`` parts
    of the names; the log-variances of uncertainty weighting count as one
    module."""
    def module(name):
        return ".".join(name.split(".")[:parts])

    out = {}
    for mod in sorted({module(n) for n in ref}):
        names = [n for n in ref if module(n) == mod]
        a = torch.cat([grads[n].flatten() for n in names])
        b = torch.cat([ref[n].flatten() for n in names])
        out[mod] = rel_l2(a, b)
    return out


def block_rel_l2(grads, ref, blocks):
    """The same for each of the encoder's first ``blocks`` conv blocks."""
    out = {}
    for i in range(blocks):
        names = [n for n in ref if n.startswith(f"encoder.blocks.{i}.")]
        a = torch.cat([grads[n].flatten() for n in names])
        b = torch.cat([ref[n].flatten() for n in names])
        out[f"encoder.blocks.{i}"] = rel_l2(a, b)
    return out


def phase_train(phase):
    from cerberusnet_torch.entry import train_entry
    from cerberusnet_torch.ops.cuda import encoder_level as cl
    from cerberusnet_torch.train.trainer import UNCERTAINTY

    config, (n2d, n1d), control_sets, model, levels, base, data = TRAIN[phase]
    extra = TRAIN_EXTRA.get(phase, {})
    loss = extra.get("loss", {})
    train = extra.get("train", {})
    raises_at = None
    if data:
        data = {**data, "root": FIXTURES[data["root"]]}
    if phase in CONFIG_HW_RAISES:
        # the config's own size: a ValueError from the model's warp
        tr, (b,) = train_entry(config, batch_size=TRAIN_BATCH,
                               data={"root": data["root"]})
        try:
            tr.train_step(b)
        except ValueError as e:
            raises_at = {"hw": list(tr.config.data.hw), "error": str(e)}
        else:
            fail(phase, f"{config} trained at {tr.config.data.hw}, where "
                        f"the reference raises")
        del tr
    fused = model.get("pallas_levels", 0)
    want_rise = {k: n2d if k.startswith("corr2d") else n1d
                 for k in launch_counts()}
    want_rise["encoder_level_fwd"] = fused
    want_rise["encoder_level_bwd"] = (
        fused if model.get("pallas_grad") == "pallas" else 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    constant = {"schedule": "constant"}
    trainer, batches = train_entry(config, batch_size=TRAIN_BATCH,
                                   n_batches=TRAIN_STEPS, optim=constant,
                                   model=model, data=data, loss=loss,
                                   train=train)
    setup_s = time.perf_counter() - t0
    errors = []
    before = {n: m.clone() for n, m in trainer.masters.items()}
    steps = []
    reset_launch_counts()
    for i, batch in enumerate(batches):
        comps, rise = launch_rise(lambda: trainer.train_step(batch))
        if rise != want_rise:
            errors.append(f"step {i}: kernel launches rose by {rise}")
        vals = {k: v.item() for k, v in comps.items()}
        if not all(map(math.isfinite, vals.values())):
            errors.append(f"step {i}: loss components {vals}")
        steps.append(vals)
    launches = launch_counts()
    partial_bytes = cl.encoder_level_bwd_partial_bytes
    unreached = [n for n in before
                 if extra.get("unreached") and n.startswith(extra["unreached"])]
    reached = [n for n in before if n not in unreached]
    moved = sum(not torch.equal(trainer.masters[n], before[n]) for n in reached)
    if moved != len(reached):
        errors.append(f"{len(reached) - moved} of {len(reached)} weights did "
                      f"not move in {TRAIN_STEPS} steps")
    log_vars = {n: m.item() for n, m in trainer.masters.items()
                if n.startswith(UNCERTAINTY)}
    if trainer.config.loss.uncertainty_weighting and not (
            len(log_vars) == 3 and all(v != 0 for v in log_vars.values())):
        errors.append(f"the log-variances did not all move: {log_vars}")

    # one step's gradients from the same weights and batch: kernels (bf16)
    # against the plain correlations in bf16 and in float32 (the yardstick)
    plain16, _ = train_entry(config, batch_size=TRAIN_BATCH, n_batches=0,
                             corr_impl="plain", optim=constant, data=data,
                             loss=loss, train=train)
    plain32, _ = train_entry(config, batch_size=TRAIN_BATCH, n_batches=0,
                             corr_impl="plain", optim=constant,
                             model={"dtype": "float32"}, data=data, loss=loss,
                             train=train)
    batch = batches[0]
    plain16.load_masters(trainer.masters)
    plain32.load_masters(trainer.masters)
    if trainer._qat_ema is not None:
        plain16._qat_ema = plain32._qat_ema = trainer._qat_ema
    # per module (and per fused encoder block), per correlation input and
    # per tapped encoder level input
    n_taps = len(levels) + 2 * (n2d + n1d)
    paths = [("kernel_bf16", trainer), ("plain_bf16", plain16)]
    samples = [batch]
    if fused:
        # every batch (see below), the same fused path in float32 (K9 and
        # K10 in float32), and in bf16 with K9's plain version rounded where
        # K9 rounds in its place (a witness: reported, not held)
        fused32, _ = train_entry(config, batch_size=TRAIN_BATCH, n_batches=0,
                                 optim=constant,
                                 model={**model, "dtype": "float32"})
        fused32.load_masters(trainer.masters)
        paths += [("kernel_f32", fused32), ("rounded_once_bf16", trainer)]
        samples = batches

    def distances_of(g, t, ref, ref_taps):
        return {**module_rel_l2(g, ref), **block_rel_l2(g, ref, 3 * fused),
                **{k: rel_l2(t[k], ref_taps[k]) for k in ref_taps}}

    per_batch = {which: [] for which, _ in paths}
    saved_fwd = cl.level_fwd
    for i, b in enumerate(samples):
        got = {}
        for which, tr in [("plain_f32", plain32), *paths]:
            if which == "rounded_once_bf16":
                cl.level_fwd = level_fwd_rounded_once
            try:
                got[which] = grads_and_taps(tr, b, levels)
            finally:
                cl.level_fwd = saved_fwd
            torch.cuda.synchronize()
            if len(got[which][1]) != n_taps:
                fail(phase, f"{which}: {len(got[which][1])} input gradients "
                            f"tapped, not {n_taps}")
        ref, ref_taps = got.pop("plain_f32")
        for which, (g, t) in got.items():
            per_batch[which].append(distances_of(g, t, ref, ref_taps))
        if i == 0:  # the controls' batch
            kernel_grads, batch_ref = got["kernel_bf16"][0], (ref, ref_taps)
        del got
    ref, ref_taps = batch_ref
    # the masters no loss reaches: zero gradients on both paths
    errors += [f"{n}: a gradient where no loss reaches" for n in unreached
               if kernel_grads[n].any() or ref[n].any()]

    # Each distance is the median over the batches. bf16: within 1.5x the
    # plain bf16 path's + 1e-3; float32: within FUSED_F32_RTOL. Behind fused
    # levels a 1-D correlation's input gradient is held in float32 alone: on
    # an H100 each bf16 path (K9's, the plain one, K9's plain version
    # rounded where K9 rounds) now and then reads two to three times its
    # median at one batch, and the median of K9's over five batches read
    # 0.84-1.46x the plain path's, so bf16 cannot tell the paths apart there.
    d = {which: {k: statistics.median(r[k] for r in rows) for k in rows[0]}
         for which, rows in per_batch.items()}
    d_kernel = d["kernel_bf16"]
    modules = [k for k in d_kernel if k not in ref_taps]
    limits = {k: 1.5 * v + 1e-3 for k, v in d["plain_bf16"].items()
              if not (fused and k.startswith("corr1d"))}
    distances = [{"of": k, **{f"{which}_vs_f32": d[which][k] for which in d},
                  **({f"{which}_per_batch": [r[k] for r in rows]
                      for which, rows in per_batch.items()} if fused else {}),
                  "limit": limits.get(k)} for k in d_kernel]
    errors += [f"{k} gradient rel L2 {d_kernel[k]} > {limits[k]}"
               for k in limits if not d_kernel[k] <= limits[k]]
    if fused:
        # float32: the fused path computes the plain path's function
        errors += [f"float32 {k} gradient rel L2 {v} > {FUSED_F32_RTOL}"
                   for k, v in d["kernel_f32"].items()
                   if not v <= FUSED_F32_RTOL]
        del fused32

    # controls: the same step with backward kernels that return zeros (one
    # at a time and all four, or all four alone: a cost volume without
    # gradient; or the encoder levels' reverse sweep); the comparison above
    # must put each beyond a limit
    controls = []
    for dropped in control_sets:
        stand_ins = [zeroed_backward(k) for k in dropped]
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in stand_ins]
        for mod, attr, fn in stand_ins:
            setattr(mod, attr, fn)
        try:
            faulty, faulty_taps = grads_and_taps(trainer, batch, levels)
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
        dist = distances_of(faulty, faulty_taps, ref, ref_taps)
        caught = [k for k in limits if not dist[k] <= limits[k]]
        controls.append({
            "zeroed": list(dropped), "caught_by": caught,
            "module_rel_l2": {m: dist[m] for m in modules},
            "module_limit": {m: limits[m] for m in modules},
            "module_rel_l2_to_kernel_path": module_rel_l2(
                faulty, kernel_grads)})
        if not caught:
            errors.append(f"zeroing {dropped} stays within every limit: "
                          f"{dist}")
    del kernel_grads, faulty, faulty_taps, plain32

    # with the levels' backward recomputed by the plain convs: the fused
    # forward (K9) still runs, the reverse sweep (K10) does not
    xla_step = None
    if fused:
        trainer.model.encoder.pallas_grad = "xla"
        try:
            _, rise = launch_rise(lambda: trainer.train_step(batch))
        finally:
            trainer.model.encoder.pallas_grad = model["pallas_grad"]
        xla_step = {"launches": rise}
        if rise != {**want_rise, "encoder_level_bwd": 0}:
            errors.append(f"pallas_grad='xla' step: launches rose by {rise}")

    # every correlation call of one more step against its plain version on
    # the same tensors (fit's rule)
    checked = None
    if extra.get("checked_calls"):
        calls = []
        real_corr = checked_corr_calls(calls)
        try:
            trainer.train_step(batch)
        finally:
            restore_corr(real_corr)
        checked = calls_summary(calls)
        want_calls = {k: v for k, v in want_rise.items() if v}
        if checked["calls"] != want_calls:
            errors.append(f"checked calls {checked['calls']}, not "
                          f"{want_calls}")
        errors += checked["errors"]

    # ms per train step, this path and the baseline in turns on one card
    if base == "plain":
        baseline = plain16
    else:
        baseline, _ = train_entry(config, batch_size=TRAIN_BATCH,
                                  n_batches=0, optim=constant, loss=loss)
        baseline.load_masters(trainer.masters)
    paths = {"kernel": trainer, base: baseline}
    times = {base: [], "kernel": []}
    for which in (base, "kernel", "kernel", base):
        tr = paths[which]
        times[which].append(cuda_times(lambda: tr.train_step(batch),
                                       runs=10, warmup=2))
    step = {}
    for which, parts in times.items():
        med = statistics.median([p["median"] for p in parts])
        step[which] = {
            "ms_per_step": med, "frames_per_s": TRAIN_BATCH * 1e3 / med,
            "ms_min": min(p["min"] for p in parts),
            "ms_max": max(p["max"] for p in parts),
            "block_medians": [p["median"] for p in parts],
            "runs": sum(p["runs"] for p in parts)}
    peak_mem = torch.cuda.max_memory_allocated() / 2**30
    int8_export = None
    if train.get("qat") and any(
            getattr(m, "fused", False) for m in trainer.model.modules()):
        errors.append("QAT trains fused estimators: the fake quantization "
                      "does not see their convs")
    if extra.get("export_int8"):
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            int8_export, export_errors = qat_int8_export(trainer, d)
        errors += export_errors
    ok = not errors
    emit({"phase": phase, "ok": ok, "config": config,
          "hw": list(trainer.config.data.hw), "batch": TRAIN_BATCH,
          "dtype": "bfloat16", "dataset": trainer.config.data.dataset,
          "config_hw_raises": raises_at, "steps": steps, "launches": launches,
          "launches_per_step": {k: v / TRAIN_STEPS
                                for k, v in launches.items()},
          "partial_bytes_per_step": partial_bytes // TRAIN_STEPS,
          "weights_moved": moved, "weights": len(reached),
          "unreached": len(unreached), "loss_overrides": loss,
          "corr_calls_vs_plain": checked, "log_variances": log_vars,
          "setup_s": setup_s, "distances": distances, "controls": controls,
          "model": model, "train_overrides": train,
          "pallas_grad_xla_step": xla_step, "train_step": step,
          "qat_int8_export": int8_export,
          "timing": "CUDA events around one train_step(batch) call, host "
                    "batch in, preprocessing and optimizer included",
          "max_memory_allocated_gib": peak_mem, "errors": errors})
    if not ok:
        sys.exit(1)
    # the wrappers' counters over the steps: launches, and K10's partials
    return {**launches, "encoder_level_bwd_partial_bytes": partial_bytes}


# The fit phase: configs/cerberus_evidence.json at its widths (128x256,
# batch 4, bf16, EMA 0.995) with the depth cut: 16 synthetic samples (4
# steps an epoch, 4 held-out batches), 2 epochs, evaluating and
# checkpointing each. A train step launches each correlation kernel once a
# level (train.remat would launch the forwards twice); an evaluation batch
# and the panel's forward launch the two forwards once a level.
FIT_CONFIG = "configs/cerberus_evidence.json"
FIT_EPOCHS = 2
FIT_SAMPLES = 16
# evaluate() on the kernels against the plain correlations, the same EMA
# weights: EPE and MAE relative, the rates (an argmax or a threshold flips
# on a pixel) absolute
FIT_REL = {"flow_epe": 1e-2, "disp_mae": 1e-2}
FIT_ABS = {"miou": 5e-3, "flow_fl_all": 5e-3, "disp_d1_all": 5e-3}
# a resumed trainer's next steps against the first trainer's: the losses
# within the floor of the bf16 rule (cuDNN may pick non-deterministic
# algorithms, so the states need not stay bit-equal past a step)
FIT_RESUME_RTOL = 1e-3
# every correlation call of one fit step and one evaluation batch against
# its plain version on the same (bf16) tensors: |kernel - plain| within
# 2^-7 |plain| (one bf16 ulp: both sum in f32 and round once) plus
# FIT_CALL_SLACK times the plain op on the inputs' magnitudes, the sum of
# |terms| behind each output (the f32 summation order moves a sum by about
# n 2^-24 of that, n <= 196 terms here)
FIT_CALL_SLACK = 1e-3


def timed_calls(obj, name, record):
    """Replaces ``obj.name`` by a wrapper that appends (kernel launches the
    call made, seconds to its end on the card) to ``record``."""
    real = getattr(obj, name)

    def call(*args, **kw):
        before = launch_counts()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        record.append(({k: v - before[k] for k, v in launch_counts().items()},
                       time.perf_counter() - t0, out))
        return out

    setattr(obj, name, call)
    return real


def timed_loader(record):
    """Replaces the trainer's DataLoader by one that appends the seconds of
    each batch's next() to record[kind] ("train": fit's epochs, "eval":
    evaluate(), "panel": render_panel's batch of 1); returns the real
    class."""
    from cerberusnet_torch.train import trainer as trainer_module
    real = trainer_module.DataLoader

    class TimedLoader(real):
        def __iter__(self):
            kind = ("eval" if not self.drop_last else
                    "train" if self.batch_size > 1 else "panel")
            batches = super().__iter__()
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    return
                record.setdefault(kind, []).append(time.perf_counter() - t0)
                yield batch

    trainer_module.DataLoader = TimedLoader
    return real


def checked_corr_calls(calls):
    """Replaces the six correlation wrappers by ones that also hold each
    call's output to its plain version on the same tensors (the
    FIT_CALL_SLACK rule) and append a row per call to ``calls``; returns
    the real wrappers. The plain calls launch no kernel."""
    from cerberusnet_torch.ops import correlation as corr
    from cerberusnet_torch.ops.cuda import correlation as cc

    plain = {"corr2d_fwd": corr._correlation2d_plain,
             "corr1d_fwd": corr._correlation1d_plain,
             "corr2d_bwd_f1": corr._correlation2d_bwd_f1_plain,
             "corr2d_bwd_f2": corr._correlation2d_bwd_f2_plain,
             "corr1d_bwd_f1": corr._correlation1d_bwd_f1_plain,
             "corr1d_bwd_f2": corr._correlation1d_bwd_f2_plain}
    real = {name: getattr(cc, name) for name in plain}

    def checked(name):
        def call(a, f, max_disp, dilation=1):
            out = real[name](a, f, max_disp, dilation)
            want = plain[name](a, f, max_disp, dilation).float()
            mag = plain[name](a.abs(), f.abs(), max_disp, dilation).float()
            limit = TOLERANCES[out.dtype][0] * want.abs() + (
                FIT_CALL_SLACK * mag)
            diff = (out.float() - want).abs()
            calls.append({
                "kernel": name, "shape": list(f.shape), "max_disp": max_disp,
                "dtype": str(out.dtype)[6:],
                "ok": bool((diff <= limit).all()),
                "max_abs_err": diff.max().item(),
                "err_of_limit": (diff / limit.clamp_min(1e-30)).max().item()})
            return out
        return call

    for name in plain:
        setattr(cc, name, checked(name))
    return real


def restore_corr(real):
    """Puts back the wrappers ``checked_corr_calls`` replaced."""
    from cerberusnet_torch.ops.cuda import correlation as cc

    for name, wrapper in real.items():
        setattr(cc, name, wrapper)


def calls_summary(calls):
    """The rows of ``checked_corr_calls`` with their count by kernel, the
    largest share of its limit any call used and the failures."""
    from collections import Counter

    return {"rule": f"|kernel - plain| <= 2^-7 |plain| + {FIT_CALL_SLACK} "
                    "plain(|a|, |f|)",
            "calls": dict(Counter(c["kernel"] for c in calls)),
            "max_err_of_limit": max((c["err_of_limit"] for c in calls),
                                    default=None),
            "errors": [f"{c['kernel']} at {c['shape']}: {c['err_of_limit']} "
                       f"of its limit" for c in calls if not c["ok"]],
            "rows": calls}


def resume_checks(tr, resumed, errors):
    """A trainer restored from ``tr``'s last checkpoint against ``tr``: the
    step, masters, EMA and optimizer state bit for bit, then two more steps
    of each on the same batches, their losses within FIT_RESUME_RTOL, and
    the first step's EMA by its rule. Appends to ``errors``; returns (the
    steps' losses, the EMA's largest error over its rounding bound)."""
    from cerberusnet_torch.data.loader import batches

    sa = tr.optimizer.state_dict()
    sb = resumed.optimizer.state_dict()
    same = (resumed.step == tr.step and sa["count"] == sb["count"]
            and all(torch.equal(tr.masters[n], resumed.masters[n])
                    and torch.equal(tr.ema[n], resumed.ema[n])
                    for n in tr.names)
            and all(torch.equal(v, sb["opt"]["state"][i][k])
                    for i, st in sa["opt"]["state"].items()
                    for k, v in st.items()))
    if not same:
        errors.append(f"resume restored step {resumed.step} and not "
                      f"the same masters, EMA and optimizer state")
    decay = tr.config.optim.ema_decay
    resume_losses, ema_err = [], 0.0
    for i, batch in enumerate(batches(tr.dataset, tr.config.data.batch_size,
                                      2)):
        ema0 = {n: e.clone() for n, e in tr.ema.items()}
        ca = {k: v.item() for k, v in tr.train_step(batch).items()}
        cb = {k: v.item() for k, v in resumed.train_step(batch).items()}
        resume_losses.append({"first": ca, "resumed": cb})
        errors += [f"resumed step {i}: {k} {cb[k]} against {ca[k]}"
                   for k in ca if not abs(cb[k] - ca[k])
                   <= FIT_RESUME_RTOL * abs(ca[k])]
        if i == 0:
            # the EMA rule, d ema0 + (1 - d) p1, to float32 rounding
            for n, e in tr.ema.items():
                a = decay * ema0[n].double()
                b = (1 - decay) * tr.masters[n].double()
                bound = 2.0**-22 * (a.abs() + b.abs()) + 1e-30
                ema_err = max(ema_err, ((e.double() - a - b).abs()
                                        / bound).max().item())
            if not ema_err <= 1:
                errors.append(f"EMA off its rule by {ema_err} of the "
                              f"float32 rounding bound")
    return resume_losses, ema_err


def phase_fit(card):
    import contextlib
    import copy
    import os
    import tempfile

    from collections import Counter

    from cerberusnet_torch.data.loader import batches
    from cerberusnet_torch.entry import REPO_ROOT
    from cerberusnet_torch.ops.cuda import correlation as cc
    from cerberusnet_torch.train.config import ExperimentConfig
    from cerberusnet_torch.train import trainer as trainer_module
    from cerberusnet_torch.train.metrics import METRICS
    from cerberusnet_torch.train.trainer import Trainer
    from cerberusnet_torch.utils.visualization import read_png_u8

    raw = json.loads((REPO_ROOT / FIT_CONFIG).read_text())
    errors = []
    if (tuple(raw["data"]["hw"]) != FIT_HW
            or raw["data"]["batch_size"] != FIT_BATCH):
        errors.append(f"{FIT_CONFIG} is no longer {FIT_HW} at batch "
                      f"{FIT_BATCH}, the shapes the kernels phase checked")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        raw["data"]["synthetic_length"] = FIT_SAMPLES
        raw["train"].update(epochs=FIT_EPOCHS, eval_every_epochs=1,
                            ckpt_every_epochs=1, ckpt_dir=ckpt_dir,
                            resume=True)

        def trainer(**model):
            r = copy.deepcopy(raw)
            r["model"].update(model)
            # the trainer's prints (a restore, fit's rows) go to stderr:
            # stdout holds the JSON lines
            with contextlib.redirect_stdout(sys.stderr):
                return Trainer(ExperimentConfig.from_dict(r))

        t0 = time.perf_counter()
        tr = trainer()
        setup_s = time.perf_counter() - t0
        bs = tr.config.data.batch_size
        eval_batches = -(-FIT_SAMPLES // bs)
        steps, evals, saves = [], [], []
        real_step = timed_calls(tr, "train_step", steps)
        real_evaluate = timed_calls(tr, "evaluate", evals)
        timed_calls(tr, "save_checkpoint", saves)
        load_s = {}
        real_loader = timed_loader(load_s)
        reset_launch_counts()
        cc.reset_design_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            history = tr.fit()
        fit_s = time.perf_counter() - t0
        launches = launch_counts()
        design = cc.launched_design()
        trainer_module.DataLoader = real_loader
        tr.evaluate = real_evaluate

        n_steps = FIT_EPOCHS * (FIT_SAMPLES // bs)
        want_step = {k: len(LEVELS) if k in REPLACES else 0
                     for k in launches}
        want_eval = {k: eval_batches * len(LEVELS)
                     if k in ("corr2d_fwd", "corr1d_fwd") else 0
                     for k in launches}
        # and the panel's forward (batch 1) after each evaluation
        want = {k: n_steps * want_step[k] + len(evals) * (
            want_eval[k] + want_eval[k] // eval_batches) for k in launches}
        errors += [f"step {i}: kernel launches rose by {r}"
                   for i, (r, _, _) in enumerate(steps) if r != want_step]
        errors += [f"evaluation {i}: kernel launches rose by {r}"
                   for i, (r, _, _) in enumerate(evals) if r != want_eval]
        if launches != want:
            errors.append(f"fit launched {launches}, not {want}")
        if design != "tc":
            errors.append(f"the bf16 correlations ran on {design!r}, not tc")
        if len(history) != FIT_EPOCHS or tr.step != n_steps or len(
                steps) != n_steps or len(evals) != FIT_EPOCHS:
            errors.append(f"{len(history)} history rows, step {tr.step}, "
                          f"{len(steps)} steps, {len(evals)} evaluations")
        for row in history:
            vals = [v for k, v in row.items() if k.startswith("loss_")]
            vals += [row.get(k, math.nan) for k in METRICS]
            if len(vals) != 4 + len(METRICS) or not all(
                    map(math.isfinite, vals)):
                errors.append(f"epoch {row['epoch']}: {row}")
        panel_path = os.path.join(ckpt_dir,
                                  f"predictions_epoch{FIT_EPOCHS - 1}.png")
        h, w = tr.config.data.hw
        panel_shape = list(read_png_u8(panel_path).shape)
        if panel_shape != [4 * h, w, 3]:
            errors.append(f"panel {panel_shape}, not {[4 * h, w, 3]}")

        # evaluate() changes no master
        masters = {n: m.clone() for n, m in tr.masters.items()}
        got = tr.evaluate()
        changed = [n for n, m in tr.masters.items()
                   if not torch.equal(m, masters[n])]
        if changed:
            errors.append(f"evaluate() changed {len(changed)} masters")

        # the kernels against the plain correlations: the same EMA weights
        # (restored from the last checkpoint)
        plain = trainer(corr_impl="plain")
        if plain.step != n_steps:
            errors.append(f"the plain trainer restored step {plain.step}")
        want_metrics = plain.evaluate()
        del plain
        metric_check = {}
        for k, tol in (*FIT_REL.items(), *FIT_ABS.items()):
            d = abs(got[k] - want_metrics[k])
            if k in FIT_REL:
                d /= abs(want_metrics[k])
            metric_check[k] = {"kernel": got[k], "plain": want_metrics[k],
                               "distance": d, "limit": tol,
                               "relative": k in FIT_REL}
            if not d <= tol:
                errors.append(f"{k}: kernels {got[k]}, plain "
                              f"{want_metrics[k]}, {d} > {tol}")

        # resume: the same state bit for bit, then the same next steps
        resumed = trainer()
        tr.train_step = real_step
        decay = tr.config.optim.ema_decay
        resume_losses, ema_err = resume_checks(tr, resumed, errors)
        del resumed

        # every correlation call of one more train step and one evaluation
        # batch against its plain version on the same tensors
        calls = []
        real_corr = checked_corr_calls(calls)
        cc.reset_design_launches()
        tr.train_step(batches(tr.dataset, bs, 1)[0])
        tr.evaluate(batches(tr.eval_dataset, bs, 1))
        call_design = cc.launched_design()
        restore_corr(real_corr)
        want_calls = {k: want_step[k] + want_eval[k] // eval_batches
                      for k in REPLACES}
        got_calls = dict(Counter(c["kernel"] for c in calls))
        if got_calls != want_calls:
            errors.append(f"checked calls {got_calls}, not {want_calls}")
        if call_design != "tc":
            errors.append(f"the checked calls ran on {call_design!r}, not tc")
        errors += [f"{c['kernel']} at {c['shape']}, d={c['max_disp']}: "
                   f"{c['err_of_limit']} of its limit"
                   for c in calls if not c["ok"]]
        ckpt_bytes = os.path.getsize(saves[-1][2])

    step_ms = [dt * 1e3 for _, dt, _ in steps]
    ok = not errors
    emit({"phase": "fit", "ok": ok, "config": FIT_CONFIG,
          "hw": list(tr.config.data.hw), "batch": bs, "dtype": "bfloat16",
          "ema_decay": decay, "epochs": FIT_EPOCHS, "samples": FIT_SAMPLES,
          "history": history, "launches": launches,
          "launches_per_step": want_step, "launches_per_eval_batch": {
              k: v // eval_batches for k, v in want_eval.items()},
          "design": design, "metrics_kernels_vs_plain": metric_check,
          "resume_losses": resume_losses, "ema_rule_err_of_bound": ema_err,
          "corr_calls_vs_plain": {
              "rule": f"|kernel - plain| <= 2^-7 |plain| + {FIT_CALL_SLACK}"
                      " plain(|a|, |f|)", "design": call_design,
              "calls": calls},
          "panel_shape": panel_shape, "setup_s": setup_s, "fit_s": fit_s,
          "errors": errors})
    emit({"phase": "fit_times", "card": card,
          "ms_per_fit_step": statistics.median(step_ms[1:]),
          "ms_per_fit_step_all": step_ms,
          "timing": "host clock around train_step and a synchronize, "
                    "median over the steps after the first",
          "eval_s_per_batch": statistics.median(
              dt / eval_batches for _, dt, _ in evals),
          "load_s_per_batch": {k: statistics.median(v)
                               for k, v in load_s.items()},
          "load_s_all": load_s,
          "load_timing": "host clock around the trainer's DataLoader's "
                         "next() in fit (train: its epochs, eval: "
                         "evaluate(), panel: the panel's sample)",
          "checkpoint_bytes": ckpt_bytes,
          "checkpoint_save_s": [dt for _, dt, _ in saves]})
    if not ok:
        sys.exit(1)
    return launches


# The RAFT phases: CerberusRAFT (configs/cerberus_raft.json's widths:
# level 3, 12 iterations, radius 4, 4 volume levels, bf16) runs no hand
# kernel (its all-pairs volumes and lookups are torch.matmul and gathers),
# so every counter must stay at 0 on its paths.
RAFT_CONFIG = "configs/cerberus_raft.json"
RAFT_FIT_CONFIG = "configs/raft_evidence.json"
RAFT_LEVEL, RAFT_ITERS = 3, 12
# the deploy point, configs/raft_lv4_deploy.json: level 4, 6 iterations
RAFT_DEPLOY = (4, 6)
RAFT_LOOKUPS = ("onehot", "gather")
# The onehot and gather lookups on the same float32 weights and frames: the
# same function, apart by float32 rounding (relative L2 on each output).
RAFT_LOOKUP_RTOL = 1e-4
# The card against the CPU in float32, the same seeded weights and inputs,
# at RAFT_PARITY_HW (the CPU side stays short): outputs and one step's
# gradients per module, relative L2; only the summation order differs (TF32
# off), through 12 iterations.
RAFT_PARITY_HW = (128, 256)
RAFT_DEVICE_RTOL = 1e-4
RAFT_DEVICE_GRAD_RTOL = 1e-3
# A bf16 step's gradients per module (the names' first three parts: the
# GRU, the motion encoder and each head of an update block apart, each
# encoder block, a projection's kernel and bias) against the float32 step's
# on the same weights and batch, relative L2; the mask heads, whose
# gradients are zero, are checked apart. Set from the card's readings at
# this phase's size, up to 0.019 (PERF.md): a gradient a quarter off, or a
# lost path (1), exceeds it. On the CPU at 64x64 single modules of both packages read
# up to 0.2-0.4 (sums over few pixels that cancel;
# scripts/raft_bf16_grad_spread.py); tests/test_torch_raft.py holds the
# port's bf16 step to the JAX Trainer's.
RAFT_BF16_GRAD_RTOL = 0.1
# The masters a CerberusRAFT step leaves where they are: the biases
# (initialised to 0, so no weight decay moves them) of the upsampling masks'
# heads, which no loss reaches (the sequence loss supervises the iterates,
# not the upsampled field; so in the reference too).
RAFT_UNMOVED = sorted(f"{d}.update.{h}.bias" for d in ("flow", "disparity")
                      for h in ("mask_head1", "mask_head2"))


def flat_outputs(out):
    """An output dict as {name: tensor}, the pyramids by level."""
    res = {}
    for key, v in out.items():
        for level, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            res[key if level is None else f"{key}[{level}]"] = t
    return res


def raft_output_errors(out, hw, level, iters):
    """What is wrong with one CerberusRAFT answer at batch 1: each output's
    shape, float32, finite and not all zero."""
    h, w = hw
    hl, wl = h >> level, w >> level
    want = {"seg_logits": (1, h, w, 19), "flow": (1, h, w, 2),
            "disp": (1, h, w, 1), f"flow_pyramid[{level}]": (1, hl, wl, 2),
            f"disp_pyramid[{level}]": (1, hl, wl, 1),
            "flow_iterates": (iters, 1, hl, wl, 2),
            "disp_iterates": (iters, 1, hl, wl, 1)}
    got = flat_outputs(out)
    if sorted(got) != sorted(want):
        return [f"outputs {sorted(got)}"]
    errors = []
    for key, shape in want.items():
        v = got[key]
        if tuple(v.shape) != shape or v.dtype != torch.float32:
            errors.append(f"{key} {tuple(v.shape)} {v.dtype}")
        elif not bool(torch.isfinite(v).all()):
            errors.append(f"{key} not finite")
        elif v.abs().max().item() <= 0:
            errors.append(f"{key} all zero")
    return errors


def turns(fns, call, runs, warmup):
    """CUDA-event times of ``call(fn)`` for each of two paths in turns (a,
    b, b, a) on one card: {name: {"ms": median of the block medians, "ms_min",
    "ms_max", "block_medians", "runs"}}."""
    a, b = fns
    parts = {a: [], b: []}
    for which in (a, b, b, a):
        parts[which].append(cuda_times(lambda: call(fns[which]), runs=runs,
                                       warmup=warmup))
    return {which: {"ms": statistics.median(p["median"] for p in ps),
                    "ms_min": min(p["min"] for p in ps),
                    "ms_max": max(p["max"] for p in ps),
                    "block_medians": [p["median"] for p in ps],
                    "runs": sum(p["runs"] for p in ps)}
            for which, ps in parts.items()}


def peak_gib(fn):
    """Peak device memory (GiB) over one call of ``fn`` after the memory
    already held."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**30


def phase_serve_raft(card):
    from cerberusnet_torch.entry import entry, make_frames

    errors = []
    forward, _ = entry(variant="cerberus_raft")
    requests = [make_frames(seed, HW) for seed in range(1, N_REQUESTS + 1)]
    reset_launch_counts()
    answers = [forward(*req) for req in requests]
    torch.cuda.synchronize()
    launches = launch_counts()
    if any(launches.values()):
        errors.append(f"hand kernels launched on the RAFT path: {launches}")
    for i, out in enumerate(answers):
        errors += [f"request {i}: {e}" for e in
                   raft_output_errors(out, HW, RAFT_LEVEL, RAFT_ITERS)]
    del answers

    # the two lookups on the same weights and frames: float32 (held) and
    # bf16 (reported)
    lookups = {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        req = make_frames(1, HW, dtype=dtype)
        a, b = (flat_outputs(entry(variant="cerberus_raft", dtype=dtype,
                                   raft_lookup=impl)[0](*req))
                for impl in RAFT_LOOKUPS)
        lookups[name] = {k: rel_l2(b[k], a[k].float()) for k in a}
    errors += [f"float32 {k}: gather against onehot rel L2 {d} > "
               f"{RAFT_LOOKUP_RTOL}" for k, d in lookups["float32"].items()
               if not d <= RAFT_LOOKUP_RTOL]

    # the card against the CPU: float32, the same seeded weights and frames
    outs = {}
    for device in ("cuda", "cpu"):
        fwd, imgs = entry(device=device, dtype=torch.float32,
                          hw=RAFT_PARITY_HW, variant="cerberus_raft")
        outs[device] = flat_outputs(fwd(*imgs))
    device_rel = {k: rel_l2(v.cpu(), outs["cpu"][k])
                  for k, v in outs["cuda"].items()}
    errors += [f"card against CPU: {k} rel L2 {d} > {RAFT_DEVICE_RTOL}"
               for k, d in device_rel.items() if not d <= RAFT_DEVICE_RTOL]
    del outs

    # eager ms per frame for both lookups, in turns, at the config's point
    # and at the deploy point; the peak memory of one request
    req = requests[0]
    points = {}
    for level, iters in ((RAFT_LEVEL, RAFT_ITERS), RAFT_DEPLOY):
        fwds = {impl: entry(variant="cerberus_raft", raft_level=level,
                            raft_iters=iters, raft_lookup=impl)[0]
                for impl in RAFT_LOOKUPS}
        reset_launch_counts()
        for impl, fwd in fwds.items():
            errors += [f"level {level} {impl}: {e}" for e in
                       raft_output_errors(fwd(*req), HW, level, iters)]
        if any(launch_counts().values()):
            errors.append(f"level {level}: hand kernels launched")
        times = turns(fwds, lambda f: f(*req), runs=20, warmup=3)
        points[f"level{level}_iters{iters}"] = {
            impl: {**times[impl], "frames_per_s": 1e3 / times[impl]["ms"],
                   "max_memory_allocated_gib": peak_gib(
                       lambda: fwds[impl](*req))}
            for impl in RAFT_LOOKUPS}
        del fwds
    gates = raft_gates_forward(req)
    ok = not errors
    emit({"phase": "serve_raft", "ok": ok, "variant": "cerberus_raft",
          "hw": list(HW), "dtype": "bfloat16", "requests": N_REQUESTS,
          "launches": launches, "lookup_gather_vs_onehot": lookups,
          "lookup_rtol_f32": RAFT_LOOKUP_RTOL,
          "device_vs_cpu_f32": {"hw": list(RAFT_PARITY_HW),
                                "rel_l2": device_rel,
                                "limit": RAFT_DEVICE_RTOL},
          "forward": points, "gates": gates, "card": card,
          "timing": "CUDA events around one eager forward after warmup, "
                    "the lookups in turns, the gates in turns",
          "errors": errors})
    if not ok:
        sys.exit(1)
    return launches


def phase_train_raft(card):
    from cerberusnet_torch.entry import train_entry

    errors = []
    constant = {"schedule": "constant"}
    t0 = time.perf_counter()
    trainer, batches = train_entry(RAFT_CONFIG, batch_size=TRAIN_BATCH,
                                   n_batches=TRAIN_STEPS, optim=constant)
    setup_s = time.perf_counter() - t0
    before = {n: m.clone() for n, m in trainer.masters.items()}
    steps = []
    reset_launch_counts()
    for i, batch in enumerate(batches):
        vals = {k: v.item() for k, v in trainer.train_step(batch).items()}
        if sorted(vals) != ["disp", "flow", "seg", "total"] or not all(
                map(math.isfinite, vals.values())):
            errors.append(f"step {i}: loss components {vals}")
        steps.append(vals)
    torch.cuda.synchronize()
    launches = launch_counts()
    if any(launches.values()):
        errors.append(f"hand kernels launched on the RAFT path: {launches}")
    still = sorted(n for n, m in trainer.masters.items()
                   if torch.equal(m, before[n]))
    if still != RAFT_UNMOVED:
        errors.append(f"masters that did not move in {TRAIN_STEPS} steps: "
                      f"{still}, not {RAFT_UNMOVED}")

    # one step's gradients, bf16 against float32 on the same weights and
    # batch, per module; the mask heads' are exactly zero in both
    batch = batches[0]
    f32, _ = train_entry(RAFT_CONFIG, batch_size=TRAIN_BATCH, n_batches=0,
                         optim=constant, model={"dtype": "float32"})
    f32.load_masters(trainer.masters)
    _, g16 = trainer.loss_and_grads(batch)
    _, g32 = f32.loss_and_grads(batch)
    del f32
    heads = [n for n in g32 if ".mask_head" in n]
    if len(heads) != 8 or any(g16[n].any() or g32[n].any() for n in heads):
        errors.append(f"the mask heads' gradients are not all zero: {heads}")
    bf16_rel = module_rel_l2(g16, {n: g for n, g in g32.items()
                                   if n not in heads}, parts=3)
    errors += [f"bf16 {k} gradient rel L2 {d} > {RAFT_BF16_GRAD_RTOL}"
               for k, d in bf16_rel.items() if not d <= RAFT_BF16_GRAD_RTOL]
    del g16, g32

    # the card against the CPU: one float32 step's gradients at
    # RAFT_PARITY_HW from the same seeded weights and batch
    small = {"hw": list(RAFT_PARITY_HW)}
    grads = {}
    for device in ("cuda", "cpu"):
        tr, (b,) = train_entry(RAFT_CONFIG, batch_size=TRAIN_BATCH,
                               device=device, optim=constant,
                               model={"dtype": "float32"}, data=small)
        grads[device] = {n: g.cpu() for n, g in tr.loss_and_grads(b)[1].items()}
    device_rel = module_rel_l2(grads["cuda"], grads["cpu"], parts=2)
    errors += [f"card against CPU: {k} gradient rel L2 {d} > "
               f"{RAFT_DEVICE_GRAD_RTOL}" for k, d in device_rel.items()
               if not d <= RAFT_DEVICE_GRAD_RTOL]
    del grads

    # ms per step for both lookups, in turns, and the peak memory of one
    gather, _ = train_entry(RAFT_CONFIG, batch_size=TRAIN_BATCH, n_batches=0,
                            optim=constant, model={"raft_lookup": "gather"})
    gather.load_masters(trainer.masters)
    trainers = {"onehot": trainer, "gather": gather}
    times = turns(trainers, lambda tr: tr.train_step(batch), runs=10,
                  warmup=2)
    step = {impl: {**times[impl],
                   "frames_per_s": TRAIN_BATCH * 1e3 / times[impl]["ms"],
                   "max_memory_allocated_gib": peak_gib(
                       lambda: trainers[impl].train_step(batch))}
            for impl in RAFT_LOOKUPS}
    del gather, trainers
    gates = raft_gates_step(trainer, batch, constant)
    ok = not errors
    emit({"phase": "train_raft", "ok": ok, "config": RAFT_CONFIG,
          "hw": list(HW), "batch": TRAIN_BATCH, "dtype": "bfloat16",
          "steps": steps, "launches": launches, "masters_unmoved": still,
          "weights": len(before), "setup_s": setup_s,
          "bf16_vs_f32_grad_rel_l2": bf16_rel,
          "bf16_limit": RAFT_BF16_GRAD_RTOL,
          "device_vs_cpu_f32_grad": {"hw": list(RAFT_PARITY_HW),
                                     "rel_l2": device_rel,
                                     "limit": RAFT_DEVICE_GRAD_RTOL},
          "train_step": step, "gates": gates, "card": card,
          "timing": "CUDA events around one train_step(batch) call, host "
                    "batch in, the lookups in turns, the gates in turns",
          "errors": errors})
    if not ok:
        sys.exit(1)
    return launches


@contextlib.contextmanager
def torch_gates():
    """The RAFT models' GRU gates and hidden state as ``torch.sigmoid`` and
    ``torch.tanh`` (their form before they rounded as flax's, ROADMAP C7)
    while it is entered."""
    from cerberusnet_torch.models import raft

    kept = raft.sigmoid, raft.tanh
    raft.sigmoid, raft.tanh = torch.sigmoid, torch.tanh
    try:
        yield
    finally:
        raft.sigmoid, raft.tanh = kept


def raft_gates_forward(req):
    """The served eager bf16 CerberusRAFT forward with the gates rounding
    as flax's (the model's) and with torch's own, on the same weights and
    frames: ms a forward in turns and the device launches of one each."""
    from cerberusnet_torch.entry import entry

    forward, _ = entry(variant="cerberus_raft")

    def call(form):
        if form == "torch":
            with torch_gates():
                return forward(*req)
        return forward(*req)

    forms = {"flax": "flax", "torch": "torch"}
    times = turns(forms, call, runs=20, warmup=3)
    return {form: {**times[form], "device_launches_per_forward":
                   device_launches(lambda f=form: call(f))}
            for form in forms}


def raft_gates_step(trainer, batch, optim):
    """The eager bf16 RAFT step with the gates rounding as flax's (the
    model's) and with torch's own, on the same masters and batch: ms a
    step in turns and the device launches of one step each."""
    from cerberusnet_torch.entry import train_entry

    other, _ = train_entry(RAFT_CONFIG, batch_size=TRAIN_BATCH, n_batches=0,
                           optim=optim)
    other.load_masters(trainer.masters)

    def step(form):
        if form == "torch":
            with torch_gates():
                return other.train_step(batch)
        return trainer.train_step(batch)

    times = turns({"flax": "flax", "torch": "torch"}, step, runs=10,
                  warmup=2)
    launches = {form: device_launches(lambda f=form: step(f))
                for form in ("flax", "torch")}
    del other
    torch.cuda.empty_cache()
    return {form: {**times[form], "device_launches_per_step":
                   launches[form]} for form in ("flax", "torch")}


def phase_fit_raft(card):
    import contextlib
    import copy
    import os
    import tempfile

    from cerberusnet_torch.entry import REPO_ROOT
    from cerberusnet_torch.train.config import ExperimentConfig
    from cerberusnet_torch.train.metrics import METRICS
    from cerberusnet_torch.train.trainer import Trainer
    from cerberusnet_torch.utils.visualization import read_png_u8

    raw = json.loads((REPO_ROOT / RAFT_FIT_CONFIG).read_text())
    errors = []
    with tempfile.TemporaryDirectory() as ckpt_dir:
        raw["data"]["synthetic_length"] = FIT_SAMPLES
        raw["train"].update(epochs=FIT_EPOCHS, eval_every_epochs=1,
                            ckpt_every_epochs=1, ckpt_dir=ckpt_dir,
                            resume=True)

        def trainer():
            # the trainer's prints go to stderr: stdout holds the JSON lines
            with contextlib.redirect_stdout(sys.stderr):
                return Trainer(ExperimentConfig.from_dict(copy.deepcopy(raw)))

        t0 = time.perf_counter()
        tr = trainer()
        setup_s = time.perf_counter() - t0
        bs = tr.config.data.batch_size
        steps, evals = [], []
        real_step = timed_calls(tr, "train_step", steps)
        real_evaluate = timed_calls(tr, "evaluate", evals)
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            history = tr.fit()
        fit_s = time.perf_counter() - t0
        launches = launch_counts()
        if any(launches.values()):
            errors.append(f"hand kernels launched on the RAFT fit: {launches}")
        tr.evaluate = real_evaluate
        n_steps = FIT_EPOCHS * (FIT_SAMPLES // bs)
        if len(history) != FIT_EPOCHS or tr.step != n_steps or len(
                evals) != FIT_EPOCHS:
            errors.append(f"{len(history)} history rows, step {tr.step}, "
                          f"{len(evals)} evaluations")
        for row in history:
            vals = [v for k, v in row.items() if k.startswith("loss_")]
            vals += [row.get(k, math.nan) for k in METRICS]
            if len(vals) != 4 + len(METRICS) or not all(
                    map(math.isfinite, vals)):
                errors.append(f"epoch {row['epoch']}: {row}")
        h, w = tr.config.data.hw
        panel_shape = list(read_png_u8(os.path.join(
            ckpt_dir, f"predictions_epoch{FIT_EPOCHS - 1}.png")).shape)
        if panel_shape != [4 * h, w, 3]:
            errors.append(f"panel {panel_shape}, not {[4 * h, w, 3]}")

        # evaluate() changes no master
        masters = {n: m.clone() for n, m in tr.masters.items()}
        tr.evaluate()
        changed = [n for n, m in tr.masters.items()
                   if not torch.equal(m, masters[n])]
        if changed:
            errors.append(f"evaluate() changed {len(changed)} masters")

        # resume: the same state bit for bit, then the same next steps
        resumed = trainer()
        tr.train_step = real_step
        resume_losses, ema_err = resume_checks(tr, resumed, errors)
        del resumed
    step_ms = [dt * 1e3 for _, dt, _ in steps]
    ok = not errors
    emit({"phase": "fit_raft", "ok": ok, "config": RAFT_FIT_CONFIG,
          "hw": [h, w], "batch": bs, "dtype": "bfloat16",
          "raft_iters": tr.config.model.raft_iters,
          "ema_decay": tr.config.optim.ema_decay, "epochs": FIT_EPOCHS,
          "samples": FIT_SAMPLES, "history": history, "launches": launches,
          "resume_losses": resume_losses, "ema_rule_err_of_bound": ema_err,
          "panel_shape": panel_shape, "setup_s": setup_s, "fit_s": fit_s,
          "ms_per_fit_step": statistics.median(step_ms[1:]),
          "ms_per_fit_step_all": step_ms,
          "eval_s_per_batch": statistics.median(
              dt / -(-FIT_SAMPLES // bs) for _, dt, _ in evals),
          "card": card, "errors": errors})
    if not ok:
        sys.exit(1)
    return launches


# The data slice's phases. Fixtures the port's writers make from a seed in
# a temporary directory: KITTI-2015 at its frame size with sparse 16-bit
# ground truth, Cityscapes at its frame size with labelIds and the 16-bit
# disparity (train and val); every PNG must go through the native decoder.
KITTI_FRAME = (375, 1242)
KITTI_SAMPLES = 16
CITY_FRAME = (1024, 2048)
CITY_SAMPLES, CITY_VAL = 8, 2
# flow_kitti's and stereo_kitti's data.hw, [384, 1248], raises in both
# packages (level 6 is 20 wide, level 5 39, and the warp refuses the 40-wide
# upsampled flow); the card runs them at the next width that is a multiple
# of 64
KITTI_HW = (384, 1280)
# dcv_flow_kitti as it stands: 384x1248 at batch 4 (its level 3 is 48x156)
DCV_KITTI_HW, DCV_KITTI_BATCH = (384, 1248), 4
CITY_HW = (512, 1024)
SEG_ASPP_CONFIG = "configs/seg_aspp_cityscapes.json"
DCV_KITTI_CONFIG = "configs/dcv_flow_kitti.json"
SEG_EPOCHS = 3
SEG_TIMED_STEPS = 5
# the ASPP SegNet's forward on the card against the CPU in float32, the same
# seeded weights and frames (TF32 off): summation order alone
SEG_PARITY_HW = (128, 256)
SEG_DEVICE_RTOL = 1e-4
# preprocess on the card against the CPU: images (normalised) within this,
# the nearest-resized ground truth exactly
PREPROCESS_ATOL = 1e-5
FIXTURES = {}


def phase_data(card, root):
    from cerberusnet_torch.data import augment, native_io
    from cerberusnet_torch.data.cityscapes import CityscapesDataset
    from cerberusnet_torch.data.kitti import Kitti2015Dataset
    from cerberusnet_torch.data.loader import collate, preprocess, to_device
    from cerberusnet_torch.data.synthetic import SyntheticPerceptionDataset

    errors = []
    FIXTURES.update(kitti=f"{root}/kitti", cityscapes=f"{root}/cityscapes")
    t0 = time.perf_counter()
    SyntheticPerceptionDataset(
        length=KITTI_SAMPLES, hw=KITTI_FRAME, sparse=True).write_kitti_fixture(
            FIXTURES["kitti"] + "/training", KITTI_SAMPLES, workers=8)
    for split, n, seed in (("train", CITY_SAMPLES, 0), ("val", CITY_VAL, 1)):
        SyntheticPerceptionDataset(length=n, hw=CITY_FRAME, seed=seed
                                   ).write_cityscapes_fixture(
            FIXTURES["cityscapes"], n, split, workers=8)
    write_s = time.perf_counter() - t0

    # read back through the port's datasets, one sample at a time
    datasets = {"kitti": Kitti2015Dataset(FIXTURES["kitti"], "training"),
                "cityscapes": CityscapesDataset(FIXTURES["cityscapes"],
                                                "train")}
    decode = {}
    for name, ds in datasets.items():
        ms, decoders = [], set()
        for i in range(len(ds)):
            t0 = time.perf_counter()
            s = ds[i]
            ms.append((time.perf_counter() - t0) * 1e3)
            decoders.add(s["decoder"])
        if decoders != {"native"}:
            errors.append(f"{name}: decoded by {sorted(decoders)}")
        decode[name] = {"samples": len(ds), "ms_per_sample": statistics.median(
            ms), "ms_all": ms, "decoders": sorted(decoders),
            "frame": list(s["left"].shape[:2]),
            "pngs_per_sample": 5 if name == "kitti" else 4}
    if native_io.library() is None:
        errors.append("the native PNG decoder did not load")

    # preprocess on the card against the CPU
    batches_ = {name: collate([ds[0], ds[1]]) for name, ds in datasets.items()}
    prep = {}
    for name, hw in (("kitti", KITTI_HW), ("cityscapes", CITY_HW)):
        gpu = preprocess(batches_[name], hw, torch.float32, "cuda")
        cpu = preprocess(batches_[name], hw, torch.float32, "cpu")
        diffs = {k: (gpu[k].cpu().double() - cpu[k].double()).abs().max().item()
                 for k in cpu}
        prep[name] = {"hw": list(hw), "max_abs_diff": diffs}
        for k, d in diffs.items():
            limit = PREPROCESS_ATOL if k in ("left", "right", "temporal") else 0
            if not d <= limit:
                errors.append(f"preprocess {name} {k}: {d} > {limit}")

    # augmentation on the card against the CPU with the same draws:
    # seg_aspp_cityscapes's set on the Cityscapes batch, and each zoom of a
    # scales set on the KITTI batch (whose disparity turns the flip off)
    cases = [("cityscapes", augment.AugmentConfig(
        crop_hw=(384, 768), flip_lr_prob=0.5, brightness=0.2, contrast=0.2),
        0)]
    zoom = augment.AugmentConfig(crop_hw=(320, 960), scales=(0.8, 1.0, 1.25),
                                 flip_lr_prob=0.5)
    seen = set()
    for seed in range(1, 100):
        d = augment.draw(zoom, 2, KITTI_FRAME, torch.Generator().manual_seed(
            seed))
        if d["scale_index"] not in seen:
            seen.add(d["scale_index"])
            cases.append(("kitti", zoom, seed))
    aug = []
    for name, config, seed in cases:
        batch = batches_[name]
        draws = augment.draw(config, 2, batch["left"].shape[1:3],
                             torch.Generator().manual_seed(seed))
        gpu = augment.apply(to_device(batch, "cuda"), draws, config)
        cpu = augment.apply(to_device(batch, "cpu"), draws, config)
        rescaled = (config.brightness > 0 or config.contrast > 0 or (
            config.scales and config.crop_size(draws["scale_index"],
                                               KITTI_FRAME) != config.crop_hw))
        row = {"dataset": name, "draws": {k: torch.as_tensor(v).tolist()
                                          for k, v in draws.items()}}
        for k, v in cpu.items():
            if not isinstance(v, torch.Tensor):
                continue
            diff = (gpu[k].cpu().double() - v.double()).abs()
            image = k in ("left", "right", "temporal")
            row[k] = {"max_abs_diff": diff.max().item(),
                      "share_differing": (diff > 0).double().mean().item()}
            limit = 1 if image and rescaled else 0
            if not diff.max().item() <= limit or tuple(
                    gpu[k].shape) != tuple(v.shape):
                errors.append(f"augment {name} seed {seed} {k}: "
                              f"{diff.max().item()} > {limit}")
        aug.append(row)
    ok = not errors
    emit({"phase": "data", "ok": ok, "card": card,
          "native_library": native_io.library(), "fixture_write_s": write_s,
          "decode": decode,
          "decode_timing": "host clock around one dataset[i] (every PNG of "
                           "the sample decoded and the ground truth decoded), "
                           "one thread",
          "preprocess_gpu_vs_cpu": prep, "preprocess_atol": PREPROCESS_ATOL,
          "augment_gpu_vs_cpu": aug, "errors": errors})
    if not ok:
        sys.exit(1)


def event_records(path):
    """The payloads of a TensorBoard event file, each record's length and
    payload CRCs checked (the TFRecord framing)."""
    import struct

    from cerberusnet_torch.utils.tblogger import _masked_crc

    with open(path, "rb") as f:
        data = f.read()
    out, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        payload = data[pos + 12:pos + 12 + n]
        if (struct.unpack("<I", data[pos + 8:pos + 12])[0]
                != _masked_crc(header) or struct.unpack(
                    "<I", data[pos + 12 + n:pos + 16 + n])[0]
                != _masked_crc(payload)):
            raise ValueError(f"{path}: bad CRC in the record at {pos}")
        out.append(payload)
        pos += 16 + n
    return out


def phase_train_seg_aspp(card):
    import contextlib
    import os
    import tempfile

    from cerberusnet_torch.data.loader import batches
    from cerberusnet_torch.entry import REPO_ROOT, make_frames
    from cerberusnet_torch.models.segmentation import SegNet
    from cerberusnet_torch.train import trainer as trainer_module
    from cerberusnet_torch.train.config import ExperimentConfig
    from cerberusnet_torch.train.trainer import Trainer
    from cerberusnet_torch.weights import init_params

    raw = json.loads((REPO_ROOT / SEG_ASPP_CONFIG).read_text())
    errors = []
    with tempfile.TemporaryDirectory() as ckpt_dir:
        raw["data"]["root"] = FIXTURES["cityscapes"]
        raw["train"].update(epochs=SEG_EPOCHS, ckpt_dir=ckpt_dir, log_every=1,
                            resume=False)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            tr = Trainer(ExperimentConfig.from_dict(raw))
        setup_s = time.perf_counter() - t0
        cfg = tr.config
        steps, load_s = [], {}
        real_step = timed_calls(tr, "train_step", steps)
        real_loader = timed_loader(load_s)
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            history = tr.fit()
        fit_s = time.perf_counter() - t0
        trainer_module.DataLoader = real_loader
        tr.train_step = real_step
        launches = launch_counts()
        if any(launches.values()):
            errors.append(f"hand kernels launched on the seg path: {launches}")
        n_steps = SEG_EPOCHS * (CITY_SAMPLES // cfg.data.batch_size)
        if len(history) != SEG_EPOCHS or tr.step != n_steps:
            errors.append(f"{len(history)} history rows, step {tr.step}")
        for row in history:
            vals = [row.get(k, math.nan) for k in ("loss_seg", "loss_total",
                                                   "miou")]
            if not all(map(math.isfinite, vals)):
                errors.append(f"epoch {row['epoch']}: {row}")
        # the event file reads back: its framing, and the scalars and
        # panels fit wrote
        (name,) = os.listdir(os.path.join(ckpt_dir, "tb"))
        records = event_records(os.path.join(ckpt_dir, "tb", name))
        tags = {t: sum(t.encode() in r for r in records)
                for t in ("loss/seg", "loss_seg", "miou", "eval/panel")}
        if tags != {"loss/seg": n_steps, "loss_seg": SEG_EPOCHS,
                    "miou": SEG_EPOCHS, "eval/panel": SEG_EPOCHS}:
            errors.append(f"event file tags {tags}")
        if not all(b"\x89PNG" in r for r in records if b"eval/panel" in r):
            errors.append("a panel record holds no PNG")

    # ms per train step on one batch (each call draws new augmentation),
    # as fit's loader hands it over (page-locked) and as a numpy batch
    # (pageable), in turns
    pinned = next(iter(tr._loader(tr.dataset, cfg.data.batch_size)))
    given = {"pinned": pinned,
             "pageable": batches(tr.dataset, cfg.data.batch_size, 1)[0]}
    step_ms = {k: [] for k in given}
    for which in ("pinned", "pageable") * (SEG_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(given[which])
        torch.cuda.synchronize()
        step_ms[which].append((time.perf_counter() - t0) * 1e3)
    del given, pinned
    peak = torch.cuda.max_memory_allocated() / 2**30
    del tr

    # the ASPP SegNet on the card against the CPU in float32
    outs = {}
    for device in ("cuda", "cpu"):
        model = init_params(SegNet(seg_head="aspp"),
                            torch.Generator().manual_seed(0)).to(device)
        with torch.no_grad():
            outs[device] = model(make_frames(1, SEG_PARITY_HW, device=device,
                                             dtype=torch.float32)[0])
    device_rel = rel_l2(outs["cuda"]["seg_logits"].cpu(),
                        outs["cpu"]["seg_logits"])
    if not device_rel <= SEG_DEVICE_RTOL:
        errors.append(f"card against CPU: rel L2 {device_rel} > "
                      f"{SEG_DEVICE_RTOL}")
    fit_ms = [dt * 1e3 for _, dt, _ in steps]
    ok = not errors
    emit({"phase": "train_seg_aspp", "ok": ok, "config": SEG_ASPP_CONFIG,
          "frame": list(CITY_FRAME), "crop_hw": list(cfg.data.crop_hw),
          "hw": list(cfg.data.hw), "batch": cfg.data.batch_size,
          "dtype": cfg.model.dtype, "ema_decay": cfg.optim.ema_decay,
          "history": history, "launches": launches, "event_tags": tags,
          "event_records": len(records), "setup_s": setup_s, "fit_s": fit_s,
          "ms_per_fit_step_all": fit_ms,
          "ms_per_step": {k: statistics.median(v[1:])
                          for k, v in step_ms.items()},
          "ms_per_step_all": step_ms,
          "load_s_per_batch": {k: statistics.median(v)
                               for k, v in load_s.items()},
          "load_s_all": load_s,
          "max_memory_allocated_gib": peak,
          "device_vs_cpu_f32": {"hw": list(SEG_PARITY_HW),
                                "rel_l2": device_rel,
                                "limit": SEG_DEVICE_RTOL},
          "timing": "host clock around train_step(batch) and a synchronize "
                    "(host batch in: upload, augmentation, preprocessing, "
                    "the optimizer and the EMA), median after the first; "
                    "the batch page-locked as the loader gives it, or numpy, "
                    "in turns",
          "card": card, "errors": errors})
    if not ok:
        sys.exit(1)
    return launches


def phase_fit_dcv_kitti(card):
    import contextlib
    import tempfile

    from collections import Counter

    from cerberusnet_torch.data.loader import batches
    from cerberusnet_torch.entry import REPO_ROOT
    from cerberusnet_torch.ops.cuda import correlation as cc
    from cerberusnet_torch.train import trainer as trainer_module
    from cerberusnet_torch.train.config import ExperimentConfig
    from cerberusnet_torch.train.trainer import Trainer

    raw = json.loads((REPO_ROOT / DCV_KITTI_CONFIG).read_text())
    errors = []
    if (tuple(raw["data"]["hw"]) != DCV_KITTI_HW
            or raw["data"]["batch_size"] != DCV_KITTI_BATCH):
        errors.append(f"{DCV_KITTI_CONFIG} is no longer {DCV_KITTI_HW} at "
                      f"batch {DCV_KITTI_BATCH}, the kernels phase's shapes")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        raw["data"]["root"] = FIXTURES["kitti"]
        raw["train"].update(epochs=FIT_EPOCHS, ckpt_dir=ckpt_dir,
                            resume=False)
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(sys.stderr):
            tr = Trainer(ExperimentConfig.from_dict(raw))
        bs = tr.config.data.batch_size
        steps, load_s = [], {}
        real_step = timed_calls(tr, "train_step", steps)
        real_loader = timed_loader(load_s)
        reset_launch_counts()
        cc.reset_design_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            history = tr.fit()
        fit_s = time.perf_counter() - t0
        launches = launch_counts()
        design = cc.launched_design()
        trainer_module.DataLoader = real_loader
        tr.train_step = real_step
    n_steps = FIT_EPOCHS * (KITTI_SAMPLES // bs)
    per_step = {k: len(DCV_FLOW_DILATIONS) if k.startswith("corr2d") else 0
                for k in launches}
    errors += [f"step {i}: kernel launches rose by {r}"
               for i, (r, _, _) in enumerate(steps) if r != per_step]
    if launches != {k: n_steps * v for k, v in per_step.items()}:
        errors.append(f"fit launched {launches}")
    if design != "tc":
        errors.append(f"the bf16 correlations ran on {design!r}, not tc")
    if len(history) != FIT_EPOCHS or tr.step != n_steps:
        errors.append(f"{len(history)} history rows, step {tr.step}")
    for row in history:
        if not all(map(math.isfinite, (row["loss_flow"], row["loss_total"]))):
            errors.append(f"epoch {row['epoch']}: {row}")

    # every correlation call of one more step against its plain version on
    # the same tensors
    calls = []
    real_corr = checked_corr_calls(calls)
    cc.reset_design_launches()
    tr.train_step(batches(tr.dataset, bs, 1)[0])
    call_design = cc.launched_design()
    restore_corr(real_corr)
    got_calls = dict(Counter(c["kernel"] for c in calls))
    want_calls = {k: v for k, v in per_step.items() if v}
    if got_calls != want_calls:
        errors.append(f"checked calls {got_calls}, not {want_calls}")
    if call_design != "tc":
        errors.append(f"the checked calls ran on {call_design!r}, not tc")
    errors += [f"{c['kernel']} at {c['shape']}: {c['err_of_limit']} of its "
               f"limit" for c in calls if not c["ok"]]
    step_ms = [dt * 1e3 for _, dt, _ in steps]
    ok = not errors
    emit({"phase": "fit_dcv_kitti", "ok": ok, "config": DCV_KITTI_CONFIG,
          "frame": list(KITTI_FRAME), "hw": list(tr.config.data.hw),
          "batch": bs, "dtype": tr.config.model.dtype,
          "num_workers": tr.config.data.num_workers, "epochs": FIT_EPOCHS,
          "samples": KITTI_SAMPLES, "history": history, "launches": launches,
          "launches_per_step": per_step, "design": design,
          "corr_calls_vs_plain": {
              "rule": f"|kernel - plain| <= 2^-7 |plain| + {FIT_CALL_SLACK}"
                      " plain(|a|, |f|)", "design": call_design,
              "calls": calls},
          "fit_s": fit_s, "ms_per_fit_step": statistics.median(step_ms[1:]),
          "ms_per_fit_step_all": step_ms,
          "load_s_per_batch": {k: statistics.median(v)
                               for k, v in load_s.items()},
          "load_s_all": load_s,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
          "timing": "host clock around train_step and a synchronize; the "
                    "loader's wait: host clock around the prefetching "
                    "DataLoader's next() in fit",
          "card": card, "errors": errors})
    if not ok:
        sys.exit(1)
    return launches


# phase: (entry variant, the entry's keywords, kernel launches per request,
# the outputs a request must have)
SERVE_SINGLE = {
    "serve_flow": ("flow", {}, {"corr2d_fwd": len(LEVELS)},
                   {"flow": (1, *HW, 2)}),
    "serve_stereo": ("stereo", {}, {"corr1d_fwd": len(LEVELS)},
                     {"disp": (1, *HW, 1)}),
    "serve_seg_aspp": ("seg", {"seg_head": "aspp"}, {},
                       {"seg_logits": (1, *HW, 19)}),
}


def phase_serve_single(phase, card):
    from cerberusnet_torch.entry import entry, make_frames

    variant, kw, per_request, want = SERVE_SINGLE[phase]
    errors = []
    forward, _ = entry(variant=variant, **kw)
    requests = [make_frames(seed, HW) for seed in range(1, N_REQUESTS + 1)]
    want_rise = {k: per_request.get(k, 0) for k in launch_counts()}
    reset_launch_counts()
    answers = []
    for i, req in enumerate(requests):
        out, rise = launch_rise(lambda: forward(*req))
        if rise != want_rise:
            errors.append(f"request {i}: kernel launches rose by {rise}")
        answers.append(out)
    launches = launch_counts()
    for i, out in enumerate(answers):
        for key, shape in want.items():
            v = out[key]
            if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
                errors.append(f"request {i}: {key} {tuple(v.shape)}")
    # the kernels (bf16) against the plain correlations in bf16 and in
    # float32 (the yardstick), as serve holds them; SegNet has no kernel,
    # so its bf16 distance from float32 is reported alone
    corr = variant != "seg"
    plain = {"plain_bf16": entry(variant=variant, corr_impl="plain", **kw)[0]
             } if corr else {}
    ref = entry(variant=variant, dtype=torch.float32,
                **({"corr_impl": "plain"} if corr else {}), **kw)[0]
    distances = []
    for i, req in enumerate(requests):
        want_f32 = ref(*req)
        for key in want:
            d = {"request": i, "head": key, "kernel_bf16_vs_f32": rel_l2(
                answers[i][key], want_f32[key].float())}
            if corr:
                d["plain_bf16_vs_f32"] = rel_l2(plain["plain_bf16"](*req)[key],
                                                want_f32[key].float())
                d["limit"] = 1.5 * d["plain_bf16_vs_f32"] + 1e-3
                if not d["kernel_bf16_vs_f32"] <= d["limit"]:
                    errors.append(f"request {i}: {key} {d}")
            distances.append(d)
    req = requests[0]
    fwds = {"kernel": forward, **plain}
    if corr:
        times = turns(fwds, lambda f: f(*req), runs=20, warmup=3)
    else:
        t = cuda_times(lambda: forward(*req), runs=20, warmup=3)
        times = {"kernel": {"ms": t["median"], "ms_min": t["min"],
                            "ms_max": t["max"], "runs": t["runs"]}}
    peak = peak_gib(lambda: forward(*req))
    ok = not errors
    emit({"phase": phase, "ok": ok, "variant": variant, **kw, "hw": list(HW),
          "dtype": "bfloat16", "requests": N_REQUESTS, "launches": launches,
          "distances": distances,
          "forward": {k: {**v, "frames_per_s": 1e3 / v["ms"]}
                      for k, v in times.items()},
          "max_memory_allocated_gib": peak, "card": card,
          "timing": "CUDA events around one eager forward after warmup, the "
                    "kernel and plain paths in turns", "errors": errors})
    if not ok:
        sys.exit(1)
    return launches


# The evaluation slice: the flow sets' fixtures at their published frame
# sizes, written from a seed; FlyingThings3D's steps at 384x768; TTA,
# tiling and prediction at the sizes users run them.
SINTEL_FRAME, SINTEL_SCENES, SINTEL_FRAMES = (436, 1024), 2, 4
CHAIRS_FRAME, CHAIRS_IDS, CHAIRS_VAL = (384, 512), 8, (3, 7)
THINGS_FRAME = (540, 960)
# one sequence whose consecutive pairs fill train_flyingthings3d's batches
THINGS_FRAMES = tuple(range(6, 7 + TRAIN_STEPS * TRAIN_BATCH))
# where FlyingThings3D's fixture holds ground truth the dataset must mask:
# flow (row, col, channel, value), disparity (row, col, value); the unused
# third flow channel's inf at THINGS_UNUSED_INF changes nothing
THINGS_BAD_FLOW = ((0, 0, 0, float("inf")), (0, 1, 1, float("nan")),
                   (1, 0, 0, 1000.0), (1, 1, 1, -1500.0))
THINGS_UNUSED_INF = (2, 2)
THINGS_BAD_DISP = ((0, 0, -4.0), (0, 1, float("inf")), (0, 2, 1000.0),
                   (0, 3, 0.0))
# train_losses: the three losses on the card against the CPU in float32 at
# a 512x1024 batch of 2 with 19 classes: values within AUX_VALUE_RTOL,
# gradients within AUX_GRAD_RTOL relative L2 (sums over 2^20 to 2^21 terms
# and the 9x9 solves run in another order on the card; TF32 off)
AUX_LOSS = {"rmi_weight": 0.5, "photometric_weight": 0.1,
            "smoothness_weight": 0.1}
AUX_VALUE_RTOL, AUX_GRAD_RTOL = 1e-4, 1e-3
AUX_STEPS = 2
# eval_tta: Trainer.evaluate_tta's defaults on CerberusNet at 512x1024
TTA_SCALES = (0.75, 1.0, 1.25)
TTA_SAMPLES = 2
# a KITTI-wide frame, where the reference's warp refuses scale 0.75
TTA_RAISES_HW = (384, 1280)
# predict: the share of labelIds the card's float32 SegNet may disagree on
# with the CPU's (an argmax of two near-equal logits flips)
LABEL_SHARE = 1e-3
SEG_CONFIG = "configs/seg_cityscapes.json"
# cli: the TorchCerberus checkpoint's widths, and the CLI's frame
CLI_MODEL = {"encoder_channels": [8, 12, 16, 16, 16, 16],
             "est_channels": [16, 16, 12], "ctx_channels": [16, 16],
             "fpn_channels": 16, "dtype": "float32"}
CLI_HW = (128, 256)
# the CLI's float32 forward on the card in a process of its own (cuDNN's
# default TF32 convolutions) against this process's with TF32 on again
CLI_RTOL = 1e-3
SUBMISSION_FILES = ["sample.npz", "flow/sample.png", "disp_0/sample.png",
                    "semantic/sample.png", "sample_panel.png"]


def write_flow_fixtures(root):
    """Sintel (436x1024, scenes of 4 frames, invalid masks), FlyingChairs
    (384x512 .ppm, 8 ids, CHAIRS_VAL flagged val in the split file) and
    FlyingThings3D (540x960, one sequence, .pfm flow and disparity with the
    bad values of THINGS_BAD_*) under ``root``, their frames and ground
    truth SyntheticPerceptionDataset's scenes. Returns {dataset: (its root,
    the samples its training split must give, in order)}."""
    import os

    import numpy as np

    from cerberusnet_torch.data import io as data_io
    from cerberusnet_torch.data.synthetic import SyntheticPerceptionDataset

    out = {}
    n = SINTEL_FRAMES
    ds = SyntheticPerceptionDataset(length=SINTEL_SCENES * n,
                                    hw=SINTEL_FRAME, seed=5)
    base = f"{root}/sintel/training"
    want = []
    for s in range(SINTEL_SCENES):
        scene = f"scene_{s}"
        for kind in ("clean", "flow", "invalid"):
            os.makedirs(f"{base}/{kind}/{scene}")
        frames = [ds[s * n + t] for t in range(n)]
        for t, smp in enumerate(frames, 1):
            data_io.write_image_u8(f"{base}/clean/{scene}/frame_{t:04d}.png",
                                   smp["left"])
            if t == n:
                continue
            data_io.write_flo(f"{base}/flow/{scene}/frame_{t:04d}.flo",
                              smp["flow_gt"])
            invalid = smp["seg_labels"] % 5 == 0  # some of the regions
            data_io.write_image_u8(
                f"{base}/invalid/{scene}/frame_{t:04d}.png",
                invalid.astype(np.uint8) * 255)
            want.append({"left": smp["left"], "temporal": frames[t]["left"],
                         "flow_gt": smp["flow_gt"],
                         "flow_valid": (~invalid).astype(np.float32)})
    out["sintel"] = (f"{root}/sintel", want)

    ds = SyntheticPerceptionDataset(length=CHAIRS_IDS, hw=CHAIRS_FRAME,
                                    seed=6)
    os.makedirs(f"{root}/chairs/data")
    want = []
    for i in range(1, CHAIRS_IDS + 1):
        smp = ds[i - 1]
        stem = f"{root}/chairs/data/{i:05d}"
        data_io.write_image_u8(stem + "_img1.ppm", smp["left"])
        data_io.write_image_u8(stem + "_img2.ppm", smp["temporal"])
        data_io.write_flo(stem + "_flow.flo", smp["flow_gt"])
        if i not in CHAIRS_VAL:
            want.append({"left": smp["left"], "temporal": smp["temporal"],
                         "flow_gt": smp["flow_gt"],
                         "flow_valid": np.ones(CHAIRS_FRAME, np.float32)})
    with open(f"{root}/chairs/FlyingChairs_train_val.txt", "w") as f:
        f.write("".join("2\n" if i in CHAIRS_VAL else "1\n"
                        for i in range(1, CHAIRS_IDS + 1)))
    out["flyingchairs"] = (f"{root}/chairs", want)

    ds = SyntheticPerceptionDataset(length=len(THINGS_FRAMES),
                                    hw=THINGS_FRAME, seed=7)
    things = f"{root}/things"
    dirs = {k: f"{things}/{sub}" for k, sub in (
        ("left", "frames_cleanpass/TRAIN/A/0000/left"),
        ("right", "frames_cleanpass/TRAIN/A/0000/right"),
        ("flow", "optical_flow/TRAIN/A/0000/into_future/left"),
        ("disp", "disparity/TRAIN/A/0000/left"))}
    for d in dirs.values():
        os.makedirs(d)
    samples = [ds[i] for i in range(len(THINGS_FRAMES))]
    for t, smp in zip(THINGS_FRAMES, samples):
        data_io.write_image_u8(f"{dirs['left']}/{t:04d}.png", smp["left"])
        data_io.write_image_u8(f"{dirs['right']}/{t:04d}.png", smp["right"])
        flow = np.concatenate([smp["flow_gt"], np.zeros(
            (*THINGS_FRAME, 1), np.float32)], -1)
        for y, x, ch, v in THINGS_BAD_FLOW:
            flow[y, x, ch] = v
        flow[THINGS_UNUSED_INF + (2,)] = np.inf
        data_io.write_pfm(
            f"{dirs['flow']}/OpticalFlowIntoFuture_{t:04d}_L.pfm", flow)
        disp = smp["disp_gt"].copy()
        for y, x, v in THINGS_BAD_DISP:
            disp[y, x] = v
        data_io.write_pfm(f"{dirs['disp']}/{t:04d}.pfm", disp)
    want = []
    for i, smp in enumerate(samples[:-1]):
        flow_valid = np.ones(THINGS_FRAME, np.float32)
        for y, x, _, _ in THINGS_BAD_FLOW:
            flow_valid[y, x] = 0
        disp_valid = (smp["disp_gt"] > 0).astype(np.float32)
        for y, x, _ in THINGS_BAD_DISP:
            disp_valid[y, x] = 0
        want.append({
            "left": smp["left"], "right": smp["right"],
            "temporal": samples[i + 1]["left"],
            "flow_gt": smp["flow_gt"] * flow_valid[..., None],
            "flow_valid": flow_valid,
            "disp_gt": smp["disp_gt"] * disp_valid,
            "disp_valid": disp_valid})
    out["flyingthings3d"] = (things, want)
    return out


def phase_flow_data(card, root):
    import numpy as np

    from cerberusnet_torch.data.flow_datasets import (
        FlyingChairsDataset,
        FlyingThings3DDataset,
        SintelDataset,
    )

    t0 = time.perf_counter()
    fixtures = write_flow_fixtures(root)
    write_s = time.perf_counter() - t0
    errors, decode = [], {}
    for name, cls in (("sintel", SintelDataset),
                      ("flyingchairs", FlyingChairsDataset),
                      ("flyingthings3d", FlyingThings3DDataset)):
        path, want = fixtures[name]
        FIXTURES[name] = path
        ds = cls(path, "training")
        if len(ds) != len(want):
            errors.append(f"{name}: {len(ds)} samples, not {len(want)}")
        ms = []
        for i, w in enumerate(want[:len(ds)]):
            t0 = time.perf_counter()
            s = ds[i]
            ms.append((time.perf_counter() - t0) * 1e3)
            if sorted(s) != sorted(w):
                errors.append(f"{name}[{i}]: keys {sorted(s)}")
                continue
            errors += [f"{name}[{i}]: {k} differs" for k in w
                       if s[k].dtype != w[k].dtype
                       or not np.array_equal(s[k], w[k])]
        decode[name] = {"samples": len(ds),
                        "frame": list(want[0]["left"].shape[:2]),
                        "ms_per_sample": statistics.median(ms), "ms_all": ms}
    ok = not errors
    emit({"phase": "flow_data", "ok": ok, "card": card,
          "fixture_write_s": write_s, "decode": decode,
          "decode_timing": "host clock around one dataset[i] (frames and "
                           "ground truth decoded), one thread",
          "errors": errors})
    if not ok:
        sys.exit(1)


def phase_train_losses(card):
    from cerberusnet_torch.entry import train_entry
    from cerberusnet_torch.train import losses as tl

    gen = torch.Generator().manual_seed(8)
    b, (h, w), c = TRAIN_BATCH, HW, 19

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen) * scale

    labels = torch.randint(0, c, (b, h, w), generator=gen)
    labels[torch.rand((b, h, w), generator=gen) < 0.1] = 255
    # loss: (its differentiated inputs, its other inputs)
    cases = {
        "rmi_loss": ({"logits": randn(b, h, w, c, scale=2.0)},
                     {"labels": labels}),
        "photometric_loss": ({"im1": randn(b, h, w, 3),
                              "im2": randn(b, h, w, 3),
                              "flow": randn(b, h, w, 2, scale=3.0)}, {}),
        "smoothness_loss": ({"field": randn(b, h, w, 2),
                             "image": randn(b, h, w, 3)}, {}),
    }
    errors, rows = [], []
    for name, (diff, fixed) in cases.items():
        fn = getattr(tl, name)
        res = {}
        for dev in ("cpu", "cuda"):
            xs = {k: v.to(dev).clone().requires_grad_()
                  for k, v in diff.items()}
            rest = {k: v.to(dev) for k, v in fixed.items()}
            value = fn(**xs, **rest)
            value.backward()
            res[dev] = (value.item(), {k: x.grad.cpu() for k, x in xs.items()})
        (cv, cg), (gv, gg) = res["cpu"], res["cuda"]
        row = {"loss": name, "value_cpu": cv, "value_cuda": gv,
               "value_rel_err": abs(gv - cv) / max(abs(cv), 1e-30),
               "grad_rel_l2": {k: rel_l2(gg[k], cg[k]) for k in cg}}
        t = cuda_times(lambda: fn(**xs, **rest).backward(), runs=10, warmup=2)
        row.update(ms_fwd_bwd=t["median"], ms_min=t["min"], ms_max=t["max"])
        rows.append(row)
        if not (math.isfinite(gv) and row["value_rel_err"] <= AUX_VALUE_RTOL):
            errors.append(f"{name}: {gv} on the card, {cv} on the CPU")
        errors += [f"{name} d{k}: rel L2 {v} > {AUX_GRAD_RTOL}"
                   for k, v in row["grad_rel_l2"].items()
                   if not v <= AUX_GRAD_RTOL]

    # bf16 steps of CerberusNet with the three terms, timed beside steps
    # without them on the same weights
    constant = {"schedule": "constant"}
    tr, batches = train_entry(batch_size=TRAIN_BATCH, n_batches=AUX_STEPS,
                              optim=constant, loss=AUX_LOSS)
    base, _ = train_entry(batch_size=TRAIN_BATCH, n_batches=0, optim=constant)
    base.load_masters(tr.masters)
    before = {n: m.clone() for n, m in tr.masters.items()}
    want_rise = {k: len(LEVELS) if k.startswith("corr") else 0
                 for k in launch_counts()}
    reset_launch_counts()
    steps = []
    for i, batch in enumerate(batches):
        comps, rise = launch_rise(lambda: tr.train_step(batch))
        vals = {k: v.item() for k, v in comps.items()}
        steps.append(vals)
        if rise != want_rise:
            errors.append(f"step {i}: kernel launches rose by {rise}")
        if sorted(vals) != ["disp", "flow", "photometric", "rmi", "seg",
                            "smoothness", "total"] or not all(
                                map(math.isfinite, vals.values())):
            errors.append(f"step {i}: loss components {vals}")
    launches = launch_counts()
    moved = sum(not torch.equal(m, before[n]) for n, m in tr.masters.items())
    if moved != len(before):
        errors.append(f"{len(before) - moved} of {len(before)} weights did "
                      f"not move in {AUX_STEPS} steps")
    step = turns({"with_aux_terms": tr, "without": base},
                 lambda t: t.train_step(batches[0]), runs=5, warmup=1)
    ok = not errors
    emit({"phase": "train_losses", "ok": ok, "hw": list(HW), "batch": b,
          "classes": c, "losses": rows, "value_rtol": AUX_VALUE_RTOL,
          "grad_rtol": AUX_GRAD_RTOL, "loss_weights": AUX_LOSS,
          "steps": steps, "launches": launches, "weights_moved": moved,
          "weights": len(before), "train_step": step, "card": card,
          "timing": "CUDA events around one loss's forward and backward, "
                    "and around one train_step(batch) (host batch in), the "
                    "two trainers in turns", "errors": errors})
    if not ok:
        sys.exit(1)
    return launches


def phase_eval_tta(card):
    from cerberusnet_torch.data.loader import batches as first_batches
    from cerberusnet_torch.data.loader import preprocess
    from cerberusnet_torch.entry import train_entry
    from cerberusnet_torch.eval import tta_forward

    errors = []
    data = {"synthetic_length": TTA_SAMPLES}
    tr, _ = train_entry(batch_size=1, n_batches=0, data=data)
    passes = 2 * len(TTA_SCALES)  # each scale and its mirror
    per_frame = {k: passes * len(LEVELS) if k in FORWARDS else 0
                 for k in launch_counts()}
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = tr.evaluate_tta(scales=TTA_SCALES, flip=True, per_class=True)
    eval_s = time.perf_counter() - t0
    launches = launch_counts()
    if launches != {k: TTA_SAMPLES * v for k, v in per_frame.items()}:
        errors.append(f"evaluate_tta launched {launches}")
    ious = [k for k in metrics if k.startswith("iou/")]
    if len(ious) != 19 or not all(math.isfinite(metrics[k]) for k in (
            "miou", "flow_epe", "disp_mae")):
        errors.append(f"metrics {metrics}")

    # one frame's TTA with the kernels against the plain correlations in
    # bf16 and in float32 (the yardstick), by serve's rule; every
    # correlation call held to its plain version
    plain16, _ = train_entry(batch_size=1, n_batches=0, corr_impl="plain",
                             data=data)
    plain32, _ = train_entry(batch_size=1, n_batches=0, corr_impl="plain",
                             model={"dtype": "float32"}, data=data)
    plain16.load_masters(tr.masters)
    plain32.load_masters(tr.masters)
    batch = first_batches(tr.dataset, 1, 1)[0]

    def inputs(dtype):
        prep = preprocess(batch, HW, dtype, "cuda")
        return {k: prep[k] for k in tr.input_keys}

    x16, x32 = inputs(torch.bfloat16), inputs(torch.float32)

    def tta(t, x):
        with torch.no_grad():
            return tta_forward(t._forward, x, scales=TTA_SCALES, flip=True)

    calls = []
    real_corr = checked_corr_calls(calls)
    try:
        got, rise = launch_rise(lambda: tta(tr, x16))
    finally:
        restore_corr(real_corr)
    checked = calls_summary(calls)
    errors += checked["errors"]
    if rise != per_frame or checked["calls"] != {
            k: v for k, v in per_frame.items() if v}:
        errors.append(f"one frame: launches {rise}, checked "
                      f"{checked['calls']}")
    ref, base = tta(plain32, x32), tta(plain16, x16)
    distances = []
    for key in ("seg_logits", "flow", "disp"):
        d = {"head": key, "shape": list(got[key].shape),
             "kernel_bf16_vs_f32": rel_l2(got[key], ref[key]),
             "plain_bf16_vs_f32": rel_l2(base[key], ref[key])}
        d["limit"] = 1.5 * d["plain_bf16_vs_f32"] + 1e-3
        distances.append(d)
        if not (tuple(got[key].shape[1:3]) == HW
                and d["kernel_bf16_vs_f32"] <= d["limit"]):
            errors.append(f"{key}: {d}")
    times = turns({"kernel": tr, "plain": plain16},
                  lambda t: tta(t, x16), runs=5, warmup=1)
    with torch.no_grad():
        one = cuda_times(lambda: tr._forward(x16), runs=10, warmup=2)

    # a KITTI-wide frame: the 0.75 scale's 288x960 breaks the warp
    wide = {k: torch.randn((1, *TTA_RAISES_HW, 3), device="cuda").to(
        torch.bfloat16) for k in tr.input_keys}
    try:
        with torch.no_grad():
            tta_forward(tr._forward, wide, scales=(0.75,))
    except ValueError as e:
        raises_at = {"hw": list(TTA_RAISES_HW), "scale": 0.75,
                     "error": str(e)}
    else:
        raises_at = None
        errors.append(f"TTA at scale 0.75 of {TTA_RAISES_HW} ran")
    ok = not errors
    emit({"phase": "eval_tta", "ok": ok, "hw": list(HW), "dtype": "bfloat16",
          "scales": list(TTA_SCALES), "flip": True,
          "frames_hw": [list(f) for f in TTA_FRAMES_HW],
          "samples": TTA_SAMPLES, "evaluate_tta_s": eval_s,
          "metrics": metrics, "launches": launches,
          "launches_per_frame": per_frame, "distances": distances,
          "corr_calls_vs_plain": checked, "tta_frame": times,
          "one_forward": {"ms": one["median"], "ms_min": one["min"],
                          "ms_max": one["max"]},
          "scale_raises": raises_at, "card": card,
          "timing": "CUDA events around one frame's tta_forward (6 forwards, "
                    "the resizes and the averaging), the kernel and plain "
                    "paths in turns; one_forward: one forward of the same "
                    "model with the kernels", "errors": errors})
    if not ok:
        sys.exit(1)
    return launches


def phase_tiled(card):
    from cerberusnet_torch.entry import FRAMES, entry, make_frames
    from cerberusnet_torch.eval import tiled_forward

    errors = []
    models = {"kernel": entry()[0], "plain_bf16": entry(corr_impl="plain")[0],
              "plain_f32": entry(dtype=torch.float32, corr_impl="plain")[0]}
    frame = dict(zip(FRAMES, make_frames(9, TILE_FRAME)))
    frame32 = {k: v.float() for k, v in frame.items()}

    def blend(which, batch_tiles=False):
        f = models[which]
        x = frame32 if which == "plain_f32" else frame
        return tiled_forward(lambda b: f(*[b[k] for k in FRAMES]), x,
                             TILE_HW, TILE_OVERLAP, batch_tiles=batch_tiles)

    want = {"sequential": N_TILES * len(LEVELS), "batched": len(LEVELS)}
    runs = {}
    for mode, batched in (("sequential", False), ("batched", True)):
        calls = []
        real_corr = checked_corr_calls(calls)
        try:
            out, rise = launch_rise(lambda: blend("kernel", batched))
        finally:
            restore_corr(real_corr)
        runs[mode] = {"out": out, "launches": rise,
                      "checked": calls_summary(calls)}
        errors += runs[mode]["checked"]["errors"]
        if rise != {k: want[mode] if k in FORWARDS else 0 for k in rise}:
            errors.append(f"{mode}: launches rose by {rise}")
    ref, base = blend("plain_f32"), blend("plain_bf16")
    seq, bat = runs["sequential"].pop("out"), runs["batched"].pop("out")
    distances = []
    for key in ("seg_logits", "flow", "disp"):
        d = {"head": key, "shape": list(seq[key].shape),
             "batched_vs_sequential": rel_l2(bat[key], seq[key]),
             "sequential_vs_f32": rel_l2(seq[key], ref[key]),
             "plain_bf16_vs_f32": rel_l2(base[key], ref[key])}
        # within bf16 rounding: the two blends no farther apart, and the
        # sequential one no farther from float32, than serve's rule allows
        # the plain bf16 blend
        d["limit"] = 1.5 * d["plain_bf16_vs_f32"] + 1e-3
        distances.append(d)
        if tuple(seq[key].shape[1:3]) != TILE_FRAME or not (
                d["batched_vs_sequential"] <= d["limit"]
                and d["sequential_vs_f32"] <= d["limit"]):
            errors.append(f"{key}: {d}")
    del seq, bat, ref, base
    timing = {}
    for mode, batched in (("sequential", False), ("batched", True)):
        t = cuda_times(lambda: blend("kernel", batched), runs=3, warmup=1)
        timing[mode] = {"ms_per_frame": t["median"], "ms_min": t["min"],
                        "ms_max": t["max"],
                        "max_memory_allocated_gib": peak_gib(
                            lambda: blend("kernel", batched))}
    ok = not errors
    emit({"phase": "tiled", "ok": ok, "frame": list(TILE_FRAME),
          "tile": list(TILE_HW), "overlap": TILE_OVERLAP, "tiles": N_TILES,
          "dtype": "bfloat16",
          "launches": {m: r["launches"] for m, r in runs.items()},
          "corr_calls_vs_plain": {m: r["checked"] for m, r in runs.items()},
          "distances": distances, "blend": timing, "card": card,
          "timing": "CUDA events around one tiled_forward of the frame; "
                    "peak memory over another", "errors": errors})
    if not ok:
        sys.exit(1)
    return {m: r["launches"] for m, r in runs.items()}


def decoded_files(out_dir):
    """{relative path: decoded file} of the submission files under
    ``out_dir``: (flow (H, W, 2), valid), (disparity, valid), (labelIds,)."""
    import os

    from cerberusnet_torch.data import encodings
    from cerberusnet_torch.data import io as data_io

    out = {}
    for sub in ("flow", "disp_0", "semantic"):
        d = os.path.join(out_dir, sub)
        for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
            path = os.path.join(d, name)
            if sub == "flow":
                v = encodings.decode_kitti_flow(data_io.read_png16(path))
            elif sub == "disp_0":
                v = encodings.decode_kitti_disparity(data_io.read_png16(path))
            else:
                v = (data_io.read_image_gray_u8(path),)
            out[f"{sub}/{name}"] = v
    return out


def files_against_cpu(files):
    """Each kernel-path file against the CPU's float32 plain prediction's:
    flow and disparity decoded, rel L2 within 1.5 x the card's plain bf16
    path's + 1e-3 (serve's rule; both paths' files hold the same 16-bit
    quantisation, the largest difference is reported in codes); labelIds
    differing on at most LABEL_SHARE of the pixels. Returns (rows,
    errors)."""
    import numpy as np

    rows, errors = [], []
    for rel, got in files["kernel"].items():
        want = files["cpu_f32"][rel]
        if rel.startswith("semantic"):
            row = {"file": rel, "label_share_differing": float(
                (got[0] != want[0]).mean())}
            ok = row["label_share_differing"] <= LABEL_SHARE
        else:
            rms = float(np.sqrt((want[0].astype(np.float64) ** 2).mean()))
            step = 1 / 64 if rel.startswith("flow") else 1 / 256

            def dist(a):
                return rel_l2(torch.from_numpy(a), torch.from_numpy(want[0]))

            row = {"file": rel, "kernel_vs_cpu_f32": dist(got[0]),
                   "plain_bf16_vs_cpu_f32": dist(files["plain_bf16"][rel][0]),
                   "rms_cpu": rms, "max_abs_diff_codes": float(
                       np.abs(got[0] - want[0]).max() / step)}
            row["limit"] = 1.5 * row["plain_bf16_vs_cpu_f32"] + 1e-3
            ok = row["kernel_vs_cpu_f32"] <= row["limit"] and got[1].all()
        rows.append(row)
        if not ok:
            errors.append(f"{rel}: {row}")
    return rows, errors


def phase_predict(card, root):
    import contextlib

    import numpy as np

    from cerberusnet_torch.entry import REPO_ROOT, train_entry
    from cerberusnet_torch.eval import submission
    from cerberusnet_torch.train.config import ExperimentConfig
    from cerberusnet_torch.train.trainer import Trainer
    from cerberusnet_torch.utils.visualization import read_png_u8

    errors, counts, rows = [], {}, {}
    # name: (config, fixture, its frame, the files' head directory)
    for name, config, fixture, frame, head in (
            ("dcv_flow_kitti", DCV_KITTI_CONFIG, "kitti", KITTI_FRAME,
             "flow"),
            ("seg_cityscapes", SEG_CONFIG, "cityscapes", CITY_FRAME,
             "semantic")):
        raw = json.loads((REPO_ROOT / config).read_text())
        raw["data"]["root"] = FIXTURES[fixture]
        raw["train"]["ckpt_dir"] = ""
        plain = {**raw, "model": {**raw["model"], "corr_impl": "plain"}}
        paths = {"kernel": (raw, "cuda"), "cpu_f32": (
            {**plain, "model": {**plain["model"], "dtype": "float32"}},
            "cpu")}
        if raw["model"]["variant"] != "seg":  # SegNet has no correlation
            paths["plain_bf16"] = (plain, "cuda")
        with contextlib.redirect_stdout(sys.stderr):
            trainers = {which: Trainer(ExperimentConfig.from_dict(r), device)
                        for which, (r, device) in paths.items()}
        masters = trainers["kernel"].masters
        for which, t in trainers.items():
            if which != "kernel":
                t.load_masters({n: m.to(t.device) for n, m in masters.items()})
        dirs = {which: f"{root}/predict/{name}/{which}" for which in trainers}
        calls = []
        real_corr = checked_corr_calls(calls)
        reset_launch_counts()
        try:
            t0 = time.perf_counter()
            made = trainers["kernel"].predict_to_dir(dirs["kernel"])
            predict_s = time.perf_counter() - t0
        finally:
            restore_corr(real_corr)
        counts[name] = launch_counts()
        checked = calls_summary(calls)
        errors += checked["errors"]
        for which, t in trainers.items():
            if which != "kernel":
                t.predict_to_dir(dirs[which])
        files = {which: decoded_files(d) for which, d in dirs.items()}
        n = len(trainers["kernel"].dataset)
        per_file, bad = files_against_cpu(files)
        errors += [f"{name} {e}" for e in bad]
        names = sorted(files["kernel"])
        if names != [f"{head}/{i:06d}_10.png" for i in range(n)] or len(
                made) != n or names != sorted(files["cpu_f32"]):
            errors.append(f"{name}: files {names[:3]}... for {n} samples")
        errors += [f"{name} {rel}: {v[0].shape}" for rel, v in
                   files["kernel"].items() if v[0].shape[:2] != frame]
        if head == "semantic":
            ids = np.unique(np.concatenate(
                [v[0].ravel() for v in files["kernel"].values()]))
            if not set(ids.tolist()) <= set(
                    submission.TRAINID_TO_LABELID.tolist()):
                errors.append(f"{name}: labelIds {ids}")
        batches_ = -(-n // trainers["kernel"].config.data.batch_size)
        want_launch = {k: len(DCV_FLOW_DILATIONS) * batches_
                       if head == "flow" and k == "corr2d_fwd" else 0
                       for k in counts[name]}
        if counts[name] != want_launch:
            errors.append(f"{name}: launches {counts[name]}")
        rows[name] = {"config": config, "samples": n, "native": list(frame),
                      "hw": list(trainers["kernel"].config.data.hw),
                      "files": len(made), "predict_s": predict_s,
                      "launches": counts[name],
                      "corr_calls_vs_plain": checked,
                      "files_vs_cpu": per_file}
        del trainers

    # predict_images: CerberusNet (the synthetic config, 512x1024) on three
    # of the KITTI fixture's frames
    tr, _ = train_entry(batch_size=1, n_batches=0)
    k = FIXTURES["kitti"] + "/training"
    paths = {"left": f"{k}/image_2/000000_10.png",
             "right": f"{k}/image_3/000000_10.png",
             "temporal": f"{k}/image_2/000000_11.png"}
    out_dir = f"{root}/predict/images"
    calls = []
    real_corr = checked_corr_calls(calls)
    reset_launch_counts()
    try:
        made = tr.predict_images(paths, out_dir)
    finally:
        restore_corr(real_corr)
    counts["predict_images"] = launch_counts()
    checked = calls_summary(calls)
    errors += checked["errors"]
    names = [p[len(out_dir) + 1:] for p in made]
    if names != SUBMISSION_FILES:
        errors.append(f"predict_images wrote {names}")
    arrays = np.load(made[0])
    shapes = {key: list(arrays[key].shape) for key in arrays.files}
    if shapes != {"seg_logits": [*HW, 19], "flow": [*HW, 2],
                  "disp": [*HW, 1]} or not all(
                      np.isfinite(arrays[key]).all() for key in arrays.files):
        errors.append(f"predict_images npz {shapes}")
    panel = read_png_u8(made[-1])
    if panel.shape[1] != HW[1]:
        errors.append(f"panel {panel.shape}")
    if counts["predict_images"] != {k: len(LEVELS) if k in FORWARDS else 0
                                    for k in counts["predict_images"]}:
        errors.append(f"predict_images launched {counts['predict_images']}")
    ok = not errors
    emit({"phase": "predict", "ok": ok, "predict_to_dir": rows,
          "label_share_limit": LABEL_SHARE,
          "predict_images": {"files": names, "npz_shapes": shapes,
                             "panel": list(panel.shape),
                             "launches": counts["predict_images"],
                             "corr_calls_vs_plain": checked},
          "timing": "host clock around predict_to_dir (decode, forward, "
                    "resize and PNG encode of every sample), the checked "
                    "calls' plain versions included", "card": card,
          "errors": errors})
    if not ok:
        sys.exit(1)
    return counts


# the CLI's export processes: their flags, and the artifact's inputs
CLI_EXPORTS = {"export": [], "export_int8": ["--quant", "int8"],
               "export_stacked": ["--export-stacked"]}
CLI_EXPORT_INPUTS = {"export": [[1, *CLI_HW, 3]] * 3,
                     "export_int8": [[1, *CLI_HW, 3]] * 3,
                     "export_stacked": [[3, *CLI_HW, 3]]}
# the float32 artifact of the CLI's process against this process's trainer
# forward on the same frames (TF32 off in both calls): the same operators
CLI_EXPORT_RTOL = 1e-5


def cli_exports(d, procs, cfg, errors):
    """What the CLI's export processes wrote: each artifact's files and
    inputs, and the float one called here against the forward of a trainer
    of the same config (the same seeded weights)."""
    import os

    from cerberusnet_torch.export import load_exported
    from cerberusnet_torch.train.config import ExperimentConfig
    from cerberusnet_torch.train.trainer import Trainer

    out = {}
    for name, inputs in CLI_EXPORT_INPUTS.items():
        art = f"{d}/{name}"
        if f"exported AOT artifact to {art}" not in procs[name]["stdout"]:
            errors.append(f"{name}: printed {procs[name]['stdout'][-300:]}")
            continue
        files = sorted(os.listdir(art))
        with open(f"{art}/manifest.json") as f:
            manifest = json.load(f)
        got = [i["shape"] for i in manifest["inputs"]]
        out[name] = {"files": files, "inputs": got,
                     "platforms": manifest["platforms"],
                     "bytes": os.path.getsize(f"{art}/model.pt2")}
        if files != ["manifest.json", "model.pt2"] or got != inputs:
            errors.append(f"{name}: files {files}, inputs {got}")
    if "export" in out:
        gen = torch.Generator().manual_seed(3)
        frames = [torch.rand((1, *CLI_HW, 3), generator=gen).cuda()
                  for _ in range(3)]
        trainer = Trainer(ExperimentConfig.from_json(cfg), device="cuda")
        with torch.no_grad():
            got = load_exported(f"{d}/export").module()(*frames)
            want = trainer.model.eval()(*frames)
        dist = frame_distances(got, want)
        out["export"]["vs_trainer_forward"] = dist
        if beyond(dist, CLI_EXPORT_RTOL):
            errors.append(f"CLI artifact against the trainer: {dist}")
    return out


def start_cli(root):
    """cli's first half, run after data (which writes the KITTI fixture):
    the checkpoint and config under ``root``/cli, and the five CLI
    processes started at once in the background at nice 19, so that they
    run beside the phases up to cli: (the directory, the model, the
    config, the PNGs, a future of each process's (name, args, rc, stdout,
    stderr, seconds))."""
    import os

    from cerberusnet_torch.entry import REPO_ROOT
    from cerberusnet_torch.models.cerberus import CerberusNet
    from cerberusnet_torch.weights import init_params, torch_cerberus_state_dict

    d = f"{root}/cli"
    os.makedirs(d)
    widths = {k: tuple(v) if isinstance(v, list) else v
              for k, v in CLI_MODEL.items() if k != "dtype"}
    model = init_params(CerberusNet(**widths),
                        torch.Generator().manual_seed(9))
    ckpt = f"{d}/torch_cerberus.pt"
    torch.save({"state_dict": torch_cerberus_state_dict(model)}, ckpt)
    cfg = f"{d}/cli.json"
    with open(cfg, "w") as f:
        json.dump({"name": "cli-smoke", "model": CLI_MODEL,
                   "data": {"hw": list(CLI_HW), "batch_size": TRAIN_BATCH,
                            "synthetic_length": 4, "num_workers": 2},
                   "optim": {"schedule": "constant"},
                   "train": {"log_every": 1000}}, f)
    k = FIXTURES["kitti"] + "/training"
    imgs = {"left": f"{k}/image_2/000000_10.png",
            "right": f"{k}/image_3/000000_10.png",
            "temporal": f"{k}/image_2/000000_11.png"}
    base = ["nice", "-n", "19", sys.executable, "-m", "cerberusnet_torch.cli",
            "--config", cfg, "--device", "cuda"]
    runs = (("infer", ["--import-torch", ckpt, "--infer",
                       ",".join(imgs.values()), "--infer-out", f"{d}/infer"]),
            ("profile", ["--profile", f"{d}/trace"]),
            *((name, ["--export-dir", f"{d}/{name}", *flags])
              for name, flags in CLI_EXPORTS.items()))

    def run(item):
        name, args = item
        t0 = time.perf_counter()
        p = subprocess.Popen(base + args, cwd=str(REPO_ROOT),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
        BACKGROUND.append(p)
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        return name, args, p.returncode, out, err, time.perf_counter() - t0

    # the five processes at once: they write apart, and each is mostly its
    # own host work (imports, tracing, export)
    pool = ThreadPoolExecutor(len(runs))
    futures = [pool.submit(run, item) for item in runs]
    pool.shutdown(wait=False)
    return d, model, cfg, imgs, futures


def phase_cli(card, started):
    """cli's second half: the checks of ``start_cli``'s processes."""
    import os

    import numpy as np

    from cerberusnet_torch.data import io as data_io
    from cerberusnet_torch.data.loader import preprocess

    errors = []
    d, model, cfg, imgs, futures = started
    procs = {}
    t0 = time.perf_counter()
    for future in futures:
        name, args, rc, out, err, seconds = future.result()
        procs[name] = {"args": args, "rc": rc, "s": seconds,
                       "stdout": out[-2000:], "stderr": err[-2000:]}
        if rc:
            errors.append(f"{name}: exit {rc}: {err[-500:]}")
    waited_s = time.perf_counter() - t0
    printed = [ln for ln in procs["infer"]["stdout"].splitlines()
               if ln.startswith(f"{d}/infer/")]
    files = [p[len(d) + len("/infer/"):] for p in printed]
    if files != SUBMISSION_FILES or not all(map(os.path.getsize, printed)):
        errors.append(f"--infer printed {files}")
    distances = {}
    if files == SUBMISSION_FILES:
        # the same weights in this process, TF32 on as in a fresh process
        frames = {key: data_io.read_image_u8(p)[None]
                  for key, p in imgs.items()}
        prep = preprocess(frames, CLI_HW, torch.float32, "cuda")
        model = model.cuda().eval()
        torch.backends.cudnn.allow_tf32 = True
        try:
            with torch.no_grad():
                want = model(*[prep[key] for key in imgs])
        finally:
            torch.backends.cudnn.allow_tf32 = False
        got = np.load(printed[0])
        for key in ("seg_logits", "flow", "disp"):
            distances[key] = rel_l2(torch.from_numpy(got[key]),
                                    want[key][0].float().cpu())
            if not distances[key] <= CLI_RTOL:
                errors.append(f"--infer {key}: rel L2 {distances[key]}")
    trace = f"{d}/trace/trace.json"
    kernels = {}
    if f"trace written to {trace}" not in procs["profile"]["stdout"]:
        errors.append(f"--profile printed {procs['profile']['stdout'][-300:]}")
    else:
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        for e in events:
            if e.get("cat") == "kernel":
                kernels[e["name"]] = kernels.get(e["name"], 0) + 1
        if not any("corr" in n for n in kernels):
            errors.append(f"the trace holds no correlation kernel: "
                          f"{sorted(kernels)[:20]}")
    exports = cli_exports(d, procs, cfg, errors)
    ok = not errors
    emit({"phase": "cli", "ok": ok, "processes": procs, "waited_s": waited_s,
          "infer_files": files, "infer_vs_in_process": distances,
          "exports": exports, "export_rtol": CLI_EXPORT_RTOL,
          "rtol": CLI_RTOL, "trace_kernel_names": len(kernels),
          "trace_corr_kernels": {n: c for n, c in kernels.items()
                                 if "corr" in n},
          "card": card, "errors": errors})
    if not ok:
        sys.exit(1)


# ------------------------------------------------------------ deployment
#
# The deployment slice's phases. export: CerberusNet (default widths, bf16,
# 512x1024, batch 1) through torch.export, saved, loaded here and in a
# fresh process that imports only torch and the operators, then the stacked,
# pallas_levels=3 and CerberusDCV artifacts; quant_int8: the int8 path;
# train_qat (a TRAIN phase): QAT steps, then an int8 export of the QAT
# weights; debug_nans: train.debug_nans.

HEADS = ("seg_logits", "flow", "disp")
# the artifact's signature at 512x1024, batch 1
EXPORT_INPUTS = [{"shape": [1, *HW, 3], "dtype": "bfloat16"}] * 3
EXPORT_OUTPUTS = [{"shape": [1, *HW, c], "dtype": "float32"}
                  for c in (19, 2, 1)]
# a call of each artifact: the operators it launches
EXPORT_LAUNCHES = {
    "cerberus": {"corr2d_fwd": len(LEVELS), "corr1d_fwd": len(LEVELS)},
    "stacked": {"corr2d_fwd": len(LEVELS), "corr1d_fwd": len(LEVELS)},
    "pallas_levels": {"corr2d_fwd": len(LEVELS), "corr1d_fwd": len(LEVELS),
                      "encoder_level_fwd": PALLAS_LEVELS},
    "cerberus_dcv": {"corr2d_fwd": len(DCV_FLOW_DILATIONS),
                     "corr1d_fwd": len(DCV_DISP_DILATIONS)},
    "int8": {"corr2d_fwd": len(LEVELS), "corr1d_fwd": len(LEVELS)},
}
# the cerberusnet_torch modules a process that loads an artifact imports
OPERATOR_MODULES = {"cerberusnet_torch", "cerberusnet_torch.ops",
                    "cerberusnet_torch.ops.build",
                    "cerberusnet_torch.ops.library",
                    "cerberusnet_torch.ops.cuda",
                    "cerberusnet_torch.ops.cuda.correlation",
                    "cerberusnet_torch.ops.cuda.encoder_level"}
FRESH_LOAD = r"""
import json, sys, time
import torch
import cerberusnet_torch.ops.library  # the kernels' operators
from cerberusnet_torch.ops.cuda import correlation as cc
from cerberusnet_torch.ops.cuda import encoder_level as cl
art, inputs, outputs = sys.argv[1:4]
# float32 convolutions in full float32, as the process that compares
torch.backends.cudnn.allow_tf32 = False
t0 = time.perf_counter()
program = torch.export.load(art + "/model.pt2").module()
load_s = time.perf_counter() - t0
frames = [f.cuda() for f in torch.load(inputs)]
cc.reset_launches()
cl.reset_launches()
with torch.no_grad():
    outs = program(*frames)
torch.cuda.synchronize()
torch.save([o.cpu() for o in outs], outputs)
print(json.dumps({"load_s": load_s, "launches": {**cc.launches(),
                                                  **cl.launches()},
                  "modules": sorted(m for m in sys.modules
                                    if m.startswith("cerberusnet_torch"))}))
"""
# int8 against its plain version (quantize, dequantize, a float32 conv),
# per head, relative L2: the bound derived in PERF.md (§6) before the
# first run; the control doubles one conv's scale_w, which must break it
INT8_SIM_BOUND = 1e-2
INT8_CONTROL_CONV = "encoder.blocks.6.conv"
# the reference's own limits of int8 against float32 (tests/test_quant.py),
# reported beside the card's distances
INT8_REF_LIMITS = {"seg_logits": 0.2, "flow": 0.35, "disp": 0.35}
CALIB_SEEDS = (11, 12)
# a loaded artifact against the eager forward (or quantized_apply) in this
# process, per head: the same operators on the same inputs, so bit-equal is
# expected and reported; held within 1e-2 relative L2, above what one
# operator rounding otherwise in bf16 moves a head and far below what a
# wrong or missing operator does (a zeroed cost volume moves a head by
# 0.1-1); the float artifacts are also held to the plain bf16 rule
ARTIFACT_RTOL = 1e-2


def seeded_model(variant="cerberus", dtype=torch.bfloat16, **kwargs):
    """entry()'s default-width model (seed 0) of ``variant``, in eval mode
    on the card."""
    from cerberusnet_torch.models.cerberus import CerberusNet
    from cerberusnet_torch.models.dcv_flow import CerberusDCV
    from cerberusnet_torch.weights import init_params

    cls = CerberusNet if variant == "cerberus" else CerberusDCV
    model = init_params(cls(dtype=dtype, **kwargs),
                        torch.Generator().manual_seed(0))
    return model.cuda().eval()


def held_operators(program):
    """{operator: calls} of the cerberus operators in a program's graph."""
    held = {}
    for node in program.graph.nodes:
        if str(node.target).startswith("cerberus."):
            op = str(node.target).split(".")[1]
            held[op] = held.get(op, 0) + 1
    return held


def export_and_load(model, example, out_dir):
    """(artifact dir, loaded program, export s, load s, manifest)."""
    from cerberusnet_torch.export import (
        export_inference,
        load_exported,
        save_exported,
    )
    from cerberusnet_torch.export.aot import DeployOutputs

    t0 = time.perf_counter()
    save_exported(export_inference(DeployOutputs(model), example), out_dir)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = load_exported(out_dir)
    load_s = time.perf_counter() - t0
    with open(f"{out_dir}/manifest.json") as f:
        manifest = json.load(f)
    return program, export_s, load_s, manifest


def frame_distances(got, want):
    """{head: relative L2 of got[i] to want[head]} over the three heads,
    and "bit_equal": whether every head is equal."""
    dist = {k: rel_l2(g, want[k].float()) for g, k in zip(got, HEADS)}
    dist["bit_equal"] = all(torch.equal(g, want[k])
                            for g, k in zip(got, HEADS))
    return dist


def beyond(dist, limit=ARTIFACT_RTOL):
    """The heads of ``frame_distances`` farther than ``limit``."""
    return {k: v for k, v in dist.items() if k in HEADS and not v <= limit}


def start_fresh_load(art, frames, d):
    """A fresh process that imports only torch and the operators, loads the
    artifact ``art`` and calls it on ``frames`` (FRESH_LOAD), started in the
    background: (the process, its start, the file of its outputs)."""
    from cerberusnet_torch.entry import REPO_ROOT

    inputs, outputs = f"{d}/frames.pt", f"{d}/fresh_out.pt"
    torch.save([f.cpu() for f in frames], inputs)
    t0 = time.perf_counter()
    p = subprocess.Popen([sys.executable, "-c", FRESH_LOAD, art, inputs,
                          outputs], cwd=str(REPO_ROOT),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    BACKGROUND.append(p)
    return p, t0, outputs


def phase_export(card, root):
    import os

    from cerberusnet_torch.entry import entry, make_frames

    errors = []
    d = f"{root}/export"
    os.makedirs(d)
    frames = make_frames(1, HW)
    model = seeded_model()
    with torch.no_grad():
        eager = model(*frames)
    runs = {}
    artifacts = {}
    for name, kwargs in (("cerberus", {}), ("stacked", {}),
                         ("pallas_levels", {"pallas_levels": PALLAS_LEVELS}),
                         ("cerberus_dcv", {})):
        m = (model if name in ("cerberus", "stacked") else
             seeded_model("cerberus_dcv" if name == "cerberus_dcv"
                          else "cerberus", **kwargs))
        m.stacked_input = name == "stacked"
        example = ((torch.cat(frames),) if name == "stacked" else frames)
        program, export_s, load_s, manifest = export_and_load(
            m, example, f"{d}/{name}")
        m.stacked_input = False
        module = program.module()
        with torch.no_grad():
            got, rise = launch_rise(lambda: module(*example))
            want = eager if m is model else m(*frames)
        rise = {k: v for k, v in rise.items() if v}
        held = held_operators(program)
        dist = frame_distances(got, want)
        if rise != EXPORT_LAUNCHES[name] or held != EXPORT_LAUNCHES[name]:
            errors.append(f"{name}: launches {rise}, operators {held}")
        if beyond(dist):
            errors.append(f"{name}: loaded against eager {dist}")
        inputs = ([{"shape": [3, *HW, 3], "dtype": "bfloat16"}]
                  if name == "stacked" else EXPORT_INPUTS)
        if manifest != {"platforms": ["cuda"], "inputs": inputs,
                        "outputs": EXPORT_OUTPUTS}:
            errors.append(f"{name}: manifest {manifest}")
        runs[name] = {"export_s": export_s, "load_s": load_s,
                      "launches_per_call": rise, "operators": held,
                      "loaded_vs_eager_rel_l2": dist,
                      "manifest_inputs": manifest["inputs"]}
        artifacts[name] = (module, got)
        if name == "cerberus":
            fresh_proc = start_fresh_load(f"{d}/cerberus", frames, d)
        else:
            del m
    # the stacked artifact answers as the separate-frame one
    stacked = frame_distances(artifacts["stacked"][1],
                              dict(zip(HEADS, artifacts["cerberus"][1])))
    if beyond(stacked):
        errors.append(f"stacked against separate frames: {stacked}")

    # the plain bf16 rule: the loaded program, the plain correlations in
    # bf16 and in float32 (the yardstick) on the same weights and frames
    plain16, _ = entry(corr_impl="plain")
    plain32, _ = entry(dtype=torch.float32, corr_impl="plain")
    ref, base = plain32(*frames), plain16(*frames)
    rule = {}
    for g, k in zip(artifacts["cerberus"][1], HEADS):
        d_art, d_plain = rel_l2(g, ref[k]), rel_l2(base[k], ref[k])
        rule[k] = {"loaded_bf16_vs_f32": d_art, "plain_bf16_vs_f32": d_plain,
                   "limit": 1.5 * d_plain + 1e-3}
        if not d_art <= rule[k]["limit"]:
            errors.append(f"loaded {k}: rel L2 {d_art} > {rule[k]['limit']}")
    del plain16, plain32, ref, base

    # the fresh process, started after the first artifact was saved
    p, t0, outputs = fresh_proc
    try:
        stdout, stderr = p.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        p.kill()
        stdout, stderr = p.communicate()
    fresh = {"rc": p.returncode, "s": time.perf_counter() - t0,
             "stderr": stderr[-1500:]}
    if p.returncode:
        errors.append(f"fresh process: exit {p.returncode}: "
                      f"{stderr[-500:]}")
    else:
        report = json.loads(stdout.strip().splitlines()[-1])
        fresh.update(report)
        got = [t.cuda() for t in torch.load(outputs)]
        fresh["vs_eager_rel_l2"] = frame_distances(got, eager)
        launched = {k: v for k, v in report["launches"].items() if v}
        if launched != EXPORT_LAUNCHES["cerberus"]:
            errors.append(f"fresh process launched {launched}")
        if beyond(fresh["vs_eager_rel_l2"]):
            errors.append(f"fresh process: {fresh['vs_eager_rel_l2']}")
        if not set(report["modules"]) <= OPERATOR_MODULES:
            errors.append(f"fresh process imported {report['modules']}")

    # ms per frame: the loaded program and the eager forward in turns
    module = artifacts["cerberus"][0]
    with torch.no_grad():
        times = turns({"eager": model, "loaded": module},
                      lambda f: f(*frames), runs=20, warmup=3)
    ok = not errors
    emit({"phase": "export", "ok": ok, "hw": list(HW), "batch": 1,
          "dtype": "bfloat16", "artifacts": runs,
          "stacked_vs_separate_rel_l2": stacked, "plain_bf16_rule": rule,
          "fresh_process": fresh, "ms_per_frame": times,
          "timing": "CUDA events around one call of the loaded program or "
                    "the eager forward, in turns; export_s: torch.export "
                    "and save, load_s: torch.export.load",
          "card": card, "errors": errors})
    if not ok:
        sys.exit(1)
    return {name: run["launches_per_call"] for name, run in runs.items()}


def phase_quant_int8(card, root):
    import os

    from cerberusnet_torch.entry import entry, make_frames
    from cerberusnet_torch.quant import calibrate, quantize, quantized_apply
    from cerberusnet_torch.quant import ptq

    errors = []
    # the reference's int8 rebuild: naive estimators, whose convs the
    # calibration and the interception see
    model = seeded_model(fused=False)
    kernels = {n[:-len(".weight")]: p.detach() for n, p in
               seeded_model(dtype=torch.float32).named_parameters()
               if n.endswith(".weight")}
    float32, _ = entry(dtype=torch.float32)
    frames = make_frames(1, HW)
    with torch.no_grad():
        bf16_out = model(*frames)
        f32_out = float32(*frames)
    del float32
    t0 = time.perf_counter()
    scales = calibrate(model, [make_frames(s, HW) for s in CALIB_SEEDS])
    calib_s = time.perf_counter() - t0
    before = torch.cuda.memory_allocated()
    float_bytes = sum(model.get_submodule(n).weight.nbytes for n in scales)
    quantize(model, scales, strip=True, weights=kernels)
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    del kernels
    names = ptq.quantized_convs(model)
    n_convs = len(ptq._convs(model))
    if len(names) != n_convs:
        errors.append(f"{len(names)} of the naive model's {n_convs} convs "
                      f"quantized")

    # im2col of each int8 conv in one forward: its int8 bytes
    cols = []
    real = ptq.int8_conv2d

    def recorded(x, kq, stride, padding, dilation):
        out = real(x, kq, stride, padding, dilation)
        k = kq.shape[1] * kq.shape[2] * kq.shape[3]
        cols.append({"rows": out.shape[0] * out.shape[2] * out.shape[3],
                     "taps": k, "bytes": out.shape[0] * out.shape[2]
                     * out.shape[3] * (-(-k // 8) * 8)})
        return out

    ptq.int8_conv2d = recorded
    try:
        with torch.no_grad():
            out, rise = launch_rise(lambda: quantized_apply(model, *frames))
    finally:
        ptq.int8_conv2d = real
    rise = {k: v for k, v in rise.items() if v}
    if rise != EXPORT_LAUNCHES["cerberus"]:
        errors.append(f"int8 forward launched {rise}")
    if len(cols) != len(names):
        errors.append(f"{len(cols)} int8 convs ran, {len(names)} quantized")
    with torch.no_grad():
        sim = quantized_apply(model, *frames, simulate=True)
    vs_sim = {k: rel_l2(out[k], sim[k].float()) for k in HEADS}
    errors += [f"int8 {k} against simulate: {v} > {INT8_SIM_BOUND}"
               for k, v in vs_sim.items() if not v <= INT8_SIM_BOUND]
    # the control: one conv's weight scale doubled must break the bound
    conv = model.get_submodule(INT8_CONTROL_CONV)
    conv.scale_w.mul_(2)
    try:
        with torch.no_grad():
            bad = quantized_apply(model, *frames)
    finally:
        conv.scale_w.div_(2)
    control = {k: rel_l2(bad[k], sim[k].float()) for k in HEADS}
    if all(v <= INT8_SIM_BOUND for v in control.values()):
        errors.append(f"doubled scale_w of {INT8_CONTROL_CONV} stays within "
                      f"the bound: {control}")
    vs_f32 = {k: rel_l2(out[k], f32_out[k]) for k in HEADS}
    bf16_vs_f32 = {k: rel_l2(bf16_out[k], f32_out[k]) for k in HEADS}
    if not all(torch.isfinite(out[k]).all() for k in HEADS):
        errors.append("int8 outputs not finite")

    # ms per frame and peak memory, int8 and bf16 in turns
    bf16 = seeded_model()

    def int8(*f):
        return quantized_apply(model, *f)

    with torch.no_grad():
        times = turns({"bf16": bf16, "int8": int8}, lambda f: f(*frames),
                      runs=20, warmup=3)
        peaks = {"int8": peak_gib(lambda: int8(*frames)),
                 "bf16": peak_gib(lambda: bf16(*frames))}
    del bf16

    # the int8 artifact: exported under quant_interception, loaded back
    with ptq.quant_interception(model):
        program, export_s, load_s, manifest = export_and_load(
            model, frames, f"{root}/int8")
    with torch.no_grad():
        got, art_rise = launch_rise(lambda: program.module()(*frames))
    art_rise = {k: v for k, v in art_rise.items() if v}
    round_trip = frame_distances(got, out)
    if beyond(round_trip):
        errors.append(f"int8 artifact against quantized_apply: {round_trip}")
    if art_rise != EXPORT_LAUNCHES["cerberus"]:
        errors.append(f"int8 artifact launched {art_rise}")
    int_mm = sum(1 for n in program.graph.nodes
                 if "_int_mm" in str(n.target))
    if int_mm != len(names):
        errors.append(f"int8 artifact holds {int_mm} int8 products, "
                      f"{len(names)} quantized convs")
    ok = not errors
    widest = max(cols, key=lambda c: c["bytes"]) if cols else None
    emit({"phase": "quant_int8", "ok": ok, "hw": list(HW), "batch": 1,
          "compute_dtype": "bfloat16", "quantized_convs": len(names),
          "calibration_batches": len(CALIB_SEEDS), "calibrate_s": calib_s,
          "float_weight_bytes_stripped": float_bytes,
          "memory_freed_by_quantize": freed,
          "launches_per_frame": rise, "int8_vs_simulate_rel_l2": vs_sim,
          "bound": INT8_SIM_BOUND,
          "control": {"conv": INT8_CONTROL_CONV, "scale_w": "doubled",
                      "int8_vs_simulate_rel_l2": control},
          "int8_vs_f32_rel_l2": vs_f32, "reference_limits": INT8_REF_LIMITS,
          "within_reference_limits": all(
              vs_f32[k] <= v for k, v in INT8_REF_LIMITS.items()),
          "bf16_vs_f32_rel_l2": bf16_vs_f32, "ms_per_frame": times,
          "peak_gib": peaks, "im2col_widest": widest,
          "im2col_bytes_per_frame": sum(c["bytes"] for c in cols),
          "artifact": {"export_s": export_s, "load_s": load_s,
                       "launches_per_call": art_rise, "int_mm_nodes": int_mm,
                       "vs_quantized_apply_rel_l2": round_trip,
                       "manifest": manifest},
          "timing": "CUDA events around one forward (quantized_apply for "
                    "int8), the two in turns",
          "card": card, "errors": errors})
    if not ok:
        sys.exit(1)
    return {"quant_int8": rise}


def qat_int8_export(trainer, root):
    """Trainer.export(quant="int8") after QAT (qat.finalize with the
    trained ranges): the artifact's call against quantized_apply of the
    trainer's int8 model on the same frame, and its launches."""
    from cerberusnet_torch.entry import make_frames
    from cerberusnet_torch.export import load_exported
    from cerberusnet_torch.quant import quantized_apply

    frames = make_frames(21, HW)
    t0 = time.perf_counter()
    out_dir = trainer.export(f"{root}/qat_int8", quant="int8")
    export_s = time.perf_counter() - t0
    module = load_exported(out_dir).module()
    with torch.no_grad():
        got, rise = launch_rise(lambda: module(*frames))
        want = quantized_apply(trainer.deploy_model("int8"), *frames)
    rise = {k: v for k, v in rise.items() if v}
    dist = frame_distances(got, want)
    errors = []
    if rise != EXPORT_LAUNCHES["cerberus"]:
        errors.append(f"QAT int8 artifact launched {rise}")
    if beyond(dist):
        errors.append(f"QAT int8 artifact against quantized_apply: {dist}")
    return {"export_s": export_s, "launches_per_call": rise,
            "vs_quantized_apply_rel_l2": dist}, errors


DEBUG_NANS_PIXEL = (0, 100, 200, 1)


def phase_debug_nans(card):
    import numpy as np

    from cerberusnet_torch.entry import train_entry
    from cerberusnet_torch.train.debug_nans import DebugNans

    errors = []
    constant = {"schedule": "constant"}
    trainer, (batch,) = train_entry(
        "configs/cerberus_synthetic.json", batch_size=TRAIN_BATCH,
        optim=constant, train={"debug_nans": True})
    bad = dict(batch, left=batch["left"].astype(np.float32))
    bad["left"][DEBUG_NANS_PIXEL] = np.nan
    before = {n: m.clone() for n, m in trainer.masters.items()}
    raised = None
    try:
        trainer.train_step(bad)
    except FloatingPointError as e:
        raised = str(e)
    if raised is None or "encountered in" not in raised:
        errors.append(f"a NaN pixel raised {raised!r}")
    if any(not torch.equal(m, before[n]) for n, m in trainer.masters.items()):
        errors.append("the failed step moved a master")
    clean = {k: v.item() for k, v in trainer.train_step(batch).items()}
    if not all(map(math.isfinite, clean.values())):
        errors.append(f"clean step: {clean}")
    # an inf is not a NaN: the stem block on a frame with one inf pixel
    # sums one inf term into each output, which holds infs and no NaN
    x = torch.rand(1, 3, *HW, device="cuda", dtype=trainer.dtype)
    x[0, 1, 100, 200] = float("inf")
    inf_raised = None
    try:
        with torch.no_grad(), DebugNans():
            y = trainer.model.encoder.blocks[0](
                x.contiguous(memory_format=torch.channels_last))
        inf_out = {"inf": bool(torch.isinf(y).any()),
                   "nan": bool(torch.isnan(y).any())}
    except FloatingPointError as e:
        inf_raised, inf_out = str(e), None
    if inf_raised or not inf_out["inf"] or inf_out["nan"]:
        errors.append(f"inf input: raised {inf_raised!r}, {inf_out}")
    # ms per step with the mode and without, in turns, the same masters
    plain_tr, _ = train_entry("configs/cerberus_synthetic.json",
                              batch_size=TRAIN_BATCH, n_batches=0,
                              optim=constant)
    plain_tr.load_masters(trainer.masters)
    times = turns({"off": plain_tr, "on": trainer},
                  lambda tr: tr.train_step(batch), runs=3, warmup=1)
    ok = not errors
    emit({"phase": "debug_nans", "ok": ok, "hw": list(HW),
          "batch": TRAIN_BATCH, "nan_pixel": list(DEBUG_NANS_PIXEL),
          "raised": raised, "clean_step": clean,
          "inf_input": {"raised": inf_raised, "output": inf_out},
          "ms_per_step": times,
          "timing": "CUDA events around one train_step, the mode on and "
                    "off in turns", "card": card, "errors": errors})
    if not ok:
        sys.exit(1)


# The C++ runner (runner): the artifacts of the export phase, compiled with
# AOTInductor and run by cerberus_runner; the operators its library defines
RUNNER_OPERATORS = ("corr2d_fwd", "corr1d_fwd", "encoder_level_fwd")
RUNNER_ITERS = 20
# timed calls of the runner on the smaller artifacts (DCV, pallas_levels)
RUNNER_ITERS_SHORT = 5
RUNNER_ARTIFACTS = ("cerberus", "stacked", "pallas_levels", "cerberus_dcv",
                    "int8")
# the int8 package's distance from the float32 eager forward within this
# multiple of quantized_apply's own (+ 1e-3): the plain bf16 rule's shape.
# Both are int8 quantizations of one model; a wrong scale or product moves
# a head 0.14-0.84 (quant_int8's control)
INT8_PACKAGE_SLACK = 1.5


def runner_launches(run, name):
    """{kernel: launches per call} from a runner's JSON line; errors of
    counts that are not whole calls of EXPORT_LAUNCHES[name]."""
    per_call = {k: v / run["calls"] for k, v in run["launches"].items()}
    want = {k: EXPORT_LAUNCHES[name].get(k, 0) for k in RUNNER_OPERATORS}
    errors = [] if per_call == want else [
        f"{name}: the runner's launches {run['launches']} over "
        f"{run['calls']} calls, want {want} a call"]
    return {k: int(v) for k, v in per_call.items() if v}, errors


def held(report, what, errors):
    """A runner_io comparison, held bit-equal: both sides run one compiled
    package on the same kernel libraries, so any difference is a fault of
    a C++ operator (the relative L2 of each output is reported)."""
    if not (report["ok"] and report["bit_equal"]):
        errors.append(f"{what}: {report['outputs']}")


class _TinyFrames(torch.nn.Module):
    """The deployment signature on three small frames, no weights: the CPU
    artifact of the refusal."""

    def forward(self, a, b, c):
        return {"seg_logits": a.float() * 2, "flow": b.float(),
                "disp": c.float()}


def runner_artifact(root, name):
    """The directory of a runner artifact: the export phase's, or
    quant_int8's int8 one."""
    return f"{root}/int8" if name == "int8" else f"{root}/export/{name}"


def int8_model():
    """quant_int8's int8 CerberusNet: seed 0's model with naive
    estimators (``fused=False``) calibrated on the CALIB_SEEDS frames and
    quantized from its float32 weights, stripped."""
    from cerberusnet_torch.entry import make_frames
    from cerberusnet_torch.quant import calibrate, quantize

    model = seeded_model(fused=False)
    kernels = {n[:-len(".weight")]: p.detach() for n, p in
               seeded_model(dtype=torch.float32).named_parameters()
               if n.endswith(".weight")}
    scales = calibrate(model, [make_frames(s, HW) for s in CALIB_SEEDS])
    return quantize(model, scales, strip=True, weights=kernels)


def runner_exports(root, names):
    """The named runner artifacts, the export phase's and quant_int8's
    (exported here where those phases did not run): {name: (dir, export s
    or None)}."""
    import os

    from cerberusnet_torch.export.aot import (
        DeployOutputs,
        export_inference,
        save_exported,
    )
    from cerberusnet_torch.quant import ptq

    out = {}
    for name in names:
        art = runner_artifact(root, name)
        export_s = None
        if name == "int8" and not os.path.exists(f"{art}/model.pt2"):
            model = int8_model()
            example = tuple(torch.zeros((1, *HW, 3), dtype=torch.bfloat16,
                                        device="cuda") for _ in range(3))
            t0 = time.perf_counter()
            with ptq.quant_interception(model):
                save_exported(export_inference(DeployOutputs(model), example),
                              art)
            export_s = time.perf_counter() - t0
            del model
        elif not os.path.exists(f"{art}/model.pt2"):
            kwargs = ({"pallas_levels": PALLAS_LEVELS}
                      if name == "pallas_levels" else {})
            m = seeded_model("cerberus_dcv" if name == "cerberus_dcv"
                             else "cerberus", **kwargs)
            m.stacked_input = name == "stacked"
            shapes = [(3, *HW, 3)] if name == "stacked" else [(1, *HW, 3)] * 3
            example = tuple(torch.zeros(s, dtype=torch.bfloat16,
                                        device="cuda") for s in shapes)
            t0 = time.perf_counter()
            save_exported(export_inference(DeployOutputs(m), example), art)
            export_s = time.perf_counter() - t0
            del m
        out[name] = (art, export_s)
    return out


def runner_cpu_export(root):
    """A small CPU export, which is not packaged: the runner refuses it
    from its manifest before it opens a package."""
    from cerberusnet_torch.export.aot import (
        DeployOutputs,
        export_inference,
        save_exported,
    )

    cpu = f"{root}/runner_cpu"
    example = tuple(torch.zeros((1, 8, 8, 3), dtype=torch.bfloat16)
                    for _ in range(3))
    save_exported(export_inference(DeployOutputs(_TinyFrames()), example), cpu)
    return cpu


def package_all(dirs):
    """The artifacts compiled with AOTInductor one after the other in one
    process at the lowest CPU priority (nice 19: the phases that run
    meanwhile keep the host), so that each reuses the kernels that the ones
    before it compiled: {name: seconds of its own compile}; fails the phase
    if the process fails."""
    from cerberusnet_torch.entry import REPO_ROOT

    p = subprocess.Popen(["nice", "-n", "19", sys.executable, "-m",
                          "cerberusnet_torch.export.runner_io", "package",
                          *dirs.values()], cwd=str(REPO_ROOT),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    BACKGROUND.append(p)
    try:
        out, err = p.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    if p.returncode or len(lines) != len(dirs):
        fail("runner", f"AOTInductor packaging of {list(dirs)} failed "
                       f"(rc {p.returncode}): {err[-2000:]}")
    return {n: line["seconds"] for n, line in zip(dirs, lines)}


# the processes started in the background (the compiles, cli's, export's
# fresh process), stopped where they still run when the script ends, and
# the runner's two g++ builds, started with the first compiles
BACKGROUND = []
RUNNER_BUILD = []


def start_packaging(root, names):
    """Exports the named runner artifacts where they are missing and starts
    their compiles (``package_all``) and, the first time, the runner's g++
    builds in the background: (exports, a future of {name: package s},
    the start)."""
    from cerberusnet_torch.export import runner as runner_build

    exports = runner_exports(root, names)
    start = time.perf_counter()
    pool = ThreadPoolExecutor(1 if RUNNER_BUILD else 3)
    future = pool.submit(package_all, {n: d for n, (d, _) in exports.items()})
    if not RUNNER_BUILD:
        RUNNER_BUILD.extend([pool.submit(runner_build.build_runner),
                             pool.submit(runner_build.build_ops)])
    pool.shutdown(wait=False)
    return exports, future, start


def stop_background():
    for p in BACKGROUND:
        if p.poll() is None:
            p.kill()
            p.wait()


def runner_refusals(runner, art, cpu_dir):
    """The runner's refusals: the CerberusNet package without the operator
    library (the load names the missing operator) and the CPU export with
    --device cuda (the manifest's platform). {case: {rc, stderr}},
    errors."""
    cases = {"no_ops": ([runner, "--model", art], ("cerberus::corr2d_fwd",
                                                   "cerberus::corr1d_fwd")),
             "cpu_package_on_cuda": ([runner, "--model", cpu_dir, "--device",
                                      "cuda"], ("compiled for [cpu]",))}
    out, errors = {}, []
    for case, (cmd, causes) in cases.items():
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        out[case] = {"rc": p.returncode, "stderr": p.stderr[:600]}
        if p.returncode == 0 or not any(c in p.stderr for c in causes):
            errors.append(f"refusal {case}: exit {p.returncode}, "
                          f"{p.stderr[:400]}")
    return out, errors


def phase_runner(card, root, batches=()):
    """``batches``: ``start_packaging``'s, started by earlier phases; the
    artifacts none of them started are exported and packaged here."""
    from cerberusnet_torch.entry import entry
    from cerberusnet_torch.export import runner_io

    errors = []
    t_phase = time.perf_counter()
    started = {n for exports, _, _ in batches for n in exports}
    rest = [n for n in RUNNER_ARTIFACTS if n not in started]
    batches = [*batches, *([start_packaging(root, rest)] if rest else [])]
    cpu_export = runner_cpu_export(root)
    # both g++ runs, started with the first compiles
    (runner, runner_s), (ops, ops_s) = [f.result() for f in RUNNER_BUILD]
    ldd = {}
    for path in (runner, ops):
        p = subprocess.run(["ldd", str(path)], capture_output=True, text=True)
        ldd[path.name] = p.stdout.split("\n")
        if p.returncode or "libpython" in p.stdout:
            errors.append(f"ldd {path.name}: rc {p.returncode}, "
                          f"{p.stdout[-800:]}")
    emit({"phase": "runner_build", "ok": not errors, "runner": runner.name,
          "runner_g++_s": runner_s, "ops": ops.name, "ops_g++_s": ops_s,
          "ldd": ldd, "errors": errors})
    if errors:
        sys.exit(1)
    exports, package_s = {}, {}
    for batch_exports, future, _ in batches:
        exports.update(batch_exports)
        package_s.update(future.result())
    # from the first compile's start to the last's end, and the part of it
    # this phase waited
    packaging_s = time.perf_counter() - min(t for _, _, t in batches)
    packaging_wait_s = time.perf_counter() - t_phase
    runs, counts, packages = {}, {}, {}
    for name in RUNNER_ARTIFACTS:
        art, export_s = exports[name]
        t0 = time.perf_counter()
        package = packages[name] = runner_io.load_package(art)
        load_s = time.perf_counter() - t0
        # a Python call of the package: its operators are ops/library.py's
        specs = runner_io.manifest(art)["inputs"]
        frames = [t.to(torch.bfloat16).cuda()
                  for t in runner_io.random_inputs(specs, 0)]
        with torch.no_grad():
            _, rise = launch_rise(lambda: package(*frames))
        rise = {k: v for k, v in rise.items() if v}
        if rise != EXPORT_LAUNCHES[name]:
            errors.append(f"{name}: the Python-loaded package launched "
                          f"{rise}, want {EXPORT_LAUNCHES[name]}")
        iters = RUNNER_ITERS if name == "cerberus" else RUNNER_ITERS_SHORT
        report = runner_io.verify(art, runner, ops, "cuda", seed=0,
                                  iters=iters, package=package)
        held(report, f"{name}: runner against the Python-loaded package",
             errors)
        per_call, errs = runner_launches(report["runner"], name)
        errors += errs
        counts[f"runner_{name}"] = per_call
        runs[name] = {"export_s": export_s, "package_s": package_s[name],
                      "python_load_s": load_s,
                      "python_launches_per_call": rise,
                      "runner": report["runner"],
                      "runner_launches_per_call": per_call,
                      "vs_python_package": report}

    # int8: the package against quantized_apply of the same int8 model on
    # the runner's inputs (bit equality reported: Inductor's fused bf16
    # arithmetic moves a value by an ulp where eager's does not, and a
    # conv's quantization can turn that into a whole int8 step), held by
    # the int8 rule against the float32 eager forward; one --serve request
    # (and its PNG request)
    from cerberusnet_torch.quant import quantized_apply

    art = exports["int8"][0]
    frames = [t.to(torch.bfloat16).cuda() for t in runner_io.random_inputs(
        runner_io.manifest(art)["inputs"], 0)]
    model = int8_model()
    f32, _ = entry(dtype=torch.float32, corr_impl="plain")
    with torch.no_grad():
        got = packages["int8"](*frames)
        want = quantized_apply(model, *frames)
        ref = f32(*frames)
    del model, f32
    rule = runs["int8"]["int8_rule"] = {}
    for g, k in zip(got, HEADS):
        d_pkg, d_eager = rel_l2(g, ref[k]), rel_l2(want[k], ref[k])
        lim = INT8_PACKAGE_SLACK * d_eager + 1e-3
        rule[k] = {"package_vs_f32": d_pkg, "quantized_apply_vs_f32": d_eager,
                   "limit": lim}
        if not d_pkg <= lim:
            errors.append(f"int8 package {k}: rel L2 to float32 {d_pkg} > "
                          f"{lim}")
    runs["int8"]["package_vs_quantized_apply"] = frame_distances(got, want)
    del got, want, ref
    serve_int8 = runs["int8"]["serve"] = runner_io.verify_serve(
        art, runner, ops, "cuda", seed=3, requests=1,
        package=packages["int8"])
    if not (serve_int8["ok"] and serve_int8["bit_equal"]):
        errors.append(f"int8 serve: rc {serve_int8['rc']}, "
                      f"{serve_int8['requests']}")

    # the plain bf16 rule against the float32 eager forward, on each float
    # artifact's runner inputs (its outputs dumped by verify); the fused
    # levels are CerberusNet's encoder convs, so pallas_levels is held to
    # CerberusNet's plain forwards
    rule = {}
    for variant, names in (("cerberus", ("cerberus", "pallas_levels")),
                           ("cerberus_dcv", ("cerberus_dcv",))):
        plain16, _ = entry(variant=variant, corr_impl="plain")
        plain32, _ = entry(variant=variant, dtype=torch.float32,
                           corr_impl="plain")
        for name in names:
            art = f"{root}/export/{name}"
            frames = [t.to(torch.bfloat16).cuda() for t in
                      runner_io.random_inputs(
                          runner_io.manifest(art)["inputs"], 0)]
            got = [t.cuda() for t in
                   runner_io.read_outputs(f"{art}/_verify")]
            with torch.no_grad():
                ref, base = plain32(*frames), plain16(*frames)
            rule[name] = {}
            for g, k in zip(got, HEADS):
                d_run, d_plain = rel_l2(g, ref[k]), rel_l2(base[k], ref[k])
                lim = 1.5 * d_plain + 1e-3
                rule[name][k] = {"runner_bf16_vs_f32": d_run,
                                 "plain_bf16_vs_f32": d_plain, "limit": lim}
                if not d_run <= lim:
                    errors.append(f"runner {name} {k}: rel L2 {d_run} > "
                                  f"{lim}")
            del ref, base
        del plain16, plain32

    art = f"{root}/export/cerberus"
    specs = runner_io.manifest(art)["inputs"]
    frames = [t.to(torch.bfloat16).cuda()
              for t in runner_io.random_inputs(specs, 0)]

    # ms per frame: the runner, the Python-loaded package and the eager
    # forward, in turns (runner, the two in Python, runner)
    model = seeded_model()
    with torch.no_grad():
        python_ms = turns({"python_package": packages["cerberus"],
                           "eager": model}, lambda f: f(*frames), runs=20,
                          warmup=3)
        int8_ms = turns({"python_package_int8": packages["int8"],
                         "python_package_bf16": packages["cerberus"]},
                        lambda f: f(*frames), runs=20, warmup=3)
    again = runner_io.run_runner(art, runner, ops, "cuda",
                                 [f"{art}/_verify/in_{i}.bin"
                                  for i in range(len(specs))],
                                 f"{art}/_verify_again", iters=RUNNER_ITERS)
    ms_per_frame = {"runner": [runs["cerberus"]["runner"]["avg_exec_ms"],
                               again["avg_exec_ms"]],
                    "runner_int8": [runs["int8"]["runner"]["avg_exec_ms"]],
                    **python_ms, **int8_ms}
    del model

    # --serve: three INFER requests and one PNGS to one warm process
    serve = runner_io.verify_serve(art, runner, ops, "cuda", seed=1,
                                   requests=N_REQUESTS,
                                   package=packages["cerberus"])
    if not (serve["ok"] and serve["bit_equal"]):
        errors.append(f"serve: rc {serve['rc']}, {serve['requests']}")
    # --pngs: separate frames and the stacked signature on the same files
    pngs = {name: runner_io.verify_pngs(f"{root}/export/{name}", runner, ops,
                                        "cuda", seed=2,
                                        package=packages[name])
            for name in ("cerberus", "stacked")}
    for name, report in pngs.items():
        held(report, f"--pngs {name}", errors)
    # the two packages, compiled apart, against each other: their flow
    # heads differ by a relative 1.0e-4 in some compiles and not in others
    # (ROADMAP C15), so the pair is held as the export phase holds it
    # (ARTIFACT_RTOL), its bit equality reported; the runner's own decoding
    # and stacking are held bit-equal by --pngs stacked above
    stacked_vs_separate = runner_io.compare(
        runner_io.read_outputs(f"{root}/export/stacked/_verify_png"),
        runner_io.read_outputs(f"{root}/export/cerberus/_verify_png"),
        rtol=ARTIFACT_RTOL)
    if not stacked_vs_separate["ok"]:
        errors.append(f"--pngs stacked against separate: "
                      f"{stacked_vs_separate['outputs']}")

    refusals, errs = runner_refusals(runner, art, cpu_export)
    errors += errs
    ok = not errors
    emit({"phase": "runner", "ok": ok, "hw": list(HW), "batch": 1,
          "dtype": "bfloat16", "artifacts": runs, "plain_bf16_rule": rule,
          "ms_per_frame": ms_per_frame, "serve": serve, "pngs": pngs,
          "pngs_stacked_vs_separate": stacked_vs_separate,
          "refusals": refusals, "packaging_s": packaging_s,
          "packaging_wait_s": packaging_wait_s,
          "seconds": time.perf_counter() - t_phase,
          "timing": "runner: host clock around each call and a stream "
                    "synchronise, mean of its timed calls (two runs, before "
                    "and after the Python pair; runner_int8 one run); "
                    "python_package and eager, python_package_int8 and "
                    "python_package_bf16: CUDA events around one call, in "
                    "turns; package_s: an artifact's own AOTInductor "
                    "compile and package, in two processes at nice 19 "
                    "(the float ones one after the other after export, "
                    "int8's after quant_int8) while the phases from "
                    "export to the data slice's ran (packaging_s from "
                    "the first start to the last end, packaging_wait_s the "
                    "part this phase waited); "
                    "serve wall_ms: host clock around a request",
          "card": card, "errors": errors})
    if not ok:
        sys.exit(1)
    return counts


REPLACES = {
    "corr2d_fwd": "cerberusnet_tpu/ops/pallas/correlation.py:86 "
                  "(_corr2d_fwd_kernel, pallas_call at :153)",
    "corr1d_fwd": "cerberusnet_tpu/ops/pallas/correlation.py:234 "
                  "(_corr1d_fwd_kernel, pallas_call at :281)",
    "corr2d_bwd_f1": "cerberusnet_tpu/ops/pallas/correlation.py:102 "
                     "(_corr2d_bwd_f1_kernel, pallas_call at :197)",
    "corr2d_bwd_f2": "cerberusnet_tpu/ops/pallas/correlation.py:122 "
                     "(_corr2d_bwd_f2_kernel, pallas_call at :214)",
    "corr1d_bwd_f1": "cerberusnet_tpu/ops/pallas/correlation.py:243 "
                     "(_corr1d_bwd_f1_kernel, pallas_call at :323)",
    "corr1d_bwd_f2": "cerberusnet_tpu/ops/pallas/correlation.py:255 "
                     "(_corr1d_bwd_f2_kernel, pallas_call at :335)",
}
# the TPU kernels of the DCV heads, which the forwards also replace at
# dilation; the reference differentiates the DCV path without a kernel
DCV_REPLACES = {
    "corr2d_fwd": "cerberusnet_tpu/ops/pallas/correlation.py:369 "
                  "(_corr2d_wl_kernel, pallas_call at :420)",
    "corr1d_fwd": "cerberusnet_tpu/ops/pallas/correlation.py:385 "
                  "(_corr1d_wl_kernel, pallas_call at :453)",
}


# The train_dp phase: CerberusNet's step through data parallelism
# (cerberusnet_torch/parallel/mesh.py) at full width, bf16 over float32
# masters, 512x1024, configs/cerberus_synthetic.json's synthetic data. Its
# ranks are spawned processes (parallel.launch), which import this script
# as their main module and run the dp_* functions below.
DP_CONFIG = "configs/cerberus_synthetic.json"
DP_RANKS = 2
DP_BATCH = DP_RANKS * TRAIN_BATCH  # the global batch of (b) to (d)
# (a): one NCCL rank against one process, both under deterministic
# algorithms, the same weights and batch
DP_ONE_RTOL = 1e-6
# (b), (c): the loss components against one process at the global batch;
# the float32 DP path's gradients against the float32 plain path; its
# masters after one AdamW step against the single process's
DP_COMPS_RTOL = 1e-3
DP_F32_RTOL = 1e-4
DP_MASTERS_RTOL = 1e-4
# (d): configs/cerberus_dp_v4_8.json cut to a global batch of 4, 8
# synthetic samples, 1 epoch, on 2 gloo ranks sharing the card
DP_FIT_CONFIG = "configs/cerberus_dp_v4_8.json"
DP_FIT_CUT = {"data": {"batch_size": DP_BATCH, "synthetic_length": 8},
              "train": {"epochs": 1, "num_data_devices": DP_RANKS}}
DP_TIMEOUT_S = 600
# cuBLAS's setting for deterministic algorithms
DETERMINISTIC_CUBLAS = ":4096:8"


def dp_setup():
    """A spawned rank's settings: the parent's float32 rules (no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def cpu_grads(grads):
    return {n: g.detach().float().cpu() for n, g in grads.items()}


def as_numpy(tensors):
    """Host copies as numpy arrays: a rank's arguments pickle by value."""
    return {n: t.numpy() for n, t in tensors.items()}


def as_tensors(arrays):
    return {n: torch.from_numpy(a) for n, a in arrays.items()}


def masters_digest(trainer):
    """A SHA-256 of the masters' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for n in trainer.names:
        h.update(trainer.masters[n].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_one_rank(batch):
    """(a) in a one-rank NCCL group: the loss components and gradients of
    one step through the DP path, under deterministic algorithms."""
    import os

    from cerberusnet_torch.entry import train_entry
    from cerberusnet_torch.parallel.mesh import shard_batch

    dp_setup()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = DETERMINISTIC_CUBLAS
    torch.use_deterministic_algorithms(True, warn_only=True)
    tr, _ = train_entry(DP_CONFIG, batch_size=TRAIN_BATCH, n_batches=0,
                        optim={"schedule": "constant"},
                        train={"num_data_devices": 1})
    comps, grads = tr.loss_and_grads(shard_batch(batch, tr.mesh))
    return {"mesh": [tr.mesh.rank, tr.mesh.size, str(tr.mesh.device),
                     tr.mesh.distributed],
            "comps": {k: v.item() for k, v in comps.items()},
            "grads": cpu_grads(grads)}


def dp_rank(job):
    """A rank of (b) or (c): this rank's rows of the global batch through
    the DP path in bf16 with the kernels (every correlation call held to
    its plain version, the launches counted), its own gradients before the
    all-reduce (the control), and the float32 DP path's gradients and
    masters after one AdamW step; each held to the single process's
    references in ``job``."""
    from cerberusnet_torch.entry import train_entry
    from cerberusnet_torch.parallel.mesh import shard_batch

    dp_setup()
    kw = dict(batch_size=DP_BATCH, n_batches=0, device=job["device"],
              optim={"schedule": "constant"},
              train={"num_data_devices": DP_RANKS})
    tr, _ = train_entry(DP_CONFIG, **kw)
    local = shard_batch(job["batch"], tr.mesh)
    ref, limits = as_tensors(job["ref"]), job["limits"]
    _, own = tr._rank_loss_and_grads(local)
    own = module_rel_l2(cpu_grads(own), ref)
    calls = []
    real = checked_corr_calls(calls)
    reset_launch_counts()
    try:
        t0 = time.perf_counter()
        comps, grads = tr.loss_and_grads(local)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        restore_corr(real)
    kernel = module_rel_l2(cpu_grads(grads), ref)
    # the gradients' all-reduce alone, on a copy: its bytes and time
    flat = [g.clone() for g in grads.values()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buckets = tr.mesh.mean_grads(flat)
    torch.cuda.synchronize()
    allreduce_ms = (time.perf_counter() - t0) * 1e3
    nbytes = 4 * sum(g.numel() for g in flat)
    del tr, grads, flat
    torch.cuda.empty_cache()
    f32, _ = train_entry(DP_CONFIG, model={"dtype": "float32"}, **kw)
    _, g32 = f32.loss_and_grads(local)
    f32.apply_grads(g32)
    return {
        "rank": f32.mesh.rank, "device": str(f32.mesh.device),
        "comps": {k: v.item() for k, v in comps.items()},
        "kernel_bf16_vs_f32": kernel, "own_vs_f32": own,
        "kernel_f32_vs_f32": module_rel_l2(cpu_grads(g32), ref),
        "masters_f32_vs_single": module_rel_l2(
            cpu_grads(f32.masters), as_tensors(job["masters"])),
        "masters_sha256": masters_digest(f32),
        "launches": launches, "calls": calls_summary(calls),
        "step_s_with_checks": step_s,
        "allreduce": {"bytes": nbytes, "buckets": buckets,
                      "ms": allreduce_ms},
        "limits": limits}


def dp_fit_rank(job):
    """A rank of (d): ``Trainer.fit`` of the cut dp_v4_8 config, the masters'
    digest, what ``save_checkpoint`` returns here, and ms per step."""
    from cerberusnet_torch.data.loader import batches
    from cerberusnet_torch.entry import REPO_ROOT
    from cerberusnet_torch.parallel.mesh import shard_batch
    from cerberusnet_torch.train.config import ExperimentConfig
    from cerberusnet_torch.train.trainer import Trainer

    dp_setup()
    with open(REPO_ROOT / DP_FIT_CONFIG) as f:
        raw = json.load(f)
    for section, values in DP_FIT_CUT.items():
        raw[section] = {**raw[section], **values}
    raw["train"]["ckpt_dir"] = job["ckpt_dir"]
    tr = Trainer(ExperimentConfig.from_dict(raw), device=job["device"])
    t0 = time.perf_counter()
    history = tr.fit()
    fit_s = time.perf_counter() - t0
    steps = tr.step
    saved = tr.save_checkpoint()
    digest = masters_digest(tr)
    local = shard_batch(batches(tr.dataset, DP_BATCH, 1)[0], tr.mesh)
    times = cuda_times(lambda: tr.train_step(local), runs=5, warmup=1)
    return {"rank": tr.mesh.rank, "history": history, "fit_s": fit_s,
            "steps": steps, "saved": saved, "masters_sha256": digest,
            "ms_per_step": times}


def dp_single_refs(batch):
    """The single-process references of (b) and (c) at the global batch:
    the float32 plain path's gradients (the yardstick), the limits of the
    train phase's rule (1.5 x the bf16 plain path's distance + 1e-3), the
    bf16 kernel path's loss components and the float32 kernel path's
    masters after one AdamW step, all on the host."""
    from cerberusnet_torch.entry import train_entry

    kw = dict(batch_size=DP_BATCH, n_batches=0,
              optim={"schedule": "constant"})
    tr, _ = train_entry(DP_CONFIG, corr_impl="plain",
                        model={"dtype": "float32"}, **kw)
    _, ref = tr.loss_and_grads(batch)
    ref = cpu_grads(ref)
    del tr
    tr, _ = train_entry(DP_CONFIG, corr_impl="plain", **kw)
    _, g = tr.loss_and_grads(batch)
    limits = {m: 1.5 * d + 1e-3
              for m, d in module_rel_l2(cpu_grads(g), ref).items()}
    del tr, g
    tr, _ = train_entry(DP_CONFIG, **kw)
    comps = {k: v.item() for k, v in tr.loss_and_grads(batch)[0].items()}
    del tr
    tr, _ = train_entry(DP_CONFIG, model={"dtype": "float32"}, **kw)
    tr.train_step(batch)
    masters = cpu_grads(tr.masters)
    del tr
    torch.cuda.empty_cache()
    return ref, limits, comps, masters


def dp_rank_errors(res, comps, label):
    """The checks of a (b) or (c) rank's result."""
    errors = []
    limits = res["limits"]
    for k, want in comps.items():
        got = res["comps"][k]
        if not abs(got - want) <= DP_COMPS_RTOL * abs(want):
            errors.append(f"{label}: loss {k} {got} against {want}")
    errors += [f"{label}: {m} bf16 gradient rel L2 {d} > {limits[m]}"
               for m, d in res["kernel_bf16_vs_f32"].items()
               if not d <= limits[m]]
    errors += [f"{label}: {m} float32 gradient rel L2 {d} > {DP_F32_RTOL}"
               for m, d in res["kernel_f32_vs_f32"].items()
               if not d <= DP_F32_RTOL]
    errors += [f"{label}: {m} masters rel L2 {d} > {DP_MASTERS_RTOL}"
               for m, d in res["masters_f32_vs_single"].items()
               if not d <= DP_MASTERS_RTOL]
    if all(d <= limits[m] for m, d in res["own_vs_f32"].items()):
        errors.append(f"{label}: the rank's own gradients (before the "
                      "all-reduce) pass the check")
    want = {k: len(LEVELS) if k in REPLACES else 0
            for k in res["launches"]}
    if res["launches"] != want:
        errors.append(f"{label}: launches {res['launches']}, not {want}")
    errors += [f"{label}: {e}" for e in res["calls"]["errors"]]
    return errors


def dp_job(batch, refs, device):
    """The job of a (b) or (c) rank (``dp_rank``)."""
    ref, limits, _, masters = refs
    return {"batch": batch, "ref": as_numpy(ref), "limits": limits,
            "masters": as_numpy(masters), "device": device}


def dp_ranks_report(part, ranks, seconds, comps, backend):
    """(b) or (c)'s checks of its DP_RANKS ranks' results against the single
    process; emits the part's lines; returns (errors, the ranks' launches
    summed)."""
    errors = []
    for res in ranks:
        errors += dp_rank_errors(res, comps, f"({part}) rank {res['rank']}")
    if len({r["masters_sha256"] for r in ranks}) != 1:
        errors.append(f"({part}) the ranks' masters differ after the step")
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    for res in ranks:
        res["calls"] = {k: v for k, v in res["calls"].items() if k != "rows"}
        emit({"phase": "train_dp", "part": part, "backend": backend,
              "device": res["device"], "rank": res["rank"],
              "comps": res["comps"],
              "single_comps": comps,
              **{k: res[k] for k in (
                  "kernel_bf16_vs_f32", "limits", "own_vs_f32",
                  "kernel_f32_vs_f32", "masters_f32_vs_single",
                  "masters_sha256", "launches", "calls",
                  "step_s_with_checks", "allreduce")}})
    emit({"phase": "train_dp", "part": part, "ranks": DP_RANKS,
          "global_batch": DP_BATCH, "seconds": seconds,
          "launches_summed": launches, "errors": errors})
    return errors, launches


def dp_ranks_part(part, batch, refs, backend, device):
    """(c): DP_RANKS NCCL ranks against the single process
    (``dp_ranks_report``)."""
    from cerberusnet_torch.parallel import launch

    t0 = time.perf_counter()
    ranks = launch(dp_rank, DP_RANKS, args=(dp_job(batch, refs, device),),
                   backend=backend, timeout=DP_TIMEOUT_S)
    return dp_ranks_report(part, ranks, time.perf_counter() - t0, refs[2],
                           backend)


def dp_part_a_reference():
    """(a)'s single process: one step at batch 2, run twice, under
    deterministic algorithms: (the batch, the loss components, the
    gradients, the two runs' module distances)."""
    import os

    from cerberusnet_torch.data.loader import batches
    from cerberusnet_torch.entry import train_entry

    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = DETERMINISTIC_CUBLAS
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        one, _ = train_entry(DP_CONFIG, batch_size=TRAIN_BATCH, n_batches=0,
                             optim={"schedule": "constant"})
        batch2 = batches(one.dataset, TRAIN_BATCH, 1)[0]
        runs = [one.loss_and_grads(batch2) for _ in range(2)]
        want_comps = {k: v.item() for k, v in runs[0][0].items()}
        want = cpu_grads(runs[0][1])
        floor = module_rel_l2(cpu_grads(runs[1][1]), want)
        del one, runs
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
    return batch2, want_comps, want, floor


def dp_part_a_report(reference, got):
    """(a): the one NCCL rank's step (``dp_one_rank``, which sets the same
    deterministic algorithms) against the single process's; emits its
    line, returns its errors."""
    _, want_comps, want, floor = reference
    dist = module_rel_l2(got["grads"], want)
    comps = {k: abs(got["comps"][k] - w) / abs(w)
             for k, w in want_comps.items()}
    emit({"phase": "train_dp", "part": "a", "backend": "nccl",
          "mesh": got["mesh"], "batch": TRAIN_BATCH, "comps_rel": comps,
          "module_rel_l2": dist, "single_process_run_to_run": floor,
          "limit": DP_ONE_RTOL, "deterministic_algorithms": True})
    return ([f"(a) {m} gradient rel L2 {d} > {DP_ONE_RTOL}"
             for m, d in dist.items() if not d <= DP_ONE_RTOL]
            + [f"(a) loss {k} rel {d} > {DP_ONE_RTOL}"
               for k, d in comps.items() if not d <= DP_ONE_RTOL])


def dp_part_d_refusal(ckpt):
    """(d)'s first half: cerberus_dp_v4_8 through the CLI, which must
    refuse its 8 ranks on fewer cards: (the ValueError's text, errors)."""
    from cerberusnet_torch import cli
    from cerberusnet_torch.entry import REPO_ROOT

    refused = None
    try:
        cli.main(["--config", str(REPO_ROOT / DP_FIT_CONFIG),
                  "--ckpt-dir", ckpt])
    except ValueError as e:
        refused = str(e)
    cards = torch.cuda.device_count()
    if cards < 8 and not (refused and "8 CUDA devices" in refused):
        return refused, [f"(d) the CLI did not refuse 8 ranks on {cards} "
                         f"card(s): {refused}"]
    return refused, []


def dp_part_d_report(card, refused, ckpt, ranks, wall_s):
    """(d)'s second half: the cut config fitted on 2 gloo ranks sharing the
    card (``dp_fit_rank``), its files under ``ckpt``; emits its lines,
    returns its errors."""
    import os

    errors = []
    files = sorted(os.listdir(ckpt))
    with open(os.path.join(ckpt, "train_log.csv")) as f:
        rows = f.read().splitlines()[1:]
    steps = DP_FIT_CUT["data"]["synthetic_length"] // DP_BATCH
    if files != [f"ckpt_{steps:08d}.pt", "train_log.csv"]:
        errors.append(f"(d) files written: {files}")
    if len(rows) != 1:
        errors.append(f"(d) train_log.csv rows: {rows}")
    if [r["saved"] is None for r in ranks] != [False, True]:
        errors.append(f"(d) save_checkpoint returned "
                      f"{[r['saved'] for r in ranks]}")
    if len({r["masters_sha256"] for r in ranks}) != 1:
        errors.append("(d) the ranks' masters differ after the epoch")
    for r in ranks:
        losses = [v for row in r["history"] for k, v in row.items()
                  if k.startswith("loss_")]
        if (r["steps"] != steps or len(r["history"]) != 1
                or not all(map(math.isfinite, losses))):
            errors.append(f"(d) rank {r['rank']}: {r['steps']} steps, "
                          f"history {r['history']}")
    emit({"phase": "train_dp", "part": "d", "config": DP_FIT_CONFIG,
          "cli_refused": refused, "reduced": DP_FIT_CUT, "backend": "gloo",
          "device": "cuda:0", "files": files, "log_rows": len(rows),
          "wall_s": wall_s,
          "ranks": [{k: r[k] for k in (
              "rank", "history", "fit_s", "steps", "saved",
              "masters_sha256")} for r in ranks]})
    for r in ranks:
        emit({"phase": "train_dp", "part": "d", "rank": r["rank"],
              "ms_per_step": r["ms_per_step"], "card": card,
              "note": "2 gloo ranks sharing one card: gloo stages the "
                      "all-reduces through the host; not a multi-card "
                      "time"})
    return errors


# The train_spatial phase: each model's step with image rows split over
# ranks sharing the card (train.num_spatial_devices,
# cerberusnet_torch/parallel/halo.py) at full width, batch 2, synthetic data,
# each rank against one process on the card. (a) SP_RANKS gloo ranks, 256
# rows of 512x1024 a rank: CerberusNet (configs/cerberus_synthetic.json),
# CerberusDCV (configs/cerberus_dcv.json) and CerberusRAFT
# (configs/cerberus_raft.json: level 3, 12 iterations), float32 and bf16
# steps; (c) SP_UNEQUAL_RANKS gloo ranks on unequal bands: DCVFlowNet at
# configs/dcv_flow_kitti.json's 384x1248 (bands of 128/128/64/64 rows, the
# 2-D correlation's 32-row reach at dilation 8 crossing every peer), float32
# steps; (d) SP_RANKS gloo ranks at an H that is no multiple of 64, RAFT's
# Sintel crop of 368x768 (extents 368/184/92/46/23/12/6, bands of 176/192
# rows, level 4 split 11/12 under the stride-2 block's top pad): CerberusDCV
# and CerberusRAFT at their configs' widths, float32 and bf16 steps. Its
# ranks are spawned processes that import this script as their main module
# (sp_rank).
SP_RANKS = 2
SP_UNEQUAL_RANKS = 4
SP_OFFGRID_HW = (368, 768)
# the DCV decoders' band of part (d) a kernels-phase case runs on: rank 0's
# rows of level 3 (46 rows split 22/24)
SP_OFFGRID_DCV_ROWS = 22
# one float32 step (its gradients, taps and the masters after it); bf16
# steps, each held to the plain rule
SP_STEPS = 2
# (config, config overrides, bf16 steps or None, a bf16 step's kernel
# launches on a rank, the taps whose gradient the controls must spoil)
SP_MODELS = {
    "cerberus": (DP_CONFIG, {}, SP_STEPS,
                 {k: len(LEVELS) for k in REPLACES}, "corr2d"),
    "cerberus_dcv": ("configs/cerberus_dcv.json", {}, SP_STEPS,
                     {k: (len(DCV_FLOW_DILATIONS) if k.startswith("corr2d")
                          else len(DCV_DISP_DILATIONS)) for k in REPLACES},
                     "corr2d"),
    "cerberus_raft": (RAFT_CONFIG, {}, SP_STEPS, {}, "raft flow"),
    "cerberus_dcv_offgrid": ("configs/cerberus_dcv.json", {"data": {
        "hw": list(SP_OFFGRID_HW)}}, SP_STEPS,
        {k: (len(DCV_FLOW_DILATIONS) if k.startswith("corr2d")
             else len(DCV_DISP_DILATIONS)) for k in REPLACES}, "corr2d"),
    "cerberus_raft_offgrid": (RAFT_CONFIG, {"data": {
        "hw": list(SP_OFFGRID_HW)}}, SP_STEPS, {}, "raft flow"),
    "dcv_flow_kitti": (DCV_KITTI_CONFIG, {"data": {
        "dataset": "synthetic", "root": "", "hw": list(DCV_KITTI_HW)}},
        None, {}, "corr2d"),
}
# the models of each part, and the controls each model's f2 taps and
# gradients must fail: the halos' and the gather's gradient all-reduces
# zeroed ("send-back"), K3 zeroed, the gather's all-reduce alone dropped
# (each rank keeps its own volume's share of RAFT's whole-frame f2
# gradient, not the peers' sum; zeroed, the band's own share would go too)
SP_PARTS = {"a": ("cerberus", "cerberus_dcv", "cerberus_raft"),
            "b": ("cerberus", "cerberus_dcv", "cerberus_raft"),
            "c": ("dcv_flow_kitti",),
            "d": ("cerberus_dcv_offgrid", "cerberus_raft_offgrid")}
SP_CONTROLS = {"cerberus": ("send_back_dropped", "k3_zeroed"),
               "cerberus_dcv": ("send_back_dropped", "k3_zeroed"),
               "cerberus_raft": ("gather_reduce_dropped",),
               "dcv_flow_kitti": ("send_back_dropped",),
               "cerberus_dcv_offgrid": ("send_back_dropped",),
               "cerberus_raft_offgrid": ("gather_reduce_dropped",)}
# float32: the all-reduced gradients of one step against one process's
# (each module's relative L2, a module the names' first SP_GRAD_PARTS
# parts: RAFT's GRU, motion encoder and heads each on their own), the
# masters after it (each module's relative L2), and the gradient each
# correlation hands each input's band (for the 2-D ones' f2 the kernel's
# own rows and the halo rows' gradients its neighbours send back; RAFT's
# f2 at the level, whose gradient every peer's volume adds to) against one
# process's rows there, by train_pallas_levels' float32 rule for
# correlation inputs (a band's convolutions take other cuDNN algorithms
# than the frame's). The gradients' limit is each model's: 5-40x its
# largest sound reading over two runs (CerberusNet 7.6e-5, CerberusDCV
# 2.6e-6, CerberusRAFT 7.3e-6, DCVFlowNet's unequal bands 2.0e-4, run to
# run as much as 1.1e-4 there) and at least 9x under the smallest miss of
# a control that spoils the gradients (RAFT's gather reduce dropped 9.6e-4,
# the send-back 0.25-0.80; an NVIDIA H100 80GB HBM3, 700 W)
SP_GRAD_PARTS = 3
SP_GRAD_RTOL = {"cerberus": 1e-3, "cerberus_dcv": 1e-4,
                "cerberus_raft": 1e-4, "dcv_flow_kitti": 1e-3,
                "cerberus_dcv_offgrid": 1e-4, "cerberus_raft_offgrid": 1e-4}
SP_MASTERS_RTOL = 1e-5
SP_TAP_RTOL = FUSED_F32_RTOL
# a control's taps must miss by more than this, and its gradients by more
# than the model's SP_GRAD_RTOL where it spoils an all-reduce (K3 zeroed does not: a
# correlation's share of a module's gradient is too small to show, which
# the taps are for)
SP_CONTROL_MISS = 1e-2
SP_GRAD_CONTROLS = ("send_back_dropped", "gather_reduce_dropped")
SP_TIMEOUT_S = 900
# the bf16 steps timed for ms per step, a rank's and one process's
SP_TIMED_STEPS = 2


def sp_band_shape(name, level):
    """The tensors a correlation kernel of ``name`` gets on a spatial
    rank's band of ``level``: (batch, rows, width, channels)."""
    rows = (HW[0] >> level) // SP_RANKS
    if name.startswith("corr2d"):
        rows += 2 * FLOW_MAX_DISP
    return (TRAIN_BATCH, rows, HW[1] >> level, ENCODER_CHANNELS[level - 1])


def sp_dcv_band_shape(name, dilation, rows, width):
    """The same for a DCV decoder's call at ``dilation`` on a band of
    ``rows`` rows of level DCV_LEVEL: the 2-D kernels' f1 and f2 haloed by
    the reach, DCV_MAX_DISP x dilation rows each side."""
    if name.startswith("corr2d"):
        rows += 2 * DCV_MAX_DISP * dilation
    return (TRAIN_BATCH, rows, width, ENCODER_CHANNELS[DCV_LEVEL - 1])


def sp_trainer(model, dtype, corr_impl=None, spatial=1, device="cuda"):
    from cerberusnet_torch.entry import train_entry

    config, overrides, *_ = SP_MODELS[model]
    sections = {"model": {"dtype": dtype}, "optim": {"schedule": "constant"},
                "train": {"num_data_devices": 1,
                          "num_spatial_devices": spatial}}
    for k, v in overrides.items():
        sections[k] = {**v, **sections.get(k, {})}
    tr, _ = train_entry(config, batch_size=TRAIN_BATCH, n_batches=0,
                        device=device, corr_impl=corr_impl, **sections)
    return tr


def band_taps(taps, mesh):
    """The mesh's rank's band of rows of each of one process's taps."""
    return {k: t[:, mesh.rows(t.shape[1])] for k, t in taps.items()}


def taps_rel_l2(taps, ref, ranks):
    """Each tap of a rank, over the ranks (a rank's gradient is the mesh's
    size times its share), against one process's."""
    return {k: rel_l2(taps[k].cpu() / ranks, ref[k]) for k in ref}


def sp_control(name):
    """A context manager that spoils what the control ``name`` tests."""
    import contextlib

    from cerberusnet_torch.parallel import halo

    @contextlib.contextmanager
    def swapped(owner, attr, value):
        saved = getattr(owner, attr)
        setattr(owner, attr, value)
        try:
            yield
        finally:
            setattr(owner, attr, saved)

    if name == "send_back_dropped":
        return swapped(halo, "_all_reduce", lambda t, mesh: t.zero_())
    if name == "k3_zeroed":
        return swapped(*zeroed_backward("corr2d_bwd_f2"))
    if name == "gather_reduce_dropped":
        real = halo._GatherRows.backward

        def backward(ctx, g):
            with swapped(halo, "_all_reduce", lambda t, mesh: t):
                return real(ctx, g)
        return swapped(halo._GatherRows, "backward", staticmethod(backward))
    raise ValueError(name)


def sp_rank_model(name, job, tr_device):
    """One model of a train_spatial rank: float32 (the controls' and one
    step's taps against one process's band, that step's all-reduced
    gradients and the masters after it against one process's); bf16 where
    the model has bf16 steps
    (every correlation call held to its plain version on the same haloed
    tensors, the launches, the halo's exchanges and bytes, this rank's
    peak; rank 0 saves the masters before each step and the all-reduced
    gradients of each under ``job["dir"]`` for the parent's yardsticks;
    then ms per step)."""
    import os

    from cerberusnet_torch.parallel import halo

    sub = job["models"][name]
    batches_ = sub["batches"]
    out = {}
    t0 = time.perf_counter()
    tr = sp_trainer(name, "float32", spatial=job["ranks"], device=tr_device)
    ref = band_taps(as_tensors(sub["taps"]), tr.mesh)
    ref_grads = as_tensors(sub["grads"])
    for control in SP_CONTROLS[name]:
        with sp_control(control):
            grads, taps = grads_and_taps(tr, batches_[0])
        out[f"control_{control}"] = taps_rel_l2(taps, ref, tr.mesh.size)
        out[f"control_{control}_grads"] = module_rel_l2(
            cpu_grads(grads), ref_grads, SP_GRAD_PARTS)
    grads, taps = grads_and_taps(tr, batches_[0])
    out["f32_taps"] = taps_rel_l2(taps, ref, tr.mesh.size)
    out["f32_grads"] = module_rel_l2(cpu_grads(grads), ref_grads,
                                     SP_GRAD_PARTS)
    tr.apply_grads(grads)
    out["f32_masters"] = module_rel_l2(cpu_grads(tr.masters),
                                       as_tensors(sub["masters"]))
    out.update(rank=tr.mesh.spatial_rank, device=str(tr.device),
               rows=[tr.mesh.rows(tr.config.data.hw[0]).start,
                     tr.mesh.rows(tr.config.data.hw[0]).stop])
    del tr, grads, taps
    torch.cuda.empty_cache()
    out["f32_s"] = time.perf_counter() - t0
    steps = SP_MODELS[name][2]
    if not steps:
        return out

    tr = sp_trainer(name, "bfloat16", spatial=job["ranks"], device=tr_device)
    rank = tr.mesh.spatial_rank
    calls, launches, exchanges = [], [], []
    torch.cuda.reset_peak_memory_stats(tr.device)
    for step, b in enumerate(batches_[:steps]):
        if rank == 0:
            torch.save(cpu_grads(tr.masters),
                       os.path.join(job["dir"], f"{name}_masters_{step}.pt"))
        real = checked_corr_calls(calls)
        reset_launch_counts()
        halo.reset_stats()
        try:
            _, grads = tr.loss_and_grads(b)
            torch.cuda.synchronize()
        finally:
            restore_corr(real)
        launches.append(launch_counts())
        exchanges.append(halo.stats())
        if rank == 0:
            torch.save(cpu_grads(grads),
                       os.path.join(job["dir"], f"{name}_grads_{step}.pt"))
        tr.apply_grads(grads)
    out["peak_gib"] = torch.cuda.max_memory_allocated(tr.device) / 2**30
    out["ms_per_step"] = cuda_times(lambda: tr.train_step(batches_[0]),
                                    runs=SP_TIMED_STEPS, warmup=1)
    out.update(launches=launches, exchanges=exchanges,
               calls=calls_summary(calls))
    out["calls"].pop("rows")
    del tr, grads
    torch.cuda.empty_cache()
    out["bf16_s"] = time.perf_counter() - t0 - out["f32_s"]
    return out


def sp_rank(job):
    """A rank of train_spatial: each model of its part in turn
    (``sp_rank_model``)."""
    dp_setup()
    return {name: sp_rank_model(name, job, job["device"])
            for name in job["models"]}


# the bf16 band resizes a spatial rank holds to the whole frame's resize
# cut to its band, bit for bit (ROADMAP C16): the frames of parts (a) and
# (d) on the pair's ranks and (c)'s on its four; batch 2, 2 channels
SP_RESIZE_FRAMES = {"pair": (HW, SP_OFFGRID_HW), "c": (DCV_KITTI_HW,)}


def sp_band_resizes(job):
    """A rank's bf16 band resizes on the card at each frame of ``job``,
    between the frame's level extents: every x2 (``upsample2x`` and its
    phase form, or ``upsample_to`` where the finer extent is not twice the
    coarser), every x4 (``upsample_to``), each against the whole frame's
    resize on this rank cut to the band: {"H x W": {case: the elements
    that differ}}."""
    from cerberusnet_torch.models.common import (
        _resize,
        upsample2x,
        upsample_to,
    )
    from cerberusnet_torch.parallel.mesh import level_extents, make_mesh

    dp_setup()
    device = job["device"]
    levels = len(ENCODER_CHANNELS)
    out = {}
    for h, w in job["frames"]:
        rows, cols = level_extents(h, levels), level_extents(w, levels)
        mesh = make_mesh(1, device, job["ranks"], extents=rows)
        cases = {}
        for fine in range(levels):
            for coarse in (fine + 1, fine + 2):
                if coarse > levels:
                    continue
                hs, hd, ws, wd = (rows[coarse], rows[fine], cols[coarse],
                                  cols[fine])
                gen = torch.Generator().manual_seed(hs * 1000 + ws)
                x = torch.randn((2, 2, hs, ws), generator=gen).to(
                    device=device, dtype=torch.bfloat16)
                band, dst = x[:, :, mesh.rows(hs)], mesh.rows(hd)
                forms = {"resize": (
                    lambda: upsample_to(band, (dst.stop - dst.start, wd),
                                        mesh), lambda: _resize(x, (hd, wd)))}
                if (hd, wd) == (2 * hs, 2 * ws):
                    forms = {"resize": (lambda: upsample2x(band, mesh),
                                        lambda: _resize(x, (hd, wd))),
                             "phase": (
                        lambda: upsample2x(band, mesh, impl="phase"),
                        lambda: upsample2x(x, impl="phase"))}
                for form, (on_band, frame) in forms.items():
                    got, want = on_band(), frame()[:, :, dst]
                    cases[f"{hs}x{ws} {hd}x{wd} {form}"] = (
                        int((got != want).sum()) if got.shape == want.shape
                        else -1)
        out[f"{h}x{w}"] = cases
    return out


def sp_resize_report(results):
    """The checks of the ranks' band resizes ({spawn: [a rank's
    ``sp_band_resizes``]}): one line, and the errors."""
    errors = [f"bf16 band resize, {spawn} rank {r}, {frame} {case}: "
              f"{n} elements differ from the frame's cut"
              for spawn, ranks in results.items()
              for r, res in enumerate(ranks) for frame, cases in res.items()
              for case, n in cases.items() if n != 0]
    emit({"phase": "train_spatial", "part": "band_resize", "dtype":
          "bfloat16", "frames": {k: [list(f) for f in v]
                                 for k, v in SP_RESIZE_FRAMES.items()},
          "cases": sum(len(c) for ranks in results.values()
                       for res in ranks for c in res.values()),
          "differing": {spawn: [{f: sum(c.values()) for f, c in res.items()}
                                for res in ranks]
                        for spawn, ranks in results.items()},
          "errors": errors})
    return errors


def sp_single(name, batches_):
    """One process's references on the card for ``name``: one step's taps
    and gradients and the masters after it in float32 through the
    kernels; where the model has bf16 steps, ms per step and the peak of
    the bf16 step."""
    tr = sp_trainer(name, "float32")
    grads, taps = grads_and_taps(tr, batches_[0])
    refs = {"taps": {k: t.cpu() for k, t in taps.items()},
            "grads": cpu_grads(grads)}
    tr.apply_grads(grads)
    refs["masters"] = cpu_grads(tr.masters)
    del tr, grads, taps
    torch.cuda.empty_cache()
    steps = SP_MODELS[name][2]
    if steps:
        tr = sp_trainer(name, "bfloat16")
        torch.cuda.reset_peak_memory_stats()
        for b in batches_[:steps]:
            tr.train_step(b)
        torch.cuda.synchronize()
        refs["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        refs["ms_per_step"] = cuda_times(
            lambda: tr.train_step(batches_[0]), runs=SP_TIMED_STEPS,
            warmup=1)
        del tr
        torch.cuda.empty_cache()
    return refs


def sp_yardsticks(name, batches_, root):
    """Each bf16 step of the ranks against the float32 plain path at the
    masters the ranks held before it (rank 0's, saved under ``root``):
    {step: (the ranks' gradients' module distances, the limits of the
    train phase's rule)}."""
    out = {}
    f32 = sp_trainer(name, "float32", corr_impl="plain")
    b16 = sp_trainer(name, "bfloat16", corr_impl="plain")
    for step, b in enumerate(batches_[:SP_MODELS[name][2]]):
        masters = torch.load(f"{root}/{name}_masters_{step}.pt")
        got = torch.load(f"{root}/{name}_grads_{step}.pt")
        f32.load_masters(masters)
        b16.load_masters(masters)
        ref = cpu_grads(f32.loss_and_grads(b)[1])
        plain = module_rel_l2(cpu_grads(b16.loss_and_grads(b)[1]), ref)
        out[step] = (module_rel_l2(got, ref),
                     {m: 1.5 * d + 1e-3 for m, d in plain.items()})
    del f32, b16
    torch.cuda.empty_cache()
    return out


def sp_rank_errors(name, res, label):
    """The checks of one model's result on a rank."""
    errors = [f"{label}: float32 tap {k} rel L2 {d} > {SP_TAP_RTOL}"
              for k, d in res["f32_taps"].items() if not d <= SP_TAP_RTOL]
    grad_rtol = SP_GRAD_RTOL[name]
    errors += [f"{label}: float32 gradient {m} rel L2 {d} > {grad_rtol}"
               for m, d in res["f32_grads"].items() if not d <= grad_rtol]
    errors += [f"{label}: float32 masters {m} rel L2 {d} > "
               f"{SP_MASTERS_RTOL}" for m, d in res["f32_masters"].items()
               if not d <= SP_MASTERS_RTOL]
    spoiled = SP_MODELS[name][4]
    for control in SP_CONTROLS[name]:
        worst = max(d for k, d in res[f"control_{control}"].items()
                    if k.startswith(spoiled) and k.endswith("df2"))
        if not worst > SP_CONTROL_MISS:
            errors.append(f"{label}: {control}: the f2 taps pass (worst "
                          f"rel L2 {worst})")
        worst = max(res[f"control_{control}_grads"].values())
        if control in SP_GRAD_CONTROLS and not worst > grad_rtol:
            errors.append(f"{label}: {control}: the gradients pass (worst "
                          f"rel L2 {worst})")
    want_launches = SP_MODELS[name][3]
    for step, launches in enumerate(res.get("launches", ())):
        want = {k: want_launches.get(k, 0) for k in launches}
        if launches != want:
            errors.append(f"{label} step {step}: launches {launches}, not "
                          f"{want}")
    if "calls" in res:
        errors += [f"{label}: {e}" for e in res["calls"]["errors"]]
    return errors


def sp_job(names, data, refs, root, device, ranks_n):
    """The job of a train_spatial rank (``sp_rank``) for the models
    ``names``: rank 0 saves its bf16 steps' masters and gradients under
    ``root``."""
    return {"models": {n: {"batches": data[n],
                           "taps": as_numpy(refs[n]["taps"]),
                           "grads": as_numpy(refs[n]["grads"]),
                           "masters": as_numpy(refs[n]["masters"])}
                       for n in names},
            "dir": root, "device": device, "ranks": ranks_n}


def sp_report(part, ranks, ranks_s, yard, refs, backend):
    """One part's checks of its ranks' results ({model: result} a rank)
    and of the yardsticks of their bf16 steps; emits the part's lines;
    returns (errors, {model: the ranks' bf16 launches summed over the ranks
    and steps})."""
    errors, summed = [], {}
    for name in SP_PARTS[part]:
        for r, res in enumerate(ranks):
            res = res[name]
            errors += sp_rank_errors(name, res, f"({part}) {name} rank {r}")
            emit({"phase": "train_spatial", "part": part, "model": name,
                  "rank": res["rank"], "device": res["device"],
                  "backend": backend, "rows": res["rows"],
                  **{k: res[k] for k in (
                      "f32_taps", "f32_grads", "f32_masters", *(
                          f"control_{c}{g}" for c in SP_CONTROLS[name]
                          for g in ("", "_grads")),
                      "launches", "exchanges", "calls", "peak_gib",
                      "ms_per_step", "f32_s", "bf16_s") if k in res}})
        for step, (dist, limits) in yard.get(name, {}).items():
            errors += [f"({part}) {name} bf16 step {step}: {m} gradient rel "
                       f"L2 {d} > {limits[m]}" for m, d in dist.items()
                       if not d <= limits[m]]
        bf16 = [r[name] for r in ranks if "launches" in r[name]]
        if bf16:
            summed[name] = {k: sum(r["launches"][s][k] for r in bf16
                                   for s in range(len(r["launches"])))
                            for k in bf16[0]["launches"][0]}
        emit({"phase": "train_spatial", "part": part, "model": name,
              "backend": backend, "ranks_s": ranks_s,
              "bf16_steps": {s: {"rel_l2": d, "limits": lim}
                             for s, (d, lim) in yard.get(name, {}).items()},
              "rank_ms_per_step": [r[name].get("ms_per_step") for r in ranks],
              "rank_peak_gib": [r[name].get("peak_gib") for r in ranks],
              "one_process_ms_per_step": refs[name].get("ms_per_step"),
              "one_process_peak_gib": refs[name].get("peak_gib"),
              "exchanges_per_step": ranks[0][name].get("exchanges"),
              "launches_summed": summed.get(name)})
    emit({"phase": "train_spatial", "part": part, "ranks_s": ranks_s,
          "errors": errors})
    return errors, summed


def sp_part(part, backend, device, data, refs):
    """(b): the models on SP_RANKS NCCL ranks a card each, and the
    yardsticks of their bf16 steps (``sp_report``)."""
    import shutil
    import tempfile

    from cerberusnet_torch.parallel import launch

    names = SP_PARTS[part]
    root = tempfile.mkdtemp(prefix="cerberus_sp_")
    try:
        t0 = time.perf_counter()
        ranks = launch(sp_rank, SP_RANKS,
                       args=(sp_job(names, data, refs, root, device,
                                    SP_RANKS),),
                       backend=backend, timeout=SP_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        yard = {n: sp_yardsticks(n, data[n], root) for n in names
                if SP_MODELS[n][2]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return sp_report(part, ranks, ranks_s, yard, refs, backend)


def sp_references(names, card):
    """Each model's batches and one process's references
    (``sp_single``); emits a line a model."""
    from cerberusnet_torch.data.loader import batches

    data, refs = {}, {}
    for name in names:
        tr = sp_trainer(name, "bfloat16")
        data[name] = batches(tr.dataset, TRAIN_BATCH,
                             SP_MODELS[name][2] or 1)
        del tr
        refs[name] = sp_single(name, data[name])
        emit({"phase": "train_spatial", "part": "one_process", "model": name,
              "card": card, "ms_per_step": refs[name].get("ms_per_step"),
              "peak_gib": refs[name].get("peak_gib"),
              "note": "the ranks of parts a, c and d are gloo ranks sharing "
                      "one card: gloo stages the halo exchanges through the "
                      "host; their ms per step is not a multi-card time"})
    return data, refs


# The parts of train_dp and train_spatial on 2 gloo ranks sharing the card
# (train_dp (b) and (d), train_spatial (a) and (d)) run in one spawn of
# PAIR_RANKS ranks, in that order: a spawn's process start and its first
# model's warm-up cost 30-45 s each time. train_dp (a)'s one NCCL rank and
# train_spatial (c)'s four gloo ranks run at once after the pair (neither
# is timed) while this process holds the pair's bf16 steps to their
# yardsticks. All three spawns start before this process computes the
# references, and each waits for its jobs in a file (waiting_rank) that
# this process writes when they are ready. While the pair runs its jobs
# (host-bound ranks, the card mostly idle) this process runs the phases
# that need neither rank (``meanwhile``); their times are taken beside
# the pair's.
PAIR_RANKS = 2
# the longest a spawn waits for its jobs
JOBS_WAIT_S = 900
# The share of the card's memory each process's allocator may hold. One
# card carries this process and up to seven ranks at once, and cuDNN takes
# as much workspace as it can allocate for a convolution's first plan (a
# rank of (c) held 53 of the card's 79 GiB that way while its peers held
# 2.4, and this process's RAFT forward beside it once ran out of memory).
# Capped, a plan whose workspace exceeds the share gives way to the next.
# Under the caps on an H100 80GB (700 W) a pair rank's job allocated at
# most 9.0 GiB and a side rank's 2.4, and this process's phases 16.
MAIN_MEMORY_SHARE = 0.40
PAIR_MEMORY_SHARE = 0.18
SIDE_MEMORY_SHARE = 0.10


def cap_memory(share):
    """This process's allocator holds at most ``share`` of card 0."""
    torch.cuda.set_per_process_memory_fraction(share, 0)


def waiting_rank(path, warm=True, share=SIDE_MEMORY_SHARE):
    """A rank that waits for the jobs at ``path`` (an empty list where the
    parent failed before it wrote them) and runs each (key, function, job)
    in turn: {"wait_s": s, "peak_gib": {key: [GiB allocated, reserved]},
    key: (result, seconds)}, its allocator held to ``share`` of the card.
    ``warm``: the card's context, cuBLAS and cuDNN first (not for train_dp
    (a), whose job sets cuBLAS's deterministic workspace before cuBLAS
    starts)."""
    import os
    import pickle
    import threading

    from cerberusnet_torch.entry import train_entry  # noqa: F401  imports

    dp_setup()
    cap_memory(share)
    if warm:
        x = torch.ones(1, 8, 16, 16, device="cuda:0")
        torch.nn.functional.conv2d(x, x[:, :, :3, :3].expand(8, 8, 3, 3))
        (x[0, 0] @ x[0, 0]).sum().item()
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > JOBS_WAIT_S:
            raise TimeoutError(f"no jobs at {path} in {JOBS_WAIT_S} s")
        time.sleep(0.2)
    with open(path, "rb") as f:
        jobs = pickle.load(f)
    out = {"wait_s": time.perf_counter() - t0, "peak_gib": {}}
    for key, fn, job in jobs:
        # the job's most allocated and reserved, sampled (a job may reset
        # the allocator's peaks); its cache goes back to the card after it
        peak, done = [0, 0], threading.Event()

        def sample():
            while not done.wait(0.05):
                peak[:] = [max(peak[0], torch.cuda.memory_allocated(0)),
                           max(peak[1], torch.cuda.memory_reserved(0))]

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        t0 = time.perf_counter()
        try:
            out[key] = (fn(job), time.perf_counter() - t0)
        finally:
            done.set()
            sampler.join()
        out["peak_gib"][key] = [b / 2**30 for b in peak]
        gc.collect()
        torch.cuda.empty_cache()
    return out


def start_ranks(fn, nprocs, args, backend, timeout):
    """``parallel.launch`` in a thread: a future of (the ranks' results, the
    launch's seconds)."""
    from cerberusnet_torch.parallel import launch

    def run():
        t0 = time.perf_counter()
        ranks = launch(fn, nprocs, args=args, backend=backend,
                       timeout=timeout)
        return ranks, time.perf_counter() - t0

    pool = ThreadPoolExecutor(1)
    future = pool.submit(run)
    pool.shutdown(wait=False)
    return future


def write_jobs(path, jobs):
    import os
    import pickle

    with open(f"{path}.part", "wb") as f:
        pickle.dump(jobs, f)
    os.replace(f"{path}.part", path)


def phase_ranks(card, dp_parts="abd", sp_parts="acd", meanwhile=None):
    """The train_dp and train_spatial phases: the parts of each named
    (train_dp's (c) and train_spatial's (b), on NCCL ranks a card each,
    run wherever there are two cards); each phase's lines, and its
    closing line, then exit 1 if either failed. ``meanwhile`` (phases of
    this process) runs once the pair has its jobs. Returns the counts of
    train_dp (b)'s ranks and of train_spatial's bf16 launches by part and
    model."""
    import shutil
    import tempfile

    from cerberusnet_torch.data.loader import batches
    from cerberusnet_torch.entry import train_entry

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    two_cards = torch.cuda.device_count() >= DP_RANKS
    pair_keys = ([f"dp_{p}" for p in "bd" if p in dp_parts]
                 + [f"sp_{p}" for p in "ad" if p in sp_parts])
    pair_sp = [n for p in "ad" if p in sp_parts for n in SP_PARTS[p]]
    sp_names = list(dict.fromkeys(
        [n for p in sp_parts for n in SP_PARTS[p]]
        + (list(SP_PARTS["b"]) if sp_parts and two_cards else [])))
    root = tempfile.mkdtemp(prefix="cerberus_ranks_")
    paths = {k: f"{root}/{k}_jobs.pkl" for k in ("pair", "dp_a", "sp_c")}
    dp_errors, sp_errors, counts = [], [], {}
    spawns, written = {}, set()

    def write(key, jobs):
        if key in spawns and key not in written:
            write_jobs(paths[key], jobs)
            written.add(key)

    try:
        # before the spawns: it sets the environment the ranks inherit
        if "a" in dp_parts:
            dp_a = dp_part_a_reference()
        timeout = JOBS_WAIT_S + SP_TIMEOUT_S
        if pair_keys:
            spawns["pair"] = start_ranks(
                waiting_rank, PAIR_RANKS,
                (paths["pair"], True, PAIR_MEMORY_SHARE), "gloo", timeout)
        if "a" in dp_parts:
            spawns["dp_a"] = start_ranks(waiting_rank, 1,
                                         (paths["dp_a"], False), "nccl",
                                         timeout)
        if "c" in sp_parts:
            spawns["sp_c"] = start_ranks(waiting_rank, SP_UNEQUAL_RANKS,
                                         (paths["sp_c"],), "gloo", timeout)
        jobs = []
        if "b" in dp_parts or (dp_parts and two_cards):
            dataset = train_entry(DP_CONFIG, batch_size=DP_BATCH,
                                  n_batches=0)[0]
            batch = batches(dataset.dataset, DP_BATCH, 1)[0]
            del dataset
            dp_refs = dp_single_refs(batch)
        if "b" in dp_parts:
            jobs.append(("dp_b", dp_rank,
                         dp_job(batch, dp_refs, "cuda:0")))
        if "d" in dp_parts:
            ckpt = f"{root}/dp_ckpt"
            refused, errs = dp_part_d_refusal(ckpt)
            dp_errors += errs
            jobs.append(("dp_d", dp_fit_rank,
                         {"ckpt_dir": ckpt, "device": "cuda:0"}))
        data, refs = sp_references(sp_names, card)
        if pair_sp:
            jobs.append(("sp", sp_rank, sp_job(
                pair_sp, data, refs, root, "cuda:0", PAIR_RANKS)))
            jobs.append(("sp_resize", sp_band_resizes, {
                "frames": SP_RESIZE_FRAMES["pair"], "device": "cuda:0",
                "ranks": PAIR_RANKS}))
        if pair_keys:
            write("pair", jobs)
        if meanwhile is not None:
            meanwhile()
        if pair_keys:
            pair_ranks, pair_s = spawns["pair"].result()
            emit({"phase": "train_spatial", "part": "pair", "ranks":
                  PAIR_RANKS, "backend": "gloo", "device": "cuda:0",
                  "seconds": pair_s, "jobs": pair_keys,
                  "wait_s": [r["wait_s"] for r in pair_ranks],
                  "job_s": {k: [r[k][1] for r in pair_ranks]
                            for k, *_ in jobs},
                  "job_peak_gib": {k: [r["peak_gib"][k] for r in pair_ranks]
                                   for k, *_ in jobs}})
        # the card is theirs now: (a) and (c), the yardsticks meanwhile
        if "a" in dp_parts:
            write("dp_a", [("dp_a", dp_one_rank, dp_a[0])])
        if "c" in sp_parts:
            write("sp_c", [("sp_c", sp_rank, sp_job(
                SP_PARTS["c"], data, refs, root, "cuda:0",
                SP_UNEQUAL_RANKS)), ("sp_resize", sp_band_resizes, {
                    "frames": SP_RESIZE_FRAMES["c"], "device": "cuda:0",
                    "ranks": SP_UNEQUAL_RANKS})])
        yard = {n: sp_yardsticks(n, data[n], root) for n in pair_sp
                if SP_MODELS[n][2]}
        side = {k: spawns[k].result() for k in ("dp_a", "sp_c")
                if k in spawns}

        if "a" in dp_parts:
            (rank,), _ = side["dp_a"]
            dp_errors += dp_part_a_report(dp_a, rank["dp_a"][0])
        if "b" in dp_parts:
            ranks = [r["dp_b"][0] for r in pair_ranks]
            errs, counts["train_dp"] = dp_ranks_report(
                "b", ranks, max(r["dp_b"][1] for r in pair_ranks),
                dp_refs[2], "gloo")
            dp_errors += errs
        if dp_parts and two_cards:
            dp_errors += dp_ranks_part("c", batch, dp_refs, "nccl",
                                       "cuda")[0]
        elif dp_parts:
            emit({"phase": "train_dp", "part": "c", "skipped": True,
                  "why": f"{torch.cuda.device_count()} CUDA device(s) "
                         f"visible; two NCCL ranks need {DP_RANKS}"})
        if "d" in dp_parts:
            dp_errors += dp_part_d_report(
                card, refused, ckpt, [r["dp_d"][0] for r in pair_ranks],
                max(r["dp_d"][1] for r in pair_ranks))
    finally:
        # a spawn whose jobs were never written (this process failed
        # first) gets none and ends; every spawn has ended before its
        # files go
        for key in spawns:
            write(key, [])
        for future in spawns.values():
            future.exception()
        shutil.rmtree(root, ignore_errors=True)
    if dp_parts:
        emit({"phase": "train_dp", "ok": not dp_errors, "parts": dp_parts,
              "config": DP_CONFIG, "hw": list(HW), "dtype": "bfloat16",
              "seconds": time.perf_counter() - t_phase,
              "errors": dp_errors})

    for part in "adc" if sp_parts else "":
        if part not in sp_parts:
            continue
        if part == "c":
            ranks = [r["sp_c"][0] for r in side["sp_c"][0]]
            ranks_s = max(r["sp_c"][1] for r in side["sp_c"][0])
        else:
            ranks = [r["sp"][0] for r in pair_ranks]
            ranks_s = max(r["sp"][1] for r in pair_ranks)
        errs, counts[f"sp_{part}"] = sp_report(part, ranks, ranks_s, yard,
                                               refs, "gloo")
        sp_errors += errs
    if sp_parts:
        resized = {}
        if pair_sp:
            resized["pair"] = [r["sp_resize"][0] for r in pair_ranks]
        if "c" in sp_parts:
            resized["c"] = [r["sp_resize"][0] for r in side["sp_c"][0]]
        sp_errors += sp_resize_report(resized)
    if sp_parts and two_cards:
        sp_errors += sp_part("b", "nccl", "cuda", data, refs)[0]
    elif sp_parts:
        emit({"phase": "train_spatial", "part": "b", "skipped": True,
              "why": f"{torch.cuda.device_count()} CUDA device(s) visible; "
                     f"{SP_RANKS} NCCL ranks need {SP_RANKS}"})
    if sp_parts:
        emit({"phase": "train_spatial", "ok": not sp_errors,
              "parts": sp_parts,
              "side_job_peak_gib": {k: [r["peak_gib"] for r in v[0]]
                                    for k, v in side.items()},
              "models": {n: SP_MODELS[n][0] for n in data},
              "hw": list(HW), "offgrid_hw": list(SP_OFFGRID_HW),
              "batch": TRAIN_BATCH, "ranks": SP_RANKS,
              "unequal_ranks": SP_UNEQUAL_RANKS, "f32_steps": 1,
              "steps": SP_STEPS, "seconds": time.perf_counter() - t_phase,
              "errors": sp_errors})
    if dp_errors or sp_errors:
        sys.exit(1)
    return counts


def path_numbers(checks, name, path, batch, launches):
    """A kernel's numbers on one path: its calls there ("cerberus": the
    five levels; "dcv": the dilations) in bf16 at that path's batch,
    summed, with the path's launch count and the per-call rows under
    "shapes"."""
    rows = [c for c in checks if c["kernel"] == name and c["path"] == path
            and c["batch"] == batch and c["dtype"] == "bfloat16"]
    bound = sum(r["bound_ms"] for r in rows)
    by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    padded = ({"padded_bound_ms": sum(r.get("padded_bound_ms", r["bound_ms"])
                                      for r in rows)}
              if any("padded_bound_ms" in r for r in rows) else {})
    return {
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": bound,
        "bound_by": "bytes" if by_bytes >= bound / 2 else "operations",
        **padded,
        "batch": batch,
        "eager_ms": sum(r["eager_ms"] for r in rows),
        "plain_eager_ms": sum(r["plain_eager_ms"] for r in rows),
        "shapes": [{k: r[k] for k in (
            "level", "shape", "max_disp", "dilation", "design", "ms", "ms_min",
            "ms_max", "eager_ms", "plain_ms", "plain_eager_ms", "bound_ms",
            "bound_by", "padded_bound_ms", "max_abs_err") if k in r}
            for r in rows],
    }


def level_numbers(checks, name, batch, counts):
    """A fused-level kernel's numbers on one path: its three level calls in
    bf16 at that path's batch (3 frames served, 6 trained), summed, with
    the path's launch count, the time over the plain (cuDNN) level's, K10's
    weight-gradient partial bytes per step as its wrapper counted them on
    the path, and the per-level rows under "shapes" (each with its vs_plain
    and, for K10, the partial bytes counted in its check)."""
    rows = [c for c in checks if c["kernel"] == name and c["level"] > 0
            and c["batch"] == batch and c["dtype"] == "bfloat16"]
    bound = sum(r["bound_ms"] for r in rows)
    by_bytes = sum(r["bound_ms"] for r in rows if r["bound_by"] == "bytes")
    ms, plain_ms = sum(r["ms"] for r in rows), sum(r["plain_ms"] for r in rows)
    out = {
        "launches": counts[name],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": ms, "plain_ms": plain_ms, "vs_plain": ms / plain_ms,
        "bound_ms": bound,
        "bound_by": "bytes" if by_bytes >= bound / 2 else "operations",
        "batch": batch,
        "shapes": [{k: r[k] for k in (
            "level", "shape", "design", "ms", "ms_min", "ms_max", "plain_ms",
            "vs_plain", "bound_ms", "bound_by", "max_abs_err",
            "partial_bytes") if k in r} for r in rows],
    }
    if name == "encoder_level_bwd":
        out["partial_bytes"] = (counts["encoder_level_bwd_partial_bytes"]
                                // TRAIN_STEPS)
    return out


def summary(checks, counts):
    """One entry per kernel. A correlation kernel's numbers are the
    CerberusNet train path's (batch 2), where all six run: launches from
    that path's run, times and bounds from its shapes. A forward's
    serve-path numbers (batch 1) and every kernel's on the fit path (batch
    4 at 128x256, launches over the whole fit run) stand under "paths"
    beside them, and each
    kernel's numbers on the DCV paths, by dilation, under "dcv". The fused
    level kernels' numbers are the train_pallas_levels path's (the three
    levels at batch 6), with K9's serve_pallas_levels numbers (batch 3)
    under "paths". No single library call computes a correlation or a
    whole level (the plain level is three cuDNN convolutions and two
    LeakyReLUs, its plain_ms), so library_ms is null. counts: {phase:
    the wrappers' counters over its run}."""
    from cerberusnet_torch.ops.cuda import encoder_level as cl

    entries = []
    for name, replaces in REPLACES.items():
        train = path_numbers(checks, name, "cerberus", TRAIN_BATCH,
                             counts["train"][name])
        paths = {"train": {k: v for k, v in train.items() if k != "shapes"}}
        dcv = {"train_dcv": path_numbers(checks, name, "dcv", TRAIN_BATCH,
                                         counts["train_dcv"][name])}
        if counts["serve"][name]:
            serve = path_numbers(checks, name, "cerberus", 1,
                                 counts["serve"][name])
            paths["serve"] = {k: v for k, v in serve.items() if k != "shapes"}
            dcv["serve_dcv"] = path_numbers(checks, name, "dcv", 1,
                                            counts["serve_dcv"][name])
        fit = path_numbers(checks, name, "fit", FIT_BATCH,
                           counts["fit"][name])
        paths["fit"] = {k: v for k, v in fit.items() if k != "shapes"}
        # the data slice's paths where the kernel runs: the shapes the
        # kernels phase checked for each, the launches from its run
        for phase, path, batch in (
                ("train_flow_kitti", "kitti", TRAIN_BATCH),
                ("train_stereo_kitti", "kitti", TRAIN_BATCH),
                ("fit_dcv_kitti", "dcv_kitti", DCV_KITTI_BATCH),
                ("serve_flow", "cerberus", 1),
                ("serve_stereo", "cerberus", 1),
                # the evaluation slice's: the launches of each phase's run
                # beside the shapes the kernels phase timed for it (TTA's
                # three frames once each, a run making two passes of each)
                ("train_flyingthings3d", "things", TRAIN_BATCH),
                ("train_losses", "cerberus", TRAIN_BATCH),
                ("eval_tta", "tta", 1),
                ("tiled_sequential", "cerberus", 1),
                ("tiled", "tiles", N_TILES),
                ("predict", "dcv_kitti", DCV_KITTI_BATCH),
                ("predict_images", "cerberus", 1),
                # the deployment slice's: a call of each loaded artifact,
                # the int8 forward, the QAT run's steps
                ("export_cerberus", "cerberus", 1),
                ("export_stacked", "cerberus", 1),
                ("export_pallas_levels", "cerberus", 1),
                ("quant_int8", "cerberus", 1),
                ("train_qat", "cerberus", TRAIN_BATCH),
                # the C++ runner's: a call of each package, the launches
                # as its operator library counted them
                ("runner_cerberus", "cerberus", 1),
                ("runner_stacked", "cerberus", 1),
                ("runner_pallas_levels", "cerberus", 1),
                ("runner_int8", "cerberus", 1),
                # the bench's headline: every call of its run
                ("bench", "cerberus", 1),
                # the data-parallel step: each rank's calls at the train
                # path's shapes, the launches of (b)'s ranks summed
                ("train_dp", "cerberus", TRAIN_BATCH),
                # the spatial axis: each rank's calls on its haloed band,
                # the launches of both ranks' bf16 steps summed
                ("train_spatial", "spatial", TRAIN_BATCH)):
            if counts[phase][name]:
                paths[phase] = path_numbers(checks, name, path, batch,
                                            counts[phase][name])
        for phase in ("export_cerberus_dcv", "runner_cerberus_dcv"):
            if counts[phase][name]:
                dcv[phase] = path_numbers(checks, name, "dcv", 1,
                                          counts[phase][name])
        # the stream: each model's forwards over its whole run (warm-up,
        # streamed frames, device-resident frames), at serve's shapes and
        # the fast model's
        if counts["stream_cerberus"][name]:
            paths["stream"] = path_numbers(checks, name, "cerberus", 1,
                                           counts["stream_cerberus"][name])
            paths["stream_fast"] = path_numbers(checks, name, "fast", 1,
                                                counts["stream_fast"][name])
            dcv["stream"] = path_numbers(checks, name, "dcv", 1,
                                         counts["stream_dcv"][name])
        # CerberusDCV's calls on a rank's (haloed) band of level 3, the
        # launches of both ranks' bf16 steps summed
        if counts["train_spatial_dcv"][name]:
            dcv["train_spatial"] = path_numbers(
                checks, name, "spatial_dcv", TRAIN_BATCH,
                counts["train_spatial_dcv"][name])
        # part (d)'s: rank 0's calls on its haloed band of 368x768's level
        # 3, the launches of both ranks' bf16 steps summed
        if counts["train_spatial_offgrid"][name]:
            dcv["train_spatial_offgrid"] = path_numbers(
                checks, name, "spatial_dcv_offgrid", TRAIN_BATCH,
                counts["train_spatial_offgrid"][name])
        dils = (DCV_FLOW_DILATIONS if name.startswith("corr2d")
                else DCV_DISP_DILATIONS)
        entries.append({
            "name": name, "route": "cuda",
            "source": "cerberusnet_torch/csrc/correlation.cu",
            "replaces": replaces, "library_ms": None, **train,
            "paths": paths,
            "dcv": {"replaces": DCV_REPLACES.get(name),
                    "dilations": list(dils), "paths": dcv}})
    for name, replaces in cl.REPLACES.items():
        train = level_numbers(checks, name, TRAIN_FRAMES,
                              counts["train_pallas_levels"])
        paths = {"train_pallas_levels": {
            k: v for k, v in train.items() if k != "shapes"}}
        if name == "encoder_level_fwd":
            serve = level_numbers(checks, name, SERVE_FRAMES,
                                  counts["serve_pallas_levels"])
            paths["serve_pallas_levels"] = serve
            for phase in ("export_pallas_levels", "runner_pallas_levels"):
                paths[phase] = level_numbers(checks, name, SERVE_FRAMES,
                                             counts[phase])
        entries.append({
            "name": name, "route": "cuda",
            "source": "cerberusnet_torch/csrc/encoder_level.cu",
            "replaces": replaces, "library_ms": None, **train,
            "paths": paths})
    emit({"kernels": entries})


def main(argv):
    # --only a,b,...: env, build and the named phases alone (the data
    # slice's need "data", which writes their fixtures and runs with them),
    # no summary and no result line: for working on a phase
    only = set(argv[1].split(",")) if argv[:1] == ["--only"] else None

    def wanted(phase):
        return only is None or phase in only

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import cerberusnet_torch  # noqa: F401  fails where the port is absent

    import shutil
    import tempfile

    t0 = time.perf_counter()
    # f32 results are compared on the card: keep cuDNN and cuBLAS in full
    # f32 (no TF32). bf16 runs are unaffected.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from cerberusnet_torch.utils.flops import card_peaks

    card, name = phase_env()
    cap_memory(MAIN_MEMORY_SHARE)
    peaks = card_peaks(name)
    if peaks is None:
        fail("env", f"no published peaks known for {name!r}")
    phase_build()
    import threading

    stop_watch = threading.Event()
    threading.Thread(target=watch_card_memory, args=(stop_watch,),
                     daemon=True).start()
    counts = {}
    # serve, stream and bench time host-bound forwards against each other
    # (bench's band against serve, serve_arithmetic's fused against naive),
    # so they run first, before any compile shares the host. The deployment
    # slice's artifacts are kept to the runner phase, which comes last: its
    # AOTInductor compiles (minutes of host work, the float artifacts' the
    # longest chain of the script) start as soon as their artifacts exist,
    # so export runs next, and they run beside every later phase
    root = tempfile.mkdtemp(prefix="cerberus_deploy_")
    try:
        if wanted("serve"):
            counts["serve"] = phase_serve("serve")
        if wanted("stream"):
            counts.update(phase_stream(card))
        if wanted("bench"):
            counts["bench"] = phase_bench(card, peaks)
        batches = export_phases(card, counts, wanted, root)
        spin_rate = sleep_cycles_per_ms()
        checks = (phase_kernels(peaks, spin_rate) if wanted("kernels")
                  else [])
        batches += deployment_phases(card, counts, wanted, root)
        for phase in ("train", "serve_dcv", "train_dcv",
                      "serve_pallas_levels", "train_pallas_levels"):
            if wanted(phase):
                run = phase_serve if phase in SERVE else phase_train
                counts[phase] = run(phase)
        if wanted("fit"):
            counts["fit"] = phase_fit(card)
        dp_parts = ("abd" if wanted("train_dp") else "c"
                    if only is not None and "train_dp_cards" in only else "")
        sp_parts = ("acd" if wanted("train_spatial") else "b"
                    if only is not None and "train_spatial_cards" in only
                    else "")

        def later():
            # the phases that need neither rank: beside the pair's jobs
            for phase in (phase_serve_raft, phase_train_raft,
                          phase_fit_raft):
                if wanted(phase.__name__[len("phase_"):]):
                    phase(card)
            data_phases(card, counts, wanted)

        if dp_parts or sp_parts:
            runs = phase_ranks(card, dp_parts, sp_parts, meanwhile=later)
            if "train_dp" in runs:
                counts["train_dp"] = runs["train_dp"]
            if "sp_a" in runs:
                counts["train_spatial"] = runs["sp_a"]["cerberus"]
                counts["train_spatial_dcv"] = runs["sp_a"]["cerberus_dcv"]
            if "sp_d" in runs:
                counts["train_spatial_offgrid"] = runs["sp_d"][
                    "cerberus_dcv_offgrid"]
        else:
            later()
        if wanted("runner"):
            record_launches(counts, phase_runner(card, root, batches))
    finally:
        stop_watch.set()
        stop_background()
        shutil.rmtree(root, ignore_errors=True)
    total = torch.cuda.mem_get_info(0)[1] / 2**30
    emit({"phase": "card_memory", "total_gib": total,
          "every_s": CARD_MEMORY_EVERY_S, **CARD_MEMORY,
          "after": None})
    if only is not None:
        emit({"phase": "done", "only": sorted(only),
              "seconds": time.perf_counter() - t0})
        return 0
    summary(checks, counts)
    emit({"phase": "done", "ok": True,
          "seconds": time.perf_counter() - t0})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


def record_launches(counts, runs):
    """counts gains each run's launches by kernel (a loaded artifact's per
    call)."""
    kernels = list(launch_counts())
    counts.update({phase: {k: launches.get(k, 0) for k in kernels}
                   for phase, launches in runs.items()})


def export_phases(card, counts, wanted, root):
    """The export phase, its artifacts under root; counts gains each
    artifact's launches. Starts the runner's AOTInductor compiles of the
    four float artifacts, one after the other (the longest chain), and
    returns them (``start_packaging``'s)."""
    runs, batches = {}, []
    if wanted("export"):
        runs.update({f"export_{k}": v
                     for k, v in phase_export(card, root).items()})
        if wanted("runner"):
            batches.append(start_packaging(
                root, [n for n in RUNNER_ARTIFACTS if n != "int8"]))
    record_launches(counts, runs)
    return batches


def deployment_phases(card, counts, wanted, root):
    """The deployment slice's other phases but the runner, their artifacts
    under root; counts gains each path's launches. Starts the runner's
    AOTInductor compile of int8's artifact after quant_int8 and returns it
    (``start_packaging``'s)."""
    runs, batches = {}, []
    if wanted("quant_int8"):
        runs.update(phase_quant_int8(card, root))
        if wanted("runner"):
            batches.append(start_packaging(root, ("int8",)))
    if wanted("train_qat"):
        runs["train_qat"] = phase_train("train_qat")
    if wanted("debug_nans"):
        phase_debug_nans(card)
    record_launches(counts, runs)
    return batches


def data_phases(card, counts, wanted):
    """The data slice's phases on fixtures written to a temporary directory
    (removed at the end): data first, which writes them."""
    import shutil
    import tempfile

    names = ("train_flow_kitti", "train_stereo_kitti", "train_seg_aspp",
             "fit_dcv_kitti", *SERVE_SINGLE)
    # the evaluation slice's, after flow_data (which writes the flow sets'
    # fixtures)
    evaluation = ("train_flyingthings3d", "train_losses", "eval_tta",
                  "tiled", "predict", "cli")
    if not any(wanted(n) for n in ("data", *names, "flow_data",
                                   *evaluation)):
        return
    root = tempfile.mkdtemp(prefix="cerberus_fixtures_")
    try:
        phase_data(card, root)
        cli = start_cli(root) if wanted("cli") else None
        for phase in names:
            if not wanted(phase):
                continue
            if phase in TRAIN:
                counts[phase] = phase_train(phase)
            elif phase in SERVE_SINGLE:
                counts[phase] = phase_serve_single(phase, card)
            elif phase == "train_seg_aspp":
                counts[phase] = phase_train_seg_aspp(card)
            else:
                counts[phase] = phase_fit_dcv_kitti(card)
        if wanted("flow_data") or wanted("train_flyingthings3d"):
            phase_flow_data(card, root)
        for phase in evaluation:
            if not wanted(phase):
                continue
            if phase in TRAIN:
                counts[phase] = phase_train(phase)
            elif phase == "train_losses":
                counts[phase] = phase_train_losses(card)
            elif phase == "eval_tta":
                counts[phase] = phase_eval_tta(card)
            elif phase == "tiled":
                runs = phase_tiled(card)
                counts["tiled_sequential"] = runs["sequential"]
                counts["tiled"] = runs["batched"]
            elif phase == "predict":
                runs = phase_predict(card, root)
                counts["predict"] = runs["dcv_flow_kitti"]
                counts["predict_images"] = runs["predict_images"]
            else:
                phase_cli(card, cli)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
