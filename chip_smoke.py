#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dear_pytorch_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card (Hopper):

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, so any failure exits
non-zero and no result line is printed):

  1. require CUDA; print the card's name and power limit; turn TF32 off;
  2. build every kernel of the serving and training paths from ``csrc/``
     with nvcc, one process per source, all started together (flash_fwd,
     flash_bwd, fused_update, ring, ring_matmul, overhead_probe);
  3. hold each kernel against its plain PyTorch version on the card:
     - K1, the flash-attention forward, by route (`fwd_route`: every
       call checked to launch once through the route it should take —
       tensor cores for bf16 in and out at D = 64, split-K for one query
       row, CUDA cores otherwise): decode and causal-prefill shapes,
       ragged lengths, Sq != Sk, an all-masked row, a decode whose whole
       128-key splits are masked, D = 40 and 128, the train shape at B = 8;
       fp32 within 2e-5 — summation order — and bf16 within 2e-2 — output
       rounding; fp32 outputs and every route's lse within 2e-5 and 2e-4;
     - K2 and K3, the backward's dQ and dK/dV, by route (`bwd_route`:
       every call checked to launch through the route it should take —
       tensor cores for bf16 in and out at D = 64, CUDA cores otherwise):
       the training shape [4, 1024, 12, 64] causal, a holey mask, ragged
       S = 13 and 136, an all-masked row, D = 128 and 40, Sq = 192 with
       Sk = 320, a causal S = 200, and a whole 128-key tile masked (its
       keys' gradients exactly 0); the largest error over the largest
       |plain value|, at most 1e-4 in fp32 — summation order over up to
       1024 keys — and 2e-2 in bf16 — P and dS rounded to bf16 on the
       tensor cores, and output rounding; bf16 inputs with fp32 outputs
       (ring attention's ``out_dtype``, the CUDA-core route; within 1e-4);
       the train case twice on the same inputs, bitwise equal, on both
       routes; and autograd through K1+K2+K3 against autograd through the
       plain forward;
     - the shard update (the K5 epilogue): bitwise, SGD (momentum, its
       first and second step; nesterov with weight decay) and AdamW, on a
       ragged shard and a 25 MB one, bf16 and fp32 gradients, with and
       without a clip scale;
     - K4 (ring all-gather) and the K5 ring (reduce-scatter + update) on a
       one-process `LocalRing`, bitwise against their stacked plain
       versions, every call's route checked: W = 2, 4, 8, a ragged shard
       (the scalar width), two short shards with empty trailing blocks
       and a 25 MB bucket's shard (the vector width: bulk copies), fp32
       and bf16, K4 on its slot route and twice on its direct route into
       registered outputs, SGD, SGD momentum (two steps), nesterov +
       weight decay, AdamW with an lr schedule; and every shard size of
       the training run's plan at W = 2;
     - K6, K7 and K8 (the ring collective matmul: forward, dx, dw) on a
       `LocalRing` against their stacked plain versions, within
       `_CM_RTOL` of the largest plain value (8e-3 for bf16 outputs, 1e-5
       for fp32, TF32 off), every K6/K7 call checked to take the route
       `cm_core` names (wgmma for bf16 with kc and N multiples of 8, mma
       for fp32 and ragged shapes): W = 2, 4, 8 on ragged and aligned
       shapes, fp32 and bf16, the main path's M = 8192, K = 768, N = 768
       and 3072 in bf16 at W = 2 (twice) and at W = 4 and 8 (kc = 192 and
       96), and M = 4 at W = 2; every wgmma-route case and every main
       shape twice on the same inputs, bitwise equal;
     - K9, the overhead probe's ``2x + 1``: bitwise against its plain
       version and against ``torch.add(one, x, alpha=2.0)`` at grids of 16
       x (1024, 512), 2048 x (8, 512) and 33 x (8, 512), with infinities,
       overflow, signed zeros and subnormals among the inputs;
     and again at the main paths' own shapes in phases 5 and 6: K1 at
     decode B = 4, train [16, 1024, 12, 64] and [8, ...] bf16 causal
     (tensor cores) and at the fp32 step's [2, 1024, 12, 64] (CUDA
     cores), K6 and K7 at three tile widths, K8 under several cuts of its
     reduction, K2 and K3 by
     route at the train shape, the shard update at every shard size of
     the training run's plan with its optimizer; the kernels line reports the largest
     error of all of these;
  4. serve GPT-2 small at full width (random weights from a seed) through
     `DecodeEngine` with ``decode_use_flash=True`` — fp32 at
     ``prefill_chunk`` 1 and 16, then bf16 — and check that every request
     finishes, that the flash kernel ran 12 times per decode tick, all of
     them through its split-K route (12 per bf16 tick), and that
     the fp32 tokens equal the port's own greedy `generate` (a divergence
     is accepted only at a near-tie: top-2 logit gap < 1e-3);
  5. train GPT-2 small at full width through the port's training CLI
     (``benchmarks/gpt.py --fp16 --flash-attention --dropout0``, batch 16,
     S = 1024, the DeAR schedule over a one-rank NCCL group) for 20 steps:
     the losses are finite and fall, and every step launches K1, K2 and
     K3 12 times each (all through their tensor-core routes) and one shard
     update, reduce-scatter and all-gather per bucket; then one fp32 step
     with the flash kernels (K1, K2 and K3 through their CUDA-core routes,
     once per layer each)
     against one with the dense attention core (2 layers, batch 2), and 3
     steps with the CLI's default dropout;
  5b. train it at world 2 as two processes sharing the card (this script
     with ``--train-rank R --out DIR --mode M[,M...]``, the three runs
     below in one process per rank since slice 19; the ``DEAR_*`` launcher
     variables, a ``file://`` store, card ``r % device_count``), 8
     sequences per rank, 6 steps (20 before slice 17, 10 before slice 18
     cut it for time),
     with ``--mode dear-fused`` (every
     step on each rank: K1, K2 and K3 12 times each (tensor cores), K4
     once per bucket on its direct route and the K5 ring once per bucket
     on its vector width, no separate update), again with
     ``--mode dear-fused
     --ring-projections`` (each rank first holds K6–K8 against their plain
     versions on its own IPC ring at the main path's shapes; then every
     step also launches K6, K7 and K8 48 times each, K6 and K7 all on the
     wgmma route) and with ``--mode
     dear``: losses finite, falling and equal on both ranks, both ranks'
     gathered parameters bitwise equal, dear-fused's last loss within
     `_FUSED_VS_DEAR_RTOL` of dear's and the ring-projection run's within
     `_RP_VS_FUSED_RTOL` of dear-fused's; each rank records its peak
     memory (``max_memory_allocated``, reset before the run); a rank's
     failure fails the run;
  5c. run the overhead probe as a user runs it on the card
     (``dear_pytorch_tpu_torch.scripts.overhead_probe``, `probe.main`):
     both sections in this process (K9 at its two granularities, 2 x 41
     launches; K4 and the K5 ring at 65536 and 1024 elements on a two-rank
     `LocalRing`, 22 launches each), then its kernel section again as two
     processes sharing the card (this script with ``--probe-rank R --out
     DIR``; the launcher variables, the IPC `Ring`, 12 launches each per
     rank); prints each ring call's time on both transports and the
     difference, the cost of pairing a call across two contexts;
  5d. train ResNet-50 at full width through the port's ImageNet CLI
     (``benchmarks/imagenet.py --model resnet50 --batch-size 64 --fp16
     --mode dear --threshold 25``: bf16, 224², BatchNorm state, 5 buckets,
     a one-rank NCCL group) for 20 steps: every step launches the K5
     epilogue and runs a shard update and a reduce-scatter once per
     bucket, the losses are finite and fall, every BN buffer is finite and
     moved from its init; prints the bucket count and the peak memory
     beside the card's name and power limit; holds the shard update
     bitwise at the plan's shard sizes; then ResNet-50 in fp32 (TF32 off,
     train mode, B = 2) from the run's weights on the card against the
     CPU: logits and updated BN buffers within `_RESNET_CPU_RTOL`;
  5e. train BERT-Base through the port's BERT CLI (``benchmarks/bert.py
     --model bert_base --fp16``, batch 32): with ``--flash-attention
     --dropout0 --mfu`` at S = 128 for 20 steps, every step launching K1,
     K2 and K3 12 times each on their tensor-core routes and the K5
     epilogue, a reduce-scatter and an all-gather once per bucket, the
     losses finite and falling, the counted FLOPs the dense model's plus
     K2 and K3's recomputation; step 1's loss against a dense-attention
     step on the same weights and batch within `_BERT_FLASH_VS_DENSE_RTOL`;
     then the bench's configuration (S = 64, dropout 0.1) and the flash
     impl under dropout, neither launching an attention kernel (phase 3
     holds K1, K2 and K3 at BERT's shapes too: B = 32, S = 64 and 128,
     non-causal, per-row key lengths and a full mask);
  5f. train ViT-B/16 through the ImageNet CLI (``--model vit_b16
     --batch-size 64 --fp16 --mfu``, 224²) for 20 steps: the K5 epilogue
     once per bucket per step, the losses finite and falling, the counted
     FLOPs equal to `bench.vit_step_flops`; then ViT-B/16 in fp32 (TF32
     off, B = 2) from the run's weights on the card against the CPU:
     logits within `_VIT_CPU_RTOL`;
  5g. run the port's bench entry as a user runs it (``python -m
     dear_pytorch_tpu_torch.bench``, a process of its own; its timed
     window runs through ``TrainStep.multi_step(10)``, `_BENCH_ITERS`
     timed iterations of it per model, not the bench's 10, for the time
     limit): exit 0, one
     parsable last line with bench.py's five metrics, names and units,
     each with a numeric value, MFU and peak memory and no error entry,
     each counted step within `_BENCH_FLOPS_RTOL` of its analytic count;
     re-prints the line and a line per model;
  5h. train the rest of the zoo through the ImageNet CLI (bf16, ``mode
     dear``, 25 MB buckets, SGD 0.01 momentum 0.9, ``--mfu``, 20 steps):
     DenseNet-201 at B = 32 and Inception-v4 at B = 64 on 299² (the
     reference sweep's batches) and VGG-16 at B = 64 with its dropout:
     every step launches the K5 epilogue once per bucket (VGG-16's fc1 a
     bucket of its own, 102,764,544 elements, held bitwise with the rest
     of each plan's shard sizes), the losses are finite, every parameter
     moved, the loss without dropout on the run's batch falls to
     `_ZOO_LOSS_FALL` of its init value and ends below it, the BN
     buffers finite and moved, the counted FLOPs within
     `_BENCH_FLOPS_RTOL` of the analytic count; prints step p50/p99,
     img/s, MFU and a 2-step trace's idle share; then each model in fp32
     on the card against the CPU (B = 2; train and eval mode with BN, eval
     for VGG): logits and BN buffers within `_ZOO_CPU_RTOL`;
  5i. the MNIST example (``examples/mnist.py --data synthetic``, 2
     epochs): one K5 epilogue per step, held-out accuracy above 0.9;
  5j. serve BERT-Base at full width through `DecodeEngine` with
     ``decode_use_flash=True`` (ring 512, 4 slots), fp32 and bf16, at
     ``prefill_chunk`` 1 and 8: K1 12 times per decode tick, all on its
     split-K route; one causal full forward over each request's prompt
     and tokens scores every generated token: the forward's argmax at
     its position, or within a near-tie of it (`_bert_tie`);
  5k. train BERT-Large (``benchmarks/bert.py --model bert --mode
     dear-fused``, 8 x 64 per rank, 6 steps) as two ranks sharing the
     card (this script with ``--bert-rank R --out DIR --mode M``), without
     and with ``--ring-projections``: K4 and the K5 ring once per bucket
     per step; with ring projections each rank first holds K6–K8 on its
     IPC ring at BERT-Large's shapes (K = 1024, N = 1024 and 4096), then
     every step launches K6, K7 and K8 96 times each, K6 and K7 on the
     wgmma route; the ranks' losses and parameters equal, the last loss
     with ring projections within `_BERT_RP_VS_FUSED_RTOL` of the one
     without;
  5l. the baseline schedules: two ranks sharing the card (this script with
     ``--modes-rank R --out DIR``, one pair of processes and one gloo
     group for every run) train GPT-2 as in 5b, 4 steps per run (6 before
     slice 17 cut it for time), with
     ``--mode fsdp``, ``allreduce``, ``rsag``, ``rb``, ``bytescheduler
     --partition 4`` and ``dear --exclude-parts reducescatter`` /
     ``allgather``: every step on each rank K1, K2 and K3 12 times each
     (tensor cores), the K5 epilogue once per bucket (whole buckets in the
     replicated modes) and the schedule's collectives as the port's
     dear.py docstring tabulates; for the modes finite, falling losses
     equal on both ranks, gathered parameters bitwise equal on both ranks
     and the step-4 loss within `_FUSED_VS_DEAR_RTOL` of 5b's dear run
     at step 4; fsdp's peak memory below that dear run's by at least
     half of (the bf16 full buckets' bytes - the largest bucket's); then
     the `Communicator` over the two ranks' gloo group, every method's
     result equal to its definition. Then one rank on NCCL: dear and each
     new mode 5 steps through the CLI (B = 4, bf16; fsdp's buckets in fp32,
     cast again in the backward), every step checked, each mode's losses
     within `_FUSED_VS_DEAR_RTOL` of dear's; the `Communicator` (2
     streams) through every method, handles round-robin, results the
     world-1 identities (the same check as the two ranks'); the K5 epilogue bitwise
     at the two-rank plan's whole-bucket sizes;
  5m. compression, LAMB and remat: the six compressors on the card against
     the same compressor on a CPU copy (ResNet-50's largest bucket, 6.3M
     fp32 with a zero tail, density 0.01): indices, values, residuals,
     sign words and qint8's words and scale bitwise; gaussian by its
     invariants and its indices clear of the threshold (its mean and std
     sum in another order); each ``compress`` timed. Then two ranks
     sharing the card (this script with ``--comp-rank R --out DIR``, one
     pair of processes): ResNet-50 the sweep's ``eftopk`` method (bf16,
     B = 64, ``--mode allreduce --compressor eftopk --density 0.01``, 6
     steps, without and with ``--momentum-correction 0.9``), GPT-2 with
     each compressor on ``--mode dear``, ``eftopk --gtopk`` on
     ``allreduce``, and topk at density 1 against dense ``allreduce``
     (fp32 gradients: the losses within `_TOPK_D1_RTOL`), 3 steps each;
     BERT-Large LAMB (``benchmarks/bert.py --model bert_large --fp16
     --optimizer lamb``, S = 128, B = 16, 5 steps) and the trust ratios of
     one more update on the shards against the gathered bucket's (within
     `_LAMB_TRUST_RTOL`): every step's launches (K1-K3, the K5 epilogue
     once per bucket but for LAMB, the payload collectives once per
     bucket, the dense legs), both ranks' losses and parameters equal,
     every stateful compressor's residual nonzero. Then one rank on NCCL:
     ResNet-50 eftopk (5 steps, traced), BERT-Large LAMB (10 steps), GPT-2
     (B = 16, bf16, flash) without remat, with ``--remat`` and with
     ``--remat-policy full`` (5 steps each: K1 24 times a step under
     remat, K2 and K3 12, the losses within `_REMAT_RTOL` of the run's
     without, ``--remat``'s peak memory below it), ResNet-50 with
     ``--remat-policy full`` (3 steps, cuDNN off: the losses, the BN buffers after steps 1 and 3
     and the parameters after step 3 within `_REMAT_BN_RTOL` of the run's
     without, the buffers updated 3 times);
  5n. runtime tuning, the tracer and ``multi_step``, one rank on NCCL:
     GPT-2 through the CLI (B = 16, S = 1024, bf16, flash) with
     ``--autotune bo`` (3 trials, windows of 4 steps) under the tracer
     with a Chrome trace, with ``--autotune wait_time``, with ``--mgwfbp``
     (prints the measured α and β, and `observability.overlap.
     fit_interconnect`'s) and with ``--autotune plan`` over the arms that
     run at one rank without a compressor (dear / dear-fused x comm dtype
     x gather dtype; both modes measured); ResNet-50 with ``--autotune
     bo``: every step
     launches the K5 epilogue once per bucket of the plan it ran on, every
     rebuild leaves the fp32 masters (by name) and the model's buffers
     (BatchNorm's) bitwise as they were, ``memory_allocated`` after the
     last BO rebuild within `_TUNE_MEM_SLACK` of the first plan's, the
     trace's ``dear.step`` and ``autotune.rebuild`` spans and the tracer's
     counters equal to the run's own counts, and the K5 epilogue bitwise
     at the largest shard any trial plan had; then ``multi_step(10)``
     against 10 ``step()`` calls on GPT-2 (B = 16, dropout) and ResNet-50
     (B = 64, cuDNN deterministic): last loss, masters and buffers
     bitwise, and the step ms of both;
  5o. the input pipeline and the harness, one rank on NCCL unless said:
     the native producer library built from the port's copy of
     ``csrc/dear_runtime.cpp``; ResNet-50 (bf16, B = 64, 224²) through the
     ImageNet CLI with ``--pipeline native`` (25 steps, every one launching
     the K5 epilogue once per bucket; the driven object a native
     ``Pipeline``), then ``--pipeline none``: step p50/p99, img/s, the
     producers' own rate, the host cast and staging time, a traced idle
     share of each, and which of them sets the pace; GPT-2 (B = 16, S =
     1024, flash) with ``--pipeline numpy``: its first three staged
     batches, read back, byte-identical to a ``NumpyPipeline`` of seed 0;
     BERT-Base with ``--flash-attention --pipeline native`` (K1–K3 12 a
     step each); the sweep driver over resnet50:64 x {dear, allreduce} at
     one rank and {dear-fused} at two ranks sharing the card (their
     ``TELEMETRY`` lines in ``reports.json``; the K4 and K5-ring launches
     rank 0's); ``collectives`` at world 1 and ``scaling --worlds 1``; the
     overlap report at two ranks sharing the card (its efficiency and
     timeline shares); ResNet-50 ``--remat-policy full`` through the CLI
     WITH its cuDNN settings (benchmark mode, after every earlier phase
     timed convs in this process), bitwise against the run without; and
     the bench line again with ``DEAR_TELEMETRY=0`` (`_BENCH_OFF_ITERS`
     timed iterations of 10 steps per model, for the time limit) beside
     phase 5g's default (counters on);
  5p. checkpoints and the guarded trainer (run after 5n, before the bench
     line): (i) GPT-2 small at full width through the GPT CLI's builders
     (bf16, flash, ``dear``, B = 16, one rank on NCCL): an async save
     whose writer is held back while the next step updates the masters in
     place (the file holds the saved step, bitwise), a sync save, a
     restore and the sha256 manifest timed, then `GuardedTrainer` with
     ``nan@6,exc@9,ckpt_corrupt@12,preempt@15`` and async checkpoints
     every 4 attempts: every rollback's masters and momentum equal to the
     step read back from disk, every dispatched step 12 tensor-core
     launches each of K1–K3 and one K5 epilogue per bucket, the emergency
     step verified and newest, and a second process (``--guard-resume``)
     resumed from it bitwise equal to this one 3 steps later; step p50
     bare and guarded; (ii) ResNet-50 (bf16, B = 64) through the ImageNet
     CLI's builders: 3 steps, a checkpoint, a fresh model and step
     restored from it, 3 more, bitwise equal to 6 uninterrupted steps
     (masters, momentum, every BN buffer); (iii) GPT-2 at 2 layers, B = 4
     per rank, ranks sharing the card over gloo (``--guard-rank``
     children): ``nan@3:r1`` and, with per-host storage, rank 0's newest
     step corrupted, each restoring the same step on both ranks with
     equal master digests; at three ranks in ``allreduce`` with
     ``DEAR_SDC=1``, ``flip@5:0:r0`` named as (rank 0, bucket 0) by every
     rank's vote; (iv) the production example with JAX's flags and
     ``DEAR_FAULTS=nan@6,exc@9`` stopping with the guard's
     DivergenceError as JAX's does, then recovering with checkpoints every
     4 steps and resuming;
  5q. elastic membership (after 5p), two fleets side by side under the
     port's supervisor (`scripts.chaos_check`): (i) GPT-2 small cut to 2
     layers (full width, bf16, flash, ``dear``, B = 4 per rank, S =
     1024), three ranks sharing the card over gloo, per-host checkpoints
     (the whole state in every blob) every 2 steps; rank 2 SIGKILLs
     itself before attempt 5, the survivors commit epoch 1 and regroup at
     world 2, the relaunch rejoins at epoch 2 (world 3): lockstep final
     step, loss and epoch, plan world 3 -> 2 -> 3 with the epoch stamped,
     every rollback on the newest common checkpoint, one K5 epilogue per
     bucket on every completed step of every rank, and the first
     post-shrink losses bitwise equal to a fresh 2-rank run restored from
     the same step; each transition's times printed; (ii) the MNIST net
     through the autoscale drill (scale-up, SIGKILL and relaunch, drain
     and backfill: epochs 1-5, then a cold start from the remote tier);
  5r. the multi-slice DCN leg (after 5q), three parts side by side: (i)
     GPT-2 small cut to 2 layers (as 5q's), four ranks sharing the card
     over gloo, first flat ``dear`` at world 4, then the hierarchical
     step at 2 slices x 2 ranks (`comm.backend.form_slice_groups`, a
     `comm.dcn.DcnExchanger` over a `FileTransport` under ``build/``), 4
     steps each from the same seeded initial state: the hierarchical
     losses within 1e-3 of the flat run's (and equal on every rank), the
     gathered parameters within 2e-4 of the largest, one K5 epilogue per
     bucket per step on every rank, K1-K3 on tensor cores; the DCN leg's
     time per step by part and its bytes printed; (ii) and (iii)
     `scripts.chaos_check --multislice` and ``--multislice-flap`` with
     the MNIST net, 2 slices x 2 ranks: JAX's verdicts, and per survivor
     the time from death to the shrink's commit, the renorms, the
     degraded steps, the time to readmission, the steps lost and the
     `fit_dcn` α-β;
  5s. sequence parallelism (after 5r): (i) K1, K2 and K3 through ring
     attention's pair wrappers (bf16 in, fp32 out: the CUDA-core routes)
     at SP's shapes — GPT-2's causal aligned pair, a full pair with a key
     mask and the zigzag half-q and half-k pairs at S/sp = 512 (B = 4, H
     = 12), BERT-Base's padded pair at S = 128, sp = 2 — each held
     against its plain version and timed beside it, SDPA and the bound
     (rows of the kernels line); then four ranks sharing the card over
     gloo (`--sp-rank` children): rank 0 trains the one-rank references,
     ranks 0 and 1 (dp 1 x sp 2) GPT-2 small at full width (12 layers, S
     = 1024, fp32, B = 4) with ring, ring_flash, ulysses and zigzag and
     ring_flash in bf16, BERT-Base (S = 128, B = 8) with ring_flash and
     ulysses, and all four GPT-2 at 2 layers with ring_flash at dp 2 x sp
     2, 3 steps each from the seed-0 weights: the losses within 2e-4 of
     one rank's on the same global batch (bf16 within 1e-2), K1-K3's
     launches equal to the ring's branch map, one K5 epilogue per bucket
     per step; the step p50 per scheme, the ring's exposed p2p time and
     the launches printed;
  6. trace steady bf16 decode ticks and training steps with
     ``torch.profiler`` (device ops, busy time and idle share, the top
     device ops of a step); time each kernel, its plain version and
     PyTorch's own call where one computes the same function (SDPA, its
     backward and ``torch.optim.SGD(fused=True)``: yardsticks the port
     never calls; none for the K5 ring on one card) at the main
     path's shapes, beside the card's bound — K4 (both routes) and the K5
     ring per bucket and K6–K8 per call on a two-rank `LocalRing` (K6–K8 beside
     one cuBLAS call computing the same function for both ranks), K9 at
     both granularities beside ``torch.add(one, x, alpha=2.0)``, the K5
     epilogue also at ResNet-50's largest bucket shard; step time
     p50/p99, tokens/s and MFU, the two-rank steps' p50/p99 and tokens/s;
     ResNet-50's step p50/p99, img/s and MFU (3 x the forward's conv and
     fc products against 989 TF/s bf16) and 2 traced steps; K1, K2 and K3
     also at BERT-Base's flash shape (B = 32, S = 128, non-causal); K1 at
     BERT-Base's decode tick (B = 4 over 512 slots, bf16 and fp32), K6–K8
     at BERT-Large's shapes beside cuBLAS, the K5 epilogue at the zoo's
     largest shards (VGG-16's fc1) and at the replicated modes' whole
     buckets; phase 5l's step p50/p99, tokens/s and peak memory per run;
     the kernels line's K1-K3 and K5-epilogue launches include 5m's,
     5o's, 5p's, 5q's, 5r's and 5s's (and K4's and the K5 ring's, 5o's
     driver cell's rank 0).

``python3 chip_smoke.py --kernels-only`` runs phases 1–3 and stops without
a result line; ``--phase 5o`` runs phases 1–2, the bench line and phase 5o,
``--phase 5p`` phases 1–2 and phase 5p, ``--phase 5q`` phases 1–2 and
phase 5q, ``--phase 5r`` phases 1–2 and phase 5r, and ``--phase 5s``
phases 1–2 and phase 5s, without one either. In a
full run the line before the last lists the kernels
as JSON (K1, K2, K3 and K4 once per route, each with its main path's
launches; K6 and K7 with their launches by route, the K5 ring by width);
the last line is ``{"ok":
true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

import dear_pytorch_tpu_torch.ops.collective_matmul as CM
import dear_pytorch_tpu_torch.ops.flash_attention as FA
import dear_pytorch_tpu_torch.ops.fused_sgd as FS
import dear_pytorch_tpu_torch.ops.overhead_probe as OP
from dear_pytorch_tpu_torch import Communicator
from dear_pytorch_tpu_torch import bench as port_bench
from dear_pytorch_tpu_torch.benchmarks import bert as bert_cli
from dear_pytorch_tpu_torch.benchmarks import gpt as train_cli
from dear_pytorch_tpu_torch.benchmarks import imagenet as imagenet_cli
from dear_pytorch_tpu_torch.comm import backend
from dear_pytorch_tpu_torch.comm import collectives as C
from dear_pytorch_tpu_torch.comm.ring import LocalRing, Ring
from dear_pytorch_tpu_torch.models import dropout_free, get_model, gpt_config
from dear_pytorch_tpu_torch.models import bert as BERT
from dear_pytorch_tpu_torch.models.data import (
    softmax_xent, synthetic_bert_batch, synthetic_gpt_batch,
    synthetic_image_batch,
)
from dear_pytorch_tpu_torch.models.gpt import (
    GPT2_SMALL, GptLmHeadModel, flash_causal_attention_impl, generate,
    gpt_lm_loss,
)
from dear_pytorch_tpu_torch.observability import overlap
from dear_pytorch_tpu_torch.observability import tracer as T
from dear_pytorch_tpu_torch.ops import _build
from dear_pytorch_tpu_torch.ops import compression as Z
from dear_pytorch_tpu_torch.ops import fusion as FU
from dear_pytorch_tpu_torch.ops.schedules import warmup_cosine
from dear_pytorch_tpu_torch.parallel.dear import build_train_step
from dear_pytorch_tpu_torch.scripts import overhead_probe as probe
from dear_pytorch_tpu_torch.serving.engine import DecodeEngine
from dear_pytorch_tpu_torch.tuning import autotune as TA

# the card's peak rates (NVIDIA data sheets, dense)
_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
_SLOTS, _H, _D, _L = 4, 12, 64, 1024
_DEV = "cuda"
_ROOT = Path(__file__).resolve().parent


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------


def _case(gen, B, Sq, Sk, dtype, causal, lengths=None, holey=False, D=None,
          dead=None):
    """q, k, v [B, S, H, D] and an int32 key mask [B, Sk]: the first
    ``lengths[b]`` keys, a random 70%, or all; ``dead`` = (lo, hi) also
    masks keys lo .. hi - 1 of every row."""
    dev = _DEV
    D = D or _D
    q = torch.randn(B, Sq, _H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Sk, _H, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Sk, _H, D, generator=gen, device=dev).to(dtype)
    ar = torch.arange(Sk, device=dev)
    if lengths is not None:
        mask = ar[None, :] < torch.tensor(lengths, device=dev)[:, None]
    elif holey:
        mask = torch.rand(B, Sk, generator=gen, device=dev) > 0.3
    else:
        mask = torch.ones(B, Sk, dtype=torch.bool, device=dev)
    if dead is not None:
        mask = mask & ~((ar >= dead[0]) & (ar < dead[1]))[None, :]
    return q, k, v, mask.to(torch.int32)


#: BERT-Base's flash shapes (phase 5e): batch 32, S = 64 (the bench's)
#: and 128 (the flash run's), H = 12, D = 64, no causal mask
_BERT_B, _BERT_SEQS = 32, (64, 128)


def _bert_lengths(S):
    """Per-row key lengths of a padded batch of ``_BERT_B`` sentences: from
    S (row 0) down to 1, every row a different tail masked."""
    return [max(1, S - (13 * b) % S) for b in range(_BERT_B)]


def _routed(name, route, fn):
    """Run ``fn`` (one K1 call) and check that it launched once, through
    ``route``: no route gives way to another or to the plain version."""
    before = dict(FA.flash_fwd_route_launches)
    out = fn()
    got = {r: FA.flash_fwd_route_launches[r] - before[r] for r in before}
    _check(got == {r: int(r == route) for r in before},
           f"{name}: K1 launches by route {got}, expected one {route}")
    return out


def check_kernel() -> dict:
    """Every case through `flash_attention` ([B,S,H,D] strides, o, in the
    inputs' dtype: the tensor-core route for bf16 at D = 64 with Sq > 1,
    split-K at Sq = 1) and `flash_pair_fwd` (folded [BH,S,D], o and lse in
    fp32: the CUDA-core route, or split-K at Sq = 1), each launch checked
    to take its route (`fwd_route`); the lse of the first call too.
    Returns the largest |o - o_plain| of each route."""
    gen = torch.Generator(device=_DEV).manual_seed(0)
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        cases += [
            (f"decode {dt}", _case(gen, _SLOTS, 1, _L, dt, False,
                                   lengths=[1, 137, 600, 1024]), False),
            (f"all-masked row {dt}", _case(gen, _SLOTS, 1, _L, dt, False,
                                           lengths=[0, 5, 1024, 0]), False),
            # whole 128-key splits of live rows masked: the tail of rows 0
            # and 1, and keys 128 .. 511 of every row
            (f"decode, dead splits {dt}",
             _case(gen, _SLOTS, 1, _L, dt, False,
                   lengths=[100, 700, 1024, 1024], dead=(128, 512)), False),
            (f"decode D=40 {dt}", _case(gen, _SLOTS, 1, 300, dt, False,
                                        holey=True, D=40), False),
            (f"causal prefill {dt}", _case(gen, 2, 1024, 1024, dt, True),
             True),
            (f"ragged causal S=13 {dt}",
             _case(gen, 2, 13, 13, dt, True, holey=True), True),
            (f"ragged S=136 {dt}",
             _case(gen, 2, 136, 136, dt, False, holey=True), False),
            (f"D=128 causal S=200 {dt}",
             _case(gen, 2, 200, 200, dt, True, holey=True, D=128), True),
            (f"Sq=200 Sk=1000 {dt}",
             _case(gen, 2, 200, 1000, dt, False, holey=True), False),
        ]
    # the training step's shape at world 2's per-rank batch
    cases.append(("train causal B=8 torch.bfloat16",
                  _case(gen, 8, 1024, 1024, torch.bfloat16, True), True))
    # BERT's: non-causal over a key-padding mask (per-row lengths) and a
    # full one (the flash run's synthetic batch)
    for S in _BERT_SEQS:
        cases += [
            (f"bert padded B={_BERT_B} S={S} torch.bfloat16",
             _case(gen, _BERT_B, S, S, torch.bfloat16, False,
                   lengths=_bert_lengths(S)), False),
            (f"bert full B={_BERT_B} S={S} torch.bfloat16",
             _case(gen, _BERT_B, S, S, torch.bfloat16, False), False)]
    worst = dict.fromkeys(FA.FWD_ROUTES, 0.0)
    for name, (q, k, v, mask), causal in cases:
        dt, D = q.dtype, q.shape[-1]
        route = FA.fwd_route(q.shape[1], D, dt, dt)
        route_f32 = FA.fwd_route(q.shape[1], D, dt, torch.float32)
        ref32, ref_lse = FA.flash_attention_reference(
            q, k, v, causal=causal, kv_mask=mask, out_dtype=torch.float32)
        ref_o = ref32.to(dt)
        o = _routed(name, route, lambda: FA.flash_attention(
            q, k, v, causal=causal, kv_mask=mask))
        _, o_lse = _routed(name, route, lambda: FA._dispatch(
            q, k, v, mask, D ** -0.5, causal, dt))

        def fold(x):
            return x.transpose(1, 2).reshape(-1, x.shape[1], D)

        po, lse = _routed(name, route_f32, lambda: FA.flash_pair_fwd(
            fold(q), fold(k), fold(v), mask.repeat_interleave(_H, dim=0),
            None, causal, out_dtype=torch.float32))
        torch.cuda.synchronize()
        err_o = float((o.float() - ref_o.float()).abs().max())
        err_o_lse = float((o_lse - ref_lse).abs().max())
        ref_po = ref32.transpose(1, 2).reshape(po.shape)
        err_po = float((po - ref_po).abs().max())
        err_lse = float((lse - ref_lse.reshape(lse.shape)).abs().max())
        print(f"kernel check {name} ({route}): max|o-plain| {err_o:.3e} "
              f"max|lse-plain| {err_o_lse:.3e}; fp32 out "
              f"max|o_f32-plain| {err_po:.3e} max|lse-plain| {err_lse:.3e}")
        _check(o.dtype == dt and po.dtype == torch.float32,
               f"{name}: output dtypes {o.dtype}, {po.dtype}")
        _check(err_o <= tol[dt] and err_po <= tol[torch.float32]
               and max(err_lse, err_o_lse) <= tol[torch.float32] * 10,
               f"{name}: kernel disagrees with its plain version")
        _check(bool(torch.isfinite(o.float()).all()), f"{name}: non-finite")
        if name.startswith("all-masked"):
            dead = mask.sum(dim=1) == 0
            _check(bool((o[dead] == 0).all()), "all-masked row: o != 0")
            for lse_all in (lse, o_lse):
                lse_rows = lse_all.reshape(_SLOTS, _H)[dead]
                _check(bool((lse_rows == -1e30).all()),
                       "all-masked row: lse != -1e30")
        worst[route] = max(worst[route], err_o)
        worst[route_f32] = max(worst[route_f32], err_po)
    return worst


def _fold(x):
    """[B, S, H, D] -> [B*H, S, D] (a copy)."""
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[-1])


def _bwd_operands(gen, B, S, dtype, causal, lengths=None, holey=False,
                  D=None, Sk=None, dead=None):
    """q, k, v, dO, mask and the forward's fp32 lse and delta = rowsum(dO *
    O), all [B, S, H, D] / [B, Sk] / [B, H, S] (``Sk`` keys, default S;
    ``dead`` as `_case`'s)."""
    q, k, v, mask = _case(gen, B, S, Sk or S, dtype, causal, lengths, holey,
                          D, dead)
    do = torch.randn(q.shape, generator=gen, device=_DEV).to(dtype)
    o, lse = FA.flash_attention_reference(q, k, v, causal=causal,
                                          kv_mask=mask,
                                          out_dtype=torch.float32)
    delta = (do.float() * o).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, mask, lse, delta


def _rel(got, ref) -> tuple:
    """(max |got - ref|, that over max(1, max |ref|))."""
    err = float((got.float() - ref.float()).abs().max())
    return err, err / max(1.0, float(ref.float().abs().max()))


def _bwd_routed(name, route, fn):
    """Run ``fn`` (K2 and K3 calls, ``n`` of each) and check that every
    launch of both took ``route`` (`bwd_route`): no route gives way to
    another or to the plain version. Returns fn's result."""
    before = {w: dict(c) for w, c in FA.flash_bwd_route_launches.items()}
    out = fn()
    got = {w: {r: c[r] - before[w][r] for r in c}
           for w, c in FA.flash_bwd_route_launches.items()}
    n = max(sum(c.values()) for c in got.values())
    _check(n > 0 and got == {w: {r: n * (r == route) for r in c}
                             for w, c in got.items()},
           f"{name}: K2/K3 launches by route {got}, expected each through "
           f"{route}")
    return out


def _bwd_instance(route, dtype, out_dtype, D) -> str:
    """The key of one K2/K3 instantiation: the route's name for the one its
    main path runs (tensor cores: bf16 in and out; CUDA cores: fp32 in and
    out, the fp32 step; both at D = 64), else the route, dtypes and D."""
    main = {"tensor_core": torch.bfloat16, "cuda_core": torch.float32}
    if dtype == out_dtype == main[route] and D == _D:
        return route
    dts = "->".join(str(t).replace("torch.", "") for t in (dtype, out_dtype))
    return f"{route} {dts} D={D}"


def _worst(worst, key, dq_err, dkv_err) -> None:
    """Fold one check's largest errors of dQ and of dK/dV into ``worst``."""
    for which, err in (("dq", dq_err), ("dkv", dkv_err)):
        worst[which][key] = max(worst[which].get(key, 0.0), err)


def _hold_dispatch(label, args, out_dt, tol) -> dict:
    """K2 and K3 through the unfolded [B, S, H, D] dispatch the autograd
    Function calls, on ``args`` (q, k, v, mask, do, lse, delta, scale,
    causal), route-checked and held against the plain versions: the
    largest error over the largest |plain value| at most ``tol``. Returns
    {"dq"|"dk"|"dv": (abs, rel)}."""
    route = FA.bwd_route(args[0].shape[-1], args[0].dtype, out_dt)
    got = _bwd_routed(label, route, lambda: (
        {"dq": FA._dispatch_dq(*args, out_dt)}
        | dict(zip(("dk", "dv"), FA._dispatch_dkv(*args, out_dt)))))
    ref = {"dq": FA._dq_reference(*args, out_dt)}
    ref["dk"], ref["dv"] = FA._dkv_reference(*args, out_dt)
    torch.cuda.synchronize()
    errs = {n: _rel(got[n], ref[n]) for n in got}
    print(f"backward kernel check {label} ({route}): " + ", ".join(
        f"max|{n}-plain| {a:.3e} (rel {r:.3e})" for n, (a, r) in errs.items()))
    for n, out in got.items():
        _check(out.dtype == out_dt and bool(torch.isfinite(out.float()).all())
               and errs[n][1] <= tol,
               f"{label}: {n} ({route}) disagrees with its plain version")
    return errs


def check_bwd_kernels() -> dict:
    """K2 (dQ) and K3 (dK, dV) against their plain versions through the
    folded `flash_pair_dq` / `flash_pair_dkv`, every call checked to take
    its route (`bwd_route`: tensor cores for bf16 in and out at D = 64),
    then autograd through `flash_attention` (K1 forward, K2 and K3
    backward) against autograd through the plain forward at the [B, S, H,
    D] layout the model uses. Then bf16 inputs with fp32 outputs (ring
    attention's ``out_dtype``; the CUDA-core route), within the fp32
    tolerance. The main paths' shapes (bf16 causal B=8 S=1024, world 2's
    per-rank batch; fp32 causal B=2 S=1024, the fp32 step) run both folded
    and through the unfolded `_dispatch_dq` / `_dispatch_dkv`. Both routes
    run twice on the train cases: bitwise equal. Returns the largest
    absolute error of dQ and of dK/dV by instantiation (`_bwd_instance`),
    ``{"dq": {key: err}, "dkv": {...}}``."""
    gen = torch.Generator(device=_DEV).manual_seed(2)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        cases += [
            (f"train causal B=4 S=1024 {dt}",
             _bwd_operands(gen, 4, 1024, dt, True), True),
            (f"holey S=256 {dt}",
             _bwd_operands(gen, 2, 256, dt, False, holey=True), False),
            (f"ragged causal S=13 {dt}",
             _bwd_operands(gen, 2, 13, dt, True, holey=True), True),
            (f"ragged S=136 {dt}",
             _bwd_operands(gen, 2, 136, dt, False, holey=True), False),
            (f"all-masked row S=136 {dt}",
             _bwd_operands(gen, 2, 136, dt, False, lengths=[0, 100]), False),
            # the D <= 128 instances, and a D that no warp width divides
            (f"D=128 causal S=200 {dt}",
             _bwd_operands(gen, 2, 200, dt, True, holey=True, D=128), True),
            (f"D=40 S=77 {dt}",
             _bwd_operands(gen, 2, 77, dt, False, holey=True, D=40), False),
            # Sq != Sk (ring attention's pairs), a causal diagonal that no
            # 64- or 128-row tile edge meets, and keys 128 .. 255 of every
            # row masked (one whole 128-key tile: K2 skips it, K3's block
            # of those keys writes zeros)
            (f"Sq=192 Sk=320 {dt}",
             _bwd_operands(gen, 2, 192, dt, False, holey=True, Sk=320),
             False),
            (f"ragged causal S=200 {dt}",
             _bwd_operands(gen, 2, 200, dt, True, holey=True), True),
            (f"dead key tile S=512 {dt}",
             _bwd_operands(gen, 2, 512, dt, False, dead=(128, 256)), False),
            (f"dead key tile causal S=512 {dt}",
             _bwd_operands(gen, 2, 512, dt, True, dead=(128, 256)), True),
        ]
    # the main paths' own shapes: world 2's per-rank bf16 train batch (the
    # two-rank dear-fused steps) and the fp32 step's batch
    cases += [
        ("train causal B=8 S=1024 torch.bfloat16",
         _bwd_operands(gen, 8, 1024, torch.bfloat16, True), True),
        ("fp32 step causal B=2 S=1024 torch.float32",
         _bwd_operands(gen, 2, 1024, torch.float32, True), True)]
    # BERT's flash shapes: non-causal, a key-padding mask and a full one
    for S in _BERT_SEQS:
        cases += [
            (f"bert padded B={_BERT_B} S={S} torch.bfloat16",
             _bwd_operands(gen, _BERT_B, S, torch.bfloat16, False,
                           lengths=_bert_lengths(S)), False),
            (f"bert full B={_BERT_B} S={S} torch.bfloat16",
             _bwd_operands(gen, _BERT_B, S, torch.bfloat16, False), False)]
    # bf16 in, fp32 out: the same kernels' fp32 stores
    f32 = torch.float32
    cases += [
        (f"{name} -> fp32", ops, causal, f32) for name, ops, causal in (
            ("train causal B=4 S=1024 bf16",
             _bwd_operands(gen, 4, 1024, torch.bfloat16, True), True),
            ("holey S=256 bf16",
             _bwd_operands(gen, 2, 256, torch.bfloat16, False, holey=True),
             False),
            ("all-masked row S=136 bf16",
             _bwd_operands(gen, 2, 136, torch.bfloat16, False,
                           lengths=[0, 100]), False))]
    worst = {"dq": {}, "dkv": {}}
    for name, (q, k, v, do, mask, lse, delta), causal, *out_dt in cases:
        out_dt = out_dt[0] if out_dt else q.dtype
        route = FA.bwd_route(q.shape[-1], q.dtype, out_dt)
        key = _bwd_instance(route, q.dtype, out_dt, q.shape[-1])
        scale = q.shape[-1] ** -0.5
        args = (_fold(q), _fold(k), _fold(v), mask.repeat_interleave(_H, 0),
                _fold(do), lse.reshape(-1, lse.shape[-1]),
                delta.reshape(-1, delta.shape[-1]), scale, causal)

        def both():
            return (FA.flash_pair_dq(*args, out_dtype=out_dt),
                    *FA.flash_pair_dkv(*args, out_dtype=out_dt))

        dq, dk, dv = _bwd_routed(name, route, both)
        ref_dq = FA.flash_pair_dq_reference(*args, out_dtype=out_dt)
        ref_dk, ref_dv = FA.flash_pair_dkv_reference(*args, out_dtype=out_dt)
        torch.cuda.synchronize()
        errs = {"dq": _rel(dq, ref_dq), "dk": _rel(dk, ref_dk),
                "dv": _rel(dv, ref_dv)}
        print(f"backward kernel check {name} ({route}): " + ", ".join(
            f"max|{n}-plain| {a:.3e} (rel {r:.3e})"
            for n, (a, r) in errs.items()))
        for n, out in (("dq", dq), ("dk", dk), ("dv", dv)):
            _check(out.dtype == out_dt, f"{name}: {n} dtype {out.dtype}")
            _check(bool(torch.isfinite(out.float()).all()),
                   f"{name}: {n} not finite")
            _check(errs[n][1] <= tol[out_dt],
                   f"{name}: {n} disagrees with its plain version")
        if name.startswith("all-masked"):
            dead = (mask.sum(1) == 0).repeat_interleave(_H, 0)
            _check(bool((dq[dead] == 0).all() and (dk[dead] == 0).all()
                        and (dv[dead] == 0).all()),
                   "all-masked row: a gradient is not 0")
        if name.startswith("dead key tile"):
            _check(bool((dk[:, 128:256] == 0).all()
                        and (dv[:, 128:256] == 0).all()),
                   f"{name}: a masked key's gradient is not 0")
        if name.startswith("train"):     # twice on the same inputs
            again = _bwd_routed(name, route, both)
            torch.cuda.synchronize()
            _check(all(torch.equal(a, b) for a, b in
                       zip((dq, dk, dv), again)),
                   f"{name} ({route}): K2/K3 not bitwise repeatable")
            print(f"backward kernel check {name} ({route}): twice on the "
                  "same inputs, bitwise equal")
        _worst(worst, key, errs["dq"][0], max(errs["dk"][0], errs["dv"][0]))

    # the same main-path shapes through the [B, S, H, D] dispatch that the
    # autograd Function calls (no fold), BERT's padded ones too
    bf16 = torch.bfloat16
    for label, B, S, dt, causal, lengths in (
            [("causal", 8, 1024, bf16, True, None),
             ("causal", 2, 1024, torch.float32, True, None)]
            + [("bert padded", _BERT_B, S, bf16, False, _bert_lengths(S))
               for S in _BERT_SEQS]):
        q, k, v, do, mask, lse, delta = _bwd_operands(gen, B, S, dt, causal,
                                                      lengths=lengths)
        errs = _hold_dispatch(f"unfolded {label} B={B} S={S} {dt}", (
            q, k, v, mask, do, lse, delta, _D ** -0.5, causal), dt, tol[dt])
        _worst(worst, _bwd_instance(FA.bwd_route(_D, dt, dt), dt, dt, _D),
               errs["dq"][0], max(errs["dk"][0], errs["dv"][0]))

    # autograd through K1+K2+K3 against autograd through the plain forward
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, mask = _case(gen, 4, 1024, 1024, dt, True)
        w = torch.randn(q.shape, generator=gen, device=_DEV).to(dt)
        grads = []
        for flash in (True, False):
            xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            if flash:    # K1, then K2 and K3 in the backward, on its route
                grads.append(_bwd_routed(
                    f"autograd {dt}", FA.bwd_route(_D, dt, dt),
                    lambda: torch.autograd.grad(
                        FA.flash_attention(*xs, causal=True), xs, w)))
            else:
                o, _ = FA.flash_attention_reference(*xs, causal=True)
                grads.append(torch.autograd.grad(o, xs, w))
        torch.cuda.synchronize()
        errs = [_rel(g, r) for g, r in zip(*grads)]
        print(f"autograd check causal B=4 S=1024 {dt}: " + ", ".join(
            f"max|d{n}-plain| {a:.3e} (rel {r:.3e})"
            for n, (a, r) in zip("qkv", errs)))
        _check(all(r <= tol[dt] for _, r in errs),
               f"autograd {dt}: flash gradients disagree with the plain "
               "forward's")
    return worst


def _ulps(a, b) -> int:
    """The largest distance in units in the last place between two fp32
    (or bf16) tensors of one sign pattern (0 when bitwise equal)."""
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    ia = a.contiguous().view(view).long()
    ib = b.contiguous().view(view).long()
    return int((ia - ib).abs().max()) if a.numel() else 0


def check_update_kernel() -> float:
    """The shard update (K5's epilogue) against `fused_update_reference`
    on the card, bitwise for SGD; AdamW's ulp distance is printed and must
    be 0 as well (both run the same IEEE operations in the same order).
    Returns the largest absolute difference (0.0)."""
    gen = torch.Generator(device=_DEV).manual_seed(3)
    opts = [
        ("sgd", FS.fused_sgd(lr=0.01)),
        ("sgd momentum", FS.fused_sgd(lr=0.01, momentum=0.9)),
        ("nesterov wd", FS.fused_sgd(lr=0.01, momentum=0.9, nesterov=True,
                                     weight_decay=1e-4)),
        ("adamw", FS.fused_adamw(lr=1e-3, weight_decay=0.01)),
    ]
    worst = 0.0
    n_cases = 0
    for n in (1_000_003, 25 * 2**20 // 4):     # ragged, one 25 MB bucket
        for gdt in (torch.bfloat16, torch.float32):
            for mean_world, clip in ((1, None), (2, 0.37)):
                for name, opt in opts:
                    worst = max(worst, _update_pair(
                        f"{name} n={n} {gdt} clip={clip}", opt, n, gdt,
                        mean_world, clip, gen))
                    n_cases += 2
    print(f"update kernel check: {n_cases} cases (SGD, momentum first and "
          "second step, nesterov + wd, AdamW; n = 1000003 and 6553600; "
          "bf16 and fp32 grads; clip 0.37 at mean_world 2) bitwise equal "
          "to the plain version")
    return worst


def _update_pair(name, opt, n, gdt, mean_world, clip, gen) -> float:
    """Two steps (the first and second) of the kernel and of its plain
    version from one start on ``n`` elements; raises unless every state
    tensor is bitwise equal after each step. Returns the largest absolute
    difference (0.0)."""
    clip_t = (None if clip is None else
              torch.tensor(clip, dtype=torch.float32, device=_DEV))
    p0 = torch.randn(n, generator=gen, device=_DEV)
    pk, pr = p0.clone(), p0.clone()
    sk, sr = opt.init(pk), opt.init(pr)
    worst = 0.0
    for step in range(2):
        rs = torch.randn(n, generator=gen, device=_DEV).to(gdt)
        scal = opt.scalars(sr, mean_world, step)
        FS.fused_update_reference(opt, rs, sr, pr, scal, clip_t)
        opt.update(rs, sk, pk, mean_world=mean_world, clip_scale=clip_t,
                   step=step)
        for key, val in sk.items():    # host bookkeeping
            if not torch.is_tensor(val):
                sr[key] = val
        pairs = [(pk, pr)] + [(sk[key], sr[key]) for key in sk
                              if torch.is_tensor(sk[key])]
        torch.cuda.synchronize()
        ulps = max(_ulps(a, b) for a, b in pairs)
        diff = max(float((a - b).abs().max()) for a, b in pairs)
        if ulps:
            print(f"update check {name} step {step}: {ulps} ulp, "
                  f"max |diff| {diff:.3e}")
        _check(ulps == 0, f"update {name}: not bitwise equal to its plain "
               "version")
        worst = max(worst, diff)
    return worst


def check_update_main_path(ts, sizes=None, what="shard") -> float:
    """The shard update at every shard size of the training run's plan
    (or at ``sizes``: ``what`` names them), with the run's own optimizer,
    bf16 gradients and one rank: bitwise equal to the plain version after
    the first and the second step. Returns the largest absolute
    difference (0.0)."""
    gen = torch.Generator(device=_DEV).manual_seed(7)
    sizes = sorted(set(sizes or (b.shard_size for b in ts.plan.buckets)))
    worst = max(_update_pair(f"main path n={n}", ts.optimizer, n,
                             torch.bfloat16, 1, None, gen) for n in sizes)
    print(f"update kernel check main path: {len(sizes)} {what} sizes of the "
          f"plan ({sizes[0]} to {sizes[-1]}), {ts.optimizer}, bf16 "
          "grads, first and second step: bitwise equal to the plain version")
    return worst


def _ring_ulps(pairs) -> tuple:
    """(largest ulp distance, largest |a - b|) over pairs of tensors."""
    return (max(_ulps(a, b) for a, b in pairs),
            max(float((a.float() - b.float()).abs().max()) for a, b in pairs))


def _ring_width(nbytes: int) -> str:
    """The width K4 and the K5 ring take for chunks of ``nbytes`` when the
    tensors are rows of fresh allocations (`CM.ag_route`, `CM.rs_route`)."""
    return "vector" if nbytes % 16 == 0 else "scalar"


def _ag_routed(name, want, fn):
    """Run ``fn`` (one K4 call) and check that it launched once, on the
    route ``want`` ((transport, width))."""
    before = json.dumps(CM.ring_ag_route_launches)
    got = fn()
    now = CM.ring_ag_route_launches
    was = json.loads(before)
    moved = [(t, w) for t in now for w in now[t] if now[t][w] != was[t][w]]
    _check(moved == [want] and now[want[0]][want[1]] == was[want[0]][
        want[1]] + 1, f"ring all-gather {name}: launched on {moved}, "
           f"expected {want}")
    return got


def _ring_ag_pair(name, ring, n, dt, gen, out=None) -> float:
    """K4 on ``ring`` against `ring_all_gather_stacked`, bitwise, or raise:
    on the slot route into a fresh output and, with ``out`` (an output
    ``ring`` registered), on the direct route twice (two epochs of its
    ready flags), ``out`` filled with NaN bits before each call so that
    every element must be written. Every call's route is checked. Returns
    the largest absolute difference (0.0)."""
    shards = torch.randn(ring.world, n, generator=gen, device=_DEV).to(dt)
    ref = CM.ring_all_gather_stacked(shards)
    width = _ring_width(n * shards.element_size())
    pairs = [(_ag_routed(f"{name} slot", ("slot", width),
                         lambda: CM.ring_all_gather(shards, ring)), ref)]
    for call in range(2 if out is not None else 0):
        out.view(torch.uint8).fill_(0xFF)
        pairs.append((_ag_routed(
            f"{name} direct call {call}", ("direct", width),
            lambda: CM.ring_all_gather(shards, ring, out=out, direct=True)
            .clone()), ref))
    torch.cuda.synchronize()
    ulps, diff = _ring_ulps(pairs)
    _check(ulps == 0, f"ring all-gather {name}: {ulps} ulp from its plain "
           "version")
    return diff


def _ring_rs_pair(name, ring, n, gdt, opt, gen, steps=2) -> float:
    """K5 ring on ``ring`` against `fused_reduce_scatter_update_stacked`
    from one start, ``steps`` calls (the momentum's first and second):
    every parameter and state tensor bitwise equal after each, every call
    on the width `_ring_width` names, or raise. Returns the largest
    absolute difference (0.0)."""
    world = ring.world
    p0 = torch.randn(world, n, generator=gen, device=_DEV)
    pk, pr = p0.clone(), p0.clone()
    sk = [opt.init(pk[i]) for i in range(world)]
    sr = [opt.init(pr[i]) for i in range(world)]
    width = _ring_width(n * torch.empty((), dtype=gdt).element_size())
    worst = 0.0
    for step in range(steps):
        g = torch.randn(world, world * n, generator=gen, device=_DEV).to(gdt)
        before = CM.ring_rs_route_launches[width]
        CM.fused_reduce_scatter_update(g, pk, sk, opt, ring,
                                       mean_world=world, step=step + 3)
        _check(CM.ring_rs_route_launches[width] == before + 1,
               f"ring reduce-scatter {name}: not launched on the {width} "
               f"width: {CM.ring_rs_route_launches}")
        CM.fused_reduce_scatter_update_stacked(g, pr, sr, opt,
                                               mean_world=world,
                                               step=step + 3)
        pairs = [(pk, pr)] + [(a[k], b[k]) for a, b in zip(sk, sr)
                              for k in a if torch.is_tensor(a[k])]
        torch.cuda.synchronize()
        ulps, diff = _ring_ulps(pairs)
        _check(ulps == 0, f"ring reduce-scatter {name} step {step}: {ulps} "
               "ulp from its plain version")
        worst = max(worst, diff)
    return worst


_RING_OPTS = (
    ("sgd", FS.fused_sgd(lr=0.01)),
    ("sgd momentum", FS.fused_sgd(lr=0.01, momentum=0.9)),
    ("nesterov wd", FS.fused_sgd(lr=0.01, momentum=0.9, nesterov=True,
                                 weight_decay=1e-4)),
    ("adamw cosine", FS.fused_adamw(lr=warmup_cosine(1e-3, 2, 10),
                                    weight_decay=0.01)),
)


def _plan_shard_sizes(world: int) -> list:
    """The distinct shard sizes of the training run's plan (GPT-2 small,
    25 MB buckets) at ``world`` ranks."""
    cfg = dropout_free(gpt_config("gpt2", dtype=torch.bfloat16))
    plan = FU.make_plan(GptLmHeadModel(cfg, device=_DEV), world,
                        threshold_mb=25.0)
    return sorted({b.shard_size for b in plan.buckets})


def check_ring_kernels() -> tuple:
    """K4 and K5 ring on a `LocalRing` against their stacked plain versions,
    bitwise, every call's route checked: at W = 2, 4 and 8 on a ragged
    shard (the scalar width), two short shards whose trailing blocks get
    no elements (n = 1028: the vector width in fp32, the scalar width's
    4-element units in bf16; n = 1032: the vector width in both) and a
    25 MB bucket's shard (the vector width), fp32 and bf16, K4 on the slot
    route and on the direct route into registered outputs, the K5 ring
    with plain SGD, SGD momentum (first and second step), nesterov with
    weight decay and AdamW with an lr schedule (the step scalar); and at
    W = 2 at every shard size of the training run's plan (both K4 routes
    in fp32 and bf16; bf16 gradients with the run's optimizer). Returns
    the largest absolute difference of each (0.0)."""
    gen = torch.Generator(device=_DEV).manual_seed(8)
    ag = rs = 0.0
    n_ag = n_rs = 0
    for world in (2, 4, 8):
        sizes = (100_003, 1028, 1032, 25 * 2**20 // 4 // world)
        ring = LocalRing(world, _DEV, max(sizes))
        for n in sizes:
            for dt in (torch.float32, torch.bfloat16):
                tag = f"W={world} n={n} {dt}"
                out = ring.register_outputs([world * n], dt)[0]
                ag = max(ag, _ring_ag_pair(tag, ring, n, dt, gen, out))
                n_ag += 1
                for oname, opt in _RING_OPTS:
                    rs = max(rs, _ring_rs_pair(f"{tag} {oname}", ring, n, dt,
                                               opt, gen))
                    n_rs += 1
        ring.close()
    plan = _plan_shard_sizes(2)
    ring = LocalRing(2, _DEV, max(plan))
    main_opt = FS.fused_sgd(lr=0.01, momentum=0.9)
    for n in plan:
        for dt in (torch.float32, torch.bfloat16):
            out = ring.register_outputs([2 * n], dt)[0]
            ag = max(ag, _ring_ag_pair(f"plan W=2 n={n} {dt}", ring, n, dt,
                                       gen, out))
            n_ag += 1
        rs = max(rs, _ring_rs_pair(f"plan W=2 n={n} bf16", ring, n,
                                   torch.bfloat16, main_opt, gen))
        n_rs += 1
    ring.close()
    print(f"ring kernel check: K4 {n_ag} cases (the slot route once, the "
          f"direct route twice each), K5 ring {n_rs} cases (two steps each) "
          "at W = 2, 4, 8 (n = 100003: scalar width; 1028 and 1032, with "
          "empty trailing blocks: vector, and the scalar width's 4-element "
          "units for bf16 at 1028; a 25 MB bucket's shard: vector; fp32 "
          "and bf16; SGD, SGD momentum, nesterov + wd, AdamW with a cosine "
          "lr) "
          f"and the plan's {len(plan)} shard sizes at W = 2 ({plan[0]} to "
          f"{plan[-1]}): 0 ulp from the plain versions; launches by route "
          f"so far: K4 {CM.ring_ag_route_launches}, K5 ring "
          f"{CM.ring_rs_route_launches}")
    return ag, rs


#: the ring matmul (K6, K7, K8) against its plain version: largest error
#: over the largest |plain value| — bf16 outputs round to 2^-8 relative
#: (one ulp is 3.9e-3; two roundings of sums that differ only in their
#: order are at most one ulp apart), fp32 only sums in another order
_CM_RTOL = {torch.bfloat16: 8e-3, torch.float32: 1e-5}
#: the main path's ring-matmul shapes at W = 2: M = 8 x 1024 tokens per
#: rank, K = 768 (kc = 384), N = 768 (query, key, value) or 3072 (mlp_in)
_CM_MAIN = ((8 * 1024, 384, 768), (8 * 1024, 384, 3072))
#: BERT-Large's with --ring-projections at W = 2 (phase 5k): M = 8 x 64
#: tokens per rank, K = 1024 (kc = 512), N = 1024 (query, key, value) or
#: 4096 (intermediate)
_CM_BERT_LARGE = ((8 * 64, 512, 1024), (8 * 64, 512, 4096))


def _cm_operands(world, m, kc, n, dt, gen, device=None):
    """Every rank's x [W, M, W*kc], weight shard [W, kc, N] and dy [W, M,
    N] on the card, scaled so that outputs stay O(1)."""
    dev = device or _DEV
    return (torch.randn(world, m, world * kc, generator=gen, device=dev)
            .to(dt),
            (torch.randn(world, kc, n, generator=gen, device=dev)
             / (world * kc) ** 0.5).to(dt),
            (torch.randn(world, m, n, generator=gen, device=dev)
             / m ** 0.5).to(dt))


def _cm_pairs(x, ws, dy, ring, rank=None):
    """[(name, kernel output, plain output)] of K6, K7, K8 on ``ring`` (the
    stacked operands on a `LocalRing`; row ``rank`` of them on a `Ring`)
    against the stacked plain versions."""
    pick = (lambda t: t) if rank is None else (lambda t: t[rank].contiguous())
    got = (CM.ring_matmul(pick(x), pick(ws), ring),
           CM.ring_matmul_dx(pick(dy), pick(ws), ring),
           CM.ring_matmul_dw(pick(x), pick(dy), ring))
    ref = (CM.ring_matmul_stacked(x, ws), CM.ring_matmul_dx_stacked(dy, ws),
           CM.ring_matmul_dw_stacked(x, dy))
    if rank is not None:
        ref = tuple(r[rank] for r in ref)
    return list(zip(("cm_fwd", "cm_dx", "cm_dw"), got, ref))


def _cm_hold(tag, pairs, worst) -> None:
    """Hold each kernel output within `_CM_RTOL` of its plain version;
    fold the largest absolute errors into ``worst``."""
    torch.cuda.synchronize()
    for name, got, ref in pairs:
        _check(bool(torch.isfinite(got).all()), f"{name} {tag}: not finite")
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        rel = err / max(scale, 1e-30)
        _check(rel <= _CM_RTOL[got.dtype], f"{name} {tag}: error {err:.3e} "
               f"= {rel:.3e} of max |plain| {scale:.3e} (limit "
               f"{_CM_RTOL[got.dtype]:g})")
        worst[name] = max(worst.get(name, 0.0), err)


def _cm_routes():
    return {k: dict(v) for k, v in CM.cm_route_launches.items()}


def _cm_routed(tag, route, fn):
    """``fn()``, checking that its K6 and K7 launches all took ``route``
    (`CM.cm_core`) and that each launched at least once: no route gives
    way to another or to the plain version."""
    before = _cm_routes()
    out = fn()
    got = {k: {r: n - before[k][r] for r, n in c.items()}
           for k, c in _cm_routes().items()}
    _check(all(c[route] > 0 and sum(c.values()) == c[route]
               for c in got.values()),
           f"{tag}: K6/K7 launches by route {got}, expected all {route}")
    return out


def _cm_repeat(tag, ops, pairs, ring) -> None:
    """K6, K7 and K8 called again on the same operands (the stacked ones
    of a `LocalRing`): bitwise equal to the first calls in ``pairs``."""
    x, ws, dy = ops
    again = (CM.ring_matmul(x, ws, ring), CM.ring_matmul_dx(dy, ws, ring),
             CM.ring_matmul_dw(x, dy, ring))
    for (name, got, _), second in zip(pairs, again):
        _check(torch.equal(got, second),
               f"{name} {tag}: two calls on the same inputs differ")


def check_ring_matmul_kernels() -> dict:
    """K6, K7 and K8 on a `LocalRing` against their stacked plain versions
    (`_CM_RTOL`), every K6/K7 call checked for the route `CM.cm_core`
    names: at W = 2, 4 and 8 on ragged shapes (M, kc and N multiples of no
    tile: the mma route, fp32 and bf16) and on shapes both routes take (kc
    and N multiples of 8: fp32 on the mma route, bf16 on the wgmma route);
    at W = 2 at the main path's own shapes (`_CM_MAIN`, bf16) twice (the
    second call reuses the slots behind the first's credits) and at a
    decode-sized M = 4; then the main path's M, K and N at W = 4 and 8
    (`check_cm_worlds`). Every case on the wgmma route (the main shapes
    among them) calls all three kernels twice on the same inputs: bitwise
    equal. Returns the largest absolute error of each kernel."""
    gen = torch.Generator(device=_DEV).manual_seed(12)
    worst: dict = {}
    cases = 0
    for world in (2, 4, 8):
        shapes = ((37, 5, 19), (200, 24, 72))
        ring = LocalRing(world, _DEV, 1,
                         cm_elems=max(kc * n for _, kc, n in shapes))
        for m, kc, n in shapes:
            for dt in (torch.float32, torch.bfloat16):
                ops = _cm_operands(world, m, kc, n, dt, gen)
                route = CM.cm_core(dt, world, kc, n)
                tag = f"W={world} M={m} kc={kc} N={n} {dt} ({route})"
                pairs = _cm_routed(tag, route, lambda: _cm_pairs(*ops, ring))
                _cm_hold(tag, pairs, worst)
                if route == "wgmma":
                    _cm_repeat(tag, ops, pairs, ring)
                cases += 1
        ring.close()
    ring = LocalRing(2, _DEV, 1, cm_elems=max(
        kc * n for _, kc, n in _CM_MAIN + _CM_BERT_LARGE))
    for m, kc, n, calls in ([s + (2,) for s in _CM_MAIN + _CM_BERT_LARGE]
                            + [(4, 384, 768, 1)]):
        for call in range(calls):
            ops = _cm_operands(2, m, kc, n, torch.bfloat16, gen)
            tag = f"W=2 M={m} K={2 * kc} N={n} call {call}"
            pairs = _cm_routed(tag, "wgmma", lambda: _cm_pairs(*ops, ring))
            _cm_hold(tag, pairs, worst)
            _cm_repeat(tag, ops, pairs, ring)
            cases += 1
    ring.close()
    more = check_cm_worlds(gen, worst)
    print(f"ring matmul check: K6, K7, K8 in {cases} cases (W = 2, 4, 8 on "
          "ragged and aligned shapes, fp32 and bf16; the main path's "
          "M=8192 K=768 N=768 and 3072 bf16 and BERT-Large's M=512 K=1024 "
          "N=1024 and 4096 at W = 2, twice each; M=4 at W = "
          f"2) and {more} more (W = 4 and 8 at the main path's M, K and N), "
          "K6/K7 every call on the route cm_core names (wgmma for bf16 with kc "
          "and N multiples of 8), every wgmma-route case twice on the same "
          "inputs, bitwise equal: largest errors "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (limits {_CM_RTOL[torch.bfloat16]:g} bf16, "
          f"{_CM_RTOL[torch.float32]:g} fp32, of max |plain|)")
    return worst


def check_cm_worlds(gen, worst) -> int:
    """K6, K7 and K8 at W = 4 and 8 on a `LocalRing` at the main path's M
    = 8192, K = 768 and N = 768 and 3072 (bf16; kc = 192 and 96: a TMA box
    of 64 columns crosses a chunk's end, which the chunk-bounded tensor
    maps must fill with zeros), within `_CM_RTOL` of the stacked plain
    versions, K6 and K7 on the wgmma route, and each called twice on the
    same inputs: bitwise equal (one block sums each element of K6 and K7
    in one order; K8's split partials are summed in segment order, with no
    float atomics). Returns the number of cases."""
    cases = 0
    for world in (4, 8):
        kc = 768 // world
        ring = LocalRing(world, _DEV, 1, cm_elems=kc * 3072)
        for m, _, n in _CM_MAIN:
            ops = _cm_operands(world, m, kc, n, torch.bfloat16, gen)
            tag = f"W={world} M={m} K=768 N={n}"
            pairs = _cm_routed(tag, "wgmma", lambda: _cm_pairs(*ops, ring))
            _cm_hold(tag, pairs, worst)
            _cm_repeat(tag, ops, pairs, ring)
            del ops, pairs
            cases += 1
        ring.close()
    return cases


#: K9's grids: the probe's two granularities over 16384 rows, and a third
_K9_GRIDS = probe.GRANULARITIES + ((33, 8),)


def check_overhead_probe_kernel() -> float:
    """K9 (the probe's ``2x + 1``) against its plain version and against
    one PyTorch call computing the same function (``torch.add(one, x,
    alpha=2.0)``), bitwise, at `_K9_GRIDS`: random fp32 rows with infinities,
    values that overflow when doubled, signed zeros and subnormals. Returns
    the largest absolute difference (0.0)."""
    gen = torch.Generator(device=_DEV).manual_seed(15)
    one = torch.ones((), device=_DEV)
    for nblocks, rpb in _K9_GRIDS:
        x = torch.randn(nblocks * rpb, OP.WIDTH, generator=gen, device=_DEV)
        x[0, :6] = torch.tensor([float("inf"), float("-inf"), 3.0e38, -0.0,
                                 1e-42, -1.5])
        got = OP.affine_probe(x, rpb)
        plain = OP.affine_probe_plain(x)
        library = torch.add(one, x, alpha=2.0)
        torch.cuda.synchronize()
        for name, ref in (("its plain version", plain),
                          ("torch.add(one, x, alpha=2.0)", library)):
            _check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                   f"overhead probe kernel at grid {nblocks} x ({rpb}, 512) "
                   f"is not bitwise equal to {name}")
    print(f"overhead probe kernel check: grids {list(_K9_GRIDS)} of (rows, "
          "512) fp32: bitwise equal to the plain version and to "
          "torch.add(one, x, alpha=2.0)")
    return 0.0


# ---------------------------------------------------------------------------
# phase 4: serve GPT-2 small through DecodeEngine
# ---------------------------------------------------------------------------


def _requests():
    rs = np.random.RandomState(0)
    lens = (5, 17, 33, 64, 97, 128, 160, 200, 11, 150)
    return [(list(rs.randint(0, GPT2_SMALL.vocab_size, n)),
             int(rs.randint(16, 33))) for n in lens]


def serve(model, reqs, chunk):
    """All requests through a 4-slot engine, admitted as slots free.
    Returns (tokens per request, engine, wall seconds)."""
    eng = DecodeEngine(model, slots=_SLOTS, prefill_chunk=chunk, device=_DEV)
    pending, done = list(range(len(reqs))), {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while pending or eng.active:
        while pending and eng.free:
            i = pending.pop(0)
            eng.submit(reqs[i][0], reqs[i][1], request_id=i)
        for fin in eng.tick():
            done[fin.request_id] = fin.tokens
    wall = time.perf_counter() - t0
    _check(sorted(done) == list(range(len(reqs))),
           f"chunk {chunk}: not every request finished")
    for i, toks in done.items():
        _check(len(toks) == reqs[i][1]
               and all(0 <= t < GPT2_SMALL.vocab_size for t in toks),
               f"chunk {chunk}: request {i} gave {toks}")
    return done, eng, wall


def _near_tie_gap(model, prompt, ref, at):
    """Top-2 gap of the reference's logits where it chose ref[at]."""
    seq = torch.tensor([prompt + ref[:at]], device=_DEV)
    with torch.no_grad():
        logits = model(seq)[0, -1, :GPT2_SMALL.vocab_size]
    top = torch.topk(logits, 2).values
    return float(top[0] - top[1])


def check_serving():
    cfg = dataclasses.replace(GPT2_SMALL, kv_cache_len=_L,
                              decode_use_flash=True)
    model = GptLmHeadModel(cfg, device=_DEV, seed=0)
    model16 = GptLmHeadModel(dataclasses.replace(cfg, dtype=torch.bfloat16),
                             device=_DEV, seed=0)
    print(f"GPT-2 small: {sum(p.numel() for p in model.parameters())} "
          f"params, {cfg.num_hidden_layers} layers, hidden "
          f"{cfg.hidden_size}, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab_size}), ring {_L}, slots {_SLOTS}")
    reqs = _requests()
    t0 = time.perf_counter()
    refs = [generate(model, [p], n, device=_DEV)[0, len(p):].tolist()
            for p, n in reqs]
    print(f"reference generate (fp32, batch 1): "
          f"{time.perf_counter() - t0:.1f} s")

    FA.reset_launch_counts()           # the main path starts here
    runs = [("fp32", 1, *serve(model, reqs, 1)),
            ("fp32", 16, *serve(model, reqs, 16))]
    fp32_split_k = FA.flash_fwd_route_launches["split_k"]
    runs.append(("bf16", 16, *serve(model16, reqs, 16)))
    launches = FA.flash_fwd_launches   # ... and ends here
    routes = dict(FA.flash_fwd_route_launches)
    decode_ticks = sum(eng.decode_steps for *_, eng, _ in runs)
    bf16_ticks = runs[-1][3].decode_steps
    print(f"main path: {decode_ticks} decode ticks ({bf16_ticks} bf16), "
          f"{sum(eng.prefill_steps for *_, eng, _ in runs)} prefill ticks, "
          f"flash_fwd launches {launches}, by route {routes} (bf16 split_k "
          f"{routes['split_k'] - fp32_split_k})")
    layers = cfg.num_hidden_layers
    _check(launches > 0 and launches == layers * decode_ticks,
           f"flash_fwd launched {launches} times for {decode_ticks} decode "
           "ticks")
    _check(routes["split_k"] == launches
           and routes["split_k"] - fp32_split_k == layers * bf16_ticks,
           f"decode ticks' K1 launches by route {routes}: expected "
           f"{layers} split_k launches per tick")

    for dt, chunk, done, eng, wall in runs:
        new = sum(len(t) for t in done.values())
        g = eng.phase_gauges()
        print(f"serve {dt} chunk {chunk}: {len(done)} requests, {new} new "
              f"tokens in {wall:.3f} s ({new / wall:.1f} tok/s), decode tick "
              f"p50 {g['serve.decode_tick_ms_p50']} ms p99 "
              f"{g['serve.decode_tick_ms_p99']} ms, decode ticks "
              f"{eng.decode_steps}, prefill ticks {eng.prefill_steps}")
        if dt != "fp32":
            continue
        for i, (prompt, _) in enumerate(reqs):
            got, ref = done[i], refs[i]
            if got == ref:
                continue
            at = next(j for j, (a, b) in enumerate(zip(got, ref)) if a != b)
            gap = _near_tie_gap(model, prompt, ref, at)
            print(f"  request {i}: diverges from generate at token {at}, "
                  f"reference top-2 gap {gap:.3e}")
            _check(gap < 1e-3, f"request {i}: engine tokens differ from "
                   "generate away from a near-tie")
    return routes, runs


# ---------------------------------------------------------------------------
# phase 5: train GPT-2 small through the training CLI
# ---------------------------------------------------------------------------

_TRAIN_ARGS = ["--model", "gpt2", "--fp16", "--flash-attention",
               "--dropout0", "--batch-size", "16", "--sequence-len", "1024",
               "--base-lr", "0.01", "--momentum", "0.9", "--threshold", "25",
               "--num-warmup-batches", "5", "--num-batches-per-iter", "5",
               "--num-iters", "3"]
_TRAIN_WARMUP = 5


def _train_counts(ts) -> dict:
    return {"flash_fwd": FA.flash_fwd_launches,
            "flash_fwd_tc": FA.flash_fwd_route_launches["tensor_core"],
            "flash_bwd_dq": FA.flash_bwd_dq_launches,
            "flash_bwd_dkv": FA.flash_bwd_dkv_launches,
            "flash_bwd_dq_tc": FA.flash_bwd_route_launches["dq"][
                "tensor_core"],
            "flash_bwd_dkv_tc": FA.flash_bwd_route_launches["dkv"][
                "tensor_core"],
            "fused_update": FS.fused_update_launches,
            "rs": ts.rs_launches, "ag": ts.ag_launches,
            "update": ts.update_launches}


def train_gpt2():
    """20 steps of ``benchmarks/gpt.py`` (the main training path), every
    step's launches checked: K1, K2 and K3 12 times each (one per layer,
    all three through their tensor-core routes), one shard update,
    reduce-scatter and all-gather per bucket. Returns
    (result, launches, step times in ms of the timed steps)."""
    cfg = GPT2_SMALL
    FA.reset_launch_counts()            # the main path
    FS.fused_update_launches = 0        # starts here
    marks, prev = [], {}

    def on_step(ts, state, metrics):
        del state, metrics
        now = _train_counts(ts)
        nb = ts.plan.num_buckets
        before = prev or {k: 0 for k in now} | {"ag": nb}   # init's gathers
        want = {"flash_fwd": cfg.num_hidden_layers,
                "flash_fwd_tc": cfg.num_hidden_layers,
                "flash_bwd_dq": cfg.num_hidden_layers,
                "flash_bwd_dkv": cfg.num_hidden_layers,
                "flash_bwd_dq_tc": cfg.num_hidden_layers,
                "flash_bwd_dkv_tc": cfg.num_hidden_layers,
                "fused_update": nb, "rs": nb, "ag": nb, "update": nb}
        got = {k: now[k] - before[k] for k in now}
        _check(got == want, f"train step {len(marks) + 1}: launches {got}, "
               f"expected {want}")
        prev.update(now)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    res = train_cli.main(_TRAIN_ARGS + ["--device", _DEV],
                         on_step=on_step)
    launches = _train_counts(res.train_step)      # ... and ends here
    losses = res.losses
    print(f"train losses: {[round(x, 4) for x in losses]}")
    _check(len(losses) == 20 and all(np.isfinite(losses)),
           f"train: losses {losses}")
    _check(losses[-1] < losses[0], "train: the loss did not fall")
    step_ms = [a.elapsed_time(b) for a, b in
               zip(marks[_TRAIN_WARMUP - 1:-1], marks[_TRAIN_WARMUP:])]
    print(f"main path (train): 20 steps, {res.train_step.plan.num_buckets} "
          f"buckets, launches {launches}")
    return res, launches, step_ms


def _loss_fn(m, b):
    return gpt_lm_loss(m(b["input_ids"], train=True), b["input_ids"],
                       vocab_size=GPT2_SMALL.vocab_size)


def check_flash_step_vs_dense() -> dict:
    """One fp32 step at full width, 2 layers, batch 2: the flash kernels
    (K1, K2, K3) against the dense attention core. The updated parameters
    agree within 1e-5 and the gradients they imply, (p0 - p1) / lr, within
    1e-3 of the largest gradient. K1, K2 and K3 run their CUDA-core routes
    here (fp32), once per layer each; returns their launches by route,
    ``{"fwd": {...}, "dq": {...}, "dkv": {...}}`` (this step is those
    routes' main path)."""
    cfg = dataclasses.replace(dropout_free(GPT2_SMALL), num_hidden_layers=2)
    batch = synthetic_gpt_batch(
        torch.Generator(device=_DEV).manual_seed(4), 2, 1024,
        cfg.vocab_size)
    lr = 0.01
    runs = []
    def by_route():
        return {"fwd": dict(FA.flash_fwd_route_launches),
                **{w: dict(c) for w, c in FA.flash_bwd_route_launches.items()}}

    before = by_route()                           # the main path starts
    for impl in (flash_causal_attention_impl(), None):
        model = GptLmHeadModel(cfg, attention_impl=impl, device=_DEV, seed=0)
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        ts = build_train_step(_loss_fn, model, device=_DEV,
                              optimizer=FS.fused_sgd(lr=lr, momentum=0.9))
        state, metrics = ts.step(ts.init(), batch)
        runs.append((float(metrics["loss"]), ts.gather_params(state), p0))
    routes = {k: {r: n - before[k][r] for r, n in c.items()}  # ... and
              for k, c in by_route().items()}                 # ends here
    layers = cfg.num_hidden_layers
    _check(routes == {
        "fwd": {"tensor_core": 0, "split_k": 0, "cuda_core": layers},
        **{w: {"tensor_core": 0, "cuda_core": layers}
           for w in ("dq", "dkv")}},
        f"fp32 step: K1, K2, K3 launches by route {routes}")
    (lf, pf, p0), (ld, pd, _) = runs
    p_err = max(float((pf[n] - pd[n]).abs().max()) for n in pf)
    g_max = max(float((p0[n] - pd[n]).abs().max()) / lr for n in pd)
    g_err = max(float((pf[n] - pd[n]).abs().max()) / lr for n in pf)
    print(f"fp32 step, flash vs dense (2 layers, B=2, S=1024): loss "
          f"{lf:.6f} vs {ld:.6f}, max |param diff| {p_err:.3e}, implied "
          f"gradients {g_err:.3e} of max {g_max:.3e}")
    _check(abs(lf - ld) <= 1e-5 * abs(ld), "flash vs dense: losses differ")
    _check(p_err <= 1e-5 and g_err <= 1e-3 * g_max,
           "flash vs dense: the updated parameters differ")
    return routes


def train_with_dropout():
    """3 steps through the CLI with its default dropout (the kernel rule
    zeroes the attention-probs dropout; embedding and hidden dropout draw
    from the step's generator), 2 layers, batch 4."""
    res = train_cli.main(["--fp16", "--flash-attention",
                          "--num-hidden-layers", "2", "--batch-size", "4",
                          "--sequence-len", "1024", "--num-warmup-batches",
                          "0", "--num-batches-per-iter", "3",
                          "--num-iters", "1", "--device", _DEV])
    print(f"train with dropout (2 layers, B=4): losses "
          f"{[round(x, 4) for x in res.losses]}")
    _check(len(res.losses) == 3 and all(np.isfinite(res.losses)),
           "train with dropout: a loss is not finite")


# ---------------------------------------------------------------------------
# phase 5b: two ranks on one card, mode dear-fused against dear
# ---------------------------------------------------------------------------

#: per-rank batch 8: 16 sequences of 1024 per step over the two ranks
_TWO_RANK_ARGS = ["--model", "gpt2", "--fp16", "--flash-attention",
                  "--dropout0", "--batch-size", "8", "--sequence-len",
                  "1024", "--base-lr", "0.01", "--momentum", "0.9",
                  "--threshold", "25", "--num-warmup-batches", "2",
                  "--num-batches-per-iter", "2", "--num-iters", "1"]
#: phase 5b's steps, and its warmup (the steps before the timed ones):
#: 4, for the script's time limit
_TWO_RANK_STEPS, _TWO_RANK_WARMUP = 4, 2
#: the last step's loss of dear-fused against dear (relative): JAX's "fp32
#: ~1e-5 rel" (docs/KERNELS.md:119-124) widened for bf16 — the dear run
#: rounds each reduced gradient to bf16 (2^-9 relative), the ring keeps
#: the sum in fp32, and bf16 compute carries that into the loss
_FUSED_VS_DEAR_RTOL = 1e-3


#: the two-rank runs: name -> the training CLI's mode flags
_TWO_RANK_MODES = {
    "dear-fused": ["--mode", "dear-fused"],
    "dear": ["--mode", "dear"],
    "ring-projections": ["--mode", "dear-fused", "--ring-projections"],
}
#: the last step's loss with ring projections against dear-fused without
#: (relative): slice 3's limit, kept — K6-K8 sum bf16 products in fp32 in
#: another order than cuBLAS, which bf16 compute carries into the loss
_RP_VS_FUSED_RTOL = 1e-3


def _two_rank_counts(ts) -> dict:
    return {"flash_fwd": FA.flash_fwd_launches,
            "flash_fwd_tc": FA.flash_fwd_route_launches["tensor_core"],
            "flash_bwd_dq": FA.flash_bwd_dq_launches,
            "flash_bwd_dkv": FA.flash_bwd_dkv_launches,
            "flash_bwd_dq_tc": FA.flash_bwd_route_launches["dq"][
                "tensor_core"],
            "flash_bwd_dkv_tc": FA.flash_bwd_route_launches["dkv"][
                "tensor_core"],
            "fused_update": FS.fused_update_launches,
            "ring_ag": CM.ring_ag_launches, "ring_rs": CM.ring_rs_launches,
            "ring_ag_direct": CM.ring_ag_route_launches["direct"]["vector"],
            "ring_ag_direct_all": sum(
                CM.ring_ag_route_launches["direct"].values()),
            "ring_rs_vector": CM.ring_rs_route_launches["vector"],
            "cm_fwd": CM.cm_fwd_launches, "cm_dx": CM.cm_dx_launches,
            "cm_dw": CM.cm_dw_launches,
            "cm_fwd_wgmma": CM.cm_route_launches["fwd"]["wgmma"],
            "cm_dx_wgmma": CM.cm_route_launches["dx"]["wgmma"],
            "rs": ts.rs_launches, "ag": ts.ag_launches,
            "update": ts.update_launches}


def _join_two_ranks(rank: int, out: Path, world: int = 2) -> None:
    """The launcher variables of rank ``rank`` of ``world`` sharing card
    0, their group meeting at a FileStore in ``out``."""
    os.environ.update(
        DEAR_NUM_PROCESSES=str(world), DEAR_PROCESS_ID=str(rank),
        DEAR_COORDINATOR_ADDRESS=f"file://{out}/store",
        DEAR_LOCAL_RANK=str(rank), DEAR_LOCAL_SIZE=str(world))


def _zero_two_rank_counts() -> None:
    """Every launch count that `_two_rank_counts` reads, to 0."""
    FA.reset_launch_counts()
    FS.fused_update_launches = 0
    _zero_ring_counts()
    CM.cm_fwd_launches = CM.cm_dx_launches = CM.cm_dw_launches = 0
    for by_route in CM.cm_route_launches.values():
        by_route.update(wgmma=0, mma=0)


def _digest(params: dict) -> str:
    """sha256 over the parameters' bytes in name order."""
    digest = hashlib.sha256()
    for name in sorted(params):
        digest.update(params[name].detach().cpu().numpy().tobytes())
    return digest.hexdigest()


def check_ring_matmul_two_ranks(rank: int, shapes=_CM_MAIN) -> dict:
    """K6, K7 and K8 on the main path's own transport — the two processes'
    IPC `Ring` — against the stacked plain versions at a main path's
    shapes (``shapes``: `_CM_MAIN`, GPT-2's, by default; bf16), two calls
    each: both ranks draw both ranks' operands from one seed, each feeds
    its own row to the kernels and holds its outputs to `_CM_RTOL` of the
    plain versions' row. Returns the largest absolute error of each."""
    world = 2
    group = backend.init(_DEV)
    dev = backend.device()
    ring = Ring(group, dev, 1, cm_elems=max(kc * n for _, kc, n in shapes))
    gen = torch.Generator(device=dev).manual_seed(14)
    worst: dict = {}
    for m, kc, n in shapes:
        for call in range(2):
            ops = _cm_operands(world, m, kc, n, torch.bfloat16, gen, dev)
            tag = f"rank {rank} IPC ring M={m} K={world * kc} N={n} call {call}"
            _cm_hold(tag, _cm_routed(tag, "wgmma", lambda: _cm_pairs(
                *ops, ring, rank=rank)), worst)
    ring.close()
    print(f"rank {rank}: IPC ring matmul check at the main path's shapes: "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def check_ring_two_ranks(rank: int) -> tuple:
    """K4 and K5 ring on the main path's own transport — the two
    processes' IPC `Ring`, two contexts time-slicing the card, sys-scope
    flags — against the stacked plain versions, bitwise, at every shard
    size of the training run's plan: K4 in fp32 and in bf16 on the slot
    route and on the direct route (into outputs the ring registered, NaN
    bits before the call; each call's route checked), and two K5 ring
    calls (bf16 gradients, the run's SGD momentum: its
    first and second step). Both ranks draw the stacked ``[2, ...]``
    inputs of both ranks from one seed on the card, so each holds its
    peer's input as the gathered one; each feeds its own row to the
    kernel and holds its output against the stacked plain version's row.
    Returns the largest absolute differences (0.0)."""
    world = 2
    group = backend.init(_DEV)
    dev = backend.device()
    sizes = _plan_shard_sizes(world)
    ring = Ring(group, dev, max(sizes))
    outs = {dt: ring.register_outputs([world * n for n in sizes], dt)
            for dt in (torch.float32, torch.bfloat16)}
    gen = torch.Generator(device=dev).manual_seed(11)
    opt = FS.fused_sgd(lr=0.01, momentum=0.9)
    ag = rs = 0.0
    for i, n in enumerate(sizes):
        for dt in (torch.float32, torch.bfloat16):
            shards = torch.randn(world, n, generator=gen, device=dev).to(dt)
            ref = CM.ring_all_gather_stacked(shards)[rank]
            mine = shards[rank].contiguous()
            width = _ring_width(n * mine.element_size())
            out = outs[dt][i]
            out.view(torch.uint8).fill_(0xFF)
            pairs = [(_ag_routed(f"rank {rank} IPC n={n} {dt} slot",
                                 ("slot", width),
                                 lambda: CM.ring_all_gather(mine, ring)),
                      ref),
                     (_ag_routed(f"rank {rank} IPC n={n} {dt} direct",
                                 ("direct", width),
                                 lambda: CM.ring_all_gather(
                                     mine, ring, out=out, direct=True)),
                      ref)]
            torch.cuda.synchronize(dev)
            ulps, diff = _ring_ulps(pairs)
            _check(ulps == 0, f"rank {rank} IPC ring all-gather n={n} {dt}: "
                   f"{ulps} ulp from its plain version")
            ag = max(ag, diff)
        p0 = torch.randn(world, n, generator=gen, device=dev)
        pk, pr = p0[rank].clone(), p0.clone()
        sk = opt.init(pk)
        sr = [opt.init(pr[i]) for i in range(world)]
        for step in range(2):
            g = torch.randn(world, world * n, generator=gen,
                            device=dev).bfloat16()
            CM.fused_reduce_scatter_update(g[rank].contiguous(), pk, sk, opt,
                                           ring, mean_world=world, step=step)
            CM.fused_reduce_scatter_update_stacked(g, pr, sr, opt,
                                                   mean_world=world,
                                                   step=step)
            pairs = [(pk, pr[rank])] + [(sk[k], sr[rank][k]) for k in sk
                                        if torch.is_tensor(sk[k])]
            torch.cuda.synchronize(dev)
            ulps, diff = _ring_ulps(pairs)
            _check(ulps == 0, f"rank {rank} IPC ring reduce-scatter n={n} "
                   f"step {step}: {ulps} ulp from its plain version")
            rs = max(rs, diff)
    ring.close()
    print(f"rank {rank}: IPC ring check: K4 fp32 and bf16 on the slot and "
          f"the direct route (registered outputs), K5 ring bf16 (two steps) "
          f"at the plan's {len(sizes)} shard sizes ({sizes[0]} to "
          f"{sizes[-1]}): 0 ulp from the plain versions")
    return ag, rs


def rank_worker(rank: int, out: Path, modes: str) -> None:
    """One of the two ranks (a process of its own, on card ``rank %
    device_count``): `rank_run` for each of ``modes`` (comma-separated
    keys of `_TWO_RANK_MODES`) in turn over one gloo group that meets at
    a FileStore in ``out`` (one process start for all of them); the
    results by mode, with each run's wall seconds, into
    ``out/rank<r>.json``."""
    _join_two_ranks(rank, out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for mode in modes.split(","):
        t0 = time.perf_counter()
        results[mode] = rank_run(rank, mode)
        results[mode]["wall_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    (out / f"rank{rank}.json").write_text(json.dumps(results))
    backend.shutdown()


def rank_run(rank: int, mode: str) -> dict:
    """One run of `rank_worker`: in dear-fused, first
    `check_ring_two_ranks` (both K4 routes on the IPC ring), with ring
    projections `check_ring_matmul_two_ranks` (their launches are not the
    main path's); then `_TWO_RANK_STEPS` steps of the training CLI in
    ``mode`` (a key of `_TWO_RANK_MODES`), every step's launches checked
    (its counts set to 0 just before); in both dear-fused modes, a
    ``torch.profiler`` trace of 3 more steps (both ranks; their ring
    calls pair up). Returns the gathered parameters' digest, the losses,
    the launches, the step times and the trace."""
    ring_errs = check_ring_two_ranks(rank) if mode == "dear-fused" else None
    rp = mode == "ring-projections"
    cm_errs = check_ring_matmul_two_ranks(rank) if rp else None
    layers = GPT2_SMALL.num_hidden_layers
    _zero_two_rank_counts()                       # the main path starts here
    marks, prev = [], {}
    fused = mode != "dear"
    n_cm = 4 * layers if rp else 0     # query, key, value, mlp_in

    def on_step(ts, state, metrics):
        del state, metrics
        now = _two_rank_counts(ts)
        nb = ts.plan.num_buckets
        before = prev or {k: 0 for k in now} | {       # init's gathers
            "ag": nb, "ring_ag": nb if fused else 0,
            "ring_ag_direct": nb if fused else 0,
            "ring_ag_direct_all": nb if fused else 0}
        want = {"flash_fwd": layers, "flash_fwd_tc": layers,
                "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
                "flash_bwd_dq_tc": layers, "flash_bwd_dkv_tc": layers,
                "rs": nb, "ag": nb, "update": nb,
                "fused_update": 0 if fused else nb,
                "ring_ag": nb if fused else 0, "ring_rs": nb if fused else 0,
                "ring_ag_direct": nb if fused else 0,
                "ring_ag_direct_all": nb if fused else 0,
                "ring_rs_vector": nb if fused else 0,
                "cm_fwd": n_cm, "cm_dx": n_cm, "cm_dw": n_cm,
                "cm_fwd_wgmma": n_cm, "cm_dx_wgmma": n_cm}
        got = {k: now[k] - before[k] for k in now}
        _check(got == want, f"rank {rank} {mode} step {len(marks) + 1}: "
               f"launches {got}, expected {want}")
        prev.update(now)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    torch.cuda.reset_peak_memory_stats()
    res = train_cli.main(_TWO_RANK_ARGS + _TWO_RANK_MODES[mode]
                         + ["--device", _DEV], on_step=on_step)
    ts = res.train_step
    launches = _two_rank_counts(ts)               # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in
               zip(marks[_TWO_RANK_WARMUP - 1:-1], marks[_TWO_RANK_WARMUP:])]
    # both ranks trace the same 3 further steps (their ring calls pair up)
    trace = (trace_train_steps(ts, res.state, res.batch,
                               float(np.percentile(step_ms, 50)),
                               label=f"rank {rank} {mode}, 8 x 1024")
             if fused else None)
    params = ts.gather_params(res.state)          # dear-fused: through K4
    run = {
        "losses": res.losses, "launches": launches, "step_ms": step_ms,
        "tokens_per_s": res.total_mean * 1024, "params": _digest(params),
        "peak_bytes": peak,
        "trace": trace, "ring_errs": ring_errs, "cm_errs": cm_errs,
        "shard_sizes": sorted({b.shard_size for b in ts.plan.buckets}),
        "bucket_shards": [b.shard_size for b in ts.plan.buckets],
        "buckets": ts.plan.num_buckets,
        "device": str(backend.device()), "card_shared": backend.card_shared(),
        "backend": torch.distributed.get_backend()}
    ts.close()
    return run


def train_two_ranks(modes: str, timeout: float = 600.0) -> list:
    """Spawn the two ranks of ``modes`` (comma-separated; this script with
    ``--train-rank``), wait for both, and return their results (by mode);
    any rank's failure, or the deadline, fails the run with both ranks'
    logs."""
    return spawn_two_ranks(
        "two-rank", lambda r, out: ["--train-rank", str(r), "--out",
                                    str(out), "--mode", modes], timeout)


def start_ranks(name: str, worker_args, world: int = 2) -> tuple:
    """Start ``world`` ranks of this script (argv ``worker_args(rank,
    out)``), each to write ``out/rank<r>.json``; returns the handle
    `wait_ranks` takes."""
    out = _ROOT / "build" / "chip_smoke" / f"{name}-{os.getpid()}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torch.cuda.empty_cache()
    logs = [out / f"rank{r}.log" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 *worker_args(r, out)],
                stdout=f, stderr=subprocess.STDOUT, cwd=_ROOT))
    return name, out, procs, logs


def wait_ranks(handle, timeout: float) -> list:
    """Wait for the ranks `start_ranks` started and return their results;
    any rank's failure, or the deadline, fails the run with every rank's
    log."""
    name, out, procs, logs = handle
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode != 0 for p in procs):
        for r, (p, log) in enumerate(zip(procs, logs)):
            print(f"--- rank {r} of {name} (exit {p.returncode}):\n"
                  + "\n".join(log.read_text().splitlines()[-40:]))
        raise RuntimeError(f"chip_smoke: a rank of the {len(procs)}-rank "
                           f"{name} run failed or passed the {timeout:.0f} s "
                           "deadline")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(len(procs))]


def spawn_two_ranks(name: str, worker_args, timeout: float,
                    world: int = 2) -> list:
    """Spawn two (or ``world``) ranks of this script (argv
    ``worker_args(rank, out)``), each writing ``out/rank<r>.json``, wait
    for all, and return their results (`start_ranks`, `wait_ranks`)."""
    return wait_ranks(start_ranks(name, worker_args, world), timeout)


def train_dear_fused() -> tuple:
    """The main paths of slices 3 and 4: GPT-2 small at full width trained
    `_TWO_RANK_STEPS` steps with ``--mode dear-fused`` by two ranks sharing
    card 0 (two
    processes, one ring), again with ``--ring-projections``, then with
    ``--mode dear`` for the loss comparison. Checks: finite and falling
    losses, equal on both ranks; both ranks' gathered parameters bitwise
    equal; every step's launches (in each rank); dear-fused's last
    loss within `_FUSED_VS_DEAR_RTOL` of dear's, and with ring projections
    within `_RP_VS_FUSED_RTOL` of dear-fused's. Returns the two ranks'
    results of each run: (dear-fused, ring projections, dear). The three
    runs share one process per rank, ``dear`` first (its peak memory, which
    phase 5l holds fsdp's against, is a fresh process's)."""
    t0 = time.perf_counter()
    ranks = train_two_ranks("dear,dear-fused,ring-projections")
    wall = time.perf_counter() - t0
    fused, rp, dear = ([r[mode] for r in ranks] for mode in
                       ("dear-fused", "ring-projections", "dear"))
    for mode, ranks in (("dear-fused", fused), ("ring-projections", rp),
                        ("dear", dear)):
        losses = ranks[0]["losses"]
        print(f"two ranks {mode}: losses {[round(x, 4) for x in losses]}; "
              f"{ranks[0]['buckets']} buckets, backend "
              f"{ranks[0]['backend']}, devices "
              f"{[r['device'] for r in ranks]}, card shared "
              f"{ranks[0]['card_shared']}")
        _check(len(losses) == _TWO_RANK_STEPS
               and all(np.isfinite(losses)),
               f"two ranks {mode}: losses {losses}")
        _check(losses[-1] < losses[0], f"two ranks {mode}: no fall")
        _check(ranks[1]["losses"] == losses,
               f"two ranks {mode}: the ranks' losses differ")
        _check(ranks[1]["params"] == ranks[0]["params"],
               f"two ranks {mode}: the ranks' gathered parameters differ")
    _check(fused[0]["shard_sizes"] == _plan_shard_sizes(2),
           "two ranks: the run's plan is not the one the kernels were "
           "checked at")
    lf, ld = fused[0]["losses"][-1], dear[0]["losses"][-1]
    lr = rp[0]["losses"][-1]
    rel = abs(lf - ld) / abs(ld)
    rel_rp = abs(lr - lf) / abs(lf)
    print(f"step-{_TWO_RANK_STEPS} loss: dear-fused {lf:.6f}, dear "
          f"{ld:.6f}, relative "
          f"difference {rel:.3e} (limit {_FUSED_VS_DEAR_RTOL:g}); with ring "
          f"projections {lr:.6f}, {rel_rp:.3e} from dear-fused (limit "
          f"{_RP_VS_FUSED_RTOL:g}); parameters of the two ranks bitwise "
          f"equal in every run; wall {wall:.1f} s in one spawn (rank 0: "
          f"{fused[0]['wall_s']:.1f} s dear-fused, {rp[0]['wall_s']:.1f} s "
          f"ring projections, {dear[0]['wall_s']:.1f} s dear)")
    _check(rel <= _FUSED_VS_DEAR_RTOL, "dear-fused and dear losses differ")
    _check(rel_rp <= _RP_VS_FUSED_RTOL,
           "ring projections and dear-fused losses differ")
    return fused, rp, dear


# ---------------------------------------------------------------------------
# phase 5c: the overhead probe
# ---------------------------------------------------------------------------

#: K9 launches of one elementwise section: per granularity one warm-up,
#: `probe.ITERS` host-timed and as many event-timed calls
_PROBE_K9_LAUNCHES = len(probe.GRANULARITIES) * (1 + 2 * probe.ITERS)
#: K4 and K5 ring launches of one kernel section, each: per shard size one
#: warm-up and `probe.RING_ITERS` host-timed calls, and as many event-timed
#: ones on a `LocalRing`
_PROBE_RING_LAUNCHES = len(probe.SHARDS) * (1 + probe.RING_ITERS)
_PROBE_LOCAL_RING_LAUNCHES = len(probe.SHARDS) * (1 + 2 * probe.RING_ITERS)


def _zero_ring_counts() -> None:
    """K4's and the K5 ring's launch counts, totals and by route, to 0."""
    CM.ring_ag_launches = CM.ring_rs_launches = 0
    for by_width in CM.ring_ag_route_launches.values():
        by_width.update(vector=0, scalar=0)
    CM.ring_rs_route_launches.update(vector=0, scalar=0)


def _probe_counts() -> dict:
    return {"overhead_probe": OP.affine_probe_launches,
            "ring_ag": CM.ring_ag_launches, "ring_rs": CM.ring_rs_launches,
            "ring_ag_slot": sum(CM.ring_ag_route_launches["slot"].values())}


def _zero_probe_counts() -> None:
    OP.affine_probe_launches = 0
    _zero_ring_counts()


def run_probe() -> tuple:
    """The probe's main path in this process, as a user runs it on the
    card (`scripts.overhead_probe.main`, both sections, the kernel section
    on a two-rank `LocalRing`): every count set to 0 just before, read just
    after, and checked (K9 `_PROBE_K9_LAUNCHES` times, K4 and the K5 ring
    `_PROBE_LOCAL_RING_LAUNCHES` each, K4 all on its slot route: the
    probe's outputs are not registered). Returns (its rows, the
    launches)."""
    _zero_probe_counts()
    res = probe.main(["--section", "all", "--world", "2"])
    launches = _probe_counts()
    want = {"overhead_probe": _PROBE_K9_LAUNCHES,
            "ring_ag": _PROBE_LOCAL_RING_LAUNCHES,
            "ring_rs": _PROBE_LOCAL_RING_LAUNCHES,
            "ring_ag_slot": _PROBE_LOCAL_RING_LAUNCHES}
    _check(launches == want, f"overhead probe: launches {launches}, "
           f"expected {want}")
    _check(len(res["elementwise"]) == len(probe.GRANULARITIES)
           and all(r["transport"] == "LocalRing" for r in res["kernels"])
           and len(res["kernels"]) == 2 * len(probe.SHARDS),
           f"overhead probe: rows {res}")
    return res, launches


def probe_rank_worker(rank: int, out: Path) -> None:
    """One of the two ranks of the probe's kernel section (a process of
    its own on card ``rank % device_count``): the entry point started
    through the launcher variables, the IPC `Ring` over a gloo group that
    meets at a FileStore in ``out``; its rows and launches (counted from
    0) into ``out/rank<r>.json``."""
    _join_two_ranks(rank, out)
    _zero_probe_counts()
    res = probe.main(["--section", "kernels"])
    (out / f"rank{rank}.json").write_text(json.dumps({
        "rows": res["kernels"], "launches": _probe_counts()}))


def probe_two_ranks(local_rows: list) -> tuple:
    """The probe's kernel section again as two processes sharing the card
    (`probe_rank_worker`): each rank's launches checked; prints each
    kernel's time per call on the IPC ring beside the `LocalRing`'s
    (``local_rows``) and their difference, the cost of pairing a ring call
    across two contexts. Returns the launches over both ranks."""
    ranks = spawn_two_ranks(
        "probe", lambda r, out: ["--probe-rank", str(r), "--out", str(out)],
        300.0)
    want = {"overhead_probe": 0, "ring_ag": _PROBE_RING_LAUNCHES,
            "ring_rs": _PROBE_RING_LAUNCHES,
            "ring_ag_slot": _PROBE_RING_LAUNCHES}
    local = {(r["kernel"], r["shard"]): r for r in local_rows}
    for r, rank in enumerate(ranks):
        _check(rank["launches"] == want, f"probe rank {r}: launches "
               f"{rank['launches']}, expected {want}")
        _check(sorted((x["kernel"], x["shard"]) for x in rank["rows"])
               == sorted(local) and all(
                   x["transport"] == "Ring" and x["world"] == 2
                   and x["device"].startswith("cuda") for x in rank["rows"]),
               f"probe rank {r}: rows {rank['rows']}")
    for key, lr in local.items():
        ipc = [next(x for x in rank["rows"]
                    if (x["kernel"], x["shard"]) == key) for rank in ranks]
        mean = sum(x["ms"] for x in ipc) / len(ipc)
        print(f"probe {key[0]} shard={key[1]}: LocalRing {lr['ms']:.5f} "
              f"ms/call ({lr['us_per_hop']:.2f} us/hop; device "
              f"{lr['device_ms']:.5f} ms); IPC Ring, two "
              f"processes sharing the card: {ipc[0]['ms']:.5f} (rank 0), "
              f"{ipc[1]['ms']:.5f} (rank 1) ms/call; pairing across two "
              f"contexts: {mean - lr['ms']:.5f} ms per call")
    return {k: sum(rank["launches"][k] for rank in ranks) for k in want}


def time_overhead_probe(hbm) -> dict:
    """K9 at the probe's granularities, inputs cycled over two sets (128
    MiB, past the 50 MB L2), beside its plain version, one PyTorch call
    computing the same function (``torch.add(one, x, alpha=2.0)``, a
    yardstick the port never calls) and the bytes bound: each call reads x
    and writes o once, 8 bytes per element. Returns the rows by
    (nblocks, rows_per_block)."""
    gen = torch.Generator(device=_DEV).manual_seed(16)
    one = torch.ones((), device=_DEV)
    rows = {}
    for nblocks, rpb in probe.GRANULARITIES:
        sets = [(torch.randn(nblocks * rpb, OP.WIDTH, generator=gen,
                             device=_DEV),
                 torch.empty(nblocks * rpb, OP.WIDTH, device=_DEV))
                for _ in range(2)]
        nbytes = 2 * sets[0][0].numel() * 4
        row = {"shape": f"grid {nblocks} x ({rpb}, 512) fp32",
               "ms": device_ms(lambda x, o: OP.affine_probe(x, rpb, out=o),
                               sets, 20),
               "plain_ms": device_ms(lambda x, o: OP.affine_probe_plain(x),
                                     sets, 20),
               "library_ms": device_ms(
                   lambda x, o: torch.add(one, x, alpha=2.0, out=o), sets,
                   20),
               "library_note": "torch.add(one, x, alpha=2.0): one PyTorch "
                               "call",
               "bound_ms": nbytes / hbm * 1e3, "bound_by": "bytes",
               "bytes": nbytes}
        print("kernel time " + json.dumps({"kernel": "overhead_probe"}
                                          | row))
        rows[nblocks, rpb] = row
    return rows


# ---------------------------------------------------------------------------
# phase 5d: train ResNet-50 through the ImageNet CLI
# ---------------------------------------------------------------------------

#: the JAX bench's ResNet configuration (bench.py `bench_resnet`): bf16
#: compute, fp32 masters, batch 64, 224², mode dear, 25 MB buckets, SGD lr
#: 0.01 momentum 0.9 (the CLI's defaults), gradients in bf16, gathers in
#: fp32 at world 1
_RESNET_ARGS = ["--model", "resnet50", "--batch-size", "64", "--fp16",
                "--mode", "dear", "--threshold", "25",
                "--num-warmup-batches", "5", "--num-batches-per-iter", "5",
                "--num-iters", "3"]
_RESNET_B, _RESNET_WARMUP, _RESNET_STEPS = 64, 5, 20
#: card against CPU, fp32 with TF32 off: the largest difference over the
#: largest |value|, of the logits and of each BN buffer. The two sum in
#: other orders, cuDNN with algorithms of its choice (cudnn.benchmark),
#: through 53 normalising layers; the CPU's own fp32 forward of this
#: network lies ~1.2e-5 of the largest logit from an fp64 one
_RESNET_CPU_RTOL = 1e-3


def train_resnet50(card: str):
    """20 steps of ``benchmarks/imagenet.py`` at full width (the main CNN
    path): every step launches the K5 epilogue and runs one shard update
    and reduce-scatter per bucket; the losses are finite and fall; every
    BN buffer is finite and moved from its init (``num_batches_tracked``
    = 20). Returns (result, the epilogue's launches, step ms of the timed
    steps)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    FS.fused_update_launches = 0        # the main path starts here
    marks, prev = [], {}

    def on_step(ts, state, metrics):
        del state, metrics
        now = {"fused_update": FS.fused_update_launches,
               "update": ts.update_launches, "rs": ts.rs_launches}
        got = {k: v - prev.get(k, 0) for k, v in now.items()}
        nb = ts.plan.num_buckets
        _check(got == dict.fromkeys(now, nb), f"resnet step "
               f"{len(marks) + 1}: launches {got}, expected {nb} each")
        prev.update(now)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    res = imagenet_cli.main(_RESNET_ARGS + ["--device", _DEV],
                            on_step=on_step)
    launches = FS.fused_update_launches           # ... and ends here
    torch.cuda.synchronize()
    peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    ts, losses = res.train_step, res.losses
    print(f"resnet50 losses: {[round(x, 4) for x in losses]}")
    _check(len(losses) == _RESNET_STEPS and all(np.isfinite(losses)),
           f"resnet50: losses {losses}")
    _check(losses[-1] < losses[0], "resnet50: the loss did not fall")
    moved = 0
    for n, b in ts.model.named_buffers():
        if n.endswith("num_batches_tracked"):
            _check(int(b) == _RESNET_STEPS, f"resnet50 {n} = {int(b)}")
            continue
        init = 1.0 if n.endswith("running_var") else 0.0
        _check(bool(torch.isfinite(b).all()), f"resnet50: {n} not finite")
        _check(bool((b != init).any()), f"resnet50: {n} unmoved")
        moved += 1
    step_ms = [a.elapsed_time(b) for a, b in
               zip(marks[_RESNET_WARMUP - 1:-1], marks[_RESNET_WARMUP:])]
    print(f"main path (resnet50 train, {card}): {_RESNET_STEPS} steps, "
          f"{ts.plan.num_buckets} buckets (shards "
          f"{[b.shard_size for b in ts.plan.buckets]}), K5 epilogue "
          f"launches {launches} ({ts.plan.num_buckets} per step), "
          f"{moved} BN buffers finite and moved; peak memory "
          f"{peak_mib:.1f} MiB over the {base / 2**20:.1f} MiB allocated "
          "before (torch.cuda.max_memory_allocated)")
    return res, launches, step_ms


def check_resnet_card_vs_cpu(res) -> float:
    """ResNet-50 in fp32 (TF32 off) in training mode, B = 2 at 224², from
    the 20-step run's master parameters and BN buffers, on the card
    (cuDNN, channels_last) and on the CPU: the logits and the updated BN
    buffers within `_RESNET_CPU_RTOL` of the largest |value|. Returns the
    worst such ratio."""
    params = res.train_step.gather_params(res.state)
    sd = {**params, **{n: b.detach().clone()
                       for n, b in res.train_step.model.named_buffers()}}
    image = synthetic_image_batch(9, 2, device=_DEV)["image"]
    outs = {}
    for dev in (_DEV, "cpu"):
        model = get_model("resnet50", device=dev)
        model.load_state_dict({k: v.to(dev) for k, v in sd.items()})
        with torch.no_grad():
            logits = model(image.to(dev))
        outs[dev] = {"logits": logits.cpu()} | {
            n: b.cpu() for n, b in model.named_buffers()
            if b.is_floating_point()}
    worst = {k: float((outs[_DEV][k] - want).abs().max())
             / max(float(want.abs().max()), 1e-30)
             for k, want in outs["cpu"].items()}
    top = max((k for k in worst if k != "logits"), key=worst.get)
    print(f"resnet50 fp32 card vs CPU (train mode, B=2, 224², TF32 off): "
          f"logits {worst['logits']:.3e}, worst BN buffer {top} "
          f"{worst[top]:.3e} of the largest |value| (tolerance "
          f"{_RESNET_CPU_RTOL})")
    _check(max(worst.values()) <= _RESNET_CPU_RTOL,
           "resnet50: card and CPU disagree")
    return max(worst.values())


# ---------------------------------------------------------------------------
# phase 5e: BERT-Base through the BERT CLI
# ---------------------------------------------------------------------------

#: BERT-Base, bf16, batch 32, 25 MB buckets, 20 steps (5 warmup, 3 x 5
#: timed); the flash run at S = 128 without dropout, SGD lr 0.01 momentum
#: 0.9 (the bench's lr 2e-5 moves the loss too little to see it fall); the
#: bench's configuration at S = 64 with dropout and the CLI's optimizer
_BERT_ARGS = ["--model", "bert_base", "--fp16", "--batch-size",
              str(_BERT_B), "--threshold", "25"]
_BERT_FLASH_ARGS = _BERT_ARGS + ["--sentence-len", "128", "--dropout0",
                                 "--base-lr", "0.01", "--momentum", "0.9"]
_BERT_STEPS = ["--num-warmup-batches", "5", "--num-batches-per-iter", "5",
               "--num-iters", "3"]
#: step 1's loss, flash against dense on one seed's weights and batch: the
#: largest difference over |loss|. Both round every product to bf16, K1 its
#: probabilities on the tensor cores, the dense core its scores and
#: probabilities; a CPU rehearsal of 4 layers at B = 8 gave 5e-7
_BERT_FLASH_VS_DENSE_RTOL = 1e-3


def _flash_counts() -> dict:
    """K1's, K2's and K3's launches so far."""
    return {"fwd": FA.flash_fwd_launches, "dq": FA.flash_bwd_dq_launches,
            "dkv": FA.flash_bwd_dkv_launches}


def train_bert():
    """BERT-Base through ``benchmarks/bert.py`` on the card. The flash run
    (``--flash-attention --dropout0 --mfu``, S = 128, 20 steps): every
    step launches K1, K2 and K3 12 times each, all on their tensor-core
    routes, and the K5 epilogue, a reduce-scatter and an all-gather once
    per bucket; the losses are finite and fall; its counted FLOPs are the
    dense model's plus what K2 and K3's plain versions recompute
    (`ops.flash_attention.plain_flops`). Then one dense step on the same
    weights and batch: step 1's loss within `_BERT_FLASH_VS_DENSE_RTOL`
    and no attention kernel. Then the bench's configuration (S = 64,
    dropout 0.1, 3 steps) and the flash impl in a dropout model: no
    attention kernel launched. Returns (flash result, its launches, its
    step times in ms, the dropout run's result)."""
    FA.reset_launch_counts()            # the main path
    FS.fused_update_launches = 0        # starts here
    marks, prev = [], {}

    def on_step(ts, state, metrics):
        del state, metrics
        now = _train_counts(ts)
        nb, layers = ts.plan.num_buckets, ts.model.config.num_hidden_layers
        before = prev or {k: 0 for k in now} | {"ag": nb}   # init's gathers
        want = {k: layers for k in now if k.startswith("flash")} | {
            "fused_update": nb, "rs": nb, "ag": nb, "update": nb}
        got = {k: now[k] - before[k] for k in now}
        _check(got == want, f"bert step {len(marks) + 1}: launches {got}, "
               f"expected {want}")
        prev.update(now)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    res = bert_cli.main(_BERT_FLASH_ARGS + _BERT_STEPS
                        + ["--flash-attention", "--mfu", "--device", _DEV],
                        on_step=on_step)
    launches = _train_counts(res.train_step)      # ... and ends here
    losses = res.losses
    S = res.batch["input_ids"].shape[1]
    print(f"bert-base flash losses (S={S}, B={_BERT_B}): "
          f"{[round(x, 4) for x in losses]}")
    _check(len(losses) == 20 and all(np.isfinite(losses)),
           f"bert flash: losses {losses}")
    _check(losses[-1] < losses[0], "bert flash: the loss did not fall")
    cfg = res.train_step.model.config
    want_flops = (port_bench.bert_step_flops(cfg, _BERT_B, S)
                  + 6 * cfg.hidden_size * cfg.num_hidden_layers * _BERT_B
                  * S * S)
    print(f"bert-base flash step: {res.flops_per_step / 1e12:.6f} TFLOP "
          f"counted, {want_flops / 1e12:.6f} reckoned (the dense model's "
          f"{port_bench.bert_step_flops(cfg, _BERT_B, S) / 1e12:.6f} plus "
          "K2 and K3's recomputed S and dP)")
    _check(abs(res.flops_per_step - want_flops) <= 1e-6 * want_flops,
           "bert flash: the counted FLOPs are not the reckoned ones")
    step_ms = [a.elapsed_time(b) for a, b in zip(marks[4:-1], marks[5:])]
    print(f"main path (bert-base flash): 20 steps, "
          f"{res.train_step.plan.num_buckets} buckets, launches {launches}")
    res.train_step.close()

    before = _flash_counts()
    dense = bert_cli.main(_BERT_FLASH_ARGS + [
        "--num-warmup-batches", "0", "--num-batches-per-iter", "1",
        "--num-iters", "1", "--device", _DEV])
    _check(_flash_counts() == before, "bert dense: an attention kernel ran")
    rel = abs(losses[0] - dense.losses[0]) / abs(dense.losses[0])
    print(f"bert-base step 1 loss: flash {losses[0]:.6f}, dense "
          f"{dense.losses[0]:.6f} (rel {rel:.3e}, tolerance "
          f"{_BERT_FLASH_VS_DENSE_RTOL})")
    _check(rel <= _BERT_FLASH_VS_DENSE_RTOL, "bert: flash and dense differ")
    dense.train_step.close()

    FS.fused_update_launches = 0
    drop = bert_cli.main(_BERT_ARGS + [
        "--sentence-len", "64", "--num-warmup-batches", "0",
        "--num-batches-per-iter", "3", "--num-iters", "1", "--device", _DEV])
    nb = drop.train_step.plan.num_buckets
    print(f"bert-base with dropout (the bench's configuration, S=64): "
          f"losses {[round(x, 4) for x in drop.losses]}")
    _check(_flash_counts() == before and FS.fused_update_launches == 3 * nb
           and all(np.isfinite(drop.losses)),
           f"bert with dropout: attention kernels {_flash_counts()} (want "
           f"{before}), K5 epilogue {FS.fused_update_launches} (want "
           f"{3 * nb}), losses {drop.losses}")
    drop_launches = FS.fused_update_launches
    cfg2 = dataclasses.replace(BERT.BERT_BASE, num_hidden_layers=2,
                               dtype=torch.bfloat16)
    model = BERT.BertForPreTraining(
        cfg2, attention_impl=FA.make_flash_attention_impl(), device=_DEV)
    b = synthetic_bert_batch(3, 4, seq_len=64, device=_DEV)
    logits, _ = model(b["input_ids"], b["token_type_ids"],
                      b["attention_mask"], train=True,
                      generator=torch.Generator(device=_DEV).manual_seed(0))
    _check(_flash_counts() == before and bool(torch.isfinite(logits).all()),
           "the flash impl under dropout launched an attention kernel")
    print("the flash impl under attention dropout: the dense core, no "
          "attention kernel (2 layers, train mode)")
    return res, launches | {"fused_update": launches["fused_update"]
                            + drop_launches}, step_ms, drop


# ---------------------------------------------------------------------------
# phase 5f: ViT-B/16 through the ImageNet CLI
# ---------------------------------------------------------------------------

_VIT_MODEL, _VIT_B = "vit_b16", 64
_VIT_ARGS = ["--model", _VIT_MODEL, "--batch-size", str(_VIT_B), "--fp16",
             "--mode", "dear", "--threshold", "25", "--mfu"] + _BERT_STEPS
#: card against CPU in fp32 (TF32 off): the largest logit difference over
#: the largest |logit| (as `_RESNET_CPU_RTOL`)
_VIT_CPU_RTOL = 1e-3


def train_vit():
    """20 steps of ``benchmarks/imagenet.py --model vit_b16`` (bf16, B = 64,
    224²): every step launches the K5 epilogue and runs a shard update and
    reduce-scatter once per bucket; the losses are finite and fall; the
    counted FLOPs equal `bench.vit_step_flops`. Then ViT-B/16 in fp32 from
    the run's weights on the card against the CPU (B = 2): logits within
    `_VIT_CPU_RTOL`. Returns (result, the epilogue's launches, step ms)."""
    FS.fused_update_launches = 0        # the main path starts here
    marks, prev = [], {}

    def on_step(ts, state, metrics):
        del state, metrics
        now = {"fused_update": FS.fused_update_launches,
               "update": ts.update_launches, "rs": ts.rs_launches}
        got = {k: v - prev.get(k, 0) for k, v in now.items()}
        nb = ts.plan.num_buckets
        _check(got == dict.fromkeys(now, nb), f"vit step {len(marks) + 1}: "
               f"launches {got}, expected {nb} each")
        prev.update(now)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    before = _flash_counts()
    res = imagenet_cli.main(_VIT_ARGS + ["--device", _DEV], on_step=on_step)
    launches = FS.fused_update_launches           # ... and ends here
    losses = res.losses
    print(f"{_VIT_MODEL} losses: {[round(x, 4) for x in losses]}")
    _check(len(losses) == 20 and all(np.isfinite(losses)),
           f"vit_b16: losses {losses}")
    _check(losses[-1] < losses[0], "vit_b16: the loss did not fall")
    _check(_flash_counts() == before, "vit_b16: an attention kernel ran")
    want = port_bench.vit_step_flops(
        _VIT_B, **{"vit_b16": port_bench.VIT_B16,
                   "vit_s16": port_bench.VIT_S16}[_VIT_MODEL])
    _check(abs(res.flops_per_step - want) <= 1e-6 * want,
           f"vit_b16: counted {res.flops_per_step} FLOPs, reckoned {want}")
    ts = res.train_step
    print(f"main path ({_VIT_MODEL} train): 20 steps, {ts.plan.num_buckets} "
          f"buckets (shards {[b.shard_size for b in ts.plan.buckets]}), K5 "
          f"epilogue launches {launches}; {res.flops_per_step / 1e12:.6f} "
          "TFLOP per step counted = reckoned")
    step_ms = [a.elapsed_time(b) for a, b in zip(marks[4:-1], marks[5:])]

    params = ts.gather_params(res.state)
    image = synthetic_image_batch(9, 2, device=_DEV)["image"]
    outs = {}
    for dev in (_DEV, "cpu"):
        model = get_model(_VIT_MODEL, device=dev)
        model.load_state_dict({k: v.to(dev) for k, v in params.items()})
        with torch.no_grad():
            outs[dev] = model(image.to(dev)).cpu()
    err = float((outs[_DEV] - outs["cpu"]).abs().max()
                / outs["cpu"].abs().max())
    print(f"{_VIT_MODEL} fp32 card vs CPU (B=2, 224², TF32 off): logits "
          f"{err:.3e} of the largest |value| (tolerance {_VIT_CPU_RTOL})")
    _check(err <= _VIT_CPU_RTOL, "vit_b16: card and CPU disagree")
    return res, launches, step_ms


# ---------------------------------------------------------------------------
# phase 5g: the bench entry
# ---------------------------------------------------------------------------

#: the bench's counted FLOPs against the analytic count
_BENCH_FLOPS_RTOL = 0.02
#: the bench phase's timed iterations of 10 steps per model (the bench's
#: default is 10), cut for the script's time limit: each metric stays a
#: mean over 20 timed steps
_BENCH_ITERS = 2


def run_bench(card: str, timeout: float = 600.0,
              telemetry=None, iters=None) -> dict:
    """``python -m dear_pytorch_tpu_torch.bench`` as a user runs it (a
    process of its own, the card, no ``DEAR_BENCH_*`` switch but
    ``iters``): it exits 0,
    its last line parses, all five metrics are there with bench.py's names
    and units and a numeric value, MFU and peak memory, no error entry,
    and each counted step within `_BENCH_FLOPS_RTOL` of its analytic
    count. ``iters``: the timed iterations of 10 steps per model
    (``DEAR_BENCH_ITERS``; default the bench's 10). Re-prints the line,
    then a line per model. Returns the line."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DEAR_BENCH_") and k != "DEAR_TELEMETRY"}
    if telemetry is not None:             # else the bench's default
        env["DEAR_TELEMETRY"] = telemetry
    if iters is not None:
        env["DEAR_BENCH_ITERS"] = str(iters)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "dear_pytorch_tpu_torch.bench"],
                         cwd=_ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    for line in out.stderr.strip().splitlines()[-12:]:
        print(f"  bench stderr: {line[:200]}")
    _check(out.returncode == 0, f"bench exited {out.returncode}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"bench line ({wall:.1f} s, {card}, DEAR_TELEMETRY "
          f"{telemetry or 'unset'}): {json.dumps(line)}")
    entries = [line] + line.get("extra_metrics", [])
    got = [(m.get("metric"), m.get("unit")) for m in entries]
    _check(got == list(port_bench.METRICS),
           f"bench: metrics {got}, expected {port_bench.METRICS}")
    want = port_bench.analytic_step_flops()
    for m in entries:
        _check("error" not in m and all(
            isinstance(m.get(k), (int, float)) and m[k] > 0
            for k in ("value", "mfu", "peak_hbm_gb")),
            f"bench: {m.get('metric')} has no numeric value, MFU and peak "
            f"memory: {m}")
        ratio = m["flops_per_step"] / want[m["metric"]]
        print(f"bench {m['metric']}: {m['value']} {m['unit']}, step "
              f"{m['step_ms']:.3f} ms, MFU {m['mfu']:.2%}, peak "
              f"{m['peak_hbm_gb']} GiB; {m['flops_per_step'] / 1e12:.6f} "
              f"TFLOP per step counted, {want[m['metric']] / 1e12:.6f} "
              f"analytic (ratio {ratio:.6f})")
        _check(abs(ratio - 1) <= _BENCH_FLOPS_RTOL,
               f"bench: {m['metric']} counted FLOPs off the analytic count")
    return line


def resnet_flops_per_image(name="resnet50", size=224) -> float:
    """The forward's 2·kh·kw·C_in·C_out·H_out·W_out over the convs (the
    output sizes from one CPU forward) plus 2·in·out per dense layer
    (`bench.conv_fc_flops`)."""
    return port_bench.conv_fc_flops(get_model(name, device="cpu"), size)[0]


def train_flops_per_step(cfg, B, S) -> float:
    """6 x (matmul parameters) x tokens, plus causal attention: QK^T and
    PV over the S(S+1)/2 causal pairs, forward and backward (x3)."""
    h, L, V = cfg.hidden_size, cfg.num_hidden_layers, cfg.padded_vocab_size
    n_matmul = L * (4 * h * h + 2 * h * cfg.intermediate_size) + V * h
    attn = 3 * 4 * h * L * B * S * (S + 1) // 2
    return 6 * n_matmul * B * S + attn


def trace_train_steps(ts, state, batch, step_p50_ms, n=2,
                      label="bf16, B=16, S=1024"):
    """``torch.profiler`` over ``n`` training steps: device ops per step,
    device busy time, idle share (of the profiled wall, an upper bound, and
    of the unprofiled step p50), the top device ops by time, and the spans
    of the ring kernels (K4, K5 ring), waits included."""
    from torch.profiler import ProfilerActivity, profile

    state, _ = ts.step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = ts.step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    if not kernels or busy <= 0:
        print("train step trace: no device time in the profile "
              "(not measured)")
        return None
    by_name: dict = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    ring = sum(ms for name, (ms, _) in by_name.items()
               if "::ring_" in name) / n
    cm = sum(ms for name, (ms, _) in by_name.items()
             if "::cm_" in name) / n
    print(f"train step trace ({label}, {n} steps): "
          f"{len(kernels) / n:.1f} device ops/step, device busy "
          f"{busy:.3f} ms/step, wall {wall / n * 1e3:.3f} ms/step under the "
          f"profiler (idle {1 - busy / (wall / n * 1e3):.1%}), idle "
          f"{1 - busy / step_p50_ms:.1%} of the unprofiled step p50 "
          f"{step_p50_ms:.3f} ms; ring kernels resident {ring:.3f} ms/step, "
          f"ring matmul kernels {cm:.3f} ms/step (their spans, waits "
          "included)")
    for name, (ms, count) in top:
        print(f"  top op {ms / n:9.3f} ms/step {count // n:5d}x/step "
              f"{name[:110]}")
    return {"ops_per_step": len(kernels) / n, "busy_ms": busy,
            "wall_ms": wall / n * 1e3, "ring_ms": ring, "cm_ms": cm,
            "top": [(name, ms / n) for name, (ms, _) in top]}


# ---------------------------------------------------------------------------
# phase 5h: the rest of the zoo through the ImageNet CLI
# ---------------------------------------------------------------------------

#: (model, batch, image side): the reference sweep's DenseNet-201 at 32 and
#: Inception-v4 at 64 on 299² (dear_pytorch_tpu/benchmarks/driver.py
#: DEFAULT_TASKS), VGG-16 at the ResNet bench's 64 with its dropout; bf16,
#: mode dear, 25 MB buckets, SGD lr 0.01 momentum 0.9 (the CLI's
#: defaults), 20 steps (5 warmup, 3 x 5 timed)
_ZOO = (("densenet201", 32, 224), ("inceptionv4", 64, 299),
        ("vgg16", 64, 224))
#: card against CPU in fp32 (TF32 off), as `_RESNET_CPU_RTOL`
_ZOO_CPU_RTOL = 1e-3
#: the loss falls: the dropout-free loss on the run's batch, from the
#: weights of every `_ZOO_EVERY`-th step, reaches at most this fraction of
#: the one at init (deterministic: unmoved weights give the init's loss).
#: Not the last step's alone: VGG-16 (no BN, lr 0.01) falls ~20% by step
#: 15, spikes at step 16 and ends ~0.7% under its init loss, as plain
#: `torch.optim.SGD` does on the same batch and dropout masks
#: (dear_pytorch_tpu_torch/scripts/plain_sgd_reference.py)
_ZOO_LOSS_FALL, _ZOO_EVERY = 0.9, 5


def _clean_loss(model, batch) -> float:
    """``model``'s loss on ``batch`` with no dropout (VGG's ``train=False``)
    and BN on the batch's statistics, as in the training steps."""
    with torch.no_grad():
        return float(softmax_xent(model.train()(batch["image"]),
                                  batch["label"]))


def train_zoo(name: str, B: int, size: int, card: str) -> dict:
    """20 steps of ``benchmarks/imagenet.py --model name`` at full width
    (bf16, ``--mfu``): every step launches the K5 epilogue and runs a
    shard update and reduce-scatter once per bucket; the losses are
    finite; every parameter moved and the loss without dropout on the
    run's batch fell to `_ZOO_LOSS_FALL` of its init value (the weights
    of every `_ZOO_EVERY`-th step, its master shards copied on the card
    outside the timed spans) and ends below it; the BN buffers (DenseNet, Inception) are
    finite and moved; the counted FLOPs within `_BENCH_FLOPS_RTOL` of 3 x
    the forward's conv and dense products less the stem's input gradient
    (`bench.conv_fc_flops`, the bench's ResNet count). Prints step
    p50/p99, img/s, MFU and peak memory beside ``card``, traces 2 steps
    (the idle share), then holds the model in fp32 on the card against the
    CPU from the run's weights (B = 2; train and eval mode with BatchNorm,
    eval for VGG, whose train mode is its generator-drawn dropout). Returns
    the run's K5 epilogue launches and numbers."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    FS.fused_update_launches = 0        # the main path starts here
    marks, starts, prev, snaps, peak = [], [], {}, [], []

    def on_step(ts, state, metrics):
        del metrics
        now = {"fused_update": FS.fused_update_launches,
               "update": ts.update_launches, "rs": ts.rs_launches}
        got = {k: v - prev.get(k, 0) for k, v in now.items()}
        nb = ts.plan.num_buckets
        _check(got == dict.fromkeys(now, nb), f"{name} step "
               f"{len(marks) + 1}: launches {got}, expected {nb} each")
        prev.update(now)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        if len(marks) % _ZOO_EVERY == 0:   # the master shards, copied on
            if not snaps:                  # the card outside the timed
                peak.append(torch.cuda.max_memory_allocated())   # spans
            snaps.append(state._replace(
                shards=tuple(t.clone() for t in state.shards)))
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        starts.append(ev)

    res = imagenet_cli.main(
        ["--model", name, "--batch-size", str(B), "--fp16", "--mode",
         "dear", "--threshold", "25", "--mfu"] + _BERT_STEPS
        + ["--device", _DEV], on_step=on_step)
    launches = FS.fused_update_launches           # ... and ends here
    torch.cuda.synchronize()
    # every step allocates alike: the peak of the steps before the first
    # snapshot
    peak_gib = (peak[0] - base) / 2**30
    ts, losses = res.train_step, res.losses
    snaps = [{k: v.cpu() for k, v in ts.gather_params(snap).items()}
             for snap in snaps]
    warm = int(_BERT_STEPS[1])
    steps = warm + int(_BERT_STEPS[3]) * int(_BERT_STEPS[5])
    print(f"{name} losses (B={B}, {size}²): "
          f"{[round(x, 4) for x in losses]}")
    _check(len(losses) == steps and all(np.isfinite(losses)),
           f"{name}: losses {losses}")
    _check(tuple(res.batch["image"].shape) == (B, 3, size, size),
           f"{name}: batch {tuple(res.batch['image'].shape)}")
    moved = 0
    for n, b in ts.model.named_buffers():
        if n.endswith("num_batches_tracked"):
            _check(int(b) == steps, f"{name} {n} = {int(b)}")
            continue
        init = 1.0 if n.endswith("running_var") else 0.0
        _check(bool(torch.isfinite(b).all()), f"{name}: {n} not finite")
        _check(bool((b != init).any()), f"{name}: {n} unmoved")
        moved += 1
    # one CPU build serves the count and the reference below (VGG-16's
    # init alone takes ~12 s on the host's cores)
    cpu_model = get_model(name, device="cpu")
    fwd, stem = port_bench.conv_fc_flops(cpu_model, size)
    want = B * (3 * fwd - stem)
    ratio = res.flops_per_step / want
    step_ms = [a.elapsed_time(b)
               for a, b in zip(starts[warm - 1:-1], marks[warm:])]
    p50, p99 = (float(np.percentile(step_ms, q)) for q in (50, 99))
    peak = _PEAK_FLOPS[torch.bfloat16]
    mfu = res.flops_per_step / res.iter_time_mean / peak
    nb = ts.plan.num_buckets
    print(f"main path ({name} train, {card}): {steps} steps, {nb} buckets "
          f"(shards {[b.shard_size for b in ts.plan.buckets]}), K5 epilogue "
          f"launches {launches} ({nb} per step), {moved} BN buffers finite "
          f"and moved; peak memory {peak_gib:.2f} GiB over the "
          f"{base / 2**30:.2f} GiB allocated before")
    print(f"{name} train step (bf16, B={B}, {size}², mode dear, {nb} "
          f"buckets, {len(step_ms)} timed steps) on {card}: p50 {p50:.3f} "
          f"ms p99 {p99:.3f} ms; {res.total_mean:.1f} img/s (the CLI's "
          f"timed mean); {res.flops_per_step / 1e12:.6f} TFLOP per step "
          f"counted, {want / 1e12:.6f} analytic (ratio {ratio:.6f}; 3 x the "
          f"forward's {fwd / 1e9:.4f} GFLOP per image of conv and dense "
          f"products, less the stem's input gradient) -> MFU {mfu:.2%} of "
          f"{peak / 1e12:.0f} TF/s bf16")
    _check(abs(ratio - 1) <= _BENCH_FLOPS_RTOL,
           f"{name}: counted FLOPs off the analytic count")
    trace = trace_train_steps(ts, res.state, res.batch, p50,
                              label=f"{name} bf16, B={B}, {size}²")

    shards = [b.shard_size for b in ts.plan.buckets]
    upd_err = check_update_main_path(ts)     # VGG-16: fc1's 102.76M shard
    params = ts.gather_params(res.state)
    sd = {**params, **{n: b.detach().clone()
                       for n, b in ts.model.named_buffers()}}
    batch = res.batch
    ts.close()
    del res, ts
    gc.collect()
    torch.cuda.empty_cache()
    # the loss falls, judged without VGG's dropout noise: the CLI's model
    # at init (seed 0), then with the weights of every `_ZOO_EVERY`-th
    # step, on the run's batch; and every parameter moved
    model = get_model(name, dtype=torch.bfloat16, device=_DEV, seed=0)
    init = {n: p.detach().cpu() for n, p in model.named_parameters()}
    _check(len(snaps) == steps // _ZOO_EVERY
           and all(set(snap) == set(init) for snap in snaps),
           f"{name}: {len(snaps)} snapshots, or not of every parameter")
    still = [n for n, p in snaps[-1].items() if torch.equal(p, init[n])]
    _check(not still, f"{name}: parameters unmoved by the run: {still}")
    clean = [_clean_loss(model, batch)]
    for snap in snaps:
        model.load_state_dict(snap, strict=False)    # BN: batch statistics
        clean.append(_clean_loss(model, batch))
    print(f"{name} loss without dropout on the run's batch at steps "
          f"{list(range(0, steps + 1, _ZOO_EVERY))}: "
          f"{[round(x, 4) for x in clean]} (limit {_ZOO_LOSS_FALL} x the "
          f"first, the last below it); every one of {len(init)} "
          "parameters moved")
    _check(min(clean[1:]) <= _ZOO_LOSS_FALL * clean[0]
           and clean[-1] < clean[0], f"{name}: the loss did not fall "
           f"({clean})")
    del model, init, snaps
    image = synthetic_image_batch(9, 2, image_size=size, device=_DEV)["image"]
    bn = any(n.endswith("running_var") for n in sd)
    worst = {}
    for train in ((True, False) if bn else (False,)):
        outs = {}
        for dev in (_DEV, "cpu"):
            model = (get_model(name, device=dev) if dev != "cpu"
                     else cpu_model).train(train)
            model.load_state_dict({k: v.to(dev) for k, v in sd.items()})
            with torch.no_grad():
                logits = model(image.to(dev))
            outs[dev] = {"logits": logits.cpu()} | {
                n: b.cpu() for n, b in model.named_buffers()
                if b.is_floating_point() and train}
        mode = "train" if train else "eval"
        for k, want_t in outs["cpu"].items():
            worst[f"{mode} {k}"] = (float((outs[_DEV][k] - want_t).abs().max())
                                    / max(float(want_t.abs().max()), 1e-30))
    top = max(worst, key=worst.get)
    print(f"{name} fp32 card vs CPU (B=2, {size}², TF32 off, "
          f"{'train and eval' if bn else 'eval'} mode): logits "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()
                      if k.endswith("logits"))
          + f"; worst {top} {worst[top]:.3e} of the largest |value| "
          f"(tolerance {_ZOO_CPU_RTOL})")
    _check(max(worst.values()) <= _ZOO_CPU_RTOL,
           f"{name}: card and CPU disagree")
    return {"launches": launches, "buckets": nb, "shards": shards,
            "p50": p50, "p99": p99, "mfu": mfu, "trace": trace,
            "upd_err": upd_err}


# ---------------------------------------------------------------------------
# phase 5i: the MNIST example
# ---------------------------------------------------------------------------


def train_mnist() -> int:
    """The port's MNIST example as a user runs it (``examples/mnist.py``)
    on the card, ``--data synthetic`` (the card has no scikit-learn), 2
    epochs of the JAX test's settings: every step launches the K5 epilogue
    once per bucket; the held-out accuracy above 0.9, the JAX test's bar.
    Returns the epilogue's launches."""
    from dear_pytorch_tpu_torch.examples import mnist as mnist_example

    FS.fused_update_launches = 0        # the main path starts here
    t0 = time.perf_counter()
    acc = mnist_example.main(["--data", "synthetic", "--epochs", "2",
                              "--batch-size", "64", "--train-size", "2048",
                              "--test-size", "512", "--lr", "0.05",
                              "--device", _DEV])
    launches = FS.fused_update_launches           # ... and ends here
    steps = 2 * (2048 // 64)
    print(f"mnist example (synthetic, 2 epochs, {steps} steps of 64): test "
          f"accuracy {acc:.4f}; K5 epilogue launches {launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    _check(launches == steps, f"mnist: {launches} K5 epilogue launches for "
           f"{steps} steps of one bucket")
    _check(acc > 0.9, f"mnist: test accuracy {acc}")
    return launches


# ---------------------------------------------------------------------------
# phase 5j: serve BERT-Base through DecodeEngine
# ---------------------------------------------------------------------------

#: a top-2 logit gap under which the engine may pick another token than
#: the causal full forward: fp32 as GPT-2's check (1e-3); bf16 4 ulps of
#: the top logit in bf16 (2^(e - 7) each for a logit in [2^e, 2^(e+1))):
#: both paths round every op to bf16, at other points (the cache, the
#: split-K softmax against the dense core), and land a few ulps apart
_BERT_TIE_FP32, _BERT_TIE_BF16_ULPS = 1e-3, 4


def _bert_tie(dt, top: float) -> float:
    if dt == torch.float32:
        return _BERT_TIE_FP32
    return _BERT_TIE_BF16_ULPS * 2.0 ** (np.floor(np.log2(abs(top))) - 7)


def _bert_requests():
    rs = np.random.RandomState(1)
    lens = (5, 17, 33, 64, 97, 128, 11, 50)
    return [(list(rs.randint(0, BERT.BERT_BASE.vocab_size, n)),
             int(rs.randint(8, 17))) for n in lens]


def _causal_gaps(model, prompt, got):
    """One causal full forward (no cache) over ``prompt + got``: at each
    generated position, the forward's top logit and how far the engine's
    token lies below it (0 where the engine took an argmax)."""
    V = model.config.vocab_size
    seq = list(prompt) + list(got)
    with torch.no_grad():
        logits, _ = model(torch.tensor([seq], device=_DEV), causal=True)
    lg = logits[0, len(prompt) - 1:len(seq) - 1, :V].float()
    top = lg.max(-1).values
    mine = lg.gather(-1, torch.tensor(got, device=_DEV)[:, None])[:, 0]
    return top.tolist(), (top - mine).tolist()


def serve_bert():
    """BERT-Base at full width (random weights from a seed) through
    `DecodeEngine` with ``decode_use_flash=True``, in fp32 and bf16, at
    ``prefill_chunk`` 1 and 8: every request finishes; K1 runs 12 times per
    decode tick, all on its split-K route; then one causal full forward
    over each request's prompt and the engine's tokens: every generated
    token is that forward's argmax at its position, or within `_bert_tie`
    of it (a request whose every token is the argmax is token for token
    the causal forward's greedy continuation). Returns (K1's launches by
    route, the runs)."""
    reqs = _bert_requests()
    models = {}
    for dt in (torch.float32, torch.bfloat16):
        cfg = dataclasses.replace(BERT.BERT_BASE, decode_use_flash=True,
                                  dtype=dt)
        models[dt] = BERT.BertForPreTraining(cfg, device=_DEV, seed=0).eval()
    cfg = models[torch.float32].config
    print(f"BERT-Base serving: {cfg.num_hidden_layers} layers, ring "
          f"{cfg.cache_len}, slots {_SLOTS}, {len(reqs)} requests")
    FA.reset_launch_counts()            # the main path starts here
    runs = []
    for dt in (torch.float32, torch.bfloat16):
        for chunk in (1, 8):
            eng = DecodeEngine(models[dt], slots=_SLOTS, prefill_chunk=chunk,
                               device=_DEV)
            pending, done = list(range(len(reqs))), {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while pending or eng.active:
                while pending and eng.free:
                    i = pending.pop(0)
                    eng.submit(reqs[i][0], reqs[i][1], request_id=i)
                for fin in eng.tick():
                    done[fin.request_id] = fin.tokens
            wall = time.perf_counter() - t0
            runs.append((dt, chunk, done, eng, wall))
    launches = FA.flash_fwd_launches   # ... and ends here
    routes = dict(FA.flash_fwd_route_launches)
    ticks = sum(r[3].decode_steps for r in runs)
    layers = cfg.num_hidden_layers
    print(f"main path (bert-base serving): {ticks} decode ticks, "
          f"{sum(r[3].prefill_steps for r in runs)} prefill ticks, K1 "
          f"launches {launches}, by route {routes}")
    _check(launches > 0 and launches == layers * ticks
           and routes["split_k"] == launches,
           f"bert serving: K1 launched {routes} for {ticks} decode ticks; "
           f"expected {layers} split_k launches per tick")
    for dt, chunk, done, eng, wall in runs:
        _check(sorted(done) == list(range(len(reqs))),
               f"bert {dt} chunk {chunk}: not every request finished")
        new = sum(len(t) for t in done.values())
        g = eng.phase_gauges()
        print(f"serve bert-base {dt} chunk {chunk}: {len(done)} requests, "
              f"{new} new tokens in {wall:.3f} s ({new / wall:.1f} tok/s), "
              f"decode tick p50 {g['serve.decode_tick_ms_p50']} ms p99 "
              f"{g['serve.decode_tick_ms_p99']} ms, decode ticks "
              f"{eng.decode_steps}, prefill ticks {eng.prefill_steps}")
        greedy = ties = 0
        worst = (0.0, 0.0, 0.0)               # (gap / limit, gap, top)
        for i, (prompt, n) in enumerate(reqs):
            got = done[i]
            _check(len(got) == n, f"bert {dt}: request {i} gave {got}")
            tops, gaps = _causal_gaps(models[dt], prompt, got)
            greedy += all(g == 0 for g in gaps)
            for j, (top, gap) in enumerate(zip(tops, gaps)):
                if gap == 0:
                    continue
                ties += 1
                lim = _bert_tie(dt, top)
                worst = max(worst, (gap / lim, gap, top))
                _check(gap < lim, f"bert {dt} chunk {chunk}: request {i} "
                       f"token {j} is {gap:.3e} below the causal forward's "
                       f"top logit {top:.4f}, over the near-tie limit "
                       f"{lim:.3e}")
        print(f"  every one of the {new} tokens is the causal full "
              f"forward's argmax over the engine's own sequence or within "
              f"the near-tie limit: {new - ties} argmax, {ties} near-ties "
              f"(the widest {worst[1]:.3e} below a top logit of "
              f"{worst[2]:.4f}, {worst[0]:.2f} of its limit); {greedy} of "
              f"{len(reqs)} requests token for token the causal greedy "
              "continuation")
    return routes, runs


# ---------------------------------------------------------------------------
# phase 5k: BERT-Large --ring-projections, two ranks on one card
# ---------------------------------------------------------------------------

#: the bench's BERT-Large batch over two ranks (8 per rank, S = 64), bf16,
#: its dropout and optimizer (the CLI's), 25 MB buckets, 6 steps (2
#: warmup, 2 x 2 timed: a paired ring-matmul call costs milliseconds on
#: one shared card, 288 of them per step)
_BERT_LARGE_ARGS = ["--model", "bert", "--fp16", "--batch-size", "8",
                    "--sentence-len", "64", "--threshold", "25",
                    "--mode", "dear-fused", "--num-warmup-batches", "2",
                    "--num-batches-per-iter", "2", "--num-iters", "2"]
_BERT_LARGE_STEPS = 6
_BERT_LARGE_MODES = {"bert-large-fused": [],
                     "bert-large-rp": ["--ring-projections"]}


def bert_rank_worker(rank: int, out: Path, mode: str) -> None:
    """One of the two ranks of phase 5k (``--bert-rank R --out DIR --mode
    M``): with ring projections, first K6–K8 on the IPC ring at
    BERT-Large's shapes (`check_ring_matmul_two_ranks`); then the BERT CLI
    in ``mode`` (a key of `_BERT_LARGE_MODES`), every step's launches
    checked (K4 and the K5 ring once per bucket; with ring projections K6,
    K7 and K8 96 times each, K6 and K7 on the wgmma route); the losses,
    launches, step times and the gathered parameters' digest into
    ``out/rank<r>.json``."""
    _join_two_ranks(rank, out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rp = mode == "bert-large-rp"
    cm_errs = check_ring_matmul_two_ranks(rank, _CM_BERT_LARGE) if rp \
        else None
    _zero_two_rank_counts()                       # the main path starts here
    marks, prev, widths = [], {}, {}

    def on_step(ts, state, metrics):
        del state, metrics
        now = _two_rank_counts(ts)
        nb = ts.plan.num_buckets
        # query, key, value and intermediate of every layer
        n_cm = 4 * ts.model.config.num_hidden_layers if rp else 0
        if not prev:       # init's gathers: nb direct, at the steps' widths
            widths.update(ag=now["ring_ag_direct"] // 2)
            prev.update({k: 0 for k in now} | {
                "ag": nb, "ring_ag": nb, "ring_ag_direct_all": nb,
                "ring_ag_direct": widths["ag"]})
        # K4 and the K5 ring on their vector width where the shard's size
        # and offset allow bulk copies (`ag_route`, `rs_route`): BERT-Large's
        # plan has shards that do not (the scalar width); the widths must
        # not change from step to step
        got = {k: now[k] - prev[k] for k in now}
        widths.setdefault("rs", got["ring_rs_vector"])
        want = {k: 0 for k in now if k.startswith("flash")} | {
            "rs": nb, "ag": nb, "update": nb, "fused_update": 0,
            "ring_ag": nb, "ring_rs": nb, "ring_ag_direct_all": nb,
            "ring_ag_direct": widths["ag"], "ring_rs_vector": widths["rs"],
            "cm_fwd": n_cm, "cm_dx": n_cm, "cm_dw": n_cm,
            "cm_fwd_wgmma": n_cm, "cm_dx_wgmma": n_cm}
        _check(got == want, f"rank {rank} {mode} step {len(marks) + 1}: "
               f"launches {got}, expected {want}")
        prev.update(now)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    torch.cuda.reset_peak_memory_stats()
    res = bert_cli.main(_BERT_LARGE_ARGS + _BERT_LARGE_MODES[mode]
                        + ["--device", _DEV], on_step=on_step)
    ts = res.train_step
    launches = _two_rank_counts(ts)               # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks[1:-1], marks[2:])]
    params = ts.gather_params(res.state)
    (out / f"rank{rank}.json").write_text(json.dumps({
        "losses": res.losses, "launches": launches, "step_ms": step_ms,
        "sen_per_s": res.total_mean, "params": _digest(params),
        "peak_bytes": peak,
        "cm_errs": cm_errs, "buckets": ts.plan.num_buckets,
        "bucket_shards": [b.shard_size for b in ts.plan.buckets]}))
    ts.close()
    backend.shutdown()


#: the last loss with ring projections against dear-fused without
#: (relative), as GPT-2's `_RP_VS_FUSED_RTOL`
_BERT_RP_VS_FUSED_RTOL = 1e-3


def train_bert_large_rp() -> tuple:
    """BERT-Large trained 6 steps by two ranks sharing the card, with
    ``--mode dear-fused`` and with ``--ring-projections`` too: finite
    losses, equal on both ranks; both ranks' gathered parameters bitwise
    equal; every step's launches checked in each rank; the last loss with
    ring projections within `_BERT_RP_VS_FUSED_RTOL` of the one without.
    Returns the two ranks' results of each run."""
    results = {}
    for mode in _BERT_LARGE_MODES:
        t0 = time.perf_counter()
        results[mode] = spawn_two_ranks(
            mode, lambda r, out, m=mode: ["--bert-rank", str(r), "--out",
                                          str(out), "--mode", m], 900.0)
        ranks = results[mode]
        losses = ranks[0]["losses"]
        print(f"two ranks {mode}: losses {[round(x, 4) for x in losses]}; "
              f"{ranks[0]['buckets']} buckets (shards "
              f"{ranks[0]['bucket_shards']}); wall "
              f"{time.perf_counter() - t0:.1f} s")
        for r, rank in enumerate(ranks):
            p50, p99 = (float(np.percentile(rank["step_ms"], q))
                        for q in (50, 99))
            print(f"two-rank {mode} step, rank {r} (BERT-Large, bf16, 8 x 64 "
                  f"per rank, {len(rank['step_ms'])} steps after the first): "
                  f"p50 {p50:.3f} ms p99 {p99:.3f} ms; "
                  f"{rank['sen_per_s']:.1f} sentences/s over both ranks "
                  "(the CLI's timed mean); K4 on the direct route by width "
                  f"{rank['launches']['ring_ag_direct']} vector of "
                  f"{rank['launches']['ring_ag_direct_all']}, the K5 ring "
                  f"{rank['launches']['ring_rs_vector']} vector of "
                  f"{rank['launches']['ring_rs']}; peak memory "
                  f"{rank['peak_bytes'] / 2**20:.1f} MiB")
        _check(len(losses) == _BERT_LARGE_STEPS
               and all(np.isfinite(losses)), f"{mode}: losses {losses}")
        _check(ranks[1]["losses"] == losses,
               f"{mode}: the ranks' losses differ")
        _check(ranks[1]["params"] == ranks[0]["params"],
               f"{mode}: the ranks' gathered parameters differ")
    fused, rp = (results[m] for m in _BERT_LARGE_MODES)
    lf, lr = fused[0]["losses"][-1], rp[0]["losses"][-1]
    rel = abs(lr - lf) / abs(lf)
    print(f"bert-large step-{_BERT_LARGE_STEPS} loss: dear-fused {lf:.6f}, "
          f"with ring projections {lr:.6f}, relative difference {rel:.3e} "
          f"(limit {_BERT_RP_VS_FUSED_RTOL:g})")
    _check(rel <= _BERT_RP_VS_FUSED_RTOL,
           "bert-large: ring projections and dear-fused losses differ")
    return fused, rp


# ---------------------------------------------------------------------------
# phase 5l: the baseline schedules, fsdp and the ablations
# ---------------------------------------------------------------------------

#: the two-rank runs of phase 5l, one after another in one pair of rank
#: processes: name -> the training CLI's mode flags. fsdp first, so that
#: its peak memory is a fresh process's, as phase 5b's dear run's is
_MODES_RUNS = {
    "fsdp": ["--mode", "fsdp"],
    "allreduce": ["--mode", "allreduce"],
    "rsag": ["--mode", "rsag"],
    "rb": ["--mode", "rb"],
    "bytescheduler": ["--mode", "bytescheduler", "--partition", "4"],
    "dear-no-reducescatter": ["--mode", "dear", "--exclude-parts",
                              "reducescatter"],
    "dear-no-allgather": ["--mode", "dear", "--exclude-parts", "allgather"],
}
#: 4 steps each (2 warmup, 2 timed): phase 5b's arguments otherwise
_MODES_STEPS = ["--num-warmup-batches", "2", "--num-batches-per-iter", "2",
                "--num-iters", "1"]
_MODES_STEP = 4
#: one rank on NCCL: ``dear`` and each new mode 5 steps through the CLI
#: at B = 4 in bf16; at world 1 ``--fp16`` keeps fsdp's buckets in fp32
#: under bf16 compute, so its backward casts every bucket it gathers again
_ONE_RANK_MODES = {
    "dear": ["--mode", "dear"],
    "allreduce": ["--mode", "allreduce"],
    "rsag": ["--mode", "rsag"],
    "rb": ["--mode", "rb"],
    "bytescheduler": ["--mode", "bytescheduler", "--partition", "4"],
    "fsdp": ["--mode", "fsdp"],
}
_ONE_RANK_ARGS = ["--model", "gpt2", "--flash-attention", "--dropout0",
                  "--fp16", "--batch-size", "4", "--sequence-len", "1024",
                  "--base-lr", "0.01", "--momentum", "0.9", "--threshold",
                  "25", "--num-warmup-batches", "0",
                  "--num-batches-per-iter", "5", "--num-iters", "1"]
_COLLECTIVES = ("rs", "ag", "ar", "reduce", "bcast")


def _modes_counts(ts) -> dict:
    return {"flash_fwd": FA.flash_fwd_launches,
            "flash_fwd_tc": FA.flash_fwd_route_launches["tensor_core"],
            "flash_bwd_dq": FA.flash_bwd_dq_launches,
            "flash_bwd_dkv": FA.flash_bwd_dkv_launches,
            "flash_bwd_dq_tc": FA.flash_bwd_route_launches["dq"][
                "tensor_core"],
            "flash_bwd_dkv_tc": FA.flash_bwd_route_launches["dkv"][
                "tensor_core"],
            "fused_update": FS.fused_update_launches,
            "update": ts.update_launches,
            **{k: getattr(ts, f"{k}_launches") for k in _COLLECTIVES}}


def _mode_collectives(ts) -> tuple:
    """(per step, before the first step) collectives of ``ts``'s schedule
    by kind: the table of the port's dear.py docstring, init's gathers
    before the first step."""
    nb = ts.plan.num_buckets
    per = dict.fromkeys(_COLLECTIVES, 0)
    before = dict.fromkeys(_COLLECTIVES, 0)
    if ts.mode == "fsdp":
        per.update(rs=nb, ag=2 * nb)
        before["ag"] = nb
    elif ts.mode == "dear":
        per["rs"] = 0 if "reducescatter" in ts._exclude else nb
        per["ag"] = before["ag"] = 0 if "allgather" in ts._exclude else nb
    elif ts.mode == "allreduce":
        per["ar"] = nb
    elif ts.mode == "rsag":
        per.update(rs=nb, ag=nb)
    elif ts.mode == "rb":
        per.update(reduce=nb, bcast=nb)
    else:                                       # bytescheduler
        chunks = sum(len(FU.chunk_bounds(b.padded_size,
                                         ts._gbuf[0].element_size(),
                                         ts.partition_mb))
                     for b in ts.plan.buckets)
        per.update(rs=chunks, ag=chunks)
    return per, before


def _run_mode(argv, label: str, bf16: bool = True) -> dict:
    """One run of the training CLI (``argv``), every step's launches
    checked: K1, K2 and K3 once per layer (on their tensor-core routes in
    bf16, else CUDA cores), the K5 epilogue and the update once per bucket
    and the schedule's collectives (`_mode_collectives`). Returns the
    run's losses, step times, launches, tokens/s, peak memory (reset
    before the run), the gathered parameters' digest and the plan's
    bucket sizes."""
    layers = GPT2_SMALL.num_hidden_layers
    FA.reset_launch_counts()                      # the main path starts
    FS.fused_update_launches = 0                  # here
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    marks, prev = [], {}

    def on_step(ts, state, metrics):
        del state, metrics
        now = _modes_counts(ts)
        nb = ts.plan.num_buckets
        per, before = _mode_collectives(ts)
        tc = layers if bf16 else 0
        want = {"flash_fwd": layers, "flash_fwd_tc": tc,
                "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
                "flash_bwd_dq_tc": tc, "flash_bwd_dkv_tc": tc,
                "fused_update": nb, "update": nb, **per}
        base = prev or dict.fromkeys(now, 0) | before
        got = {k: now[k] - base[k] for k in now}
        _check(got == want, f"{label} step {len(marks) + 1}: launches "
               f"{got}, expected {want}")
        prev.update(now)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    res = train_cli.main(argv + ["--device", _DEV], on_step=on_step)
    ts = res.train_step
    launches = _modes_counts(ts)                  # ... and ends here
    routes = {"fwd": dict(FA.flash_fwd_route_launches),
              **{w: dict(c) for w, c in FA.flash_bwd_route_launches.items()}}
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    params = ts.gather_params(res.state)
    out = {"losses": res.losses, "step_ms": step_ms, "launches": launches,
           "routes": routes, "tokens_per_s": res.total_mean * 1024,
           "peak_bytes": peak, "base_bytes": base,
           "params": _digest(params),
           "bucket_padded": [b.padded_size for b in ts.plan.buckets],
           "buckets": ts.plan.num_buckets, "mode": ts.mode,
           "gather_bytes": ts._full[0].element_size()}
    ts.close()
    return out


def check_communicator(rank: int, world: int) -> None:
    """The `Communicator` (2 streams) on this process's group: every method
    once on one stacked ``(world, n)`` input that every rank draws from one
    seed, handles round-robin, `syncStream` and `synchronize` as fences,
    each result equal to the stacked input's sum, slice or row that the
    collective defines (sums of at most two fp32 values, so exact; at world
    1 the identities); ``multiBcast`` broadcasts ``fn`` of rank 0's large
    input and computes that of this rank's small one here."""
    comm = Communicator(nstreams=2)
    gen = torch.Generator(device=_DEV).manual_seed(22)
    xs = torch.randn(world, 4099, generator=gen, device=_DEV)
    big = torch.randn(world, 512 * 512, generator=gen, device=_DEV)
    x, total, root = xs[rank].contiguous(), xs.sum(0), world - 1
    n = 4098 // world
    even = xs[:, :n * world].contiguous()
    want = {"reduce": total if rank == root else x, "bcast": xs[root],
            "allReduce": total, "allReduceRB": total, "allReduceRSAG": total,
            "reduceScatter": even.sum(0)[rank * n:(rank + 1) * n],
            "allGather": xs.reshape(-1),
            "sendrecv": xs[(rank - 1) % world]}
    outs = {"reduce": comm.reduce(x, root), "bcast": comm.bcast(x, root),
            "allReduce": comm.allReduce(x),
            "allReduceRB": comm.allReduceRB(x),
            "allReduceRSAG": comm.allReduceRSAG(x),
            "reduceScatter": comm.reduceScatter(even[rank]),
            "allGather": comm.allGather(x),
            "sendrecv": comm.sendrecv(
                x, [(r + 1) % world for r in range(world)])}
    multi, h = comm.multiBcast([big[rank].contiguous(), x],
                               lambda t: t * 2.0 + 1.0)
    handles = [o[1] for o in outs.values()] + [h]
    _check(handles == [i % 2 for i in range(len(outs) + 1)],
           f"rank {rank} communicator handles {handles}")
    comm.syncStream(0)
    comm.synchronize()
    _check(comm.getNumOfFreeStreams() == 2,
           f"rank {rank} communicator: streams busy")
    for name, (o, _) in outs.items():
        _check(torch.equal(o, want[name]),
               f"rank {rank} communicator {name} (world {world})")
    _check(torch.equal(multi[0], big[0] * 2.0 + 1.0)
           and torch.equal(multi[1], x * 2.0 + 1.0),
           f"rank {rank} communicator multiBcast (world {world})")
    backend_name = torch.distributed.get_backend()
    comm.destroy()
    print(f"rank {rank}: communicator ({backend_name}, world {world}, 2 "
          f"streams): every method once, handles {handles}, each result "
          "equal to its definition")


def modes_rank_worker(rank: int, out: Path) -> None:
    """One of the two ranks of phase 5l (``--modes-rank R --out DIR``):
    every run of `_MODES_RUNS` in turn over one gloo group (phase 5b's
    arguments, 4 steps each; `_run_mode` checks every step), then the
    `Communicator` over that group (`check_communicator`); the
    results into ``out/rank<r>.json``."""
    _join_two_ranks(rank, out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for name, flags in _MODES_RUNS.items():
        t0 = time.perf_counter()
        results[name] = _run_mode(_TWO_RANK_ARGS + _MODES_STEPS + flags,
                                  f"rank {rank} {name}")
        results[name]["wall_s"] = time.perf_counter() - t0
    check_communicator(rank, 2)
    results["device"] = str(backend.device())
    results["card_shared"] = backend.card_shared()
    results["backend"] = torch.distributed.get_backend()
    (out / f"rank{rank}.json").write_text(json.dumps(results))
    backend.shutdown()


def train_modes(dear_ranks) -> tuple:
    """Phase 5l on two ranks sharing the card: the runs of `_MODES_RUNS`
    (`modes_rank_worker`). For the modes: finite losses that fall, equal
    on both ranks; both ranks' gathered parameters bitwise equal; the
    step-6 loss within `_FUSED_VS_DEAR_RTOL` of phase 5b's ``dear`` run
    (``dear_ranks``) at step 10. For the ablations: only that they ran,
    with their counts. fsdp's peak memory per rank below dear's by at
    least half of (the full buckets' bytes - the largest bucket's). Returns
    the two ranks' results."""
    t0 = time.perf_counter()
    ranks = spawn_two_ranks(
        "modes", lambda r, out: ["--modes-rank", str(r), "--out", str(out)],
        900.0)
    print(f"two ranks, phase 5l: backend {ranks[0]['backend']}, devices "
          f"{[r['device'] for r in ranks]}, card shared "
          f"{ranks[0]['card_shared']}; wall {time.perf_counter() - t0:.1f} s")
    dear_loss = dear_ranks[0]["losses"][_MODES_STEP - 1]
    for name in _MODES_RUNS:
        r0, r1 = ranks[0][name], ranks[1][name]
        losses = r0["losses"]
        p50s = [float(np.percentile(r[name]["step_ms"], 50)) for r in ranks]
        print(f"two ranks {name}: losses {[round(x, 4) for x in losses]}; "
              f"{r0['buckets']} buckets; step p50 by rank "
              f"{[round(x, 3) for x in p50s]} ms; wall {r0['wall_s']:.1f} s")
        _check(len(losses) == _MODES_STEP and len(r1["losses"])
               == _MODES_STEP, f"two ranks {name}: losses {losses}")
        if r0["mode"] == "dear":       # an ablation: garbage by design
            continue
        _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
               f"two ranks {name}: losses {losses}")
        _check(r1["losses"] == losses,
               f"two ranks {name}: the ranks' losses differ")
        _check(r1["params"] == r0["params"],
               f"two ranks {name}: the ranks' gathered parameters differ")
        rel = abs(losses[-1] - dear_loss) / abs(dear_loss)
        print(f"  step-{_MODES_STEP} loss {losses[-1]:.6f} against phase "
              f"5b's dear {dear_loss:.6f}: relative {rel:.3e} (limit "
              f"{_FUSED_VS_DEAR_RTOL:g})")
        _check(rel <= _FUSED_VS_DEAR_RTOL,
               f"two ranks {name}: the step-{_MODES_STEP} loss is not dear's")
    fsdp = ranks[0]["fsdp"]
    item = fsdp["gather_bytes"]
    full = sum(fsdp["bucket_padded"]) * item
    largest = max(fsdp["bucket_padded"]) * item
    need = (full - largest) / 2
    for r, (mine, dear) in enumerate(zip(ranks, dear_ranks)):
        peak, dear_peak = mine["fsdp"]["peak_bytes"], dear["peak_bytes"]
        print(f"rank {r} peak memory (max_memory_allocated): fsdp "
              f"{peak / 2**20:.1f} MiB, dear (phase 5b) "
              f"{dear_peak / 2**20:.1f} MiB: {(dear_peak - peak) / 2**20:.1f}"
              f" MiB less; the full buckets {full / 2**20:.1f} MiB, the "
              f"largest {largest / 2**20:.1f} MiB: at least "
              f"{need / 2**20:.1f} MiB less required")
        _check(peak <= dear_peak - need,
               f"rank {r}: fsdp's peak memory is not below dear's")
    return ranks


def train_modes_one_rank() -> dict:
    """Phase 5l on one rank over NCCL (the only place the new collectives
    run on the NCCL path): each run of `_ONE_RANK_MODES` through the CLI,
    every step checked (`_run_mode`), each new mode's 5 losses within
    `_FUSED_VS_DEAR_RTOL` of the ``dear`` run's. Returns the runs'
    results."""
    runs = {}
    for name, flags in _ONE_RANK_MODES.items():
        runs[name] = r = _run_mode(_ONE_RANK_ARGS + flags,
                                   f"one rank {name}")
        losses, dear = r["losses"], runs["dear"]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, dear))
        print(f"one rank {name} (NCCL, B=4): losses "
              f"{[round(x, 4) for x in losses]}, largest relative "
              f"difference from dear's {rel:.3e} (limit "
              f"{_FUSED_VS_DEAR_RTOL:g}); launches {r['launches']}")
        _check(len(losses) == len(dear) == 5 and all(np.isfinite(losses)),
               f"one rank {name}: losses {losses}")
        _check(rel <= _FUSED_VS_DEAR_RTOL,
               f"one rank {name}: the losses are not dear's")
    return runs


# ---------------------------------------------------------------------------
# phase 5m: compression, LAMB and remat
# ---------------------------------------------------------------------------

_COMP_NAMES = ("topk", "eftopk", "gaussian", "signum", "efsignum", "qint8")
#: the reference sweep's density (its ResNet-50 eftopk methods)
_COMP_DENSITY = 0.01
#: ResNet-50 as the sweep's eftopk method runs it: bf16, B = 64, 224²,
#: allreduce, 25 MB buckets, eftopk at 1% (the CLI's SGD 0.01, momentum
#: 0.9; with momentum correction the velocity carries it)
_RESNET_COMP_ARGS = ["--model", "resnet50", "--batch-size", "64", "--fp16",
                     "--mode", "allreduce", "--threshold", "25",
                     "--compressor", "eftopk", "--density", "0.01"]


def _steps(n: int) -> list:
    return ["--num-warmup-batches", "0", "--num-batches-per-iter", str(n),
            "--num-iters", "1"]


_GPT_FP32_ARGS = [a for a in _TWO_RANK_ARGS if a != "--fp16"]
#: the two-rank runs of phase 5m, one after another in one pair of rank
#: processes (``--comp-rank R --out DIR``): name -> (model, argv). The sign
#: compressors move every element by lr each step: lr 1e-3 (JAX's tests
#: train them at a smaller lr too)
#: (few steps, for the script's time limit: the checks run on every step
#: all the same)
_COMP_RUNS = {
    "resnet50 eftopk": ("resnet", _RESNET_COMP_ARGS + _steps(4)),
    "resnet50 eftopk mc": ("resnet", _RESNET_COMP_ARGS + _steps(4)
                           + ["--momentum-correction", "0.9"]),
    **{f"gpt2 dear {c}": ("gpt", _TWO_RANK_ARGS + _steps(2) + [
        "--mode", "dear", "--compressor", c, "--density",
        str(_COMP_DENSITY)] + (["--base-lr", "0.001"] if "sign" in c
                               else [])) for c in _COMP_NAMES},
    "gpt2 allreduce eftopk gtopk": ("gpt", _TWO_RANK_ARGS + _steps(2) + [
        "--mode", "allreduce", "--compressor", "eftopk", "--density",
        str(_COMP_DENSITY), "--gtopk"]),
    # fp32 gradients: topk at density 1 sends every coordinate, so its
    # losses are the dense allreduce's (JAX's
    # test_sparse_allreduce_equals_dense_at_density_1, on the card)
    "gpt2 allreduce topk d1 fp32": ("gpt", _GPT_FP32_ARGS + _steps(2) + [
        "--mode", "allreduce", "--compressor", "topk", "--density", "1.0"]),
    "gpt2 allreduce fp32": ("gpt", _GPT_FP32_ARGS + _steps(2) + [
        "--mode", "allreduce"]),
}
_TOPK_D1_RTOL = 1e-5
#: LAMB on BERT-Large pretraining (JAX runner.py:354-361): bf16, S = 128,
#: B = 16, dropout 0.1, betas (0.9, 0.999), eps 1e-8, no weight decay
#: (DearConfig's)
_LAMB_ARGS = ["--model", "bert_large", "--fp16", "--optimizer", "lamb",
              "--batch-size", "16", "--sentence-len", "128"]
_LAMB_TRUST_RTOL = 1e-5
_REMAT_ARGS = ["--model", "gpt2", "--fp16", "--flash-attention",
               "--dropout0", "--batch-size", "16", "--sequence-len", "1024",
               "--base-lr", "0.01", "--momentum", "0.9", "--threshold",
               "25"] + _steps(5)
_REMAT_RTOL = 1e-5
_REMAT_BN_RTOL = 1e-6


def _payload_parts(payload) -> dict:
    return (dict(payload) if isinstance(payload, dict)
            else {"words": payload})


def _check_gaussian(tag, x, payload, res, density) -> tuple:
    """gaussian's invariants on one device: k indices; the residual is x
    off them and 0 on them; each sent value is x where |x| is over the
    threshold, else 0. Returns (threshold, the indices clear of it)."""
    k = Z._k_of(x.shape[0], density)
    thres = float(Z._gaussian_threshold(x, density))
    idx = payload["indices"].long()
    mag = x.abs()
    _check(idx.shape[0] == k and idx.unique().shape[0] == k,
           f"{tag}: {idx.shape[0]} indices, k = {k}")
    want_vals = torch.where(mag[idx] > thres, x[idx], torch.zeros_like(x[idx]))
    _check(torch.equal(payload["values"], want_vals),
           f"{tag}: a sent value is not x over the threshold (else 0)")
    sent = torch.zeros_like(x, dtype=torch.bool)
    sent[idx] = True
    _check(torch.equal(res[~sent], x[~sent]) and not res[sent].any(),
           f"{tag}: the residual is not x off the sent indices, 0 on them")
    clear = idx[(mag[idx] - thres).abs() > 1e-5 * thres]
    return thres, set(clear.cpu().tolist())


def check_compressors(n: int, card: str) -> dict:
    """Phase 5m's compressors on the card at ResNet-50's largest bucket
    (``n`` fp32 elements, a zero tail of 4096 as padding ties) and density
    0.01, against the same compressor on a CPU copy of the input: the
    indices equal, the values, residuals, sign words and qint8's words and
    scale bitwise; gaussian, whose mean and std sum in another order on
    the card: its invariants on each device, the thresholds within 1e-5,
    and the indices equal away from the threshold. Prints and returns each
    ``compress`` time on the card (ms, median of 5 after one warm call)."""
    gen = torch.Generator(device=_DEV).manual_seed(31)
    x = torch.randn(n, generator=gen, device=_DEV)
    x[-4096:] = 0.0
    res0 = 0.1 * torch.randn(n, generator=gen, device=_DEV)
    times = {}
    for name in _COMP_NAMES:
        comp = Z.get_compressor(name)
        stateful = torch.is_tensor(comp.init(1))
        rc, rh = (res0, res0.cpu()) if stateful else ((), ())
        pc, sc = comp.compress(x, rc, _COMP_DENSITY)
        ph, sh = comp.compress(x.cpu(), rh, _COMP_DENSITY)
        torch.cuda.synchronize()
        pc, ph = _payload_parts(pc), _payload_parts(ph)
        tag = f"compressor {name} card vs CPU (n={n})"
        if name == "gaussian":
            xin = x + res0
            tc, clear_c = _check_gaussian(tag + " card", xin, pc, sc,
                                          _COMP_DENSITY)
            th, clear_h = _check_gaussian(tag + " CPU", xin.cpu(), ph, sh,
                                          _COMP_DENSITY)
            _check(abs(tc - th) <= 1e-5 * th, f"{tag}: thresholds {tc}, {th}")
            _check(clear_c == clear_h, f"{tag}: indices clear of the "
                   "threshold differ")
        else:
            for key in pc:
                _check(torch.equal(pc[key].cpu(), ph[key]),
                       f"{tag}: {key} differ")
            _check(not stateful or torch.equal(sc.cpu(), sh),
                   f"{tag}: residuals differ")
        ms = []
        for rep in range(6):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            comp.compress(x, rc, _COMP_DENSITY)
            b.record()
            torch.cuda.synchronize()
            if rep:
                ms.append(a.elapsed_time(b))
        times[name] = float(np.median(ms))
    print(f"phase 5m compressors on the card = on the CPU (n = {n}, "
          f"density {_COMP_DENSITY}; gaussian by its invariants); compress "
          f"ms on {card}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return times


def _comp_counts(ts) -> dict:
    return {"flash_fwd": FA.flash_fwd_launches,
            "flash_fwd_tc": FA.flash_fwd_route_launches["tensor_core"],
            "flash_bwd_dq": FA.flash_bwd_dq_launches,
            "flash_bwd_dkv": FA.flash_bwd_dkv_launches,
            "fused_update": FS.fused_update_launches,
            "update": ts.update_launches, "comp": ts.comp_launches,
            **{k: getattr(ts, f"{k}_launches") for k in _COLLECTIVES}}


def _comp_want(ts, layers: int, bf16: bool, fwd_per_layer: int = 1) -> tuple:
    """(per step, before the first step) launches of ``ts``'s schedule:
    K1 ``fwd_per_layer`` times per layer (2 under remat), K2 and K3 once
    (tensor cores in bf16); the K5 epilogue once per bucket (not for
    LAMB); the payload collectives once per bucket (gTop-k: log2 W); the
    schedule's dense collectives; LAMB's segment sums in one all-reduce per
    bucket in the sharded modes at world > 1."""
    nb = ts.plan.num_buckets
    per = dict.fromkeys(_COLLECTIVES, 0)
    before = dict.fromkeys(_COLLECTIVES, 0)
    compressed = ts.compressor is not None
    if ts.sharded:
        per["rs"] = 0 if compressed else nb
        per["ag"] = before["ag"] = nb
    elif not compressed:
        per["ar"] = nb
    if ts.layerwise and ts.sharded and ts.world > 1:
        per["ar"] += nb
    rounds = ts.world.bit_length() - 1 if ts.gtopk else 1
    want = {"flash_fwd": fwd_per_layer * layers,
            "flash_fwd_tc": fwd_per_layer * layers if bf16 else 0,
            "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
            "fused_update": 0 if ts.layerwise else nb, "update": nb,
            "comp": nb * rounds if compressed else 0, **per}
    return want, {"comp": 0} | before


def _run_comp(main, argv, label, layers=0, bf16=True, fwd_per_layer=1,
              trace=False, on_first=None) -> dict:
    """One run of a training CLI (``main``, ``argv``), every step's
    launches checked against `_comp_want`; ``on_first(ts)`` after the first
    step. Returns the run's losses, step times (after the first),
    launches, K1-K3 launches by route, peak memory (reset before the run),
    the gathered parameters' digest, the largest |residual| and, with
    ``trace``, a 2-step trace."""
    FA.reset_launch_counts()                      # the main path starts
    FS.fused_update_launches = 0                  # here
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    marks, prev = [], {}

    def on_step(ts, state, metrics):
        del state, metrics
        now = _comp_counts(ts)
        want, before = _comp_want(ts, layers, bf16, fwd_per_layer)
        base = prev or dict.fromkeys(now, 0) | before
        got = {k: now[k] - base[k] for k in now}
        _check(got == want, f"{label} step {len(marks) + 1}: launches "
               f"{got}, expected {want}")
        prev.update(now)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        if on_first is not None and len(marks) == 1:
            on_first(ts)

    res = main(argv + ["--device", _DEV], on_step=on_step)
    ts = res.train_step
    launches = _comp_counts(ts)                   # ... and ends here
    routes = {"fwd": dict(FA.flash_fwd_route_launches),
              **{w: dict(c) for w, c in FA.flash_bwd_route_launches.items()}}
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    _check(all(np.isfinite(res.losses)), f"{label}: losses {res.losses}")
    residual = 0.0
    for entry in res.state.comp_state:
        r = entry["res"] if isinstance(entry, dict) else entry
        if torch.is_tensor(r):
            residual = max(residual, float(r.abs().max()))
    out = {"losses": res.losses, "step_ms": step_ms, "launches": launches,
           "routes": routes, "peak_bytes": peak,
           "params": _digest(ts.gather_params(res.state)),
           "residual": residual, "buckets": ts.plan.num_buckets,
           "stateful": any(torch.is_tensor(e["res"] if isinstance(e, dict)
                                           else e)
                           for e in res.state.comp_state)}
    if trace:
        out["trace"] = trace_train_steps(
            ts, res.state, res.batch, float(np.percentile(step_ms, 50)),
            label=label)
    out["result"] = res
    return out


def check_lamb_trust(ts, state, rank: int) -> float:
    """LAMB's trust ratios computed on this rank's shard (segment sums
    all-reduced) against the same update of the gathered full bucket (its
    own sums): one more update, on copies, of the bucket with the most
    parameters of those where one spans the shard boundary, from the
    run's last state and a gradient
    that both ranks draw from one seed. Returns the largest difference
    over the largest ratio."""
    plan, world = ts.plan, ts.world
    g = max((b for b in plan.buckets
             if any(off < r * b.shard_size < off + plan.leaves[i].size
                    for i, off in zip(b.leaf_ids, b.offsets)
                    for r in range(1, world))),
            key=lambda b: len(b.leaf_ids)).index
    b = plan.buckets[g]
    opt, st = ts.optimizer, state.opt_state[g]
    gen = torch.Generator(device=_DEV).manual_seed(44)
    grad = 1e-3 * torch.randn(b.padded_size, generator=gen, device=_DEV)
    grad[b.size:] = 0.0
    lo = rank * b.shard_size
    mine = {"m": st["m"].clone(), "v": st["v"].clone(), "t": st["t"]}
    seg, nseg, psum = ts._segments(g)
    opt.update(grad[lo:lo + b.shard_size].clone(), mine,
               state.shards[g].clone(), seg, nseg, psum)
    full = {k: C.all_gather(st[k], ts.group) for k in ("m", "v")}
    full["t"] = st["t"]
    opt.update(grad, full, C.all_gather(state.shards[g], ts.group),
               ts._segment_ids(g, 0, b.padded_size), nseg, lambda x: x)
    err = float((mine["trust"] - full["trust"]).abs().max()
                / full["trust"].abs().max())
    print(f"rank {rank}: LAMB trust ratios of bucket {g} ({len(b.leaf_ids)} "
          f"parameters, one across the shard boundary) on the shards vs the "
          f"gathered bucket: {err:.3e} of the largest (limit "
          f"{_LAMB_TRUST_RTOL})")
    _check(err <= _LAMB_TRUST_RTOL, f"rank {rank}: LAMB trust ratios differ")
    return err


def comp_rank_worker(rank: int, out: Path) -> None:
    """One of the two ranks of phase 5m (``--comp-rank R --out DIR``):
    every run of `_COMP_RUNS` in turn over one gloo group (`_run_comp`
    checks every step), then LAMB on BERT-Large (3 steps, every step
    checked) and `check_lamb_trust`; the results into
    ``out/rank<r>.json``."""
    _join_two_ranks(rank, out)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers = GPT2_SMALL.num_hidden_layers
    results = {}
    for name, (model, argv) in _COMP_RUNS.items():
        t0 = time.perf_counter()
        gpt = model == "gpt"
        run = _run_comp(train_cli.main if gpt else imagenet_cli.main, argv,
                        f"rank {rank} {name}", layers if gpt else 0,
                        bf16="--fp16" in argv, trace=not gpt)
        run.pop("result").train_step.close()
        run["wall_s"] = time.perf_counter() - t0
        results[name] = run
    t0 = time.perf_counter()
    run = _run_comp(bert_cli.main, _LAMB_ARGS + _steps(3),
                    f"rank {rank} bert_large lamb")
    res = run.pop("result")
    run["trust_err"] = check_lamb_trust(res.train_step, res.state, rank)
    res.train_step.close()
    run["wall_s"] = time.perf_counter() - t0
    results["bert_large lamb"] = run
    results["device"] = str(backend.device())
    results["card_shared"] = backend.card_shared()
    results["backend"] = torch.distributed.get_backend()
    (out / f"rank{rank}.json").write_text(json.dumps(results))
    backend.shutdown()


def train_compressed_two_ranks() -> list:
    """Phase 5m's two-rank runs (`comp_rank_worker`): per run both ranks'
    gathered parameters bitwise equal and their losses equal; every
    stateful compressor's residual nonzero; the topk run at density 1
    within `_TOPK_D1_RTOL` of the dense allreduce's losses at every step.
    Prints each run's step p50 per rank (and for ResNet-50 the traced idle
    share). Returns the two ranks' results."""
    t0 = time.perf_counter()
    ranks = spawn_two_ranks(
        "comp", lambda r, out: ["--comp-rank", str(r), "--out", str(out)],
        900.0)
    print(f"two ranks, phase 5m: backend {ranks[0]['backend']}, devices "
          f"{[r['device'] for r in ranks]}, card shared "
          f"{ranks[0]['card_shared']}; wall {time.perf_counter() - t0:.1f} s")
    for name in [*_COMP_RUNS, "bert_large lamb"]:
        r0, r1 = ranks[0][name], ranks[1][name]
        p50s = [float(np.percentile(r[name]["step_ms"], 50)) for r in ranks]
        tr = r0.get("trace")
        print(f"two ranks {name}: losses "
              f"{[round(x, 4) for x in r0['losses']]}; {r0['buckets']} "
              f"buckets; step p50 by rank {[round(x, 3) for x in p50s]} ms"
              + (f"; idle {1 - tr['busy_ms'] / p50s[0]:.1%} of rank 0's "
                 f"p50 (traced busy {tr['busy_ms']:.3f} ms/step)"
                 if tr else "")
              + f"; max |residual| {r0['residual']:.3e}"
              + (f"; LAMB trust ratios on the shards vs the gathered bucket "
                 f"{max(r[name]['trust_err'] for r in ranks):.3e} of the "
                 f"largest" if "trust_err" in r0 else "")
              + f"; wall {r0['wall_s']:.1f} s")
        _check(r1["losses"] == r0["losses"],
               f"two ranks {name}: the ranks' losses differ")
        _check(r1["params"] == r0["params"],
               f"two ranks {name}: the ranks' gathered parameters differ")
        _check(not r0["stateful"] or r0["residual"] > 0,
               f"two ranks {name}: the residual is zero")
    d1 = ranks[0]["gpt2 allreduce topk d1 fp32"]["losses"]
    dense = ranks[0]["gpt2 allreduce fp32"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(d1, dense))
    print(f"topk at density 1 vs dense allreduce (fp32 gradients): losses "
          f"{d1} and {dense}, largest relative difference {rel:.3e} (limit "
          f"{_TOPK_D1_RTOL}; bitwise: {d1 == dense})")
    _check(rel <= _TOPK_D1_RTOL, "topk at density 1 is not the dense mean")
    return ranks


def train_compressed_one_rank(card: str) -> dict:
    """Phase 5m at one rank (NCCL): ResNet-50 eftopk (3 steps, traced);
    LAMB on BERT-Large (5 steps); GPT-2 without remat, with ``--remat``
    and with ``--remat-policy full`` (5 steps each: K1 24 times per step
    under remat, the losses within `_REMAT_RTOL` of the run's without,
    ``--remat``'s peak memory below it); ResNet-50 with ``--remat-policy
    full`` against the run without (`check_resnet_remat`). Returns the
    runs."""
    layers = GPT2_SMALL.num_hidden_layers
    runs = {}
    r = _run_comp(imagenet_cli.main, _RESNET_COMP_ARGS + _steps(3),
                  "one rank resnet50 eftopk", trace=True)
    r.pop("result").train_step.close()
    _check(r["residual"] > 0, "one rank resnet50 eftopk: zero residual")
    runs["resnet50 eftopk"] = r
    r = _run_comp(bert_cli.main, _LAMB_ARGS + _steps(5),
                  "one rank bert_large lamb")
    ts = r.pop("result").train_step
    r["segment_sums"] = time_lamb_segment_sums(ts, card)
    ts.close()
    runs["bert_large lamb"] = r
    for name, flags, fwd in (("gpt2", [], 1), ("gpt2 --remat", ["--remat"],
                                               2),
                             ("gpt2 --remat-policy full",
                              ["--remat-policy", "full"], 2)):
        r = _run_comp(train_cli.main, _REMAT_ARGS + flags, f"one rank {name}",
                      layers, fwd_per_layer=fwd)
        r.pop("result").train_step.close()
        runs[name] = r
    base = runs["gpt2"]
    for name in ("gpt2 --remat", "gpt2 --remat-policy full"):
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(runs[name]["losses"], base["losses"]))
        print(f"{name} (GPT-2 small, bf16, B=16, S=1024): losses "
              f"{runs[name]['losses']} against {base['losses']}: largest "
              f"relative difference {rel:.3e} (limit {_REMAT_RTOL}; bitwise:"
              f" {runs[name]['losses'] == base['losses']})")
        _check(rel <= _REMAT_RTOL, f"{name}: the losses are not the run's "
               "without remat")
    _check(runs["gpt2 --remat"]["peak_bytes"] < base["peak_bytes"],
           "--remat: the peak memory is not below the run's without")
    for name in ("gpt2", "gpt2 --remat", "gpt2 --remat-policy full",
                 "resnet50 eftopk", "bert_large lamb"):
        r = runs[name]
        p50 = float(np.percentile(r["step_ms"], 50))
        tr = r.get("trace")
        print(f"phase 5m one rank {name} on {card}: step p50 {p50:.3f} ms; "
              f"peak memory {r['peak_bytes'] / 2**20:.1f} MiB"
              + (f"; idle {1 - tr['busy_ms'] / p50:.1%} of the p50 (traced "
                 f"busy {tr['busy_ms']:.3f} ms/step)" if tr else "")
              + f"; losses {[round(x, 4) for x in r['losses']]}")
    runs.update(check_resnet_remat())
    return runs


def time_lamb_segment_sums(ts, card: str) -> dict:
    """LAMB's two sums of squares per segment (``|w|^2`` and ``|u|^2``,
    `ops.fused_sgd.fused_lamb`: the squares into one fp64 buffer, then
    `_segment_sums` on its two rows) at the buckets of ``ts``'s plan, on
    random values with each bucket's smallest segment zeroed: every sum
    within 1e-6 of the CPU's fp64 sum of its segment, the zeroed ones
    exactly 0. Timed (CUDA events, median of 5 after a warm call, ms per
    step: every bucket once) against the two designs it replaced, from the
    same fp32 values: one fp64 ``sum`` per segment, and differences of one
    fp64 running sum over the bucket (the one that read a zero segment as
    +-1e-13). Returns the three times."""
    gen = torch.Generator(device=_DEV).manual_seed(45)
    cases = []
    for g in range(ts.plan.num_buckets):
        lo, hi = ts._span(g)
        lengths = ts._segment_lengths(g)
        ab = torch.randn(2, hi - lo, generator=gen, device=_DEV)
        ends = np.cumsum(lengths)
        small = min((n, i) for i, n in enumerate(lengths) if n)[1]
        ab[:, ends[small] - lengths[small]:ends[small]] = 0.0
        cases.append((ab[0], ab[1], ts._segment_ids(g, lo, hi), len(lengths),
                      lengths, ts._segment_pieces(g), small))

    def pieces(a, b, seg, nseg, lengths, pc):
        sq = a.new_empty((2, a.numel()), dtype=torch.float64)
        torch.mul(a, a, out=sq[0])
        torch.mul(b, b, out=sq[1])
        return FS._segment_sums(sq, seg, nseg, pc).float()

    def per_segment(a, b, seg, nseg, lengths, pc):
        return torch.stack([torch.stack([p.sum(dtype=torch.float64)
                                         for p in torch.split(x, lengths)])
                            for x in (a * a, b * b)]).float()

    def running_sum(a, b, seg, nseg, lengths, pc):
        out = []
        for x in (a * a, b * b):
            run = torch.cumsum(x.double(), 0)
            ids = torch.arange(nseg, dtype=seg.dtype, device=seg.device)
            ends = torch.searchsorted(seg, ids, right=True)
            upto = torch.cat([run.new_zeros((1,)), run])[ends]
            out.append(torch.diff(upto, prepend=upto.new_zeros((1,))))
        return torch.stack(out).float()

    worst, nseg, npieces = 0.0, 0, 0
    for a, b, seg, n, lengths, pc, small in cases:
        got = pieces(a, b, seg, n, lengths, pc).double().cpu().numpy()
        want = np.array([[p.double().square().sum().item()
                          for p in torch.split(x.cpu(), lengths)]
                         for x in (a, b)])
        _check((got[:, small] == 0.0).all(), f"LAMB segment sums: a zero "
               f"segment summed to {got[:, small]}")
        worst = max(worst, float(np.max(np.abs(got - want)
                                        / np.maximum(np.abs(want), 1e-30))))
        nseg, npieces = nseg + n, npieces + (len(pc[0]) - 1) // 2
    _check(worst <= 1e-6, f"LAMB segment sums off fp64 by {worst:.3e}")
    times = {}
    for name, fn in (("pieces", pieces), ("per_segment", per_segment),
                     ("running_sum", running_sum)):
        ms = []
        for rep in range(6):
            start, stop = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
            for case in cases:
                fn(*case[:6])
            stop.record()
            torch.cuda.synchronize()
            if rep:
                ms.append(start.elapsed_time(stop))
        times[name] = float(np.median(ms))
    print(f"phase 5m LAMB segment sums on {card} ({ts.plan.num_buckets} "
          f"buckets, {nseg} segments, {npieces} pieces of <= "
          f"{FS._PIECE}; |w|^2 and |u|^2 of every bucket, as one step): "
          f"within {worst:.3e} of fp64, the zeroed segments 0; ms per step: "
          f"two segmented reductions over both rows "
          f"{times['pieces']:.3f}, one sum per segment "
          f"{times['per_segment']:.3f}, running-sum differences "
          f"{times['running_sum']:.3f}")
    return times


def check_resnet_remat() -> dict:
    """ResNet-50 with ``--remat-policy full`` against the run without (3
    steps each, and a second run without as the control), with cuDNN off:
    the losses, the BN buffers after the first and the third step and the
    gathered parameters after the third within `_REMAT_BN_RTOL` of the
    largest |value| (the buffers updated 3 times). cuDNN caches its pick
    of a conv's algorithm per thread and the recompute runs on autograd's
    thread, so with cuDNN on the recompute's convs may round apart from
    the forward's (`ops.remat`); PyTorch's own convs pick nothing, so with
    cuDNN off any difference is the port's. Returns the runs."""
    runs, bufs, params = {}, {}, {}
    cudnn = torch.backends.cudnn
    was = cudnn.enabled
    cudnn.enabled = False
    try:
        for key, policy in (("none", "none"), ("full", "full"),
                            ("none again", "none")):
            def first(ts, key=key):
                bufs[key, 1] = {n: b.detach().clone() for n, b in
                                ts.model.named_buffers()}

            r = _run_comp(imagenet_cli.main, _RESNET_ARGS[:-6] + _steps(3)
                          + ["--remat-policy", policy],
                          f"one rank resnet50 --remat-policy {policy}",
                          on_first=first)
            res = r.pop("result")
            bufs[key, 3] = {n: b.detach().clone() for n, b in
                            res.train_step.model.named_buffers()}
            params[key] = res.train_step.gather_params(res.state)
            res.train_step.close()
            runs[f"resnet50 --remat-policy {key}"] = r
    finally:
        cudnn.enabled = was

    def apart(a, b):
        return max(float((a[n].float() - x.float()).abs().max())
                   / max(float(x.float().abs().max()), 1e-30)
                   for n, x in b.items())

    losses = {k: runs[f"resnet50 --remat-policy {k}"]["losses"]
              for k in ("none", "full", "none again")}
    gaps = {"losses": max(abs(a - b) / abs(b) for a, b in
                          zip(losses["full"], losses["none"])),
            "BN buffers after step 1": apart(bufs["full", 1],
                                             bufs["none", 1]),
            "BN buffers after step 3": apart(bufs["full", 3],
                                             bufs["none", 3]),
            "parameters after step 3": apart(params["full"],
                                             params["none"])}
    control = max(apart(bufs["none again", 3], bufs["none", 3]),
                  apart(params["none again"], params["none"]))
    tracked = {int(b) for n, b in bufs["full", 3].items()
               if n.endswith("num_batches_tracked")}
    print(f"resnet50 --remat-policy full against the run without (bf16, "
          f"B=64, 3 steps, cuDNN off; "
          f"{len(bufs['full', 1])} buffers, {len(params['full'])} "
          f"parameters), largest difference over the largest |value| "
          f"(limit {_REMAT_BN_RTOL}): "
          + "; ".join(f"{k} {v:.3e} (bitwise: {v == 0.0})"
                      for k, v in gaps.items())
          + f"; losses {losses['full']} and {losses['none']}; a second run "
          f"without remat {control:.3e}; num_batches_tracked "
          f"{sorted(tracked)}")
    _check(max(gaps.values()) <= _REMAT_BN_RTOL and tracked == {3},
           "resnet50 remat: the losses, BN buffers or parameters are not "
           "the run's without remat")
    return runs


def comp_launch_totals(two_ranks, one_rank) -> tuple:
    """Phase 5m's K1-K3 launches by route and K5 epilogue launches, over
    both ranks of every two-rank run and every one-rank run."""
    runs = [run for ranks in two_ranks for run in ranks.values()
            if isinstance(run, dict)] + list(one_rank.values())
    routes = {w: {route: sum(run["routes"][w][route] for run in runs)
                  for route in runs[0]["routes"][w]}
              for w in ("fwd", "dq", "dkv")}
    return routes, sum(run["launches"]["fused_update"] for run in runs)


# ---------------------------------------------------------------------------
# phase 5n: runtime tuning, the tracer, multi_step (slice 15)
# ---------------------------------------------------------------------------

_TUNE_GPT_ARGS = ["--model", "gpt2", "--fp16", "--flash-attention",
                  "--dropout0", "--batch-size", "16", "--sequence-len",
                  "1024", "--base-lr", "0.01", "--momentum", "0.9",
                  "--threshold", "25"]
#: BO: 3 trials of windows of 4 steps (the tuner's least interval: it
#: drops a window's first 3 durations); the budget, (2 x 3 + 2) x 4 = 32
#: steps, fits in the 36 steps of the warmup and the timed iterations
_BO_ENV = {"DEAR_BO_TRIALS": "3", "DEAR_BO_INTERVAL": "4"}
_BO_STEPS = ["--num-warmup-batches", "4", "--num-batches-per-iter", "8",
             "--num-iters", "4"]
#: the plan strategy over the arms that run at one rank without a
#: compressor: mode x comm dtype x gather dtype, 4 trials (no α-β fit: at
#: one rank every arm's predicted comm is 0, so the sweep goes by axis
#: coverage and tries both modes); it pre-tunes for its budget,
#: (2 x 4 + 2) x 4 = 40 steps, before the timed steps
_PLAN_ENV = {"DEAR_TUNE_MODES": "dear,dear-fused",
             "DEAR_TUNE_COMPRESSORS": "none", "DEAR_TUNE_DTYPES": "none,bf16",
             "DEAR_TUNE_REMAT": "none", "DEAR_BO_TRIALS": "4",
             "DEAR_BO_INTERVAL": "4"}
#: wait-time: split every ~3 blocks of GPT-2 (the layer-time estimate is
#: ~0.1 ms a block); the switch comes after the tuner's 5 warmup steps
_WT_ENV = {"DEAR_CYCLE_TIME_S": "3e-4"}
_SHORT_STEPS = ["--num-warmup-batches", "2", "--num-batches-per-iter", "4",
                "--num-iters", "2"]
#: memory_allocated after the last rebuild against the first plan's
_TUNE_MEM_SLACK = 64 * 2**20


@contextlib.contextmanager
def _environ(values: dict):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _TuneWatch:
    """Wraps `tuning.autotune.AutoTuner.step` and `repack_state` for one
    tuned run: every step launches the K5 epilogue once per bucket of the
    plan it ran on; every rebuild leaves the fp32 masters (by name) and
    the model's buffers bitwise as they were; ``memory_allocated`` at each
    step's start, beside the rebuild count. A failed check raises AND is
    kept in ``failures``, which `_tuned_run` asserts empty after the run:
    the code under test cannot swallow it."""

    def __init__(self, label: str):
        self.label = label
        self.rebuild_checks = self.steps = self.launches = 0
        self.failures: list = []
        self.mem: list = []
        self.shards: set = set()
        self._step, self._repack = TA.AutoTuner.step, TA.repack_state

    def _check(self, ok: bool, msg: str) -> None:
        if not ok:
            self.failures.append(msg)
        _check(ok, msg)

    def __enter__(self):
        watch = self

        def step(at, state, batch):
            # at a step's start the caller holds only the live state
            watch.mem.append((at.rebuilds, torch.cuda.memory_allocated()))
            nb, before = at.ts.plan.num_buckets, FS.fused_update_launches
            out = watch._step(at, state, batch)
            got = FS.fused_update_launches - before
            watch._check(got == nb, f"{watch.label} step "
                         f"{watch.steps + 1}: {got} K5 epilogue launches, "
                         f"the plan has {nb} buckets")
            watch.steps += 1
            watch.launches += got
            return out

        def repack(state, old_ts, new_ts, **kw):
            before = TA._by_name(old_ts, [TA._full(old_ts, s)
                                          for s in state.shards])
            bufs = {n: b.clone() for n, b in old_ts.model.named_buffers()}
            out = watch._repack(state, old_ts, new_ts, **kw)
            after = TA._by_name(new_ts, [TA._full(new_ts, s)
                                         for s in out.shards])
            watch._check(sorted(before) == sorted(after) and all(
                torch.equal(before[n], after[n]) for n in before),
                f"{watch.label}: a rebuild changed the masters")
            watch._check(all(torch.equal(bufs[n], b)
                             for n, b in new_ts.model.named_buffers()),
                         f"{watch.label}: a rebuild changed the model's "
                         "buffers")
            watch.rebuild_checks += 1
            watch.shards |= {b.shard_size for b in new_ts.plan.buckets}
            return out

        TA.AutoTuner.step, TA.repack_state = step, repack
        return self

    def __exit__(self, *exc):
        TA.AutoTuner.step, TA.repack_state = self._step, self._repack

    def check_memory(self, at) -> tuple:
        """(the first plan's memory_allocated, the last plan's): at the
        start of the last step before the first rebuild and of the first
        step after the last."""
        first = [m for r, m in self.mem if r == 0][-1]
        last = [m for r, m in self.mem if r == at.rebuilds][0]
        _check(abs(last - first) <= _TUNE_MEM_SLACK,
               f"{self.label}: memory_allocated {last / 2**20:.1f} MiB after "
               f"the last rebuild, {first / 2**20:.1f} MiB on the first plan")
        return first, last


def _tuned_run(label, main, argv, env, card) -> tuple:
    """One tuned CLI run under a `_TuneWatch`; returns (result, watch)."""
    gc.collect()
    torch.cuda.empty_cache()
    with _environ(env), _TuneWatch(label) as watch:
        res = main(argv + ["--device", _DEV])
    at = res.stepper
    _check(not watch.failures, f"{label}: checks failed {watch.failures}")
    _check(all(np.isfinite(res.losses)), f"{label}: losses {res.losses}")
    _check(watch.rebuild_checks == at.rebuilds,
           f"{label}: {watch.rebuild_checks} checked rebuilds of "
           f"{at.rebuilds}")
    print(f"phase 5n {label} on {card}: {watch.steps} steps, "
          f"{at.rebuilds} rebuilds (masters and buffers bitwise across each), "
          f"K5 epilogue launches {watch.launches} (one per bucket of the "
          f"live plan every step), {res.train_step.plan.num_buckets} "
          "buckets at the end")
    return res, watch


def _bo_trials(at) -> str:
    opt = at.tuner._opt
    return ", ".join(f"{x:.3f} MB: {y * 1e3:.3f} ms"
                     for x, y in zip(opt.xs, opt.ys))


def tune_bo_gpt2(card: str, trace_path: Path) -> dict:
    """GPT-2 through the CLI with ``--autotune bo`` under the tracer (a
    Chrome trace): the watch's checks, the memory bound, the tracer's
    counts against the run's own, K5 at the largest shard any trial
    plan had against its plain version."""
    T.configure(chrome=str(trace_path))
    try:
        res, watch = _tuned_run("gpt2 --autotune bo", train_cli.main,
                                _TUNE_GPT_ARGS + _BO_STEPS
                                + ["--autotune", "bo"], _BO_ENV, card)
        counters = T.get_tracer().counters()
    finally:
        T.disable()
    at = res.stepper
    _check(at.tuner.finished and at.rebuilds >= 2,
           f"gpt2 bo: finished {at.tuner.finished}, {at.rebuilds} rebuilds")
    first, last = watch.check_memory(at)
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans = {}
    for e in events:
        if e["ph"] == "X":
            spans[e["name"]] = spans.get(e["name"], 0) + 1
    want = {"dear.steps": watch.steps, "autotune.rebuilds": at.rebuilds,
            "dear.plan_builds": 1 + at.rebuilds}
    got = {k: counters.get(k) for k in want}
    _check(got == want, f"gpt2 bo tracer counters {got}, the run's {want}")
    _check(spans.get("dear.step") == watch.steps
           and spans.get("autotune.rebuild") == at.rebuilds,
           f"gpt2 bo chrome trace spans {spans}")
    upd_err = check_update_main_path(res.train_step, [max(watch.shards)],
                                     "largest trial shard")
    rebuild_ms = ", ".join(f"{e['dur'] / 1e3:.1f}" for e in events
                           if e["ph"] == "X"
                           and e["name"] == "autotune.rebuild")
    print(f"phase 5n gpt2 bo: rebuilds {rebuild_ms} ms (host, the trace's "
          "autotune.rebuild spans)")
    print(f"phase 5n gpt2 bo: trials {_bo_trials(at)}; adopted "
          f"{at._live_threshold:.3f} MB ({res.train_step.plan.num_buckets} "
          f"buckets); memory_allocated {first / 2**20:.1f} MiB on the first "
          f"plan, {last / 2**20:.1f} MiB after the last rebuild; timed "
          f"{res.iter_time_mean * 1e3:.3f} ms/step; Chrome trace "
          f"{len(events)} events, counters {got}, spans "
          f"{ {k: spans[k] for k in ('dear.step', 'autotune.rebuild')} }")
    at.close()
    return {"launches": watch.launches, "upd_err": upd_err}


def tune_gpt2_others(card: str) -> int:
    """GPT-2 with ``--autotune wait_time``, with ``--mgwfbp`` (prints the
    measured α and β) and with ``--autotune plan`` over the one-rank arms.
    Returns the K5 epilogue launches of their steps."""
    launches = 0
    res, watch = _tuned_run("gpt2 --autotune wait_time", train_cli.main,
                            _TUNE_GPT_ARGS + _SHORT_STEPS
                            + ["--autotune", "wait_time"], _WT_ENV, card)
    _check(res.stepper.rebuilds == 1, "gpt2 wait_time: no split")
    launches += watch.launches
    res.stepper.close()
    del res
    gc.collect()
    before = FS.fused_update_launches
    res = train_cli.main(_TUNE_GPT_ARGS + _SHORT_STEPS
                         + ["--mgwfbp", "--device", _DEV])
    ts = res.train_step
    got = FS.fused_update_launches - before
    _check(ts.update_launches == got == ts.plan.num_buckets * 10,
           f"gpt2 mgwfbp: K5 launches {got}, {ts.plan.num_buckets} buckets")
    launches += got
    alpha, beta = ts.alpha_beta
    ag = overlap.fit_interconnect(backend.group(), device=_DEV)
    print(f"phase 5n gpt2 --mgwfbp on {card}: measured alpha {alpha:.6e} s "
          f"beta {beta:.6e} s/B (the one-rank NCCL all-reduce, 1 KiB to 4 "
          f"MiB); {ts.plan.num_buckets} buckets; "
          f"{res.iter_time_mean * 1e3:.3f} ms/step; the all-gather fit "
          f"(overlap.fit_interconnect, 16 KiB to 1 MiB): alpha {ag[0]:.6e} "
          f"s beta {ag[1]:.6e} s/B")
    ts.close()
    del res, ts
    res, watch = _tuned_run("gpt2 --autotune plan", train_cli.main,
                            _TUNE_GPT_ARGS + _SHORT_STEPS
                            + ["--autotune", "plan"], _PLAN_ENV, card)
    at = res.stepper
    _check(at.planner.finished and at._trial_backup is None,
           "gpt2 plan: the search did not finish")
    _check({k[0] for k in at.planner._obs} == {"dear", "dear-fused"},
           f"gpt2 plan: measured arms {list(at.planner._obs)}")
    obs = "; ".join(f"{'/'.join(str(p) for p in k)} @ {x:.3f} MB: "
                    f"{y * 1e3:.3f} ms" for k, v in at.planner._obs.items()
                    for x, y in v)
    print(f"phase 5n gpt2 plan: trials {obs}; "
          f"adopted {at._live_config.describe()}; timed "
          f"{res.iter_time_mean * 1e3:.3f} ms/step")
    launches += watch.launches
    at.close()
    return launches


def tune_bo_resnet50(card: str) -> int:
    res, watch = _tuned_run("resnet50 --autotune bo", imagenet_cli.main,
                            _RESNET_ARGS[:-6] + _BO_STEPS
                            + ["--autotune", "bo"], _BO_ENV, card)
    at = res.stepper
    _check(at.rebuilds >= 1, "resnet50 bo: no rebuild")
    first, last = watch.check_memory(at)
    print(f"phase 5n resnet50 bo: trials {_bo_trials(at)}; adopted "
          f"{at._live_threshold:.3f} MB ({res.train_step.plan.num_buckets} "
          f"buckets); memory_allocated {first / 2**20:.1f} / "
          f"{last / 2**20:.1f} MiB; BN buffers bitwise across every "
          "rebuild")
    at.close()
    return watch.launches


def _multi_vs_steps(label, make, loss_fn, batch, n=10) -> tuple:
    """One warm step, then ``n`` eager steps, on one model; one warm step,
    then ``multi_step(n)``, on another from the same seed: the last losses,
    the masters and the model's buffers bitwise equal. Returns (eager ms
    per step, multi_step ms per step, K5 launches of both runs)."""
    out = []
    before = FS.fused_update_launches
    for scanned in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        model = make()
        ts = build_train_step(
            loss_fn, model, device=_DEV, threshold_mb=25.0, rng_seed=42,
            optimizer=FS.fused_sgd(lr=0.01, momentum=0.9),
            comm_dtype=torch.bfloat16)
        state, _ = ts.step(ts.init(), batch)
        run = ts.multi_step(n)
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        if scanned:
            state, m = run(state, batch)
        else:
            for _ in range(n):
                state, m = ts.step(state, batch)
        t1.record()
        t1.synchronize()
        out.append((float(m["loss"]), state.step, ts.gather_params(state),
                    {k: b.clone() for k, b in model.named_buffers()},
                    t0.elapsed_time(t1) / n))
        ts.close()
        del model, ts, state
    (la, sa, pa, ba, ms_a), (lb, sb, pb, bb, ms_b) = out
    _check(la == lb and sa == sb == n + 1, f"{label} multi_step({n}): last "
           f"loss {lb} step {sb}, {n} steps: {la} step {sa}")
    _check(all(torch.equal(pa[k], pb[k]) for k in pa)
           and all(torch.equal(ba[k], bb[k]) for k in ba),
           f"{label} multi_step({n}): masters or buffers differ")
    launches = FS.fused_update_launches - before
    print(f"phase 5n {label}: multi_step({n}) bitwise equal to {n} step() "
          f"calls (last loss {la:.6f}, every master and buffer); "
          f"{ms_a:.3f} ms/step eager, {ms_b:.3f} ms/step through multi_step "
          "(CUDA events around the n steps)")
    return ms_a, ms_b, launches


def check_multi_step(card: str) -> int:
    """``multi_step(10)`` against 10 ``step()`` calls on GPT-2 (B = 16,
    S = 1024, bf16, flash, dropout 0.1) and ResNet-50 (B = 64, bf16,
    224², cuDNN deterministic, no autotuning: bitwise needs one algorithm
    per conv). Returns the K5 epilogue launches of both."""
    cfg = gpt_config("gpt2", dtype=torch.bfloat16)
    gpt_batch = synthetic_gpt_batch(
        torch.Generator(device=_DEV).manual_seed(0), 16, seq_len=1024,
        vocab_size=cfg.vocab_size)

    def gpt_loss(m, b, generator):
        return gpt_lm_loss(m(b["input_ids"], train=True,
                             generator=generator), b["input_ids"],
                           vocab_size=cfg.vocab_size)

    cfg_flash = dataclasses.replace(cfg, attention_probs_dropout_prob=0.0)
    _, _, l1 = _multi_vs_steps(
        f"gpt2 (B=16, S=1024, bf16, flash) on {card}",
        lambda: GptLmHeadModel(cfg_flash,
                               attention_impl=flash_causal_attention_impl(),
                               device=_DEV, seed=0),
        gpt_loss, gpt_batch)
    img = synthetic_image_batch(0, 64, image_size=224, dtype=torch.bfloat16,
                                device=_DEV)
    bench, det = torch.backends.cudnn.benchmark, \
        torch.backends.cudnn.deterministic
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
        False, True
    try:
        _, _, l2 = _multi_vs_steps(
            f"resnet50 (B=64, bf16, 224²) on {card}",
            lambda: get_model("resnet50", dtype=torch.bfloat16, device=_DEV,
                              seed=0),
            lambda m, b, generator: softmax_xent(m(b["image"]), b["label"]),
            img)
    finally:
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = \
            bench, det
    return l1 + l2


def tune_and_multi_step(card: str) -> dict:
    """Phase 5n, in one rank on NCCL."""
    out_dir = _ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    bo = tune_bo_gpt2(card, out_dir / "tune_bo_gpt2.trace.json")
    gc.collect()
    launches = bo["launches"] + tune_gpt2_others(card)
    gc.collect()
    launches += tune_bo_resnet50(card)
    gc.collect()
    launches += check_multi_step(card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 5n K5 epilogue launches on the main paths: {launches}")
    return {"launches": launches, "upd_err": bo["upd_err"]}


# ---------------------------------------------------------------------------
# phase 5o: the input pipeline, the harness and the overlap audit (slice 16)
# ---------------------------------------------------------------------------

_PIPE_RESNET_ARGS = ["--model", "resnet50", "--batch-size", "64", "--fp16",
                     "--mode", "dear", "--threshold", "25",
                     "--num-warmup-batches", "5", "--num-batches-per-iter",
                     "10", "--num-iters", "2"]
_PIPE_WARMUP = 5
_PIPE_GPT_ARGS = _REMAT_ARGS[:-6] + _steps(4)
_PIPE_BERT_ARGS = _BERT_FLASH_ARGS + ["--flash-attention"] + _steps(4)
_DRIVER_STEPS = ["--warmup", "2", "--batches", "3", "--iters", "1"]


def _idle_share(step_fn, n: int = 3) -> dict:
    """``torch.profiler`` over ``n`` calls of ``step_fn``: the card's busy
    ms per call against the wall under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    step_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step_fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    return {"busy_ms": busy, "wall_ms": wall,
            "idle": 1 - busy / wall if busy > 0 else None}


def check_native_build() -> str:
    """The producer library is the port's own build: its source is the
    package's ``csrc/dear_runtime.cpp`` and the loaded file is the one
    named by that source's digest under ``build/runtime/``."""
    from dear_pytorch_tpu_torch.runtime import build as RB

    lib = RB.load()
    _check(lib is not None, f"native pipeline library: {RB.load_error()}")
    want_src = _ROOT / "dear_pytorch_tpu_torch" / "csrc" / "dear_runtime.cpp"
    tag = hashlib.sha256(want_src.read_bytes()).hexdigest()[:12]
    so = RB.library_path()
    _check(RB.SOURCE.resolve() == want_src.resolve() and so.exists()
           and Path(lib._name).resolve() == so.resolve()
           and so.name == f"dear_runtime_{tag}.so",
           f"native library {lib._name} is not the build of {want_src}")
    print(f"phase 5o native producer library: {so.relative_to(_ROOT)} "
          f"(g++ of {want_src.relative_to(_ROOT)}, sha256 tag {tag})")
    return str(so)


def _pipe_run(label, argv):
    """One ImageNet CLI run of ResNet-50 (``_PIPE_RESNET_ARGS`` + argv),
    every step's K5 epilogue launches checked. Returns (result, launches,
    step ms after the warmup)."""
    FS.fused_update_launches = 0
    marks, prev = [], {}

    def on_step(ts, state, metrics):
        del state, metrics
        now = FS.fused_update_launches
        _check(now - prev.get("n", 0) == ts.plan.num_buckets,
               f"{label} step {len(marks) + 1}: {now - prev.get('n', 0)} "
               f"K5 epilogue launches, expected {ts.plan.num_buckets}")
        prev["n"] = now
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    res = imagenet_cli.main(_PIPE_RESNET_ARGS + argv + ["--device", _DEV],
                            on_step=on_step)
    torch.cuda.synchronize()
    _check(all(np.isfinite(res.losses)), f"{label}: losses {res.losses}")
    step_ms = [a.elapsed_time(b) for a, b in
               zip(marks[_PIPE_WARMUP - 1:-1], marks[_PIPE_WARMUP:])]
    return res, FS.fused_update_launches, step_ms


def pipeline_resnet50(card: str) -> dict:
    """Phase 5o (i): ResNet-50 on streamed native batches against the
    constant batch, in one process."""
    from dear_pytorch_tpu_torch.benchmarks import runner
    from dear_pytorch_tpu_torch.runtime import pipeline as RP

    spec = RP.image_spec(64)
    # the producers' own rate: a fresh pipeline drained with nothing else
    # running (each next() also copies the batch out of its slot)
    with RP.Pipeline(spec) as pl:
        pl.next()
        t0 = time.perf_counter()
        for _ in range(20):
            pl.next()
        prod_s = (time.perf_counter() - t0) / 20
        host = [pl.next() for _ in range(6)]
    # the host cast to bf16 / int64 into pinned memory and the enqueued
    # copy, per batch (the consumer's part of a streamed step)
    stager = runner.PinnedStager(_DEV)
    dtypes = {"image": torch.bfloat16, "label": torch.int64}
    stager(host[0], dtypes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for h in host[1:]:
        stager(h, dtypes)
    stage_s = (time.perf_counter() - t0) / (len(host) - 1)
    torch.cuda.synchronize()
    runs = {}
    for label, argv in (("native", ["--pipeline", "native"]),
                        ("none", ["--pipeline", "none"])):
        res, launches, step_ms = _pipe_run(f"resnet50 --pipeline {label}",
                                           argv)
        ts, holder = res.train_step, {"state": res.state}
        if label == "native":
            _check(type(res.pipeline) is RP.Pipeline,
                   f"--pipeline native drove {type(res.pipeline).__name__}")
            produced = res.pipeline.produced
            # a short trace of streamed steps, from a pipeline of its own
            tl = RP.Pipeline(spec, seed=1)
            st = runner.PinnedStager(_DEV)
            bdt = {k: v.dtype for k, v in res.batch.items()}

            def step(tl=tl, st=st, bdt=bdt, ts=ts, holder=holder):
                b = runner.stage_global(tl.next(), st, bdt)
                b["image"] = b["image"].permute(0, 3, 1, 2)
                holder["state"], _ = ts.step(holder["state"], b)
        else:
            produced = None

            def step(ts=ts, holder=holder, b=res.batch):
                holder["state"], _ = ts.step(holder["state"], b)
        idle = _idle_share(step)
        if label == "native":
            tl.close()
        p50, p99 = (float(np.percentile(step_ms, q)) for q in (50, 99))
        runs[label] = {"p50": p50, "p99": p99, "img_s": res.total_mean,
                       "launches": launches, "idle": idle,
                       "produced": produced, "steps": len(step_ms)}
        print(f"phase 5o resnet50 --pipeline {label} (bf16, B=64, 224², "
              f"{len(step_ms)} timed steps) on {card}: p50 {p50:.3f} ms "
              f"p99 {p99:.3f} ms; {res.total_mean:.1f} img/s (the CLI's "
              f"timed mean); traced idle {idle['idle']:.1%} (busy "
              f"{idle['busy_ms']:.3f} of {idle['wall_ms']:.3f} ms a step "
              f"under the profiler)"
              + (f"; {produced} batches produced" if produced else ""))
        ts.close()
        del res, ts, holder, step
        gc.collect()
        torch.cuda.empty_cache()
    native, none = runs["native"], runs["none"]
    prod_ms, stage_ms = prod_s * 1e3, stage_s * 1e3
    slower = native["p50"] - none["p50"]
    if prod_ms >= 0.9 * native["p50"]:
        pace = "the producers"
    elif slower > 0.05 * none["p50"] and slower >= 0.5 * stage_ms:
        pace = "the host cast and staging (main thread)"
    else:
        pace = "the step"
    print(f"phase 5o pipeline pace on {card}: producers {prod_ms:.3f} ms a "
          f"batch ({1e3 / prod_ms:.1f} batches/s, 2 threads, drained alone; "
          f"{64e3 / prod_ms:.1f} img/s), host cast + pinned staging "
          f"{stage_ms:.3f} ms a batch, step p50 native {native['p50']:.3f} "
          f"against none {none['p50']:.3f} ms ({slower:+.3f} ms): the pace "
          f"is set by {pace}")
    return {"runs": runs, "producer_ms": prod_ms, "stage_ms": stage_ms,
            "pace": pace,
            "launches": native["launches"] + none["launches"]}


def pipeline_gpt2_numpy(card: str) -> dict:
    """Phase 5o (ii): GPT-2 with ``--pipeline numpy``; its first three
    staged batches, read back, byte-identical to a NumpyPipeline of the
    same seed (int32 ids cast to the constant batch's int64)."""
    from dear_pytorch_tpu_torch.benchmarks import runner
    from dear_pytorch_tpu_torch.runtime import pipeline as RP

    staged = []
    orig = runner.stage_global

    def recording(*a, **k):
        out = orig(*a, **k)
        if len(staged) < 3:
            staged.append({n: t.cpu().numpy() for n, t in out.items()})
        return out

    runner.stage_global = recording
    try:
        r = _run_comp(train_cli.main, _PIPE_GPT_ARGS + ["--pipeline",
                                                        "numpy"],
                      "gpt2 --pipeline numpy", GPT2_SMALL.num_hidden_layers)
    finally:
        runner.stage_global = orig
    r.pop("result").train_step.close()
    ref = RP.NumpyPipeline(RP.gpt_spec(16, 1024, vocab=GPT2_SMALL.vocab_size),
                           seed=0)
    for i, got in enumerate(staged):
        want = ref.next()["input_ids"].astype(np.int64)
        _check(got["input_ids"].dtype == np.int64
               and got["input_ids"].tobytes() == want.tobytes(),
               f"gpt2 --pipeline numpy: staged batch {i} differs from "
               "NumpyPipeline's")
    _check(len(staged) == 3, f"gpt2 numpy: {len(staged)} batches staged")
    print(f"phase 5o gpt2 --pipeline numpy on {card}: the first 3 staged "
          f"batches (16 x 1024 int64, read back) byte-identical to "
          f"NumpyPipeline(seed 0); step p50 "
          f"{float(np.percentile(r['step_ms'], 50)):.3f} ms; losses "
          f"{[round(x, 4) for x in r['losses']]}")
    return r


def pipeline_bert_flash(card: str) -> dict:
    """Phase 5o (iii): BERT-Base with ``--flash-attention --pipeline
    native``: K1-K3 12 a step each on their tensor-core routes."""
    r = _run_comp(bert_cli.main, _PIPE_BERT_ARGS + ["--pipeline", "native"],
                  "bert_base flash --pipeline native",
                  BERT.BERT_BASE.num_hidden_layers)
    res = r.pop("result")
    from dear_pytorch_tpu_torch.runtime import pipeline as RP

    _check(type(res.pipeline) is RP.Pipeline, "bert: not the native pipeline")
    res.train_step.close()
    print(f"phase 5o bert_base flash --pipeline native on {card}: step p50 "
          f"{float(np.percentile(r['step_ms'], 50)):.3f} ms; launches "
          f"{r['launches']}")
    return r


def run_driver(card: str, out: Path) -> dict:
    """Phase 5o (iv): the sweep driver over resnet50:64 — dear and
    allreduce at one rank (NCCL), dear-fused at two ranks sharing the card
    (gloo and the ring kernels) — with ``DEAR_TELEMETRY=1`` in the cells'
    environment: every cell's result and telemetry in its reports.json.
    Returns the kernels' launches from the cells' telemetry (rank 0's)."""
    env = dict(os.environ, DEAR_TELEMETRY="1")
    got = {}
    for sub, methods, n in (("one_rank", "dear,allreduce", "1"),
                            ("two_ranks", "dear-fused", "2")):
        logdir = out / sub
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dear_pytorch_tpu_torch.benchmarks.driver",
             "--logdir", str(logdir), "--tasks", "resnet50:64",
             "--methods", methods, "--nworkers", n, "--timeout", "300",
             "--extra-args=--fp16"] + _DRIVER_STEPS,
            cwd=_ROOT, env=env, capture_output=True, text=True, timeout=700)
        for line in proc.stdout.strip().splitlines():
            print(f"  driver: {line[:200]}")
        _check(proc.returncode == 0, f"driver exited {proc.returncode}: "
               f"{proc.stderr[-2000:]}")
        rep = json.loads((logdir / "reports.json").read_text())
        tel = rep["telemetry"]
        for m in methods.split(","):
            tag = f"resnet50-bs64-{m}-n{n}"
            cell = rep["resnet50"][m][n]
            snap = tel["per_cell"].get(tag)
            if cell is None or snap is None:
                print((logdir / f"{tag}.log").read_text()[-3000:])
            _check(cell is not None and snap is not None
                   and snap["enabled"] is True,
                   f"driver: cell {tag} has no result or no telemetry")
            got[tag] = {"img_s": cell[0], "ci": cell[1],
                        "counters": snap["counters"]}
        _check(tel["cells_failed"] == 0, f"driver: failed cells {tel}")
        print(f"phase 5o driver ({methods}, {n} rank(s)"
              + (" sharing the card" if n == "2" else ", NCCL")
              + f") on {card}: {time.perf_counter() - t0:.1f} s; "
              + "; ".join(f"{t} {v['img_s']} +-{v['ci']} img/s"
                          for t, v in got.items() if f"-n{n}" in t))
    c = {t: v["counters"] for t, v in got.items()}
    launches = {
        "fused_update": sum(v.get("kernel.fused_update_launches", 0)
                            for v in c.values()),
        "ring_rs": c["resnet50-bs64-dear-fused-n2"].get(
            "kernel.fused_rs_launches", 0),
        "ring_ag": c["resnet50-bs64-dear-fused-n2"].get(
            "kernel.ring_ag_launches", 0)}
    _check(launches["ring_rs"] > 0 and launches["ring_ag"] > 0
           and launches["fused_update"] > 0,
           f"driver cells launched no kernel: {launches}")
    print(f"phase 5o driver launches from the cells' telemetry (rank 0's): "
          f"{launches}")
    return {"cells": got, "launches": launches}


def run_collectives_scaling(card: str) -> int:
    """Phase 5o (v): ``collectives`` at world 1 on NCCL, and ``scaling
    --worlds 1`` (ResNet-50, bf16, B = 64). Returns the K5 epilogue's
    launches."""
    from dear_pytorch_tpu_torch.benchmarks import collectives as BC
    from dear_pytorch_tpu_torch.benchmarks import scaling as BS

    out = BC.main(["--sizes-log2", "12:27:2", "--repeats", "5",
                   "--collectives", "all_reduce,reduce_scatter,all_gather"])
    _check(out["backend"] == "nccl" and out["world"] == 1,
           f"collectives ran on {out['backend']} at {out['world']}")
    for name, c in out["collectives"].items():
        _check(all(r["time_s"] > 0 for r in c["rows"]), f"{name}: no time")
        top = c["rows"][-1]
        print(f"phase 5o collectives {name} (NCCL, world 1) on {card}: alpha "
              f"{c['alpha_s']:.3e} s, beta {c['beta_s_per_byte']:.3e} s/B; "
              f"{top['bytes']} B in {top['time_s'] * 1e6:.1f} us "
              f"({top['bw_gbs']:.2f} GB/s)")
    FS.fused_update_launches = 0
    sc = BS.main(["--model", "resnet50", "--batch-size", "64", "--fp16",
                  "--worlds", "1", "--num-warmup-batches", "3",
                  "--num-batches-per-iter", "5", "--num-iters", "2"])
    _check(sc["efficiency"] == {1: 1.0} and sc["per_device_img_sec"][1] > 0,
           f"scaling: {sc}")
    print(f"phase 5o scaling --worlds 1 on {card}: "
          f"{sc['per_device_img_sec'][1]:.1f} img/s per rank")
    return FS.fused_update_launches


def run_report(card: str, out: Path) -> dict:
    """Phase 5o (vi): the overlap report, dear and allreduce, at two ranks
    sharing the card (gloo, host-staged): the efficiency and the timeline's
    overlap shares."""
    path = out / "overlap.json"
    proc = subprocess.run(
        [sys.executable, "-m", "dear_pytorch_tpu_torch.observability.report",
         "--modes", "dear,allreduce", "--world", "2", "--layers", "4",
         "--width", "1024", "--batch", "64", "--steps", "10",
         "--json", str(path)],
        cwd=_ROOT, capture_output=True, text=True, timeout=600)
    for line in proc.stdout.strip().splitlines():
        print(f"  report: {line[:200]}")
    _check(proc.returncode == 0, f"report exited {proc.returncode}: "
           f"{proc.stderr[-3000:]}")
    doc = json.loads(path.read_text())
    _check(doc["world"] == 2 and set(doc["modes"]) == {"dear", "allreduce"},
           f"report: {doc.keys()}")
    for mode, rep in doc["modes"].items():
        tl = rep["timeline"]
        _check(tl is not None and tl["collective_s_per_step"] > 0,
               f"report {mode}: no traced collective")
        eff = rep["overlap_efficiency"]
        print(f"phase 5o overlap report {mode} (two ranks sharing the card, "
              f"gloo; MLP 4 x 1024², B = 32 per rank) on {card}: measured "
              f"{rep['measured_step_s'] * 1e3:.3f} ms, compute "
              f"{rep['compute_time_s'] * 1e3:.3f} ms, comm (alpha-beta) "
              f"{rep['comm_time_s'] * 1e3:.3f} ms, efficiency "
              + ("n/a" if eff is None else f"{eff:.3f}")
              + f"; timeline ({tl['source']}): collectives "
              f"{tl['collective_s_per_step'] * 1e3:.3f} ms a step, overlap "
              f"share {tl['overlap_share']}; by leg "
              + ", ".join(f"{k} {v['overlap_share']}"
                          for k, v in tl["legs"].items()))
    launches = doc["telemetry"]["counters"].get(
        "kernel.fused_update_launches", 0)
    _check(launches > 0, "report: no K5 epilogue launch")
    return {"doc": doc, "launches": launches}


def check_resnet_remat_cli(card: str) -> dict:
    """Phase 5o (vii): ResNet-50 ``--remat-policy full`` through the CLI
    with the CLI's own cuDNN settings (benchmark mode on; convs timed by
    earlier phases of this process), against the run without, and a
    second run without: the losses, the BN buffers after steps 1 and 3 and
    the parameters after step 3 bitwise equal."""
    _check(torch.backends.cudnn.enabled, "cuDNN is off")
    runs, bufs, params = {}, {}, {}
    for key, policy in (("none", "none"), ("full", "full"),
                        ("none again", "none")):
        def first(ts, key=key):
            bufs[key, 1] = {n: b.detach().clone() for n, b in
                            ts.model.named_buffers()}

        r = _run_comp(imagenet_cli.main, _RESNET_ARGS[:-6] + _steps(3)
                      + ["--remat-policy", policy],
                      f"one rank resnet50 --remat-policy {policy} (cuDNN "
                      "benchmark)", on_first=first)
        res = r.pop("result")
        _check(torch.backends.cudnn.benchmark, "the CLI left benchmark off")
        bufs[key, 3] = {n: b.detach().clone() for n, b in
                        res.train_step.model.named_buffers()}
        params[key] = res.train_step.gather_params(res.state)
        res.train_step.close()
        runs[key] = r

    def same(a, b):
        return all(torch.equal(a[n], x) for n, x in b.items())

    checks = {"losses": runs["full"]["losses"] == runs["none"]["losses"],
              "BN buffers after step 1": same(bufs["full", 1],
                                              bufs["none", 1]),
              "BN buffers after step 3": same(bufs["full", 3],
                                              bufs["none", 3]),
              "parameters after step 3": same(params["full"],
                                              params["none"]),
              "control (a second run without)": same(params["none again"],
                                                     params["none"])}
    print(f"phase 5o resnet50 --remat-policy full under the CLI's cuDNN "
          f"settings (benchmark {torch.backends.cudnn.benchmark}, "
          f"deterministic {torch.backends.cudnn.deterministic}) against the "
          f"run without, bitwise: {checks}; losses {runs['full']['losses']}")
    _check(all(checks.values()), "resnet50 remat under cuDNN benchmark mode "
           f"is not the run without remat: {checks}")
    return {k: v for k, v in runs.items()}


#: the telemetry-off line's timed iterations of 10 steps per model
_BENCH_OFF_ITERS = 1


def bench_telemetry(card: str, line_on: dict) -> dict:
    """Phase 5o (viii): the bench line with ``DEAR_TELEMETRY=0`` beside
    phase 5g's default (counters on): both telemetry blocks, and each
    metric's value on and off. The off line times `_BENCH_OFF_ITERS`
    iterations of 10 steps per model, not 10, for the script's time
    limit; its values are means per step all the same."""
    _check(line_on.get("telemetry", {}).get("enabled") is True
           and line_on["telemetry"]["counters"].get("dear.steps", 0) > 0
           and "spans" not in line_on["telemetry"],
           f"bench: the default line's telemetry block {line_on.get('telemetry')}")
    gc.collect()
    torch.cuda.empty_cache()
    line_off = run_bench(card, telemetry="0", iters=_BENCH_OFF_ITERS)
    _check(line_off["telemetry"] == {"enabled": False, "counters": {}},
           f"bench DEAR_TELEMETRY=0: {line_off['telemetry']}")
    on = {m["metric"]: m["value"] for m in [line_on]
          + line_on["extra_metrics"]}
    off = {m["metric"]: m["value"] for m in [line_off]
           + line_off["extra_metrics"]}
    for k in on:
        print(f"phase 5o bench {k} on {card}: telemetry on (counters only) "
              f"{on[k]}, off {off[k]} ({on[k] / off[k] - 1:+.2%})")
    return {"on": on, "off": off}


def harness_phase(card: str, bench_line: dict) -> dict:
    """Phase 5o: (i)-(viii) above; returns the launches it made."""
    out = _ROOT / "build" / "chip_smoke" / "harness"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    check_native_build()
    FA.reset_launch_counts()
    pipe = pipeline_resnet50(card)
    gpt = pipeline_gpt2_numpy(card)
    bert = pipeline_bert_flash(card)
    drv = run_driver(card, out)
    scaling_update = run_collectives_scaling(card)
    rep = run_report(card, out)
    remat = check_resnet_remat_cli(card)
    tel = bench_telemetry(card, bench_line)
    routes = {w: {route: gpt["routes"][w][route] + bert["routes"][w][route]
                  for route in gpt["routes"][w]}
              for w in ("fwd", "dq", "dkv")}
    update = (pipe["launches"] + gpt["launches"]["fused_update"]
              + bert["launches"]["fused_update"]
              + drv["launches"]["fused_update"] + scaling_update
              + rep["launches"]
              + sum(r["launches"]["fused_update"] for r in remat.values()))
    print(f"phase 5o launches: K1-K3 by route {routes}, the K5 epilogue "
          f"{update}, K4 {drv['launches']['ring_ag']}, the K5 ring "
          f"{drv['launches']['ring_rs']} (the driver cell's rank 0)")
    return {"routes": routes, "update": update,
            "ring_ag": drv["launches"]["ring_ag"],
            "ring_rs": drv["launches"]["ring_rs"], "pipe": pipe,
            "telemetry": tel}


# ---------------------------------------------------------------------------
# phase 5p: checkpoints and the guarded trainer
# ---------------------------------------------------------------------------

#: GPT-2 small at full width through the GPT CLI's own builders (its
#: parser, `runner.config_from_args`, `runner.build_stepper`): bf16,
#: --flash-attention, dear, B = 16, S = 1024, SGD momentum 0.9
_GUARD_GPT_ARGS = ["--model", "gpt2", "--fp16", "--flash-attention",
                   "--dropout0", "--batch-size", "16", "--sequence-len",
                   "1024", "--base-lr", "0.01", "--momentum", "0.9",
                   "--threshold", "25"]
_GUARD_FAULTS = "nan@6,exc@9,ckpt_corrupt@12,preempt@15"
_GUARD_EVERY = 4
#: both processes step the run this far past the emergency step
_GUARD_ON = 3
#: the smaller runs of (iii): two layers, B = 4 per rank
_GUARD_SMALL = ["--num-hidden-layers", "2", "--batch-size", "4"]
_GUARD_RANK_CASES = {
    # name: (mode, faults, shared storage, DEAR_SDC, attempts)
    "nan_r1": ("dear", "nan@3:r1", True, False, 5),
    "per_host": ("dear", "ckpt_corrupt@5:r0,nan@5", False, False, 6),
    # the vote needs three voters (resilience/sdc.py: two can only see a
    # desync), and replicas to vote on: a replicated mode, the flip on
    # rank 0's replica only
    "flip": ("allreduce", "flip@5:0:r0", True, True, 8),
}
#: the spawns of (iii): (world, cases run in turn by every rank)
_GUARD_SPAWNS = ((2, ("nan_r1", "per_host")), (3, ("flip",)))


def _guard_gpt_step(extra=()):
    """(train step, batch, model config) of the GPT CLI's builders over
    ``_GUARD_GPT_ARGS`` + ``extra`` on this process's group."""
    from dear_pytorch_tpu_torch.benchmarks import runner

    args = train_cli.build_parser().parse_args(
        _GUARD_GPT_ARGS + list(extra) + ["--device", _DEV])
    group = backend.init(_DEV)
    dev, world, rank = backend.device(), backend.size(), backend.rank()
    cfg = dropout_free(gpt_config(args.model, dtype=torch.bfloat16))
    if args.num_hidden_layers is not None:
        cfg = dataclasses.replace(cfg,
                                  num_hidden_layers=args.num_hidden_layers)
    model = GptLmHeadModel(cfg, attention_impl=flash_causal_attention_impl(),
                           device=dev, seed=0)
    B = args.batch_size
    batch = synthetic_gpt_batch(
        torch.Generator(device=dev).manual_seed(0), B * world,
        seq_len=args.sequence_len, vocab_size=cfg.vocab_size)
    batch = {k: v[rank * B:(rank + 1) * B] for k, v in batch.items()}

    def loss_fn(m, b, generator):
        return gpt_lm_loss(m(b["input_ids"], train=True,
                             generator=generator),
                           b["input_ids"], vocab_size=cfg.vocab_size)

    ts, _ = runner.build_stepper(runner.config_from_args(args, world=world),
                                 loss_fn, model, group=group, device=dev)
    return ts, batch, cfg


def _state_digest(state) -> str:
    """sha256 over the masters' and the per-element optimizer state's
    bytes, bucket by bucket, and the step."""
    h = hashlib.sha256()
    tensors = list(state.shards) + [v for o in state.opt_state
                                    for v in o.values() if torch.is_tensor(v)]
    for t in tensors:
        h.update(t.detach().reshape(-1).view(torch.uint8).cpu().numpy()
                 .tobytes())
    h.update(str(int(state.step)).encode())
    return h.hexdigest()


def _equal_to_disk(state, directory: str, step: int) -> bool:
    """The live masters and optimizer state equal, bitwise, the blob of
    step ``step`` read back from disk."""
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt

    saved = ckpt._read_rank(os.path.join(directory, f"step_{step:010d}"),
                            backend.rank())
    ok = int(saved["step"]) == int(state.step) == step
    for g, s in enumerate(state.shards):
        ok &= torch.equal(saved[f"shards.{g}"], s.cpu())
        for k, v in state.opt_state[g].items():
            if torch.is_tensor(v):
                ok &= torch.equal(saved[f"opt.{g}.{k}"], v.cpu())
    return bool(ok)


def _wall(fn):
    """(result, host ms) of ``fn()`` between two card synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _step_ms(step, n):
    """``n`` calls of ``step()`` timed by CUDA events: the ms of each."""
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    evs[0].record()
    for i in range(n):
        step()
        evs[i + 1].record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(evs[:-1], evs[1:])]


def _guard_counts() -> dict:
    return {"flash_fwd_tc": FA.flash_fwd_route_launches["tensor_core"],
            "flash_bwd_dq_tc": FA.flash_bwd_route_launches["dq"][
                "tensor_core"],
            "flash_bwd_dkv_tc": FA.flash_bwd_route_launches["dkv"][
                "tensor_core"],
            "fused_update": FS.fused_update_launches}


def guard_gpt2(card: str, work: Path) -> dict:
    """(i): GPT-2 small at full width under `GuardedTrainer` with
    ``_GUARD_FAULTS``, async checkpoints every ``_GUARD_EVERY`` attempts;
    the timings; every rollback's masters against the step read back; an
    async save held against the next step's in-place update; a second
    process resumed from the emergency step against this
    one. Returns the launches of the guarded run."""
    from dear_pytorch_tpu_torch.resilience import inject as INJ
    from dear_pytorch_tpu_torch.resilience.preempt import PreemptionHandler
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt
    from dear_pytorch_tpu_torch.utils.guard import GuardedTrainer

    ts, batch, cfg = _guard_gpt_step()
    layers, nb = cfg.num_hidden_layers, ts.plan.num_buckets
    state = ts.init()
    holder = {"state": state}

    def bare():
        holder["state"], _ = ts.step(holder["state"], batch)

    bare_ms = _step_ms(bare, 8)
    state = holder["state"]
    # the async hazard on the card: the writer is held back while the next
    # step updates the masters in place; the file holds step k's bytes
    timing = work / "timing"
    want = _state_digest(state)
    k = int(state.step)
    ac = ckpt._get_async_checkpointer()
    ac.hold = __import__("threading").Event()
    try:
        _, async_ms = _wall(lambda: ckpt.save_checkpoint(
            str(timing), state, ts, asynchronous=True))
        state, _ = ts.step(state, batch)
        torch.cuda.synchronize()
    finally:
        ac.hold.set()
        ac.hold = None
    ckpt.wait_for_checkpoints()
    saved = ckpt._read_rank(str(timing / f"step_{k:010d}"), 0)
    h = hashlib.sha256()
    for g in range(nb):
        h.update(saved[f"shards.{g}"].reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    for g in range(nb):
        for key in ts.last_state.opt_state[g]:
            if torch.is_tensor(ts.last_state.opt_state[g][key]):
                h.update(saved[f"opt.{g}.{key}"].reshape(-1)
                         .view(torch.uint8).numpy().tobytes())
    h.update(str(k).encode())
    _check(h.hexdigest() == want,
           f"async save at step {k}: the file does not hold step {k}'s "
           "masters after step k+1 updated them in place")
    t0 = time.perf_counter()
    _check(ckpt.write_manifest(str(timing), k), "manifest backfill")
    sha_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(e["bytes"] for e in
                 ckpt.read_sidecar(str(timing), k)["manifest"].values())
    _, sync_ms = _wall(lambda: ckpt.save_checkpoint(str(timing), state, ts))
    state, restore_ms = _wall(lambda: ckpt.restore_checkpoint(
        str(timing), ts, step=int(state.step)))
    _check(_equal_to_disk(state, str(timing), int(state.step)),
           "restore: the masters differ from the step on disk")
    print(f"phase 5p (i) checkpoint of GPT-2 small ({nbytes / 2**20:.1f} "
          f"MiB: fp32 masters and momentum) on {card}: sync save "
          f"{sync_ms:.1f} ms, async save's blocking part {async_ms:.1f} ms, "
          f"restore {restore_ms:.1f} ms, sha256 manifest {sha_ms:.1f} ms")

    # the guarded run, from a fresh step count of attempts
    gdir = str(work / "guard")
    restored, checks = [], []

    def on_rollback(recoveries, at):
        restored.append(at)

    saves = []                          # (asynchronous, host ms) per save
    plain_save = ckpt.save_checkpoint

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        out = plain_save(*a, **kw)
        saves.append((kw.get("asynchronous", False),
                      (time.perf_counter() - t0) * 1e3))
        return out

    FA.reset_launch_counts()            # the guarded path starts here
    FS.fused_update_launches = 0
    dispatched, guard_ms, preempted = 0, [], None
    ckpt.save_checkpoint = timed_save
    with PreemptionHandler() as pre:
        guard = GuardedTrainer(
            ts, gdir, check_every=1, checkpoint_every=_GUARD_EVERY,
            async_checkpoints=True, preemption=pre, on_rollback=on_rollback,
            injector=INJ.FaultInjector(INJ.parse_faults(_GUARD_FAULTS)))
        for _ in range(20):
            before = FS.fused_update_launches
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            state, m = guard.step(state, batch)
            ev1.record()
            ran = FS.fused_update_launches - before
            dispatched += ran // nb
            if m.get("rolled_back"):
                checks.append(_equal_to_disk(state, gdir, restored[-1]))
            elif ran:
                torch.cuda.synchronize()
                guard_ms.append(ev0.elapsed_time(ev1))
            if m.get("preempted"):
                preempted = m.get("preempt_checkpoint_step")
                break
        guard.finalize()
    ckpt.save_checkpoint = plain_save
    launches = _guard_counts()          # ... and ends here
    want_launches = {"flash_fwd_tc": layers * dispatched,
                     "flash_bwd_dq_tc": layers * dispatched,
                     "flash_bwd_dkv_tc": layers * dispatched,
                     "fused_update": nb * dispatched}
    _check(launches == want_launches,
           f"guarded run: launches {launches}, expected {want_launches} "
           f"({dispatched} dispatched steps)")
    _check(len(restored) == 2 and all(checks),
           f"guarded run: restored {restored}, masters equal to the disk "
           f"{checks}")
    _check(preempted is not None and preempted == int(state.step)
           and ckpt.verify_checkpoint(gdir, preempted),
           f"preemption: emergency step {preempted}")
    valid = ckpt.valid_steps(gdir)
    _check(valid and valid[0] == preempted,
           f"valid steps {valid}, emergency step {preempted}")
    print(f"phase 5p (i) guarded run: restored steps {restored} (each "
          f"equal to its step on disk), emergency step {preempted}, valid "
          f"steps {valid}, {dispatched} dispatched steps; launches "
          f"{launches}; its saves' host ms (async: the blocking part, "
          f"which waits for the previous write): "
          f"{[(('async' if a else 'sync'), round(ms, 1)) for a, ms in saves]}")
    # this process on past the emergency step; a second process resumes
    # from it (`finish_resume` holds the two)
    n = preempted + _GUARD_ON
    while int(state.step) < n:
        state, _ = ts.step(state, batch)
    mine = _state_digest(state)
    del state, batch, guard
    ts.close()
    del ts
    gc.collect()
    torch.cuda.empty_cache()
    out = work / "resume.json"
    log = open(work / "resume.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--guard-resume",
         gdir, "--out", str(out), "--steps", str(n)], cwd=_ROOT,
        stdout=log, stderr=subprocess.STDOUT)
    log.close()
    bp50, gp50 = (float(np.percentile(x, 50)) for x in (bare_ms, guard_ms))
    print(f"phase 5p (i) GPT-2 small step (bf16, B=16, S=1024) on {card}: "
          f"bare p50 {bp50:.3f} ms ({len(bare_ms)} steps), under the guard "
          f"p50 {gp50:.3f} ms ({len(guard_ms)} steps that ran a train "
          "step; check_every=1: one loss fetch a step)")
    return launches, (proc, out, preempted, n, mine)


def finish_resume(card: str, resume) -> None:
    """(i)'s end: the second process, resumed from the emergency step,
    reached step n bitwise equal to this process."""
    proc, out, preempted, n, mine = resume
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode:
        print((out.parent / "resume.log").read_text()[-8000:])
    _check(proc.returncode == 0, "the resumed process failed")
    other = json.loads(out.read_text())
    _check(other["from"] == preempted and other["digest"] == mine,
           f"resumed process: from step {other['from']}, digest at step "
           f"{n} {other['digest'][:16]} vs this process's {mine[:16]}")
    print(f"phase 5p (i) resumed process on {card}: from the emergency step "
          f"{preempted} to step {n}, masters and momentum bitwise equal to "
          f"this process's at step {n}")


def guard_resume_worker(directory: str, out: Path, n: int) -> None:
    """The second process of (i) (``--guard-resume DIR --out FILE --steps
    N``): the same train step, restored from the newest verified step in
    DIR, on to step N; its start and digest into FILE."""
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ts, batch, _ = _guard_gpt_step()
    step = ckpt.latest_valid_step(directory)
    state = ckpt.restore_checkpoint(directory, ts, step=step,
                                    template=ts.init())
    while int(state.step) < n:
        state, _ = ts.step(state, batch)
    out.write_text(json.dumps({"from": step,
                               "digest": _state_digest(state)}))
    ts.close()
    backend.shutdown()


def guard_resnet50(card: str, work: Path) -> dict:
    """(ii): ResNet-50 through the ImageNet CLI's builders (bf16, B = 64,
    224², dear, its BN buffers): 3 steps, a checkpoint, 3 more; then a
    fresh model and step restored from it, 3 steps: the masters, momentum
    and every buffer bitwise equal. Returns the K5 epilogue's launches."""
    from dear_pytorch_tpu_torch.benchmarks import runner
    from dear_pytorch_tpu_torch.utils import checkpoint as ckpt

    args = imagenet_cli.build_parser().parse_args(
        _RESNET_ARGS + ["--device", _DEV])
    group = backend.init(_DEV)
    torch.backends.cudnn.benchmark = True

    def build():
        model, loss_fn, batch, *_ = imagenet_cli.setup_cnn(
            args, 1, backend.device())
        ts, _ = runner.build_stepper(runner.config_from_args(args, world=1),
                                     loss_fn, model, group=group,
                                     device=backend.device())
        return ts, batch

    def image(ts, state):
        return _state_digest(state) + hashlib.sha256(b"".join(
            b.detach().reshape(-1).view(torch.uint8).cpu().numpy()
            .tobytes() for _, b in ts.model.named_buffers())).hexdigest()

    d = str(work / "resnet")
    FS.fused_update_launches = 0          # the path starts here
    ts, batch = build()
    state = ts.init()
    for i in range(6):
        state, _ = ts.step(state, batch)
        if i == 2:
            ckpt.save_checkpoint(d, state, ts)
    want = image(ts, state)
    nb = ts.plan.num_buckets
    ts.close()
    ts, batch = build()
    state = ckpt.restore_checkpoint(d, ts, template=ts.init())
    _check(int(state.step) == 3, f"resnet restore at {state.step}")
    for _ in range(3):
        state, _ = ts.step(state, batch)
    got = image(ts, state)
    n_bufs = sum(1 for _ in ts.model.buffers())
    ts.close()
    launches = FS.fused_update_launches   # ... and ends here
    _check(launches == 9 * nb, f"resnet: {launches} K5 epilogue launches, "
           f"expected {9 * nb}")
    _check(got == want, "resnet: the resumed steps differ from the "
           "uninterrupted ones")
    print(f"phase 5p (ii) ResNet-50 (bf16, B=64, {nb} buckets, {n_bufs} "
          f"buffers) on {card}: 3 steps, a checkpoint, a fresh step "
          "restored from it and 3 more: masters, momentum and BN buffers "
          "bitwise equal to 6 uninterrupted steps")
    return {"fused_update": launches}


def guard_rank_worker(rank: int, world: int, out: Path, cases) -> None:
    """One rank of (iii) (``--guard-rank R --world W --out DIR --cases
    C1,C2``): each case of `_GUARD_RANK_CASES` in turn, under
    `GuardedTrainer`, over one gloo group of ranks sharing the card; per
    case the restored steps, the vote and the digest of the gathered
    masters into ``out/rank<r>.json``."""
    from dear_pytorch_tpu_torch.resilience import inject as INJ
    from dear_pytorch_tpu_torch.utils.guard import (
        DivergenceError, GuardedTrainer)

    _join_two_ranks(rank, out, world)
    os.environ["DEAR_SDC_HOST"] = f"card0-rank{rank}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    for case in cases:
        mode, faults, shared, sdc, attempts = _GUARD_RANK_CASES[case]
        os.environ["DEAR_CKPT_SHARED"] = "1" if shared else "0"
        os.environ["DEAR_SDC"] = "1" if sdc else ""
        FA.reset_launch_counts()
        FS.fused_update_launches = 0
        ts, batch, _ = _guard_gpt_step(_GUARD_SMALL + ["--mode", mode])
        state = ts.init()
        restored, suspects, error = [], [], ""
        d = out / case / ("ckpt" if shared else f"ckpt{rank}")
        guard = GuardedTrainer(
            ts, str(d), check_every=1, checkpoint_every=2, max_keep=10,
            on_rollback=lambda c, s: restored.append(s),
            injector=INJ.FaultInjector(INJ.parse_faults(faults)))
        try:
            for _ in range(attempts):
                state, _ = guard.step(state, batch)
                if guard._sdc is not None and guard._sdc.last_suspects:
                    suspects.append(guard._sdc.last_suspects)
        except DivergenceError as exc:
            error = str(exc)
        guard.finalize()
        results[case] = {
            "restored": restored, "suspects": suspects, "error": error,
            "step": int(state.step),
            "digest": _digest(ts.gather_params(state)),
            "convicted": sorted(guard._sdc.convicted) if guard._sdc else [],
            "launches": _guard_counts()}
        ts.close()
        del ts, state, guard
        gc.collect()
    (out / f"rank{rank}.json").write_text(json.dumps(results))
    backend.shutdown()


def start_guard_ranks() -> list:
    """(iii)'s spawns of `_GUARD_SPAWNS`, started together."""
    return [(world, cases, start_ranks(
        f"guard-{world}", lambda r, out, w=world, c=cases: [
            "--guard-rank", str(r), "--world", str(w), "--out", str(out),
            "--cases", ",".join(c)], world))
        for world, cases in _GUARD_SPAWNS]


def finish_guard_ranks(card: str, started) -> dict:
    """(iii): the cases of `_GUARD_RANK_CASES` on ranks sharing the card:
    one rank's NaN rolls both back to the same step; a newest step
    corrupted on rank 0 only (per-host storage) makes both restore the
    newest common step; the vote names the flipped rank 0. Returns the
    launches over every rank."""
    totals: dict = {}
    results = {}
    for world, cases, handle in started:
        ranks = wait_ranks(handle, 600.0)
        shutil.rmtree(handle[1], ignore_errors=True)
        for case in cases:
            results[case] = [r[case] for r in ranks]
            for r in results[case]:
                for k, v in r["launches"].items():
                    totals[k] = totals.get(k, 0) + v
            print(f"phase 5p (iii) {case} at {world} ranks: restored "
                  f"{[r['restored'] for r in results[case]]}, first vote "
                  f"{results[case][0]['suspects'][:1]}, convicted "
                  f"{results[case][0]['convicted']}")
    nan, per_host, flip = (results[c] for c in ("nan_r1", "per_host", "flip"))
    for case in (nan, per_host):
        _check(case[0]["restored"] == case[1]["restored"] == [2]
               and case[0]["digest"] == case[1]["digest"]
               and case[0]["step"] == case[1]["step"],
               f"two ranks: restored {[r['restored'] for r in case]}, "
               f"digests equal {case[0]['digest'] == case[1]['digest']}")
    first = flip[0]["suspects"][0] if flip[0]["suspects"] else None
    _check(first is not None and [s[:2] for s in first] == [[0, 0]]
           and all(r["suspects"] and r["suspects"][0] == first
                   for r in flip),
           f"the vote: {[r['suspects'][:1] for r in flip]}")
    print(f"phase 5p (iii) on {card}: nan@3:r1 rolled both ranks back to "
          f"step 2 (equal master digests); rank 0's corrupted newest step "
          f"(per-host) made both restore step 2; at 3 ranks the vote named "
          f"(rank, bucket) {first[0][:2]} on every rank")
    return totals


def guard_production(card: str, work: Path) -> dict:
    """(iv): the ported production example as JAX configures it (its
    flags and defaults) with ``DEAR_FAULTS="nan@6,exc@9"``: its first
    checkpoint comes at step 20, so the NaN at step 6 (found at the check
    of step 10) has nothing to restore, and the example stops with the
    guard's DivergenceError — as the JAX example does on the CPU; then
    with ``--checkpoint-every 4 --log-every 2`` it recovers, and a
    relaunch resumes from its newest verified step. Returns the K5
    epilogue's launches."""
    from dear_pytorch_tpu_torch.examples import production
    from dear_pytorch_tpu_torch.utils.guard import DivergenceError

    FS.fused_update_launches = 0          # the path starts here
    os.environ["DEAR_FAULTS"] = "nan@6,exc@9"
    try:
        try:
            production.main(["--steps", "40", "--workdir",
                             str(work / "prod-jax"), "--device", _DEV])
            raised = ""
        except DivergenceError as exc:
            raised = str(exc)
        _check("before the first checkpoint" in raised,
               f"production as JAX configures it: {raised!r}")
        loss = production.main(["--steps", "40", "--workdir",
                                str(work / "prod"), "--checkpoint-every",
                                "4", "--log-every", "2", "--device", _DEV])
    finally:
        del os.environ["DEAR_FAULTS"]
    again = production.main(["--steps", "48", "--workdir", str(work / "prod"),
                             "--checkpoint-every", "4", "--log-every", "2",
                             "--device", _DEV])
    launches = FS.fused_update_launches   # ... and ends here
    _check(np.isfinite(loss) and np.isfinite(again),
           f"production: losses {loss}, {again}")
    print(f"phase 5p (iv) production example on {card}: JAX's flags with "
          "nan@6,exc@9 stop before the first checkpoint (DivergenceError, "
          f"as JAX's); with checkpoints every 4 it recovers (loss {loss:.4f} "
          f"at step 40) and resumes to step 48 (loss {again:.4f})")
    return {"fused_update": launches}


def guard_phase(card: str) -> dict:
    """Phase 5p: (i)-(iv); returns the launches of K1-K3 (tensor-core
    routes) and the K5 epilogue on its paths. (i)'s second process and
    (iii)'s ranks run beside (ii) and (iv): none of them is timed."""
    work = _ROOT / "build" / "chip_smoke" / "guard"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    gpt, resume = guard_gpt2(card, work)
    print(f"phase 5p (i), this process: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    started = start_guard_ranks()
    finish_resume(card, resume)
    print(f"phase 5p (i), the second process: "
          f"{time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    rn = guard_resnet50(card, work)
    print(f"phase 5p (ii): {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    prod = guard_production(card, work)
    print(f"phase 5p (iv): {time.perf_counter() - t1:.1f} s")
    ranks = finish_guard_ranks(card, started)
    print(f"phase 5p (iii), from its start: "
          f"{time.perf_counter() - t0:.1f} s")
    out = {k: gpt[k] + ranks.get(k, 0) for k in gpt}
    out["fused_update"] += rn["fused_update"] + prod["fused_update"]
    print(f"phase 5p launches: {out}")
    shutil.rmtree(work, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 6: timings
# ---------------------------------------------------------------------------


def trace_decode_ticks(model, warm=8, n=16):
    """Where a steady bf16 decode tick's time goes: ``torch.profiler`` over
    ``n`` ticks of 4 decoding slots — kernel launches per tick, device busy
    time per tick, K1's share, and the device's idle share of the traced
    wall time (the profiler's own host cost inflates the wall, so the idle
    share is an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    eng = DecodeEngine(model, slots=_SLOTS, device=_DEV)
    rs = np.random.RandomState(1)
    for i in range(_SLOTS):
        eng.submit(list(rs.randint(0, GPT2_SMALL.vocab_size, 4)),
                   warm + n + 8, request_id=i)
    for _ in range(warm):
        eng.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()   # kernels, copies and memsets
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    flash = sum(e.time_range.elapsed_us() for e in kernels
                if "flash_fwd_kernel" in e.name) / 1e6
    if not kernels or busy <= 0:
        print("decode tick trace: no device time in the profile "
              "(not measured)")
        return
    print(f"decode tick trace (bf16, {_SLOTS} slots decoding, {n} ticks): "
          f"{len(kernels) / n:.1f} device ops/tick, wall "
          f"{wall / n * 1e3:.3f} ms/tick under the profiler, device busy "
          f"{busy / n * 1e3:.3f} ms/tick, flash_fwd "
          f"{flash / n * 1e3:.3f} ms/tick ({flash / busy:.1%} of busy), "
          f"device idle {1 - busy / wall:.1%} of wall")


def device_ms(fn, sets, reps):
    """Mean device time of ``fn(*s)`` over ``reps`` calls that cycle
    through input ``sets`` (more bytes than the 50 MB L2, so each call
    finds its inputs cold, as a decode tick does across 12 layers). CUDA
    events bracket the calls behind a sleep kernel long enough for the host
    to enqueue them all, so host overhead does not leak into the time."""
    for s in sets[:2]:
        fn(*s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(host_s * 2e9 * 2) + 1_000_000)
    start.record()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_shape(name, B, Sq, Sk, dtype, causal, n_sets, hbm, out_dtype=None):
    """K1 at one shape (outputs in ``out_dtype``, default the inputs'):
    first held against its plain version on the first input set (the
    tolerance of `check_kernel`), then timed beside its plain version, SDPA
    and the card's bound. The row names the route `fwd_route` takes."""
    out_dtype = out_dtype or dtype
    route = FA.fwd_route(Sq, _D, dtype, out_dtype)
    gen = torch.Generator(device=_DEV).manual_seed(1)
    sets = [_case(gen, B, Sq, Sk, dtype, causal) for _ in range(n_sets)]
    q, k, v, m = sets[0]
    scale = _D ** -0.5
    o, lse = _routed(name, route, lambda: FA._dispatch(
        q, k, v, m, scale, causal, out_dtype))
    ref, ref_lse = FA.flash_attention_reference(
        q, k, v, causal=causal, kv_mask=m, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = float((o.float() - ref.to(out_dtype).float()).abs().max())
    err_lse = float((lse - ref_lse).abs().max())
    _check(bool(torch.isfinite(o.float()).all())
           and err <= {torch.float32: 2e-5, torch.bfloat16: 2e-2}[out_dtype]
           and err_lse <= 2e-4,
           f"{name} {dtype} ({route}): kernel disagrees with its plain "
           f"version (max |o - plain| {err:.3e}, lse {err_lse:.3e})")
    del o, lse, ref, ref_lse

    def kernel(q, k, v, m):
        FA._dispatch(q, k, v, m, scale, causal, out_dtype)

    def plain(q, k, v, m):
        FA.flash_attention_reference(q, k, v, causal=causal, kv_mask=m)

    def library(q, k, v, m):
        F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=None if causal else m.bool()[:, None, None, :],
            is_causal=causal)

    ms = device_ms(kernel, sets, 50)
    plain_ms = device_ms(plain, sets, 20)
    library_ms = device_ms(library, sets, 50)
    esize = torch.finfo(dtype).bits // 8
    out_esize = torch.finfo(out_dtype).bits // 8
    nbytes = (B * Sq * _H * _D * (esize + out_esize)
              + 2 * B * Sk * _H * _D * esize
              + B * Sk * 4 + B * _H * Sq * 4)   # q, o, k, v, mask, lse
    pairs = B * _H * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
    flops = 4 * _D * pairs                       # QK^T and PV per pair
    bytes_ms = nbytes / hbm * 1e3
    ops_ms = flops / _PEAK_FLOPS[dtype] * 1e3
    dts = str(dtype).replace("torch.", "")
    if out_dtype != dtype:
        dts += " in, " + str(out_dtype).replace("torch.", "") + " out"
    row = {"shape": name, "dtype": dts, "route": route,
           "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": nbytes, "flops": flops}
    print("kernel time " + json.dumps(row))
    return row


def time_bwd(hbm, configs, S=1024, causal=True):
    """K2 and K3 at [B, S, 12, 64] shapes (``causal``, or over a full key
    mask: BERT's), through the [B, S, H, D] dispatch the autograd Function
    uses. ``configs`` lists (suffix, B,
    dtype, out_dtype, launches_per_step): the tensor-core route at the bf16
    train step (bf16 out), the CUDA-core route at the fp32 step (fp32 in
    and out) and at the train shape with bf16 in, fp32 out (ring
    attention's ``out_dtype``). Each is first held against its plain version
    on the first input set (the largest error over the largest |plain
    value|, at most 2e-2 for bf16 out and 1e-4 for fp32 out, as in
    `check_bwd_kernels`), every call checked for its route, then timed
    beside its plain version and the backward of SDPA at the same shape and
    dtype (is_causal as the kernels; dq, dk and dv in one call), the
    yardstick for K2 + K3
    together. Rows ``flash_bwd_dq`` + suffix / ``flash_bwd_dkv`` + suffix,
    each with its TF/s. Returns (rows, the largest absolute error of dQ and
    of dK/dV by instantiation, as `check_bwd_kernels`)."""
    gen = torch.Generator(device=_DEV).manual_seed(5)
    scale = _D ** -0.5
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    operands, sdpa_ms, rows = {}, {}, {}
    worst = {"dq": {}, "dkv": {}}
    for sfx, B, dt, out_dt, launches_per_step in configs:
        if (B, dt) not in operands:
            operands[B, dt] = [_bwd_operands(gen, B, S, dt, causal)
                               for _ in range(2)]
        sets = operands[B, dt]
        route = FA.bwd_route(_D, dt, out_dt)
        q, k, v, do, mask, lse, delta = sets[0]
        kind = "causal" if causal else "non-causal"
        errs = _hold_dispatch(
            f"main path {kind} B={B} S={S} {dt} in, {out_dt} out",
            (q, k, v, mask, do, lse, delta, scale, causal), out_dt,
            tol[out_dt])
        _worst(worst, _bwd_instance(route, dt, out_dt, _D), errs["dq"][0],
               max(errs["dk"][0], errs["dv"][0]))

        if (B, dt) not in sdpa_ms:
            sdpa = []
            for q, k, v, do, *_ in sets:
                xs = [t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v)]
                out = F.scaled_dot_product_attention(*xs,
                                                     is_causal=causal)
                sdpa.append((out, xs, do.transpose(1, 2)))

            def library(out, xs, do):
                torch.autograd.grad(out, xs, do, retain_graph=True)

            # one SDPA backward computes dq, dk and dv: the yardstick of
            # K2 + K3 together, so both rows carry it with that scope
            sdpa_ms[B, dt] = device_ms(library, sdpa, 20)
            del sdpa

        def dq(q, k, v, do, mask, lse, delta):
            FA._dispatch_dq(q, k, v, mask, do, lse, delta, scale, causal,
                            out_dt)

        def dkv(q, k, v, do, mask, lse, delta):
            FA._dispatch_dkv(q, k, v, mask, do, lse, delta, scale, causal,
                             out_dt)

        def dq_plain(q, k, v, do, mask, lse, delta):
            FA._dq_reference(q, k, v, mask, do, lse, delta, scale, causal,
                             out_dt)

        def dkv_plain(q, k, v, do, mask, lse, delta):
            FA._dkv_reference(q, k, v, mask, do, lse, delta, scale, causal,
                              out_dt)

        pairs = B * _H * (S * (S + 1) // 2 if causal else S * S)
        elems = B * S * _H * _D
        dts = str(dt).replace("torch.", "")
        if out_dt != dt:
            dts += " in, " + str(out_dt).replace("torch.", "") + " out"
        for name, fn, plain, flops_per_pair, n_out in (
                ("flash_bwd_dq", dq, dq_plain, 6 * _D, 1),
                ("flash_bwd_dkv", dkv, dkv_plain, 8 * _D, 2)):
            ms = device_ms(fn, sets, 20)
            plain_ms = device_ms(plain, sets, 4)
            # q, k, v, dO read, the outputs written; lse, delta, the mask
            nbytes = (4 * dt.itemsize + n_out * out_dt.itemsize) * elems \
                + 2 * B * _H * S * 4 + B * S * 4
            flops = flops_per_pair * pairs
            bytes_ms = nbytes / hbm * 1e3
            ops_ms = flops / _PEAK_FLOPS[dt] * 1e3
            row = {
                "shape": f"train {kind} B={B} S={S} H={_H} D={_D}",
                "dtype": dts, "route": route, "ms": ms,
                "tflops": flops / ms / 1e9, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "flops": flops,
                "launches_per_step": launches_per_step,
                "library_ms": sdpa_ms[B, dt], "library_scope": "dq+dk+dv"}
            rows[name + sfx] = row
            print("kernel time " + json.dumps({"kernel": name + sfx} | row))
        dq_row = rows["flash_bwd_dq" + sfx]
        dkv_row = rows["flash_bwd_dkv" + sfx]
        both = dq_row["ms"] + dkv_row["ms"]
        tflops = (dq_row["flops"] + dkv_row["flops"]) / both / 1e9
        print(f"backward yardstick: SDPA backward ({kind}, dq+dk+dv) "
              f"{sdpa_ms[B, dt]:.4f} ms vs K2 + K3 ({route}) {both:.4f} ms "
              f"({tflops:.1f} TF/s; {both / sdpa_ms[B, dt]:.2f}x) at B={B} "
              f"S={S} {dts}")
    return rows, worst


def time_update(n, hbm, launches_per_step):
    """The shard update on one bucket of the main path (``n`` elements, bf16
    gradient, SGD momentum 0.9 past its first step), its plain version, and
    ``torch.optim.SGD(fused=True)`` over the same elements (an fp32
    gradient: the fused SGD needs the parameter's dtype) as the yardstick."""
    gen = torch.Generator(device=_DEV).manual_seed(6)
    opt = FS.fused_sgd(lr=0.01, momentum=0.9)
    sets = []
    for _ in range(2):
        p = torch.randn(n, generator=gen, device=_DEV)
        st = opt.init(p)
        st["buf"].normal_(generator=gen)
        st["initialized"] = True
        sets.append((torch.randn(n, generator=gen, device=_DEV).bfloat16(),
                     st, p))
    scal = opt.scalars(sets[0][1], 1, 0)

    def kernel(g, st, p):
        opt.update(g, st, p)

    def plain(g, st, p):
        FS.fused_update_reference(opt, g, st, p, scal)

    lib = []
    for g, _, p in sets:
        w = torch.nn.Parameter(p.clone())
        w.grad = g.float()
        sgd = torch.optim.SGD([w], lr=0.01, momentum=0.9, fused=True)
        sgd.step()                         # seed the momentum buffer
        lib.append((sgd,))

    ms = device_ms(kernel, sets, 50)
    plain_ms = device_ms(plain, sets, 20)
    library_ms = device_ms(lambda sgd: sgd.step(), lib, 50)
    nbytes = n * (2 + 4 * 4)               # grad; param and buf in and out
    row = {"shape": f"bucket shard n={n}", "dtype": "bf16 grad, fp32 state",
           "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": nbytes / hbm * 1e3, "bound_by": "bytes",
           "bytes": nbytes, "flops": 6 * n,
           "launches_per_step": launches_per_step}
    print("kernel time " + json.dumps(row))
    return row


def time_ring(bucket_shards, hbm):
    """K4 and K5 ring on a `LocalRing` of two ranks (one launch drives
    both, as the two processes' launches share the card) at each shard
    size of the main path's plan: the gather in fp32 (dear-fused gathers
    the master shards in fp32, as the JAX CLI) on its direct route into
    registered outputs (the main path) and on its slot route, the
    reduce-scatter of a bf16 gradient with SGD momentum 0.9 past its first
    step; beside their stacked plain versions and the bytes bound. Bytes
    per rank: K4 reads its shard and writes the W chunks of the output,
    (1 + W)·n·4; K5 ring reads its W·n bf16 gradient and reads and writes
    the parameter and the momentum, W·n·2 + 16·n (its hop, which one card
    may serve from L2, left out); both ranks' bytes over the card's memory
    rate (they share it). NCCL refuses two ranks on one device, so K4's
    library time is the one-card replicate of the stacked shards (one copy
    into the same output, checked equal to K4's); K5 ring has no one
    library call on one card. Then the scalar width, which no shard of the
    plan takes, at the plan's most common shard size n0 plus 2 (K4 and the
    K5 ring one element per access) and plus 4 (the K5 ring's bf16 in
    4-element units), printed beside the vector width's rows. Returns the
    rows of each kernel by shard size: "ring_all_gather" (direct),
    "ring_all_gather_slot", "ring_rs_update"."""
    world = 2
    sizes = sorted(set(bucket_shards))
    n0 = max(sizes, key=bucket_shards.count)
    gen = torch.Generator(device=_DEV).manual_seed(9)
    ring = LocalRing(world, _DEV, max(sizes + [n0 + 4]))
    opt = FS.fused_sgd(lr=0.01, momentum=0.9)
    note = ("none on one card: NCCL refuses two ranks on one device"
            if torch.cuda.device_count() < 2 else "not measured")
    rows = {"ring_all_gather": {}, "ring_all_gather_slot": {},
            "ring_rs_update": {}}

    def make_sets(n, direct=False):
        ag_sets, direct_sets, rs_sets = [], [], []
        for _ in range(2):
            x = torch.randn(world, n, generator=gen, device=_DEV)
            ag_sets.append((x, torch.empty(world, world * n, device=_DEV)))
            if direct:
                direct_sets.append((x, ring.register_outputs(
                    [world * n], torch.float32)[0]))
            p = torch.randn(world, n, generator=gen, device=_DEV)
            st = [opt.init(p[i]) for i in range(world)]
            for one in st:
                one["buf"].normal_(generator=gen)
                one["initialized"] = True
            g = torch.randn(world, world * n, generator=gen,
                            device=_DEV).bfloat16()
            rs_sets.append((g, p, st))
        return ag_sets, direct_sets, rs_sets

    def ag(x, o):
        CM.ring_all_gather(x, ring, out=o, direct=True)

    def ag_slot(x, o):
        CM.ring_all_gather(x, ring, out=o)

    def ag_plain(x, o):
        CM.ring_all_gather_stacked(x)

    def ag_library(x, o):
        o.copy_(x.reshape(1, -1).expand(world, -1))

    def rs(g, p, st):
        CM.fused_reduce_scatter_update(g, p, st, opt, ring,
                                       mean_world=world)

    def rs_plain(g, p, st):
        CM.fused_reduce_scatter_update_stacked(g, p, st, opt,
                                               mean_world=world)

    for n in sizes:
        ag_sets, direct_sets, rs_sets = make_sets(n, direct=True)
        x, o = direct_sets[0]
        before = CM.ring_ag_route_launches["direct"]["vector"]
        ag(x, o)
        _check(CM.ring_ag_route_launches["direct"]["vector"] == before + 1,
               f"K4 at n={n}: not on the direct route's vector width")
        want = o.clone()
        _check(torch.equal(want, CM.ring_all_gather_stacked(x)),
               f"K4's direct route at n={n} is not the all-gather")
        ag_library(x, o)
        _check(torch.equal(o, want), f"the one-card replicate at n={n} is "
               "not K4's all-gather")
        ag_bytes = world * (1 + world) * n * 4
        for name, fn, plain, library, sets, nbytes, dtype in (
                ("ring_all_gather", ag, ag_plain, ag_library, direct_sets,
                 ag_bytes, "fp32, direct route"),
                ("ring_all_gather_slot", ag_slot, ag_plain, ag_library,
                 ag_sets, ag_bytes, "fp32, slot route"),
                ("ring_rs_update", rs, rs_plain, None, rs_sets,
                 world * (world * n * 2 + 16 * n),
                 "bf16 grad, fp32 state")):
            ms = device_ms(fn, sets, 20)
            plain_ms = device_ms(plain, sets, 5)
            row = {"shape": f"W=2 LocalRing shard n={n}", "dtype": dtype,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                   "library_note": note, "bound_ms": nbytes / hbm * 1e3,
                   "bound_by": "bytes", "bytes": nbytes,
                   "launches_per_step": len(bucket_shards)}
            if library is not None:
                row.update(library_ms=device_ms(library, sets, 20),
                           library_scope="one-card replicate",
                           library_note="NCCL refuses two ranks on one "
                           "device: one copy replicating the stacked "
                           "shards stands in")
            print("kernel time " + json.dumps({"kernel": name} | row))
            rows[name][n] = row
    for n, kernels in ((n0 + 2, ("ag", "rs")), (n0 + 4, ("rs",))):
        ag_sets, _, rs_sets = make_sets(n)
        for kernel in kernels:
            is_ag = kernel == "ag"
            fn, data = (ag_slot, ag_sets) if is_ag else (rs, rs_sets)
            counts = (CM.ring_ag_route_launches["slot"] if is_ag
                      else CM.ring_rs_route_launches)
            before = counts["scalar"]
            fn(*data[0])
            _check(counts["scalar"] == before + 1,
                   f"{kernel} at n={n}: not on the scalar width")
            nbytes = (world * (1 + world) * n * 4 if is_ag
                      else world * (world * n * 2 + 16 * n))
            row = {"shape": f"W=2 LocalRing shard n={n}", "width": "scalar",
                   "dtype": "fp32, slot route" if is_ag
                   else "bf16 grad, fp32 state",
                   "ms": device_ms(fn, data, 20),
                   "bound_ms": nbytes / hbm * 1e3, "bound_by": "bytes",
                   "bytes": nbytes, "launches_per_step": 0}
            name = "ring_all_gather_slot" if is_ag else "ring_rs_update"
            print("kernel time " + json.dumps({"kernel": name} | row))
    ring.close()
    for name, by_n in rows.items():
        keys = ("ms", "plain_ms", "bound_ms", "library_ms")
        per_step = {k: sum(by_n[n][k] for n in bucket_shards)
                    for k in keys if by_n[sizes[0]][k] is not None}
        library = (f", library {per_step['library_ms']:.4f} ms"
                   if "library_ms" in per_step else "")
        print(f"{name}: per step at W=2 (one launch per bucket, "
              f"{len(bucket_shards)} buckets), both ranks: kernel "
              f"{per_step['ms']:.4f} ms, plain {per_step['plain_ms']:.4f} "
              f"ms, bound {per_step['bound_ms']:.4f} ms{library}")
    return rows


def time_ring_matmul(hbm, calls_per_step, shapes=_CM_MAIN, sweeps=True):
    """K6, K7 and K8 on a two-rank `LocalRing` (one cooperative launch
    drives both ranks, as the two processes' launches share the card) at
    the main path's shapes (`_CM_MAIN`, bf16), each held to its plain
    version first; beside the stacked plain versions, the bound and one
    cuBLAS call computing the same function for both ranks (a yardstick
    the port never calls): K6 ``x @ w`` (x stacked [2, M, K], w the full
    [K, N]), K7 ``dy @ wᵀ``, K8 ``x_catᵀ @ dy_cat`` (the ranks' rows
    concatenated: every rank's dw shard at once). Per call, both ranks:
    operations 2 x 2·M·K·N, bytes 2 x (M·K + kc·N + M·N) x 2 (each input
    read once, each output written once). Per step: ``calls_per_step[N]``
    calls at each N. ``shapes``: (M, kc, N) at W = 2 (GPT-2's
    `_CM_MAIN` by default); ``sweeps``: also time the other tiles and K8
    plans. Returns the rows of each kernel by N."""
    world = 2
    gen = torch.Generator(device=_DEV).manual_seed(13)
    ring = LocalRing(world, _DEV, 1,
                     cm_elems=max(kc * n for _, kc, n in shapes))
    rows = {"cm_fwd": {}, "cm_dx": {}, "cm_dw": {}}
    for m, kc, n in shapes:
        k = world * kc
        sets = [_cm_operands(world, m, kc, n, torch.bfloat16, gen)
                for _ in range(2)]
        worst: dict = {}
        _cm_hold(f"timed W=2 M={m} K={k} N={n}", _cm_pairs(*sets[0], ring),
                 worst)
        fns = {
            "cm_fwd": (lambda x, ws, dy: CM.ring_matmul(x, ws, ring),
                       lambda x, ws, dy: CM.ring_matmul_stacked(x, ws),
                       lambda x, ws, dy: torch.matmul(x, ws.reshape(k, n))),
            "cm_dx": (lambda x, ws, dy: CM.ring_matmul_dx(dy, ws, ring),
                      lambda x, ws, dy: CM.ring_matmul_dx_stacked(dy, ws),
                      lambda x, ws, dy: torch.matmul(
                          dy, ws.reshape(k, n).T)),
            "cm_dw": (lambda x, ws, dy: CM.ring_matmul_dw(x, dy, ring),
                      lambda x, ws, dy: CM.ring_matmul_dw_stacked(x, dy),
                      lambda x, ws, dy: x.reshape(-1, k).T
                      @ dy.reshape(-1, n)),
        }
        flops = world * 2 * m * k * n
        nbytes = world * (m * k + kc * n + m * n) * 2
        bound = max(nbytes / hbm, flops / _PEAK_FLOPS[torch.bfloat16]) * 1e3
        core, ranges, contrib, slab = CM.dw_launch_plan(ring, m, kc, n,
                                                        torch.bfloat16)
        route = CM.cm_core(torch.bfloat16, world, kc, n)
        for name, (kernel, plain, library) in fns.items():
            got = kernel(*sets[0]).reshape(-1)
            lib = library(*sets[0]).reshape(-1)
            _check(float((got.float() - lib.float()).abs().max())
                   <= 2 * _CM_RTOL[torch.bfloat16]
                   * float(lib.float().abs().max()),
                   f"{name}'s cuBLAS yardstick computes another function")
            ms = device_ms(kernel, sets, 20)
            row = {"shape": f"W=2 LocalRing M={m} K={k} N={n}",
                   "dtype": "bf16", "ms": ms,
                   "plain_ms": device_ms(plain, sets, 5),
                   "library_ms": device_ms(library, sets, 20),
                   "library_scope": "one cuBLAS call for both ranks",
                   "bound_ms": bound,
                   "bound_by": ("operations" if flops
                                / _PEAK_FLOPS[torch.bfloat16]
                                >= nbytes / hbm else "bytes"),
                   "flops": flops, "bytes": nbytes,
                   "tflops": flops / ms / 1e9,
                   "launches_per_step": calls_per_step[n]}
            if name == "cm_dw":   # K8's plan: its tile core and the split
                row["plan"] = (f"{core} core, {ranges} ranges of slabs of "
                               f"{slab} rows, up to {contrib} per tile")
            else:                 # K6's and K7's route and tile
                row["route"] = route
                row["plan"] = (f"128 x {CM.CM_TILE_N[name[3:]]} tiles"
                               if route == "wgmma" else "mma tiles")
            print("kernel time " + json.dumps({"kernel": name} | row))
            rows[name][n] = row
        if sweeps:
            time_cm_tiles(ring, sets, m, kc, n, fns)
            time_dw_plans(ring, sets, m, kc, n, ranges)
    ring.close()
    for name, by_n in rows.items():
        per_step = {key: sum(by_n[n][key] * calls_per_step[n] for n in by_n)
                    for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        print(f"{name}: per step at W=2 ({sum(calls_per_step.values())} "
              "calls, both ranks): kernel "
              f"{per_step['ms']:.4f} ms, plain {per_step['plain_ms']:.4f} "
              f"ms, bound {per_step['bound_ms']:.4f} ms, cuBLAS "
              f"{per_step['library_ms']:.4f} ms")
    return rows


def time_cm_tiles(ring, sets, m, kc, n, fns) -> None:
    """K6 and K7 on the wgmma route with output tiles of 128 x 128, 192
    and 256 (`CM.CM_TILE_N`; the default is printed with the rows above),
    each held to `_CM_RTOL` of the plain version and timed: the
    measurement behind the default, against the waves each gives on the
    ring's blocks."""
    tiles = dict(CM.CM_TILE_N)
    times = {}
    try:
        for name in ("cm_fwd", "cm_dx"):
            kernel, plain, _ = fns[name]
            ref = plain(*sets[0])
            for bn in (128, 192, 256):
                CM.CM_TILE_N[name[3:]] = bn
                _cm_hold(f"{name} tiles 128 x {bn} N={n}",
                         [(name, kernel(*sets[0]), ref)], {})
                times[name, bn] = device_ms(kernel, sets, 20)
    finally:
        CM.CM_TILE_N.update(tiles)
    blocks = ring_blocks(ring)
    for name in ("cm_fwd", "cm_dx"):
        cols = n if name == "cm_fwd" else kc
        waves = {bn: -(-m // 128) * -(-cols // bn)
                 * (1 if name == "cm_fwd" else 2) / blocks
                 for bn in (128, 192, 256)}
        print(f"{name} tiles at W=2 M={m} K={2 * kc} N={n} ({blocks} blocks "
              "per rank): " + ", ".join(
                  f"128 x {bn} {times[name, bn]:.4f} ms ({waves[bn]:.2f} "
                  "waves)" for bn in (128, 192, 256)))


def ring_blocks(ring) -> int:
    """K8's blocks per rank on ``ring`` (the grid ``rmm_blocks`` sizes)."""
    from dear_pytorch_tpu_torch.comm.ring import matmul_lib

    return matmul_lib().rmm_blocks(ring.world if ring.stacked else 1,
                                   int(ring.cooperative))


def time_dw_plans(ring, sets, m, kc, n, ranges) -> None:
    """K8 under several cuts of its tiles x slabs (`CM.dw_plan`'s
    ``ranges``; the default cut is ``ranges``): S equal segments of every
    tile (ranges = tiles x S) and one run per block (stream-K), each held
    to `_CM_RTOL` of the plain version and timed — the measurement behind
    the default; then the default at a quarter, a half and all of M, whose
    slope is the mainloop's cost per 64-row slab."""
    plan = CM.dw_plan
    _, bm, bn = CM.DW_CORES[CM.dw_core(torch.bfloat16, 2, kc, n)]
    tiles = -(-kc // bm) * -(-n // bn)
    x, _, dy = sets[0]
    ref = CM.ring_matmul_dw_stacked(x, dy)
    times = {}
    try:
        for label, R in [(f"{S} equal segments", tiles * S)
                         for S in (1, 2, 3, 4, 8)] + [
                             ("one run per block", ring_blocks(ring))]:
            CM.dw_plan = lambda *args, R=R: plan(*args, ranges=R)
            got = CM.ring_matmul_dw(x, dy, ring)
            _cm_hold(f"cm_dw plan {label} N={n}", [("cm_dw", got, ref)], {})
            times[label] = device_ms(
                lambda x, ws, dy: CM.ring_matmul_dw(x, dy, ring), sets, 20)
    finally:
        CM.dw_plan = plan
    print(f"cm_dw plans at W=2 M={m} K={2 * kc} N={n} ({tiles} tiles; "
          f"the default plan: {ranges} ranges): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    # the default plan at fewer rows: the slope over M is the mainloop's
    # cost per 64-row slab, the rest the call's fixed cost
    by_m = {}
    for rows in (m // 4, m // 2, m):
        part = [tuple(t[:, :rows].contiguous() if i != 1 else t
                      for i, t in enumerate(ops)) for ops in sets]
        xs, _, dys = part[0]
        _cm_hold(f"cm_dw M={rows} N={n}", [(
            "cm_dw", CM.ring_matmul_dw(xs, dys, ring),
            CM.ring_matmul_dw_stacked(xs, dys))], {})
        by_m[rows] = device_ms(
            lambda x, ws, dy: CM.ring_matmul_dw(x, dy, ring), part, 20)
    slope = (by_m[m] - by_m[m // 4]) / ((m - m // 4) / CM.DW_SLAB)
    print(f"cm_dw at N={n} by M (default plan): " + ", ".join(
        f"M={k} {v:.4f} ms" for k, v in sorted(by_m.items()))
        + f"; {slope * 1e3:.3f} us per 64-row slab of every tile (both "
        f"ranks), {by_m[m] - slope * m / CM.DW_SLAB:.4f} ms fixed")


def _kernel_entry(name, source, replaces, launches, err, row):
    entry = {"name": name, "route": "cuda",
             "source": f"dear_pytorch_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches, "max_abs_err": err,
             "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": row["library_ms"]}
    if "library_scope" in row:   # one library call for several kernels
        entry["library_scope"] = row["library_scope"]
    if "library_note" in row:    # what the library time is, or why none
        entry["library_note"] = row["library_note"]
    return entry


# ---------------------------------------------------------------------------
# phase 5q: elastic membership on the card
# ---------------------------------------------------------------------------

#: the drills' peer timeouts on the card (a collective of the data plane
#: times out after a quarter of one): the GPT-2 storm's checkpoints gather
#: ~430 MB a rank through the host, the MNIST net's a few KB
_ELASTIC_TIMEOUT_S = 16
_AUTOSCALE_TIMEOUT_S = 10


def _drill_args(work: Path, model: str, **kw):
    from dear_pytorch_tpu_torch.scripts import chaos_check as CK

    argv = ["--workdir", str(work), "--device", _DEV, "--model", model,
            "--checkpoint-every", "2", "--deadline", "240"]
    for k, v in kw.items():
        argv += [f"--{k.replace('_', '-')}"] + ([] if v is True else [str(v)])
    return CK.build_parser().parse_args(argv)


def _lost(transition: dict) -> str:
    """A transition's steps lost, as the drill recorded them (none for a
    move during the rank's own re-entry: it held no step yet)."""
    n = transition["steps_lost"]
    return "none (during its re-entry)" if n is None else str(n)


def elastic_storm(card: str, work: Path) -> dict:
    """Phase 5q (i): the elastic drill (`scripts.chaos_check --elastic`)
    with GPT-2 small cut to 2 layers (full width, bf16, flash attention,
    dear, B = 4 per rank, S = 1024), three ranks sharing the card under
    the port's supervisor, per-host checkpoints every 2 steps: rank 2
    SIGKILLs itself before attempt 5, the survivors regroup at epoch 1
    (world 2), the relaunch rejoins at epoch 2 (world 3). JAX's verdicts
    (lockstep final step, loss and epoch; plan world 3 -> 2 -> 3 with the
    epoch stamped; every rollback on the newest common checkpoint), one
    K5 epilogue per bucket on every completed step of every rank, and the
    first post-shrink losses against a fresh 2-rank run restored from the
    same step. Prints each transition's times on the card."""
    from dear_pytorch_tpu_torch.scripts import chaos_check as CK

    # --replay-shrink adds the peer timeout to the relaunch's delay, so
    # the survivors train a few steps at world 2 before the rejoin
    args = _drill_args(work, "gpt2", replay_shrink=True,
                       peer_timeout=_ELASTIC_TIMEOUT_S)
    summary = CK.run_elastic(args)
    if not summary["passed"]:
        print(summary.get("logs", "")[-12000:], file=sys.stderr)
        raise RuntimeError(f"phase 5q (i) failed: {summary['failures']}")
    v = summary["verdicts"]
    death = json.loads((work / "death_rank2.json").read_text())["t"]
    for r in (0, 1):
        shrink, admit = v[r]["transitions"][:2]
        print(f"phase 5q (i) rank {r} on {card}: death -> epoch-1 commit "
              f"{shrink['t_commit'] - death:.3f} s (the peer timeout is "
              f"{_ELASTIC_TIMEOUT_S} s); regroup {shrink['regroup_s']:.3f} "
              f"s; rescale + restore {shrink['t_restored'] - shrink['t_hook']:.3f}"
              f" s; steps lost {_lost(shrink)} (restored step "
              f"{shrink['restored_step']})")
        print(f"phase 5q (i) rank {r} on {card}: epoch-2 admission commit "
              f"{admit['commit_s']:.3f} s; regroup {admit['regroup_s']:.3f} "
              f"s; rescale + restore {admit['t_restored'] - admit['t_hook']:.3f}"
              f" s; steps lost {_lost(admit)} (restored step "
              f"{admit['restored_step']})")
    print(f"phase 5q (i) rank 2 (relaunched) on {card}: rejoin request -> "
          f"admission {v[2]['rejoin_s']:.3f} s; elastic resume "
          f"{v[2]['resume_s']:.3f} s")
    replay = summary["replay"]
    print(f"phase 5q (i) the first {len(replay['losses'])} post-shrink "
          f"losses {replay['survivor']} equal, bitwise, a fresh 2-rank run "
          f"restored from step {replay['step']}")
    out = {"fused_update": 0, "flash_fwd_tc": 0, "flash_bwd_dq_tc": 0,
           "flash_bwd_dkv_tc": 0}
    for r, verdict in v.items():
        rows = [w for w in verdict["rows"] if not w["rolled_back"]]
        c = verdict["counters"]
        print(f"phase 5q (i) rank {r}: {len(rows)} completed steps, "
              f"{sum(w['launches'] for w in rows)} K5-epilogue launches "
              f"over {sum(w['buckets'] for w in rows)} buckets; K1-K3 "
              f"launches {c.get('kernel.flash_fwd_launches', 0)}, "
              f"{c.get('kernel.flash_bwd_dq_launches', 0)}, "
              f"{c.get('kernel.flash_bwd_dkv_launches', 0)}")
        out["fused_update"] += c.get("kernel.fused_update_launches", 0)
        for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            out[k + "_tc"] += c.get(f"kernel.{k}_launches", 0)
    print(f"phase 5q (i): {summary['elapsed_s']:.1f} s for the fleet")
    return out


def elastic_autoscale(card: str, work: Path) -> dict:
    """Phase 5q (ii): `scripts.chaos_check --autoscale` with the MNIST
    example's net on the card: 2 ranks, a scale-up to 3, a SIGKILL and
    its relaunch, a drain and its backfill (epochs 1-5 with their signed
    deltas), then a cold start from the remote tier alone, restored at
    the newest upload and trained one step."""
    from dear_pytorch_tpu_torch.scripts import chaos_check as CK

    summary = CK.run_autoscale(_drill_args(
        work, "mnistnet", peer_timeout=_AUTOSCALE_TIMEOUT_S))
    if not summary["passed"]:
        print(summary.get("logs", "")[-12000:], file=sys.stderr)
        raise RuntimeError(f"phase 5q (ii) failed: {summary['failures']}")
    fused = 0
    for lives in summary["lives"].values():
        for v in lives:
            fused += v["counters"].get("kernel.fused_update_launches", 0)
            for t in v["transitions"]:
                if "t_restored" in t:
                    print(f"phase 5q (ii) rank {v['rank']} epoch "
                          f"{t['epoch']} ({t['kind']}, world {t['world']}) "
                          f"on {card}: commit {t['commit_s']:.3f} s, "
                          f"regroup {t.get('regroup_s', 0.0):.3f} s, "
                          f"rescale + restore "
                          f"{t['t_restored'] - t['t_hook']:.3f} s, steps "
                          f"lost {_lost(t)}")
    print(f"phase 5q (ii) on {card}: policy {summary['policy_decisions']}, "
          f"epochs 1-5 committed, cold start at step "
          f"{summary['cold']['restored_step']} (newest upload "
          f"{summary['newest_uploaded']}), {summary['steps_per_hour']:.0f} "
          f"steps/h over {summary['elapsed_s']:.1f} s")
    return {"fused_update": fused}


def elastic_phase(card: str) -> dict:
    """Phase 5q: (i) the GPT-2 elastic storm and (ii) the MNIST autoscale
    drill, side by side (two fleets of their own on the card, each with
    its own store and peer timeout); returns the K1-K3 (tensor-core
    routes) and K5-epilogue launches of every rank of both."""
    import concurrent.futures

    root = _ROOT / "build" / "chip_smoke" / "elastic"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    done = {}

    def timed(fn, key, work):
        out = fn(card, work)
        done[key] = time.perf_counter() - t0
        return out

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        storm = pool.submit(timed, elastic_storm, "i", root / "storm")
        auto = pool.submit(timed, elastic_autoscale, "ii",
                           root / "autoscale")
        out = storm.result()
        out["fused_update"] += auto.result()["fused_update"]
    print(f"phase 5q (i) done after {done['i']:.1f} s, (ii) after "
          f"{done['ii']:.1f} s")
    print(f"phase 5q launches: {out}")
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 5r: the multi-slice DCN leg on the card
# ---------------------------------------------------------------------------

#: (i): steps of the flat and the hierarchical GPT-2 run, and the limits
#: against each other: the loss (absolute) and each gathered parameter
#: (relative to the largest |parameter|)
_SLICE_STEPS = 4
_SLICE_LOSS_ATOL = 1e-3
_SLICE_PARAM_RTOL = 2e-4
#: (ii): the drills' peer timeout on the card (their strict DCN deadline
#: is 0.45 of it)
_SLICE_TIMEOUT_S = 10


def _slice_counts() -> dict:
    return {"fused_update": FS.fused_update_launches,
            "flash_fwd_tc": FA.flash_fwd_route_launches["tensor_core"],
            "flash_bwd_dq_tc": FA.flash_bwd_route_launches["dq"][
                "tensor_core"],
            "flash_bwd_dkv_tc": FA.flash_bwd_route_launches["dkv"][
                "tensor_core"]}


def slice_rank_worker(rank: int, out: Path) -> None:
    """One of the four ranks of phase 5r (i) (``--slice-rank R --out
    DIR``), sharing the card over gloo: GPT-2 small at 2 layers (full
    width, bf16, flash attention, B = 4 per rank, S = 1024, SGD momentum
    0.9, 25 MB buckets) from the seed-0 initial state, first as flat
    ``dear`` at world 4, then as the hierarchical step at 2 slices x 2
    ranks (`comm.backend.form_slice_groups`; a `FileTransport` under
    ``out`` for the DCN leg). Per run: the losses, the step times, the
    K5-epilogue and K1-K3 launches; for the hierarchical one the DCN
    leg's time per step by part and its host payload; the largest
    difference of the gathered parameters from the flat run's."""
    from dear_pytorch_tpu_torch.comm.dcn import DcnExchanger
    from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd
    from dear_pytorch_tpu_torch.resilience.cluster import FileTransport
    from dear_pytorch_tpu_torch.scripts import chaos_check as CK

    _join_two_ranks(rank, out, 4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = backend.init(_DEV)
    res, flat_params = {}, None
    for kind in ("flat", "hier"):
        model, loss_fn, batch_at, _, thr = CK._workload("gpt2", _DEV)
        kw = dict(optimizer=fused_sgd(lr=0.05, momentum=0.9),
                  threshold_mb=thr, device=_DEV)
        dcn = None
        if kind == "hier":
            backend.form_slice_groups(2)
            dcn = DcnExchanger(FileTransport(str(out / "dcn")),
                               local_slices=(backend.slice_id(),),
                               slices=(0, 1), timeout_s=120.0)
            ts = build_train_step(loss_fn, model, dcn=dcn, **kw)
        else:
            ts = build_train_step(loss_fn, model, group=group, **kw)
        state = ts.init()
        FA.reset_launch_counts()
        FS.fused_update_launches = 0
        losses, step_s, legs = [], [], []
        for i in range(_SLICE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = ts.step(state, batch_at(i, rank, 4))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if dcn is not None:
                legs.append(dict(ts.dcn_times))
        counts = _slice_counts()
        params = {k: v.float().cpu() for k, v in
                  ts.gather_params(state).items()}
        res[kind] = {"losses": losses, "step_s": step_s, "legs": legs,
                     "launches": counts, "buckets": ts.plan.num_buckets,
                     "updates": ts.update_launches,
                     "dcn_bytes": ts.dcn_bytes,
                     "exchanges": None if dcn is None else dcn.exchanges,
                     "dcn_fit": None if dcn is None else CK._fit_dcn(dcn)}
        if flat_params is None:
            flat_params = params
        else:
            res["param_diff"] = max(float((params[k] - v).abs().max())
                                    for k, v in flat_params.items())
            res["param_max"] = max(float(v.abs().max())
                                   for v in flat_params.values())
        ts.close()
        del ts, state, model
        gc.collect()
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    backend.shutdown()


def multislice_gpt2(card: str) -> dict:
    """Phase 5r (i): `slice_rank_worker` on four ranks sharing the card.
    The hierarchical losses within `_SLICE_LOSS_ATOL` of the flat run's
    and equal on every rank, the gathered parameters within
    `_SLICE_PARAM_RTOL` of the largest, one K5 epilogue per bucket per
    step on every rank (both runs), K1-K3 on their tensor-core routes (2
    launches each per step per rank: one per layer); prints the DCN leg's
    time per step by part and its bytes. Returns the launches over every
    rank and both runs."""
    handle = start_ranks(
        "slice", lambda r, out: ["--slice-rank", str(r), "--out", str(out)],
        world=4)
    ranks = wait_ranks(handle, 600.0)
    shutil.rmtree(handle[1], ignore_errors=True)   # the DCN leg's chunks
    out = {k: 0 for k in _slice_counts()}
    for r, res in enumerate(ranks):
        flat, hier = res["flat"], res["hier"]
        worst = max(abs(a - b) for a, b in zip(flat["losses"],
                                               hier["losses"]))
        _check(worst <= _SLICE_LOSS_ATOL,
               f"phase 5r (i) rank {r}: hierarchical losses {hier['losses']}"
               f" against flat {flat['losses']} (largest |diff| {worst:.3g},"
               f" limit {_SLICE_LOSS_ATOL})")
        _check(res["param_diff"] <= _SLICE_PARAM_RTOL * res["param_max"],
               f"phase 5r (i) rank {r}: gathered parameters' largest |diff| "
               f"{res['param_diff']:.3g} against {_SLICE_PARAM_RTOL} x "
               f"{res['param_max']:.4g}")
        _check(hier["losses"] == ranks[0]["hier"]["losses"],
               f"phase 5r (i) rank {r}: the exchanged loss mean is the same "
               f"on every rank ({hier['losses']})")
        for kind, run in (("flat", flat), ("hier", hier)):
            n = _SLICE_STEPS * run["buckets"]
            c = run["launches"]
            _check(c["fused_update"] == n and run["updates"] == n,
                   f"phase 5r (i) rank {r} {kind}: one K5 epilogue per "
                   f"bucket per step ({c['fused_update']} launches, "
                   f"{run['updates']} updates, want {n})")
            _check(all(c[k] == 2 * _SLICE_STEPS for k in
                       ("flash_fwd_tc", "flash_bwd_dq_tc",
                        "flash_bwd_dkv_tc")),
                   f"phase 5r (i) rank {r} {kind}: K1-K3 on tensor cores, "
                   f"2 each per step ({c})")
            for k in out:
                out[k] += c[k]
        _check(hier["exchanges"] == _SLICE_STEPS,
               f"phase 5r (i) rank {r}: {hier['exchanges']} exchanges")
    mb = ranks[0]["hier"]["dcn_bytes"] / 1e6
    print(f"phase 5r (i) GPT-2 small at 2 layers (bf16, flash, B = 4 per "
          f"rank, S = 1024, {ranks[0]['hier']['buckets']} buckets), 2 "
          f"slices x 2 ranks on {card}: losses {ranks[0]['hier']['losses']}"
          f" against flat world 4 {ranks[0]['flat']['losses']}; largest "
          f"parameter |diff| {max(r['param_diff'] for r in ranks):.3g} "
          f"(largest |parameter| {ranks[0]['param_max']:.4g})")
    for r, res in enumerate(ranks):
        legs = res["hier"]["legs"][1:]   # after the first step
        mean = {k: sum(x[k] for x in legs) / len(legs) for k in legs[0]}
        print(f"phase 5r (i) rank {r} on {card}: hierarchical step "
              f"{np.median(res['hier']['step_s'][1:]) * 1e3:.1f} ms, flat "
              f"{np.median(res['flat']['step_s'][1:]) * 1e3:.1f} ms "
              f"(medians after the first step); the DCN leg per step (mean "
              f"of steps 2-{_SLICE_STEPS}): the wait for the backward's "
              f"reduce-scatters {mean['rs_wait_s'] * 1e3:.1f} ms, slice "
              f"gathers {mean['gather_s'] * 1e3:.1f} ms, to the host "
              f"{mean['to_host_s'] * 1e3:.1f} ms, exchange and agreement "
              f"{mean['exchange_s'] * 1e3:.1f} ms, back to the card "
              f"{mean['to_device_s'] * 1e3:.1f} ms; {mb:.1f} MB of fp32 "
              f"gradient a slice per step, published as base64 text (4/3 "
              f"of it, by every rank of the slice: the FileTransport "
              f"stands in for a network, and the framing is its cost); "
              f"fit_dcn over its 4 MB chunk fetches "
              + ("n/a" if res["hier"]["dcn_fit"] is None else
                 f"alpha {res['hier']['dcn_fit'][0]:.3e} s, beta "
                 f"{res['hier']['dcn_fit'][1]:.3e} s/B"))
    return out


def multislice_drill(card: str, work: Path, flap: bool) -> dict:
    """Phase 5r (ii) / (iii): `scripts.chaos_check --multislice` (or
    ``--multislice-flap``) with the MNIST net on the card, 2 slices x 2
    ranks, with JAX's verdicts; prints per survivor the time from the
    victims' death to the shrink's commit, the renorms, the degraded
    steps, the time to the readmission, the steps lost at each transition
    and the `fit_dcn` α-β of its exchanger's samples. Returns the K5
    epilogue's launches of every final life."""
    from dear_pytorch_tpu_torch.scripts import chaos_check as CK

    label = "--multislice-flap" if flap else "--multislice"
    run = CK.run_multislice_flap if flap else CK.run_multislice
    summary = run(_drill_args(work / label.strip("-"), "mnistnet",
                              peer_timeout=_SLICE_TIMEOUT_S))
    if not summary["passed"]:
        print(summary.get("logs", "")[-12000:], file=sys.stderr)
        raise RuntimeError(
            f"phase 5r {label} failed: {summary['failures']}")
    for r, st in sorted(summary["story"].items()):
        if st["death_to_commit_s"] is not None:
            print(f"phase 5r {label} rank {r} on {card}: death -> "
                  f"shrink commit {st['death_to_commit_s']:.3f} s (DCN "
                  f"deadline {0.45 * _SLICE_TIMEOUT_S:g} s, peer timeout "
                  f"{_SLICE_TIMEOUT_S} s); {st['renorms']} renorms; "
                  f"{st['degraded_steps']} degraded steps; shrink -> "
                  f"readmission commit {st['readmit_s']:.3f} s; steps "
                  f"lost {st['steps_lost']}")
        _check(all(n is None or n >= 0 for n in st["steps_lost"]),
               f"phase 5r {label} rank {r}: steps lost "
               f"{st['steps_lost']}")
        fit = st["dcn_fit"]
        print(f"phase 5r {label} rank {r}: fit_dcn "
              + ("n/a (too few samples)" if fit is None else
                 f"alpha {fit[0]:.3e} s, beta {fit[1]:.3e} s/B")
              + f"; {st['degraded_rounds']} degraded rounds; last "
              f"step's DCN leg {st['dcn_times']}")
    print(f"phase 5r {label} on {card}: passed in "
          f"{summary['elapsed_s']:.1f} s")
    return {"fused_update": sum(
        v["counters"].get("kernel.fused_update_launches", 0)
        for v in summary["finals"].values())}


def multislice_phase(card: str) -> dict:
    """Phase 5r: (i) the GPT-2 hierarchical check, (ii) the MNIST
    ``--multislice`` drill and (iii) ``--multislice-flap``, side by side
    (three fleets of four ranks on the card, each with its own store);
    returns the K5-epilogue and K1-K3 (tensor-core) launches of all
    three."""
    import concurrent.futures

    root = _ROOT / "build" / "chip_smoke" / "multislice"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    done = {}

    def timed(fn, key, *a):
        result = fn(card, *a)
        done[key] = time.perf_counter() - t0
        return result

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        gpt = pool.submit(timed, multislice_gpt2, "i")
        kill = pool.submit(timed, multislice_drill, "ii", root, False)
        flap = pool.submit(timed, multislice_drill, "iii", root, True)
        out = gpt.result()
        out["fused_update"] += (kill.result()["fused_update"]
                                + flap.result()["fused_update"])
    print(f"phase 5r (i) done after {done['i']:.1f} s, (ii) after "
          f"{done['ii']:.1f} s, (iii) after {done['iii']:.1f} s")
    print(f"phase 5r launches: {out}")
    shutil.rmtree(root, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 5s: sequence parallelism on the card
# ---------------------------------------------------------------------------

#: (ii)-(iv): 3 steps of SGD (lr 0.05, momentum 0.9: JAX's SP test's) from
#: the seed-0 weights, dropout off
_SP_STEPS = 3
_SP_LR = 0.05
#: the losses against one rank's (JAX's SP tolerance,
#: tests/test_sp_training.py:207), and the bf16 run against the fp32 one
_SP_LOSS_RTOL = 2e-4
_SP_BF16_RTOL = 1e-2
#: the parameters after the steps against one rank's, over the largest
#: entry of each one's reference update (`_sp_param_errs`): fp32 runs, and
#: the bf16 run against the fp32 reference; the update's floor, a share of
#: the model's largest. On an H100 the fp32 runs read up to 1.2e-3 and the
#: bf16 run 2.0e-2 (PERF.md): the fp32 limit lies between them
_SP_PARAM_RTOL = 5e-3
_SP_BF16_PARAM_RTOL = 0.1
_SP_UPDATE_FLOOR = 1e-3
#: GPT-2 small at full width: B = 4 sequences of 1024; BERT-Base: 8 of 128
_SP_GPT_B, _SP_GPT_S = 4, 1024
_SP_BERT_B, _SP_BERT_S = 8, 128
_SP_GPT_SCHEMES = ("ring", "ring_flash", "ulysses", "zigzag")
_SP_BERT_SCHEMES = ("ring_flash", "ulysses")
#: (iv)'s depth: GPT-2 at 2 layers, dp 2 x sp 2
_SP_2X2_LAYERS = 2


def _sp_shapes(gen):
    """(i)'s shapes: (label, folded q, k, v, mask, dO, causal), each pair
    of phase 5s's runs in bf16 and in fp32 in: GPT-2's at S/sp = 512 (B =
    4, H = 12: 48 folded rows; the causal aligned pair, the full pair with
    a key mask, the zigzag half-q and half-k pairs at 256) and
    BERT-Base's at S = 128, sp = 2 (B = 8: 96 rows, a padding mask)."""
    out = []
    B, S, c = _SP_GPT_B, _SP_GPT_S // 2, _SP_GPT_S // 4
    Bb, Sb = _SP_BERT_B, _SP_BERT_S // 2
    lengths = [max(1, Sb - (13 * b) % Sb) for b in range(Bb)]

    def folded(*case):
        return [_fold(x) if x.dim() == 4 else x.repeat_interleave(_H, 0)
                for x in case]

    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        q, k, v, m = folded(*_case(gen, B, S, S, dt, True))
        do = torch.randn(q.shape, generator=gen, device=_DEV).to(dt)
        hq, hk, hv, hm = folded(*_case(gen, B, S, S, dt, False, holey=True))
        bq, bk, bv, bm = folded(*_case(gen, Bb, Sb, Sb, dt, False,
                                       lengths=lengths))
        bdo = torch.randn(bq.shape, generator=gen, device=_DEV).to(dt)
        out += [
            (f"gpt2 causal aligned pair, {name} in", q, k, v, m, do, True),
            (f"gpt2 full pair, key mask, {name} in", hq, hk, hv, hm, do,
             False),
            (f"gpt2 zigzag half-q pair, {name} in", q[:, c:], k, v, m,
             do[:, c:], False),
            (f"gpt2 zigzag half-k pair, {name} in", q, k[:, :c], v[:, :c],
             m[:, :c], do, False),
            (f"bert-base full pair, padding mask, {name} in", bq, bk, bv, bm,
             bdo, False)]
    return out


def sp_kernel_rows(hbm) -> dict:
    """Phase 5s (i): K1, K2 and K3 through the ring's wrappers
    (`flash_pair_fwd` / `flash_pair_dq` / `flash_pair_dkv`, fp32 out) at
    SP's pair shapes (`_sp_shapes`, bf16 and fp32 in), each call
    route-checked (CUDA cores), held against its plain version (K1 within
    2e-5 of the fp32 plain output and 2e-4 in lse, K2/K3 within 1e-4 of the
    largest |plain value|: `time_shape`'s and `check_bwd_kernels`'
    tolerances for fp32 out), then timed beside the plain versions, SDPA on
    the same operands (the forward, or its backward for dq + dk + dv; it
    has no fp32-out form for bf16 inputs), for bf16 inputs the same call
    with bf16 out (the tensor-core routes, held within 2e-2: the yardstick
    of ROADMAP Queue 2 item 1), and the card's bound (bytes over the
    card's memory rate; operations over 989 TF/s bf16 or 67 TF/s fp32).
    The inputs are one set, warm in L2 (3-6 MB a pair). Returns the rows
    by (kernel, label), each with its own largest error."""
    gen = torch.Generator(device=_DEV).manual_seed(21)
    rows = {}
    for label, q, k, v, m, do, causal in _sp_shapes(gen):
        t_case = time.perf_counter()
        scale = q.shape[-1] ** -0.5
        BH, Sq, D = q.shape
        Sk = k.shape[1]
        dt, es = q.dtype, q.element_size()
        o, lse = _routed(f"phase 5s {label}", "cuda_core",
                         lambda: FA.flash_pair_fwd(
                             q, k, v, m, scale, causal,
                             out_dtype=torch.float32))
        ref, ref_lse = FA.flash_pair_fwd_reference(
            q, k, v, m, scale, causal, out_dtype=torch.float32)
        delta = (do.float() * ref).sum(-1)
        args = (q, k, v, m, do, ref_lse, delta, scale, causal)
        got = _bwd_routed(f"phase 5s {label}", "cuda_core", lambda: (
            FA.flash_pair_dq(*args, out_dtype=torch.float32),
            *FA.flash_pair_dkv(*args, out_dtype=torch.float32)))
        want = (FA.flash_pair_dq_reference(*args, out_dtype=torch.float32),
                *FA.flash_pair_dkv_reference(*args,
                                             out_dtype=torch.float32))
        torch.cuda.synchronize()
        e_fwd = float((o - ref).abs().max())
        e_lse = float((lse - ref_lse).abs().max())
        e_bwd = [_rel(g, w) for g, w in zip(got, want)]
        _check(bool(torch.isfinite(o).all()) and e_fwd <= 2e-5
               and e_lse <= 2e-4,
               f"phase 5s {label}: K1 disagrees with its plain version "
               f"(|o| {e_fwd:.3e}, lse {e_lse:.3e})")
        _check(all(bool(torch.isfinite(g).all()) and r <= 1e-4
                   for g, (_, r) in zip(got, e_bwd)),
               f"phase 5s {label}: K2/K3 disagree with their plain "
               f"versions {e_bwd}")
        errs = {"flash_fwd": e_fwd, "flash_bwd_dq": e_bwd[0][0],
                "flash_bwd_dkv": max(e_bwd[1][0], e_bwd[2][0])}
        bf = torch.bfloat16
        if dt == bf:
            # the yardstick of ROADMAP Queue 2 item 1: the same calls with
            # bf16 out take the tensor-core routes; held at 2e-2
            o_tc, _ = _routed(f"phase 5s {label} bf16 out", "tensor_core",
                              lambda: FA.flash_pair_fwd(
                                  q, k, v, m, scale, causal, out_dtype=bf))
            tc = _bwd_routed(f"phase 5s {label} bf16 out", "tensor_core",
                             lambda: (FA.flash_pair_dq(*args, out_dtype=bf),
                                      *FA.flash_pair_dkv(*args,
                                                         out_dtype=bf)))
            torch.cuda.synchronize()
            _check(float((o_tc.float() - ref).abs().max()) <= 2e-2
                   and all(_rel(g, w)[1] <= 2e-2 for g, w in zip(tc, want)),
                   f"phase 5s {label}: the tensor-core routes (bf16 out) "
                   "disagree with the plain versions")
            del o_tc, tc
        print(f"phase 5s (i) {label} [{BH}, {Sq}/{Sk}, {D}], fp32 out: "
              f"max|o - plain| {e_fwd:.3e}, lse {e_lse:.3e}; dq, dk, dv rel "
              f"{[round(r, 9) for _, r in e_bwd]}")
        del o, lse, got
        sets = [(q, k, v, m, do, ref_lse, delta)]
        # SDPA on the same operands ([B*H, 1, S, D]; a key mask as a
        # boolean attn_mask): its forward, and its backward (dq, dk, dv)
        sq, sk, sv = (t[:, None] for t in (q, k, v))
        amask = None if causal else m.bool()[:, None, None, :]
        sdpa_fwd = device_ms(lambda *_: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=amask, is_causal=causal), sets, 50)
        xs = [t.detach().clone().requires_grad_() for t in (sq, sk, sv)]
        out = F.scaled_dot_product_attention(*xs, attn_mask=amask,
                                             is_causal=causal)
        sdpa_bwd = device_ms(lambda *_: torch.autograd.grad(
            out, xs, do[:, None], retain_graph=True), sets, 20)
        del xs, out
        pairs = BH * (Sq * (Sq + 1) // 2 if causal else Sq * Sk)
        ctx = {"shape": f"{label} [{BH}, {Sq}, {Sk}, {D}]",
               "dtype": f"{str(dt).replace('torch.', '')} in, float32 out",
               "route": "cuda_core", "Sq": Sq, "Sk": Sk, "causal": causal,
               "in_dtype": str(dt).replace("torch.", "")}
        for name, fn, plain, flops, nbytes, lib, scope, tc_fn in (
                ("flash_fwd",
                 lambda *a: FA.flash_pair_fwd(a[0], a[1], a[2], a[3], scale,
                                              causal,
                                              out_dtype=torch.float32),
                 lambda *a: FA.flash_pair_fwd_reference(
                     a[0], a[1], a[2], a[3], scale, causal,
                     out_dtype=torch.float32),
                 4 * D * pairs,
                 BH * (Sq * D * (es + 4) + 2 * Sk * D * es + Sq * 4 + Sk * 4),
                 sdpa_fwd, "forward",
                 lambda *a: FA.flash_pair_fwd(a[0], a[1], a[2], a[3], scale,
                                              causal, out_dtype=bf)),
                ("flash_bwd_dq",
                 lambda *a: FA.flash_pair_dq(*a, scale, causal,
                                             out_dtype=torch.float32),
                 lambda *a: FA.flash_pair_dq_reference(
                     *a, scale, causal, out_dtype=torch.float32),
                 6 * D * pairs,
                 BH * (Sq * D * (es + es + 4) + 2 * Sk * D * es + 2 * Sq * 4
                       + Sk * 4),
                 sdpa_bwd, "dq+dk+dv",
                 lambda *a: FA.flash_pair_dq(*a, scale, causal,
                                             out_dtype=bf)),
                ("flash_bwd_dkv",
                 lambda *a: FA.flash_pair_dkv(*a, scale, causal,
                                              out_dtype=torch.float32),
                 lambda *a: FA.flash_pair_dkv_reference(
                     *a, scale, causal, out_dtype=torch.float32),
                 8 * D * pairs,
                 BH * (Sq * D * (es + es) + 2 * Sk * D * (es + 4)
                       + 2 * Sq * 4 + Sk * 4),
                 sdpa_bwd, "dq+dk+dv",
                 lambda *a: FA.flash_pair_dkv(*a, scale, causal,
                                              out_dtype=bf))):
            if name == "flash_fwd":
                k_sets = [s_[:4] for s_ in sets]
            else:
                k_sets = sets
            ms = device_ms(fn, k_sets, 20)
            plain_ms = device_ms(plain, k_sets, 4)
            tc_ms = device_ms(tc_fn, k_sets, 20) if dt == bf else None
            bytes_ms = nbytes / hbm * 1e3
            ops_ms = flops / _PEAK_FLOPS[dt] * 1e3
            row = ctx | {
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "flops": flops, "tflops": flops / ms / 1e9,
                "max_abs_err": errs[name],
                "library_ms": lib, "library_scope": scope,
                "library_note": "SDPA on the same operands, in their dtype",
                "tensor_core_bf16_out_ms": tc_ms}
            rows[name, label] = row
            print("kernel time " + json.dumps({"kernel": name} | row))
        print(f"phase 5s (i) {label}: {time.perf_counter() - t_case:.1f} s")
    return rows


def _sp_expected(scheme: str, causal: bool, sp: int, sp_rank: int,
                 layers: int) -> int:
    """K1 launches per step of one rank (and as many of K2 and of K3) by
    `parallel.ring_attention`'s branch map: the flash ring runs one pair a
    hop, but a causal sequential ring skips the later blocks (sp rank i
    runs i + 1 pairs); the zigzag ring runs one (half) pair every hop; the
    dense ring and Ulysses launch none."""
    if scheme == "zigzag":
        per_layer = sp
    elif scheme == "ring_flash":
        per_layer = sp_rank + 1 if causal else sp
    else:
        per_layer = 0
    return per_layer * layers


def _sp_run(model, loss_fn, batch, group, ref=None, reference=False, **kw):
    """`_SP_STEPS` steps of ``model`` on ``batch`` over ``group``, counts
    zeroed just before the steps. Returns the results and, for a
    ``reference`` run, its (initial, final) parameters by name (else
    None): losses, step seconds, K1-K3 launches by
    route and by shape, the K5 epilogue's, the ring's hops, exposed p2p
    seconds, the plan's buckets; with ``ref`` (a reference run's initial
    and final parameters) also the parameter check (`_sp_param_errs`)."""
    from dear_pytorch_tpu_torch.ops.fused_sgd import fused_sgd
    from dear_pytorch_tpu_torch.parallel import ring_attention as RA

    t_run = time.perf_counter()
    ts = build_train_step(loss_fn, model, group=group, device=_DEV,
                          optimizer=fused_sgd(lr=_SP_LR, momentum=0.9), **kw)
    state = ts.init()
    first = ts.gather_params(state) if reference else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    FA.reset_launch_counts()
    FS.fused_update_launches = 0
    RA.reset_counts()
    losses, step_s = [], []
    for _ in range(_SP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = ts.step(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    res = {"losses": losses, "step_s": step_s,
           "fwd": dict(FA.flash_fwd_route_launches),
           "dq": dict(FA.flash_bwd_route_launches["dq"]),
           "dkv": dict(FA.flash_bwd_route_launches["dkv"]),
           "shapes": [list(k) + [n]
                      for k, n in FA.flash_shape_launches.items()],
           "fused_update": FS.fused_update_launches,
           "updates": ts.update_launches, "buckets": ts.plan.num_buckets,
           "mean_world": ts.mean_world, "hops": RA.ring_hops,
           "p2p_s": RA.ring_p2p_s,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    final = ts.gather_params(state)     # collective: every rank gathers
    if ref is not None:
        res["params"] = _sp_param_errs(final, *ref)
    ts.close()
    del ts, state
    gc.collect()
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_run
    return res, ((first, final) if reference else None)


def _sp_param_errs(got: dict, first: dict, final: dict) -> dict:
    """``got``'s parameters against a reference run's ``final`` ones, by
    name: the largest |got - final| of each over the largest entry of that
    parameter's reference update |final - first|, floored at
    `_SP_UPDATE_FLOOR` of the largest update in the model; the worst, and
    where. (3 steps move the weights by far less than their size, so
    relative to the weights a wrong gradient would read small; and a
    parameter's own update can be 0, as the key bias's is: softmax ignores
    a per-query constant.)"""
    _check(sorted(got) == sorted(final), "phase 5s: the SP model's "
           "parameter names differ from the one-rank model's")
    step = {n: float((ref - first[n]).abs().max())
            for n, ref in final.items()}
    floor = _SP_UPDATE_FLOOR * max(step.values())
    err = {n: float((got[n] - ref).abs().max()) / max(step[n], floor)
           for n, ref in final.items()}
    at = max(err, key=err.get)
    return {"of_update": err[at], "at": at, "update": step[at]}


def sp_rank_worker(rank: int, out: Path) -> None:
    """One of the four ranks of phase 5s (``--sp-rank R --out DIR``),
    sharing the card over gloo, fp32 (no TF32), dropout off:

      - rank 0 alone (a one-rank group) trains the references: GPT-2 small
        (12 layers, B = 4, S = 1024) and at 2 layers, BERT-Base (B = 8, S
        = 128, rows padded), the dense models;
      - ranks 0 and 1 (dp 1 x sp 2, `comm.backend.form_sp_groups(2,
        ranks=[0, 1])`) train GPT-2 small with each of `_SP_GPT_SCHEMES`
        and ring_flash in bf16, BERT-Base with `_SP_BERT_SCHEMES`;
      - all four (dp 2 x sp 2) train GPT-2 at 2 layers with ring_flash.

    Every run holds the same global batch, the seed-0 weights and
    ``mean_axes=("dp",)`` (the references: one rank). Rank 0 keeps the
    references' initial and final parameters on the card and holds each
    SP run's gathered parameters against them (`_sp_param_errs`; the
    gather is an all-gather, so every rank of a run holds the same ones).
    Writes each run's `_sp_run` results."""
    import torch.distributed as dist

    from dear_pytorch_tpu_torch.parallel import sp as SP
    from dear_pytorch_tpu_torch.parallel.ring_attention import (
        zigzag_permutation,
    )

    _join_two_ranks(rank, out, 4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend.init(_DEV)
    pair, one = dist.new_group([0, 1]), dist.new_group([0])
    gen = torch.Generator(device=_DEV)
    cfg = dropout_free(gpt_config("gpt2", dtype=torch.float32))
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=_SP_2X2_LAYERS)
    bcfg = dropout_free(BERT.BERT_BASE)
    gpt_batch = synthetic_gpt_batch(gen.manual_seed(0), _SP_GPT_B,
                                    seq_len=_SP_GPT_S,
                                    vocab_size=cfg.vocab_size)
    bert_batch = synthetic_bert_batch(gen.manual_seed(0), _SP_BERT_B,
                                      seq_len=_SP_BERT_S,
                                      vocab_size=bcfg.vocab_size,
                                      device=_DEV)
    # padded rows: sentence b keeps its first 128 - 9 b tokens
    keep = (torch.arange(_SP_BERT_S, device=_DEV)[None, :]
            < (_SP_BERT_S - 9 * torch.arange(_SP_BERT_B, device=_DEV))[
                :, None])
    bert_batch["attention_mask"] = keep.to(
        bert_batch["attention_mask"].dtype)

    def gpt_loss(m, b):
        return gpt_lm_loss(m(b["input_ids"], train=True), b["input_ids"],
                           vocab_size=cfg.vocab_size)

    def bert_loss(m, b):
        logits, nsp = m(b["input_ids"], b["token_type_ids"],
                        b["attention_mask"], train=True)
        return BERT.bert_pretraining_loss(logits, nsp, b["masked_lm_labels"],
                                          b["next_sentence_labels"])

    res, refs = {}, {}
    if rank == 0:
        for key, model, loss in (
                ("gpt", GptLmHeadModel(cfg, device=_DEV, seed=0), gpt_loss),
                ("bert", BERT.BertForPreTraining(bcfg, device=_DEV, seed=0),
                 bert_loss),
                ("gpt2x2", GptLmHeadModel(cfg2, device=_DEV, seed=0),
                 gpt_loss)):
            batch = bert_batch if key == "bert" else gpt_batch
            res[f"ref.{key}"], refs[key] = _sp_run(model, loss, batch, one,
                                                   reference=True)
            del model
    backend.barrier()

    def gpt_sp(c, scheme, group, ref):
        model = SP.sp_gpt_model(c, attention=scheme, device=_DEV, seed=0)
        zigzag = scheme == "zigzag"
        batch = gpt_batch
        if zigzag:
            perm = torch.as_tensor(zigzag_permutation(_SP_GPT_S,
                                                      backend.sp_size()),
                                   device=_DEV)
            batch = {"input_ids": batch["input_ids"][:, perm]}
        loss_fn = SP.make_sp_gpt_loss_fn(model, vocab_size=c.vocab_size,
                                         zigzag=zigzag)
        return _sp_run(model, loss_fn, SP.shard_sp_batch(batch), group,
                       ref=refs.get(ref), mean_axes=("dp",))[0]

    backend.form_sp_groups(2, ranks=[0, 1])
    if rank < 2:
        for scheme in _SP_GPT_SCHEMES:
            res[f"gpt.{scheme}"] = gpt_sp(cfg, scheme, pair, "gpt")
        res["gpt.ring_flash_bf16"] = gpt_sp(
            dataclasses.replace(cfg, dtype=torch.bfloat16), "ring_flash",
            pair, "gpt")
        for scheme in _SP_BERT_SCHEMES:
            model = SP.sp_bert_model(bcfg, attention=scheme, device=_DEV,
                                     seed=0)
            res[f"bert.{scheme}"] = _sp_run(
                model, SP.make_sp_bert_loss_fn(model),
                SP.shard_sp_batch(bert_batch), pair, ref=refs.get("bert"),
                mean_axes=("dp",))[0]
    backend.barrier()
    backend.form_sp_groups(2)
    res["gpt2x2.ring_flash"] = gpt_sp(cfg2, "ring_flash", None, "gpt2x2")
    refs.clear()
    res["layout"] = [backend.dp_rank(), backend.sp_rank()]
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    backend.shutdown()


def _sp_check_run(label, run, ref, r, sp_rank, scheme, causal, layers,
                  rtol=_SP_LOSS_RTOL, prtol=_SP_PARAM_RTOL, dp=1) -> None:
    """One rank's run against the one-rank reference: its losses within
    ``rtol``, its parameters (rank 0 holds the check) within ``prtol`` of
    the reference's update (`_sp_param_errs`), its launches against the
    branch map's count, one K5 epilogue per bucket per step."""
    worst = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                    ref["losses"]))
    _check(all(np.isfinite(run["losses"])) and worst <= rtol,
           f"phase 5s {label} rank {r}: losses {run['losses']} against one "
           f"rank's {ref['losses']} (largest relative |diff| {worst:.3g}, "
           f"limit {rtol})")
    p = run.get("params")
    _check((p is not None) == (r == 0),
           f"phase 5s {label} rank {r}: the parameter check ran "
           f"{'nowhere' if p is None else 'off rank 0'}")
    if p is not None:
        _check(p["of_update"] <= prtol,
               f"phase 5s {label}: parameters against one rank's "
               f"{p['of_update']:.3g} of the update, at {p['at']} (limit "
               f"{prtol})")
    want = _sp_expected(scheme, causal, 2, sp_rank, layers) * _SP_STEPS
    for w in ("fwd", "dq", "dkv"):
        c = run[w]
        _check(c["cuda_core"] == want and sum(c.values()) == want,
               f"phase 5s {label} rank {r}: {w} launches by route {c}, "
               f"predicted {want} on CUDA cores")
    n = _SP_STEPS * run["buckets"]
    _check(run["fused_update"] == n and run["updates"] == n
           and run["mean_world"] == dp,
           f"phase 5s {label} rank {r}: {run['fused_update']} K5 epilogue "
           f"launches, {run['updates']} updates (want {n}), mean_world "
           f"{run['mean_world']} (want {dp})")
    print(f"phase 5s {label} rank {r}: losses {run['losses']} (one rank "
          f"{ref['losses']}; largest relative |diff| {worst:.3g})"
          f"; K1/K2/K3 launches {run['fwd']['cuda_core']}/"
          f"{run['dq']['cuda_core']}/{run['dkv']['cuda_core']} on CUDA "
          f"cores, predicted {want} each; K5 epilogue {run['fused_update']}")


def sp_phase(card: str) -> dict:
    """Phase 5s: (i) `sp_kernel_rows` in this process, then
    `sp_rank_worker` on four ranks sharing the card: every SP run's losses
    within `_SP_LOSS_RTOL` of one rank's on the same global batch (the bf16
    ring_flash run within `_SP_BF16_RTOL` of the fp32 one) and its
    parameters within `_SP_PARAM_RTOL` (`_SP_BF16_PARAM_RTOL`), the same
    losses on both ranks, K1-K3 launches equal to the branch map's
    prediction and all at shapes that (i) holds, one K5 epilogue per
    bucket per step; prints the step p50 per scheme beside the one-rank
    step, the ring's transfer time per step and the launches. Returns the
    kernel rows, each with its launches in the runs, and the launches over
    every rank and run."""
    t0 = time.perf_counter()
    hbm = probe.memory_rate(torch.cuda.get_device_name(0))
    rows = sp_kernel_rows(hbm)
    print(f"phase 5s (i): {time.perf_counter() - t0:.1f} s")
    handle = start_ranks(
        "sp", lambda r, out: ["--sp-rank", str(r), "--out", str(out)],
        world=4)
    ranks = wait_ranks(handle, 600.0)
    shutil.rmtree(handle[1], ignore_errors=True)
    ref = ranks[0]
    L = GPT2_SMALL.num_hidden_layers
    for key, run in ref.items():         # every reading before any check
        if isinstance(run, dict) and "params" in run:
            p = run["params"]
            print(f"phase 5s {key}: parameters against one rank's, largest "
                  f"|diff| {p['of_update']:.3g} of the update at {p['at']} "
                  f"(its update {p['update']:.3g})")
    for r in (0, 1):
        res = ranks[r]
        for scheme in _SP_GPT_SCHEMES:
            _sp_check_run(f"(ii) GPT-2 {scheme}", res[f"gpt.{scheme}"],
                          ref["ref.gpt"], r, r, scheme, True, L)
        bf16 = res["gpt.ring_flash_bf16"]
        _sp_check_run("(ii) GPT-2 ring_flash bf16", bf16, ref["ref.gpt"], r,
                      r, "ring_flash", True, L, rtol=_SP_BF16_RTOL,
                      prtol=_SP_BF16_PARAM_RTOL)
        for scheme in _SP_BERT_SCHEMES:
            _sp_check_run(f"(iii) BERT-Base {scheme}",
                          res[f"bert.{scheme}"], ref["ref.bert"], r, r,
                          scheme, False, BERT.BERT_BASE.num_hidden_layers)
        for key in [k for k in res if "." in k and not k.startswith("ref")]:
            _check(res[key]["losses"] == ranks[0][key]["losses"],
                   f"phase 5s {key}: rank {r}'s losses differ from rank 0's")
    for r, res in enumerate(ranks):
        _check(res["layout"] == [r // 2, r % 2],
               f"phase 5s (iv) rank {r}: dp, sp index {res['layout']}")
        _sp_check_run("(iv) GPT-2 2 layers 2x2 ring_flash",
                      res["gpt2x2.ring_flash"], ref["ref.gpt2x2"], r, r % 2,
                      "ring_flash", True, _SP_2X2_LAYERS, dp=2)
    runs = [(f"rank {r} {key}", run) for r, res in enumerate(ranks)
            for key, run in res.items() if isinstance(run, dict)]
    for label, run in runs:
        steps = len(run["step_s"])
        print(f"phase 5s {label} on {card}: step p50 "
              f"{np.median(run['step_s']) * 1e3:.1f} ms (all "
              f"{[round(x * 1e3, 1) for x in run['step_s']]}); ring hops "
              f"{run['p2p_s'] / steps * 1e3:.1f} ms a step blocked in "
              f"{run['hops'] // steps} hops after the card drained (the "
              f"transfer through the host and the wait for the peer; "
              f"synchronous, so no overlap with the kernels)"
              + (" (the forward's: the backward's hops run inside "
                 "autograd, untimed)" if label.endswith(".ring") else "")
              + f"; K5 epilogue "
              f"{run['fused_update']} launches over {run['buckets']} "
              f"buckets; peak memory {run['peak_bytes'] / 2**30:.2f} GiB; "
              f"the run {run['wall_s']:.1f} s from its build")
    launches = {"fused_update": 0}
    shapes: dict = {}
    for w in ("fwd", "dq", "dkv"):
        launches[w] = sum(run[w]["cuda_core"] for _, run in runs)
        _check(sum(sum(v for k, v in run[w].items() if k != "cuda_core")
                   for _, run in runs) == 0,
               f"phase 5s: {w} launches off the CUDA-core route")
    for _, run in runs:
        launches["fused_update"] += run["fused_update"]
        for *key, n in run["shapes"]:
            shapes[tuple(key)] = shapes.get(tuple(key), 0) + n
    which = {"flash_fwd": "fwd", "flash_bwd_dq": "dq",
             "flash_bwd_dkv": "dkv"}
    for (kname, _), row in rows.items():
        row["launches"] = shapes.get((which[kname], row["route"], row["Sq"],
                                      row["Sk"], row["causal"],
                                      row["in_dtype"]), 0)
    for kname, w in which.items():
        in_rows = sum(r_["launches"] for (kn, _), r_ in rows.items()
                      if kn == kname)
        _check(in_rows == launches[w],
               f"phase 5s: {launches[w]} {kname} launches in the runs, "
               f"{in_rows} at the shapes (i) holds: "
               f"{sorted(k_ for k_ in shapes if k_[0] == w)}")
    print(f"phase 5s launches over every rank and run: K1 {launches['fwd']}, "
          f"K2 {launches['dq']}, K3 {launches['dkv']} (CUDA cores), the K5 "
          f"epilogue {launches['fused_update']}; by (kernel, route, Sq, Sk, "
          f"causal, input dtype): {sorted(shapes.items())}")
    return {"rows": rows, "launches": launches}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kernels_only = argv == ["--kernels-only"]
    harness_only = argv == ["--phase", "5o"]
    worker = len(argv) == 6 and argv[0::2] == ["--train-rank", "--out",
                                               "--mode"]
    bert_worker = len(argv) == 6 and argv[0::2] == ["--bert-rank", "--out",
                                                    "--mode"]
    probe_worker = len(argv) == 4 and argv[0::2] == ["--probe-rank",
                                                     "--out"]
    modes_worker = len(argv) == 4 and argv[0::2] == ["--modes-rank",
                                                     "--out"]
    comp_worker = len(argv) == 4 and argv[0::2] == ["--comp-rank", "--out"]
    guard_only = argv == ["--phase", "5p"]
    elastic_only = argv == ["--phase", "5q"]
    multislice_only = argv == ["--phase", "5r"]
    slice_worker = len(argv) == 4 and argv[0::2] == ["--slice-rank", "--out"]
    sp_only = argv == ["--phase", "5s"]
    sp_worker = len(argv) == 4 and argv[0::2] == ["--sp-rank", "--out"]
    guard_worker = len(argv) == 8 and argv[0::2] == [
        "--guard-rank", "--world", "--out", "--cases"]
    resume_worker = len(argv) == 6 and argv[0::2] == [
        "--guard-resume", "--out", "--steps"]
    if argv and not (kernels_only or harness_only or worker or bert_worker
                     or probe_worker or modes_worker or comp_worker
                     or guard_only or guard_worker or resume_worker
                     or elastic_only or multislice_only or slice_worker
                     or sp_only or sp_worker):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's chip check needs the "
              "card", file=sys.stderr)
        return 1
    if worker:                   # one rank of phase 5b, spawned below
        rank_worker(int(argv[1]), Path(argv[3]), argv[5])
        return 0
    if bert_worker:              # one rank of phase 5k, spawned below
        bert_rank_worker(int(argv[1]), Path(argv[3]), argv[5])
        return 0
    if probe_worker:             # one rank of phase 5c, spawned below
        probe_rank_worker(int(argv[1]), Path(argv[3]))
        return 0
    if modes_worker:             # one rank of phase 5l, spawned below
        modes_rank_worker(int(argv[1]), Path(argv[3]))
        return 0
    if comp_worker:              # one rank of phase 5m, spawned below
        comp_rank_worker(int(argv[1]), Path(argv[3]))
        return 0
    if guard_worker:             # one rank of phase 5p (iii)
        guard_rank_worker(int(argv[1]), int(argv[3]), Path(argv[5]),
                          argv[7].split(","))
        return 0
    if resume_worker:            # the resumed process of phase 5p (i)
        guard_resume_worker(argv[1], Path(argv[3]), int(argv[5]))
        return 0
    if slice_worker:             # one rank of phase 5r (i)
        slice_rank_worker(int(argv[1]), Path(argv[3]))
        return 0
    if sp_worker:                # one rank of phase 5s (ii)-(iv)
        sp_rank_worker(int(argv[1]), Path(argv[3]))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build(["flash_fwd", "flash_bwd", "fused_update", "ring",
                         "ring_matmul", "overhead_probe"])
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'cached'}) into {_build.BUILD_DIR}")
    for log in logs.values():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                print("  ptxas entry " + line.split("'")[1][:100])
            elif "registers" in line or "spill" in line:
                print("  ptxas " + line.strip())

    if guard_only:               # phase 5p alone
        t0 = time.perf_counter()
        guard_phase(card)
        print(f"phase 5p: {time.perf_counter() - t0:.1f} s")
        backend.shutdown()
        return 0
    if elastic_only:             # phase 5q alone
        t0 = time.perf_counter()
        elastic_phase(card)
        print(f"phase 5q: {time.perf_counter() - t0:.1f} s")
        return 0
    if multislice_only:          # phase 5r alone
        t0 = time.perf_counter()
        multislice_phase(card)
        print(f"phase 5r: {time.perf_counter() - t0:.1f} s")
        return 0
    if sp_only:                  # phase 5s alone
        t0 = time.perf_counter()
        sp_phase(card)
        print(f"phase 5s: {time.perf_counter() - t0:.1f} s")
        return 0
    if harness_only:             # phase 5o alone (with phase 5g's line)
        t0 = time.perf_counter()
        harness_phase(card, run_bench(card, iters=_BENCH_ITERS))
        print(f"bench and phase 5o: {time.perf_counter() - t0:.1f} s")
        backend.shutdown()
        return 0
    t0 = time.perf_counter()
    fwd_err = check_kernel()
    bwd_err = check_bwd_kernels()
    upd_err = check_update_kernel()
    ag_err, rs_err = check_ring_kernels()
    cm_err = check_ring_matmul_kernels()
    k9_err = check_overhead_probe_kernel()
    print(f"kernel checks: {time.perf_counter() - t0:.1f} s")
    if kernels_only:
        return 0

    serve_routes, runs = check_serving()
    t0 = time.perf_counter()
    res, train_launches, step_ms = train_gpt2()
    print(f"train phase: {time.perf_counter() - t0:.1f} s")
    upd_err = max(upd_err, check_update_main_path(res.train_step))
    fp32_routes = check_flash_step_vs_dense()
    train_with_dropout()
    t0 = time.perf_counter()
    fused, rp, dear2 = train_dear_fused()
    for rank in fused:      # the IPC ring's own checks, in each rank
        ag_err = max(ag_err, rank["ring_errs"][0])
        rs_err = max(rs_err, rank["ring_errs"][1])
    for rank in rp:
        for k, v in rank["cm_errs"].items():
            cm_err[k] = max(cm_err[k], v)
    print("IPC ring check, both ranks: K4 fp32 and bf16, K5 ring bf16 (two "
          "steps) at the plan's shard sizes: 0 ulp from the plain versions")
    print(f"two-rank phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    probe_res, probe_launches = run_probe()
    probe_ipc_launches = probe_two_ranks(probe_res["kernels"])
    print(f"overhead probe phase: {time.perf_counter() - t0:.1f} s; "
          f"launches in this process {probe_launches}, over both IPC "
          f"ranks {probe_ipc_launches}")
    t0 = time.perf_counter()
    rn, rn_launches, rn_step_ms = train_resnet50(card)
    upd_err = max(upd_err, check_update_main_path(rn.train_step))
    check_resnet_card_vs_cpu(rn)
    print(f"resnet phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bert, bert_launches, bert_step_ms, bert_drop = train_bert()
    upd_err = max(upd_err, check_update_main_path(bert.train_step))
    print(f"bert phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vit, vit_launches, vit_step_ms = train_vit()
    upd_err = max(upd_err, check_update_main_path(vit.train_step))
    print(f"vit phase: {time.perf_counter() - t0:.1f} s")
    for label, r, ms, items in (
            (f"bert-base flash (bf16, B={_BERT_B}, S=128)", bert,
             bert_step_ms, "sentences"),
            ("vit_b16 (bf16, B=64, 224²)", vit, vit_step_ms, "images")):
        p50, p99 = (float(np.percentile(ms, q)) for q in (50, 99))
        flops = r.flops_per_step
        print(f"{label} train step on {card}: p50 {p50:.3f} ms p99 "
              f"{p99:.3f} ms; {r.total_mean:.1f} {items}/s (the CLI's "
              f"timed mean); {flops / 1e12:.6f} TFLOP per step counted -> "
              f"MFU {flops / r.iter_time_mean / _PEAK_FLOPS[torch.bfloat16]:.2%}"
              f" of {_PEAK_FLOPS[torch.bfloat16] / 1e12:.0f} TF/s bf16")
    t0 = time.perf_counter()
    zoo = {name: train_zoo(name, B_, size, card) for name, B_, size in _ZOO}
    upd_err = max([upd_err] + [z["upd_err"] for z in zoo.values()])
    print(f"zoo phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mnist_launches = train_mnist()
    print(f"mnist phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bert_serve_routes, bert_runs = serve_bert()
    print(f"bert serving phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bl_fused, bl_rp = train_bert_large_rp()
    for rank in bl_rp:
        for k, v in rank["cm_errs"].items():
            cm_err[k] = max(cm_err[k], v)
    print(f"bert-large ring-projection phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    modes = train_modes(dear2)
    modes1 = train_modes_one_rank()
    check_communicator(0, 1)
    # the K5 epilogue at the replicated modes' sizes: whole buckets of the
    # two-rank plan (the one-rank plan's are its shards already)
    upd_err = max(upd_err, check_update_main_path(
        res.train_step, modes[0]["allreduce"]["bucket_padded"],
        "whole-bucket (two-rank allreduce)"))
    print(f"modes phase (5l): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    comp_ms = check_compressors(
        max(b.padded_size for b in rn.train_step.plan.buckets), card)
    comp2 = train_compressed_two_ranks()
    comp1 = train_compressed_one_rank(card)
    comp_routes, comp_update = comp_launch_totals(comp2, comp1)
    print(f"phase 5m launches over both ranks and every run: K1-K3 by route "
          f"{comp_routes}, the K5 epilogue {comp_update}; compress ms "
          f"{comp_ms}")
    print(f"compression, LAMB and remat phase (5m): "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tune = tune_and_multi_step(card)
    upd_err = max(upd_err, tune["upd_err"])
    print(f"tuning and multi_step phase (5n): "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    guard = guard_phase(card)
    print(f"checkpoint and guard phase (5p): "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    elastic = elastic_phase(card)
    print(f"elastic membership phase (5q): "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    multislice = multislice_phase(card)
    print(f"multi-slice DCN phase (5r): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sp = sp_phase(card)
    print(f"sequence-parallel phase (5s): {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()      # the bench's process needs the memory
    t0 = time.perf_counter()
    bench_line = run_bench(card, iters=_BENCH_ITERS)
    print(f"bench phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    harness = harness_phase(card, bench_line)
    print(f"input pipeline and harness phase (5o): "
          f"{time.perf_counter() - t0:.1f} s")
    trace_decode_ticks(runs[-1][3].model)

    B, S = 16, 1024
    p50, p99 = (float(np.percentile(step_ms, q)) for q in (50, 99))
    tok_s = res.total_mean * S
    flops = train_flops_per_step(GPT2_SMALL, B, S)
    print(f"train step (GPT-2 small, bf16, B={B}, S={S}, "
          f"{res.train_step.plan.num_buckets} buckets, {len(step_ms)} timed "
          f"steps): p50 {p50:.3f} ms p99 {p99:.3f} ms; {tok_s:.1f} tokens/s "
          f"(the CLI's timed mean); {flops / 1e12:.3f} TFLOP per step "
          f"(6 x matmul params x tokens + causal attention) -> MFU "
          f"{tok_s / (B * S) * flops / _PEAK_FLOPS[torch.bfloat16]:.2%} of "
          f"{_PEAK_FLOPS[torch.bfloat16] / 1e12:.0f} TF/s bf16")
    trace_train_steps(res.train_step, res.state, res.batch, p50)
    rn_buckets = rn.train_step.plan.buckets
    rp50, rp99 = (float(np.percentile(rn_step_ms, q)) for q in (50, 99))
    flops_img = resnet_flops_per_image()
    print(f"resnet50 train step (bf16, B={_RESNET_B}, 224², mode dear, "
          f"{len(rn_buckets)} buckets, {len(rn_step_ms)} timed steps) on "
          f"{card}: p50 {rp50:.3f} ms p99 {rp99:.3f} ms; "
          f"{rn.total_mean:.1f} img/s (the CLI's timed mean); "
          f"{3 * flops_img * _RESNET_B / 1e12:.4f} TFLOP per step (3 x the "
          f"forward's conv and fc products, {flops_img / 1e9:.4f} GFLOP "
          f"per image) -> MFU "
          f"{rn.total_mean * 3 * flops_img / _PEAK_FLOPS[torch.bfloat16]:.2%}"
          f" of {_PEAK_FLOPS[torch.bfloat16] / 1e12:.0f} TF/s bf16")
    trace_train_steps(rn.train_step, rn.state, rn.batch, rp50,
                      label=f"resnet50 bf16, B={_RESNET_B}, 224²")
    for label, r, ms in (
            (f"bert-base flash bf16, B={_BERT_B}, S=128", bert,
             bert_step_ms),
            (f"{_VIT_MODEL} bf16, B={_VIT_B}, 224²", vit, vit_step_ms)):
        trace_train_steps(r.train_step, r.state, r.batch,
                          float(np.percentile(ms, 50)), label=label)
    # the bench's BERT-Base configuration (dropout 0.1, S = 64); its idle
    # share against the bench line's step time
    bert_bench_ms = next(m["step_ms"] for m in bench_line["extra_metrics"]
                         if m["metric"] == "bert_base_sen_sec_per_chip")
    trace_train_steps(bert_drop.train_step, bert_drop.state,
                      bert_drop.batch, bert_bench_ms,
                      label=f"bert-base dropout bf16, B={_BERT_B}, S=64 (the "
                            "bench's configuration; p50 = the bench's step)")
    for label, r, rank in ([("dear-fused", r, x) for r, x in enumerate(fused)]
                           + [("dear-fused --ring-projections", r, x)
                              for r, x in enumerate(rp)]
                           + [("dear", r, x) for r, x in enumerate(dear2)]):
        fp50, fp99 = (float(np.percentile(rank["step_ms"], q))
                      for q in (50, 99))
        print(f"two-rank {label} step, rank {r} (GPT-2 small, bf16, 8 "
              f"sequences of {S} per rank, {len(rank['step_ms'])} timed "
              f"steps): p50 {fp50:.3f} ms p99 {fp99:.3f} ms; "
              f"{rank['tokens_per_s']:.1f} tokens/s over both ranks (the "
              "CLI's timed mean); both ranks share one card, so this is "
              "the card's time for 16 sequences plus the waits of the "
              "collectives (the ring's, or gloo's through the host), not "
              f"a per-card rate; peak memory "
              f"{rank['peak_bytes'] / 2**20:.1f} MiB")
        tr = rank["trace"]
        if tr is not None:
            print(f"  traced (2 steps, this rank's context): "
                  f"{tr['ops_per_step']:.1f} device ops/step, kernels' "
                  f"spans {tr['busy_ms']:.3f} ms/step of which the ring "
                  f"kernels {tr['ring_ms']:.3f} and the ring matmul "
                  f"kernels {tr['cm_ms']:.3f}, wall {tr['wall_ms']:.3f} "
                  "ms/step under the profiler; top: "
                  + "; ".join(f"{ms:.3f} {name[:48]}"
                              for name, ms in tr["top"][:6]))

    for label, runs in ([(f"two-rank, rank {r}", x)
                         for r, x in enumerate(modes)]
                        + [("one rank (NCCL, B=4)", modes1)]):
        for mode, run in runs.items():
            if not isinstance(run, dict):
                continue
            mp50, mp99 = (float(np.percentile(run["step_ms"], q))
                          for q in (50, 99))
            print(f"phase 5l {label} {mode} step (GPT-2 small, "
                  f"{len(run['step_ms'])} steps after the first) on {card}: "
                  f"p50 {mp50:.3f} ms p99 {mp99:.3f} ms; "
                  f"{run['tokens_per_s']:.1f} tokens/s (the CLI's timed "
                  f"mean); peak memory {run['peak_bytes'] / 2**20:.1f} MiB "
                  f"(over {run['base_bytes'] / 2**20:.1f} MiB allocated "
                  "before the run)")

    hbm = probe.memory_rate(name)
    print(f"bounds: {hbm / 1e12} TB/s memory ({name}), peak "
          f"{_PEAK_FLOPS[torch.bfloat16] / 1e12} TF/s bf16, "
          f"{_PEAK_FLOPS[torch.float32] / 1e12} TF/s fp32; power limit as "
          f"above: {card}")
    # each K1 shape is held against the plain version before it is timed;
    # decode B=4 and train B=16 are the main paths' own shapes
    # the routes' main-path shapes: split-K the bf16 decode tick (and the
    # fp32 one), tensor cores the train step (B = 16; 8 per rank at world
    # 2), CUDA cores the fp32 step (B = 2); then the CUDA-core route at the
    # train shape (bf16 in, fp32 out) beside the tensor-core one
    fwd_rows = {
        "split_k": time_shape("decode B=4 Sq=1 Sk=1024 H=12 D=64", _SLOTS,
                              1, _L, torch.bfloat16, False, 8, hbm),
        "split_k fp32": time_shape("decode B=4 Sq=1 Sk=1024 H=12 D=64",
                                   _SLOTS, 1, _L, torch.float32, False, 4,
                                   hbm),
        "tensor_core prefill": time_shape(
            "causal prefill B=2 S=1024 H=12 D=64", 2, _L, _L,
            torch.bfloat16, True, 2, hbm),
        "cuda_core": time_shape("causal prefill B=2 S=1024 H=12 D=64", 2,
                                _L, _L, torch.float32, True, 2, hbm),
        "tensor_core": time_shape("causal train B=16 S=1024 H=12 D=64", B,
                                  S, S, torch.bfloat16, True, 2, hbm),
        "tensor_core B=8": time_shape("causal train B=8 S=1024 H=12 D=64",
                                      8, S, S, torch.bfloat16, True, 2, hbm),
        "cuda_core train": time_shape("causal train B=16 S=1024 H=12 D=64",
                                      B, S, S, torch.bfloat16, True, 2, hbm,
                                      out_dtype=torch.float32)}
    # K1 at BERT-Base's decode tick (phase 5j): 4 slots over the 512-slot
    # ring, bf16 and fp32, split-K
    fwd_rows["split_k bert"] = time_shape(
        "bert decode B=4 Sq=1 Sk=512 H=12 D=64", _SLOTS, 1, 512,
        torch.bfloat16, False, 8, hbm)
    fwd_rows["split_k bert fp32"] = time_shape(
        "bert decode B=4 Sq=1 Sk=512 H=12 D=64", _SLOTS, 1, 512,
        torch.float32, False, 4, hbm)
    for row in fwd_rows.values():
        fwd_err[row["route"]] = max(fwd_err[row["route"]],
                                    row["max_abs_err"])
    layers = GPT2_SMALL.num_hidden_layers
    # K2 and K3 by route at their main paths' shapes (tensor cores the bf16
    # train step, CUDA cores the fp32 step), then the CUDA-core route at the
    # train shape with fp32 outputs (ring attention's call; no main path)
    bwd, bwd_main_err = time_bwd(hbm, [
        ("", B, torch.bfloat16, torch.bfloat16, layers),
        ("_f32", 2, torch.float32, torch.float32,
         fp32_routes["dq"]["cuda_core"]),
        ("_bf16_f32out", B, torch.bfloat16, torch.float32, 0)], S)
    for which, errs in bwd_main_err.items():
        for key, err in errs.items():
            bwd_err[which][key] = max(bwd_err[which].get(key, 0.0), err)
    # K1, K2 and K3 at BERT-Base's flash shape (phase 5e: full mask,
    # non-causal), the same tensor-core routes
    bert_fwd = time_shape(f"bert B={_BERT_B} S=128 H={_H} D={_D}", _BERT_B,
                          128, 128, torch.bfloat16, False, 4, hbm)
    fwd_err["tensor_core"] = max(fwd_err["tensor_core"],
                                 bert_fwd["max_abs_err"])
    _, bert_bwd_err = time_bwd(hbm, [
        ("_bert", _BERT_B, torch.bfloat16, torch.bfloat16,
         BERT.BERT_BASE.num_hidden_layers)], 128, causal=False)
    for which, errs in bert_bwd_err.items():
        for key, err in errs.items():
            bwd_err[which][key] = max(bwd_err[which].get(key, 0.0), err)
    print("K2/K3 largest |err| by instantiation (the kernels line takes "
          f"each route's main-path one): {bwd_err}")
    buckets = res.train_step.plan.buckets
    nb = len(buckets)
    # a bucket of the 25 MB threshold (the kernels line) and the largest
    # one (wte alone: a layer over the threshold gets its own bucket)
    upd = time_update(max(b.shard_size for b in buckets
                          if b.size * 4 <= 25 * 2**20), hbm, nb)
    time_update(max(b.shard_size for b in buckets), hbm, nb)
    # the replicated modes' whole buckets at world 2 (phase 5l): the 25 MB
    # bucket and wte's
    padded2 = modes[0]["allreduce"]["bucket_padded"]
    time_update(max(n for n in padded2 if n * 4 <= 25 * 2**20), hbm,
                len(padded2))
    time_update(max(padded2), hbm, len(padded2))
    # ResNet-50's largest bucket shard (the 25 MB threshold's first bucket)
    time_update(max(b.shard_size for b in rn_buckets), hbm, len(rn_buckets))
    # the zoo's largest shards: VGG-16's fc1 bucket (102,764,544 elements,
    # its own bucket) and DenseNet-201's and Inception-v4's largest
    for z in zoo.values():
        time_update(max(z["shards"]), hbm, z["buckets"])
    ring_rows = time_ring(fused[0]["bucket_shards"], hbm)
    # the kernels line: the 25 MB bucket's shard, as for the update
    ring_n = max(n for n in fused[0]["shard_sizes"]
                 if 2 * n * 4 <= 25 * 2**20)
    cm_rows = time_ring_matmul(hbm, {768: 3 * layers, 3072: layers})
    # BERT-Large's (phase 5k): 72 calls at N = 1024, 24 at N = 4096
    bl_layers = BERT.BERT_LARGE.num_hidden_layers
    time_ring_matmul(hbm, {1024: 3 * bl_layers, 4096: bl_layers},
                     shapes=_CM_BERT_LARGE, sweeps=False)
    k9_rows = time_overhead_probe(hbm)
    fused_launches = {k: sum(r["launches"][k]
                             for r in fused + rp + bl_fused + bl_rp)
                      for k in fused[0]["launches"]}
    # K4 and the K5 ring also run on the probe's path (both transports)
    # and in phase 5o's dear-fused driver cell (its rank 0's telemetry)
    ring_launches = {k: fused_launches[k] + probe_launches[k]
                     + probe_ipc_launches[k] + harness[k]
                     for k in ("ring_ag", "ring_rs")}
    # K4 by route, each with its own main path: direct the dear-fused
    # steps (every one checked so in both ranks; the driver cell's train
    # step demands it too), slot the probe's (both transports); the K5
    # ring by width on the dear-fused steps (the cell's are not split)
    ag_by_route = {"direct": fused_launches["ring_ag_direct_all"]
                   + harness["ring_ag"],
                   "slot": probe_launches["ring_ag_slot"]
                   + probe_ipc_launches["ring_ag_slot"]}
    _check(ag_by_route["direct"] == fused_launches["ring_ag"]
           + harness["ring_ag"]
           and sum(ag_by_route.values()) == ring_launches["ring_ag"],
           f"K4 on the main paths by route: {ag_by_route}, all "
           f"{ring_launches['ring_ag']}")
    rs_by_width = {"vector": fused_launches["ring_rs_vector"],
                   "scalar": fused_launches["ring_rs"]
                   - fused_launches["ring_rs_vector"],
                   "phase 5o driver cell (by width not counted)":
                   harness["ring_rs"]}
    print(f"K4 launches on the main paths by route: {ag_by_route}; the K5 "
          f"ring's on the dear-fused steps by width: {rs_by_width}")
    rp_launches = {k: sum(r["launches"][k] for r in rp + bl_rp)
                   for k in rp[0]["launches"]}
    print(f"main paths (two ranks, dear-fused, with and without ring "
          f"projections; GPT-2 small and BERT-Large): launches over both "
          f"ranks and runs "
          f"{fused_launches}; with ring projections {rp_launches}; K4 and "
          f"the K5 ring with the probe's {ring_launches}")
    # K6 and K7 by route on their main path: every launch on the wgmma
    # route (each step checked so in both ranks); the mma route runs only
    # in the checks (fp32 and ragged shapes)
    cm_by_route = {k: {"launches_by_route": {
        "wgmma": rp_launches[k + "_wgmma"],
        "mma": rp_launches[k] - rp_launches[k + "_wgmma"]}}
        for k in ("cm_fwd", "cm_dx")}
    _check(all(r["launches_by_route"]["mma"] == 0
               for r in cm_by_route.values()),
           f"K6/K7 on the main path by route: {cm_by_route}")

    # K1 by route, each with its own main path: split-K the decode ticks,
    # tensor cores the bf16 train steps (one rank and both ranks of the two
    # dear-fused runs), CUDA cores the fp32 step
    # phase 5l's runs: both ranks of every two-rank run and the one-rank
    # runs (bf16, on the tensor-core routes)
    modes_runs = [run for ranks in modes for run in ranks.values()
                  if isinstance(run, dict)] + list(modes1.values())
    modes_routes = {w: {route: sum(run["routes"][w][route]
                                   for run in modes_runs)
                        for route in modes_runs[0]["routes"][w]}
                    for w in ("fwd", "dq", "dkv")}
    modes_update = sum(run["launches"]["fused_update"]
                       for run in modes_runs)
    print(f"phase 5l launches over both ranks and every run: K1-K3 by "
          f"route {modes_routes}, the K5 epilogue {modes_update}")
    k1_launches = {
        "split_k": serve_routes["split_k"] + bert_serve_routes["split_k"],
        "tensor_core": train_launches["flash_fwd_tc"]
        + fused_launches["flash_fwd_tc"] + bert_launches["flash_fwd_tc"]
        + modes_routes["fwd"]["tensor_core"]
        + comp_routes["fwd"]["tensor_core"]
        + harness["routes"]["fwd"]["tensor_core"]
        + guard["flash_fwd_tc"] + elastic["flash_fwd_tc"]
        + multislice["flash_fwd_tc"],
        "cuda_core": fp32_routes["fwd"]["cuda_core"]
        + modes_routes["fwd"]["cuda_core"]
        + comp_routes["fwd"]["cuda_core"]
        + harness["routes"]["fwd"]["cuda_core"]
        + sp["launches"]["fwd"]}
    print(f"K1 launches on the main paths by route: {k1_launches}")
    k1 = [_kernel_entry(f"flash_fwd ({route})", "flash_fwd.cu",
                        "dear_pytorch_tpu/ops/flash_attention.py:97",
                        k1_launches[route], fwd_err[route], fwd_rows[route])
          for route in FA.FWD_ROUTES]
    # K2 and K3 by route, each with its own main path and timed at its
    # shape: tensor cores the bf16 train steps (one rank and both ranks of
    # the two dear-fused runs), CUDA cores the fp32 step
    k23 = []
    for kname, which, line in (("flash_bwd_dq", "dq", 152),
                               ("flash_bwd_dkv", "dkv", 195)):
        launches = {"tensor_core": train_launches[kname + "_tc"]
                    + fused_launches[kname + "_tc"]
                    + bert_launches[kname + "_tc"]
                    + modes_routes[which]["tensor_core"]
                    + comp_routes[which]["tensor_core"]
                    + harness["routes"][which]["tensor_core"]
                    + guard[kname + "_tc"] + elastic[kname + "_tc"]
                    + multislice[kname + "_tc"],
                    "cuda_core": fp32_routes[which]["cuda_core"]
                    + modes_routes[which]["cuda_core"]
                    + comp_routes[which]["cuda_core"]
                    + harness["routes"][which]["cuda_core"]
                    + sp["launches"][which]}
        print(f"{kname} launches on the main paths by route: {launches}")
        for route, sfx in (("tensor_core", ""), ("cuda_core", "_f32")):
            k23.append(_kernel_entry(
                f"{kname} ({route})", "flash_bwd.cu",
                f"dear_pytorch_tpu/ops/flash_attention.py:{line}",
                launches[route], bwd_err[which][route], bwd[kname + sfx]))
    print(json.dumps({"kernels": k1 + k23 + [
        # launches: GPT-2's train steps, ResNet-50's, BERT-Base's (flash
        # and with dropout), ViT-B/16's, the zoo's, the MNIST example's,
        # phase 5l's (whole buckets in the replicated modes), phase 5m's
        # (the compressed buckets' dense means, the remat runs), phase
        # 5n's (every plan a tuner tried, and the multi_step runs), phase
        # 5o's (streamed batches, the driver's cells, scaling, the overlap
        # report's rank 0, the remat check), phase 5p's (the guarded,
        # replayed and resumed steps, the ranks' runs, the production
        # example), phase 5q's (every rank of both drills) and phase 5r's
        # (every rank of the GPT-2 runs, flat and hierarchical, and every
        # final life of the multi-slice drills)
        _kernel_entry("fused_update", "fused_update.cu",
                      "dear_pytorch_tpu/ops/collective_matmul.py:317",
                      train_launches["fused_update"] + rn_launches
                      + bert_launches["fused_update"] + vit_launches
                      + sum(z["launches"] for z in zoo.values())
                      + mnist_launches + modes_update + comp_update
                      + tune["launches"] + harness["update"]
                      + guard["fused_update"] + elastic["fused_update"]
                      + multislice["fused_update"]
                      + sp["launches"]["fused_update"],
                      upd_err, upd),
    ] + [
        _kernel_entry(f"ring_all_gather ({route})", "ring.cu",
                      "dear_pytorch_tpu/ops/collective_matmul.py:218",
                      ag_by_route[route], ag_err, ring_rows[key][ring_n])
        for route, key in (("direct", "ring_all_gather"),
                           ("slot", "ring_all_gather_slot"))] + [
        _kernel_entry("ring_rs_update", "ring.cu",
                      "dear_pytorch_tpu/ops/collective_matmul.py:317",
                      ring_launches["ring_rs"], rs_err,
                      ring_rows["ring_rs_update"][ring_n])
        | {"launches_by_width": rs_by_width},
    ] + [
        # the mlp_in shape (N = 3072); PERF.md has both shapes and per step
        _kernel_entry(kname, "ring_matmul.cu",
                      f"dear_pytorch_tpu/ops/collective_matmul.py:{line}",
                      rp_launches[kname], cm_err[kname],
                      cm_rows[kname][3072]) | cm_by_route.get(kname, {})
        for kname, line in (("cm_fwd", 510), ("cm_dx", 545),
                            ("cm_dw", 572))] + [
        # the finer granularity: per-step cost, not one SM's bandwidth
        _kernel_entry("overhead_probe", "overhead_probe.cu",
                      "scripts/pallas_overhead_probe.py:33",
                      probe_launches["overhead_probe"], k9_err,
                      k9_rows[2048, 8])] + [
        # phase 5s: K1-K3 on CUDA cores at SP's pair shapes; launches =
        # the launches at that shape and input dtype in 5s's runs
        _kernel_entry(
            f"{kname} (cuda_core, sp: {label})",
            "flash_fwd.cu" if kname == "flash_fwd" else "flash_bwd.cu",
            "dear_pytorch_tpu/ops/flash_attention.py:"
            + {"flash_fwd": "97", "flash_bwd_dq": "152",
               "flash_bwd_dkv": "195"}[kname],
            row["launches"], row["max_abs_err"], row)
        for (kname, label), row in sp["rows"].items()]}))
    backend.shutdown()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
