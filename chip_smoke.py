#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lstm_rnn_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Drives the port's paths end to end at the full width of the TIMIT recipe
(117 inputs -> 5 x BLSTM(250) -> softmax(183), parallel_sequences 50) and
of the LVCSR recipe (the same stack -> softmax(10112)), with random
weights from a seed, and holds every kernel against its plain twin:

1. device: torch/CUDA versions, the card's name and power limit; TF32 off;
2. build: compiles the CUDA kernels from csrc/ with nvcc (one process per
   source, in parallel), prints ptxas's registers and spills (failing if
   an instance of K5f, csrc/softmax_ce_plain.cu's plain_fwd_kernel,
   spills: it holds its row in registers), and counts
   the HGMMA (wgmma) instructions in the SASS of every instance of the
   GEMM engine (csrc/gemm.cuh), of K3f (csrc/softmax_ce.cu's
   ce_fwd_kernel) and of K4b (csrc/softmax_ce_wide.cu's wide_bwd_*):
   more than 0 in each bf16 instance and in each 3x instance
   (--f32_matmul 3x: gemm3x_kernel, wide_bwd_3x_kernel), 0 in each f32
   one;
   and the thread-block cluster each recurrence path takes (csrc/
   recurrence.cuh: n, threads, shared memory, W_rec on chip or from L2,
   the clusters the card holds at once), against ops/lstm_cell.py's
   mirror of the plan;
3. the inference forward kernel (K0) against its twin at one layer's full
   width (D=2, H=125, B=50, T=800, P=117 and P=250), float32 and bfloat16,
   with the recurrence's time alone and per step;
4. the training kernels against their twins, with times: the forward with
   residuals (K1) and the BPTT (K2) at T=500, B=50, P=117 (the first
   layer: no dx) and P=250, with each recurrence's time alone and per step
   (K1's by CUDA events, K2's bptt_kernel by the profiler's device time),
   and the softmax + CE tail's forward and
   backward (K3f, K3b) at N=25,000, P=250, S=183; float32 and bfloat16;
   K3f on operands already in the storage dtype, timed on the device (the
   profiler: its kernel and the loss reduction) beside one
   `F.cross_entropy(addmm(...))` on the same operands, timed the same way,
   and by CUDA events (host work included); K3b the same way beside
   cuBLAS's dh + dW on its operands, at most four kernels a call, its dz
   (the kernels' own view of it) the twin's bit for bit at g = 1 and a
   second launch bit for bit equal to the first;
5. serving end to end: writes a TIMIT-shaped .nc and network.jsn, runs
   `cli.main(--train false ... htk)` in f32 and bf16 and with
   `--lstm_backend scan`, checks the files, the posteriors and the K0
   launch count; forward frames/s and a profile of one fraction;
6. one SGD step of the kernel path against the scan path's autograd, from
   the same weights (f32): the loss and the parameter update;
7. training end to end: a TIMIT-shaped train and val corpus, `cli.main(
   --train true --truncate_seq 500 --parallel_sequences 50 --stochastic
   true --shuffle_fractions true ... --max_epochs 2)` in f32 and bf16:
   the epoch table, trained_network.jsn (exists, moved, serves in forward
   mode) and the exact launch count of every kernel;
8. training frames/s of the bench.py recipe step (T=500, B=50, every row
   full, lr 1e-4, momentum 0.9) on the kernel path (f32, bf16) and the
   scan path, and a profile of one kernel-path step by kernel;
9. the wide tail's kernels (K4f, K4b) against their twins at the LVCSR
   tail (N=25,000, P=250, S=10,112), f32 and bf16, with controls, a row
   tile of dummy frames and K4b launched twice (the same bits), and their
   times (phase 4's order; K4f and `F.cross_entropy` on the same logits,
   and K4b, on the device, as phase 4); K4's two products outside its
   kernels (the logits, dh) on the device, this route beside the twins'
   f32 products, and cuBLAS's dW on K4b's operands as a yardstick;
10. one LVCSR SGD step, fused tail (K4) vs unfused tail, f32;
11. the LVCSR recipe through `cli.main(examples/lvcsr_physical_states/
    config.cfg ...)` on a synthetic 10,112-state corpus, f32 with its
    autosave and bf16 without: the exact launch count of every kernel (no
    K3), the autosaves, `--continue epoch001.autosave` against the
    uninterrupted run, and the seconds an LVCSR autosave's dump takes;
12. LVCSR training frames/s (f32, bf16) and a profile of one f32 and one
    bf16 step (the bf16 step must run no library GEMM in f32);
13. the K3/K4/K5 crossover: the three tails, forward + backward with
    their products, at S = 183, 512 and 832 (K3 where it fits the card:
    S <= 704 on an H100; measured only);
14. the carry kernel (K6 forward + K7) against its twin at the streaming
    width (117 -> 5 x LSTM(250) -> softmax(183), the TIMIT stack with every
    BLSTM made an LSTM: one layer, D=1, H=250, B=64, a 64-frame chunk, P=117
    and P=250), f32 and bf16, from non-zero (h0, c0) with a step mask of
    every pattern a chunk has, with two controls that must fail (zero
    carries; the same chunk masked by prefix lengths only), and its times;
15. `Network.apply_streaming` over 8 chained 64-frame chunks (T=512, B=64)
    against `Network.apply` (K0) on the whole sequence: the last LSTM
    layer's output and the posteriors;
16. streaming serving through `cli.main(--stream_chunk 64 ...)` on phase
    5's corpus with the unidirectional net, f32 and bf16: the posteriors
    against the `--stream_chunk 0` run, the exact launch counts (5 carry
    launches per chunk, no K0), and a BLSTM net refused;
17. streaming frames/s against whole-sequence frames/s on the same stack
    (f32, bf16), the latency of one 64-frame chunk (host wall and device),
    and a profile of one chunk;
18. the carry kernels with gradients (K6b: the carry forward with
    residuals and the carry BPTT) against their twins at one TIMIT
    layer's sequence-parallel block (D=1, H=125, B=50, T=125, P=117
    without dx and P=250 with it), both directions (dir_offset 0 and 1),
    f32 and bf16, from non-zero (h0, c0) with non-zero final-state
    cotangents and lengths full, ending inside the block and 0; three
    controls that must fail (zero dhf/dcf, c0 replaced by zero in the
    backward, the forward from zero carries); times; and on the same
    blocks the carry kernel K6f (no residuals, prefix lengths, no step
    mask: what SP serving and the SP Trainer's validation passes launch)
    against its twin at phase 14's tolerance, with zero carries as the
    control that must fail; and the recurrences of K6f, K6b-f and K6b-b
    alone, per step;
19. four chained K6b blocks per direction (parallel/sequence.py's kernel
    wavefront on a mesh of cuda:0 four times) against K1 + K2 on the whole
    T=500 BLSTM layer: h and every gradient, f32;
20. sequence parallelism at full width on a 4-block mesh (cuda:0 four
    times): one TIMIT training step on bench.py's fraction against the
    single-device kernel step from the same weights, with the exact
    launches (40 K6b-f, 40 K6b-b, no K0-K3); `Trainer(seq_mesh=)` over
    phase 7's corpus for 2 epochs against the same run without the mesh;
    `apply_seq` over phase 5's corpus against `apply` (40 K6f launches per
    fraction); SP training frames/s, f32 and bf16, beside the
    single-device step's;
21. the CLI's `--seq_devices 2`, train and forward, against the runs
    without it when torch sees two GPUs; on one GPU, that the flag is
    refused with the JAX CLI's message.
22. the plain tail's kernels (K5f, K5b) against their twins over
    N=25,000 frames at S=183 and S=10,112, f32 and bf16, with a row tile
    of dummy frames and controls that must fail (a zero p, rolled
    targets, dz from the f32 p in bf16 mode), K5f launched twice (the
    same bits) and the body and vector width it takes, and their times
    (phase 9's order: K5f and `F.cross_entropy` on the same logits on
    the device, and by CUDA events; K5b on the device);
23. one SGD step with `--remat_blocks` against the kernel step from the
    same weights (f32, ragged rows): TIMIT at K=4 and K=3 (not a divisor
    of T=500), LVCSR at K=4 against the fused K4 step, the loss, the
    update and the exact launches (K=4: 80 K6b-f, 40 K6b-b, one K5f and
    one K5b, no K0-K4); the bf16 remat step as the control;
24. `cli.main(--train true --remat_blocks 4)` on phase 7's corpus, f32 and
    bf16, 2 epochs (run beside phase 7, in its directory): the exact
    launches and the epoch errors and weights against phase 7's runs;
25. training frames/s and peak device memory of a step with and without
    `--remat_blocks` at T=500 (K=4) and T=4000 (K=8), f32 and bf16; the
    T=4000 step's peak must fall at least 1.5x; a profile of one f32
    remat step (K=4, T=500) by kernel, TIMIT's and LVCSR's (K5f at 183
    and at 10,112 classes).

26. the GEMM engine (csrc/gemm.cuh's gemm_kernel, which every projection,
    weight-gradient and dx product of the paths above runs in, and K4's
    logits and dh in bf16 mode, held and timed in phase 9) against its
    twin at every main-path shape (ops/gemm.py MAIN_PATH_CASES: dW_in at
    P = 117 and 250, dW_rec with the shift -B and +B, dx over two
    directions, the tail's dh and dW at S = 183 (in f32 and bf16 no path
    runs them since K3b's redesign; phase 40 holds their 3x instances,
    which the 3x TIMIT tail runs), the projection over 25,000, 40,000,
    6,250 and 4,096 rows), f32 and bf16, with controls that must fail (a zero
    output, a wrong shift, a dropped split, a zeroed direction), a second
    launch bit for bit equal to the first, and its times beside the
    twin's, one torch.matmul-family call's (TF32 off) and the bound;
27. backend "auto" on an LSTM layer no recurrence kernel takes (801 cells
    per direction training, 1,025 serving): the scan route, no kernel
    launch, backend "scan"'s values and gradients bit for bit, and an
    explicit "pallas" refused;
28. a 705-class softmax fed by 1,025 units (past K3's S and K4b's P): one
    training step through the materialized logits and K5 (one K5f, one
    K5b, no K3 or K4) against the unfused loss;
29. the bf16 softmax layer's product and its two gradient products on
    the tensor cores: no f32 library GEMM in a profile of serving's
    softmax and one backward, the values of round_operand's f32 matmul,
    and the product's device time beside that route's;
30. the three CHiME recipes (examples/speech_autoencoding_chime,
    examples/speech_recognition_chime/{no_,}subsampling: 39 inputs, cells
    78, 128, 150 and 51 per direction, softmax(51) over 102 units) at
    their published widths: each width's cluster plan (it must fit), K0,
    K1 and K2 at every layer's shape and K3f/K3b at the recognition tail
    against their twins at phase 3/4's tolerances, with their times; then
    `cli.main(--train true)` with each recipe's config.cfg and
    network.jsn (normal init, input noise 0.1 or 0.6, 50 parallel
    sequences, stochastic, shuffled fractions) on synthetic CHiME-shaped
    corpora (150 train and 50 val sequences of 200-700 frames), 2 epochs,
    f32 and bf16: the epoch table, the exact launches, the weights moved,
    the trained net serving in forward mode; the control, the same run
    with --input_noise_sigma 0, must train to other errors;
31. weight noise on the card: the Trainer's first draw equals numpy's
    stream bit for bit; one noisy SGD step on the TIMIT recipe batch
    through the kernel route against the scan route, SP on 2 blocks of
    cuda:0 and --remat_blocks 4 against the kernel route, with the step
    at the clean weights as the control that must fail; the step's
    frames/s with --weight_noise_sigma 0.01 beside the step without it
    (TIMIT and CHiME no_subsampling, f32 and bf16), the host draw alone,
    and a profile of one noisy step of each (device busy against wall);
32. `cli.main --init_rng currennt` on the TIMIT network.jsn (no weights)
    with --learning_rate 0: the saved weights are the host replay of the
    reference's stream (utils/rng_compat.py) bit for bit, and the run
    launched its kernels;
33. data parallelism's per-rank shapes: the TIMIT recipe's 50 sequences
    over 4 GPUs pad to 13 rows a rank (the last rank's 2 empty), over 2
    to 25: K0, K1 and K2 at one layer (P = 117 and 250, T = 500) and
    K3f/K3b (S = 183) and K4f/K4b (S = 10,112) over its frames at B = 13
    and 25 with the last row empty, f32 and bf16, against their twins at
    phase 3, 4 and 9's tolerances, the empty row's outputs exactly zero,
    with times; and the recipe step on one GPU at B = 13, 25 and 50
    (TIMIT f32 and bf16, LVCSR f32);
34. data parallelism on one card: two ranks on cuda:0 over gloo, through
    `Trainer(data_group=)` in spawned workers (parallel/launch.py): the
    recipe step (B = 50, and B = 49 padded to 50) against the
    one-process step from the same weights (loss, count, every rank's
    update within 1e-6 relative, the ranks' parameters equal), with a
    rank's exact launches (5 K1, 5 K2, one K3f, one K3b); the controls
    that must fail (the gradient all-reduce left out, padding rows that
    carry real targets); 2 epochs over phase 7's corpus against the
    one-process Trainer; and, on one GPU, the CLI's --num_devices 2
    refused with the JAX CLI's message;
35. data parallelism on distinct GPUs, when torch sees at least 2 (over
    NCCL): the CLI's --num_devices 2 (and 4 with 4 GPUs) against
    --num_devices 1, train (2 epochs over phase 7's corpus: weights and
    epoch errors) and forward (phase 5's corpus: the posteriors); two CLI
    processes with --coordinator_address/--num_processes/--process_id,
    each seeing half of the GPUs, against --num_devices of the same
    total; and the step's frames/s and the gradient all-reduce's time on
    1, 2 and 4 GPUs (TIMIT f32 and bf16 at parallel_sequences 50 and at
    50 a GPU, LVCSR f32 at 50 a GPU);
36. data parallelism composed with sequence parallelism (DP x SP) on one
    card: K6b-f, K6b-b and K6f at a rank's block (B = 25 of 50, T = 250
    of 500, P = 117 and 250, both directions, f32 and bf16) against their
    twins at phase 18's tolerances, an all-padding block's outputs exactly
    zero; two ranks on cuda:0 over gloo, each with a 2-block seq mesh of
    cuda:0, through Trainer(seq_mesh=, data_group=): the recipe step (B =
    50, and 49) against the one-process 2-block SP step (loss, count,
    every rank's update within 1e-6), a rank's exact launches (20 K6b-f,
    20 K6b-b), the controls that must fail (no all-reduce, padding rows
    with real targets), a rank all padding adding exactly zero, 2 epochs
    over phase 7's corpus against the one-process SP Trainer; the CLI's
    --num_devices 4 --seq_devices 2 refused on fewer than 4 GPUs;
37. data-parallel streaming on one card: K6f+K7 at a rank's 32 streams
    against its twin at phase 14's tolerance; two ranks on cuda:0 over
    gloo stream 32 streams each through the CLI's DP streaming path
    (cli._apply_block) in 64-frame chunks, f32 and bf16, against the
    one-process streamed forward of all 64, with a rank's exact launches;
38. DP x SP and DP streaming on distinct GPUs, when torch sees at least
    4 (over NCCL): the CLI's --num_devices 4 --seq_devices 2 against
    --seq_devices 2 and one GPU (train, 2 epochs) and one GPU (forward),
    two multi-host processes of 2 GPUs with --seq_devices 2 against it,
    --stream_chunk 64 --num_devices 2 and 4 against one GPU; training
    frames/s of DP x SP 2 x 2 beside one GPU, --seq_devices 4 and
    --num_devices 4, and streaming frames/s and chunk latency on 1, 2
    and 4 GPUs;
39. the data feed and the dispatch flags: the native runtime (runtime/,
    the JSON formatter, built with g++ at first use; a failed build fails
    the run) and its seconds; the LVCSR autosave's JSON dump
    through the native formatter (its seconds; its bytes against the
    pure-Python dump's); `cli.main(--train true)` on phase 7's corpus
    with --bucket_lengths true, 3 epochs f32, plain, with --device_cache
    true and with --fuse_fractions 4 --profile_dir (the step graphs,
    captured under the profiler): the tables' errors, trained_network.jsn
    and every kernel's exact launches alike (a capture's launches counted
    once a replay of its graph), the fused run's warm-ups, captures and
    replays, every lookup of epochs 2-3 a hit and
    no byte copied from the host in their passes, the trace naming
    rec_kernel, bptt_kernel, ce_fwd_kernel and gemm_kernel; two child
    processes on one fresh --compilation_cache_dir, the first building
    the kernels there, the second loading them; epoch 2's
    frames/s and the device's busy share with the cache off and on.
40. --f32_matmul 3x (f32 products as three bf16 passes on the tensor
    cores): (a) the engine's 3x instance (gemm3x_kernel) at every
    main-path shape of phase 26 against its 3x twin (f32 sum-order noise),
    against the exact f32 product at THREE_PASS_REL, with the 1-pass bf16
    product as the control that must read above it, a second launch bit
    for bit, and its device time beside phase 26's f32 SIMT body, one
    torch call's (TF32 off) and the 3x bound; (b) K4 in 3x at the LVCSR
    tail: the logits (also at TIMIT's 183 states, the 3x route's) and dh
    in the engine's 3x instance and K4b's 3x instance (wide_bwd_3x_kernel)
    the same way, K4b launched twice, its dummy tile exactly zero; (c,
    run beside phases 7 and 11 on their corpora) `cli.main(--train true
    --f32_matmul 3x)` for TIMIT and LVCSR, 2 epochs: the epoch errors
    within 1e-3 of the f32 runs' and every kernel's exact launches (the
    TIMIT tail on the 3x route: the engine's 3x logits, K5f, K5b, its 3x
    tail_dh and tail_dW; no K3); (d) bench.py's recipe step, TIMIT and
    LVCSR, in f32, 3x and bf16 in turns, and a profile of one 3x step;
41. the tools and recipes on the card: HTK files -> the port's htk2nc
    -> nc_standardize -> `cli.main(--train true)` (the TIMIT recipe's
    config.cfg, 1 epoch) -> forward mode with HTK output ->
    test_post_conv.py; then every examples/*/run_torch.sh at once, each
    generating its corpus through its fallback and training its recipe
    one epoch at its widths: each must store trained_network.jsn.

42. pipeline parallelism on one card (a pipe mesh of cuda:0 k times):
    the TIMIT recipe step (T=500, B=50, every row full) at 2 stages (2
    and 4 microbatches) and 4 (4), and the LVCSR step at 2 (K4 at the
    last stage), each against the one-GPU step from the same weights in
    f32 and bf16 (loss, count, every gradient), with the exact launches
    that the per-microbatch checkpointing implies (K1 and the tail's
    forward twice a microbatch, K2 and its backward once); two controls
    that must fail (a microbatch dropped, the microbatches' targets
    swapped); `apply_pipelined` against `apply` over phase 5's corpus
    (K0 5 m times a fraction); the step's ms and peak memory against one
    GPU, f32 and bf16, and a profiled pipelined step's busy share;
43. tensor parallelism on one card (a model mesh of cuda:0 k times): K8f
    (save=True) and K8b (csrc/lstm_tp.cu) at a TIMIT layer in 5 shards
    against their twins, with failing controls, their ms, bound and the
    twins' ms; the TIMIT step at model_devices 5 (K3 in its tail, the
    LSTM layers on K8) and the CHiME autoencoding step at its full widths
    at 2, against the one-GPU kernel step (f32), their exact launches
    (one K8f and one K8b a layer and GPU, no K0-K2), the TP step's ms
    beside PR 18's host-driven layer and one GPU's, and a profiled full
    TP step's busy share; under bf16 the TP stack's hidden output against
    the one-GPU f32 kernel stack (the TP layers compute in f32), the bf16
    kernel stack the control; the phase's wall time;
44. with 2+ GPUs: the CLI's --num_devices 2 --pipeline_devices 2 (train
    and forward) and --num_devices 2 --model_devices 2 (train, CHiME
    autoencoding) against one GPU, with 4 DP x PP and DP x TP too, the
    TP runs also fused (--fuse_fractions 8 --device_cache true) against
    themselves bit for bit; the pipelined and TP steps on distinct GPUs
    with each GPU's peak memory; with 4 GPUs (44e) the 1,024-cell BLSTM
    at model_devices 4 against the one-GPU scan route. On one GPU the
    CLI's refusal of both in the JAX CLI's words, and a line saying what
    was not run;
45. a seq or pipe mesh over two processes on one card (two workers on
    cuda:0 over gloo, parallel/launch.py start(span=True), every message
    staged through host memory): the hop (parallel/hop.py) of a TIMIT
    carry and a stage message, f32 and bf16, values and cotangents bit
    for bit, its µs, and the zero-cotangent control that must fail; the
    TIMIT SP step (a block a process) and the pipelined step (m = 2, a
    stage a process), summed over the processes, against the same mesh
    from one process, with each process's exact launches;
46. with 2+ GPUs, the same over NCCL between processes of their own GPUs
    (f32 and bf16, the LVCSR pipelined step, SP over 1 + 2 GPUs with 3
    and over 2 x 2 and 4 x 1 with 4), each step's ms, peak MiB a GPU and
    each process's busy share, the same meshes from one process and one
    GPU for comparison, and the CLI's multi-host --seq_devices and
    --pipeline_devices (a process each CUDA_VISIBLE_DEVICES) against
    one process on as many GPUs. On one GPU a line saying it was not
    run;
47. --fuse_fractions (graphs.py, the Trainer's fused passes) on phase 7's
    corpus (LVCSR: its sizes and seed, 10,112 labels): (a) `cli.main(
    --train true --fuse_fractions 8 --device_cache true)` against
    --fuse_fractions 1 for TIMIT f32 and bf16, the remat K=4 TIMIT step
    and LVCSR in f32, 2 epochs each, each run whole under the profiler:
    the tables' errors and trained_network.jsn (bit for bit for TIMIT,
    within GRAPH_REL for the others, naming the layers whose bits moved),
    the profiled kernels equal by name (the fused run's two int64 fills
    a capture, torch's RNG bookkeeping, aside), the profiler's bptt
    kernels equal to the K2 and K6b-b launches of the wrappers' counts (a
    capture's counted once a replay) and those the unfused run's, the
    stacked epoch taken (no decline line), a warm-up for each mode and
    shape used, a capture for each used twice, a replay for every other
    step;
    (b) the same four as Trainers, fuse 1 and 8, the device cache off and
    on: the first two epochs' walls (warm-ups, captures and their
    seconds), three more epochs' walls and their median ms a step, a
    profiled epoch's busy share, the graphs' pool MiB. The spread of many
    epochs and the 8-shape LVCSR case: scripts/torch_fused_rates.py;
48. --fuse_fractions under a data group and the one-process seq and pipe
    meshes, fuse 8 against fuse 1 (fused_group_phase);
49. --fuse_fractions under a model mesh (the graphs hold K8) and on a seq
    or pipe mesh across processes (the graphs hold the NCCL hops): fuse 8
    against fuse 1 bit for bit, 20 timed epochs of each with the busy
    share a GPU, the K8 launches and hop messages that ran equal; two
    processes on one card over gloo keep one fraction at a time with the
    Trainer's note (fused_tp_span_phase). The [done] lines give each
    report tag's wall time and the total.

Every path's run also counts the engine's launches by product and checks
them against what its kernels' launches imply; the profiles (phases 5, 8,
12, 17, 20, 25) give the engine's device time per product.

scripts/torch_sp_multigpu.py runs phases 20 and 21 on a mesh of distinct
GPUs; scripts/torch_dp_multigpu.py runs phase 35 alone,
scripts/torch_dp_sp_multigpu.py phase 38, scripts/torch_pp_tp.py
phases 42-44, scripts/torch_cross_host.py phases 45-46 and
scripts/torch_tp_fused.py phase 43, 44's TP part and phase 49.

Any failed check raises and the script exits non-zero. Imports torch and
the port only (no jax). Exits 1 without printing a result when torch sees
no GPU. The line before last is the card's name and power limit, the one
before it the kernels' JSON; the last line of stdout is the contract line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1234
T_LAYER, B, H, D = 800, 50, 125, 2
# kernel vs twin over 800 recurrent steps at width 125. f32: both are true
# f32 but sum in different orders; the difference grows along the
# recurrence (the H100 showed 5.7e-7: the bound leaves ~20x). bf16: one sum
# order can round h to the neighbouring bf16 value where the other does
# not, and the recurrence carries it forward (the H100 showed 3.9e-3, one
# bf16 ulp below 1.0: the bound is four).
TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
# posteriors of the kernel path vs the scan path (f32): errors of ~1e-5 in
# h move near-uniform posteriors (~1/183) by far less than this
SCAN_TOL = 1e-5


# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s; FP32 outside the
# tensor cores and dense bf16 FLOP/s (the rate for the operands' type)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# the training kernels' shapes: one BLSTM layer of the recipe at the
# bench.py sequence length, and the tail over one fraction's frames
T_TRAIN, N_TAIL, S_STATES = 500, 25_000, 183
# kernel vs twin, relative to the largest entry of each of the twin's
# outputs. K1 as K0 (TOL): f32 sums in another order through 500 steps;
# bf16 one rounding flip of h carried forward. K2: the same through the
# backward recurrence, then summed over 25,000 rows into the weight
# gradients; in bf16 a delta stored on the other side of a bf16 boundary
# moves every sum it enters by up to one bf16 ulp (2^-8), and the
# recurrence carries it. K3: f32 sums in another order; bf16 p and dz
# stored in bf16 (2^-7).
REL = {"lstm_fwd_save": {"float32": 1e-5, "bfloat16": 1.6e-2},
       "lstm_bwd": {"float32": 1e-4, "bfloat16": 2.0 ** -6},
       "softmax_ce": {"float32": 1e-5, "bfloat16": 2.0 ** -7}}
# the tail's p element by element against its own size: f32 sums in
# another order; bf16 both sides round the same f32 value, and a rounding
# flip moves p by one bf16 ulp, at most 2^-7 of |p|
P_REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
# one SGD step, kernel path vs scan path (f32, 5 layers, T=500): the loss
# to f32 sum-order noise; the update (-lr * grad on the first step)
# relative to its largest entry. Sound f32 runs read 2.3e-6 on an H100
# (700 W); the control, the bf16 kernel step against the same f32 scan
# step, must read above the limit
STEP_TOL = {"loss": 1e-5, "update": 1e-4}
# the LVCSR recipe (examples/lvcsr_physical_states): the same stack with a
# softmax over 10,112 physical HMM states, whose tail is K4
S_LVCSR = 10112
LVCSR_DIR = os.path.join(REPO, "examples", "lvcsr_physical_states")
# K4 vs its twins on the same logits. The stats element by element: f32
# math on the same values in both modes, sums in another order. The rest
# relative to each output's largest entry: f32 sum-order noise; bf16 dz is
# stored rounded, a rounding flip moves it by one bf16 ulp (2^-8, bound
# 2^-7), and each flip moves the dW and dh sums by up to that much (2^-6)
WIDE_REL = {"stats": {"float32": 1e-5, "bfloat16": 1e-5},
            "dz": {"float32": 1e-5, "bfloat16": 2.0 ** -7},
            "dW": {"float32": 1e-5, "bfloat16": 2.0 ** -6}}
# a resumed LVCSR run (--continue) against the uninterrupted one: the same
# kernels on the same inputs in the same order, weights within 1e-6
CONTINUE_TOL = 1e-6
# streaming serving, as the JAX package measured it (scripts/
# tpu_measure_r5b.py:53-62): the TIMIT stack with every BLSTM an LSTM(250),
# 64 concurrent streams, T=512 fed in 64-frame chunks
T_STREAM, B_STREAM, CHUNK, H_STREAM = 512, 64, 64, 250
# the carry kernel against its twin: K0's bounds (TOL) over a 64-step
# chunk; streamed posteriors against the whole-sequence ones: f32 sum-order
# noise of the softmax product on chunks of rows (the hidden output of the
# two is expected bit-identical)
STREAM_TOL = 1e-5


_T0 = time.perf_counter()


# each report tag's first and last second since the start (the `[done]`
# line prints them: each phase's wall)
_SPANS = {}


def phase(name, msg):
    """One line of the run's report, tagged with its phase and the
    seconds since the script started."""
    now = time.perf_counter() - _T0
    _SPANS.setdefault(name, [now, now])[1] = now
    print(f"[{name} {now:.0f}s] {msg}", flush=True)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def make_layer(torch, P, seed):
    """One BLSTM layer's operands on the card: uniform +-0.1 weights (the
    recipe's init), N(0, 1) inputs, ragged lengths including 1 and T."""
    rng = np.random.RandomState(seed)

    def u(*s):
        return torch.tensor(rng.uniform(-0.1, 0.1, s), dtype=torch.float32,
                            device="cuda")
    x = torch.tensor(rng.randn(T_LAYER, B, P), dtype=torch.float32,
                     device="cuda")
    lengths = rng.randint(1, T_LAYER + 1, B)
    lengths[0], lengths[-1] = T_LAYER, 1
    return (x, u(D, P, 4 * H), u(D, H, 4 * H), u(D, 3, H), u(D, 4 * H),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def time_ms(torch, fn, reps):
    """Mean device milliseconds per call, CUDA events around `reps` calls
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(torch, fn, part, reps=5):
    """Mean device milliseconds of one launch of the kernel whose profiler
    name holds `part` (the BPTT recurrence alone: its entry point also
    launches the weight-gradient products), over `reps` calls after one
    warm-up; by the launches the profiler recorded, since the first ones
    of a window can go missing."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if part in e.key]
    n = sum(e.count for e in events)
    if n == 0:
        raise AssertionError(f"the profiler recorded no {part} launch")
    return sum(dev_us(e) for e in events) / 1e3 / n


def report_plans(torch):
    """The cluster each recurrence path takes (the kernel library's plan
    on the card beside ops/lstm_cell.py's mirror, which must agree): n,
    threads and shared memory a CTA, W_rec on chip or from L2, and the
    clusters of that size the card holds at once."""
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    for what, width, kind in (
            ("K0, K1, K6f/K6b-f on an SP block", H, "fwd"),
            ("K2, K6b-b", H, "bwd"),
            ("K6f+K7 at the streaming width", H_STREAM, "fwd")):
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)
            card = lc.recurrence_plan_on_card(width, dt, kind)
            mine = lc.recurrence_plan(width, dt, kind)
            phase("build", f"plan {kind} H={width} {name} ({what}): "
                  f"cluster of "
                  f"{card['n']}, {card['threads']} threads, "
                  f"{card['smem']:,} B shared a CTA, W_rec "
                  f"{'on chip' if card['w_on_chip'] else 'from L2'}; "
                  f"{card['active_clusters']} such clusters at once")
            if any(card[k] != mine[k] for k in ("n", "threads", "smem",
                                                 "w_on_chip")):
                raise AssertionError(f"the plan's mirror disagrees with the "
                                     f"kernel library: {mine} vs {card}")


def kernel_vs_twin(torch):
    from lstm_rnn_tpu_torch.ops import lstm_cell
    from lstm_rnn_tpu_torch.ops.lstm_cell import (lstm_scan_fused,
                                                  lstm_scan_reference)
    res = {}
    for P in (117, 250):
        args = make_layer(torch, P, seed=P)
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)
            got = lstm_scan_fused(*args, 1.0, dt)
            want = lstm_scan_reference(*args, 1.0, dt)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"kernel output not finite (P={P}, "
                                     f"{name})")
            err = (got.float() - want.float()).abs().max().item()
            ms = time_ms(torch, lambda: lstm_scan_fused(*args, 1.0, dt), 10)
            plain = time_ms(
                torch, lambda: lstm_scan_reference(*args, 1.0, dt), 1)
            xc = args[0].to(dt)
            w_in, w_rec = args[1].to(dt), args[2].to(dt)
            a = lstm_cell._launch_proj(xc, w_in, args[4], 1.0)
            proj = time_ms(torch, lambda: lstm_cell._launch_proj(
                xc, w_in, args[4], 1.0), 10)
            rec = time_ms(torch, lambda: lstm_cell._launch_rec(
                a, w_rec, args[3], args[5]), 10)
            phase("kernel", f"P={P} {name}: max_abs_err={err:.3e} "
                  f"(tol {TOL[name]:.0e}); kernel {ms:.3f} ms "
                  f"(proj {proj:.3f} ms, rec {rec:.3f} ms = "
                  f"{1e3 * rec / T_LAYER:.2f} us per step); twin "
                  f"{plain:.1f} ms "
                  f"[T={T_LAYER} B={B} H={H} D={D}]")
            if not err <= TOL[name]:
                raise AssertionError(f"kernel disagrees with its twin: "
                                     f"{err} > {TOL[name]} (P={P}, {name})")
            res[(P, name)] = {"err": err, "ms": ms, "plain_ms": plain,
                              "rec_ms": rec,
                              "us_per_step": 1e3 * rec / T_LAYER,
                              "cost": lstm_cost("lstm_fwd", P,
                                                args[5].cpu().numpy(), name)}
    return res


def write_inputs(workdir):
    """A TIMIT-shaped forward-mode corpus and the recipe's network.jsn with
    weights from the port's init_params(SEED)."""
    from lstm_rnn_tpu_torch.data.netcdf3 import strings_to_chars, write_netcdf
    from lstm_rnn_tpu_torch.models.flagship import build_timit_network
    rng = np.random.RandomState(SEED)
    # 145 = 50 + 50 + 45: the last fraction carries 5 empty rows, as a
    # corpus's last fraction does, down to a kernel block with no valid step
    n_seq, n_in, n_states = 145, 117, 183
    lengths = rng.randint(300, 801, n_seq)
    total = int(lengths.sum())
    tags = [f"spk{i // 10:02d}/utt{i:03d}" for i in range(n_seq)]
    nc = os.path.join(workdir, "timit_ff.nc")
    write_netcdf(nc, {"numSeqs": n_seq, "numTimesteps": total,
                      "inputPattSize": n_in, "numLabels": n_states,
                      "maxSeqTagLength": 24}, [
        ("seqTags", ["numSeqs", "maxSeqTagLength"],
         strings_to_chars(tags, 24)),
        ("seqLengths", ["numSeqs"], lengths.astype(np.int32)),
        ("inputs", ["numTimesteps", "inputPattSize"],
         rng.randn(total, n_in).astype(np.float32)),
        ("targetClasses", ["numTimesteps"],
         rng.randint(0, n_states, total).astype(np.int32)),
    ])
    net_path = os.path.join(workdir, "network.jsn")
    build_timit_network(seed=SEED).save(net_path)
    return nc, net_path, tags, lengths


def run_cli(nc, net_path, outdir, *extra):
    from lstm_rnn_tpu_torch import cli
    os.makedirs(outdir)
    t0 = time.perf_counter()
    rc = cli.main(["--network", net_path, "--train", "false",
                   "--ff_input_file", nc, "--parallel_sequences", "50",
                   "--ff_output_format", "htk", "--ff_output_file", outdir,
                   "--random_seed", str(SEED), *extra])
    if rc != 0:
        raise AssertionError(f"cli.main {' '.join(extra)} returned {rc}")
    return time.perf_counter() - t0


def read_outputs(outdir, tags, lengths, n_states=183):
    """Per-sequence HTK posteriors; checks count, frames, finiteness and
    row sums."""
    from lstm_rnn_tpu_torch.writers import read_htk
    files = glob.glob(os.path.join(outdir, "**", "*.htk"), recursive=True)
    if len(files) != len(tags):
        raise AssertionError(f"{len(files)} output files for {len(tags)} "
                             "sequences")
    outs = []
    worst = 0.0
    for tag, n in zip(tags, lengths):
        y, _, _ = read_htk(os.path.join(outdir, tag + ".htk"))
        if y.shape != (n, n_states) or not np.isfinite(y).all():
            raise AssertionError(f"{tag}: shape {y.shape}, want "
                                 f"({n}, {n_states}), finite")
        worst = max(worst, float(np.abs(y.sum(-1) - 1.0).max()))
        outs.append(y)
    if worst > 1e-5:
        raise AssertionError(f"posterior rows sum to 1 +- {worst}")
    return outs, worst


def host_phases(nc, net_path):
    """Host seconds of the CLI's set-up: reading network.jsn, and loading
    the corpus and assembling its fractions."""
    from lstm_rnn_tpu_torch import io_currennt as ioc
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    t0 = time.perf_counter()
    ioc.load_network_json(net_path)
    t1 = time.perf_counter()
    n = sum(1 for _ in DataSet([nc], parallel_sequences=50).fractions())
    t2 = time.perf_counter()
    phase("e2e", f"host: network.jsn read {t1 - t0:.3f} s; corpus load + "
          f"{n} fractions assembled {t2 - t1:.3f} s")


def end_to_end(torch, workdir):
    from lstm_rnn_tpu_torch.ops.lstm_cell import lstm_scan_fused
    nc, net_path, tags, lengths = write_inputs(workdir)
    n_frac = -(-len(tags) // 50)
    phase("e2e", f"{len(tags)} sequences, {int(lengths.sum())} frames, "
          f"lengths {lengths.min()}..{lengths.max()}, {n_frac} fractions")

    host_phases(nc, net_path)
    w = wrappers()
    for f in w.values():
        f.launches = 0  # the main path's run starts here
    wall = run_cli(nc, net_path, os.path.join(workdir, "f32"))
    counts = {k: f.launches for k, f in w.items()}
    launches = lstm_scan_fused.launches
    y32, worst = read_outputs(os.path.join(workdir, "f32"), tags, lengths)
    phase("e2e", f"float32 CLI run {wall:.2f} s wall; {launches} kernel "
          f"launches for {n_frac} fractions ({counts['gemm:proj']} "
          f"projections in the GEMM engine); row sums within {worst:.1e}")
    check_counts(counts, {**dict.fromkeys(w, 0), "lstm_fwd": 5 * n_frac})

    before = lstm_scan_fused.launches
    wall16 = run_cli(nc, net_path, os.path.join(workdir, "bf16"),
                     "--compute_dtype", "bfloat16")
    y16, worst16 = read_outputs(os.path.join(workdir, "bf16"), tags, lengths)
    d16 = max(float(np.abs(a - b).max()) for a, b in zip(y16, y32))
    phase("e2e", f"bfloat16 CLI run {wall16:.2f} s wall; "
          f"{lstm_scan_fused.launches - before} kernel launches; row sums "
          f"within {worst16:.1e}; max |p_bf16 - p_f32| = {d16:.3e}")
    if lstm_scan_fused.launches - before != 5 * n_frac:
        raise AssertionError("bf16 run missed the kernel")

    before = lstm_scan_fused.launches
    wall_scan = run_cli(nc, net_path, os.path.join(workdir, "scan"),
                        "--lstm_backend", "scan")
    ys, _ = read_outputs(os.path.join(workdir, "scan"), tags, lengths)
    dscan = max(float(np.abs(a - b).max()) for a, b in zip(ys, y32))
    phase("e2e", f"--lstm_backend scan CLI run {wall_scan:.2f} s wall; "
          f"max |p_kernel - p_scan| = {dscan:.3e} (tol {SCAN_TOL:.0e})")
    if lstm_scan_fused.launches != before:
        raise AssertionError("the scan backend launched the kernel")
    if not dscan <= SCAN_TOL:
        raise AssertionError(f"kernel path and scan path disagree: {dscan}")
    return counts, nc


def forward_rates(torch, nc, card):
    """Forward frames/s of Network.apply over the corpus's fractions (exact
    lengths, as the CLI assembles them), after one warm-up fraction,
    synchronised; kernel path and twin path."""
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.models.flagship import build_timit_network
    ds = DataSet([nc], parallel_sequences=50, prefetch=False)
    fracs = [(torch.from_numpy(f.inputs).cuda(),
              torch.from_numpy(f.pattypes).cuda(),
              sum(i["length"] for i in f.seq_info)) for f in ds.fractions()]
    rates = {}
    for label, backend, dtype in (("kernel f32", "auto", "float32"),
                                  ("kernel bf16", "auto", "bfloat16"),
                                  ("twin (scan) f32", "scan", "float32")):
        net = build_timit_network(seed=SEED, backend=backend,
                                  compute_dtype=dtype)
        params = net.device_params("cuda")
        with torch.inference_mode():
            net.apply(params, fracs[0][0], fracs[0][1])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for x, pt, _ in fracs:
                net.apply(params, x, pt)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        frames = sum(n for _, _, n in fracs)
        padded = sum(x.shape[0] * x.shape[1] for x, _, _ in fracs)
        rates[label] = frames / dt
        phase("rate", f"{label}: {frames / dt:,.0f} frames/s "
              f"({frames} real / {padded} padded frames, "
              f"{1e3 * dt / len(fracs):.1f} ms per fraction of 50) on {card}")
    return rates


def profile_fraction(torch, nc):
    """Device time by kernel over one kernel-path fraction (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.models.flagship import build_timit_network
    frac = next(DataSet([nc], parallel_sequences=50,
                        prefetch=False).fractions())
    net = build_timit_network(seed=SEED)
    params = net.device_params("cuda")
    x = torch.from_numpy(frac.inputs).cuda()
    pt = torch.from_numpy(frac.pattypes).cuda()
    with torch.inference_mode():
        net.apply(params, x, pt)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            net.apply(params, x, pt)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)

    report_profile(prof, wall_us, f"one forward fraction T={x.shape[0]}")


def rel_err(got, want):
    """max |got - want| / max |want|, and max |got - want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err / max(1e-30, want.abs().max().item()), err


def elem_rel(got, want):
    """max over elements of |got - want| / |want| (0 where both are 0)."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


def per_output(names, errs):
    return ", ".join(f"{n} {e[0]:.2e}" for n, e in zip(names, errs))


def bound(nbytes, flops, dtype):
    """(least ms the card could take, what bounds it): each input read
    once and each output written once at HBM rate, the products at the
    peak rate for the operands' type."""
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def lstm_cost(kind, P, lengths, dtype, need_dx=True, T=None, D=D, H=H):
    """(bytes, flops) of one BLSTM layer at D=2, H=125, B=50, T=T_TRAIN (or
    T_LAYER for K0) for this run's lengths, or of one chunk of a streaming
    LSTM layer (lstm_fwd_carry: T, D and H given, lengths the valid steps
    per row). Padded rows add nothing to any output, so every product
    counts the valid frames only, and every per-frame input is read at the
    valid frames; the outputs are written whole. The carry kernel also
    reads the [B, T] step mask and (h0, c0), and writes (hf, cf); the K6b
    forward (lstm_fwd_carry_save) is lstm_fwd_save plus (h0, c0) in and
    (hf, cf) out, the K6b backward (lstm_bwd_carry) lstm_bwd plus h0, c0,
    dhf, dcf in, dh0, dc0 out, and the dh0 and edge dW_rec products."""
    if T is None:
        T = T_LAYER if kind == "lstm_fwd" else T_TRAIN
    B = len(lengths)
    G = 4 * H
    es = 2 if dtype == "bfloat16" else 4
    frames = int(lengths.sum())
    weights = D * (P + H) * G * es + D * (3 * H + G) * 4 + B * 4
    if kind in ("lstm_fwd", "lstm_fwd_save", "lstm_fwd_carry",
                "lstm_fwd_carry_save"):
        nbytes = frames * P * es + weights + T * B * D * H * es
        if kind in ("lstm_fwd_save", "lstm_fwd_carry_save"):
            nbytes += D * T * B * (H * 4 + G * es)
        if kind == "lstm_fwd_carry":
            nbytes += B * T + 4 * D * B * H * 4
        if kind == "lstm_fwd_carry_save":
            nbytes += 4 * D * B * H * 4
        # the input projection and the recurrent product
        flops = 2 * D * frames * (P + H) * G
        return nbytes, flops
    # reads x, the weights, h (for h_prev), dh, c and the gates; writes
    # dW_in, dW_rec, dpeep, dbias and dx
    nbytes = (frames * P * es + weights + frames * D * H * es * 2
              + D * frames * (H * 4 + G * es)
              + D * (P + H) * G * 4 + D * (3 * H + G) * 4
              + (T * B * P * 4 if need_dx else 0))
    # da_next . W_rec^T, dW_in, dW_rec, and dx
    flops = 2 * D * frames * G * (H + P + H + (P if need_dx else 0))
    if kind == "lstm_bwd_carry":
        nbytes += 6 * D * B * H * 4
        flops += 2 * 2 * D * B * G * H
    return nbytes, flops


def tail_cost(kind, P, dtype, N=N_TAIL, S=S_STATES):
    es = 2 if dtype == "bfloat16" else 4
    if kind == "softmax_ce_proj_fwd":
        return (N * P * es + P * S * es + S * 4 + N * 4 + N * S * es + 8,
                2 * N * P * S)
    return (N * S * es + N * P * es + P * S * es + N * 4 + 4
            + N * P * es + P * S * 4 + S * 4, 4 * N * P * S)


def train_layer(torch, P, seed):
    """One BLSTM layer's operands at T_TRAIN: the recipe's +-0.1 weights,
    N(0, 1) inputs, and lengths near a training fraction's (most rows full
    after truncation at 500), with ragged rows, a row of length 1 and a
    kernel block of empty rows."""
    rng = np.random.RandomState(seed)

    def u(*s):
        return torch.tensor(rng.uniform(-0.1, 0.1, s), dtype=torch.float32,
                            device="cuda")
    x = torch.tensor(rng.randn(T_TRAIN, B, P), dtype=torch.float32,
                     device="cuda")
    lengths = np.full(B, T_TRAIN)
    lengths[8:20] = rng.randint(1, T_TRAIN, 12)
    lengths[1], lengths[4:8] = 1, 0
    dh = torch.tensor(rng.randn(T_TRAIN, B, D * H), dtype=torch.float32,
                      device="cuda")
    return (x, u(D, P, 4 * H), u(D, H, 4 * H), u(D, 3, H), u(D, 4 * H),
            torch.tensor(lengths, dtype=torch.int32, device="cuda")), dh


def train_kernels_vs_twins(torch):
    """K1 and K2 at one layer's full width, K3f and K3b over one fraction
    of frames: max error against the twin, kernel and twin ms."""
    import torch.nn.functional as F
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    from lstm_rnn_tpu_torch.ops import softmax_ce as sc
    res = {}
    for P, need_dx in ((117, False), (250, True)):
        args, dh = train_layer(torch, P, seed=P)
        lens = args[5].cpu().numpy()
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)
            got = lc.lstm_fwd_save(*args, 1.0, dt)
            want = lc.lstm_scan_reference(*args, 1.0, dt, save=True)
            torch.cuda.synchronize()
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            rel, err = max(e[0] for e in errs), max(e[1] for e in errs)
            each = per_output(("h", "c", "gates"), errs)
            ms = time_ms(torch, lambda: lc.lstm_fwd_save(*args, 1.0, dt), 10)
            plain = time_ms(torch, lambda: lc.lstm_scan_reference(
                *args, 1.0, dt, save=True), 1)
            a = lc._launch_proj(args[0].to(dt), args[1].to(dt), args[4], 1.0)
            w_rec = args[2].to(dt)
            rec = time_ms(torch, lambda: lc._launch_rec(
                a, w_rec, args[3], args[5], save=True), 10)
            del a
            res[("lstm_fwd_save", P, name)] = dict(
                err=err, rel=rel, ms=ms, plain_ms=plain, rec_ms=rec,
                us_per_step=1e3 * rec / T_TRAIN,
                cost=lstm_cost("lstm_fwd_save", P, lens, name))
            phase("train-kernel", f"K1 lstm_fwd_save P={P} {name}: "
                  f"max_abs_err={err:.3e} rel={rel:.3e} [{each}] (tol "
                  f"{REL['lstm_fwd_save'][name]:.1e}); kernel {ms:.3f} ms "
                  f"(rec {rec:.3f} ms = {1e3 * rec / T_TRAIN:.2f} us per "
                  f"step); twin {plain:.1f} ms [T={T_TRAIN} B={B} H={H} "
                  f"D={D}]")
            if not (rel <= REL["lstm_fwd_save"][name]
                    and all(torch.isfinite(g.float()).all() for g in got)):
                raise AssertionError(f"K1 disagrees with its twin: {rel}")
            h, c, g = got
            bwd_args = (args[0], args[1], args[2], args[3], args[5], h, c, g,
                        dh, 1.0, True, dt, need_dx)
            got = lc.lstm_bwd(*bwd_args)
            want = lc.lstm_scan_bwd_reference(*bwd_args)
            torch.cuda.synchronize()
            errs = [rel_err(a, b) if a is not None else (0.0, 0.0)
                    for a, b in zip(got, want)]
            rel, err = max(e[0] for e in errs), max(e[1] for e in errs)
            each = per_output(("dx", "dW_in", "dW_rec", "dpeep", "dbias"),
                              errs)
            ms = time_ms(torch, lambda: lc.lstm_bwd(*bwd_args), 5)
            plain = time_ms(torch, lambda: lc.lstm_scan_bwd_reference(
                *bwd_args), 1)
            rec = kernel_device_ms(torch, lambda: lc.lstm_bwd(*bwd_args),
                                   "bptt_kernel")
            res[("lstm_bwd", P, name)] = dict(
                err=err, rel=rel, ms=ms, plain_ms=plain, rec_ms=rec,
                us_per_step=1e3 * rec / T_TRAIN,
                cost=lstm_cost("lstm_bwd", P, lens, name, need_dx))
            phase("train-kernel", f"K2 lstm_bwd P={P} need_dx={need_dx} "
                  f"{name}: max_abs_err={err:.3e} rel={rel:.3e} [{each}] "
                  f"(tol {REL['lstm_bwd'][name]:.1e}); kernel {ms:.3f} ms "
                  f"(bptt_kernel {rec:.3f} ms on the device = "
                  f"{1e3 * rec / T_TRAIN:.2f} us per step); twin "
                  f"{plain:.1f} ms")
            if not (rel <= REL["lstm_bwd"][name] and all(
                    torch.isfinite(a).all() for a in got if a is not None)):
                raise AssertionError(f"K2 disagrees with its twin: {rel}")

    gen = torch.Generator("cuda").manual_seed(SEED)
    P, N, S = 2 * H, N_TAIL, S_STATES
    h2 = torch.randn(N, P, device="cuda", generator=gen) * 0.5
    W = (torch.rand(P, S, device="cuda", generator=gen) - 0.5) * 0.2
    b = (torch.rand(S, device="cuda", generator=gen) - 0.5) * 0.2
    tc = torch.randint(0, S, (N,), device="cuda", generator=gen,
                       dtype=torch.int32)
    tc[::10] = -1  # dummy frames
    g = torch.tensor(1.0, device="cuda")
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        # the operands in the storage dtype, as the path hands them over:
        # the kernel and the library call are timed on the same tensors
        hs, Ws, bs = h2.to(dt), W.to(dt), b.to(dt)
        tl = tc.long()
        loss, cnt, p = sc.softmax_ce_proj_fwd(hs, Ws, b, tc, 1.0, dt)
        loss_r, cnt_r, p_r = sc.softmax_ce_fwd_reference(hs, Ws, b, tc, 1.0,
                                                         dt)
        torch.cuda.synchronize()
        rel, err = elem_rel(p, p_r), rel_err(p, p_r)[1]
        # controls: a zero, a uniform and a column-rolled p must fail
        controls = {"zero": torch.zeros_like(p_r),
                    "uniform": torch.full_like(p_r, 1.0 / S),
                    "rolled": p_r.roll(1, dims=1)}
        ctrl = {k: elem_rel(v, p_r) for k, v in controls.items()}
        lrel = abs(loss.item() - loss_r.item()) / abs(loss_r.item())

        def k3f():
            return sc.softmax_ce_proj_fwd(hs, Ws, b, tc, 1.0, dt)

        def lib_call():
            return F.cross_entropy(torch.addmm(bs, hs, Ws), tl,
                                   reduction="sum", ignore_index=-1)
        ms = time_ms(torch, k3f, 10)
        ms_nop = time_ms(torch, lambda: sc.softmax_ce_proj_fwd(
            hs, Ws, b, tc, 1.0, dt, want_p=False), 10)
        plain = time_ms(torch, lambda: sc.softmax_ce_fwd_reference(
            hs, Ws, b, tc, 1.0, dt), 10)
        lib = time_ms(torch, lib_call, 10)
        # device time: the kernel and its loss reduction, and the library
        # call's kernels, each summed (one launch of each per call)
        dev_k = prof_ms(torch, [k3f], 20)
        dev = sum(dev_k.values())
        lib_dev = sum(prof_ms(torch, [lib_call], 20).values())
        res[("softmax_ce_proj_fwd", P, name)] = dict(
            err=err, rel=rel, loss_rel=lrel, ms=dev if dev else ms,
            events_ms=ms, plain_ms=plain,
            library_ms=lib_dev if lib_dev else lib, library_events_ms=lib,
            cost=tail_cost("softmax_ce_proj_fwd", P, name))
        phase("train-kernel", f"K3f softmax_ce_proj_fwd {name}: p "
              f"max_abs_err={err:.3e} elementwise rel={rel:.3e} (tol "
              f"{P_REL[name]:.1e}; controls " + ", ".join(
                  f"{k} {v:.2e}" for k, v in ctrl.items()) + f"), loss rel "
              f"{lrel:.2e}, "
              f"count {cnt.item()} vs {cnt_r.item()}; on the device "
              f"{fmt_ms(dev or None)} (" + ", ".join(
                  f"{short_key(k)} {v:.4f}" for k, v in dev_k.items())
              + f"), F.cross_entropy(addmm) {fmt_ms(lib_dev or None)} on "
              f"the device; CUDA events: kernel {ms:.3f} ms ({ms_nop:.3f} "
              f"ms without p), F.cross_entropy(addmm) {lib:.3f} ms; twin "
              f"{plain:.3f} ms [N={N} P={P} S={S}, operands in {name}]")
        if not all(v > P_REL[name] for v in ctrl.values()):
            raise AssertionError(f"the p check passes a wrong p: {ctrl}")
        if not (rel <= P_REL[name] and lrel <= 1e-5
                and abs(cnt.item() - cnt_r.item()) <= 1):
            raise AssertionError("K3f disagrees with its twin")
        got = sc.softmax_ce_proj_bwd(p, h2, W, tc, g, 1.0, dt)
        want = sc.softmax_ce_bwd_reference(p, h2, W, tc, g, 1.0, dt)
        # dz never leaves the chip: the kernels' own view of it (before
        # its rounding) against the twin's, bit for bit at g = 1, and a
        # second launch's outputs against the first's
        dz = torch.empty(N, S, device="cuda")
        first = sc._launch_proj_bwd(p, hs, Ws, tc, g, 1.0, dz_out=dz)
        again = sc._launch_proj_bwd(p, hs, Ws, tc, g, 1.0)
        dz_r = sc.plain_dz_reference(p, tc, g)
        torch.cuda.synchronize()
        dz_bits = torch.equal(dz.view(torch.int32), dz_r.view(torch.int32))
        same = all(torch.equal(a, c) for a, c in zip(first, again))
        errs = [rel_err(a, c) for a, c in zip(got, want)]
        rel, err = max(e[0] for e in errs), max(e[1] for e in errs)
        each = per_output(("dh", "dW", "db"), errs)
        dzc = dz_r.to(dt)
        del dz, first, again

        def k3b():
            return sc.softmax_ce_proj_bwd(p, hs, Ws, tc, g, 1.0, dt)

        def lib_call():  # cuBLAS's dh and dW on the same operands
            return torch.matmul(dzc, Ws.t()), torch.matmul(hs.t(), dzc)
        ms = time_ms(torch, k3b, 10)
        lib = time_ms(torch, lib_call, 10)
        plain = time_ms(torch, lambda: sc.softmax_ce_bwd_reference(
            p, h2, W, tc, g, 1.0, dt), 10)
        dev_k = prof_ms(torch, [k3b], 20)
        dev = sum(dev_k.values())
        lib_dev = sum(prof_ms(torch, [lib_call], 20).values())
        res[("softmax_ce_proj_bwd", P, name)] = dict(
            err=err, rel=rel, ms=dev if dev else ms, events_ms=ms,
            plain_ms=plain, library_ms=lib_dev if lib_dev else lib,
            library_events_ms=lib, launches_per_call=len(dev_k),
            cost=tail_cost("softmax_ce_proj_bwd", P, name))
        phase("train-kernel", f"K3b softmax_ce_proj_bwd {name}: "
              f"max_abs_err={err:.3e} rel={rel:.3e} [{each}] (tol "
              f"{REL['softmax_ce'][name]:.1e}); dz the twin's bit for bit: "
              f"{dz_bits}; repeat bit for bit: {same}; on the device "
              f"{fmt_ms(dev or None)} in {len(dev_k)} kernels (" + ", ".join(
                  f"{short_key(k)} {v:.4f}" for k, v in dev_k.items())
              + f"), cuBLAS dh + dW {fmt_ms(lib_dev or None)} on the device;"
              f" CUDA events: kernel {ms:.3f} ms, cuBLAS {lib:.3f} ms; twin "
              f"{plain:.3f} ms [N={N} P={P} S={S}]")
        if dev_k and len(dev_k) > 4:
            raise AssertionError(f"K3b launched {len(dev_k)} kernels")
        if not (rel <= REL["softmax_ce"][name] and dz_bits and same):
            raise AssertionError(f"K3b disagrees with its twin: {rel}")
    return res


def recipe_batch(torch, T=T_TRAIN, full=True, seed=0, states=S_STATES,
                 inputs=117):
    """bench.py's fraction: N(0, 1) inputs, random targets of `states`
    states, every row full (or ragged lengths 300..T with full=False)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T, B, inputs).astype(np.float32)
    lengths = np.full(B, T) if full else rng.randint(300, T + 1, B)
    pt = (np.arange(T)[:, None] < lengths[None, :]).astype(np.int8)
    tc = rng.randint(0, states, (T, B)).astype(np.int32)
    tc[pt == 0] = -1
    return (torch.from_numpy(x).cuda(), torch.from_numpy(tc).cuda(),
            torch.from_numpy(pt).cuda()), int(lengths.sum())


def make_trainer(backend, dtype, lvcsr=False, **kw):
    """The recipe step's Trainer (kw: weight_noise_sigma, seed, seq_mesh)."""
    from lstm_rnn_tpu_torch.models.flagship import (build_lvcsr_network,
                                                    build_timit_network)
    from lstm_rnn_tpu_torch.trainer import Trainer
    build = build_lvcsr_network if lvcsr else build_timit_network
    net = build(seed=3, backend=backend, compute_dtype=dtype)
    # no device named: the Trainer takes the card
    return Trainer(net, None, learning_rate=1e-4, momentum=0.9,
                   hybrid_online_batch=True, **kw)


def step_kernel_vs_scan(torch):
    """One SGD step from the same weights, kernel path vs scan path (f32,
    ragged rows): the loss and the update; and the control, the bf16
    kernel step against the same f32 scan step, which the check must
    reject."""
    batch, _ = recipe_batch(torch, full=False, seed=1)
    out = {}
    for label, backend, dtype in (("kernel", "auto", "float32"),
                                  ("scan", "scan", "float32"),
                                  ("control", "auto", "bfloat16")):
        tr = make_trainer(backend, dtype)
        before = {n: {k: v.detach().clone() for k, v in l.items()}
                  for n, l in tr.params.items()}
        t0 = time.perf_counter()
        err, _ = tr.train_step(*batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        upd = torch.cat([(tr.params[n][k].detach() - before[n][k]).flatten()
                         for n in sorted(before) for k in sorted(before[n])])
        out[label] = (err.item(), upd, dt)
    l_s, u_s, t_s = out["scan"]

    def rels(label):
        loss, upd, _ = out[label]
        return (abs(loss - l_s) / abs(l_s),
                ((upd - u_s).abs().max() / u_s.abs().max()).item())
    (lrel, urel), (lrel_c, urel_c) = rels("kernel"), rels("control")
    l_k, _, t_k = out["kernel"]
    phase("step", f"one SGD step f32 T={T_TRAIN} B={B}: loss kernel "
          f"{l_k:.6f} scan {l_s:.6f} (rel {lrel:.2e}, tol "
          f"{STEP_TOL['loss']:.0e}); update rel {urel:.2e} (tol "
          f"{STEP_TOL['update']:.0e}, max |update| "
          f"{u_s.abs().max().item():.3e}); control (bf16 kernel step): "
          f"loss rel {lrel_c:.2e}, update rel {urel_c:.2e}; wall kernel "
          f"{t_k:.2f} s, scan {t_s:.2f} s (first calls)")
    if not (lrel <= STEP_TOL["loss"] and urel <= STEP_TOL["update"]):
        raise AssertionError("kernel step and scan step disagree")
    if not urel_c > STEP_TOL["update"]:
        raise AssertionError("the update check passes the bf16 control")


def write_corpus(workdir, prefix, states, sizes, seed):
    """Train and val corpora (lengths 300-800, N(0, 1) inputs of 117
    features, random labels of `states` states) as .nc files."""
    from lstm_rnn_tpu_torch.data.netcdf3 import strings_to_chars, write_netcdf
    rng = np.random.RandomState(seed)
    paths = {}
    for name, n_seq in zip(("train", "val"), sizes):
        lengths = rng.randint(300, 801, n_seq)
        total = int(lengths.sum())
        path = os.path.join(workdir, f"{prefix}_{name}.nc")
        write_netcdf(path, {"numSeqs": n_seq, "numTimesteps": total,
                            "inputPattSize": 117, "numLabels": states,
                            "maxSeqTagLength": 24}, [
            ("seqTags", ["numSeqs", "maxSeqTagLength"],
             strings_to_chars([f"{name}{i:04d}" for i in range(n_seq)], 24)),
            ("seqLengths", ["numSeqs"], lengths.astype(np.int32)),
            ("inputs", ["numTimesteps", "inputPattSize"],
             rng.randn(total, 117).astype(np.float32)),
            ("targetClasses", ["numTimesteps"],
             rng.randint(0, states, total).astype(np.int32)),
        ])
        paths[name] = (path, lengths)
    return paths


def write_train_corpus(workdir):
    """TIMIT-shaped train and val corpora (200 and 100 sequences, 183
    states) and the recipe's network.jsn (weights from SEED)."""
    from lstm_rnn_tpu_torch.models.flagship import build_timit_network
    paths = write_corpus(workdir, "timit", S_STATES, (200, 100), SEED + 1)
    net_path = os.path.join(workdir, "network_train.jsn")
    build_timit_network(seed=SEED).save(net_path)
    return paths, net_path


def wrappers():
    """Every launch count of the port: the kernels' wrappers, and the GEMM
    engine's per product ("gemm:<use>"; "gemm:<use>:3x" and
    "softmax_ce_wide_bwd_3x" count the launches of the 3x instances among
    them)."""
    from lstm_rnn_tpu_torch.ops import gemm as ge
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    from lstm_rnn_tpu_torch.ops import lstm_tp as tp
    from lstm_rnn_tpu_torch.ops import softmax_ce as sc
    return {**{f"gemm:{u}": c for u, c in ge.LAUNCHES.items()},
            "lstm_tp_fwd": tp.lstm_tp_fwd, "lstm_tp_bwd": tp.lstm_tp_bwd,
            "lstm_fwd": lc.lstm_scan_fused, "lstm_fwd_save": lc.lstm_fwd_save,
            "lstm_bwd": lc.lstm_bwd,
            "softmax_ce_proj_fwd": sc.softmax_ce_proj_fwd,
            "softmax_ce_proj_bwd": sc.softmax_ce_proj_bwd,
            "softmax_ce_wide_fwd": sc.softmax_ce_wide_fwd,
            "softmax_ce_wide_bwd": sc.softmax_ce_wide_bwd,
            "softmax_ce_wide_bwd_3x": sc.WIDE_BWD_3X,
            "lstm_fwd_carry": lc.lstm_scan_fused_carry,
            "lstm_fwd_carry_save": lc.lstm_fwd_save_carry,
            "lstm_bwd_carry": lc.lstm_bwd_carry,
            "softmax_ce_fwd": sc.softmax_ce_fwd,
            "softmax_ce_bwd": sc.softmax_ce_bwd}


def gemm_expect(kernels, layers=5, bf16=False, x3=False):
    """The GEMM engine's launches per product that a path's kernel
    launches imply, on a stack whose first layer's input takes no
    gradient: one projection per LSTM forward; dW_in and dW_rec per BPTT,
    dx per BPTT of the other layers; in bf16 mode the logits per K4f and
    dh per K4b (K4b's dW is its own kernel's, and in f32 mode K4's two
    products run in cuBLAS). K3b's dh and dW are its own kernels'.
    In 3x mode (x3, f32, no remat) every product takes the 3x instance,
    K4's two products too, and the TIMIT tail's 3x route adds the logits
    per K5f and tail_dh and tail_dW per K5b."""
    fwd = sum(kernels[k] for k in ("lstm_fwd", "lstm_fwd_save",
                                   "lstm_fwd_carry", "lstm_fwd_carry_save"))
    bwd = kernels["lstm_bwd"] + kernels["lstm_bwd_carry"]
    k4f, k4b = kernels["softmax_ce_wide_fwd"], kernels["softmax_ce_wide_bwd"]
    k5f, k5b = (kernels.get(k, 0) for k in ("softmax_ce_fwd",
                                            "softmax_ce_bwd"))
    out = {"gemm:proj": fwd, "gemm:dW_in": bwd, "gemm:dW_rec": bwd,
           "gemm:dx": bwd * (layers - 1) // layers,
           "gemm:tail_dh": k5b if x3 else 0,
           "gemm:tail_dW": k5b if x3 else 0,
           "gemm:tail_logits": (k4f + (k5f if x3 else 0)
                                if bf16 or x3 else 0),
           "gemm:wide_dh": k4b if bf16 or x3 else 0}
    out.update({f"{k}:3x": v if x3 else 0 for k, v in list(out.items())})
    return out


def gemm_total(counts):
    """The engine's launches of a run (a 3x launch counts once, under its
    use)."""
    return sum(v for k, v in counts.items()
               if k.startswith("gemm:") and not k.endswith(":3x"))


def graph_executed(tr, counts):
    """The launches that ran in a Trainer's run whose wrappers counted
    `counts` (by wrappers()' names): the wrappers saw a step graph's
    kernels once, at its capture, and a replay calls no wrapper, so each
    capture's recorded launches count once a replay instead
    (graphs.py `GraphStats.executed`); without graphs, `counts`."""
    from lstm_rnn_tpu_torch.graphs import launch_counters
    name = {id(c): n for n, c in launch_counters().items()}
    w = wrappers()
    return {k: tr.graph_stats.executed(name[id(w[k])], n)
            for k, n in counts.items()}


def check_counts(counts, expect, bf16=False, layers=5, x3=False):
    """Every kernel's launches on a path's run, exactly as expected, and
    the GEMM engine's per product as the kernels' imply (bf16: the run's
    compute dtype; layers: the LSTM layers of the stack; x3: a run with
    --f32_matmul 3x, where every K4b launch takes its 3x instance)."""
    expect = {**expect, **gemm_expect(expect, layers=layers, bf16=bf16,
                                      x3=x3)}
    for k in ("lstm_tp_fwd", "lstm_tp_bwd"):  # K8: TP paths only
        expect.setdefault(k, 0)
    expect.setdefault("softmax_ce_wide_bwd_3x",
                      expect["softmax_ce_wide_bwd"] if x3 else 0)
    if counts != expect:
        raise AssertionError(f"launch counts {counts}, expected {expect}")


def train_end_to_end(torch, workdir):
    """cli.main(--train true) on the TIMIT recipe, f32 and bf16: the epoch
    table, the saved network, and every kernel's exact launch count."""
    import contextlib
    import io
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.network import Network
    paths, net_path = write_train_corpus(workdir)
    (train_nc, train_len), (val_nc, val_len) = paths["train"], paths["val"]
    n_train = DataSet([train_nc], parallel_sequences=50,
                      trunc_seq_length=500).num_fractions()
    n_val = DataSet([val_nc], parallel_sequences=50).num_fractions()
    epochs = 2
    expect = {"lstm_fwd": 5 * n_val * epochs,
              "lstm_fwd_save": 5 * n_train * epochs,
              "lstm_bwd": 5 * n_train * epochs,
              "softmax_ce_proj_fwd": (n_train + n_val) * epochs,
              "softmax_ce_proj_bwd": n_train * epochs,
              "softmax_ce_wide_fwd": 0, "softmax_ce_wide_bwd": 0,
              "lstm_fwd_carry": 0, "lstm_fwd_carry_save": 0,
              "lstm_bwd_carry": 0, "softmax_ce_fwd": 0, "softmax_ce_bwd": 0}
    phase("train", f"train {len(train_len)} sequences "
          f"({int(train_len.sum())} frames, lengths {train_len.min()}.."
          f"{train_len.max()}, {n_train} fractions after truncation at "
          f"500), val {len(val_len)} ({n_val} fractions)")
    launches, tables = None, {}
    for name in ("float32", "bfloat16"):
        out = os.path.join(workdir, f"trained_{name}.jsn")
        args = ["--network", net_path, "--train", "true",
                "--train_file", train_nc, "--val_file", val_nc,
                "--truncate_seq", "500", "--parallel_sequences", "50",
                "--stochastic", "true", "--shuffle_fractions", "true",
                "--learning_rate", "1e-4", "--momentum", "0.9",
                "--max_epochs", str(epochs), "--random_seed", str(SEED),
                "--compute_dtype", name, "--save_network", out]
        w = wrappers()
        for f in w.values():
            f.launches = 0  # the training path's run starts here
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args)
        wall = time.perf_counter() - t0
        counts = {k: f.launches for k, f in w.items()}
        text = buf.getvalue()
        rows = [ln for ln in text.splitlines()
                if ln.strip()[:1].isdigit() and "|" in ln]
        for ln in rows:
            phase("train", f"{name} |{ln}")
        if rc != 0 or len(rows) != epochs:
            print(text[-3000:])
            raise AssertionError(f"cli --train true {name} returned {rc}")
        tables[name] = epoch_errors(rows)
        phase("train", f"{name}: {wall:.1f} s wall for {epochs} epochs; "
              f"launches {counts}")
        check_counts(counts, expect)
        if launches is None:
            launches = counts
        start = Network.from_json_file(net_path)
        trained = Network.from_json_file(out)
        moved = max(float(np.abs(trained.params[n][k]
                                 - start.params[n][k]).max())
                    for n in start.params for k in start.params[n])
        if not moved > 0:
            raise AssertionError("training did not move the weights")
        phase("train", f"{name}: trained_network.jsn written, max |w - w0| "
              f"= {moved:.3e}")
    # the trained network serves in forward mode
    outdir = os.path.join(workdir, "served")
    run_cli(val_nc, os.path.join(workdir, "trained_float32.jsn"), outdir)
    tags = [f"val{i:04d}" for i in range(len(val_len))]
    _, worst = read_outputs(outdir, tags, val_len)
    phase("train", f"the trained network serves the val set in forward "
          f"mode: {len(tags)} HTK files, rows sum to 1 within {worst:.1e}")
    return launches, tables


def epoch_errors(rows):
    """The training and validation class errors (%) and errors of each
    epoch row of the CLI's table; raises on a non-finite one."""
    out = []
    for ln in rows:
        cells = ln.replace("%", " ").replace("|", " ").split()
        vals = [float(c) for c in cells[2:6]]
        if not np.isfinite(vals).all():
            raise AssertionError(f"non-finite epoch row: {ln}")
        out.append(vals)
    return out


def train_rates(torch, card):
    """Training frames/s of the bench.py recipe step (T=500, B=50, every
    row full, lr 1e-4, momentum 0.9), synchronised, after a warm-up: the
    kernel path f32 and bf16 and the scan path f32."""
    batch, frames = recipe_batch(torch)
    for label, backend, dtype, reps in (("kernel f32", "auto", "float32", 5),
                                        ("kernel bf16", "auto", "bfloat16",
                                         5),
                                        ("scan f32", "scan", "float32", 1)):
        tr = make_trainer(backend, dtype)
        tr.train_step(*batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            tr.train_step(*batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        phase("rate", f"train step {label}: {frames / dt:,.0f} frames/s "
              f"({1e3 * dt:.1f} ms per step of {frames} frames, mean of "
              f"{reps}) on {card}")


def profile_step(torch, lvcsr=False, remat_blocks=0, dtype="float32"):
    """Device time by kernel over one kernel-path training step (f32, or
    `dtype`), with --remat_blocks when remat_blocks > 0."""
    batch, _ = recipe_batch(torch, states=S_LVCSR if lvcsr else S_STATES)
    tr = make_trainer("auto", dtype, lvcsr)
    tr.net.remat_blocks = remat_blocks
    return profile_trainer_step(
        torch, tr, batch, f"one {'LVCSR' if lvcsr else 'TIMIT'} training "
        f"step T={T_TRAIN} {'f32' if dtype == 'float32' else 'bf16'}"
        + (f" remat_blocks={remat_blocks}" if remat_blocks else ""), dtype)


def profile_trainer_step(torch, tr, batch, what, dtype="float32"):
    """Device time by kernel over the third of three train_step calls of
    `tr` on `batch`, after a warm-up step: busy against wall."""
    from torch.profiler import ProfilerActivity, profile
    tr.train_step(*batch)
    torch.cuda.synchronize()
    # steps 1 and 2 open the trace (a window's first launches go
    # missing), step 3 is the one recorded
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=torch.profiler.schedule(wait=1, warmup=1,
                                                  active=1)) as prof:
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(*batch)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
            prof.step()
    events = report_profile(prof, wall_us, what)
    if events and dtype == "bfloat16":
        # bf16 mode runs every product on the tensor cores: no library
        # GEMM on the FP32 pipes (cuBLAS's sgemm / ...f32f32...ffma)
        f32 = [e.key for e in events
               if any(t in e.key for t in ("sgemm", "f32f32", "ffma"))]
        phase("profile", f"  f32 library GEMMs in this bf16 step: "
              f"{f32 or 'none'}")
        if f32:
            raise AssertionError(f"a bf16 step ran f32 GEMMs: {f32}")
    return events, wall_us


def dev_us(e):
    """A profiler event's own device microseconds."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0) or 0)


def report_profile(prof, wall_us, what):
    # device-side events only: a host op (an autograd node) also reports
    # the device time of the kernels it launched, which would count twice,
    # and so does a scheduled profile's step annotation
    events = sorted((e for e in prof.key_averages()
                     if str(getattr(e, "device_type", "")).endswith("CUDA")
                     and not e.key.startswith("ProfilerStep")),
                    key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in events)
    if busy <= 0:
        phase("profile", f"{what}: device time by kernel not measured (the "
              "profiler recorded no device time)")
        return []
    phase("profile", f"{what}: device busy {busy / 1e3:.2f} ms of "
          f"{wall_us / 1e3:.2f} ms wall ({100 * busy / wall_us:.1f}%)")
    for e in events[:12]:
        if dev_us(e) > 0:
            phase("profile", f"  {dev_us(e) / 1e3:9.3f} ms  "
                  f"{e.count:5d}x  {e.key[:90]}")
    # the GEMM engine's instances carry their product in their name
    per = {}
    for e in events:
        for tag, use in GEMM_TAGS.items():
            if (("gemm_kernel<" in e.key or "gemm3x_kernel<" in e.key)
                    and f"::{tag}," in e.key):
                ms, n = per.get(use, (0.0, 0))
                per[use] = (ms + dev_us(e) / 1e3, n + e.count)
    if per:
        phase("profile", "  GEMM engine by product: " + ", ".join(
            f"{u} {ms:.3f} ms ({n}x)" for u, (ms, n) in per.items())
            + f"; all {sum(ms for ms, _ in per.values()):.3f} ms")
    return events


# the GEMM engine's use tags (csrc/gemm.cuh) and the products they name
GEMM_TAGS = {"GemmDwIn": "dW_in", "GemmDwRec": "dW_rec", "GemmDx": "dx",
             "GemmProj": "proj", "GemmTailDw": "tail dW",
             "GemmTailDh": "tail dh", "GemmTailLogits": "tail logits",
             "GemmWideDh": "wide dh"}


def wide_cost(kind, dtype, N=N_TAIL):
    """(bytes, flops) of K4f and K4b at the LVCSR tail over N frames: K4f
    reads the logits, the targets and writes three per-row stats (its
    elementwise work, a few FP32 operations per logit, counted as 4); K4b
    reads the logits, h, the targets and the stats, writes dz, dW and db,
    and runs the dW product."""
    es = 2 if dtype == "bfloat16" else 4
    P, S = 2 * H, S_LVCSR
    if kind == "softmax_ce_wide_fwd":
        return N * S * es + N * 4 + 3 * N * 4 + 8, 4 * N * S
    return (N * S * es + N * P * es + N * 4 + 3 * N * 4 + 4 + N * S * es
            + P * S * 4 + S * 4, 2 * N * P * S)


def wide_kernels_vs_twins(torch):
    """K4f and K4b against their twins on the card at the LVCSR tail
    (N = 25,000 frames, P = 250, S = 10,112), float32 and bfloat16, with
    controls that the checks must reject and a row tile of dummy frames
    that must give exactly zero; kernel, twin and library times."""
    import torch.nn.functional as F
    from lstm_rnn_tpu_torch.ops import softmax_ce as sc
    gen = torch.Generator("cuda").manual_seed(SEED + 7)
    N, P, S = N_TAIL, 2 * H, S_LVCSR
    h2 = torch.randn(N, P, device="cuda", generator=gen) * 0.5
    W = (torch.rand(P, S, device="cuda", generator=gen) - 0.5) * 0.2
    b = (torch.rand(S, device="cuda", generator=gen) - 0.5) * 0.2
    tc = torch.randint(0, S, (N,), device="cuda", generator=gen,
                       dtype=torch.int32)
    tc[::10] = -1  # dummy frames
    tc[:64] = -1  # one whole K4b row tile of them
    tl = tc.long()
    g = torch.tensor(1.0, device="cuda")
    res = {}
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        loss, cnt, a, off, ssum, pt = sc.softmax_ce_wide_fwd(h2, W, b, tc,
                                                             1.0, dt)
        loss_r, cnt_r, off_r, ssum_r, pt_r = sc.wide_stats_reference(a, tc)
        # the logits product (bf16: the engine on the tensor cores; f32:
        # cuBLAS with the bias in its epilogue) against the twin's, each
        # rounded to the storage dtype: f32 sums in another order, and in
        # bf16 a sum on the other side of a rounding boundary (dz's bound)
        a_rel, _ = rel_err(a, sc.wide_logits_reference(h2, W, b, 1.0, dt))
        torch.cuda.synchronize()
        phase("wide-kernel", f"logits product {name} against the twin's: "
              f"rel {a_rel:.2e} (tol {WIDE_REL['dz'][name]:.1e})")
        if not a_rel <= WIDE_REL["dz"][name]:
            raise AssertionError("the logits product disagrees with its twin")
        pairs = {"off": (off, off_r), "ssum": (ssum, ssum_r),
                 "pt": (pt, pt_r)}
        srel = {k: elem_rel(x, y) for k, (x, y) in pairs.items()}
        serr = max(rel_err(x, y)[1] for x, y in pairs.values())
        lrel = abs(loss.item() - loss_r.item()) / abs(loss_r.item())
        lim = WIDE_REL["stats"][name]
        ctrl = {}
        if name == "bfloat16":
            # control: the stats of the f32 logits, before their rounding,
            # must fail the check (off and pt move by ~2^-9 relative)
            a32 = torch.matmul(h2.to(dt).float(), W.to(dt).float()) + b
            _, _, *st = sc.wide_stats_reference(a32, tc)
            each = {k: elem_rel(x, pairs[k][1]) for k, x in zip(pairs, st)}
            ctrl["stats of f32 a"] = max(each.values())
            phase("wide-kernel", "control, stats of f32 a: " + ", ".join(
                f"{k} {v:.2e}" for k, v in each.items()))
            del a32, st
        ms = time_ms(torch, lambda: sc._launch_wide_fwd(a, tc), 10)
        ms_all = time_ms(torch, lambda: sc.softmax_ce_wide_fwd(
            h2, W, b, tc, 1.0, dt), 5)
        plain = time_ms(torch, lambda: sc.wide_stats_reference(a, tc), 3)

        def lib_call():
            return F.cross_entropy(a, tl, reduction="sum", ignore_index=-1)
        lib = time_ms(torch, lib_call, 10)
        dev_k = prof_ms(torch, [lambda: sc._launch_wide_fwd(a, tc)], 10)
        dev = sum(dev_k.values())
        lib_dev = sum(prof_ms(torch, [lib_call], 10).values())
        res[("softmax_ce_wide_fwd", name)] = dict(
            err=serr, rel=max(srel.values()), loss_rel=lrel,
            ms=dev if dev else ms, events_ms=ms, plain_ms=plain,
            library_ms=lib_dev if lib_dev else lib, library_events_ms=lib,
            cost=wide_cost("softmax_ce_wide_fwd", name))
        phase("wide-kernel", f"K4f softmax_ce_wide_fwd {name}: stats "
              f"max_abs_err={serr:.3e}, elementwise rel " + ", ".join(
                  f"{k} {v:.2e}" for k, v in srel.items())
              + f" (tol {lim:.0e}" + "".join(
                  f"; control {k} {v:.2e}" for k, v in ctrl.items())
              + f"), loss rel {lrel:.2e}, count {cnt.item()} vs "
              f"{cnt_r.item()}; on the device {fmt_ms(dev or None)} ("
              + ", ".join(f"{short_key(k)} {v:.4f}" for k, v in dev_k.items())
              + f"), F.cross_entropy {fmt_ms(lib_dev or None)} on the "
              f"device; CUDA events: kernel {ms:.3f} ms ({ms_all:.3f} ms "
              f"with the logits product), F.cross_entropy {lib:.3f} ms; twin "
              f"{plain:.3f} ms [N={N} P={P} S={S}]")
        if not all(v > lim for v in ctrl.values()):
            raise AssertionError(f"the stats check passes a wrong one: {ctrl}")
        if not (max(srel.values()) <= lim and lrel <= 1e-5
                and abs(cnt.item() - cnt_r.item()) <= 1):
            raise AssertionError("K4f disagrees with its twin")

        hc = h2.to(a.dtype)

        def k4b():
            return sc._launch_wide_bwd(a, hc, tc, off, ssum, pt, g, 1.0)
        dz, dw, db = k4b()
        again = k4b()
        dz_r = sc.wide_dz_reference(a, tc, off, ssum, pt, g)
        dzc_r = dz_r.to(a.dtype)
        dw_r = torch.matmul(hc.float().t(), dzc_r.float())
        db_r = dz_r.sum(dim=0)
        del dz_r
        dh = sc._wide_dh(dz, W, h2.dtype, dt)
        dh_r = sc.wide_dh_reference(dzc_r, W, h2.dtype, dt)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip((dz, dw, db), again))
        del again
        outs = {"dz": (dz, dzc_r), "dW": (dw, dw_r), "db": (db, db_r),
                "dh": (dh, dh_r)}
        errs = {k: rel_err(x, y) for k, (x, y) in outs.items()}
        lims = {"dz": WIDE_REL["dz"][name], "dW": WIDE_REL["dW"][name],
                "db": WIDE_REL["dW"][name], "dh": WIDE_REL["dW"][name]}
        ctrl = {"zero dz": rel_err(torch.zeros_like(dzc_r), dzc_r)[0],
                "rolled dz": rel_err(dzc_r.roll(1, dims=1), dzc_r)[0]}
        dummy_zero = not dz[:64].any() and not dh[:64].any()
        # K4b's kernels on the device (the packing of h, the fused kernel,
        # the sums of the row splits' partials); events around the call
        # and around the call with the dh product, host work included
        dev_k = prof_ms(torch, [k4b], 5)
        dev = sum(dev_k.values())
        ms = time_ms(torch, k4b, 5)
        ms_all = time_ms(torch, lambda: sc.softmax_ce_wide_bwd(
            a, h2, W, tc, off, ssum, pt, g, 1.0, dt), 5)

        def plain_bwd():
            d = sc.wide_dz_reference(a, tc, off, ssum, pt, g)
            dc = d.to(a.dtype)
            return dc, torch.matmul(hc.float().t(), dc.float()), d.sum(0)
        plain = time_ms(torch, plain_bwd, 3)
        # the two products outside the kernels on the device, this route
        # (bf16: the engine on the tensor cores; f32: cuBLAS, the bias in
        # addmm's epilogue) beside the twins' (f32 on the storage dtype's
        # values, the bias added in a pass of its own); cuBLAS's dW on the
        # same operands as a yardstick of K4b's product (no single call
        # computes K4b's function)
        prods = {k: sum(prof_ms(torch, [f], 5).values()) for k, f in (
            ("logits", lambda: sc.wide_logits(h2, W, b, 1.0, dt)),
            ("logits twin",
             lambda: sc.wide_logits_reference(h2, W, b, 1.0, dt)),
            ("dh", lambda: sc._wide_dh(dz, W, h2.dtype, dt)),
            ("dh twin", lambda: sc.wide_dh_reference(dz, W, h2.dtype, dt)),
            ("cuBLAS dW", lambda: torch.matmul(hc.t(), dz)))}
        res[("softmax_ce_wide_bwd", name)] = dict(
            err=max(e[1] for k, e in errs.items() if k != "dh"),
            rel=max(e[0] for e in errs.values()), ms=dev if dev else ms,
            events_ms=ms, plain_ms=plain, library_ms=None,
            library_events_ms=None, cost=wide_cost("softmax_ce_wide_bwd",
                                                   name),
            products_ms=prods)
        phase("wide-kernel", f"K4b softmax_ce_wide_bwd {name}: " + ", ".join(
            f"{k} rel {e[0]:.2e} (tol {lims[k]:.1e})"
            for k, e in errs.items()) + "; controls " + ", ".join(
            f"{k} {v:.2e}" for k, v in ctrl.items()) + f"; dummy tile "
            f"exactly zero: {dummy_zero}; a second launch bit for bit "
            f"equal: {same}; on the device {fmt_ms(dev or None)} ("
            + ", ".join(f"{short_key(k)} {v:.4f}" for k, v in dev_k.items())
            + f"); CUDA events: kernel {ms:.3f} ms ({ms_all:.3f} ms with "
            f"the dh product); twin {plain:.3f} ms")
        phase("wide-kernel", f"K4 products outside {name}, on the device: "
              + ", ".join(f"{k} {fmt_ms(v or None)}"
                          for k, v in prods.items())
              + f" [N={N} P={P} S={S}]")
        if not all(v > lims["dz"] for v in ctrl.values()):
            raise AssertionError(f"the dz check passes a wrong dz: {ctrl}")
        if not (dummy_zero and same
                and all(errs[k][0] <= lims[k] for k in errs)):
            raise AssertionError("K4b disagrees with its twin")
        del loss, a, off, ssum, pt, dz, dw, db, dzc_r, dw_r, db_r, dh, dh_r
        torch.cuda.empty_cache()
    return res


def lvcsr_step_fused_vs_unfused(torch):
    """One LVCSR SGD step from the same weights, the fused tail (K4) vs
    the unfused one (softmax_forward + the multiclass loss under
    autograd), both f32, ragged rows: the loss and the update; and the
    control, the bf16 fused step against the same f32 unfused step,
    which the update check must reject."""
    batch, _ = recipe_batch(torch, full=False, seed=2, states=S_LVCSR)
    out = {}
    for label, fused, dtype in (("fused", True, "float32"),
                                ("unfused", False, "float32"),
                                ("control", True, "bfloat16")):
        tr = make_trainer("auto", dtype, lvcsr=True)
        tr.fused_tail = fused
        before = {n: {k: v.detach().clone() for k, v in l.items()}
                  for n, l in tr.params.items()}
        err, _ = tr.train_step(*batch)
        torch.cuda.synchronize()
        upd = torch.cat([(tr.params[n][k].detach() - before[n][k]).flatten()
                         for n in sorted(before) for k in sorted(before[n])])
        out[label] = (err.item(), upd)
        del tr, before
    l_u, u_u = out["unfused"]

    def rels(label):
        loss, upd = out[label]
        return (abs(loss - l_u) / abs(l_u),
                ((upd - u_u).abs().max() / u_u.abs().max()).item())
    (lrel, urel), (_, urel_c) = rels("fused"), rels("control")
    phase("lvcsr-step", f"one LVCSR SGD step f32 T={T_TRAIN} B={B} "
          f"S={S_LVCSR}: loss fused {out['fused'][0]:.6f} unfused "
          f"{l_u:.6f} (rel {lrel:.2e}, tol {STEP_TOL['loss']:.0e}); update "
          f"rel {urel:.2e} (tol {STEP_TOL['update']:.0e}, max |update| "
          f"{u_u.abs().max().item():.3e}); control (bf16 fused step) update "
          f"rel {urel_c:.2e}")
    if not (lrel <= STEP_TOL["loss"] and urel <= STEP_TOL["update"]):
        raise AssertionError("fused and unfused LVCSR steps disagree")
    if not urel_c > STEP_TOL["update"]:
        raise AssertionError("the update check passes the bf16 control")


def _weights(path):
    with open(path) as f:
        doc = json.load(f)
    return {(n, k): np.asarray(v) for n, sec in doc["weights"].items()
            for k, v in sec.items()}


def lvcsr_cli(torch, workdir):
    """The LVCSR recipe through cli.main (examples/lvcsr_physical_states
    config.cfg and network.jsn) on a synthetic 10,112-state corpus: f32
    with the recipe's autosave, bf16 without; exact launch counts (K4, no
    K3); the autosaves, and --continue from the first one against the
    uninterrupted run; the autosave dump's seconds."""
    import contextlib
    import io
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.config import parse_config
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    paths = write_corpus(workdir, "lvcsr", S_LVCSR, (100, 50), SEED + 2)
    (train_nc, train_len), (val_nc, val_len) = paths["train"], paths["val"]
    n_train = DataSet([train_nc], parallel_sequences=50,
                      trunc_seq_length=500).num_fractions()
    n_val = DataSet([val_nc], parallel_sequences=50).num_fractions()
    if n_train < 3 or n_val < 1:
        raise AssertionError(f"{n_train} train / {n_val} val fractions")
    phase("lvcsr", f"train {len(train_len)} sequences "
          f"({int(train_len.sum())} frames, {n_train} fractions after "
          f"truncation at 500), val {len(val_len)} ({n_val} fraction(s)), "
          f"{S_LVCSR} states")
    cfg_path = os.path.join(LVCSR_DIR, "config.cfg")
    base = [cfg_path, "--network", os.path.join(LVCSR_DIR, "network.jsn"),
            "--train_file", train_nc, "--val_file", val_nc,
            "--max_epochs", "2", "--random_seed", str(SEED)]
    per_epoch = {"lstm_fwd": 5 * n_val, "lstm_fwd_save": 5 * n_train,
                 "lstm_bwd": 5 * n_train, "softmax_ce_proj_fwd": 0,
                 "softmax_ce_proj_bwd": 0,
                 "softmax_ce_wide_fwd": n_train + n_val,
                 "softmax_ce_wide_bwd": n_train, "lstm_fwd_carry": 0,
                 "lstm_fwd_carry_save": 0, "lstm_bwd_carry": 0,
                 "softmax_ce_fwd": 0, "softmax_ce_bwd": 0}
    here = os.getcwd()
    launches, outs, tables = None, {}, {}
    for label, args, epochs in (
            ("float32", base, 2),
            ("bfloat16", base + ["--compute_dtype", "bfloat16",
                                 "--autosave", "false"], 2),
            ("continue", ["--continue", os.path.join(
                workdir, "lvcsr_float32", "epoch001.autosave")], 1)):
        rundir = os.path.join(workdir, f"lvcsr_{label}")
        os.makedirs(rundir)
        w = wrappers()
        for f in w.values():
            f.launches = 0  # the LVCSR path's run starts here
        buf = io.StringIO()
        os.chdir(rundir)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(args)
            wall = time.perf_counter() - t0
        finally:
            os.chdir(here)
        counts = {k: f.launches for k, f in w.items()}
        text = buf.getvalue()
        rows = [ln for ln in text.splitlines()
                if ln.strip()[:1].isdigit() and "|" in ln]
        for ln in rows:
            phase("lvcsr", f"{label} |{ln}")
        if rc != 0 or len(rows) != 2:
            print(text[-3000:])
            raise AssertionError(f"cli (LVCSR, {label}) returned {rc}")
        phase("lvcsr", f"{label}: {wall:.1f} s wall for {epochs} epoch(s); "
              f"launches {counts}")
        tables[label] = epoch_errors(rows)
        check_counts(counts, {k: v * epochs for k, v in per_epoch.items()},
                     bf16=label == "bfloat16")
        if label == "float32":
            launches = counts
            saves = sorted(os.listdir(rundir))
            phase("lvcsr", f"{label}: files {saves}")
            for name in ("epoch001.autosave", "epoch002.autosave"):
                if name not in saves:
                    raise AssertionError(f"{name} was not written")
        outs[label] = _weights(os.path.join(rundir, "trained_network.jsn"))
    def maxabs(label, k, v):
        return float(np.abs(outs[label][k] - v).max(initial=0.0))
    ref = outs["float32"]
    wmax = max(float(np.abs(v).max(initial=0.0)) for v in ref.values())
    diff = max(maxabs("continue", k, v) for k, v in ref.items())
    d16 = max(maxabs("bfloat16", k, v) for k, v in ref.items())
    phase("lvcsr", f"--continue epoch001.autosave vs the uninterrupted run: "
          f"max |w - w_straight| = {diff:.3e} (tol {CONTINUE_TOL:.0e}); "
          f"bf16 vs f32 trained weights {d16:.3e}; max |w| {wmax:.3e}")
    if not diff <= CONTINUE_TOL:
        raise AssertionError("the resumed run differs from the straight run")

    # the dump alone: one LVCSR-width autosave written as the CLI writes it
    from lstm_rnn_tpu_torch.models.flagship import build_lvcsr_network
    from lstm_rnn_tpu_torch.trainer import Trainer
    cfg = parse_config(base + ["--autosave_prefix",
                               os.path.join(workdir, "dump")])
    net = build_lvcsr_network(seed=SEED)
    tr = Trainer(net, None)
    t0 = time.perf_counter()
    saver = cli._save_autosave(cfg, net, tr, "rows")
    t1 = time.perf_counter()
    cli._join_saver(saver)
    t2 = time.perf_counter()
    n = sum(v.size for layer in net.params.values() for v in layer.values())
    phase("lvcsr", f"autosave of the LVCSR net ({n} weights, {3 * n} floats "
          f"with the best weights and deltas): {t1 - t0:.3f} s on the "
          f"calling thread (copies to the host), {saver.seconds:.1f} s JSON "
          f"dump on the worker thread, {t2 - t0:.1f} s in all, "
          f"{os.path.getsize(saver.path) / 2**20:.0f} MiB")
    os.remove(saver.path)
    return launches, tables


def lvcsr_rates(torch, card):
    """Training frames/s of bench.py --recipe lvcsr's step (T=500, B=50,
    every row full, lr 1e-4, momentum 0.9), f32 and bf16, synchronised,
    mean of 5 after a warm-up step."""
    batch, frames = recipe_batch(torch, states=S_LVCSR)
    for label, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        tr = make_trainer("auto", dtype, lvcsr=True)
        tr.train_step(*batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            tr.train_step(*batch)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 5
        phase("rate", f"LVCSR train step {label}: {frames / dt:,.0f} "
              f"frames/s ({1e3 * dt:.1f} ms per step of {frames} frames, "
              f"mean of 5) on {card}")
        del tr


def tail_crossover(torch):
    """The three tails, forward + backward, at N = 25,000, P = 250 and
    S = 183, 512, 832 (K3 where it fits the card; K4 and K5 with their
    products outside, K5's in cuBLAS as its path runs them under
    autograd): measured only, the route stays K3 where it fits and remat
    is off."""
    from lstm_rnn_tpu_torch.ops import softmax_ce as sc
    from lstm_rnn_tpu_torch.ops.lstm_cell import storage_dtype
    gen = torch.Generator("cuda").manual_seed(SEED + 9)
    N, P = N_TAIL, 2 * H
    g = torch.tensor(1.0, device="cuda")
    for S in (183, 512, 832):
        h2 = torch.randn(N, P, device="cuda", generator=gen) * 0.5
        W = (torch.rand(P, S, device="cuda", generator=gen) - 0.5) * 0.2
        b = (torch.rand(S, device="cuda", generator=gen) - 0.5) * 0.2
        tc = torch.randint(0, S, (N,), device="cuda", generator=gen,
                           dtype=torch.int32)
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)

            def k3():
                _, _, p = sc.softmax_ce_proj_fwd(h2, W, b, tc, 1.0, dt)
                sc.softmax_ce_proj_bwd(p, h2, W, tc, g, 1.0, dt)

            def k4():
                _, _, a, off, ssum, pt = sc.softmax_ce_wide_fwd(
                    h2, W, b, tc, 1.0, dt)
                sc.softmax_ce_wide_bwd(a, h2, W, tc, off, ssum, pt, g, 1.0,
                                       dt)
            def k5():
                hs = h2.to(storage_dtype(dt)).float()
                Ws = W.to(storage_dtype(dt)).float()
                a = torch.addmm(b, hs, Ws)
                _, _, p = sc.softmax_ce_fwd(a, tc, dt)
                dz = sc.softmax_ce_bwd(p, tc, g)
                torch.matmul(dz, Ws.t())  # dh
                torch.matmul(hs.t(), dz)  # dW
                dz.sum(dim=0)  # db
            fits = sc.proj_tail_fits(S, sc.tail_smem_optin("cuda"))
            t3 = (f"{time_ms(torch, k3, 10):.3f} ms" if fits else
                  "does not fit the card (the route takes K4)")
            t4, t5 = time_ms(torch, k4, 10), time_ms(torch, k5, 10)
            phase("crossover", f"S={S} {name}: K3 fwd+bwd {t3}, K4 "
                  f"fwd+bwd (products included) {t4:.3f} ms, K5 fwd+bwd "
                  f"(products included) {t5:.3f} ms [N={N} P={P}]")


def streaming_network(seed, **net_kwargs):
    """The streaming stack: the TIMIT recipe's layers with every BLSTM made
    an LSTM of the same size (117 -> 5 x LSTM(250) -> softmax(183)), as
    scripts/tpu_measure_r5b.py:59-62 builds it; random weights from seed."""
    from lstm_rnn_tpu_torch.models.flagship import timit_dblstm_layers
    from lstm_rnn_tpu_torch.network import Network
    layers = timit_dblstm_layers()
    for layer in layers:
        if layer["type"] == "blstm":
            layer["type"] = "lstm"
    net = Network(layers, **net_kwargs)
    net.init_params(seed)
    return net


def chunk_mask(torch, T, Bs):
    """[B, T] step mask of a streamed chunk: rows 0 and 5+ full, row 1 ends
    at step 20, row 2 has a NONE gap (steps 10-19) and restarts, row 3
    starts at step 32, row 4 has no valid step."""
    m = torch.ones(Bs, T, dtype=torch.bool, device="cuda")
    m[1, 20:] = False
    m[2, 10:20] = False
    m[3, :32] = False
    m[4] = False
    return m


def carry_kernel_vs_twin(torch):
    """Phase 14: the carry kernel against its twin at one streaming layer's
    width, f32 and bf16, with two controls that must fail; kernel, twin
    and recurrence-only times."""
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    T, Bs, Hs = CHUNK, B_STREAM, H_STREAM
    mask = chunk_mask(torch, T, Bs)
    steps = mask.sum(dim=1).cpu().numpy()
    res = {}
    for P in (117, 250):
        rng = np.random.RandomState(P + 14)

        def u(lo, hi, *shape):
            return torch.tensor(rng.uniform(lo, hi, shape),
                                dtype=torch.float32, device="cuda")
        x = torch.tensor(rng.randn(T, Bs, P), dtype=torch.float32,
                         device="cuda")
        args = (x, u(-0.1, 0.1, 1, P, 4 * Hs), u(-0.1, 0.1, 1, Hs, 4 * Hs),
                u(-0.1, 0.1, 1, 3, Hs), u(-0.1, 0.1, 1, 4 * Hs),
                torch.full((Bs,), T, dtype=torch.int32, device="cuda"))
        # a carried state of the size a stream reaches
        h0, c0 = u(-0.9, 0.9, 1, Bs, Hs), u(-3.0, 3.0, 1, Bs, Hs)
        prefix = mask.sum(dim=1, dtype=torch.int32)
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)

            def kernel(h=h0, c=c0, m=mask, lengths=args[5]):
                return lc.lstm_scan_fused_carry(
                    *args[:5], lengths, h, c, 1.0, True, dt, True, None, 0,
                    m)
            want = lc.lstm_scan_carry_reference(*args, h0, c0, 1.0, dt,
                                                None, 0, mask)

            def errs(got):
                return [(g.float() - w.float()).abs().max().item()
                        for g, w in zip((got[0], *got[1]),
                                        (want[0], *want[1]))]
            got = kernel()
            torch.cuda.synchronize()
            if not all(torch.isfinite(g.float()).all()
                       for g in (got[0], *got[1])):
                raise AssertionError(f"carry kernel output not finite "
                                     f"(P={P}, {name})")
            err = errs(got)
            z = torch.zeros_like(h0)
            ctrl = {"zero carries": max(errs(kernel(h=z, c=z))),
                    "prefix lengths": max(errs(kernel(m=None,
                                                      lengths=prefix)))}
            ms = time_ms(torch, kernel, 20)
            plain = time_ms(torch, lambda: lc.lstm_scan_carry_reference(
                *args, h0, c0, 1.0, dt, None, 0, mask), 1)
            a = lc._launch_proj(x.to(dt), args[1].to(dt), args[4], 1.0)
            w_rec = args[2].to(dt)
            m8 = mask.to(torch.uint8)
            rec = time_ms(torch, lambda: lc._launch_rec_carry(
                a, w_rec, args[3], args[5], m8, h0, c0, T, 0), 20)
            # K0's recurrence on the same chunk (every row full): what the
            # carry variant's state, mask and full-length walk cost
            rec0 = time_ms(torch, lambda: lc._launch_rec(
                a, w_rec, args[3], args[5]), 20)
            phase("carry-kernel", f"P={P} {name}: max_abs_err h "
                  f"{err[0]:.3e}, hf {err[1]:.3e}, cf {err[2]:.3e} (tol "
                  f"{TOL[name]:.0e}); controls " + ", ".join(
                      f"{k} {v:.2e}" for k, v in ctrl.items())
                  + f"; kernel {ms:.3f} ms (recurrence {rec:.3f} ms = "
                  f"{1e3 * rec / T:.2f} us per step; K0's on the same "
                  f"chunk {1e3 * rec0 / T:.2f} us); twin {plain:.1f} ms "
                  f"[T={T} B={Bs} H={Hs} D=1, {int(steps.sum())} valid "
                  "steps]")
            if not max(err) <= TOL[name]:
                raise AssertionError(f"carry kernel disagrees with its twin: "
                                     f"{err} > {TOL[name]} (P={P}, {name})")
            if not all(v > TOL[name] for v in ctrl.values()):
                raise AssertionError(f"the carry check passes a wrong "
                                     f"chunk: {ctrl}")
            res[(P, name)] = {
                "err": max(err), "ms": ms, "plain_ms": plain,
                "rec_ms": rec, "us_per_step": 1e3 * rec / T,
                "cost": lstm_cost("lstm_fwd_carry", P, steps, name, T=T,
                                  D=1, H=Hs)}
    return res


def stream_batch(torch, seed):
    """T_STREAM frames of B_STREAM streams: N(0, 1) inputs, most rows full,
    every eighth row ending early (a stream whose utterance ends)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T_STREAM, B_STREAM, 117).astype(np.float32)
    lengths = np.full(B_STREAM, T_STREAM)
    lengths[::8] = rng.randint(100, T_STREAM, B_STREAM // 8)
    pt = (np.arange(T_STREAM)[:, None] < lengths[None, :]).astype(np.int8)
    return torch.from_numpy(x).cuda(), torch.from_numpy(pt).cuda()


def stream(net, params, x, pt, hidden_only=False):
    """x through net.apply_streaming in CHUNK-frame chunks from a fresh
    state, the outputs concatenated; with hidden_only, through the layers
    below the softmax only."""
    import torch
    state = net.init_stream_state(x.shape[1], x.device)
    outs = []
    for lo in range(0, x.shape[0], CHUNK):
        xc, pc = x[lo:lo + CHUNK], pt[lo:lo + CHUNK]
        if hidden_only:
            y, state = net._apply_layers(params, xc, pc, net.specs[1:-2],
                                         state)
        else:
            y, state = net.apply_streaming(params, xc, pc, state)
        outs.append(y)
    return torch.cat(outs)


def chained_vs_whole(torch):
    """Phase 15: apply_streaming over 8 chained chunks against apply (K0)
    on the whole sequence, f32 and bf16: the last LSTM layer's output and
    the posteriors."""
    x, pt = stream_batch(torch, SEED + 15)
    for name in ("float32", "bfloat16"):
        net = streaming_network(SEED, compute_dtype=name)
        params = net.device_params("cuda")
        hidden_whole = net._apply_layers(params, x, pt, net.specs[1:-2])
        hidden = stream(net, params, x, pt, hidden_only=True)
        y_whole = net.apply(params, x, pt)
        y = stream(net, params, x, pt)
        torch.cuda.synchronize()
        same = torch.equal(hidden, hidden_whole)
        dh = (hidden - hidden_whole).abs().max().item()
        dp = (y - y_whole).abs().max().item()
        phase("chained", f"{name}: {T_STREAM // CHUNK} chained {CHUNK}-frame "
              f"chunks vs the whole sequence (T={T_STREAM} B={B_STREAM}): "
              f"last LSTM layer bit-identical: {same} (max diff {dh:.3e}); "
              f"posteriors max diff {dp:.3e} (tol {STREAM_TOL:.0e})")
        if not (torch.isfinite(y).all() and dp <= STREAM_TOL
                and dh <= TOL[name]):
            raise AssertionError(f"chained chunks disagree with the whole "
                                 f"sequence ({name}): {dh}, {dp}")


def stream_cli(torch, workdir, nc, tags, lengths):
    """Phase 16: streaming serving through cli.main on phase 5's corpus
    with the unidirectional net: f32 and bf16 against the whole-sequence
    run of the same net, exact launch counts, and a BLSTM net refused."""
    import contextlib
    import io
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    net_path = os.path.join(workdir, "network_uni.jsn")
    streaming_network(SEED).save(net_path)
    t_frac = [f.inputs.shape[0] for f in DataSet(
        [nc], parallel_sequences=50, prefetch=False).fractions()]
    chunks = sum(-(-t // CHUNK) for t in t_frac)
    none = {k: 0 for k in wrappers()}
    launches = None
    for name in ("float32", "bfloat16"):
        outs = {}
        for label, extra, expect in (
                ("stream", ["--stream_chunk", str(CHUNK)],
                 {**none, "lstm_fwd_carry": 5 * chunks}),
                ("whole", [], {**none, "lstm_fwd": 5 * len(t_frac)})):
            w = wrappers()
            for f in w.values():
                f.launches = 0  # the streaming path's run starts here
            outdir = os.path.join(workdir, f"uni_{label}_{name}")
            wall = run_cli(nc, net_path, outdir, "--compute_dtype", name,
                           *extra)
            counts = {k: f.launches for k, f in w.items()}
            outs[label], worst = read_outputs(outdir, tags, lengths)
            phase("stream-cli", f"{name} {label}: {wall:.2f} s wall; "
                  f"launches {counts}; row sums within {worst:.1e}")
            check_counts(counts, expect)
            if label == "stream" and name == "float32":
                launches = counts
        d = max(float(np.abs(a - b).max())
                for a, b in zip(outs["stream"], outs["whole"]))
        phase("stream-cli", f"{name}: --stream_chunk {CHUNK} vs whole "
              f"sequence, {len(t_frac)} fractions of T={t_frac} "
              f"({chunks} chunks): max |p_stream - p_whole| = {d:.3e} (tol "
              f"{STREAM_TOL:.0e})")
        if not d <= STREAM_TOL:
            raise AssertionError(f"streamed CLI posteriors differ: {d}")
    # the TIMIT recipe's BLSTM net cannot stream
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["--network", os.path.join(workdir, "network.jsn"),
                       "--train", "false", "--ff_input_file", nc,
                       "--ff_output_file", os.path.join(workdir, "blstm"),
                       "--stream_chunk", str(CHUNK)])
    text = buf.getvalue()
    if rc == 0 or "bidirectional" not in text or "Computing" in text:
        raise AssertionError(f"a BLSTM net streamed (rc {rc})")
    phase("stream-cli", f"BLSTM net with --stream_chunk {CHUNK}: refused "
          f"(rc {rc}): {text.strip().splitlines()[-1][:100]}")
    return launches


def stream_rates(torch, card):
    """Phase 17: streaming frames/s (T=512 in 64-frame chunks, B=64, every
    row full) against whole-sequence apply on the same stack, f32 and
    bf16; the latency of one chunk, host wall and device; a profile of
    one chunk."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.RandomState(SEED + 17)
    x = torch.from_numpy(rng.randn(T_STREAM, B_STREAM, 117).astype(
        np.float32)).cuda()
    pt = torch.ones(T_STREAM, B_STREAM, dtype=torch.int8, device="cuda")
    frames = T_STREAM * B_STREAM
    for name in ("float32", "bfloat16"):
        net = streaming_network(SEED, compute_dtype=name)
        params = net.device_params("cuda")
        rates = {}
        for label, fn in (("streamed", lambda: stream(net, params, x, pt)),
                          ("whole", lambda: net.apply(params, x, pt))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            rates[label] = 3 * frames / (time.perf_counter() - t0)
        # one chunk at a time, each synchronised: what a stream waits for
        state = net.init_stream_state(B_STREAM, "cuda")
        walls, devs = [], []
        for lo in range(0, T_STREAM, CHUNK):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            _, state = net.apply_streaming(params, x[lo:lo + CHUNK],
                                           pt[lo:lo + CHUNK], state)
            end.record()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            devs.append(start.elapsed_time(end))
        phase("stream-rate", f"{name}: streamed {rates['streamed']:,.0f} "
              f"frames/s, whole sequence {rates['whole']:,.0f} frames/s "
              f"(T={T_STREAM} B={B_STREAM}, {CHUNK}-frame chunks, mean of "
              f"3); one chunk: host wall {np.mean(walls):.3f} ms (min "
              f"{min(walls):.3f}), device {np.mean(devs):.3f} ms (mean of "
              f"{len(walls)}) on {card}")
        if name == "float32":
            # chunks 1 and 2 open the trace (a window's first launches go
            # missing), chunk 3 is the one recorded
            state = net.init_stream_state(B_STREAM, "cuda")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=torch.profiler.schedule(
                             wait=1, warmup=1, active=1)) as prof:
                for lo in range(0, 3 * CHUNK, CHUNK):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, state = net.apply_streaming(
                        params, x[lo:lo + CHUNK], pt[lo:lo + CHUNK], state)
                    torch.cuda.synchronize()
                    wall_us = 1e6 * (time.perf_counter() - t0)
                    prof.step()
            report_profile(prof, wall_us, f"one streamed {CHUNK}-frame "
                           f"chunk f32, B={B_STREAM}")


# sequence parallelism (phases 18-21): the TIMIT layer's time block on a
# 4-block mesh at bench.py's T=500
N_SEQ = 4
T_BLOCK = T_TRAIN // N_SEQ
# four chained K6b blocks against K1 + K2 on the whole layer, f32: the
# same f32 operations summed in another order (the chain hands its
# cell-state terms on as dc0), relative to each output's largest entry
CHAIN_REL = 1e-5
# the SP training step against the single-device kernel step (f32): the
# loss to sum-order noise; every gradient relative to its largest entry
SP_STEP_TOL = {"loss": 1e-5, "grad": 1e-4}
# SP Trainer's epoch errors against the single-device Trainer's, relative
SP_EPOCH_TOL = 1e-5


def carry_grad_layer(torch, P, seed, T=T_BLOCK, rows=B):
    """One SP block of a TIMIT layer, one direction, T frames of `rows`
    sequences: the recipe's +-0.1 weights, N(0, 1) inputs; non-zero (h0,
    c0) of the size a block hands on and non-zero cotangents; lengths
    full, ending inside the block (rows 8-19), 0 (rows 4-7: one whole
    kernel block, and row 1) and 1 (row 2)."""
    rng = np.random.RandomState(seed)

    def u(lo, hi, *s):
        return torch.tensor(rng.uniform(lo, hi, s), dtype=torch.float32,
                            device="cuda")
    x = torch.tensor(rng.randn(T, rows, P), dtype=torch.float32,
                     device="cuda")
    lengths = np.full(rows, T)
    lengths[8:20] = rng.randint(1, T, 12)
    lengths[4:8], lengths[1], lengths[2] = 0, 0, 1
    args = (x, u(-0.1, 0.1, 1, P, 4 * H), u(-0.1, 0.1, 1, H, 4 * H),
            u(-0.1, 0.1, 1, 3, H), u(-0.1, 0.1, 1, 4 * H),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    carry = (u(-0.9, 0.9, 1, rows, H), u(-3.0, 3.0, 1, rows, H))
    cts = (torch.tensor(rng.randn(T, rows, H), dtype=torch.float32,
                        device="cuda"),
           u(-1.0, 1.0, 1, rows, H), u(-1.0, 1.0, 1, rows, H))
    return args, carry, cts


def carry_grad_kernels_vs_twins(torch):
    """Phase 18: K6b forward and backward, and K6f, against their twins at
    one SP block of a TIMIT layer, both directions, f32 and bf16, with
    controls that must fail; kernel and twin times."""
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    res = {}
    for P, need_dx in ((117, False), (250, True)):
        args, (h0, c0), (dh, dhf, dcf) = carry_grad_layer(torch, P, P + 18)
        lens = args[5].cpu().numpy()
        z = torch.zeros_like(h0)
        for dir_offset in (0, 1):
            for name in ("float32", "bfloat16"):
                dt = getattr(torch, name)

                def fwd(hh=h0, cc=c0):
                    return lc.lstm_fwd_save_carry(*args, hh, cc, 1.0, dt,
                                                  None, dir_offset)
                got = fwd()
                want = lc.lstm_scan_carry_reference(
                    *args, h0, c0, 1.0, dt, None, dir_offset, None, True)
                torch.cuda.synchronize()

                def f_errs(out):
                    return [rel_err(g, w) for g, w in zip(
                        (*out[:3], *out[3]), (*want[:3], *want[3]))]
                errs = f_errs(got)
                frel = max(e[0] for e in errs)
                ferr = max(e[1] for e in errs)
                fctrl = max(e[0] for e in f_errs(fwd(z, z)))

                # K6f on the same block: what SP serving and the SP
                # Trainer's validation passes launch (no residuals, no step
                # mask: validity from the prefix lengths)
                def k6f(hh=h0, cc=c0):
                    return lc.lstm_scan_fused_carry(
                        *args, hh, cc, 1.0, True, dt, True, None, dir_offset)
                want_6 = lc.lstm_scan_carry_reference(*args, h0, c0, 1.0, dt,
                                                      None, dir_offset)

                def k6f_errs(out):
                    return [(g.float() - w.float()).abs().max().item()
                            for g, w in zip((out[0], *out[1]),
                                            (want_6[0], *want_6[1]))]
                got_6 = k6f()
                torch.cuda.synchronize()
                err_6 = k6f_errs(got_6)
                ctrl_6 = max(k6f_errs(k6f(z, z)))
                ms_6 = time_ms(torch, k6f, 10)
                b_6 = bound(*lstm_cost("lstm_fwd_carry", P, lens, name,
                                       T=T_BLOCK, D=1), name)[0]
                a = lc._launch_proj(args[0].to(dt), args[1].to(dt), args[4],
                                    1.0)
                w_rec = args[2].to(dt)
                rec_6 = time_ms(torch, lambda: lc._launch_rec_carry(
                    a, w_rec, args[3], args[5], None, h0, c0, T_BLOCK,
                    dir_offset), 10)
                rec_f = time_ms(torch, lambda: lc._launch_rec_carry(
                    a, w_rec, args[3], args[5], None, h0, c0, T_BLOCK,
                    dir_offset, save=True), 10)
                del a
                phase("carry-grad", f"K6f P={P} dir_offset={dir_offset} "
                      f"{name}, prefix lengths: max_abs_err h {err_6[0]:.3e}"
                      f", hf {err_6[1]:.3e}, cf {err_6[2]:.3e} (tol "
                      f"{TOL[name]:.0e}; control zero carries {ctrl_6:.2e});"
                      f" kernel {ms_6:.3f} ms (bound {b_6:.3f}; recurrence "
                      f"{rec_6:.3f} ms = {1e3 * rec_6 / T_BLOCK:.2f} us per "
                      f"step) [T={T_BLOCK} B={B} H={H} D=1]")
                if not (all(torch.isfinite(t.float()).all()
                            for t in (got_6[0], *got_6[1]))
                        and max(err_6) <= TOL[name]):
                    raise AssertionError(f"K6f disagrees with its twin on the "
                                         f"SP block (P={P}, dir_offset="
                                         f"{dir_offset}, {name}): {err_6}")
                if not ctrl_6 > TOL[name]:
                    raise AssertionError(f"the K6f check passes zero carries: "
                                         f"{ctrl_6}")
                h, c, g, _ = got
                bwd_args = (args[0], args[1], args[2], args[3], args[5], h,
                            c, g, h0, c0, dh, dhf, dcf, 1.0, True, dt,
                            need_dx, None, dir_offset)

                def bwd(hf_ct=dhf, cf_ct=dcf, cc=c0):
                    a = list(bwd_args)
                    a[9], a[11], a[12] = cc, hf_ct, cf_ct
                    return lc.lstm_bwd_carry(*a)
                got_b = bwd()
                want_b = lc.lstm_scan_carry_bwd_reference(*bwd_args)
                torch.cuda.synchronize()

                def b_errs(out):
                    return [rel_err(a, b) if a is not None else (0.0, 0.0)
                            for a, b in zip(out, want_b)]
                errs_b = b_errs(got_b)
                brel = max(e[0] for e in errs_b)
                berr = max(e[1] for e in errs_b)
                bctrl = {"zero dhf/dcf": max(
                             e[0] for e in b_errs(bwd(z, z))),
                         "zero c0": max(e[0] for e in b_errs(bwd(cc=z)))}
                finite = all(torch.isfinite(t.float()).all() for t in
                             (*got[:3], *got[3], *[a for a in got_b
                                                   if a is not None]))
                ms_f = time_ms(torch, fwd, 10)
                ms_b = time_ms(torch, bwd, 5)
                rec_b = kernel_device_ms(torch, bwd, "bptt_carry_kernel")
                plain_f = time_ms(torch, lambda: (
                    lc.lstm_scan_carry_reference(*args, h0, c0, 1.0, dt,
                                                 None, dir_offset, None,
                                                 True)), 1)
                plain_b = time_ms(torch, lambda: (
                    lc.lstm_scan_carry_bwd_reference(*bwd_args)), 1)
                lim_f = REL["lstm_fwd_save"][name]
                lim_b = REL["lstm_bwd"][name]
                b_f = bound(*lstm_cost("lstm_fwd_carry_save", P, lens, name,
                                       T=T_BLOCK, D=1), name)[0]
                b_b = bound(*lstm_cost("lstm_bwd_carry", P, lens, name,
                                       need_dx, T=T_BLOCK, D=1), name)[0]
                phase("carry-grad", f"K6b-f P={P} dir_offset={dir_offset} "
                      f"{name}: rel {frel:.2e} [" + per_output(
                          ("h", "c", "gates", "hf", "cf"), errs) + f"] (tol "
                      f"{lim_f:.1e}; control zero carries {fctrl:.2e}); "
                      f"kernel {ms_f:.3f} ms (bound {b_f:.3f}; recurrence "
                      f"{rec_f:.3f} ms = {1e3 * rec_f / T_BLOCK:.2f} us per "
                      f"step); twin {plain_f:.1f} ms [T={T_BLOCK} B={B} "
                      f"H={H} D=1]")
                phase("carry-grad", f"K6b-b P={P} dir_offset={dir_offset} "
                      f"need_dx={need_dx} {name}: rel {brel:.2e} [" +
                      per_output(("dx", "dW_in", "dW_rec", "dpeep", "dbias",
                                  "dh0", "dc0"), errs_b) + f"] (tol "
                      f"{lim_b:.1e}; controls " + ", ".join(
                          f"{k} {v:.2e}" for k, v in bctrl.items())
                      + f"); kernel {ms_b:.3f} ms (bound {b_b:.3f}; "
                      f"bptt_carry_kernel {rec_b:.3f} ms on the device = "
                      f"{1e3 * rec_b / T_BLOCK:.2f} us per step); twin "
                      f"{plain_b:.1f} ms")
                if not (finite and frel <= lim_f and brel <= lim_b):
                    raise AssertionError(f"K6b disagrees with its twins "
                                         f"(P={P}, dir_offset={dir_offset}, "
                                         f"{name}): {frel}, {brel}")
                if not (fctrl > lim_f and all(v > lim_b
                                              for v in bctrl.values())):
                    raise AssertionError(f"the K6b check passes a wrong "
                                         f"input: {fctrl}, {bctrl}")
                for kind, err, rel, ms, plain, rec in (
                        ("lstm_fwd_carry_save", ferr, frel, ms_f, plain_f,
                         rec_f),
                        ("lstm_bwd_carry", berr, brel, ms_b, plain_b,
                         rec_b)):
                    res[(kind, P, dir_offset, name)] = dict(
                        err=err, rel=rel, ms=ms, plain_ms=plain, rec_ms=rec,
                        us_per_step=1e3 * rec / T_BLOCK,
                        cost=lstm_cost(kind, P, lens, name, need_dx,
                                       T=T_BLOCK, D=1))
    return res


def sp_mesh(torch):
    """The 4-block seq mesh of one card: cuda:0 four times."""
    return [torch.device("cuda", 0)] * N_SEQ


def mesh_name(mesh):
    gpus = len(set(mesh))
    return f"{len(mesh)} blocks on " + (f"{gpus} GPUs" if gpus > 1
                                        else "one card")


def sync_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def chained_blocks_vs_whole(torch):
    """Phase 19: one BLSTM layer at T=500 as four chained K6b blocks per
    direction (the SP kernel wavefront) against K1 + K2 on the whole
    sequence: h and every gradient, f32, with the exact launches."""
    from lstm_rnn_tpu_torch.models.lstm import lstm_forward
    from lstm_rnn_tpu_torch.parallel.sequence import lstm_forward_seq
    rng = np.random.RandomState(19)
    P = 2 * H
    params = {k: torch.tensor(rng.uniform(-0.1, 0.1, s), dtype=torch.float32,
                              device="cuda", requires_grad=True)
              for k, s in (("W_in", (D, P, 4, H)), ("W_rec", (D, H, 4, H)),
                           ("b", (D, 4, H)), ("peep", (D, 3, H)))}
    x = torch.tensor(rng.randn(T_TRAIN, B, P), dtype=torch.float32,
                     device="cuda", requires_grad=True)
    lengths = np.full(B, T_TRAIN)
    lengths[8:20] = rng.randint(1, T_TRAIN, 12)
    lengths[4:8] = 0
    pt = torch.tensor((np.arange(T_TRAIN)[:, None] < lengths[None, :])
                      .astype(np.int8), device="cuda")
    dy = torch.tensor(rng.randn(T_TRAIN, B, 2 * H), dtype=torch.float32,
                      device="cuda")
    leaves = [x] + [params[k] for k in sorted(params)]
    w = wrappers()
    outs = {}
    for label in ("chained", "whole"):
        for f in w.values():
            f.launches = 0
        if label == "whole":
            y = lstm_forward(params, x, pt, 1.0, True)
        else:
            mesh = sp_mesh(torch)
            xs = list(x.split(T_BLOCK))
            pts = list(pt.split(T_BLOCK))
            y = torch.cat(lstm_forward_seq(params, xs, pts, 1.0, True, mesh))
        grads = torch.autograd.grad((y * dy).sum(), leaves)
        torch.cuda.synchronize()
        outs[label] = (y.detach(), grads,
                       {k: f.launches for k, f in w.items() if f.launches})
    (y_c, g_c, n_c), (y_w, g_w, n_w) = outs["chained"], outs["whole"]
    errs = [rel_err(y_c, y_w)] + [rel_err(a, b) for a, b in zip(g_c, g_w)]
    names = ["h", "dx"] + [f"d{k}" for k in sorted(params)]
    phase("chain", f"{N_SEQ} chained K6b blocks per direction vs K1 + K2 on "
          f"the whole layer (T={T_TRAIN} B={B} H={H} P={P}, f32): " +
          per_output(names, errs) + f" (tol {CHAIN_REL:.0e}); launches "
          f"chained {n_c}, whole {n_w}")
    if not max(e[0] for e in errs) <= CHAIN_REL:
        raise AssertionError(f"chained blocks differ from the whole layer: "
                             f"{errs}")
    gemm = ("gemm:proj", "gemm:dW_in", "gemm:dW_rec", "gemm:dx")
    if n_c != {"lstm_fwd_carry_save": 2 * N_SEQ, "lstm_bwd_carry": 2 * N_SEQ,
               **dict.fromkeys(gemm, 2 * N_SEQ)} or n_w != {
                   "lstm_fwd_save": 1, "lstm_bwd": 1,
                   **dict.fromkeys(gemm, 1)}:
        raise AssertionError(f"launches chained {n_c}, whole {n_w}")


def sp_trainer(dtype, train=None, val=None, seed=3, mesh=None):
    """The bench.py recipe's Trainer on the TIMIT net; SP over `mesh`, or
    on one device without one."""
    from lstm_rnn_tpu_torch.models.flagship import build_timit_network
    from lstm_rnn_tpu_torch.trainer import Trainer
    net = build_timit_network(seed=seed, compute_dtype=dtype)
    return Trainer(net, train, val, learning_rate=1e-4, momentum=0.9,
                   max_epochs=2, hybrid_online_batch=True, seq_mesh=mesh)


def sp_step_vs_single(torch, mesh):
    """Phase 20a: one TIMIT training step on bench.py's fraction, SP on
    the mesh vs the single-device kernel step (f32): loss, count, every
    gradient; the SP step's exact launches."""
    batch, _ = recipe_batch(torch, seed=20)
    out = {}
    w = wrappers()
    for label, m in (("sp", mesh), ("single", None)):
        tr = sp_trainer("float32", mesh=m)
        for f in w.values():
            f.launches = 0  # the SP step's run starts here
        err, corr, grads = tr.grad_fraction(*batch)
        sync_all(torch)
        out[label] = (err.item(), int(corr), grads,
                      {k: f.launches for k, f in w.items()})
    (e_s, c_s, g_s, n_s), (e_1, c_1, g_1, _) = out["sp"], out["single"]
    lrel = abs(e_s - e_1) / abs(e_1)
    grel = max(rel_err(g_s[n][k], g_1[n][k])[0] for n in g_1 for k in g_1[n])
    layers = 5
    expect = {k: 0 for k in n_s}
    expect.update(lstm_fwd_carry_save=2 * layers * len(mesh),
                  lstm_bwd_carry=2 * layers * len(mesh))
    phase("sp-step", f"one TIMIT SGD step's gradients, SP on "
          f"{mesh_name(mesh)} vs single device (f32, T={T_TRAIN} B={B}): loss {e_s:.6f} vs "
          f"{e_1:.6f} (rel {lrel:.2e}, tol {SP_STEP_TOL['loss']:.0e}); count "
          f"{c_s} vs {c_1}; gradients rel {grel:.2e} (tol "
          f"{SP_STEP_TOL['grad']:.0e}); SP launches {n_s}")
    check_counts(n_s, expect)
    if not (lrel <= SP_STEP_TOL["loss"] and c_s == c_1
            and grel <= SP_STEP_TOL["grad"]):
        raise AssertionError("the SP step differs from the single-device step")


def sp_trainer_epochs(torch, workdir, mesh):
    """Phase 20b: Trainer(seq_mesh=mesh) over phase 7's corpus (truncated
    at 500, 50 parallel sequences, shuffled fractions, stochastic) for 2
    epochs against the same Trainer without the mesh: the epoch errors,
    and the SP run's exact launches."""
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.config import parse_config
    paths, _ = write_train_corpus(workdir)
    cfg = parse_config(["--train", "true", "--network", "x",
                        "--train_file", paths["train"][0],
                        "--val_file", paths["val"][0],
                        "--truncate_seq", "500", "--parallel_sequences", "50",
                        "--stochastic", "true", "--shuffle_fractions",
                        "true", "--random_seed", str(SEED)])
    w = wrappers()
    rows = {}
    for label, m in (("sp", mesh), ("single", None)):
        train = cli._load_dataset(cfg, "train")
        val = cli._load_dataset(cfg, "val")
        tr = sp_trainer("float32", train, val, seed=SEED, mesh=m)
        for f in w.values():
            f.launches = 0  # the SP Trainer's run starts here
        t0 = time.perf_counter()
        rows[label] = []
        finished = False
        while not finished:
            finished = tr.train_epoch()
            rows[label].append((tr.cur_training_error,
                                tr.cur_training_class_error,
                                tr.cur_validation_error,
                                tr.cur_validation_class_error))
        sync_all(torch)
        wall = time.perf_counter() - t0
        counts = {k: f.launches for k, f in w.items()}
        phase("sp-train", f"{label}: epochs {rows[label]}; {wall:.1f} s "
              f"wall; launches {counts}")
        if label == "sp":
            n_train, n_val = train.num_fractions(), val.num_fractions()
            expect = {k: 0 for k in counts}
            per = 10 * len(mesh)  # 5 layers x 2 directions per block
            expect.update(lstm_fwd_carry_save=per * n_train * 2,
                          lstm_bwd_carry=per * n_train * 2,
                          lstm_fwd_carry=per * n_val * 2)
            check_counts(counts, expect)
            launches = counts
    diff = float(np.max(np.abs(np.array(rows["sp"]) - np.array(rows["single"]))
                        / np.abs(np.array(rows["single"]))))
    phase("sp-train", f"SP Trainer ({mesh_name(mesh)}) vs single-device "
          f"Trainer, 2 epochs: epoch "
          f"errors within {diff:.2e} relative (tol {SP_EPOCH_TOL:.0e})")
    if not diff <= SP_EPOCH_TOL:
        raise AssertionError(f"SP training differs: {rows}")
    return launches


def sp_serving(torch, workdir, mesh):
    """Phase 20c: apply_seq on the mesh over phase 5's serving corpus
    against apply (K0): posteriors, and 10 K6f launches per block and
    fraction."""
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.models.flagship import build_timit_network
    from lstm_rnn_tpu_torch.parallel.sequence import apply_seq
    nc, _, _, _ = write_inputs(workdir)
    net = build_timit_network(seed=SEED)
    params = net.device_params("cuda")
    w = wrappers()
    worst, n_frac = 0.0, 0
    for f in w.values():
        f.launches = 0  # the SP serving run starts here
    with torch.inference_mode():
        for frac in DataSet([nc], parallel_sequences=50,
                            prefetch=False).fractions():
            x = torch.from_numpy(frac.inputs).cuda()
            pt = torch.from_numpy(frac.pattypes).cuda()
            y = apply_seq(net, params, x, pt, mesh)
            y1 = net.apply(params, x, pt)
            worst = max(worst, (y - y1).abs().max().item())
            n_frac += 1
    sync_all(torch)
    n = w["lstm_fwd_carry"].launches
    phase("sp-serve", f"apply_seq on {mesh_name(mesh)} vs apply over phase "
          f"5's "
          f"corpus ({n_frac} fractions): max |p_sp - p| = {worst:.3e} (tol "
          f"{STREAM_TOL:.0e}); {n} K6f launches")
    if not (worst <= STREAM_TOL and n == 10 * len(mesh) * n_frac):
        raise AssertionError(f"apply_seq: {worst}, {n} launches")


def sp_rates(torch, card, meshes):
    """Phase 20d: training frames/s of bench.py's step, f32 and bf16, SP
    on each mesh against the single-device step measured beside it; a
    profile of one f32 SP step on the first mesh."""
    from torch.profiler import ProfilerActivity, profile
    batch, frames = recipe_batch(torch)
    for label, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        rates = {}
        for mesh in (*meshes, None):
            tr = sp_trainer(dtype, mesh=mesh)
            tr.train_step(*batch)
            sync_all(torch)
            t0 = time.perf_counter()
            for _ in range(3):
                tr.train_step(*batch)
            sync_all(torch)
            dt = (time.perf_counter() - t0) / 3
            name = mesh_name(mesh) if mesh else "single device, no SP"
            rates[name] = frames / dt
            phase("rate", f"train step {label}, {name}: {frames / dt:,.0f} "
                  f"frames/s ({1e3 * dt:.1f} ms per step, mean of 3) on "
                  f"{card}")
            if label == "f32" and mesh is meshes[0]:
                # steps 1 and 2 open the trace (a window's first launches
                # go missing), step 3 is the one recorded
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             schedule=torch.profiler.schedule(
                                 wait=1, warmup=1, active=1)) as prof:
                    for _ in range(3):
                        sync_all(torch)
                        t0 = time.perf_counter()
                        tr.train_step(*batch)
                        sync_all(torch)
                        wall_us = 1e6 * (time.perf_counter() - t0)
                        prof.step()
                report_profile(prof, wall_us, f"one SP training step "
                               f"({name}; device time summed over its GPUs) "
                               f"T={T_TRAIN} f32")
        one = rates["single device, no SP"]
        phase("rate", f"SP train step {label} against the single device: " +
              ", ".join(f"{k} {v / one:.2f}x" for k, v in rates.items()))


def sp_cli(torch, workdir, n=2):
    """Phase 21: cli --seq_devices n, train and forward, against the runs
    without it when torch sees n GPUs; on one GPU, the refusal of
    --seq_devices 2 with the JAX CLI's message."""
    import contextlib
    import io
    from lstm_rnn_tpu_torch import cli
    nc, net_path, tags, lengths = write_inputs(workdir)
    if torch.cuda.device_count() < 2:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["--network", net_path, "--train", "false",
                           "--ff_input_file", nc, "--ff_output_file",
                           os.path.join(workdir, "sp2"), "--seq_devices",
                           "2"])
        text = buf.getvalue()
        want = "num_devices=2 but only 1 devices available"
        if rc == 0 or want not in text or "Computing" in text:
            raise AssertionError(f"--seq_devices 2 ran on one GPU (rc {rc})")
        phase("sp-cli", f"--seq_devices 2 on one GPU: refused (rc {rc}): "
              f"{text.strip().splitlines()[-1][:100]}")
        phase("sp-cli", "the multi-GPU CLI runs (--seq_devices 2, train and "
              "forward) were not made: torch sees one GPU")
        return
    outs = {}
    if torch.cuda.device_count() < n:
        raise AssertionError(f"--seq_devices {n} needs {n} GPUs")
    for label, extra in (("sp", ["--seq_devices", str(n)]), ("one", [])):
        run_cli(nc, net_path, os.path.join(workdir, f"ff_{label}"), *extra)
        outs[label], _ = read_outputs(os.path.join(workdir, f"ff_{label}"),
                                      tags, lengths)
    d = max(float(np.abs(a - b).max()) for a, b in zip(outs["sp"],
                                                       outs["one"]))
    phase("sp-cli", f"forward --seq_devices {n} vs 1: max |p_sp - p| = "
          f"{d:.3e} (tol {STREAM_TOL:.0e})")
    if not d <= STREAM_TOL:
        raise AssertionError(f"--seq_devices {n} serving differs: {d}")
    paths, _ = write_train_corpus(workdir)
    saved = {}
    for label, extra in (("sp", ["--seq_devices", str(n)]), ("one", [])):
        saved[label] = os.path.join(workdir, f"sp_{label}.jsn")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--network", net_path, "--train", "true",
                           "--train_file", paths["train"][0],
                           "--truncate_seq", "500", "--parallel_sequences",
                           "50", "--stochastic", "true", "--learning_rate",
                           "1e-4", "--momentum", "0.9", "--max_epochs", "1",
                           "--random_seed", str(SEED), "--save_network",
                           saved[label], *extra])
        if rc != 0:
            print(buf.getvalue()[-3000:])
            raise AssertionError(f"cli --train true {label} returned {rc}")
    a, b = _weights(saved["sp"]), _weights(saved["one"])
    d = max(float(np.abs(a[k] - b[k]).max(initial=0.0)) for k in b)
    phase("sp-cli", f"train --seq_devices {n} vs 1 (1 epoch): max |w_sp - w| "
          f"= {d:.3e} (tol {CONTINUE_TOL * 10:.0e})")
    if not d <= CONTINUE_TOL * 10:
        raise AssertionError(f"--seq_devices {n} training differs: {d}")


# --remat_blocks (phases 22-25): the plain tail (K5) and the LSTM
# checkpointed in K time blocks on the carry kernels
# K5 against its twins on the same logits. p element by element (P_REL);
# dz relative to its largest entry: f32 math on the same stored p in both
# modes, the twin's in another order
PLAIN_DZ_REL = 1e-5
# the CLI's --remat_blocks 4 run against the run without it, 2 epochs on
# phase 7's corpus. f32: the same f32 math in another order (K6b for
# K1/K2, K5 and cuBLAS for K3), the bound of phase 21's SP run; the epoch
# errors to the table's last printed digit. bf16: K5's path rounds the
# softmax layer's dW to bf16 (the JAX package's autodiff of its bf16
# product does the same) where K3 keeps it f32, 2^-9 of each entry every
# step, so the weights drift apart by a share of how far training moved
# them
REMAT_CLI_TOL = {"float32": 1e-5, "bfloat16": 0.05}
# peak memory of a T = 4000 step with --remat_blocks 8, at least this many
# times below the step without it
REMAT_MEM_GAIN = 1.5


def plain_cost(kind, S, dtype):
    """(bytes, flops) of K5f and K5b over N_TAIL rows of S classes: K5f
    reads the f32 logits and the targets and writes p in the storage dtype
    and the loss and count; K5b reads p, the targets and g and writes dz in
    f32; a few FP32 operations per element (counted as 4)."""
    es = 2 if dtype == "bfloat16" else 4
    N = N_TAIL
    if kind == "softmax_ce_fwd":
        return N * S * 4 + N * 4 + N * S * es + 8, 4 * N * S
    return N * S * es + N * 4 + 4 + N * S * 4, 4 * N * S


def plain_kernels_vs_twins(torch):
    """Phase 22: K5f and K5b against their twins on the card over
    N = 25,000 frames at S = 183 (TIMIT) and 10,112 (LVCSR), float32 and
    bfloat16, with a row tile of dummy frames that must give exactly zero
    and controls the checks must reject (a zero p, rolled targets, and in
    bf16 dz from the f32 p before its rounding) and a second K5f launch
    that must give the same bits; kernel, twin and library times, the
    kernels' and the library call's on the device (the profiler) beside
    CUDA events."""
    import torch.nn.functional as F
    from lstm_rnn_tpu_torch.ops import softmax_ce as sc
    gen = torch.Generator("cuda").manual_seed(SEED + 11)
    N = N_TAIL
    g = torch.tensor(0.37, device="cuda")
    res = {}
    for S in (S_STATES, S_LVCSR):
        a = torch.randn(N, S, device="cuda", generator=gen) * 3
        tc = torch.randint(0, S, (N,), device="cuda", generator=gen,
                           dtype=torch.int32)
        tc[::10] = -1  # dummy frames
        tc[:64] = -1  # and a whole row tile of them
        tl = tc.long()
        rolled = tc.roll(1)
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)
            loss, cnt, p = sc.softmax_ce_fwd(a, tc, dt)
            loss2, cnt2, p2 = sc.softmax_ce_fwd(a, tc, dt)
            loss_r, cnt_r, p_r = sc.plain_fwd_reference(a, tc, dt)
            loss_x, _, _ = sc.plain_fwd_reference(a, rolled, dt, False)
            torch.cuda.synchronize()
            same = (torch.equal(p, p2) and loss2.item() == loss.item()
                    and cnt2.item() == cnt.item())
            del p2
            plan = sc.plain_fwd_plan(S, a.data_ptr(), p.data_ptr(),
                                     p.element_size())
            rel, err = elem_rel(p, p_r), rel_err(p, p_r)[1]
            lrel = abs(loss.item() - loss_r.item()) / abs(loss_r.item())
            ctrl = {"zero p": elem_rel(torch.zeros_like(p_r), p_r),
                    "loss of rolled targets": abs(
                        loss_x.item() - loss.item()) / abs(loss.item())}

            def k5f():
                return sc.softmax_ce_fwd(a, tc, dt)

            def lib_call():
                return F.cross_entropy(a, tl, reduction="sum",
                                       ignore_index=-1)
            ms = time_ms(torch, k5f, 10)
            ms_nop = time_ms(torch, lambda: sc.softmax_ce_fwd(
                a, tc, dt, want_p=False), 10)
            dev_k = prof_ms(torch, [k5f], 10,
                            ("plain_fwd_kernel", "ce_reduce_kernel"))
            dev = sum(dev_k.values())
            plain = time_ms(torch, lambda: sc.plain_fwd_reference(
                a, tc, dt), 3)
            lib = time_ms(torch, lib_call, 10)
            # log_softmax and nll_loss's kernels
            lib_dev = sum(prof_ms(torch, [lib_call], 10,
                                  ("softmax", "nll_loss")).values())
            res[("softmax_ce_fwd", S, name)] = dict(
                err=err, rel=rel, loss_rel=lrel, ms=dev if dev else ms,
                events_ms=ms, plain_ms=plain,
                library_ms=lib_dev if lib_dev else lib,
                library_events_ms=lib,
                cost=plain_cost("softmax_ce_fwd", S, name))
            phase("plain-kernel", f"K5f softmax_ce_fwd S={S} {name} "
                  f"({plan[0]} body, {plan[1]} values a thread held, "
                  f"{plan[2]} a vector): p "
                  f"max_abs_err={err:.3e} elementwise rel={rel:.3e} (tol "
                  f"{P_REL[name]:.1e}; controls " + ", ".join(
                      f"{k} {v:.2e}" for k, v in ctrl.items())
                  + f"), loss rel {lrel:.2e}, count {cnt.item()} vs "
                  f"{cnt_r.item()}; a second launch bit for bit: {same}; "
                  f"on the device {fmt_ms(dev or None)} (" + ", ".join(
                      f"{short_key(k)} {v:.4f}" for k, v in dev_k.items())
                  + f"), F.cross_entropy {fmt_ms(lib_dev or None)} on the "
                  f"device; CUDA events: kernel {ms:.3f} ms ({ms_nop:.3f} "
                  f"ms without p), F.cross_entropy {lib:.3f} ms; twin "
                  f"{plain:.3f} ms [N={N} S={S}]")
            if not (ctrl["zero p"] > P_REL[name]
                    and ctrl["loss of rolled targets"] > 1e-5):
                raise AssertionError(f"the K5f checks pass a wrong p or "
                                     f"loss: {ctrl}")
            if not (rel <= P_REL[name] and lrel <= 1e-5
                    and abs(cnt.item() - cnt_r.item()) <= 1):
                raise AssertionError("K5f disagrees with its twin")
            if not same:
                raise AssertionError("a second K5f launch gave other bits")
            del p_r

            dz = sc.softmax_ce_bwd(p, tc, g)
            dz_r = sc.plain_dz_reference(p, tc, g)
            torch.cuda.synchronize()
            rel, err = rel_err(dz, dz_r)
            ctrl = {"zero dz": rel_err(torch.zeros_like(dz_r), dz_r)[0],
                    "dz of rolled targets": rel_err(sc.plain_dz_reference(
                        p, rolled, g), dz_r)[0]}
            if name == "bfloat16":
                p32 = sc.plain_fwd_reference(a, tc)[2]
                ctrl["dz of the f32 p"] = rel_err(
                    sc.plain_dz_reference(p32, tc, g), dz_r)[0]
                del p32
            dummy_zero = not dz[:64].any()
            ms = time_ms(torch, lambda: sc.softmax_ce_bwd(p, tc, g), 10)
            dev_ms = sum(prof_ms(torch, [lambda: sc.softmax_ce_bwd(
                p, tc, g)], 10, ("plain_bwd_kernel",)).values()) or None
            plain = time_ms(torch, lambda: sc.plain_dz_reference(p, tc, g),
                            3)
            res[("softmax_ce_bwd", S, name)] = dict(
                err=err, rel=rel, ms=dev_ms or ms, events_ms=ms,
                plain_ms=plain, library_ms=None, library_events_ms=None,
                cost=plain_cost("softmax_ce_bwd", S, name))
            phase("plain-kernel", f"K5b softmax_ce_bwd S={S} {name}: dz "
                  f"max_abs_err={err:.3e} rel={rel:.3e} (tol "
                  f"{PLAIN_DZ_REL:.0e}; controls " + ", ".join(
                      f"{k} {v:.2e}" for k, v in ctrl.items())
                  + f"); dummy tile exactly zero: {dummy_zero}; kernel "
                  f"{ms:.3f} ms (on the device {fmt_ms(dev_ms)}); twin "
                  f"{plain:.3f} ms")
            if not all(v > PLAIN_DZ_REL for v in ctrl.values()):
                raise AssertionError(f"the dz check passes a wrong dz: "
                                     f"{ctrl}")
            if not (dummy_zero and rel <= PLAIN_DZ_REL):
                raise AssertionError("K5b disagrees with its twin")
            del p, dz, dz_r
        del a
        torch.cuda.empty_cache()
    return res


def remat_expect(k, layers=5, dirs=2):
    """One remat training step's launches: per layer and direction k K6b-f
    in the forward, k more in the recompute and k K6b-b; one K5f, one
    K5b; nothing else."""
    blocks = layers * dirs * k
    expect = {name: 0 for name in wrappers()}
    expect.update(lstm_fwd_carry_save=2 * blocks, lstm_bwd_carry=blocks,
                  softmax_ce_fwd=1, softmax_ce_bwd=1)
    return expect


def remat_steps(torch):
    """Phase 23: one SGD step with --remat_blocks from the same weights as
    the plain kernel step: TIMIT at K = 4 and K = 3 (not a divisor of
    T = 500) on ragged rows, and LVCSR at K = 4 against the fused K4 step
    (f32): the loss, the update and the exact launches; the control, the
    bf16 remat step against the f32 kernel step, must fail the update
    check."""
    w = wrappers()
    for lvcsr in (False, True):
        states = S_LVCSR if lvcsr else S_STATES
        batch, _ = recipe_batch(torch, full=False, seed=23, states=states)
        runs = [("kernel", 0, "float32"), ("remat K=4", 4, "float32")]
        if not lvcsr:
            runs += [("remat K=3", 3, "float32"), ("control", 4, "bfloat16")]
        out = {}
        for label, k, dtype in runs:
            tr = make_trainer("auto", dtype, lvcsr=lvcsr)
            tr.net.remat_blocks = k
            before = {n: {j: v.detach().clone() for j, v in l.items()}
                      for n, l in tr.params.items()}
            for f in w.values():
                f.launches = 0  # the step's run starts here
            err, _ = tr.train_step(*batch)
            torch.cuda.synchronize()
            counts = {n: f.launches for n, f in w.items()}
            upd = torch.cat([(tr.params[n][j].detach()
                              - before[n][j]).flatten()
                             for n in sorted(before) for j in sorted(before[n])])
            out[label] = (err.item(), upd, counts)
            del tr, before
        l_k, u_k, _ = out["kernel"]
        what = "LVCSR" if lvcsr else "TIMIT"
        for label, k, _ in runs[1:]:
            loss, upd, counts = out[label]
            lrel = abs(loss - l_k) / abs(l_k)
            urel = ((upd - u_k).abs().max() / u_k.abs().max()).item()
            phase("remat-step", f"one {what} SGD step T={T_TRAIN} B={B} "
                  f"{label} vs the kernel step (f32): loss {loss:.6f} vs "
                  f"{l_k:.6f} (rel {lrel:.2e}, tol {STEP_TOL['loss']:.0e}); "
                  f"update rel {urel:.2e} (tol {STEP_TOL['update']:.0e}); "
                  f"launches " + str({n: c for n, c in counts.items() if c}))
            if label == "control":
                if not urel > STEP_TOL["update"]:
                    raise AssertionError("the update check passes the bf16 "
                                         "control")
                continue
            check_counts(counts, remat_expect(k))
            if not (lrel <= STEP_TOL["loss"] and urel <= STEP_TOL["update"]):
                raise AssertionError(f"the {what} remat step ({label}) "
                                     f"disagrees with the kernel step")
        del out
        torch.cuda.empty_cache()


def remat_cli(torch, workdir, tables):
    """Phase 24: cli.main(--train true --remat_blocks 4) on phase 7's
    corpus and settings, f32 and bf16, 2 epochs: the exact launch count of
    every kernel (per train fraction 80 K6b-f, 40 K6b-b, one K5f and one
    K5b; per val fraction 5 K0 and one K5f), and the epoch errors and
    trained weights against phase 7's runs without the flag. Returns the
    f32 run's launches."""
    import contextlib
    import io
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    paths, net_path = write_train_corpus(workdir)
    (train_nc, _), (val_nc, _) = paths["train"], paths["val"]
    n_train = DataSet([train_nc], parallel_sequences=50,
                      trunc_seq_length=500).num_fractions()
    n_val = DataSet([val_nc], parallel_sequences=50).num_fractions()
    epochs = 2
    expect = {k: 0 for k in wrappers()}
    expect.update(lstm_fwd=5 * n_val * epochs,
                  lstm_fwd_carry_save=80 * n_train * epochs,
                  lstm_bwd_carry=40 * n_train * epochs,
                  softmax_ce_fwd=(n_train + n_val) * epochs,
                  softmax_ce_bwd=n_train * epochs)
    launches = None
    w0 = _weights(net_path)
    for name in ("float32", "bfloat16"):
        out = os.path.join(workdir, f"remat_{name}.jsn")
        args = ["--network", net_path, "--train", "true",
                "--train_file", train_nc, "--val_file", val_nc,
                "--truncate_seq", "500", "--parallel_sequences", "50",
                "--stochastic", "true", "--shuffle_fractions", "true",
                "--learning_rate", "1e-4", "--momentum", "0.9",
                "--max_epochs", str(epochs), "--random_seed", str(SEED),
                "--compute_dtype", name, "--save_network", out,
                "--remat_blocks", "4"]
        w = wrappers()
        for f in w.values():
            f.launches = 0  # the remat training path's run starts here
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(args)
        wall = time.perf_counter() - t0
        counts = {k: f.launches for k, f in w.items()}
        text = buf.getvalue()
        rows = [ln for ln in text.splitlines()
                if ln.strip()[:1].isdigit() and "|" in ln]
        for ln in rows:
            phase("remat-cli", f"{name} |{ln}")
        if rc != 0 or len(rows) != epochs:
            print(text[-3000:])
            raise AssertionError(f"cli --remat_blocks 4 {name} returned {rc}")
        errs = np.array(epoch_errors(rows))
        want = np.array(tables[name])
        derr = float(np.abs(errs - want).max())
        a = _weights(out)
        b = _weights(os.path.join(workdir, f"trained_{name}.jsn"))
        dw = max(float(np.abs(a[k] - b[k]).max(initial=0.0)) for k in b)
        moved = max(float(np.abs(b[k] - w0[k]).max(initial=0.0)) for k in b)
        tol = REMAT_CLI_TOL[name] * (moved if name == "bfloat16" else 1.0)
        phase("remat-cli", f"{name}: {wall:.1f} s wall for {epochs} epochs; "
              f"launches {counts}; vs the run without the flag: epoch "
              f"errors max |d| {derr:.3e}, weights max |d| {dw:.3e} (tol "
              f"{tol:.3e}; training moved them {moved:.3e})")
        check_counts(counts, expect)
        if name == "float32" and not derr <= 1.001e-2:
            raise AssertionError(f"--remat_blocks epoch errors differ: "
                                 f"{derr}")
        if not dw <= tol:
            raise AssertionError(f"--remat_blocks weights differ: {dw}")
        if launches is None:
            launches = counts
    return launches


def remat_rates_memory(torch, card):
    """Phase 25: training frames/s and peak device memory of one step on
    bench.py's fraction (B=50, every row full) at T = 500 with and without
    --remat_blocks 4, and at T = 4000 with and without --remat_blocks 8,
    f32 and bf16; synchronised, after a warm-up step. Peak memory is
    torch.cuda.max_memory_allocated over the timed steps."""
    peaks = {}
    for T, k, reps in ((T_TRAIN, 4, 5), (4000, 8, 2)):
        batch, frames = recipe_batch(torch, T=T)
        for name in ("float32", "bfloat16"):
            for kk in (0, k):
                tr = make_trainer("auto", name)
                tr.net.remat_blocks = kk
                tr.train_step(*batch)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(reps):
                    tr.train_step(*batch)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) / reps
                peak = torch.cuda.max_memory_allocated()
                peaks[(T, name, kk)] = peak
                phase("remat-rate", f"T={T} {name} remat_blocks={kk}: "
                      f"{frames / dt:,.0f} frames/s ({1e3 * dt:.1f} ms per "
                      f"step of {frames} frames, mean of {reps}); peak "
                      f"{peak / 2 ** 20:,.0f} MiB ({(peak - base) / 2 ** 20:,.0f}"
                      f" MiB above the {base / 2 ** 20:,.0f} resident) on "
                      f"{card}")
                del tr
                torch.cuda.empty_cache()
            gain = peaks[(T, name, 0)] / peaks[(T, name, k)]
            phase("remat-rate", f"T={T} {name}: peak memory {gain:.2f}x "
                  f"lower with remat_blocks={k}")
            if T > T_TRAIN and not gain >= REMAT_MEM_GAIN:
                raise AssertionError(f"--remat_blocks {k} saves too little "
                                     f"memory at T={T}: {gain:.2f}x")
        del batch
        torch.cuda.empty_cache()


def kernel_label(mangled):
    """A kernel's name, and for the GEMM engine its product and dtype, for
    the tails' forwards (K3f, K4f) their dtype and integer template
    arguments."""
    import re
    # the length-prefixed name: lowercase, after the digits of its length
    # the length-prefixed name that ends in kernel or partials
    name = mangled[:60]
    for m in re.finditer(r"(?=([0-9]+))", mangled):
        end = m.start() + len(m.group(1))
        cand = mangled[end:end + int(m.group(1))]
        if re.fullmatch(r"[a-z_][a-z0-9_]*(?:kernel|partials)", cand):
            name = cand
            break
    dtype = "bf16" if "__nv_bfloat16" in mangled else "f32"
    if "3x_kernel" in name:
        dtype = "3x"
    if name in ("gemm_kernel", "gemm3x_kernel"):
        tag = next((t for t in GEMM_TAGS if t in mangled), "?")
        name += f" {tag} {dtype}"
    elif name in ("ce_fwd_kernel", "wide_fwd_kernel",
                  "wide_bwd_wgmma_kernel", "wide_bwd_simt_kernel",
                  "wide_bwd_3x_kernel", "plain_fwd_kernel"):
        # template arguments: Li3E (int 3), Lb0E (bool false)
        args = re.findall(r"L[ib](\d+)E", mangled)
        name += f"<{dtype}, {', '.join(args)}>"
    return name


def report_ptxas(log):
    """ptxas's registers and spills, one line per kernel instance; K5f
    (plain_fwd_kernel), which holds its row in registers, must spill
    nothing."""
    import re
    name = "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_label(line.split("'")[1])
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            phase("build", f"{name}: {line.split(':', 1)[1].strip()}; "
                  f"{spill}")
            if name.startswith("plain_fwd_kernel") and any(
                    int(n) for n in re.findall(r"(\d+) bytes spill", spill)):
                raise AssertionError(f"{name} spills: {spill}")


def check_hgmma(_build):
    """The HGMMA (wgmma) instructions in the SASS of every instance of the
    GEMM engine (K4's bf16 logits and dh products among them), of K3f and
    of K4b: the bf16 instances and the 3x ones (gemm3x_kernel,
    wide_bwd_3x_kernel: f32 as three bf16 passes) run on the tensor cores,
    the f32 ones (true f32) must not."""
    import re
    for part in ("gemm_kernel", "gemm3x_kernel", "ce_fwd_kernel",
                 "wide_bwd_", "pb_dh_kernel", "pb_dw_kernel"):
        counts = _build.sass_counts("HGMMA", part)
        if not counts:
            raise AssertionError(f"no {part} instance in the SASS")
        for name, n in sorted(counts.items()):
            src = re.search(r"_\d+_(\w+?)_cu_", name)
            phase("build", f"SASS {n:3d} HGMMA  {kernel_label(name)} "
                  f"({src.group(1) if src else '?'}.cu)")
            if (n > 0) != ("__nv_bfloat16" in name or "3x_kernel" in name):
                raise AssertionError(f"{name}: {n} HGMMA instructions")


# the GEMM engine against its twin (phase 26), relative to each output's
# largest entry. f32: true f32 on both sides, summed in another order. bf16:
# exact products summed in f32, the tensor cores adding in another order
# than the twin's matmul. Where the output is rounded to bf16 (dx's
# planes, the tail's dh), a sum on the other side of a rounding boundary
# moves an element by one bf16 ulp (2^-8 of it): the bound is 2^-7
GEMM_REL = {"float32": 1e-5, "bfloat16": 1e-4}
GEMM_ROUNDED_REL = 2.0 ** -7


def prof_ms(torch, fns, reps, expect=()):
    """Device milliseconds of each kernel that the calls fns make, a call
    (each fn called `reps` times after a warm-up call), from one profile:
    {kernel name: ms}, each kernel's device time over the launches the
    profiler recorded (it may miss some) times its launches a call (no
    two fns launch the same kernel). A call's host work does not count,
    so a short kernel is not timed at the host's pace. A profile counts
    only if each name in `expect` (a part of a kernel's name, any case)
    matches a kernel recorded at least `reps` times: a profile can miss a
    whole kernel. {} when three profiles in a row do not count."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                for _ in range(reps):
                    fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and dev_us(e) > 0]
        per = {e.key: dev_us(e) / 1e3 / e.count
               * max(1, round(e.count / reps)) for e in events}
        if per and all(any(x.lower() in e.key.lower() and e.count >= reps
                           for e in events) for x in expect):
            return per
    return {}


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def short_key(key):
    """A profiler key's kernel name with its template arguments."""
    name = key.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return name.removeprefix("void ")[:60]


def gemm_cost(use, a, b, M, N, K, kw, dtype):
    """(bytes, flops) of one engine launch: each distinct operand read
    once (rows x cols in the operand dtype), the bias, the output written
    once (f32; dh in the operand dtype), 2 M N K per output or group."""
    es = 2 if dtype == "bfloat16" else 4
    seen = {(v.t.data_ptr(), v.offset): v.rows * v.cols for v in (*a, *b)}
    pairs = max(kw.get("outputs", 1), kw.get("ngroups", 1))
    outs = kw.get("outputs", 1)
    nbytes = sum(seen.values()) * es + outs * M * N * (
        es if use == "tail_dh" else 4)
    if use == "proj":
        nbytes += outs * N * 4
    return nbytes, 2 * M * N * K * pairs


def gemm_library(torch, use, a, b, M, N, K, kw):
    """One torch call that computes the product on the same operands
    (laid out outside the timed call): the yardstick of library_ms."""
    dt = a[0].t.dtype
    if use == "proj":
        D = kw["outputs"]
        x, w = a[0].t, b[0].t.reshape(D, K, N)
        bias = kw["bias"].to(dt)[:, None, :]
        return lambda: torch.baddbmm(bias, x.expand(D, M, K), w)
    if use == "dW_in":
        x, da = a[0].t, b[0].t.reshape(-1, K, N)
        return lambda: torch.matmul(x.T, da)
    if use == "dW_rec":
        hs, ds = [], []
        for va, vb in zip(a, b):
            lo, hi = max(0, -va.shift), min(K, va.rows - va.shift)
            h = va.t.reshape(-1)[va.offset:].as_strided(
                (va.rows, va.cols), (va.ld, 1))
            hs.append(h[lo + va.shift:hi + va.shift])
            ds.append(vb.t.reshape(-1, K, N)[len(ds), lo:hi])
        hs, ds = torch.stack(hs), torch.stack(ds)
        return lambda: torch.bmm(hs.transpose(1, 2), ds)
    if use == "dx":
        da = a[0].t.reshape(2, M, K)
        w = b[0].t.reshape(2, N, K)
        a2, w2 = torch.cat([da[0], da[1]], 1), torch.cat([w[0], w[1]], 1)
        return lambda: torch.matmul(a2, w2.T)
    if use == "tail_dh":
        dz, w = a[0].t, b[0].t
        return lambda: torch.matmul(dz, w.T)
    h, dz = a[0].t, b[0].t
    return lambda: torch.matmul(h.T, dz)


def gemm_controls(torch, ge, use, a, b, M, N, K, kw, dt, want):
    """Wrong results the check must reject: a zero output; dW_rec with
    the other direction's shift; a weight gradient with its first split
    dropped; dx with one direction's plane dropped; the projection with a
    direction (or, for one direction, the bias) dropped."""
    ref = ge.gemm_reference
    ctrl = {"zero": torch.zeros_like(want)}
    if use == "dW_rec":
        flipped = [v._replace(shift=-v.shift) for v in a]
        ctrl["other shift"] = ref(use, flipped, b, M, N, K,
                                  compute_dtype=dt, **kw)
    if use in ge.SPLIT_USES:
        k1 = ge.split_ranges(K, kw["nsplit"])[0][1]
        first = ref(use, a, b, M, N, k1, outputs=kw.get("outputs", 1),
                    compute_dtype=dt)
        ctrl["dropped split"] = want - first
    if use == "dx":
        A, B = ge._operands(use, a[1], b[1], M, N, K)
        ctrl["one direction"] = want - (A @ B).to(dt).float()
    if use == "proj":
        drop = want.clone()
        if kw["outputs"] == 2:
            drop[1] = 0
        else:
            drop -= kw["bias"][:, None, :]
        ctrl["dropped direction" if kw["outputs"] == 2 else "no bias"] = drop
    return ctrl


def gemm_engine_vs_twin(torch):
    """Phase 26: the GEMM engine at every main-path shape, f32 and bf16:
    against its twin with controls that must fail, a second launch bit
    for bit, the device time (profiler) beside the twin's, one torch
    call's and the bound."""
    from lstm_rnn_tpu_torch.ops import gemm as ge
    phase("gemm", f"TF32 {'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'} "
          f"for the library calls (torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32})")
    res = {}
    for name in ge.MAIN_PATH_CASES:
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            gen = torch.Generator("cuda").manual_seed(SEED + 26)
            use, a, b, M, N, K, kw = ge.main_path_case(name, dt, "cuda", gen)
            got = ge.gemm(use, a, b, M, N, K, compute_dtype=dt, **kw)
            again = ge.gemm(use, a, b, M, N, K, compute_dtype=dt, **kw)
            want = ge.gemm_reference(use, a, b, M, N, K, compute_dtype=dt,
                                     **kw)
            torch.cuda.synchronize()
            tol = (GEMM_ROUNDED_REL if dname == "bfloat16"
                   and use in ("dx", "tail_dh") else GEMM_REL[dname])
            rel, err = rel_err(got, want)
            same = torch.equal(got, again)
            ctrl = {k: rel_err(v, want)[0] for k, v in gemm_controls(
                torch, ge, use, a, b, M, N, K, kw, dt, want).items()}
            del got, again, want
            reps = 10
            def run():
                return ge.gemm(use, a, b, M, N, K, compute_dtype=dt, **kw)
            lib = gemm_library(torch, use, a, b, M, N, K, kw)
            # the engine's kernels (the product, and the partials' sum)
            # and the library call's, in one profile
            per = prof_ms(torch, [run, lib], reps)
            ours = {k: v for k, v in per.items()
                    if "gemm_kernel" in k or "sum_partials" in k}
            ms = sum(ours.values())
            kms = sum(v for k, v in ours.items() if "gemm_kernel" in k)
            lib_ms = sum(v for k, v in per.items() if k not in ours)
            clock = "profiler"
            if not kms or not lib_ms:  # CUDA events: host included
                ms = kms = time_ms(torch, run, reps)
                lib_ms = time_ms(torch, lib, reps)
                clock = "CUDA events"
            plain = time_ms(torch, lambda: ge.gemm_reference(
                use, a, b, M, N, K, compute_dtype=dt, **kw), 2)
            cost = gemm_cost(use, a, b, M, N, K, kw, dname)
            bms, by = bound(*cost, dname)
            res[(name, dname)] = dict(err=err, rel=rel, ms=ms,
                                      kernel_ms=kms, plain_ms=plain,
                                      library_ms=lib_ms, cost=cost)
            phase("gemm", f"{name} {dname} [M={M} N={N} K={K}"
                  + "".join(f" {k}={v}" for k, v in kw.items()
                            if k in ("outputs", "nsplit", "ngroups"))
                  + f"]: rel {rel:.2e} (tol {tol:.0e}; controls "
                  + ", ".join(f"{k} {v:.2e}" for k, v in ctrl.items())
                  + f"); repeat bit for bit: {same}; {ms:.4f} ms on the "
                  f"device ({clock}; {kms:.4f} in gemm_kernel, "
                  f"{cost[1] / kms / 1e9:.1f} TFLOP/s); twin {plain:.3f} ms;"
                  f" torch {lib_ms:.4f} ms; bound {bms:.4f} ms ({by})")
            if not all(v > tol for v in ctrl.values()):
                raise AssertionError(f"the GEMM check passes a wrong "
                                     f"result: {ctrl}")
            if not (rel <= tol and same):
                raise AssertionError(f"the GEMM engine disagrees with its "
                                     f"twin at {name} {dname}: {rel}")
            del a, b, kw, lib
            torch.cuda.empty_cache()
    return res


def wide_lstm_route(torch):
    """Phase 27: backend "auto" trains a BLSTM layer of 801 cells per
    direction and serves one of 1,025 on the scan route (no recurrence
    kernel has a CTA for them), on the card, with backend "scan"'s values
    and gradients bit for bit and no kernel launch; "pallas" raises."""
    from lstm_rnn_tpu_torch.models.lstm import lstm_forward
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    kern = (lc.lstm_scan_fused, lc.lstm_fwd_save, lc.lstm_bwd)
    for H, grad in ((801, True), (1025, False)):
        gen = torch.Generator("cuda").manual_seed(SEED + H)
        u = lambda *sh: (torch.rand(*sh, device="cuda",  # noqa: E731
                                    generator=gen) - 0.5) * 0.2
        params = {"W_in": u(2, 16, 4, H), "W_rec": u(2, H, 4, H),
                  "b": u(2, 4, H), "peep": u(2, 3, H)}
        x = torch.randn(8, 4, 16, device="cuda", generator=gen)
        pt = torch.ones(8, 4, dtype=torch.int8, device="cuda")
        pt[6:, 1] = 0
        outs = []
        for backend in ("auto", "scan"):
            ps = {k: v.clone().requires_grad_(grad) for k, v in params.items()}
            before = [f.launches for f in kern]
            t0 = time.perf_counter()
            with torch.set_grad_enabled(grad):
                y = lstm_forward(ps, x, pt, 1.0, True, backend=backend)
                grads = (torch.autograd.grad(y.sum(), list(ps.values()))
                         if grad else ())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = [f.launches - n for f, n in zip(kern, before)]
            outs.append((y, grads))
        same = torch.equal(outs[0][0], outs[1][0]) and all(
            torch.equal(a, c) for a, c in zip(outs[0][1], outs[1][1]))
        try:
            with torch.set_grad_enabled(grad):
                lstm_forward({k: v.clone().requires_grad_(grad)
                              for k, v in params.items()}, x, pt, 1.0, True,
                             backend="pallas")
            refused = False
        except ValueError:
            refused = True
        phase("route", f"LSTM H={H} per direction "
              f"{'training' if grad else 'serving'}, backend auto: scan "
              f"route, kernel launches {launched}, values"
              f"{' and gradients' if grad else ''} those of backend scan bit "
              f"for bit: {same}; explicit pallas refused: {refused}; "
              f"{wall:.2f} s wall [T=8 B=4 P=16]")
        if launched != [0, 0, 0] or not same or not refused:
            raise AssertionError(f"the wide LSTM route failed at H={H}")


def wide_p_tail_route(torch):
    """Phase 28: a 705-class softmax fed by 1,025 units (past K3's S and
    K4b's P) trains through the materialized logits and K5 on the card:
    one K5f and one K5b, no K3 or K4 launch, finite gradients, and the
    unfused loss."""
    from lstm_rnn_tpu_torch.network import Network
    from lstm_rnn_tpu_torch.ops import softmax_ce as sc
    net = Network([
        {"name": "input", "type": "input", "size": 39},
        {"name": "l1", "type": "feedforward_tanh", "size": 1025,
         "bias": 1.0},
        {"name": "output", "type": "softmax", "size": 705, "bias": 1.0},
        {"name": "postoutput", "type": "multiclass_classification",
         "size": 705}])
    net.init_params(SEED)
    params = net.device_params("cuda")
    for layer in params.values():
        for v in layer.values():
            v.requires_grad_(True)
    gen = torch.Generator("cuda").manual_seed(SEED + 28)
    x = torch.randn(100, 50, 39, device="cuda", generator=gen)
    pt = torch.ones(100, 50, dtype=torch.int8, device="cuda")
    tc = torch.randint(0, 705, (100, 50), device="cuda", generator=gen,
                       dtype=torch.int32)
    wr = (sc.softmax_ce_proj_fwd, sc.softmax_ce_proj_bwd,
          sc.softmax_ce_wide_fwd, sc.softmax_ce_wide_bwd, sc.softmax_ce_fwd,
          sc.softmax_ce_bwd)
    before = [f.launches for f in wr]
    loss, _ = net.loss_and_count_fused(params, x, tc, pt)
    loss.backward()
    torch.cuda.synchronize()
    launched = [f.launches - n for f, n in zip(wr, before)]
    with torch.no_grad():
        ref = net.loss(params, x, tc, pt)
    lrel = abs(loss.item() - ref.item()) / abs(ref.item())
    finite = all(torch.isfinite(v.grad).all() for layer in params.values()
                 for v in layer.values())
    phase("route", f"softmax(705) over 1,025 units, one training step of "
          f"5,000 frames: launches K3f/K3b/K4f/K4b/K5f/K5b {launched}, loss "
          f"rel {lrel:.2e} against the unfused tail, gradients finite: "
          f"{finite}")
    if launched != [0, 0, 0, 0, 1, 1] or lrel > 1e-5 or not finite:
        raise AssertionError("the wide-P tail route failed")


def bf16_feedforward(torch):
    """Phase 29: in bf16 mode the softmax layer's product and its two
    gradient products run on the tensor cores (no f32 library GEMM in a
    profile of serving's softmax and of one backward), with the CPU
    route's values (round_operand's f32 matmul, here on the card): the
    forward to f32 sum-order noise, the gradients to one bf16 ulp; the
    device time of the forward product beside that route's."""
    from torch.profiler import ProfilerActivity, profile
    from lstm_rnn_tpu_torch.models import feedforward as ff
    gen = torch.Generator("cuda").manual_seed(SEED + 29)
    x = torch.randn(500, 50, 2 * H, device="cuda", generator=gen)
    params = {"W": (torch.rand(2 * H, S_STATES, device="cuda",
                               generator=gen) - 0.5) * 0.2,
              "b": (torch.rand(S_STATES, device="cuda", generator=gen)
                    - 0.5) * 0.2}
    dy = torch.randn(500, 50, S_STATES, device="cuda", generator=gen)
    bf = torch.bfloat16

    def grads(route_fn):
        xg = x.clone().requires_grad_(True)
        wg = params["W"].clone().requires_grad_(True)
        a = route_fn(xg, wg) + params["b"]
        gx, gw = torch.autograd.grad(a, (xg, wg), dy)
        return a.detach(), gx, gw

    def f32_route(xg, wg):
        return torch.matmul(ff.round_operand(xg, bf), ff.round_operand(wg, bf))
    got = grads(lambda xg, wg: ff._product(xg, wg, bf))
    want = grads(f32_route)
    torch.cuda.synchronize()
    errs = [rel_err(a, c)[0] for a, c in zip(got, want)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            ff.softmax_forward(params, x, 1.0, bf)
        grads(lambda xg, wg: ff._product(xg, wg, bf))
        torch.cuda.synchronize()
    keys = [e.key for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    f32 = [k for k in keys if any(t in k for t in ("sgemm", "f32f32",
                                                     "ffma"))]
    new_ms = prof_ms(torch, [lambda: ff._product(x, params["W"], bf)], 10)
    old_ms = prof_ms(torch, [lambda: f32_route(x, params["W"])], 10)
    phase("route", f"bf16 softmax layer [25,000 x {2 * H} . {2 * H} x "
          f"{S_STATES}]: rel err a {errs[0]:.2e} (tol 1e-5), dx {errs[1]:.2e},"
          f" dW {errs[2]:.2e} (tol 2^-7) against round_operand's f32 "
          f"matmul; f32 library GEMMs: {f32 or 'none'} (of {len(keys)} "
          f"kernels); the product on the device {sum(new_ms.values()):.4f} ms"
          f" (" + ", ".join(f"{short_key(k)} {v:.4f}"
                            for k, v in new_ms.items())
          + f"), the f32 route's {sum(old_ms.values()):.4f} ms")
    if not keys:
        phase("route", "  (the profiler recorded no device time: the "
              "library-GEMM check was not made)")
    if f32 or errs[0] > 1e-5 or max(errs[1:]) > 2.0 ** -7:
        raise AssertionError("the bf16 feedforward products failed")


# ------------------------------------------------ CHiME and noise (30-32)
# the three CHiME recipes at their published widths: 39 inputs -> BLSTM
# (156, 256, 156) -> 39 regression outputs (autoencoding), and BLSTM(156,
# 300, 102) -> softmax(51), with feedforward_tanh(39) and (75) between the
# BLSTMs in the subsampling net
CHIME = {"autoencoding": os.path.join(REPO, "examples",
                                      "speech_autoencoding_chime"),
         "no_subsampling": os.path.join(REPO, "examples",
                                        "speech_recognition_chime",
                                        "no_subsampling"),
         "subsampling": os.path.join(REPO, "examples",
                                     "speech_recognition_chime",
                                     "subsampling")}
CHIME_IN, CHIME_STATES = 39, 51
# the synthetic corpora's longest sequence (lengths 200-700), the longest
# fraction of a CHiME run
T_CHIME = 700
# every LSTM layer of the three nets: (P, H per direction, dx); the
# subsampling net's feedforward_tanh layers give P = 39 and 75
CHIME_LAYERS = [(39, 78, False), (156, 128, True), (256, 78, True),
                (156, 150, True), (300, 51, True), (39, 150, True),
                (75, 51, True)]
# the recognition nets' softmax(51) over the last BLSTM's 102 units
CHIME_P, CHIME_N = 102, T_CHIME * B
# weight noise: the rate phase's sigma (31d), and the steps' (31b-c), at
# which the step taken at the clean weights must fail STEP_TOL
WN_SIGMA, WN_CHECK_SIGMA = 0.01, 0.05


def timed(torch, fn):
    """(fn(), its device milliseconds by CUDA events around one call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def chime_plans(torch):
    """Phase 30a: the cluster of each CHiME width (n = 5, 8, 10 and 4 CTAs
    at H = 78, 128, 150 and 51, with uneven slices), the library's plan
    beside ops/lstm_cell.py's mirror; each must fit the card."""
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    for width in sorted({h for _, h, _ in CHIME_LAYERS}):
        for kind in ("fwd", "bwd"):
            for name in ("float32", "bfloat16"):
                dt = getattr(torch, name)
                card = lc.recurrence_plan_on_card(width, dt, kind)
                mine = lc.recurrence_plan(width, dt, kind)
                phase("chime", f"plan {kind} H={width} {name}: cluster of "
                      f"{card['n']} (slices {mine['slices']}), "
                      f"{card['threads']} threads, {card['smem']:,} B "
                      f"shared a CTA, W_rec "
                      f"{'on chip' if card['w_on_chip'] else 'from L2'}; "
                      f"{card['active_clusters']} such clusters at once")
                if any(card[k] != mine[k] for k in ("n", "threads", "smem",
                                                     "w_on_chip")):
                    raise AssertionError(f"the plan's mirror disagrees with "
                                         f"the kernel library: {mine} vs "
                                         f"{card}")
                if not card["active_clusters"] > 0:
                    raise AssertionError(f"no cluster of H={width} fits")


def chime_layer(torch, P, H, seed):
    """One CHiME BLSTM layer's operands at T_CHIME, B = 50: +-0.1 weights,
    N(0, 1) inputs, the corpus's lengths (200-700) with a full row, a row
    of length 1 and an empty kernel block; dh for the BPTT."""
    rng = np.random.RandomState(seed)

    def u(*s):
        return torch.tensor(rng.uniform(-0.1, 0.1, s), dtype=torch.float32,
                            device="cuda")
    x = torch.tensor(rng.randn(T_CHIME, B, P), dtype=torch.float32,
                     device="cuda")
    lengths = rng.randint(200, T_CHIME + 1, B)
    lengths[0], lengths[1], lengths[4:8] = T_CHIME, 1, 0
    dh = torch.tensor(rng.randn(T_CHIME, B, D * H), dtype=torch.float32,
                      device="cuda")
    return (x, u(D, P, 4 * H), u(D, H, 4 * H), u(D, 3, H), u(D, 4 * H),
            torch.tensor(lengths, dtype=torch.int32, device="cuda")), dh


def chime_kernels_vs_twins(torch):
    """Phase 30a: K0, K1 and K2 at every CHiME layer's width and K3f/K3b
    at the recognition tail (S = 51 over P = 102, below one 64-column
    wgmma chunk), f32 and bf16, against their twins at phase 3/4's
    tolerances, with their times (CUDA events; the twins one call) and
    K3's on the device beside one PyTorch call."""
    import torch.nn.functional as F
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    from lstm_rnn_tpu_torch.ops import softmax_ce as sc
    res = {}
    for P, H, need_dx in CHIME_LAYERS:
        args, dh = chime_layer(torch, P, H, seed=P * 1000 + H)
        lens = args[5].cpu().numpy()
        shape = f"P={P} H={H}"
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)
            got = lc.lstm_scan_fused(*args, 1.0, dt)
            want, plain0 = timed(torch, lambda: lc.lstm_scan_reference(
                *args, 1.0, dt))
            err0 = (got.float() - want.float()).abs().max().item()
            ms0 = time_ms(torch, lambda: lc.lstm_scan_fused(*args, 1.0, dt),
                          5)
            got = lc.lstm_fwd_save(*args, 1.0, dt)
            want, plain1 = timed(torch, lambda: lc.lstm_scan_reference(
                *args, 1.0, dt, save=True))
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            rel1, err1 = max(e[0] for e in errs), max(e[1] for e in errs)
            ms1 = time_ms(torch, lambda: lc.lstm_fwd_save(*args, 1.0, dt), 5)
            fin = all(torch.isfinite(g.float()).all() for g in got)
            h, c, g = got
            bwd = (args[0], args[1], args[2], args[3], args[5], h, c, g, dh,
                   1.0, True, dt, need_dx)
            got = lc.lstm_bwd(*bwd)
            want, plain2 = timed(torch, lambda: lc.lstm_scan_bwd_reference(
                *bwd))
            errs = [rel_err(a, b) if a is not None else (0.0, 0.0)
                    for a, b in zip(got, want)]
            rel2, err2 = max(e[0] for e in errs), max(e[1] for e in errs)
            fin = fin and all(torch.isfinite(a).all() for a in got
                              if a is not None)
            ms2 = time_ms(torch, lambda: lc.lstm_bwd(*bwd), 5)
            del got, want, h, c, g
            for k, err, ms, plain, need in (
                    ("lstm_fwd", err0, ms0, plain0, False),
                    ("lstm_fwd_save", err1, ms1, plain1, False),
                    ("lstm_bwd", err2, ms2, plain2, need_dx)):
                res[(k, shape, name)] = dict(
                    err=err, ms=ms, plain_ms=plain,
                    cost=lstm_cost(k, P, lens, name, need, T=T_CHIME, H=H))
            phase("chime", f"{shape} dx={need_dx} {name} [T={T_CHIME} "
                  f"B={B}]: K0 max_abs_err={err0:.3e} (tol {TOL[name]:.0e}) "
                  f"{ms0:.3f} ms; K1 rel={rel1:.3e} (tol "
                  f"{REL['lstm_fwd_save'][name]:.1e}) {ms1:.3f} ms; K2 "
                  f"rel={rel2:.3e} (tol {REL['lstm_bwd'][name]:.1e}) "
                  f"{ms2:.3f} ms; twins {plain0:.0f} / {plain1:.0f} / "
                  f"{plain2:.0f} ms")
            if not (err0 <= TOL[name] and rel1 <= REL["lstm_fwd_save"][name]
                    and rel2 <= REL["lstm_bwd"][name] and fin):
                raise AssertionError(f"a CHiME-width LSTM kernel disagrees "
                                     f"with its twin ({shape}, {name})")

    gen = torch.Generator("cuda").manual_seed(SEED + 30)
    P, N, S = CHIME_P, CHIME_N, CHIME_STATES
    h2 = torch.randn(N, P, device="cuda", generator=gen) * 0.5
    W = (torch.rand(P, S, device="cuda", generator=gen) - 0.5) * 0.2
    b = (torch.rand(S, device="cuda", generator=gen) - 0.5) * 0.2
    tc = torch.randint(0, S, (N,), device="cuda", generator=gen,
                       dtype=torch.int32)
    tc[::9] = -1  # dummy frames
    g = torch.tensor(1.0, device="cuda")
    shape = f"S={S} P={P}"
    for name in ("float32", "bfloat16"):
        dt = getattr(torch, name)
        hs, Ws, bs = h2.to(dt), W.to(dt), b.to(dt)
        tl = tc.long()
        loss, cnt, p = sc.softmax_ce_proj_fwd(hs, Ws, b, tc, 1.0, dt)
        (loss_r, cnt_r, p_r), plain_f = timed(
            torch, lambda: sc.softmax_ce_fwd_reference(hs, Ws, b, tc, 1.0, dt))
        rel = elem_rel(p, p_r)
        ctrl = elem_rel(p_r.roll(1, dims=1), p_r)
        lrel = abs(loss.item() - loss_r.item()) / abs(loss_r.item())

        def k3f():
            return sc.softmax_ce_proj_fwd(hs, Ws, b, tc, 1.0, dt)

        def lib_f():
            return F.cross_entropy(torch.addmm(bs, hs, Ws), tl,
                                   reduction="sum", ignore_index=-1)
        dev_f = sum(prof_ms(torch, [k3f], 20, expect=("ce_fwd",)).values())
        lib_fd = sum(prof_ms(torch, [lib_f], 20).values())
        ms_f = time_ms(torch, k3f, 10)
        got = sc.softmax_ce_proj_bwd(p, h2, W, tc, g, 1.0, dt)
        again = sc.softmax_ce_proj_bwd(p, h2, W, tc, g, 1.0, dt)
        want, plain_b = timed(torch, lambda: sc.softmax_ce_bwd_reference(
            p, h2, W, tc, g, 1.0, dt))
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        errs = [rel_err(a, c) for a, c in zip(got, want)]
        brel, berr = max(e[0] for e in errs), max(e[1] for e in errs)

        def k3b():
            return sc.softmax_ce_proj_bwd(p, hs, Ws, tc, g, 1.0, dt)
        dev_b = sum(prof_ms(torch, [k3b], 20, expect=("pb_dw",)).values())
        ms_b = time_ms(torch, k3b, 10)
        res[("softmax_ce_proj_fwd", shape, name)] = dict(
            err=rel_err(p, p_r)[1], ms=dev_f or ms_f, events_ms=ms_f,
            plain_ms=plain_f, library_ms=lib_fd or None,
            cost=tail_cost("softmax_ce_proj_fwd", P, name, N, S))
        res[("softmax_ce_proj_bwd", shape, name)] = dict(
            err=berr, ms=dev_b or ms_b, events_ms=ms_b, plain_ms=plain_b,
            library_ms=None,
            cost=tail_cost("softmax_ce_proj_bwd", P, name, N, S))
        phase("chime", f"K3f {shape} {name} [N={N}]: p elementwise rel "
              f"{rel:.2e} (tol {P_REL[name]:.1e}; rolled-p control "
              f"{ctrl:.2e}), loss rel {lrel:.2e}, count {cnt.item()} vs "
              f"{cnt_r.item()}; on the device {fmt_ms(dev_f or None)}, "
              f"F.cross_entropy(addmm) {fmt_ms(lib_fd or None)}; events "
              f"{ms_f:.4f} ms; twin {plain_f:.2f} ms. K3b rel {brel:.2e} "
              f"[{per_output(('dh', 'dW', 'db'), errs)}] (tol "
              f"{REL['softmax_ce'][name]:.1e}), repeat bit for bit: {same};"
              f" on the device {fmt_ms(dev_b or None)}, events {ms_b:.4f} "
              f"ms; twin {plain_b:.2f} ms")
        if not ctrl > P_REL[name]:
            raise AssertionError("the p check passes a rolled p")
        if not (rel <= P_REL[name] and lrel <= 1e-5
                and abs(cnt.item() - cnt_r.item()) <= 1
                and brel <= REL["softmax_ce"][name] and same):
            raise AssertionError(f"K3 disagrees with its twin at {shape}")
    return res


def write_chime_corpus(workdir):
    """CHiME-shaped corpora (39 features, 150 train and 50 val sequences
    of 200-700 frames): 51-class labels for the recognition nets, 39
    regression targets (a clean version of the input) for the
    autoencoder."""
    from lstm_rnn_tpu_torch.data.netcdf3 import strings_to_chars, write_netcdf
    rng = np.random.RandomState(SEED + 30)
    paths = {}
    for task in ("recognition", "autoencoding"):
        for name, n_seq in (("train", 150), ("val", 50)):
            lengths = rng.randint(200, T_CHIME + 1, n_seq)
            total = int(lengths.sum())
            x = rng.randn(total, CHIME_IN).astype(np.float32)
            dims = {"numSeqs": n_seq, "numTimesteps": total,
                    "inputPattSize": CHIME_IN, "maxSeqTagLength": 24}
            if task == "recognition":
                dims["numLabels"] = CHIME_STATES
                target = ("targetClasses", ["numTimesteps"],
                          rng.randint(0, CHIME_STATES, total).astype(np.int32))
            else:
                dims["targetPattSize"] = CHIME_IN
                target = ("targetPatterns", ["numTimesteps",
                                             "targetPattSize"],
                          (0.5 * x + 0.1 * rng.randn(total, CHIME_IN)
                           ).astype(np.float32))
            path = os.path.join(workdir, f"chime_{task}_{name}.nc")
            write_netcdf(path, dims, [
                ("seqTags", ["numSeqs", "maxSeqTagLength"],
                 strings_to_chars([f"{name}{i:04d}" for i in range(n_seq)],
                                  24)),
                ("seqLengths", ["numSeqs"], lengths.astype(np.int32)),
                ("inputs", ["numTimesteps", "inputPattSize"], x), target])
            paths[(task, name)] = (path, lengths)
    return paths


def chime_cli(torch, workdir):
    """Phase 30b: cli.main(--train true) with each CHiME recipe's
    config.cfg and network.jsn (normal init, input noise 0.1 or 0.6,
    parallel_sequences 50, stochastic, shuffled fractions), 2 epochs, f32
    and bf16: the epoch table, the exact launches (per training fraction
    3 K1 + 3 K2, per val fraction 3 K0; K3f/K3b per fraction for the
    recognition nets, none for the autoencoder), the weights moved, and
    the trained f32 net serves the val set in forward mode. The control:
    no_subsampling f32 with --input_noise_sigma 0 trains to other
    errors. Returns each kernel's launches over these runs."""
    import contextlib
    import io
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.network import Network
    from lstm_rnn_tpu_torch.writers import read_htk
    paths = write_chime_corpus(workdir)
    n_train = DataSet([paths[("recognition", "train")][0]],
                      parallel_sequences=50).num_fractions()
    n_val = DataSet([paths[("recognition", "val")][0]],
                    parallel_sequences=50).num_fractions()
    totals, tables = {}, {}
    here = os.getcwd()
    runs = [(r, d, []) for r in CHIME for d in ("float32", "bfloat16")]
    runs.append(("no_subsampling", "float32", ["--input_noise_sigma", "0"]))
    for recipe, name, extra in runs:
        rdir = CHIME[recipe]
        task = "autoencoding" if recipe == "autoencoding" else "recognition"
        (train_nc, train_len), (val_nc, val_len) = (paths[(task, "train")],
                                                    paths[(task, "val")])
        label = f"{recipe} {name}" + (" input_noise_sigma 0" if extra
                                      else "")
        rundir = os.path.join(workdir, "chime_" + label.replace(" ", "_"))
        os.makedirs(rundir)
        out = os.path.join(rundir, "trained.jsn")
        args = [os.path.join(rdir, "config.cfg"), "--network",
                os.path.join(rdir, "network.jsn"), "--train_file", train_nc,
                "--val_file", val_nc, "--max_epochs", "2",
                "--random_seed", str(SEED), "--compute_dtype", name,
                "--save_network", out, *extra]
        w = wrappers()
        for f in w.values():
            f.launches = 0  # this CHiME run starts here
        buf = io.StringIO()
        os.chdir(rundir)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(args)
            wall = time.perf_counter() - t0
        finally:
            os.chdir(here)
        counts = {k: f.launches for k, f in w.items()}
        text = buf.getvalue()
        rows = [ln for ln in text.splitlines()
                if ln.strip()[:1].isdigit() and "|" in ln]
        for ln in rows:
            phase("chime-cli", f"{label} |{ln}")
        noise_line = [ln for ln in text.splitlines()
                      if ln.startswith("Using input noise")]
        if rc != 0 or len(rows) != 2 or bool(noise_line) == bool(extra):
            print(text[-3000:])
            raise AssertionError(f"cli (CHiME {label}) returned {rc}")
        k3 = task == "recognition"
        expect = {k: 0 for k in w if not k.startswith("gemm:")}
        expect.update(lstm_fwd=3 * n_val * 2, lstm_fwd_save=3 * n_train * 2,
                      lstm_bwd=3 * n_train * 2,
                      softmax_ce_proj_fwd=(n_train + n_val) * 2 * k3,
                      softmax_ce_proj_bwd=n_train * 2 * k3)
        check_counts(counts, expect, bf16=name == "bfloat16", layers=3)
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        cells = [ln.replace("%", " ").replace("|", " ").split()
                 for ln in rows]
        tables[label] = [float(c[3] if k3 else c[2]) for c in cells]
        if not np.isfinite(tables[label]).all():
            raise AssertionError(f"non-finite training error: {rows}")
        start = Network.from_json_file(os.path.join(rdir, "network.jsn"),
                                       input_size_override=CHIME_IN)
        start.init_params(SEED, dist="normal", normal_sigma=0.1)
        trained = Network.from_json_file(out)
        moved = max(float(np.abs(trained.params[n][k]
                                 - start.params[n][k]).max())
                    for n in start.params for k in start.params[n])
        phase("chime-cli", f"{label}: {wall:.1f} s wall for 2 epochs "
              f"({n_train} train fractions of {len(train_len)} sequences, "
              f"{int(train_len.sum())} frames; {n_val} val); "
              f"{noise_line[0] if noise_line else 'no input noise'}; max "
              f"|w - w0| = {moved:.3e}; launches "
              + str({k: v for k, v in counts.items() if v}))
        if not moved > 0:
            raise AssertionError("training did not move the weights")
        if name == "float32" and not extra:
            outdir = os.path.join(rundir, "served")
            run_cli(val_nc, out, outdir)
            tags = [f"val{i:04d}" for i in range(len(val_len))]
            if k3:
                _, worst = read_outputs(outdir, tags, val_len, CHIME_STATES)
                what = f"rows sum to 1 within {worst:.1e}"
            else:
                for tag, n in zip(tags, val_len):
                    y, _, _ = read_htk(os.path.join(outdir, tag + ".htk"))
                    if y.shape != (n, CHIME_IN) or not np.isfinite(y).all():
                        raise AssertionError(f"{tag}: {y.shape}")
                what = f"{CHIME_IN} finite outputs a frame"
            phase("chime-cli", f"{label}: the trained net serves the val "
                  f"set in forward mode: {len(tags)} HTK files, {what}")
    noisy = tables["no_subsampling float32"]
    clean = tables["no_subsampling float32 input_noise_sigma 0"]
    phase("chime-cli", f"control: training errors with input noise 0.6 "
          f"{noisy}, without {clean}")
    if noisy[0] == clean[0] or noisy[1] == clean[1]:
        raise AssertionError("input noise did not change the training "
                             "errors")
    return totals


def noise_draw_on_card(torch):
    """Phase 31a: the Trainer's first weight-noise draw on the card equals
    numpy's RandomState(seed & 0x7FFFFFFF).normal, leaf by leaf in sorted
    layer and key order, bit for bit."""
    seed = 2 ** 32 - 7  # the mask matters
    tr = make_trainer("auto", "float32", weight_noise_sigma=WN_SIGMA,
                      seed=seed)
    noise = tr._draw_noise()
    torch.cuda.synchronize()
    rng = np.random.RandomState(seed & 0x7FFFFFFF)
    n = 0
    for name in sorted(tr.params):
        for k in sorted(tr.params[name]):
            want = rng.normal(0.0, WN_SIGMA, tuple(tr.params[name][k].shape)
                              ).astype(np.float32)
            got = noise[name][k]
            if not (got.is_cuda and np.array_equal(
                    got.cpu().numpy().view(np.int32), want.view(np.int32))):
                raise AssertionError(f"the draw of {name}/{k} is not numpy's")
            n += want.size
    phase("noise", f"the first weight-noise draw on the card ({n:,} normals "
          f"over {sum(len(v) for v in tr.params.values())} leaves, seed "
          f"{seed}): numpy's stream, bit for bit")


def noisy_steps(torch):
    """Phases 31b-c: one weight-noise SGD step (sigma WN_CHECK_SIGMA) on
    the TIMIT recipe batch (T=500, B=50, ragged rows, f32) from the same
    weights and the same draw, through the kernel route, the scan route,
    SP on 2 blocks of cuda:0 and --remat_blocks 4: the loss and the update
    of each against the kernel step's within STEP_TOL, and the exact
    launches; the control, the kernel step at the clean weights, must
    fail the update check against the noisy scan step."""
    batch, _ = recipe_batch(torch, full=False, seed=31)
    cuda0 = torch.device("cuda", 0)
    w = wrappers()
    runs = (("kernel", "auto", WN_CHECK_SIGMA, None, 0),
            ("scan", "scan", WN_CHECK_SIGMA, None, 0),
            ("control", "auto", 0.0, None, 0),
            ("SP on 2 blocks of cuda:0", "auto", WN_CHECK_SIGMA,
             [cuda0] * 2, 0),
            ("remat K=4", "auto", WN_CHECK_SIGMA, None, 4))
    out = {}
    for label, backend, sigma, mesh, k in runs:
        tr = make_trainer(backend, "float32", weight_noise_sigma=sigma,
                          seed=SEED, seq_mesh=mesh)
        tr.net.remat_blocks = k
        before = [v.detach().clone() for v in tr._leaves(tr.params)]
        for f in w.values():
            f.launches = 0  # the step's run starts here
        t0 = time.perf_counter()
        err, _ = tr.train_step(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        upd = torch.cat([(v.detach() - b0).flatten()
                         for v, b0 in zip(tr._leaves(tr.params), before)])
        out[label] = (err.item(), upd, {n: f.launches for n, f in w.items()},
                      wall)
        del tr, before
    l_k, u_k, _, _ = out["kernel"]
    l_s, u_s, _, _ = out["scan"]

    def rels(a, b):
        return (abs(a[0] - b[0]) / abs(b[0]),
                ((a[1] - b[1]).abs().max() / b[1].abs().max()).item())
    zero = {n: 0 for n in w if not n.startswith("gemm:")}
    expect = {"kernel": {**zero, "lstm_fwd_save": 5, "lstm_bwd": 5,
                         "softmax_ce_proj_fwd": 1, "softmax_ce_proj_bwd": 1},
              "SP on 2 blocks of cuda:0": {**zero,
                                           "lstm_fwd_carry_save": 20,
                                           "lstm_bwd_carry": 20},
              "remat K=4": remat_expect(4)}
    for label, ref in (("kernel", "scan"), ("control", "scan"),
                       ("SP on 2 blocks of cuda:0", "kernel"),
                       ("remat K=4", "kernel")):
        lrel, urel = rels(out[label], out[ref])
        loss, _, counts, wall = out[label]
        phase("noise-step", f"one noisy TIMIT SGD step (sigma "
              f"{WN_CHECK_SIGMA}, f32, T={T_TRAIN} B={B}) {label} vs {ref}: "
              f"loss {loss:.6f} vs {out[ref][0]:.6f} (rel {lrel:.2e}, tol "
              f"{STEP_TOL['loss']:.0e}); update rel {urel:.2e} (tol "
              f"{STEP_TOL['update']:.0e}); {wall:.2f} s wall (first call); "
              f"launches " + str({n: c for n, c in counts.items() if c}))
        if label == "control":
            if not urel > STEP_TOL["update"]:
                raise AssertionError("the update check passes the step "
                                     "taken at the clean weights")
            continue
        check_counts(counts, expect[label])
        if not (lrel <= STEP_TOL["loss"] and urel <= STEP_TOL["update"]):
            raise AssertionError(f"the noisy step ({label}) disagrees with "
                                 f"the {ref} step")
    del out
    torch.cuda.empty_cache()


def chime_trainer(recipe, dtype, **kw):
    """A CHiME recipe's Trainer on the card: the recipe's network.jsn,
    normal init (sigma 0.1) from a seed."""
    from lstm_rnn_tpu_torch.network import Network
    from lstm_rnn_tpu_torch.trainer import Trainer
    net = Network.from_json_file(os.path.join(CHIME[recipe], "network.jsn"),
                                 compute_dtype=dtype)
    net.init_params(3, dist="normal", normal_sigma=0.1)
    return Trainer(net, None, learning_rate=1e-5, momentum=0.9,
                   hybrid_online_batch=True, **kw)


def noisy_rates(torch, card):
    """Phase 31d: the training step's frames/s with --weight_noise_sigma
    0.01 beside the same step without it (T=500, B=50, every row full,
    mean of 5 after a warm-up), TIMIT and CHiME no_subsampling, f32 and
    bf16; the host draw alone; a profile of one noisy f32 step of each:
    device busy against wall."""
    nets = (("TIMIT", lambda d, **kw: make_trainer("auto", d, **kw),
             recipe_batch(torch)),
            ("CHiME no_subsampling",
             lambda d, **kw: chime_trainer("no_subsampling", d, **kw),
             recipe_batch(torch, states=CHIME_STATES, inputs=CHIME_IN)))
    for what, make, (batch, frames) in nets:
        for dtype in ("float32", "bfloat16"):
            ms = {}
            for sigma in (0.0, WN_SIGMA):
                tr = make(dtype, weight_noise_sigma=sigma, seed=SEED)
                tr.train_step(*batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    tr.train_step(*batch)
                torch.cuda.synchronize()
                ms[sigma] = 1e3 * (time.perf_counter() - t0) / 5
            t0 = time.perf_counter()
            for _ in range(5):
                tr._draw_noise()
            torch.cuda.synchronize()
            draw = 1e3 * (time.perf_counter() - t0) / 5
            n = sum(v.numel() for v in tr._leaves(tr.params))
            phase("noise-rate", f"{what} train step {dtype}: clean "
                  f"{frames / ms[0.0] * 1e3:,.0f} frames/s ({ms[0.0]:.1f} "
                  f"ms), weight noise {WN_SIGMA} "
                  f"{frames / ms[WN_SIGMA] * 1e3:,.0f} frames/s "
                  f"({ms[WN_SIGMA]:.1f} ms); the draw alone {draw:.1f} ms "
                  f"({n:,} normals) on {card}")
            del tr
        tr = make("float32", weight_noise_sigma=WN_SIGMA, seed=SEED)
        events, wall_us = profile_trainer_step(
            torch, tr, batch, f"one noisy {what} training step T={T_TRAIN}"
            f" f32 (weight noise {WN_SIGMA})")
        busy = sum(dev_us(e) for e in events)
        phase("noise-rate", f"{what} noisy f32 step: device busy "
              + (f"{100 * busy / wall_us:.1f}% of wall" if busy
                 else "not measured"))
        del tr
    torch.cuda.empty_cache()


def init_rng_cli(torch, workdir):
    """Phase 32: cli.main on the TIMIT network.jsn (no weights section)
    with --init_rng currennt, uniform init, --learning_rate 0, 1 epoch:
    the saved weights equal rng_compat's host replay of the reference's
    stream bit for bit (and not the numpy stream's), and the run launched
    its kernels (5 K1, 5 K2, one K3f and one K3b per fraction)."""
    import contextlib
    import io
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch import io_currennt as ioc
    from lstm_rnn_tpu_torch.network import Network
    paths = write_corpus(workdir, "rng", S_STATES, (50,), SEED + 32)
    train_nc, train_len = paths["train"]
    net_path = os.path.join(REPO, "examples", "phoneme_recognition_timit",
                            "network.jsn")
    out = os.path.join(workdir, "rng_initial.jsn")
    w = wrappers()
    for f in w.values():
        f.launches = 0  # the run starts here
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--network", net_path, "--train", "true",
                       "--train_file", train_nc, "--init_rng", "currennt",
                       "--weights_dist", "uniform", "--learning_rate", "0",
                       "--max_epochs", "1", "--parallel_sequences", "50",
                       "--random_seed", str(SEED), "--save_network", out])
    wall = time.perf_counter() - t0
    counts = {k: f.launches for k, f in w.items()}
    if rc != 0:
        print(buf.getvalue()[-3000:])
        raise AssertionError(f"cli --init_rng currennt returned {rc}")
    zero = {n: 0 for n in w if not n.startswith("gemm:")}
    check_counts(counts, {**zero, "lstm_fwd_save": 5, "lstm_bwd": 5,
                          "softmax_ce_proj_fwd": 1, "softmax_ce_proj_bwd": 1})
    saved = _weights(out)
    for init_rng in ("currennt", "numpy"):
        replay = Network.from_json_file(net_path)
        replay.init_params(SEED, init_rng=init_rng)
        flat = ioc.weights_section_from_params(replay.layers_json(),
                                               replay.params)
        same = all(np.array_equal(
            np.asarray(saved[(n, k)], np.float32).view(np.int32),
            np.asarray(v, np.float32).view(np.int32))
            for n, sec in flat.items() for k, v in sec.items())
        if same != (init_rng == "currennt"):
            raise AssertionError(f"the saved weights and the {init_rng} "
                                 f"replay: equal {same}")
    n = sum(np.asarray(v).size for v in saved.values())
    phase("init-rng", f"cli --init_rng currennt on the TIMIT network "
          f"({len(train_len)} sequences, 1 epoch, lr 0, {wall:.1f} s): the "
          f"{n:,} saved weights are rng_compat's replay bit for bit (the "
          f"numpy stream's are not); launches "
          + str({k: v for k, v in counts.items() if v}))



# data parallelism (phases 33-35): the TIMIT recipe's 50 parallel
# sequences over k GPUs, B padded to a multiple of k: 13 rows a rank on 4
# (52 rows, the last rank's 2 empty), 25 on 2
DP_ROWS = (13, 25)
# a DP step on two ranks against the one-process step from the same
# weights (f32): the same kernels over the same rows, each weight-gradient
# sum split between the ranks and finished by the all-reduce, so only the
# order of f32 additions differs (1.7e-7 of the largest gradient on the
# CPU twins); the loss, the update (the momentum delta v = -lr g of the
# first step: the weights' own rounding, an ulp of 0.1 against updates of
# 1e-4, would hide it) relative to its largest entry, and the weights
# relative to theirs; the 2-epoch Trainer's errors and weights the same way
DP_TOL = 1e-6
# the CLI's --num_devices k (and two multi-host processes) against one GPU
# after 2 epochs: the JAX test's rtol (tests/test_distributed.py:104-110),
# relative to each tensor's largest entry; the epoch errors to the table's
# printed digits; served posteriors as phase 16's (STREAM_TOL)
DP_CLI_TOL = 1e-5
# phase 34's steps: (name, rows, leave the all-reduce out, padding rows
# with real targets); the last two are controls that must fail
DP_VARIANTS = (("full", B, False, False), ("padded", B - 1, False, False),
               ("no all-reduce", B, True, False),
               ("padding with targets", B - 1, False, True))


def dp_batch(rows, states, seed, T=T_TRAIN, inputs=117):
    """bench.py's fraction with `rows` sequences, every row full: host
    arrays (inputs, targets, pattypes) as a DataSet fraction holds them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T, rows, inputs).astype(np.float32)
    tc = rng.randint(0, states, (T, rows)).astype(np.int32)
    return x, tc, np.ones((T, rows), np.int8)


def on_card(torch, arrays, device="cuda"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def rank_block(torch, arrays, group, real_pad_targets=False):
    """This rank's block of a host fraction, B padded to a multiple of the
    world size (parallel/data.py), on its device. real_pad_targets: the
    control, padding rows made real frames with class 1."""
    from lstm_rnn_tpu_torch.parallel.data import pad_batch
    rows = arrays[2].shape[1]
    x, tc, pt = pad_batch(*arrays, group.size)
    if real_pad_targets:
        tc, pt = tc.copy(), pt.copy()
        tc[:, rows:], pt[:, rows:] = 1, 1
    return on_card(torch, group.block(x, tc, pt), group.device)


def dp_rank_layer(torch, P, rows, seed):
    """One BLSTM layer's operands at T_TRAIN for one rank's block of
    `rows` sequences: full rows (the recipe step's), a ragged row, a row
    of length 1 and the last row empty (a padding row); dh for the BPTT."""
    rng = np.random.RandomState(seed)

    def u(*s):
        return torch.tensor(rng.uniform(-0.1, 0.1, s), dtype=torch.float32,
                            device="cuda")
    x = torch.tensor(rng.randn(T_TRAIN, rows, P), dtype=torch.float32,
                     device="cuda")
    lengths = np.full(rows, T_TRAIN)
    lengths[1], lengths[2], lengths[-1] = 1, rng.randint(2, T_TRAIN), 0
    dh = torch.tensor(rng.randn(T_TRAIN, rows, D * H), dtype=torch.float32,
                      device="cuda")
    return (x, u(D, P, 4 * H), u(D, H, 4 * H), u(D, 3, H), u(D, 4 * H),
            torch.tensor(lengths, dtype=torch.int32, device="cuda")), dh


def dp_rank_kernels(torch):
    """Phase 33a: K0, K1 and K2 at one TIMIT layer (P = 117 without dx, P
    = 250 with it), and K3f/K3b (S = 183) and K4f/K4b (S = 10,112) over
    its frames, at one rank's block of B = 13 and 25 sequences (T = 500,
    the last row empty), f32 and bf16, against their twins at phase 3, 4
    and 9's tolerances; the empty row's outputs exactly zero; times."""
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    from lstm_rnn_tpu_torch.ops import softmax_ce as sc
    res = {}
    for rows in DP_ROWS:
        for P, need_dx in ((117, False), (250, True)):
            args, dh = dp_rank_layer(torch, P, rows, seed=rows * 1000 + P)
            lens = args[5].cpu().numpy()
            for name in ("float32", "bfloat16"):
                dt = getattr(torch, name)
                with torch.inference_mode():
                    y = lc.lstm_scan_fused(*args, 1.0, dt)
                    err0 = (y.float() - lc.lstm_scan_reference(
                        *args, 1.0, dt).float()).abs().max().item()
                    empty = not y[:, -1].any()
                    ms0 = time_ms(torch, lambda: lc.lstm_scan_fused(
                        *args, 1.0, dt), 5)
                got = lc.lstm_fwd_save(*args, 1.0, dt)
                want = lc.lstm_scan_reference(*args, 1.0, dt, save=True)
                errs = [rel_err(g, w) for g, w in zip(got, want)]
                rel1, err1 = max(e[0] for e in errs), max(e[1] for e in errs)
                fin = all(torch.isfinite(g.float()).all() for g in got)
                ms1 = time_ms(torch, lambda: lc.lstm_fwd_save(*args, 1.0, dt),
                              5)
                h, c, g = got
                bwd = (args[0], args[1], args[2], args[3], args[5], h, c, g,
                       dh, 1.0, True, dt, need_dx)
                got = lc.lstm_bwd(*bwd)
                want = lc.lstm_scan_bwd_reference(*bwd)
                errs = [rel_err(a, b) if a is not None else (0.0, 0.0)
                        for a, b in zip(got, want)]
                rel2, err2 = max(e[0] for e in errs), max(e[1] for e in errs)
                fin = fin and all(torch.isfinite(a).all() for a in got
                                  if a is not None)
                empty = empty and (not need_dx or not got[0][:, -1].any())
                ms2 = time_ms(torch, lambda: lc.lstm_bwd(*bwd), 5)
                del got, want, h, c, g
                for k, err, ms, need in (("lstm_fwd", err0, ms0, False),
                                         ("lstm_fwd_save", err1, ms1, False),
                                         ("lstm_bwd", err2, ms2, need_dx)):
                    res[(k, f"B={rows} P={P}", name)] = dict(
                        err=err, ms=ms, cost=lstm_cost(
                            k, P, lens, name, need, T=T_TRAIN))
                phase("dp-kernel", f"B={rows} P={P} dx={need_dx} {name} "
                      f"[T={T_TRAIN}, row {rows - 1} empty]: K0 "
                      f"max_abs_err={err0:.3e} (tol {TOL[name]:.0e}) "
                      f"{ms0:.3f} ms; K1 rel={rel1:.3e} (tol "
                      f"{REL['lstm_fwd_save'][name]:.1e}) {ms1:.3f} ms; K2 "
                      f"rel={rel2:.3e} (tol {REL['lstm_bwd'][name]:.1e}) "
                      f"{ms2:.3f} ms; the empty row's h and dx exactly "
                      f"zero: {empty}")
                if not (err0 <= TOL[name]
                        and rel1 <= REL["lstm_fwd_save"][name]
                        and rel2 <= REL["lstm_bwd"][name] and fin and empty):
                    raise AssertionError(f"an LSTM kernel disagrees with its "
                                         f"twin at B={rows}, P={P}, {name}")
    gen = torch.Generator("cuda").manual_seed(SEED + 33)
    g = torch.tensor(1.0, device="cuda")
    for rows in DP_ROWS:
        N, P = rows * T_TRAIN, 2 * H
        h2 = torch.randn(N, P, device="cuda", generator=gen) * 0.5
        for S in (S_STATES, S_LVCSR):
            W = (torch.rand(P, S, device="cuda", generator=gen) - 0.5) * 0.2
            b = (torch.rand(S, device="cuda", generator=gen) - 0.5) * 0.2
            tc = torch.randint(0, S, (N,), device="cuda", generator=gen,
                               dtype=torch.int32)
            tc[rows - 1::rows] = -1  # the empty row's frames ([T, B] order)
            for name in ("float32", "bfloat16"):
                dt = getattr(torch, name)
                if S == S_STATES:
                    res.update(dp_rank_k3(torch, rows, h2, W, b, tc, g, name,
                                          dt))
                else:
                    res.update(dp_rank_k4(torch, rows, h2, W, b, tc, g, name,
                                          dt))
    return res


def dp_rank_k3(torch, rows, h2, W, b, tc, g, name, dt):
    """K3f and K3b at one rank's frames against their twins (phase 4's
    checks), the empty row's dh exactly zero."""
    from lstm_rnn_tpu_torch.ops import softmax_ce as sc
    N, P = h2.shape
    hs, Ws = h2.to(dt), W.to(dt)
    loss, cnt, p = sc.softmax_ce_proj_fwd(hs, Ws, b, tc, 1.0, dt)
    loss_r, cnt_r, p_r = sc.softmax_ce_fwd_reference(hs, Ws, b, tc, 1.0, dt)
    rel = elem_rel(p, p_r)
    lrel = abs(loss.item() - loss_r.item()) / abs(loss_r.item())
    got = sc.softmax_ce_proj_bwd(p, h2, W, tc, g, 1.0, dt)
    want = sc.softmax_ce_bwd_reference(p, h2, W, tc, g, 1.0, dt)
    errs = [rel_err(a, c) for a, c in zip(got, want)]
    brel, berr = max(e[0] for e in errs), max(e[1] for e in errs)
    empty = not got[0][rows - 1::rows].any()
    ms_f = time_ms(torch, lambda: sc.softmax_ce_proj_fwd(hs, Ws, b, tc, 1.0,
                                                         dt), 10)
    ms_b = time_ms(torch, lambda: sc.softmax_ce_proj_bwd(p, hs, Ws, tc, g,
                                                         1.0, dt), 10)
    phase("dp-kernel", f"K3 B={rows} (N={N}) {name}: K3f p elementwise rel "
          f"{rel:.2e} (tol {P_REL[name]:.1e}), loss rel {lrel:.2e}, count "
          f"{cnt.item()} vs {cnt_r.item()}, {ms_f:.4f} ms; K3b rel "
          f"{brel:.2e} [{per_output(('dh', 'dW', 'db'), errs)}] (tol "
          f"{REL['softmax_ce'][name]:.1e}), {ms_b:.4f} ms (CUDA events); "
          f"the empty row's dh exactly zero: {empty}")
    if not (rel <= P_REL[name] and lrel <= 1e-5
            and abs(cnt.item() - cnt_r.item()) <= 1
            and brel <= REL["softmax_ce"][name] and empty):
        raise AssertionError(f"K3 disagrees with its twin at B={rows}")
    shape = f"B={rows} P={P}"
    return {("softmax_ce_proj_fwd", shape, name): dict(
                err=rel_err(p, p_r)[1], ms=ms_f,
                cost=tail_cost("softmax_ce_proj_fwd", P, name, N)),
            ("softmax_ce_proj_bwd", shape, name): dict(
                err=berr, ms=ms_b,
                cost=tail_cost("softmax_ce_proj_bwd", P, name, N))}


def dp_rank_k4(torch, rows, h2, W, b, tc, g, name, dt):
    """K4f and K4b at one rank's frames against their twins (phase 9's
    checks), the empty row's dz exactly zero."""
    from lstm_rnn_tpu_torch.ops import softmax_ce as sc
    N, P = h2.shape
    loss, cnt, a, off, ssum, pt = sc.softmax_ce_wide_fwd(h2, W, b, tc, 1.0,
                                                         dt)
    loss_r, cnt_r, off_r, ssum_r, pt_r = sc.wide_stats_reference(a, tc)
    pairs = ((off, off_r), (ssum, ssum_r), (pt, pt_r))
    srel = max(elem_rel(x, y) for x, y in pairs)
    serr = max(rel_err(x, y)[1] for x, y in pairs)
    lrel = abs(loss.item() - loss_r.item()) / abs(loss_r.item())
    hc = h2.to(a.dtype)
    dz, dw, db = sc._launch_wide_bwd(a, hc, tc, off, ssum, pt, g, 1.0)
    dz_r = sc.wide_dz_reference(a, tc, off, ssum, pt, g)
    dzc_r = dz_r.to(a.dtype)
    outs = {"dz": (dz, dzc_r),
            "dW": (dw, torch.matmul(hc.float().t(), dzc_r.float())),
            "db": (db, dz_r.sum(dim=0))}
    errs = {k: rel_err(x, y) for k, (x, y) in outs.items()}
    lims = {"dz": WIDE_REL["dz"][name], "dW": WIDE_REL["dW"][name],
            "db": WIDE_REL["dW"][name]}
    empty = not dz[rows - 1::rows].any()
    del dz_r, dzc_r, outs
    ms_f = time_ms(torch, lambda: sc.softmax_ce_wide_fwd(h2, W, b, tc, 1.0,
                                                         dt), 5)
    ms_b = time_ms(torch, lambda: sc.softmax_ce_wide_bwd(
        a, h2, W, tc, off, ssum, pt, g, 1.0, dt), 5)
    phase("dp-kernel", f"K4 B={rows} (N={N}) {name}: K4f stats elementwise "
          f"rel {srel:.2e} (tol {WIDE_REL['stats'][name]:.0e}), loss rel "
          f"{lrel:.2e}, count {cnt.item()} vs {cnt_r.item()}, {ms_f:.3f} ms "
          f"with its logits product; K4b " + ", ".join(
              f"{k} rel {e[0]:.2e} (tol {lims[k]:.1e})"
              for k, e in errs.items())
          + f", {ms_b:.3f} ms with its dh product (CUDA events); the empty "
          f"row's dz exactly zero: {empty}")
    if not (srel <= WIDE_REL["stats"][name] and lrel <= 1e-5
            and abs(cnt.item() - cnt_r.item()) <= 1 and empty
            and all(e[0] <= lims[k] for k, e in errs.items())):
        raise AssertionError(f"K4 disagrees with its twin at B={rows}")
    shape = f"B={rows} P={P}"
    return {("softmax_ce_wide_fwd", shape, name): dict(
                err=serr, ms=ms_f, cost=wide_cost("softmax_ce_wide_fwd",
                                                  name, N)),
            ("softmax_ce_wide_bwd", shape, name): dict(
                err=max(e[1] for e in errs.values()), ms=ms_b,
                cost=wide_cost("softmax_ce_wide_bwd", name, N))}


def step_ms(torch, tr, batch, reps=5):
    """Mean wall ms of a training step, synchronised, after a warm-up."""
    tr.train_step(*batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        tr.train_step(*batch)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def dp_rank_steps(torch, card):
    """Phase 33b: the recipe step on one GPU at one rank's block, B = 13
    and 25 full rows, beside B = 50: TIMIT f32 and bf16, LVCSR f32 (what
    a DP step costs a rank before its all-reduce)."""
    out = {}
    for label, lvcsr, dtype in (("TIMIT f32", False, "float32"),
                                ("TIMIT bf16", False, "bfloat16"),
                                ("LVCSR f32", True, "float32")):
        for rows in (*DP_ROWS, B):
            batch = on_card(torch, dp_batch(
                rows, S_LVCSR if lvcsr else S_STATES, seed=33))
            tr = make_trainer("auto", dtype, lvcsr)
            ms = step_ms(torch, tr, batch)
            out[(label, rows)] = ms
            phase("dp-step", f"{label} step at B={rows} on one GPU: "
                  f"{ms:.2f} ms ({1e3 * rows * T_TRAIN / ms:,.0f} frames/s, "
                  f"mean of 5) on {card}")
            del tr, batch
    torch.cuda.empty_cache()
    return out


def _epoch_trainer(group, workdir, mesh=None):
    """The 2-epoch Trainer of phases 34 and 36 over phase 7's corpus
    (stochastic, shuffled fractions, f32), data-parallel over `group`
    (None: one process), sequence-parallel over `mesh` (None: no SP);
    returns (trainer, train set, val set)."""
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.config import parse_config
    from lstm_rnn_tpu_torch.models.flagship import build_timit_network
    from lstm_rnn_tpu_torch.trainer import Trainer
    paths = {k: os.path.join(workdir, f"timit_{k}.nc")
             for k in ("train", "val")}
    cfg = parse_config(["--train", "true", "--network", "x",
                        "--train_file", paths["train"],
                        "--val_file", paths["val"], "--truncate_seq", "500",
                        "--parallel_sequences", "50", "--stochastic", "true",
                        "--shuffle_fractions", "true", "--random_seed",
                        str(SEED)])
    train, val = cli._load_dataset(cfg, "train"), cli._load_dataset(cfg,
                                                                    "val")
    net = build_timit_network(seed=SEED)
    return Trainer(net, train, val, learning_rate=1e-4, momentum=0.9,
                   max_epochs=2, hybrid_online_batch=True,
                   device=None if group or mesh else "cuda",
                   seq_mesh=mesh, data_group=group), train, val


def _run_epochs(torch, tr):
    rows = []
    finished = False
    while not finished:
        finished = tr.train_epoch()
        rows.append((tr.cur_training_error, tr.cur_training_class_error,
                     tr.cur_validation_error, tr.cur_validation_class_error))
    torch.cuda.synchronize()
    return rows


def _dp_card_worker(group, workdir):
    """Phase 34 on one rank: each of DP_VARIANTS' steps from fresh
    weights, then the 2-epoch Trainer; the rank's losses, counts,
    parameters and launches to workdir."""
    import contextlib
    import io
    import torch
    w = wrappers()
    out = {}
    for name, rows, skip, real_pad in DP_VARIANTS:
        blk = rank_block(torch, dp_batch(rows, S_STATES, seed=34), group,
                         real_pad)
        tr = make_trainer("auto", "float32", data_group=group)
        if skip:
            tr._sum_over_ranks = lambda tensors: None
        for f in w.values():
            f.launches = 0  # the rank's step starts here
        err, corr = tr.train_step(*blk)
        torch.cuda.synchronize()
        out[name] = dict(err=err.item(), corr=int(corr),
                         params=tr.exact_params(),
                         velocity=tr.exact_params(tr.velocity),
                         launches={k: f.launches for k, f in w.items()})
        del tr, blk
    with contextlib.redirect_stdout(io.StringIO()):
        tr, _, _ = _epoch_trainer(group, workdir)
    for f in w.values():
        f.launches = 0  # the rank's 2 epochs start here
    t0 = time.perf_counter()
    rows = _run_epochs(torch, tr)
    out["epochs"] = dict(rows=rows, params=tr.exact_params(),
                         wall=time.perf_counter() - t0,
                         launches={k: f.launches for k, f in w.items()})
    torch.save(out, os.path.join(workdir, f"dp_rank{group.rank}.pt"))


def _tree_rel(got, want):
    """max |got - want| / max |want| over every leaf of two parameter
    trees (numpy, exact_params' layout)."""
    num = max(float(np.abs(np.asarray(got[n][k]) - want[n][k]).max())
              for n in want for k in want[n])
    return num / max(float(np.abs(want[n][k]).max())
                     for n in want for k in want[n])


def dp_on_one_card(torch, workdir):
    """Phase 34: two ranks on cuda:0 over gloo, through Trainer(
    data_group=) in spawned workers (parallel/launch.py start): the
    recipe step (T = 500, B = 50 full rows; and B = 49, padded to 50, its
    empty row on rank 1) against the one-process step from the same
    weights, the losses summed, the counts summed and every rank's update
    within DP_TOL, with the exact launches a rank; the controls (the
    all-reduce left out, padding rows with real targets) must fail; then 2
    epochs over phase 7's corpus against the one-process Trainer; and the
    CLI's --num_devices 2 refused on one GPU with the JAX CLI's message.
    Returns a rank's launches of the full step."""
    import contextlib
    import io
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.parallel.launch import start
    write_train_corpus(workdir)
    t0 = time.perf_counter()
    start(_dp_card_worker, [torch.device("cuda", 0)] * 2, (workdir,),
          backend="gloo")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(workdir, f"dp_rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    single = {}
    for rows in (B, B - 1):
        tr = make_trainer("auto", "float32")
        err, corr = tr.train_step(*on_card(torch, dp_batch(rows, S_STATES,
                                                           seed=34)))
        single[rows] = (err.item(), int(corr), tr.exact_params(),
                        tr.exact_params(tr.velocity))
        del tr
    for name, rows, *_ in DP_VARIANTS:
        err1, corr1, want, want_v = single[rows]
        err = sum(r[name]["err"] for r in ranks)
        corr = sum(r[name]["corr"] for r in ranks)
        lrel = abs(err - err1) / abs(err1)
        urel = max(_tree_rel(r[name]["velocity"], want_v) for r in ranks)
        wrel = max(_tree_rel(r[name]["params"], want) for r in ranks)
        same = all(np.array_equal(ranks[0][name]["params"][n][k],
                                  ranks[1][name]["params"][n][k])
                   for n in want for k in want[n])
        ok = (lrel <= DP_TOL and corr == corr1 and urel <= DP_TOL
              and wrel <= DP_TOL)
        phase("dp-card", f"{name} (B={rows} over 2 ranks of cuda:0, gloo, "
              f"f32): loss {err:.6f} vs {err1:.6f} (rel {lrel:.2e}), count "
              f"{corr} vs {corr1}, update rel {urel:.2e}, weights rel "
              f"{wrel:.2e} (tol {DP_TOL:.0e}); the ranks' parameters equal: "
              f"{same}; " + ("matches" if ok else "differs"))
        if (name in ("full", "padded")) != ok:
            raise AssertionError(f"the DP step '{name}' "
                                 + ("differs" if not ok else
                                    "passes the check"))
        if name in ("full", "padded") and not same:
            raise AssertionError("the ranks' parameters differ")
    for r, rank in enumerate(ranks):
        zero = {k: 0 for k in rank["full"]["launches"]
                if not k.startswith("gemm:")}
        check_counts(rank["full"]["launches"], {
            **zero, "lstm_fwd_save": 5, "lstm_bwd": 5,
            "softmax_ce_proj_fwd": 1, "softmax_ce_proj_bwd": 1})
    phase("dp-card", f"rank launches of one step: "
          + str({k: v for k, v in ranks[0]["full"]["launches"].items()
                 if v}) + f" (both ranks; workers {wall:.1f} s wall)")
    with contextlib.redirect_stdout(io.StringIO()):
        tr, train, val = _epoch_trainer(None, workdir)
    rows1 = _run_epochs(torch, tr)
    n_train, n_val = train.num_fractions(), val.num_fractions()
    zero = {k: 0 for k in ranks[0]["epochs"]["launches"]
            if not k.startswith("gemm:")}
    for r, rank in enumerate(ranks):
        ep = rank["epochs"]
        # the errors (columns 0, 2) relative; the class errors to a frame
        err_rel = max(abs(a[i] - b[i]) / abs(b[i]) for a, b in
                      zip(ep["rows"], rows1) for i in (0, 2))
        cls = max(abs(a[i] - b[i]) for a, b in zip(ep["rows"], rows1)
                  for i in (1, 3))
        wrel = _tree_rel(ep["params"], tr.exact_params())
        phase("dp-card", f"rank {r}, 2 epochs of Trainer(data_group=) over "
              f"phase 7's corpus ({ep['wall']:.1f} s): epochs {ep['rows']} "
              f"against one process's {rows1}: errors rel {err_rel:.2e}, "
              f"class errors within {cls:.2e}, weights rel {wrel:.2e} (tol "
              f"{DP_TOL:.0e})")
        if not (err_rel <= DP_TOL and wrel <= DP_TOL
                and cls <= 1.5 / min(train.total_timesteps,
                                     val.total_timesteps)):
            raise AssertionError("DP training differs from one process")
        check_counts(ep["launches"], {
            **zero, "lstm_fwd": 5 * n_val * 2,
            "lstm_fwd_save": 5 * n_train * 2, "lstm_bwd": 5 * n_train * 2,
            "softmax_ce_proj_fwd": (n_train + n_val) * 2,
            "softmax_ce_proj_bwd": n_train * 2})
    del tr
    if torch.cuda.device_count() < 2:
        nc, net_path, _, _ = write_inputs(workdir)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["--network", net_path, "--train", "false",
                           "--ff_input_file", nc, "--ff_output_file",
                           os.path.join(workdir, "dp2"), "--num_devices",
                           "2"])
        text = buf.getvalue()
        want = "num_devices=2 but only 1 devices available"
        if rc == 0 or want not in text or "Computing" in text:
            raise AssertionError(f"--num_devices 2 ran on one GPU (rc {rc})")
        phase("dp-card", f"cli --num_devices 2 on one GPU: refused (rc "
              f"{rc}): {text.strip().splitlines()[-1][:100]}")
    torch.cuda.empty_cache()
    return ranks[0]["full"]["launches"]


def cli_process(args, cwd, env=None):
    """Start `python -m lstm_rnn_tpu_torch.cli args` in a process group of
    its own (a data-parallel run's workers are its children); `finish`
    waits for it."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    os.makedirs(cwd, exist_ok=True)
    p = subprocess.Popen([sys.executable, "-m", "lstm_rnn_tpu_torch.cli",
                          *args], cwd=cwd, env=env, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         start_new_session=True)
    return p


def finish(p, what, timeout=900):
    """The output of a cli_process, which must exit 0 within `timeout`
    seconds (else its process group is killed and the phase fails)."""
    import signal
    try:
        out = p.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f"{what} did not end within {timeout} s")
    if p.returncode != 0:
        print(out[-4000:])
        raise AssertionError(f"{what} returned {p.returncode}")
    return out


def _flat_rel(got, want):
    """max over the weights sections of a saved network (_weights) of max
    |got - want| / max |want|."""
    return max(float(np.abs(got[k] - want[k]).max(initial=0.0)
                     / max(1e-30, np.abs(want[k]).max(initial=0.0)))
               for k in want)


def _table_rows(text):
    return [ln for ln in text.splitlines()
            if ln.strip()[:1].isdigit() and "|" in ln]


def _rows_close(a, b):
    """Two epoch tables' errors: relative DP_CLI_TOL plus half a unit of
    the printed digit (class errors to 0.01%, errors to 0.001)."""
    return all(abs(x - y) <= DP_CLI_TOL * abs(y) + (0.005 if i % 2 == 0
                                                    else 0.0005)
               for ra, rb in zip(epoch_errors(a), epoch_errors(b))
               for i, (x, y) in enumerate(zip(ra, rb)))


def dp_cli(torch, workdir, n):
    """Phase 35a-c: the CLI on n GPUs over NCCL. Train mode: --num_devices
    k (k = 2, and 4 with 4 GPUs) on phase 7's corpus for 2 epochs
    (stochastic, shuffled fractions, f32) against --num_devices 1: the
    weights and the epoch table; two CLI processes with the multi-host
    flags, each seeing half of the GPUs (CUDA_VISIBLE_DEVICES), against
    --num_devices of the same total. Forward mode: --num_devices k over
    phase 5's corpus against one GPU, the HTK posteriors."""
    paths, net_path = write_train_corpus(workdir)
    ks = [k for k in (2, 4) if k <= n]
    train = ["--network", net_path, "--train", "true", "--train_file",
             paths["train"][0], "--val_file", paths["val"][0],
             "--truncate_seq", "500", "--parallel_sequences", "50",
             "--stochastic", "true", "--shuffle_fractions", "true",
             "--learning_rate", "1e-4", "--momentum", "0.9", "--max_epochs",
             "2", "--random_seed", str(SEED)]
    runs = {}
    for k in (1, *ks):
        d = os.path.join(workdir, f"dp_train{k}")
        t0 = time.perf_counter()
        out = finish(cli_process(train + ["--num_devices", str(k)], d),
                     f"cli --num_devices {k}")
        runs[k] = (d, out, time.perf_counter() - t0)
        for ln in _table_rows(out):
            phase("dp-cli", f"--num_devices {k} |{ln}")
    base = _weights(os.path.join(runs[1][0], "trained_network.jsn"))
    half = n // 2 if n >= 2 else 1
    port = _free_port()
    procs = []
    for i in range(2):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=",".join(
            str(j) for j in range(i * half, (i + 1) * half)))
        procs.append(cli_process(train + [
            "--coordinator_address", f"127.0.0.1:{port}", "--num_processes",
            "2", "--process_id", str(i)],
            os.path.join(workdir, f"dp_mh{i}"), env))
    t0 = time.perf_counter()
    outs = [finish(p, f"multi-host process {i}") for i, p in
            enumerate(procs)]
    mh_wall = time.perf_counter() - t0
    if "over 2 hosts" not in outs[0] or os.listdir(os.path.join(
            workdir, "dp_mh1")):
        raise AssertionError("the multi-host run's banner or files")
    for k, (d, out, wall) in runs.items():
        if k == 1:
            continue
        w = _weights(os.path.join(d, "trained_network.jsn"))
        rel = _flat_rel(w, base)
        close = _rows_close(_table_rows(out), _table_rows(runs[1][1]))
        phase("dp-cli", f"train --num_devices {k} vs 1 ({wall:.1f} s vs "
              f"{runs[1][2]:.1f} s wall, 2 epochs): weights rel {rel:.2e} "
              f"(tol {DP_CLI_TOL:.0e}); epoch errors to the table's digits:"
              f" {close}")
        if not (rel <= DP_CLI_TOL and close):
            raise AssertionError(f"--num_devices {k} training differs")
    mh = _weights(os.path.join(workdir, "dp_mh0", "trained_network.jsn"))
    same = runs[2 * half][0]
    want = _weights(os.path.join(same, "trained_network.jsn"))
    rel = _flat_rel(mh, want)
    phase("dp-cli", f"train, 2 processes x {half} GPU(s) with the multi-host "
          f"flags ({mh_wall:.1f} s wall) vs --num_devices {2 * half}: "
          f"weights rel {rel:.2e} (tol {DP_CLI_TOL:.0e}); process 1 wrote "
          "nothing")
    if not rel <= DP_CLI_TOL:
        raise AssertionError("multi-host training differs")
    nc, net_path, tags, lengths = write_inputs(workdir)
    outs = {}
    for k in (1, *ks):
        d = os.path.join(workdir, f"dp_ff{k}")
        t0 = time.perf_counter()
        finish(cli_process(["--network", net_path, "--train", "false",
                            "--ff_input_file", nc, "--parallel_sequences",
                            "50", "--ff_output_format", "htk",
                            "--ff_output_file", d, "--num_devices", str(k)],
                           workdir + f"/dp_ff_cwd{k}"), f"forward {k}")
        outs[k], _ = read_outputs(d, tags, lengths)
        if k > 1:
            diff = max(float(np.abs(a - b).max())
                       for a, b in zip(outs[k], outs[1]))
            phase("dp-cli", f"forward --num_devices {k} vs 1 "
                  f"({time.perf_counter() - t0:.1f} s wall): max |p_dp - p|"
                  f" = {diff:.3e} (tol {STREAM_TOL:.0e})")
            if not diff <= STREAM_TOL:
                raise AssertionError(f"DP serving differs: {diff}")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# phase 35d's steps: (label, LVCSR, compute dtype, B a GPU fixed at 50
# (False: parallel_sequences 50 over k GPUs) )
DP_RATES = (("TIMIT f32", False, "float32", False),
            ("TIMIT f32", False, "float32", True),
            ("TIMIT bf16", False, "bfloat16", False),
            ("TIMIT bf16", False, "bfloat16", True),
            ("LVCSR f32", True, "float32", True))


def _dp_rates_worker(group, out_path):
    """Phase 35d on one rank of n: for each of DP_RATES and k = 1, 2, 4
    (<= n) GPUs, the recipe step of ranks 0..k-1 (k = 1: no group), timed
    (mean of 5 after a warm-up, a barrier before and after), the packed
    all-reduce of the gradients alone (CUDA events, mean of 10), and on
    rank 0 a profile of 3 steps (the NCCL kernels' device time a step);
    rank 0 writes the results as JSON."""
    import json as _json
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile
    from lstm_rnn_tpu_torch.parallel.data import DataGroup, all_reduce_sum
    ks = [k for k in (1, 2, 4, 8) if k <= group.size]
    groups = {k: dist.new_group(list(range(k))) for k in ks if k > 1}
    out = []
    for label, lvcsr, dtype, per_gpu in DP_RATES:
        for k in ks:
            if k == 1 and per_gpu and not lvcsr:
                continue  # the same one-GPU step as parallel_sequences 50
            rows = B * k if per_gpu else B
            if group.rank < k:
                sub = groups.get(k)
                dg = (DataGroup(group.rank, k, group.device, group=sub)
                      if sub is not None else None)
                arrays = dp_batch(rows, S_LVCSR if lvcsr else S_STATES,
                                  seed=35)
                batch = (rank_block(torch, arrays, dg) if dg is not None
                         else on_card(torch, arrays, group.device))
                tr = make_trainer("auto", dtype, lvcsr, data_group=dg,
                                  device=None if dg else group.device)

                def sync():
                    torch.cuda.synchronize()
                    if sub is not None:
                        dist.barrier(group=sub)
                tr.train_step(*batch)
                sync()
                t0 = time.perf_counter()
                for _ in range(5):
                    tr.train_step(*batch)
                sync()
                ms = 1e3 * (time.perf_counter() - t0) / 5
                leaves = [torch.zeros_like(p) for p in tr._leaves(tr.params)]
                mb = sum(t.numel() * t.element_size() for t in leaves) / 1e6
                ar_ms = nccl_ms = busy_ms = None
                if sub is not None:
                    all_reduce_sum(leaves, sub)
                    sync()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(10):
                        all_reduce_sum(leaves, sub)
                    end.record()
                    sync()
                    ar_ms = start.elapsed_time(end) / 10
                if group.rank == 0:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(3):
                            tr.train_step(*batch)
                        torch.cuda.synchronize()
                    ev = prof.key_averages()
                    busy = sum(dev_us(e) for e in ev)
                    if busy:
                        busy_ms = busy / 3e3
                        nccl_ms = sum(dev_us(e) for e in ev
                                      if "nccl" in e.key.lower()) / 3e3
                else:
                    for _ in range(3):
                        tr.train_step(*batch)
                sync()
                if group.rank == 0:
                    out.append(dict(label=label, k=k, rows=rows,
                                    per_gpu=per_gpu, ms=ms,
                                    frames_s=1e3 * rows * T_TRAIN / ms,
                                    allreduce_mb=mb, allreduce_ms=ar_ms,
                                    nccl_ms=nccl_ms, busy_ms=busy_ms))
                del tr, batch, leaves
                torch.cuda.empty_cache()
            dist.barrier()
    if group.rank == 0:
        with open(out_path, "w") as f:
            _json.dump(out, f)


def dp_rates(torch, card, workdir, n):
    """Phase 35d: training frames/s and the all-reduce's time per step on
    1, 2 and 4 GPUs (n workers over NCCL, parallel/launch.py): TIMIT f32
    and bf16 at parallel_sequences 50 and at 50 a GPU, LVCSR f32 at 50 a
    GPU, each beside the one-GPU step of the same call."""
    from lstm_rnn_tpu_torch.parallel.launch import start
    path = os.path.join(workdir, "dp_rates.json")
    start(_dp_rates_worker, [torch.device("cuda", j) for j in range(n)],
          (path,))
    with open(path) as f:
        res = json.load(f)
    one = {r["label"]: r for r in res if r["k"] == 1}
    for r in res:
        base = one[r["label"]]
        phase("dp-rate", f"{r['label']} B={r['rows']} "
              f"({'50 a GPU' if r['per_gpu'] else 'parallel_sequences 50'})"
              f" on {r['k']} GPU(s): {r['frames_s']:,.0f} frames/s "
              f"({r['ms']:.2f} ms a step, mean of 5; "
              f"{r['frames_s'] / base['frames_s']:.2f}x the one-GPU step's "
              f"{base['frames_s']:,.0f}); all-reduce of "
              f"{r['allreduce_mb']:.2f} MB alone "
              + (f"{r['allreduce_ms']:.3f} ms" if r["allreduce_ms"]
                 is not None else "none")
              + ", NCCL kernels in a profiled step "
              + fmt_ms(r["nccl_ms"]) + f", device busy {fmt_ms(r['busy_ms'])}"
              f" a step on rank 0; {card}")
    return res


# DP x SP and data-parallel streaming (phases 36-38): each data-parallel
# rank's block of B runs sequence-parallel on a seq mesh of its own (DP x
# SP), or streams its block of the concurrent streams chunk by chunk from
# its own carried state (DP streaming). On one card two ranks share
# cuda:0 over gloo, each DP x SP rank with a 2-block mesh of cuda:0.
DPSP_SEQ = 2
# a DP x SP rank's block: the recipe's 50 rows over 2 ranks, T = 500 over
# 2 blocks
DPSP_ROWS, DPSP_T = B // 2, T_TRAIN // DPSP_SEQ
# a DP streaming rank's streams: the streaming stack's 64 over 2 ranks
DPSTREAM_ROWS = B_STREAM // 2
# K6b-f, K6b-b and K6f launches of one DP x SP rank's training step: 5
# layers x 2 directions x 2 blocks
DPSP_PER_STEP = 5 * 2 * DPSP_SEQ


def dp_sp_rank_kernels(torch):
    """Phase 36a: K6b-f and K6b-b (the DP x SP training step's blocks) and
    K6f (its validation passes' and DP x SP serving's blocks) at one
    rank's block (B = 25 of the recipe's 50, T = 250 of 500; P = 117
    without dx, P = 250 with it; both directions; f32 and bf16) against
    their twins at phase 18's tolerances, from non-zero carries, zero
    carries as the K6b-f control that must fail, with times; and a block
    whose rows are all padding (no valid frame, zero carries and final
    cotangents, N(0, 1) inputs and output cotangents): every output of the
    three kernels exactly zero; the twins' times (dir_offset 0)."""
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    res = {}
    for P, need_dx in ((117, False), (250, True)):
        args, (h0, c0), (dh, dhf, dcf) = carry_grad_layer(
            torch, P, P + 36, T=DPSP_T, rows=DPSP_ROWS)
        lens = args[5].cpu().numpy()
        z = torch.zeros_like(h0)
        pad_args = args[:5] + (torch.zeros_like(args[5]),)
        shape = f"B={DPSP_ROWS} T={DPSP_T} P={P}"
        for dir_offset in (0, 1):
            for name in ("float32", "bfloat16"):
                dt = getattr(torch, name)

                def fwd(a=args, hh=h0, cc=c0):
                    return lc.lstm_fwd_save_carry(*a, hh, cc, 1.0, dt, None,
                                                  dir_offset)

                def k6f(a=args, hh=h0, cc=c0):
                    return lc.lstm_scan_fused_carry(*a, hh, cc, 1.0, True, dt,
                                                    True, None, dir_offset)
                got = fwd()
                want = lc.lstm_scan_carry_reference(
                    *args, h0, c0, 1.0, dt, None, dir_offset, None, True)
                errs = [rel_err(g, w) for g, w in zip((*got[:3], *got[3]),
                                                      (*want[:3], *want[3]))]
                ctrl = max(rel_err(g, w)[0] for g, w in zip(
                    (*fwd(hh=z, cc=z)[:3],), want[:3]))
                got6 = k6f()
                want6 = lc.lstm_scan_carry_reference(*args, h0, c0, 1.0, dt,
                                                     None, dir_offset)
                err6 = max((g.float() - w.float()).abs().max().item()
                           for g, w in zip((got6[0], *got6[1]),
                                           (want6[0], *want6[1])))
                h, c, g, _ = got
                bwd_args = (args[0], args[1], args[2], args[3], args[5], h,
                            c, g, h0, c0, dh, dhf, dcf, 1.0, True, dt,
                            need_dx, None, dir_offset)
                got_b = lc.lstm_bwd_carry(*bwd_args)
                want_b = lc.lstm_scan_carry_bwd_reference(*bwd_args)
                errs_b = [rel_err(a, b) if a is not None else (0.0, 0.0)
                          for a, b in zip(got_b, want_b)]
                # the all-padding block: what a rank whose rows are all
                # padding runs
                pf = fwd(pad_args, z, z)
                ph, pc, pg, _ = pf
                pb = lc.lstm_bwd_carry(
                    args[0], args[1], args[2], args[3], pad_args[5], ph, pc,
                    pg, z, z, dh, z, z, 1.0, True, dt, need_dx, None,
                    dir_offset)
                p6 = k6f(pad_args, z, z)
                zero = not any(t.any().item() for t in (
                    *pf[:3], *pf[3], p6[0], *p6[1],
                    *[t for t in pb if t is not None]))
                torch.cuda.synchronize()
                finite = all(torch.isfinite(t.float()).all() for t in (
                    *got[:3], *got[3], got6[0], *[t for t in got_b
                                                   if t is not None]))
                ms_f = time_ms(torch, fwd, 10)
                ms_b = time_ms(torch, lambda: lc.lstm_bwd_carry(*bwd_args), 5)
                ms_6 = time_ms(torch, k6f, 10)
                frel, brel = max(e[0] for e in errs), max(e[0] for e in errs_b)
                lim_f, lim_b = REL["lstm_fwd_save"][name], REL["lstm_bwd"][name]
                phase("dpsp-kernel", f"{shape} dir_offset={dir_offset} {name}:"
                      f" K6b-f rel {frel:.2e} (tol {lim_f:.1e}; control zero "
                      f"carries {ctrl:.2e}) {ms_f:.3f} ms; K6b-b rel "
                      f"{brel:.2e} [" + per_output(
                          ("dx", "dW_in", "dW_rec", "dpeep", "dbias", "dh0",
                           "dc0"), errs_b) + f"] (tol {lim_b:.1e}) "
                      f"{ms_b:.3f} ms; K6f max_abs_err {err6:.3e} (tol "
                      f"{TOL[name]:.0e}) {ms_6:.3f} ms; an all-padding "
                      f"block's outputs exactly zero: {zero}")
                if not (finite and frel <= lim_f and brel <= lim_b
                        and err6 <= TOL[name] and zero):
                    raise AssertionError(f"K6b/K6f at a DP x SP rank's block "
                                         f"(P={P}, dir_offset={dir_offset}, "
                                         f"{name}): {frel}, {brel}, {err6}, "
                                         f"all-padding zero {zero}")
                if not ctrl > lim_f:
                    raise AssertionError(f"the K6b-f check passes zero "
                                         f"carries: {ctrl}")
                if dir_offset:
                    continue
                plain = [time_ms(torch, fn, 1) for fn in (
                    lambda: lc.lstm_scan_carry_reference(
                        *args, h0, c0, 1.0, dt, None, 0, None, True),
                    lambda: lc.lstm_scan_carry_bwd_reference(*bwd_args),
                    lambda: lc.lstm_scan_carry_reference(
                        *args, h0, c0, 1.0, dt, None, 0))]
                for kind, err, ms, plain_ms, dx in (
                        ("lstm_fwd_carry_save", max(e[1] for e in errs),
                         ms_f, plain[0], False),
                        ("lstm_bwd_carry", max(e[1] for e in errs_b), ms_b,
                         plain[1], need_dx),
                        ("lstm_fwd_carry", err6, ms_6, plain[2], False)):
                    res[(kind, shape, name)] = dict(
                        err=err, ms=ms, plain_ms=plain_ms,
                        cost=lstm_cost(kind, P, lens, name, dx, T=DPSP_T,
                                       D=1))
    return res


def _dpsp_card_worker(group, workdir):
    """Phase 36b-c on one rank (its seq mesh: cuda:0 twice): each of
    DP_VARIANTS' steps from fresh weights, a step of one sequence (rank
    1's block all padding: its loss, count and gradients before the
    all-reduce), then the 2-epoch Trainer; the rank's results and
    launches to workdir."""
    import contextlib
    import io
    import torch
    mesh = list(group.seq_mesh)
    w = wrappers()
    out = {}
    for name, rows, skip, real_pad in DP_VARIANTS:
        blk = rank_block(torch, dp_batch(rows, S_STATES, seed=36), group,
                         real_pad)
        tr = make_trainer("auto", "float32", seq_mesh=mesh, data_group=group)
        if skip:
            tr._sum_over_ranks = lambda tensors: None
        for f in w.values():
            f.launches = 0  # the rank's step starts here
        err, corr = tr.train_step(*blk)
        torch.cuda.synchronize()
        out[name] = dict(err=err.item(), corr=int(corr),
                         params=tr.exact_params(),
                         velocity=tr.exact_params(tr.velocity),
                         launches={k: f.launches for k, f in w.items()})
        if name == "full":  # the step's wall, both ranks sharing the card
            out["step_ms"] = step_ms(torch, tr, blk)
        del tr, blk
    tr = make_trainer("auto", "float32", seq_mesh=mesh, data_group=group)
    err, corr, grads = tr.grad_fraction(*rank_block(
        torch, dp_batch(1, S_STATES, seed=36), group))
    out["one row"] = dict(err=err.item(), corr=int(corr), zero=not any(
        g.any().item() for layer in grads.values() for g in layer.values()))
    del tr, grads
    with contextlib.redirect_stdout(io.StringIO()):
        tr, _, _ = _epoch_trainer(group, workdir, mesh)
    for f in w.values():
        f.launches = 0  # the rank's 2 epochs start here
    t0 = time.perf_counter()
    rows = _run_epochs(torch, tr)
    out["epochs"] = dict(rows=rows, params=tr.exact_params(),
                         wall=time.perf_counter() - t0,
                         launches={k: f.launches for k, f in w.items()})
    torch.save(out, os.path.join(workdir, f"dpsp_rank{group.rank}.pt"))


def dp_sp_on_one_card(torch, workdir):
    """Phase 36b-d: two DP x SP ranks on cuda:0 over gloo, each with a
    2-block seq mesh of cuda:0, through Trainer(seq_mesh=, data_group=) in
    spawned workers: the recipe step (T = 500, B = 50 full rows; and B =
    49, its padding row on rank 1) against the one-process step on the
    same 2-block mesh from the same weights (the losses and counts summed,
    every rank's update within DP_TOL), with a rank's exact launches (20
    K6b-f, 20 K6b-b, nothing else); the controls (the all-reduce left out,
    padding rows with real targets) must fail; one sequence over the two
    ranks: rank 1's loss, count and gradients exactly zero; 2 epochs over
    phase 7's corpus against the one-process SP Trainer; and, on fewer
    than 4 GPUs, the CLI's --num_devices 4 --seq_devices 2 refused with
    the JAX CLI's message. Returns a rank's launches of the full step and
    of the 2 epochs."""
    import contextlib
    import io
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.parallel.launch import start
    write_train_corpus(workdir)
    mesh = [torch.device("cuda", 0)] * DPSP_SEQ
    t0 = time.perf_counter()
    start(_dpsp_card_worker, [mesh] * 2, (workdir,), backend="gloo")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(workdir, f"dpsp_rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    single = {}
    for rows in (B, B - 1):
        tr = make_trainer("auto", "float32", seq_mesh=mesh)
        batch = on_card(torch, dp_batch(rows, S_STATES, seed=36))
        err, corr = tr.train_step(*batch)
        single[rows] = (err.item(), int(corr), tr.exact_params(),
                        tr.exact_params(tr.velocity))
        if rows == B:
            one_ms = step_ms(torch, tr, batch)
        del tr, batch
    for name, rows, *_ in DP_VARIANTS:
        err1, corr1, want, want_v = single[rows]
        err = sum(r[name]["err"] for r in ranks)
        corr = sum(r[name]["corr"] for r in ranks)
        lrel = abs(err - err1) / abs(err1)
        urel = max(_tree_rel(r[name]["velocity"], want_v) for r in ranks)
        wrel = max(_tree_rel(r[name]["params"], want) for r in ranks)
        same = all(np.array_equal(ranks[0][name]["params"][n][k],
                                  ranks[1][name]["params"][n][k])
                   for n in want for k in want[n])
        ok = (lrel <= DP_TOL and corr == corr1 and urel <= DP_TOL
              and wrel <= DP_TOL)
        phase("dpsp-card", f"{name} (B={rows} over 2 ranks x {DPSP_SEQ} "
              f"blocks of cuda:0, gloo, f32) vs one process's {DPSP_SEQ}-"
              f"block SP step: loss {err:.6f} vs {err1:.6f} (rel "
              f"{lrel:.2e}), count {corr} vs {corr1}, update rel "
              f"{urel:.2e}, weights rel {wrel:.2e} (tol {DP_TOL:.0e}); the "
              f"ranks' parameters equal: {same}; "
              + ("matches" if ok else "differs"))
        if (name in ("full", "padded")) != ok:
            raise AssertionError(f"the DP x SP step '{name}' "
                                 + ("differs" if not ok else
                                    "passes the check"))
        if name in ("full", "padded") and not same:
            raise AssertionError("the DP x SP ranks' parameters differ")
    expect_step = {k: 0 for k in ranks[0]["full"]["launches"]
                   if not k.startswith("gemm:")}
    expect_step.update(lstm_fwd_carry_save=DPSP_PER_STEP,
                       lstm_bwd_carry=DPSP_PER_STEP)
    for rank in ranks:
        check_counts(rank["full"]["launches"], expect_step)
    pad = ranks[1]["one row"]
    phase("dpsp-card", "rank launches of one step: " + str(
        {k: v for k, v in ranks[0]["full"]["launches"].items() if v})
        + f" (both ranks; workers {wall:.1f} s wall); the B={B} step "
        f"{ranks[0]['step_ms']:.2f} ms on rank 0 (both ranks sharing the "
        f"card, mean of 5) against {one_ms:.2f} ms in one process on the "
        f"same 2-block mesh; one sequence over "
        f"the two ranks: rank 1 (all padding) loss {pad['err']}, count "
        f"{pad['corr']}, gradients exactly zero: {pad['zero']}")
    if not (pad["err"] == 0.0 and pad["corr"] == 0 and pad["zero"]):
        raise AssertionError(f"an all-padding DP x SP rank adds {pad}")
    with contextlib.redirect_stdout(io.StringIO()):
        tr, train, val = _epoch_trainer(None, workdir, mesh)
    t0 = time.perf_counter()
    rows1 = _run_epochs(torch, tr)
    wall1 = time.perf_counter() - t0
    n_train, n_val = train.num_fractions(), val.num_fractions()
    expect = {k: 0 for k in ranks[0]["epochs"]["launches"]
              if not k.startswith("gemm:")}
    expect.update(lstm_fwd_carry=DPSP_PER_STEP * n_val * 2,
                  lstm_fwd_carry_save=DPSP_PER_STEP * n_train * 2,
                  lstm_bwd_carry=DPSP_PER_STEP * n_train * 2)
    for r, rank in enumerate(ranks):
        ep = rank["epochs"]
        err_rel = max(abs(a[i] - b[i]) / abs(b[i]) for a, b in
                      zip(ep["rows"], rows1) for i in (0, 2))
        cls = max(abs(a[i] - b[i]) for a, b in zip(ep["rows"], rows1)
                  for i in (1, 3))
        wrel = _tree_rel(ep["params"], tr.exact_params())
        phase("dpsp-card", f"rank {r}, 2 epochs of Trainer(seq_mesh=, "
              f"data_group=) over phase 7's corpus ({ep['wall']:.1f} s): "
              f"epochs {ep['rows']} against one process's {DPSP_SEQ}-block "
              f"SP Trainer's {rows1} ({wall1:.1f} s): errors rel "
              f"{err_rel:.2e}, class errors "
              f"within {cls:.2e}, weights rel {wrel:.2e} (tol {DP_TOL:.0e})")
        if not (err_rel <= DP_TOL and wrel <= DP_TOL
                and cls <= 1.5 / min(train.total_timesteps,
                                     val.total_timesteps)):
            raise AssertionError("DP x SP training differs from one process")
        check_counts(ep["launches"], expect)
    del tr
    if torch.cuda.device_count() < 4:
        nc, net_path, _, _ = write_inputs(workdir)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["--network", net_path, "--train", "false",
                           "--ff_input_file", nc, "--ff_output_file",
                           os.path.join(workdir, "dpsp4"), "--num_devices",
                           "4", "--seq_devices", "2"])
        text = buf.getvalue()
        want = (f"num_devices=4 but only {torch.cuda.device_count()} "
                "devices available")
        if rc == 0 or want not in text or "Computing" in text:
            raise AssertionError(f"--num_devices 4 --seq_devices 2 ran on "
                                 f"{torch.cuda.device_count()} GPU(s) (rc "
                                 f"{rc})")
        phase("dpsp-card", f"cli --num_devices 4 --seq_devices 2 on "
              f"{torch.cuda.device_count()} GPU(s): refused (rc {rc}): "
              f"{text.strip().splitlines()[-1][:100]}")
    torch.cuda.empty_cache()
    return ranks[0]["full"]["launches"], ranks[0]["epochs"]["launches"]


def dp_stream_rank_kernel(torch):
    """Phase 37a: the carry kernel K6f+K7 at one DP streaming rank's
    streams (B = 32 of the 64, one 64-frame chunk of the streaming stack's
    layer, H = 250, P = 117 and 250) against its twin at phase 14's
    tolerance, from non-zero carries with chunk_mask's step patterns; zero
    carries as the control that must fail; its time beside the twin's."""
    from lstm_rnn_tpu_torch.ops import lstm_cell as lc
    T, Bs, Hs = CHUNK, DPSTREAM_ROWS, H_STREAM
    mask = chunk_mask(torch, T, Bs)
    steps = mask.sum(dim=1).cpu().numpy()
    res = {}
    for P in (117, 250):
        rng = np.random.RandomState(P + 37)

        def u(lo, hi, *shape):
            return torch.tensor(rng.uniform(lo, hi, shape),
                                dtype=torch.float32, device="cuda")
        x = torch.tensor(rng.randn(T, Bs, P), dtype=torch.float32,
                         device="cuda")
        args = (x, u(-0.1, 0.1, 1, P, 4 * Hs), u(-0.1, 0.1, 1, Hs, 4 * Hs),
                u(-0.1, 0.1, 1, 3, Hs), u(-0.1, 0.1, 1, 4 * Hs),
                torch.full((Bs,), T, dtype=torch.int32, device="cuda"))
        h0, c0 = u(-0.9, 0.9, 1, Bs, Hs), u(-3.0, 3.0, 1, Bs, Hs)
        z = torch.zeros_like(h0)
        for name in ("float32", "bfloat16"):
            dt = getattr(torch, name)

            def kernel(h=h0, c=c0):
                return lc.lstm_scan_fused_carry(*args, h, c, 1.0, True, dt,
                                                True, None, 0, mask)
            want = lc.lstm_scan_carry_reference(*args, h0, c0, 1.0, dt,
                                                None, 0, mask)

            def errs(got):
                return [(g.float() - w.float()).abs().max().item()
                        for g, w in zip((got[0], *got[1]),
                                        (want[0], *want[1]))]
            got = kernel()
            torch.cuda.synchronize()
            err = max(errs(got))
            ctrl = max(errs(kernel(z, z)))
            finite = all(torch.isfinite(g.float()).all()
                         for g in (got[0], *got[1]))
            ms = time_ms(torch, kernel, 20)
            plain = time_ms(torch, lambda: lc.lstm_scan_carry_reference(
                *args, h0, c0, 1.0, dt, None, 0, mask), 1)
            phase("dpstream-kernel", f"B={Bs} P={P} {name}: max_abs_err "
                  f"{err:.3e} (tol {TOL[name]:.0e}; control zero carries "
                  f"{ctrl:.2e}); kernel {ms:.3f} ms, twin {plain:.1f} ms "
                  f"[T={T} H={Hs} D=1, {int(steps.sum())} valid steps]")
            if not (finite and err <= TOL[name]):
                raise AssertionError(f"the carry kernel at a DP streaming "
                                     f"rank's B={Bs} (P={P}, {name}): {err}")
            if not ctrl > TOL[name]:
                raise AssertionError(f"the check passes zero carries: {ctrl}")
            res[("lstm_fwd_carry", f"B={Bs} P={P}", name)] = dict(
                err=err, ms=ms, plain_ms=plain,
                cost=lstm_cost("lstm_fwd_carry", P, steps, name, T=T, D=1,
                               H=Hs))
    return res


def _stream_fraction(torch, seed):
    """stream_batch's T_STREAM frames of B_STREAM streams as a DataSet
    fraction's host arrays (inputs, pattypes)."""
    import types
    x, pt = stream_batch(torch, seed)
    return types.SimpleNamespace(inputs=x.cpu().numpy(),
                                 pattypes=pt.cpu().numpy())


def _dp_stream_worker(group, workdir):
    """Phase 37b on one rank: its block of the 64 streams through the
    CLI's DP streaming path (cli._apply_block with --stream_chunk's
    chunks: B padded to parallel_sequences 64 over the ranks, the rank's
    32 streams in 64-frame chunks from a fresh state on its device, the
    blocks gathered on rank 0), f32 and bf16, after a warm-up; rank 0
    saves the posteriors, every rank its launches and wall."""
    import torch
    from lstm_rnn_tpu_torch import cli
    frac = _stream_fraction(torch, SEED + 37)
    w = wrappers()
    out = {}
    for name in ("float32", "bfloat16"):
        net = streaming_network(SEED, compute_dtype=name)
        params = net.device_params(group.device)
        with torch.inference_mode():
            cli._apply_block(net, params, frac, group, CHUNK, B_STREAM)
            torch.cuda.synchronize()
            for f in w.values():
                f.launches = 0  # the rank's streamed fraction starts here
            t0 = time.perf_counter()
            y = cli._apply_block(net, params, frac, group, CHUNK, B_STREAM)
            torch.cuda.synchronize()
        out[name] = dict(y=None if y is None else y.cpu(),
                         wall=time.perf_counter() - t0,
                         launches={k: f.launches for k, f in w.items()})
    torch.save(out, os.path.join(workdir, f"dpstream_rank{group.rank}.pt"))


def dp_streaming_on_one_card(torch, workdir):
    """Phase 37b: two DP streaming ranks on cuda:0 over gloo stream 32 of
    the 64 streams each (stream_batch's T = 512, every eighth stream
    ending early) through the streaming stack in 64-frame chunks, f32 and
    bf16, against the one-process streamed forward of all 64 (phase 15's
    `stream`): the gathered posteriors within STREAM_TOL, the last LSTM
    layer's rows the same kernels' on fewer rows; each rank's exact
    launches (5 carry launches a chunk, nothing else). Returns a rank's
    launches (f32)."""
    from lstm_rnn_tpu_torch.parallel.launch import start
    t0 = time.perf_counter()
    start(_dp_stream_worker, [torch.device("cuda", 0)] * 2, (workdir,),
          backend="gloo")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(workdir, f"dpstream_rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    x, pt = stream_batch(torch, SEED + 37)
    chunks = -(-T_STREAM // CHUNK)
    for name in ("float32", "bfloat16"):
        net = streaming_network(SEED, compute_dtype=name)
        params = net.device_params("cuda")
        with torch.inference_mode():
            stream(net, params, x, pt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y1 = stream(net, params, x, pt)
            torch.cuda.synchronize()
            wall1 = time.perf_counter() - t1
        y = ranks[0][name]["y"].cuda()
        diff = (y - y1).abs().max().item()
        expect = {k: 0 for k in ranks[0][name]["launches"]
                  if not k.startswith("gemm:")}
        expect["lstm_fwd_carry"] = 5 * chunks
        for rank in ranks:
            check_counts(rank[name]["launches"], expect,
                         bf16=name == "bfloat16")
        phase("dpstream-card", f"{name}: 2 ranks x {DPSTREAM_ROWS} streams "
              f"on cuda:0 (gloo), {chunks} chunks of {CHUNK} frames: "
              f"posteriors vs one process's {B_STREAM} streams max diff "
              f"{diff:.3e} (tol {STREAM_TOL:.0e}), bit-identical: "
              f"{torch.equal(y, y1)}; rank launches "
              + str({k: v for k, v in ranks[0][name]['launches'].items()
                     if v})
              + f"; the streamed fraction {ranks[0][name]['wall']:.3f} s "
              f"on rank 0 (both ranks sharing the card) against "
              f"{wall1:.3f} s in one process (workers {wall:.1f} s wall)")
        if not (y.shape == y1.shape and torch.isfinite(y).all()
                and diff <= STREAM_TOL):
            raise AssertionError(f"DP streaming differs from one process "
                                 f"({name}): {diff}")
    return ranks[0]["float32"]["launches"]


def _mesh_sync(torch, group):
    """Synchronise every GPU of a rank's seq mesh (its device alone
    without one), then the ranks."""
    import torch.distributed as dist
    for dev in set(group.seq_mesh or (group.device,)):
        torch.cuda.synchronize(dev)
    dist.barrier()


def _dpsp_rates_worker(group, out_path):
    """Phase 38d on one rank: the recipe step (T = 500, B = 50 over the
    ranks: parallel_sequences 50) f32 and bf16, Trainer(data_group=) with
    the rank's seq mesh if it has one; mean of 5 after a warm-up, the
    ranks synchronised before and after; rank 0 writes the times."""
    import json as _json
    import torch
    out = {}
    mesh = list(group.seq_mesh) if group.seq_mesh else None
    for label, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        tr = make_trainer("auto", dtype, seq_mesh=mesh, data_group=group)
        batch = rank_block(torch, dp_batch(B, S_STATES, seed=38), group)
        tr.train_step(*batch)
        _mesh_sync(torch, group)
        t0 = time.perf_counter()
        for _ in range(5):
            tr.train_step(*batch)
        _mesh_sync(torch, group)
        out[label] = 1e3 * (time.perf_counter() - t0) / 5
        del tr, batch
        torch.cuda.empty_cache()
    if group.rank == 0:
        with open(out_path, "w") as f:
            _json.dump(out, f)


def _dp_stream_rates_worker(group, out_path):
    """Phase 38e on one rank: the rank's block of 64 full streams (T =
    512) through the streaming stack in 64-frame chunks, f32 and bf16:
    the whole stream 3 times (the ranks synchronised before and after),
    then chunk by chunk, each chunk synchronised (a stream's wait for its
    chunk's posteriors); rank 0 writes the times."""
    import json as _json
    import torch
    import torch.distributed as dist
    from lstm_rnn_tpu_torch.parallel.data import local_block
    rng = np.random.RandomState(SEED + 38)
    x = local_block(torch.from_numpy(rng.randn(
        T_STREAM, B_STREAM, 117).astype(np.float32)), group.rank,
        group.size).contiguous().to(group.device)
    pt = torch.ones(T_STREAM, x.shape[1], dtype=torch.int8,
                    device=group.device)
    out = {}
    for name in ("float32", "bfloat16"):
        net = streaming_network(SEED, compute_dtype=name)
        params = net.device_params(group.device)
        with torch.inference_mode():
            stream(net, params, x, pt)
            _mesh_sync(torch, group)
            t0 = time.perf_counter()
            for _ in range(3):
                stream(net, params, x, pt)
            _mesh_sync(torch, group)
            wall = (time.perf_counter() - t0) / 3
            state = net.init_stream_state(x.shape[1], group.device)
            lat = []
            for lo in range(0, T_STREAM, CHUNK):
                t1 = time.perf_counter()
                _, state = net.apply_streaming(params, x[lo:lo + CHUNK],
                                               pt[lo:lo + CHUNK], state)
                torch.cuda.synchronize(group.device)
                lat.append(1e3 * (time.perf_counter() - t1))
            dist.barrier()
        out[name] = dict(frames_s=T_STREAM * B_STREAM / wall,
                         chunk_ms=float(np.mean(lat)),
                         chunk_ms_min=float(min(lat)))
    if group.rank == 0:
        with open(out_path, "w") as f:
            _json.dump(out, f)


def dp_sp_cli(torch, workdir, n):
    """Phase 38a-c on n >= 4 GPUs over NCCL: the CLI's --num_devices 4
    --seq_devices 2 (2 ranks, each a 2-GPU seq mesh) on phase 7's corpus
    for 2 epochs against --seq_devices 2 on 2 GPUs (the same route: the
    weights and the epoch table within DP_CLI_TOL) and against one GPU
    (the epoch table); two CLI processes with the multi-host flags and
    --seq_devices 2, each seeing 2 GPUs, against --num_devices 4
    --seq_devices 2; forward mode --num_devices 4 --seq_devices 2 over
    phase 5's corpus against one GPU (STREAM_TOL); and DP streaming,
    --stream_chunk 64 --num_devices 2 and 4 with the streaming stack
    against --stream_chunk 64 on one GPU (STREAM_TOL)."""
    paths, net_path = write_train_corpus(workdir)
    train = ["--network", net_path, "--train", "true", "--train_file",
             paths["train"][0], "--val_file", paths["val"][0],
             "--truncate_seq", "500", "--parallel_sequences", "50",
             "--stochastic", "true", "--shuffle_fractions", "true",
             "--learning_rate", "1e-4", "--momentum", "0.9", "--max_epochs",
             "2", "--random_seed", str(SEED)]
    runs = {}
    for label, extra in (("dpsp", ["--num_devices", "4", "--seq_devices",
                                   "2"]),
                         ("sp2", ["--seq_devices", "2"]), ("one", [])):
        d = os.path.join(workdir, f"dpsp_train_{label}")
        t0 = time.perf_counter()
        out = finish(cli_process(train + extra, d), f"cli {label}")
        runs[label] = (d, out, time.perf_counter() - t0)
        for ln in _table_rows(out):
            phase("dpsp-cli", f"{' '.join(extra) or 'one GPU'} |{ln}")
    if "DP x SP mesh: {'data': 2, 'seq': 2}" not in runs["dpsp"][1]:
        raise AssertionError("the DP x SP run's banner")
    w = {k: _weights(os.path.join(d, "trained_network.jsn"))
         for k, (d, _, _) in runs.items()}
    rel = _flat_rel(w["dpsp"], w["sp2"])
    tables = {k: _rows_close(_table_rows(runs["dpsp"][1]),
                             _table_rows(runs[k][1])) for k in ("sp2", "one")}
    phase("dpsp-cli", f"train --num_devices 4 --seq_devices 2 vs "
          f"--seq_devices 2 ({runs['dpsp'][2]:.1f} s vs "
          f"{runs['sp2'][2]:.1f} s wall; one GPU {runs['one'][2]:.1f} s): "
          f"weights rel {rel:.2e} (tol {DP_CLI_TOL:.0e}); epoch errors to "
          f"the table's digits: vs --seq_devices 2 {tables['sp2']}, vs one "
          f"GPU {tables['one']}; vs one GPU's weights rel "
          f"{_flat_rel(w['dpsp'], w['one']):.2e} (another route: K6b and "
          "the unfused tail against K1/K2 and K3)")
    if not (rel <= DP_CLI_TOL and all(tables.values())):
        raise AssertionError("DP x SP training differs")
    port = _free_port()
    procs = []
    for i in range(2):
        env = dict(os.environ, CUDA_VISIBLE_DEVICES=f"{2 * i},{2 * i + 1}")
        procs.append(cli_process(train + [
            "--seq_devices", "2", "--coordinator_address",
            f"127.0.0.1:{port}", "--num_processes", "2", "--process_id",
            str(i)], os.path.join(workdir, f"dpsp_mh{i}"), env))
    t0 = time.perf_counter()
    outs = [finish(p, f"multi-host DP x SP process {i}")
            for i, p in enumerate(procs)]
    mh_wall = time.perf_counter() - t0
    if "DP x SP mesh: {'data': 2, 'seq': 2}" not in outs[0] or os.listdir(
            os.path.join(workdir, "dpsp_mh1")):
        raise AssertionError("the multi-host DP x SP run's banner or files")
    rel = _flat_rel(_weights(os.path.join(workdir, "dpsp_mh0",
                                          "trained_network.jsn")),
                    w["dpsp"])
    phase("dpsp-cli", f"train, 2 processes x 2 GPUs with --seq_devices 2 "
          f"and the multi-host flags ({mh_wall:.1f} s wall) vs --num_devices "
          f"4 --seq_devices 2: weights rel {rel:.2e} (tol {DP_CLI_TOL:.0e}); "
          "process 1 wrote nothing")
    if not rel <= DP_CLI_TOL:
        raise AssertionError("multi-host DP x SP training differs")
    nc, net_path, tags, lengths = write_inputs(workdir)
    outs = {}
    for label, extra in (("dpsp", ["--num_devices", "4", "--seq_devices",
                                   "2"]), ("one", [])):
        d = os.path.join(workdir, f"dpsp_ff_{label}")
        t0 = time.perf_counter()
        finish(cli_process(["--network", net_path, "--train", "false",
                            "--ff_input_file", nc, "--parallel_sequences",
                            "50", "--ff_output_format", "htk",
                            "--ff_output_file", d, *extra],
                           d + "_cwd"), f"forward {label}")
        outs[label] = (read_outputs(d, tags, lengths)[0],
                       time.perf_counter() - t0)
    diff = max(float(np.abs(a - b).max())
               for a, b in zip(outs["dpsp"][0], outs["one"][0]))
    phase("dpsp-cli", f"forward --num_devices 4 --seq_devices 2 vs one GPU "
          f"({outs['dpsp'][1]:.1f} s vs {outs['one'][1]:.1f} s wall): max "
          f"|p - p_1| = {diff:.3e} (tol {STREAM_TOL:.0e})")
    if not diff <= STREAM_TOL:
        raise AssertionError(f"DP x SP serving differs: {diff}")
    uni = os.path.join(workdir, "streaming.jsn")
    streaming_network(SEED).save(uni)
    outs = {}
    for k in (1, 2, 4):
        d = os.path.join(workdir, f"dpstream_ff{k}")
        t0 = time.perf_counter()
        text = finish(cli_process(
            ["--network", uni, "--train", "false", "--ff_input_file", nc,
             "--parallel_sequences", "64", "--ff_output_format", "htk",
             "--ff_output_file", d, "--stream_chunk", str(CHUNK),
             "--num_devices", str(k)], d + "_cwd"), f"streaming {k}")
        if k > 1 and (f"Data-parallel streaming mesh: {{'data': {k}}}"
                      not in text):
            raise AssertionError("the DP streaming run's banner")
        outs[k] = (read_outputs(d, tags, lengths)[0],
                   time.perf_counter() - t0)
    for k in (2, 4):
        diff = max(float(np.abs(a - b).max())
                   for a, b in zip(outs[k][0], outs[1][0]))
        phase("dpsp-cli", f"streaming forward --stream_chunk {CHUNK} "
              f"--num_devices {k} vs one GPU ({outs[k][1]:.1f} s vs "
              f"{outs[1][1]:.1f} s wall): max |p - p_1| = {diff:.3e} (tol "
              f"{STREAM_TOL:.0e})")
        if not diff <= STREAM_TOL:
            raise AssertionError(f"DP streaming differs: {diff}")


def dp_sp_rates(torch, card, workdir, n):
    """Phase 38d-e on n >= 4 GPUs: training frames/s of the recipe step at
    parallel_sequences 50, f32 and bf16, on one GPU, 1-D SP on 4 GPUs (one
    process), DP x SP 2 x 2 and DP on 4 (worker processes over NCCL); and
    streaming frames/s and a chunk's latency of 64 streams (T = 512,
    64-frame chunks) on 1, 2 and 4 GPUs (B = 64, 32, 16 a GPU)."""
    from lstm_rnn_tpu_torch.parallel.launch import start
    batch, frames = recipe_batch(torch)
    gpus = [torch.device("cuda", j) for j in range(4)]
    rates = {}
    for label, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        for name, mesh in (("one GPU", None), ("--seq_devices 4", gpus)):
            tr = make_trainer("auto", dtype, seq_mesh=mesh)
            tr.train_step(*batch)
            sync_all(torch)
            t0 = time.perf_counter()
            for _ in range(5):
                tr.train_step(*batch)
            sync_all(torch)
            rates[(label, name)] = 1e3 * (time.perf_counter() - t0) / 5
            del tr
    for name, devices in (("--num_devices 4 --seq_devices 2",
                           [gpus[:2], gpus[2:]]),
                          ("--num_devices 4", gpus)):
        path = os.path.join(workdir, "dpsp_rates.json")
        start(_dpsp_rates_worker, devices, (path,))
        with open(path) as f:
            for label, ms in json.load(f).items():
                rates[(label, name)] = ms
    for label in ("f32", "bf16"):
        one = rates[(label, "one GPU")]
        for name in ("one GPU", "--seq_devices 4",
                     "--num_devices 4 --seq_devices 2", "--num_devices 4"):
            ms = rates[(label, name)]
            phase("dpsp-rate", f"TIMIT {label} train step, "
                  f"parallel_sequences 50, {name}: {1e3 * frames / ms:,.0f} "
                  f"frames/s ({ms:.2f} ms a step, mean of 5; {one / ms:.2f}x "
                  f"one GPU) on {card}")
    srates = {}
    x = torch.from_numpy(np.random.RandomState(SEED + 38).randn(
        T_STREAM, B_STREAM, 117).astype(np.float32)).cuda()
    pt = torch.ones(T_STREAM, B_STREAM, dtype=torch.int8, device="cuda")
    for name in ("float32", "bfloat16"):
        net = streaming_network(SEED, compute_dtype=name)
        params = net.device_params("cuda")
        with torch.inference_mode():
            stream(net, params, x, pt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                stream(net, params, x, pt)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3
            state = net.init_stream_state(B_STREAM, "cuda")
            lat = []
            for lo in range(0, T_STREAM, CHUNK):
                t1 = time.perf_counter()
                _, state = net.apply_streaming(params, x[lo:lo + CHUNK],
                                               pt[lo:lo + CHUNK], state)
                torch.cuda.synchronize()
                lat.append(1e3 * (time.perf_counter() - t1))
        srates[(name, 1)] = dict(frames_s=T_STREAM * B_STREAM / wall,
                                 chunk_ms=float(np.mean(lat)),
                                 chunk_ms_min=float(min(lat)))
    for k in (2, 4):
        path = os.path.join(workdir, "dpstream_rates.json")
        start(_dp_stream_rates_worker, gpus[:k], (path,))
        with open(path) as f:
            for name, r in json.load(f).items():
                srates[(name, k)] = r
    for (name, k), r in sorted(srates.items()):
        one = srates[(name, 1)]["frames_s"]
        phase("dpsp-rate", f"streaming {name}, {B_STREAM} streams on {k} "
              f"GPU(s) ({B_STREAM // k} a GPU): {r['frames_s']:,.0f} "
              f"frames/s ({r['frames_s'] / one:.2f}x one GPU, mean of 3); "
              f"a {CHUNK}-frame chunk {r['chunk_ms']:.3f} ms host wall "
              f"(min {r['chunk_ms_min']:.3f}, rank 0) on {card}")
    return rates, srates


# ----------------------------------------------------- the data feed (39)
def _table_errors(rows):
    """An epoch table's rows without their duration and throughput (and
    cache) columns: what two runs of the same updates print alike."""
    return ["|".join(c for i, c in enumerate(r.split("|"))
                     if i not in (1, 6)) for r in rows]


def native_runtime():
    """39a: the native runtime (the fraction assembly and the JSON
    formatter), built with this host's g++ at its first use in this
    process; a failed build, or a library without either entry point,
    fails the run."""
    from lstm_rnn_tpu_torch import runtime
    lib = runtime.load()
    entries = [name for name in ("lrt_assemble_fraction",
                                 "lrt_format_f64_json")
               if hasattr(lib, name)]
    built = (f"built with g++ in {runtime.build_seconds:.2f} s"
             if runtime.build_seconds is not None else
             "loaded (built before this process)")
    phase("dispatch", f"native runtime "
          f"{os.path.relpath(runtime.library_path(), REPO)}: {built}; "
          f"entry points {entries}")
    if len(entries) != 2:
        raise AssertionError(f"the native runtime lacks an entry point: "
                             f"it has {entries}")


def autosave_native_vs_python(workdir, meanwhile):
    """39f: the LVCSR autosave's dump through the native formatter, its
    seconds beside the 19.7 s a pure-Python dump of it took on an H100
    at 700 W (PERF.md), and its bytes against the pure-Python dump of the
    same autosave, which runs after meanwhile() has started what it
    starts (returned): its seconds are not a measurement."""
    import filecmp
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch import io_currennt as ioc
    from lstm_rnn_tpu_torch.config import parse_config
    from lstm_rnn_tpu_torch.models.flagship import build_lvcsr_network
    from lstm_rnn_tpu_torch.trainer import Trainer
    cfg = parse_config([os.path.join(LVCSR_DIR, "config.cfg"), "--network",
                        os.path.join(LVCSR_DIR, "network.jsn"),
                        "--autosave_prefix", os.path.join(workdir, "dump")])
    net = build_lvcsr_network(seed=SEED)
    tr = Trainer(net, None)
    saver = cli._save_autosave(cfg, net, tr, "rows")
    cli._join_saver(saver)
    native_s, path = saver.seconds, saver.path
    os.replace(path, path + ".native")
    started = meanwhile()
    dump = ioc.dump_doc_json
    ioc.dump_doc_json = ioc.dump_doc_json_python
    try:
        saver = cli._save_autosave(cfg, net, tr, "rows")
        cli._join_saver(saver)
    finally:
        ioc.dump_doc_json = dump
    same = filecmp.cmp(path, path + ".native", shallow=False)
    phase("dispatch", f"LVCSR autosave ({os.path.getsize(path) / 2**20:.0f}"
          f" MiB): JSON dump {native_s:.2f} s native (pure Python on an "
          f"H100 at 700 W: 19.7 s); the pure-Python dump of it (beside a "
          f"kernel build) {saver.seconds:.1f} s, bytes "
          f"{'equal' if same else 'DIFFER'}")
    os.remove(path)
    os.remove(path + ".native")
    if not same:
        raise AssertionError("the native autosave's bytes differ from the "
                             "pure-Python dump's")
    return started


def _child(args, cwd):
    """cli.main(args) in a child process that then prints where the kernel
    library and the native runtime are and whether it built the kernels
    (`BUILD <seconds or None> <kernels> <runtime>`)."""
    code = ("import sys\n"
            "from lstm_rnn_tpu_torch import cli, runtime\n"
            "from lstm_rnn_tpu_torch.ops import _build\n"
            "rc = cli.main(sys.argv[1:])\n"
            "print('BUILD', _build.build_seconds, _build.library_path(), "
            "runtime.library_path())\n"
            "sys.exit(rc)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    os.makedirs(cwd, exist_ok=True)
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=cwd,
                            env=env, text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)


def _build_line(out, what):
    line = [ln for ln in out.splitlines() if ln.startswith("BUILD ")]
    if not line:
        print(out[-3000:])
        raise AssertionError(f"{what}: no BUILD line")
    _, seconds, kernels, native = line[-1].split(" ")
    return (None if seconds == "None" else float(seconds)), kernels, native


def dispatch_cli(torch, workdir):
    """39b-d: cli.main on phase 7's corpus (TIMIT recipe, f32, 3 epochs,
    --bucket_lengths true so that same-shape runs form) without the
    dispatch flags, with --device_cache true, and with --fuse_fractions 4
    --profile_dir (the step graphs, captured in the profiled epoch 1): the
    tables' errors, trained_network.jsn and the exact launches alike; the
    fused run's warm-ups, captures and replays; every lookup of epochs 2-3
    a hit and no byte copied from the host in their passes; the trace
    names the kernels. Returns the launches of the plain run."""
    import contextlib
    import io
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.trainer import Trainer
    paths, net_path = write_train_corpus(workdir)
    (train_nc, _), (val_nc, _) = paths["train"], paths["val"]
    n_train = DataSet([train_nc], parallel_sequences=50,
                      trunc_seq_length=500).num_fractions()
    n_val = DataSet([val_nc], parallel_sequences=50).num_fractions()
    epochs = 3
    expect = {"lstm_fwd": 5 * n_val * epochs,
              "lstm_fwd_save": 5 * n_train * epochs,
              "lstm_bwd": 5 * n_train * epochs,
              "softmax_ce_proj_fwd": (n_train + n_val) * epochs,
              "softmax_ce_proj_bwd": n_train * epochs,
              "softmax_ce_wide_fwd": 0, "softmax_ce_wide_bwd": 0,
              "lstm_fwd_carry": 0, "lstm_fwd_carry_save": 0,
              "lstm_bwd_carry": 0, "softmax_ce_fwd": 0, "softmax_ce_bwd": 0}
    made = []

    class Recording(Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    prof_dir = os.path.join(workdir, "dispatch_trace")
    runs = {}
    for label, extra in (("plain", []),
                         ("cache", ["--device_cache", "true"]),
                         ("fuse", ["--fuse_fractions", "4", "--profile_dir",
                                   prof_dir])):
        out = os.path.join(workdir, f"dispatch_{label}.jsn")
        args = ["--network", net_path, "--train", "true",
                "--train_file", train_nc, "--val_file", val_nc,
                "--truncate_seq", "500", "--parallel_sequences", "50",
                "--hybrid_online_batch", "true", "--shuffle_fractions",
                "true", "--bucket_lengths", "true", "--learning_rate", "1e-4",
                "--momentum", "0.9", "--max_epochs", str(epochs),
                "--random_seed", str(SEED), "--save_network", out, *extra]
        w = wrappers()
        for f in w.values():
            f.launches = 0  # this run of the path starts here
        buf = io.StringIO()
        cli.Trainer = Recording
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(args)
            wall = time.perf_counter() - t0
        finally:
            cli.Trainer = Trainer
        counts = graph_executed(made[-1],
                                {k: f.launches for k, f in w.items()})
        text = buf.getvalue()
        rows = _table_rows(text)
        for ln in rows:
            phase("dispatch", f"{label} |{ln}")
        if rc != 0 or len(rows) != epochs:
            print(text[-3000:])
            raise AssertionError(f"cli --train true ({label}) returned {rc}")
        check_counts(counts, expect)
        with open(out, "rb") as f:
            runs[label] = (rows, f.read(), counts, made[-1])
        phase("dispatch", f"{label}: {wall:.1f} s wall; bytes copied from "
              f"the host a pass (train, val; by epoch) "
              f"{made[-1].h2d_bytes}; launches as expected")
    plain = runs["plain"]
    for label in ("cache", "fuse"):
        rows, blob, counts, tr = runs[label]
        if _table_errors(rows) != _table_errors(plain[0]):
            raise AssertionError(f"{label}: the epoch table's errors differ")
        if blob != plain[1]:
            raise AssertionError(f"{label}: trained_network.jsn differs")
        if counts != plain[2]:
            raise AssertionError(f"{label}: other launches {counts}")
    rows, _, _, tr = runs["cache"]
    brackets = [r[r.index("[cache"):] if "[cache" in r else "" for r in rows]
    for e, b in enumerate(brackets[1:], start=2):
        hits, looks = b.split()[1].split("/")
        if hits != looks or int(looks) != n_train + n_val:
            raise AssertionError(f"epoch {e}: {b}")
    if tr.h2d_bytes[2:] != [0] * (2 * (epochs - 1)) or tr.h2d_bytes[0] <= 0:
        raise AssertionError(f"bytes copied with the cache: {tr.h2d_bytes}")
    phase("dispatch", f"--device_cache true: tables' errors and "
          f"trained_network.jsn bit for bit the plain run's; brackets "
          f"{brackets}; epochs 2-3 copy 0 bytes from the host")
    fused = runs["fuse"][3]
    st = fused.graph_stats.as_dict()
    want = expected_graphs(fused, epochs)
    got = (st["warmups"], st["captures"], st["replays"])
    if got != want or st["eager"]:
        raise AssertionError(f"--fuse_fractions 4: (warm-ups, captures, "
                             f"replays) {got}, eager {st['eager']}; want "
                             f"{want}")
    phase("dispatch", f"--fuse_fractions 4 (the step graphs, the cache "
          f"off: the grouped route): trained_network.jsn bit for bit the "
          f"plain run's, launches equal ({runs['fuse'][2]['lstm_bwd']} K2, "
          f"{runs['fuse'][2]['softmax_ce_proj_bwd']} K3b: the wrappers' "
          f"counts with each capture's launches counted once a replay); "
          f"warm-ups {got[0]}, captures {got[1]} (one a mode and shape "
          f"used twice), replays {got[2]} (the steps less the warm-ups), "
          f"the captures under the profiler; staging buffers allocated "
          f"{fused._staging.allocations}")
    trace = os.path.join(prof_dir, "trace_rank0.json")
    with open(trace) as f:
        doc = json.load(f)
    names = {ev.get("name", "") for ev in doc["traceEvents"]}
    missing = [k for k in ("rec_kernel", "bptt_kernel", "ce_fwd_kernel",
                           "gemm_kernel") if not any(k in n for n in names)]
    phase("dispatch", f"--profile_dir: {os.path.getsize(trace) / 2**20:.1f} "
          f"MiB Chrome trace of epoch 1, {len(doc['traceEvents'])} events; "
          f"kernels missing: {missing or 'none'}")
    if missing:
        raise AssertionError(f"the trace names no {missing}")
    return train_nc, val_nc, net_path


def dispatch_sets(train_nc, val_nc, use_native=None, prefetch=True):
    """Phase 7's corpus as the TIMIT recipe's train (truncated at 500
    frames, shuffled fractions) and val DataSets, with length buckets."""
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    kw = {"parallel_sequences": 50, "sort_by_length": True,
          "bucket_lengths": True, "use_native": use_native,
          "prefetch": prefetch}
    return (DataSet([train_nc], trunc_seq_length=500,
                    fraction_shuffling=True, seed=SEED, **kw),
            DataSet([val_nc], **kw))


def dispatch_trainer(train_nc, val_nc, cache, use_native=None,
                     cache_bytes=None, trainer_cls=None):
    from lstm_rnn_tpu_torch.models.flagship import build_timit_network
    from lstm_rnn_tpu_torch.trainer import Trainer
    train, val = dispatch_sets(train_nc, val_nc, use_native)
    return (trainer_cls or Trainer)(
        build_timit_network(seed=SEED), train, val, learning_rate=1e-4,
        momentum=0.9, hybrid_online_batch=True, device="cuda",
        device_cache=cache, device_cache_bytes=cache_bytes)


def compilation_cache_children(workdir, nc, net_path, first):
    """39e: a second child given the same fresh --compilation_cache_dir as
    the first (started earlier): the first built the kernel library
    there, the second loads it without building; both place the native
    runtime there too (the first builds it for its DataSet's native
    fraction assembly)."""
    cache = os.path.join(workdir, "compile_cache")
    outs = []
    for i, p in enumerate((first, None)):
        if p is None:
            p = _child(_child_args(workdir, nc, net_path, 1), os.path.join(
                workdir, "child1"))
        outs.append(_build_line(finish(p, f"child {i}", 900),
                                f"child {i}"))
    (s0, k0, n0), (s1, k1, n1) = outs
    files = sorted(os.listdir(cache))
    phase("dispatch", f"--compilation_cache_dir: child 0 built the kernels "
          f"in {s0} s into {os.path.relpath(k0, workdir)}, child 1 built "
          f"{'nothing' if s1 is None else f'again ({s1} s)'}; the directory "
          f"holds {files}")
    for k, n in ((k0, n0), (k1, n1)):
        if os.path.dirname(k) != cache or os.path.dirname(n) != cache:
            raise AssertionError(f"a library outside {cache}: {k}, {n}")
    if s0 is None or s1 is not None or k0 != k1:
        raise AssertionError("the compile cache was not built once and "
                             "then loaded")
    if os.path.basename(k0) not in files:
        raise AssertionError(f"{cache} lacks the kernel library: {files}")
    if os.path.basename(n0) not in files:
        raise AssertionError(f"{cache} lacks the native runtime: {files}")
    with open(os.path.join(workdir, "child0.csv"), "rb") as a, \
            open(os.path.join(workdir, "child1.csv"), "rb") as b:
        if a.read() != b.read():
            raise AssertionError("the two children served other outputs")


def _child_args(workdir, nc, net_path, i):
    return ["--network", net_path, "--train", "false", "--ff_input_file", nc,
            "--parallel_sequences", "50", "--ff_output_format", "single_csv",
            "--ff_output_file", os.path.join(workdir, f"child{i}.csv"),
            "--compilation_cache_dir", os.path.join(workdir, "compile_cache")]


def _staging_views(torch, layout):
    """Numpy views of a pinned buffer in the Trainer's staging layout
    (trainer.py `_stage`: each array 64-byte aligned)."""
    offsets, total = [], 0
    for dt, shape in layout:
        total = -(-total // 64) * 64
        offsets.append(total)
        total += int(np.prod(shape)) * dt.itemsize
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=True).numpy()
    return [buf[o:o + int(np.prod(shape)) * dt.itemsize].view(dt).reshape(
        shape) for (dt, shape), o in zip(layout, offsets)]


def feed_native(torch, card, train_nc, val_nc, reps=3):
    """39h: the native fraction assembly against the NumPy one on phase
    7's corpus, on this host: every fraction of the train and val sets
    byte for byte (arrays, seq_info, keys), also assembled straight into
    pinned staging views as the Trainer does on a device-cache miss
    (LazyFraction.assemble_into); then the mean ms to assemble one
    fraction each way (NumPy, native, NumPy then its copy into the pinned
    views, native into them), over reps passes of every fraction."""
    from lstm_rnn_tpu_torch.data.dataset import LazyFraction
    sets = {n: dispatch_sets(train_nc, val_nc, n, prefetch=False)
            for n in (False, True)}
    ms = {k: [] for k in ("numpy", "native", "numpy+copy", "staging")}
    frames = nbytes = count = 0
    for py, nat in zip(sets[False], sets[True]):
        if nat._native is None or py._native is not None:
            raise AssertionError("use_native did not take its path")
        for s in range(0, len(py.sequences), py.parallel_sequences):
            fp, fn = py._make_fraction(s), nat._make_fraction(s)
            lazy = LazyFraction(nat, s, *nat.fraction_meta(s))
            views = _staging_views(torch, lazy.native_layout())
            lazy.assemble_into(*views)
            for a, b, c in zip((fp.inputs, fp.targets, fp.pattypes),
                               (fn.inputs, fn.targets, fn.pattypes), views):
                if not (a.dtype == b.dtype == c.dtype and a.shape == b.shape
                        == c.shape and a.tobytes() == b.tobytes()
                        == c.tobytes()):
                    raise AssertionError(f"fraction {count}: the native "
                                         "bytes differ from NumPy's")
            if fp.seq_info != fn.seq_info or fp.key[1:] != fn.key[1:]:
                raise AssertionError(f"fraction {count}: seq_info or key")
            frames += sum(i["length"] for i in fn.seq_info)
            nbytes += sum(v.nbytes for v in views)
            count += 1

            def copied():
                f = py._make_fraction(s)
                for v, a in zip(views, (f.inputs, f.targets, f.pattypes)):
                    v[...] = a

            for _ in range(reps):
                for way, run in (
                        ("numpy", lambda: py._make_fraction(s)),
                        ("native", lambda: nat._make_fraction(s)),
                        ("numpy+copy", copied),
                        ("staging", lambda: lazy.assemble_into(*views))):
                    t0 = time.perf_counter()
                    run()
                    ms[way].append(1e3 * (time.perf_counter() - t0))
    means = {k: float(np.mean(v)) for k, v in ms.items()}
    phase("dispatch", f"native fractions: {count} fractions ({frames} "
          f"frames) of phase 7's train and val sets byte for byte the "
          f"NumPy ones (arrays, seq_info, keys), and assembled into pinned "
          f"staging views too; mean ms a fraction "
          f"({nbytes / count / 2**20:.2f} MiB each on average, {reps} "
          f"passes): "
          + ", ".join(f"{k} {v:.3f}" for k, v in means.items())
          + f" ({card})")
    return means


# the feed's variants in 39g: (label, use_native, device cache, native
# assembly into the staging buffer on a miss); "half" is a budget that
# admits about half of the fractions' bytes, so that every epoch misses
# on the rest
FEED_VARIANTS = (("numpy, cache off", False, "off", True),
                 ("native, cache off", True, "off", True),
                 ("numpy, cache half", False, "half", True),
                 ("native copied, cache half", True, "half", False),
                 ("staging, cache half", True, "half", True),
                 ("native, cache on", True, "all", True))


def dispatch_rates(torch, card, train_nc, val_nc, timed=3):
    """39g: the feed's variants (FEED_VARIANTS) on phase 7's corpus with
    length buckets, f32, in two rounds, the second in reverse order: epoch
    2's frames/s (training frames over the epoch's wall, train and val
    passes, as the CLI counts) and epochs 2..timed+1's; in the first round
    the device's busy share over one more epoch (profiler). The trained
    parameters of every variant are bit for bit the first's, the half
    budget hits and misses in every later epoch, and the staging variant
    assembles every miss into the staging buffer. Returns {label: [epoch
    walls of both rounds]}."""
    from torch.profiler import ProfilerActivity, profile
    from lstm_rnn_tpu_torch.data.dataset import LazyFraction
    from lstm_rnn_tpu_torch.trainer import Trainer

    class Copying(Trainer):
        def _native_layout(self, frac):
            return None

    # the cache's bytes of every train and val fraction
    half = sum(int(np.prod(shape)) * dt.itemsize
               for ds in dispatch_sets(train_nc, val_nc, False)
               for s in range(0, len(ds.sequences), ds.parallel_sequences)
               for dt, shape in ds.host_layout(ds.fraction_meta(s)[1])) // 2
    staged = [0]
    orig = LazyFraction.assemble_into

    def counting(self, *views):
        staged[0] += 1
        return orig(self, *views)

    walls = {}
    for rnd, order in enumerate((FEED_VARIANTS, FEED_VARIANTS[::-1])):
        ref = None
        for label, native, cache, stage in order:
            tr = dispatch_trainer(
                train_nc, val_nc, cache != "off", native,
                half if cache == "half" else None,
                None if stage else Copying)
            frames = tr.train_set.total_timesteps
            tr.train_epoch()
            staged[0] = 0
            LazyFraction.assemble_into = counting
            try:
                ws, stats = [], []
                for _ in range(timed):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tr.train_epoch()
                    torch.cuda.synchronize()
                    ws.append(time.perf_counter() - t0)
                    stats.append(tr.device_cache_stats())
            finally:
                LazyFraction.assemble_into = orig
            busy_txt = ""
            if rnd == 0:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    tr.train_epoch()
                    torch.cuda.synchronize()
                    wall3 = time.perf_counter() - t1
                busy = sum(dev_us(e) for e in prof.key_averages()
                           if str(getattr(e, "device_type", "")).endswith(
                               "CUDA"))
                busy_txt = (f"; one more epoch under the profiler "
                            f"{wall3:.3f} s, device busy {busy / 1e6:.3f} s "
                            f"({100 * busy / 1e6 / wall3:.1f}%)")
            walls.setdefault(label, []).extend(ws)
            misses = sum(st["misses"] for st in stats)
            phase("dispatch", f"rates {label} (round {rnd + 1}): epoch 2 "
                  f"{ws[0]:.4f} s, {frames / ws[0]:,.0f} frames/s; epochs "
                  f"2-{timed + 1} {[round(w, 4) for w in ws]}; lookups "
                  f"hit/miss {[(st['hits'], st['misses']) for st in stats]}"
                  f", staged {staged[0]}; bytes from the host epoch 2 "
                  f"{tr.h2d_bytes[2:4]}{busy_txt} ({card})")
            if cache == "half" and not all(st["hits"] and st["misses"]
                                           for st in stats):
                raise AssertionError(f"{label}: the half budget did not "
                                     f"hit and miss: {stats}")
            want_staged = misses if stage and native and cache != "off" \
                else 0
            if staged[0] != want_staged:
                raise AssertionError(f"{label}: {staged[0]} fractions "
                                     f"staged natively, not {want_staged}")
            leaves = [v.detach().clone() for v in tr._leaves(tr.params)]
            if ref is None:
                ref = (label, leaves)
            elif not all(torch.equal(a, b) for a, b in zip(ref[1], leaves)):
                raise AssertionError(f"{label}: trained parameters differ "
                                     f"from {ref[0]}'s")
            del tr
            torch.cuda.empty_cache()
    for label, ws in walls.items():
        phase("dispatch", f"rates {label}: epoch walls of both rounds, "
              f"median {statistics.median(ws):.4f} s, min {min(ws):.4f}, "
              f"max {max(ws):.4f} ({card})")
    return walls


def dispatch_phase(torch, card):
    """Phase 39 (the data feed and the dispatch flags)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        nc, net_path, _, _ = write_inputs(workdir)
        native_runtime()
        # 39e's first child builds the kernels (nvcc, ~1 min) while the
        # pure-Python autosave dump and 39b-d run here
        children = []
        try:
            autosave_native_vs_python(workdir, lambda: children.append(
                _child(_child_args(workdir, nc, net_path, 0),
                       os.path.join(workdir, "child0"))))
            train_nc, val_nc, _ = dispatch_cli(torch, workdir)
        except BaseException:
            import signal
            for p in children:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
            raise
        compilation_cache_children(workdir, nc, net_path, children[0])
        feed_native(torch, card, train_nc, val_nc)
        dispatch_rates(torch, card, train_nc, val_nc)
    phase("dispatch", f"phase 39 took {time.perf_counter() - t0:.0f} s")

# --------------------------------------- --f32_matmul 3x (phases 40a-40d)
# the 3x instances against their 3x twins, relative to each output's
# largest entry: f32 sums in another order (the kernel adds the three
# passes into one set of accumulators, the twin adds three finished
# products), and inside each 64-k stage the tensor cores add without
# f32's round to nearest (the engine sums the stages in f32). An H100
# read at most 6.2e-7 at the engine's main-path shapes and 5.2e-6 to
# 1.4e-5 at K4's long reductions (dh over K = 2,049-10,112, K4b's dW over
# splits of 1,024 rows): 3x phase 4/9's f32 bound
THREE_PASS_TWIN_REL = 3e-5
# the 3x products against the exact f32 product (the twin without the
# split, true f32 with TF32 off), relative to each output's largest entry:
# the split drops lo . lo and rounds lo, about 2^-17 of each product's
# size, spread by the sums over K; the 1-pass bf16 product, the control,
# must read above it
THREE_PASS_REL = 2.0 ** -14
# the 3x CLI runs' training and validation errors against the f32 runs'
# (the JAX package's bound, tests/test_end_to_end.py:415-416)
THREE_PASS_EPOCH_REL = 1e-3


@contextlib.contextmanager
def three_pass():
    """--f32_matmul 3x's switch (ops/gemm.py F32_MATMUL_3X) on, restored
    after."""
    from lstm_rnn_tpu_torch.ops import gemm as ge
    before = ge.F32_MATMUL_3X
    ge.F32_MATMUL_3X = True
    try:
        yield
    finally:
        ge.F32_MATMUL_3X = before


def three_pass_bound(cost):
    """(ms, by) of a product in 3x: its f32 bytes at the HBM rate against
    three bf16 passes of its operations at the tensor cores' rate."""
    nbytes, flops = cost
    return bound(nbytes, 3 * flops, "bfloat16")


def device_ms(torch, fn, part, lib=None, reps=10):
    """(ms of fn's kernels, ms of lib's, clock): one profile of both,
    fn's kernels those whose name holds `part` or sum_partials; CUDA
    events (host work included) where the profile misses either."""
    per = prof_ms(torch, [fn] + ([lib] if lib else []), reps)
    ours = {k: v for k, v in per.items()
            if part in k or "sum_partials" in k}
    ms = sum(ours.values())
    lib_ms = sum(v for k, v in per.items() if k not in ours)
    if ms and (lib is None or lib_ms):
        return ms, lib_ms if lib else None, "profiler"
    return (time_ms(torch, fn, reps),
            time_ms(torch, lib, reps) if lib else None, "CUDA events")


def three_pass_engine(torch, gres):
    """Phase 40a: the engine's 3x instance (gemm3x_kernel) at every
    main-path shape of phase 26 against its 3x twin, against the exact f32
    product with the 1-pass bf16 product as the control, a second launch
    bit for bit; its device time beside phase 26's f32 SIMT body and one
    torch call's (TF32 off), and the 3x bound."""
    from lstm_rnn_tpu_torch.ops import gemm as ge
    res = {}
    for name in ge.MAIN_PATH_CASES:
        gen = torch.Generator("cuda").manual_seed(SEED + 40)
        use, a, b, M, N, K, kw = ge.main_path_case(name, torch.float32,
                                                   "cuda", gen)
        got = ge.gemm(use, a, b, M, N, K, x3=True, **kw)
        again = ge.gemm(use, a, b, M, N, K, x3=True, **kw)
        want = ge.gemm_reference(use, a, b, M, N, K, x3=True, **kw)
        exact = ge.gemm_reference(use, a, b, M, N, K, **kw)
        rb = [v._replace(t=v.t.to(torch.bfloat16).float()) for v in a + b]
        ctrl = ge.gemm_reference(use, rb[:len(a)], rb[len(a):], M, N, K,
                                 **kw)
        torch.cuda.synchronize()
        rel, err = rel_err(got, want)
        rel_x, rel_c = rel_err(got, exact)[0], rel_err(ctrl, exact)[0]
        same = torch.equal(got, again)
        del got, again, want, exact, ctrl, rb

        def run():
            return ge.gemm(use, a, b, M, N, K, x3=True, **kw)
        ms, lib_ms, clock = device_ms(
            torch, run, "gemm3x_kernel",
            gemm_library(torch, use, a, b, M, N, K, kw))
        plain = time_ms(torch, lambda: ge.gemm_reference(
            use, a, b, M, N, K, x3=True, **kw), 2)
        cost = gemm_cost(use, a, b, M, N, K, kw, "float32")
        bms, by = three_pass_bound(cost)
        f32 = gres[(name, "float32")]
        res[name] = dict(err=err, rel=rel, rel_exact=rel_x, ms=ms,
                         plain_ms=plain, library_ms=lib_ms, f32_ms=f32["ms"],
                         bound=(bms, by), cost=cost)
        phase("3x", f"engine {name} [M={M} N={N} K={K}]: vs its 3x twin "
              f"rel {rel:.2e} (tol {THREE_PASS_TWIN_REL:.0e}); vs exact f32 "
              f"rel {rel_x:.2e} (bound {THREE_PASS_REL:.1e}; control, the "
              f"1-pass bf16 product, {rel_c:.2e}); repeat bit for bit: "
              f"{same}; {ms:.4f} ms on the device ({clock}; "
              f"{3 * cost[1] / ms / 1e9:.1f} bf16 TFLOP/s), f32 SIMT body "
              f"{f32['ms']:.4f} ms, torch (TF32 off) {fmt_ms(lib_ms)}, "
              f"twin {plain:.3f} ms; 3x bound {bms:.4f} ms ({by}), f32 "
              f"bound {bound(*cost, 'float32')[0]:.4f} ms")
        if not (rel <= THREE_PASS_TWIN_REL and rel_x <= THREE_PASS_REL
                and same):
            raise AssertionError(f"the 3x engine disagrees at {name}")
        if not rel_c > THREE_PASS_REL:
            raise AssertionError(f"the 3x bound passes the 1-pass bf16 "
                                 f"product at {name}: {rel_c}")
        del a, b, kw
        torch.cuda.empty_cache()
    return res


def three_pass_tails(torch, wres):
    """Phase 40b: K4 in 3x at the LVCSR tail (N = 25,000, P = 250, S =
    10,112): the logits (the engine's 3x GemmTailLogits, also at TIMIT's
    S = 183, the 3x route's), K4b's 3x instance and dh (the engine's 3x
    GemmWideDh), each against its 3x twin and against the exact f32
    product with the 1-pass bf16 control, K4b launched twice; device
    times beside phase 9's f32 kernels and one torch call's, and the 3x
    bounds."""
    from lstm_rnn_tpu_torch.ops import softmax_ce as sc
    gen = torch.Generator("cuda").manual_seed(SEED + 41)
    N, P = N_TAIL, 2 * H
    res = {}
    h2 = torch.randn(N, P, device="cuda", generator=gen) * 0.5
    hb = h2.to(torch.bfloat16).float()
    f32 = torch.float32
    for S in (S_STATES, S_LVCSR):
        W = (torch.rand(P, S, device="cuda", generator=gen) - 0.5) * 0.2
        b = (torch.rand(S, device="cuda", generator=gen) - 0.5) * 0.2
        a = sc._launch_wide_logits(h2, W, b, 1.0)
        errs = {"logits": (
            rel_err(a, sc.wide_logits_reference(h2, W, b, 1.0, f32, True)),
            rel_err(a, sc.wide_logits_reference(h2, W, b, 1.0, f32))[0],
            rel_err(sc.wide_logits_reference(hb, W.to(torch.bfloat16)
                                             .float(), b, 1.0, f32),
                    sc.wide_logits_reference(h2, W, b, 1.0, f32))[0])}
        ms, lib, _ = device_ms(
            torch, lambda: sc._launch_wide_logits(h2, W, b, 1.0),
            "gemm3x_kernel", lambda: torch.addmm(b, h2, W))
        cost = (4 * (N * P + P * S + S + N * S), 2 * N * P * S)
        timing = {"logits": (ms, lib, cost)}
        if S == S_LVCSR:
            tc = torch.randint(0, S, (N,), device="cuda", generator=gen,
                               dtype=torch.int32)
            tc[::10] = -1
            tc[:64] = -1
            g = torch.tensor(1.0, device="cuda")
            _, _, off, ssum, pt = sc._launch_wide_fwd(a, tc)

            def k4b():
                return sc._launch_wide_bwd(a, h2, tc, off, ssum, pt, g, 1.0,
                                           x3=True)
            dz, dw, db = k4b()
            again = k4b()
            _, dw_r, db_r = sc.softmax_ce_wide_bwd_reference(
                a, h2, W, tc, off, ssum, pt, g, 1.0, f32, x3=True)
            dz_r = sc.wide_dz_reference(a, tc, off, ssum, pt, g)
            dw_x = torch.matmul(h2.t(), dz_r)
            dw_c = torch.matmul(hb.t(), dz_r.to(torch.bfloat16).float())
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip((dz, dw, db),
                                                          again))
            zero = not dz[:64].any()
            del again
            errs["K4b dW"] = (rel_err(dw, dw_r), rel_err(dw, dw_x)[0],
                              rel_err(dw_c, dw_x)[0])
            dz_rel, db_rel = rel_err(dz, dz_r)[0], rel_err(db, db_r)[0]
            dh = sc._launch_wide_dh(dz, W, f32)
            errs["dh"] = (
                rel_err(dh, sc.wide_dh_reference(dz, W, f32, f32, True)),
                rel_err(dh, sc.wide_dh_reference(dz, W, f32, f32))[0],
                rel_err(sc.wide_dh_reference(dz.to(torch.bfloat16).float(),
                                             W.to(torch.bfloat16).float(),
                                             f32, f32),
                        sc.wide_dh_reference(dz, W, f32, f32))[0])
            per = prof_ms(torch, [k4b], 5)
            # CUDA events beside the profile: a profile that records part
            # of a launch's time (one read half of the step profiles'
            # 1.79 ms) yields to them
            events = time_ms(torch, k4b, 5)
            k4b_ms = sum(per.values())
            if k4b_ms < 0.8 * events:
                k4b_ms = events
            cublas_dw, _, _ = device_ms(
                torch, lambda: torch.matmul(h2.t(), dz), "gemm")
            nbytes, flops = wide_cost("softmax_ce_wide_bwd", "float32")
            timing["K4b dW"] = (k4b_ms, cublas_dw, (nbytes, flops))
            ms, lib, _ = device_ms(
                torch, lambda: sc._launch_wide_dh(dz, W, f32),
                "gemm3x_kernel", lambda: torch.matmul(dz, W.t()))
            timing["dh"] = (ms, lib, (4 * (N * S + P * S + N * P),
                                      2 * N * P * S))
            plain = time_ms(torch, lambda: sc.softmax_ce_wide_bwd_reference(
                a, h2, W, tc, off, ssum, pt, g, 1.0, f32, x3=True), 2)
            f32_k4b = wres[("softmax_ce_wide_bwd", "float32")]
            phase("3x", f"K4b 3x instance [N={N} P={P} S={S}]: dz rel "
                  f"{dz_rel:.2e}, db rel {db_rel:.2e} (tol "
                  f"{THREE_PASS_TWIN_REL:.0e}); dummy tile exactly zero: "
                  f"{zero}; a second launch bit for bit equal: {same}; on "
                  f"the device " + ", ".join(
                      f"{short_key(k)} {v:.4f}" for k, v in per.items())
                  + f"; CUDA events {events:.4f} ms; f32 K4b (phase 9) "
                  f"{f32_k4b['ms']:.4f} ms; cuBLAS's dW alone (TF32 off) "
                  f"{cublas_dw:.4f} ms; twin {plain:.3f} ms")
            if not (dz_rel <= THREE_PASS_TWIN_REL and db_rel
                    <= THREE_PASS_TWIN_REL and same and zero):
                raise AssertionError("K4b's 3x instance disagrees")
            res["softmax_ce_wide_bwd_3x"] = dict(
                err=errs["K4b dW"][0][1], rel=errs["K4b dW"][0][0],
                rel_exact=errs["K4b dW"][1], ms=k4b_ms, plain_ms=plain,
                cublas_dw_ms=cublas_dw, f32_ms=f32_k4b["ms"],
                bound=three_pass_bound((nbytes, flops)),
                cost=(nbytes, flops))
            del dz, dw, db, dz_r, dw_r, db_r, dw_x, dw_c, dh
        for k, ((rel, err), rel_x, rel_c) in errs.items():
            ms, lib, cost = timing[k]
            bms, by = three_pass_bound(cost)
            phase("3x", f"{k} 3x [N={N} P={P} S={S}]: vs its 3x twin rel "
                  f"{rel:.2e} (tol {THREE_PASS_TWIN_REL:.0e}); vs exact f32 "
                  f"rel {rel_x:.2e} (bound {THREE_PASS_REL:.1e}; control "
                  f"{rel_c:.2e}); {ms:.4f} ms on the device, torch (TF32 "
                  f"off) {fmt_ms(lib)}; 3x bound {bms:.4f} ms ({by}), f32 "
                  f"bound {bound(*cost, 'float32')[0]:.4f} ms")
            res[(k, S)] = dict(rel=rel, err=err, rel_exact=rel_x, ms=ms,
                               library_ms=lib, bound=(bms, by))
            if not (rel <= THREE_PASS_TWIN_REL and rel_x <= THREE_PASS_REL):
                raise AssertionError(f"the 3x {k} disagrees at S={S}")
            if not rel_c > THREE_PASS_REL:
                raise AssertionError(f"the 3x bound passes the 1-pass bf16 "
                                     f"{k} at S={S}: {rel_c}")
        del a, W, b
        torch.cuda.empty_cache()
    return res


def three_pass_cli(torch, workdir, tables, lvcsr_tables):
    """Phase 40c: cli.main(--train true --f32_matmul 3x) on phase 7's
    TIMIT corpus and phase 11's LVCSR corpus, 2 epochs each as those
    phases ran f32: the epoch errors within THREE_PASS_EPOCH_REL of the f32
    runs', every kernel's exact launches (the TIMIT tail on the 3x route:
    the engine's 3x logits, K5f and K5b, its 3x tail_dh and tail_dW; no
    K3), the weights moved."""
    import io
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    out = {}
    timit = [os.path.join(workdir, f"timit_{n}.nc") for n in ("train",
                                                              "val")]
    lvcsr = [os.path.join(workdir, f"lvcsr_{n}.nc") for n in ("train",
                                                              "val")]
    runs = (
        ("TIMIT", timit, tables["float32"],
         ["--network", os.path.join(workdir, "network_train.jsn"),
          "--train", "true", "--truncate_seq", "500",
          "--parallel_sequences", "50", "--stochastic", "true",
          "--shuffle_fractions", "true", "--learning_rate", "1e-4",
          "--momentum", "0.9"]),
        ("LVCSR", lvcsr, lvcsr_tables["float32"],
         [os.path.join(LVCSR_DIR, "config.cfg"), "--network",
          os.path.join(LVCSR_DIR, "network.jsn"), "--autosave", "false"]))
    here = os.getcwd()
    for label, (train_nc, val_nc), want, args in runs:
        n_train = DataSet([train_nc], parallel_sequences=50,
                          trunc_seq_length=500).num_fractions()
        n_val = DataSet([val_nc], parallel_sequences=50).num_fractions()
        zero = {k: 0 for k in wrappers() if not k.startswith("gemm:")}
        if label == "TIMIT":
            per_epoch = {**zero, "lstm_fwd": 5 * n_val,
                         "lstm_fwd_save": 5 * n_train,
                         "lstm_bwd": 5 * n_train,
                         "softmax_ce_fwd": n_train + n_val,
                         "softmax_ce_bwd": n_train}
        else:
            per_epoch = {**zero, "lstm_fwd": 5 * n_val,
                         "lstm_fwd_save": 5 * n_train,
                         "lstm_bwd": 5 * n_train,
                         "softmax_ce_wide_fwd": n_train + n_val,
                         "softmax_ce_wide_bwd": n_train,
                         "softmax_ce_wide_bwd_3x": n_train}
        rundir = os.path.join(workdir, f"x3_{label}")
        os.makedirs(rundir)
        w = wrappers()
        for f in w.values():
            f.launches = 0  # the 3x path's run starts here
        buf = io.StringIO()
        os.chdir(rundir)
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(args + [
                    "--train_file", train_nc, "--val_file", val_nc,
                    "--max_epochs", "2", "--random_seed", str(SEED),
                    "--f32_matmul", "3x", "--save_network",
                    os.path.join(rundir, "trained.jsn")])
            wall = time.perf_counter() - t0
        finally:
            os.chdir(here)
        counts = {k: f.launches for k, f in w.items()}
        text = buf.getvalue()
        rows = [ln for ln in text.splitlines()
                if ln.strip()[:1].isdigit() and "|" in ln]
        for ln in rows:
            phase("3x-cli", f"{label} 3x |{ln}")
        if rc != 0 or len(rows) != 2:
            print(text[-3000:])
            raise AssertionError(f"cli --f32_matmul 3x ({label}) returned "
                                 f"{rc}")
        got = epoch_errors(rows)
        # the training and validation errors (cells 1 and 3 of a row)
        worst = max(abs(g[i] - f[i]) / abs(f[i]) for g, f in zip(got, want)
                    for i in (1, 3))
        phase("3x-cli", f"{label}: {wall:.1f} s wall for 2 epochs; errors "
              f"against the f32 run's: max rel {worst:.2e} (tol "
              f"{THREE_PASS_EPOCH_REL:.0e}); launches "
              f"{ {k: v for k, v in counts.items() if v} }")
        if not worst <= THREE_PASS_EPOCH_REL:
            raise AssertionError(f"the 3x {label} run's errors {got} are "
                                 f"off the f32 run's {want}")
        check_counts(counts, {k: v * 2 for k, v in per_epoch.items()},
                     x3=True)
        out[label] = counts
    return out


def three_pass_rates(torch, card):
    """Phase 40d: bench.py's recipe step (T=500, B=50, every row full) in
    f32, 3x and bf16, TIMIT and LVCSR, in turns on one card, mean of 5
    after a warm-up step; and a profile of one 3x step of each."""
    from lstm_rnn_tpu_torch.ops import gemm as ge
    for lvcsr in (False, True):
        what = "LVCSR" if lvcsr else "TIMIT"
        batch, frames = recipe_batch(
            torch, states=S_LVCSR if lvcsr else S_STATES)
        for label, dtype, x3 in (("f32", "float32", False),
                                 ("3x", "float32", True),
                                 ("bf16", "bfloat16", False)):
            tr = make_trainer("auto", dtype, lvcsr=lvcsr)
            with three_pass() if x3 else contextlib.nullcontext():
                before = ge.LAUNCHES["dW_in:3x"].launches
                tr.train_step(*batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    tr.train_step(*batch)
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) / 5
                if x3 != (ge.LAUNCHES["dW_in:3x"].launches > before):
                    raise AssertionError("the 3x step's mode is off")
                if x3:
                    profile_trainer_step(
                        torch, tr, batch, f"one {what} training step "
                        f"T={T_TRAIN} 3x")
            phase("3x-rate", f"{what} train step {label}: "
                  f"{frames / dt:,.0f} frames/s ({1e3 * dt:.2f} ms per step "
                  f"of {frames} frames, mean of 5) on {card}")
            del tr


# ------------------------------------------ tools and recipes (phase 41)
def tools_chain(torch, workdir):
    """Phase 41a: the port's tools at the TIMIT recipe's widths on the
    card: HTK features and numeric state labels -> htk2nc (--no_label_map
    183) -> nc_standardize (the train set's statistics, applied to the val
    set) -> cli.main(--train true, the recipe's config.cfg, 1 epoch) ->
    forward mode with HTK output -> examples/phoneme_recognition_timit/
    test_post_conv.py with a state map."""
    import io
    import struct
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.data.netcdf3 import NetCDF3File
    from lstm_rnn_tpu_torch.tools import htk2nc, nc_standardize
    from lstm_rnn_tpu_torch.writers import read_htk
    d = os.path.join(workdir, "tools")
    os.makedirs(os.path.join(d, "htk"))
    rng = np.random.RandomState(SEED + 41)
    means = rng.randn(S_STATES, 117).astype(np.float32)
    t0 = time.perf_counter()
    ncs = {}
    for part, n_seq in (("train", 60), ("val", 20)):
        lines = []
        for i in range(n_seq):
            n = int(rng.randint(100, 301))
            lab = rng.randint(0, S_STATES, n)
            x = means[lab] + rng.randn(n, 117).astype(np.float32)
            feat = os.path.join(d, "htk", f"{part}{i:03d}.htk")
            with open(feat, "wb") as f:
                f.write(struct.pack(">IIHH", n, 100000, 117 * 4, 9))
                f.write((3.0 * x + 5.0).astype(">f4").tobytes())
            labels = feat[:-4] + ".labels"
            with open(labels, "w") as f:
                f.write("\n".join(str(v) for v in lab) + "\n")
            lines.append(f"{part}{i:03d} 1 {feat} {labels}")
        mapping = os.path.join(d, f"{part}.map")
        with open(mapping, "w") as f:
            f.write("\n".join(lines) + "\n")
        ncs[part] = os.path.join(d, f"{part}.nc")
        if htk2nc.main(["--mapping_list", mapping, "--nc", ncs[part],
                        "--no_label_map", str(S_STATES)]) != 0:
            raise AssertionError(f"htk2nc {part} failed")
    if (nc_standardize.main([ncs["train"], "-"]) != 0
            or nc_standardize.main([ncs["val"], ncs["train"]]) != 0):
        raise AssertionError("nc_standardize failed")
    xs = NetCDF3File(ncs["train"]).read("inputs")
    dims = NetCDF3File(ncs["val"]).dimensions
    t_tools = time.perf_counter() - t0
    trained = os.path.join(d, "trained_network.jsn")
    timit = os.path.join(REPO, "examples", "phoneme_recognition_timit")
    here = os.getcwd()
    os.chdir(d)
    buf = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([os.path.join(timit, "config.cfg"), "--network",
                           os.path.join(timit, "network.jsn"),
                           "--train_file", ncs["train"], "--val_file",
                           ncs["val"], "--max_epochs", "1", "--random_seed",
                           str(SEED), "--save_network", trained])
        t_train = time.perf_counter() - t0
    finally:
        os.chdir(here)
    rows = [ln for ln in buf.getvalue().splitlines()
            if ln.strip()[:1].isdigit() and "|" in ln]
    if rc != 0 or len(rows) != 1:
        print(buf.getvalue()[-3000:])
        raise AssertionError(f"cli --train true on htk2nc's corpus: {rc}")
    outdir = os.path.join(d, "post")
    with contextlib.redirect_stdout(io.StringIO()):
        t_serve = run_cli(ncs["val"], trained, outdir)
    names = sorted(os.listdir(outdir))
    with open(os.path.join(d, "test.scp"), "w") as f:
        f.write("".join(f"post/{n}\n" for n in names))
    perm = rng.permutation(S_STATES)  # output k takes posterior perm[k]
    with open(os.path.join(d, "state.map"), "w") as f:
        f.write("".join(f"{v}:{k}\n" for k, v in enumerate(perm)))
    r = subprocess.run([sys.executable, os.path.join(timit,
                                                     "test_post_conv.py"),
                        "test.scp", "state.map", "conv"], cwd=d,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"test_post_conv.py: {r.stdout}{r.stderr}")
    worst = 0.0
    for n in names:
        y, _, _ = read_htk(os.path.join(outdir, n))
        z, _, _ = read_htk(os.path.join(d, "conv", "post", n))
        if y.shape[1] != S_STATES or not np.array_equal(z, y[:, perm]):
            raise AssertionError(f"{n}: test_post_conv.py's output is not "
                                 "the permuted posteriors")
        worst = max(worst, float(np.abs(y.sum(-1) - 1).max()))
    phase("tools", f"htk2nc + nc_standardize: {dims['numSeqs']} val "
          f"sequences ({dims['numTimesteps']} frames), train inputs "
          f"standardized to mean {np.abs(xs.mean(0)).max():.1e} and std "
          f"within {np.abs(xs.std(0, ddof=1) - 1).max():.1e} of 1, "
          f"{t_tools:.1f} s; cli --train true 1 epoch |{rows[0]}| "
          f"{t_train:.1f} s; forward mode {len(names)} HTK files "
          f"{t_serve:.1f} s (rows sum to 1 within {worst:.1e}); "
          "test_post_conv.py permuted every file's 183 states")
    if worst > 1e-5:
        raise AssertionError("the served posteriors do not sum to 1")


RUN_TORCH = ("phoneme_recognition_timit", "lvcsr_physical_states",
             "speech_autoencoding_chime",
             "speech_recognition_chime/no_subsampling",
             "speech_recognition_chime/subsampling")


def recipes_on_card(workdir):
    """Phase 41b: every examples/*/run_torch.sh in a copy of examples/,
    the five at once on the card, each generating its corpus through its
    fallback (make_example_data_torch.py's defaults: 60 train sequences of
    80-200 frames) and training its config.cfg at the recipe's widths for
    one epoch; each must store trained_network.jsn."""
    import shutil
    ex = os.path.join(workdir, "examples")
    shutil.copytree(os.path.join(REPO, "examples"), ex)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = {}
    for recipe in RUN_TORCH:
        d = os.path.join(ex, recipe)
        log = open(os.path.join(d, "run_torch.log"), "w")
        procs[recipe] = (subprocess.Popen(
            ["sh", "run_torch.sh", "--max_epochs", "1", "--random_seed",
             str(SEED), "--autosave", "false"], cwd=d, env=env,
            stdout=log, stderr=subprocess.STDOUT), log)
    failed = []
    try:
        for recipe, (p, log) in procs.items():
            try:
                rc = p.wait(timeout=max(1, 300 - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            log.close()
            d = os.path.join(ex, recipe)
            with open(os.path.join(d, "run_torch.log")) as f:
                text = f.read()
            rows = [ln for ln in text.splitlines()
                    if ln.strip()[:1].isdigit() and "|" in ln]
            ok = (rc == 0 and os.path.exists(os.path.join(
                d, "trained_network.jsn")) and len(rows) == 1)
            phase("recipes", f"{recipe}/run_torch.sh: rc {rc}, "
                  f"trained_network.jsn {'stored' if ok else 'MISSING'}; "
                  + (f"|{rows[0]}" if rows else text[-1500:]))
            if not ok:
                failed.append(recipe)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    phase("recipes", f"the five run_torch.sh took {time.perf_counter() - t0:.1f}"
          " s together")
    if failed:
        raise AssertionError(f"run_torch.sh failed: {failed}")


# pipeline and tensor parallelism (phases 42-44). On one card a mesh names
# cuda:0 k times: every stage or shard runs on the card, the copies
# between them are no-ops, and what a mesh of distinct GPUs adds (the
# peer copies, the overlap) shows in phase 44 only.
# (stages, microbatches) of the pipelined TIMIT steps; LVCSR at (2, 2)
PP_CONFIGS = ((2, 2), (2, 4), (4, 4))
# a pipelined step against the one-GPU step from the same weights: the
# same kernels over a microbatch's rows (their outputs row by row as the
# whole batch's), each weight gradient summed over the microbatches by
# autograd, so in f32 sums in another order: phase 20's bounds, in bf16
# too: the kernels' gradient outputs are f32 there as well (the H100 read
# 6.6e-7 in f32 and at most 1.8e-5 in bf16, the LVCSR softmax's dW; the
# CPU twins, whose bf16 products round their outputs to bf16 once a
# microbatch, read 3.7e-3 there)
PP_STEP_TOL = {"loss": 1e-5, "grad": 1e-4}
# the tensor-parallel shard counts: TIMIT's 125 cells per direction over
# 5 (2 and 4 do not divide it), CHiME autoencoding's 78 / 128 / 78 over 2
TP_TIMIT, TP_CHIME = 5, 2
# a tensor-parallel step (the scan cell in f32) against the one-GPU kernel
# step: phase 6's bounds for the kernel path against the scan path
TP_STEP_TOL = {"loss": 1e-5, "grad": 1e-4}
# K8f and K8b against their twins (phase 43a), relative to each output's
# largest entry: TOL's f32 bound through 500 steps for the forward, the
# BPTT's (REL's lstm_bwd) for the deltas
TP_KERNEL_TOL = {"lstm_tp_fwd": 1e-5, "lstm_tp_bwd": 1e-4}
# the TP layers' hidden output under --compute_dtype bfloat16 against the
# one-GPU f32 kernel stack: f32 arithmetic on both sides (TOL's f32 bound);
# the one-GPU bf16 kernel stack, the control, must read above it
TP_BF16_REL = 1e-5


def pp_expect(m, lvcsr=False, layers=5):
    """Launches of one pipelined training step over m microbatches: every
    (stage, microbatch) forward runs under torch.utils.checkpoint, so each
    LSTM layer's training forward (K1) and the tail's forward (K3f, or K4f
    on the LVCSR net) run twice per microbatch (the forward and its
    recompute), the BPTT (K2) and the tail's backward once."""
    expect = dict.fromkeys(k for k in wrappers() if not k.startswith(
        "gemm:"))
    expect = {k: 0 for k in expect}
    expect.update(lstm_fwd_save=2 * layers * m, lstm_bwd=layers * m)
    tail = "softmax_ce_wide" if lvcsr else "softmax_ce_proj"
    expect.update({f"{tail}_fwd": 2 * m, f"{tail}_bwd": m})
    return expect


def _grad_rel(g, want):
    """(max over the tree of each gradient's rel_err, the leaf's name)."""
    return max((rel_err(g[n][k], want[n][k])[0], f"{n}/{k}")
               for n in want for k in want[n])


def _zero_launches():
    w = wrappers()
    for f in w.values():
        f.launches = 0
    return w


def _step_check(torch, tr, batch, ref, what, expect, bf16, tol):
    """One grad_fraction of `tr` against `ref` (err, corr, grads): the
    loss, the count, every gradient; its exact launches (expect, None:
    not checked). Returns (loss rel, grad rel, launches)."""
    w = _zero_launches()
    err, corr, g = tr.grad_fraction(*batch)
    sync_all(torch)
    counts = {k: f.launches for k, f in w.items()}
    e1, c1, g1 = ref
    lrel = abs(err.item() - e1) / abs(e1)
    grel, leaf = _grad_rel(g, g1)
    phase(what[0], f"{what[1]}: loss {err.item():.6f} vs {e1:.6f} (rel "
          f"{lrel:.2e}, tol {tol['loss']:.0e}); count {int(corr)} vs {c1};"
          f" gradients rel {grel:.2e} (worst {leaf}; tol "
          f"{tol['grad']:.1e}); launches "
          + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    if expect is not None:
        check_counts(counts, expect, bf16=bf16)
    if not (lrel <= tol["loss"] and int(corr) == c1
            and grel <= tol["grad"]):
        raise AssertionError(f"{what[1]} differs from the one-GPU step")
    return lrel, grel, counts


def _one_gpu_ref(torch, dtype, lvcsr, batch):
    tr = make_trainer("auto", dtype, lvcsr)
    err, corr, g = tr.grad_fraction(*batch)
    return tr, (err.item(), int(corr), g)


def _peak_mib(torch, fn, devices):
    """fn() and the peak device memory it allocated, MiB, per distinct
    device."""
    devs = sorted({torch.device(d).index or 0 for d in devices})
    sync_all(torch)
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
    fn()
    sync_all(torch)
    return {d: torch.cuda.max_memory_allocated(d) / 2**20 for d in devs}


def pp_steps(torch, card, mesh_of=None, configs=PP_CONFIGS, lvcsr=True):
    """Phase 42a-b: the TIMIT recipe step (T = 500, B = 50, every row
    full) pipelined over (stages, microbatches) = (2, 2), (2, 4), (4, 4),
    and the LVCSR step at (2, 2), K4 at the last stage, each against the
    one-GPU step from the same weights in f32 and bf16: the loss, the
    count, every gradient (PP_STEP_TOL) and the exact launches
    (pp_expect); the controls that must fail (a microbatch dropped, the
    microbatches' targets swapped); then the step's ms and the peak
    memory against one GPU, and a profiled pipelined step's busy share.
    mesh_of(k): the pipe mesh (default: cuda:0 k times)."""
    mesh_of = mesh_of or (lambda k: [torch.device("cuda", 0)] * k)
    out = {}
    for lvcsr, configs in ((False, configs),
                           *(((True, ((2, 2),)),) if lvcsr else ())):
        name = "LVCSR" if lvcsr else "TIMIT"
        batch, frames = recipe_batch(torch, seed=42,
                                     states=S_LVCSR if lvcsr else S_STATES)
        for dtype in ("float32", "bfloat16"):
            _, ref = _one_gpu_ref(torch, dtype, lvcsr, batch)
            for k, m in configs:
                mesh = mesh_of(k)
                tr = make_trainer("auto", dtype, lvcsr, pipe_mesh=mesh,
                                  pipeline_microbatches=m)
                _, _, counts = _step_check(
                    torch, tr, batch, ref,
                    ("pp-step", f"{name} {dtype} pp={k} m={m} on "
                     f"{mesh_name(mesh).replace('blocks', 'stages')}"),
                    pp_expect(m, lvcsr), dtype == "bfloat16", PP_STEP_TOL)
                out[(name, dtype, k, m)] = counts
                del tr
            if not lvcsr and dtype == "float32":
                pp_controls(torch, batch, ref, mesh_of(2))
    return out


def pp_controls(torch, batch, ref, mesh):
    """Phase 42a's controls: the pipelined step with microbatch 1 of 2
    dropped (its columns never reach the loss) and with the two
    microbatches' targets swapped must fail PP_STEP_TOL."""
    x, tc, pt = batch
    half = x.shape[1] // 2
    e1, _, g1 = ref
    for label, args in (
            ("a microbatch dropped", (x[:, :half], tc[:, :half],
                                      pt[:, :half])),
            ("targets swapped", (x, torch.cat([tc[:, half:], tc[:, :half]],
                                              1), pt))):
        tr = make_trainer("auto", "float32", pipe_mesh=mesh,
                          pipeline_microbatches=1 if "dropped" in label
                          else 2)
        err, _, g = tr.grad_fraction(*args)
        lrel = abs(err.item() - e1) / abs(e1)
        grel, _ = _grad_rel(g, g1)
        phase("pp-step", f"control ({label}): loss rel {lrel:.2e}, "
              f"gradients rel {grel:.2e}")
        if lrel <= PP_STEP_TOL["loss"] and grel <= PP_STEP_TOL["grad"]:
            raise AssertionError(f"the PP check passes its control "
                                 f"({label})")


def pp_rates(torch, card, mesh_of=None, configs=PP_CONFIGS):
    """Phase 42d: the TIMIT step's ms (mean of 3 after a warm-up) and peak
    device memory, one GPU and each pipelined configuration, f32 and
    bf16, on `card`; a profile of one pipelined f32 step (2 stages, 2
    microbatches): device busy against wall."""
    mesh_of = mesh_of or (lambda k: [torch.device("cuda", 0)] * k)
    batch, frames = recipe_batch(torch, seed=42)
    res = {}
    for dtype in ("float32", "bfloat16"):
        for k, m in ((1, 1), *configs):
            kw = {} if k == 1 else {"pipe_mesh": mesh_of(k),
                                    "pipeline_microbatches": m}
            tr = make_trainer("auto", dtype, **kw)
            ms = step_ms(torch, tr, batch, reps=3)
            peak = _peak_mib(torch, lambda: tr.train_step(*batch),
                             kw.get("pipe_mesh", ["cuda:0"]))
            label = "one GPU" if k == 1 else f"pp={k} m={m}"
            res[(dtype, label)] = (ms, peak)
            phase("pp-rate", f"TIMIT step {dtype} {label}: {ms:.2f} ms "
                  f"({frames / ms * 1e3:,.0f} frames/s), peak memory "
                  + ", ".join(f"cuda:{d} {v:,.0f} MiB"
                              for d, v in peak.items()) + f" on {card}")
            if k == 2 and m == 2 and dtype == "float32":
                profile_trainer_step(torch, tr, batch, f"one pipelined "
                                     f"TIMIT step pp=2 m=2 T={T_TRAIN} f32")
            del tr
    return res


def pp_serving(torch, workdir, mesh_of=None):
    """Phase 42c: apply_pipelined over phase 5's corpus at 2 stages (m = 2)
    and 4 (m = 4) against apply (K0): the posteriors (STREAM_TOL) and 5 m
    K0 launches per fraction, nothing else."""
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.models.flagship import build_timit_network
    from lstm_rnn_tpu_torch.parallel.pipeline import apply_pipelined
    mesh_of = mesh_of or (lambda k: [torch.device("cuda", 0)] * k)
    nc, _, _, _ = write_inputs(workdir)
    net = build_timit_network(seed=SEED)
    params = net.device_params("cuda")
    batches, want = [], []
    with torch.inference_mode():
        for frac in DataSet([nc], parallel_sequences=50,
                            prefetch=False).fractions():
            batches.append((torch.from_numpy(frac.inputs).cuda(),
                            torch.from_numpy(frac.pattypes).cuda()))
            want.append(net.apply(params, *batches[-1]))
    out = {}
    for k, m in ((2, 2), (4, 4)):
        w = _zero_launches()
        with torch.inference_mode():
            got = [apply_pipelined(net, params, x, pt, mesh_of(k), m)
                   for x, pt in batches]
        sync_all(torch)
        counts = {key: f.launches for key, f in w.items()}
        worst = max((a - b).abs().max().item() for a, b in zip(got, want))
        expect = {key: 0 for key in counts if not key.startswith("gemm:")}
        expect["lstm_fwd"] = 5 * m * len(batches)
        phase("pp-serve", f"apply_pipelined pp={k} m={m} vs apply over "
              f"phase 5's corpus ({len(batches)} fractions): max |p_pp - p|"
              f" = {worst:.3e} (tol {STREAM_TOL:.0e}); launches "
              + ", ".join(f"{key} {v}" for key, v in counts.items() if v))
        check_counts(counts, expect)
        if not worst <= STREAM_TOL:
            raise AssertionError(f"apply_pipelined differs: {worst}")
        out[(k, m)] = 5 * m
    return out


def tp_cost(kind, T, Bn, Hn, Dn, gpus=1):
    """(bytes, flops) of one K8f (with its residuals) or K8b launch set
    over a layer of Hn cells a direction, every row full: each input read
    once, each output written once (K8f's output once a GPU of the mesh);
    the recurrent product over the T - 1 steps that have a step before
    (2 flops a multiply-add) and ~30 flops a cell and step of the cell."""
    cells = T * Dn * Bn * Hn
    prod = 2 * (T - 1) * Dn * Bn * Hn * 4 * Hn
    w_rec, peep, mask = Dn * Hn * 4 * Hn, Dn * 3 * Hn, T * Dn * Bn
    if kind == "lstm_tp_fwd":
        nbytes = 4 * (4 * cells + w_rec + peep + mask
                      + gpus * cells + cells + 4 * cells)
    else:
        nbytes = 4 * (4 * cells + cells + cells + w_rec + peep + mask
                      + 4 * cells)
    return nbytes, prod + 30 * cells


def tp_kernels_vs_twins(torch, reps=5):
    """Phase 43a: K8f (save=True, the training forward) and K8b at a
    TIMIT layer (P = 250, H = 125 cells a direction in 5 shards on
    cuda:0, T = 500, B = 50, every row full) against their twins on the
    same operands (K8b from the kernel's residuals), relative to each
    output's largest entry (TP_KERNEL_TOL), with a control that must fail
    (the twin from one shard's W_rec changed; from a changed cotangent);
    ms by CUDA events over `reps` launches, the twins' ms once each.
    Returns {name: the kernels JSON's numbers}."""
    from lstm_rnn_tpu_torch.ops import lstm_tp as tp
    from lstm_rnn_tpu_torch.parallel.tensor import _operands
    mesh = [torch.device("cuda", 0)] * TP_TIMIT
    rng = np.random.RandomState(SEED)
    params = {k: torch.from_numpy(rng.uniform(-0.1, 0.1, sh).astype(
        np.float32)).cuda() for k, sh in (
            ("W_in", (D, 250, 4, H)), ("W_rec", (D, H, 4, H)),
            ("b", (D, 4, H)), ("peep", (D, 3, H)))}
    x = torch.from_numpy(rng.randn(T_TRAIN, B, 250).astype(np.float32)).cuda()
    pt = torch.ones((T_TRAIN, B), dtype=torch.int8, device="cuda")
    acts, w_recs, peeps, masks, _ = _operands(params, x, pt, 1.0, True, mesh)
    w = H // TP_TIMIT
    dys = [torch.from_numpy(rng.randn(T_TRAIN, D, B, w).astype(
        np.float32)).cuda() for _ in mesh]
    out = {}

    def fwd():
        return tp.lstm_tp_fwd(mesh, acts, w_recs, peeps, masks, True)

    (ys, cs, gs), _ = timed(torch, fwd)
    tp.check(mesh)
    _, ms_f = timed(torch, lambda: [fwd() for _ in range(reps)])
    (yt, ct, gt), plain_f = timed(torch, lambda: tp.lstm_tp_fwd_reference(
        acts, w_recs, peeps, masks, mesh, save=True))
    rel_f = max(rel_err(a, b)[0] for a, b in ((ys[0], yt[0]),
                                               *zip(cs, ct), *zip(gs, gt)))
    bad_w = [wr.clone() for wr in w_recs]
    bad_w[2][0, 7] += 0.05
    ctl_f = rel_err(ys[0], tp.lstm_tp_fwd_reference(
        acts, bad_w, peeps, masks, mesh)[0][0])[0]

    def bwd():
        return tp.lstm_tp_bwd(mesh, gs, cs, w_recs, peeps, dys, masks)

    da, _ = timed(torch, bwd)
    tp.check(mesh)
    _, ms_b = timed(torch, lambda: [bwd() for _ in range(reps)])
    dat, plain_b = timed(torch, lambda: tp.lstm_tp_bptt_reference(
        gs, cs, w_recs, peeps, dys, masks, mesh))
    rel_b = max(rel_err(a, b)[0] for a, b in zip(da, dat))
    bad_dy = [d.clone() for d in dys]
    bad_dy[1][T_TRAIN // 2] += 1.0
    ctl_b = max(rel_err(a, b)[0] for a, b in zip(da, tp.lstm_tp_bptt_reference(
        gs, cs, w_recs, peeps, bad_dy, masks, mesh)))
    for name, rel, ctl, ms, plain, err in (
            ("lstm_tp_fwd", rel_f, ctl_f, ms_f / reps, plain_f,
             float((ys[0] - yt[0]).abs().max())),
            ("lstm_tp_bwd", rel_b, ctl_b, ms_b / reps, plain_b,
             max(float((a - b).abs().max()) for a, b in zip(da, dat)))):
        tol = TP_KERNEL_TOL[name]
        bnd, by = bound(*tp_cost(name, T_TRAIN, B, H, D), "float32")
        phase("tp-kernel", f"{name} (TIMIT layer, {TP_TIMIT} shards of "
              f"cuda:0, T={T_TRAIN}, B={B}): rel {rel:.2e} (tol {tol:.0e})"
              f", max abs {err:.2e}; control {ctl:.2e} (must exceed the "
              f"tol); {ms:.3f} ms a launch set (bound {bnd:.4f} ms, {by})"
              f", twin {plain:.1f} ms")
        if not (rel <= tol and ctl > tol):
            raise AssertionError(f"{name} differs from its twin, or its "
                                 "control passed")
        out[name] = {"err": err, "ms": ms, "plain_ms": plain,
                     "bound": (bnd, by), "rel": rel}
    return out


def tp_trainer(torch, dtype, n, recipe=None, mesh=None):
    """The recipe step's Trainer (TIMIT, or a CHiME recipe) with its LSTM
    layers sharded over a model mesh of n (default cuda:0 n times);
    n = 1: no mesh."""
    kw = {}
    if n > 1:
        kw["model_mesh"] = mesh or [torch.device("cuda", 0)] * n
    if recipe:
        return chime_trainer(recipe, dtype, **kw)
    return make_trainer("auto", dtype, **kw)


def chime_ae_batch(torch, T=T_TRAIN, seed=43):
    """A CHiME autoencoding fraction: 50 rows of N(0, 1) features, ragged
    lengths T/2..T, regression targets a clean version of the input."""
    rng = np.random.RandomState(seed)
    x = rng.randn(T, B, CHIME_IN).astype(np.float32)
    lengths = rng.randint(T // 2, T + 1, B)
    lengths[0] = T
    pt = (np.arange(T)[:, None] < lengths[None, :]).astype(np.int8)
    y = (0.5 * x + 0.1 * rng.randn(T, B, CHIME_IN)).astype(np.float32)
    y[pt == 0] = 0
    return tuple(torch.from_numpy(a).cuda() for a in (x, y, pt))


def tp_steps(torch, card, mesh_of=None,
             cases=((None, TP_TIMIT), ("autoencoding", TP_CHIME)),
             bf16=True):
    """Phase 43b-d: tensor parallelism on K8. The TIMIT step at
    model_devices 5 (K3 in its tail) and the CHiME autoencoding step (39
    -> BLSTM 156 / 256 / 156 -> 39, sse) at 2, each against the one-GPU
    kernel step from the same weights (f32, TP_STEP_TOL), with the exact
    launches (one K8f and one K8b a layer and GPU, every shard a GPU
    holds in that launch; TIMIT also one K3f and one K3b; no K0-K2), the
    TP step's ms (mean of 3 after a warm-up) beside PR 18's host-driven
    layer and one GPU's, and a profile of a full TP step: its busy share;
    under bf16 the TIMIT TP stack's hidden output against the one-GPU f32
    kernel stack (tp_bf16). mesh_of(k): the model mesh (default: cuda:0
    k times)."""
    from torch.profiler import ProfilerActivity, profile
    from lstm_rnn_tpu_torch.ops import lstm_tp
    mesh_of = mesh_of or (lambda k: [torch.device("cuda", 0)] * k)
    res = {}
    for recipe, n in cases:
        name = "TIMIT" if recipe is None else "CHiME autoencoding"
        batch = (recipe_batch(torch, seed=43)[0] if recipe is None
                 else chime_ae_batch(torch))
        one = tp_trainer(torch, "float32", 1, recipe)
        err, corr, g = one.grad_fraction(*batch)
        ref = (err.item(), int(corr), g)
        tr = tp_trainer(torch, "float32", n, recipe, mesh_of(n))
        gpus = len(set(mesh_of(n)))
        layers = 5 if recipe is None else 3
        expect = {k: 0 for k in wrappers() if not k.startswith("gemm:")}
        expect.update(lstm_tp_fwd=layers * gpus, lstm_tp_bwd=layers * gpus)
        if recipe is None:
            expect.update(softmax_ce_proj_fwd=1, softmax_ce_proj_bwd=1)
        mesh = mesh_name(mesh_of(n)).replace("blocks", "shards")
        _, _, counts = _step_check(
            torch, tr, batch, ref, ("tp-step", f"{name} f32 model_devices="
                                    f"{n} on {mesh}"), expect, False,
            TP_STEP_TOL)
        lstm_tp.check()
        tp_ms = step_ms(torch, tr, batch, reps=3)
        ms1 = step_ms(torch, one, batch, reps=3)
        phase("tp-rate", f"{name} step f32 (T={batch[0].shape[0]}, B={B}): "
              f"TP on {mesh} {tp_ms:.2f} ms a step on K8 (the host-driven "
              "layer of PR 18: 56.6-60.6 s at 5 shards of cuda:0), one GPU "
              f"{ms1:.2f} ms a step, on {card}")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sync_all(torch)
            t0 = time.perf_counter()
            tr.train_step(*batch)
            sync_all(torch)
            wall_us = 1e6 * (time.perf_counter() - t0)
        report_profile(prof, wall_us, f"one TP {name} step on {mesh}, f32")
        res[name] = (tp_ms, ms1, counts)
        del tr, one
    if bf16:
        tp_bf16(torch, mesh_of(TP_TIMIT))
    return res


def tp_bf16(torch, mesh):
    """Phase 43b: under --compute_dtype bfloat16 the TP layers compute in
    f32 (the JAX package's TP takes no compute dtype): the TIMIT stack's
    hidden output (the five BLSTMs) on the model mesh against the one-GPU
    f32 kernel stack, and the one-GPU bf16 kernel stack as the control."""
    from lstm_rnn_tpu_torch.models.flagship import build_timit_network
    (x, _, pt), _ = recipe_batch(torch, seed=44)
    outs = {}
    with torch.inference_mode():
        for label, dtype, tp in (("TP bf16", "bfloat16", True),
                                 ("one GPU f32", "float32", False),
                                 ("one GPU bf16", "bfloat16", False)):
            net = build_timit_network(seed=3, compute_dtype=dtype)
            net.model_mesh = mesh if tp else None
            outs[label] = net.apply_layer_range(net.device_params("cuda"),
                                                x, pt, 0, 5).float()
    rel = rel_err(outs["TP bf16"], outs["one GPU f32"])[0]
    ctl = rel_err(outs["one GPU bf16"], outs["one GPU f32"])[0]
    phase("tp-bf16", f"TIMIT stack's hidden output, bf16 mode, TP on "
          f"{len(mesh)} shards vs the one-GPU f32 kernels: rel {rel:.2e} "
          f"(tol {TP_BF16_REL:.0e}); control (the one-GPU bf16 kernels): "
          f"{ctl:.2e}")
    if not (rel <= TP_BF16_REL and ctl > TP_BF16_REL):
        raise AssertionError("TP under bf16 does not compute in f32")


def _errors_close(a, b):
    """Two epoch tables' training and validation columns (classification
    or regression), number by number: relative DP_CLI_TOL plus half a unit
    of the printed digit."""
    import re

    def numbers(rows):
        return [re.findall(r"-?\d+\.\d+", c)
                for r in rows for c in r.split("|")[2:4]]
    na, nb = numbers(a), numbers(b)
    return len(na) == len(nb) > 0 and all(
        len(x) == len(y) and all(
            abs(float(u) - float(v)) <= DP_CLI_TOL * abs(float(v))
            + 0.5 * 10.0 ** -len(v.split(".")[1]) for u, v in zip(x, y))
        for x, y in zip(na, nb))


def pp_tp_cli(torch, workdir, n, kinds=("pp", "tp", "dp_pp", "dp_tp")):
    """Phase 44 (distinct GPUs): the CLI's --num_devices 2
    --pipeline_devices 2 in train (phase 7's corpus, 2 epochs) and forward
    mode (phase 5's corpus) against one GPU; --num_devices 2
    --model_devices 2 in train mode on CHiME autoencoding (1 epoch)
    against one GPU; with 4 GPUs DP x PP (--num_devices 4
    --pipeline_devices 2) and DP x TP (--num_devices 4 --model_devices 2)
    the same way, the TP runs also with --fuse_fractions 8 --device_cache
    true against themselves bit for bit; `kinds` picks the train runs (the
    forward runs come with "pp")."""
    paths, net_path = write_train_corpus(workdir)
    train = ["--network", net_path, "--train", "true", "--train_file",
             paths["train"][0], "--val_file", paths["val"][0],
             "--truncate_seq", "500", "--parallel_sequences", "50",
             "--stochastic", "true", "--shuffle_fractions", "true",
             "--learning_rate", "1e-4", "--momentum", "0.9", "--max_epochs",
             "2", "--random_seed", str(SEED)]
    cpaths = write_chime_corpus(workdir)
    ae = CHIME["autoencoding"]
    chime = [os.path.join(ae, "config.cfg"), "--network",
             os.path.join(ae, "network.jsn"), "--train_file",
             cpaths[("autoencoding", "train")][0], "--val_file",
             cpaths[("autoencoding", "val")][0], "--max_epochs", "1",
             "--random_seed", str(SEED), "--input_noise_sigma", "0"]
    runs = [("pp", train, ["--num_devices", "2", "--pipeline_devices",
                           "2"], "Pipeline mesh: {'pipe': 2}"),
            ("tp", chime, ["--num_devices", "2", "--model_devices", "2"],
             "DP x TP mesh: {'data': 1, 'model': 2}")]
    if n >= 4:
        runs += [("dp_pp", train, ["--num_devices", "4",
                                   "--pipeline_devices", "2"],
                  "DP x PP mesh: {'data': 2, 'pipe': 2}"),
                 ("dp_tp", chime, ["--num_devices", "4", "--model_devices",
                                   "2"],
                  "DP x TP mesh: {'data': 2, 'model': 2}")]
    runs = [r for r in runs if r[0] in kinds]
    base = {}
    for label, args, flags, banner in runs:
        key = "chime" if args is chime else "timit"
        if key not in base:
            d = os.path.join(workdir, f"pptp_{key}_one")
            base[key] = (d, finish(cli_process(args, d), f"{key} one GPU"))
        d = os.path.join(workdir, f"pptp_{label}")
        t0 = time.perf_counter()
        out = finish(cli_process(args + flags, d), f"cli {label}")
        wall = time.perf_counter() - t0
        rel = _flat_rel(_weights(os.path.join(d, "trained_network.jsn")),
                        _weights(os.path.join(base[key][0],
                                              "trained_network.jsn")))
        close = _errors_close(_table_rows(out), _table_rows(base[key][1]))
        phase("pptp-cli", f"train {' '.join(flags)} ({wall:.1f} s wall) vs "
              f"one GPU: banner {banner in out}; weights rel {rel:.2e} "
              f"(tol {DP_CLI_TOL:.0e}); epoch errors to the table's digits:"
              f" {close}")
        for ln in _table_rows(out):
            phase("pptp-cli", f"{label} |{ln}")
        if not (banner in out and rel <= DP_CLI_TOL and close):
            raise AssertionError(f"cli {label} differs from one GPU")
        if label in ("tp", "dp_tp"):
            # the same run's fused passes (step graphs holding K8): bit
            # for bit the unfused run's network and table
            fd = os.path.join(workdir, f"pptp_{label}_fused")
            t0 = time.perf_counter()
            fout = finish(cli_process(args + flags + [
                "--fuse_fractions", "8", "--device_cache", "true"], fd),
                f"cli {label} fused")
            with open(os.path.join(d, "trained_network.jsn"), "rb") as f:
                want = f.read()
            with open(os.path.join(fd, "trained_network.jsn"), "rb") as f:
                same = f.read() == want
            rows = ([c for r in _table_rows(fout) for c in r.split("|")[2:4]]
                    == [c for r in _table_rows(out)
                        for c in r.split("|")[2:4]])
            phase("pptp-cli", f"train {' '.join(flags)} --fuse_fractions 8 "
                  f"--device_cache true ({time.perf_counter() - t0:.1f} s "
                  f"wall) vs unfused: network "
                  f"{'bit for bit' if same else 'DIFFERS'}; the table's errors "
                  f"{'equal' if rows else 'DIFFER'}")
            if not (same and rows):
                raise AssertionError(f"cli {label} fused differs")
    if "pp" not in kinds:
        return
    nc, net_path, tags, lengths = write_inputs(workdir)
    outs = {}
    for label, flags in (("one", []), ("pp", ["--num_devices", "2",
                                               "--pipeline_devices", "2"]),
                         *((("dp_pp", ["--num_devices", "4",
                                       "--pipeline_devices", "2"]),)
                           if n >= 4 else ())):
        d = os.path.join(workdir, f"pptp_ff_{label}")
        finish(cli_process(["--network", net_path, "--train", "false",
                            "--ff_input_file", nc, "--parallel_sequences",
                            "50", "--ff_output_format", "htk",
                            "--ff_output_file", d, *flags],
                           d + "_cwd"), f"forward {label}")
        outs[label], _ = read_outputs(d, tags, lengths)
        if label != "one":
            diff = max(float(np.abs(a - b).max())
                       for a, b in zip(outs[label], outs["one"]))
            phase("pptp-cli", f"forward {' '.join(flags)} vs one GPU: max "
                  f"|p - p_1| = {diff:.3e} (tol {STREAM_TOL:.0e})")
            if not diff <= STREAM_TOL:
                raise AssertionError(f"forward {label} differs: {diff}")


def pp_tp_refused_on_one_gpu(torch, workdir):
    """Phase 44 on one GPU: the CLI's --num_devices 2 --pipeline_devices 2
    and --num_devices 2 --model_devices 2 refused with the JAX CLI's
    message before any work."""
    import contextlib
    import io
    from lstm_rnn_tpu_torch import cli
    nc, net_path, _, _ = write_inputs(workdir)
    for flags, mode in ((["--pipeline_devices", "2"], "false"),
                        (["--model_devices", "2"], "true")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["--network", net_path, "--train", mode,
                           "--train_file", nc, "--ff_input_file", nc,
                           "--ff_output_file", os.path.join(workdir, "x"),
                           "--num_devices", "2", *flags])
        text = buf.getvalue()
        want = "num_devices=2 but only 1 devices available"
        if rc == 0 or want not in text or "Computing" in text:
            raise AssertionError(f"{flags} ran on one GPU (rc {rc})")
        phase("pptp-cli", f"--num_devices 2 {' '.join(flags)} on one GPU: "
              f"refused (rc {rc}): {text.strip().splitlines()[-1][:100]}")
    phase("pptp-cli", "phase 44 (PP and TP on distinct GPUs: the CLI's "
          "--pipeline_devices 2 and --model_devices 2, DP x PP and DP x TP)"
          " was not run: torch sees one GPU")


def pp_tp_distinct(torch, card, n):
    """Phase 44d: on distinct GPUs (stage or shard j on cuda:j), the
    pipelined TIMIT steps that fit the GPUs (2 stages, and 4 with 4 GPUs)
    and the LVCSR one against one GPU, their ms and each GPU's peak
    memory; the TP CHiME autoencoding step over 2 GPUs (and TIMIT's over
    5 with 5) against one GPU, with its time."""
    def gpus(k):
        return [torch.device("cuda", j) for j in range(k)]
    configs = tuple(c for c in PP_CONFIGS if c[0] <= n)
    pp_steps(torch, card, mesh_of=gpus, configs=configs)
    pp_rates(torch, card, mesh_of=gpus, configs=configs)
    tp_steps(torch, card, mesh_of=gpus,
             cases=(("autoencoding", TP_CHIME),
                    *(((None, TP_TIMIT),) if n >= TP_TIMIT else ())),
             bf16=False)
    if n >= WIDE_TP_N:
        tp_wide(torch, card)


# the layer TP exists for: a BLSTM of 1,024 cells a direction (117 inputs
# -> BLSTM(2048) -> softmax(183)), too wide for the BPTT's cluster plan,
# in 4 shards of 256 on 4 GPUs (phase 44e)
WIDE_TP_H, WIDE_TP_N = 1024, 4


def _wide_tp_net(seed=SEED):
    from lstm_rnn_tpu_torch.network import Network
    net = Network([{"name": "input", "type": "input", "size": 117},
                   {"name": "wide", "type": "blstm", "size": 2 * WIDE_TP_H,
                    "bias": 1.0},
                   {"name": "output", "type": "softmax", "size": S_STATES,
                    "bias": 1.0},
                   {"name": "postoutput", "type": "multiclass_classification",
                    "size": S_STATES}])
    net.init_params(seed)
    return net


def tp_wide(torch, card):
    """Phase 44e (4+ GPUs): the 1,024-cell BLSTM at model_devices 4 on
    cuda:0-3 (W_rec's 4 MiB a direction and shard read from L2; the
    exchange over NVLink). Its training step (T = 500, B = 50, every row
    full) against the one-GPU step from the same weights, which takes the
    scan route (the BPTT kernel's plan refuses the width): TP_STEP_TOL,
    one K8f and one K8b a GPU; both steps' ms (mean of 3 after a warm-up)
    and a profiled TP step's busy share a GPU."""
    from torch.profiler import ProfilerActivity, profile
    from lstm_rnn_tpu_torch.ops.lstm_cell import recurrence_fits
    from lstm_rnn_tpu_torch.trainer import Trainer
    mesh = [torch.device("cuda", j) for j in range(WIDE_TP_N)]
    batch, _ = recipe_batch(torch, seed=47)
    fits = recurrence_fits(WIDE_TP_H, torch.float32, True)
    one = Trainer(_wide_tp_net(), None, learning_rate=1e-4, momentum=0.9,
                  hybrid_online_batch=True, device="cuda")
    w = _zero_launches()
    err, corr, g = one.grad_fraction(*batch)
    ref = (err.item(), int(corr), g)
    # the tail's kernels as the one-GPU step launched them
    expect = {k: (f.launches if k.startswith("softmax_ce") else 0)
              for k, f in w.items() if not k.startswith("gemm:")}
    expect.update(lstm_tp_fwd=WIDE_TP_N, lstm_tp_bwd=WIDE_TP_N)
    tr = Trainer(_wide_tp_net(), None, learning_rate=1e-4, momentum=0.9,
                 hybrid_online_batch=True, model_mesh=mesh)
    _step_check(torch, tr, batch, ref, (
        "tp-wide", f"BLSTM({2 * WIDE_TP_H}) f32 model_devices={WIDE_TP_N} on "
        f"{mesh_name(mesh).replace('blocks', 'shards')} against one GPU "
        f"(the kernels take the width: {fits}; the scan route)"), expect,
        False, TP_STEP_TOL)
    ms_tp = step_ms(torch, tr, batch, reps=3)
    ms1 = step_ms(torch, one, batch, reps=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync_all(torch)
        t0 = time.perf_counter()
        tr.train_step(*batch)
        sync_all(torch)
        wall_us = 1e6 * (time.perf_counter() - t0)
    report_profile(prof, wall_us, f"one TP step of the BLSTM({2 * WIDE_TP_H})"
                   f" net on {WIDE_TP_N} GPUs, f32 (busy over 4 GPUs: "
                   "divide by 4)")
    phase("tp-wide", f"BLSTM({2 * WIDE_TP_H}) step f32 (T={T_TRAIN}, B={B}): "
          f"TP on {WIDE_TP_N} GPUs {ms_tp:.2f} ms, one GPU on the scan route "
          f"{ms1:.2f} ms, on {card}")
    return ms_tp, ms1


# a seq or pipe mesh over several processes (phases 45-46, parallel/
# launch.py's spanning plan and parallel/hop.py): each process a worker
# (launch.start(span=True)) driving its own positions of one mesh. On one
# card two processes share cuda:0 over gloo (NCCL takes one rank a GPU),
# every message staged through host memory; with 2+ GPUs each process
# drives its own GPUs and the hops go over NCCL, the multi-host CLI's
# layout (one process a host, CUDA_VISIBLE_DEVICES a process).
# the hop's messages: a TIMIT carry (h and c of one direction at B = 50,
# H = 125, one message) and a pipelined step's stage message at m = 2
HOP_SHAPES = (("carry", (2, 1, B, H)), ("stage message", (T_TRAIN, B // 2,
                                                          2 * H)))
HOP_WARMUP, HOP_REPS = 5, 50
# seconds any wait of a span launch or a CLI run of phases 45-46 may take
# (a hop or collective that hangs fails the phase in this time)
XH_TIMEOUT_S = 300


def _sync(torch, devices):
    for d in sorted({torch.device(d).index or 0 for d in devices}):
        torch.cuda.synchronize(d)


def _hop_case(torch, group, shape, dtype, zero_cotangents=False):
    """One hop from position 0 (rank 0) to position 1 (rank 1) of the span
    and its cotangent back through parallel/hop.py's chain: on rank 1
    whether the received values equal the sent ones bit for bit, on rank
    0 whether the cotangent that came back equals rank 1's. The control
    sends zero cotangents back."""
    from lstm_rnn_tpu_torch.parallel import hop
    dev = group.device
    rng = np.random.RandomState(45)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    backward = hop._Recv.backward
    if zero_cotangents:
        def zeros_back(ctx, g_token, g_y):
            peer, bwd = ctx.meta
            hop._send(torch.zeros_like(g_y), peer, bwd)
            return g_token, None, None, None, None, None, None
        hop._Recv.backward = staticmethod(zeros_back)
    try:
        if group.rank == 0:
            xr = x.clone().requires_grad_(True)
            chain = hop.Chain(group.span, hop.anchor([xr], dev))
            chain.send(xr, 0, 1)
            grad, = torch.autograd.grad(
                chain.close(torch.zeros((), device=dev)), [xr])
            return torch.equal(grad, g)
        w = torch.zeros((), device=dev, requires_grad=True)
        chain = hop.Chain(group.span, hop.anchor([w], dev))
        y = chain.recv(0, 1, shape, dtype)
        torch.autograd.grad(chain.close((y * g).sum().float()), [w])
        return torch.equal(y, x)
    finally:
        hop._Recv.backward = backward


def _barrier(group):
    """A barrier of the group on the process's own device (NCCL would
    guess the device from the rank)."""
    import torch.distributed as dist
    if group.device.type == "cuda" and dist.get_backend() == "nccl":
        dist.barrier(device_ids=[group.device.index])
    else:
        dist.barrier()


def _hop_us(torch, group, shape, dtype):
    """µs a one-way hop of a [shape] message between ranks 0 and 1: the
    mean of HOP_REPS round trips (up, then down) after HOP_WARMUP, with
    the devices synchronised at the ends."""
    from lstm_rnn_tpu_torch.parallel import hop
    dev, groups = group.device, group.span.groups
    x = torch.zeros(shape, dtype=dtype, device=dev)

    def round_trip():
        if group.rank == 0:
            hop._send(x, 1, groups["up"])
            hop._recv(shape, dtype, dev, 1, groups["down"])
        else:
            y = hop._recv(shape, dtype, dev, 0, groups["up"])
            hop._send(y, 0, groups["down"])
    for _ in range(HOP_WARMUP):
        round_trip()
    torch.cuda.synchronize(dev)
    _barrier(group)
    t0 = time.perf_counter()
    for _ in range(HOP_REPS):
        round_trip()
    torch.cuda.synchronize(dev)
    return 1e6 * (time.perf_counter() - t0) / (2 * HOP_REPS)


def _span_expect(kind, span, rank, m=0, lvcsr=False):
    """The exact launches of one span training step on `rank`'s positions
    of the TIMIT or LVCSR stack (5 BLSTM layers and the softmax): SP runs
    the carry pair (K6b) once a layer, direction and owned block, and the
    unfused tail; PP's owned stages run their layers' K1 twice a
    microbatch (the checkpoint's recompute) and K2 once, the last stage
    the tail's forward twice and backward once. The GEMM engine's
    products follow, dx on every BPTT but the first layer's (its input is
    the data; a later stage's input is a received message, which takes
    one)."""
    from lstm_rnn_tpu_torch.parallel.pipeline import stage_ranges
    expect = {k: 0 for k in wrappers() if not k.startswith("gemm:")}
    own = [i for i in range(len(span)) if span.owners[i] == rank]
    if kind == "seq":
        expect.update(lstm_fwd_carry_save=10 * len(own),
                      lstm_bwd_carry=10 * len(own))
        first = 2 * len(own)
    else:
        ranges = [stage_ranges(6, len(span))[i] for i in own]
        layers = sum(min(hi, 5) - min(lo, 5) for lo, hi in ranges)
        expect.update(lstm_fwd_save=2 * m * layers, lstm_bwd=m * layers)
        if len(span) - 1 in own:
            tail = "softmax_ce_wide" if lvcsr else "softmax_ce_proj"
            expect.update({f"{tail}_fwd": 2 * m, f"{tail}_bwd": m})
        first = m if 0 in own else 0
    expect.update(gemm_expect(expect))
    expect["gemm:dx"] = expect["lstm_bwd"] + expect["lstm_bwd_carry"] - first
    expect["softmax_ce_wide_bwd_3x"] = 0
    return expect


def _busy(torch, tr, batch, devices):
    """(compute ms, NCCL ms, wall ms) of one profiled train_step of `tr` in
    this process, after the warm-ups of the caller: the device time of
    this process's kernels on its GPUs, the NCCL kernels apart (they run
    on streams of their own, beside the compute, and wait there for the
    peer, so their time says nothing of how busy the GPU was)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync(torch, devices)
        t0 = time.perf_counter()
        tr.train_step(*batch)
        _sync(torch, devices)
        wall = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not e.key.startswith("ProfilerStep")]
    nccl = sum(dev_us(e) for e in events if "nccl" in e.key.lower()) / 1e3
    return sum(dev_us(e) for e in events) / 1e3 - nccl, nccl, wall


def _span_card_worker(group, workdir, plan):
    """Phases 45-46 on one process of a span: the hop's cases and times
    (plan["hop"], ranks 0 and 1), then each step of plan["steps"] ((kind,
    LVCSR, dtype, m)): the step's error, count and gradients summed over
    the group against the reference (on rank 0), this rank's exact
    launches, and with plan["rates"] the step's ms (mean of 3 after a
    warm-up), each local GPU's peak MiB and a profiled step's busy ms.
    The reference is the same mesh driven from one process, every
    position on rank 0's GPU: the same kernels on the same blocks or
    microbatches (phases 20 and 42 hold that against one GPU). Writes its
    results to workdir."""
    import torch
    from lstm_rnn_tpu_torch.parallel.data import all_reduce_sum
    out = {"hop": {}, "steps": {}, "local": [str(d) for d in
                                            group.span.local]}
    devices = group.span.local
    if plan.get("hop"):
        for name, shape in HOP_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                key = f"{name} {tuple(shape)} {str(dtype)[6:]}"
                out["hop"][key] = dict(
                    exact=_hop_case(torch, group, shape, dtype),
                    control=_hop_case(torch, group, shape, dtype, True),
                    us=_hop_us(torch, group, shape, dtype),
                    bytes=int(np.prod(shape)) * (4 if dtype == torch.float32
                                                 else 2))
    for kind, lvcsr, dtype, m in plan["steps"]:
        batch, frames = recipe_batch(
            torch, seed=42, states=S_LVCSR if lvcsr else S_STATES)
        kw = ({"seq_mesh": group.span} if kind == "seq" else
              {"pipe_mesh": group.span, "pipeline_microbatches": m})
        tr = make_trainer("auto", dtype, lvcsr, data_group=group, **kw)
        w = _zero_launches()
        err, corr, g = tr.grad_fraction(*batch)
        _sync(torch, devices)
        counts = {k: f.launches for k, f in w.items()}
        expect = _span_expect(kind, group.span, group.rank, m, lvcsr)
        tot = [err.detach().float(), corr.to(torch.int64)]
        all_reduce_sum(tot)
        all_reduce_sum(tr._leaves(g))
        res = dict(counts=counts, expect_ok=counts == expect, expect=expect)
        if group.rank == 0:
            # the same mesh in one process: every position on this GPU
            mesh = [group.device] * len(group.span)
            ref = make_trainer("auto", dtype, lvcsr, **(
                {"seq_mesh": mesh} if kind == "seq" else
                {"pipe_mesh": mesh, "pipeline_microbatches": m}))
            e1, c1, g1 = ref.grad_fraction(*batch)
            e1, c1 = e1.item(), int(c1)
            del ref
            grel, leaf = _grad_rel(g, g1)
            res.update(loss_rel=abs(tot[0].item() - e1) / abs(e1),
                       corr=(int(tot[1]), c1), grad_rel=grel, leaf=leaf)
        if plan.get("rates"):
            ms = []
            for _ in range(2):  # the warm-up, then the mean of 3
                _barrier(group)
                _sync(torch, devices)
                t0 = time.perf_counter()
                for _ in range(3 if ms else 1):
                    tr.train_step(*batch)
                _sync(torch, devices)
                ms.append(1e3 * (time.perf_counter() - t0) / (3 if ms
                                                              else 1))
            res["ms"] = ms[1]
            res["frames"] = frames
            res["peak_mib"] = _peak_mib_on(
                torch, lambda: tr.train_step(*batch), devices)
            res["busy_ms"], res["nccl_ms"], res["wall_ms"] = _busy(
                torch, tr, batch, devices)
        out["steps"][(kind, lvcsr, dtype, m)] = res
        del tr
    torch.save(out, os.path.join(workdir, f"span_rank{group.rank}.pt"))


def _peak_mib_on(torch, fn, devices):
    """fn() and the peak memory it allocated, MiB, on each of `devices`."""
    idx = sorted({torch.device(d).index or 0 for d in devices})
    _sync(torch, devices)
    for d in idx:
        torch.cuda.reset_peak_memory_stats(d)
    fn()
    _sync(torch, devices)
    return {d: torch.cuda.max_memory_allocated(d) / 2**20 for d in idx}


def _span_run(torch, layout, plan, workdir, backend=None):
    """launch.start of _span_card_worker over the processes of `layout`
    (each a list of GPU indices, its positions in mesh order): each
    rank's results, and the wall seconds of the launch."""
    from lstm_rnn_tpu_torch.parallel.launch import start
    for f in glob.glob(os.path.join(workdir, "span_rank*.pt")):
        os.remove(f)
    t0 = time.perf_counter()
    start(_span_card_worker, [[torch.device("cuda", j) for j in part]
                              for part in layout], (workdir, plan),
          backend=backend, span=True, timeout_s=XH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    return [torch.load(os.path.join(workdir, f"span_rank{r}.pt"),
                       weights_only=False)
            for r in range(len(layout))], wall


def _layout_name(layout):
    return " + ".join(f"[{', '.join(f'cuda:{j}' for j in part)}]"
                      for part in layout)


def _report_span(torch, card, layout, ranks, how):
    """The phase lines of one span launch, and its checks: the hop's cases
    bit-exact and their controls failing, each step within SP_STEP_TOL or
    PP_STEP_TOL of the same mesh driven from one process, with every
    rank's exact launches.
    Returns {(kind, lvcsr, dtype, m): [each rank's step results]}."""
    name = _layout_name(layout)
    for key, r0 in ranks[0]["hop"].items():
        r1 = ranks[1]["hop"][key]
        ok = r0["exact"] and r1["exact"]
        ctl = r0["control"]
        phase("xh-hop", f"{key} over {how} ({name}): values and cotangents "
              f"bit-exact {ok}; control (zero cotangents) passes {ctl}; "
              f"{r0['us']:.1f} µs a hop ({r0['bytes'] / r0['us'] / 1e3:.2f}"
              f" GB/s) on {card}")
        if not ok or ctl:
            raise AssertionError(f"the hop of {key} over {how}")
    out = {}
    for key in ranks[0]["steps"]:
        kind, lvcsr, dtype, m = key
        rs = [r["steps"][key] for r in ranks]
        r0 = rs[0]
        tol = SP_STEP_TOL if kind == "seq" else PP_STEP_TOL
        what = (f"{'LVCSR' if lvcsr else 'TIMIT'} {dtype} "
                f"{'SP' if kind == 'seq' else f'PP m={m}'} over {name} "
                f"({how})")
        phase("xh-step", f"{what}: loss rel {r0['loss_rel']:.2e} (tol "
              f"{tol['loss']:.0e}), count {r0['corr'][0]} vs "
              f"{r0['corr'][1]}, gradients rel {r0['grad_rel']:.2e} (worst "
              f"{r0['leaf']}; tol {tol['grad']:.0e}) against the mesh from "
              "one process; launches " + "; ".join(
                  f"rank {i}: " + ", ".join(f"{k} {v}" for k, v in
                                            r["counts"].items() if v)
                  for i, r in enumerate(rs)))
        for i, r in enumerate(rs):
            if not r["expect_ok"]:
                raise AssertionError(f"{what}: rank {i} launched "
                                     f"{r['counts']}, expected "
                                     f"{r['expect']}")
        if not (r0["loss_rel"] <= tol["loss"] and r0["corr"][0] ==
                r0["corr"][1] and r0["grad_rel"] <= tol["grad"]):
            raise AssertionError(f"{what} differs from one process's")
        if "ms" in r0:
            phase("xh-rate", f"{what}: {r0['ms']:.2f} ms a step ("
                  f"{r0['frames'] / r0['ms'] * 1e3:,.0f} frames/s); " +
                  "; ".join(
                      f"rank {i} peak " + ", ".join(
                          f"cuda:{d} {v:,.0f} MiB" for d, v in
                          r["peak_mib"].items())
                      + f", kernels {r['busy_ms']:.2f} ms (NCCL "
                      f"{r['nccl_ms']:.2f} beside) in a profiled step of "
                      f"{r['wall_ms']:.2f} ms: busy "
                      f"{_share(r['busy_ms'], r['wall_ms'], r)}, "
                      f"{_share(r['busy_ms'], r['ms'], r)} of an unprofiled "
                      "step" for i, r in enumerate(rs))
                  + f" on {card}")
        out[key] = rs
    return out


def _share(busy_ms, wall_ms, r):
    """busy_ms as a share of wall_ms on each of the process's GPUs."""
    return f"{100 * busy_ms / wall_ms / len(r['peak_mib']):.1f}%"


def cross_host_on_one_card(torch, card, workdir):
    """Phase 45: a seq and a pipe mesh over two processes sharing cuda:0
    over gloo (launch.start(span=True); every message staged through
    host memory, the backend's choice). 45a the hop: a TIMIT carry and a
    stage message, f32 and bf16, values and cotangents bit for bit, µs a
    hop, the zero-cotangent control; 45b the TIMIT SP step (one block a
    process) and the pipelined step (m = 2, a stage a process) in f32
    against the same mesh from one process, each process's exact
    launches (SP: 10 K6b-f and 10 K6b-b; PP: K1 / K2 of its own stage's
    layers, the tail on the last). Returns each step's results a
    process."""
    ranks, wall = _span_run(torch, [[0], [0]], {
        "hop": True, "steps": [("seq", False, "float32", 0),
                               ("pipe", False, "float32", 2)]},
        workdir, backend="gloo")
    phase("xh-card", f"two processes on cuda:0 over gloo: {wall:.1f} s "
          "wall (spawn, the hop's cases, two steps)")
    return _report_span(torch, card, [[0], [0]], ranks,
                        "gloo, staged through host memory")


def _in_process_ms(torch, kind, k, dtype, m=2, lvcsr=False):
    """The recipe step's ms on a seq or pipe mesh of cuda:0 .. cuda:k-1
    driven from this process (k = 1: one GPU), and its peak MiB a GPU."""
    batch, _ = recipe_batch(torch, seed=42,
                            states=S_LVCSR if lvcsr else S_STATES)
    gpus = [torch.device("cuda", j) for j in range(k)]
    kw = {} if k == 1 else ({"seq_mesh": gpus} if kind == "seq" else
                            {"pipe_mesh": gpus, "pipeline_microbatches": m})
    tr = make_trainer("auto", dtype, lvcsr, **kw)
    ms = step_ms(torch, tr, batch, reps=3)
    peak = _peak_mib(torch, lambda: tr.train_step(*batch), gpus)
    del tr
    return ms, peak


def cross_host_distinct(torch, card, workdir, n):
    """Phase 46a-c (2+ GPUs): spans over processes of their own GPUs, the
    hops over NCCL. 46a two processes of one GPU: the hop (as 45a), the
    TIMIT SP and PP (m = 2) steps in f32 and bf16 and the LVCSR PP step
    in f32 against the same mesh from one process with each process's
    exact launches, their ms,
    each GPU's peak MiB and each process's busy share; 46b with 3 GPUs
    SP over processes of one and two GPUs (k = 3), with 4 SP over two
    processes of two GPUs and over four of one (k = 4); 46c the same
    steps driven from one process (--seq_devices k, --pipeline_devices 2
    on k GPUs) and on one GPU, in this call."""
    gpus_rates = {"rates": True}
    layouts = [([[0], [1]], dict(gpus_rates, hop=True, steps=[
        ("seq", False, "float32", 0), ("seq", False, "bfloat16", 0),
        ("pipe", False, "float32", 2), ("pipe", False, "bfloat16", 2),
        ("pipe", True, "float32", 2)]))]
    sp = [("seq", False, "float32", 0), ("seq", False, "bfloat16", 0)]
    if n >= 3:
        layouts.append(([[0], [1, 2]], dict(gpus_rates, steps=sp)))
    else:
        phase("xh-gpus", "SP over processes of 1 + 2 GPUs (k = 3) was not "
              f"run: torch sees {n} GPUs")
    if n >= 4:
        layouts += [([[0, 1], [2, 3]], dict(gpus_rates, steps=sp)),
                    ([[0], [1], [2], [3]], dict(gpus_rates, steps=sp))]
    else:
        phase("xh-gpus", "SP over 2 x 2 and 4 x 1 GPUs (k = 4) was not run:"
              f" torch sees {n} GPUs")
    res = {}
    for layout, plan in layouts:
        ranks, wall = _span_run(torch, layout, plan, workdir)
        phase("xh-gpus", f"{_layout_name(layout)} over NCCL: {wall:.1f} s "
              "wall")
        res[_layout_name(layout)] = _report_span(torch, card, layout, ranks,
                                                 "NCCL")
    for dtype in ("float32", "bfloat16"):
        for kind, k in (("one GPU", 1), ("seq", 2), ("seq", 3), ("seq", 4),
                        ("pipe", 2)):
            if k > n:
                continue
            ms, peak = _in_process_ms(torch, kind, k, dtype)
            label = {"one GPU": "on one GPU", "seq": f"--seq_devices {k}",
                     "pipe": f"--pipeline_devices {k} m=2"}[kind]
            phase("xh-rate", f"TIMIT {dtype} {label} from one process: "
                  f"{ms:.2f} ms a step, peak " + ", ".join(
                      f"cuda:{d} {v:,.0f} MiB" for d, v in peak.items())
                  + f" on {card}")
    ms, peak = _in_process_ms(torch, "pipe", 2, "float32", lvcsr=True)
    phase("xh-rate", f"LVCSR float32 --pipeline_devices 2 m=2 from one "
          f"process: {ms:.2f} ms a step, peak " + ", ".join(
              f"cuda:{d} {v:,.0f} MiB" for d, v in peak.items())
          + f" on {card}")
    return res


def cross_host(torch, card, workdir, n):
    """Phases 45-46: a seq or pipe mesh over processes on one card, and
    with 2+ GPUs over processes of their own GPUs and through the CLI.
    Returns {layout: {step: each process's results}}."""
    res = {"[cuda:0] + [cuda:0]": cross_host_on_one_card(torch, card,
                                                        workdir)}
    if n >= 2:
        res.update(cross_host_distinct(torch, card, workdir, n))
        cross_host_cli(torch, workdir, n)
    else:
        phase("xh-gpus", "phase 46 (a seq or pipe mesh over processes of "
              "their own GPUs, the hops over NCCL, and the CLI's "
              "multi-host --seq_devices / --pipeline_devices) was not run: "
              "torch sees one GPU")
    return res


def cross_host_cli(torch, workdir, n):
    """Phase 46d (2+ GPUs): the CLI as processes of their own GPUs
    (CUDA_VISIBLE_DEVICES a process, the multi-host flags), training the
    TIMIT recipe on phase 7's corpus for 2 epochs with --seq_devices 2
    and --pipeline_devices 2 over two processes of one GPU, --seq_devices
    3 over one and two (3+ GPUs) and --seq_devices 4 over two and two (4
    GPUs), each against the same flag from one process on as many GPUs:
    the weights (DP_CLI_TOL), the epoch errors to the table's digits, the
    JAX banner on process 0, and nothing written by the others."""
    paths, net_path = write_train_corpus(workdir)
    train = ["--network", net_path, "--train", "true", "--train_file",
             paths["train"][0], "--val_file", paths["val"][0],
             "--truncate_seq", "500", "--parallel_sequences", "50",
             "--stochastic", "true", "--shuffle_fractions", "true",
             "--learning_rate", "1e-4", "--momentum", "0.9", "--max_epochs",
             "2", "--random_seed", str(SEED)]
    runs = [("--seq_devices", [[0], [1]],
             "Sequence-parallel mesh: {'seq': 2} (time axis sharded)"),
            ("--pipeline_devices", [[0], [1]],
             "Pipeline mesh: {'pipe': 2} (6 hidden layers over 2 stages)")]
    if n >= 3:
        runs.append(("--seq_devices", [[0], [1, 2]],
                     "Sequence-parallel mesh: {'seq': 3} (time axis "
                     "sharded)"))
    if n >= 4:
        runs.append(("--seq_devices", [[0, 1], [2, 3]],
                     "Sequence-parallel mesh: {'seq': 4} (time axis "
                     "sharded)"))
    for flag, layout, banner in runs:
        k = sum(map(len, layout))
        tag = f"{flag.strip('-')}_{'_'.join(str(len(p)) for p in layout)}"
        one = os.path.join(workdir, f"xh_{tag}_one")
        t0 = time.perf_counter()
        base = finish(cli_process(train + [flag, str(k)], one, dict(
            os.environ, CUDA_VISIBLE_DEVICES=",".join(map(str, range(k))))),
            f"{flag} {k} from one process", XH_TIMEOUT_S)
        wall1 = time.perf_counter() - t0
        port = _free_port()
        dirs = [os.path.join(workdir, f"xh_{tag}_p{i}")
                for i in range(len(layout))]
        t0 = time.perf_counter()
        procs = [cli_process(train + [
            flag, str(k), "--coordinator_address", f"127.0.0.1:{port}",
            "--num_processes", str(len(layout)), "--process_id", str(i)],
            d, dict(os.environ, CUDA_VISIBLE_DEVICES=",".join(
                map(str, part))))
            for i, (part, d) in enumerate(zip(layout, dirs))]
        outs = [finish(p, f"{flag} {k} process {i}", XH_TIMEOUT_S)
                for i, p in enumerate(procs)]
        wall = time.perf_counter() - t0
        rel = _flat_rel(_weights(os.path.join(dirs[0],
                                              "trained_network.jsn")),
                        _weights(os.path.join(one, "trained_network.jsn")))
        close = _errors_close(_table_rows(outs[0]), _table_rows(base))
        silent = all(not os.listdir(d) and "mesh" not in o
                     for d, o in zip(dirs[1:], outs[1:]))
        phase("xh-cli", f"train {flag} {k} over {_layout_name(layout)} "
              f"({wall:.1f} s wall) vs one process on {k} GPUs ({wall1:.1f}"
              f" s): banner {banner in outs[0]}; weights rel {rel:.2e} (tol"
              f" {DP_CLI_TOL:.0e}); epoch errors to the table's digits: "
              f"{close}; the other processes silent and wrote nothing: "
              f"{silent}")
        for ln in _table_rows(outs[0]):
            phase("xh-cli", f"{tag} |{ln}")
        if not (banner in outs[0] and rel <= DP_CLI_TOL and close
                and silent):
            raise AssertionError(f"the CLI's {flag} {k} over processes "
                                 "differs from one process")


# ------------------------------------------------- step graphs (phase 47)
# (recipe, compute dtype, remat blocks); the CLI runs take GRAPH_EPOCHS
# epochs, so that most of a fused run's steps are replays
GRAPH_RUNS = (("TIMIT", "float32", 0), ("TIMIT", "bfloat16", 0),
              ("remat", "float32", 4), ("LVCSR", "float32", 0))
GRAPH_EPOCHS = 2
# the runs whose steps hold cuBLAS products (the LVCSR tail's f32 logits
# and dh, the remat softmax layer's product), which may pick another
# algorithm under capture: the JAX Trainer's fused tolerance
# (tests/test_fused.py); the TIMIT runs are held bit for bit
GRAPH_REL = 1e-6


def _graph_net(workdir, recipe):
    """The recipe's network.jsn without weights (the CLI draws them from
    --random_seed): TIMIT's 5 x BLSTM(250), softmax(183) or LVCSR's
    softmax(10,112)."""
    from lstm_rnn_tpu_torch.models.flagship import timit_dblstm_layers
    path = os.path.join(workdir, f"network_{recipe}.jsn")
    with open(path, "w") as f:
        json.dump({"layers": timit_dblstm_layers(
            num_states=S_LVCSR if recipe == "LVCSR" else S_STATES)}, f)
    return path


def _graph_args(dtype, remat, epochs, train_nc, val_nc, net, out):
    return ["--network", net, "--train", "true", "--train_file", train_nc,
            "--val_file", val_nc, "--truncate_seq", "500",
            "--parallel_sequences", "50", "--hybrid_online_batch", "true",
            "--shuffle_fractions", "true", "--bucket_lengths", "true",
            "--learning_rate", "1e-4", "--momentum", "0.9",
            "--max_epochs", str(epochs), "--random_seed", str(SEED),
            "--compute_dtype", dtype, "--remat_blocks", str(remat),
            "--save_network", out]


def expected_graphs(tr, epochs):
    """(warm-ups, captures, replays) of a fused run of `epochs` epochs:
    a warm-up for each (mode, shape) used, a capture for each used twice
    or more, a replay for every other step."""
    from collections import Counter
    uses = Counter()
    for ds, mode in ((tr.train_set, "train"), (tr.validation_set, "eval")):
        for f in ds.lazy_fractions():
            uses[mode, tuple(f.shape)] += epochs
    return (len(uses), sum(1 for n in uses.values() if n > 1),
            sum(uses.values()) - len(uses))


def _profiled_kernels(prof):
    """{kernel name: launches} of a profile's device events."""
    from collections import Counter
    return Counter({e.key: e.count for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA")
                    and not e.key.startswith(("ProfilerStep", "Memcpy",
                                              "Memset"))})


def graphs_cli(torch, workdir, corpora):
    """47a: cli.main on phase 7's corpus (LVCSR: its sizes with 10,112
    labels), each of GRAPH_RUNS for GRAPH_EPOCHS epochs with
    --fuse_fractions 8 --device_cache true against --fuse_fractions 1,
    each run whole under torch.profiler: the epoch tables' errors and
    trained_network.jsn (bit for bit for TIMIT, within GRAPH_REL for
    remat and LVCSR), the kernels the profiler saw, by name, equal (but
    for the two int64 fills with which torch's CUDA generator opens each
    capture); the
    profiler's bptt kernels equal to the K2 and K6b-b launches that the
    wrappers' counts give (each capture's counted once a replay), and
    those equal to the unfused run's; one capture per (mode, shape) used
    twice, the replays the fractions less the warm-ups, and the stacked
    epoch taken (no decline line). A pair whose profile lost records
    (seen as bptt counts below the wrappers') runs once more."""
    import contextlib
    import io

    from torch.profiler import ProfilerActivity, profile
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.trainer import Trainer
    made = []

    class Recording(Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def run(name, label, args):
        w = wrappers()
        for f in w.values():
            f.launches = 0
        buf = io.StringIO()
        cli.Trainer = Recording
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                # a profile's first kernel records can go missing (on the
                # card, up to some 45 of them): open it on launches of a
                # kernel no step runs (an int16 fill), left out below
                for _ in range(200):
                    torch.empty(8, dtype=torch.int16, device="cuda").fill_(1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(buf):
                    rc = cli.main(args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            cli.Trainer = Trainer
        tr = made.pop()
        text = buf.getvalue()
        rows = _table_rows(text)
        if rc != 0 or len(rows) != GRAPH_EPOCHS:
            print(text[-3000:])
            raise AssertionError(f"{name} {label}: cli returned {rc}")
        declined = [ln for ln in text.splitlines() if "declined" in ln]
        if declined:
            raise AssertionError(f"{name} {label}: {declined}")
        counts = graph_executed(tr, {k: f.launches for k, f in w.items()})
        kernels = _profiled_kernels(prof)
        for k in [k for k in kernels if "FillFunctor<short>" in k]:
            del kernels[k]
        seen = tuple(sum(n for k, n in kernels.items() if part in k)
                     for part in ("bptt_kernel", "bptt_carry_kernel"))
        lost = seen != (counts["lstm_bwd"], counts["lstm_bwd_carry"])
        st = tr.graph_stats.as_dict()
        want = expected_graphs(tr, GRAPH_EPOCHS)
        tr.drop_graphs()
        return dict(rows=rows, counts=counts, kernels=kernels, seen=seen,
                    lost=lost, wall=wall, st=st, want=want)

    nets = {}
    for recipe, dtype, remat in GRAPH_RUNS:
        name = f"{recipe} {'f32' if dtype == 'float32' else 'bf16'}"
        lvcsr = "LVCSR" if recipe == "LVCSR" else "TIMIT"
        train_nc, val_nc = corpora[lvcsr]
        if lvcsr not in nets:
            nets[lvcsr] = _graph_net(workdir, lvcsr)
        for attempt in range(2):
            runs, outs = {}, {}
            for label, extra in (("fuse 1", []),
                                 ("fuse 8", ["--fuse_fractions", "8",
                                             "--device_cache", "true"])):
                outs[label] = os.path.join(
                    workdir, f"graphs_{label[-1]}_{recipe}_{dtype}.jsn")
                runs[label] = run(name, label, _graph_args(
                    dtype, remat, GRAPH_EPOCHS, train_nc, val_nc,
                    nets[lvcsr], outs[label]) + extra)
            if not any(r["lost"] for r in runs.values()):
                break
            phase("graphs", f"{name}: a profile lost kernel records (bptt "
                  f"seen {[r['seen'] for r in runs.values()]}): the pair "
                  "runs again")
        else:
            raise AssertionError(
                f"{name}: the profiler saw bptt "
                f"{[r['seen'] for r in runs.values()]}, the wrappers' "
                f"counts {[r['counts']['lstm_bwd'] for r in runs.values()]}")
        one, fused = runs["fuse 1"], runs["fuse 8"]
        for label, r in runs.items():
            for ln in r["rows"]:
                phase("graphs", f"{name} {label} |{ln}")
        if fused["counts"] != one["counts"]:
            raise AssertionError(f"{name}: launches {fused['counts']} "
                                 f"against {one['counts']}")
        st = fused["st"]
        # the one kernel a capture launches itself: torch's CUDA generator
        # fills its two int64 graph-safe RNG tensors (seed, offset) as
        # each capture begins, outside the graph
        extra = {k: 2 * st["captures"] for k in fused["kernels"]
                 if "FillFunctor<long>" in k}
        less = {k: n - extra.get(k, 0) for k, n in fused["kernels"].items()}
        diff = {k: (less.get(k, 0), one["kernels"][k])
                for k in one["kernels"] | fused["kernels"]
                if less.get(k, 0) != one["kernels"][k]}
        if diff:
            raise AssertionError(f"{name}: the profiled kernels differ "
                                 f"(fused less the captures' int64 fills "
                                 f"{sum(extra.values())}, unfused): {diff}")
        got = (st["warmups"], st["captures"], st["replays"])
        if got != fused["want"] or st["eager"]:
            raise AssertionError(f"{name}: (warm-ups, captures, replays) "
                                 f"{got}, eager {st['eager']}; want "
                                 f"{fused['want']}")
        with open(outs["fuse 1"], "rb") as f1, open(outs["fuse 8"],
                                                    "rb") as f8:
            same = f1.read() == f8.read()
        rel = 0.0
        if not same:
            a, b = _weights(outs["fuse 8"]), _weights(outs["fuse 1"])
            rel = max(float(np.abs(a[k] - b[k]).max()
                            / max(np.abs(b[k]).max(), 1e-30)) for k in b)
            moved = sorted({k[0] for k in b if not np.array_equal(a[k],
                                                                  b[k])})
        errs8, errs1 = epoch_errors(fused["rows"]), epoch_errors(one["rows"])
        if recipe == "TIMIT" and (not same or errs8 != errs1):
            raise AssertionError(f"{name}: the fused run's table or "
                                 "trained_network.jsn differs")
        if rel > GRAPH_REL or not all(
                abs(x - y) <= GRAPH_REL * abs(y) + (0.005 if i % 2 == 0
                                                    else 0.0005)
                for r8, r1 in zip(errs8, errs1)
                for i, (x, y) in enumerate(zip(r8, r1))):
            raise AssertionError(f"{name}: rel {rel:.2e} > {GRAPH_REL}")
        phase("graphs", f"{name}: --fuse_fractions 8 --device_cache true "
              f"({fused['wall']:.1f} s wall under the profiler) against "
              f"--fuse_fractions 1 ({one['wall']:.1f} s): "
              f"trained_network.jsn "
              + ("bit for bit" if same else
                 f"within rel {rel:.2e} (layers whose bits moved: {moved})")
              + f", table errors {'equal' if errs8 == errs1 else 'close'}; "
              f"the profiler's kernels equal by name "
              f"({sum(one['kernels'].values())} in "
              f"{len(one['kernels'])} names; the fused run's besides: "
              f"{sum(extra.values())} int64 fills, 2 a capture), its "
              f"bptt / bptt_carry "
              f"{fused['seen']} the wrappers' K2 / K6b-b counts; warm-ups "
              f"{got[0]}, captures {got[1]}, replays {got[2]} (the "
              f"fractions less the warm-ups); capture s "
              f"{[round(x, 3) for x in st['capture_seconds']]}"
              f", pools {sum(st['pool_bytes']) / 2**20:.0f} MiB")
        torch.cuda.empty_cache()


def _fused_trainer(train_nc, val_nc, recipe, dtype, remat, fuse, cache,
                   device="cuda", **trainer_kw):
    from lstm_rnn_tpu_torch.data.dataset import DataSet
    from lstm_rnn_tpu_torch.models.flagship import (build_lvcsr_network,
                                                    build_timit_network)
    from lstm_rnn_tpu_torch.trainer import Trainer
    kw = {"parallel_sequences": 50, "sort_by_length": True,
          "bucket_lengths": True}
    train = DataSet([train_nc], trunc_seq_length=500,
                    fraction_shuffling=True, seed=SEED, **kw)
    val = DataSet([val_nc], **kw)
    build = build_lvcsr_network if recipe == "LVCSR" else build_timit_network
    net = build(seed=SEED, compute_dtype=dtype)
    net.remat_blocks = remat
    return Trainer(net, train, val, learning_rate=1e-4, momentum=0.9,
                   hybrid_online_batch=True, device=device,
                   fuse_fractions=fuse, device_cache=cache, **trainer_kw)


def _profiled_epoch(torch, tr):
    """(wall s, device-busy s, copies by name) of the third of three
    epochs under the profiler: the first two open its trace (a window's
    first launches go missing, as do a few more after a cheap opening
    step; a schedule that ends its cycle on a new one clears what the last
    one recorded)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(2):
            tr.train_epoch()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        tr.train_epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not e.key.startswith("ProfilerStep")]
    busy = sum(dev_us(e) for e in events) / 1e6
    copies = {e.key: e.count for e in events
              if e.key.startswith(("Memcpy", "Memset"))}
    return wall, busy, copies


def fused_epochs(torch, tr, timed):
    """A Trainer's epochs: the walls of epochs 1 (a warm-up a mode and
    shape) and 2 (the captures of the shapes that come once an epoch), of
    `timed` epochs after them, each synchronised, and (wall, busy s,
    copies) of the third of three epochs under the profiler."""
    walls = []
    for _ in range(2 + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_epoch()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls[:2], walls[2:], _profiled_epoch(torch, tr)


def graphs_rates(torch, card, corpora, timed=3):
    """47b: each of GRAPH_RUNS' configurations as a Trainer on phase 7's
    corpus, --fuse_fractions 1 and 8, each with the device cache off and
    on (`fused_epochs`): epochs 1 and 2, `timed` epochs and their median
    wall a step, a profiled epoch's device-busy share, the captures'
    seconds and the pools' MiB. A few epochs of 7 steps each: the spread
    of many epochs, and what a gain stands on, are
    scripts/torch_fused_rates.py's."""
    import statistics
    out = {}
    for recipe, dtype, remat in GRAPH_RUNS:
        name = f"{recipe} {'f32' if dtype == 'float32' else 'bf16'}"
        for cache in (False, True):
            for fuse in (1, 8):
                tr = _fused_trainer(*corpora[recipe if recipe == "LVCSR"
                                             else "TIMIT"],
                                    recipe, dtype, remat, fuse, cache)
                steps = (tr.train_set.num_fractions()
                         + tr.validation_set.num_fractions())
                first, walls, (pwall, busy, copies) = fused_epochs(
                    torch, tr, timed)
                med = statistics.median(walls)
                st = tr.graph_stats.as_dict()
                out[(name, fuse, cache)] = dict(
                    epochs=walls, step_ms=1e3 * med / steps,
                    busy=busy / pwall if pwall else 0.0,
                    pool_mib=sum(st["pool_bytes"]) / 2**20,
                    capture_s=st["capture_seconds"])
                phase("graphs", f"{name} fuse={fuse} cache="
                      f"{'on' if cache else 'off'}: epochs 1-2 "
                      f"{first[0]:.4f}, {first[1]:.4f} s, epochs 3-"
                      f"{2 + timed} {[round(w, 4) for w in walls]} s "
                      f"(median {1e3 * med / steps:.2f} ms a step, {steps} "
                      f"steps); profiled epoch {pwall:.4f} s, busy "
                      f"{busy:.4f} s ({100 * busy / pwall:.1f}%); captures "
                      f"{st['captures']} in {sum(st['capture_seconds']):.3f}"
                      f" s ({[round(x, 3) for x in st['capture_seconds']]}),"
                      f" pools {sum(st['pool_bytes']) / 2**20:.1f} MiB; "
                      f"copies {copies} ({card})")
                tr.drop_graphs()
                del tr
                torch.cuda.empty_cache()
    return out


def graph_corpora(workdir):
    """{"TIMIT" | "LVCSR": (train .nc, val .nc)}: phase 7's corpus (200
    train and 100 val sequences of 300-800 frames) with 183 and 10,112
    labels."""
    corpora = {}
    for recipe, states in (("TIMIT", S_STATES), ("LVCSR", S_LVCSR)):
        paths = write_corpus(workdir, recipe, states, (200, 100), SEED + 1)
        corpora[recipe] = (paths["train"][0], paths["val"][0])
    return corpora


def graphs_phase(torch, card):
    """Phase 47 (--fuse_fractions: the step graphs and the stacked epoch)
    on phase 7's corpus."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        corpora = graph_corpora(workdir)
        graphs_cli(torch, workdir, corpora)
        res = graphs_rates(torch, card, corpora)
    phase("graphs", f"phase 47 took {time.perf_counter() - t0:.0f} s")
    return res


# ------------------------- fused passes under DP and the meshes (phase 48)
# timed epochs a fuse count; the fused runs and the unfused ones are held
# bit for bit, or at 4 ranks within the fused tests' tolerance (rel 1e-6,
# atol 1e-8; tests/test_fused.py) where NCCL's order of four may move
FUSED_TIMED = 20
FUSED_ATOL = 1e-8


def _flat_close(a, b, rel=GRAPH_REL, atol=FUSED_ATOL):
    return all(np.allclose(a[n][k], b[n][k], rtol=rel, atol=atol)
               for n in b for k in b[n])


def _same_params(a, b):
    return all(np.array_equal(a[n][k], b[n][k]) for n in b for k in b[n])


def _group_trainer(corpora, fuse, group=None, mesh=None, axis="seq", m=0):
    """Phase 7's TIMIT f32 Trainer with the device cache on and fuse
    `fuse`, on a data group's rank and/or a one-process mesh (`axis`,
    its first device the Trainer's); validation never stops it."""
    kw = {f"{axis}_mesh": mesh} if mesh is not None else {}
    if axis == "pipe":
        kw["pipeline_microbatches"] = m
    device = (group.device if group is not None
              else mesh[0] if mesh is not None else "cuda")
    return _fused_trainer(*corpora["TIMIT"], "TIMIT", "float32", 0, fuse,
                          True, device=device, data_group=group,
                          max_epochs_no_best=10**6, **kw)


def _profiled_group_epoch(torch, tr, devices):
    """(wall s, compute s, NCCL s) of the third of three epochs under the
    profiler (as `_profiled_epoch`), the device time of the kernels on
    `devices` with NCCL's apart (they wait on streams of their own)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(2):
            tr.train_epoch()
            _sync(torch, devices)
            prof.step()
        t0 = time.perf_counter()
        tr.train_epoch()
        _sync(torch, devices)
        wall = time.perf_counter() - t0
        prof.step()
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and not e.key.startswith("ProfilerStep")]
    nccl = sum(dev_us(e) for e in events if "nccl" in e.key.lower()) / 1e6
    return wall, sum(dev_us(e) for e in events) / 1e6 - nccl, nccl


def _fused_layout_runs(torch, corpora, devices, runs, timed, group=None,
                       mesh=None, axis="seq", m=0):
    """Each (label, fuse, eager rank) of `runs` on a fresh Trainer:
    GRAPH_EPOCHS epochs (the parameters and epoch errors after them),
    then `timed` epochs' walls and a profiled epoch (`timed` 0, or a run
    with an eager rank: none). On the eager rank (a data group's rank, or
    None) the graphs decline their capture (`_fits`), so that its steps
    run eagerly beside the other ranks' replays."""
    from lstm_rnn_tpu_torch import graphs
    out = {}
    for label, fuse, eager_rank in runs:
        tr = _group_trainer(corpora, fuse, group, mesh, axis, m)
        fits = graphs.StepGraph._fits
        eager = eager_rank is not None and group.rank == eager_rank
        if eager:
            graphs.StepGraph._fits = lambda self: (
                self.note(f"the step of shape {self.key} runs eagerly "
                          "(declined for the check)"), False)[1]
        try:
            counters = {k: c for k, c in graphs.launch_counters().items()
                        if k.startswith(("lstm_tp_", "hop:"))}
            before = {k: c.launches for k, c in counters.items()}
            rows = []
            for _ in range(GRAPH_EPOCHS):
                tr.train_epoch()
                rows.append((tr.cur_training_error,
                             tr.cur_training_class_error,
                             tr.cur_validation_error,
                             tr.cur_validation_class_error))
            # the K8 launches and hop messages that ran (a capture's
            # counted once a replay)
            r = dict(rows=rows, params=tr.exact_params(), ran={
                k: tr.graph_stats.executed(k, c.launches - before[k])
                for k, c in counters.items()})
            if timed and eager_rank is None:
                walls = []
                for _ in range(timed):
                    _sync(torch, devices)
                    t0 = time.perf_counter()
                    tr.train_epoch()
                    _sync(torch, devices)
                    walls.append(time.perf_counter() - t0)
                r["walls"] = walls
                r["steps"] = (tr.train_set.num_fractions()
                              + tr.validation_set.num_fractions())
                r["profiled"] = _profiled_group_epoch(torch, tr, devices)
        finally:
            graphs.StepGraph._fits = fits
        r["stats"] = tr.graph_stats.as_dict()
        out[label] = r
        tr.drop_graphs()
        del tr
        torch.cuda.empty_cache()
    return out


FUSED_RUNS = (("fuse 1", 1, None), ("fuse 8", 8, None))


def _fused_dp_worker(group, workdir, corpora, runs, timed):
    """Phase 48b-c on one rank of a data group (its own GPU, or under DP x
    SP its seq mesh): `_fused_layout_runs`, to workdir."""
    import torch
    mesh = group.seq_mesh
    devices = list(mesh) if mesh is not None else [group.device]
    out = _fused_layout_runs(torch, corpora, devices, runs, timed, group,
                             mesh=list(mesh) if mesh is not None else None)
    torch.save(out, os.path.join(workdir, f"fused_rank{group.rank}.pt"))


def _report_fused(torch, card, what, res, ranks=1, exact=True):
    """Phase 48's checks and lines of one layout: each fused run (and a
    rank's eager one) against the unfused run, bit for bit (or with
    `exact` False within GRAPH_REL / FUSED_ATOL, saying which held); the
    graphs' counts; the timed epochs' median, min and max, the ms a step
    and the profiled epoch's busy share, fuse 1 and 8."""
    import statistics
    one = res["fuse 1"]
    for label, r in res.items():
        if label == "fuse 1":
            continue
        same = _same_params(r["params"], one["params"]) and (
            r["rows"] == one["rows"])
        close = _flat_close(r["params"], one["params"])
        st = r["stats"]
        phase("fused-group", f"{what} {label} against fuse 1 after "
              f"{GRAPH_EPOCHS} epochs: weights and epoch errors "
              + ("bit for bit" if same else
                 "within rel 1e-6 / atol 1e-8" if close else "DIFFER")
              + f"; warm-ups {st['warmups']}, captures {st['captures']} "
              f"({[round(x, 3) for x in st['capture_seconds']]} s), "
              f"replays {st['replays']}, eager {st['eager']}; pools "
              f"{sum(st['pool_bytes']) / 2**20:.0f} MiB")
        if not (same or (close and not exact)):
            raise AssertionError(f"{what} {label} differs from fuse 1")
        ran = {k: v for k, v in r["ran"].items() if v}
        if ran:
            phase("fused-group", f"{what} {label}: K8 launches and hop "
                  f"messages that ran {ran}, fuse 1's "
                  f"{ {k: v for k, v in one['ran'].items() if v} }")
        if r["ran"] != one["ran"]:
            raise AssertionError(f"{what} {label}: launches or messages "
                                 "that ran differ from fuse 1's")
        if st["eager"] or not st["captures"]:
            raise AssertionError(f"{what} {label}: graphs {st}")
    for label, r in res.items():
        if "walls" not in r:
            continue
        w = r["walls"]
        med = statistics.median(w)
        wall, busy, nccl = r["profiled"]
        phase("fused-rate", f"{what} {label}: {len(w)} epochs median "
              f"{med:.4f} s (min {min(w):.4f}, max {max(w):.4f}), "
              f"{1e3 * med / r['steps']:.2f} ms a step ({r['steps']} steps)"
              f"; profiled epoch {wall:.4f} s, kernels {busy:.4f} s (NCCL "
              f"{nccl:.4f} beside) over {ranks} GPU(s): busy "
              f"{100 * busy / (wall * ranks):.1f}% ({card})")


def fused_dp_one_rank(torch, workdir, corpora):
    """48a: the CLI's training body (cli.train_mode) in one NCCL rank on
    cuda:0 (parallel/launch.py start), phase 7's corpus, GRAPH_EPOCHS
    epochs, --fuse_fractions 8 --device_cache true against
    --fuse_fractions 1, each under the profiler: trained_network.jsn and
    the epoch table bit for bit; the stacked epoch taken; the launches
    that ran (the wrappers' counts with each capture's once a replay)
    equal the unfused run's, and the profiler's bptt_kernel, ce_fwd_kernel
    and pb_dw_kernel equal them (K2, K3f, K3b); the collectives that ran
    one a training step and two a pass (its error and its count)."""
    from lstm_rnn_tpu_torch.parallel.launch import start
    net = _graph_net(workdir, "TIMIT")
    base = _graph_args("float32", 0, GRAPH_EPOCHS, *corpora["TIMIT"], net,
                       "")[:-1]
    outs = [os.path.join(workdir, f"fdp_{k}.jsn") for k in (1, 8)]
    runs = [("fuse 1", base + [outs[0]]),
            ("fuse 8", base + [outs[1], "--fuse_fractions", "8",
                               "--device_cache", "true"])]
    for attempt in range(2):
        t0 = time.perf_counter()
        start(_fused_cli_worker, [torch.device("cuda", 0)], (workdir, runs),
              backend="nccl")
        wall = time.perf_counter() - t0
        res = torch.load(os.path.join(workdir, "fused_cli_rank0.pt"),
                         weights_only=False)
        lost = [label for label, r in res.items()
                if r["seen"]["bptt_kernel"] != r["counts"]["lstm_bwd"]]
        if not lost:
            break
        phase("fused-group", f"48a: a profile lost kernel records ({lost}):"
              " the pair runs again")
    else:
        raise AssertionError(f"48a: the profiler lost records: {res}")
    one, fused = res["fuse 1"], res["fuse 8"]
    with open(outs[0], "rb") as f1, open(outs[1], "rb") as f8:
        same = f1.read() == f8.read()
    st = fused["stats"]
    for label, r in res.items():
        for ln in r["rows"]:
            phase("fused-group", f"48a {label} |{ln}")
    errs = epoch_errors(fused["rows"]) == epoch_errors(one["rows"])
    seen_ok = all(r["seen"][k] == r["counts"][w] for r in res.values()
                  for k, w in (("bptt_kernel", "lstm_bwd"),
                               ("ce_fwd_kernel", "softmax_ce_proj_fwd"),
                               ("pb_dw_kernel", "softmax_ce_proj_bwd")))
    phase("fused-group", f"48a one NCCL rank on cuda:0 ({wall:.1f} s for "
          f"both runs): --fuse_fractions 8 --device_cache true against "
          f"--fuse_fractions 1: trained_network.jsn "
          f"{'bit for bit' if same else 'DIFFERS'}, table "
          f"errors {'equal' if errs else 'DIFFER'}; "
          f"launches that ran {'equal' if fused['counts'] == one['counts'] else 'DIFFER'}"
          f" (K2 {fused['counts']['lstm_bwd']}, K3f "
          f"{fused['counts']['softmax_ce_proj_fwd']}, K3b "
          f"{fused['counts']['softmax_ce_proj_bwd']}); the profiler's "
          f"bptt / ce_fwd / pb_dw "
          f"{[fused['seen'][k] for k in ('bptt_kernel', 'ce_fwd_kernel', 'pb_dw_kernel')]}"
          f" ({'equal' if seen_ok else 'NOT equal'} to them); collectives "
          f"that ran {fused['collectives']} and {one['collectives']} (want "
          f"{fused['want_collectives']}: one a training step, two a pass); "
          f"warm-ups {st['warmups']}, captures {st['captures']}, replays "
          f"{st['replays']}, eager {st['eager']}; declined: "
          f"{fused['declined'] or 'none'}")
    if not (same and errs and seen_ok
            and fused["counts"] == one["counts"]
            and fused["collectives"] == one["collectives"]
            == fused["want_collectives"] and not fused["declined"]
            and st["captures"] > 0 and not st["eager"]):
        raise AssertionError("48a: the fused run under a one-rank data "
                             "group differs from the unfused one")


def _fused_cli_worker(group, workdir, runs):
    """48a in its rank: cli.train_mode(cfg, device, group) for each
    (label, argv) of runs under the profiler, to workdir."""
    import contextlib
    import io
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lstm_rnn_tpu_torch import cli
    from lstm_rnn_tpu_torch.config import parse_config
    from lstm_rnn_tpu_torch.parallel.data import all_reduce_sum
    from lstm_rnn_tpu_torch.trainer import Trainer
    made = []

    class Recording(Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    out = {}
    for label, argv in runs:
        cfg = parse_config(argv)
        w = wrappers()
        for f in w.values():
            f.launches = 0
        coll = all_reduce_sum.collectives
        buf = io.StringIO()
        cli.Trainer = Recording
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(200):  # opens the profile (as 47a's)
                    torch.empty(8, dtype=torch.int16,
                                device=group.device).fill_(1)
                torch.cuda.synchronize()
                with contextlib.redirect_stdout(buf):
                    rc = cli.train_mode(cfg, group.device, group)
                torch.cuda.synchronize()
        finally:
            cli.Trainer = Trainer
        tr = made.pop()
        if rc:
            raise RuntimeError(f"{label}: train_mode returned {rc}")
        text = buf.getvalue()
        kernels = _profiled_kernels(prof)
        passes = 2 * GRAPH_EPOCHS  # training and validation each epoch
        out[label] = dict(
            rows=_table_rows(text),
            declined=[ln for ln in text.splitlines() if "declined" in ln],
            counts=graph_executed(tr, {k: f.launches for k, f in w.items()}),
            seen={k: sum(n for name, n in kernels.items() if k in name
                         and "carry" not in name)
                  for k in ("bptt_kernel", "ce_fwd_kernel", "pb_dw_kernel")},
            collectives=tr.graph_stats.executed(
                "collectives", all_reduce_sum.collectives - coll),
            want_collectives=(GRAPH_EPOCHS * tr.train_set.num_fractions()
                              + 2 * passes),
            stats=tr.graph_stats.as_dict())
        tr.drop_graphs()
    torch.save(out, os.path.join(workdir, f"fused_cli_rank{group.rank}.pt"))


def fused_dp_gpus(torch, card, workdir, corpora, k, timed=FUSED_TIMED):
    """48b: a data group of k ranks, one GPU each, over NCCL: fuse 8
    against fuse 1 (bit for bit at 2 ranks; at 4 bit for bit or within
    GRAPH_REL, said which), and fuse 8 with rank 1's graphs declined
    (`_fits`) so that its steps run eagerly beside the others' replays,
    its values the unfused run's; `timed` epochs of each fuse count."""
    from lstm_rnn_tpu_torch.parallel.launch import start
    runs = FUSED_RUNS + (("fuse 8, rank 1 eager", 8, 1),)
    t0 = time.perf_counter()
    start(_fused_dp_worker, [torch.device("cuda", j) for j in range(k)],
          (workdir, corpora, runs, timed), backend="nccl")
    phase("fused-group", f"48b DP on {k} GPUs: {time.perf_counter() - t0:.1f}"
          " s for its runs")
    res = [torch.load(os.path.join(workdir, f"fused_rank{r}.pt"),
                      weights_only=False) for r in range(k)]
    for r in res[1:]:
        if any(not _same_params(r[lb]["params"], res[0][lb]["params"])
               for lb in r):
            raise AssertionError(f"48b DP {k}: the ranks' weights differ")
    _report_fused(torch, card, f"48b DP {k} x 1 GPU", res[0], exact=k <= 2)
    st = res[1]["fuse 8, rank 1 eager"]["stats"]
    phase("fused-group", f"48b DP {k}: rank 1's graphs declined: warm-ups "
          f"{st['warmups']}, captures {st['captures']}, eager steps "
          f"{st['eager']}, beside rank 0's replays")
    if st["captures"] or not st["eager"]:
        raise AssertionError(f"48b DP {k}: rank 1 did not step eagerly")


def fused_meshes(torch, card, workdir, corpora, n, timed=FUSED_TIMED):
    """48c: the seq mesh of 4 blocks of cuda:0 (always), and where torch
    sees the GPUs SP over 2 GPUs and PP at 2 stages (m = 2) in one
    process, and DP x SP 2 x 2 (two ranks, each a seq mesh of 2 GPUs):
    fuse 8 against fuse 1, bit for bit, and `timed` epochs of each."""
    from lstm_rnn_tpu_torch.parallel.launch import start
    cuda = [torch.device("cuda", j) for j in range(n)]
    layouts = [("SP on 4 blocks of cuda:0", [cuda[0]] * 4, "seq", 0)]
    if n >= 2:
        layouts += [("SP on 2 GPUs", cuda[:2], "seq", 0),
                    ("PP on 2 GPUs (m = 2)", cuda[:2], "pipe", 2)]
    for what, mesh, axis, m in layouts:
        t0 = time.perf_counter()
        res = _fused_layout_runs(torch, corpora, list(dict.fromkeys(mesh)),
                                 FUSED_RUNS, timed, mesh=mesh, axis=axis,
                                 m=m)
        phase("fused-group", f"48c {what}: {time.perf_counter() - t0:.1f} s"
              " for its runs")
        _report_fused(torch, card, f"48c {what}", res,
                      ranks=len(set(mesh)))
    if n >= 4:
        t0 = time.perf_counter()
        start(_fused_dp_worker, [cuda[0:2], cuda[2:4]],
              (workdir, corpora, FUSED_RUNS, timed), backend="nccl",
              axis="seq")
        phase("fused-group", f"48c DP x SP 2 x 2: "
              f"{time.perf_counter() - t0:.1f} s for its runs")
        res = [torch.load(os.path.join(workdir, f"fused_rank{r}.pt"),
                          weights_only=False) for r in range(2)]
        if not all(_same_params(res[1][lb]["params"], res[0][lb]["params"])
                   for lb in res[0]):
            raise AssertionError("48c DP x SP: the ranks' weights differ")
        _report_fused(torch, card, "48c DP x SP 2 x 2", res[0], ranks=2)


def _trace_devices(directory):
    """The devices of the kernels in a --profile_dir's Chrome traces (one
    a rank)."""
    found = set()
    for name in os.listdir(directory):
        with open(os.path.join(directory, name)) as f:
            trace = json.load(f)
        found |= {e.get("args", {}).get("device", e.get("pid"))
                  for e in trace.get("traceEvents", [])
                  if e.get("cat") == "kernel"}
    return sorted(found)


def multihost_from_env(torch, workdir, corpora, n):
    """48d: the repair of multi-host auto-detection (parallel/cluster.py)
    on the card. With 2 GPUs: two CLI processes started with
    JAX_COORDINATOR_ADDRESS and SLURM's variables alone (SLURM_LOCALID 0
    and 1) against the one-process --num_devices 2 run, bit for bit, each
    process's kernels on cuda:{SLURM_LOCALID} (its --profile_dir trace);
    on one card one process from the environment (SLURM_NTASKS=1: NCCL
    takes one rank a GPU) against the plain run. Both sides with
    --fuse_fractions 8 --device_cache true."""
    net = _graph_net(workdir, "TIMIT")
    args = _graph_args("float32", 0, GRAPH_EPOCHS, *corpora["TIMIT"], net,
                       "trained.jsn") + ["--fuse_fractions", "8",
                                         "--device_cache", "true"]
    k = 2 if n >= 2 else 1
    port = _free_port()
    t0 = time.perf_counter()
    ref_dir = os.path.join(workdir, "env_ref")
    # the reference and the processes at once: they share the GPUs
    ref = cli_process(args + (["--num_devices", "2"] if k == 2 else []),
                      ref_dir)
    procs = []
    for i in range(k):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   SLURM_JOB_ID="4242", SLURM_STEP_NODELIST="localhost",
                   SLURM_NTASKS=str(k), SLURM_PROCID=str(i),
                   SLURM_LOCALID=str(i))
        procs.append(cli_process(args + ["--profile_dir", "prof"],
                                 os.path.join(workdir, f"env{i}"), env))
    outs = [finish(p, f"process {i} from the environment")
            for i, p in enumerate(procs)]
    finish(ref, "the flag-started run")
    wall = time.perf_counter() - t0
    with open(os.path.join(ref_dir, "trained.jsn"), "rb") as f:
        want = f.read()
    with open(os.path.join(workdir, "env0", "trained.jsn"), "rb") as f:
        same = f.read() == want
    devices = [_trace_devices(os.path.join(workdir, f"env{i}", "prof"))
               for i in range(k)]
    banner = ("Data-parallel mesh: {'data': 2} over 2 hosts" in outs[0]
              if k == 2 else "Data-parallel mesh: {'data': 1}" in outs[0])
    phase("fused-group", f"48d {k} process(es) from JAX_COORDINATOR_ADDRESS "
          f"and SLURM's variables ({wall:.1f} s with the reference) against "
          + ("--num_devices 2" if k == 2 else "the plain run")
          + f": trained_network {'bit for bit' if same else 'DIFFERS'}; "
          f"the kernels of process i on {devices}; banner "
          f"{'printed' if banner else 'MISSING'}")
    if not (same and banner and devices == [[i] for i in range(k)]):
        raise AssertionError("48d: the run from the environment differs")


def fused_group_phase(torch, card):
    """Phase 48: --fuse_fractions under a data group and the one-process
    seq and pipe meshes (48a-c), and multi-host runs from the environment
    (48d), on phase 7's corpus."""
    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        corpora = graph_corpora(workdir)
        fused_dp_one_rank(torch, workdir, corpora)
        if n >= 2:
            for k in (2, 4):
                if k <= n:
                    fused_dp_gpus(torch, card, workdir, corpora, k)
        else:
            phase("fused-group", "48b (DP on 2 and 4 GPUs) was not run: "
                  "torch sees one GPU")
        fused_meshes(torch, card, workdir, corpora, n)
        multihost_from_env(torch, workdir, corpora, n)
    phase("fused-group", f"phase 48 took {time.perf_counter() - t0:.0f} s")


# ------------------ fused passes under TP and across processes (phase 49)
def _fused_span_worker(group, workdir, corpora, axis, m, runs, timed):
    """Phase 49c on one process of a span over NCCL: `_fused_layout_runs`
    on its positions of a seq or pipe mesh, to workdir."""
    import torch
    out = _fused_layout_runs(torch, corpora, group.span.local, runs, timed,
                             group, mesh=group.span, axis=axis, m=m)
    torch.save(out, os.path.join(workdir, f"fused_span_rank{group.rank}.pt"))


def _staged_span_worker(group, workdir, corpora):
    """Phase 49d on one of two processes sharing cuda:0 over gloo (every
    hop staged through host memory): fuse 1 and fuse 8, GRAPH_EPOCHS
    epochs each of the SP Trainer; the rows, weights, graph counts and
    what the Trainer printed, to workdir."""
    import io
    import torch
    out = {}
    for label, fuse in (("fuse 1", 1), ("fuse 8", 8)):
        tr = _group_trainer(corpora, fuse, group, group.span, "seq")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = []
            for _ in range(GRAPH_EPOCHS):
                tr.train_epoch()
                rows.append((tr.cur_training_error,
                             tr.cur_validation_error))
        out[label] = dict(rows=rows, params=tr.exact_params(),
                          stats=tr.graph_stats.as_dict(), out=buf.getvalue())
        del tr
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(workdir, f"staged_rank{group.rank}.pt"))


def fused_tp_span_phase(torch, card, distinct=False):
    """Phase 49: --fuse_fractions under a model mesh and on a seq or pipe
    mesh across processes, on phase 7's corpus (TIMIT f32, the cache on):
    49a the TIMIT Trainer at model_devices 5 on cuda:0, fuse 8 against
    fuse 1 bit for bit, FUSED_TIMED epochs of each with the busy share,
    the K8 launches that ran equal; 49b (2+ GPUs) the same with the 5
    shards over cuda:0 and cuda:1 (peer stores between them); 49c (2+ GPUs) SP and PP (m = 2) over two processes of one
    GPU each over NCCL, fuse 8 against fuse 1, the hop messages that ran
    equal; 49d two processes on cuda:0 over gloo: fuse 8 prints the
    Trainer's note, steps eagerly (no capture) and equals fuse 1 bit for
    bit. (CHiME autoencoding on 2 GPUs and DP x TP fused: phase 44.)
    `distinct`: only the parts on distinct GPUs (49b-c)."""
    from lstm_rnn_tpu_torch.parallel.launch import start
    t0 = time.perf_counter()
    n = torch.cuda.device_count()
    cuda = [torch.device("cuda", j) for j in range(n)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        corpora = graph_corpora(workdir)
        layouts = ([] if distinct else
                   [("49a TP 5 shards of cuda:0", [cuda[0]] * TP_TIMIT)])
        if n >= 2:
            # TIMIT's 125 cells take 5 shards: 3 on cuda:0, 2 on cuda:1
            layouts.append(("49b TP 5 shards over 2 GPUs",
                            [cuda[j % 2] for j in range(TP_TIMIT)]))
        for what, mesh in layouts:
            t1 = time.perf_counter()
            res = _fused_layout_runs(torch, corpora,
                                     list(dict.fromkeys(mesh)), FUSED_RUNS,
                                     FUSED_TIMED, mesh=mesh, axis="model")
            phase("fused-tp", f"{what}: {time.perf_counter() - t1:.1f} s "
                  "for its runs")
            _report_fused(torch, card, what, res, ranks=len(set(mesh)))
        if n >= 2:
            for kind, m in (("seq", 0), ("pipe", 2)):
                t1 = time.perf_counter()
                for f in glob.glob(os.path.join(workdir, "fused_span_*")):
                    os.remove(f)
                start(_fused_span_worker, [[cuda[0]], [cuda[1]]],
                      (workdir, corpora, kind, m, FUSED_RUNS, FUSED_TIMED),
                      backend="nccl", span=True, timeout_s=XH_TIMEOUT_S)
                res = [torch.load(os.path.join(
                    workdir, f"fused_span_rank{r}.pt"), weights_only=False)
                    for r in range(2)]
                what = (f"49c {'SP' if kind == 'seq' else 'PP m = 2'} "
                        "over 2 processes x 1 GPU (NCCL)")
                phase("fused-tp", f"{what}: {time.perf_counter() - t1:.1f}"
                      " s for its runs")
                if not all(_same_params(res[1][lb]["params"],
                                        res[0][lb]["params"])
                           for lb in res[0]):
                    raise AssertionError(f"{what}: the ranks' weights "
                                         "differ")
                _report_fused(torch, card, what, res[0])
        else:
            phase("fused-tp", "49b-c (TP over 2 GPUs; SP and PP across "
                  "processes over NCCL) were not run: torch sees one GPU")
        if distinct:
            phase("fused-tp", f"phase 49 (2+ GPUs) took "
                  f"{time.perf_counter() - t0:.0f} s")
            return
        t1 = time.perf_counter()
        start(_staged_span_worker, [[cuda[0]], [cuda[0]]],
              (workdir, corpora), backend="gloo", span=True,
              timeout_s=XH_TIMEOUT_S)
        res = [torch.load(os.path.join(workdir, f"staged_rank{r}.pt"),
                          weights_only=False) for r in range(2)]
        note = ("fuse_fractions=8: no step graph holds a seq or pipe mesh "
                "that spans processes; every pass steps one fraction at a "
                "time (the same values)")
        for r, rr in enumerate(res):
            one, fused = rr["fuse 1"], rr["fuse 8"]
            same = (fused["rows"] == one["rows"]
                    and _same_params(fused["params"], one["params"]))
            st = fused["stats"]
            phase("fused-tp", f"49d SP over 2 processes on cuda:0 (gloo, "
                  f"staged), rank {r}: fuse 8 against fuse 1 "
                  f"{'bit for bit' if same else 'DIFFERS'}; the note "
                  f"{'printed' if note in fused['out'] else 'MISSING'}; "
                  f"captures {st['captures']}, warm-ups {st['warmups']} "
                  f"({time.perf_counter() - t1:.1f} s)")
            if not (same and note in fused["out"] and st["captures"] == 0
                    and st["warmups"] == 0):
                raise AssertionError("49d: the staged span fused or "
                                     "differs")
    phase("fused-tp", f"phase 49 took {time.perf_counter() - t0:.0f} s")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU; nothing to run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    # outside a checkout of the repository this raises before any output
    from lstm_rnn_tpu_torch.ops import _build
    card = card_line()
    phase("device", f"python {sys.version.split()[0]}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", "TF32 off (matmul and cuDNN)")

    t0 = time.perf_counter()
    _build.load()
    phase("build", f"kernel library ready in {time.perf_counter() - t0:.1f} s"
          f" ({os.path.relpath(_build.library_path(), REPO)})")
    report_ptxas(_build.build_log())
    check_hgmma(_build)
    report_plans(torch)

    with torch.inference_mode():
        res = kernel_vs_twin(torch)
    with torch.no_grad():
        tres = train_kernels_vs_twins(torch)
        wres = wide_kernels_vs_twins(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        launches_fwd, nc = end_to_end(torch, workdir)
        forward_rates(torch, nc, card)
        profile_fraction(torch, nc)
        step_kernel_vs_scan(torch)
        launches, tables = train_end_to_end(torch, workdir)
        lvcsr_step_fused_vs_unfused(torch)
        lvcsr_launches, lvcsr_tables = lvcsr_cli(torch, workdir)
        # phase 24 compares with phase 7's trained networks, kept here
        remat_launches = remat_cli(torch, workdir, tables)
        # phase 40c trains on phase 7's and phase 11's corpora, kept here
        x3_launches = three_pass_cli(torch, workdir, tables, lvcsr_tables)
    gemm_paths = {"serving": gemm_total(launches_fwd),
                  "TIMIT training": gemm_total(launches)}
    launches["lstm_fwd"] = launches_fwd["lstm_fwd"]
    gemm_paths["LVCSR training"] = gemm_total(lvcsr_launches)
    for k in ("softmax_ce_wide_fwd", "softmax_ce_wide_bwd"):
        launches[k] = lvcsr_launches[k]
    train_rates(torch, card)
    profile_step(torch)
    lvcsr_rates(torch, card)
    profile_step(torch, lvcsr=True)
    profile_step(torch, lvcsr=True, dtype="bfloat16")
    with torch.no_grad():
        tail_crossover(torch)
    with torch.inference_mode():
        cres = carry_kernel_vs_twin(torch)
        chained_vs_whole(torch)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            nc, _, tags, lengths = write_inputs(workdir)
            stream_launches = stream_cli(torch, workdir, nc, tags, lengths)
        launches["lstm_fwd_carry"] = stream_launches["lstm_fwd_carry"]
        gemm_paths["streaming"] = gemm_total(stream_launches)
        stream_rates(torch, card)
    with torch.no_grad():
        cgres = carry_grad_kernels_vs_twins(torch)
    chained_blocks_vs_whole(torch)
    sp_step_vs_single(torch, sp_mesh(torch))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        sp_launches = sp_trainer_epochs(torch, workdir, sp_mesh(torch))
        sp_serving(torch, workdir, sp_mesh(torch))
        sp_cli(torch, workdir)
    for k in ("lstm_fwd_carry_save", "lstm_bwd_carry"):
        launches[k] = sp_launches[k]
    gemm_paths["SP training"] = gemm_total(sp_launches)
    sp_rates(torch, card, [sp_mesh(torch)])
    with torch.no_grad():
        pres = plain_kernels_vs_twins(torch)
    remat_steps(torch)
    remat_rates_memory(torch, card)
    profile_step(torch, remat_blocks=4)
    profile_step(torch, lvcsr=True, remat_blocks=4)
    for k in ("softmax_ce_fwd", "softmax_ce_bwd"):
        launches[k] = remat_launches[k]
    gemm_paths["remat training"] = gemm_total(remat_launches)
    with torch.no_grad():
        gres = gemm_engine_vs_twin(torch)
    wide_lstm_route(torch)
    wide_p_tail_route(torch)
    bf16_feedforward(torch)
    with torch.no_grad():
        chime_plans(torch)
        chres = chime_kernels_vs_twins(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        chime_launches = chime_cli(torch, workdir)
        init_rng_cli(torch, workdir)
    noise_draw_on_card(torch)
    noisy_steps(torch)
    noisy_rates(torch, card)
    with torch.no_grad():
        dres = dp_rank_kernels(torch)
    dp_rank_steps(torch, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        dp_launches = dp_on_one_card(torch, workdir)
    if torch.cuda.device_count() >= 2:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            dp_cli(torch, workdir, torch.cuda.device_count())
            dp_rates(torch, card, workdir, torch.cuda.device_count())
    else:
        phase("dp-cli", "phase 35 (DP on distinct GPUs) was not run: torch "
              "sees one GPU")
    with torch.no_grad():
        dsres = dp_sp_rank_kernels(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        dpsp_step, dpsp_epochs = dp_sp_on_one_card(torch, workdir)
    with torch.inference_mode():
        dstres = dp_stream_rank_kernel(torch)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        dpstream_launches = dp_streaming_on_one_card(torch, workdir)
    if torch.cuda.device_count() >= 4:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            dp_sp_cli(torch, workdir, torch.cuda.device_count())
            dp_sp_rates(torch, card, workdir, torch.cuda.device_count())
    else:
        phase("dpsp-cli", "phase 38 (DP x SP and DP streaming on distinct "
              f"GPUs) was not run: torch sees {torch.cuda.device_count()} "
              "GPU(s), it needs 4")
    dispatch_phase(torch, card)
    with torch.no_grad():
        x3_engine = three_pass_engine(torch, gres)
        x3_tails = three_pass_tails(torch, wres)
    three_pass_rates(torch, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        tools_chain(torch, workdir)
        recipes_on_card(workdir)
    pp_launches = pp_steps(torch, card)
    pp_rates(torch, card)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        pp_serve = pp_serving(torch, workdir)
    t43 = time.perf_counter()
    with torch.no_grad():
        tpk = tp_kernels_vs_twins(torch)
    tp_res = tp_steps(torch, card)
    phase("tp-step", f"phase 43 took {time.perf_counter() - t43:.0f} s")
    n_gpus = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if n_gpus >= 2:
            pp_tp_cli(torch, workdir, n_gpus)
            pp_tp_distinct(torch, card, n_gpus)
        else:
            pp_tp_refused_on_one_gpu(torch, workdir)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        xh_steps = cross_host(torch, card, workdir, n_gpus)
    graphs_phase(torch, card)
    fused_group_phase(torch, card)
    fused_tp_span_phase(torch, card)

    source = {"lstm_fwd": "lstm_fwd.cu", "lstm_fwd_save": "lstm_fwd.cu",
              "lstm_bwd": "lstm_bwd.cu", "softmax_ce_proj_fwd":
              "softmax_ce.cu", "softmax_ce_proj_bwd": "softmax_ce.cu",
              "softmax_ce_wide_fwd": "softmax_ce_wide.cu",
              "softmax_ce_wide_bwd": "softmax_ce_wide.cu",
              "lstm_fwd_carry": "lstm_fwd.cu",
              "lstm_fwd_carry_save": "lstm_fwd.cu",
              "lstm_bwd_carry": "lstm_bwd.cu",
              "softmax_ce_fwd": "softmax_ce_plain.cu",
              "softmax_ce_bwd": "softmax_ce_plain.cu"}
    replaces = {"lstm_fwd": "lstm_rnn_tpu/ops/lstm_cell.py:164",
                "lstm_fwd_save": "lstm_rnn_tpu/ops/lstm_cell.py:164",
                "lstm_bwd": "lstm_rnn_tpu/ops/lstm_cell.py:284",
                "softmax_ce_proj_fwd": "lstm_rnn_tpu/ops/softmax_ce.py:350",
                "softmax_ce_proj_bwd": "lstm_rnn_tpu/ops/softmax_ce.py:361",
                "softmax_ce_wide_fwd": "lstm_rnn_tpu/ops/softmax_ce.py:568",
                "softmax_ce_wide_bwd": "lstm_rnn_tpu/ops/softmax_ce.py:575",
                "lstm_fwd_carry": "lstm_rnn_tpu/ops/lstm_cell.py:164",
                "lstm_fwd_carry_save": "lstm_rnn_tpu/ops/lstm_cell.py:164",
                "lstm_bwd_carry": "lstm_rnn_tpu/ops/lstm_cell.py:284",
                "softmax_ce_fwd": "lstm_rnn_tpu/ops/softmax_ce.py:163",
                "softmax_ce_bwd": "lstm_rnn_tpu/ops/softmax_ce.py:169"}
    # each kernel at the shape its path gives it: K0 at P=250, T=800; K1
    # and K2 at P=250, T=500; the tails over 25,000 frames (K3 at 183
    # states, K4 at 10,112); the carry kernel at P=250 over one 64-frame
    # chunk of the streaming stack; the K6b kernels at P=250 over one
    # 125-frame SP block of a TIMIT layer, dir_offset 0; K5 over the
    # TIMIT remat step's 25,000 frames of 183 states
    rows = {"lstm_fwd": (res[(250, "float32")], res[(250, "bfloat16")])}
    for k in ("lstm_fwd_save", "lstm_bwd", "softmax_ce_proj_fwd",
              "softmax_ce_proj_bwd"):
        rows[k] = (tres[(k, 250, "float32")], tres[(k, 250, "bfloat16")])
    for k in ("softmax_ce_wide_fwd", "softmax_ce_wide_bwd"):
        rows[k] = (wres[(k, "float32")], wres[(k, "bfloat16")])
    rows["lstm_fwd_carry"] = (cres[(250, "float32")], cres[(250, "bfloat16")])
    for k in ("lstm_fwd_carry_save", "lstm_bwd_carry"):
        rows[k] = (cgres[(k, 250, 0, "float32")],
                   cgres[(k, 250, 0, "bfloat16")])
    for k in ("softmax_ce_fwd", "softmax_ce_bwd"):
        rows[k] = (pres[(k, S_STATES, "float32")],
                   pres[(k, S_STATES, "bfloat16")])
    kernels = []
    for k, (r32, r16) in rows.items():
        b32, by32 = bound(*r32["cost"], "float32")
        b16, _ = bound(*r16["cost"], "bfloat16")
        kernels.append({
            "name": k, "route": "cuda",
            "source": f"lstm_rnn_tpu_torch/csrc/{source[k]}",
            "replaces": replaces[k], "launches": launches[k],
            "max_abs_err": r32["err"], "ms": r32["ms"],
            "plain_ms": r32["plain_ms"], "bound_ms": b32, "bound_by": by32,
            "library_ms": r32.get("library_ms"),
            "max_abs_err_bf16": r16["err"], "ms_bf16": r16["ms"],
            "plain_ms_bf16": r16["plain_ms"], "bound_ms_bf16": b16,
            "library_ms_bf16": r16.get("library_ms")})
        if "loss_rel" in r32:
            kernels[-1]["loss_rel_err"] = r32["loss_rel"]
        if "us_per_step" in r32:  # the recurrence alone, a step of it
            for k2, r in (("", r32), ("_bf16", r16)):
                kernels[-1]["recurrence_ms" + k2] = r["rec_ms"]
                kernels[-1]["us_per_step" + k2] = r["us_per_step"]
        if k == "lstm_fwd_carry":
            kernels[-1]["variant"] = "carry=True, with_mask=True"
        if k in ("lstm_fwd_carry_save", "lstm_bwd_carry"):
            kernels[-1]["variant"] = "carry=True, save=True, dir_offset=0"
        if "events_ms" in r32:  # K3, K4, K5: ms on the device, events
            for k2, r in (("", r32), ("_bf16", r16)):
                kernels[-1]["events_ms" + k2] = r["events_ms"]
                kernels[-1]["library_events_ms" + k2] = r["library_events_ms"]
        if "products_ms" in r32:  # K4's products outside, on the device
            kernels[-1]["products_ms"] = r32["products_ms"]
            kernels[-1]["products_ms_bf16"] = r16["products_ms"]
        if k in ("softmax_ce_fwd", "softmax_ce_bwd"):
            # K5 at the LVCSR width too (the row above is TIMIT's)
            for k2, d in (("", "float32"), ("_bf16", "bfloat16")):
                r = pres[(k, S_LVCSR, d)]
                kernels[-1][f"lvcsr{k2}"] = {
                    "ms": r["ms"], "library_ms": r["library_ms"],
                    "bound_ms": bound(*r["cost"], d)[0]}
    # the CHiME recipes' shapes of the kernels on their path (phase 30a),
    # and the launches of phase 30b's six runs and its control
    for row in kernels:
        shapes = sorted({sh for (k, sh, _) in chres if k == row["name"]})
        if not shapes:
            continue
        row["chime_launches"] = chime_launches[row["name"]]
        row["chime"] = {}
        for sh in shapes:
            r32, r16 = chres[(row["name"], sh, "float32")], chres[
                (row["name"], sh, "bfloat16")]
            row["chime"][sh] = {
                "max_abs_err": r32["err"], "ms": r32["ms"],
                "plain_ms": r32["plain_ms"],
                "bound_ms": bound(*r32["cost"], "float32")[0],
                "library_ms": r32.get("library_ms"),
                "max_abs_err_bf16": r16["err"], "ms_bf16": r16["ms"],
                "plain_ms_bf16": r16["plain_ms"],
                "bound_ms_bf16": bound(*r16["cost"], "bfloat16")[0],
                "library_ms_bf16": r16.get("library_ms")}
    # each data-parallel rank's shapes (phase 33a: one rank's block of B =
    # 13 and 25 sequences) and a rank's launches of one DP step (phase 34)
    for row in kernels:
        shapes = sorted({sh for (k, sh, _) in dres if k == row["name"]})
        if not shapes:
            continue
        row["dp_launches_per_rank_step"] = dp_launches[row["name"]]
        row["per_rank"] = {}
        for sh in shapes:
            r32, r16 = dres[(row["name"], sh, "float32")], dres[
                (row["name"], sh, "bfloat16")]
            row["per_rank"][sh] = {
                "max_abs_err": r32["err"], "ms": r32["ms"],
                "bound_ms": bound(*r32["cost"], "float32")[0],
                "max_abs_err_bf16": r16["err"], "ms_bf16": r16["ms"],
                "bound_ms_bf16": bound(*r16["cost"], "bfloat16")[0]}
    # a DP x SP rank's block (phase 36a: B = 25, T = 250) and a rank's
    # launches of one step and of 2 epochs (phase 36b-c); a DP streaming
    # rank's 32 streams (phase 37a) and its launches over one fraction
    # (phase 37b)
    for row in kernels:
        for key, found, launches in (
                ("dp_sp", dsres, {"step": dpsp_step,
                                  "2 epochs": dpsp_epochs}),
                ("dp_stream", dstres, {"fraction": dpstream_launches})):
            shapes = sorted({sh for (k, sh, _) in found if k == row["name"]})
            if not shapes:
                continue
            row[f"{key}_launches_per_rank"] = {
                what: counts[row["name"]] for what, counts in
                launches.items()}
            row[f"{key}_per_rank"] = {}
            for sh in shapes:
                r32, r16 = found[(row["name"], sh, "float32")], found[
                    (row["name"], sh, "bfloat16")]
                row[f"{key}_per_rank"][sh] = {
                    "max_abs_err": r32["err"], "ms": r32["ms"],
                    "plain_ms": r32["plain_ms"],
                    "bound_ms": bound(*r32["cost"], "float32")[0],
                    "max_abs_err_bf16": r16["err"], "ms_bf16": r16["ms"],
                    "plain_ms_bf16": r16["plain_ms"],
                    "bound_ms_bf16": bound(*r16["cost"], "bfloat16")[0]}
    # pipeline parallelism (phase 42): the launches of one pipelined step
    # of each configuration (its microbatches are phase 33a's rank shapes:
    # B = 25 at m = 2, 13 at m = 4) and of one served fraction; tensor
    # parallelism (phase 43): the TP steps' tail launches
    for row in kernels:
        pp = {f"{name} {dtype} pp={k} m={m}": counts[row["name"]]
              for (name, dtype, k, m), counts in pp_launches.items()
              if counts[row["name"]]}
        if pp:
            row["pp_launches_per_step"] = pp
            row["pp_microbatch_shapes"] = "per_rank (B = 25 at m = 2, 13 " \
                "at m = 4)"
        if row["name"] == "lstm_fwd":
            row["pp_launches_per_served_fraction"] = {
                f"pp={k} m={m}": n for (k, m), n in pp_serve.items()}
        tp = {f"{name} model_devices="
              f"{TP_TIMIT if name == 'TIMIT' else TP_CHIME}":
              counts[row["name"]] for name, (_, _, counts) in tp_res.items()
              if counts[row["name"]]}
        if tp:
            row["tp_launches_per_step"] = tp
    for (name, dtype, k, m), counts in pp_launches.items():
        gemm_paths[f"PP {name} {dtype} step pp={k} m={m}"] = gemm_total(
            counts)
    # a mesh over processes (phases 45-46): each process's launches of one
    # step, by layout
    for row in kernels:
        xh = {f"{layout} {'LVCSR' if lvcsr else 'TIMIT'} {dtype} "
              f"{'SP' if kind == 'seq' else f'PP m={m}'}":
              [r["counts"][row["name"]] for r in rs]
              for layout, steps in xh_steps.items()
              for (kind, lvcsr, dtype, m), rs in steps.items()
              if any(r["counts"][row["name"]] for r in rs)}
        if xh:
            row["cross_host_launches_per_process_step"] = xh
    for layout, steps in xh_steps.items():
        for (kind, lvcsr, dtype, m), rs in steps.items():
            gemm_paths[f"{layout} {'LVCSR' if lvcsr else 'TIMIT'} {dtype} "
                       f"{'SP' if kind == 'seq' else f'PP m={m}'} (each "
                       "process)"] = sum(gemm_total(r["counts"]) for r in rs)
    gemm_paths["DP x SP training (a rank, 2 epochs)"] = gemm_total(
        dpsp_epochs)
    gemm_paths["DP streaming (a rank, one fraction)"] = gemm_total(
        dpstream_launches)
    # the TP layer's kernels (phase 43a at a TIMIT layer, 5 shards of
    # cuda:0); launches of one TP step (phase 43b-c); no pallas_call: the
    # JAX TP layer is a lax.scan inside shard_map, an all_gather a step
    for k in ("lstm_tp_fwd", "lstm_tp_bwd"):
        r = tpk[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "lstm_rnn_tpu_torch/csrc/lstm_tp.cu",
            "replaces": "lstm_rnn_tpu/parallel/tensor.py:107",
            "replaces_what": "not a pallas_call: the JAX TP layer's "
                             "lax.scan in shard_map (all_gather a step)",
            "variant": ("tp_rec_kernel save=True (the training forward)"
                        if k == "lstm_tp_fwd" else "tp_bptt_kernel"),
            "launches": tp_res["TIMIT"][2][k],
            "launches_by_path": {f"TP {name} step": counts[k]
                                 for name, (_, _, counts) in tp_res.items()},
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None})
    # the GEMM engine at the dW_in product of a TIMIT layer (P = 250: the
    # largest share of its time on the training step), every shape beside
    g32, g16 = gres[("dW_in:250", "float32")], gres[("dW_in:250", "bfloat16")]
    kernels.append({
        "name": "gemm", "route": "cuda",
        "source": "lstm_rnn_tpu_torch/csrc/gemm.cuh",
        "replaces": "lstm_rnn_tpu/ops/lstm_cell.py:449",
        "replaces_also": ["lstm_rnn_tpu/ops/lstm_cell.py:227",
                          "lstm_rnn_tpu/ops/lstm_cell.py:475",
                          "lstm_rnn_tpu/ops/lstm_cell.py:491",
                          "lstm_rnn_tpu/ops/softmax_ce.py:575"],
        "variant": "dW_in at P=250 (T*B=25,000 rows, two directions)",
        "launches": sum(gemm_paths.values()),
        "launches_by_path": gemm_paths,
        "max_abs_err": g32["err"], "ms": g32["ms"],
        "plain_ms": g32["plain_ms"],
        "bound_ms": bound(*g32["cost"], "float32")[0],
        "bound_by": bound(*g32["cost"], "float32")[1],
        "library_ms": g32["library_ms"],
        "max_abs_err_bf16": g16["err"], "ms_bf16": g16["ms"],
        "plain_ms_bf16": g16["plain_ms"],
        "bound_ms_bf16": bound(*g16["cost"], "bfloat16")[0],
        "library_ms_bf16": g16["library_ms"],
        "shapes": {f"{n} {d}": {"ms": r["ms"], "library_ms": r["library_ms"],
                                "bound_ms": bound(*r["cost"], d)[0]}
                   for (n, d), r in gres.items()}})
    # the 3x instances (phase 40): the engine's at dW_in P=250, every
    # shape beside, and K4b's at the LVCSR tail; launches of phase 40c's
    # two CLI runs (TIMIT and LVCSR, 2 epochs each)
    e3 = x3_engine["dW_in:250"]
    k4_products = {f"{key[0]} S={key[1]}": {
        "ms": r["ms"], "library_ms": r["library_ms"],
        "bound_ms": r["bound"][0], "rel_err_vs_exact_f32": r["rel_exact"]}
        for key, r in x3_tails.items()
        if isinstance(key, tuple) and key[0] != "K4b dW"}
    kernels.append({
        "name": "gemm_3x", "route": "cuda",
        "source": "lstm_rnn_tpu_torch/csrc/gemm.cuh",
        "replaces": "lstm_rnn_tpu/ops/lstm_cell.py:449",
        "replaces_also": ["lstm_rnn_tpu/ops/lstm_cell.py:227",
                          "lstm_rnn_tpu/ops/lstm_cell.py:475",
                          "lstm_rnn_tpu/ops/lstm_cell.py:491",
                          "lstm_rnn_tpu/ops/softmax_ce.py:355",
                          "lstm_rnn_tpu/ops/softmax_ce.py:375",
                          "lstm_rnn_tpu/ops/softmax_ce.py:378",
                          "lstm_rnn_tpu/ops/softmax_ce.py:633",
                          "lstm_rnn_tpu/ops/softmax_ce.py:699"],
        "variant": "--f32_matmul 3x (gemm3x_kernel), dW_in at P=250",
        "launches": sum(v for c in x3_launches.values()
                        for k, v in c.items()
                        if k.startswith("gemm:") and k.endswith(":3x")),
        "launches_by_path": {k: {u: v for u, v in c.items()
                                 if u.endswith(":3x") and v}
                             for k, c in x3_launches.items()},
        "max_abs_err": e3["err"], "rel_err_vs_exact_f32": e3["rel_exact"],
        "ms": e3["ms"], "plain_ms": e3["plain_ms"],
        "bound_ms": e3["bound"][0], "bound_by": e3["bound"][1],
        "library_ms": e3["library_ms"], "f32_simt_ms": e3["f32_ms"],
        "shapes": {n: {"ms": r["ms"], "f32_simt_ms": r["f32_ms"],
                       "library_ms": r["library_ms"],
                       "bound_ms": r["bound"][0],
                       "rel_err_vs_exact_f32": r["rel_exact"]}
                   for n, r in x3_engine.items()},
        "k4_products": k4_products})
    k3 = x3_tails["softmax_ce_wide_bwd_3x"]
    kernels.append({
        "name": "softmax_ce_wide_bwd_3x", "route": "cuda",
        "source": "lstm_rnn_tpu_torch/csrc/softmax_ce_wide.cu",
        "replaces": "lstm_rnn_tpu/ops/softmax_ce.py:575",
        "variant": "--f32_matmul 3x (wide_bwd_3x_kernel), the LVCSR tail",
        "launches": x3_launches["LVCSR"]["softmax_ce_wide_bwd_3x"],
        "max_abs_err": k3["err"], "rel_err_vs_exact_f32": k3["rel_exact"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound"][0], "bound_by": k3["bound"][1],
        "library_ms": None, "cublas_dW_ms": k3["cublas_dw_ms"],
        "f32_simt_ms": k3["f32_ms"]})
    phase("done", "each report tag's first and last line, s since the "
          "start: " + ", ".join(f"{name} {lo:.0f}-{hi:.0f}"
                                 for name, (lo, hi) in _SPANS.items()))
    phase("done", f"chip_smoke.py took {time.perf_counter() - _T0:.0f} s "
          "in all, the build included")
    print(json.dumps({"kernels": kernels}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
