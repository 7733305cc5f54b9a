#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero without the final line:

  1. build    every CUDA kernel of the served paths from
              deeplearning4j_tpu_torch/csrc (one nvcc per source, started
              together), with the build time and ptxas' resource report.
  2. kernel   each kernel against its plain PyTorch version on the card:
              bn_act at every (shape, activation) the ResNet-50 path gives
              it at the serving batch (float32, bfloat16) and at the
              training batch of 64 (bfloat16), flash_attention at the TransformerLM
              path's shape (16, 8, 512, 64) causal with and without lse and
              at edge cases (ragged t, t=1, non-causal, head dims 16, 32,
              128), in float32 and bfloat16: max error against the stated
              tolerance, kernel / plain / one-library-call times (CUDA
              events, inputs rotated through more than the 50 MB L2) and the
              least time the card could take (bytes or operations over the
              card's published rates).
  3. serve    zoo ResNet-50 (1000 classes, 224x224x3, random weights from a
              seed) behind InferenceServer (batch_limit 32), warmed up,
              answering concurrent requests of 1, 3, 8 and 32 rows and then
              a stream of 32-row requests; every answer finite softmax rows
              equal to net.output on the same rows; bn_act must have run
              53 times per dispatched batch.
  4. refer    the same seeded ResNet-50 on the CPU (plain epilogue, exact
              float32) against the card with TF32 off, vertex by vertex.
  5. serve-lm zoo TransformerLM (vocab 8192, max length 512, d_model 512,
              8 heads, 6 blocks, random weights from a seed) behind
              InferenceServer (batch_limit 16), warmed up with a [1, 512]
              int32 example, answering concurrent requests of 1, 3, 8 and
              16 rows of 512 token ids and then a stream of 16-row requests;
              every answer finite (n, 512, 8192) softmax rows equal to
              net.output on the same rows; flash_attention must have run 6
              times per dispatched batch.
  6. refer-lm the same seeded TransformerLM on the CPU (plain attention,
              exact float32) against the card with TF32 off, layer by layer
              on 2 x 128 token ids.
  7. kernel-lstm  lstm_scan against its plain version on the card at the
              TextGenerationLSTM path's shapes (served and trained (64, 64,
              256) peephole, rnn_time_step (64, 1, 256), the tBPTT window
              (32, 50, 256)), at edge cases (plain cell, masked with a
              fully masked row, ragged (3, 7, 12), long t (8, 1024, 256),
              wide n (16, 64, 512)) and at the launch plan's edges (b = 200:
              batch tiles beyond one wave; n = 1000: not a multiple of 16,
              R read from L2; b = 3 at n = 256; the plain cell at (8, 4096,
              256)), float32 and bfloat16, nonzero h0/c0: each case's plan
              (blocks per cluster, rows per cluster, clusters, R resident),
              max error against the stated tolerance, kernel / plain times,
              us per step, the bound (the recurrent products as float32
              FMAs on the CUDA cores for n <= 256, else on the tensor cores
              as 3xTF32 in float32 and two TF32 products in bfloat16; the
              other units' bound beside it on the log) and the kernel's
              share of it; torch.nn.LSTM's forward (cuDNN, plain cell, input
              projection included, TF32 off) at (64, 64, 256) as the
              library time; and the port's LSTM layer (projection + kernel)
              beside torch.nn.LSTM for the plain cell.
  8. serve-rnn    zoo TextGenerationLSTM (77 characters, 64 steps, two
              GravesLSTM(256), random weights from a seed) behind
              InferenceServer (batch_limit 64), warmed up, answering
              concurrent one-hot requests of 1, 3, 8 and 64 rows and then a
              stream of 64-row requests; every answer finite (n, 64, 77)
              softmax rows equal to net.output on the same rows; lstm_scan
              must have run 2 times per dispatched batch.
  9. stream-rnn   rnn_time_step with TF32 off: 64 single steps and 4 calls
              of 16 steps equal net.output on one [64, 64, 77] sequence,
              rnn_clear_previous_state restarts the stream; then 64 streams
              generate 256 characters each, sampled on the card with a
              seeded generator and fed back as one-hot, no host round trip
              per step; lstm_scan must have run 2 times per call.
 10. refer-rnn    the same seeded TextGenerationLSTM on the CPU (plain scan,
              exact float32) against the card with TF32 off, layer by
              layer on 2 x 64 one-hot rows.
 11. kernel-flash-bwd  the flash-attention backward kernels (dq, dk/dv)
              against their plain formulas on the card at the training
              shape (16, 8, 512, 64) causal and at edge cases (ragged t,
              t = 1, non-causal, head dims 16, 32, 128), float32 and
              bfloat16: each output against its tolerance x its own
              largest magnitude (a zeroed dq, dk or dv and a dS without
              -delta must fail), kernel / plain / library (the backward of
              scaled_dot_product_attention through autograd) times and the
              bound. The float32 bound is 3xTF32's three products over the
              TF32 tensor-core rate, the CUDA-core bound beside it on the
              log.
 12. kernel-xent  the fused linear + softmax cross-entropy kernels (forward,
              backward) against their plain versions at the training shape
              (8192 rows, d 512, vocab 8192) with one-hot labels (the
              backward's index path), soft labels and one smoothed row (the
              dense path), at a ragged shape, at the char-RNN training
              paths' shapes (4096, 1600 and 32768 rows, d 256, 77
              characters: less than one vocabulary tile), at the image
              training paths' (64 rows: ResNet-50's d 2048, 1000 classes,
              LeNet's d 500, 10 classes), float32 and
              bfloat16, and where the 128 x 128 tiles' edges fall (129
              rows, d 70 and v 333: rows not 16-byte aligned); library
              F.cross_entropy(x @ W + b, idx) forward and backward. The
              float32 bound is 3xTF32's three products over the TF32
              tensor-core rate, the CUDA-core bound beside it on the log.
 13. train-lm     zoo TransformerLM at full width (vocab 8192, 512 tokens,
              d_model 512, 8 heads, 6 blocks), Adam(3e-4), trained by
              MultiLayerNetwork.fit for 20 steps on one repeated batch of
              16 x 512 token ids with one-hot float32 labels (268 MB, copied
              from host memory every step), TF32 policy: loss finite every
              step and lower at the end, step time split into the labels'
              copy and the rest, trained tokens/s; per step 6 flash
              forward, 6 dq, 6 dk/dv, 1 xent forward and 1 xent backward
              launches. Then 5 steps under set_mixed_precision(True), same
              checks.
 14. refer-train  the same seeded TransformerLM at full width and 2 blocks,
              3 Adam steps on 2 x 128 tokens, on the CPU (plain versions,
              exact float32) and on the card (TF32 off): per-step scores,
              params and Adam slots agree within the stated tolerances.
 15. kernel-lstm-bwd  the fused LSTM backward (lstm_scan_bwd), the
              time-chunked forward (lstm_scan_chunked) and the chunked
              backward (lstm_scan_chunked_bwd) against their plain versions
              at the training paths' shapes ((64, 64, 256) and the tBPTT
              window (32, 50, 256) peephole, (8, 4096, 256)) and at edge
              cases (plain cell, masked, ragged (3, 7, 12), t = 1, a ragged
              last chunk at t = 1000, n = 512 and 1024), float32 and
              bfloat16, nonzero h0/c0, cotangents of order 1: each output
              against its tolerance x its largest magnitude (a zeroed dzx,
              dR or dp, a dR without one chunk's part, a dzx with one chunk
              stale, an hs whose units of one block lag one step, an hck
              holding the next chunk's checkpoint and a cT from the last
              step of a masked row must fail), kernel / plain / library
              (torch.nn.LSTM, cuDNN, plain cell: its forward for the
              chunked forward, its backward for the backward kernels)
              times, us per step, the bound (the backward's products on the
              tensor cores, 3xTF32 in float32; the chunked forward's as
              phase 7 counts them) and the kernel's share of it; then
              torch.nn.LSTM (cuDNN) in bfloat16 at rows 5-8's path shapes,
              forward and backward: the bfloat16 rows' library times (a
              refusal by cuDNN is logged as such).
 16. train-rnn    zoo TextGenerationLSTM at full width (two GravesLSTM(256),
              77 characters), RmsProp(1e-2), l2 1e-4, trained by
              MultiLayerNetwork.fit for 20 BPTT steps on one repeated batch
              of 64 x 64 one-hot characters, then 5 more under the mixed
              policy: loss finite every step and lower at the end of each
              run, step time, trained characters/s, peak memory; per step 2
              lstm_scan, 2 lstm_scan_bwd, 1 xent forward, 1 xent backward
              and nothing else.
 17. train-rnn-tbptt  the same network with tBPTT windows of 50 on one
              batch of 32 x 1000 characters: 20 iterations, per window the
              launches of train-rnn; score per window, time per window.
 18. train-rnn-long  standard BPTT at 8 x 4096 characters, 10 steps, inside
              the chunked regime: per step 2 lstm_scan_chunked, 2
              lstm_scan_chunked_bwd, 1 + 1 xent and no lstm_scan or
              lstm_scan_bwd.
 19. refer-train-rnn  the same seeded network on the CPU (plain versions,
              exact float32) and on the card (TF32 off): 3 BPTT steps at
              2 x 64, tBPTT at 2 x 100 in windows of 50, 3 steps at 2 x
              1024 on the chunked route; scores, each param's change and
              the RmsProp slots within the stated tolerances.

 20. train-resnet  zoo ResNet-50 at full width (1000 classes, 224x224x3),
              its own config (Nesterovs(0.1, 0.9), l2 1e-4), trained by
              ComputationGraph.fit for 20 steps under the mixed policy on
              one repeated batch of 64 bfloat16 images made on the card
              (bench.py bench_resnet50's input) with one-hot float32
              labels, then 5 steps under the float32 / TF32 policy on the
              same images in float32: every score finite, the median of
              the last 5 mixed scores below the first; per step 53
              bn_act, 1 xent forward, 1 xent backward and nothing else;
              median step ms, trained images/s, peak memory; the copy of
              one such batch from pageable host memory, timed apart.
 21. refer-train-resnet  the same seeded ResNet-50 at full width on the CPU
              (plain versions, exact float32) and on the card (TF32 off):
              3 Nesterovs steps at batch 4, each from the same point (the
              CPU network takes the card's params, state and slots after
              each step); per-step scores, each param's change, the BN
              running stats and the Nesterovs slots within the stated
              tolerances.
 22. train-lenet  zoo LeNet trained by MultiLayerNetwork.fit on
              MnistDataSetIterator(batch=64) (its seeded synthetic sample
              where no MNIST files are present), Adam(1e-3), 20 steps:
              scores finite and falling, per step 1 xent forward and 1
              xent backward and nothing else; then 3 steps on the CPU and
              on the card (TF32 off) agreeing as refer-train's do.
 23. kernel-inception  a Keras InceptionV3 file (299x299x3, 1000 classes,
              random weights from the seed) written by the port's
              write_inception_v3_h5 into a temporary directory and imported
              onto the card by import_keras_model_and_weights (both timed;
              94 bias-free Conv2D, 94 BatchNorm, 15 MergeVertex, more than
              21e6 parameters); bn_act against its plain version at the 18
              (h, w, c) shapes of its 94 BatchNorms at the serving batch of
              32 (identity: Keras puts the ReLU in its own Activation),
              float32 and bfloat16, with kernel / plain / library (addcmul)
              times and the byte bound per forward.
 24. serve-inception  the imported InceptionV3 behind InferenceServer
              (batch_limit 32), as phase 3 serves ResNet-50, on
              inception_preprocess images: softmax rows, the server equal to
              net.output, bn_act 94 times per dispatched batch.
 25. refer-inception  the same file imported on the CPU (plain epilogue,
              exact float32) against the card with TF32 off, vertex by
              vertex on 2 images (relative 1e-4), and the softmax with TF32
              on.
 26. dl4j-write  the BASELINE char-RNN (zoo TextGenerationLSTM at full
              width: 77 characters, two GravesLSTM(256), 888,653 params)
              written as a DL4J ModelSerializer zip into a temporary
              directory by this script's own writer (configuration.json in
              DL4J's form: legacy RMSPROP at 1e-2, rmsDecay 0.95, l2 1e-4,
              TruncatedBPTT 50/50, iterationCount 1000; coefficients.bin of
              seeded float32 values; updaterState.bin, one RMSProp block of
              seeded values in [1e-4, 1e-3]): its size and write time.
 27. dl4j-charrnn  the zip restored by modelimport's
              restore_multi_layer_network(load_updater=True) onto the card
              and onto the CPU (both timed): the output on 32 x 200 one-hot
              characters and 3 fit calls on 32 x 200 (12 tBPTT windows of
              50) on the card (TF32 off) against the CPU, as
              refer-train-rnn compares them; net.iteration 1000 -> 1012;
              ms per window (median of 12); launches: per window 2
              lstm_scan, 2 lstm_scan_bwd, 1 + 1 xent, plus 2 lstm_scan per
              output call, nothing else.
 28. checkpoint-resume  the trained card network written by
              models.serialization.write_model and restored onto the card:
              params, running state, RMSProp slots, iteration and epoch bit
              for bit; one more tBPTT window from each, bit for bit; then
              200 characters for 32 streams sampled by rnn_time_step with a
              seeded generator from each, the same characters and last
              probabilities; ms per character step.
 29. dl4j-fixtures  the six committed DL4J zips (tests/fixtures/dl4j/)
              and the six committed checkpoint zips (cg_branch_merge,
              mln_graves_lstm, mln_vit, mln_conv_bn_noise,
              mln_scheduled_dropout, mln_bidir_lstm) restored onto the
              card, each against its committed output (1e-5, TF32 off);
              conv_pool_bn launches bn_act once. The two with dropout and
              weight noise (AlphaDropout + DropConnect after a BatchNorm;
              scheduled Dropout, DropConnect and GaussianNoise) and the
              GravesBidirectionalLSTM one then take 3 fit steps on the card
              against their CPU restore, each from the same point, the
              card's masks and noise replayed on the CPU: scores, param
              changes, Adam slots and BN running stats within the stated
              tolerances; per step bn_act 1 (the BatchNorm fixture), 2
              lstm_scan and 2 lstm_scan_bwd (the bidirectional one: both
              halves) and 1 + 1 xent.
 30. kernel-vgg  the fused linear + softmax cross-entropy kernels at zoo
              VGG16's Output (64 rows, d 4096, 1000 classes), float32 and
              bfloat16, as phase 12 checks and times them.
 31. train-vgg16  zoo VGG16 at full width (224x224x3, 1000 classes,
              138,357,544 params; 13 convs, two Dense(4096) with dropout
              0.5, Nesterovs(1e-2, 0.9)) trained by MultiLayerNetwork.fit
              for 20 steps under the mixed policy on one repeated batch of
              64 bfloat16 images made on the card, then 5 under the float32
              / TF32 policy on the same images in float32: scores finite,
              the median of the last 5 mixed scores below the first; per
              step 1 xent forward and 1 xent backward and nothing else; the
              first step's two dropout masks keep p = 0.5 of their units
              within 0.01; median step ms, trained images/s, peak memory.
 32. refer-train-vgg16  the same seeded VGG16 at full width on the card
              (TF32 off), on the CPU (plain versions, float32) and on the
              CPU in float64: 3 Nesterovs steps at batch 2, each from the
              same point, the card's dropout masks replayed on the CPU (the
              two generators differ); the scores within 1e-5, and the
              card's farthest change or slot leaf from float64 at most 3
              times as far as the CPU float32's farthest (no float32
              program holds the 13 convs' gradients to 1e-4 of another).
 33. dp-vgg16  zoo VGG16 as train-vgg16 trains it (the same seed, batch,
              policies and steps), through parallel.ParallelWrapper at
              world size 1 over NCCL (a file:// rendezvous in a temporary
              directory): the first score equal to train-vgg16's within
              1e-6, scores finite and falling, per step 1 xent forward and
              1 xent backward and nothing else; median step ms, trained
              images/s, peak memory, and the gradient reduce's MB,
              all-reduces and device ms per step (CUDA events around each
              bucket's pack and all-reduce).
 34. dp-resnet  zoo ResNet-50 as train-resnet trains it, the same way
              (first score within 1e-4: 53 BatchNorms' statistics are
              all-reduced sums over their count here); per step 53 bn_act,
              1 + 1 xent.
 35. refer-dp  two ranks of ParallelWrapper spawned on the one card over
              gloo (this script with --dp-rank), TF32 off, deterministic
              cuDNN, against this process's fit on the same global batches
              and draws: a conv + BatchNorm + dropout + Dense + Output
              network (3 Nesterovs steps at 8 images), a tBPTT
              GravesLSTM char-RNN (4 sequences of 24 characters in windows
              of 8, one row's labels masked from step 13) and the same
              char-RNN as a ComputationGraph with features and labels
              masked alike: the ranks' params, slots and running stats
              bit-identical after every step; scores, params, slots and
              running stats within 1e-5 of the single process; per step
              and process 1 bn_act and 1 + 1 xent, per window 1 lstm_scan,
              1 lstm_scan_bwd and 1 + 1 xent.
 36. kernel-bidir  rows 5-8 (lstm_scan, lstm_scan_bwd, lstm_scan_chunked,
              lstm_scan_chunked_bwd) on the inputs the backward half of
              GravesBidirectionalLSTM gives them: zx and a right-padded
              mask flipped in time, so a row's dead steps lead, one row
              wholly dead, h0 and c0 nonzero; at train-bidir's (32, 1000,
              256) and at (8, 1024, 256) (inside chunked_lstm_auto_regime),
              float32, against their plain versions (the dead row's carry
              and cotangent bit for bit; a forward that ran the leading
              dead steps as live must fail); rows 5 and 6 timed at (32,
              1000, 256) with their bounds over the live (row, step) pairs
              and torch.nn.LSTM's; then the xent kernels at train-bidir's
              Output (32 rows, d 512, 77 characters), as phase 12.
 37. train-cg-rnn  the char-RNN as a ComputationGraph at full width (in ->
              GravesLSTM(256) -> GravesLSTM(256) -> RnnOutput(77), seed 7,
              RmsProp(1e-2), l2 1e-4, tBPTT 50/50) trained by
              ComputationGraph.fit on one batch of 32 x 1000 Zipf
              characters with features mask = labels mask (row 0 live for
              1000 steps, row 1 for 510, the others for lengths drawn in
              [500, 1000]): 20 windows, per window 2 lstm_scan, 2
              lstm_scan_bwd, 1 + 1 xent and nothing else; ms per window,
              trained characters per second, peak memory. Then the last 3
              windows again on the graph and on the port's MLN
              TextGenerationLSTM carrying the graph's params and slots,
              each from the same point, TF32 off: scores 1e-5 relative,
              params 1e-5 absolute.
 38. train-bidir  the same width and batch as a classifier: in ->
              GravesBidirectionalLSTM(256) -> LastTimeStepVertex and
              GlobalPooling(avg) -> MergeVertex -> Output(77), RmsProp(1e-3)
              (at 1e-2 whole-sequence BPTT through 1000 steps diverges to
              NaN, on the card and the CPU alike), labelled
              with the character after each row's live span (2-D labels:
              whole-sequence BPTT under the same tBPTT configuration); 20
              steps, per step 2 lstm_scan (the forward half and the reverse
              half), 2 lstm_scan_bwd, 1 + 1 xent; ms per step, sequences
              per second, peak memory.
 39. refer-train-cg  both graphs on the card (TF32 off) and on the CPU
              (plain versions, exact float32) from the seed: the char graph
              on 8 x 200 masked characters in 4 windows of 50 (one row
              wholly masked in the last window), the classifier on 8 x 120
              for 3 steps; refer-train-rnn's gates.
 40. eval-cg-rnn  train-cg-rnn's graph after its windows evaluated
              (ComputationGraph.evaluate) on its own masked batch: the
              live steps counted exactly, the accuracy numpy's over the
              masked argmax of the pass's output; 2 lstm_scan and nothing
              else.
 41. eval-resnet  zoo ResNet-50 (224x224x3, 1000 classes, seed 7, TF32):
              one do_evaluation pass over 16 batches of 32 from
              BenchmarkDataSetIterator through AsyncDataSetIterator into
              Evaluation, ROCMultiClass(100) and EvaluationCalibration:
              the confusion matrix numpy's count of (label, argmax) over
              the pass's outputs (512), each class's calibration counts
              512; bn_act 53 per batch and nothing else; evaluated images
              per second against output alone on the same batches.
 42. es-charrnn   the BASELINE char-RNN (zoo TextGenerationLSTM, tBPTT 50,
              RmsProp(1e-2), l2 1e-4) by EarlyStoppingTrainer on 4 batches
              of 32 x 1000 Zipf characters, held-out loss on a batch from
              another seed, MaxEpochsTerminationCondition(3), a
              LocalFileModelSaver; listeners: the events 3 x (on_fit_start,
              on_epoch_start, 80 iteration_done, on_epoch_end, on_fit_end);
              per window 2 + 2 LSTM and 1 + 1 xent, per held-out score 2
              lstm_scan and 1 xent forward; get_best() onto the card bit for
              bit the best epoch's params; then fit(epochs=2,
              checkpoint_manager=m) and a fresh network's fit(epochs=3,
              checkpoint_manager=m): one epoch trained, params within 1e-6
              of an unbroken 3-epoch fit, every checkpoint verified.
 43. kernel-transfer  the xent kernels at the fine-tuned VGG16's Output
              (64 rows, d 4096, 5 classes), float32 and bfloat16, as phase
              12 checks and times them.
 44. transfer-vgg16  zoo VGG16 (seed 7) fine-tuned as dl4j-examples'
              EditLastLayerOthersFrozen: FineTuneConfiguration(Nesterovs(
              5e-5, 0.9), seed 7), the layers up to fc2 frozen, a new
              Output(5); 20 mixed steps at batch 64 on distinct seeded
              images: frozen params bit for bit, the Output moved, 1 + 1
              xent per step and nothing else;
              TransferLearningHelper.featurize + fit_featurized over the
              same batches give the frozen fit's Output params (1e-5);
              predict the argmax of output; ms per step against
              train-vgg16's, peak memory.
 45. refer-transfer  the same transferred VGG16 on the card (TF32 off),
              on the CPU and on the CPU in float64, 3 steps at batch 4,
              each from the same point; refer-train-vgg16's gates.

The characters the training phases learn are drawn with Zipf frequencies,
so that a falling loss shows learning; their shapes are bench.py
bench_lstm's.

Every kernel's launch count is set to 0 just before each serve phase, the
generation run, each training run (the data-parallel ones too), the
restore-and-resume runs and each evaluation pass, and read just after. The
last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.
Exits non-zero when no CUDA device is available, and when the port's
package is not beside this script.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

SEED = 7
BATCH = 32                 # ResNet-50 server's batch_limit: its serving batch
L2_BYTES = 50 * 2 ** 20    # H100 L2; timing inputs rotate through 2x this
ITERS = 50

# the repo's transformer configuration (bench.py bench_transformer,
# profile_transformer.py), served at batch limit 16
LM = dict(num_classes=8192, max_length=512, d_model=512, n_heads=8,
          n_layers=6)
LM_BATCH = 16

# zoo TextGenerationLSTM as the JAX package's bench drives it (bench.py
# char-RNN row: 77 characters, 64 steps, batch 64), served at batch 64
RNN = dict(num_classes=77, max_length=64)
RNN_BATCH = 64

# Published rates (NVIDIA data sheets, dense): device-memory bytes/s,
# float32 operations/s outside the tensor cores, bfloat16 and TF32
# operations/s on the tensor cores. bn_act's bfloat16 arithmetic runs on
# the float32 units; the flash-attention and linear_xent kernels run their
# bfloat16 products at the bfloat16 tensor-core rate and their float32
# products as 3xTF32.
CARD_RATES = {
    "H100 PCIe": (2.0e12, 51e12, 756e12, 378e12),
    "H100 NVL": (3.9e12, 60e12, 835e12, 417.5e12),
    "H100": (3.35e12, 67e12, 989e12, 495e12),      # SXM
    "H200": (4.8e12, 67e12, 989e12, 495e12),
}

# the repo's transformer training batch (bench.py bench_transformer: 16 x
# 512 token ids, one-hot float32 next-token labels), 20 Adam steps
TRAIN_STEPS = 20
MIXED_STEPS = 5

# Kernels of the ported paths: name -> (route, source, TPU kernel it
# replaces)
KERNELS = {
    "bn_act": ("cuda", "deeplearning4j_tpu_torch/csrc/bn_act.cu",
               "deeplearning4j_tpu/ops/pallas_kernels.py:1430"),
    "flash_attention": (
        "cuda", "deeplearning4j_tpu_torch/csrc/flash_attention.cu",
        "deeplearning4j_tpu/ops/pallas_kernels.py:163"),
    "lstm_scan": ("cuda", "deeplearning4j_tpu_torch/csrc/lstm_scan.cu",
                  "deeplearning4j_tpu/ops/pallas_kernels.py:444"),
    "flash_attention_bwd_dq": (
        "cuda", "deeplearning4j_tpu_torch/csrc/flash_attention_bwd.cu",
        "deeplearning4j_tpu/ops/pallas_kernels.py:294"),
    "flash_attention_bwd_dkv": (
        "cuda", "deeplearning4j_tpu_torch/csrc/flash_attention_bwd.cu",
        "deeplearning4j_tpu/ops/pallas_kernels.py:304"),
    "linear_xent_fwd": ("cuda", "deeplearning4j_tpu_torch/csrc/linear_xent.cu",
                        "deeplearning4j_tpu/ops/xent_kernel.py:174"),
    "linear_xent_bwd": ("cuda", "deeplearning4j_tpu_torch/csrc/linear_xent.cu",
                        "deeplearning4j_tpu/ops/xent_kernel.py:277"),
    "lstm_scan_bwd": ("cuda", "deeplearning4j_tpu_torch/csrc/lstm_scan_bwd.cu",
                      "deeplearning4j_tpu/ops/pallas_kernels.py:799"),
    "lstm_scan_chunked": ("cuda", "deeplearning4j_tpu_torch/csrc/lstm_scan.cu",
                          "deeplearning4j_tpu/ops/pallas_kernels.py:1164"),
    "lstm_scan_chunked_bwd": (
        "cuda", "deeplearning4j_tpu_torch/csrc/lstm_scan_bwd.cu",
        "deeplearning4j_tpu/ops/pallas_kernels.py:1241"),
}
SOURCES = sorted({os.path.basename(src)[:-len(".cu")]
                  for _, src, _ in KERNELS.values()})


def log(msg: str = "") -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def card_rates(name: str):
    for key, rates in CARD_RATES.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published rates for card {name!r}")


def device_ms(torch, fn, nbuf: int, iters: int = ITERS) -> float:
    """Mean device time of fn(i) over `iters` calls. A sleep kernel holds
    the stream while the calls are enqueued, so host launch overhead does
    not enter the measurement (unless enqueuing outlasts the sleep, as for
    a plain version of thousands of small launches); `i` cycles through
    `nbuf` input buffers."""
    for i in range(min(nbuf, 3)):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for i in range(iters):
        fn(i % nbuf)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wrappers():
    """Each kernel's wrapper, which counts its launches."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops
    from deeplearning4j_tpu_torch.ops import xent_kernel as xk
    from deeplearning4j_tpu_torch.ops.bn_act import bn_act

    return {"bn_act": bn_act, "flash_attention": fa.flash_attention,
            "lstm_scan": lstm_ops.lstm_scan,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "linear_xent_fwd": xk.linear_xent_fwd,
            "linear_xent_bwd": xk.linear_xent_bwd,
            "lstm_scan_bwd": lstm_ops.lstm_scan_bwd,
            "lstm_scan_chunked": lstm_ops.lstm_scan_chunked,
            "lstm_scan_chunked_bwd": lstm_ops.lstm_scan_chunked_bwd}


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN's deterministic algorithms (no autotuning) inside the block,
    for the refer phases whose later steps start from the card's earlier
    ones: the default weight-gradient algorithms sum in an order that
    changes from run to run."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in wrappers().items()}


# ---------------------------------------------------------------- phase 1
def phase_build():
    from deeplearning4j_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(SOURCES)
    dt = time.perf_counter() - t0
    log(f"[build] {', '.join(SOURCES)} built in {dt:.2f} s with "
        f"{_build.nvcc_path()}")
    for name, text in logs.items():
        for line in text.splitlines():
            # ptxas -v: the entry, its registers, and (on a line of its
            # own, without the "ptxas" prefix) its stack frame and spills
            if ("ptxas" in line and ("registers" in line
                                     or "Compiling" in line)) \
                    or "spill" in line:
                log(f"[build]   {name}: {line.strip()}")


# ---------------------------------------------------------------- phase 2
def bn_cases(net, batch):
    """(rows, c, act, calls per forward) of every bn_act call the network
    makes, from its BatchNorm vertices' input types."""
    from deeplearning4j_tpu_torch.nn.layers import BatchNorm

    cases = {}
    for name in net.topo:
        layer = net.layer(name)
        if not isinstance(layer, BatchNorm):
            continue
        act = layer.activation or "identity"
        if act not in ("relu", "identity"):
            continue
        t = net.vertex_types[name]
        key = (batch * t.height * t.width, t.channels, act)
        cases[key] = cases.get(key, 0) + 1
    return [(r, c, a, n) for (r, c, a), n in cases.items()]


def phase_kernel(torch, cases, bw, peak, batch=BATCH, dtypes=None,
                 what="forward", model="ResNet-50", tag="kernel"):
    """bn_act against its plain version at every (rows, c, act) of
    `cases`, for a `model` forward at `batch` rows, in each of `dtypes`
    (float32 and bfloat16 by default). Returns the per-forward totals by
    dtype and the largest error."""
    from deeplearning4j_tpu_torch.ops.bn_act import bn_act, bn_act_reference

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ulp = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7}
    rows_out = {}
    max_err = 0.0
    checked = 0
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                  "bound_ms": 0.0}
        for rows, c, act, calls in cases:
            item = torch.empty((), dtype=dtype).element_size()
            nbytes = rows * c * item
            nbuf = max(1, min(64, math.ceil(2 * L2_BYTES / nbytes)))
            xs = [torch.randn((batch, rows // batch, c), generator=gen,
                              device=dev).to(dtype) for _ in range(nbuf)]
            scale = torch.rand(c, generator=gen, device=dev) + 0.5
            shift = torch.randn(c, generator=gen, device=dev)
            s_x, h_x = scale.to(dtype), shift.to(dtype)

            y = bn_act(xs[0], scale, shift, act)
            ref = bn_act_reference(xs[0], scale, shift, act)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs()
            # 1 ulp of the dtype at the magnitude of the multiply-add's
            # terms: the two programs may round the product differently
            bound = ulp[dtype] * ((xs[0].float() * scale).abs()
                                  + shift.abs()) + 1e-30
            if y.dtype != dtype or y.shape != xs[0].shape or \
                    not bool((err <= bound).all()):
                raise AssertionError(
                    f"bn_act disagrees with its plain version at rows={rows}"
                    f" c={c} act={act} {dtype}: max err "
                    f"{float(err.max())}")
            e = float(err.max())
            max_err = max(max_err, e)
            checked += 1

            k_ms = device_ms(torch, lambda i: bn_act(xs[i], scale, shift,
                                                     act), nbuf)
            p_ms = device_ms(torch, lambda i: bn_act_reference(
                xs[i], scale, shift, act), nbuf)
            if act == "relu":
                lib_name = "clamp_min(addcmul) (2 calls)"
                l_ms = device_ms(torch, lambda i: torch.clamp_min(
                    torch.addcmul(h_x, xs[i], s_x), 0), nbuf)
            else:
                lib_name = "addcmul"
                l_ms = device_ms(torch, lambda i: torch.addcmul(
                    h_x, xs[i], s_x), nbuf)
            moved = 2 * nbytes + 2 * c * 4
            ops = rows * c * (3 if act == "relu" else 2)
            b_ms = max(moved / bw, ops / peak) * 1e3
            by = "bytes" if moved / bw >= ops / peak else "operations"
            log(f"[{tag}] bn_act {str(dtype)[6:]:8s} rows={rows:6d} "
                f"c={c:4d} {act:8s} x{calls:2d}/fwd  max_err={e:.3g} "
                f"(tol 1 ulp)  kernel={k_ms:.4f} ms  plain={p_ms:.4f} ms  "
                f"library[{lib_name}]={l_ms:.4f} ms  bound={b_ms:.4f} ms "
                f"({by})")
            for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                           ("library_ms", l_ms), ("bound_ms", b_ms)):
                totals[key] += calls * v
            del xs
        rows_out[dtype] = totals
        log(f"[{tag}] bn_act {str(dtype)[6:]} per {model} {what} at "
            f"batch {batch} ({sum(n for *_, n in cases)} calls): "
            f"kernel={totals['ms']:.4f} ms  "
            f"plain={totals['plain_ms']:.4f} ms  "
            f"library={totals['library_ms']:.4f} ms  "
            f"bound={totals['bound_ms']:.4f} ms")
    log(f"[{tag}] verdict: bn_act agrees with its plain version in "
        f"{checked}/{checked} (shape, activation, dtype) cases, max error "
        f"{max_err:.3g} (tol 1 ulp)")
    return rows_out, max_err


# (b, h, t, d, causal): the served shape first, then the edge cases
FLASH_CASES = [
    (16, 8, 512, 64, True),     # TransformerLM serving, one launch per block
    (16, 8, 512, 64, False),    # non-causal
    (4, 8, 200, 64, True),      # ragged t: no multiple of the 64-row tile
    (4, 8, 1, 64, True),        # t = 1
    (4, 8, 300, 16, True),
    (4, 8, 512, 32, True),
    (4, 8, 512, 128, True),
    (2, 4, 129, 128, False),
]
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # x max|o| of the plain


def flash_disagrees(got, ref, dname):
    """Why flash_attention's (o[, lse]) is not the plain version's within
    FLASH_TOL x max|o| (lse: 1e-5 x max(1, max|lse|)), or None. NaN
    disagrees."""
    o, o_ref = (got[0], ref[0]) if isinstance(ref, tuple) else (got, ref)
    err = float((o.float() - o_ref.float()).abs().max())
    mag = float(o_ref.float().abs().max())
    if o.dtype != o_ref.dtype or o.shape != o_ref.shape \
            or not err <= FLASH_TOL[dname] * mag:
        return f"max err {err:.3g} (|o| max {mag:.3g})"
    if isinstance(ref, tuple):
        lse_err = float((got[1] - ref[1]).abs().max())
        if got[1].shape != ref[1].shape or not lse_err <= 1e-5 * max(
                1.0, float(ref[1].abs().max())):
            return f"lse err {lse_err:.3g}"
    return None


def flash_broken(torch, q, k, causal, ref):
    """Outputs the phase must reject, from the plain (o, lse): o zeroed, o
    not divided by l, lse without its log(l) term. The last two equal the
    plain ones where every l is 1 (t = 1), and are left out there."""
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        NEG_INF, default_scale, scale_in)

    o, lse = ref
    broken = [("a zeroed o", (torch.zeros_like(o), lse))]
    t = q.shape[2]
    if t > 1:
        sq = scale_in(q.dtype, default_scale(q.shape[-1]))
        s = torch.matmul((q * torch.tensor(sq, dtype=q.dtype,
                                           device=q.device)).float(),
                         k.float().transpose(-1, -2))
        if causal:
            keep = torch.ones(t, t, dtype=torch.bool, device=s.device).tril()
            s = s.masked_fill(~keep, NEG_INF)
        m = s.amax(-1)  # the plain version's row max: lse = m + log(l)
        l = torch.exp(lse - m)
        broken += [("an o not divided by l",
                    ((o.float() * l[..., None]).to(o.dtype), lse)),
                   ("an lse without log(l)", (o, m))]
    return broken


def phase_flash(torch, bw, peak, peak_bf16, peak_tf32):
    """flash_attention against its plain version at FLASH_CASES, float32
    and bfloat16, with and without lse, and proof that the comparison
    rejects a broken output. Returns the served case's float32 row (per
    launch) and the largest absolute error of any case."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa_library

    from deeplearning4j_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the library yardstick computes in full float32 too
    torch.backends.cuda.matmul.allow_tf32 = False
    served, max_err, checked, rejected = None, 0.0, 0, 0
    for b, h, t, d, causal in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            item = torch.empty((), dtype=dtype).element_size()
            set_bytes = 3 * b * h * t * d * item
            nbuf = max(1, min(16, math.ceil(2 * L2_BYTES / set_bytes)))
            qkv = [[torch.randn((b, h, t, d), generator=gen, device=dev)
                    .to(dtype) for _ in range(3)] for _ in range(nbuf)]
            where = (f"b={b} h={h} t={t} d={d} causal={causal} {dname}")
            for lse in (False, True):
                got = flash_attention(*qkv[0], causal, return_lse=lse)
                ref = flash_attention_reference(*qkv[0], causal,
                                                return_lse=lse)
                torch.cuda.synchronize()
                bad = flash_disagrees(got, ref, dname)
                if bad:
                    raise AssertionError(
                        f"flash_attention disagrees with its plain version "
                        f"at {where} lse={lse}: {bad}")
                o, o_ref = (got[0], ref[0]) if lse else (got, ref)
                err = float((o.float() - o_ref.float()).abs().max())
                mag = float(o_ref.float().abs().max())
                lse_err = (float((got[1] - ref[1]).abs().max()) if lse
                           else 0.0)
                if lse:  # the comparison must see a broken forward
                    for name, out in flash_broken(torch, *qkv[0][:2],
                                                  causal, ref):
                        if not flash_disagrees(out, ref, dname):
                            raise AssertionError(
                                f"kernel cannot tell {name} from the plain "
                                f"flash_attention at {where}")
                        rejected += 1
                max_err = max(max_err, err)
                checked += 1
                k_ms = device_ms(torch, lambda i: flash_attention(
                    *qkv[i], causal, return_lse=lse), nbuf)
                p_ms = device_ms(torch, lambda i: flash_attention_reference(
                    *qkv[i], causal, return_lse=lse), nbuf)
                l_ms = device_ms(torch, lambda i: sdpa_library(
                    *qkv[i], is_causal=causal), nbuf)
                pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
                ops = 4 * d * pairs
                moved = 4 * b * h * t * d * item + (4 * b * h * t if lse
                                                    else 0)
                # float32 runs each product as 3xTF32: three TF32
                # products on the tensor cores
                f32 = dtype == torch.float32
                work, rate = (3 * ops, peak_tf32) if f32 else (ops,
                                                              peak_bf16)
                b_ms = max(moved / bw, work / rate) * 1e3
                by = "bytes" if moved / bw >= work / rate else "operations"
                log(f"[kernel] flash_attention {dname:8s} b={b:2d} h={h} "
                    f"t={t:3d} d={d:3d} {'causal' if causal else 'full  '} "
                    f"lse={int(lse)}  max_err={err:.3g} (tol "
                    f"{FLASH_TOL[dname]:g} x {mag:.3g})  lse_err="
                    f"{lse_err:.3g}  kernel={k_ms:.4f} ms  plain={p_ms:.4f} "
                    f"ms  library[scaled_dot_product_attention]={l_ms:.4f} "
                    f"ms  bound={b_ms:.4f} ms ({by}"
                    f"{', 3xTF32' if f32 else ''})")
                if (b, h, t, d, causal) == FLASH_CASES[0] and not lse \
                        and f32:
                    served = {"ms": k_ms, "plain_ms": p_ms,
                              "library_ms": l_ms, "bound_ms": b_ms,
                              "bound_by": by}
            del qkv
    log(f"[kernel] verdict: flash_attention agrees with its plain version "
        f"in {checked}/{checked} (shape, dtype, lse) cases, max abs error "
        f"{max_err:.3g} (tol float32 1e-5, bfloat16 2e-2, x max|o|; lse "
        f"1e-5 x max(1, |lse|)); {rejected} broken outputs rejected (a "
        f"zeroed o in every case, an o not divided by l and an lse without "
        f"log(l) in every case with t > 1)")
    return served, max_err


# ---------------------------------------------------------------- phase 3
def phase_serve(torch, np, net, card, bn_per_forward=53, rows=None,
                tag="serve"):
    """`net` behind InferenceServer(batch_limit=BATCH); `rows(rng, n)` makes
    n input rows (standard normal by default). bn_act must run
    `bn_per_forward` times per dispatched batch."""
    from deeplearning4j_tpu_torch.serving import InferenceServer

    rng = np.random.default_rng(SEED)
    direct = net.output
    forwards = [0]

    def counted_output(x):
        forwards[0] += 1
        return direct(x)

    net.output = counted_output  # counts the server's dispatched batches
    t_in = net.conf.input_types[0]
    shape = (t_in.height, t_in.width, t_in.channels)
    classes = net.vertex_types[net.conf.network_outputs[0]].size
    sizes = (1, 3, 8, 32)
    if rows is None:
        def rows(rng, n):
            return rng.standard_normal((n, *shape)).astype(np.float32)
    xs = [rows(rng, n) for n in sizes]
    stream = [rows(rng, BATCH) for _ in range(4)]

    def timed(x):
        t0 = time.perf_counter()
        out = server.output(x)
        return out, time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    server = InferenceServer(model=net, batch_limit=BATCH)
    try:
        server.warmup(xs[0])
        torch.cuda.synchronize()
        log(f"[{tag}] warmup of buckets {server.buckets.sizes} took "
            f"{time.perf_counter() - t0:.2f} s")
        with ThreadPoolExecutor(len(sizes)) as pool:
            first = list(pool.map(timed, xs))
        n_stream = 96
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            streamed = list(pool.map(timed, [stream[i % len(stream)]
                                             for i in range(n_stream)]))
        wall = time.perf_counter() - t1
    finally:
        server.shutdown()
        net.output = direct
    launches = read_counts()
    per_forward = sum(n for *_, n in bn_cases(net, 1))
    log(f"[{tag}] {forwards[0]} batches dispatched, launches {launches} "
        f"(bn_act {per_forward} per forward)")
    if per_forward != bn_per_forward or forwards[0] == 0 or \
            launches["bn_act"] != per_forward * forwards[0]:
        raise AssertionError(
            f"bn_act launches {launches['bn_act']} != {bn_per_forward} x "
            f"{forwards[0]} dispatched batches")

    for x, (out, lat) in zip(xs, first):
        n = x.shape[0]
        if out.shape != (n, classes) or not np.isfinite(out).all():
            raise AssertionError(f"request of {n} rows: bad output "
                                 f"{out.shape}")
        if np.abs(out.sum(axis=1) - 1.0).max() > 1e-4:
            raise AssertionError(f"request of {n} rows: softmax rows do "
                                 f"not sum to 1")
        ref = direct(x).cpu().numpy()
        diff = float(np.abs(out - ref).max())
        # TF32 convolutions: cuDNN may pick another algorithm for the
        # padded bucket than for n rows alone
        if diff > 2e-3 or (out.argmax(1) != ref.argmax(1)).any():
            raise AssertionError(f"request of {n} rows: server and "
                                 f"net.output differ by {diff}")
        log(f"[{tag}] request rows={n:2d} latency={lat * 1e3:.2f} ms  "
            f"max |server - net.output| = {diff:.3g}  ({card})")
    lats = sorted(lat for _, lat in streamed)
    for out, _ in streamed:
        if out.shape != (BATCH, classes) or not np.isfinite(out).all():
            raise AssertionError("streamed request: bad output")
    img_s = n_stream * BATCH / wall
    log(f"[{tag}] stream: {n_stream} requests x {BATCH} rows in "
        f"{wall:.3f} s = {img_s:.1f} img/s, latency p50 "
        f"{lats[len(lats) // 2] * 1e3:.2f} ms, max {lats[-1] * 1e3:.2f} ms "
        f"({card})")
    return launches


# ---------------------------------------------------------------- phase 4
def phase_reference(torch, np, net, cpu_net=None, x=None, tag="refer"):
    """`net` on the card with TF32 off against `cpu_net` (default: the same
    config and seed on the CPU) at every vertex, on `x` (default: 2
    standard normal rows)."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.models import ComputationGraph

    if cpu_net is None:
        # same config, same seed: the same weights, drawn on the CPU
        cpu_net = ComputationGraph(net.conf).init(device="cpu")
    t_in = net.conf.input_types[0]
    if x is None:
        x = np.random.default_rng(SEED + 1).standard_normal(
            (2, t_in.height, t_in.width, t_in.channels)).astype(np.float32)
    with dtypes.full_precision():
        gpu_acts = net.feed_forward(x)
    cpu_acts = cpu_net.feed_forward(x)
    worst = 0.0
    for name, a, b in zip(["in"] + net.topo, gpu_acts, cpu_acts):
        a, b = a.cpu().numpy(), b.numpy()
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        worst = max(worst, rel)
        # float32 sums in another order on each device, over 50-100 layers
        if a.shape != b.shape or not rel <= 1e-4:
            raise AssertionError(f"vertex {name}: card and CPU differ, "
                                 f"relative {rel:.3g}")
    tf32 = net.output(x).cpu().numpy()
    log(f"[{tag}] {len(cpu_acts)} activations, card (TF32 off) vs CPU: worst "
        f"relative difference {worst:.3g} (tol 1e-4); softmax with TF32 on "
        f"vs CPU: max {float(np.abs(tf32 - cpu_acts[-1].numpy()).max()):.3g}")


# ---------------------------------------------------------------- phase 5
def phase_serve_lm(torch, np, net, card):
    from deeplearning4j_tpu_torch.serving import InferenceServer

    rng = np.random.default_rng(SEED)
    t, vocab = LM["max_length"], LM["num_classes"]
    direct = net.output
    forwards = [0]

    def counted_output(x):
        forwards[0] += 1
        return direct(x)

    net.output = counted_output  # counts the server's dispatched batches
    sizes = (1, 3, 8, LM_BATCH)
    xs = [rng.integers(0, vocab, (n, t)).astype(np.int32) for n in sizes]
    stream = [rng.integers(0, vocab, (LM_BATCH, t)).astype(np.int32)
              for _ in range(4)]

    def timed(x):
        t0 = time.perf_counter()
        out = server.output(x)
        return out, time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    server = InferenceServer(model=net, batch_limit=LM_BATCH)
    try:
        server.warmup(xs[0][:1])
        torch.cuda.synchronize()
        log(f"[serve-lm] warmup of buckets {server.buckets.sizes} took "
            f"{time.perf_counter() - t0:.2f} s")
        with ThreadPoolExecutor(len(sizes)) as pool:
            first = list(pool.map(timed, xs))
        n_stream = 24
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            streamed = list(pool.map(timed, [stream[i % len(stream)]
                                             for i in range(n_stream)]))
        wall = time.perf_counter() - t1
    finally:
        server.shutdown()
        net.output = direct
    launches = read_counts()
    per_forward = LM["n_layers"]
    log(f"[serve-lm] {forwards[0]} batches dispatched, launches {launches} "
        f"(flash_attention {per_forward} per forward)")
    if forwards[0] == 0 or \
            launches["flash_attention"] != per_forward * forwards[0]:
        raise AssertionError(
            f"flash_attention launches {launches['flash_attention']} != "
            f"{per_forward} x {forwards[0]} dispatched batches")

    for x, (out, lat) in zip(xs, first):
        n = x.shape[0]
        if out.shape != (n, t, vocab) or not np.isfinite(out).all():
            raise AssertionError(f"request of {n} rows: bad output "
                                 f"{out.shape}")
        if np.abs(out.sum(axis=-1) - 1.0).max() > 1e-4:
            raise AssertionError(f"request of {n} rows: softmax rows do "
                                 f"not sum to 1")
        ref = direct(x).cpu().numpy()
        rel = float(np.abs(out - ref).max() / np.abs(ref).max())
        # TF32 matmuls: cuBLAS may pick another algorithm for the padded
        # bucket than for n rows alone
        if not rel <= 1e-3:
            raise AssertionError(f"request of {n} rows: server and "
                                 f"net.output differ by {rel:.3g} relative")
        log(f"[serve-lm] request rows={n:2d} latency={lat * 1e3:.2f} ms  "
            f"max |server - net.output| / max|p| = {rel:.3g}  ({card})")
    lats = sorted(lat for _, lat in streamed)
    for out, _ in streamed:
        if out.shape != (LM_BATCH, t, vocab) or not np.isfinite(out).all():
            raise AssertionError("streamed request: bad output")
    tok_s = n_stream * LM_BATCH * t / wall
    log(f"[serve-lm] stream: {n_stream} requests x {LM_BATCH} rows x {t} "
        f"tokens in {wall:.3f} s = {tok_s:.1f} tokens/s, latency p50 "
        f"{lats[len(lats) // 2] * 1e3:.2f} ms, max {lats[-1] * 1e3:.2f} ms "
        f"({card})")

    # one served batch split: the forward on the card, then the copy of its
    # [16, 512, 8192] float32 answer to pageable host memory
    x = stream[0]
    fwd, copy = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = direct(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out.cpu()
        fwd.append(t1 - t0)
        copy.append(time.perf_counter() - t1)
    mb = out.numel() * out.element_size() / 1e6
    log(f"[serve-lm] one batch of {LM_BATCH}: forward {min(fwd) * 1e3:.2f} "
        f"ms, answer copy to host {min(copy) * 1e3:.2f} ms for {mb:.1f} MB "
        f"(best of 5; {card})")
    return launches


# ---------------------------------------------------------------- phase 6
def phase_reference_lm(torch, np, net):
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.zoo import TransformerLM

    # same config, same seed: the same weights, drawn on the CPU
    cpu_net = TransformerLM(**LM, seed=SEED).init(device="cpu")
    x = np.random.default_rng(SEED + 1).integers(
        0, LM["num_classes"], (2, 128)).astype(np.int32)
    with dtypes.full_precision():
        gpu_acts = net.feed_forward(x)
    cpu_acts = cpu_net.feed_forward(x)
    worst = 0.0
    for i, (a, b) in enumerate(zip(gpu_acts, cpu_acts)):
        a, b = a.cpu().numpy(), b.numpy()
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        worst = max(worst, rel)
        # float32 sums in another order on each device, over 8 layers
        if a.shape != b.shape or not rel <= 1e-4:
            raise AssertionError(f"layer {i - 1}: card and CPU differ, "
                                 f"relative {rel:.3g}")
    log(f"[refer-lm] {len(cpu_acts)} activations (input and "
        f"{len(cpu_acts) - 1} layers), card (TF32 off) vs CPU: worst "
        f"relative difference {worst:.3g} (tol 1e-4)")


# ---------------------------------------------------------------- phase 7
# (b, t, n, peephole, masked): the served shape first, then the edge cases
LSTM_CASES = [
    (64, 64, 256, True, False),     # TextGenerationLSTM serving, 2 per fwd
    (64, 1, 256, True, False),      # rnn_time_step, 2 per call
    (64, 64, 256, False, False),    # plain cell (LSTM)
    (32, 50, 256, True, False),     # a tBPTT window of the training path
    (8, 64, 256, True, True),       # ragged lengths, one row fully masked
    (3, 7, 12, True, True),         # ragged small
    (8, 1024, 256, False, False),   # long t (the JAX chunked kernel's)
    (16, 64, 512, True, False),     # wide n: R read from L2 every step
    # the launch plan's edges
    (200, 32, 256, True, False),    # batch tiles beyond one wave
    (8, 64, 1000, True, False),     # n not a multiple of 16, R from L2
    (3, 64, 256, True, False),      # one-row tiles
    (8, 4096, 256, False, False),   # plain cell at the long path's shape
]
LSTM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # x max(1, max|plain|)


def lstm_case_inputs(torch, gen, b, t, n, dtype, peephole, masked):
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    zx = rnd(b, t, 4 * n)
    R = rnd(n, 4 * n, scale=(2.0 / (5 * n)) ** 0.5)  # xavier, as init
    p = rnd(3, n, scale=0.3) if peephole else None
    h0, c0 = rnd(b, n, scale=0.5), rnd(b, n, scale=0.5)
    mask = None
    if masked:
        lengths = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
        mask = (torch.arange(t, device=dev)[None] < lengths[:, None]).float()
        mask[1] = 0.0
    return zx, R, p, h0, c0, mask


def lstm_plan_text(lstm_ops, b, n):
    pl = lstm_ops.plan(b, n)
    return (f"plan {pl['cluster']} blocks x {pl['units']} units, "
            f"{pl['rows']} rows, {pl['tiles']} clusters of {pl['active']} "
            f"at once, R {'in registers' if pl['resident'] else 'from L2'}")


def lstm_fwd_bound(b, t, n, dtype, bw, peak, peak_tf32, moved):
    """(bound ms, bound_by, basis, the other units' bound ms) of the
    forward: its recurrent products as float32 FMAs on the CUDA cores where
    R's slices stay in registers (n <= 256, both dtypes), else on the
    tensor cores (three TF32 products each in float32, two in bfloat16,
    where R is exact in TF32); the other units' bound beside it."""
    ops = 2 * b * n * 4 * n * t
    cores = ops / peak
    tensor = (3 if dtype == "float32" else 2) * ops / peak_tf32
    on_cores = n <= 256
    work = cores if on_cores else tensor
    b_ms = max(moved / bw, work) * 1e3
    by = "bytes" if moved / bw >= work else "operations"
    basis = ("float32 FMAs" if on_cores else
             f"{3 if dtype == 'float32' else 2} TF32 products")
    other = max(moved / bw, tensor if on_cores else cores) * 1e3
    return b_ms, by, basis, other


def phase_lstm(torch, bw, peak, peak_tf32):
    """lstm_scan against its plain version at LSTM_CASES, float32 and
    bfloat16. Returns the served case's float32 row (per launch) and the
    largest absolute error of any case."""
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    served, max_err, checked = None, 0.0, 0
    b, t, n = LSTM_CASES[0][:3]
    lib_ms = lstm_library_fwd_ms(torch, b, t, n)
    log(f"[kernel-lstm] library: torch.nn.LSTM forward (cuDNN, plain cell, "
        f"input projection included, TF32 off) at ({b}, {t}, {n}) float32 "
        f"{lib_ms:.4f} ms ({lib_ms * 1e3 / t:.2f} us/step)")
    for b, t, n, peephole, masked in LSTM_CASES:
        log(f"[kernel-lstm] b={b} n={n}: {lstm_plan_text(lstm_ops, b, n)}")
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            item = torch.empty((), dtype=dtype).element_size()
            set_bytes = b * t * 5 * n * item + 4 * n * n * item
            nbuf = max(1, min(16, math.ceil(2 * L2_BYTES / set_bytes)))
            sets = [lstm_case_inputs(torch, gen, b, t, n, dtype, peephole,
                                     masked) for _ in range(nbuf)]

            def kernel(i):
                zx, R, p, h0, c0, m = sets[i]
                if peephole:
                    return lstm_ops.lstm_scan_peephole(zx, R, p, h0, c0, m)
                return lstm_ops.lstm_scan(zx, R, h0, c0, m)

            def plain(i):
                zx, R, p, h0, c0, m = sets[i]
                return lstm_ops.lstm_scan_reference(zx, R, h0, c0, p, m)

            got, ref = kernel(0), plain(0)
            torch.cuda.synchronize()
            errs, mag = [], 1.0
            for a, r in zip(got, ref):
                if a.dtype != dtype or a.shape != r.shape:
                    raise AssertionError(f"lstm_scan output {a.dtype} "
                                         f"{tuple(a.shape)}, plain {r.dtype} "
                                         f"{tuple(r.shape)}")
                errs.append(float((a.float() - r.float()).abs().max()))
                mag = max(mag, float(r.float().abs().max()))
            err = max(errs)
            if not err <= LSTM_TOL[dname] * mag:
                raise AssertionError(
                    f"lstm_scan disagrees with its plain version at b={b} "
                    f"t={t} n={n} peephole={peephole} masked={masked} "
                    f"{dname}: max err (hs, hT, cT) {errs}, tol "
                    f"{LSTM_TOL[dname]} x {mag:.3g}")
            if masked and (got[0][1].float().abs().any()
                           or not torch.equal(got[1][1], sets[0][3][1])):
                raise AssertionError("lstm_scan: the fully masked row did "
                                     "not keep its carry")
            max_err = max(max_err, err)
            checked += 1
            k_ms = device_ms(torch, kernel, nbuf,
                             iters=max(3, min(ITERS, 6400 // t)))
            p_ms = device_ms(torch, plain, nbuf,
                             iters=max(2, min(ITERS, 3200 // t)))
            moved = (b * t * 5 * n + 4 * n * n + 4 * b * n
                     + (3 * n if peephole else 0)) * item \
                + (4 * b * t if masked else 0)
            b_ms, by, basis, other_ms = lstm_fwd_bound(b, t, n, dname, bw,
                                                       peak, peak_tf32, moved)
            served_case = (b, t, n, peephole, masked) == LSTM_CASES[0]
            lib = (f"{lib_ms:.4f} ms [torch.nn.LSTM forward, plain cell]"
                   if served_case and dtype == torch.float32 else "-")
            log(f"[kernel-lstm] lstm_scan {dname:8s} b={b:3d} t={t:4d} "
                f"n={n:4d} {'peephole' if peephole else 'plain   '} "
                f"{'masked' if masked else '      '}  max_err={err:.3g} (tol "
                f"{LSTM_TOL[dname]:g} x {mag:.3g})  kernel={k_ms:.4f} ms "
                f"({k_ms * 1e3 / t:.2f} us/step)  plain={p_ms:.4f} ms  "
                f"library={lib}  bound={b_ms:.4f} ms ({by}, {basis}; "
                f"{100 * b_ms / k_ms:.1f}% of it; the other units' bound "
                f"{other_ms:.4f} ms)")
            if served_case and dtype == torch.float32:
                served = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                          "bound_ms": b_ms, "bound_by": by,
                          "library_covers": (
                              "torch.nn.LSTM forward (cuDNN): the plain "
                              "cell, no peepholes, its input projection "
                              "included")}
            del sets
    log(f"[kernel-lstm] verdict: lstm_scan agrees with its plain version in "
        f"{checked}/{checked} (shape, dtype) cases, max abs error "
        f"{max_err:.3g} (tol float32 1e-5, bfloat16 2e-2, x max(1, "
        f"max|plain|)); at (64, 64, 256) float32 {served['ms']:.4f} ms per "
        f"launch ({served['ms'] * 1e3 / 64:.3f} us/step), torch.nn.LSTM "
        f"forward {lib_ms:.4f} ms, bound {served['bound_ms']:.4f} ms "
        f"({100 * served['bound_ms'] / served['ms']:.1f}% of it)")
    phase_lstm_library(torch)
    return served, max_err


def lstm_library_fwd_ms(torch, b, t, n, dtype=None):
    """torch.nn.LSTM's forward (cuDNN, plain cell, its input projection
    included) at (b, t, n), input width n, float32 (or `dtype`), TF32
    off."""
    dev = torch.device("cuda")
    dtype = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lstm = torch.nn.LSTM(n, n, batch_first=True).to(dev, dtype)
    nbuf = max(1, min(8, math.ceil(2 * L2_BYTES / (b * t * n * 4 * 2))))
    runs = [(torch.randn((b, t, n), generator=gen, device=dev).to(dtype),
             tuple(torch.randn((1, b, n), generator=gen, device=dev).to(dtype)
                   for _ in range(2))) for _ in range(nbuf)]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            return device_ms(torch, lambda i: lstm(*runs[i]), nbuf,
                             iters=max(3, min(ITERS, 6400 // t)))
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def phase_lstm_library(torch):
    """The plain cell as a layer: the port's LSTM (projection + kernel)
    beside torch.nn.LSTM (cuDNN, projection included) at (64, 64, 256),
    input width 256, float32 with TF32 off in both."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.nn import inputs as it
    from deeplearning4j_tpu_torch.nn.layers import LSTM

    b, t, n = 64, 64, 256
    dev = torch.device("cuda")
    layer = LSTM(n_out=n, activation="tanh")
    params = {k: v.to(dev) for k, v in layer.init_params(
        torch.Generator().manual_seed(SEED), it.recurrent(n, t)).items()}
    cudnn = torch.nn.LSTM(n, n, batch_first=True).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    nbuf = math.ceil(2 * L2_BYTES / (b * t * n * 4))
    xs = [torch.randn((b, t, n), generator=gen, device=dev)
          for _ in range(nbuf)]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode(), dtypes.full_precision():
            port_ms = device_ms(torch, lambda i: layer.apply(
                params, xs[i], state={}, train=False), nbuf)
            lib_ms = device_ms(torch, lambda i: cudnn(xs[i]), nbuf)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    log(f"[kernel-lstm] plain cell as a layer at b={b} t={t} n={n}, input "
        f"width {n}, float32, TF32 off: port LSTM (x @ W + b, then "
        f"lstm_scan) {port_ms:.4f} ms; library torch.nn.LSTM (cuDNN, its "
        f"input projection included) {lib_ms:.4f} ms")


# ---------------------------------------------------------------- phase 8
def one_hot_rows(np, rng, n, t, vocab):
    return np.eye(vocab, dtype=np.float32)[rng.integers(0, vocab, (n, t))]


def phase_serve_rnn(torch, np, net, card):
    from deeplearning4j_tpu_torch.serving import InferenceServer

    rng = np.random.default_rng(SEED)
    t, vocab = RNN["max_length"], RNN["num_classes"]
    direct = net.output
    forwards = [0]

    def counted_output(x):
        forwards[0] += 1
        return direct(x)

    net.output = counted_output  # counts the server's dispatched batches
    sizes = (1, 3, 8, RNN_BATCH)
    xs = [one_hot_rows(np, rng, n, t, vocab) for n in sizes]
    stream = [one_hot_rows(np, rng, RNN_BATCH, t, vocab) for _ in range(4)]

    def timed(x):
        t0 = time.perf_counter()
        out = server.output(x)
        return out, time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    server = InferenceServer(model=net, batch_limit=RNN_BATCH)
    try:
        server.warmup(xs[0])
        torch.cuda.synchronize()
        log(f"[serve-rnn] warmup of buckets {server.buckets.sizes} took "
            f"{time.perf_counter() - t0:.2f} s")
        with ThreadPoolExecutor(len(sizes)) as pool:
            first = list(pool.map(timed, xs))
        n_stream = 96
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            streamed = list(pool.map(timed, [stream[i % len(stream)]
                                             for i in range(n_stream)]))
        wall = time.perf_counter() - t1
    finally:
        server.shutdown()
        net.output = direct
    launches = read_counts()
    log(f"[serve-rnn] {forwards[0]} batches dispatched, launches {launches} "
        f"(lstm_scan 2 per forward)")
    if forwards[0] == 0 or launches["lstm_scan"] != 2 * forwards[0]:
        raise AssertionError(f"lstm_scan launches {launches['lstm_scan']} "
                             f"!= 2 x {forwards[0]} dispatched batches")

    for x, (out, lat) in zip(xs, first):
        n = x.shape[0]
        if out.shape != (n, t, vocab) or not np.isfinite(out).all():
            raise AssertionError(f"request of {n} rows: bad output "
                                 f"{out.shape}")
        if np.abs(out.sum(axis=-1) - 1.0).max() > 1e-4:
            raise AssertionError(f"request of {n} rows: softmax rows do "
                                 f"not sum to 1")
        ref = direct(x).cpu().numpy()
        rel = float(np.abs(out - ref).max() / np.abs(ref).max())
        # TF32 input projections: cuBLAS may pick another algorithm for
        # the padded bucket than for n rows alone
        if not rel <= 1e-3:
            raise AssertionError(f"request of {n} rows: server and "
                                 f"net.output differ by {rel:.3g} relative")
        log(f"[serve-rnn] request rows={n:2d} latency={lat * 1e3:.2f} ms  "
            f"max |server - net.output| / max|p| = {rel:.3g}  ({card})")
    lats = sorted(lat for _, lat in streamed)
    for out, _ in streamed:
        if out.shape != (RNN_BATCH, t, vocab) or not np.isfinite(out).all():
            raise AssertionError("streamed request: bad output")
    chars = n_stream * RNN_BATCH * t / wall
    log(f"[serve-rnn] stream: {n_stream} requests x {RNN_BATCH} rows x {t} "
        f"characters in {wall:.3f} s = {chars:.1f} chars/s, latency p50 "
        f"{lats[len(lats) // 2] * 1e3:.2f} ms, max {lats[-1] * 1e3:.2f} ms "
        f"({card})")

    x = stream[0]
    fwd, copy = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = direct(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out.cpu()
        fwd.append(t1 - t0)
        copy.append(time.perf_counter() - t1)
    log(f"[serve-rnn] one batch of {RNN_BATCH}: forward (input copy "
        f"included) {min(fwd) * 1e3:.3f} ms, answer copy to host "
        f"{min(copy) * 1e3:.3f} ms for "
        f"{out.numel() * out.element_size() / 1e6:.2f} MB (best of 5; "
        f"{card})")
    return launches


# ---------------------------------------------------------------- phase 9
def phase_stream_rnn(torch, np, net, card):
    from deeplearning4j_tpu_torch import dtypes

    t, vocab = RNN["max_length"], RNN["num_classes"]
    dev = torch.device("cuda")
    x = torch.from_numpy(one_hot_rows(np, np.random.default_rng(SEED + 2),
                                      RNN_BATCH, t, vocab)).to(dev)
    with dtypes.full_precision():
        full = net.output(x)
        net.rnn_clear_previous_state()
        steps = torch.stack([net.rnn_time_step(x[:, s]) for s in range(t)],
                            dim=1)
        net.rnn_clear_previous_state()
        chunks = torch.cat([net.rnn_time_step(x[:, a:a + 16])
                            for a in range(0, t, 16)], dim=1)
        net.rnn_clear_previous_state()
        again = net.rnn_time_step(x[:, 0])
    e_steps = float((steps - full).abs().max())
    e_chunks = float((chunks - full).abs().max())
    if steps.shape != full.shape or e_steps > 1e-5 or e_chunks > 1e-5:
        raise AssertionError(f"rnn_time_step differs from net.output: "
                             f"{e_steps:.3g} stepped, {e_chunks:.3g} in "
                             f"chunks of 16 (tol 1e-5)")
    if not torch.equal(again, steps[:, 0]):
        raise AssertionError("rnn_clear_previous_state did not restart the "
                             "stream")
    log(f"[stream-rnn] {t} single steps and {t // 16} calls of 16 steps "
        f"equal net.output (TF32 off): max |diff| {e_steps:.3g} / "
        f"{e_chunks:.3g} (tol 1e-5); cleared state repeats step 0 exactly")

    # generation: 64 streams, 256 characters each, sampled on the card
    n_chars = 256
    gen = torch.Generator(device=dev).manual_seed(SEED)
    start = torch.randint(0, vocab, (RNN_BATCH,), generator=gen, device=dev)
    eye = torch.eye(vocab, device=dev)

    def generate():
        net.rnn_clear_previous_state()
        cur, ids = eye[start], []
        for _ in range(n_chars):
            probs = net.rnn_time_step(cur)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            ids.append(nxt)
            cur = eye[nxt]
        return torch.stack(ids, dim=1), probs

    generate()  # warm-up: allocator and handles
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, last = generate()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    if launches["lstm_scan"] != 2 * n_chars:
        raise AssertionError(f"lstm_scan launches {launches['lstm_scan']} "
                             f"!= 2 x {n_chars} rnn_time_step calls")
    if ids.shape != (RNN_BATCH, n_chars) or int(ids.min()) < 0 or \
            int(ids.max()) >= vocab or not bool(torch.isfinite(last).all()) \
            or float((last.sum(-1) - 1).abs().max()) > 1e-4:
        raise AssertionError("generation produced bad characters or "
                             "probabilities")
    log(f"[stream-rnn] generated {RNN_BATCH} x {n_chars} characters in "
        f"{wall:.3f} s = {RNN_BATCH * n_chars / wall:.1f} chars/s, "
        f"{wall / n_chars * 1e3:.3f} ms per rnn_time_step call; launches "
        f"{launches} ({card})")
    return launches


# ---------------------------------------------------------------- phase 10
def phase_reference_rnn(torch, np, net):
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    # same config, same seed: the same weights, drawn on the CPU
    cpu_net = TextGenerationLSTM(**RNN, seed=SEED).init(device="cpu")
    x = one_hot_rows(np, np.random.default_rng(SEED + 1), 2,
                     RNN["max_length"], RNN["num_classes"])
    with dtypes.full_precision():
        gpu_acts = net.feed_forward(x)
    cpu_acts = cpu_net.feed_forward(x)
    worst = 0.0
    for i, (a, b) in enumerate(zip(gpu_acts, cpu_acts)):
        a, b = a.cpu().numpy(), b.numpy()
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        worst = max(worst, rel)
        # float32 sums in another order on each device, over 64 steps
        if a.shape != b.shape or not rel <= 1e-4:
            raise AssertionError(f"layer {i - 1}: card and CPU differ, "
                                 f"relative {rel:.3g}")
    log(f"[refer-rnn] {len(cpu_acts)} activations (input and "
        f"{len(cpu_acts) - 1} layers), card (TF32 off) vs CPU: worst "
        f"relative difference {worst:.3g} (tol 1e-4)")


# ---------------------------------------------------------------- phase 11
# (b, h, t, d, causal): the training shape first, then the edge cases
FLASH_BWD_CASES = [
    (16, 8, 512, 64, True),     # TransformerLM training, 6 of each per step
    (16, 8, 512, 64, False),    # non-causal
    (4, 8, 200, 64, True),      # ragged t
    (4, 8, 1, 64, True),        # t = 1
    (4, 8, 300, 16, True),
    (4, 8, 512, 32, True),
    (4, 8, 512, 128, True),
    (2, 4, 129, 128, False),
]
# each of dq, dk and dv x its own plain output's largest magnitude: float32
# sums in another order, bfloat16 one rounding of the float32 result apart.
# The magnitude is 1 where the plain output is zero: all of it, or in exact
# arithmetic at t = 1, where one key gives P = 1 and O = V, so dS = dP -
# delta = 0 and the plain dq and dk are rounding noise.
FLASH_BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def disagrees(a, r, tol, zero=False):
    """(max abs error, limit) when `a` is not `r` within tol x max|r| (x 1
    where `r` is all zero, or `zero`: zero in exact arithmetic); None when
    they agree. NaN disagrees."""
    err = float((a.float() - r.float()).abs().max())
    mag = 1.0 if zero else float(r.float().abs().max()) or 1.0
    bad = a.shape != r.shape or a.dtype != r.dtype or not err <= tol * mag
    return (err, tol * mag) if bad else None


def phase_flash_bwd(torch, bw, peak, peak_bf16, peak_tf32):
    """dq and dk/dv kernels against their plain formulas at
    FLASH_BWD_CASES, float32 and bfloat16. Returns the training case's
    float32 rows (per launch) and the largest absolute error of any case."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa_library

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    served, max_err, checked = {}, 0.0, 0
    for b, h, t, d, causal in FLASH_BWD_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            item = torch.empty((), dtype=dtype).element_size()
            set_bytes = 4 * b * h * t * d * item
            nbuf = max(1, min(16, math.ceil(2 * L2_BYTES / set_bytes)))
            sets = []
            for _ in range(nbuf):
                q, k, v, do = (torch.randn((b, h, t, d), generator=gen,
                                           device=dev).to(dtype)
                               for _ in range(4))
                o, lse = fa.flash_attention(q, k, v, causal, return_lse=True)
                delta = (do.float() * o.float()).sum(-1)
                sets.append((q, k, v, do, o, lse, delta))
            q, k, v, do, o, lse, delta = sets[0]
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
            dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                causal)
            ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                                   causal)
            torch.cuda.synchronize()
            tol, errs = FLASH_BWD_TOL[dname], {}
            where = f"b={b} h={h} t={t} d={d} causal={causal} {dname}"
            for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                bad = disagrees(got, want, tol, t == 1 and name != "dv")
                if bad:
                    raise AssertionError(
                        f"flash backward {name} disagrees with its plain "
                        f"version at {where}: max err {bad[0]:.3g} (limit "
                        f"{bad[1]:.3g})")
                errs[name] = float((got.float() - want.float()).abs().max())
                max_err = max(max_err, errs[name])
            # the comparison must see a broken backward: each output zeroed
            # (dq and dk are zero at t = 1) and a dS without its -delta term
            scale = d ** -0.5
            no_delta = torch.zeros_like(delta)
            broken = [("a dS without -delta", 0, fa._bwd_plain(
                q, k, v, do, lse, no_delta, causal, scale, "dq")),
                ("a dS without -delta", 1, fa._bwd_plain(
                    q, k, v, do, lse, no_delta, causal, scale, "dkv")[0]),
                ("a zeroed dv", 2, torch.zeros_like(dv))]
            if t > 1:
                broken += [("a zeroed dq", 0, torch.zeros_like(dq)),
                           ("a zeroed dk", 1, torch.zeros_like(dk))]
            for name, i, a in broken:
                if not disagrees(a, ref[i], tol, t == 1 and i < 2):
                    raise AssertionError(
                        f"kernel-flash-bwd cannot tell {name} "
                        f"({('dq', 'dk', 'dv')[i]}) from the plain backward "
                        f"at {where}")
            del broken, no_delta
            checked += 1
            k_dq = device_ms(torch, lambda i: fa.flash_attention_bwd_dq(
                *sets[i][:4], sets[i][5], sets[i][6], causal), nbuf)
            k_dkv = device_ms(torch, lambda i: fa.flash_attention_bwd_dkv(
                *sets[i][:4], sets[i][5], sets[i][6], causal), nbuf)
            p_dq = device_ms(torch, lambda i: fa._bwd_plain(
                *sets[i][:4], sets[i][5], sets[i][6], causal, scale, "dq"),
                nbuf, iters=10)
            p_dkv = device_ms(torch, lambda i: fa._bwd_plain(
                *sets[i][:4], sets[i][5], sets[i][6], causal, scale, "dkv"),
                nbuf, iters=10)
            # the library's whole backward (dq, dk and dv in one call)
            lib = []
            for qq, kk, vv, dd, *_ in sets:
                leaves = [a.detach().requires_grad_() for a in (qq, kk, vv)]
                with torch.enable_grad():
                    lib.append((sdpa_library(*leaves, is_causal=causal),
                                leaves, dd))
            l_ms = device_ms(torch, lambda i: torch.autograd.grad(
                lib[i][0], lib[i][1], lib[i][2], retain_graph=True), nbuf)
            del lib
            pairs = b * h * (t * (t + 1) // 2 if causal else t * t)
            in_bytes = 4 * b * h * t * d * item + 2 * 4 * b * h * t
            f32 = dtype == torch.float32
            rows = {}
            # products of 2 d operations per (q, k) pair: dq 3, dk/dv 4.
            # float32 runs each as 3xTF32, three TF32 products on the tensor
            # cores; bfloat16 runs P and dS as hi + lo pairs, two products
            # each (dq 4, dk/dv 6)
            for name, ms, pl_ms, ops, bf16_ops, out_n in (
                    ("dq", k_dq, p_dq, 3, 4, 1),
                    ("dkv", k_dkv, p_dkv, 4, 6, 2)):
                moved = in_bytes + out_n * b * h * t * d * item
                work = 2 * d * pairs * (3 * ops if f32 else bf16_ops)
                rate = peak_tf32 if f32 else peak_bf16
                b_ms = max(moved / bw, work / rate) * 1e3
                by = "bytes" if moved / bw >= work / rate else "operations"
                core = (f"  cuda-core bound="
                        f"{max(moved / bw, 2 * d * pairs * ops / peak) * 1e3:.4f}"
                        f" ms" if f32 else "")
                # one library call gives dq, dk and dv: its time is shared
                # by the pair, not comparable with either kernel alone
                rows[name] = {"ms": ms, "plain_ms": pl_ms, "library_ms": l_ms,
                              "library_covers": "dq, dk and dv: shared by "
                              "flash_attention_bwd_dq and _dkv",
                              "bound_ms": b_ms, "bound_by": by}
                log(f"[kernel-flash-bwd] {name:3s} {dname:8s} b={b:2d} h={h} "
                    f"t={t:3d} d={d:3d} {'causal' if causal else 'full  '}  "
                    f"max_err={max(errs[n] for n in (['dq'] if name == 'dq' else ['dk', 'dv'])):.3g} "
                    f"(tol {tol:g} x max|plain|)  "
                    f"kernel={ms:.4f} ms  plain={pl_ms:.4f} ms  "
                    f"bound={b_ms:.4f} ms ({by}{', 3xTF32' if f32 else ''})"
                    f"{core}")
            log(f"[kernel-flash-bwd] dq + dkv {dname:8s} kernels together "
                f"{k_dq + k_dkv:.4f} ms  library[sdpa backward, dq+dk+dv]="
                f"{l_ms:.4f} ms")
            if (b, h, t, d, causal) == FLASH_BWD_CASES[0] and \
                    dtype == torch.float32:
                served = rows
            del sets
    log(f"[kernel-flash-bwd] verdict: dq and dk/dv agree with their plain "
        f"versions in {checked}/{checked} (shape, dtype) cases, max abs "
        f"error {max_err:.3g} (tol float32 1e-4, bfloat16 1e-2, x max|plain| "
        f"of each output); a zeroed dv and a dS without -delta fail the "
        f"comparison in every case, a zeroed dq or dk in every case with "
        f"t > 1 (at t = 1 both are zero)")
    return served, max_err


# ---------------------------------------------------------------- phase 12
# (n, d, v, labels, dtype): the training shape first
XENT_CASES = [
    (8192, 512, 8192, "onehot", "float32"),   # TransformerLM training
    (8192, 512, 8192, "soft", "float32"),
    (8192, 512, 8192, "mixed", "float32"),    # one smoothed row: dense path
    (8192, 512, 8192, "onehot", "bfloat16"),  # the mixed-precision policy
    (8192, 512, 8192, "soft", "bfloat16"),
    (1000, 200, 3001, "onehot", "float32"),   # ragged n, d and v
    (1000, 200, 3001, "mixed", "bfloat16"),
    # the char-RNN training paths: V = 77 is less than one vocabulary tile
    (4096, 256, 77, "onehot", "float32"),     # BPTT step, 64 x 64
    (4096, 256, 77, "onehot", "bfloat16"),    # its mixed-precision steps
    (1600, 256, 77, "onehot", "float32"),     # a tBPTT window, 32 x 50
    (32768, 256, 77, "onehot", "float32"),    # long sequences, 8 x 4096
    # the image training paths at batch 64: ResNet-50's Output (2048 ->
    # 1000) and LeNet's (500 -> 10), both policies
    (64, 2048, 1000, "onehot", "float32"),
    (64, 2048, 1000, "onehot", "bfloat16"),
    (64, 500, 10, "onehot", "float32"),
    (64, 500, 10, "onehot", "bfloat16"),
    # the 128 x 128 tiles' edges: n past one row tile, rows of x (d = 70)
    # and W (v = 333) not 16-byte aligned, a ragged last vocabulary tile
    (129, 70, 333, "mixed", "float32"),
]
# each output x max|plain| of that output (1 where the plain output is all
# zero): forward outputs (float32 for both dtypes: the products are exact in
# float32) 1e-4, sums over d and the vocabulary in another order; backward
# dx and dz 1e-4 (float32) or 1e-2 (bfloat16, one rounding apart), db 1e-4.
# The cotangent is of order 1, so that dx and dz are as large as the
# label term makes them.
XENT_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def xent_inputs(torch, gen, n, d, v, labels, dtype):
    dev = torch.device("cuda")
    x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
    w = (torch.randn(d, v, generator=gen, device=dev) * d ** -0.5).to(dtype)
    b = torch.randn(v, generator=gen, device=dev) * 0.1
    ids = torch.randint(0, v, (n,), generator=gen, device=dev)
    t = torch.nn.functional.one_hot(ids, v).float()
    if labels == "soft":
        t = torch.rand(n, v, generator=gen, device=dev) / v
    elif labels == "mixed":
        t[3] = 0.9 * t[3] + 0.1 / v
    g = torch.rand(n, generator=gen, device=dev) + 0.5
    return x, w, b, t, ids, g


def phase_xent(torch, bw, peak, peak_bf16, peak_tf32, cases=XENT_CASES,
               tag="kernel-xent"):
    """Forward and backward kernels against their plain versions at
    `cases`. Returns each case's rows ({case: {"fwd": ..., "bwd": ...}})
    and the largest absolute error of any case."""
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import xent_kernel as xk

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    by_case, max_err = {}, 0.0
    for n, d, v, labels, dname in cases:
        dtype = getattr(torch, dname)
        item = torch.empty((), dtype=dtype).element_size()
        x, w, b, t, ids, g = xent_inputs(torch, gen, n, d, v, labels, dtype)
        got = xk.linear_xent_fwd(x, w, b, t)
        ref = xk.linear_xent_fwd_reference(x, w, b, t)
        flag = got[4].amin().reshape(())
        dx, dz, db = xk.linear_xent_bwd(x, w, b, t, got[3], flag, got[1],
                                        got[2], g)
        rdx, rdz, rdb = xk.linear_xent_bwd_reference(x, w, b, t, got[1],
                                                     got[2], g)
        torch.cuda.synchronize()
        errs = {}
        for name, a, r, tol in (
                ("per_row", got[0], ref[0], 1e-4), ("lse", got[1], ref[1],
                                                    1e-4),
                ("T", got[2], ref[2], 1e-4), ("dx", dx, rdx, XENT_TOL[dname]),
                ("dz", dz, rdz, XENT_TOL[dname]), ("db", db, rdb, 1e-4)):
            bad = disagrees(a, r, tol)
            if bad:
                raise AssertionError(
                    f"linear_xent {name} disagrees with its plain version at"
                    f" n={n} d={d} v={v} {labels} {dname}: max err "
                    f"{bad[0]:.3g} (limit {bad[1]:.3g})")
            errs[name] = float((a.float() - r.float()).abs().max())
            max_err = max(max_err, errs[name])
        # the comparison must see a broken backward: a zeroed dx, a zeroed
        # dz and a dz without its label term each fail it
        no_label = (dz.float() + g[:, None] * t).to(dz.dtype)
        for name, a, r in (("dx = 0", torch.zeros_like(dx), rdx),
                           ("dz = 0", torch.zeros_like(dz), rdz),
                           ("dz without the label term", no_label, rdz)):
            if not disagrees(a, r, XENT_TOL[dname]):
                raise AssertionError(f"{tag} cannot tell {name} from "
                                     f"the plain backward ({labels} {dname})")
        del no_label
        one = labels == "onehot"
        if not (torch.equal(got[3], ref[3]) and torch.equal(got[4], ref[4])
                and float(flag) == (1.0 if one else 0.0)):
            raise AssertionError(f"linear_xent idx / one-hot flag differ "
                                 f"from the plain version ({labels})")
        k_f = device_ms(torch, lambda i: xk.linear_xent_fwd(x, w, b, t), 1,
                        iters=10)
        k_b = device_ms(torch, lambda i: xk.linear_xent_bwd(
            x, w, b, t, got[3], flag, got[1], got[2], g), 1, iters=10)
        p_f = device_ms(torch, lambda i: xk.linear_xent_fwd_reference(
            x, w, b, t), 1, iters=10)
        p_b = device_ms(torch, lambda i: xk.linear_xent_bwd_reference(
            x, w, b, t, got[1], got[2], g), 1, iters=10)
        # library: one F.cross_entropy over materialized logits, forward,
        # and its backward through autograd (which also gives dW)
        if one:
            leaves = [a.detach().requires_grad_() for a in (x, w, b)]
            l_f = device_ms(torch, lambda i: F.cross_entropy(
                leaves[0] @ leaves[1] + leaves[2], ids, reduction="none"),
                1, iters=10)
            with torch.enable_grad():
                lib_out = F.cross_entropy(leaves[0] @ leaves[1] + leaves[2],
                                          ids, reduction="none")
            l_b = device_ms(torch, lambda i: torch.autograd.grad(
                lib_out, leaves, g, retain_graph=True), 1, iters=10)
            del lib_out, leaves
        else:
            l_f = l_b = None
        # float32 products run as 3xTF32: three TF32 products each
        f32 = dtype == torch.float32
        rate, per_op = (peak_tf32, 3) if f32 else (peak_bf16, 1)
        work = 2 * n * d * v
        ins = (n * d + d * v) * item + 4 * v
        label_bytes = 4 * n * v
        rows = {}
        for name, ms, pl_ms, lib_ms, ops, moved in (
                ("fwd", k_f, p_f, l_f, work, ins + label_bytes + 4 * 5 * n),
                # the index path reads idx instead of the labels
                ("bwd", k_b, p_b, l_b, 2 * work,
                 ins + (4 * n if one else label_bytes) + 4 * 3 * n
                 + (n * d + n * v) * item + 4 * v)):
            b_ms = max(moved / bw, per_op * ops / rate) * 1e3
            by = "bytes" if moved / bw >= per_op * ops / rate else \
                "operations"
            core = (f"  cuda-core bound="
                    f"{max(moved / bw, ops / peak) * 1e3:.4f} ms"
                    if f32 else "")
            rows[name] = {"ms": ms, "plain_ms": pl_ms, "library_ms": lib_ms,
                          "bound_ms": b_ms, "bound_by": by}
            lib_s = "n/a (soft labels)" if lib_ms is None else \
                f"{lib_ms:.4f} ms"
            log(f"[{tag}] {name} {dname:8s} n={n} d={d} v={v} "
                f"{labels:6s}  max_err={max(errs.values()):.3g}  kernel="
                f"{ms:.4f} ms  plain={pl_ms:.4f} ms  library[F.cross_entropy"
                f" {'forward' if name == 'fwd' else 'backward'}]={lib_s}  "
                f"bound={b_ms:.4f} ms ({by}){core}")
        by_case[(n, d, v, labels, dname)] = rows
        del x, w, b, t, got, ref, dx, dz, db, rdx, rdz, rdb
        torch.cuda.empty_cache()
    log(f"[{tag}] verdict: forward and backward agree with their plain"
        f" versions in {len(cases)}/{len(cases)} cases, max abs "
        f"error {max_err:.3g} (tol 1e-4, bfloat16 dx/dz 1e-2, x max|plain| "
        f"of each output); a zeroed dx, a zeroed dz and a dz without its "
        f"label term fail the comparison in every case")
    return by_case, max_err


# ---------------------------------------------------------------- phase 13
LM_PER_STEP = {"flash_attention": LM["n_layers"],
               "flash_attention_bwd_dq": LM["n_layers"],
               "flash_attention_bwd_dkv": LM["n_layers"],
               "linear_xent_fwd": 1, "linear_xent_bwd": 1}


def lm_batch(np, rng, n, t, vocab):
    """n x t token ids and their one-hot float32 next-token labels, as
    bench.py's transformer row makes them."""
    ids = rng.integers(0, vocab, (n, t + 1))
    y = np.zeros((n, t, vocab), np.float32)
    np.put_along_axis(y, ids[:, 1:, None], 1.0, axis=-1)
    return ids[:, :t].astype(np.int32), y


def train_steps(torch, net, x_np, y_np, steps, DataSet):
    """`steps` fit calls on one host batch, each copying it to the card
    first. Returns per-step (copy s, rest s, score)."""
    dev = net.device
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = torch.from_numpy(x_np).to(dev)
        y = torch.from_numpy(y_np).to(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        net.fit(DataSet(x, y))
        torch.cuda.synchronize()
        out.append((t1 - t0, time.perf_counter() - t1, net.score_))
    return out


def phase_train_lm(torch, np, card):
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.zoo import TransformerLM

    t, vocab = LM["max_length"], LM["num_classes"]
    x_np, y_np = lm_batch(np, np.random.default_rng(SEED + 3), LM_BATCH, t,
                          vocab)
    results = {}
    for mixed, steps in ((False, TRAIN_STEPS), (True, MIXED_STEPS)):
        tag = "mixed bf16" if mixed else "TF32"
        net = TransformerLM(**LM, seed=SEED).init()
        dtypes.set_mixed_precision(mixed)
        torch.cuda.reset_peak_memory_stats()
        try:
            reset_counts()
            runs = train_steps(torch, net, x_np, y_np, steps, DataSet)
            launches = read_counts()
        finally:
            dtypes.set_mixed_precision(False)
        scores = [s for *_, s in runs]
        if not all(math.isfinite(s) for s in scores) or \
                not scores[-1] < scores[0]:
            raise AssertionError(f"train-lm ({tag}): scores {scores}")
        want = {k: steps * n for k, n in LM_PER_STEP.items()}
        got = {k: launches[k] for k in LM_PER_STEP}
        if got != want:
            raise AssertionError(f"train-lm ({tag}): launches {got}, want "
                                 f"{want}")
        # the first step pays one-time set-up (cuBLAS handles, allocator)
        steady = runs[1:]
        copy_ms = sorted(c for c, _, _ in steady)[len(steady) // 2] * 1e3
        rest_ms = sorted(r for _, r, _ in steady)[len(steady) // 2] * 1e3
        tok_s = LM_BATCH * t / ((copy_ms + rest_ms) / 1e3)
        log(f"[train-lm] {tag}: {steps} steps of {LM_BATCH} x {t} tokens, "
            f"score {scores[0]:.5f} -> {scores[-1]:.5f}; launches {got} "
            f"(per step {LM_PER_STEP})")
        log(f"[train-lm] {tag}: median step {copy_ms + rest_ms:.2f} ms = "
            f"labels copy to the card {copy_ms:.2f} ms ({y_np.nbytes / 1e6:.1f}"
            f" MB from pageable memory) + the rest {rest_ms:.2f} ms; "
            f"{tok_s:.1f} trained tokens/s; first step "
            f"{(runs[0][0] + runs[0][1]) * 1e3:.2f} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({card})")
        results[tag] = launches
        del net
        torch.cuda.empty_cache()
    return results["TF32"]


# ---------------------------------------------------------------- phase 14
# An element whose reference RMS gradient is below this share of the
# network's largest is zero up to float32 rounding (the attention key bias,
# to which softmax is invariant: 3.3e-10 against 0.037). Adam divides the
# rounding noise by its own size, so such an element's change is set by the
# noise on each device and is held only to Adam's bound of lr per step.
ZERO_GRAD = 1e-6


def phase_refer_train(torch, np):
    from deeplearning4j_tpu_torch import dtypes, interop
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import flat_items
    from deeplearning4j_tpu_torch.zoo import TransformerLM

    cfg = dict(LM, n_layers=2)
    steps, lr = 3, 3e-4
    x, y = lm_batch(np, np.random.default_rng(SEED + 4), 2, 128,
                    LM["num_classes"])
    nets = {"card": TransformerLM(**cfg, seed=SEED).init(),
            "cpu": TransformerLM(**cfg, seed=SEED).init(device="cpu")}
    start = {k: {key: p.copy() for key, p in net.get_param_table().items()}
             for k, net in nets.items()}
    scores = {k: [] for k in nets}
    with dtypes.full_precision():
        for _ in range(steps):
            for k, net in nets.items():
                net.fit(DataSet(x, y))
                scores[k].append(net.score_)
    rel = max(abs(a - b) / abs(b) for a, b in zip(scores["card"],
                                                  scores["cpu"]))
    moved = {k: {key: p - start[k][key]
                 for key, p in net.get_param_table().items()}
             for k, net in nets.items()}
    slots = {k: interop.opt_state_to_jax(net) for k, net in nets.items()}
    rms = {f"layer_{i}/{path}": np.sqrt(v)
           for i, b in enumerate(slots["cpu"]) if b
           for path, v in flat_items(b["v"])}
    floor = ZERO_GRAD * max(float(r.max()) for r in rms.values())
    p_err, z_move, n_zero, s_err, steps_ok = 0.0, 0.0, 0, 0.0, True
    for key, want in moved["cpu"].items():
        got, zero = moved["card"][key], rms[key] <= floor
        p_err = max(p_err, float(np.abs(got - want)[~zero].max(initial=0)))
        z_move = max(z_move, float(np.abs(got)[zero].max(initial=0)),
                     float(np.abs(want)[zero].max(initial=0)))
        n_zero += int(np.count_nonzero(zero & (want != 0)))
    for a, b in zip(slots["card"], slots["cpu"]):
        if not b:
            continue
        steps_ok &= int(a["t"]) == int(b["t"]) == steps
        for slot in ("m", "v"):
            got = dict(flat_items(a[slot]))
            for path, want in flat_items(b[slot]):
                s_err = max(s_err, float(np.abs(got[path] - want).max()
                                         / max(np.abs(want).max(), 1e-30)))
    # scores: float32 sums in another order on each device; each element's
    # change from its start 1e-5 absolute (sound: 4.52e-06 over every
    # element, a step moves an element by up to lr = 3e-4); zero-gradient
    # elements within Adam's bound; slots m and v relative to each leaf's
    # largest magnitude
    finite = all(np.isfinite(a).all() for k in nets
                 for a in [*moved[k].values(), *(
                     leaf for b in slots[k] if b for slot in ("m", "v")
                     for _, leaf in flat_items(b[slot]))]) and all(
        math.isfinite(x) for v in scores.values() for x in v)
    if not (rel <= 1e-5 and p_err <= 1e-5 and z_move <= 1.01 * steps * lr
            and s_err <= 1e-4 and steps_ok and finite):
        raise AssertionError(
            f"refer-train: card and CPU differ: scores {scores}, changes "
            f"{p_err:.3g}, zero-gradient moves {z_move:.3g}, slots "
            f"{s_err:.3g}, steps counted {steps_ok}, finite {finite}")
    log(f"[refer-train] TransformerLM (2 blocks, full width), {steps} Adam "
        f"steps on 2 x 128 tokens, card (TF32 off) vs CPU: scores "
        f"{scores['card']} vs {scores['cpu']} (relative {rel:.3g}, tol "
        f"1e-5); params' change from their start max |diff| {p_err:.3g} "
        f"(tol 1e-5); {n_zero} moved elements with zero gradient (RMS "
        f"gradient <= {floor:.3g}) move at most {z_move:.3g} (Adam's bound "
        f"{1.01 * steps * lr:.3g}); Adam m, v max relative {s_err:.3g} "
        f"(tol 1e-4); t = {steps} on both")


# ---------------------------------------------------------------- phase 15
# (b, t, n, peephole, masked): the training paths' shapes first, then the
# edge cases
LSTM_BWD_CASES = [
    (64, 64, 256, True, False),     # BPTT step: 2 of rows 5 and 6 per step
    (32, 50, 256, True, False),     # one tBPTT window
    (8, 4096, 256, True, False),    # long sequences: 2 of rows 7 and 8
    (64, 64, 256, False, False),    # plain cell (LSTM)
    (8, 64, 256, True, True),       # ragged, one row fully masked, one
                                    # masked in the middle of its sequence
    (3, 7, 12, True, True),         # ragged small
    (8, 1, 256, True, False),       # t = 1
    (8, 1000, 256, True, False),    # a ragged last chunk: 1000 = 15 x 64 + 40
    (16, 64, 512, True, False),     # wide n: R read from L2 every step
    (8, 64, 1024, True, False),     # n at the kernels' cap
]
# x max|plain| of each output (1 where it is all zero). Float32 outputs:
# forward (hs, hT, cT, hck, cck) 1e-5, as lstm_scan; backward (dR, dp, dh0,
# dc0, float32 dzx) 1e-4: sums over b t terms and two chains of t steps in
# another order. Bfloat16 outputs: 2e-2 forward, 1e-2 dzx (one rounding of
# the float32 value apart).
LSTM_BWD_TOL = {("fwd", "float32"): 1e-5, ("fwd", "bfloat16"): 2e-2,
                ("bwd", "float32"): 1e-4, ("bwd", "bfloat16"): 1e-2}
LSTM_PATH_CASES = {"lstm_scan_bwd": LSTM_BWD_CASES[0],
                   "lstm_scan_chunked": LSTM_BWD_CASES[2],
                   "lstm_scan_chunked_bwd": LSTM_BWD_CASES[2]}


def lstm_bwd_inputs(torch, gen, b, t, n, dtype, peephole, masked):
    """lstm_case_inputs (one row fully masked when masked, and one more
    masked in the middle of its sequence), cotangents of order 1 and the
    chunked forward's hs, hck and cck."""
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops

    zx, R, p, h0, c0, m = lstm_case_inputs(torch, gen, b, t, n, dtype,
                                           peephole, masked)
    if masked:
        r = min(4, b - 1)
        m[r] = 1.0
        m[r, t // 3:2 * t // 3] = 0.0
    g = tuple(torch.randn(s, generator=gen, device=zx.device).to(dtype)
              for s in ((b, t, n), (b, n), (b, n)))
    fwd = lstm_ops.lstm_scan_chunked_forward(zx, R, h0, c0, p, m)
    return {"zx": zx, "R": R, "p": p, "h0": h0, "c0": c0, "m": m, "g": g,
            "fwd": fwd}


def lstm_disagrees(a, r, tol):
    """(max abs error, limit) of `a` against `r` at tol x max|r|; the limit
    is None when they agree."""
    err = float((a.float() - r.float()).abs().max()) if a.numel() else 0.0
    mag = (float(r.float().abs().max()) if r.numel() else 0.0) or 1.0
    ok = a.shape == r.shape and a.dtype == r.dtype and err <= tol * mag
    return err, None if ok else tol * mag


def lstm_bwd_check(kname, names, got, ref, kind, where):
    """Each output of `got` against `ref`; returns the largest abs error."""
    worst = 0.0
    for name, a, r in zip(names, got, ref):
        if r is None:
            if a is not None:
                raise AssertionError(f"{kname} {name}: got a tensor for none")
            continue
        tol = LSTM_BWD_TOL[(kind, str(r.dtype)[6:])]
        err, limit = lstm_disagrees(a, r, tol)
        if limit is not None:
            raise AssertionError(
                f"{kname} {name} disagrees with its plain version at {where}:"
                f" max err {err:.3g}, limit {limit:.3g} ({a.dtype} "
                f"{tuple(a.shape)} vs {r.dtype} {tuple(r.shape)})")
        worst = max(worst, err)
    return worst


def lstm_library_bwd_ms(torch, b, t, n, dtype=None):
    """torch.nn.LSTM's backward (cuDNN, plain cell, its input projection's
    backward included) at (b, t, n), input width n, float32 (or `dtype`),
    TF32 off: one autograd.grad of its output, hT and cT."""
    dev = torch.device("cuda")
    dtype = dtype or torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lstm = torch.nn.LSTM(n, n, batch_first=True).to(dev, dtype)
    nbuf = max(1, min(8, math.ceil(2 * L2_BYTES / (b * t * n * 4 * 3))))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for _ in range(nbuf):
            x = torch.randn((b, t, n), generator=gen, device=dev,
                            dtype=dtype, requires_grad=True)
            h0, c0 = (torch.randn((1, b, n), generator=gen, device=dev,
                                  dtype=dtype, requires_grad=True)
                      for _ in range(2))
            with torch.enable_grad():
                out, (hT, cT) = lstm(x, (h0, c0))
            gs = [torch.randn_like(o) for o in (out, hT, cT)]
            runs.append(([out, hT, cT], [x, h0, c0, *lstm.parameters()], gs))
        return device_ms(torch, lambda i: torch.autograd.grad(
            runs[i][0], runs[i][1], runs[i][2], retain_graph=True), nbuf,
            iters=max(3, min(ITERS, 6400 // t)))
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def phase_lstm_library_bf16(torch):
    """torch.nn.LSTM (cuDNN, plain cell, input projection included) in
    bfloat16 at the LSTM rows' path shapes: rows 5 and 6 at (64, 64,
    256), rows 7 and 8 at (8, 4096, 256), forward and backward; the
    library times of the bfloat16 rows. A refusal by cuDNN is logged as
    such."""
    for rows, (b, t, n) in (("5, 6", (64, 64, 256)),
                            ("7, 8", (8, 4096, 256))):
        try:
            f_ms = lstm_library_fwd_ms(torch, b, t, n, torch.bfloat16)
            b_ms = lstm_library_bwd_ms(torch, b, t, n, torch.bfloat16)
        except RuntimeError as e:
            log(f"[kernel-lstm-bwd] library bfloat16 (rows {rows}) at "
                f"({b}, {t}, {n}): torch.nn.LSTM refuses bfloat16: {e}")
            continue
        log(f"[kernel-lstm-bwd] library bfloat16 (rows {rows}): "
            f"torch.nn.LSTM (cuDNN, plain cell, input projection included) "
            f"at ({b}, {t}, {n}): forward {f_ms:.4f} ms, backward "
            f"{b_ms:.4f} ms")


def chunk_dR(torch, s, dz, j, tc):
    """The part of dR that chunk j's (row, step) pairs add, h_{s-1}^T dz_s,
    in exact float32 from the forward's hs (the h carry without a mask)."""
    from deeplearning4j_tpu_torch import dtypes

    hs, h0 = s["fwd"][0].float(), s["h0"].float()
    s0, s1 = j * tc, min(hs.shape[1], (j + 1) * tc)
    h = torch.cat([h0[:, None], hs[:, :-1]], dim=1)[:, s0:s1]
    with dtypes.exact_float32_matmul():
        return h.reshape(-1, h.shape[-1]).t() @ \
            dz[:, s0:s1].float().reshape(-1, dz.shape[-1])


def lstm_bwd_broken(torch, s, got, ref, tc):
    """Broken chunked backward outputs that the comparison must reject: a
    zeroed dzx, dR and dp; a dR without chunk 0's part; a dzx whose chunk
    0 holds chunk 1's values, as a chunk slot read before it was written
    again would leave it."""
    broken = [(0, "zeroed dzx", torch.zeros_like(got[0])),
              (1, "zeroed dR", torch.zeros_like(got[1])),
              (2, "zeroed dp", torch.zeros_like(got[2])),
              (1, "dR without chunk 0", got[1] - chunk_dR(torch, s, got[0],
                                                          0, tc))]
    stale = got[0].clone()
    stale[:, :tc] = got[0][:, tc:2 * tc]
    broken.append((0, "dzx with chunk 0 stale", stale))
    for i, what, out in broken:
        tol = LSTM_BWD_TOL[("bwd", str(out.dtype)[6:])]
        if lstm_disagrees(out, ref[i], tol)[1] is None:
            raise AssertionError(f"kernel-lstm-bwd cannot tell a {what} "
                                 f"from the plain backward")
    return [what for _, what, _ in broken]


def lstm_fwd_reject(what, out, ref):
    tol = LSTM_BWD_TOL[("fwd", str(ref.dtype)[6:])]
    if lstm_disagrees(out, ref, tol)[1] is None:
        raise AssertionError(f"kernel-lstm-bwd cannot tell a {what} from "
                             f"the plain forward")
    return what


def lstm_fwd_broken(lstm_ops, s, ref):
    """Broken chunked forward outputs that the comparison must reject: hs
    whose units of one block (the plan's second) lag one step, as a block
    that read last step's h would give; hck whose chunk 0 holds chunk 1's
    checkpoint."""
    hs, hck = s["fwd"][0], s["fwd"][3]
    b, t, n = hs.shape
    j = lstm_ops.plan(b, n)["units"]
    lag = hs.clone()
    lag[:, 1:, j:2 * j] = hs[:, :-1, j:2 * j]
    stale = hck.clone()
    stale[0] = hck[1]
    return [lstm_fwd_reject("hs whose units of block 1 lag one step", lag,
                            ref[0]),
            lstm_fwd_reject("hck holding the next chunk's checkpoint", stale,
                            ref[3])]


def lstm_masked_cT_broken(lstm_ops, s, ref):
    """A cT that took the last step of a masked row (the carry run on
    through its masked steps) must be rejected."""
    rows = [r for r in range(s["m"].shape[0]) if not bool(s["m"][r, -1] > 0)]
    if not rows:
        return []
    live = lstm_ops.lstm_scan_chunked_reference(
        s["zx"], s["R"], s["h0"], s["c0"], s["p"], None)
    cT = s["fwd"][2].clone()
    cT[rows] = live[2][rows]
    return [lstm_fwd_reject("cT from the last step of a masked row", cT,
                            ref[2])]


def phase_lstm_bwd(torch, bw, peak, peak_tf32):
    """Rows 6 (lstm_scan_bwd), 7 (lstm_scan_chunked) and 8
    (lstm_scan_chunked_bwd) against their plain versions at LSTM_BWD_CASES,
    float32 and bfloat16, from the same inputs (row 6 reads the chunked
    forward's hs, row 8 its checkpoints). Returns each kernel's float32 row
    at its path's shape (per launch) and its largest absolute error. The
    backward's bounds count its products on the tensor cores: as 3xTF32 in
    float32, two TF32 products each in bfloat16 (R, or hs, is exact in
    TF32; h or dz is not) but one for row 6's z without a mask (hs and R);
    row 7's is lstm_fwd_bound's."""
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    names_fwd = ("hs", "hT", "cT", "hck", "cck")
    names_bwd = ("dzx", "dR", "dp", "dh0", "dc0")
    rows, worst, checked = {}, dict.fromkeys(LSTM_PATH_CASES, 0.0), 0
    rejected_c = []
    for case in LSTM_BWD_CASES:
        b, t, n, peephole, masked = case
        nt = -(-t // lstm_ops.CHUNK)
        lib_ms = (lstm_library_bwd_ms(torch, b, t, n)
                  if case in LSTM_PATH_CASES.values() else None)
        lib_fwd_ms = (lstm_library_fwd_ms(torch, b, t, n)
                      if case == LSTM_PATH_CASES["lstm_scan_chunked"]
                      else None)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            item = torch.empty((), dtype=dtype).element_size()
            set_bytes = b * t * 7 * n * item + 4 * n * n * item
            nbuf = max(1, min(16, math.ceil(2 * L2_BYTES / set_bytes)))
            sets = [lstm_bwd_inputs(torch, gen, b, t, n, dtype, peephole,
                                    masked) for _ in range(nbuf)]

            def row6(s):
                return lstm_ops.lstm_scan_bwd(s["zx"], s["R"], s["h0"],
                                              s["c0"], s["fwd"][0], *s["g"],
                                              s["p"], s["m"])

            def row7(s):
                return lstm_ops.lstm_scan_chunked_forward(
                    s["zx"], s["R"], s["h0"], s["c0"], s["p"], s["m"])

            def row8(s):
                return lstm_ops.lstm_scan_chunked_bwd(
                    s["zx"], s["R"], s["fwd"][3], s["fwd"][4], *s["g"],
                    s["p"], s["m"])

            def plain6(s):
                return lstm_ops.lstm_scan_backward_reference(
                    s["zx"], s["R"], s["h0"], s["c0"], s["fwd"][0], *s["g"],
                    s["p"], s["m"])

            def plain7(s):
                return lstm_ops.lstm_scan_chunked_reference(
                    s["zx"], s["R"], s["h0"], s["c0"], s["p"], s["m"])

            def plain8(s):
                return lstm_ops.lstm_scan_chunked_backward_reference(
                    s["zx"], s["R"], s["fwd"][3], s["fwd"][4], *s["g"],
                    s["p"], s["m"])

            s = sets[0]
            where = (f"b={b} t={t} n={n} peephole={peephole} "
                     f"masked={masked} {dname}")
            got6, got8 = row6(s), row8(s)
            ref6, ref7, ref8 = plain6(s), plain7(s), plain8(s)
            torch.cuda.synchronize()
            errs = {
                "lstm_scan_chunked": lstm_bwd_check(
                    "lstm_scan_chunked", names_fwd, s["fwd"], ref7, "fwd",
                    where),
                "lstm_scan_bwd": lstm_bwd_check(
                    "lstm_scan_bwd", names_bwd, got6, ref6, "bwd", where),
                "lstm_scan_chunked_bwd": lstm_bwd_check(
                    "lstm_scan_chunked_bwd", names_bwd, got8, ref8, "bwd",
                    where)}
            for k, e in errs.items():
                worst[k] = max(worst[k], e)
            if masked:
                # the fully masked row passes its carry's cotangent through
                for got in (got6, got8):
                    if not (torch.equal(got[3][1], s["g"][1][1].float())
                            and torch.equal(got[4][1], s["g"][2][1].float())):
                        raise AssertionError(
                            "lstm backward: the fully masked row did not "
                            "pass g_hT, g_cT through to dh0, dc0")
            if checked == 0:
                # the comparison must see a broken backward
                for i, name in ((0, "dzx"), (1, "dR"), (2, "dp")):
                    zeroed = torch.zeros_like(got6[i])
                    tol = LSTM_BWD_TOL[("bwd", str(zeroed.dtype)[6:])]
                    if lstm_disagrees(zeroed, ref6[i], tol)[1] is None:
                        raise AssertionError(f"kernel-lstm-bwd cannot tell a "
                                             f"zeroed {name} from the plain "
                                             f"backward")
            if case == LSTM_PATH_CASES["lstm_scan_chunked_bwd"]:
                rejected = lstm_bwd_broken(torch, s, got8, ref8,
                                           lstm_ops.CHUNK)
                rejected += lstm_fwd_broken(lstm_ops, s, ref7)
            if masked and dtype == torch.float32:
                rejected_c = lstm_masked_cT_broken(lstm_ops, s, ref7)
            checked += 1
            del got6, got8, ref6, ref7, ref8

            k_iters = max(3, min(ITERS, 6400 // t))
            ms = {"lstm_scan_bwd": device_ms(
                      torch, lambda i: row6(sets[i]), nbuf, k_iters),
                  "lstm_scan_chunked": device_ms(
                      torch, lambda i: row7(sets[i]), nbuf, k_iters),
                  "lstm_scan_chunked_bwd": device_ms(
                      torch, lambda i: row8(sets[i]), nbuf, k_iters)}
            plain_ms = dict.fromkeys(ms)
            if dtype == torch.float32:
                # the plain versions launch thousands of small kernels
                # one at a time: a few calls
                p_iters = max(1, min(10, 640 // t))
                for k, fn in (("lstm_scan_bwd", plain6),
                              ("lstm_scan_chunked", plain7),
                              ("lstm_scan_chunked_bwd", plain8)):
                    plain_ms[k] = device_ms(torch, lambda i: fn(sets[i]),
                                            nbuf, p_iters)
            # the kernels form every product in float32, for both dtypes:
            # the backward's three (z, dh, dR) on the tensor cores as TF32
            # products, 3 per product in float32; bfloat16 2, as R and hs
            # are exact in TF32 and h and dz are not, but 1 for row 6's z
            # without a mask, where hs and R are both exact. Row 7's one
            # (lstm_fwd_bound): float32 FMAs on the CUDA cores, or TF32
            # products past n = 256
            fwd_ops = 2 * b * t * n * 4 * n
            f32 = dtype == torch.float32
            tf32_products = {
                "lstm_scan_bwd": 9 if f32 else 6 if masked else 5,
                "lstm_scan_chunked_bwd": 9 if f32 else 6}
            p_bytes = 3 * n * item if peephole else 0
            m_bytes = 4 * b * t if masked else 0
            ck_bytes = 2 * nt * b * n * 4
            common = (b * t * 4 * n + 4 * n * n + b * t * n + 2 * b * n) \
                * item + p_bytes + m_bytes           # zx, R, g_hs, g_hT/cT
            grads = b * t * 4 * n * item + (4 * n * n + 3 * n + 2 * b * n) * 4
            work = {
                "lstm_scan_bwd": (
                    tf32_products["lstm_scan_bwd"] * fwd_ops,
                    common + (b * t * n + 2 * b * n) * item + grads,
                    peak_tf32),
                "lstm_scan_chunked": (
                    None, (b * t * 4 * n + 4 * n * n + 2 * b * n) * item
                    + p_bytes + m_bytes + (b * t * n + 2 * b * n) * item
                    + ck_bytes, None),
                "lstm_scan_chunked_bwd": (
                    tf32_products["lstm_scan_chunked_bwd"] * fwd_ops,
                    common + ck_bytes + grads, peak_tf32)}
            for k, (ops, moved, rate) in work.items():
                fwd = k == "lstm_scan_chunked"
                if fwd:
                    b_ms, by, basis, other_ms = lstm_fwd_bound(
                        b, t, n, dname, bw, peak, peak_tf32, moved)
                else:
                    b_ms = max(moved / bw, ops / rate) * 1e3
                    by = "bytes" if moved / bw >= ops / rate else "operations"
                lib = lib_fwd_ms if fwd else lib_ms
                pl = "-" if plain_ms[k] is None else f"{plain_ms[k]:.4f} ms"
                lib_s = ("-" if lib is None or dtype != torch.float32
                         else f"{lib:.4f} ms [torch.nn.LSTM "
                              f"{'forward' if fwd else 'backward'}, cuDNN, "
                              f"plain cell]")
                res = lstm_ops.resident(n, backward=not fwd)
                how = (f"{basis}; the other units' bound {other_ms:.4f} ms"
                       if fwd else f"{tf32_products[k]} TF32 products")
                log(f"[kernel-lstm-bwd] {k:21s} {dname:8s} b={b:2d} "
                    f"t={t:4d} n={n:4d} {'peephole' if peephole else 'plain   '}"
                    f" {'masked' if masked else '      '} resident="
                    f"{int(res)}  max_err="
                    f"{errs[k]:.3g}  kernel={ms[k]:.4f} ms "
                    f"({ms[k] * 1e3 / t:.2f} us/step)  plain={pl}  "
                    f"library={lib_s}  bound={b_ms:.4f} ms ({by}, {how}; "
                    f"{100 * b_ms / ms[k]:.1f}% of it)")
                if dtype == torch.float32 and case == LSTM_PATH_CASES[k]:
                    rows[k] = {"ms": ms[k], "plain_ms": plain_ms[k],
                               "library_ms": lib, "bound_ms": b_ms,
                               "bound_by": by}
                    if lib is not None:
                        rows[k]["library_covers"] = (
                            "torch.nn.LSTM forward (cuDNN): the plain cell, "
                            "no peepholes, its input projection included"
                            if fwd else
                            "torch.nn.LSTM backward (cuDNN): the plain cell, "
                            "no peepholes, its input projection's backward "
                            "included")
            del sets
        torch.cuda.empty_cache()
    for k in ("lstm_scan_chunked", "lstm_scan_bwd", "lstm_scan_chunked_bwd"):
        r, (b, t, n, _, _) = rows[k], LSTM_PATH_CASES[k]
        what = "forward" if k == "lstm_scan_chunked" else "backward"
        log(f"[kernel-lstm-bwd] {k} at its path's ({b}, {t}, {n}) float32: "
            f"{r['ms']:.4f} ms per launch ({r['ms'] * 1e3 / t:.3f} us/step),"
            f" torch.nn.LSTM {what} {r['library_ms']:.4f} ms in the same "
            f"run ({r['library_ms'] / r['ms']:.2f}x the kernel's time), "
            f"bound {r['bound_ms']:.4f} ms "
            f"({100 * r['bound_ms'] / r['ms']:.1f}% of it)")
    log(f"[kernel-lstm-bwd] verdict: rows 6, 7 and 8 agree with their plain "
        f"versions in {checked}/{checked} (shape, dtype) cases, max abs "
        f"error {worst} (tol float32 1e-5 forward, 1e-4 backward; bfloat16 "
        f"2e-2 forward, 1e-2 dzx; x max|plain| of each output); the "
        f"comparison rejects a {', a '.join(rejected + rejected_c)}")
    return rows, worst


# ------------------------------------------------------- phases 16 to 18
RNN_PER_STEP = {"lstm_scan": 2, "lstm_scan_bwd": 2, "linear_xent_fwd": 1,
                "linear_xent_bwd": 1}
RNN_LONG_PER_STEP = {"lstm_scan_chunked": 2, "lstm_scan_chunked_bwd": 2,
                     "linear_xent_fwd": 1, "linear_xent_bwd": 1}
RNN_TRAIN_STEPS = 20           # bench.py bench_lstm's batch, repeated
RNN_TBPTT = (32, 1000, 50)     # rows, characters, tbptt_fwd_length
# rows, characters, steps: RmsProp(1e-2)'s first steps overshoot (the
# loss rises for a few steps before it falls below its start), so the long
# path takes 10 steps where 5 would end above the first score
RNN_LONG = (8, 4096, 10)


def char_batch(np, rng, n, t, vocab):
    """n x t one-hot characters and their next characters, at bench.py
    bench_lstm's shapes. The characters are drawn with Zipf frequencies
    (p proportional to 1 / rank, the skew of text) rather than uniformly,
    so that the loss can fall below its start within a few RmsProp steps."""
    zipf = 1.0 / np.arange(1, vocab + 1)
    ids = rng.choice(vocab, size=(n, t + 1), p=zipf / zipf.sum())
    eye = np.eye(vocab, dtype=np.float32)
    return eye[ids[:, :t]], eye[ids[:, 1:]]


def rnn_net(torch, t, tbptt=None, device=None):
    """The zoo TextGenerationLSTM at full width from SEED, over t
    characters, with tBPTT windows of `tbptt` steps when given."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    conf = TextGenerationLSTM(num_classes=RNN["num_classes"], max_length=t,
                              seed=SEED).conf()
    if tbptt:
        conf.defaults.backprop_type = "tbptt"
        conf.defaults.tbptt_fwd_length = tbptt
    return MultiLayerNetwork(conf).init(
        **({} if device is None else {"device": device}))


class ScoreLog:
    """A listener keeping every iteration's score."""

    def __init__(self):
        self.scores = []

    def iteration_done(self, net, iteration, score):
        self.scores.append(score)


def check_train(tag, scores, launches, want, start=None):
    """Exactly `want` launches (0 for every other kernel); every score
    finite and the last below `start` (else the first)."""
    want = {k: want.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, want {want}")
    start = scores[0] if start is None else start
    if not all(math.isfinite(s) for s in scores) or not scores[-1] < start:
        raise AssertionError(f"{tag}: scores {scores}, start {start}")


def phase_train_rnn(torch, np, card):
    """Path 1: bench_lstm's 64 x 64 batch, 20 steps, then 5 more of the
    same network under the mixed policy (which must end below the first
    step's score). Returns the TF32 run's launches."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet

    b, t, vocab = RNN_BATCH, RNN["max_length"], RNN["num_classes"]
    x_np, y_np = char_batch(np, np.random.default_rng(SEED + 5), b, t,
                            vocab)
    results, first = {}, None
    net = rnn_net(torch, t)
    for mixed, steps in ((False, RNN_TRAIN_STEPS), (True, MIXED_STEPS)):
        tag = "mixed bf16" if mixed else "TF32"
        dtypes.set_mixed_precision(mixed)
        torch.cuda.reset_peak_memory_stats()
        try:
            reset_counts()
            runs = train_steps(torch, net, x_np, y_np, steps, DataSet)
            launches = read_counts()
        finally:
            dtypes.set_mixed_precision(False)
        scores = [s for *_, s in runs]
        want = {k: steps * v for k, v in RNN_PER_STEP.items()}
        check_train(f"train-rnn ({tag})", scores, launches, want, first)
        first = scores[0]
        steady = sorted(c + r for c, r, _ in runs[1:])
        step_ms = steady[len(steady) // 2] * 1e3
        log(f"[train-rnn] {tag}: {steps} BPTT steps of {b} x {t} "
            f"characters, score {scores[0]:.5f} -> {scores[-1]:.5f}; "
            f"launches {want} (per step {RNN_PER_STEP})")
        log(f"[train-rnn] {tag}: median step {step_ms:.3f} ms (batch copy "
            f"included), {b * t / (step_ms / 1e3):.1f} trained characters/s;"
            f" first step {(runs[0][0] + runs[0][1]) * 1e3:.2f} ms; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f}"
            f" GiB ({card})")
        results[tag] = launches
    return results["TF32"]


def phase_train_rnn_tbptt(torch, np, card):
    """Path 2: one batch of 32 x 1000 characters in windows of 50, one
    iteration per window."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    b, t, window = RNN_TBPTT
    x_np, y_np = char_batch(np, np.random.default_rng(SEED + 6), b, t,
                            RNN["num_classes"])
    windows = -(-t // window)
    # one window on a network of its own warms the allocator and handles
    rnn_net(torch, t, tbptt=window).fit(DataSet(x_np[:, :window],
                                                y_np[:, :window]))
    net = rnn_net(torch, t, tbptt=window)
    rec = ScoreLog()
    net.set_listeners(rec)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runs = train_steps(torch, net, x_np, y_np, 1, DataSet)
    launches = read_counts()
    want = {k: windows * v for k, v in RNN_PER_STEP.items()}
    check_train("train-rnn-tbptt", rec.scores, launches, want)
    if len(rec.scores) != windows or net.iteration != windows:
        raise AssertionError(f"train-rnn-tbptt: {len(rec.scores)} listener "
                             f"calls, iteration {net.iteration}; want "
                             f"{windows} windows")
    wall = runs[0][0] + runs[0][1]
    log(f"[train-rnn-tbptt] {b} x {t} characters in {windows} windows of "
        f"{window}: score {rec.scores[0]:.5f} -> {rec.scores[-1]:.5f}; "
        f"launches {want} (per window {RNN_PER_STEP})")
    log(f"[train-rnn-tbptt] batch {wall * 1e3:.2f} ms (copy included) = "
        f"{wall / windows * 1e3:.3f} ms per window, "
        f"{b * t / wall:.1f} trained characters/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({card})")
    return launches


def phase_train_rnn_long(torch, np, card):
    """Path 3: standard BPTT at 8 x 4096 characters, 10 steps, on the
    chunked route."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    b, t, steps = RNN_LONG
    x_np, y_np = char_batch(np, np.random.default_rng(SEED + 7), b, t,
                            RNN["num_classes"])
    net = rnn_net(torch, t)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    runs = train_steps(torch, net, x_np, y_np, steps, DataSet)
    launches = read_counts()
    scores = [s for *_, s in runs]
    want = {k: steps * v for k, v in RNN_LONG_PER_STEP.items()}
    check_train("train-rnn-long", scores, launches, want)
    steady = sorted(c + r for c, r, _ in runs[1:])
    step_ms = steady[len(steady) // 2] * 1e3
    log(f"[train-rnn-long] {steps} BPTT steps of {b} x {t} characters, "
        f"score {scores[0]:.5f} -> {scores[-1]:.5f}; launches {want} (per "
        f"step {RNN_LONG_PER_STEP})")
    log(f"[train-rnn-long] median step {step_ms:.2f} ms (batch copy "
        f"included), {b * t / (step_ms / 1e3):.1f} trained characters/s; "
        f"first step {(runs[0][0] + runs[0][1]) * 1e3:.2f} ms; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
        f"({card})")
    return launches


# ---------------------------------------------------------------- phase 19
def rmsprop_agreement(np, nets, logs, start, iters, lr=1e-2, decay=0.95):
    """How far the card's char-RNN ("card" in `nets`, TF32 off; a
    MultiLayerNetwork or a ComputationGraph) is from the CPU's ("cpu")
    after the same fit calls from the same point: scores
    (ScoreLogs `logs`) relative; each param's change from `start` (param
    tables) absolute, over elements whose RMS gradient (the CPU's RmsProp
    g2) is above ZERO_GRAD of the largest; the move of the others, which
    RmsProp's bound of lr / sqrt(1 - decay) per iteration holds; the g2
    slots relative to each leaf's largest magnitude. Returns (scores,
    changes, zero-gradient moves, zero count, slots, floor, bound,
    finite)."""
    from deeplearning4j_tpu_torch import interop
    from deeplearning4j_tpu_torch.models.multi_layer_network import flat_items

    def g2(net):
        # "layer_i/path" (a MultiLayerNetwork's list) or "vertex/path" (a
        # graph's dict), as the param tables name the leaves
        slots = interop.opt_state_to_jax(net)
        entries = (slots.items() if isinstance(slots, dict)
                   else ((f"layer_{i}", s) for i, s in enumerate(slots)))
        return {f"{k}/{path}": v for k, s in entries if s
                for path, v in flat_items(s["g2"])}

    rel = max(abs(a - b) / abs(b) for a, b in zip(logs["card"].scores,
                                                  logs["cpu"].scores))
    moved = {k: {key: p - start[k][key]
                 for key, p in net.get_param_table().items()}
             for k, net in nets.items()}
    slots = {k: g2(net) for k, net in nets.items()}
    rms = {key: np.sqrt(v) for key, v in slots["cpu"].items()}
    floor = ZERO_GRAD * max(float(r.max()) for r in rms.values())
    bound = 1.01 * iters * lr / math.sqrt(1 - decay)
    p_err, z_move, n_zero, s_err = 0.0, 0.0, 0, 0.0
    for key, want in moved["cpu"].items():
        got, zero = moved["card"][key], rms[key] <= floor
        p_err = max(p_err, float(np.abs(got - want)[~zero].max(initial=0)))
        z_move = max(z_move, float(np.abs(got)[zero].max(initial=0)),
                     float(np.abs(want)[zero].max(initial=0)))
        n_zero += int(np.count_nonzero(zero))
    for key, want in slots["cpu"].items():
        s_err = max(s_err, float(np.abs(slots["card"][key] - want).max()
                                 / max(np.abs(want).max(), 1e-30)))
    finite = all(np.isfinite(a).all() for k in nets
                 for a in moved[k].values()) and all(
        math.isfinite(v) for lg in logs.values() for v in lg.scores)
    return rel, p_err, z_move, n_zero, s_err, floor, bound, finite


def phase_refer_train_rnn(torch, np):
    """The seeded full-width TextGenerationLSTM on the CPU (plain versions,
    exact float32) and on the card (TF32 off): 3 BPTT steps at 2 x 64,
    tBPTT at 2 x 100 in windows of 50, 3 steps at 2 x 1024 (chunked
    route)."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet

    rng = np.random.default_rng(SEED + 8)
    for label, t, tbptt, steps in (("BPTT", 64, None, 3),
                                   ("tBPTT", 100, 50, 1),
                                   ("chunked", 1024, None, 3)):
        x, y = char_batch(np, rng, 2, t, RNN["num_classes"])
        nets = {"card": rnn_net(torch, t, tbptt),
                "cpu": rnn_net(torch, t, tbptt, device="cpu")}
        logs = {}
        for k, net in nets.items():
            logs[k] = ScoreLog()
            net.set_listeners(logs[k])
        start = {k: net.get_param_table() for k, net in nets.items()}
        reset_counts()
        with dtypes.full_precision():
            for _ in range(steps):
                for net in nets.values():
                    net.fit(DataSet(x, y))
        launches = read_counts()
        route = "lstm_scan_chunked" if label == "chunked" else "lstm_scan"
        if launches[route] == 0 or launches[route + "_bwd"] == 0:
            raise AssertionError(f"refer-train-rnn ({label}): launches "
                                 f"{launches}")
        iters = len(logs["cpu"].scores)
        rel, p_err, z_move, n_zero, s_err, floor, bound, finite = \
            rmsprop_agreement(np, nets, logs, start, iters)
        same_iters = (len(logs["card"].scores) == iters == steps * (
            -(-t // tbptt) if tbptt else 1) and nets["card"].iteration
            == nets["cpu"].iteration == iters)
        # scores: float32 sums in another order; each element's change
        # from its start 1e-5 absolute; elements with zero gradient within
        # RmsProp's bound of lr / sqrt(1 - decay) per iteration; g2 slots
        # relative to each leaf's largest magnitude
        if not (rel <= 1e-5 and p_err <= 1e-5 and z_move <= bound
                and s_err <= 1e-4 and finite and same_iters):
            raise AssertionError(
                f"refer-train-rnn ({label}): card and CPU differ: scores "
                f"{logs['card'].scores} vs {logs['cpu'].scores}, changes "
                f"{p_err:.3g}, zero-gradient moves {z_move:.3g}, slots "
                f"{s_err:.3g}, finite {finite}, iterations {iters}")
        log(f"[refer-train-rnn] {label}: 2 x {t} characters, {iters} RmsProp "
            f"iterations, card (TF32 off) vs CPU: scores relative "
            f"{rel:.3g} (tol 1e-5); params' change from their start max "
            f"|diff| {p_err:.3g} (tol 1e-5); {n_zero} elements with zero "
            f"gradient (RMS gradient <= {floor:.3g}) move at most "
            f"{z_move:.3g} (RmsProp's bound {bound:.3g}); g2 max relative "
            f"{s_err:.3g} (tol 1e-4); card launches {launches}")
        del nets


# ---------------------------------------------------------------- phase 20
RESNET_TRAIN = (64, 20, 5)  # batch, mixed steps, float32 / TF32 steps
RESNET_SHAPE = (224, 224, 3)
RESNET_PER_STEP = {"bn_act": 53, "linear_xent_fwd": 1, "linear_xent_bwd": 1}


def resnet_net(torch, device=None):
    from deeplearning4j_tpu_torch.zoo import ResNet50

    return ResNet50(num_classes=1000, input_shape=RESNET_SHAPE,
                    seed=SEED).init(**({} if device is None
                                       else {"device": device}))


def timed_fits(torch, net, data, steps, fit=None):
    """`steps` fit calls (`fit`, else net.fit) on one batch already on the
    card. Returns [(seconds, score)] per step."""
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (fit or net.fit)(data)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0, net.score_))
    return out


def image_batch(torch, seed, b, shape):
    """b bfloat16 images made on the card from `seed` and their one-hot
    float32 labels of 1000 classes (bench.py bench_resnet50's input)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, *shape), generator=gen, device=dev).to(
        torch.bfloat16)
    y = torch.nn.functional.one_hot(torch.randint(
        0, 1000, (b,), generator=gen, device=dev), 1000).float()
    return x, y


def phase_train_resnet(torch, np, card):
    """bench_resnet50's training step: 20 steps under the mixed policy on
    bfloat16 images, 5 under the float32 / TF32 policy on the same images
    in float32, one network throughout. Returns the mixed run's
    launches and its first score."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet

    b, mixed_steps, f32_steps = RESNET_TRAIN
    dev = torch.device("cuda")
    x, y = image_batch(torch, SEED + 9, b, RESNET_SHAPE)
    # the same batch's copy from pageable host memory (numpy has no
    # bfloat16: its bits as int16), timed apart from the step
    bits = x.view(torch.int16).cpu().numpy()
    y_np = y.cpu().numpy()
    copies = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(bits).to(dev).view(torch.bfloat16)
        torch.from_numpy(y_np).to(dev)
        torch.cuda.synchronize()
        copies.append(time.perf_counter() - t0)
    copy_ms = sorted(copies)[2] * 1e3
    t0 = time.perf_counter()
    net = resnet_net(torch)
    log(f"[train-resnet] ResNet-50 ({net.num_params()} params) on "
        f"{net.device} in {time.perf_counter() - t0:.2f} s")
    results = {}
    for mixed, steps, data in ((True, mixed_steps, DataSet(x, y)),
                               (False, f32_steps, DataSet(x.float(), y))):
        tag = "mixed bf16" if mixed else "TF32"
        dtypes.set_mixed_precision(mixed)
        torch.cuda.reset_peak_memory_stats()
        try:
            reset_counts()
            runs = timed_fits(torch, net, data, steps)
            launches = read_counts()
        finally:
            dtypes.set_mixed_precision(False)
        scores = [sc for _, sc in runs]
        want = {k: steps * RESNET_PER_STEP.get(k, 0) for k in launches}
        if launches != want:
            raise AssertionError(f"train-resnet ({tag}): launches "
                                 f"{launches}, want {want}")
        if not all(math.isfinite(sc) for sc in scores):
            raise AssertionError(f"train-resnet ({tag}): scores {scores}")
        if mixed and not sorted(scores[-5:])[2] < scores[0]:
            raise AssertionError(f"train-resnet ({tag}): the median of the "
                                 f"last 5 scores is not below the first: "
                                 f"{scores}")
        steady = sorted(t for t, _ in runs[1:])
        step_ms = steady[len(steady) // 2] * 1e3
        log(f"[train-resnet] {tag}: {steps} steps of {b} images, scores "
            f"{', '.join(f'{sc:.5f}' for sc in scores)}; launches {want} "
            f"(per step {RESNET_PER_STEP})")
        log(f"[train-resnet] {tag}: median step {step_ms:.3f} ms, "
            f"{b / (step_ms / 1e3):.1f} trained images/s; first step "
            f"{runs[0][0] * 1e3:.2f} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({card})")
        results[tag] = launches, scores[0]
    log(f"[train-resnet] one batch ({bits.nbytes / 1e6:.1f} MB of bfloat16 "
        f"images, {y_np.nbytes / 1e6:.3f} MB of labels) copied from "
        f"pageable host memory: {copy_ms:.3f} ms (median of 5; not part "
        f"of the steps above, whose batch is on the card) ({card})")
    del net
    torch.cuda.empty_cache()
    return results["mixed bf16"]


# ---------------------------------------------------------------- phase 21
def leaf_rel(a, b):
    """max |a - b| / max |b| over one leaf (numpy arrays)."""
    return float(abs(a - b).max() / max(float(abs(b).max()), 1e-30))


def slot_items(slots):
    """(entry/slot/path, numpy leaf) of every dict slot of an
    `interop.opt_state_to_jax` result (a list or a dict of entries)."""
    from deeplearning4j_tpu_torch.models._training import flat_items

    entries = slots.items() if isinstance(slots, dict) else enumerate(slots)
    for key, entry in entries:
        for slot, tree in (entry.items() if entry else ()):
            if isinstance(tree, dict):
                for path, leaf in flat_items(tree):
                    yield f"{key}/{slot}/{path}", leaf


def copy_state(dst, src):
    """dst takes src's params (in place), running state and updater slots
    (a list of entries for a MultiLayerNetwork, a dict for a graph), on
    dst's device."""
    import torch

    from deeplearning4j_tpu_torch.models._training import flat_items

    def moved(tree):
        if isinstance(tree, dict):
            return {k: moved(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(moved(v) for v in tree)
        return tree.to(dst.device) if isinstance(tree, torch.Tensor) \
            else tree

    with torch.no_grad():
        for name, p in src.params.items():
            mine = dict(flat_items(dst.params[name]))
            for path, t in flat_items(p):
                mine[path].copy_(t)
    dst.state = moved(src.state)
    dst.opt_state = moved(src.opt_state)


# card - CPU, per step from the same point: the score relative; each
# param's change and each Nesterovs slot in relative L2 norm per leaf; the
# BN running stats relative to each leaf's largest magnitude. Scores and
# stats hold refer-train's 1e-5 and 1e-4 (measured on an H100 80GB HBM3
# against the CPU: 5.6e-6 and 6.7e-6); changes and slots measured 0.024
# at worst (a BN beta of s2 in the first step): at batch 4 single relu
# inputs near zero change sign between the two programs, and each flip
# moves the gradient of every earlier leaf by percents, so 0.05
REFER_RESNET_TOL = {"score": 1e-5, "change": 0.05, "slot": 0.05, "bn": 1e-4}


def phase_refer_train_resnet(torch, np):
    """3 Nesterovs steps at batch 4 on the card (TF32 off) and on the CPU,
    each from the same point: after each step the CPU network takes the
    card's params, state and slots. A train-mode ResNet-50 at batch 4 is
    chaotic (the first step sends the score from 8.4 to 104 two steps
    later), so steps from points that drifted apart would compare two
    trajectories rather than two steps. cuDNN runs deterministic here, as
    in refer-train-vgg16: with its default weight-gradient algorithms the
    card's first step lands on another point in every run, and step 2's
    score error read 0 to 4.21e-06 in eight runs of the phase and 1.07e-05
    in a ninth, on the same commit and its parent alike (an NVIDIA H100
    80GB HBM3, 700 W)."""
    steps, b = 3, 4
    rng = np.random.default_rng(SEED + 10)
    x = rng.standard_normal((b, *RESNET_SHAPE)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, b)]
    nets = {"card": resnet_net(torch), "cpu": resnet_net(torch, "cpu")}
    with deterministic_cudnn(torch):
        per_step = refer_resnet_steps(torch, np, nets, x, y, steps)
    launches = read_counts()
    if launches["bn_act"] != 53 * steps:
        raise AssertionError(f"refer-train-resnet: launches {launches}")
    bad = [(i + 1, k, v) for i, errs in enumerate(per_step)
           for k, v in errs.items()
           if not (math.isfinite(v) and v <= REFER_RESNET_TOL[k])]
    if bad:
        raise AssertionError(f"refer-train-resnet: card and CPU differ: "
                             f"{bad}")
    del nets


def refer_resnet_steps(torch, np, nets, x, y, steps):
    """refer-train-resnet's steps, each from the same point; returns each
    step's measures."""
    from deeplearning4j_tpu_torch import dtypes, interop
    from deeplearning4j_tpu_torch.datasets import DataSet

    per_step = []
    reset_counts()
    for step in range(steps):
        start = nets["cpu"].get_param_table()
        with dtypes.full_precision():
            for net in nets.values():
                net.fit(DataSet(x, y))
        moved = {k: {key: p - start[key]
                     for key, p in net.get_param_table().items()}
                 for k, net in nets.items()}
        slots = {k: dict(slot_items(interop.opt_state_to_jax(net)))
                 for k, net in nets.items()}

        def norm_rel(a, c):
            return float(np.linalg.norm(a - c) / max(np.linalg.norm(c),
                                                     1e-30))

        change = {key: norm_rel(moved["card"][key], w)
                  for key, w in moved["cpu"].items()}
        errs = {
            "score": abs(nets["card"].score_ - nets["cpu"].score_)
            / abs(nets["cpu"].score_),
            "change": max(change.values()),
            "slot": max(norm_rel(slots["card"][k], v)
                        for k, v in slots["cpu"].items()),
            "bn": max(leaf_rel(nets["card"].state[name][s].cpu().numpy(),
                               v.numpy())
                      for name, st in nets["cpu"].state.items()
                      for s, v in st.items()),
        }
        worst = sorted(change, key=change.get)[-2:]
        median = sorted(change.values())[len(change) // 2]
        elementwise = max(leaf_rel(moved["card"][key], w)
                          for key, w in moved["cpu"].items())
        log(f"[refer-train-resnet] step {step + 1}: scores "
            f"{nets['card'].score_:.7f} (card) {nets['cpu'].score_:.7f} "
            f"(CPU); " + ", ".join(f"{k} {v:.3g} (tol "
                                   f"{REFER_RESNET_TOL[k]:g})"
                                   for k, v in errs.items())
            + f"; worst changes {[(k, f'{change[k]:.3g}') for k in worst]},"
              f" median {median:.3g} over {len(change)} leaves; largest "
              f"element error of a change {elementwise:.3g} of its leaf's "
              f"largest")
        per_step.append(errs)
        copy_state(nets["cpu"], nets["card"])
    return per_step


# ---------------------------------------------------------------- phase 22
LENET_PER_STEP = {"linear_xent_fwd": 1, "linear_xent_bwd": 1}
LENET_TRAIN = (64, 20)  # batch, steps


def phase_train_lenet(torch, np, card):
    """Zoo LeNet on MnistDataSetIterator: 20 Adam steps on the card, then
    3 steps on the card and on the CPU (TF32 off) compared. Returns the
    card run's launches."""
    from deeplearning4j_tpu_torch import dtypes, interop
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models._training import flat_items
    from deeplearning4j_tpu_torch.zoo import LeNet

    b, steps = LENET_TRAIN
    data = MnistDataSetIterator(batch=b, num_examples=b * steps, seed=SEED)
    net = LeNet(seed=SEED).init()

    class Timed(ScoreLog):
        def __init__(self):
            super().__init__()
            self.times = []

        def iteration_done(self, net, iteration, score):
            super().iteration_done(net, iteration, score)
            self.times.append(time.perf_counter())  # score_ waited

    rec = Timed()
    net.set_listeners(rec)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    net.fit(data)
    launches = read_counts()
    want = {k: steps * v for k, v in LENET_PER_STEP.items()}
    check_train("train-lenet", rec.scores, launches, want)
    gaps = sorted(np.diff([t0] + rec.times)[1:])
    step_ms = gaps[len(gaps) // 2] * 1e3
    log(f"[train-lenet] {steps} Adam steps of {b} MNIST images "
        f"({'synthetic sample' if data.synthetic else 'idx files'}), score "
        f"{rec.scores[0]:.5f} -> {rec.scores[-1]:.5f}; launches {want} (per "
        f"step {LENET_PER_STEP})")
    log(f"[train-lenet] median step {step_ms:.3f} ms (host batch copy "
        f"included), {b / (step_ms / 1e3):.1f} trained images/s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 20:.1f} "
        f"MiB ({card})")

    lr, n = 1e-3, 3
    nets = {"card": LeNet(seed=SEED).init(),
            "cpu": LeNet(seed=SEED).init(device="cpu")}
    logs = {k: ScoreLog() for k in nets}
    start = {k: net.get_param_table() for k, net in nets.items()}
    with dtypes.full_precision():
        for k, net in nets.items():
            net.set_listeners(logs[k])
            net.fit(MnistDataSetIterator(batch=b, num_examples=b * n,
                                         seed=SEED))
    rel = max(abs(a - c) / abs(c) for a, c in zip(logs["card"].scores,
                                                  logs["cpu"].scores))
    slots = {k: interop.opt_state_to_jax(net) for k, net in nets.items()}
    rms = {f"layer_{i}/{path}": np.sqrt(v)
           for i, s in enumerate(slots["cpu"]) if s["m"]
           for path, v in flat_items(s["v"])}
    floor = ZERO_GRAD * max(float(r.max()) for r in rms.values())
    p_err, z_move = 0.0, 0.0
    for key, p in nets["cpu"].get_param_table().items():
        want = p - start["cpu"][key]
        got = nets["card"].get_param_table()[key] - start["card"][key]
        zero = rms[key] <= floor
        p_err = max(p_err, float(np.abs(got - want)[~zero].max(initial=0)))
        z_move = max(z_move, float(np.abs(got)[zero].max(initial=0)))
    cpu_slots = dict(slot_items(slots["cpu"]))
    s_errs = {k: leaf_rel(v, cpu_slots[k])
              for k, v in slot_items(slots["card"])}
    s_worst = max(s_errs, key=s_errs.get)
    s_err = s_errs[s_worst]
    # slots 2e-4: the first conv's bias gradient sums 64 x 28 x 28 terms
    # of both signs per channel, and its m differs by 1.51e-4 of the
    # leaf's largest (on an H100 80GB HBM3 against the CPU, the same in
    # three runs)
    ok = (len(logs["cpu"].scores) == n and rel <= 1e-5 and p_err <= 1e-5
          and z_move <= 1.01 * n * lr and s_err <= 2e-4)
    log(f"[train-lenet] {n} Adam steps, card (TF32 off) vs CPU: scores "
        f"relative {rel:.3g} (tol 1e-5); params' change max |diff| "
        f"{p_err:.3g} (tol 1e-5); zero-gradient elements move at most "
        f"{z_move:.3g} (Adam's bound {1.01 * n * lr:.3g}); Adam m, v max "
        f"relative {s_err:.3g} ({s_worst}; tol 2e-4)")
    if not ok:
        raise AssertionError("train-lenet: card and CPU differ")
    return launches


# ------------------------------------------------------------ phases 23-25
INCEPTION = dict(input_shape=(299, 299, 3), classes=1000)
INCEPTION_BN = 94  # BatchNorms per forward, one bn_act launch each


def inception_images(np):
    from deeplearning4j_tpu_torch.modelimport.trainedmodels import (
        inception_preprocess,
    )

    h, w, c = INCEPTION["input_shape"]
    return lambda rng, n: inception_preprocess(
        rng.integers(0, 256, (n, h, w, c)))


def import_inception(path):
    """Writes the InceptionV3 file at `path` and imports it onto the card;
    checks the imported graph's shape."""
    from deeplearning4j_tpu_torch.modelimport import (
        import_keras_model_and_weights,
    )
    from deeplearning4j_tpu_torch.modelimport.trainedmodels import (
        write_inception_v3_h5,
    )
    from deeplearning4j_tpu_torch.nn.layers import BatchNorm, Conv2D

    t0 = time.perf_counter()
    write_inception_v3_h5(path, seed=SEED, **INCEPTION)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    net = import_keras_model_and_weights(path)
    t_import = time.perf_counter() - t0
    layers = [net.layer(n) for n in net.topo]
    convs = [l for l in layers if isinstance(l, Conv2D)]
    merges = [n for n in net.topo
              if type(net.conf.vertices[n]).__name__ == "MergeVertex"]
    bns = [l for l in layers if isinstance(l, BatchNorm)]
    if len(convs) != 94 or any(l.has_bias for l in convs) or \
            len(bns) != INCEPTION_BN or len(merges) != 15 or \
            net.num_params() <= 21e6 or net.device.type != "cuda":
        raise AssertionError(
            f"imported InceptionV3: {len(convs)} Conv2D, {len(bns)} "
            f"BatchNorm, {len(merges)} MergeVertex, {net.num_params()} "
            f"params on {net.device}")
    log(f"[serve-inception] wrote {os.path.getsize(path)} bytes of "
        f"InceptionV3 .h5 in {t_write:.2f} s, imported onto {net.device} "
        f"in {t_import:.2f} s: {len(convs)} bias-free Conv2D, {len(bns)} "
        f"BatchNorm, {len(merges)} MergeVertex, {net.num_params()} params")
    return net


def phase_refer_inception(torch, np, net, path):
    from deeplearning4j_tpu_torch.modelimport import (
        import_keras_model_and_weights,
    )

    t0 = time.perf_counter()
    cpu_net = import_keras_model_and_weights(path, device="cpu")
    log(f"[refer-inception] imported on the CPU in "
        f"{time.perf_counter() - t0:.2f} s")
    x = inception_images(np)(np.random.default_rng(SEED + 1), 2)
    phase_reference(torch, np, net, cpu_net=cpu_net, x=x,
                    tag="refer-inception")


# ------------------------------------------------------------ phases 26-29
# The BASELINE char-RNN (BASELINE.md:21, zoo TextGenerationLSTM at full
# width) as DL4J's ModelSerializer writes it: legacy RMSPROP, l2 on every
# layer, TruncatedBPTT 50/50, and a training clock (iterationCount) that
# the restore carries into net.iteration
CHAR_RNN = dict(vocab=77, hidden=256, lr=1e-2, rms_decay=0.95, l2=1e-4,
                tbptt=50, iteration=1000)
CHAR_RNN_PARAMS = 888653  # 342,784 + 526,080 + 19,789


def char_rnn_dl4j_conf(seed=SEED):
    """configuration.json of the char-RNN in DL4J's form (legacy per-layer
    updater fields, WRAPPER_OBJECT layer and activation names), as
    tests/make_dl4j_fixtures.py writes its fixtures."""
    c = CHAR_RNN
    common = {"updater": "RMSPROP", "learningRate": c["lr"],
              "rmsDecay": c["rms_decay"], "l2": c["l2"], "l1": 0.0,
              "weightInit": "XAVIER", "biasInit": 0.0}

    def lstm(n_in):
        return {"gravesLSTM": dict(
            common, activationFn={"TanH": {}},
            gateActivationFn={"Sigmoid": {}}, nin=n_in, nout=c["hidden"],
            forgetGateBiasInit=1.0)}

    layers = [lstm(c["vocab"]), lstm(c["hidden"]), {"rnnoutput": dict(
        common, activationFn={"Softmax": {}}, lossFunction="MCXENT",
        nin=c["hidden"], nout=c["vocab"])}]
    return {
        "backprop": True, "pretrain": False,
        "backpropType": "TruncatedBPTT", "tbpttFwdLength": c["tbptt"],
        "tbpttBackLength": c["tbptt"],
        "confs": [{"iterationCount": c["iteration"], "miniBatch": True,
                   "numIterations": 1, "seed": seed,
                   "optimizationAlgo": "STOCHASTIC_GRADIENT_DESCENT",
                   "layer": layer} for layer in layers],
    }


def write_char_rnn_zip(np, path, seed=SEED):
    """The char-RNN as a DL4J zip at `path`: configuration.json,
    coefficients.bin (seeded float32 values, normal with std 0.08, in the
    reference's flat layout) and updaterState.bin (one RMSProp block over
    every parameter: seeded values in [1e-4, 1e-3], so a misplaced slot
    shows). Returns the coefficient vector and the state vector."""
    import io
    import zipfile

    from deeplearning4j_tpu_torch.modelimport.dl4j import write_nd4j_array

    rng = np.random.default_rng(seed)
    flat = rng.normal(0.0, 0.08, CHAR_RNN_PARAMS).astype(np.float32)
    g2 = rng.uniform(1e-4, 1e-3, CHAR_RNN_PARAMS).astype(np.float32)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("configuration.json",
                    json.dumps(char_rnn_dl4j_conf(seed), indent=2))
        for name, vec in (("coefficients.bin", flat),
                          ("updaterState.bin", g2)):
            buf = io.BytesIO()
            # the reference writes a network's flat vectors as [1, n] rows
            write_nd4j_array(buf, vec[None, :], order="f")
            zf.writestr(name, buf.getvalue())
    return flat, g2


CHAR_RNN_RUN = (32, 200, 3)  # rows, characters, fit calls (4 windows each)
SAMPLE_CHARS = 200


class TimedScoreLog(ScoreLog):
    """A ScoreLog that also stamps each iteration's end on the host clock
    (after the score's read, which waits for the card)."""

    def __init__(self):
        super().__init__()
        self.stamps = []

    def iteration_done(self, net, iteration, score):
        super().iteration_done(net, iteration, score)
        self.stamps.append(time.perf_counter())


def phase_dl4j_charrnn(torch, np, tmp, card):
    """dl4j-write and dl4j-charrnn: the char-RNN written as a DL4J zip,
    restored onto the card and the CPU with its RmsProp state, output on 32
    x 200 one-hot characters and 3 tBPTT fit calls (12 windows of 50)
    compared card (TF32 off) against CPU, as refer-train-rnn compares them.
    Returns the trained card network and its launches."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.modelimport import (
        restore_multi_layer_network,
    )

    path = os.path.join(tmp, "char_rnn_dl4j.zip")
    t0 = time.perf_counter()
    flat, g2 = write_char_rnn_zip(np, path)
    t_write = time.perf_counter() - t0
    log(f"[dl4j-write] DL4J zip of the char-RNN ({flat.size} params, "
        f"{g2.size} RMSProp values, iterationCount {CHAR_RNN['iteration']}, "
        f"tBPTT {CHAR_RNN['tbptt']}/{CHAR_RNN['tbptt']}): "
        f"{os.path.getsize(path)} bytes written in {t_write:.3f} s")

    nets, t_import = {}, {}
    for k, dev in (("card", None), ("cpu", "cpu")):
        if dev is None:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        nets[k] = restore_multi_layer_network(
            path, load_updater=True, **({} if dev is None else
                                        {"device": dev}))
        if dev is None:
            torch.cuda.synchronize()
        t_import[k] = time.perf_counter() - t0
    net = nets["card"]
    if net.device.type != "cuda" or net.num_params() != CHAR_RNN_PARAMS or \
            net.iteration != CHAR_RNN["iteration"] or \
            net.conf.defaults.tbptt_fwd_length != CHAR_RNN["tbptt"]:
        raise AssertionError(
            f"dl4j-charrnn: restored {net.num_params()} params on "
            f"{net.device}, iteration {net.iteration}, tBPTT "
            f"{net.conf.defaults.tbptt_fwd_length}")
    g2_card = np.concatenate([
        t.detach().cpu().numpy().ravel() for s in net.opt_state if s
        for t in s["g2"].values()])
    if not (g2_card.size == g2.size and g2_card.min() == g2.min()
            and g2_card.max() == g2.max()
            and np.isclose(g2_card.sum(dtype=np.float64),
                           g2.sum(dtype=np.float64), rtol=1e-12)):
        raise AssertionError("dl4j-charrnn: the RMSProp state did not come "
                             "across whole")
    log(f"[dl4j-charrnn] restored with its RMSProp state onto {net.device} "
        f"in {t_import['card']:.3f} s, onto the CPU in "
        f"{t_import['cpu']:.3f} s")

    b, t, calls = CHAR_RNN_RUN
    rng = np.random.default_rng(SEED + 13)
    x_out = one_hot_rows(np, rng, b, t, CHAR_RNN["vocab"])
    batches = [char_batch(np, rng, b, t, CHAR_RNN["vocab"])
               for _ in range(calls)]
    on_card = [tuple(torch.from_numpy(a).to(net.device) for a in xy)
               for xy in batches]
    windows = calls * -(-t // CHAR_RNN["tbptt"])
    logs = {"card": TimedScoreLog(), "cpu": ScoreLog()}
    for k, n in nets.items():
        n.set_listeners(logs[k])
    start = {k: n.get_param_table() for k, n in nets.items()}
    torch.cuda.synchronize()
    reset_counts()
    with dtypes.full_precision():
        got = net.output(x_out).cpu().numpy()
        begins = []
        for xy in on_card:
            torch.cuda.synchronize()
            begins.append(time.perf_counter())
            net.fit(DataSet(*xy))
        torch.cuda.synchronize()
        launches = read_counts()
    want = nets["cpu"].output(x_out).numpy()
    for xy in batches:
        nets["cpu"].fit(DataSet(*xy))
    out_rel = float(np.abs(got - want).max() / np.abs(want).max())
    rel, p_err, z_move, n_zero, s_err, floor, bound, finite = \
        rmsprop_agreement(np, nets, logs, start, windows)
    per_window = {k: v * windows for k, v in RNN_PER_STEP.items()}
    per_window["lstm_scan"] += 2  # the output call
    want_launches = {k: per_window.get(k, 0) for k in launches}
    iters = CHAR_RNN["iteration"] + windows
    ok = (out_rel <= 1e-5 and rel <= 1e-5 and p_err <= 1e-5
          and z_move <= bound and s_err <= 1e-4 and finite
          and launches == want_launches
          and len(logs["card"].scores) == len(logs["cpu"].scores) == windows
          and net.iteration == nets["cpu"].iteration == iters)
    # window times: from the end of the one before (or the fit call's
    # start) to the end of this one; 4 windows per call
    stamps, ms = logs["card"].stamps, []
    per_call = windows // calls
    for c in range(calls):
        prev = begins[c]
        for w in stamps[c * per_call:(c + 1) * per_call]:
            ms.append((w - prev) * 1e3)
            prev = w
    log(f"[dl4j-charrnn] output on {b} x {t} one-hot characters, card (TF32 "
        f"off) vs CPU: max relative {out_rel:.3g} (tol 1e-5)")
    log(f"[dl4j-charrnn] {calls} fit calls of {b} x {t} characters = "
        f"{windows} tBPTT windows of {CHAR_RNN['tbptt']} resumed from "
        f"iteration {CHAR_RNN['iteration']} (now {net.iteration}): score "
        f"{logs['card'].scores[0]:.5f} -> {logs['card'].scores[-1]:.5f}; "
        f"card (TF32 off) vs CPU: scores relative {rel:.3g} (tol 1e-5), "
        f"params' change max |diff| {p_err:.3g} (tol 1e-5), {n_zero} "
        f"elements with RMS gradient <= {floor:.3g} move at most "
        f"{z_move:.3g} (bound {bound:.3g}), g2 max relative {s_err:.3g} "
        f"(tol 1e-4)")
    log(f"[dl4j-charrnn] ms per tBPTT window on the card (untraced, TF32 "
        f"off, batches already there): median {sorted(ms)[len(ms) // 2]:.3f}"
        f" of {len(ms)} (min {min(ms):.3f}, max {max(ms):.3f}); launches "
        f"{launches} (want {want_launches}: per window {RNN_PER_STEP}, "
        f"2 lstm_scan per output call) ({card})")
    if not ok:
        raise AssertionError("dl4j-charrnn: the restored char-RNN failed "
                             "its checks (see the lines above)")
    net.set_listeners()
    return net, launches


def same_bits(a, b, what):
    """Two nested containers of tensors equal bit for bit (dtype, shape,
    values); raises naming the first that is not."""
    import torch

    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            raise AssertionError(f"{what}: keys {sorted(a)} vs {sorted(b)}")
        for k in a:
            same_bits(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: {len(a)} vs {len(b)} entries")
        for i, (x, y) in enumerate(zip(a, b)):
            same_bits(x, y, f"{what}/{i}")
    elif not (a.dtype == b.dtype and a.shape == b.shape
              and torch.equal(a, b)):
        raise AssertionError(f"{what}: not bit-equal")


def sample_chars(torch, net, n_chars, seed):
    """`n_chars` characters for each of 32 streams, generated by
    rnn_time_step from character 0, each drawn from the softmax with a
    seeded generator on the card and fed back one-hot.
    Returns (ids [rows, n_chars], the last step's probabilities, seconds
    per character)."""
    rows, vocab = CHAR_RNN_RUN[0], CHAR_RNN["vocab"]
    gen = torch.Generator(device=net.device).manual_seed(seed)
    eye = torch.eye(vocab, device=net.device)
    net.rnn_clear_previous_state()
    ids = torch.zeros(rows, dtype=torch.long, device=net.device)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_chars):
        probs = net.rnn_time_step(eye[ids])
        ids = torch.multinomial(probs, 1, generator=gen)[:, 0]
        out.append(ids)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n_chars
    net.rnn_clear_previous_state()
    return torch.stack(out, 1), probs, dt


def phase_checkpoint_resume(torch, np, net, tmp, card):
    """checkpoint-resume: the trained card network written by
    models.serialization.write_model and restored onto the card: params,
    running state, updater slots, iteration and epoch bit for bit; one more
    tBPTT window from each, then 200 sampled characters from each, equal
    bit for bit."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import serialization

    path = os.path.join(tmp, "char_rnn_checkpoint.zip")
    t0 = time.perf_counter()
    serialization.write_model(net, path)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = serialization.restore_multi_layer_network(path)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    same_bits(net.params, back.params, "params")
    same_bits(net.state, back.state, "state")
    same_bits(net.opt_state, back.opt_state, "opt_state")
    if (back.iteration, back.epoch) != (net.iteration, net.epoch) or \
            back.device != net.device:
        raise AssertionError(f"checkpoint-resume: iteration/epoch "
                             f"{back.iteration}/{back.epoch} on "
                             f"{back.device}, want {net.iteration}/"
                             f"{net.epoch} on {net.device}")
    log(f"[checkpoint-resume] checkpoint of the trained char-RNN: "
        f"{os.path.getsize(path)} bytes written in {t_write:.3f} s, "
        f"restored onto {back.device} in {t_restore:.3f} s; params, state, "
        f"RMSProp slots, iteration {back.iteration} and epoch {back.epoch} "
        f"equal bit for bit")
    b, window = CHAR_RNN_RUN[0], CHAR_RNN["tbptt"]
    x, y = char_batch(np, np.random.default_rng(SEED + 14), b, window,
                      CHAR_RNN["vocab"])
    reset_counts()
    scores = []
    for n in (net, back):
        n.fit(DataSet(x, y))
        scores.append(n.score_)
    same_bits(net.params, back.params, "params after one more window")
    same_bits(net.opt_state, back.opt_state, "slots after one more window")
    if scores[0] != scores[1]:
        raise AssertionError(f"checkpoint-resume: window scores {scores}")
    ids, probs, dt = {}, {}, {}
    for k, n in (("unsaved", net), ("restored", back)):
        ids[k], probs[k], dt[k] = sample_chars(torch, n, SAMPLE_CHARS,
                                               SEED + 15)
    launches = read_counts()
    same_bits(ids["unsaved"], ids["restored"], "sampled characters")
    same_bits(probs["unsaved"], probs["restored"], "last probabilities")
    want = {k: 2 * v for k, v in RNN_PER_STEP.items()}
    want["lstm_scan"] += 2 * 2 * SAMPLE_CHARS
    want = {k: want.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"checkpoint-resume: launches {launches}, "
                             f"want {want}")
    log(f"[checkpoint-resume] one more window of {b} x {window} from each: "
        f"score {scores[0]:.6f} from both, params and slots bit-equal; "
        f"{SAMPLE_CHARS} characters for {b} streams sampled by rnn_time_step"
        f" (seeded generator) from each: the same {ids['restored'].numel()} "
        f"characters, {len(set(ids['restored'].flatten().tolist()))} "
        f"distinct; {dt['restored'] * 1e3:.3f} ms per character step "
        f"(unsaved {dt['unsaved'] * 1e3:.3f}); launches {launches} ({card})")
    return launches


# the committed DL4J zips: fixture -> (input, output, input type)
DL4J_FIXTURES = {
    "mlp_nesterovs": ("mlp_x", "mlp_y", None),
    "mlp_half": ("mlp_x", "mlp_y", None),
    "mlp_with_normalizer": ("mlp_x", "mlp_y", None),
    "conv_pool_bn": ("conv_x", "conv_y", (5, 5, 2)),
    "graves_lstm": ("lstm_x", "lstm_y", None),
    "graph_diamond": ("graph_x", "graph_y", None),
}
CHECKPOINT_FIXTURES = ("cg_branch_merge", "mln_graves_lstm", "mln_vit",
                       "mln_conv_bn_noise", "mln_scheduled_dropout",
                       "mln_bidir_lstm")
# the checkpoint fixtures trained further on the card against the CPU (the
# two with dropout and weight noise, and the GravesBidirectionalLSTM one:
# its tanh cells run both halves on rows 5 and 6): name -> launches per
# step
TRAINED_FIXTURES = {
    "mln_conv_bn_noise": {"bn_act": 1, "linear_xent_fwd": 1,
                          "linear_xent_bwd": 1},
    "mln_scheduled_dropout": {"linear_xent_fwd": 1, "linear_xent_bwd": 1},
    "mln_bidir_lstm": {"lstm_scan": 2, "lstm_scan_bwd": 2,
                       "linear_xent_fwd": 1, "linear_xent_bwd": 1},
}


def phase_dl4j_fixtures(torch, np):
    """dl4j-fixtures: every committed DL4J zip (tests/fixtures/dl4j/) and
    the six committed checkpoint zips, restored onto the card, each against
    its committed output at 1e-5 (TF32 off); the BatchNorm fixture launches
    bn_act. TRAINED_FIXTURES (the two with dropout and weight noise, and
    the bidirectional one) then take 3 fit steps on the card against their
    CPU restore, each from the same point with the card's masks replayed on
    the CPU. Returns those steps' launches."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.modelimport import (
        restore_computation_graph,
        restore_multi_layer_network,
        restore_normalizer,
    )
    from deeplearning4j_tpu_torch.models import restore_model
    from deeplearning4j_tpu_torch.nn import inputs as it

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures")
    exp = np.load(os.path.join(here, "dl4j", "expected_outputs.npz"))
    results = []
    for name, (xk, yk, shape) in DL4J_FIXTURES.items():
        path = os.path.join(here, "dl4j", name + ".zip")
        if name.startswith("graph"):
            net = restore_computation_graph(path, load_updater=True)
        else:
            net = restore_multi_layer_network(
                path, it.convolutional(*shape) if shape else None,
                load_updater=True)
        before = read_counts()
        with dtypes.full_precision():
            got = net.output(exp[xk]).cpu().numpy()
        bn = read_counts()["bn_act"] - before["bn_act"]
        err = float(np.abs(got - exp[yk]).max())
        results.append((name, err, bn))
        if net.device.type != "cuda" or not err <= 1e-5 or \
                (name == "conv_pool_bn") != (bn == 1):
            raise AssertionError(f"dl4j-fixtures: {name} on {net.device}: "
                                 f"max |diff| {err:.3g}, bn_act {bn}")
    norm = restore_normalizer(os.path.join(here, "dl4j",
                                           "mlp_with_normalizer.zip"))
    if norm.mean.tolist() != [0.5, -1.0, 2.0]:
        raise AssertionError(f"dl4j-fixtures: normalizer mean {norm.mean}")
    cexp = np.load(os.path.join(here, "expected_outputs.npz"))
    for name in CHECKPOINT_FIXTURES:
        net = restore_model(os.path.join(here, name + ".zip"))
        with dtypes.full_precision():
            got = net.output(cexp[name + "_in"]).cpu().numpy()
        err = float(np.abs(got - cexp[name + "_out"]).max())
        results.append((name, err, None))
        if net.device.type != "cuda" or not err <= 1e-5:
            raise AssertionError(f"dl4j-fixtures: checkpoint {name} on "
                                 f"{net.device}: max |diff| {err:.3g}")
    log("[dl4j-fixtures] restored onto the card, max |diff| from the "
        "committed output (tol 1e-5, TF32 off): " + ", ".join(
            f"{n} {e:.3g}" + (f" (bn_act {b})" if b else "")
            for n, e, b in results) + "; normalizer.bin mean "
        f"{norm.mean.tolist()}")
    steps, fit_launches = 3, {}
    for name, per_step in TRAINED_FIXTURES.items():
        path = os.path.join(here, name + ".zip")
        nets = {"card": restore_model(path),
                "cpu": restore_model(path, device="cpu")}
        x = cexp[name + "_in"]
        out_shape = cexp[name + "_out"].shape
        y = np.eye(out_shape[-1], dtype=np.float32)[
            np.random.default_rng(SEED).integers(0, out_shape[-1],
                                                 out_shape[:-1])]
        layers = [f"{type(l).__name__}({type(l.dropout).__name__}, "
                  f"{type(l.weight_noise).__name__})"
                  for l in nets["card"].layers
                  if l.dropout is not None or l.weight_noise is not None] \
            or [type(l).__name__ for l in nets["card"].layers]
        log(f"[dl4j-fixtures] {name}: {', '.join(layers)}; iteration "
            f"{nets['card'].iteration}; {steps} fit steps, card vs CPU")
        reset_counts()
        refer_fit_steps(torch, np, "dl4j-fixtures", nets, (x, y), steps,
                        REFER_DROPOUT_TOL, what=f"{name} ")
        launches = read_counts()
        want = {k: steps * per_step.get(k, 0) for k in launches}
        if launches != want:
            raise AssertionError(f"dl4j-fixtures: {name} launches "
                                 f"{launches}, want {want}")
        fit_launches = {k: fit_launches.get(k, 0) + v
                        for k, v in launches.items()}
    return fit_launches


# ------------------------------------------------------------ phases 30-32
VGG_SHAPE = (224, 224, 3)
VGG_PARAMS = 138_357_544
VGG_TRAIN = (64, 20, 5)  # batch, mixed steps, float32 / TF32 steps
VGG_PER_STEP = {"linear_xent_fwd": 1, "linear_xent_bwd": 1}
# VGG16's Output: 64 rows of the last Dense's 4096 into 1000 classes
VGG_XENT_CASES = [(64, 4096, 1000, "onehot", "float32"),
                  (64, 4096, 1000, "onehot", "bfloat16")]
# card against CPU per step from the same point, TF32 off (refer_fit_steps'
# measures): the score relative 1e-5, each element's change 1e-5
# absolute and the slots 1e-4 of each leaf's largest magnitude, as
# refer-train holds them; BN running stats 1e-4
REFER_DROPOUT_TOL = {"score": 1e-5, "change": 1e-5, "slot": 1e-4,
                     "state": 1e-4}
# VGG16: no float32 program gets its 13 convs' changes within 1e-4 of
# each other. Through the relus, at random init, each conv leaf's change
# and slot is 1e-3 to 7.4e-3 away (in L2 norm) from the same step in
# float64 on the CPU port and 1e-3 to 8.2e-3 on the card (an NVIDIA H100
# 80GB HBM3, 700 W; the Dense leaves 1.2e-4 to 8e-8 on both), so the card
# and the CPU differ by up to 1.7e-2 in a slot and 2.3e-5 in an element's
# change there, and a leaf's distance moves by up to 1.7x between runs of
# the card. The changes and slots are held against float64 instead: the
# card's farthest leaf at most 3 times as far as the CPU float32's
# farthest (measured 0.24 to 1.63 times over six steps in two runs; a
# wrong dropout mask put a slot at 1.66, 1353 times, in a mutation check
# on the CPU at 32x32). The score as refer-train holds it
REFER_VGG_TOL = {"score": 1e-5, "exact": 3.0}


def vgg_net(torch, device=None):
    from deeplearning4j_tpu_torch.zoo import VGG16

    return VGG16(num_classes=1000, input_shape=VGG_SHAPE, seed=SEED).init(
        **({} if device is None else {"device": device}))


class DrawTape:
    """Stands in for a network's dropout draws (`nn.dropout.Draws`). A
    recording tape passes every call on to `inner` and keeps each mask and
    noise sample it hands out; a replaying tape hands the kept samples out
    again, in order, on its own device, and fails on a call that does not
    match the recorded one. So a CPU network trains with the card's
    masks."""

    def __init__(self, inner, tape, device=None):
        self.inner, self.tape, self.device = inner, tape, device

    @classmethod
    def record(cls, inner):
        return cls(inner, [])

    @classmethod
    def replay(cls, taken, device):
        import collections

        return cls(None, collections.deque(taken), device)

    def _child(self, inner):
        return DrawTape(inner, self.tape, self.device)

    def step(self):
        return self._child(self.inner and self.inner.step())

    def split(self, n):
        if self.inner is None:
            return [self] * n
        return [self._child(d) for d in self.inner.split(n)]

    def fold_in(self, data):
        return self._child(self.inner and self.inner.fold_in(data))

    def _take(self, what, shape, draw):
        if self.inner is not None:
            t = draw(self.inner)
            self.tape.append((what, t))
            return t
        if not self.tape:
            raise AssertionError(f"replayed draws exhausted at {what}")
        got, t = self.tape.popleft()
        if got != what or tuple(t.shape) != tuple(shape):
            raise AssertionError(f"replayed draws out of step: recorded "
                                 f"{got} {tuple(t.shape)}, asked {what} "
                                 f"{tuple(shape)}")
        return t.to(self.device)

    def bernoulli(self, p, shape):
        return self._take(("bernoulli", p), shape,
                          lambda d: d.bernoulli(p, shape))

    def normal(self, shape, dtype):
        return self._take(("normal", str(dtype)), shape,
                          lambda d: d.normal(shape, dtype))

    def keep_rates(self):
        """(p, kept share) of each recorded mask."""
        return [(what[1], float(t.float().mean())) for what, t in self.tape
                if what[0] == "bernoulli"]


def as_float64(net):
    """`net` (on the CPU) with its params and updater slots in float64."""
    import torch

    def widened(tree):
        if isinstance(tree, dict):
            return {k: widened(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(widened(v) for v in tree)
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return tree.double()
        return tree

    with torch.no_grad():
        net.params = widened(net.params)
    net.opt_state = widened(net.opt_state)
    return net


def refer_fit_steps(torch, np, tag, nets, data, steps, tol, what=""):
    """`steps` fit calls of nets["card"] (TF32 off) and of the CPU networks
    (nets["cpu"] in float32 and, where given, nets["f64"], the same network
    in float64) on `data` (features, labels), each from the same point: the
    card's dropout masks and noise are recorded and replayed on the CPU,
    and after each step the CPU networks take the card's params, state and
    slots. Measures per step: "score" |card - cpu| / |cpu|; "change" the
    largest |card - cpu| over the params' changes; "slot" each updater
    slot's largest |card - cpu| over its leaf's largest magnitude; "state"
    the running state's likewise; with "f64", "exact": the card's largest
    distance from float64 over every change and slot leaf (in L2 norm,
    relative) over the CPU float32's largest (at least 1e-5). Gates the
    measures named in `tol`; returns the worst of each over the steps."""
    from deeplearning4j_tpu_torch import dtypes, interop
    from deeplearning4j_tpu_torch.datasets import DataSet

    def norm_rel(a, c):
        return float(np.linalg.norm(a - c) / max(np.linalg.norm(c), 1e-30))

    x, y = data
    batches = {k: DataSet(x.astype(np.float64), y.astype(np.float64))
               if k == "f64" else DataSet(x, y) for k in nets}
    base = nets["card"].draws
    worst = {}
    for step in range(steps):
        start = nets["cpu"].get_param_table()
        rec = DrawTape.record(base)
        nets["card"].draws = rec
        with dtypes.full_precision():
            nets["card"].fit(batches["card"])
            for k, net in nets.items():
                if k != "card":
                    net.draws = DrawTape.replay(rec.tape, "cpu")
                    net.fit(batches[k])
                    if net.draws.tape:
                        raise AssertionError(
                            f"{tag}: {len(net.draws.tape)} recorded draws "
                            f"left over")
        moved = {k: {key: p - start[key]
                     for key, p in net.get_param_table().items()}
                 for k, net in nets.items()}
        slots = {k: dict(slot_items(interop.opt_state_to_jax(net)))
                 for k, net in nets.items()}
        states = [(nets["card"].state[k][s], v)
                  for k, st in nets["cpu"].state.items()
                  for s, v in st.items()]
        errs = {
            "score": abs(nets["card"].score_ - nets["cpu"].score_)
            / abs(nets["cpu"].score_),
            "change": max(float(np.abs(moved["card"][k] - w).max())
                          for k, w in moved["cpu"].items()),
            "slot": max(leaf_rel(slots["card"][k], v)
                        for k, v in slots["cpu"].items()),
            "state": max((leaf_rel(a.cpu().numpy(), b.numpy())
                          for a, b in states), default=0.0),
        }
        note = ""
        if "f64" in nets:
            dist = {}
            for k in ("card", "cpu"):
                dist[k] = {**{f"change {key}": norm_rel(moved[k][key], w)
                              for key, w in moved["f64"].items()},
                           **{f"slot {key}": norm_rel(slots[k][key], w)
                              for key, w in slots["f64"].items()}}
            far = {k: max(d, key=d.get) for k, d in dist.items()}
            errs["exact"] = dist["card"][far["card"]] / max(
                dist["cpu"][far["cpu"]], 1e-5)
            note = "; against float64 the farthest leaf " + ", ".join(
                f"{k} {far[k]} {dist[k][far[k]]:.3g}" for k in far)
        log(f"[{tag}] {what}step {step + 1}: scores "
            f"{nets['card'].score_:.7f} (card) {nets['cpu'].score_:.7f} "
            f"(CPU); " + ", ".join(
                f"{k} {v:.3g}" + (f" (tol {tol[k]:g})" if k in tol else "")
                for k, v in errs.items())
            + f"{note}; {len(rec.tape)} draws replayed")
        worst = {k: max(worst.get(k, v), v) for k, v in errs.items()}
        for k, net in nets.items():
            if k != "card":
                copy_state(net, nets["card"])
        if "f64" in nets:
            as_float64(nets["f64"])
    nets["card"].draws = base
    bad = {k: worst[k] for k in tol
           if not (math.isfinite(worst[k]) and worst[k] <= tol[k])}
    if bad:
        raise AssertionError(f"{tag}: card and CPU differ: {bad}")
    return worst


def phase_train_vgg16(torch, np, card):
    """Zoo VGG16 at full width trained by MultiLayerNetwork.fit: 20 steps
    under the mixed policy on one repeated batch of 64 bfloat16 images made
    on the card, then 5 under the float32 / TF32 policy on the same images
    in float32, one network throughout. Returns the mixed run's
    launches, its first score and its median step ms."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet

    b, mixed_steps, f32_steps = VGG_TRAIN
    x, y = image_batch(torch, SEED + 11, b, VGG_SHAPE)
    t0 = time.perf_counter()
    net = vgg_net(torch)
    if net.num_params() != VGG_PARAMS:
        raise AssertionError(f"train-vgg16: {net.num_params()} params")
    log(f"[train-vgg16] VGG16 ({net.num_params()} params, dropout "
        f"{[l.dropout for l in net.layers if l.dropout]}) on {net.device} "
        f"in {time.perf_counter() - t0:.2f} s; draws on "
        f"{net.draws.generator.device}")
    results = {}
    for mixed, steps, data in ((True, mixed_steps, DataSet(x, y)),
                               (False, f32_steps, DataSet(x.float(), y))):
        tag = "mixed bf16" if mixed else "TF32"
        dtypes.set_mixed_precision(mixed)
        torch.cuda.reset_peak_memory_stats()
        base = net.draws
        tape = DrawTape.record(base)
        try:
            reset_counts()
            net.draws = tape
            first = timed_fits(torch, net, data, 1)
            net.draws = base
            runs = first + timed_fits(torch, net, data, steps - 1)
            launches = read_counts()
        finally:
            net.draws = base
            dtypes.set_mixed_precision(False)
        scores = [sc for _, sc in runs]
        want = {k: steps * VGG_PER_STEP.get(k, 0) for k in launches}
        if launches != want:
            raise AssertionError(f"train-vgg16 ({tag}): launches "
                                 f"{launches}, want {want}")
        if not all(math.isfinite(sc) for sc in scores):
            raise AssertionError(f"train-vgg16 ({tag}): scores {scores}")
        if mixed and not sorted(scores[-5:])[2] < scores[0]:
            raise AssertionError(f"train-vgg16 ({tag}): the median of the "
                                 f"last 5 scores is not below the first: "
                                 f"{scores}")
        keep = tape.keep_rates()
        if len(keep) != 2 or any(abs(k - p) > 0.01 for p, k in keep):
            raise AssertionError(f"train-vgg16 ({tag}): dropout masks "
                                 f"(p, kept) {keep}")
        steady = sorted(t for t, _ in runs[1:])
        step_ms = steady[len(steady) // 2] * 1e3
        log(f"[train-vgg16] {tag}: {steps} steps of {b} images, scores "
            f"{', '.join(f'{sc:.5f}' for sc in scores)}; launches {want} "
            f"(per step {VGG_PER_STEP}); first step's dropout masks (p, "
            f"kept share) {[(p, round(k, 5)) for p, k in keep]}")
        log(f"[train-vgg16] {tag}: median step {step_ms:.3f} ms, "
            f"{b / (step_ms / 1e3):.1f} trained images/s; first step "
            f"{runs[0][0] * 1e3:.2f} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({card})")
        results[tag] = launches, scores[0], step_ms
    del net
    torch.cuda.empty_cache()
    return results["mixed bf16"]


def phase_refer_train_vgg16(torch, np):
    """3 Nesterovs steps of VGG16 at full width and batch 2 on the card
    (TF32 off, deterministic cuDNN), on the CPU and on the CPU in float64,
    each from the same point, the card's dropout masks replayed on the
    CPU. cuDNN's default weight-gradient algorithms sum in an order that
    changes from run to run, and each step starts from the card's params,
    so with them steps 2 and 3 start from another point in every run, and
    the CPU float32's farthest leaf from float64 (the gate's denominator)
    moved from 0.0004 to 0.0129 between runs of this phase on an NVIDIA
    H100 80GB HBM3, failing 4 of 9 runs (the parent commit's 2 of 4)."""

    steps, b = 3, 2
    rng = np.random.default_rng(SEED + 12)
    x = rng.standard_normal((b, *VGG_SHAPE)).astype(np.float32)
    y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, b)]
    nets = {"card": vgg_net(torch), "cpu": vgg_net(torch, "cpu"),
            "f64": as_float64(vgg_net(torch, "cpu"))}
    with deterministic_cudnn(torch):
        reset_counts()
        refer_fit_steps(torch, np, "refer-train-vgg16", nets, (x, y), steps,
                        REFER_VGG_TOL)
        launches = read_counts()
    want = {k: steps * VGG_PER_STEP.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"refer-train-vgg16: launches {launches}, "
                             f"want {want}")
    del nets
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phases 33-35
# train-vgg16's and train-resnet's runs through ParallelWrapper at world
# size 1 over NCCL. The first step starts where the train phase's did, so
# their first scores agree: VGG16's to 1e-6 (its loss a sum over the global
# count here, a mean there: float32 results at most an ulp apart);
# ResNet-50's to 1e-4 (its 53 BatchNorms' statistics too, which the
# bfloat16 activations then round)
DP_FIRST_TOL = {"dp-vgg16": 1e-6, "dp-resnet": 1e-4}


def phase_dp(torch, np, card, tag, net, batch, per_step, first, train):
    """`net` trained through ParallelWrapper (world size 1, the NCCL group
    this script initialised) as its train phase trains it: 20 steps under
    the mixed policy on `batch` (bfloat16 images on the card, one-hot
    labels; `train` gives the batch and step counts), 5 under the float32 / TF32 policy on the same images in
    float32. Gates: the first score against the train phase's `first`,
    scores finite and falling, exactly `per_step` launches per step. Logs
    the step's median ms, images/s, peak memory and the gradient reduce's
    bytes, collectives and device ms per step (CUDA events around each
    bucket's pack and all-reduce). Returns the mixed run's launches."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.shard import ReduceStats
    from deeplearning4j_tpu_torch.parallel import MeshSpec, ParallelWrapper

    x, y = batch
    b, mixed_steps, f32_steps = train
    pw = ParallelWrapper(net, mesh_spec=MeshSpec(data=1))
    if pw.mesh.backend != "nccl" or pw.mesh.size != 1:
        raise AssertionError(f"{tag}: group {pw.mesh}")
    log(f"[{tag}] {net.num_params()} params wrapped by ParallelWrapper "
        f"(rank {pw.mesh.rank} of {pw.mesh.size}, {pw.mesh.backend})")
    results = {}
    for mixed, steps, data in ((True, mixed_steps, DataSet(x, y)),
                               (False, f32_steps, DataSet(x.float(), y))):
        what = "mixed bf16" if mixed else "TF32"
        dtypes.set_mixed_precision(mixed)
        torch.cuda.reset_peak_memory_stats()
        pw.stats = ReduceStats(events=[])
        try:
            reset_counts()
            runs = timed_fits(torch, net, data, steps, fit=pw.fit)
            launches = read_counts()
        finally:
            dtypes.set_mixed_precision(False)
        scores = [sc for _, sc in runs]
        want = {k: steps * per_step.get(k, 0) for k in launches}
        if launches != want:
            raise AssertionError(f"{tag} ({what}): launches {launches}, "
                                 f"want {want}")
        if not all(math.isfinite(sc) for sc in scores):
            raise AssertionError(f"{tag} ({what}): scores {scores}")
        if mixed:
            if not sorted(scores[-5:])[2] < scores[0]:
                raise AssertionError(f"{tag} ({what}): the median of the "
                                     f"last 5 scores is not below the "
                                     f"first: {scores}")
            rel = abs(scores[0] - first) / abs(first)
            log(f"[{tag}] first score {scores[0]:.9f}, the train phase's "
                f"{first:.9f}: {rel:.3g} relative (tol "
                f"{DP_FIRST_TOL[tag]:g})")
            if not rel <= DP_FIRST_TOL[tag]:
                raise AssertionError(f"{tag}: first score {scores[0]} "
                                     f"against {first}")
        st = pw.stats
        if st.steps != steps:
            raise AssertionError(f"{tag} ({what}): {st.steps} reduces in "
                                 f"{steps} steps")
        steady = sorted(t for t, _ in runs[1:])
        step_ms = steady[len(steady) // 2] * 1e3
        log(f"[{tag}] {what}: {steps} steps of {b} images, scores "
            f"{', '.join(f'{sc:.5f}' for sc in scores)}; launches {want} "
            f"(per step {per_step})")
        log(f"[{tag}] {what}: median step {step_ms:.3f} ms, "
            f"{b / (step_ms / 1e3):.1f} trained images/s; first step "
            f"{runs[0][0] * 1e3:.2f} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; "
            f"gradient reduce per step {st.bytes / steps / 1e6:.3f} MB in "
            f"{st.collectives / steps:g} NCCL all-reduces, "
            f"{st.seconds() / steps * 1e3:.3f} ms of device time (pack "
            f"and all-reduce) ({card})")
        results[what] = launches
    return results["mixed bf16"]


# refer-dp: two ranks on the one card over gloo (NCCL refuses two ranks on
# one device) against one process, TF32 off, deterministic cuDNN. Narrow
# nets: a conv + BatchNorm + dropout + Dense + Output MLN (l2; the conv has
# no bias, whose gradient BatchNorm would cancel to noise) and a tBPTT
# GravesLSTM char-RNN with one row's labels masked. Both take Nesterovs:
# its step is linear in the gradient, where Adam's step is about lr
# whatever the gradient's size, so the sums' rounding in a near-zero
# gradient would move a param by up to lr
DP_REFER = dict(image=(8, 8, 3), conv=8, dense=32, classes=10, batch=8,
                steps=3, vocab=16, hidden=32, length=24, window=8, rows=4)
DP_REFER_TOL = 1e-5
DP_REFER_PER_STEP = {
    "conv_bn": {"bn_act": 1, "linear_xent_fwd": 1, "linear_xent_bwd": 1},
    "char_rnn": {"lstm_scan": 1, "lstm_scan_bwd": 1, "linear_xent_fwd": 1,
                 "linear_xent_bwd": 1}}
DP_REFER_PER_STEP["masked_graph"] = DP_REFER_PER_STEP["char_rnn"]


def dp_refer_nets():
    """The three refer-dp networks on the card, from SEED."""
    from deeplearning4j_tpu_torch.models import (
        ComputationGraph,
        MultiLayerNetwork,
    )
    from deeplearning4j_tpu_torch.nn import inputs as it
    from deeplearning4j_tpu_torch.nn import updaters
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.graph_conf import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        BatchNorm,
        Conv2D,
        Dense,
        GravesLSTM,
        Output,
        RnnOutput,
    )

    c = DP_REFER
    conv = NeuralNetConfiguration(
        seed=SEED, updater=updaters.Nesterovs(learning_rate=0.05,
                                              momentum=0.9), l2=1e-4,
    ).list([Conv2D(kernel_size=(3, 3), n_out=c["conv"],
                   convolution_mode="same", has_bias=False),
            BatchNorm(activation="relu"),
            Dense(n_out=c["dense"], activation="relu", dropout=0.5),
            Output(n_out=c["classes"], loss="mcxent")]
           ).set_input_type(it.convolutional(*c["image"]))
    rnn = NeuralNetConfiguration(
        seed=SEED, updater=updaters.Nesterovs(learning_rate=0.1,
                                              momentum=0.9),
        backprop_type="tbptt", tbptt_fwd_length=c["window"],
    ).list([GravesLSTM(n_out=c["hidden"], activation="tanh"),
            RnnOutput(n_out=c["vocab"], loss="mcxent")]
           ).set_input_type(it.recurrent(c["vocab"], c["length"]))
    graph = ComputationGraphConfiguration(defaults=NeuralNetConfiguration(
        seed=SEED, updater=updaters.Nesterovs(learning_rate=0.1,
                                              momentum=0.9),
        backprop_type="tbptt", tbptt_fwd_length=c["window"])) \
        .add_inputs("in") \
        .add_layer("lstm", GravesLSTM(n_out=c["hidden"], activation="tanh"),
                   "in") \
        .add_layer("out", RnnOutput(n_out=c["vocab"], loss="mcxent"), "lstm") \
        .set_outputs("out") \
        .set_input_types(it.recurrent(c["vocab"], c["length"]))
    return {"conv_bn": MultiLayerNetwork(conv).init(),
            "char_rnn": MultiLayerNetwork(rnn).init(),
            "masked_graph": ComputationGraph(graph).init()}


def dp_refer_data(np):
    """Per network, the global batches of its refer-dp steps (numpy)."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    c = DP_REFER
    rng = np.random.default_rng(SEED + 13)
    conv = [DataSet(rng.standard_normal((c["batch"], *c["image"])).astype(
                np.float32),
                np.eye(c["classes"], dtype=np.float32)[
                    rng.integers(0, c["classes"], c["batch"])])
            for _ in range(c["steps"])]
    x, y = char_batch(np, rng, c["rows"], c["length"], c["vocab"])
    lm = np.ones((c["rows"], c["length"]), np.float32)
    lm[0, 13:] = 0.0
    # the graph: features and labels masked alike, row 0 wholly masked in
    # the last window
    gx, gy = char_batch(np, rng, c["rows"], c["length"], c["vocab"])
    gm = np.ones((c["rows"], c["length"]), np.float32)
    gm[0, 13:] = 0.0
    return {"conv_bn": conv, "char_rnn": [DataSet(x, y, None, lm)],
            "masked_graph": [DataSet(gx, gy, gm, gm.copy())]}


class Snapshots:
    """A listener keeping every step's (tBPTT window's) score, param
    table, updater slots and running state, as numpy."""

    def __init__(self):
        self.steps = []

    def iteration_done(self, net, iteration, score):
        from deeplearning4j_tpu_torch import interop

        snap = {"score": score}
        snap.update({f"param/{k}": v
                     for k, v in net.get_param_table().items()})
        snap.update({f"slot/{k}": v for k, v in slot_items(
            interop.opt_state_to_jax(net))})
        snap.update({f"state/{k}/{s}": t.detach().cpu().numpy()
                     for k, st in net.state.items() for s, t in st.items()})
        self.steps.append(snap)


def dp_refer_run(torch, np, rank=None, tmp=None):
    """Trains the two refer-dp networks on the card, TF32 off and cuDNN
    deterministic: in this process by fit (`rank` None), or as `rank` of
    2 through ParallelWrapper over gloo (rendezvous in `tmp`). Returns
    ({net: [snapshot per step]}, {net: launches})."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec,
        ParallelWrapper,
        init_process_group,
    )

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    if rank is not None:
        init_process_group(f"file://{tmp}/rdv", rank, 2, backend="gloo")
    try:
        data = dp_refer_data(np)
        out, launches = {}, {}
        for name, net in dp_refer_nets().items():
            snaps = Snapshots()
            net.set_listeners(snaps)
            fit = net.fit
            if rank is not None:
                fit = ParallelWrapper(net, mesh_spec=MeshSpec(data=2)).fit
            reset_counts()
            with dtypes.full_precision():
                for ds in data[name]:
                    fit(ds)
            launches[name] = read_counts()
            out[name] = snaps.steps
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        if rank is not None:
            torch.distributed.destroy_process_group()
    return out, launches


def dp_rank_main(rank: int, tmp: str) -> int:
    """A refer-dp rank (this script run with --dp-rank RANK DIR): trains
    and writes its snapshots and launches to DIR/rank{RANK}.npz."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    out, launches = dp_refer_run(torch, np, rank, tmp)
    flat = {f"launches/{name}/{k}": v for name, counts in launches.items()
            for k, v in counts.items()}
    for name, steps in out.items():
        for i, snap in enumerate(steps):
            flat.update({f"{name}/{i}/{k}": np.asarray(v)
                         for k, v in snap.items()})
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **flat)
    return 0


def phase_refer_dp(torch, np):
    """Two ranks of ParallelWrapper spawned on the one card over gloo
    against this process's fit on the same global batches and draws:
    after every step (tBPTT window) the ranks' params, slots and running
    stats are bit-identical, and the score, params, Nesterovs / Adam slots
    and BatchNorm running stats within DP_REFER_TOL of the single process
    (each leaf relative to its largest magnitude); every process launches
    exactly DP_REFER_PER_STEP per step."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
             tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(2)]
        try:
            single, launches = dp_refer_run(torch, np)
            logs = [p.communicate(timeout=300)[0].decode() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"refer-dp: rank {r} exited "
                                     f"{p.returncode}:\n{text[-4000:]}")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(2)]
    for name, steps in single.items():
        per = DP_REFER_PER_STEP[name]
        want = {k: len(steps) * per.get(k, 0) for k in launches[name]}
        got = [launches[name]] + [{k: int(r[f"launches/{name}/{k}"])
                                   for k in want} for r in ranks]
        if any(g != want for g in got):
            raise AssertionError(f"refer-dp {name}: launches (single, rank "
                                 f"0, rank 1) {got}, want {want}")
        worst = {}
        for i, snap in enumerate(steps):
            for k, ref in snap.items():
                a, b = (r[f"{name}/{i}/{k}"] for r in ranks)
                if not np.array_equal(a, b):
                    raise AssertionError(f"refer-dp {name}: the ranks "
                                         f"differ after step {i + 1} in {k}")
                kind = k.split("/")[0]
                err = (abs(float(a) - ref) / abs(ref) if kind == "score"
                       else leaf_rel(a, ref))
                worst[kind] = max(worst.get(kind, 0.0), err)
        log(f"[refer-dp] {name}: {len(steps)} steps, 2 ranks (gloo, one "
            f"card) bit-identical after each; against one process, worst "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
            + f" (tol {DP_REFER_TOL:g}); launches per process {want}")
        bad = {k: v for k, v in worst.items()
               if not (math.isfinite(v) and v <= DP_REFER_TOL)}
        if bad:
            raise AssertionError(f"refer-dp {name}: ranks and one process "
                                 f"differ: {bad}")
    log(f"[refer-dp] took {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ phases 36-40
# masks and tBPTT through the ComputationGraph, at train-rnn-tbptt's width
# and batch: row 1's live length, and the least any other row's may be
CG_RNN_LIVE = (510, 500)
CG_RNN_MLN_WINDOWS = 3         # last windows run again beside the MLN
BIDIR_STEPS = 20
# the classifier's RmsProp rate: at the char-RNN's 1e-2 its first step
# moves every weight by lr / sqrt(1 - decay) = 0.045, and whole-sequence
# BPTT through 1000 steps of both halves then diverges to NaN from step 5,
# on the card (an NVIDIA H100 80GB HBM3 at 700 W) and in the same phase
# run on the CPU alike; at 1e-3 the loss falls from 4.41 to 2.36 in 20
# steps on both
BIDIR_LR = 1e-3
# the reverse half's inputs at train-bidir's shape (rows 5 and 6) and
# inside chunked_lstm_auto_regime (rows 7 and 8)
BIDIR_KERNEL_CASES = [(32, 1000, 256), (8, 1024, 256)]
# train-bidir's Output: 32 rows of the merged 512 features, 77 characters
BIDIR_XENT_CASES = [(32, 512, 77, "onehot", "float32")]
# refer-train-cg: (rows, characters, window, fit calls) of the char graph,
# (rows, characters, steps) of the bidirectional classifier
REFER_CG = ((8, 200, 50, 1), (8, 120, 3))


def masked_char_batch(np, rng, n, t, vocab, row1, least):
    """char_batch and its right-padded mask (the features mask and the
    labels mask): row 0 live for all t characters, row 1 for `row1`, the
    others for lengths drawn from `rng` in [least, t]. Returns x, y, the
    mask and the lengths."""
    x, y = char_batch(np, rng, n, t, vocab)
    lengths = rng.integers(least, t + 1, n)
    lengths[0], lengths[1] = t, row1
    mask = (np.arange(t)[None] < lengths[:, None]).astype(np.float32)
    return x, y, mask, lengths


def cg_rnn_net(torch, t, window, device=None, bidir=False):
    """The char-RNN as a ComputationGraph at full width from SEED
    (RmsProp(1e-2), l2 1e-4, tBPTT windows of `window`): in -> l0
    GravesLSTM(256) -> l1 GravesLSTM(256) -> out RnnOutput(77), or with
    `bidir` the classifier in -> bi GravesBidirectionalLSTM(256); last
    (LastTimeStepVertex) and pool (GlobalPooling avg) of bi -> merge
    (MergeVertex) -> out Output(77), at RmsProp(BIDIR_LR)."""
    from deeplearning4j_tpu_torch.models import ComputationGraph
    from deeplearning4j_tpu_torch.nn import inputs as it
    from deeplearning4j_tpu_torch.nn import updaters
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.graph_conf import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph_vertices import (
        LastTimeStepVertex,
        MergeVertex,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        GlobalPooling,
        GravesBidirectionalLSTM,
        GravesLSTM,
        Output,
        RnnOutput,
    )

    vocab, n = RNN["num_classes"], CHAR_RNN["hidden"]
    lr = BIDIR_LR if bidir else 1e-2
    g = ComputationGraphConfiguration(defaults=NeuralNetConfiguration(
        seed=SEED, updater=updaters.RmsProp(learning_rate=lr), l2=1e-4,
        backprop_type="tbptt", tbptt_fwd_length=window)).add_inputs("in")
    if bidir:
        g = (g.add_layer("bi", GravesBidirectionalLSTM(
                n_out=n, activation="tanh"), "in")
             .add_vertex("last", LastTimeStepVertex(mask_input="in"), "bi")
             .add_layer("pool", GlobalPooling(pooling_type="avg"), "bi")
             .add_vertex("merge", MergeVertex(), "last", "pool")
             .add_layer("out", Output(n_out=vocab, loss="mcxent",
                                      activation="softmax"), "merge"))
    else:
        g = (g.add_layer("l0", GravesLSTM(n_out=n, activation="tanh"), "in")
             .add_layer("l1", GravesLSTM(n_out=n, activation="tanh"), "l0")
             .add_layer("out", RnnOutput(n_out=vocab, loss="mcxent",
                                         activation="softmax"), "l1"))
    conf = g.set_outputs("out").set_input_types(it.recurrent(vocab, t))
    return ComputationGraph(conf).init(
        **({} if device is None else {"device": device}))


def bidir_labels(np, y, lengths):
    """The character after each row's live span, one-hot [n, vocab]."""
    return y[np.arange(len(lengths)), lengths - 1]


def flipped_lstm_inputs(torch, gen, b, t, n):
    """lstm_case_inputs (float32, peepholes, nonzero h0 and c0) as the
    backward half of GravesBidirectionalLSTM gives them to the kernels: zx
    and a right-padded mask flipped in time, so each row's dead steps lead
    (row 0 live throughout, row 1 wholly dead, the others live for at
    least t / 2); cotangents of order 1 and the chunked forward's outputs,
    as lstm_bwd_inputs."""
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops

    zx, R, p, h0, c0, _ = lstm_case_inputs(torch, gen, b, t, n,
                                           torch.float32, True, False)
    dev = zx.device
    lengths = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
    lengths[0], lengths[1] = t, 0
    mask = (torch.arange(t, device=dev)[None] < lengths[:, None]).float()
    zx, m = torch.flip(zx, dims=(1,)).contiguous(), torch.flip(mask, (1,))
    g = tuple(torch.randn(s, generator=gen, device=dev)
              for s in ((b, t, n), (b, n), (b, n)))
    fwd = lstm_ops.lstm_scan_chunked_forward(zx, R, h0, c0, p, m)
    return {"zx": zx, "R": R, "p": p, "h0": h0, "c0": c0, "m": m, "g": g,
            "fwd": fwd}


def phase_kernel_bidir(torch, bw, peak, peak_tf32):
    """kernel-bidir: rows 5-8 on the reverse half's inputs (leading dead
    steps, a wholly dead row, nonzero h0 and c0) at BIDIR_KERNEL_CASES,
    float32, against their plain versions: h0 and c0 must pass through the
    leading dead steps in the forward, dh and dc through them to dh0 and
    dc0 in the backward. Times rows 5 and 6 at train-bidir's (32, 1000,
    256) with their bounds (the products of the live (row, step) pairs
    only) and torch.nn.LSTM's. Returns ({"lstm_scan": row, "lstm_scan_bwd":
    row}, {kernel: largest absolute error})."""
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    torch.backends.cuda.matmul.allow_tf32 = False
    names_fwd = ("hs", "hT", "cT", "hck", "cck")
    names_bwd = ("dzx", "dR", "dp", "dh0", "dc0")
    worst = dict.fromkeys(("lstm_scan", "lstm_scan_bwd", "lstm_scan_chunked",
                           "lstm_scan_chunked_bwd"), 0.0)
    rows = {}
    for b, t, n in BIDIR_KERNEL_CASES:
        s = flipped_lstm_inputs(torch, gen, b, t, n)
        where = f"b={b} t={t} n={n} leading dead steps float32"

        def row5(s=s):
            return lstm_ops.lstm_scan_peephole(s["zx"], s["R"], s["p"],
                                               s["h0"], s["c0"], s["m"])

        def row6(s=s, hs=None):
            return lstm_ops.lstm_scan_bwd(s["zx"], s["R"], s["h0"], s["c0"],
                                          s["fwd"][0] if hs is None else hs,
                                          *s["g"], s["p"], s["m"])

        def plain5(s=s):
            return lstm_ops.lstm_scan_reference(s["zx"], s["R"], s["h0"],
                                                s["c0"], s["p"], s["m"])

        def plain6(s=s):
            return lstm_ops.lstm_scan_backward_reference(
                s["zx"], s["R"], s["h0"], s["c0"], s["fwd"][0], *s["g"],
                s["p"], s["m"])

        got5, ref5 = row5(), plain5()
        got6, ref6 = row6(hs=got5[0]), plain6()
        got8 = lstm_ops.lstm_scan_chunked_bwd(
            s["zx"], s["R"], s["fwd"][3], s["fwd"][4], *s["g"], s["p"],
            s["m"])
        ref7 = lstm_ops.lstm_scan_chunked_reference(
            s["zx"], s["R"], s["h0"], s["c0"], s["p"], s["m"])
        ref8 = lstm_ops.lstm_scan_chunked_backward_reference(
            s["zx"], s["R"], s["fwd"][3], s["fwd"][4], *s["g"], s["p"],
            s["m"])
        torch.cuda.synchronize()
        for k, names, got, ref, kind in (
                ("lstm_scan", names_fwd[:3], got5, ref5, "fwd"),
                ("lstm_scan_bwd", names_bwd, got6, ref6, "bwd"),
                ("lstm_scan_chunked", names_fwd, s["fwd"], ref7, "fwd"),
                ("lstm_scan_chunked_bwd", names_bwd, got8, ref8, "bwd")):
            worst[k] = max(worst[k], lstm_bwd_check(k, names, got, ref, kind,
                                                    where))
        # the wholly dead row keeps its carry and passes its cotangent
        for what, fwd in (("lstm_scan", got5), ("lstm_scan_chunked",
                                                 s["fwd"])):
            if not (torch.equal(fwd[1][1], s["h0"][1])
                    and torch.equal(fwd[2][1], s["c0"][1])
                    and not fwd[0][1].abs().any()):
                raise AssertionError(f"kernel-bidir: {what} did not carry "
                                     f"h0, c0 through a wholly dead row")
        for what, got in (("lstm_scan_bwd", got6),
                          ("lstm_scan_chunked_bwd", got8)):
            if not (torch.equal(got[3][1], s["g"][1][1])
                    and torch.equal(got[4][1], s["g"][2][1])):
                raise AssertionError(f"kernel-bidir: {what} did not pass "
                                     f"g_hT, g_cT through a wholly dead row")
        # a forward that ran the leading dead steps as live ones must fail
        live = lstm_ops.lstm_scan_reference(s["zx"], s["R"], s["h0"],
                                            s["c0"], s["p"], None)
        lstm_fwd_reject("hT from a row's leading dead steps run as live",
                        live[1], ref5[1])
        log(f"[kernel-bidir] rows 5-8 at ({b}, {t}, {n}) float32, the "
            f"reverse half's mask (leading dead steps, row 1 wholly dead, "
            f"h0/c0 nonzero): max abs error row 5 "
            f"{worst['lstm_scan']:.3g}, row 6 {worst['lstm_scan_bwd']:.3g}, "
            f"row 7 {worst['lstm_scan_chunked']:.3g}, row 8 "
            f"{worst['lstm_scan_chunked_bwd']:.3g}; the dead row's carry and "
            f"cotangent pass through bit for bit")
        del got5, ref5, got6, ref6, got8, ref7, ref8, live
        if (b, t, n) == BIDIR_KERNEL_CASES[0]:
            pairs = int(s["m"].sum())
            k5 = device_ms(torch, lambda i: row5(), 1, iters=5)
            k6 = device_ms(torch, lambda i: row6(), 1, iters=5)
            p5 = device_ms(torch, lambda i: plain5(), 1, iters=1)
            p6 = device_ms(torch, lambda i: plain6(), 1, iters=1)
            lib5 = lstm_library_fwd_ms(torch, b, t, n)
            lib6 = lstm_library_bwd_ms(torch, b, t, n)
            # the products of the live (row, step) pairs only: n <= 256,
            # so row 5's run as float32 FMAs (lstm_fwd_bound), row 6's three
            # as 3xTF32 (phase_lstm_bwd)
            fwd_ops = 2 * pairs * n * 4 * n
            moved5 = (b * t * 5 * n + 4 * n * n + 4 * b * n + 3 * n) * 4 \
                + 4 * b * t
            b5 = max(moved5 / bw, fwd_ops / peak) * 1e3
            by5 = "bytes" if moved5 / bw >= fwd_ops / peak else "operations"
            moved6 = ((b * t * 4 * n + 4 * n * n + b * t * n + 2 * b * n)
                      * 4 + 3 * n * 4 + 4 * b * t + (b * t * n + 2 * b * n)
                      * 4 + b * t * 4 * n * 4
                      + (4 * n * n + 3 * n + 2 * b * n) * 4)
            ops6 = 9 * fwd_ops
            b6 = max(moved6 / bw, ops6 / peak_tf32) * 1e3
            by6 = "bytes" if moved6 / bw >= ops6 / peak_tf32 else \
                "operations"
            rows["lstm_scan"] = {"ms": k5, "plain_ms": p5, "library_ms": lib5,
                                 "bound_ms": b5, "bound_by": by5}
            rows["lstm_scan_bwd"] = {"ms": k6, "plain_ms": p6,
                                     "library_ms": lib6, "bound_ms": b6,
                                     "bound_by": by6}
            for k, r, what in (("lstm_scan", rows["lstm_scan"],
                                "float32 FMAs"),
                               ("lstm_scan_bwd", rows["lstm_scan_bwd"],
                                "3 products as 3xTF32")):
                log(f"[kernel-bidir] {k} at ({b}, {t}, {n}) float32, the "
                    f"reverse half ({pairs} live (row, step) pairs of "
                    f"{b * t}): kernel {r['ms']:.4f} ms ({r['ms'] * 1e3 / t:.2f}"
                    f" us/step), plain {r['plain_ms']:.4f} ms, library "
                    f"{r['library_ms']:.4f} ms [torch.nn.LSTM "
                    f"{'forward' if k == 'lstm_scan' else 'backward'}, cuDNN,"
                    f" plain cell, no mask], bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}, {what}; "
                    f"{100 * r['bound_ms'] / r['ms']:.1f}% of it)")
        del s
        torch.cuda.empty_cache()
    return rows, worst


def phase_train_cg_rnn(torch, np, card):
    """train-cg-rnn: the char graph (cg_rnn_net) trained by
    ComputationGraph.fit on one masked batch of 32 x 1000 characters
    (masked_char_batch: features mask = labels mask) in tBPTT windows of
    50: 20 iterations, per window 2 lstm_scan, 2 lstm_scan_bwd, 1 + 1 xent
    and nothing else; ms per window, trained characters per second, peak
    memory. Then its last CG_RNN_MLN_WINDOWS windows again, each from the
    same point, on the graph and on the port's MLN TextGenerationLSTM
    carrying the graph's params and RmsProp slots (TF32 off): scores 1e-5
    relative, params 1e-5 absolute. Returns the 20 windows' launches, the
    graph and its batch (x, y, mask) for eval-cg-rnn."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet, MultiDataSet

    b, t, window = RNN_TBPTT
    x, y, m, lengths = masked_char_batch(
        np, np.random.default_rng(SEED + 14), b, t, RNN["num_classes"],
        *CG_RNN_LIVE)
    windows = -(-t // window)
    sl0 = slice(0, window)
    # one window on a graph of its own warms the allocator and handles
    cg_rnn_net(torch, t, window).fit(MultiDataSet(
        [x[:, sl0]], [y[:, sl0]], [m[:, sl0]], [m[:, sl0]]))
    net = cg_rnn_net(torch, t, window)
    rec = ScoreLog()
    net.set_listeners(rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    net.fit(MultiDataSet([x], [y], [m], [m]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = {k: windows * v for k, v in RNN_PER_STEP.items()}
    check_train("train-cg-rnn", rec.scores, launches, want)
    if len(rec.scores) != windows or net.iteration != windows:
        raise AssertionError(f"train-cg-rnn: {len(rec.scores)} listener "
                             f"calls, iteration {net.iteration}; want "
                             f"{windows} windows")
    per_window = m.reshape(b, windows, window).sum(axis=2)
    dead = [w for w in range(windows) if (per_window[:, w] == 0).any()]
    partial = [w for w in range(windows)
               if ((per_window[:, w] > 0) & (per_window[:, w] < window)).any()]
    if not dead or not partial:
        raise AssertionError(f"train-cg-rnn: no window with a wholly masked "
                             f"row ({dead}) or a partly masked one "
                             f"({partial})")
    live = int(m.sum())
    log(f"[train-cg-rnn] ComputationGraph in -> l0 GravesLSTM(256) -> l1 "
        f"GravesLSTM(256) -> out RnnOutput(77) ({net.num_params()} params),"
        f" {b} x {t} characters, {live} live (rows live for {lengths[0]}, "
        f"{lengths[1]} and {lengths[2:].min()}-{lengths[2:].max()}), in "
        f"{windows} windows of {window} (partly masked rows from window "
        f"{partial[0]}, wholly masked rows from window {dead[0]}): score "
        f"{rec.scores[0]:.5f} -> {rec.scores[-1]:.5f}; launches {want} (per "
        f"window {RNN_PER_STEP})")
    log(f"[train-cg-rnn] batch {wall * 1e3:.2f} ms (copy included) = "
        f"{wall / windows * 1e3:.3f} ms per window, {live / wall:.1f} "
        f"trained (live) characters/s, {b * t / wall:.1f} character slots/s;"
        f" peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({card})")
    mln = rnn_net(torch, window, tbptt=window)
    names = {"l0": "layer_0", "l1": "layer_1", "out": "layer_2"}
    rel, err = 0.0, 0.0
    with dtypes.full_precision():
        for w in range(windows - CG_RNN_MLN_WINDOWS, windows):
            with torch.no_grad():
                for k, key in names.items():
                    for p, v in net.params[k].items():
                        mln.params[key][p].copy_(v)
            mln.opt_state = [{s: {p: v.clone() for p, v in tree.items()}
                              for s, tree in net.opt_state[k].items()}
                             for k in names]
            mln.iteration = net.iteration
            sl = slice(w * window, (w + 1) * window)
            net.fit(MultiDataSet([x[:, sl]], [y[:, sl]], [m[:, sl]],
                                 [m[:, sl]]))
            mln.fit(DataSet(x[:, sl], y[:, sl], m[:, sl], m[:, sl]))
            rel = max(rel, abs(net.score_ - mln.score_) / abs(mln.score_))
            got = net.get_param_table()
            for key, v in mln.get_param_table().items():
                layer, p = key.split("/", 1)
                g = got[{v_: k_ for k_, v_ in names.items()}[layer] + "/" + p]
                err = max(err, float(np.abs(g - v).max()))
    if not (rel <= 1e-5 and err <= 1e-5):
        raise AssertionError(f"train-cg-rnn: the graph and the MLN differ: "
                             f"scores {rel:.3g}, params {err:.3g}")
    log(f"[train-cg-rnn] the same windows {windows - CG_RNN_MLN_WINDOWS}-"
        f"{windows - 1} on the graph and on the MLN TextGenerationLSTM, each"
        f" from the graph's params and slots (TF32 off): scores relative "
        f"{rel:.3g} (tol 1e-5), params max |diff| {err:.3g} (tol 1e-5)")
    return launches, net, (x, y, m)


def phase_train_bidir(torch, np, card):
    """train-bidir: the bidirectional classifier (cg_rnn_net bidir) on
    train-cg-rnn's masked batch, labelled with the character after each
    row's live span (2-D labels, so whole-sequence BPTT under the tBPTT
    configuration), BIDIR_STEPS steps: per step 2 lstm_scan (the forward
    half, and the reverse half on flipped zx and mask), 2 lstm_scan_bwd,
    1 + 1 xent and nothing else; scores finite and falling; ms per step,
    sequences per second, peak memory. Returns the launches."""
    from deeplearning4j_tpu_torch.datasets import MultiDataSet

    b, t, window = RNN_TBPTT
    x, y, m, lengths = masked_char_batch(
        np, np.random.default_rng(SEED + 14), b, t, RNN["num_classes"],
        *CG_RNN_LIVE)
    mds = MultiDataSet([x], [bidir_labels(np, y, lengths)], [m], None)
    net = cg_rnn_net(torch, t, window, bidir=True)
    rec = ScoreLog()
    net.set_listeners(rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(BIDIR_STEPS):
        t0 = time.perf_counter()
        net.fit(mds)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counts()
    want = {k: BIDIR_STEPS * v for k, v in RNN_PER_STEP.items()}
    check_train("train-bidir", rec.scores, launches, want)
    if net.iteration != BIDIR_STEPS:
        raise AssertionError(f"train-bidir: iteration {net.iteration}")
    steady = sorted(times[1:])
    step_ms = steady[len(steady) // 2] * 1e3
    log(f"[train-bidir] ComputationGraph in -> bi GravesBidirectionalLSTM("
        f"256) -> last (LastTimeStepVertex), pool (GlobalPooling avg) -> "
        f"merge -> out Output(77) ({net.num_params()} params), {b} "
        f"sequences of {t} characters ({int(m.sum())} live), labels 2-D: "
        f"{BIDIR_STEPS} BPTT steps, score {rec.scores[0]:.5f} -> "
        f"{rec.scores[-1]:.5f}; launches {want} (per step {RNN_PER_STEP})")
    log(f"[train-bidir] median step {step_ms:.3f} ms (batch copy "
        f"included), {b / (step_ms / 1e3):.1f} sequences/s, "
        f"{int(m.sum()) / (step_ms / 1e3):.1f} live characters/s; first "
        f"step {times[0] * 1e3:.2f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({card})")
    return launches


def phase_refer_train_cg(torch, np):
    """refer-train-cg: the two graphs at a cut length on the card (TF32
    off) and on the CPU (plain versions, exact float32), from SEED: the
    char graph on 8 x 200 masked characters in 4 windows of 50 (row 1
    wholly masked in the last window), the bidirectional classifier on 8 x
    120 for 3 steps; refer-train-rnn's gates (rmsprop_agreement)."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import MultiDataSet

    rng = np.random.default_rng(SEED + 16)
    vocab = RNN["num_classes"]
    (b, t, window, calls), (bb, bt, bsteps) = REFER_CG
    # row 1 wholly masked in the last window
    x, y, m, _ = masked_char_batch(np, rng, b, t, vocab, t - window, t // 2)
    bx, by, bm, blen = masked_char_batch(np, rng, bb, bt, vocab, bt // 3,
                                         bt // 2)
    cases = (("char graph", t, False, MultiDataSet([x], [y], [m], [m]),
              calls, calls * -(-t // window)),
             ("bidirectional", bt, True,
              MultiDataSet([bx], [bidir_labels(np, by, blen)], [bm], None),
              bsteps, bsteps))
    for label, tt, bidir, mds, fits, iters in cases:
        nets = {"card": cg_rnn_net(torch, tt, window, bidir=bidir),
                "cpu": cg_rnn_net(torch, tt, window, device="cpu",
                                  bidir=bidir)}
        logs = {}
        for k, net in nets.items():
            logs[k] = ScoreLog()
            net.set_listeners(logs[k])
        start = {k: net.get_param_table() for k, net in nets.items()}
        reset_counts()
        with dtypes.full_precision():
            for _ in range(fits):
                for net in nets.values():
                    net.fit(mds)
        launches = read_counts()
        if launches["lstm_scan"] == 0 or launches["lstm_scan_bwd"] == 0:
            raise AssertionError(f"refer-train-cg ({label}): launches "
                                 f"{launches}")
        rel, p_err, z_move, n_zero, s_err, floor, bound, finite = \
            rmsprop_agreement(np, nets, logs, start, iters,
                              lr=BIDIR_LR if bidir else 1e-2)
        same_iters = (len(logs["card"].scores) == len(logs["cpu"].scores)
                      == iters == nets["card"].iteration
                      == nets["cpu"].iteration)
        if not (rel <= 1e-5 and p_err <= 1e-5 and z_move <= bound
                and s_err <= 1e-4 and finite and same_iters):
            raise AssertionError(
                f"refer-train-cg ({label}): card and CPU differ: scores "
                f"{logs['card'].scores} vs {logs['cpu'].scores}, changes "
                f"{p_err:.3g}, zero-gradient moves {z_move:.3g}, slots "
                f"{s_err:.3g}, finite {finite}, iterations {iters}")
        log(f"[refer-train-cg] {label}: {mds.features[0].shape[0]} x {tt} "
            f"masked characters, {iters} RmsProp iterations, card (TF32 "
            f"off) vs CPU: scores relative {rel:.3g} (tol 1e-5); params' "
            f"change from their start max |diff| {p_err:.3g} (tol 1e-5); "
            f"{n_zero} elements with zero gradient (RMS gradient <= "
            f"{floor:.3g}) move at most {z_move:.3g} (RmsProp's bound "
            f"{bound:.3g}); g2 max relative {s_err:.3g} (tol 1e-4); card "
            f"launches {launches}")
        del nets


# ------------------------------------------------------------ phases 40-45
# evaluation, the fit lifecycle, early stopping and transfer learning
EVAL_RESNET = (32, 16)     # batch (the serving batch), batches per pass
EVAL_ROC_STEPS = 100
# es-charrnn: training batches of 32 x 1000 per epoch, epochs, windows
ES_BATCHES, ES_EPOCHS = 4, 3
# transfer-vgg16: classes of the new Output, steps at batch 64, its
# fine-tune updater's rate and momentum, refer-transfer's batch and steps
TRANSFER = dict(classes=5, steps=20, lr=5e-5, momentum=0.9,
                refer_batch=4, refer_steps=3)
# VGG16's new Output: 64 rows of fc2's 4096 into 5 classes, both policies
TRANSFER_XENT_CASES = [(64, 4096, 5, "onehot", "float32"),
                       (64, 4096, 5, "onehot", "bfloat16")]


class EventLog:
    """Every lifecycle event of a fit, in order."""

    def __init__(self):
        self.events = []

    def on_fit_start(self, model):
        self.events.append("on_fit_start")

    def on_epoch_start(self, model, epoch):
        self.events.append("on_epoch_start")

    def on_epoch_end(self, model, epoch):
        self.events.append("on_epoch_end")

    def on_fit_end(self, model):
        self.events.append("on_fit_end")

    def iteration_done(self, model, iteration, score):
        self.events.append("iteration_done")


def phase_eval_resnet(torch, np, card):
    """eval-resnet: zoo ResNet-50 (224x224x3, 1000 classes, seed 7, TF32)
    evaluated by ComputationGraph.do_evaluation over EVAL_RESNET[1] batches
    of 32 from a BenchmarkDataSetIterator (seed 7) wrapped in
    AsyncDataSetIterator, feeding Evaluation, ROCMultiClass(100) and
    EvaluationCalibration in one pass: the confusion matrix equals numpy's
    count of (label, argmax) over the outputs of the pass, 512 in all; each
    class's calibration counts sum to 512; bn_act 53 times per batch and
    nothing else; images per second of the pass against `output` alone on
    the same batches. Returns the pass's launches."""
    from deeplearning4j_tpu_torch import eval as ev_mod
    from deeplearning4j_tpu_torch.datasets import (
        AsyncDataSetIterator,
        BenchmarkDataSetIterator,
    )

    b, n = EVAL_RESNET
    net = resnet_net(torch)
    bench = BenchmarkDataSetIterator((b, *RESNET_SHAPE), 1000,
                                     total_batches=n, seed=SEED)
    x, y = bench._ds.features, bench._ds.labels
    net.output(x)  # warm: cuDNN's algorithm choices, the allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        net.output(x).cpu()
    t_out = time.perf_counter() - t0
    outs, output = [], net.output

    def recorded(*inputs):
        outs.append(output(*inputs))
        return outs[-1]

    net.output = recorded  # the pass's own outputs, for numpy's count
    evs = (ev_mod.Evaluation(), ev_mod.ROCMultiClass(EVAL_ROC_STEPS),
           ev_mod.EvaluationCalibration())
    it_ = AsyncDataSetIterator(bench)
    try:
        reset_counts()
        t0 = time.perf_counter()
        net.do_evaluation(it_, *evs)
        t_eval = time.perf_counter() - t0
        launches = read_counts()
    finally:
        it_.shutdown()
        del net.output
    want = {k: (n * 53 if k == "bn_act" else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"eval-resnet: launches {launches}, want {want}")
    if len(outs) != n:
        raise AssertionError(f"eval-resnet: {len(outs)} outputs, want {n}")
    count = np.zeros((1000, 1000), np.int64)
    for o in outs:
        np.add.at(count, (y.argmax(-1), o.float().cpu().numpy().argmax(-1)),
                  1)
    ev, roc, cal = evs
    if not (np.array_equal(ev.confusion.matrix, count)
            and int(ev.confusion.matrix.sum()) == b * n == ev.total):
        raise AssertionError(f"eval-resnet: the confusion matrix differs "
                             f"from numpy's count ({ev.total} counted)")
    per_class = cal.bin_count.sum(axis=1)
    if not (per_class == b * n).all():
        raise AssertionError(f"eval-resnet: calibration counts per class "
                             f"{sorted(set(per_class.tolist()))}, want "
                             f"{b * n}")
    auc = roc.calculate_average_auc()
    if not math.isfinite(auc):
        raise AssertionError(f"eval-resnet: average AUC {auc}")
    log(f"[eval-resnet] ResNet-50 (TF32), {n} batches of {b} from "
        f"BenchmarkDataSetIterator through AsyncDataSetIterator, one "
        f"do_evaluation pass into Evaluation, ROCMultiClass("
        f"{EVAL_ROC_STEPS}) and EvaluationCalibration: {ev.total} counted "
        f"(confusion matrix = numpy's count), accuracy {ev.accuracy():.5f}, "
        f"average AUC {auc:.5f}, calibration counts {b * n} per class; "
        f"launches {want} (bn_act 53 per batch)")
    log(f"[eval-resnet] the pass {t_eval * 1e3:.1f} ms = "
        f"{b * n / t_eval:.1f} evaluated images/s; output alone on the same "
        f"batches (copied to the host) {t_out * 1e3:.1f} ms = "
        f"{b * n / t_out:.1f} images/s: the evaluators on the host cost "
        f"{(t_eval - t_out) / n * 1e3:.1f} ms per batch ({card})")
    del net, outs
    torch.cuda.empty_cache()
    return launches


def phase_eval_cg_rnn(torch, np, net, batch, card):
    """eval-cg-rnn: train-cg-rnn's masked char graph, after its windows,
    evaluated on its own batch (labels mask = its features mask): the
    evaluation counts exactly the live steps, its accuracy equals numpy's
    over the masked argmax of the pass's output, 2 lstm_scan launches for
    the one forward and nothing else (inference takes no xent kernel).
    Returns the launches."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    x, y, m = batch
    outs, output = [], net.output

    def recorded(*inputs):
        outs.append(output(*inputs))
        return outs[-1]

    net.output = recorded
    try:
        reset_counts()
        t0 = time.perf_counter()
        ev = net.evaluate([DataSet(x, y, m, m)])
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        del net.output
    want = {k: (2 if k == "lstm_scan" else 0) for k in launches}
    if launches != want:
        raise AssertionError(f"eval-cg-rnn: launches {launches}, want {want}")
    out = outs[0].float().cpu().numpy()
    live = m.reshape(-1) > 0
    hits = (out.reshape(-1, out.shape[-1])[live].argmax(-1)
            == y.reshape(-1, y.shape[-1])[live].argmax(-1))
    if ev.total != int(live.sum()) or ev.accuracy() != float(
            hits.sum() / live.sum()):
        raise AssertionError(f"eval-cg-rnn: counted {ev.total} of "
                             f"{int(live.sum())} live steps, accuracy "
                             f"{ev.accuracy()} vs numpy's "
                             f"{hits.sum() / live.sum()}")
    log(f"[eval-cg-rnn] the masked char graph after train-cg-rnn: "
        f"evaluate on its {x.shape[0]} x {x.shape[1]} batch counted "
        f"{ev.total} live steps (the mask's {int(live.sum())}), accuracy "
        f"{ev.accuracy():.5f} = numpy's over the masked argmax; "
        f"{wall * 1e3:.1f} ms; launches {want} ({card})")
    return launches


def phase_es_charrnn(torch, np, tmp, card):
    """es-charrnn: the BASELINE char-RNN (zoo TextGenerationLSTM, tBPTT 50)
    trained by EarlyStoppingTrainer on ES_BATCHES batches of 32 x 1000
    Zipf characters, held-out loss on one batch from another seed
    (DataSetLossCalculator: the whole 1000 steps, unwindowed), stopped by
    MaxEpochsTerminationCondition(3), with listeners and a
    LocalFileModelSaver; then the fit(checkpoint_manager=...) resume
    contract. Returns the early-stopped run's launches."""
    from deeplearning4j_tpu_torch import earlystopping as es
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize import (
        CollectScoresListener,
        PerformanceListener,
        ScoreIterationListener,
        TrainingListener,
    )
    from deeplearning4j_tpu_torch.resilience import CheckpointManager

    b, t, window = RNN_TBPTT
    vocab = RNN["num_classes"]
    x, y = char_batch(np, np.random.default_rng(SEED + 20), b * ES_BATCHES,
                      t, vocab)
    hx, hy = char_batch(np, np.random.default_rng(SEED + 21), b, t, vocab)
    windows = ES_BATCHES * -(-t // window)

    def train_it():
        return ListDataSetIterator(DataSet(x, y), batch=b)

    net = rnn_net(torch, t, tbptt=window)
    events, scores = EventLog(), CollectScoresListener(1)
    printed = []
    snapshots = {}

    class Snapshot(TrainingListener):
        """Each epoch's params as the trainer scores and saves them."""

        def on_epoch_end(self, model, epoch):
            snapshots[epoch] = {f"{k}/{p}": v.clone()
                                for k, ps in model.params.items()
                                for p, v in ps.items()}

    class WindowClock(TrainingListener):
        """The host clock at every window's end."""

        def __init__(self):
            self.stamps = []

        def on_epoch_start(self, model, epoch):
            self.stamps.append([])

        def iteration_done(self, model, iteration, score):
            self.stamps[-1].append(time.perf_counter())

    clock = WindowClock()
    perf = PerformanceListener(windows, report_etl=False,
                               print_fn=printed.append)
    net.set_listeners(ScoreIterationListener(windows, printed.append),
                      scores, perf, events, Snapshot(), clock)
    cfg = es.EarlyStoppingConfiguration(
        score_calculator=es.DataSetLossCalculator(
            ListDataSetIterator(DataSet(hx, hy), batch=b)),
        model_saver=es.LocalFileModelSaver(os.path.join(tmp, "es")),
        epoch_termination_conditions=[
            es.MaxEpochsTerminationCondition(ES_EPOCHS),
            es.ScoreImprovementEpochTerminationCondition(
                max_epochs_without_improvement=ES_EPOCHS)],
        iteration_termination_conditions=[
            es.InvalidScoreIterationTerminationCondition()])
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    result = es.EarlyStoppingTrainer(cfg, net, train_it()).fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    per_epoch = ["on_fit_start", "on_epoch_start"] + \
        ["iteration_done"] * windows + ["on_epoch_end", "on_fit_end"]
    if events.events != per_epoch * ES_EPOCHS:
        raise AssertionError(f"es-charrnn: events {events.events[:5]} ... "
                             f"({len(events.events)}), want "
                             f"{ES_EPOCHS} x {len(per_epoch)}")
    if (result.termination_reason, result.termination_details) != (
            "EpochTerminationCondition", "MaxEpochsTerminationCondition") \
            or result.total_epochs != ES_EPOCHS:
        raise AssertionError(f"es-charrnn: stopped by "
                             f"{result.termination_reason} / "
                             f"{result.termination_details} after "
                             f"{result.total_epochs} epochs")
    n_win = ES_EPOCHS * windows
    want = {k: 0 for k in launches}
    want.update({"lstm_scan": 2 * n_win + 2 * ES_EPOCHS,
                 "lstm_scan_bwd": 2 * n_win,
                 "linear_xent_fwd": n_win + ES_EPOCHS,
                 "linear_xent_bwd": n_win})
    if launches != want:
        raise AssertionError(f"es-charrnn: launches {launches}, want {want}")
    held = [result.score_vs_epoch[e] for e in range(ES_EPOCHS)]
    if not all(math.isfinite(s) for s in held) or not all(
            math.isfinite(s) for _, s in scores.scores):
        raise AssertionError(f"es-charrnn: held-out {held}")
    best = result.get_best_model()
    if best.device != net.device:
        raise AssertionError(f"es-charrnn: best model on {best.device}")
    want_best = snapshots[result.best_model_epoch]
    for k, v in best.params.items():
        for p, tv in v.items():
            if not torch.equal(tv, want_best[f"{k}/{p}"]):
                raise AssertionError(f"es-charrnn: get_best()'s {k}/{p} "
                                     f"is not epoch "
                                     f"{result.best_model_epoch}'s")
    log(f"[es-charrnn] TextGenerationLSTM (tBPTT {window}) by "
        f"EarlyStoppingTrainer: {ES_EPOCHS} epochs of {ES_BATCHES} batches "
        f"of {b} x {t} ({windows} windows each), stopped by "
        f"{result.termination_details}; held-out loss per epoch "
        f"{', '.join(f'{s:.5f}' for s in held)}, best epoch "
        f"{result.best_model_epoch}; training score "
        f"{scores.scores[0][1]:.5f} -> {scores.scores[-1][1]:.5f}; events "
        f"{ES_EPOCHS} x (on_fit_start, on_epoch_start, {windows} x "
        f"iteration_done, on_epoch_end, on_fit_end); launches {want}")
    gaps = sorted(b_ - a for st in clock.stamps for a, b_ in zip(st, st[1:]))
    window_ms = gaps[len(gaps) // 2] * 1e3
    log(f"[es-charrnn] median window {window_ms:.3f} ms (between listener "
        f"calls within an epoch), {b * window / window_ms * 1e3:.1f} trained "
        f"characters/s; {wall:.2f} s in all = {wall / n_win * 1e3:.3f} ms per "
        f"window with the held-out scores, best-model saves and restore; "
        f"get_best() onto the card = epoch {result.best_model_epoch}'s "
        f"params bit for bit; listeners printed {printed[:2]} ({card})")
    # the resume contract: 2 epochs, then a fresh network to 3 epochs
    mgr = CheckpointManager(os.path.join(tmp, "ckpt"), keep_last=5)
    first = rnn_net(torch, t, tbptt=window)
    first.fit(train_it(), epochs=2, checkpoint_manager=mgr)
    resumed = rnn_net(torch, t, tbptt=window)
    log_r = EventLog()
    resumed.set_listeners(log_r)
    reset_counts()
    t0 = time.perf_counter()
    resumed.fit(train_it(), epochs=3, checkpoint_manager=mgr)
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    resume_launches = read_counts()
    straight = rnn_net(torch, t, tbptt=window)
    straight.fit(train_it(), epochs=3)
    iters = log_r.events.count("iteration_done")
    if iters != windows or resumed.epoch != 3 or \
            resumed.iteration != 3 * windows:
        raise AssertionError(f"es-charrnn resume: {iters} windows trained, "
                             f"epoch {resumed.epoch}, iteration "
                             f"{resumed.iteration}")
    if resume_launches["lstm_scan_bwd"] != 2 * windows:
        raise AssertionError(f"es-charrnn resume: launches "
                             f"{resume_launches}")
    worst, exact = 0.0, True
    with torch.no_grad():
        for k, v in straight.params.items():
            for p, tv in v.items():
                got = resumed.params[k][p]
                exact = exact and torch.equal(got, tv)
                worst = max(worst, float((got - tv).abs().max()))
    if worst > 1e-6:
        raise AssertionError(f"es-charrnn resume: params differ from the "
                             f"unbroken 3-epoch fit by {worst:.3g}")
    steps = mgr.list_steps()
    bad = [s for s in steps if not mgr.verify(s)[0]]
    if steps != [windows * e for e in (1, 2, 3)] or bad:
        raise AssertionError(f"es-charrnn resume: checkpoints {steps}, "
                             f"failing verify {bad}")
    log(f"[es-charrnn] resume: fit(epochs=2, checkpoint_manager=m), then a "
        f"fresh network fit(epochs=3, checkpoint_manager=m) restored epoch 2 "
        f"and trained {iters} windows in {t_resume:.2f} s; its params equal "
        f"an unbroken 3-epoch fit "
        f"{'bit for bit' if exact else f'within {worst:.3g}'}"
        f"; checkpoints {steps} each pass verify ({card})")
    del net, first, resumed, straight, best
    torch.cuda.empty_cache()
    return {k: v + resume_launches[k] for k, v in launches.items()}


def transfer_net(torch, src):
    """The DL4J example EditLastLayerOthersFrozen on zoo VGG16 `src`:
    FineTuneConfiguration(Nesterovs(5e-5, 0.9), seed 7), the layers up to
    fc2 frozen, the Output replaced by Output(5, mcxent, softmax)."""
    from deeplearning4j_tpu_torch.models.transfer import (
        FineTuneConfiguration,
        TransferLearning,
    )
    from deeplearning4j_tpu_torch.nn import updaters
    from deeplearning4j_tpu_torch.nn.layers import Output

    fc2 = len(src.layers) - 2
    return (TransferLearning(src)
            .fine_tune_configuration(FineTuneConfiguration(
                updater=updaters.Nesterovs(
                    learning_rate=TRANSFER["lr"],
                    momentum=TRANSFER["momentum"]), seed=SEED))
            .set_feature_extractor(fc2)
            .remove_output_layer()
            .add_layer(Output(n_out=TRANSFER["classes"], loss="mcxent",
                              activation="softmax"))
            .build())


def phase_transfer_vgg16(torch, np, card, vgg_step_ms):
    """transfer-vgg16: zoo VGG16 (seed 7) fine-tuned with the layers up to
    fc2 frozen and a new 5-class Output, TRANSFER["steps"] steps at batch
    64 under the mixed policy on distinct seeded images: the frozen params
    bit-identical after the steps, the Output's moved, 1 + 1 xent per step
    and nothing else; TransferLearningHelper.featurize then fit_featurized
    over the same batches gives the same Output params (1e-5); predict
    equals the argmax of output. Returns the frozen fit's launches."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import (
        DataSet,
        ExistingDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.transfer import (
        TransferLearningHelper,
    )

    b, steps, classes = VGG_TRAIN[0], TRANSFER["steps"], TRANSFER["classes"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    batches = []
    for _ in range(steps):
        x = torch.randn((b, *VGG_SHAPE), generator=gen, device="cuda").to(
            torch.bfloat16)
        y = torch.nn.functional.one_hot(torch.randint(
            0, classes, (b,), generator=gen, device="cuda"), classes).float()
        batches.append(DataSet(x, y))
    t0 = time.perf_counter()
    src = vgg_net(torch)
    net = transfer_net(torch, src)
    del src
    frozen = [i for i, l in enumerate(net.layers)
              if getattr(l, "frozen", False)]
    head = f"layer_{len(net.layers) - 1}"
    log(f"[transfer-vgg16] VGG16 -> {len(frozen)} Frozen layers (0-"
        f"{frozen[-1]}) + Output({classes}) built on {net.device} in "
        f"{time.perf_counter() - t0:.2f} s; {net.num_params()} params")
    before = {f"layer_{i}": {p: v.clone()
                             for p, v in net.params[f"layer_{i}"].items()}
              for i in frozen}
    head0 = {p: v.clone() for p, v in net.params[head].items()}
    helper_net = transfer_net(torch, vgg_net(torch))
    dtypes.set_mixed_precision(True)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        reset_counts()
        for ds in batches:
            runs += timed_fits(torch, net, ds, 1)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        helper = TransferLearningHelper(helper_net)
        t0 = time.perf_counter()
        feats = [helper.featurize(ds) for ds in batches]
        helper.fit_featurized(ExistingDataSetIterator(feats))
        torch.cuda.synchronize()
        t_helper = time.perf_counter() - t0
    finally:
        dtypes.set_mixed_precision(False)
    want = {k: steps * VGG_PER_STEP.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"transfer-vgg16: launches {launches}, want "
                             f"{want}")
    for k, ps in before.items():
        same_bits(ps, net.params[k], f"transfer-vgg16 frozen {k}")
        if any(v.requires_grad for v in net.params[k].values()):
            raise AssertionError(f"transfer-vgg16: {k} records gradients")
    with torch.no_grad():
        moved = max(float((net.params[head][p] - v).abs().max())
                    for p, v in head0.items())
        diff = max(float((helper_net.params[head][p] - v).abs().max())
                   for p, v in net.params[head].items())
    scores = [sc for _, sc in runs]
    if not moved > 0 or not all(math.isfinite(sc) for sc in scores):
        raise AssertionError(f"transfer-vgg16: Output moved {moved}, "
                             f"scores {scores}")
    if not diff <= 1e-5:
        raise AssertionError(f"transfer-vgg16: featurize + fit_featurized "
                             f"differs from the frozen fit by {diff:.3g}")
    x0 = batches[0].features.float()
    if not np.array_equal(net.predict(x0),
                          net.output(x0).float().argmax(-1).cpu().numpy()):
        raise AssertionError("transfer-vgg16: predict is not the argmax of "
                             "output")
    steady = sorted(t_ for t_, _ in runs[1:])
    step_ms = steady[len(steady) // 2] * 1e3
    log(f"[transfer-vgg16] {steps} mixed steps of {b} images (distinct "
        f"batches), scores {scores[0]:.5f} -> {scores[-1]:.5f}; the "
        f"{len(frozen)} Frozen layers' params bit-identical, the Output's "
        f"moved by up to {moved:.3g}; launches {want} (per step "
        f"{VGG_PER_STEP}); featurize + fit_featurized over the same batches "
        f"= the frozen fit's Output within {diff:.3g} (tol 1e-5), "
        f"{t_helper * 1e3:.1f} ms; predict = argmax of output")
    log(f"[transfer-vgg16] median step {step_ms:.3f} ms "
        f"({b / step_ms * 1e3:.1f} images/s) against train-vgg16's {vgg_step_ms:.3f} ms in this run "
        f"({vgg_step_ms / step_ms:.2f}x); peak device memory {peak:.3f} GiB "
        f"({card})")
    del net, helper_net, helper, feats, batches
    torch.cuda.empty_cache()
    return launches


def phase_refer_transfer(torch, np):
    """refer-transfer: the transferred VGG16 on the card (TF32 off,
    deterministic cuDNN), on the CPU and on the CPU in float64, 3
    Nesterovs steps at batch 4, each from the same point; refer-train-
    vgg16's gates (REFER_VGG_TOL)."""
    steps, b = TRANSFER["refer_steps"], TRANSFER["refer_batch"]
    rng = np.random.default_rng(SEED + 23)
    x = rng.standard_normal((b, *VGG_SHAPE)).astype(np.float32)
    y = np.eye(TRANSFER["classes"], dtype=np.float32)[rng.integers(
        0, TRANSFER["classes"], b)]
    nets = {"card": transfer_net(torch, vgg_net(torch)),
            "cpu": transfer_net(torch, vgg_net(torch, "cpu")),
            "f64": as_float64(transfer_net(torch, vgg_net(torch, "cpu")))}
    with deterministic_cudnn(torch):
        reset_counts()
        worst = refer_fit_steps(torch, np, "refer-transfer", nets, (x, y),
                                steps, REFER_VGG_TOL)
        launches = read_counts()
    want = {k: steps * VGG_PER_STEP.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"refer-transfer: launches {launches}, want "
                             f"{want}")
    log(f"[refer-transfer] {steps} steps at batch {b}, card vs CPU: worst "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (gates {REFER_VGG_TOL}); launches {want}")
    del nets
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import deeplearning4j_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.zoo import (
        ResNet50,
        TextGenerationLSTM,
        TransformerLM,
    )

    t_start = time.perf_counter()
    try:
        card = card_line()
        name = torch.cuda.get_device_name(0)
        bw, peak, peak_bf16, peak_tf32 = card_rates(name)
        log(f"[card] {card}; torch {torch.__version__} CUDA "
            f"{torch.version.cuda}; rates used for bounds: {bw / 1e12} TB/s,"
            f" {peak / 1e12} TFLOP/s float32, {peak_bf16 / 1e12} TFLOP/s "
            f"bfloat16 tensor, {peak_tf32 / 1e12} TFLOP/s TF32 tensor")
        phase_build()
        t0 = time.perf_counter()
        net = ResNet50(num_classes=1000, input_shape=(224, 224, 3),
                       seed=SEED).init()
        log(f"[serve] ResNet-50 ({net.num_params()} params) on "
            f"{net.device} in {time.perf_counter() - t0:.2f} s")
        times, max_err = phase_kernel(torch, bn_cases(net, BATCH), bw, peak)
        bn_b = RESNET_TRAIN[0]
        _, train_err = phase_kernel(torch, bn_cases(net, bn_b), bw, peak,
                                    batch=bn_b, dtypes=(torch.bfloat16,),
                                    what="training forward")
        max_err = max(max_err, train_err)
        flash, flash_err = phase_flash(torch, bw, peak, peak_bf16,
                                       peak_tf32)
        launches = phase_serve(torch, np, net, card)
        phase_reference(torch, np, net)
        del net
        t0 = time.perf_counter()
        lm = TransformerLM(**LM, seed=SEED).init()
        log(f"[serve-lm] TransformerLM {LM} ({lm.num_params()} params) on "
            f"{lm.device} in {time.perf_counter() - t0:.2f} s")
        lm_launches = phase_serve_lm(torch, np, lm, card)
        phase_reference_lm(torch, np, lm)
        del lm
        lstm, lstm_err = phase_lstm(torch, bw, peak, peak_tf32)
        t0 = time.perf_counter()
        rnn = TextGenerationLSTM(**RNN, seed=SEED).init()
        log(f"[serve-rnn] TextGenerationLSTM {RNN} ({rnn.num_params()} "
            f"params) on {rnn.device} in {time.perf_counter() - t0:.2f} s")
        rnn_launches = phase_serve_rnn(torch, np, rnn, card)
        phase_stream_rnn(torch, np, rnn, card)
        phase_reference_rnn(torch, np, rnn)
        del rnn
        flash_bwd, flash_bwd_err = phase_flash_bwd(torch, bw, peak,
                                                   peak_bf16, peak_tf32)
        xent_cases, xent_err = phase_xent(torch, bw, peak, peak_bf16,
                                          peak_tf32)
        xent = xent_cases[XENT_CASES[0]]
        # rows 9 and 10 at a window of train-rnn-tbptt and train-cg-rnn
        xent_window = xent_cases[(1600, 256, 77, "onehot", "float32")]
        train_launches = phase_train_lm(torch, np, card)
        phase_refer_train(torch, np)
        lstm_bwd, lstm_bwd_err = phase_lstm_bwd(torch, bw, peak, peak_tf32)
        phase_lstm_library_bf16(torch)
        rnn_train_launches = phase_train_rnn(torch, np, card)
        phase_train_rnn_tbptt(torch, np, card)
        long_launches = phase_train_rnn_long(torch, np, card)
        phase_refer_train_rnn(torch, np)
        _, resnet_first = phase_train_resnet(torch, np, card)
        phase_refer_train_resnet(torch, np)
        phase_train_lenet(torch, np, card)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "inception_v3.h5")
            iv3 = import_inception(path)
            iv3_times, iv3_err = phase_kernel(
                torch, bn_cases(iv3, BATCH), bw, peak, model="InceptionV3",
                tag="kernel-inception")
            max_err = max(max_err, iv3_err)
            iv3_launches = phase_serve(
                torch, np, iv3, card, bn_per_forward=INCEPTION_BN,
                rows=inception_images(np), tag="serve-inception")
            phase_refer_inception(torch, np, iv3, path)
            del iv3
        log(f"[refer-inception] the InceptionV3 phases (write, import, "
            f"kernel, serve, refer) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            char_rnn, restore_launches = phase_dl4j_charrnn(torch, np, tmp,
                                                            card)
            resume = phase_checkpoint_resume(torch, np, char_rnn, tmp, card)
            resume_launches = {k: v + resume[k]
                               for k, v in restore_launches.items()}
            del char_rnn
        fixture_launches = phase_dl4j_fixtures(torch, np)
        log(f"[dl4j-fixtures] the persistence phases (dl4j-write, "
            f"dl4j-charrnn, checkpoint-resume, dl4j-fixtures) took "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        vgg_xent, vgg_err = phase_xent(torch, bw, peak, peak_bf16, peak_tf32,
                                       cases=VGG_XENT_CASES, tag="kernel-vgg")
        xent_err = max(xent_err, vgg_err)
        vgg_launches, vgg_first, vgg_step_ms = phase_train_vgg16(torch, np,
                                                                 card)
        phase_refer_train_vgg16(torch, np)
        log(f"[refer-train-vgg16] the VGG16 phases (kernel-vgg, "
            f"train-vgg16, refer-train-vgg16) took "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        from deeplearning4j_tpu_torch.parallel import init_process_group

        with tempfile.TemporaryDirectory() as tmp:
            init_process_group(f"file://{tmp}/rdv", 0, 1)  # NCCL, the card
            try:
                dp_launches = phase_dp(
                    torch, np, card, "dp-vgg16", vgg_net(torch),
                    image_batch(torch, SEED + 11, VGG_TRAIN[0], VGG_SHAPE),
                    VGG_PER_STEP, vgg_first, VGG_TRAIN)
                torch.cuda.empty_cache()
                resnet_dp = phase_dp(
                    torch, np, card, "dp-resnet", resnet_net(torch),
                    image_batch(torch, SEED + 9, RESNET_TRAIN[0],
                                RESNET_SHAPE),
                    RESNET_PER_STEP, resnet_first, RESNET_TRAIN)
                torch.cuda.empty_cache()
            finally:
                torch.distributed.destroy_process_group()
        dp_launches = {k: v + resnet_dp[k] for k, v in dp_launches.items()}
        phase_refer_dp(torch, np)
        log(f"[refer-dp] the data-parallel phases (dp-vgg16, dp-resnet, "
            f"refer-dp) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bidir_rows, bidir_err = phase_kernel_bidir(torch, bw, peak,
                                                   peak_tf32)
        lstm_err = max(lstm_err, bidir_err["lstm_scan"])
        lstm_bwd_err = {k: max(v, bidir_err[k])
                        for k, v in lstm_bwd_err.items()}
        bidir_xent, bidir_xent_err = phase_xent(
            torch, bw, peak, peak_bf16, peak_tf32, cases=BIDIR_XENT_CASES,
            tag="kernel-bidir")
        bidir_xent = bidir_xent[BIDIR_XENT_CASES[0]]
        xent_err = max(xent_err, bidir_xent_err)
        cg_launches, cg_net, cg_batch = phase_train_cg_rnn(torch, np, card)
        bidir_launches = phase_train_bidir(torch, np, card)
        phase_refer_train_cg(torch, np)
        log(f"[refer-train-cg] the graph recurrent phases (kernel-bidir, "
            f"train-cg-rnn, train-bidir, refer-train-cg) took "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        eval_cg = phase_eval_cg_rnn(torch, np, cg_net, cg_batch, card)
        del cg_net
        eval_launches = phase_eval_resnet(torch, np, card)
        eval_launches = {k: v + eval_cg[k] for k, v in eval_launches.items()}
        with tempfile.TemporaryDirectory() as tmp:
            es_launches = phase_es_charrnn(torch, np, tmp, card)
        transfer_xent, transfer_err = phase_xent(
            torch, bw, peak, peak_bf16, peak_tf32, cases=TRANSFER_XENT_CASES,
            tag="kernel-transfer")
        xent_err = max(xent_err, transfer_err)
        transfer_launches = phase_transfer_vgg16(torch, np, card, vgg_step_ms)
        phase_refer_transfer(torch, np)
        log(f"[refer-transfer] the evaluation, early-stopping and transfer "
            f"phases (eval-cg-rnn, eval-resnet, es-charrnn, kernel-transfer, "
            f"transfer-vgg16, refer-transfer) took "
            f"{time.perf_counter() - t0:.1f} s")
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "deeplearning4j_tpu"))
        if leaked:
            raise AssertionError(f"imported {leaked[:5]}")
    except Exception:
        traceback.print_exc()
        return 1

    # float32 times per forward of each kernel's own path: bn_act's 53
    # calls of a ResNet-50 forward at batch 32 (its launches count
    # InceptionV3's serving too; that forward's 94 calls' times are under
    # "inception_v3_forward"), flash_attention's 6 calls
    # of a TransformerLM forward at batch 16, lstm_scan's 2 calls of a
    # TextGenerationLSTM forward at batch 64; per training step of the
    # TransformerLM at batch 16 x 512: 6 dq and 6 dk/dv launches, 1 xent
    # forward and 1 xent backward; per training step of the
    # TextGenerationLSTM: 2 lstm_scan_bwd at 64 x 64, 2 lstm_scan_chunked and
    # 2 lstm_scan_chunked_bwd at 8 x 4096
    def vgg_rows(name):
        # per launch at VGG16's Output, (64, 4096, 1000), both policies
        return {case[-1]: vgg_xent[case][name] for case in VGG_XENT_CASES}

    def transfer_rows(name):
        # per launch at the fine-tuned VGG16's Output, (64, 4096, 5)
        return {case[-1]: transfer_xent[case][name]
                for case in TRANSFER_XENT_CASES}

    def per_forward(row, calls):
        return {k: (v * calls if k.endswith("ms") and v is not None else v)
                for k, v in row.items()}

    rows = {
        "bn_act": (launches["bn_act"] + iv3_launches["bn_act"], max_err,
                   dict(times[torch.float32], bound_by="bytes",
                        inception_v3_forward=iv3_times[torch.float32])),
        "flash_attention": (lm_launches["flash_attention"], flash_err,
                            per_forward(flash, LM["n_layers"])),
        "lstm_scan": (rnn_launches["lstm_scan"], lstm_err,
                      dict(per_forward(lstm, 2),
                           bidir_shape=bidir_rows["lstm_scan"])),
        "flash_attention_bwd_dq": (
            train_launches["flash_attention_bwd_dq"], flash_bwd_err,
            per_forward(flash_bwd["dq"], LM["n_layers"])),
        "flash_attention_bwd_dkv": (
            train_launches["flash_attention_bwd_dkv"], flash_bwd_err,
            per_forward(flash_bwd["dkv"], LM["n_layers"])),
        "linear_xent_fwd": (train_launches["linear_xent_fwd"], xent_err,
                            dict(xent["fwd"], vgg16_output=vgg_rows("fwd"),
                                 tbptt_window=xent_window["fwd"],
                                 bidir_output=bidir_xent["fwd"],
                                 transfer_output=transfer_rows("fwd"))),
        "linear_xent_bwd": (train_launches["linear_xent_bwd"], xent_err,
                            dict(xent["bwd"], vgg16_output=vgg_rows("bwd"),
                                 tbptt_window=xent_window["bwd"],
                                 bidir_output=bidir_xent["bwd"],
                                 transfer_output=transfer_rows("bwd"))),
        "lstm_scan_bwd": (rnn_train_launches["lstm_scan_bwd"],
                          lstm_bwd_err["lstm_scan_bwd"],
                          dict(per_forward(lstm_bwd["lstm_scan_bwd"], 2),
                               bidir_shape=bidir_rows["lstm_scan_bwd"])),
        "lstm_scan_chunked": (long_launches["lstm_scan_chunked"],
                              lstm_bwd_err["lstm_scan_chunked"],
                              per_forward(lstm_bwd["lstm_scan_chunked"], 2)),
        "lstm_scan_chunked_bwd": (
            long_launches["lstm_scan_chunked_bwd"],
            lstm_bwd_err["lstm_scan_chunked_bwd"],
            per_forward(lstm_bwd["lstm_scan_chunked_bwd"], 2)),
    }
    kernels = []
    for kname, (route, source, replaces) in KERNELS.items():
        n, err, t = rows[kname]
        kernels.append({
            "name": kname, "route": route, "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            # per launch: rows 5 and 6 at train-bidir's (32, 1000, 256) on
            # the reverse half's mask; rows 9 and 10 at a tBPTT window
            # (1600, 256, 77) and at train-bidir's Output (32, 512, 77)
            **{k: t[k] for k in ("library_covers", "inception_v3_forward",
                                 "vgg16_output", "bidir_shape",
                                 "tbptt_window", "bidir_output",
                                 "transfer_output") if k in t},
            # launches on the char-RNN's DL4J restore and resume path
            # (dl4j-charrnn and checkpoint-resume)
            "dl4j_resume_launches": resume_launches[kname],
            # launches in train-vgg16's 20 mixed steps and in the dropout
            # fixtures' 3 + 3 card steps (dl4j-fixtures)
            "vgg16_launches": vgg_launches[kname],
            # launches in dp-vgg16's and dp-resnet's 20 + 20 mixed steps
            # through ParallelWrapper
            "dp_launches": dp_launches[kname],
            # launches in the trained checkpoint fixtures' 3 + 3 + 3 card
            # steps (dl4j-fixtures: the dropout ones and mln_bidir_lstm)
            "fixture_launches": fixture_launches[kname],
            # launches in train-cg-rnn's 20 tBPTT windows of the masked
            # graph and in train-bidir's 20 steps
            "cg_rnn_launches": cg_launches[kname],
            "bidir_launches": bidir_launches[kname],
            # launches in eval-resnet's and eval-cg-rnn's passes, in
            # es-charrnn's early-stopped run with its resumed epoch, and in
            # transfer-vgg16's 20 frozen-base steps
            "eval_launches": eval_launches[kname],
            "es_launches": es_launches[kname],
            "transfer_launches": transfer_launches[kname]})
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--dp-rank":
        sys.exit(dp_rank_main(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
