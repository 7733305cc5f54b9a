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
 46. solver-charrnn  the BASELINE char-RNN (TextGenerationLSTM, 77
              characters, two GravesLSTM(256)) at 64 x 64 by BPTT under
              each line-search solver: LBFGS, conjugate gradient and line
              gradient descent, 10 fit calls on one batch each (max 5
              line-search trials): every post-step score no higher than
              its pre-step score, the last below the first; launches
              exactly 2 value-and-gradient passes per iteration plus 1
              forward per trial (the trials counted); ms per iteration,
              trials per iteration.
 47. solver-lenet  zoo LeNet on the MNIST sample by conjugate gradient,
              10 batches of 64, one iteration each; the same checks.
 48. refer-solver  a char-RNN of GravesLSTM(32) at 8 x 16 by LBFGS and
              LeNet at batch 8 by conjugate gradient, card (TF32 off;
              LeNet's convolutions without cuDNN) against the CPU port, 3
              iterations each from the CPU's params and solver state:
              the accepted alpha equal, the params within 1e-5 of the
              largest.
 49. window-rnn  the char-RNN at 64 x 64 over 24 seeded batches, 2
              epochs, at DL4J_TPU_STEP_WINDOW 1, 8, and 8 with
              DL4J_TPU_DEVICE_PREFETCH=1, each from the seed's weights:
              scores, params and slots equal bit for bit, launches 2 + 2 +
              1 + 1 per step; median ms per step of each.
 50. window-resnet  ResNet-50 by ComputationGraph.fit, batch 64, mixed,
              12 batches for 2 epochs, at K = 1 and K = 4 under
              deterministic cuDNN: bit for bit, 53 bn_act per step; ms per
              step of each.
 51. sentry-charrnn  window-rnn's K = 8 run with a DivergenceSentry
              (policy rollback, a CheckpointManager that a
              CheckpointListener saves to at each window's end, no
              in-memory snapshot) and a NaN batch at position 3 of the
              second window: one divergence, one rollback through the
              checkpoint of iteration 8, the iterations the listeners see those pinned
              against JAX in tests/test_torch_sentry.py, the params finite;
              policy warn detects and carries on; a CheckpointListener
              every 5 iterations saves at the window ends, and the resume
              from one equals the unbroken run bit for bit.
 52. records-charrnn  2 shards of 32 CSV sequence files (77 one-hot
              columns and the next character's id, Zipf characters,
              lengths log-uniform in 64-1000, ordered by length) written
              to a temporary directory, read by CSVSequenceRecordReader ->
              SequenceRecordReaderDataSetIterator(batch 16) ->
              JointParallelDataSetIterator -> BucketSequenceIterator(128,
              256, 512, 1024) -> fit by masked BPTT at K = 4 with device
              prefetch: the lengths within the buckets, the windows flushed
              at each change of length, per bucket the padded batch's
              score within 1e-5 of the unpadded one's (TF32 off), the
              1024 bucket of 16 rows on the chunked kernels (rows 7, 8);
              parse seconds, live characters per second. Before the
              sentry phase, kernel-records holds rows 5-8 at this path's
              shapes, (16, 512, 256) and (16, 1024, 256) with right-padded
              masks, forward and backward, against the plain scan (float32,
              TF32 off, the tolerances of phase 15, kernel-lstm-bwd).
 53. records-lenet  2048 MNIST sample images written as P6 PPM files in
              10 class directories, read by ImageRecordReader(28, 28, 1)
              -> RecordReaderDataSetIterator(batch 64, label_index=-1,
              num_classes=10) (NHWC by its pre-processor) ->
              prefetch_to_device -> LeNet, one epoch: bit for bit fit on
              the same arrays; images per second from files and from
              arrays.
 54. layers-a8  each layer of ROADMAP A.8's first half (Deconv2D in both
              modes at k 2, 3, 4, stride 1, 2, pad 0, 1; SeparableConv2D
              with depth multiplier 2, "same", stride 2, dilation 2;
              Conv1D "same" at stride 2; pnorm pooling over a window of
              zeros; sum and 1-D pools; upsampling; zero padding;
              ElementWiseMultiplication), forward and gradients on the card
              (TF32 off, deterministic cuDNN) against the CPU port at
              small shapes, 1e-5 of the largest magnitude, NaN gradients
              at the same positions.
 55. keras-a8  two Keras files written with the port's HDF5 writer
              (Conv2D -> ZeroPadding2D -> SeparableConv2D -> UpSampling2D
              -> Conv2DTranspose; Conv1D -> MaxPooling1D -> UpSampling1D ->
              ZeroPadding1D) imported onto the card and the CPU, the card's
              served through InferenceServer (batch limit 8): every answer
              within 1e-5 of the CPU import (TF32 off).
 56. train-tinyyolo, serve-tinyyolo, refer-tinyyolo  zoo TinyYOLO (20
              classes, 416x416x3, 13x13 grid, 5 anchors) trained by fit at
              batch 16 with Adam on seeded images with 1-4 boxes each (10
              mixed, 5 TF32 steps; step ms, images/s), served through
              InferenceServer (batch limit 16; answers against net.output;
              decode with the threshold on the host and on the card, NMS on
              the host, ms per batch), then 3 steps at batch 4 card (TF32
              off, deterministic cuDNN) vs CPU, each from the same point.
              No TPU kernel runs here (leaky BatchNorm takes the plain
              epilogue).
 57. train-googlenet  zoo GoogLeNet (224x224x3, 1000 classes, dropout 0.4,
              two LRNs) at batch 64, 10 mixed and 5 TF32 steps; rows 9 and
              10 once each per step at (64, 1024, 1000).
 58. kernel-vit, train-vit  rows 2-4 non-causal at ViT's (256, 4, 64, 32)
              and rows 9-10 at (64, 1024, 1000) and (256, 128, 10) against
              their plain versions (kernel / plain / library / bound ms);
              zoo VisionTransformer (32x32x3, patch 4, d_model 128, 4
              heads, 4 blocks, 10 classes) at batch 256, 20 mixed and 5
              TF32 steps, per step 4 flash forward, 4 dq, 4 dk/dv, 1 + 1
              xent.
 59. train-facenet  zoo FaceNetNN4Small2 (96x96x3, 1000 classes, a
              128-wide embedding into CenterLossOutput) at batch 64, 10
              Adam steps under TF32; the centers of the batch's classes
              move and no other; then 3 steps card (TF32 off) vs CPU from
              the same point: score, changes, Adam slots and centers.
 60. serve-darknet19, serve-irv1  zoo Darknet19 and InceptionResNetV1 at
              224x224x3 behind InferenceServer (batch limit 32), softmax
              rows against net.output, then one TF32-off forward at 2 rows
              against the CPU port, every activation within 1e-4.
 61. pretrain-dbn  Hinton, Osindero & Teh's DBN on MNIST flattened to 784
              (the port's MnistDataSetIterator): RBMs 784-500-500-2000
              (binary, CD-1) pretrained by MultiLayerNetwork.pretrain_layer
              for 20 batches of 128 each (ms per batch per layer, the
              one-step reconstruction error lower after each pass, no TPU
              kernel), then an Output softmax/mcxent 2000 -> 10 fine-tuned
              by fit for 20 steps (ms per step, images/s; rows 9 and 10 once
              each per step at (128, 2000, 10)); memory_report(conf).
              training_bytes(128) beside the card's peak allocation in a
              fit step (reported); a fit step under nan_checks passes and
              one on a batch with a NaN pixel raises FloatingPointError.
 62. pretrain-sda  a stacked denoising autoencoder, AutoEncoders
              784-1000-500-250-30 at corruption 0.3, pretrained and
              fine-tuned as pretrain-dbn (each layer's loss lower at the
              end; rows 9 and 10 at (128, 30, 10)).
 63. pretrain-vae  DL4J's VariationalAutoEncoderExample (784 -> 256, 256 ->
              2 -> 256, 256, bernoulli, leakyrelu, RmsProp 1e-3) pretrained
              for 20 batches (-ELBO lower at the end), then
              reconstruction_probability of 1024 held-out images with 16
              samples each as an anomaly score (ms, scores/s; finite, at
              most 0, digits above uniform noise). No TPU kernel runs.
 64. refer-pretrain  card (TF32 off) vs CPU from the same point, the
              card's draws replayed on the CPU: 3 pretrain batches each of
              an AutoEncoder (784 -> 1000), RBMs 784 -> 500 (binary CD-1,
              gaussian-visible CD-2) and both VAEs (score, changes and
              slots; reconstruction probabilities with the same normals);
              one fit step of the fine-tuned DBN; check_gradients on
              float64 AutoEncoder, RBM and VAE networks on the card.
 65. kernel-a8b  rows 9 and 10 at (128, 2000, 10) and (128, 30, 10) (the
              latter's 120-byte rows take the unaligned copies), float32
              and bfloat16, against their plain versions (kernel / plain /
              library / bound ms).
 66. train-inception  (after refer-inception, on its network) bn_act at
              the InceptionV3 training batch of 32 in bfloat16 and rows 9
              and 10 at its Output (32, 2048, 1000) against their plain
              versions (kernel-inception), then ComputationGraph.fit on
              the imported InceptionV3: 20 mixed and 5 TF32 steps of 32
              seeded images, the loss from the file's training_config,
              94 + 1 + 1 launches per step, every BatchNorm's running mean
              moved (ms per step, images/s, peak memory).
 67. refer-train-inception  the file written at 107x107, 10 classes,
              imported on the card and the CPU, 3 Sgd steps at batch 4
              each from the same point (TF32 off, deterministic cuDNN),
              then step 1 again with TF32 on, which must fail the score
              gate (the control).
 68. kernel-tp  rows 2-4 at a model-split TransformerLM's local shape
              (16, 4, 512, 64) causal, float32 and bfloat16.
 69. tp-transformer  the full-width TransformerLM on two gloo ranks of
              the one card at MeshSpec(model=2) (chip_smoke.py --a9-rank),
              5 mixed steps beside this process's 5: scores, ms per step,
              collectives and bytes per step, 4 heads per rank.
 70. fsdp-vgg16  zoo VGG16 at train-vgg16's batch on two ranks at
              MeshSpec(fsdp=2): bytes of params and slots at rest against
              the replicated, peak memory, ms per step, the first score
              train-vgg16's.
 71. refer-tp-fsdp  four ranks at MeshSpec(fsdp=2, model=2), TF32 off,
              deterministic cuDNN: a small TransformerLM, VGG16 at 32x32
              and the char-RNN, each step from the same point against this
              process; the ranks bit-identical after every step.
 72. remat-transformer  the full-width TransformerLM under each remat
              policy, 3 float32 steps: peak memory, ms per step, scores
              against 'none'.
 73. compress  EncodingHandler over a seeded 2.4M-entry gradient tree for
              4 rounds on the card against the CPU port (no kernel).
 74. kernel-ring  rows 2-4 at a ring hop's shape (2, 8, 1024, 64), causal
              (the diagonal hop) and full (an earlier block), float32 and
              bfloat16.
 75. ring-attention  seq = 4 on four gloo ranks of the one card at
              (2, 8, 4096, 64) global, causal and full, float32 and
              bfloat16: each rank's ring (`parallel.ring.ring_attention`)
              against one process's rows 2-4 over the whole sequence,
              output and dq, dk, dv; launches per call r + 1 (causal) and
              4 (full); a skipped hop and dK/dV one rank off their owner
              rejected; ms per call against one process's.
 76. sp-transformer, pp-transformer  the full-width TransformerLM through
              ParallelWrapper on two gloo ranks at MeshSpec(seq=2) and at
              MeshSpec(pipe=2) with microbatches=4: 5 mixed and 3 float32
              steps each against this process's, step by step; launches
              per rank (the ring's r + 1 hops per block, a stage's blocks
              per microbatch, the Output on the last stage).
 77. sharded-lm  ShardedTransformerLM at the TransformerConfig defaults,
              8 x 2048 tokens: one process (a one-rank grid) 5 float32
              steps (ms, tokens/s, peak memory), four ranks at
              data=2 x seq=2 and model=2 x seq=2 and the MoE config at
              pipe=2 x expert=2, 3 steps each against one process; the
              grid's checkpoint restored here, logits compared.
 78. pi-resnet  zoo ResNet-50 behind parallel.ParallelInference (batch
              limit 32, the model's own card) in BATCHED then INSTANT mode
              with DL4J_TPU_SERVING unset, then BATCHED with it set (the
              serving runtime): concurrent requests of 1, 3, 8 and 32 rows
              and one whose trailing shape does not match (it fails alone),
              each answer against net.output at serve's tolerance; bn_act
              53 times per dispatched batch and no other kernel; images/s
              per mode over a stream of 48 32-row requests beside serve's
              InferenceServer figure.
 79. registry-fleet  one serving.ModelRegistry with a warm-manifest
              directory serving ResNet-50 from a checkpoint zip written
              by write_model, the full-width TransformerLM from a
              CheckpointManager directory through its latest pointer (a
              torn publication beside it refused with IOError) and
              zoo:LeNet by name, side by side, plus a second ResNet-50
              version (zoo:ResNet50) made stable with set_stable: every
              answer against its model's output; served rates side by
              side; a second registry warmed from the manifests alone
              (first-request latency against a cold replica's); two
              tenants at weights 3:1 and a third over its quota on one
              shared ResNet-50 server under backlog (served-row ratio,
              TenantQuotaError count); submit_with_retry through a server
              that sheds. bn_act 53 per ResNet-50 forward, flash_attention
              6 per TransformerLM forward, no other kernel.
 80. dcn-dp     refer-dp's three networks through ParallelWrapper on four
              gloo ranks of the one card at MeshSpec(dcn=2, data=2), TF32
              off: after every step the four ranks bit-identical (so each
              dcn row equals its data peer) and within refer-dp's 1e-5 of
              this process's fit; each rank launches refer-dp's kernels per
              step.
 81. router-canary  one serving.ModelRegistry behind one serving.Router:
              ResNet-50 v1 (seed 7, stable), v2 (seed 8) and v3 (seed 9) at
              batch limit 32 and the full-width TransformerLM. A rollout of
              v2 over the default stages (5, 25, 50, 100%, the version
              rules' windows shrunk through rule_kwargs) driven by
              requests of 1, 3, 8 and 32 rows and fake-clock evaluate()
              ticks until v2 is promoted, a 1-row TransformerLM request
              routed by name every 24 requests; every answer against the
              output of the version the counter split says answered it
              (the versions' rows must be apart by more than the
              tolerance); images/s and tokens/s through the Router; then a
              rollout of v3 under DL4J_TPU_CHAOS=canary_nan that rolls
              back within one tick with exactly one canary_rollback
              bundle (read back by load_bundle) while no stable answer
              changes; requests per version and stage, each version's
              p50 / p99 from dl4j_tpu_model_latency_seconds. bn_act 53
              per ResNet-50 forward, flash_attention 6 per TransformerLM
              forward, no other kernel.
 82. fleet-autoscale  serving.Autoscaler.for_model over ResNet-50 from a
              registry with a warm manifest (min 1, max 3 replicas sharing
              the network's weights, a TenancyController), attached to the
              Router: a load step from 1 to 16 closed-loop clients of 8-32
              rows scales out (replicas per tick, images/s before and
              after, each spawned replica's first request); one replica's
              dispatcher crashes under the load (its callers requeue onto
              survivors: the time from the crash to the last of them) and
              serving_dispatch@1 fails one batch typed; the load drops to
              one client and the pool scales in after the dwell; a
              tenant_burst tenant sheds only itself. Every answer against
              net.output; bn_act 53 per forward, no other kernel.
 83. telemetry-serve  serve's ResNet-50 stream at batch limit 32 with
              DL4J_TPU_TELEMETRY off, then on (images/s of each); the
              chrome trace written, loaded back and holding one
              serving.dispatch_batch span per dispatched batch;
              dl4j_tpu_serving_requests_total in the Prometheus text equal
              to the requests made; serving_nan opening the breaker, which
              writes exactly one serving_breaker bundle. bn_act 53 per
              forward.

The characters the training phases learn are drawn with Zipf frequencies,
so that a falling loss shows learning; their shapes are bench.py
bench_lstm's.

Every kernel's launch count is set to 0 just before each serve phase, the
generation run, each training run (the data-parallel ones too), the
restore-and-resume runs, each evaluation pass and each solver, window,
sentry and records run, each serving or training run of A.8's paths,
each pretraining and fine-tuning run, each training run of A.3's rest
and A.9 and each ring call (in the ranks' processes too), each
ParallelInference mode, the registry's run and the dcn ranks' fits, and
each of router-canary, fleet-autoscale and telemetry-serve, and read just
after. The
last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.
Exits non-zero when no CUDA device is available, and when the port's
package is not beside this script.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
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
SERVE_RATES = {}           # images/s of each serve phase's stream, by tag
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


@contextlib.contextmanager
def without_cudnn(torch):
    """The CUDA convolutions without cuDNN inside the block."""
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


def card_device(torch):
    """The card the phases run on (a CPU rehearsal replaces it)."""
    return torch.device("cuda")


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


def phase_flash(torch, bw, peak, peak_bf16, peak_tf32, cases=FLASH_CASES,
                tag="kernel"):
    """flash_attention against its plain version at `cases`, float32 and
    bfloat16, with and without lse, and proof that the comparison rejects
    a broken output. Returns the first case's float32 row (per launch) and
    the largest absolute error of any case."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa_library

    from deeplearning4j_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the library yardstick computes in full float32 too
    torch.backends.cuda.matmul.allow_tf32 = False
    served, max_err, checked, rejected = None, 0.0, 0, 0
    for b, h, t, d, causal in cases:
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
                log(f"[{tag}] flash_attention {dname:8s} b={b:2d} h={h} "
                    f"t={t:3d} d={d:3d} {'causal' if causal else 'full  '} "
                    f"lse={int(lse)}  max_err={err:.3g} (tol "
                    f"{FLASH_TOL[dname]:g} x {mag:.3g})  lse_err="
                    f"{lse_err:.3g}  kernel={k_ms:.4f} ms  plain={p_ms:.4f} "
                    f"ms  library[scaled_dot_product_attention]={l_ms:.4f} "
                    f"ms  bound={b_ms:.4f} ms ({by}"
                    f"{', 3xTF32' if f32 else ''})")
                if (b, h, t, d, causal) == cases[0] and not lse \
                        and f32:
                    served = {"ms": k_ms, "plain_ms": p_ms,
                              "library_ms": l_ms, "bound_ms": b_ms,
                              "bound_by": by}
            del qkv
    log(f"[{tag}] verdict: flash_attention agrees with its plain version "
        f"in {checked}/{checked} (shape, dtype, lse) cases, max abs error "
        f"{max_err:.3g} (tol float32 1e-5, bfloat16 2e-2, x max|o|; lse "
        f"1e-5 x max(1, |lse|)); {rejected} broken outputs rejected (a "
        f"zeroed o in every case, an o not divided by l and an lse without "
        f"log(l) in every case with t > 1)")
    return served, max_err


# ---------------------------------------------------------------- phase 3
def phase_serve(torch, np, net, card, rows=None, tag="serve", limit=BATCH,
                per_batch=None, rel_tol=None, softmax=True, n_stream=96):
    """`net` behind InferenceServer(batch_limit=limit): warmed up,
    concurrent requests of 1, 3, 8 and `limit` rows, then a stream of
    `n_stream` `limit`-row requests from 4 threads. `rows(rng, n)` makes n
    input rows (standard normal at the graph's input type by default).
    Each dispatched batch must launch `per_batch` (kernel -> launches;
    default bn_act's 53 of a ResNet-50 forward, which must be the
    network's own count of bn_act calls). Every answer is finite, of
    net.output's shape, and within 2e-3 of net.output on the same rows
    with the same argmax or, with `rel_tol`, within `rel_tol` of its
    largest magnitude (TF32 convolutions: cuDNN may pick another
    algorithm for the padded bucket than for n rows alone); with
    `softmax`, its rows sum to 1. Returns (launches, [(x, answer)] of the
    first requests)."""
    from deeplearning4j_tpu_torch.serving import InferenceServer

    rng = np.random.default_rng(SEED)
    direct = net.output
    forwards = [0]

    def counted_output(x):
        forwards[0] += 1
        return direct(x)

    net.output = counted_output  # counts the server's dispatched batches
    if per_batch is None:
        per_batch = {"bn_act": 53}
    sizes = (1, 3, 8, limit)
    if rows is None:
        t_in = net.conf.input_types[0]
        shape = (t_in.height, t_in.width, t_in.channels)

        def rows(rng, n):
            return rng.standard_normal((n, *shape)).astype(np.float32)
    xs = [rows(rng, n) for n in sizes]
    stream = [rows(rng, limit) for _ in range(4)]

    def timed(x):
        t0 = time.perf_counter()
        out = server.output(x)
        return out, time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    server = InferenceServer(model=net, batch_limit=limit)
    try:
        server.warmup(xs[0])
        torch.cuda.synchronize()
        log(f"[{tag}] warmup of buckets {server.buckets.sizes} took "
            f"{time.perf_counter() - t0:.2f} s")
        with ThreadPoolExecutor(len(sizes)) as pool:
            first = list(pool.map(timed, xs))
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            streamed = list(pool.map(timed, [stream[i % len(stream)]
                                             for i in range(n_stream)]))
        wall = time.perf_counter() - t1
    finally:
        server.shutdown()
        net.output = direct
    launches = read_counts()
    log(f"[{tag}] {forwards[0]} batches dispatched (warmup included), "
        f"launches {launches} ({per_batch} per forward)")
    if "bn_act" in per_batch:
        own = sum(n for *_, n in bn_cases(net, 1))
        if own != per_batch["bn_act"]:
            raise AssertionError(f"{tag}: the network makes {own} bn_act "
                                 f"calls per forward, not "
                                 f"{per_batch['bn_act']}")
    if forwards[0] == 0:
        raise AssertionError(f"{tag}: no batch dispatched")
    expect_launches(tag, launches, {k: v * forwards[0]
                                    for k, v in per_batch.items()})

    for x, (out, lat) in zip(xs, first):
        n = x.shape[0]
        ref = direct(x).cpu().numpy()
        if out.shape != ref.shape or not np.isfinite(out).all():
            raise AssertionError(f"{tag}: request of {n} rows: bad output "
                                 f"{out.shape}, net.output {ref.shape}")
        if softmax and np.abs(out.sum(axis=1) - 1.0).max() > 1e-4:
            raise AssertionError(f"{tag}: request of {n} rows: softmax "
                                 f"rows do not sum to 1")
        diff = float(np.abs(out - ref).max())
        if rel_tol is None:
            what = f"max |server - net.output| = {diff:.3g}"
            bad = diff > 2e-3 or (out.argmax(1) != ref.argmax(1)).any()
        else:
            rel = diff / max(float(np.abs(ref).max()), 1e-30)
            what = (f"|server - net.output| {rel:.3g} of its largest (tol "
                    f"{rel_tol:g})")
            bad = not rel <= rel_tol
        if bad:
            raise AssertionError(f"{tag}: request of {n} rows: server and "
                                 f"net.output differ: {what}")
        log(f"[{tag}] request rows={n:2d} latency={lat * 1e3:.2f} ms  "
            f"{what}  ({card})")
    lats = sorted(lat for _, lat in streamed)
    for out, _ in streamed:
        if out.shape[0] != limit or not np.isfinite(out).all():
            raise AssertionError(f"{tag}: streamed request: bad output")
    img_s = n_stream * limit / wall
    SERVE_RATES[tag] = img_s
    log(f"[{tag}] stream: {n_stream} requests x {limit} rows in "
        f"{wall:.3f} s = {img_s:.1f} img/s, latency p50 "
        f"{lats[len(lats) // 2] * 1e3:.2f} ms, max {lats[-1] * 1e3:.2f} ms "
        f"({card})")
    return launches, [(x, out) for x, (out, _) in zip(xs, first)]


# ---------------------------------------------------------------- phase 4
def phase_reference(torch, np, net, cpu_net=None, x=None, tag="refer"):
    """`net` on the card with TF32 off against `cpu_net` (default: the same
    graph config and seed on the CPU) at every activation of feed_forward,
    on `x` (default: 2 standard normal rows of the graph's input type)."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.models import ComputationGraph

    if cpu_net is None:
        # same config, same seed: the same weights, drawn on the CPU
        cpu_net = ComputationGraph(net.conf).init(device="cpu")
    if x is None:
        t_in = net.conf.input_types[0]
        x = np.random.default_rng(SEED + 1).standard_normal(
            (2, t_in.height, t_in.width, t_in.channels)).astype(np.float32)
    with dtypes.full_precision():
        gpu_acts = net.feed_forward(x)
    cpu_acts = cpu_net.feed_forward(x)
    names = ["in"] + getattr(net, "topo", list(range(len(cpu_acts) - 1)))
    worst = 0.0
    for name, a, b in zip(names, gpu_acts, cpu_acts):
        a, b = a.float().cpu().numpy(), b.numpy()
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        worst = max(worst, rel)
        # float32 sums in another order on each device, over 50-100 layers
        if a.shape != b.shape or not rel <= 1e-4:
            raise AssertionError(f"{tag}: activation {name}: card and CPU "
                                 f"differ, relative {rel:.3g}")
    tf32 = net.output(x).cpu().numpy()
    log(f"[{tag}] {len(cpu_acts)} activations at {x.shape[0]} rows, card "
        f"(TF32 off) vs CPU: worst relative difference {worst:.3g} (tol "
        f"1e-4); output with TF32 on vs CPU: max "
        f"{float(np.abs(tf32 - cpu_acts[-1].numpy()).max()):.3g}")


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


def phase_flash_bwd(torch, bw, peak, peak_bf16, peak_tf32,
                    cases=FLASH_BWD_CASES, tag="kernel-flash-bwd"):
    """dq and dk/dv kernels against their plain formulas at `cases`,
    float32 and bfloat16. Returns the first case's float32 rows (per
    launch) and the largest absolute error of any case."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa_library

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    served, max_err, checked = {}, 0.0, 0
    for b, h, t, d, causal in cases:
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
                        f"{tag} cannot tell {name} "
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
                log(f"[{tag}] {name:3s} {dname:8s} b={b:2d} h={h} "
                    f"t={t:3d} d={d:3d} {'causal' if causal else 'full  '}  "
                    f"max_err={max(errs[n] for n in (['dq'] if name == 'dq' else ['dk', 'dv'])):.3g} "
                    f"(tol {tol:g} x max|plain|)  "
                    f"kernel={ms:.4f} ms  plain={pl_ms:.4f} ms  "
                    f"bound={b_ms:.4f} ms ({by}{', 3xTF32' if f32 else ''})"
                    f"{core}")
            log(f"[{tag}] dq + dkv {dname:8s} kernels together "
                f"{k_dq + k_dkv:.4f} ms  library[sdpa backward, dq+dk+dv]="
                f"{l_ms:.4f} ms")
            if (b, h, t, d, causal) == cases[0] and \
                    dtype == torch.float32:
                served = rows
            del sets
    log(f"[{tag}] verdict: dq and dk/dv agree with their plain "
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
    dev = card_device(torch)
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
    check_refer("refer-train-resnet", per_step)
    del nets


def check_refer(tag, per_step, tol=REFER_RESNET_TOL):
    """Fails when a step's measure is not finite or exceeds its `tol`
    (REFER_RESNET_TOL)."""
    bad = [(i + 1, k, v) for i, errs in enumerate(per_step)
           for k, v in errs.items() if not (math.isfinite(v) and v <= tol[k])]
    if bad:
        raise AssertionError(f"{tag}: card and CPU differ: {bad}")


def refer_resnet_steps(torch, np, nets, x, y, steps,
                       tag="refer-train-resnet", tol=REFER_RESNET_TOL,
                       precision=None):
    """refer-train-resnet's steps (logged under `tag` beside `tol`), each
    from the same point, under `precision` (a context; default TF32 off);
    returns each step's measures (a network without updater slots, as
    under Sgd, measures them as 0)."""
    from deeplearning4j_tpu_torch import dtypes, interop
    from deeplearning4j_tpu_torch.datasets import DataSet

    per_step = []
    reset_counts()
    for step in range(steps):
        start = nets["cpu"].get_param_table()
        with (precision or dtypes.full_precision)():
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
            "slot": max((norm_rel(slots["card"][k], v)
                         for k, v in slots["cpu"].items()), default=0.0),
            "bn": max(leaf_rel(nets["card"].state[name][s].cpu().numpy(),
                               v.numpy())
                      for name, st in nets["cpu"].state.items()
                      for s, v in st.items()),
        }
        worst = sorted(change, key=change.get)[-2:]
        median = sorted(change.values())[len(change) // 2]
        elementwise = max(leaf_rel(moved["card"][key], w)
                          for key, w in moved["cpu"].items())
        log(f"[{tag}] step {step + 1}: scores "
            f"{nets['card'].score_:.7f} (card) {nets['cpu'].score_:.7f} "
            f"(CPU); " + ", ".join(f"{k} {v:.3g} (tol "
                                   f"{tol[k]:g})"
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
    """Stands in for a network's draws (`nn.dropout.Draws`). A recording
    tape passes every call on to `inner` and keeps each mask and noise
    sample it hands out (dropout masks, weight noise, and in layerwise
    pretraining the corruption masks, the Gibbs chain's samples from a
    tensor of probabilities and the VAE's normals); a replaying tape hands
    the kept samples out again, in order, on its own device, and fails on
    a call that does not match the recorded one. So a CPU network trains
    with the card's masks."""

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
        # a tensor of probabilities (the RBM's Gibbs samples) is recorded
        # as "tensor": the replaying side computes its own p
        key = "tensor" if hasattr(p, "shape") else p
        return self._take(("bernoulli", key), shape,
                          lambda d: d.bernoulli(p, shape))

    def normal(self, shape, dtype):
        return self._take(("normal", str(dtype)), shape,
                          lambda d: d.normal(shape, dtype))

    def keep_rates(self):
        """(p, kept share) of each recorded mask."""
        return [(what[1], float(t.float().mean())) for what, t in self.tape
                if what[0] == "bernoulli" and what[1] != "tensor"]


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


def dp_refer_run(torch, np, rank=None, tmp=None, dcn=False):
    """Trains the refer-dp networks on the card, TF32 off and cuDNN
    deterministic: in this process by fit (`rank` None), or as `rank` of
    2 (MeshSpec(data=2)), or with `dcn` of 4 (MeshSpec(dcn=2, data=2)),
    through ParallelWrapper over gloo (rendezvous in `tmp`). Returns
    ({net: [snapshot per step]}, {net: launches}, {net: what the wrapper
    saw}): for a rank, the (global, local) rows of each batch it stepped
    on ("rows") and its collectives per axis ("coll"); {} in this
    process."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec,
        ParallelWrapper,
        init_process_group,
    )

    spec = MeshSpec(dcn=2, data=2) if dcn else MeshSpec(data=2)
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    if rank is not None:
        init_process_group(f"file://{tmp}/rdv", rank, spec.total(),
                           backend="gloo")
    try:
        data = dp_refer_data(np)
        out, launches, seen = {}, {}, {}
        for name, net in dp_refer_nets().items():
            snaps = Snapshots()
            net.set_listeners(snaps)
            fit, pw = net.fit, None
            if rank is not None:
                pw = ParallelWrapper(net, mesh_spec=spec)
                fit, rows = pw.fit, []
                local = pw._local

                def counted(ds, local=local, rows=rows):
                    got = local(ds)
                    rows.append((ds.num_examples(), got[0].num_examples()))
                    return got

                pw._local = counted
            reset_counts()
            with dtypes.full_precision():
                for ds in data[name]:
                    fit(ds)
            launches[name] = read_counts()
            out[name] = snaps.steps
            if pw is not None:
                seen[name] = {"rows": rows, "coll": pw.collective_stats()}
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
        if rank is not None:
            torch.distributed.destroy_process_group()
    return out, launches, seen


def dp_rank_main(rank: int, tmp: str, dcn: bool = False) -> int:
    """A refer-dp rank (this script run with --dp-rank RANK DIR) or a
    dcn-dp rank (--dcn-rank RANK DIR): trains and writes its snapshots
    and launches to DIR/rank{RANK}.npz."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    out, launches, seen = dp_refer_run(torch, np, rank, tmp, dcn=dcn)
    flat = {f"launches/{name}/{k}": v for name, counts in launches.items()
            for k, v in counts.items()}
    for name, s in seen.items():
        flat[f"rows/{name}"] = np.asarray(s["rows"], np.int64)
        flat.update({f"coll/{name}/{axis}": v["collectives"]
                     for axis, v in s["coll"].items()})
    for name, steps in out.items():
        for i, snap in enumerate(steps):
            flat.update({f"{name}/{i}/{k}": np.asarray(v)
                         for k, v in snap.items()})
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **flat)
    return 0


def dp_spawn_ranks(torch, np, tag, flag, world, single=None):
    """`world` ranks of this script (`flag` RANK DIR) trained on the one
    card, and (when `single` is None) this process's fit beside them.
    Returns (single, launches, [each rank's npz])."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, str(r), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]
        try:
            if single is None:
                single = dp_refer_run(torch, np)
            logs = [p.communicate(timeout=300)[0].decode() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"{tag}: rank {r} exited "
                                     f"{p.returncode}:\n{text[-4000:]}")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(world)]
    return single[0], single[1], ranks


def check_dp_ranks(np, tag, single, launches, ranks, what):
    """Every rank bit-identical to rank 0 after every step (tBPTT window),
    and the score, params, updater slots and running stats within
    DP_REFER_TOL of the single process (each leaf relative to its largest
    magnitude); every process launches DP_REFER_PER_STEP per step.
    Returns each rank's launches summed over the networks."""
    per_rank = [dict.fromkeys(launches[next(iter(launches))], 0)
                for _ in ranks]
    for name, steps in single.items():
        per = DP_REFER_PER_STEP[name]
        want = {k: len(steps) * per.get(k, 0) for k in launches[name]}
        got = [launches[name]] + [{k: int(r[f"launches/{name}/{k}"])
                                   for k in want} for r in ranks]
        if any(g != want for g in got):
            raise AssertionError(f"{tag} {name}: launches (single, then "
                                 f"each rank) {got}, want {want}")
        for i, g in enumerate(got[1:]):
            per_rank[i] = add_counts(per_rank[i], g)
        worst = {}
        for i, snap in enumerate(steps):
            for k, ref in snap.items():
                a = ranks[0][f"{name}/{i}/{k}"]
                for r, other in enumerate(ranks[1:], 1):
                    if not np.array_equal(a, other[f"{name}/{i}/{k}"]):
                        raise AssertionError(
                            f"{tag} {name}: rank {r} differs from rank 0 "
                            f"after step {i + 1} in {k}")
                kind = k.split("/")[0]
                err = (abs(float(a) - ref) / abs(ref) if kind == "score"
                       else leaf_rel(a, ref))
                worst[kind] = max(worst.get(kind, 0.0), err)
        log(f"[{tag}] {name}: {len(steps)} steps, {len(ranks)} ranks ("
            f"{what}) bit-identical after each; against one process, worst "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
            + f" (tol {DP_REFER_TOL:g}); launches per process {want}")
        bad = {k: v for k, v in worst.items()
               if not (math.isfinite(v) and v <= DP_REFER_TOL)}
        if bad:
            raise AssertionError(f"{tag} {name}: ranks and one process "
                                 f"differ: {bad}")
    return per_rank


def check_rank_rows(np, tag, ranks, single, data):
    """Each rank stepped on its share of every global batch, the rows over
    the data axis alone (a dcn peer takes the same count: nothing is split
    over dcn), and ran no collective on the dcn group and some on the data
    group."""
    for name in single:
        for r, z in enumerate(ranks):
            rows = z[f"rows/{name}"]
            want = [-(-g // data) for g in rows[:, 0]]
            if len(rows) == 0 or list(rows[:, 1]) != want:
                raise AssertionError(
                    f"{tag} {name}: rank {r} stepped on (global, local) "
                    f"rows {rows.tolist()}, want local {want}")
            dcn, dat = (int(z[f"coll/{name}/dcn"]),
                        int(z[f"coll/{name}/data"]))
            if dcn != 0 or dat <= 0:
                raise AssertionError(f"{tag} {name}: rank {r} ran {dcn} "
                                     f"collectives on dcn and {dat} on "
                                     f"data")
        log(f"[{tag}] {name}: each of {len(ranks)} ranks stepped on "
            f"{ranks[0][f'rows/{name}'][:, 1].tolist()} of "
            f"{ranks[0][f'rows/{name}'][:, 0].tolist()} rows; collectives "
            f"data {[int(z[f'coll/{name}/data']) for z in ranks]}, dcn "
            f"{[int(z[f'coll/{name}/dcn']) for z in ranks]}")


def phase_refer_dp(torch, np):
    """Two ranks of ParallelWrapper spawned on the one card over gloo
    against this process's fit on the same global batches and draws
    (`check_dp_ranks`). Returns the single process's (snapshots,
    launches)."""
    t0 = time.perf_counter()
    single, launches, ranks = dp_spawn_ranks(torch, np, "refer-dp",
                                             "--dp-rank", 2)
    check_dp_ranks(np, "refer-dp", single, launches, ranks,
                   "gloo, one card")
    check_rank_rows(np, "refer-dp", ranks, single, 2)
    log(f"[refer-dp] took {time.perf_counter() - t0:.1f} s")
    return single, launches


def phase_dcn_dp(torch, np, single):
    """refer-dp's networks on four ranks at MeshSpec(dcn=2, data=2) against
    `single` (refer-dp's one-process run): the dcn axis replicates the
    data-sharded step, so all four ranks end every step bit-identical
    (ranks 0 and 2, 1 and 3 are each other's dcn peers) and within
    DP_REFER_TOL of one process; each rank stepped on its data share of
    every batch and ran no collective on dcn (`check_rank_rows`). Returns
    each rank's launches."""
    t0 = time.perf_counter()
    snaps, launches, ranks = dp_spawn_ranks(torch, np, "dcn-dp",
                                            "--dcn-rank", 4, single=single)
    per_rank = check_dp_ranks(np, "dcn-dp", snaps, launches, ranks,
                              "MeshSpec(dcn=2, data=2), gloo, one card")
    check_rank_rows(np, "dcn-dp", ranks, snaps, 2)
    log(f"[dcn-dp] took {time.perf_counter() - t0:.1f} s")
    return per_rank


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


LSTM_ROWS = ("lstm_scan", "lstm_scan_bwd", "lstm_scan_chunked",
             "lstm_scan_chunked_bwd")


def lstm_rows_check(torch, s, where, worst):
    """Rows 5-8 on the inputs `s` (lstm_bwd_inputs' keys, the chunked
    forward's outputs in s["fwd"]) against their plain versions at
    LSTM_BWD_TOL: row 5's forward, row 6's backward on row 5's hs, row 7's
    forward, row 8's backward on row 7's checkpoints. Raises on a
    disagreement, raises `worst` (kernel -> largest abs error) to this
    case's errors, and returns (row 5's outputs, its plain outputs, row
    6's, row 8's)."""
    from deeplearning4j_tpu_torch.ops import lstm as lstm_ops

    names_fwd = ("hs", "hT", "cT", "hck", "cck")
    names_bwd = ("dzx", "dR", "dp", "dh0", "dc0")
    got5 = lstm_ops.lstm_scan_peephole(s["zx"], s["R"], s["p"], s["h0"],
                                       s["c0"], s["m"])
    ref5 = lstm_ops.lstm_scan_reference(s["zx"], s["R"], s["h0"], s["c0"],
                                        s["p"], s["m"])
    got6 = lstm_ops.lstm_scan_bwd(s["zx"], s["R"], s["h0"], s["c0"],
                                  got5[0], *s["g"], s["p"], s["m"])
    ref6 = lstm_ops.lstm_scan_backward_reference(
        s["zx"], s["R"], s["h0"], s["c0"], s["fwd"][0], *s["g"], s["p"],
        s["m"])
    got8 = lstm_ops.lstm_scan_chunked_bwd(
        s["zx"], s["R"], s["fwd"][3], s["fwd"][4], *s["g"], s["p"], s["m"])
    ref7 = lstm_ops.lstm_scan_chunked_reference(
        s["zx"], s["R"], s["h0"], s["c0"], s["p"], s["m"])
    ref8 = lstm_ops.lstm_scan_chunked_backward_reference(
        s["zx"], s["R"], s["fwd"][3], s["fwd"][4], *s["g"], s["p"], s["m"])
    torch.cuda.synchronize()
    for k, names, got, ref, kind in (
            ("lstm_scan", names_fwd[:3], got5, ref5, "fwd"),
            ("lstm_scan_bwd", names_bwd, got6, ref6, "bwd"),
            ("lstm_scan_chunked", names_fwd, s["fwd"], ref7, "fwd"),
            ("lstm_scan_chunked_bwd", names_bwd, got8, ref8, "bwd")):
        worst[k] = max(worst[k], lstm_bwd_check(k, names, got, ref, kind,
                                                where))
    return got5, ref5, got6, got8


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
    worst = dict.fromkeys(LSTM_ROWS, 0.0)
    rows = {}
    for b, t, n in BIDIR_KERNEL_CASES:
        s = flipped_lstm_inputs(torch, gen, b, t, n)
        where = f"b={b} t={t} n={n} leading dead steps float32"

        def row5(s=s):
            return lstm_ops.lstm_scan_peephole(s["zx"], s["R"], s["p"],
                                               s["h0"], s["c0"], s["m"])

        def row6(s=s):
            return lstm_ops.lstm_scan_bwd(s["zx"], s["R"], s["h0"], s["c0"],
                                          s["fwd"][0], *s["g"], s["p"],
                                          s["m"])

        def plain5(s=s):
            return lstm_ops.lstm_scan_reference(s["zx"], s["R"], s["h0"],
                                                s["c0"], s["p"], s["m"])

        def plain6(s=s):
            return lstm_ops.lstm_scan_backward_reference(
                s["zx"], s["R"], s["h0"], s["c0"], s["fwd"][0], *s["g"],
                s["p"], s["m"])

        got5, ref5, got6, got8 = lstm_rows_check(torch, s, where, worst)
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
        del got5, ref5, got6, got8, live
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


# ------------------------------------------------------------ phases 46-53
SOLVER_ITERS = 10
SOLVER_ALGOS = ("lbfgs", "conjugate_gradient", "line_gradient_descent")
SOLVER_LINE_SEARCH = 5       # max_num_line_search_iterations
WINDOW_BATCHES = 24          # window-rnn's seeded batches per epoch
WINDOW_K = 8
RESNET_WINDOW = (64, 12, 4)  # batch, batches per epoch, K
SENTRY_NAN_AT = 11           # position 3 of the second window of 8
RECORD_SHARDS, RECORD_FILES, RECORD_BATCH = 2, 32, 16
RECORD_BUCKETS = (128, 256, 512, 1024)
RECORD_LENGTHS = (64, 1000)  # log-uniform sequence lengths
RECORD_EPOCHS, RECORD_K = 2, 4
# rows 5-8 at the records path's batch of 16: a 512 bucket (rows 5, 6) and
# the 1024 bucket (rows 7, 8, in chunked_lstm_auto_regime; rows 5, 6 there
# too, which the unpadded batch of that bucket runs in the score check)
RECORD_KERNEL_CASES = [(16, 512, 256), (16, 1024, 256)]
LENET_FILES = 2048
WINDOW_GATE = "DL4J_TPU_STEP_WINDOW"
PREFETCH_GATE = "DL4J_TPU_DEVICE_PREFETCH"


@contextlib.contextmanager
def env_vars(**values):
    """The environment variables set (None: unset) inside the block."""
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


def expect_launches(tag, launches, want):
    """Exactly `want` launches, 0 for every other kernel."""
    want = {k: want.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, want {want}")


def add_counts(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def median(values):
    v = sorted(values)
    return v[len(v) // 2]


def solver_net(torch, algo, conf, device):
    """A MultiLayerNetwork of `conf` trained by the line-search `algo`."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    conf.defaults.optimization_algo = algo
    conf.defaults.max_num_line_search_iterations = SOLVER_LINE_SEARCH
    return MultiLayerNetwork(conf).init(device=device)


def char_rnn_conf(t, n=None, vocab=None):
    """The zoo TextGenerationLSTM's config (BASELINE config #3), its
    GravesLSTM width cut to n when given."""
    from deeplearning4j_tpu_torch.zoo import TextGenerationLSTM

    conf = TextGenerationLSTM(num_classes=vocab or RNN["num_classes"],
                              max_length=t, seed=SEED).conf()
    if n:
        for layer in conf.layers[:2]:
            layer.n_out = n
    return conf


def solver_want(iters, trials, rnn):
    """A solver iteration's launches: 2 value-and-gradient passes (the
    pre-step and the post-step point) and 1 forward per line-search
    trial."""
    want = {"linear_xent_fwd": 2 * iters + trials,
            "linear_xent_bwd": 2 * iters}
    if rnn:
        want.update(lstm_scan=4 * iters + 2 * trials,
                    lstm_scan_bwd=4 * iters)
    return want


def solver_record(opt):
    """The last iteration of a ConvexOptimizer: pre-step and post-step
    score, alpha, line-search trials."""
    return {"score0": opt.last_score0, "score": opt.score,
            "alpha": opt.last_alpha, "trials": opt.last_trials}


def check_solver(tag, history):
    """Each post-step score no higher than its pre-step score; the last
    below the first pre-step score (`history`: one `solver_record` per
    iteration)."""
    for i, h in enumerate(history):
        if not (math.isfinite(h["score"]) and h["score"] <= h["score0"]):
            raise AssertionError(f"{tag}: iteration {i + 1} went from "
                                 f"{h['score0']} to {h['score']}")
    if not history[-1]["score"] < history[0]["score0"]:
        raise AssertionError(f"{tag}: {history[0]['score0']} -> "
                             f"{history[-1]['score']}")


def phase_solver_charrnn(torch, np, card):
    """solver-charrnn: the BASELINE char-RNN at 64 x 64 by BPTT, 10 fit
    calls on one batch under each line-search solver (LBFGS, then
    conjugate gradient, then line gradient descent, each from the seed's
    weights). Returns the three runs' launches."""
    from deeplearning4j_tpu_torch.datasets import DataSet

    dev = card_device(torch)
    b, t, vocab = RNN_BATCH, RNN["max_length"], RNN["num_classes"]
    x, y = char_batch(np, np.random.default_rng(SEED + 30), b, t, vocab)
    data = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    runs = []
    for algo in SOLVER_ALGOS:
        net = solver_net(torch, algo, char_rnn_conf(t), dev)
        times, hist = [], []
        torch.cuda.synchronize()
        reset_counts()
        for _ in range(SOLVER_ITERS):
            t0 = time.perf_counter()
            net.fit(data)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            hist.append(solver_record(net._solver.optimizer))
        launches = read_counts()
        trials = sum(h["trials"] for h in hist)
        tag = f"solver-charrnn ({algo})"
        check_solver(tag, hist)
        expect_launches(tag, launches, solver_want(SOLVER_ITERS, trials,
                                                   rnn=True))
        log(f"[solver-charrnn] {algo}: {SOLVER_ITERS} iterations on {b} x "
            f"{t} characters, score {hist[0]['score0']:.5f} -> "
            f"{hist[-1]['score']:.5f}; alphas "
            f"{', '.join(format(h['alpha'], 'g') for h in hist)}; "
            f"{trials / SOLVER_ITERS:.1f} line-search trials per iteration "
            f"({trials} host reads); median {median(times[1:]) * 1e3:.3f} "
            f"ms per iteration, first {times[0] * 1e3:.1f} ms ({card})")
        runs.append(launches)
        del net
    return add_counts(*runs)


def phase_solver_lenet(torch, np, card):
    """solver-lenet: zoo LeNet (BASELINE config #1) by conjugate gradient
    on the MNIST sample, 10 batches of 64, one iteration each. Returns the
    launches."""
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator
    from deeplearning4j_tpu_torch.zoo import LeNet

    dev = card_device(torch)
    b = LENET_TRAIN[0]
    net = solver_net(torch, "conjugate_gradient", LeNet(seed=SEED).conf(),
                     dev)
    data = MnistDataSetIterator(batch=b, num_examples=b * SOLVER_ITERS,
                                seed=SEED)
    stamps, hist = [], []

    class Clock:
        def iteration_done(self, model, iteration, score):
            stamps.append(time.perf_counter())
            hist.append(solver_record(model._solver.optimizer))

    net.set_listeners(Clock())
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    net.fit(data)
    torch.cuda.synchronize()
    launches = read_counts()
    trials = sum(h["trials"] for h in hist)
    check_solver("solver-lenet", hist)
    expect_launches("solver-lenet", launches,
                    solver_want(SOLVER_ITERS, trials, rnn=False))
    gaps = np.diff([t0] + stamps)
    log(f"[solver-lenet] conjugate_gradient: {SOLVER_ITERS} iterations on "
        f"batches of {b} MNIST images "
        f"({'synthetic sample' if data.synthetic else 'idx files'}), score "
        f"{hist[0]['score0']:.5f} -> {hist[-1]['score']:.5f}; "
        f"{trials / SOLVER_ITERS:.1f} trials per iteration; median "
        f"{median(gaps[1:]) * 1e3:.3f} ms per iteration (host batch copy "
        f"included) ({card})")
    return launches


def solver_state_to(torch, state, device):
    """A solver's state (CG's list, LBFGS's dict) on `device`."""
    if isinstance(state, dict):
        return {k: solver_state_to(torch, v, device)
                for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(solver_state_to(torch, v, device) for v in state)
    return state.to(device) if torch.is_tensor(state) else state


def phase_refer_solver(torch, np):
    """refer-solver: a small char-RNN (GravesLSTM(32), 8 x 16, LBFGS) and
    LeNet at batch 8 (conjugate gradient), the card (TF32 off) against the
    CPU port, 3 iterations, each started
    from the CPU's params and solver state: the accepted alpha equal,
    the params after the step within 1e-5 of the largest. A solver's step
    is the whole gradient (alpha 1, no learning rate), so the gradient is
    held to 1e-5: LeNet's images are seeded Gaussian noise (0.3 standard
    deviation, where conjugate gradient takes steps of 1, 0 and 1/16 from
    the seed's weights) rather than the MNIST sample, whose flat stripes
    tie in the max pooling, and its card side runs the CUDA convolutions
    without cuDNN: cuDNN's weight gradient of the first convolution (one
    input channel) reads 8.0e-4 of its largest from the CPU's with TF32
    off and deterministic algorithms, the convolutions without cuDNN
    6.2e-7 (on an H100 80GB HBM3)."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.zoo import LeNet

    dev = card_device(torch)
    x, y = char_batch(np, np.random.default_rng(SEED + 32), 8, 16,
                      RNN["num_classes"])
    rng = np.random.default_rng(SEED + 33)
    images = (0.3 * rng.standard_normal((8, 28, 28, 1))).astype(np.float32)
    digits = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    cases = (("char-RNN", "lbfgs", lambda: char_rnn_conf(16, n=32),
              (x, y)),
             ("LeNet", "conjugate_gradient", lambda: LeNet(seed=SEED).conf(),
              (images, digits)))
    for name, algo, conf, (fx, fy) in cases:
        card = solver_net(torch, algo, conf(), dev)
        cpu = solver_net(torch, algo, conf(), "cpu")
        worst, alphas = 0.0, []
        with dtypes.full_precision(), without_cudnn(torch):
            for i in range(3):
                card.set_param_table(cpu.get_param_table())
                if cpu._solver is not None:
                    card._solver.optimizer._solver_state = solver_state_to(
                        torch, cpu._solver.optimizer._solver_state, dev)
                cpu.fit(fx, fy)
                card.fit(fx, fy)
                torch.cuda.synchronize()
                a_card = card._solver.optimizer.last_alpha
                a_cpu = cpu._solver.optimizer.last_alpha
                alphas.append(a_cpu)
                if a_card != a_cpu:
                    raise AssertionError(f"refer-solver ({name}): iteration "
                                         f"{i + 1} alpha {a_card} on the "
                                         f"card, {a_cpu} on the CPU")
                got, want = card.get_param_table(), cpu.get_param_table()
                top = max(float(abs(v).max()) for v in want.values())
                err = max(float(abs(got[k] - want[k]).max())
                          for k in want) / top
                worst = max(worst, err)
                if err > 1e-5:
                    raise AssertionError(f"refer-solver ({name}): iteration "
                                         f"{i + 1} params {err:.3g} of the "
                                         f"largest from the CPU's")
        log(f"[refer-solver] {name} by {algo}: 3 iterations card (TF32 off) "
            f"vs CPU, each from the CPU's params and state: alphas "
            f"{alphas} equal; params within {worst:.3g} of the largest "
            f"(tol 1e-5)")


class StepClock:
    """The host clock per step: a stamp at each window's end (at each step
    without windows), each gap divided by the steps it covers; per
    epoch."""

    def __init__(self):
        self.epochs = []
        self._pending = 0

    def on_epoch_start(self, model, epoch):
        self.epochs.append([(time.perf_counter(), 0)])

    def iteration_done(self, model, iteration, score):
        self._pending += 1
        if not getattr(model, "_window_replay", False):
            self._mark()

    def on_window_end(self, model):
        self._mark()

    def _mark(self):
        self.epochs[-1].append((time.perf_counter(), self._pending))
        self._pending = 0

    def step_ms(self, epoch=-1):
        """The median over the epoch's windows of ms per step."""
        marks = self.epochs[epoch]
        return median([(b[0] - a[0]) * 1e3 / b[1]
                       for a, b in zip(marks, marks[1:]) if b[1]])


class WindowLog:
    """Each window's first and last iteration (exclusive)."""

    def __init__(self):
        self.windows = []

    def iteration_done(self, model, iteration, score):
        pass

    def on_window_start(self, model):
        self.windows.append([model.iteration, None])

    def on_window_end(self, model):
        self.windows[-1][1] = model.iteration


def net_bits(net):
    """A network's params and updater slots, as numpy arrays by name."""
    from deeplearning4j_tpu_torch import interop

    out = {f"param/{k}": v for k, v in net.get_param_table().items()}
    out.update((f"slot/{k}", v) for k, v in slot_items(
        interop.opt_state_to_jax(net)))
    for key, st in net.state.items():
        for name, t in st.items():
            out[f"state/{key}/{name}"] = t.detach().float().cpu().numpy()
    return out


def same_run(tag, a, b):
    """Bit for bit: the scores and every param, slot and state array."""
    if a["scores"] != b["scores"]:
        raise AssertionError(f"{tag}: scores differ")
    for k, v in a["bits"].items():
        if not (v == b["bits"][k]).all():
            raise AssertionError(f"{tag}: {k} differs")


def phase_window_rnn(torch, np, card):
    """window-rnn: the char-RNN at 64 x 64 by BPTT over 24 seeded batches,
    2 epochs, at K = 1, K = 8 and K = 8 with DL4J_TPU_DEVICE_PREFETCH=1,
    each from the seed's weights: bit for bit the same run. Returns the
    three runs' launches and the data."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize import CollectScoresListener

    dev = card_device(torch)
    b, t, vocab = RNN_BATCH, RNN["max_length"], RNN["num_classes"]
    x, y = char_batch(np, np.random.default_rng(SEED + 31),
                      b * WINDOW_BATCHES, t, vocab)
    runs, all_launches = {}, []
    for tag, k, prefetch in (("K=1", 1, None), (f"K={WINDOW_K}", WINDOW_K,
                                                None),
                             (f"K={WINDOW_K} + device prefetch", WINDOW_K,
                              1)):
        with env_vars(**{WINDOW_GATE: k, PREFETCH_GATE: prefetch}):
            net = rnn_net(torch, t, device=dev)
            col, clock, wins = CollectScoresListener(), StepClock(), WindowLog()
            net.set_listeners(col, clock, wins)
            torch.cuda.synchronize()
            reset_counts()
            net.fit(ListDataSetIterator(DataSet(x, y), batch=b), epochs=2)
            torch.cuda.synchronize()
            launches = read_counts()
        steps = 2 * WINDOW_BATCHES
        expect_launches(f"window-rnn ({tag})", launches,
                        {k_: steps * v for k_, v in RNN_PER_STEP.items()})
        if len(wins.windows) != (0 if k == 1 else 2 * WINDOW_BATCHES // k):
            raise AssertionError(f"window-rnn ({tag}): windows "
                                 f"{wins.windows}")
        runs[tag] = dict(scores=[s for _, s in col.scores],
                         bits=net_bits(net), ms=clock.step_ms())
        all_launches.append(launches)
        del net
    (ta, a), *rest = runs.items()
    for tb, b_ in rest:
        same_run(f"window-rnn ({tb} against {ta})", b_, a)
    log(f"[window-rnn] {2 * WINDOW_BATCHES} BPTT steps of {b} x {t} "
        f"characters at K=1, K={WINDOW_K} and K={WINDOW_K} with device "
        f"prefetch: scores, params and RmsProp slots equal bit for bit "
        f"(score {a['scores'][0]:.5f} -> {a['scores'][-1]:.5f}); launches "
        f"per step {RNN_PER_STEP} in each")
    log(f"[window-rnn] median ms per step in the second epoch: "
        + "; ".join(f"{tag} {r['ms']:.3f}" for tag, r in runs.items())
        + f" ({card})")
    return add_counts(*all_launches), (x, y)


def phase_window_resnet(torch, np, card):
    """window-resnet: ResNet-50 by ComputationGraph.fit, batch 64, mixed,
    12 batches for 2 epochs, at K = 1 and K = 4 under deterministic cuDNN:
    bit for bit the same run. Returns the two runs' launches."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import (
        DataSet,
        ExistingDataSetIterator,
    )
    from deeplearning4j_tpu_torch.optimize import CollectScoresListener

    dev = card_device(torch)
    b, n, k4 = RESNET_WINDOW
    batches = [DataSet(*image_batch(torch, SEED + 40 + i, b, RESNET_SHAPE))
               for i in range(n)]
    runs, all_launches = {}, []
    for k in (1, k4):
        tag = f"K={k}"
        with env_vars(**{WINDOW_GATE: k, PREFETCH_GATE: None}), \
                deterministic_cudnn(torch):
            net = resnet_net(torch, device=dev)
            col, clock = CollectScoresListener(), StepClock()
            net.set_listeners(col, clock)
            dtypes.set_mixed_precision(True)
            try:
                torch.cuda.synchronize()
                reset_counts()
                net.fit(ExistingDataSetIterator(batches), epochs=2)
                torch.cuda.synchronize()
                launches = read_counts()
            finally:
                dtypes.set_mixed_precision(False)
        expect_launches(f"window-resnet ({tag})", launches,
                        {k_: 2 * n * v for k_, v in RESNET_PER_STEP.items()})
        runs[tag] = dict(scores=[s for _, s in col.scores],
                         bits=net_bits(net), ms=clock.step_ms())
        all_launches.append(launches)
        del net
        torch.cuda.empty_cache()
    same_run("window-resnet", runs[f"K={k4}"], runs["K=1"])
    s = runs["K=1"]["scores"]
    log(f"[window-resnet] ResNet-50 fit, {2 * n} mixed steps of {b} images "
        f"at K=1 and K={k4} (deterministic cuDNN): scores, params, slots "
        f"and BatchNorm state equal bit for bit (score {s[0]:.5f} -> "
        f"{s[-1]:.5f}); {RESNET_PER_STEP} launches per step")
    log(f"[window-resnet] median ms per step in the second epoch: "
        + "; ".join(f"{tag} {r['ms']:.3f} ({b / r['ms'] * 1e3:.1f} images/s)"
                    for tag, r in runs.items()) + f" ({card})")
    return add_counts(*all_launches)


def nan_at(underlying, positions):
    """`underlying` with NaN features in the batches at `positions`
    (counted from 1), synchronous: the port's chaos fault points are not
    ported yet."""
    import numpy as np

    from deeplearning4j_tpu_torch.datasets import DataSet, DataSetIterator

    class NanAt(DataSetIterator):
        def __init__(self):
            self.count = 0

        def reset(self):
            underlying.reset()

        def __iter__(self):
            self.reset()
            return self

        def __next__(self):
            ds = next(underlying)
            self.count += 1
            if self.count in positions:
                ds = DataSet(np.full_like(np.asarray(ds.features), np.nan),
                             ds.labels, ds.features_mask, ds.labels_mask)
            return ds

        def async_supported(self):
            return False

    return NanAt()


def phase_sentry_charrnn(torch, np, tmp, card, data):
    """sentry-charrnn: window-rnn's K = 8 run over its 24 batches with
    DivergenceSentry(policy="rollback", checkpoint_manager=...,
    snapshot_every=0) beside a CheckpointListener saving to that manager
    every 8 iterations, and a NaN batch at position 3 of the second
    window: the sentry keeps no in-memory snapshot, so the trip restores
    the checkpoint of iteration 8 through the manager. Then
    policy="warn" on the same data; then a CheckpointListener every 5
    iterations under K = 8 and the resume from its save at 16. Returns
    the launches."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.optimize import CollectScoresListener
    from deeplearning4j_tpu_torch.resilience import (
        CheckpointListener,
        CheckpointManager,
        DivergenceSentry,
        tree_all_finite,
    )

    dev = card_device(torch)
    x, y = data
    b, t = RNN_BATCH, RNN["max_length"]
    runs = []
    with env_vars(**{WINDOW_GATE: WINDOW_K, PREFETCH_GATE: None}):
        for policy in ("rollback", "warn"):
            net = rnn_net(torch, t, device=dev)
            col = CollectScoresListener()
            if policy == "rollback":
                cm = CheckpointManager(os.path.join(tmp, "sentry-rollback"))
                sentry = DivergenceSentry(policy=policy, max_rollbacks=2,
                                          checkpoint_manager=cm,
                                          snapshot_every=0)
                net.set_listeners(col, CheckpointListener(
                    cm, save_every_n_iterations=WINDOW_K), sentry)
            else:
                sentry = DivergenceSentry(policy=policy)
                net.set_listeners(col, sentry)
            torch.cuda.synchronize()
            reset_counts()
            net.fit(nan_at(ListDataSetIterator(DataSet(x, y), batch=b),
                           (SENTRY_NAN_AT,)))
            torch.cuda.synchronize()
            launches = read_counts()
            runs.append(launches)
            expect_launches(f"sentry-charrnn ({policy})", launches,
                            {k: WINDOW_BATCHES * v
                             for k, v in RNN_PER_STEP.items()})
            its = [i for i, _ in col.scores]
            if policy == "rollback":
                want = (list(range(1, SENTRY_NAN_AT + 1))
                        + list(range(WINDOW_K + 1, 2 * WINDOW_K + 1)))
                saves = [m["step"] for m in cm.manifests()]
                ok = ((sentry.divergences, sentry.rollbacks) == (1, 1)
                      and sentry._snapshot is None
                      and saves == [WINDOW_K, 2 * WINDOW_K]
                      and its == want and net.iteration == 2 * WINDOW_K
                      and tree_all_finite(net.params)
                      and math.isfinite(net.score_))
                log(f"[sentry-charrnn] rollback at K={WINDOW_K}: NaN batch "
                    f"{SENTRY_NAN_AT}; divergences {sentry.divergences}, "
                    f"rollbacks {sentry.rollbacks}, restored from the "
                    f"checkpoint of iteration {WINDOW_K} (no snapshot "
                    f"kept); saves at {saves}; iterations seen {its}; "
                    f"final iteration {net.iteration}, params finite "
                    f"{tree_all_finite(net.params)}")
            else:
                ok = (sentry.divergences >= 1 and sentry.rollbacks == 0
                      and net.iteration == WINDOW_BATCHES)
                log(f"[sentry-charrnn] warn at K={WINDOW_K}: divergences "
                    f"{sentry.divergences}, rollbacks {sentry.rollbacks}, "
                    f"final iteration {net.iteration}")
            if not ok:
                raise AssertionError(f"sentry-charrnn ({policy}) failed")
            del net
        cm = CheckpointManager(os.path.join(tmp, "sentry-listener"))
        net = rnn_net(torch, t, device=dev)
        net.set_listeners(CheckpointListener(cm, save_every_n_iterations=5))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        net.fit(ListDataSetIterator(DataSet(x, y), batch=b))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = [m["step"] for m in cm.manifests()]
        if steps != [8, 16, 24]:
            raise AssertionError(f"sentry-charrnn: saves at {steps}, want "
                                 f"the window ends 8, 16, 24")
        resumed, manifest = cm.restore(16, device=dev)
        resumed.fit(ListDataSetIterator(DataSet(x[16 * b:], y[16 * b:]),
                                        batch=b))
        torch.cuda.synchronize()
        runs.append(read_counts())
        want, got = net_bits(net), net_bits(resumed)
        for k, v in want.items():
            if not (got[k] == v).all():
                raise AssertionError(f"sentry-charrnn: the resume from 16 "
                                     f"differs in {k}")
        log(f"[sentry-charrnn] CheckpointListener every 5 iterations at "
            f"K={WINDOW_K}: saves at {steps} (the window ends), "
            f"{wall:.2f} s for {WINDOW_BATCHES} steps with the saves; the "
            f"resume from 16 equals the unbroken run bit for bit ({card})")
    return add_counts(*runs)


def phase_kernel_records(torch):
    """kernel-records: rows 5-8 at the shapes records-charrnn gives them,
    RECORD_KERNEL_CASES, float32 (TF32 off), on lstm_bwd_inputs' masked
    inputs (right-padded rows, as a bucket pads them, one row wholly dead,
    one masked in the middle), forward and backward against their plain
    versions at LSTM_BWD_TOL. Returns {kernel: largest absolute error}."""
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        chunked_lstm_auto_regime,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = dict.fromkeys(LSTM_ROWS, 0.0)
    try:
        for b, t, n in RECORD_KERNEL_CASES:
            chunked = chunked_lstm_auto_regime(b, t, n, torch.float32)
            if chunked != (t == max(RECORD_BUCKETS)):
                raise AssertionError(f"kernel-records: ({b}, {t}, {n}) is "
                                     f"{'' if chunked else 'not '}in the "
                                     f"chunked regime")
            s = lstm_bwd_inputs(torch, gen, b, t, n, torch.float32, True,
                                True)
            case = dict.fromkeys(LSTM_ROWS, 0.0)
            lstm_rows_check(torch, s, f"b={b} t={t} n={n} right-padded "
                            f"mask float32", case)
            for k, v in case.items():
                worst[k] = max(worst[k], v)
            log(f"[kernel-records] rows 5-8 at ({b}, {t}, {n}) float32, "
                f"right-padded mask ({int(s['m'].sum())} live (row, step) "
                f"pairs of {b * t}; the path runs rows "
                f"{'7, 8' if chunked else '5, 6'} here), forward and "
                f"backward against the plain scan: max abs error row 5 "
                f"{case['lstm_scan']:.3g}, row 6 {case['lstm_scan_bwd']:.3g}, "
                f"row 7 {case['lstm_scan_chunked']:.3g}, row 8 "
                f"{case['lstm_scan_chunked_bwd']:.3g}")
            del s
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return worst


def write_char_shards(np, root):
    """RECORD_SHARDS directories of RECORD_FILES CSV sequence files: per
    line the 77-column one-hot character and the next character's id, Zipf
    characters, lengths log-uniform in RECORD_LENGTHS, each shard's files
    named in order of length."""
    vocab = RNN["num_classes"]
    rng = np.random.default_rng(SEED + 50)
    zipf = 1.0 / np.arange(1, vocab + 1)
    onehot = [",".join("1" if j == c else "0" for j in range(vocab))
              for c in range(vocab)]
    lo, hi = (math.log(v) for v in RECORD_LENGTHS)
    for s in range(RECORD_SHARDS):
        d = os.path.join(root, f"shard{s}")
        os.makedirs(d)
        lengths = sorted(int(math.exp(rng.uniform(lo, hi)))
                         for _ in range(RECORD_FILES))
        for i, t in enumerate(lengths):
            ids = rng.choice(vocab, size=t + 1, p=zipf / zipf.sum())
            with open(os.path.join(d, f"{i:03d}.csv"), "w") as f:
                f.write("\n".join(f"{onehot[a]},{n}"
                                  for a, n in zip(ids[:-1], ids[1:])))
                f.write("\n")


def char_pipeline(root):
    """The records pipeline: a CSVSequenceRecordReader per shard, each
    through SequenceRecordReaderDataSetIterator(batch 16), both joined by
    JointParallelDataSetIterator, bucketed by BucketSequenceIterator.
    Returns (joint, bucketed)."""
    from deeplearning4j_tpu_torch.datasets import (
        BucketSequenceIterator,
        CSVSequenceRecordReader,
        JointParallelDataSetIterator,
        SequenceRecordReaderDataSetIterator,
    )

    joint = JointParallelDataSetIterator(*[
        SequenceRecordReaderDataSetIterator(
            CSVSequenceRecordReader(os.path.join(root, f"shard{s}",
                                                 "*.csv")),
            batch=RECORD_BATCH, label_index=-1,
            num_classes=RNN["num_classes"])
        for s in range(RECORD_SHARDS)])
    return joint, BucketSequenceIterator(joint, buckets=RECORD_BUCKETS)


def phase_records_charrnn(torch, np, tmp, card):
    """records-charrnn: the char-RNN fed from CSV sequence files on disk,
    by masked BPTT at K = 4 with device prefetch (see char_pipeline).
    Returns the launches."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import (
        BucketSequenceIterator,
        ExistingDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        chunked_lstm_auto_regime,
    )

    dev = card_device(torch)
    root = os.path.join(tmp, "char_shards")
    t0 = time.perf_counter()
    write_char_shards(np, root)
    write_s = time.perf_counter() - t0
    joint, bucketed = char_pipeline(root)
    try:
        t0 = time.perf_counter()
        raw = list(joint)
        parse_s = time.perf_counter() - t0
        emitted = [ds.features.shape[1] for ds in bucketed]
        if not set(emitted) <= set(RECORD_BUCKETS) or len(emitted) != len(
                raw):
            raise AssertionError(f"records-charrnn: emitted lengths "
                                 f"{emitted}, buckets {RECORD_BUCKETS}")
        live = sum(float(ds.labels_mask.sum()) for ds in raw)
        seen = []
        bucketed.set_pre_processor(
            lambda ds: seen.append(ds.features.shape[1]) or ds)
        with env_vars(**{WINDOW_GATE: RECORD_K, PREFETCH_GATE: 1}):
            net = rnn_net(torch, max(RECORD_BUCKETS), device=dev)
        n = net.layers[0].n_out
        per_step = []
        for tb in emitted:
            chunked = chunked_lstm_auto_regime(RECORD_BATCH, tb, n,
                                               torch.float32)
            per_step.append(
                {"lstm_scan_chunked": 2, "lstm_scan_chunked_bwd": 2}
                if chunked else {"lstm_scan": 2, "lstm_scan_bwd": 2})
        want = {"linear_xent_fwd": RECORD_EPOCHS * len(emitted),
                "linear_xent_bwd": RECORD_EPOCHS * len(emitted)}
        for d in per_step:
            for k, v in d.items():
                want[k] = want.get(k, 0) + RECORD_EPOCHS * v
        with env_vars(**{WINDOW_GATE: RECORD_K, PREFETCH_GATE: 1}):
            wins, clock = WindowLog(), StepClock()
            net.set_listeners(wins, clock)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            net.fit(bucketed, epochs=RECORD_EPOCHS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
        expect_launches("records-charrnn", launches, want)
        if seen != emitted * RECORD_EPOCHS:
            raise AssertionError(f"records-charrnn: steps on lengths {seen}")
        for a, e in wins.windows:
            lens = seen[a:e]
            ends_epoch = e % len(emitted) == 0
            if (len(set(lens)) != 1 or len(lens) > RECORD_K
                    or (len(lens) < RECORD_K and not ends_epoch
                        and seen[e] == lens[0])):
                raise AssertionError(f"records-charrnn: window {a}-{e} on "
                                     f"lengths {lens} ({seen})")
        # per bucket, one batch's masked score against the unpadded one
        errs = {}
        with dtypes.full_precision():
            for ds in raw:
                tb = BucketSequenceIterator(
                    ExistingDataSetIterator([]),
                    buckets=RECORD_BUCKETS).bucket_for(ds.features.shape[1])
                if tb in errs:
                    continue
                padded = next(iter(BucketSequenceIterator(
                    ExistingDataSetIterator([ds]), buckets=RECORD_BUCKETS)))
                a, p = net.score(ds), net.score(padded)
                errs[tb] = abs(a - p) / abs(a)
        if max(errs.values()) > 1e-5:
            raise AssertionError(f"records-charrnn: padded against unpadded "
                                 f"scores {errs}")
    finally:
        joint.shutdown()
    log(f"[records-charrnn] {RECORD_SHARDS} x {RECORD_FILES} CSV sequence "
        f"files (lengths {RECORD_LENGTHS[0]}-{RECORD_LENGTHS[1]}, "
        f"log-uniform) written in {write_s:.2f} s; parsed into "
        f"{len(raw)} batches of {RECORD_BATCH} in {parse_s:.3f} s "
        f"({live:.0f} live characters); bucket lengths per epoch {emitted}; "
        f"windows {wins.windows}")
    log(f"[records-charrnn] masked BPTT at K={RECORD_K} with device "
        f"prefetch, {RECORD_EPOCHS} epochs in {wall:.3f} s: "
        f"{RECORD_EPOCHS * live / wall:.1f} live characters/s; the "
        f"parse alone {parse_s:.3f} s per epoch against "
        f"{wall / RECORD_EPOCHS:.3f} s per epoch of the fit, which parses "
        f"on the streams' producer threads; padded against unpadded score "
        f"per bucket (TF32 off) "
        + ", ".join(f"{k}: {v:.3g}" for k, v in sorted(errs.items()))
        + f" (tol 1e-5); launches {want} ({card})")
    return launches


def mnist_u8(np, n):
    """n MNIST sample images as uint8 [n, 28, 28] and their labels: the
    idx files under $DL4J_TPU_DATA_DIR where MnistDataSetIterator finds
    them, else its seeded synthetic sample."""
    from deeplearning4j_tpu_torch.datasets import fetchers

    img, lbl = fetchers.MnistDataSetIterator.FILES_TRAIN
    img_path, lbl_path = fetchers._find(img), fetchers._find(lbl)
    if img_path is None or lbl_path is None:
        return fetchers._synthetic_images(n, 28, 28, 10, SEED)
    return fetchers.read_idx(img_path)[:n], fetchers.read_idx(lbl_path)[:n]


def write_ppm(np, path, img):
    """uint8 [h, w] as a binary (P6) PPM, the gray repeated to 3
    channels."""
    img = np.repeat(np.asarray(img, np.uint8)[:, :, None], 3, axis=2)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def phase_records_lenet(torch, np, tmp, card):
    """records-lenet: 2048 MNIST sample images written as P6 PPM files in
    10 class directories, read by ImageRecordReader(28, 28, 1) through
    RecordReaderDataSetIterator(batch 64, label_index=-1, num_classes=10)
    (a pre-processor reshapes to NHWC) and prefetch_to_device into LeNet,
    one epoch; against fit on the same arrays. Returns the launches."""
    from deeplearning4j_tpu_torch.datasets import (
        DataSet,
        ImageRecordReader,
        ListDataSetIterator,
        RecordReaderDataSetIterator,
        prefetch_to_device,
    )
    from deeplearning4j_tpu_torch.zoo import LeNet

    dev = card_device(torch)
    u8, ids = mnist_u8(np, LENET_FILES)
    root = os.path.join(tmp, "mnist_ppm")
    index = {}
    t0 = time.perf_counter()
    for c in range(10):
        os.makedirs(os.path.join(root, str(c)))
    for i in range(len(u8)):
        path = os.path.join(root, str(int(ids[i])), f"{i:05d}.ppm")
        write_ppm(np, path, u8[i])
        index[path] = i
    write_s = time.perf_counter() - t0
    b = LENET_TRAIN[0]
    reader = ImageRecordReader(28, 28, 1, root=root)
    source = RecordReaderDataSetIterator(reader, batch=b, label_index=-1,
                                         num_classes=10)
    source.set_pre_processor(
        lambda ds: DataSet(ds.features.reshape(-1, 28, 28, 1), ds.labels))
    t0 = time.perf_counter()
    parsed = sum(ds.num_examples() for ds in source)
    parse_s = time.perf_counter() - t0
    order = [index[p] for p in reader.paths]
    x = (u8[order].astype(np.float32) / 255.0).reshape(-1, 28, 28, 1)
    y = np.eye(10, dtype=np.float32)[ids[order].astype(int)]
    with deterministic_cudnn(torch):
        # warm-up: the first step's cuDNN and allocator set-up is timed
        # in neither run
        LeNet(seed=SEED).init(device=dev).fit(x[:b], y[:b])
        files = LeNet(seed=SEED).init(device=dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for ds in prefetch_to_device(source, size=2, device=dev):
            files.fit(ds)
        torch.cuda.synchronize()
        files_s = time.perf_counter() - t0
        launches = read_counts()
        arrays = LeNet(seed=SEED).init(device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arrays.fit(ListDataSetIterator(DataSet(x, y), batch=b))
        torch.cuda.synchronize()
        arrays_s = time.perf_counter() - t0
    steps = -(-len(u8) // b)
    expect_launches("records-lenet", launches,
                    {k: steps * v for k, v in LENET_PER_STEP.items()})
    got, want = net_bits(files), net_bits(arrays)
    for k, v in want.items():
        if not (got[k] == v).all():
            raise AssertionError(f"records-lenet: {k} differs from fit on "
                                 f"the same arrays")
    if files.iteration != steps or arrays.iteration != steps or \
            parsed != len(u8):
        raise AssertionError(f"records-lenet: {files.iteration} and "
                             f"{arrays.iteration} steps, want {steps}")
    log(f"[records-lenet] {len(u8)} PPM files in 10 class directories "
        f"written in {write_s:.2f} s; ImageRecordReader -> "
        f"RecordReaderDataSetIterator -> prefetch_to_device -> LeNet, "
        f"{steps} Adam steps: equal bit for bit to fit on the same arrays; "
        f"{len(u8) / files_s:.1f} images/s from files, "
        f"{len(u8) / arrays_s:.1f} from arrays; the readers alone "
        f"{parse_s:.3f} s for the {len(u8)} files, the fit from files "
        f"{files_s:.3f} s, from arrays {arrays_s:.3f} s ({card})")
    return launches


# ---------------------------------------------------------------- A.8
# layers-a8: each layer of A.8's first half, forward and the gradients of
# sum(out * w) (w seeded) on the card (TF32 off, deterministic cuDNN)
# against the CPU port, at small shapes: (label, layer config, input
# shape, a window of zeros in the input)
A8_LAYER_CASES = (
    [(f"Deconv2D {m} k={k} s={s} p={p}",
      dict(type="Deconv2D", kernel_size=(k, k), stride=(s, s),
           padding=(p, p), convolution_mode=m, n_out=5, activation="tanh"),
      (2, 7, 6, 3), False)
     for m in ("truncate", "same") for k in (2, 3, 4) for s in (1, 2)
     for p in (0, 1)]
    + [("SeparableConv2D dm=2 same s=2 d=2",
        dict(type="SeparableConv2D", kernel_size=(3, 3), stride=(2, 2),
             dilation=(2, 2), depth_multiplier=2, convolution_mode="same",
             n_out=6, activation="relu"), (2, 11, 10, 3), False),
       ("Conv1D same s=2 k=3", dict(type="Conv1D", kernel_size=3, stride=2,
                                    convolution_mode="same", n_out=6,
                                    activation="tanh"), (3, 17, 4), False),
       ("Conv1D same s=2 k=4", dict(type="Conv1D", kernel_size=4, stride=2,
                                    convolution_mode="same", n_out=6),
        (3, 17, 4), False),
       ("Subsampling2D pnorm zero window",
        dict(type="Subsampling2D", kernel_size=(2, 2), stride=(2, 2),
             pooling_type="pnorm", pnorm=2), (2, 6, 6, 3), True),
       ("Subsampling2D sum same", dict(type="Subsampling2D",
                                       kernel_size=(3, 3), stride=(2, 2),
                                       pooling_type="sum",
                                       convolution_mode="same"),
        (2, 7, 7, 3), False),
       ("Subsampling1D avg same", dict(type="Subsampling1D", kernel_size=3,
                                       stride=2, pooling_type="avg",
                                       convolution_mode="same"),
        (2, 9, 4), False),
       ("Upsampling2D", dict(type="Upsampling2D", size=(2, 3)),
        (2, 3, 4, 2), False),
       ("Upsampling1D", dict(type="Upsampling1D", size=3), (2, 5, 2),
        False),
       ("ZeroPadding2D", dict(type="ZeroPadding2D", pad=(0, 1, 2, 3)),
        (2, 3, 4, 2), False),
       ("ZeroPadding1D", dict(type="ZeroPadding1D", pad=(1, 2)), (2, 5, 2),
        False),
       ("ElementWiseMultiplication",
        dict(type="ElementWiseMultiplication", n_out=6,
             activation="tanh"), (4, 6), False)])
A8_LAYER_TOL = 1e-5  # x the CPU value's largest magnitude


def a8_in_type(shape):
    from deeplearning4j_tpu_torch.nn import inputs as it

    if len(shape) == 4:
        return it.convolutional(*shape[1:])
    if len(shape) == 3:
        return it.recurrent(shape[2], shape[1])
    return it.feed_forward(shape[1])


def a8_layer_run(torch, np, cfg, shape, zero_window, device):
    """(output, input gradient, {param: gradient in the interchange
    layout}) of one layer, as numpy, its params made on the CPU from SEED
    (biases drawn nonzero)."""
    from deeplearning4j_tpu_torch.nn.layers.base import Layer

    layer = Layer.from_json(cfg)
    rng = np.random.default_rng(SEED)
    params = layer.init_params(torch.Generator().manual_seed(SEED),
                               a8_in_type(shape))
    if "b" in params:
        params["b"] = torch.from_numpy(
            rng.standard_normal(params["b"].shape).astype(np.float32))
    if "W" in params and cfg["type"] == "ElementWiseMultiplication":
        params["W"] = torch.from_numpy(
            rng.standard_normal(params["W"].shape).astype(np.float32))
    x = rng.standard_normal(shape).astype(np.float32)
    if zero_window:
        x[0, :2, :2, 0] = 0.0
    p = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
    tx = torch.tensor(x, device=device, requires_grad=True)
    out, _ = layer.apply(p, tx, state={}, train=False)
    w = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32)).to(device)
    (out * w).sum().backward()
    return (out.detach().cpu().numpy(), tx.grad.cpu().numpy(),
            {k: layer.to_interchange(k, v.grad).cpu().numpy()
             for k, v in p.items()})


def a8_disagreement(np, got, want):
    """Relative error of `got` to `want` over the finite entries, inf where
    their NaN positions or shapes differ."""
    if got.shape != want.shape or \
            (np.isnan(got) != np.isnan(want)).any():
        return float("inf")
    live = ~np.isnan(want)
    if not live.any():
        return 0.0
    return float(np.abs(got[live] - want[live]).max()
                 / max(np.abs(want[live]).max(), 1e-30))


def phase_layers_a8(torch, np):
    """layers-a8: A8_LAYER_CASES on the card against the CPU port."""
    from deeplearning4j_tpu_torch import dtypes

    dev = card_device(torch)
    worst, nan_cases = 0.0, 0
    for label, cfg, shape, zero_window in A8_LAYER_CASES:
        cpu = a8_layer_run(torch, np, cfg, shape, zero_window, "cpu")
        with dtypes.full_precision(), deterministic_cudnn(torch):
            card = a8_layer_run(torch, np, cfg, shape, zero_window, dev)
        errs = {"out": a8_disagreement(np, card[0], cpu[0]),
                "dx": a8_disagreement(np, card[1], cpu[1]),
                **{f"d{k}": a8_disagreement(np, card[2][k], cpu[2][k])
                   for k in cpu[2]}}
        bad = {k: v for k, v in errs.items() if not v <= A8_LAYER_TOL}
        if bad:
            raise AssertionError(f"layers-a8: {label}: card and CPU differ "
                                 f"{bad} (tol {A8_LAYER_TOL:g})")
        if zero_window:
            if not np.isnan(cpu[1]).any():
                raise AssertionError(f"layers-a8: {label}: no NaN gradient "
                                     f"over the zero window")
            nan_cases += 1
        worst = max(worst, *errs.values())
        log(f"[layers-a8] {label:40s} in {shape} -> out "
            f"{tuple(cpu[0].shape)}: " + ", ".join(
                f"{k} {v:.3g}" for k, v in errs.items()))
    log(f"[layers-a8] verdict: {len(A8_LAYER_CASES)} cases agree, card "
        f"(TF32 off, deterministic cuDNN) vs CPU, worst relative error "
        f"{worst:.3g} (tol {A8_LAYER_TOL:g}); NaN gradients at the same "
        f"positions in {nan_cases} zero-window case(s)")


def write_keras_a8_h5(np, path, kind, seed=SEED):
    """A Keras Sequential .h5 written with the port's HDF5 writer: "2d"
    Conv2D -> ZeroPadding2D -> SeparableConv2D -> UpSampling2D ->
    Conv2DTranspose on 12x12x3, or "1d" Conv1D -> MaxPooling1D ->
    UpSampling1D -> ZeroPadding1D on 20 steps of 5; random weights from
    `seed`. Returns the input shape without the batch axis."""
    from deeplearning4j_tpu_torch.modelimport import hdf5

    if kind == "2d":
        shape = (12, 12, 3)
        layers = [
            ("Conv2D", dict(name="conv", filters=8, kernel_size=[3, 3],
                            padding="same", activation="relu"),
             [("kernel:0", (3, 3, 3, 8)), ("bias:0", (8,))]),
            ("ZeroPadding2D", dict(name="pad", padding=[[1, 0], [0, 1]]),
             []),
            ("SeparableConv2D", dict(name="sep", filters=12,
                                     kernel_size=[3, 3], strides=[2, 2],
                                     padding="same", depth_multiplier=2,
                                     activation="relu"),
             [("depthwise_kernel:0", (3, 3, 8, 2)),
              ("pointwise_kernel:0", (1, 1, 16, 12)), ("bias:0", (12,))]),
            ("UpSampling2D", dict(name="up", size=[2, 2]), []),
            ("Conv2DTranspose", dict(name="deconv", filters=4,
                                     kernel_size=[3, 3], strides=[2, 2],
                                     padding="same", activation="linear"),
             [("kernel:0", (3, 3, 4, 12)), ("bias:0", (4,))])]
    else:
        shape = (20, 5)
        layers = [
            ("Conv1D", dict(name="conv", filters=8, kernel_size=[3],
                            strides=[2], padding="same", activation="relu"),
             [("kernel:0", (3, 5, 8)), ("bias:0", (8,))]),
            ("MaxPooling1D", dict(name="pool", pool_size=[2]), []),
            ("UpSampling1D", dict(name="up", size=3), []),
            ("ZeroPadding1D", dict(name="pad", padding=[1, 2]), [])]
    rng = np.random.default_rng(seed)
    cfg = [{"class_name": cls, "config": dict(c)} for cls, c, _ in layers]
    cfg[0]["config"]["batch_input_shape"] = [None, *shape]
    with hdf5.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(
            {"class_name": "Sequential", "config": {"layers": cfg}})
        mw = f.require_group("model_weights")
        for _, c, weights in layers:
            g = mw.require_group(c["name"])
            names = []
            for wname, wshape in weights:
                fan_in = int(np.prod(wshape[:-1])) if len(wshape) > 1 else 1
                arr = rng.normal(0, (2.0 / fan_in) ** 0.5, wshape)
                g.create_dataset(wname, data=arr.astype(np.float32))
                names.append(f"{c['name']}/{wname}".encode())
            g.attrs["weight_names"] = names
    return shape


def phase_keras_a8(torch, np, tmp, card):
    """keras-a8: the two files of write_keras_a8_h5 imported onto the card
    and onto the CPU; the card's import served through InferenceServer
    (batch limit 8), every answer against the CPU import's output (the
    server and a direct forward under TF32 off)."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.modelimport import (
        import_keras_sequential_model_and_weights as load)
    from deeplearning4j_tpu_torch.serving import InferenceServer

    rng = np.random.default_rng(SEED + 60)
    for kind in ("2d", "1d"):
        path = os.path.join(tmp, f"keras_a8_{kind}.h5")
        shape = write_keras_a8_h5(np, path, kind)
        net, cpu = load(path, device=card_device(torch)), load(
            path, device="cpu")
        names = [type(l).__name__ for l in net.layers]
        if net.device.type != card_device(torch).type or \
                net.conf.to_json() != cpu.conf.to_json():
            raise AssertionError(f"keras-a8 ({kind}): imports differ")
        xs = [rng.standard_normal((n, *shape)).astype(np.float32)
              for n in (1, 3, 8, 5)]
        reset_counts()
        with dtypes.full_precision(), deterministic_cudnn(torch):
            server = InferenceServer(model=net, batch_limit=8)
            try:
                server.warmup(xs[0])
                with ThreadPoolExecutor(len(xs)) as pool:
                    answers = list(pool.map(server.output, xs))
            finally:
                server.shutdown()
            direct = [net.output(x).cpu().numpy() for x in xs]
        expect_launches(f"keras-a8 ({kind})", read_counts(), {})
        worst = 0.0
        for x, a, d in zip(xs, answers, direct):
            want = cpu.output(x).numpy()
            for got in (a, d):
                err = a8_disagreement(np, np.asarray(got), want)
                if not err <= 1e-5:
                    raise AssertionError(f"keras-a8 ({kind}): {x.shape[0]} "
                                         f"rows differ from the CPU import "
                                         f"by {err:.3g} (tol 1e-5)")
                worst = max(worst, err)
        log(f"[keras-a8] {kind}: {' -> '.join(names)} imported onto "
            f"{net.device} and the CPU; {len(xs)} requests of "
            f"{[x.shape[0] for x in xs]} rows served, out "
            f"{tuple(direct[0].shape[1:])}; worst relative difference "
            f"from the CPU import {worst:.3g} (tol 1e-5, TF32 off)")


def train_zoo(torch, np, tag, net, x, y, runs, per_step, card):
    """`net` trained by fit on one batch (x, y tensors on the card) for
    each (mixed, steps) of `runs`: launches exactly `per_step` x steps,
    finite scores, and in the first run the median of the last 5 scores
    below the first. Returns {policy: (launches, scores, median step
    ms)}."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet

    out = {}
    b = x.shape[0]
    for i, (mixed, steps) in enumerate(runs):
        policy = "mixed bf16" if mixed else "TF32"
        data = DataSet(x.to(torch.bfloat16) if mixed else x.float(), y)
        dtypes.set_mixed_precision(mixed)
        torch.cuda.reset_peak_memory_stats()
        try:
            reset_counts()
            timed = timed_fits(torch, net, data, steps)
            launches = read_counts()
        finally:
            dtypes.set_mixed_precision(False)
        expect_launches(f"{tag} ({policy})", launches,
                        {k: steps * v for k, v in per_step.items()})
        scores = [sc for _, sc in timed]
        if not all(math.isfinite(sc) for sc in scores):
            raise AssertionError(f"{tag} ({policy}): scores {scores}")
        if i == 0 and not median(scores[-5:]) < scores[0]:
            raise AssertionError(f"{tag} ({policy}): the median of the last "
                                 f"5 scores is not below the first: "
                                 f"{scores}")
        step_ms = median([t for t, _ in timed[1:]]) * 1e3
        log(f"[{tag}] {policy}: {steps} steps of {b}, scores "
            f"{', '.join(f'{sc:.5f}' for sc in scores)}; launches per step "
            f"{per_step}")
        log(f"[{tag}] {policy}: median step {step_ms:.3f} ms, "
            f"{b / (step_ms / 1e3):.1f} trained images/s; first step "
            f"{timed[0][0] * 1e3:.2f} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB ({card})")
        out[policy] = launches, scores, step_ms
    return out


TINYYOLO = dict(num_classes=20, input_shape=(416, 416, 3))
TINYYOLO_TRAIN = (16, 10, 5)     # batch, mixed steps, TF32 steps
TINYYOLO_SERVE = 16              # InferenceServer's batch limit
ZOO_STREAM = 24                  # streamed requests of the zoo servers
TINYYOLO_REFER = (4, 3)          # batch, steps card vs CPU
YOLO_THRESHOLD = 0.5             # objectness (the JAX package's default)
YOLO_NMS_IOU = 0.5
YOLO_CANDIDATES = 200            # anchors kept by the second threshold


def yolo_batch(np, rng, b, grid, classes):
    """b seeded 416x416 images and Yolo2Output labels of 1-4 boxes each,
    each written into the cell of its center."""
    h, w, c = TINYYOLO["input_shape"]
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    y = np.zeros((b, grid, grid, 4 + classes), np.float32)
    for i in range(b):
        for _ in range(rng.integers(1, 5)):
            cx, cy = rng.uniform(0.05, 0.95, 2)
            bw_, bh = rng.uniform(0.05, 0.5, 2)
            r, col = min(int(cy * grid), grid - 1), min(int(cx * grid),
                                                        grid - 1)
            y[i, r, col, :4] = [cx - bw_ / 2, cy - bh / 2, cx + bw_ / 2,
                                cy + bh / 2]
            y[i, r, col, 4:] = 0.0
            y[i, r, col, 4 + rng.integers(classes)] = 1.0
    return x, y


def zoo_net(torch, name, device=None, **kw):
    from deeplearning4j_tpu_torch import zoo

    return getattr(zoo, name)(seed=SEED, **kw).init(
        card_device(torch) if device is None else device)


def phase_tinyyolo(torch, np, card):
    """train-tinyyolo, serve-tinyyolo and refer-tinyyolo: zoo TinyYOLO (20
    classes, 416x416x3, a 13x13 grid of 5 anchors) trained by fit at batch
    16 with Adam, mixed then TF32; the trained network behind
    InferenceServer, each answer decoded (get_predicted_objects, the
    threshold on the card) and non-max suppressed on the host; then card
    (TF32 off, deterministic cuDNN) against the CPU port, 3 steps at
    batch 4, each from the same point. No TPU kernel runs on this path:
    leaky BatchNorm takes the plain epilogue in both packages."""
    from deeplearning4j_tpu_torch.nn.layers.objdetect import (
        get_predicted_objects, non_max_suppression)

    b, mixed_steps, f32_steps = TINYYOLO_TRAIN
    classes = TINYYOLO["num_classes"]
    t0 = time.perf_counter()
    net = zoo_net(torch, "TinyYOLO", **TINYYOLO)
    grid = int(net.output(np.zeros((1, *TINYYOLO["input_shape"]),
                                   np.float32)).shape[1])
    log(f"[train-tinyyolo] TinyYOLO ({net.num_params()} params, grid "
        f"{grid}x{grid}, 5 anchors, {classes} classes) on {net.device} in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 62)
    x, y = yolo_batch(np, rng, b, grid, classes)
    dev = card_device(torch)
    train_zoo(torch, np, "train-tinyyolo", net, torch.from_numpy(x).to(dev),
              torch.from_numpy(y).to(dev),
              [(True, mixed_steps), (False, f32_steps)], {}, card)

    layer = net.layers[-1]

    def rows(rng, n):
        return rng.standard_normal((n, *TINYYOLO["input_shape"])).astype(
            np.float32)

    _, answers = phase_serve(torch, np, net, card, rows=rows,
                             tag="serve-tinyyolo", limit=TINYYOLO_SERVE,
                             per_batch={}, rel_tol=1e-2, softmax=False,
                             n_stream=ZOO_STREAM)
    x_full, out_full = answers[-1]
    # a trained detector keeps a few candidates per image before NMS: the
    # second threshold keeps the answer's 200 most confident anchors
    # (about 12 per image), whatever the training did
    conf = layer._pred_boxes(torch.as_tensor(out_full))[4].flatten()
    top = float(conf.kthvalue(conf.numel() - YOLO_CANDIDATES).values)
    for threshold in (YOLO_THRESHOLD, top):
        for where, out in (("host", out_full),
                           ("card", net.output(x_full))):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                objs = get_predicted_objects(layer, out, threshold)
                t2 = time.perf_counter()
                kept = non_max_suppression(objs, YOLO_NMS_IOU)
                times.append((t2 - t1, time.perf_counter() - t2))
            for o in kept:
                if not (0 <= o.example < x_full.shape[0]
                        and 0 <= o.predicted_class < classes
                        and o.confidence > threshold):
                    raise AssertionError(f"serve-tinyyolo: bad detection "
                                         f"{o}")
            log(f"[serve-tinyyolo] decode of a {x_full.shape[0]}-image "
                f"answer on the {where} at objectness > {threshold:.4f}: "
                f"{len(objs)} anchors in "
                f"{median([t for t, _ in times]) * 1e3:.3f} ms, NMS (IoU "
                f"{YOLO_NMS_IOU}) keeps {len(kept)} in "
                f"{median([t for _, t in times]) * 1e3:.3f} ms on the host "
                f"(median of 3; {card})")
            if where == "host" and threshold == top and \
                    len(objs) != YOLO_CANDIDATES:
                raise AssertionError(f"serve-tinyyolo: {len(objs)} anchors "
                                     f"above the threshold of the "
                                     f"{YOLO_CANDIDATES} most confident")
    del net, answers
    torch.cuda.empty_cache()

    rb, steps = TINYYOLO_REFER
    x, y = yolo_batch(np, np.random.default_rng(SEED + 63), rb, grid,
                      classes)
    nets = {"card": zoo_net(torch, "TinyYOLO", **TINYYOLO),
            "cpu": zoo_net(torch, "TinyYOLO", "cpu", **TINYYOLO)}
    with deterministic_cudnn(torch):
        per_step = refer_resnet_steps(torch, np, nets, x, y, steps,
                                      tag="refer-tinyyolo")
    expect_launches("refer-tinyyolo", read_counts(), {})
    check_refer("refer-tinyyolo", per_step)
    del nets


GOOGLENET_TRAIN = (64, 10, 5)  # batch, mixed steps, TF32 steps
GOOGLENET_SHAPE = (224, 224, 3)
ZOO_SERVE_SHAPE = (224, 224, 3)  # serve-darknet19, serve-irv1
XENT_PER_STEP = {"linear_xent_fwd": 1, "linear_xent_bwd": 1}
VIT = dict(num_classes=10, input_shape=(32, 32, 3), patch_size=4,
           d_model=128, n_heads=4, n_layers=4)
VIT_TRAIN = (256, 20, 5)       # batch, mixed steps, TF32 steps
VIT_PER_STEP = {"flash_attention": 4, "flash_attention_bwd_dq": 4,
                "flash_attention_bwd_dkv": 4, **XENT_PER_STEP}
# rows 2-4 at ViT's attention: 256 images x 4 heads x 64 patches x 32
VIT_FLASH_CASES = [(256, 4, 64, 32, False)]
# rows 9 and 10 at GoogLeNet's Output (64, 1024, 1000) and ViT's (256,
# 128, 10)
A8_XENT_CASES = [(64, 1024, 1000, "onehot", "float32"),
                 (64, 1024, 1000, "onehot", "bfloat16"),
                 (256, 128, 10, "onehot", "float32"),
                 (256, 128, 10, "onehot", "bfloat16")]
FACENET = dict(num_classes=1000, embedding_size=128,
               input_shape=(96, 96, 3))
FACENET_TRAIN = (64, 10)       # batch, TF32 steps (Adam)
FACENET_REFER = 3              # steps card vs CPU, at the training batch


def labelled_images(torch, seed, b, shape, classes):
    """b float32 images made on the card from `seed` and one-hot labels."""
    dev = card_device(torch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, *shape), generator=gen, device=dev)
    y = torch.nn.functional.one_hot(torch.randint(
        0, classes, (b,), generator=gen, device=dev), classes).float()
    return x, y


def phase_train_googlenet(torch, np, card):
    """train-googlenet: zoo GoogLeNet (224x224x3, 1000 classes, dropout 0.4
    before the Output, two LRNs) at batch 64, mixed then TF32; rows 9 and
    10 run at (64, 1024, 1000), one of each per step."""
    b, mixed_steps, f32_steps = GOOGLENET_TRAIN
    net = zoo_net(torch, "GoogLeNet", num_classes=1000,
                  input_shape=GOOGLENET_SHAPE)
    log(f"[train-googlenet] GoogLeNet ({net.num_params()} params) on "
        f"{net.device}")
    x, y = labelled_images(torch, SEED + 64, b, GOOGLENET_SHAPE, 1000)
    res = train_zoo(torch, np, "train-googlenet", net, x, y,
                    [(True, mixed_steps), (False, f32_steps)],
                    XENT_PER_STEP, card)
    del net
    torch.cuda.empty_cache()
    return add_counts(res["mixed bf16"][0], res["TF32"][0])


def phase_train_vit(torch, np, card):
    """train-vit: zoo VisionTransformer at the JAX defaults at batch 256,
    mixed then TF32: per step 4 non-causal flash forward, 4 dq, 4 dk/dv
    launches at (256, 4, 64, 32) and one of each xent at (256, 128, 10)."""
    b, mixed_steps, f32_steps = VIT_TRAIN
    net = zoo_net(torch, "VisionTransformer", **VIT)
    log(f"[train-vit] VisionTransformer {VIT} ({net.num_params()} params) "
        f"on {net.device}")
    x, y = labelled_images(torch, SEED + 65, b, VIT["input_shape"],
                           VIT["num_classes"])
    res = train_zoo(torch, np, "train-vit", net, x, y,
                    [(True, mixed_steps), (False, f32_steps)],
                    VIT_PER_STEP, card)
    del net
    torch.cuda.empty_cache()
    return add_counts(res["mixed bf16"][0], res["TF32"][0])


def phase_train_facenet(torch, np, card):
    """train-facenet: zoo FaceNetNN4Small2 (96x96x3, 1000 classes, a
    128-wide L2-normalized embedding into CenterLossOutput) at batch 64
    with Adam under TF32; then 3 steps card (TF32 off, deterministic
    cuDNN) against the CPU port, each from the same point: the score,
    each leaf's change and Adam slots, and the centers."""
    b, steps = FACENET_TRAIN
    net = zoo_net(torch, "FaceNetNN4Small2", **FACENET)
    log(f"[train-facenet] FaceNetNN4Small2 ({net.num_params()} params) on "
        f"{net.device}")
    x, y = labelled_images(torch, SEED + 66, b, FACENET["input_shape"],
                           FACENET["num_classes"])
    train_zoo(torch, np, "train-facenet", net, x, y, [(False, steps)], {},
              card)
    centers = net.state["out"]["centers"]
    moved = int((centers.abs().sum(dim=1) > 0).sum())
    if moved != int(y.sum(0).gt(0).sum()):
        raise AssertionError(f"train-facenet: {moved} centers moved, the "
                             f"batch has {int(y.sum(0).gt(0).sum())} classes")
    log(f"[train-facenet] centers of the {moved} classes in the batch moved"
        f" (norms {float(centers.norm(dim=1).max()):.4f} at most)")
    del net
    torch.cuda.empty_cache()
    nets = {"card": zoo_net(torch, "FaceNetNN4Small2", **FACENET),
            "cpu": zoo_net(torch, "FaceNetNN4Small2", "cpu", **FACENET)}
    xs, ys = x.cpu().numpy(), y.cpu().numpy()
    with deterministic_cudnn(torch):
        per_step = refer_resnet_steps(torch, np, nets, xs, ys,
                                      FACENET_REFER, tag="train-facenet")
    # the CenterLossOutput's centers are running state: "bn" holds them
    check_refer("train-facenet", per_step)
    del nets


def phase_serve_zoo(torch, np, card, name, tag, limit=32):
    """serve-darknet19 / serve-irv1: zoo `name` at 224x224x3 behind
    InferenceServer (batch limit 32), softmax rows within 2e-3 of
    net.output's largest (no TPU kernel runs); then one TF32-off forward
    against the CPU port at 2 rows."""
    shape = ZOO_SERVE_SHAPE
    net = zoo_net(torch, name, input_shape=shape)
    log(f"[{tag}] {name} ({net.num_params()} params) on {net.device}")

    def rows(rng, n):
        return rng.standard_normal((n, *shape)).astype(np.float32)

    phase_serve(torch, np, net, card, rows=rows, tag=tag, limit=limit,
                per_batch={}, rel_tol=2e-3, n_stream=ZOO_STREAM)
    phase_reference(torch, np, net, cpu_net=zoo_net(
        torch, name, "cpu", input_shape=shape),
        x=rows(np.random.default_rng(SEED + 67), 2), tag=tag)
    del net
    torch.cuda.empty_cache()


# ------------------------------------------------- A.8's second half, A.2
# MNIST flattened to 784, batch 128: pretrain batches per layer, fit steps
PRETRAIN = (128, 20, 20)
# Hinton, Osindero & Teh 2006: RBMs 784-500-500-2000, then 10 classes
DBN_WIDTHS = (500, 500, 2000)
# Hinton & Salakhutdinov 2006's encoder widths, denoising at 0.3
SDA_WIDTHS = (1000, 500, 250, 30)
SDA_CORRUPTION = 0.3
# DL4J's VariationalAutoEncoderExample: 784 -> 256, 256 -> 2 -> 256, 256
VAE_EXAMPLE = dict(n_out=2, encoder_layer_sizes=[256, 256],
                   decoder_layer_sizes=[256, 256],
                   reconstruction_distribution="bernoulli",
                   pzx_activation="identity", activation="leakyrelu")
VAE_HELD_OUT = (1024, 16)      # held-out images, samples per image
# rows 9 and 10 at the DBN's Output (128, 2000, 10) and the stacked
# denoising autoencoder's (128, 30, 10)
PRETRAIN_XENT_CASES = [(128, 2000, 10, "onehot", "float32"),
                       (128, 2000, 10, "onehot", "bfloat16"),
                       (128, 30, 10, "onehot", "float32"),
                       (128, 30, 10, "onehot", "bfloat16")]
# refer-pretrain: each layer under an Output(10), 3 pretrain batches of
# 128 card (TF32 off) vs CPU with the card's draws replayed: (label,
# layer config, updater, learning rate). Gaussian visible units take a
# hundredth of the binary units' rate (Hinton's practical guide, section
# 13.2): at 0.05 the free energy reaches 1e8 in 3 batches.
PRETRAIN_REFER_CASES = [
    ("autoencoder", dict(type="AutoEncoder", n_out=1000,
                         corruption_level=SDA_CORRUPTION), "nesterovs", 0.05),
    ("rbm-binary-cd1", dict(type="RBM", n_out=500), "nesterovs", 0.05),
    ("rbm-gaussian-cd2", dict(type="RBM", n_out=500, visible_unit="gaussian",
                              cd_k=2), "nesterovs", 5e-4),
    ("vae-bernoulli", dict(type="VariationalAutoencoder", **VAE_EXAMPLE),
     "rmsprop", 1e-3),
    ("vae-gaussian", dict(type="VariationalAutoencoder",
                          **dict(VAE_EXAMPLE,
                                 reconstruction_distribution="gaussian")),
     "rmsprop", 1e-3),
]
PRETRAIN_REFER_BATCHES = 3
# card against CPU after 3 pretrain batches from the same point: the last
# batch's score relative (the RBM's CD surrogate, a difference of two free
# energies, relative to the data's mean free energy), each param's change
# and each slot in relative L2 norm per leaf as refer-tinyyolo holds them;
# reconstruction_probability with the same normals relative per row
PRETRAIN_REFER_TOL = {"score": 1e-5, "change": 0.05, "slot": 0.05,
                      "recon_prob": 1e-5}


def pretrain_updater(kind, lr=None):
    """RmsProp (the VAE example's, 1e-3) or Nesterovs (0.05, momentum
    0.9), at `lr` where given."""
    from deeplearning4j_tpu_torch.nn import updaters

    if kind == "rmsprop":
        return updaters.RmsProp(learning_rate=lr or 1e-3)
    return updaters.Nesterovs(learning_rate=lr or 0.05, momentum=0.9)


def pretrain_conf(kind):
    """The DBN, the stacked denoising autoencoder or DL4J's VAE example
    (MNIST flattened to 784, weights from SEED)."""
    from deeplearning4j_tpu_torch.nn import inputs
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import (
        RBM,
        AutoEncoder,
        Output,
        VariationalAutoencoder,
    )

    out = Output(n_out=10, loss="mcxent", activation="softmax")
    if kind == "dbn":
        layers = [RBM(n_out=w) for w in DBN_WIDTHS] + [out]
    elif kind == "sda":
        layers = [AutoEncoder(n_out=w, corruption_level=SDA_CORRUPTION)
                  for w in SDA_WIDTHS] + [out]
    else:
        layers = [VariationalAutoencoder(**VAE_EXAMPLE)]
    return (NeuralNetConfiguration(
        seed=SEED, updater=pretrain_updater(
            "rmsprop" if kind == "vae" else "nesterovs"),
        l2=1e-4 if kind == "vae" else 0.0)
        .list(layers).set_input_type(inputs.feed_forward(784)))


def mnist_flat(torch, np, n, train=True):
    """n MNIST images flattened to 784 (the port's MnistDataSetIterator:
    the idx files where there are any, else its seeded sample) and their
    one-hot labels, on the card; and whether they are the sample."""
    from deeplearning4j_tpu_torch.datasets import MnistDataSetIterator

    it = MnistDataSetIterator(batch=n, train=train, num_examples=n,
                              seed=SEED, shuffle=False)
    ds = next(iter(it))
    dev = card_device(torch)
    x = torch.from_numpy(np.asarray(ds.features).reshape(n, -1)).to(dev)
    return x, torch.from_numpy(np.asarray(ds.labels)).to(dev), it.synthetic


def score_tap(torch, net, x, y, batch):
    """A DataSetIterator over (x, y) in batches of `batch` rows that keeps
    net.score_ and the seconds of each batch as pretraining consumes it
    (no prefetch thread)."""
    from deeplearning4j_tpu_torch.datasets import DataSet, DataSetIterator

    class Tap(DataSetIterator):
        def __init__(self):
            self.scores, self.seconds, self._i, self._t0 = [], [], 0, None

        def async_supported(self):
            return False

        def reset(self):
            self._i = 0

        def __next__(self):
            torch.cuda.synchronize()
            if self._t0 is not None:
                self.seconds.append(time.perf_counter() - self._t0)
                self.scores.append(net.score_)
                self._t0 = None
            lo = self._i * batch
            if lo >= x.shape[0]:
                raise StopIteration
            self._i += 1
            self._t0 = time.perf_counter()
            return DataSet(x[lo:lo + batch], y[lo:lo + batch])

        def batch_size(self):
            return batch

    return Tap()


def pretrain_run(torch, np, tag, net, x, y, card):
    """net.pretrain_layer of every layer with an objective, in order, over
    PRETRAIN[1] batches of PRETRAIN[0] rows of (x, y): no TPU kernel
    launches; every score finite; the AutoEncoder's and the VAE's loss
    (median of the last 5) below the first batch's; an RBM's one-step
    mean-field reconstruction error of the first batch lower after its
    pass. Logs ms per pretrain batch per layer. Returns {layer: median
    ms}."""
    from deeplearning4j_tpu_torch.nn.layers import RBM

    b, batches, _ = PRETRAIN
    xs, ys = x[:b * batches], y[:b * batches]
    out = {}
    reset_counts()
    for i, layer in enumerate(net.layers):
        if not hasattr(layer, "pretrain_loss"):
            continue
        with torch.no_grad():
            h = net._walk(net.params, xs[:b], to_layer=i)[0]

        def recon(_i=i, _layer=layer, _h=h):
            with torch.no_grad():
                pv = _layer.gibbs_chain(net.params[f"layer_{_i}"], _h, None,
                                        k=1)
                return float(((pv - _h) ** 2).sum(dim=-1).mean())

        before = recon() if isinstance(layer, RBM) else None
        tap = score_tap(torch, net, xs, ys, b)
        net.pretrain_layer(i, tap)
        scores = tap.scores
        if len(scores) != batches or \
                not all(math.isfinite(s) for s in scores):
            raise AssertionError(f"{tag}: layer {i} scores {scores}")
        ms = median(tap.seconds[1:]) * 1e3
        note = ""
        if before is not None:
            after = recon()
            note = (f"; one-step reconstruction error of the first batch "
                    f"{before:.4f} -> {after:.4f}")
            if not after < before:
                raise AssertionError(f"{tag}: layer {i} reconstruction "
                                     f"error {before} -> {after}")
        elif not median(scores[-5:]) < scores[0]:
            raise AssertionError(f"{tag}: layer {i} the median of the last "
                                 f"5 losses is not below the first: "
                                 f"{scores}")
        log(f"[{tag}] pretrain layer {i} {type(layer).__name__} "
            f"{tuple(h.shape)} -> {layer.n_out}: {batches} batches of {b}, "
            f"scores {', '.join(f'{s:.4f}' for s in scores)}{note}")
        log(f"[{tag}] pretrain layer {i}: median {ms:.3f} ms per batch, "
            f"{b / (ms / 1e3):.1f} images/s; first batch "
            f"{tap.seconds[0] * 1e3:.2f} ms ({card})")
        out[i] = ms
    expect_launches(f"{tag} (pretrain)", read_counts(), {})
    return out


def phase_pretrain_stack(torch, np, card, kind, tag, data):
    """pretrain-dbn / pretrain-sda: the stack pretrained layer by layer
    (pretrain_run), then PRETRAIN[2] fit steps on one batch (rows 9 and
    10 once each per step at its Output). Returns the fit's launches and
    the network."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    x, y = data
    net = MultiLayerNetwork(pretrain_conf(kind)).init(card_device(torch))
    log(f"[{tag}] {[type(l).__name__ for l in net.layers]} "
        f"({net.num_params()} params) on {net.device}")
    pretrain_run(torch, np, tag, net, x, y, card)
    b, _, steps = PRETRAIN
    res = train_zoo(torch, np, tag, net, x[:b], y[:b], [(False, steps)],
                    XENT_PER_STEP, card)
    return res["TF32"][0], net


def phase_memory_and_nans(torch, np, net, data, card):
    """On the fine-tuned DBN: memory_report(conf).training_bytes(128)
    beside the card's peak allocation in one fit step (reported, not
    gated); then two fit steps under nan_checks on finite data (the
    kernels' outputs pass the checks) and a fit and an output on a batch
    with one NaN pixel, each of which raises FloatingPointError."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.memory import memory_report
    from deeplearning4j_tpu_torch.util.debugging import nan_checks

    b = PRETRAIN[0]
    x, y = data[0][:b], data[1][:b]
    report = memory_report(net.conf)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    net.fit(DataSet(x, y))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    mib = 2 ** 20
    log(f"[pretrain-dbn] memory_report: {report.total_params} params, "
        f"training_bytes(128) {report.training_bytes(b) / mib:.2f} MiB, "
        f"inference_bytes(128) {report.inference_bytes(b) / mib:.2f} MiB; "
        f"one fit step's peak allocation {peak / mib:.2f} MiB "
        f"({before / mib:.2f} MiB allocated before it; reported, not "
        f"gated) ({card})")
    bad = x.clone()
    bad[3, 400] = float("nan")
    finite_ms = []
    with nan_checks():
        for _ in range(2):  # the first pays one-time costs of the checks
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(DataSet(x, y))
            torch.cuda.synchronize()
            finite_ms.append((time.perf_counter() - t0) * 1e3)
        caught = []
        for run in (lambda: net.fit(DataSet(bad, y)),
                    lambda: net.output(bad)):
            try:
                run()
            except FloatingPointError as e:
                caught.append(str(e))
            else:
                raise AssertionError("pretrain-dbn: nan_checks let a NaN "
                                     "batch through")
    if not math.isfinite(net.score(DataSet(x, y))):
        raise AssertionError("pretrain-dbn: the network is not finite "
                             "after the refused step")
    log(f"[pretrain-dbn] nan_checks: finite fit steps pass "
        f"({finite_ms[0]:.1f} ms, then {finite_ms[1]:.1f} ms, with every op "
        f"checked); the NaN batch raises "
        f"FloatingPointError in fit ({caught[0]}: the batch's slice, as "
        f"JAX's dynamic_slice would) and in output ({caught[1]})")


def phase_pretrain_vae(torch, np, card, data):
    """pretrain-vae: DL4J's VariationalAutoEncoderExample pretrained for
    PRETRAIN[1] batches; then reconstruction_probability of VAE_HELD_OUT
    held-out images with 16 samples each as an anomaly score (ms and
    scores/s): finite, at most 0 (log p of a bernoulli), and the held-out
    digits more probable on average than as many uniform-noise images."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    x, y = data
    net = MultiLayerNetwork(pretrain_conf("vae")).init(card_device(torch))
    log(f"[pretrain-vae] VariationalAutoencoder {VAE_EXAMPLE} "
        f"({net.num_params()} params) on {net.device}")
    pretrain_run(torch, np, "pretrain-vae", net, x, y, card)
    n, samples = VAE_HELD_OUT
    x_test, _, synthetic = mnist_flat(torch, np, n, train=False)
    gen = torch.Generator(device=card_device(torch)).manual_seed(SEED + 70)
    noise = torch.rand((n, 784), generator=gen, device=card_device(torch))
    layer, p = net.layers[0], net.params["layer_0"]
    reset_counts()
    times = []
    with torch.no_grad():
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = layer.reconstruction_probability(
                p, x_test, net.draws.step(), num_samples=samples)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        noise_scores = layer.reconstruction_probability(
            p, noise, net.draws.step(), num_samples=samples)
    expect_launches("pretrain-vae", read_counts(), {})
    s = scores.cpu().numpy()
    s_noise = noise_scores.cpu().numpy()
    if s.shape != (n,) or not np.isfinite(s).all() or (s > 0).any():
        raise AssertionError(f"pretrain-vae: scores {s[:8]} shape "
                             f"{s.shape}")
    if not s.mean() > s_noise.mean():
        raise AssertionError(f"pretrain-vae: held-out digits "
                             f"{s.mean():.2f} not above noise "
                             f"{s_noise.mean():.2f}")
    ms = median(times) * 1e3
    log(f"[pretrain-vae] reconstruction_probability of {n} held-out "
        f"images ({'synthetic sample' if synthetic else 'MNIST test'}), "
        f"{samples} samples each: {ms:.3f} ms (median of 3), "
        f"{n / (ms / 1e3):.1f} scores/s; mean log p {s.mean():.2f} "
        f"(min {s.min():.2f}) against {s_noise.mean():.2f} for uniform "
        f"noise ({card})")
    del net


class SlotTap:
    """Stands in for a layer's updater in pretrain_layer and keeps the
    slots of its last step."""

    def __init__(self, inner):
        self.inner, self.slots = inner, None
        self.learning_rate = inner.learning_rate

    def init_state(self, params):
        return self.inner.init_state(params)

    def apply(self, grads, slots, lr):
        steps, self.slots = self.inner.apply(grads, slots, lr)
        return steps, self.slots


def pretrain_refer_net(torch, cfg, updater, lr, device):
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import inputs
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import Output
    from deeplearning4j_tpu_torch.nn.layers.base import Layer

    conf = (NeuralNetConfiguration(seed=SEED,
                                   updater=pretrain_updater(updater, lr))
            .list([Layer.from_json(cfg), Output(n_out=10, loss="mcxent")])
            .set_input_type(inputs.feed_forward(784)))
    return MultiLayerNetwork(conf).init(device)


def pretrain_refer_run(torch, np, case, x, y, device, tape=None):
    """PRETRAIN_REFER_CASES[case]'s layer under an Output(10) pretrained
    on (x, y) in batches of PRETRAIN[0] on `device`, its draws recorded
    (tape None) or replayed from `tape`; with a VAE, then
    reconstruction_probability of the first batch with 4 samples. Returns
    (params as numpy, the last slots as numpy, score_, the recorded tape,
    the reconstruction probabilities or None)."""
    from deeplearning4j_tpu_torch.datasets import DataSet, ListDataSetIterator
    from deeplearning4j_tpu_torch.models._training import flat_items

    _, cfg, updater, lr = PRETRAIN_REFER_CASES[case]
    net = pretrain_refer_net(torch, cfg, updater, lr, device)
    net.draws = (DrawTape.record(net.draws) if tape is None
                 else DrawTape.replay(tape, device))
    net._updaters[0] = SlotTap(net._updaters[0])
    x, y = x.to(device), y.to(device)
    net.pretrain_layer(0, ListDataSetIterator(DataSet(x, y),
                                              batch=PRETRAIN[0]))
    layer, p = net.layers[0], net.params["layer_0"]
    probs = None
    if hasattr(layer, "reconstruction_probability"):
        with torch.no_grad():
            probs = layer.reconstruction_probability(
                p, x[:PRETRAIN[0]], net.draws.step(), num_samples=4)
        probs = probs.cpu().numpy()
    if tape is not None and net.draws.tape:
        raise AssertionError(f"refer-pretrain: {len(net.draws.tape)} "
                             f"recorded draws left over")

    def numpy_tree(tree):
        return {k: t.detach().cpu().numpy() for k, t in flat_items(tree)
                if hasattr(t, "shape") and t.dim()}

    slots = {}
    for slot, tree in net._updaters[0].slots.items():
        if isinstance(tree, dict):
            slots.update({f"{slot}/{k}": v
                          for k, v in numpy_tree(tree).items()})
    return (numpy_tree(p), slots, net.score_,
            None if tape is not None else net.draws.tape, probs)


def pretrain_refer_case(torch, np, case, x, y):
    """PRETRAIN_REFER_CASES[case] pretrained on (x, y) (card tensors) on
    the card (TF32 off) and on the CPU from the same params, the card's
    draws replayed on the CPU. Returns (measures beside
    PRETRAIN_REFER_TOL, a log line)."""
    from deeplearning4j_tpu_torch import dtypes

    label, cfg, updater, lr = PRETRAIN_REFER_CASES[case]
    start = {k: t.detach().numpy() for k, t in
             pretrain_refer_net(torch, cfg, updater, lr, "cpu")
             .params["layer_0"].items()}
    with dtypes.full_precision():
        card_p, card_s, card_score, tape, card_probs = pretrain_refer_run(
            torch, np, case, x, y, card_device(torch))
        n_draws = len(tape)
        cpu_p, cpu_s, cpu_score, _, cpu_probs = pretrain_refer_run(
            torch, np, case, x.cpu(), y.cpu(), "cpu", tape=tape)
    scale = abs(cpu_score)
    if cfg["type"] == "RBM":
        layer = pretrain_refer_net(torch, cfg, updater, lr, "cpu").layers[0]
        with torch.no_grad():
            fe = layer.free_energy(
                {k: torch.from_numpy(v) for k, v in cpu_p.items()},
                x[-PRETRAIN[0]:].cpu())
        scale = max(scale, float(fe.abs().mean()))

    def norm_rel(a, c):
        return float(np.linalg.norm(a - c) / max(np.linalg.norm(c), 1e-30))

    errs = {
        "score": abs(card_score - cpu_score) / scale,
        "change": max(norm_rel(card_p[k] - start[k], v - start[k])
                      for k, v in cpu_p.items()),
        "slot": max(norm_rel(card_s[k], v) for k, v in cpu_s.items()),
    }
    if card_probs is not None:
        errs["recon_prob"] = float(np.abs(card_probs - cpu_probs).max()
                                   / np.abs(cpu_probs).max())
    elementwise = max(leaf_rel(card_p[k] - start[k], v - start[k])
                      for k, v in cpu_p.items())
    line = (f"{label}: {x.shape[0] // PRETRAIN[0]} batches of "
            f"{PRETRAIN[0]}, scores {card_score:.7f} (card) "
            f"{cpu_score:.7f} (CPU); "
            + ", ".join(f"{k} {v:.3g} (tol {PRETRAIN_REFER_TOL[k]:g})"
                        for k, v in errs.items())
            + f"; largest element error of a change {elementwise:.3g} of "
              f"its leaf's largest; {n_draws} draws replayed")
    return errs, line


def phase_refer_pretrain(torch, np, dbn, data):
    """refer-pretrain: each PRETRAIN_REFER_CASES layer pretrained for 3
    batches on the card (TF32 off) and on the CPU from the same params,
    the card's corruption masks, Gibbs samples and normals replayed on
    the CPU (pretrain_refer_case): the last score, each param's change and
    each slot within PRETRAIN_REFER_TOL; the VAEs' reconstruction
    probabilities with the same normals within 1e-5. Then one fit step of
    the fine-tuned DBN card vs CPU (REFER_DROPOUT_TOL), and
    check_gradients on float64 AutoEncoder, RBM and VAE networks on the
    card."""
    x, y = data
    n = PRETRAIN[0] * PRETRAIN_REFER_BATCHES
    for case, (label, *_) in enumerate(PRETRAIN_REFER_CASES):
        reset_counts()
        errs, line = pretrain_refer_case(torch, np, case, x[:n], y[:n])
        expect_launches("refer-pretrain", read_counts(), {})
        log(f"[refer-pretrain] {line}")
        bad = {k: v for k, v in errs.items()
               if not (math.isfinite(v) and v <= PRETRAIN_REFER_TOL[k])}
        if bad:
            raise AssertionError(f"refer-pretrain: {label}: card and CPU "
                                 f"differ: {bad}")
    # one fit step of the fine-tuned DBN, card vs CPU from the same point
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork

    cpu = MultiLayerNetwork(pretrain_conf("dbn")).init("cpu")
    copy_state(cpu, dbn)
    b = PRETRAIN[0]
    reset_counts()
    refer_fit_steps(torch, np, "refer-pretrain",
                    {"card": dbn, "cpu": cpu},
                    (x[:b].cpu().numpy(), y[:b].cpu().numpy()), 1,
                    REFER_DROPOUT_TOL, what="fine-tuned DBN ")
    expect_launches("refer-pretrain (DBN step)", read_counts(),
                    XENT_PER_STEP)
    del cpu
    phase_gradient_checks(torch, np)


def gradient_check_nets():
    """(label, [layer]) of the card's gradient checks: one layer of each
    class, put under an Output in a small float64 network."""
    from deeplearning4j_tpu_torch.nn.layers import (
        RBM,
        AutoEncoder,
        Output,
        VariationalAutoencoder,
    )

    return [("AutoEncoder", [AutoEncoder(n_out=5, activation="tanh")]),
            ("RBM", [RBM(n_out=5, visible_unit="gaussian")]),
            ("VariationalAutoencoder", [VariationalAutoencoder(
                n_out=3, encoder_layer_sizes=[5, 4], decoder_layer_sizes=[4],
                pzx_activation="tanh")])]


def phase_gradient_checks(torch, np):
    """check_gradients on the card: each gradient_check_nets network in
    float64 (the layers' plain versions) passes, and its analytic gradient
    is within 1e-10 of the CPU's (relative to each leaf's largest)."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import inputs
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import Output
    from deeplearning4j_tpu_torch.util.gradientcheck import (
        analytic_gradients,
        check_gradients,
    )

    rng = np.random.default_rng(SEED + 71)
    ds = DataSet(rng.standard_normal((8, 6)),
                 np.eye(3)[rng.integers(0, 3, 8)])
    for label, layers in gradient_check_nets():
        conf = (NeuralNetConfiguration(seed=42).list(
            layers + [Output(n_out=3, loss="mcxent")])
            .set_input_type(inputs.feed_forward(6)))
        nets = [MultiLayerNetwork(conf).init(d)
                for d in (card_device(torch), "cpu")]
        t0 = time.perf_counter()
        if not check_gradients(nets[0], ds):
            raise AssertionError(f"refer-pretrain: check_gradients fails "
                                 f"the {label} network on the card")
        seconds = time.perf_counter() - t0
        card_g, cpu_g = (analytic_gradients(n, ds) for n in nets)
        worst = max(float(np.abs(card_g[k] - g).max()
                          / max(np.abs(g).max(), 1e-30))
                    for k, g in cpu_g.items())
        if not worst <= 1e-10:
            raise AssertionError(f"refer-pretrain: {label}'s analytic "
                                 f"gradient on the card is {worst:.3g} "
                                 f"from the CPU's")
        log(f"[refer-pretrain] check_gradients of a float64 {label} -> "
            f"Output network on {nets[0].device}: passes in {seconds:.2f} "
            f"s; analytic gradient {worst:.3g} from the CPU's")


# ------------------------------------------------------------ A.3's rest, A.9
# train-inception: ComputationGraph.fit on the imported InceptionV3 at full
# width (the serve-inception network); per step its 94 BatchNorms launch
# bn_act once each and its Output the two xent rows at (32, 2048, 1000)
INCEPTION_TRAIN = (32, 20, 5)  # batch, mixed steps, TF32 steps
INCEPTION_PER_STEP = {"bn_act": INCEPTION_BN, "linear_xent_fwd": 1,
                      "linear_xent_bwd": 1}
INCEPTION_XENT_CASES = [(32, 2048, 1000, "onehot", "float32"),
                        (32, 2048, 1000, "onehot", "bfloat16")]
# refer-train-inception: the same file's network at 107x107, 10 classes,
# card (TF32 off, deterministic cuDNN) against the CPU port, each step
# from the same point. 107x107 leaves the last blocks 2x2 maps, 16 values
# per channel's statistics at batch 4 (at 75x75, 4: single relu flips
# then move whole channels). Measured on an H100 80GB HBM3 (700 W): the
# first step's score 1.82e-05 relative (the forward alone: float32
# rounding renormalized by 94 train-mode BatchNorms; the CPU tests
# measured 3.3e-05 between the port and the JAX package), changes 0.0416
# at worst, running stats 6.26e-05; Sgd keeps no slots. The same step
# with TF32 left on (the control, logged and checked to fail the gate)
# read a score error of 0.00566
INCEPTION_REFER = dict(input_shape=(107, 107, 3), classes=10, batch=4,
                       steps=3)
REFER_INCEPTION_TOL = {"score": 5e-5, "change": 0.1, "slot": 0.1,
                       "bn": 1e-4}

# tp-transformer: the TransformerLM at train-lm's width on two gloo ranks
# of the one card, MeshSpec(model=2), 5 mixed steps beside this process's
# 5 on the same batch; each rank launches rows 2-4 on 4 of the 8 heads and
# rows 9-10 on the gathered vocabulary, as the single process does per
# step
TP_STEPS = 5
# ranks against one process, each of the 5 scores relative: bf16
# activations, the row-split products summed in another order, after
# 1-4 Adam steps (measured 1.44e-05 on an H100 80GB HBM3, 700 W)
TP_SCORE_TOL = 1e-4
TP_FLASH_CASES = [(LM_BATCH, LM["n_heads"] // 2, LM["max_length"],
                   LM["d_model"] // LM["n_heads"], True)]
# fsdp-vgg16: zoo VGG16 at 224x224, batch 64, MeshSpec(fsdp=2), 5 mixed
# steps; each rank holds half of every kernel that splits at rest
FSDP_STEPS = 5
# refer-tp-fsdp: four ranks, MeshSpec(fsdp=2, model=2), TF32 off and
# deterministic cuDNN, against this process, each step from the same
# point: a small TransformerLM, VGG16 at 32x32 and the char-RNN (BPTT:
# fsdp does not compose with tBPTT)
REFER_A9 = dict(lm=dict(num_classes=128, max_length=32, d_model=64,
                        n_heads=4, n_layers=2), lm_batch=4,
                vgg=dict(num_classes=10, input_shape=(32, 32, 3)),
                vgg_batch=4, rnn_batch=8, rnn_length=64, steps=3)
# remat-transformer: the full-width TransformerLM under each remat policy,
# 3 float32 steps each (TF32 off); 'full' and 'dots_saveable' recompute
# each block's forward in the backward, so the forward rows launch twice
REMAT_STEPS = 3
REMAT_FLASH = {"none": 1, "dots_saveable": 2, "full": 2, "offload": 1}
# compress: EncodingHandler over a seeded gradient tree, card against CPU
COMPRESS = dict(leaves=((512, 1536), (2048, 512), (512,), (8192, 64)),
                rounds=4, threshold=0.05, capacity_fraction=0.02)


def a9_rank_main(case: str, rank: int, world: int, tmp: str) -> int:
    """One rank of an A.9 phase (this script run with --a9-rank CASE RANK
    WORLD DIR): joins the gloo group of `world` ranks on the card through
    DIR, runs the case and writes its results to DIR/CASE_rankRANK.npz."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.parallel import init_process_group

    init_process_group(f"file://{tmp}/rdv_{case}", rank, world,
                       backend="gloo", device=card_device(torch))
    try:
        out = {"tp": tp_rank, "fsdp": fsdp_rank, "refer": refer_a9_rank,
               "ring": ring_rank, "sppp": sppp_rank,
               "lm4": functools.partial(lm4_rank, tmp=tmp)}[case](torch, np)
        np.savez(os.path.join(tmp, f"{case}_rank{rank}.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def a9_spawn(case, world, tmp):
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--a9-rank", case,
         str(r), str(world), tmp], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]


def a9_wait(tag, case, procs, tmp, timeout=600):
    """Each rank's results; raises with a failed rank's log."""
    import numpy as np

    try:
        logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{tag}: rank {r} exited {p.returncode}:\n"
                                 f"{text[-4000:]}")
    return [dict(np.load(os.path.join(tmp, f"{case}_rank{r}.npz")))
            for r in range(len(procs))]


def coll_totals(pw):
    """(collectives, bytes) so far over every axis of a wrapper's grid."""
    st = pw.collective_stats()
    return (sum(v["collectives"] for v in st.values()),
            sum(v["bytes"] for v in st.values()))


def wrapper_steps(torch, pw, data, steps):
    """`steps` fit calls of the wrapper on one batch on the card: per step
    (seconds, score), and the collectives and bytes moved per step."""
    c0, b0 = coll_totals(pw)
    runs = timed_fits(torch, pw.model, data, steps, fit=pw.fit)
    c1, b1 = coll_totals(pw)
    return runs, (c1 - c0) / steps, (b1 - b0) / steps


def tp_rank(torch, np):
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import MeshSpec, ParallelWrapper
    from deeplearning4j_tpu_torch.zoo import TransformerLM

    x, y = lm_batch(np, np.random.default_rng(SEED + 3), LM_BATCH,
                    LM["max_length"], LM["num_classes"])
    dev = card_device(torch)
    data = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    net = TransformerLM(**LM, seed=SEED).init()
    pw = ParallelWrapper(net, mesh_spec=MeshSpec(model=2))
    heads = net.params["layer_2"]["attn"]["Wqkv"].shape[1] // 3 // (
        LM["d_model"] // LM["n_heads"])
    dtypes.set_mixed_precision(True)
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_counts()
        runs, colls, nbytes = wrapper_steps(torch, pw, data, TP_STEPS)
        launches = read_counts()
    finally:
        dtypes.set_mixed_precision(False)
    return dict(seconds=[t for t, _ in runs], scores=[s for _, s in runs],
                collectives=colls, bytes=nbytes, heads=heads,
                peak=torch.cuda.max_memory_allocated(),
                **{f"launches/{k}": v for k, v in launches.items()})


def at_rest_bytes(net):
    """Bytes of the params and of the updater slots this rank holds."""
    from deeplearning4j_tpu_torch.models._training import flat_items

    params = sum(t.numel() * t.element_size() for p in net.params.values()
                 for _, t in flat_items(p))
    entries = (net.opt_state.values() if isinstance(net.opt_state, dict)
               else net.opt_state)
    slots = sum(t.numel() * t.element_size() for e in entries
                if isinstance(e, dict) for v in e.values()
                for t in ([v] if not isinstance(v, dict)
                          else [t for _, t in flat_items(v)]))
    return params, slots


def fsdp_rank(torch, np):
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import MeshSpec, ParallelWrapper

    x, y = image_batch(torch, SEED + 11, VGG_TRAIN[0], VGG_SHAPE)
    net = vgg_net(torch)
    whole = at_rest_bytes(net)
    pw = ParallelWrapper(net, mesh_spec=MeshSpec(fsdp=2))
    held = at_rest_bytes(net)
    torch.cuda.empty_cache()
    dtypes.set_mixed_precision(True)
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_counts()
        runs, colls, nbytes = wrapper_steps(torch, pw, DataSet(x, y),
                                            FSDP_STEPS)
        launches = read_counts()
    finally:
        dtypes.set_mixed_precision(False)
    return dict(seconds=[t for t, _ in runs], scores=[s for _, s in runs],
                collectives=colls, bytes=nbytes, whole=whole, held=held,
                peak=torch.cuda.max_memory_allocated(),
                **{f"launches/{k}": v for k, v in launches.items()})


def refer_a9_nets(torch, device=None):
    """refer-tp-fsdp's three networks from SEED, each with Nesterovs(0.01,
    0.9) in place of its zoo updater: as in refer-dp, its step is linear
    in the gradient, where Adam's and RMSProp's is about lr whatever the
    gradient's size, so the rounding of a near-zero gradient (the
    attention key bias, to which softmax is invariant) would move a param
    by up to lr."""
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import updaters
    from deeplearning4j_tpu_torch.zoo import (
        VGG16,
        TextGenerationLSTM,
        TransformerLM,
    )

    c = REFER_A9
    confs = {"lm": TransformerLM(**c["lm"], seed=SEED).conf(),
             "vgg16": VGG16(**c["vgg"], seed=SEED).conf(),
             "char_rnn": TextGenerationLSTM(
                 num_classes=RNN["num_classes"], max_length=c["rnn_length"],
                 seed=SEED).conf()}
    out = {}
    for name, conf in confs.items():
        conf.defaults.updater = updaters.Nesterovs(learning_rate=1e-2,
                                                   momentum=0.9)
        out[name] = MultiLayerNetwork(conf).init(
            **({} if device is None else {"device": device}))
    return out


def refer_a9_data(np):
    c, rng = REFER_A9, np.random.default_rng(SEED + 21)
    lm = c["lm"]
    vgg = c["vgg"]
    return {
        "lm": lm_batch(np, rng, c["lm_batch"], lm["max_length"],
                       lm["num_classes"]),
        "vgg16": (rng.standard_normal((c["vgg_batch"], *vgg["input_shape"])
                                      ).astype(np.float32),
                  np.eye(vgg["num_classes"], dtype=np.float32)[
                      rng.integers(0, vgg["num_classes"], c["vgg_batch"])]),
        "char_rnn": char_batch(np, rng, c["rnn_batch"], c["rnn_length"],
                               RNN["num_classes"])}


def refer_a9_rank(torch, np):
    """Each refer-tp-fsdp network through the wrapper at fsdp=2 x model=2,
    TF32 off and deterministic cuDNN; its snapshots after every step."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import MeshSpec, ParallelWrapper

    out = {}
    data = refer_a9_data(np)
    with deterministic_cudnn(torch), dtypes.full_precision():
        for name, net in refer_a9_nets(torch).items():
            snaps = Snapshots()
            net.set_listeners(snaps)
            pw = ParallelWrapper(net, mesh_spec=MeshSpec(fsdp=2, model=2))
            x, y = data[name]
            reset_counts()
            for _ in range(REFER_A9["steps"]):
                pw.fit(DataSet(x, y))
            out.update({f"launches/{name}/{k}": v
                        for k, v in read_counts().items()})
            for i, snap in enumerate(snaps.steps):
                out.update({f"{name}/{i}/{k}": np.asarray(v)
                            for k, v in snap.items()})
    return out


def phase_train_inception(torch, np, card, net):
    """The imported InceptionV3 trained by ComputationGraph.fit: 20 mixed
    steps, then 5 TF32 steps, on one batch of 32 seeded images (its
    training_config's loss, batch statistics in its 94 BatchNorms).
    Returns the mixed run's launches."""
    b, mixed_steps, f32_steps = INCEPTION_TRAIN
    out = net.layer(net.conf.network_outputs[0])
    if out.loss != "mcxent":
        raise AssertionError(f"train-inception: loss {out.loss}")
    x, y = image_batch(torch, SEED + 17, b, INCEPTION["input_shape"])
    means = {n: st["mean"].clone() for n, st in net.state.items() if st}
    runs = train_zoo(torch, np, "train-inception", net, x, y,
                     [(True, mixed_steps), (False, f32_steps)],
                     INCEPTION_PER_STEP, card)
    moved = sum(not net.state[n]["mean"].equal(m) for n, m in means.items())
    if moved != INCEPTION_BN:
        raise AssertionError(f"train-inception: {moved} of {len(means)} "
                             f"BatchNorms moved their running means")
    log(f"[train-inception] loss {out.loss} (the file's training_config); "
        f"{moved} BatchNorms moved their running means")
    return runs["mixed bf16"][0]


def phase_refer_train_inception(torch, np, tmp):
    """The InceptionV3 file at 107x107 and 10 classes, imported on the card
    and on the CPU: 3 Sgd steps at batch 4, each from the same point, TF32
    off and cuDNN deterministic (refer-train-resnet's pattern)."""
    from deeplearning4j_tpu_torch.modelimport import (
        import_keras_model_and_weights,
    )
    from deeplearning4j_tpu_torch.modelimport.trainedmodels import (
        write_inception_v3_h5,
    )

    c = INCEPTION_REFER
    path = os.path.join(tmp, "inception_v3_small.h5")
    write_inception_v3_h5(path, input_shape=c["input_shape"],
                          classes=c["classes"], seed=SEED)
    nets = {"card": import_keras_model_and_weights(path),
            "cpu": import_keras_model_and_weights(path, device="cpu")}
    rng = np.random.default_rng(SEED + 19)
    x = rng.standard_normal((c["batch"], *c["input_shape"])).astype(
        np.float32)
    y = np.eye(c["classes"], dtype=np.float32)[
        rng.integers(0, c["classes"], c["batch"])]
    with deterministic_cudnn(torch):
        per_step = refer_resnet_steps(torch, np, nets, x, y, c["steps"],
                                      tag="refer-train-inception",
                                      tol=REFER_INCEPTION_TOL)
    launches = read_counts()
    expect_launches("refer-train-inception", launches,
                    {k: c["steps"] * v for k, v in
                     INCEPTION_PER_STEP.items()})
    check_refer("refer-train-inception", per_step, REFER_INCEPTION_TOL)
    # the control: step 1 from the same start with TF32 left on, to show
    # where the score gate sits between float32 rounding and TF32's
    control = {"card": import_keras_model_and_weights(path),
               "cpu": import_keras_model_and_weights(path, device="cpu")}
    with deterministic_cudnn(torch):
        tf32 = refer_resnet_steps(torch, np, control, x, y, 1,
                                  tag="refer-train-inception TF32 control",
                                  tol=REFER_INCEPTION_TOL,
                                  precision=contextlib.nullcontext)[0]
    log(f"[refer-train-inception] step 1's score error "
        f"{per_step[0]['score']:.3g} with TF32 off, {tf32['score']:.3g} "
        f"with TF32 on (the control); the gate "
        f"{REFER_INCEPTION_TOL['score']:g}")
    if not tf32["score"] > REFER_INCEPTION_TOL["score"]:
        raise AssertionError(
            f"refer-train-inception: the score gate "
            f"{REFER_INCEPTION_TOL['score']:g} passes the TF32 control "
            f"({tf32['score']:.3g}): it cannot tell float32 from TF32")


def phase_tp_transformer(torch, np, card, tmp):
    """tp-transformer: this process's 5 mixed steps first, then the two
    ranks' (MeshSpec(model=2), gloo on the one card). Gates: the ranks'
    scores equal, each within TP_SCORE_TOL of this process's, 4 heads per
    rank, the single process's launches per step on each rank. Returns
    rank 0's launches."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.zoo import TransformerLM

    x, y = lm_batch(np, np.random.default_rng(SEED + 3), LM_BATCH,
                    LM["max_length"], LM["num_classes"])
    dev = card_device(torch)
    data = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    net = TransformerLM(**LM, seed=SEED).init()
    dtypes.set_mixed_precision(True)
    try:
        single = timed_fits(torch, net, data, TP_STEPS)
    finally:
        dtypes.set_mixed_precision(False)
    del net, data
    torch.cuda.empty_cache()
    ranks = a9_wait("tp-transformer", "tp", a9_spawn("tp", 2, tmp), tmp)
    want = {k: TP_STEPS * v for k, v in LM_PER_STEP.items()}
    for r, res in enumerate(ranks):
        got = {k[len("launches/"):]: int(v) for k, v in res.items()
               if k.startswith("launches/")}
        expect_launches(f"tp-transformer rank {r}", got, want)
        if int(res["heads"]) != LM["n_heads"] // 2:
            raise AssertionError(f"tp-transformer: {res['heads']} heads")
    if not np.array_equal(ranks[0]["scores"], ranks[1]["scores"]):
        raise AssertionError(f"tp-transformer: the ranks' scores differ: "
                             f"{ranks[0]['scores']} {ranks[1]['scores']}")
    s_single = np.array([s for _, s in single])
    rel = np.abs(ranks[0]["scores"] - s_single) / np.abs(s_single)
    r_ms = median(ranks[0]["seconds"][1:]) * 1e3
    s_ms = median([t for t, _ in single[1:]]) * 1e3
    log(f"[tp-transformer] TransformerLM {LM}, {LM_BATCH} x "
        f"{LM['max_length']} tokens, {TP_STEPS} mixed steps: scores "
        f"(rank 0) {', '.join(f'{s:.5f}' for s in ranks[0]['scores'])}, "
        f"one process {', '.join(f'{s:.5f}' for s in s_single)}: worst "
        f"{rel.max():.3g} relative (tol {TP_SCORE_TOL:g}); launches per "
        f"rank {want}, "
        f"{int(ranks[0]['heads'])} heads per rank")
    log(f"[tp-transformer] median step {r_ms:.3f} ms on each of 2 ranks "
        f"(gloo on one card) against {s_ms:.3f} ms in one process; "
        f"{float(ranks[0]['collectives']):g} collectives and "
        f"{float(ranks[0]['bytes']) / 1e6:.3f} MB per step per rank; peak "
        f"device memory per rank "
        f"{float(ranks[0]['peak']) / 2 ** 30:.3f} GiB ({card})")
    if not (np.isfinite(rel).all() and rel.max() <= TP_SCORE_TOL):
        raise AssertionError(f"tp-transformer: scores {ranks[0]['scores']} "
                             f"against {s_single}")
    return {k[len("launches/"):]: int(v) for k, v in ranks[0].items()
            if k.startswith("launches/")}


def phase_fsdp_vgg16(torch, np, card, tmp, first):
    """fsdp-vgg16: two ranks, MeshSpec(fsdp=2), 5 mixed steps of
    train-vgg16's batch; each rank holds about half of the params and
    slots at rest, its first score is train-vgg16's (the same rows, the
    same masks) to DP_FIRST_TOL. Returns rank 0's launches."""
    ranks = a9_wait("fsdp-vgg16", "fsdp", a9_spawn("fsdp", 2, tmp), tmp)
    want = {k: FSDP_STEPS * v for k, v in VGG_PER_STEP.items()}
    for r, res in enumerate(ranks):
        got = {k[len("launches/"):]: int(v) for k, v in res.items()
               if k.startswith("launches/")}
        expect_launches(f"fsdp-vgg16 rank {r}", got, want)
        held, whole = res["held"], res["whole"]
        if not (held[0] < 0.55 * whole[0] and held[1] < 0.55 * whole[1]):
            raise AssertionError(f"fsdp-vgg16 rank {r}: at rest {held} of "
                                 f"{whole} bytes")
    scores = ranks[0]["scores"]
    rel = abs(scores[0] - first) / abs(first)
    if not (np.isfinite(scores).all() and rel <= DP_FIRST_TOL["dp-vgg16"]):
        raise AssertionError(f"fsdp-vgg16: scores {scores}, first of "
                             f"train-vgg16 {first}")
    r0 = ranks[0]
    log(f"[fsdp-vgg16] VGG16 at {VGG_SHAPE}, batch {VGG_TRAIN[0]}, "
        f"{FSDP_STEPS} mixed steps on 2 ranks (gloo, one card): scores "
        f"{', '.join(f'{s:.5f}' for s in scores)}; first {rel:.3g} from "
        f"train-vgg16's (tol {DP_FIRST_TOL['dp-vgg16']:g}); launches per "
        f"rank {want}")
    log(f"[fsdp-vgg16] at rest per rank: params {r0['held'][0] / 2 ** 20:.1f}"
        f" MiB, slots {r0['held'][1] / 2 ** 20:.1f} MiB, against "
        f"{r0['whole'][0] / 2 ** 20:.1f} and {r0['whole'][1] / 2 ** 20:.1f} "
        f"MiB replicated; peak device memory per rank "
        f"{float(r0['peak']) / 2 ** 30:.3f} GiB; median step "
        f"{median(r0['seconds'][1:]) * 1e3:.3f} ms; "
        f"{float(r0['collectives']):g} collectives and "
        f"{float(r0['bytes']) / 1e6:.1f} MB per step per rank ({card})")
    return {k[len("launches/"):]: int(v) for k, v in r0.items()
            if k.startswith("launches/")}


# rank vs this process, each step from the same point: the score
# relative, each param's change and each slot in relative L2 norm per leaf
# (measured on an H100 80GB HBM3, 700 W: scores 0, changes 8.28e-05 at
# worst, a conv kernel of VGG16 whose cout slices take other cuDNN
# algorithms, slots 3.04e-06)
REFER_A9_TOL = {"score": 1e-6, "change": 5e-4, "slot": 1e-4}


def phase_refer_tp_fsdp(torch, np, tmp):
    """refer-tp-fsdp: four ranks (fsdp=2 x model=2, gloo on the one card)
    train each network REFER_A9['steps'] steps; this process takes each
    step from the rank's point before it and compares the step's score,
    changes and slots (REFER_A9_TOL), the ranks bit-identical after every
    step."""
    from deeplearning4j_tpu_torch import dtypes, interop
    from deeplearning4j_tpu_torch.datasets import DataSet

    procs = a9_spawn("refer", 4, tmp)
    ranks = a9_wait("refer-tp-fsdp", "refer", procs, tmp)
    data = refer_a9_data(np)
    nets = refer_a9_nets(torch)
    for name, net in nets.items():
        x, y = data[name]
        keys = sorted(k for k in ranks[0] if k.startswith(f"{name}/0/"))
        for k in ranks[0]:
            if k.startswith(f"{name}/") and any(
                    not np.array_equal(r[k], ranks[0][k]) for r in ranks):
                raise AssertionError(f"refer-tp-fsdp: the ranks differ in "
                                     f"{k}")
        worst = {}
        for i in range(REFER_A9["steps"]):
            if i:
                prev = {k.split("/", 2)[2]: ranks[0][k] for k in ranks[0]
                        if k.startswith(f"{name}/{i - 1}/")}
                net.set_param_table({k[len("param/"):]: v
                                     for k, v in prev.items()
                                     if k.startswith("param/")})
                set_slots(interop, net, {k[len("slot/"):]: v
                                         for k, v in prev.items()
                                         if k.startswith("slot/")})
            start = net.get_param_table()
            with deterministic_cudnn(torch), dtypes.full_precision():
                net.fit(DataSet(x, y))
            got = {k.split("/", 2)[2]: ranks[0][k] for k in ranks[0]
                   if k.startswith(f"{name}/{i}/")}
            mine = net.get_param_table()
            slots = dict(slot_items(interop.opt_state_to_jax(net)))

            def rel_l2(a, c):
                return float(np.linalg.norm(a - c) / max(np.linalg.norm(c),
                                                         1e-30))

            change = {k: rel_l2(got[f"param/{k}"] - start[k], v - start[k])
                      for k, v in mine.items()}
            errs = {"score": abs(float(got["score"]) - net.score_)
                    / abs(net.score_),
                    "change": max(change.values()),
                    "slot": max((rel_l2(got[f"slot/{k}"], v)
                                 for k, v in slots.items()), default=0.0)}
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
            leaf = max(change, key=change.get)
            if change[leaf] >= worst["change"]:
                worst_leaf = (i + 1, leaf)
        launches = {k.split("/")[-1]: int(v) for k, v in ranks[0].items()
                    if k.startswith(f"launches/{name}/") and v}
        log(f"[refer-tp-fsdp] {name}: {REFER_A9['steps']} steps on 4 ranks "
            f"(fsdp=2 x model=2, gloo, one card), bit-identical after each; "
            f"against one process from the same point, worst "
            + ", ".join(f"{k} {v:.3g} (tol {REFER_A9_TOL[k]:g})"
                        for k, v in worst.items())
            + f" (the change's at step {worst_leaf[0]}, {worst_leaf[1]}); "
              f"rank 0's launches {launches}; {len(keys)} leaves")
        bad = {k: v for k, v in worst.items()
               if not (math.isfinite(v) and v <= REFER_A9_TOL[k])}
        if bad:
            raise AssertionError(f"refer-tp-fsdp {name}: {bad}")
    del nets


def set_slots(interop, net, flat):
    """The updater slots from snapshot entries "entry/slot/path"."""
    tree = interop.opt_state_to_jax(net)
    entries = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, entry in entries:
        for slot, sub in (entry.items() if entry else ()):
            if not isinstance(sub, dict):
                continue
            for path in [p for p in _paths(sub)]:
                node = sub
                *parents, leaf = path.split("/")
                for part in parents:
                    node = node[part]
                node[leaf] = flat[f"{key}/{slot}/{path}"]
    interop.opt_state_from_jax(net, tree)


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}"


def phase_remat_transformer(torch, np, card):
    """The full-width TransformerLM under each remat policy: 3 float32
    steps (TF32 off) from the same seed on train-lm's batch; peak memory
    and median step per policy; the scores within 1e-6 of 'none' (float32
    rounding; logged whether bit for bit). Returns the launches of the
    four runs."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.parallel import layout as layout_mod
    from deeplearning4j_tpu_torch.zoo import TransformerLM

    x, y = lm_batch(np, np.random.default_rng(SEED + 3), LM_BATCH,
                    LM["max_length"], LM["num_classes"])
    dev = card_device(torch)
    data = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    out, total = {}, None
    for pol in layout_mod.REMAT_POLICY_NAMES:
        net = TransformerLM(**LM, remat=pol, seed=SEED).init()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with dtypes.full_precision():
            reset_counts()
            runs = timed_fits(torch, net, data, REMAT_STEPS)
            launches = read_counts()
        per = dict(LM_PER_STEP)
        per["flash_attention"] = LM["n_layers"] * REMAT_FLASH[pol]
        expect_launches(f"remat-transformer ({pol})", launches,
                        {k: REMAT_STEPS * v for k, v in per.items()})
        out[pol] = ([s for _, s in runs], median([t for t, _ in runs[1:]]),
                    torch.cuda.max_memory_allocated())
        total = launches if total is None else add_counts(total, launches)
        del net
    base = out["none"][0]
    for pol, (scores, sec, peak) in out.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(scores, base))
        log(f"[remat-transformer] {pol}: scores "
            f"{', '.join(f'{s:.7f}' for s in scores)} ({rel:.3g} from "
            f"'none', {'bit for bit' if scores == base else 'not bitwise'}"
            f"); median step {sec * 1e3:.3f} ms; peak device memory "
            f"{peak / 2 ** 30:.3f} GiB; flash forward launches per step "
            f"{LM['n_layers'] * REMAT_FLASH[pol]} ({card})")
        if not rel <= 1e-6:
            raise AssertionError(f"remat-transformer {pol}: scores {scores} "
                                 f"against {base}")
    return total


def phase_compress(torch, np, card):
    """EncodingHandler over a seeded gradient tree, COMPRESS['rounds']
    rounds on the card and on the CPU: the indices sent equal, the values,
    deltas and residuals within 1e-6, the thresholds equal; ms per round
    on the card. No kernel: torch's sort and index_add on the card."""
    from deeplearning4j_tpu_torch.parallel.compression import EncodingHandler

    c = COMPRESS
    rng = np.random.default_rng(SEED + 23)
    kw = dict(threshold=c["threshold"],
              capacity_fraction=c["capacity_fraction"])
    card_h, cpu_h = EncodingHandler(**kw), EncodingHandler(**kw)
    dev = card_device(torch)
    worst, times, sent = 0.0, [], 0
    for _ in range(c["rounds"]):
        grads = {f"leaf{i}": (0.05 * rng.standard_normal(s)).astype(
            np.float32) for i, s in enumerate(c["leaves"])}
        on_card = {k: torch.from_numpy(v).to(dev) for k, v in grads.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        msgs, deltas = card_h.encode_tree(on_card)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        cmsgs, cdeltas = cpu_h.encode_tree(
            {k: torch.from_numpy(v) for k, v in grads.items()})
        for k, (idx, vals, size) in msgs.items():
            cidx, cvals, _ = cmsgs[k]
            if not torch.equal(idx.cpu(), cidx):
                raise AssertionError(f"compress: indices of {k} differ")
            sent += int((cidx >= 0).sum())
            for a, b in ((vals, cvals), (deltas[k], cdeltas[k]),
                         (card_h._residuals[k], cpu_h._residuals[k])):
                worst = max(worst, float((a.cpu() - b).abs().max()))
        if card_h.threshold != cpu_h.threshold:
            raise AssertionError(f"compress: thresholds "
                                 f"{card_h.threshold} {cpu_h.threshold}")
    n = sum(int(np.prod(s)) for s in c["leaves"])
    log(f"[compress] EncodingHandler, {c['rounds']} rounds of {n} gradient "
        f"entries: indices equal on the card and the CPU, values, deltas "
        f"and residuals within {worst:.3g} (tol 1e-6), {sent} entries sent "
        f"in all, threshold {card_h.threshold:.6g}; median round "
        f"{median(times[1:]) * 1e3:.3f} ms on the card ({card})")
    if not worst <= 1e-6:
        raise AssertionError(f"compress: card and CPU differ by {worst}")


# ring-attention: seq = 4 on four gloo ranks of the one card, the global
# (b, h, t, d) below split 1024 tokens a rank; each rank's ring against one
# process's rows 2-4 over the whole sequence on the same inputs, forward and
# dq, dk, dv, causal and not, float32 and bfloat16, at the flash phases'
# tolerances (x max|plain| of each output)
RING = dict(b=2, h=8, t=4096, d=64, world=4)
RING_REPS = 3              # timed ring calls after one warm-up
# sp-transformer and pp-transformer: the full-width TransformerLM through
# ParallelWrapper on two gloo ranks of the one card, MeshSpec(seq=2) and
# MeshSpec(pipe=2) with microbatches=4: 5 mixed steps, then 3 float32
# steps (TF32 off) from a fresh network, each against this process's
SPPP = dict(steps=5, f32_steps=3, microbatches=4)
# ranks against one process, each score relative: the mixed steps round
# activations to bfloat16 (the ring merges each hop's bfloat16 o), the
# float32 steps sum in another order (ring merges, microbatch sums, the
# gradient reduce)
# (measured 1.2e-05 mixed and 1.12e-07 float32 on an NVIDIA H100 80GB
# HBM3, 700 W)
SPPP_TOL = {"mixed": 1e-4, "float32": 1e-6}
# sharded-lm: ShardedTransformerLM at the TransformerConfig defaults, batch
# 8 x 2048 tokens; one process 5 float32 steps (TF32 off), four ranks at
# data=2 x seq=2 and model=2 x seq=2 for 3 steps each against it, the MoE
# config (4 experts) at pipe=2 x expert=2 against its own one-process run;
# the data=2 x seq=2 ranks' checkpoint restored in this process, logits
# on 4 x 256 tokens compared
SLM = dict(batch=8, t=2048, steps=5, grid_steps=3, logits=(4, 256))
# relative: losses against one process (float32 sums in another order:
# ring merges, microbatch and gradient sums; measured 6.55e-07), the
# restored logits x the grid's largest (measured 2.98e-06 absolute of
# 2.53, 1.2e-06); on an NVIDIA H100 80GB HBM3, 700 W
SLM_TOL = {"loss": 1e-5, "logits": 1e-5}
# rows 2-4 at a ring hop's shape: ring-attention's (b 2, h 8, 1024 tokens
# a rank, d 64), the diagonal hop causal, an earlier one full
RING_FLASH_CASES = [(RING["b"], RING["h"], RING["t"] // RING["world"],
                     RING["d"], True),
                    (RING["b"], RING["h"], RING["t"] // RING["world"],
                     RING["d"], False)]


def ring_inputs(torch, dtype, seed):
    """The ring phase's global q, k, v and dO on the card (the same on
    every rank)."""
    r = RING
    gen = torch.Generator(device=card_device(torch)).manual_seed(seed)
    return [torch.randn((r["b"], r["h"], r["t"], r["d"]), generator=gen,
                        device=card_device(torch)).to(dtype)
            for _ in range(4)]


def ring_rank(torch, np):
    """One rank of ring-attention: per (causal, dtype) the ring's output
    and gradients against one process's rows 2-4 on the whole sequence,
    its launches per call, two broken rings the comparison must reject (a
    skipped hop; dK/dV left one rank off their owner), and ms per ring
    call (forward, forward + backward)."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import MeshSpec, build_mesh
    from deeplearning4j_tpu_torch.parallel import ring

    grid = build_mesh(MeshSpec(seq=RING["world"]))
    seq, n = grid.seq, RING["world"]
    t_loc = RING["t"] // n
    out = {}
    for causal in (True, False):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{'causal' if causal else 'full'}_{str(dtype)[6:]}"
            dname = str(dtype)[6:]
            q, k, v, do = ring_inputs(torch, dtype, SEED + 31)
            o_ref, lse = fa.flash_attention(q, k, v, causal,
                                            return_lse=True)
            ref = (o_ref,) + fa.flash_attention_bwd(q, k, v, o_ref, lse, do,
                                                    causal)
            leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
            torch.cuda.synchronize()
            reset_counts()
            o = ring.ring_attention(*leaves, grid, causal=causal)
            o.backward(do)
            torch.cuda.synchronize()
            got = (o.detach(),) + tuple(a.grad for a in leaves)
            counts = read_counts()
            tols = (FLASH_TOL[dname],) + (FLASH_BWD_TOL[dname],) * 3
            for name, a, r_, tol in zip(("o", "dq", "dk", "dv"), got, ref,
                                        tols):
                err = float((a.float() - r_.float()).abs().max())
                out[f"{tag}/err/{name}"] = err
                out[f"{tag}/lim/{name}"] = tol * float(
                    r_.float().abs().max())
            for name in ("flash_attention", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"):
                out[f"{tag}/launches/{name}"] = counts[name]
            # broken rings: one hop skipped (every rank but a causal rank
            # 0 drops its block src = rank - 1), and dk one block off
            runs = ring._runs
            ring._runs = lambda c, src, idx: runs(c, src, idx) and \
                src != (idx - 1) % n
            try:
                with torch.no_grad():
                    o_bad = ring.ring_attention(q, k, v, grid, causal=causal)
            finally:
                ring._runs = runs
            out[f"{tag}/rejects/skipped_hop"] = bool(disagrees(
                o_bad, ref[0], FLASH_TOL[dname]))
            out[f"{tag}/rejects/dk_off_owner"] = bool(disagrees(
                torch.roll(got[2], -t_loc, dims=2), ref[2],
                FLASH_BWD_TOL[dname]))
            # ms per call of the layer's function on this rank's blocks
            lq, lk, lv, ldo = (a[:, :, seq.rank * t_loc:
                                 (seq.rank + 1) * t_loc].contiguous()
                               for a in (q, k, v, do))
            for mode in ("fwd", "fwd_bwd"):
                times = []
                for rep in range(RING_REPS + 1):
                    xs = [a.clone().requires_grad_(mode == "fwd_bwd")
                          for a in (lq, lk, lv)]
                    torch.distributed.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    o_l = ring.ring_attention_sharded(*xs, axis=seq,
                                                      causal=causal)
                    if mode == "fwd_bwd":
                        o_l.backward(ldo)
                    torch.cuda.synchronize()
                    if rep:
                        times.append(time.perf_counter() - t0)
                out[f"{tag}/ms/{mode}"] = median(times) * 1e3
            del q, k, v, do, ref, got, leaves
    out["hops"] = seq.stats.collectives
    return out


def phase_ring_attention(torch, np, card, tmp):
    """ring-attention (see RING): one process's forward and forward +
    backward times at the global shape here, then the four ranks. Gates:
    every rank's output and gradients within the flash phases'
    tolerances, launches per call r + 1 (causal) and n (not), both broken
    rings rejected on every rank. Returns (per-rank launches per call,
    {tag: ms}) for the kernels line."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    single = {}
    for causal in (True, False):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"{'causal' if causal else 'full'}_{str(dtype)[6:]}"
            q, k, v, do = ring_inputs(torch, dtype, SEED + 31)

            def fwd(i, q=q, k=k, v=v, causal=causal):
                fa.flash_attention(q, k, v, causal)

            def fwd_bwd(i, q=q, k=k, v=v, do=do, causal=causal):
                o, lse = fa.flash_attention(q, k, v, causal,
                                            return_lse=True)
                fa.flash_attention_bwd(q, k, v, o, lse, do, causal)

            single[tag] = {"fwd": device_ms(torch, fwd, 1, 10),
                           "fwd_bwd": device_ms(torch, fwd_bwd, 1, 10)}
            del q, k, v, do
    torch.cuda.empty_cache()
    ranks = a9_wait("ring-attention", "ring", a9_spawn(
        "ring", RING["world"], tmp), tmp)
    n = RING["world"]
    per_rank = {}
    for r, res in enumerate(ranks):
        for tag in single:
            causal = tag.startswith("causal")
            want = r + 1 if causal else n
            got = {k.split("/")[-1]: int(v) for k, v in res.items()
                   if k.startswith(f"{tag}/launches/")}
            expect_launches(f"ring-attention rank {r} {tag}", got, {
                k: want for k in got})
            per_rank.setdefault(tag, []).append(got["flash_attention"])
            for name in ("o", "dq", "dk", "dv"):
                err = float(res[f"{tag}/err/{name}"])
                lim = float(res[f"{tag}/lim/{name}"])
                if not err <= lim:
                    raise AssertionError(
                        f"ring-attention rank {r} {tag}: {name} error "
                        f"{err:.3g} over {lim:.3g}")
            for what in ("skipped_hop", "dk_off_owner"):
                if not bool(res[f"{tag}/rejects/{what}"]):
                    raise AssertionError(
                        f"ring-attention rank {r} {tag}: the comparison "
                        f"does not reject a ring with a {what}")
    r0 = ranks[0]
    ms = {}
    for tag in single:
        worst = {name: max(float(res[f"{tag}/err/{name}"]) for res in ranks)
                 for name in ("o", "dq", "dk", "dv")}
        errs = ", ".join(f"{name} {err:.3g} (tol "
                         f"{float(r0[f'{tag}/lim/{name}']):.3g})"
                         for name, err in worst.items())
        ms[tag] = {m: float(r0[f"{tag}/ms/{m}"]) for m in ("fwd", "fwd_bwd")}
        log(f"[ring-attention] seq={n} on {n} gloo ranks of one card, "
            f"global (b={RING['b']}, h={RING['h']}, t={RING['t']}, "
            f"d={RING['d']}) {tag}: worst over ranks {errs}; rows 2-4 "
            f"launches per ring call by rank {per_rank[tag]}; ms per ring "
            f"call (rank 0, its {RING['t'] // n} tokens) forward "
            f"{ms[tag]['fwd']:.3f}, forward + backward "
            f"{ms[tag]['fwd_bwd']:.3f}; one process on the whole sequence "
            f"forward {single[tag]['fwd']:.3f}, forward + backward "
            f"{single[tag]['fwd_bwd']:.3f} ({card})")
    log(f"[ring-attention] verdict: the ring agrees with one process's rows "
        f"2-4 on every rank in 4/4 (causal, dtype) cases; a skipped hop and "
        f"dK/dV one rank off their owner are rejected on every rank; "
        f"{int(r0['hops'])} seq-axis messages on rank 0")
    return per_rank, ms, single


@contextlib.contextmanager
def mixed_policy():
    """The mixed-precision policy inside the block."""
    from deeplearning4j_tpu_torch import dtypes

    dtypes.set_mixed_precision(True)
    try:
        yield
    finally:
        dtypes.set_mixed_precision(False)


def lm_rank_steps(torch, np, pw, data, precision, steps):
    """`steps` wrapper steps under `precision` (a context): per step
    (seconds, score), and the collectives and bytes per step."""
    with precision():
        return wrapper_steps(torch, pw, data, steps)


def sppp_rank(torch, np):
    """One rank of sp-transformer then pp-transformer (see SPPP)."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.nn.layers import TransformerBlock
    from deeplearning4j_tpu_torch.parallel import MeshSpec, ParallelWrapper
    from deeplearning4j_tpu_torch.zoo import TransformerLM

    x, y = lm_batch(np, np.random.default_rng(SEED + 3), LM_BATCH,
                    LM["max_length"], LM["num_classes"])
    dev = card_device(torch)
    data = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    out = {}
    for tag, spec, micro in (("sp", MeshSpec(seq=2), None),
                             ("pp", MeshSpec(pipe=2), SPPP["microbatches"])):
        net = TransformerLM(**LM, seed=SEED).init()
        pw = ParallelWrapper(net, mesh_spec=spec, microbatches=micro)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        runs, colls, nbytes = lm_rank_steps(torch, np, pw, data,
                                            mixed_policy, SPPP["steps"])
        launches = read_counts()
        out[f"{tag}/peak"] = torch.cuda.max_memory_allocated()
        del net, pw
        torch.cuda.empty_cache()
        net = TransformerLM(**LM, seed=SEED).init()
        pw = ParallelWrapper(net, mesh_spec=spec, microbatches=micro)
        f32, _, _ = lm_rank_steps(torch, np, pw, data, dtypes.full_precision,
                                  SPPP["f32_steps"])
        if tag == "pp":
            lo, hi = pw._pp_bounds[pw.mesh.pipe.rank]
            out["pp/blocks"] = sum(isinstance(net.layers[i],
                                              TransformerBlock)
                                   for i in range(lo, hi))
            out["pp/last"] = pw.mesh.pipe.rank == pw.mesh.pipe.size - 1
        del net, pw
        torch.cuda.empty_cache()
        out.update({f"{tag}/seconds": [t for t, _ in runs],
                    f"{tag}/scores": [s for _, s in runs],
                    f"{tag}/f32": [s for _, s in f32],
                    f"{tag}/collectives": colls, f"{tag}/bytes": nbytes})
        out.update({f"{tag}/launches/{k}": v for k, v in launches.items()})
    return out


def phase_sp_pp_transformer(torch, np, card, tmp):
    """sp-transformer and pp-transformer (see SPPP): this process's 5
    mixed steps and 3 float32 steps first, then the two ranks of each
    mesh. Gates: the ranks' scores equal, each within SPPP_TOL of this
    process's, step by step; per rank and step, rows 2-4 6 x (r + 1) on
    seq rank r (its causal ring over the 6 blocks) and blocks x
    microbatches on a pipe stage, rows 9-10 once on every seq rank and on
    the last stage. Returns each rank's launches of each."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.zoo import TransformerLM

    x, y = lm_batch(np, np.random.default_rng(SEED + 3), LM_BATCH,
                    LM["max_length"], LM["num_classes"])
    dev = card_device(torch)
    data = DataSet(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
    net = TransformerLM(**LM, seed=SEED).init()
    dtypes.set_mixed_precision(True)
    try:
        single = timed_fits(torch, net, data, SPPP["steps"])
    finally:
        dtypes.set_mixed_precision(False)
    net = TransformerLM(**LM, seed=SEED).init()
    with dtypes.full_precision():
        single_f32 = [s for _, s in timed_fits(torch, net, data,
                                               SPPP["f32_steps"])]
    del net, data
    torch.cuda.empty_cache()
    ranks = a9_wait("sp-transformer", "sppp", a9_spawn("sppp", 2, tmp), tmp)
    s_mixed = np.array([s for _, s in single])
    s_ms = median([t for t, _ in single[1:]]) * 1e3
    rows = ("flash_attention", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")
    out = {}
    for tag in ("sp", "pp"):
        name = f"{tag}-transformer"
        for r, res in enumerate(ranks):
            got = {k.split("/")[-1]: int(v) for k, v in res.items()
                   if k.startswith(f"{tag}/launches/")}
            if tag == "sp":
                per = {k: LM["n_layers"] * (r + 1) for k in rows}
                per.update(linear_xent_fwd=1, linear_xent_bwd=1)
            else:
                per = {k: int(res["pp/blocks"]) * SPPP["microbatches"]
                       for k in rows}
                last = int(bool(res["pp/last"]))
                per.update(linear_xent_fwd=last, linear_xent_bwd=last)
            expect_launches(f"{name} rank {r}", got, {
                k: SPPP["steps"] * v for k, v in per.items()})
            out.setdefault(tag, []).append(got)
        for what in ("scores", "f32"):
            if not np.array_equal(ranks[0][f"{tag}/{what}"],
                                  ranks[1][f"{tag}/{what}"]):
                raise AssertionError(
                    f"{name}: the ranks' {what} differ: "
                    f"{ranks[0][f'{tag}/{what}']} "
                    f"{ranks[1][f'{tag}/{what}']}")
        r0 = ranks[0]
        rel = np.abs(r0[f"{tag}/scores"] - s_mixed) / np.abs(s_mixed)
        rel32 = (np.abs(r0[f"{tag}/f32"] - np.array(single_f32))
                 / np.abs(np.array(single_f32)))
        r_ms = median(list(r0[f"{tag}/seconds"][1:])) * 1e3
        mesh = ("MeshSpec(seq=2)" if tag == "sp" else
                f"MeshSpec(pipe=2), microbatches={SPPP['microbatches']}")
        log(f"[{name}] TransformerLM {LM}, {LM_BATCH} x {LM['max_length']} "
            f"tokens on 2 gloo ranks of one card ({mesh}): "
            f"{SPPP['steps']} mixed steps' scores (rank 0) "
            f"{', '.join(f'{s:.5f}' for s in r0[f'{tag}/scores'])}, one "
            f"process {', '.join(f'{s:.5f}' for s in s_mixed)}: worst "
            f"{rel.max():.3g} relative (tol {SPPP_TOL['mixed']:g}); "
            f"{SPPP['f32_steps']} float32 steps (TF32 off) worst "
            f"{rel32.max():.3g} relative (tol {SPPP_TOL['float32']:g}); "
            f"launches per rank {out[tag]}")
        log(f"[{name}] median mixed step {r_ms:.3f} ms on each of 2 ranks "
            f"against {s_ms:.3f} ms in one process; "
            f"{float(r0[f'{tag}/collectives']):g} messages and "
            f"{float(r0[f'{tag}/bytes']) / 1e6:.3f} MB per step on rank 0 "
            f"(gradient reduce, {'ring hops' if tag == 'sp' else 'stage hops'}"
            f"); peak device memory per rank "
            f"{float(r0[f'{tag}/peak']) / 2 ** 30:.3f} GiB ({card})")
        if not (np.isfinite(rel).all() and rel.max() <= SPPP_TOL["mixed"]
                and np.isfinite(rel32).all()
                and rel32.max() <= SPPP_TOL["float32"]):
            raise AssertionError(f"{name}: scores {r0[f'{tag}/scores']} "
                                 f"{r0[f'{tag}/f32']} against {s_mixed} "
                                 f"{single_f32}")
    return out


def slm_batch(np, seed, b, t):
    """b x t token ids and their next tokens over the default config's
    vocabulary."""
    from deeplearning4j_tpu_torch.parallel import TransformerConfig

    rng = np.random.default_rng(seed)
    ids = rng.integers(0, TransformerConfig().vocab, (b, t + 1)).astype(
        np.int32)
    return ids[:, :t], ids[:, 1:]


def slm_steps(torch, lm, ids, tgt, steps):
    """`steps` fit_batch calls: (seconds, loss) per step."""
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = lm.fit_batch(ids, tgt)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0, loss))
    return out


def lm4_rank(torch, np, tmp):
    """One rank of sharded-lm's grids (see SLM)."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec,
        ShardedTransformerLM,
        TransformerConfig,
        build_mesh,
    )

    ids, tgt = slm_batch(np, SEED + 41, SLM["batch"], SLM["t"])
    small = slm_batch(np, SEED + 43, *SLM["logits"])[0]
    out = {}
    for tag, spec, experts in (("dp_sp", MeshSpec(data=2, seq=2), 0),
                               ("tp_sp", MeshSpec(model=2, seq=2), 0),
                               ("moe_pp_ep", MeshSpec(pipe=2, expert=2), 4)):
        grid = build_mesh(spec)
        lm = ShardedTransformerLM(TransformerConfig(n_experts=experts),
                                  grid, device=card_device(torch)).init(
            seed=SEED)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with dtypes.full_precision():
            runs = slm_steps(torch, lm, ids, tgt, SLM["grid_steps"])
        out.update({f"{tag}/seconds": [t for t, _ in runs],
                    f"{tag}/losses": [s for _, s in runs],
                    f"{tag}/peak": torch.cuda.max_memory_allocated()})
        out.update({f"{tag}/launches/{k}": v
                    for k, v in read_counts().items()})
        if tag == "dp_sp":
            lm.save(os.path.join(tmp, "sharded_lm.zip"))
            with dtypes.full_precision():
                out["dp_sp/logits"] = lm.logits(small)
        del lm
        torch.cuda.empty_cache()
    return out


def phase_sharded_lm(torch, np, card, tmp):
    """sharded-lm (see SLM): one process (a grid of one rank) 5 float32
    steps with ms per step, tokens/s and peak memory, and the MoE config's
    3 steps; then the four ranks. Gates: each grid's losses within
    SLM_TOL of the one-process run step by step, rows 2-4 launched on
    every rank, the restored checkpoint's logits within SLM_TOL of the
    grid's. Returns the one-process run's launches per step."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.parallel import (
        MeshSpec,
        ShardedTransformerLM,
        TransformerConfig,
        build_mesh,
        init_process_group,
    )

    ids, tgt = slm_batch(np, SEED + 41, SLM["batch"], SLM["t"])
    small = slm_batch(np, SEED + 43, *SLM["logits"])[0]
    init_process_group(f"file://{tmp}/rdv_slm1", 0, 1)  # NCCL, the card
    try:
        grid = build_mesh(MeshSpec())
        one = {}
        for tag, experts, steps in (("dense", 0, SLM["steps"]),
                                    ("moe", 4, SLM["grid_steps"])):
            lm = ShardedTransformerLM(TransformerConfig(n_experts=experts),
                                      grid).init(seed=SEED)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            with dtypes.full_precision():
                runs = slm_steps(torch, lm, ids, tgt, steps)
            one[tag] = (runs, read_counts(), torch.cuda.max_memory_allocated(),
                        lm.config)
            del lm
            torch.cuda.empty_cache()
        ranks = a9_wait("sharded-lm", "lm4", a9_spawn("lm4", 4, tmp), tmp)
        restored = ShardedTransformerLM.restore(
            os.path.join(tmp, "sharded_lm.zip"), grid)
        with dtypes.full_precision():
            logits = restored.logits(small)
        del restored
    finally:
        torch.distributed.destroy_process_group()
    runs, launches, peak, cfg = one["dense"]
    sec = median([t for t, _ in runs[1:]])
    tokens = SLM["batch"] * SLM["t"]
    per_step = {k: v // SLM["steps"] for k, v in launches.items()}
    log(f"[sharded-lm] ShardedTransformerLM {dataclasses.asdict(cfg)} in one "
        f"process, {SLM['batch']} x {SLM['t']} tokens, {SLM['steps']} "
        f"float32 steps (TF32 off): losses "
        f"{', '.join(f'{s:.6f}' for _, s in runs)}; median step "
        f"{sec * 1e3:.3f} ms, {tokens / sec:.1f} tokens/s, peak device "
        f"memory {peak / 2 ** 30:.3f} GiB; launches per step {per_step} "
        f"({card})")
    want = {"flash_attention": cfg.n_layers,
            "flash_attention_bwd_dq": cfg.n_layers,
            "flash_attention_bwd_dkv": cfg.n_layers}
    # remat 'full' recomputes each block's forward in the backward
    want["flash_attention"] *= 2
    expect_launches("sharded-lm one process", {
        k: v for k, v in launches.items() if k in want},
        {k: SLM["steps"] * v for k, v in want.items()})
    worst = 0.0
    for tag, ref in (("dp_sp", "dense"), ("tp_sp", "dense"),
                     ("moe_pp_ep", "moe")):
        base = np.array([s for _, s in one[ref][0][:SLM["grid_steps"]]])
        for r, res in enumerate(ranks):
            if not np.array_equal(res[f"{tag}/losses"],
                                  ranks[0][f"{tag}/losses"]):
                raise AssertionError(f"sharded-lm {tag}: ranks' losses "
                                     f"differ")
            got = {k.split("/")[-1]: int(v) for k, v in res.items()
                   if k.startswith(f"{tag}/launches/")}
            # per step: the causal ring's r_seq + 1 hops on each of the
            # n_layers blocks on seq rank r_seq (ranks row-major (data or
            # model, seq)); on the pipe grid each stage's n_layers / 2
            # blocks on 2 microbatches; remat doubles the forward
            hops = (r % 2 + 1) if tag != "moe_pp_ep" else 1
            per = {"flash_attention": 2 * cfg.n_layers * hops,
                   "flash_attention_bwd_dq": cfg.n_layers * hops,
                   "flash_attention_bwd_dkv": cfg.n_layers * hops}
            expect_launches(f"sharded-lm {tag} rank {r}", {
                k: v for k, v in got.items() if k in per},
                {k: SLM["grid_steps"] * v for k, v in per.items()})
        r0 = ranks[0]
        rel = np.abs(r0[f"{tag}/losses"] - base) / np.abs(base)
        worst = max(worst, float(rel.max()))
        log(f"[sharded-lm] {tag} on 4 gloo ranks of one card: losses "
            f"{', '.join(f'{s:.6f}' for s in r0[f'{tag}/losses'])} against "
            f"one process {', '.join(f'{s:.6f}' for s in base)}: worst "
            f"{rel.max():.3g} relative (tol {SLM_TOL['loss']:g}); median "
            f"step {median(list(r0[f'{tag}/seconds'][1:])) * 1e3:.3f} ms; "
            f"peak device memory per rank "
            f"{float(r0[f'{tag}/peak']) / 2 ** 30:.3f} GiB; rows 2-4 "
            f"launches by rank "
            f"{[int(res[f'{tag}/launches/flash_attention']) for res in ranks]}"
            f" ({card})")
        if not (np.isfinite(rel).all() and rel.max() <= SLM_TOL["loss"]):
            raise AssertionError(f"sharded-lm {tag}: losses "
                                 f"{r0[f'{tag}/losses']} against {base}")
    want_lg = ranks[0]["dp_sp/logits"]
    err = float(np.abs(logits - want_lg).max())
    lim = SLM_TOL["logits"] * float(np.abs(want_lg).max())
    log(f"[sharded-lm] the data=2 x seq=2 checkpoint restored in one "
        f"process: logits on {SLM['logits'][0]} x {SLM['logits'][1]} tokens "
        f"within {err:.3g} of the grid's (tol {lim:.3g})")
    if not err <= lim:
        raise AssertionError(f"sharded-lm: restored logits off by {err}")
    return per_step


# ------------------------------------------------------------ phases 78-80
# A.9's rest and A.10's first half: ParallelInference, the model registry
# with tenancy, warm manifests and the retrying client, the dcn axis
PI_STREAM = 48             # 32-row requests per ParallelInference mode
PI_MODES = (("batched", False), ("instant", False), ("batched", True))
# an answer against its model's output on the same rows, each row's
# largest difference over its largest value: with TF32 off (the request
# and the reference in exact float32), and under the default policy (TF32
# convolutions; the batch the request rode in may differ from the
# reference's). A row of another request differs by far more: pi-resnet
# measures that least difference in each run and fails if a limit is not
# below it, since a check that a swap of rows would pass proves nothing.
FULL_TOL = 1e-5
TF32_TOL = 1e-3
LM_SERVE_TOL = 1e-3        # phase_serve_lm's: of the largest probability
PI_MIXED = (5, 7, 2, 16, 9, 4)  # more rows coalesced and carried, TF32 off
FLEET_SECONDS = 2.0        # the side-by-side and tenant runs
FLEET_ROWS = 8             # rows per tenant and retrying request
TENANTS = {"gold": 3.0, "bronze": 1.0}
TENANT_CLIENTS = 8         # closed-loop clients per weighted tenant
CAPPED = dict(rate=32.0, burst=16.0)  # the over-quota tenant's rows/s
RETRY_CLIENTS = 12


class Forwards:
    """Counts the forwards of each network that return, through an
    instance attribute over its `output`; `direct[name]` is the original
    (uncounted) forward."""

    def __init__(self, nets):
        self.nets, self.n, self.direct = nets, {}, {}
        for name, net in nets.items():
            self.n[name] = 0
            self.direct[name] = net.output
            net.output = functools.partial(self._counted, name)

    def _counted(self, name, x):
        out = self.direct[name](x)
        self.n[name] += 1
        return out

    def restore(self):
        for name, net in self.nets.items():
            net.output = self.direct[name]


def row_diffs(np, out, ref):
    """Each row's largest |out - ref| over its largest |ref|."""
    out = np.asarray(out, np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    return (np.abs(out - ref).max(1)
            / np.maximum(np.abs(ref).max(1), 1e-30))


def served_close(np, tag, out, ref, tol, whole=False):
    """A served answer against the model's own output on its rows: each
    row within `tol` of its largest value with the same argmax, or with
    `whole` (phase_serve_lm's rule) the answer within `tol` of its
    largest."""
    out = np.asarray(out)
    if out.shape != ref.shape or not np.isfinite(out).all():
        raise AssertionError(f"{tag}: bad answer {out.shape}, want "
                             f"{ref.shape}")
    if whole:
        diff = (float(np.abs(out - ref).max())
                / max(float(np.abs(ref).max()), 1e-30))
        if not diff <= tol:
            raise AssertionError(f"{tag}: answer differs by {diff:.3g} of "
                                 f"its largest (tol {tol:g})")
        return diff
    diff = float(row_diffs(np, out, ref).max())
    if not diff <= tol or (out.argmax(-1) != ref.argmax(-1)).any():
        raise AssertionError(f"{tag}: a row differs by {diff:.3g} of its "
                             f"largest (tol {tol:g}) or in its argmax")
    return diff


def ask(server, x, **kw):
    """(answer or the exception, seconds)."""
    t0 = time.perf_counter()
    try:
        out = server.output(x, **kw)
    except Exception as e:
        out = e
    return out, time.perf_counter() - t0


def phase_pi_resnet(torch, np, card):
    """ResNet-50 behind ParallelInference in each of PI_MODES (see the
    module docstring): with TF32 off, requests of 1, 3, 8 and 32 rows and
    of PI_MIXED rows at once, each within FULL_TOL of net.output on its
    rows, and one of another trailing shape that fails alone; then the
    timed stream under the default policy, every answer within TF32_TOL
    of net.output on its own input. Returns the launches summed over the
    modes and the images/s of each."""
    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.parallel import ParallelInference

    net = resnet_net(torch, card_device(torch))
    rng = np.random.default_rng(SEED + 23)
    sizes = (1, 3, 8, BATCH) + PI_MIXED
    xs = [rng.standard_normal((n, *RESNET_SHAPE)).astype(np.float32)
          for n in sizes]
    bad = rng.standard_normal((2, RESNET_SHAPE[0], RESNET_SHAPE[1],
                               4)).astype(np.float32)
    stream = [rng.standard_normal((BATCH, *RESNET_SHAPE)).astype(np.float32)
              for _ in range(4)]
    with dtypes.full_precision():
        refs = [net.output(x).cpu().numpy() for x in xs]
    stream_refs = [net.output(x).cpu().numpy() for x in stream]
    # the least difference between two different requests' rows, against
    # which each limit must be small
    pool_rows = np.concatenate(refs)
    apart = min(float(row_diffs(np, np.roll(pool_rows, k, 0),
                                pool_rows).min())
                for k in range(1, 4))
    if not max(FULL_TOL, TF32_TOL) < apart:
        raise AssertionError(f"pi-resnet: rows of different requests "
                             f"differ by only {apart:.3g} of their "
                             f"largest; the tolerances could not see a "
                             f"swap")
    fwd = Forwards({"resnet": net})
    total, rates = None, {}
    try:
        for mode, gate in PI_MODES:
            tag = mode + (" DL4J_TPU_SERVING=1" if gate else "")
            fwd.n["resnet"] = 0
            reset_counts()
            with env_vars(DL4J_TPU_SERVING="1" if gate else None):
                pi = ParallelInference(net, mode=mode, batch_limit=BATCH)
            try:
                with dtypes.full_precision():
                    with ThreadPoolExecutor(len(xs) + 1) as pool:
                        first = list(pool.map(lambda x: ask(
                            pi, x, deadline_s=300.0), xs + [bad]))
                    torch.cuda.synchronize()
                # one untimed batch under the default policy first, as
                # serve's warmup has it: the dispatcher thread's first
                # TF32 convolutions are not the stream's
                order = [i % len(stream) for i in range(PI_STREAM)]
                warm, _ = ask(pi, stream[0], deadline_s=300.0)
                if isinstance(warm, Exception):
                    raise AssertionError(f"pi-resnet {tag}: {warm!r}")
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                with ThreadPoolExecutor(4) as pool:
                    streamed = list(pool.map(lambda i: ask(
                        pi, stream[i], deadline_s=300.0), order))
                wall = time.perf_counter() - t1
            finally:
                pi.shutdown()
            launches = read_counts()
            n_fwd = fwd.n["resnet"]
            expect_launches(f"pi-resnet {tag}", launches,
                            {"bn_act": 53 * n_fwd})
            total = launches if total is None else add_counts(total,
                                                              launches)
            worst = 0.0
            for x, ref, (out, lat) in zip(xs, refs, first):
                if isinstance(out, Exception):
                    raise AssertionError(f"pi-resnet {tag}: request of "
                                         f"{x.shape[0]} rows failed: {out!r}")
                worst = max(worst, served_close(
                    np, f"pi-resnet {tag} rows={x.shape[0]}", out, ref,
                    FULL_TOL))
            if not isinstance(first[-1][0], Exception):
                raise AssertionError(f"pi-resnet {tag}: the request of "
                                     f"trailing shape {bad.shape[1:]} was "
                                     f"answered")
            worst_stream = 0.0
            for i, (out, _) in zip([0] + order, [(warm, 0.0)] + streamed):
                if isinstance(out, Exception):
                    raise AssertionError(f"pi-resnet {tag}: streamed "
                                         f"request: {out!r:.200}")
                worst_stream = max(worst_stream, served_close(
                    np, f"pi-resnet {tag} streamed", out, stream_refs[i],
                    TF32_TOL))
            rates[tag] = PI_STREAM * BATCH / wall
            lats = sorted(lat for _, lat in streamed)
            log(f"[pi-resnet] {tag}: {n_fwd} batches, launches "
                f"{ {k: v for k, v in launches.items() if v} }; TF32 off, "
                f"requests of {sizes} rows within {worst:.3g} of "
                f"net.output per row (tol {FULL_TOL:g}), latencies "
                + ", ".join(f"{lat * 1e3:.1f}" for _, lat in first[:-1])
                + f" ms; trailing shape {bad.shape[1:]} failed alone "
                f"({type(first[-1][0]).__name__}); stream {PI_STREAM} x "
                f"{BATCH} rows in {wall:.3f} s = {rates[tag]:.1f} img/s, "
                f"p50 {lats[len(lats) // 2] * 1e3:.2f} ms, every answer "
                f"within {worst_stream:.3g} per row (tol {TF32_TOL:g}) "
                f"({card})")
    finally:
        fwd.restore()
    log(f"[pi-resnet] rows of different requests differ by at least "
        f"{apart:.3g} of their largest; images/s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
        + f"; serve's InferenceServer in this call "
        f"{SERVE_RATES.get('serve', float('nan')):.1f} ({card})")
    return total, rates


def write_publication(torch, np, net, tmp):
    """`net` published as a continuous learner publishes: a
    CheckpointManager checkpoint, then the latest pointer naming it; and a
    torn copy beside it (the zip cut in half, the manifest kept). Returns
    (directory, torn directory)."""
    import shutil

    from deeplearning4j_tpu_torch.distributed.continuous import (
        LATEST_POINTER,
        POINTER_VERSION,
    )
    from deeplearning4j_tpu_torch.resilience.checkpoint import (
        CheckpointManager,
        atomic_write_json,
    )

    pub = os.path.join(tmp, "lm_publication")
    mgr = CheckpointManager(pub, save_updater=False)
    mgr.save(net, step=1)
    m = mgr.manifest(1)
    atomic_write_json(os.path.join(pub, LATEST_POINTER), {
        "pointer_version": POINTER_VERSION, "step": 1,
        "sha256": m["sha256"], "time": m["time"], "trace_id": None})
    torn = os.path.join(tmp, "lm_torn")
    shutil.copytree(pub, torn)
    z = os.path.join(torn, "checkpoint_00000001.zip")
    size = os.path.getsize(z)
    with open(z, "r+b") as f:
        f.truncate(size // 2)
    return pub, torn


def phase_registry_fleet(torch, np, card, tmp):
    """One ModelRegistry serving three sources side by side, a second
    version made stable, a second registry warmed from the manifests,
    tenants and the retrying client (see the module docstring). Returns
    the launches."""
    import random
    import threading

    from deeplearning4j_tpu_torch import dtypes
    from deeplearning4j_tpu_torch.models import write_model
    from deeplearning4j_tpu_torch.serving import (
        InferenceServer,
        ModelRegistry,
        TenancyController,
        TenantQuotaError,
        submit_with_retry,
        warmstart,
    )
    from deeplearning4j_tpu_torch.zoo import TransformerLM

    dev = card_device(torch)
    t0 = time.perf_counter()
    zip_path = os.path.join(tmp, "resnet50.zip")
    resnet = resnet_net(torch, dev)
    write_model(resnet, zip_path, save_updater=False)
    del resnet
    lm = TransformerLM(**LM, seed=SEED).init(device=dev)
    pub, torn = write_publication(torch, np, lm, tmp)
    del lm
    torch.cuda.empty_cache()
    log(f"[registry-fleet] sources written in "
        f"{time.perf_counter() - t0:.2f} s: {os.path.basename(zip_path)} "
        f"({os.path.getsize(zip_path) / 1e6:.1f} MB), a TransformerLM "
        f"publication and a torn one beside it")
    rng = np.random.default_rng(SEED + 29)
    t, vocab = LM["max_length"], LM["num_classes"]

    def images(n):
        return rng.standard_normal((n, *RESNET_SHAPE)).astype(np.float32)

    def ids(n):
        return rng.integers(0, vocab, (n, t)).astype(np.int32)

    def digits(n):
        return rng.standard_normal((n, 28, 28, 1)).astype(np.float32)

    warm_dir = os.path.join(tmp, "warm")
    reg = ModelRegistry(warm_cache_dir=warm_dir)
    reg2 = fwd = None
    try:
        try:
            reg.register("lm-torn", torn, batch_limit=LM_BATCH)
        except IOError as e:
            log(f"[registry-fleet] torn publication refused: {e}")
        else:
            raise AssertionError("registry-fleet: a torn publication was "
                                 "registered")
        t1 = time.perf_counter()
        mv = {"resnet": reg.register("resnet", zip_path, batch_limit=BATCH),
              "lm": reg.register("lm", pub, batch_limit=LM_BATCH),
              "lenet": reg.register("lenet", "zoo:LeNet",
                                    batch_limit=BATCH),
              "resnet-v2": reg.register("resnet", "zoo:ResNet50",
                                        version="v2", stable=False,
                                        batch_limit=BATCH)}
        log(f"[registry-fleet] resolved and registered {reg.models()} "
            f"(resnet v1 from the zip, v2 zoo:ResNet50; lm through "
            f"{continuous_step(pub)}) in {time.perf_counter() - t1:.2f} s")
        fwd = Forwards({k: v.server.model for k, v in mv.items()})
        make = {"resnet": images, "resnet-v2": images, "lm": ids,
                "lenet": digits}
        reset_counts()
        t1 = time.perf_counter()
        reg.warm("resnet", example=images(1))
        reg.warm("resnet", "v2", example=images(1))
        reg.warm("lm", example=ids(1))
        reg.warm("lenet", example=digits(1))
        torch.cuda.synchronize()
        log(f"[registry-fleet] warmed every bucket in "
            f"{time.perf_counter() - t1:.2f} s; manifests "
            + ", ".join(f"{m['model']}:{m['version']} {m['buckets']}"
                        for m in warmstart.list_manifests(warm_dir)))

        # side by side: each model's requests at once, TF32 off; every
        # answer is held against its model's output after the launches are
        # read (with TF32 off where it was served so)
        checks = []  # (what, model, x, answer, TF32 off)
        asks = [(name, make[name](n)) for name in ("resnet", "lm", "lenet")
                for n in ((1, 3, LM_BATCH) if name == "lm" else
                          (1, 3, 8, BATCH))]
        with dtypes.full_precision():
            with ThreadPoolExecutor(len(asks)) as pool:
                got = list(pool.map(lambda a: ask(
                    reg.get(a[0]).server, a[1], deadline_s=300.0), asks))
            for (name, x), (out, _) in zip(asks, got):
                if isinstance(out, Exception):
                    raise AssertionError(f"registry-fleet {name}: {out!r}")
                checks.append((f"side by side, {x.shape[0]} rows", name,
                               x, out, True))
            reg.set_stable("resnet", "v2")
            if reg.get("resnet").version != "v2":
                raise AssertionError("registry-fleet: set_stable did not "
                                     "move")
            x = images(8)
            checks.append(("stable v2", "resnet-v2", x, reg.get(
                "resnet").server.output(x, deadline_s=300.0), True))

        # served rates side by side
        reg.set_stable("resnet", "v1")
        rows = {"resnet": 0, "lm": 0, "lenet": 0}
        lock = threading.Lock()
        end = time.perf_counter() + FLEET_SECONDS
        fixed = {"resnet": images(BATCH), "lm": ids(LM_BATCH),
                 "lenet": digits(BATCH)}

        def client(name):
            server, x = reg.get(name).server, fixed[name]
            while time.perf_counter() < end:
                out = server.output(x, deadline_s=300.0)
                with lock:
                    rows[name] += out.shape[0]

        t1 = time.perf_counter()
        with ThreadPoolExecutor(6) as pool:
            list(pool.map(client, ["resnet"] * 3 + ["lm"] + ["lenet"] * 2))
        wall = time.perf_counter() - t1
        log(f"[registry-fleet] side by side for {wall:.2f} s: resnet "
            f"{rows['resnet'] / wall:.1f} images/s, lm "
            f"{rows['lm'] * t / wall:.1f} tokens/s ({rows['lm'] / wall:.2f} "
            f"sequences/s), lenet {rows['lenet'] / wall:.1f} images/s "
            f"({card})")

        # a second registry warmed from the manifests alone
        net = mv["resnet"].server.model
        reg2 = ModelRegistry(warm_cache_dir=warm_dir)
        warm = reg2.register("resnet", net, batch_limit=BATCH)
        cold = reg2.register("resnet", net, version="cold",
                             batch_limit=BATCH, stable=False)
        t1 = time.perf_counter()
        reg2.warm("resnet")
        warm_s = time.perf_counter() - t1
        x = images(8)
        out, warm_first = ask(warm.server, x, deadline_s=300.0)
        checks.append(("warm replica", "resnet", x, out, False))
        out, cold_first = ask(cold.server, x, deadline_s=300.0)
        checks.append(("cold replica", "resnet", x, out, False))
        warmed = sorted(b for _, b in warm.server.warmed_rows)
        log(f"[registry-fleet] second registry warmed resnet:v1 from its "
            f"manifest alone (buckets {warmed}) in {warm_s:.2f} s; first "
            f"request of 8 rows "
            f"{warm_first * 1e3:.2f} ms warm against {cold_first * 1e3:.2f} "
            f"ms on a cold replica ({card})")

        # tenants on one shared server under backlog
        ctrl = TenancyController(default_rate=1e9, quantum=FLEET_ROWS)
        for name, w in TENANTS.items():
            ctrl.add_tenant(name, rate=1e9, burst=1e9, weight=w)
        ctrl.add_tenant("capped", weight=1.0, **CAPPED)
        shared = InferenceServer(model=net, batch_limit=BATCH,
                                 queue_limit=64, tenancy=ctrl,
                                 name="tenants")
        served = dict.fromkeys(list(TENANTS) + ["capped"], 0)
        quota = [0]
        x = images(FLEET_ROWS)
        end = time.perf_counter() + FLEET_SECONDS

        def tenant(name):
            while time.perf_counter() < end:
                try:
                    out = shared.output(x, deadline_s=300.0, tenant=name)
                except TenantQuotaError as e:
                    with lock:
                        quota[0] += 1
                    time.sleep(min(e.retry_after_s or 0.01, 0.05))
                    continue
                with lock:
                    if not served[name]:
                        checks.append((f"tenant {name}", "resnet", x, out,
                                       False))
                    served[name] += out.shape[0]

        try:
            with ThreadPoolExecutor(2 * TENANT_CLIENTS + 2) as pool:
                list(pool.map(tenant, ["gold"] * TENANT_CLIENTS
                              + ["bronze"] * TENANT_CLIENTS
                              + ["capped"] * 2))
        finally:
            shared.shutdown()
        ratio = served["gold"] / max(served["bronze"], 1)
        log(f"[registry-fleet] tenants gold:bronze weights 3:1 on one "
            f"ResNet-50 server, {TENANT_CLIENTS} closed-loop clients each "
            f"of {FLEET_ROWS} rows for {FLEET_SECONDS:g} s: served rows "
            f"{served}, ratio "
            f"{ratio:.3f}; capped ({CAPPED['rate']:g} rows/s) "
            f"TenantQuotaError x {quota[0]}; "
            f"{ctrl.snapshot()['tenants']['capped']['shed']} quota sheds "
            f"in the controller ({card})")
        if not (served["gold"] > served["bronze"] > 0 and quota[0] > 0):
            raise AssertionError(f"registry-fleet: tenants {served}, quota "
                                 f"refusals {quota[0]}")

        # the retrying client through a server that sheds
        # one request per batch, two queued at most: the rest shed
        shedding = InferenceServer(model=net, batch_limit=FLEET_ROWS,
                                   queue_limit=2, name="shedding")
        sleeps = []

        def retrying(i):
            def sleep(s):
                with lock:
                    sleeps.append(s)
                time.sleep(s)

            return submit_with_retry(
                shedding, x, attempts=50, base_backoff_s=0.005,
                max_backoff_s=0.2, request_deadline_s=300.0, sleep=sleep,
                rng=random.Random(SEED + i))

        try:
            t1 = time.perf_counter()
            with ThreadPoolExecutor(RETRY_CLIENTS) as pool:
                outs = list(pool.map(retrying, range(RETRY_CLIENTS)))
            wall = time.perf_counter() - t1
        finally:
            shedding.shutdown()
        checks += [("retrying client", "resnet", x, out, False)
                   for out in outs]
        log(f"[registry-fleet] submit_with_retry: {RETRY_CLIENTS} clients "
            f"through a server of batch_limit {FLEET_ROWS} and queue_limit "
            f"2, all served in {wall:.2f} "
            f"s after {len(sleeps)} shed retries (slept "
            f"{sum(sleeps) * 1e3:.1f} ms in all)")
        if not sleeps:
            raise AssertionError("registry-fleet: the server never shed")
    finally:
        for r in (reg, reg2):
            if r is not None:
                r.shutdown()
        if fwd is not None:
            fwd.restore()
    launches = read_counts()
    n_resnet = fwd.n["resnet"] + fwd.n["resnet-v2"]
    log(f"[registry-fleet] forwards {fwd.n}; launches "
        f"{ {k: v for k, v in launches.items() if v} } (bn_act 53 per "
        f"ResNet-50 forward, flash_attention {LM['n_layers']} per "
        f"TransformerLM forward)")
    expect_launches("registry-fleet", launches, {
        "bn_act": 53 * n_resnet,
        "flash_attention": LM["n_layers"] * fwd.n["lm"]})
    worst = {}
    for what, name, x, out, full in checks:
        with (dtypes.full_precision() if full else contextlib.nullcontext()):
            ref = fwd.direct[name](x).float().cpu().numpy()
        key = f"{name} ({'TF32 off' if full else 'default'})"
        worst[key] = max(worst.get(key, 0.0), served_close(
            np, f"registry-fleet {name} ({what})", out, ref,
            LM_SERVE_TOL if name == "lm" else FULL_TOL if full
            else TF32_TOL, whole=name == "lm"))
    log(f"[registry-fleet] {len(checks)} answers against their model's "
        f"output, worst " + ", ".join(f"{k} {v:.3g}" for k, v in
                                      worst.items())
        + f" (per row: tol {FULL_TOL:g} TF32 off, {TF32_TOL:g} default; "
        f"lm {LM_SERVE_TOL:g} of its largest); "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------ phases 81-83
# A.10's second half and A.11's first pieces: the SLO-gated canary Router,
# the Autoscaler's replica pool, the telemetry core on the serving path
ROUTER_SIZES = (1, 3, 8, BATCH)     # rows of the routed ResNet-50 requests
ROUTER_MIN_REQUESTS = 8             # canary requests a stage must soak
# the version rules' windows, shrunk through rule_kwargs as the JAX tests
# do (ticks come with a fake `now`, 61 s apart), and the latency rule's
# bound: 1 s, so that a first batch of a shape on a fresh dispatcher thread
# (cuDNN's algorithm choice) cannot hold the ramp; availability is what
# the rollback below is about
ROUTER_RULES = dict(fast_window_s=60.0, slow_window_s=600.0,
                    latency_threshold_s=1.0)
ROUTER_LM_EVERY = 24                # one 1-row TransformerLM request per 24
ROUTER_STREAM = 48                  # 32-row requests timed through the Router
ROUTER_LM_STREAM = (8, 4)           # LM requests x rows timed by name
ROLLBACK_REQUESTS = 40              # requests during v3's 5% stage
AUTOSCALE_CLIENTS = 16                  # the load step's closed-loop clients
AUTOSCALE_ROWS = (8, 16, 24, 32)        # their request sizes, cycled
AUTOSCALE_BANDS = dict(queue_depth_high=4.0, queue_depth_low=2.0,
                   ema_high_s=1.0, ema_low_s=0.1, min_dwell_s=1.0)
AUTOSCALE_WINDOW = 1.5                  # s of load timed before / after scaling
AUTOSCALE_TICK = 0.2                    # s between evaluate() ticks
AUTOSCALE_LIMIT = 12.0                  # s the scale out or in may take at most
AUTOSCALE_DEADLINE = 30.0               # s each fleet request may take at most
TENANT_ROUNDS = 20                  # noisy / quiet rounds of tenant-burst
TENANT_TICK = 0.1                   # s of the quotas' clock per round
# the noisy tenant's quota covers its own 8 rows a round (80 rows/s), not
# the rounds tenant_burst amplifies tenfold
NOISY = dict(rate=100.0, burst=20.0)
TELEMETRY_STREAM = 48               # 32-row requests per telemetry setting


def hist_quantile(fam, labels, q):
    """The q-quantile's upper bound from a labeled histogram family's
    buckets (the Prometheus le series); None before any observation."""
    for lab, child in fam.child_items():
        if lab == labels:
            pairs = child.bucket_counts()
            total = pairs[-1][1]
            if not total:
                return None
            for bound, cum in pairs:
                if cum >= q * total:
                    return bound
    return None


def routed_version(fraction, counter):
    """The side the Router's counter split gives the next routed request
    while a rollout runs at `fraction`: request n goes to the canary iff
    floor(n f) advanced. `counter` is the split's running count, which,
    as the Router's, advances only while a rollout runs."""
    counter[0] += 1
    k = counter[0]
    return "canary" if math.floor(k * fraction) > math.floor(
        (k - 1) * fraction) else "stable"


def phase_router_canary(torch, np, card, tmp):
    """router-canary (see the module docstring). Returns the launches."""
    from deeplearning4j_tpu_torch.resilience import chaos
    from deeplearning4j_tpu_torch.serving import ModelRegistry, Router
    from deeplearning4j_tpu_torch.serving.errors import ServingError
    from deeplearning4j_tpu_torch.telemetry import flight, metrics
    from deeplearning4j_tpu_torch.telemetry import trace as trace_mod
    from deeplearning4j_tpu_torch.zoo import ResNet50, TransformerLM

    dev = card_device(torch)
    t0 = time.perf_counter()
    nets = {v: ResNet50(num_classes=1000, input_shape=RESNET_SHAPE,
                        seed=s).init(device=dev)
            for v, s in (("v1", SEED), ("v2", SEED + 1), ("v3", SEED + 2))}
    lm = TransformerLM(**LM, seed=SEED).init(device=dev)
    rng = np.random.default_rng(SEED + 31)
    t, vocab = LM["max_length"], LM["num_classes"]

    def images(n):
        return rng.standard_normal((n, *RESNET_SHAPE)).astype(np.float32)

    def ids(n):
        return rng.integers(0, vocab, (n, t)).astype(np.int32)

    flight_dir = os.path.join(tmp, "flight")
    metrics.registry().reset()
    reg = ModelRegistry()
    fwd = Forwards(dict(nets, lm=lm))
    reset_counts()
    try:
        for v, net in nets.items():
            reg.register("resnet", net, version=v, stable=v == "v1",
                         batch_limit=BATCH)
            reg.warm("resnet", v, example=images(1))
        reg.register("lm", lm, batch_limit=LM_BATCH)
        reg.warm("lm", example=ids(1))
        torch.cuda.synchronize()
        log(f"[router-canary] ResNet-50 v1, v2, v3 (seeds {SEED}, "
            f"{SEED + 1}, {SEED + 2}) and the TransformerLM {LM} registered "
            f"and warmed in {time.perf_counter() - t0:.2f} s")
        rt = Router(reg)
        answers = []       # (model, version, x, answer, stage)
        per_stage = {}     # (stage, version) -> requests
        counter, n_req = [0], 0
        now = 1000.0
        ro = rt.start_rollout("resnet", "v2", min_requests=ROUTER_MIN_REQUESTS,
                              **ROUTER_RULES)
        rt.evaluate(now=now)
        ticks = 0
        t1 = time.perf_counter()
        while ro.state == "running":
            stage = ro.history[-1]
            for _ in range(max(ROUTER_MIN_REQUESTS,
                               int(math.ceil(ROUTER_MIN_REQUESTS
                                             / ro.fraction)))):
                n_req += 1
                if n_req % ROUTER_LM_EVERY == 0:
                    x = ids(1)
                    answers.append(("lm", "v1", x, rt.output(
                        "lm", x, deadline_s=AUTOSCALE_DEADLINE), stage))
                x = images(ROUTER_SIZES[n_req % len(ROUTER_SIZES)])
                side = routed_version(ro.fraction, counter)
                v = "v2" if side == "canary" else "v1"
                out = rt.output("resnet", x, deadline_s=AUTOSCALE_DEADLINE)
                answers.append(("resnet", v, x, out, stage))
                per_stage[(stage, v)] = per_stage.get((stage, v), 0) + 1
            now += 61.0
            rt.evaluate(now=now)
            ticks += 1
            if ticks > 12:
                raise AssertionError(f"router-canary: v2 not promoted after "
                                     f"{ticks} ticks ({ro.history})")
        ramp_s = time.perf_counter() - t1
        if ro.state != "promoted" or reg.get("resnet").version != "v2":
            raise AssertionError(f"router-canary: rollout of v2 ended "
                                 f"{ro.state} ({ro.history})")
        log(f"[router-canary] v2 ramp {ro.history} in {ticks} ticks "
            f"({ramp_s:.2f} s): requests per stage and version "
            + ", ".join(f"{s}% {v} {n}" for (s, v), n in
                        sorted(per_stage.items(), key=lambda kv: (
                            int(kv[0][0]), kv[0][1])))
            + f"; {sum(1 for a in answers if a[0] == 'lm')} TransformerLM "
            f"requests routed by name between them")

        # rates through the Router at the promoted version
        stream = [images(BATCH) for _ in range(4)]
        t1 = time.perf_counter()
        with ThreadPoolExecutor(4) as pool:
            outs = list(pool.map(lambda i: rt.output(
                "resnet", stream[i % 4], deadline_s=AUTOSCALE_DEADLINE),
                range(ROUTER_STREAM)))
        wall = time.perf_counter() - t1
        img_s = ROUTER_STREAM * BATCH / wall
        answers += [("resnet", "v2", stream[i % 4], o, "stream")
                    for i, o in enumerate(outs[:4])]
        n_lm, rows_lm = ROUTER_LM_STREAM
        lm_x = ids(rows_lm)
        t1 = time.perf_counter()
        for _ in range(n_lm):
            lm_out = rt.output("lm", lm_x, deadline_s=AUTOSCALE_DEADLINE)
        lm_wall = time.perf_counter() - t1
        tok_s = n_lm * rows_lm * t / lm_wall
        answers.append(("lm", "v1", lm_x, lm_out, "stream"))
        log(f"[router-canary] through the Router: ResNet-50 {img_s:.1f} "
            f"images/s ({ROUTER_STREAM} x {BATCH} rows, 4 clients), "
            f"TransformerLM {tok_s:.1f} tokens/s ({n_lm} x {rows_lm} x {t} "
            f"tokens by name, one client) ({card})")

        # a broken canary: v3 under canary_nan rolls back in one tick
        with env_vars(DL4J_TPU_CHAOS="canary_nan@" + ":".join(
                str(i) for i in range(1, 200)),
                DL4J_TPU_TELEMETRY="1", DL4J_TPU_FLIGHT_DIR=flight_dir):
            chaos.reset_fault_points()
            trace_mod.tracer().clear()
            ro3 = rt.start_rollout("resnet", "v3", **ROUTER_RULES)
            rt.evaluate(now=now)
            failed = stable = 0
            for k in range(ROLLBACK_REQUESTS):
                x = images(ROUTER_SIZES[k % len(ROUTER_SIZES)])
                side = routed_version(ro3.fraction, counter)
                try:
                    out = rt.output("resnet", x, deadline_s=AUTOSCALE_DEADLINE)
                except ServingError as e:
                    if side != "canary":
                        raise AssertionError(f"router-canary: a stable "
                                             f"request failed: {e!r}")
                    failed += 1
                    continue
                if side == "canary":
                    raise AssertionError("router-canary: a canary_nan "
                                         "answer was served")
                stable += 1
                answers.append(("resnet", "v2", x, out, "v3 rollout"))
            now += 61.0
            rt.evaluate(now=now)
            rollback_tick = 1
            after = [(x, rt.output("resnet", x, deadline_s=AUTOSCALE_DEADLINE))
                     for x in (images(8) for _ in range(4))]
            answers += [("resnet", "v2", x, o, "after rollback")
                        for x, o in after]
            bundles = [p for p in flight.list_bundles(flight_dir)
                       if "canary_rollback" in os.path.basename(p)]
            chaos.reset_fault_points()
        if ro3.state != "rolled_back" or ro3.history != ["5", "rollback"]:
            raise AssertionError(f"router-canary: v3 did not roll back in "
                                 f"one tick: {ro3.state} {ro3.history}")
        if len(bundles) != 1 or bundles[0] != ro3.rollback_bundle:
            raise AssertionError(f"router-canary: canary_rollback bundles "
                                 f"{bundles}")
        doc = flight.load_bundle(bundles[0])
        if (doc["reason"] != "canary_rollback"
                or doc["canary"]["canary"] != "v3"
                or len(doc["canary"]["offending_traces"]) != failed):
            raise AssertionError(f"router-canary: bundle {doc['canary']}")
        log(f"[router-canary] v3 under canary_nan: {failed} canary requests "
            f"failed typed, {stable} stable answered, rolled back at tick "
            f"{rollback_tick} after its start ({ro3.rollback_rules}); one "
            f"canary_rollback bundle ({os.path.basename(bundles[0])}, "
            f"{len(doc['canary']['offending_traces'])} offending traces) "
            f"read back by load_bundle")
        lat = metrics.registry().get("dl4j_tpu_model_latency_seconds")
        log("[router-canary] dl4j_tpu_model_latency_seconds p50 / p99 "
            "upper bounds: " + ", ".join(
                f"{m}:{v} {hist_quantile(lat, dict(model=m, version=v), 0.5)}"
                f" / {hist_quantile(lat, dict(model=m, version=v), 0.99)} s"
                for m, v in (("resnet", "v1"), ("resnet", "v2"),
                             ("lm", "v1"))) + f" ({card})")
    finally:
        reg.shutdown()
        fwd.restore()
    launches = read_counts()
    n_resnet = fwd.n["v1"] + fwd.n["v2"] + fwd.n["v3"]
    expect_launches("router-canary", launches, {
        "bn_act": 53 * n_resnet,
        "flash_attention": LM["n_layers"] * fwd.n["lm"]})
    # every answer against the output of the version the split says
    # answered it; the versions must be far apart for that to mean anything
    x = images(8)
    apart = float(row_diffs(np, fwd.direct["v1"](x).cpu().numpy(),
                            fwd.direct["v2"](x).cpu().numpy()).min())
    if not TF32_TOL < apart:
        raise AssertionError(f"router-canary: v1 and v2 rows differ by only "
                             f"{apart:.3g}; a swap would pass")
    worst = {}
    for model, v, x, out, stage in answers:
        ref = fwd.direct["lm" if model == "lm" else v](x).float().cpu().numpy()
        key = f"{model}:{v}"
        worst[key] = max(worst.get(key, 0.0), served_close(
            np, f"router-canary {key} ({stage})", out, ref,
            LM_SERVE_TOL if model == "lm" else TF32_TOL,
            whole=model == "lm"))
    log(f"[router-canary] forwards {fwd.n}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; {len(answers)} "
        f"answers against their version's output, worst "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f" (ResNet-50 per row {TF32_TOL:g}, versions apart by "
        f"{apart:.3g}; lm {LM_SERVE_TOL:g} of its largest); "
        f"{time.perf_counter() - t0:.1f} s")
    del nets, lm
    return launches


def phase_fleet_autoscale(torch, np, card, tmp):
    """fleet-autoscale (see the module docstring). Returns the launches."""
    import threading

    from deeplearning4j_tpu_torch.serving import (
        Autoscaler,
        ModelRegistry,
        Router,
        TenancyController,
        TenantQuotaError,
    )
    from deeplearning4j_tpu_torch.serving.errors import (
        DispatcherCrashedError,
        ServingError,
    )
    from deeplearning4j_tpu_torch.resilience import chaos

    t0 = time.perf_counter()
    net = resnet_net(torch, card_device(torch))
    rng = np.random.default_rng(SEED + 37)
    xs = {n: rng.standard_normal((n, *RESNET_SHAPE)).astype(np.float32)
          for n in AUTOSCALE_ROWS}
    refs = {n: net.output(x).float().cpu().numpy() for n, x in xs.items()}
    reg = ModelRegistry(warm_cache_dir=os.path.join(tmp, "warm"))
    # the quotas' clock is the tenant rounds' own: TENANT_TICK a round
    tclock = [0.0]
    ctrl = TenancyController(default_rate=1e9, default_burst=1e9,
                             clock=lambda: tclock[0])
    ctrl.add_tenant("quiet", rate=1e9, burst=1e9)
    ctrl.add_tenant("noisy", **NOISY)
    fwd = Forwards({"resnet": net})
    reset_counts()
    pool = None
    lock = threading.Lock()
    worst = [0.0]
    typed = {}
    broken = []  # a client thread's failure, raised after the join

    def check(out, n, what):
        d = served_close(np, f"fleet-autoscale ({what})", out, refs[n],
                         TF32_TOL)
        with lock:
            worst[0] = max(worst[0], d)

    try:
        reg.register("resnet", net, batch_limit=BATCH)
        reg.warm("resnet", example=xs[8][:1])
        rt = Router(reg)
        pool = Autoscaler.for_model(reg, "resnet", tenancy=ctrl,
                                    min_replicas=1, max_replicas=3,
                                    **AUTOSCALE_BANDS)
        rt.attach_autoscaler("resnet", pool)
        torch.cuda.synchronize()
        log(f"[fleet-autoscale] ResNet-50 registered, warmed (manifest "
            f"recorded), pool of {pool.snapshot()['replicas_live']} replica "
            f"behind the Router in {time.perf_counter() - t0:.2f} s")

        stop = threading.Event()
        served = [0]
        requeued = {}  # client thread -> end of its answer after a requeue
        hit = set()    # client threads the crashed replica refused

        def client(k, sizes=AUTOSCALE_ROWS):
            i = k
            try:
                while not stop.is_set():
                    n = sizes[i % len(sizes)]
                    i += 1
                    s = time.perf_counter()
                    try:
                        out = rt.output("resnet", xs[n],
                                        deadline_s=AUTOSCALE_DEADLINE)
                    except ServingError as e:
                        with lock:
                            typed[type(e).__name__] = typed.get(
                                type(e).__name__, 0) + 1
                        if time.perf_counter() - s > AUTOSCALE_DEADLINE + 1.0:
                            raise AssertionError("a caller blocked past "
                                                 "its deadline")
                        continue
                    check(out, n, "load")
                    me = threading.get_ident()
                    with lock:
                        served[0] += n
                        if me in hit:
                            hit.discard(me)
                            requeued[me] = time.perf_counter()
            except Exception as e:
                broken.append(e)

        def window(seconds):
            """(images/s, rows per dispatched batch, the replicas' mean
            dispatch EMA in ms) over `seconds` of the load."""
            a, f = served[0], fwd.n["resnet"]
            t1 = time.perf_counter()
            time.sleep(seconds)
            rows, n = served[0] - a, fwd.n["resnet"] - f
            ema = pool.snapshot()["signals"]["ema_latency_s"] or 0.0
            return (rows / (time.perf_counter() - t1), rows / max(n, 1),
                    ema * 1e3)

        counts = []
        first_ms = []
        seen = {r.replica_id for r in pool._replicas}
        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(AUTOSCALE_CLIENTS)]
        for th in threads:
            th.start()
        try:
            time.sleep(0.5)  # the load settles on one replica
            before = window(AUTOSCALE_WINDOW)
            end = time.perf_counter() + AUTOSCALE_LIMIT
            while (pool.snapshot()["replicas_live"] < pool.max_replicas
                   and time.perf_counter() < end):
                rt.evaluate()
                counts.append(pool.snapshot()["replicas_live"])
                for rep in list(pool._replicas):
                    if rep.replica_id not in seen:
                        seen.add(rep.replica_id)
                        s = time.perf_counter()
                        out = rep.server.output(xs[8],
                                                deadline_s=AUTOSCALE_DEADLINE)
                        first_ms.append((time.perf_counter() - s) * 1e3)
                        check(out, 8, f"{rep.replica_id} first request")
                time.sleep(AUTOSCALE_TICK)
            if pool.snapshot()["replicas_live"] < 2:
                raise AssertionError(f"fleet-autoscale: no scale out under "
                                     f"{AUTOSCALE_CLIENTS} clients ({counts})")
            after = window(AUTOSCALE_WINDOW)
            log(f"[fleet-autoscale] load step 1 -> {AUTOSCALE_CLIENTS} clients "
                f"of {AUTOSCALE_ROWS} rows: replicas per tick {counts}; "
                f"{before[0]:.1f} images/s on 1 replica ({before[1]:.1f} "
                f"rows a batch, dispatch EMA {before[2]:.2f} ms), "
                f"{after[0]:.1f} on {pool.snapshot()['replicas_live']} "
                f"({after[1]:.1f} rows a batch, EMA {after[2]:.2f} ms); "
                f"spawned replicas' first 8-row request under the load "
                + ", ".join(f"{v:.1f}" for v in first_ms) + f" ms ({card})")

            # one replica's dispatcher dies under the load: its callers
            # requeue onto the survivors
            victim = pool._replicas[0]
            inner = victim.server._dispatch
            refused = victim.server.output
            crash_at = []

            def dying(xp):
                crash_at.append(time.perf_counter())
                raise SystemExit("replica dispatcher crashed")

            def watched(x, **kw):
                # a caller the dead dispatcher refused; the pool requeues it
                try:
                    return refused(x, **kw)
                except DispatcherCrashedError:
                    with lock:
                        hit.add(threading.get_ident())
                    raise

            # every caller inside the victim when it dies must have come in
            # through the watch: the calls already in it finish first
            victim.server.output = watched
            time.sleep(0.5)
            victim.server._dispatch = dying
            end = time.perf_counter() + AUTOSCALE_LIMIT
            while not crash_at and time.perf_counter() < end:
                time.sleep(0.01)
            if not crash_at:
                raise AssertionError("fleet-autoscale: the victim never "
                                     "dispatched")
            end = time.perf_counter() + AUTOSCALE_DEADLINE
            while time.perf_counter() < end:
                with lock:
                    if requeued and not hit:
                        break
                time.sleep(0.01)
            with lock:
                if hit or not requeued:
                    raise AssertionError(f"fleet-autoscale: callers the "
                                         f"crash refused: {len(hit)} not "
                                         f"answered, {len(requeued)} "
                                         f"answered")
                recover_ms = (max(requeued.values()) - crash_at[0]) * 1e3
            rt.evaluate()
            info = pool.membership.get(victim.replica_id)
            if info.state.value != "evicted" or info.evict_reason != "crash":
                raise AssertionError(f"fleet-autoscale: the crashed replica "
                                     f"is {info.state} ({info.evict_reason})")
            victim.server._dispatch = inner
            victim.server.output = refused
            # the serving_dispatch point: the next dispatched batch of any
            # replica fails typed, and no one else's
            with env_vars(DL4J_TPU_CHAOS="serving_dispatch@1"):
                chaos.reset_fault_points()
                end = time.perf_counter() + AUTOSCALE_LIMIT
                while (typed.get("DispatchFailedError", 0) == 0
                       and time.perf_counter() < end):
                    time.sleep(0.01)
                chaos.reset_fault_points()
            log(f"[fleet-autoscale] {victim.replica_id}'s dispatcher crashed "
                f"under the load: evicted ({info.evict_reason}), "
                f"{len(requeued)} callers it refused requeued onto the "
                f"survivors and answered, the last {recover_ms:.1f} ms "
                f"after the crash; "
                f"serving_dispatch@1 failed one batch typed; typed errors "
                f"{typed} ({card})")
        finally:
            stop.set()
            for th in threads:
                th.join(AUTOSCALE_DEADLINE + 5.0)
        if broken:
            raise broken[0]
        if set(typed) != {"DispatchFailedError"}:
            raise AssertionError(f"fleet-autoscale: typed errors {typed}")

        # the load drops to one client: the pool scales in after the dwell
        stop = threading.Event()
        th = threading.Thread(target=client, args=(0, (8,)), daemon=True)
        th.start()
        counts = [pool.snapshot()["replicas_live"]]
        t1 = time.perf_counter()
        try:
            end = t1 + 2 * AUTOSCALE_LIMIT
            while (pool.snapshot()["replicas_live"] > pool.min_replicas
                   and time.perf_counter() < end):
                rt.evaluate()
                counts.append(pool.snapshot()["replicas_live"])
                time.sleep(AUTOSCALE_TICK)
        finally:
            stop.set()
            th.join(AUTOSCALE_DEADLINE + 5.0)
        if broken:
            raise broken[0]
        # a request queued on the drained replica resolves typed
        if set(typed) - {"DispatchFailedError", "ShutdownError"}:
            raise AssertionError(f"fleet-autoscale: typed errors {typed}")
        ins = [e for e in pool.snapshot()["events"]
               if e["direction"] == "in" and e["reason"] == "idle"]
        if not ins:
            raise AssertionError(f"fleet-autoscale: no scale in after the "
                                 f"load dropped ({counts})")
        log(f"[fleet-autoscale] load dropped to 1 client: replicas per "
            f"tick {counts} over {time.perf_counter() - t1:.2f} s "
            f"({len(ins)} scale-in(s), dwell {AUTOSCALE_BANDS['min_dwell_s']} s)")

        # a bursting tenant sheds only itself
        with env_vars(DL4J_TPU_CHAOS="tenant_burst@" + ":".join(
                str(2 * i + 1) for i in range(TENANT_ROUNDS))):
            chaos.reset_fault_points()
            noisy_shed, quiet_ok = 0, 0
            for _ in range(TENANT_ROUNDS):
                tclock[0] += TENANT_TICK
                try:
                    out = rt.output("resnet", xs[8], tenant="noisy",
                                    deadline_s=AUTOSCALE_DEADLINE)
                    check(out, 8, "noisy tenant")
                except TenantQuotaError:
                    noisy_shed += 1
                out = rt.output("resnet", xs[8], tenant="quiet",
                                deadline_s=AUTOSCALE_DEADLINE)
                check(out, 8, "quiet tenant")
                quiet_ok += 1
            chaos.reset_fault_points()
        tenants = ctrl.snapshot()["tenants"]
        if not noisy_shed or tenants["quiet"]["shed"]:
            raise AssertionError(f"fleet-autoscale: tenants {tenants}")
        log(f"[fleet-autoscale] tenant_burst on each of the noisy tenant's "
            f"admissions (quota {NOISY['rate']:g} rows/s, burst "
            f"{NOISY['burst']:g}; 8 rows a {TENANT_TICK:g} s round): noisy "
            f"shed {noisy_shed} of {TENANT_ROUNDS}, quiet answered "
            f"{quiet_ok} of {TENANT_ROUNDS} and shed "
            f"{tenants['quiet']['shed']}")
    finally:
        if pool is not None:
            pool.shutdown()
        reg.shutdown()
        fwd.restore()
    launches = read_counts()
    expect_launches("fleet-autoscale", launches,
                    {"bn_act": 53 * fwd.n["resnet"]})
    log(f"[fleet-autoscale] {fwd.n['resnet']} ResNet-50 forwards, launches "
        f"{ {k: v for k, v in launches.items() if v} }; every answer within "
        f"{worst[0]:.3g} of net.output per row (tol {TF32_TOL:g}); "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase_telemetry_serve(torch, np, card, tmp):
    """telemetry-serve (see the module docstring). Returns the launches."""
    from deeplearning4j_tpu_torch.resilience import chaos
    from deeplearning4j_tpu_torch.serving import InferenceServer
    from deeplearning4j_tpu_torch.serving.errors import (
        CircuitOpenError,
        NonFiniteOutputError,
    )
    from deeplearning4j_tpu_torch.telemetry import (
        flight,
        metrics,
        render_prometheus,
    )
    from deeplearning4j_tpu_torch.telemetry import trace as trace_mod

    t0 = time.perf_counter()
    net = resnet_net(torch, card_device(torch))
    rng = np.random.default_rng(SEED)
    stream = [rng.standard_normal((BATCH, *RESNET_SHAPE)).astype(np.float32)
              for _ in range(4)]
    refs = [net.output(x).float().cpu().numpy() for x in stream]
    fwd = Forwards({"resnet": net})
    reset_counts()
    rates, worst, spans = {}, 0.0, None
    flight_dir = os.path.join(tmp, "flight")
    try:
        for gate in ("0", "1"):
            with env_vars(DL4J_TPU_TELEMETRY=gate,
                          DL4J_TPU_FLIGHT_DIR=flight_dir):
                metrics.registry().reset()
                trace_mod.tracer().clear()
                server = InferenceServer(model=net, batch_limit=BATCH,
                                         name=f"telemetry-{gate}")
                try:
                    server.warmup(stream[0][:1])
                    torch.cuda.synchronize()
                    n0 = fwd.n["resnet"]
                    t1 = time.perf_counter()
                    with ThreadPoolExecutor(4) as pool:
                        outs = list(pool.map(lambda i: server.output(
                            stream[i % 4]), range(TELEMETRY_STREAM)))
                    wall = time.perf_counter() - t1
                    batches = fwd.n["resnet"] - n0
                finally:
                    server.shutdown()
                rates[gate] = TELEMETRY_STREAM * BATCH / wall
                for i, out in enumerate(outs):
                    worst = max(worst, served_close(
                        np, f"telemetry-serve gate {gate}", out,
                        refs[i % 4], TF32_TOL))
                text = render_prometheus()
                made = sum(float(line.rsplit(" ", 1)[1])
                           for line in text.splitlines()
                           if line.startswith(
                               "dl4j_tpu_serving_requests_total{"))
                if made != TELEMETRY_STREAM:
                    raise AssertionError(f"telemetry-serve gate {gate}: "
                                         f"dl4j_tpu_serving_requests_total "
                                         f"{made}, requests made "
                                         f"{TELEMETRY_STREAM}")
                if gate == "1":
                    path = os.path.join(tmp, "serve_trace.json")
                    trace_mod.tracer().export_chrome(path)
                    with open(path) as f:
                        events = json.load(f)["traceEvents"]
                    spans = sum(1 for e in events
                                if e["name"] == "serving.dispatch_batch")
                    if spans != batches:
                        raise AssertionError(
                            f"telemetry-serve: {spans} serving.dispatch_batch "
                            f"spans for {batches} dispatched batches")
                    mb = os.path.getsize(path) / 1e6
        log(f"[telemetry-serve] serve's stream ({TELEMETRY_STREAM} x {BATCH} "
            f"rows, 4 clients): {rates['0']:.1f} images/s with "
            f"DL4J_TPU_TELEMETRY off, {rates['1']:.1f} on "
            f"({(rates['0'] / rates['1'] - 1) * 100:+.2f}% time); the chrome "
            f"trace ({mb:.2f} MB) holds {spans} serving.dispatch_batch spans "
            f"for {batches} dispatched batches; "
            f"dl4j_tpu_serving_requests_total = {TELEMETRY_STREAM} requests "
            f"made; every answer within {worst:.3g} per row (tol "
            f"{TF32_TOL:g}) ({card})")

        # serving_nan opens the breaker, which writes one bundle
        x = stream[0][:1]
        with env_vars(DL4J_TPU_TELEMETRY="1", DL4J_TPU_FLIGHT_DIR=flight_dir,
                      DL4J_TPU_CHAOS="serving_nan@1:2:3:4:5"):
            chaos.reset_fault_points()
            server = InferenceServer(model=net, batch_limit=BATCH,
                                     name="telemetry-nan")
            got = []
            try:
                for _ in range(6):
                    try:
                        server.output(x)
                        got.append("ok")
                    except (NonFiniteOutputError, CircuitOpenError) as e:
                        got.append(type(e).__name__)
            finally:
                server.shutdown()
                chaos.reset_fault_points()
        bundles = [p for p in flight.list_bundles(flight_dir)
                   if "serving_breaker" in os.path.basename(p)]
        if got != ["NonFiniteOutputError"] * 5 + ["CircuitOpenError"] or \
                len(bundles) != 1:
            raise AssertionError(f"telemetry-serve: serving_nan gave {got}, "
                                 f"bundles {bundles}")
        doc = flight.load_bundle(bundles[0])
        log(f"[telemetry-serve] serving_nan@1:2:3:4:5: {got}; one "
            f"serving_breaker bundle ({doc['note']}), trace of "
            f"{len(doc['trace']['traceEvents'])} events")
    finally:
        fwd.restore()
    launches = read_counts()
    expect_launches("telemetry-serve", launches,
                    {"bn_act": 53 * fwd.n["resnet"]})
    log(f"[telemetry-serve] {fwd.n['resnet']} ResNet-50 forwards, launches "
        f"{ {k: v for k, v in launches.items() if v} }; "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


def continuous_step(pub):
    from deeplearning4j_tpu_torch.distributed.continuous import (
        read_latest_pointer,
    )

    return f"latest.json step {read_latest_pointer(pub)['step']}"


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
        launches, _ = phase_serve(torch, np, net, card)
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
            iv3_launches, _ = phase_serve(
                torch, np, iv3, card, rows=inception_images(np),
                tag="serve-inception", per_batch={"bn_act": INCEPTION_BN})
            phase_refer_inception(torch, np, iv3, path)
            _, iv3_train_err = phase_kernel(
                torch, bn_cases(iv3, INCEPTION_TRAIN[0]), bw, peak,
                batch=INCEPTION_TRAIN[0], dtypes=(torch.bfloat16,),
                what="training forward", model="InceptionV3",
                tag="kernel-inception")
            max_err = max(max_err, iv3_train_err)
            inception_xent, inception_xent_err = phase_xent(
                torch, bw, peak, peak_bf16, peak_tf32,
                cases=INCEPTION_XENT_CASES, tag="kernel-inception")
            inception_launches = phase_train_inception(torch, np, card, iv3)
            del iv3
            torch.cuda.empty_cache()
            phase_refer_train_inception(torch, np, tmp)
        log(f"[refer-train-inception] the InceptionV3 phases (write, "
            f"import, kernel, serve, refer, train, refer-train) took "
            f"{time.perf_counter() - t0:.1f} s")
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
        refer_dp_single = phase_refer_dp(torch, np)
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
        t0 = time.perf_counter()
        solver_launches = add_counts(phase_solver_charrnn(torch, np, card),
                                     phase_solver_lenet(torch, np, card))
        phase_refer_solver(torch, np)
        window_rnn, char_data = phase_window_rnn(torch, np, card)
        window_launches = add_counts(window_rnn,
                                     phase_window_resnet(torch, np, card))
        records_err = phase_kernel_records(torch)
        lstm_err = max(lstm_err, records_err["lstm_scan"])
        lstm_bwd_err = {k: max(v, records_err[k])
                        for k, v in lstm_bwd_err.items()}
        with tempfile.TemporaryDirectory() as tmp:
            sentry_launches = phase_sentry_charrnn(torch, np, tmp, card,
                                                   char_data)
            records_launches = add_counts(
                phase_records_charrnn(torch, np, tmp, card),
                phase_records_lenet(torch, np, tmp, card))
        log(f"[records-lenet] the solver, window, sentry and records phases "
            f"(solver-charrnn, solver-lenet, refer-solver, window-rnn, "
            f"window-resnet, kernel-records, sentry-charrnn, "
            f"records-charrnn, records-lenet) took "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_layers_a8(torch, np)
        with tempfile.TemporaryDirectory() as tmp:
            phase_keras_a8(torch, np, tmp, card)
        phase_tinyyolo(torch, np, card)
        googlenet_launches = phase_train_googlenet(torch, np, card)
        vit_flash, vit_flash_err = phase_flash(
            torch, bw, peak, peak_bf16, peak_tf32, cases=VIT_FLASH_CASES,
            tag="kernel-vit")
        flash_err = max(flash_err, vit_flash_err)
        vit_bwd, vit_bwd_err = phase_flash_bwd(
            torch, bw, peak, peak_bf16, peak_tf32, cases=VIT_FLASH_CASES,
            tag="kernel-vit")
        flash_bwd_err = max(flash_bwd_err, vit_bwd_err)
        a8_xent, a8_xent_err = phase_xent(
            torch, bw, peak, peak_bf16, peak_tf32, cases=A8_XENT_CASES,
            tag="kernel-vit")
        xent_err = max(xent_err, a8_xent_err)
        vit_launches = phase_train_vit(torch, np, card)
        phase_train_facenet(torch, np, card)
        phase_serve_zoo(torch, np, card, "Darknet19", "serve-darknet19")
        phase_serve_zoo(torch, np, card, "InceptionResNetV1", "serve-irv1")
        a8_launches = add_counts(googlenet_launches, vit_launches)
        log(f"[serve-irv1] the A.8 phases (layers-a8, keras-a8, "
            f"train/serve/refer-tinyyolo, train-googlenet, kernel-vit, "
            f"train-vit, train-facenet, serve-darknet19, serve-irv1) took "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mnist = mnist_flat(torch, np, PRETRAIN[0] * PRETRAIN[1])
        log(f"[pretrain-dbn] {mnist[0].shape[0]} MNIST images flattened to "
            f"784 ({'the seeded sample' if mnist[2] else 'idx files'})")
        mnist = mnist[:2]
        dbn_launches, dbn = phase_pretrain_stack(torch, np, card, "dbn",
                                                 "pretrain-dbn", mnist)
        phase_memory_and_nans(torch, np, dbn, mnist, card)
        sda_launches, sda = phase_pretrain_stack(torch, np, card, "sda",
                                                 "pretrain-sda", mnist)
        del sda
        phase_pretrain_vae(torch, np, card, mnist)
        phase_refer_pretrain(torch, np, dbn, mnist)
        del dbn
        torch.cuda.empty_cache()
        pretrain_xent, pretrain_xent_err = phase_xent(
            torch, bw, peak, peak_bf16, peak_tf32, cases=PRETRAIN_XENT_CASES,
            tag="kernel-a8b")
        xent_err = max(xent_err, pretrain_xent_err)
        pretrain_launches = add_counts(dbn_launches, sda_launches)
        log(f"[kernel-a8b] the pretraining phases (pretrain-dbn, "
            f"pretrain-sda, pretrain-vae, refer-pretrain, kernel-a8b) took "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        tp_flash, tp_flash_err = phase_flash(
            torch, bw, peak, peak_bf16, peak_tf32, cases=TP_FLASH_CASES,
            tag="kernel-tp")
        flash_err = max(flash_err, tp_flash_err)
        tp_bwd, tp_bwd_err = phase_flash_bwd(
            torch, bw, peak, peak_bf16, peak_tf32, cases=TP_FLASH_CASES,
            tag="kernel-tp")
        flash_bwd_err = max(flash_bwd_err, tp_bwd_err)
        xent_err = max(xent_err, inception_xent_err)
        with tempfile.TemporaryDirectory() as tmp:
            tp_launches = phase_tp_transformer(torch, np, card, tmp)
            fsdp_launches = phase_fsdp_vgg16(torch, np, card, tmp,
                                             vgg_first)
            phase_refer_tp_fsdp(torch, np, tmp)
        remat_launches = phase_remat_transformer(torch, np, card)
        phase_compress(torch, np, card)
        a9_launches = add_counts(inception_launches, tp_launches,
                                 fsdp_launches, remat_launches)
        log(f"[compress] the A.9 phases (kernel-tp, tp-transformer, "
            f"fsdp-vgg16, refer-tp-fsdp, remat-transformer, compress) took "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ring_flash, ring_flash_err = phase_flash(
            torch, bw, peak, peak_bf16, peak_tf32, cases=RING_FLASH_CASES,
            tag="kernel-ring")
        flash_err = max(flash_err, ring_flash_err)
        ring_bwd, ring_bwd_err = phase_flash_bwd(
            torch, bw, peak, peak_bf16, peak_tf32, cases=RING_FLASH_CASES,
            tag="kernel-ring")
        flash_bwd_err = max(flash_bwd_err, ring_bwd_err)
        with tempfile.TemporaryDirectory() as tmp:
            ring_per_rank, _, _ = phase_ring_attention(torch, np, card, tmp)
            sppp_launches = phase_sp_pp_transformer(torch, np, card, tmp)
            slm_per_step = phase_sharded_lm(torch, np, card, tmp)
        log(f"[sharded-lm] the seq, pipe and expert phases (kernel-ring, "
            f"ring-attention, sp-transformer, pp-transformer, sharded-lm) "
            f"took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        pi_launches, _ = phase_pi_resnet(torch, np, card)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            registry_launches = phase_registry_fleet(torch, np, card, tmp)
        torch.cuda.empty_cache()
        fleet_launches = add_counts(pi_launches, registry_launches)
        dcn_launches = phase_dcn_dp(torch, np, refer_dp_single)
        log(f"[dcn-dp] the serving-fleet and dcn phases (pi-resnet, "
            f"registry-fleet, dcn-dp) took {time.perf_counter() - t0:.1f} "
            f"s")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            a10_launches = phase_router_canary(torch, np, card, tmp)
            torch.cuda.empty_cache()
            a10_launches = add_counts(
                a10_launches, phase_fleet_autoscale(torch, np, card, tmp))
            torch.cuda.empty_cache()
            a10_launches = add_counts(
                a10_launches, phase_telemetry_serve(torch, np, card, tmp))
        torch.cuda.empty_cache()
        log(f"[telemetry-serve] the router, autoscaler and telemetry phases "
            f"(router-canary, fleet-autoscale, telemetry-serve) took "
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

    def a8_rows(name, n, d, v):
        # per launch at an A.8 Output, both policies
        return {case[-1]: a8_xent[case][name] for case in A8_XENT_CASES
                if case[:3] == (n, d, v)}

    def pretrain_rows(name, d):
        # per launch at the DBN's (d 2000) or the SDA's (d 30) Output
        return {case[-1]: pretrain_xent[case][name]
                for case in PRETRAIN_XENT_CASES if case[1] == d}

    def inception_rows(name):
        # per launch at the trained InceptionV3's Output, (32, 2048, 1000)
        return {case[-1]: inception_xent[case][name]
                for case in INCEPTION_XENT_CASES}

    def per_forward(row, calls):
        return {k: (v * calls if k.endswith("ms") and v is not None else v)
                for k, v in row.items()}

    rows = {
        "bn_act": (launches["bn_act"] + iv3_launches["bn_act"], max_err,
                   dict(times[torch.float32], bound_by="bytes",
                        inception_v3_forward=iv3_times[torch.float32])),
        "flash_attention": (lm_launches["flash_attention"], flash_err,
                            dict(per_forward(flash, LM["n_layers"]),
                                 vit_shape=vit_flash, tp_shape=tp_flash,
                                 ring_shape=ring_flash)),
        "lstm_scan": (rnn_launches["lstm_scan"], lstm_err,
                      dict(per_forward(lstm, 2),
                           bidir_shape=bidir_rows["lstm_scan"])),
        "flash_attention_bwd_dq": (
            train_launches["flash_attention_bwd_dq"], flash_bwd_err,
            dict(per_forward(flash_bwd["dq"], LM["n_layers"]),
                 vit_shape=vit_bwd["dq"], tp_shape=tp_bwd["dq"],
                 ring_shape=ring_bwd["dq"])),
        "flash_attention_bwd_dkv": (
            train_launches["flash_attention_bwd_dkv"], flash_bwd_err,
            dict(per_forward(flash_bwd["dkv"], LM["n_layers"]),
                 vit_shape=vit_bwd["dkv"], tp_shape=tp_bwd["dkv"],
                 ring_shape=ring_bwd["dkv"])),
        "linear_xent_fwd": (train_launches["linear_xent_fwd"], xent_err,
                            dict(xent["fwd"], vgg16_output=vgg_rows("fwd"),
                                 tbptt_window=xent_window["fwd"],
                                 bidir_output=bidir_xent["fwd"],
                                 transfer_output=transfer_rows("fwd"),
                                 googlenet_output=a8_rows("fwd", 64, 1024,
                                                          1000),
                                 vit_output=a8_rows("fwd", 256, 128, 10),
                                 dbn_output=pretrain_rows("fwd", 2000),
                                 sda_output=pretrain_rows("fwd", 30),
                                 inception_output=inception_rows("fwd"))),
        "linear_xent_bwd": (train_launches["linear_xent_bwd"], xent_err,
                            dict(xent["bwd"], vgg16_output=vgg_rows("bwd"),
                                 tbptt_window=xent_window["bwd"],
                                 bidir_output=bidir_xent["bwd"],
                                 transfer_output=transfer_rows("bwd"),
                                 googlenet_output=a8_rows("bwd", 64, 1024,
                                                          1000),
                                 vit_output=a8_rows("bwd", 256, 128, 10),
                                 dbn_output=pretrain_rows("bwd", 2000),
                                 sda_output=pretrain_rows("bwd", 30),
                                 inception_output=inception_rows("bwd"))),
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
                                 "transfer_output", "vit_shape",
                                 "googlenet_output", "vit_output",
                                 "dbn_output", "sda_output", "tp_shape",
                                 "inception_output", "ring_shape")
               if k in t},
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
            "transfer_launches": transfer_launches[kname],
            # launches in solver-charrnn's and solver-lenet's line-search
            # iterations, window-rnn's and window-resnet's runs,
            # sentry-charrnn's three fits and the resume, and the records
            # phases' fits from files
            "solver_launches": solver_launches[kname],
            "window_launches": window_launches[kname],
            "sentry_launches": sentry_launches[kname],
            "records_launches": records_launches[kname],
            # launches in train-googlenet's and train-vit's 15 + 25 steps
            # (A.8's training paths; TinyYOLO, FaceNet, Darknet19 and
            # InceptionResNetV1 run none of these kernels)
            "a8_launches": a8_launches[kname],
            # launches in pretrain-dbn's and pretrain-sda's 20 + 20
            # fine-tuning steps (layerwise pretraining runs none)
            "pretrain_launches": pretrain_launches[kname],
            # launches in train-inception's 20 mixed steps, tp-transformer's
            # and fsdp-vgg16's rank 0 (5 steps each) and remat-transformer's
            # 4 x 3 steps (A.3's rest and A.9's model and fsdp axes)
            "a9_launches": a9_launches[kname],
            # A.9's seq, pipe and expert axes: rows 2-4 per ring call on
            # each of ring-attention's 4 ranks (causal: r + 1 each, full:
            # 4) and per ShardedTransformerLM step in one process (6
            # blocks, remat: 12 forward, 6 + 6 backward); every row's
            # launches on each rank in sp-transformer's and
            # pp-transformer's 5 mixed steps (seq ranks 0 and 1; pipe
            # stages 0 and 1, the Output on the last)
            **({"ring_launches_per_call": {
                "causal": ring_per_rank["causal_float32"],
                "full": ring_per_rank["full_float32"]},
                "sharded_lm_launches_per_step": slm_per_step[kname]}
               if kname.startswith("flash_attention") else {}),
            "sp_launches": [r[kname] for r in sppp_launches["sp"]],
            "pp_launches": [r[kname] for r in sppp_launches["pp"]],
            # A.9's rest and A.10's first half: launches in pi-resnet's
            # three modes and registry-fleet's run (53 bn_act per
            # ResNet-50 forward, 6 flash_attention per TransformerLM
            # forward), and on each of dcn-dp's four ranks
            "fleet_launches": fleet_launches[kname],
            "dcn_launches": [r[kname] for r in dcn_launches],
            # A.10's second half and A.11's first pieces: launches in
            # router-canary's, fleet-autoscale's and telemetry-serve's runs
            # (53 bn_act per ResNet-50 forward, 6 flash_attention per
            # TransformerLM forward routed by name)
            "router_fleet_launches": a10_launches[kname]})
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] in ("--dp-rank", "--dcn-rank"):
        sys.exit(dp_rank_main(int(sys.argv[2]), sys.argv[3],
                              dcn=sys.argv[1] == "--dcn-rank"))
    if len(sys.argv) == 6 and sys.argv[1] == "--a9-rank":
        sys.exit(a9_rank_main(sys.argv[2], int(sys.argv[3]),
                              int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
